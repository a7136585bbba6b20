"""Host identity hash (port of ``horovod_tpu/runner/common/util/
host_hash.py``; reference ``horovod/runner/common/util/host_hash.py``): short hostname plus a
digest of the full hostname + namespace links, so two containers on
one machine hash differently.  Used by the spark/elastic layers to
group ranks by physical host."""

import hashlib
import os
import socket

NAMESPACE_PATH = "/proc/self/ns"


def _namespaces():
    if not os.path.exists(NAMESPACE_PATH):
        return ""
    links = []
    for entry in sorted(os.listdir(NAMESPACE_PATH)):
        try:
            links.append(os.readlink(os.path.join(NAMESPACE_PATH, entry)))
        except OSError:
            continue
    return " ".join(links)


def host_hash(salt=None):
    hostname = socket.gethostname()
    host = hostname.split(".")[0]
    host_info = f"{hostname}-{_namespaces()}"
    if salt:
        host_info = f"{host_info}-{salt}"
    digest = hashlib.md5(host_info.encode("ascii",
                                          errors="replace")).hexdigest()
    return f"{host}-{digest}"
