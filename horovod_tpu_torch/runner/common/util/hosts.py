"""Reference import path ``horovod.runner.common.util.hosts`` (port of
``horovod_tpu/runner/common/util/hosts.py``): the host/slot allocation
lives in the port's ``runner/hosts.py``; this module adds the
reference's remaining helpers on top of it."""

from ...hosts import (  # noqa: F401
    HostInfo, SlotInfo, parse_hosts, parse_host_files,
)
from ...hosts import get_host_assignments as _assign

INVALID_SLOT_INFO = SlotInfo(hostname="", rank=-1, local_rank=-1,
                             local_size=-1, cross_rank=-1,
                             cross_size=-1, size=-1)


def parse_hosts_and_slots(hosts):
    """``h1:2,h2:4`` -> ``([h1, h2], {h1: 2, h2: 4})`` (reference
    hosts.py:71)."""
    infos = parse_hosts(hosts)
    return [h.hostname for h in infos], \
        {h.hostname: h.slots for h in infos}


def get_host_assignments(hosts, min_num_proc, max_num_proc=None):
    """Reference hosts.py:100 — allocate as many slots as available,
    bounded by ``max_num_proc``, failing below ``min_num_proc`` (the
    elastic form of the static allocator)."""
    # static call: one argument means exactly that many slots
    if max_num_proc is None:
        return _assign(hosts, min_num_proc)
    total = sum(h.slots for h in hosts)
    np = min(total, max_num_proc)
    if np < min_num_proc:
        raise ValueError(
            f"Requested at least {min_num_proc} processes but only "
            f"{total} slots are available across {len(hosts)} hosts")
    return _assign(hosts, np)
