"""Host/interface discovery (port of ``horovod_tpu/runner/util/
network.py``; reference ``horovod/runner/util/network.py``).
Implemented on the stdlib (psutil is not required): interface addresses
come from
``socket.getaddrinfo`` plus a best-effort read of the routing trick
(UDP connect) the KV server already uses (http_server.local_ip)."""

import random
import socket

from . import threads

_local_addresses_cache = None


def _interface_addresses():
    """IPv4 addresses assigned to this host."""
    addresses = {"127.0.0.1"}
    hostname = socket.gethostname()
    for name in (hostname, "localhost"):
        try:
            for info in socket.getaddrinfo(name, None,
                                           socket.AF_INET):
                addresses.add(info[4][0])
        except socket.gaierror:
            continue
    try:
        # the address a default route would use (no packets sent)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.connect(("10.255.255.255", 1))
        addresses.add(s.getsockname()[0])
        s.close()
    except OSError:
        pass
    return addresses


def get_local_host_addresses():
    global _local_addresses_cache
    if _local_addresses_cache is None:
        _local_addresses_cache = _interface_addresses()
    return _local_addresses_cache


def get_local_intfs(nic=None):
    """Interfaces carrying 127.0.0.1 (reference network.py:36 — used
    only as the single-host fallback NIC set).  ``nic`` may be a
    single name or a set of names (launch.py's --nics action builds a
    set)."""
    wanted = None
    if nic is not None:
        wanted = {nic} if isinstance(nic, str) else set(nic)
    intfs = set()
    try:
        names = {name for _, name in socket.if_nameindex()}
    except OSError:
        names = {"lo"}
    if "lo" in names and (wanted is None or "lo" in wanted):
        intfs.add("lo")
    elif wanted:
        intfs |= wanted & names
    return intfs


def resolve_host_address(host_name):
    try:
        return socket.gethostbyname(host_name)
    except socket.gaierror:
        return None


def filter_local_addresses(all_host_names):
    """Hosts from the list that do NOT resolve to a local address
    (reference network.py:54) — the set the launcher must ssh to."""
    local = get_local_host_addresses()
    resolved = threads.execute_function_multithreaded(
        resolve_host_address, [[h] for h in all_host_names])
    remote = []
    for i, name in enumerate(all_host_names):
        addr = resolved[i]
        if not addr or addr not in local:
            remote.append(name)
    return remote


def get_driver_ip(nics=None):
    """The address workers should dial back to (reference
    network.py get_driver_ip)."""
    from ..http.http_server import local_ip
    return local_ip()


def find_port(server_factory):
    """Bind ``server_factory(addr)`` to a random free port (reference
    network.py:74)."""
    min_port, max_port = 1024, 65536
    num_ports = max_port - min_port
    start = random.randrange(0, num_ports)
    for offset in range(num_ports):
        port = min_port + (start + offset) % num_ports
        try:
            server = server_factory(("", port))
            return server, port
        except OSError:
            continue
    raise RuntimeError("Unable to find a port to bind to.")
