"""Host list parsing + slot allocation (port of
``horovod_tpu/runner/hosts.py``; reference
``horovod/runner/common/util/hosts.py`` and ``launch.py`` host flags).
"""

from dataclasses import dataclass
from typing import List


@dataclass
class HostInfo:
    hostname: str
    slots: int

    @staticmethod
    def from_string(s: str) -> "HostInfo":
        if ":" in s:
            host, slots = s.rsplit(":", 1)
            return HostInfo(host.strip(), int(slots))
        return HostInfo(s.strip(), 1)


@dataclass
class SlotInfo:
    """One rank's placement (reference hosts.py SlotInfo: rank,
    local/cross rank+size)."""
    hostname: str
    rank: int
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int
    size: int


def parse_hosts(hosts_str: str) -> List[HostInfo]:
    """Parse ``h1:2,h2:4`` (reference hosts.py parse_hosts)."""
    return [HostInfo.from_string(x) for x in hosts_str.split(",") if x]


def parse_host_files(filename: str) -> str:
    """Hostfile with ``hostname slots=N`` lines (reference
    launch.py parse_host_files)."""
    hosts = []
    with open(filename) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            name = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p[len("slots="):])
            hosts.append(f"{name}:{slots}")
    return ",".join(hosts)


def get_host_assignments(hosts: List[HostInfo], np: int) -> List[SlotInfo]:
    """Round-robin-free block allocation: fill each host's slots in
    order (reference hosts.py get_host_assignments)."""
    total = sum(h.slots for h in hosts)
    if total < np:
        raise ValueError(
            f"requested np={np} exceeds available slots {total} "
            f"across hosts {[f'{h.hostname}:{h.slots}' for h in hosts]}")
    assignments = []
    rank = 0
    cross_sizes = {}
    # first pass: (host, local_rank) placement
    placements = []
    for hi, h in enumerate(hosts):
        for lr in range(h.slots):
            if rank >= np:
                break
            placements.append((hi, h.hostname, lr))
            cross_sizes[lr] = cross_sizes.get(lr, 0) + 1
            rank += 1
    local_sizes = {}
    for hi, name, lr in placements:
        local_sizes[hi] = local_sizes.get(hi, 0) + 1
    cross_ranks = {}
    for rank, (hi, name, lr) in enumerate(placements):
        cr = cross_ranks.get(lr, 0)
        cross_ranks[lr] = cr + 1
        assignments.append(SlotInfo(
            hostname=name, rank=rank, local_rank=lr,
            local_size=local_sizes[hi], cross_rank=cr,
            cross_size=cross_sizes[lr], size=np))
    return assignments
