"""Rank topology: global / local (intra-host) / cross (inter-host)
(a framework-free copy of ``horovod_tpu/common/topology.py``).

The reference derives a 3-level topology from MPI communicators
(mpi/mpi_context.h:104-113: global_comm / local_comm / cross_comm) and
uses it for hierarchical and torus collectives.  Here the levels come
from the launcher's host map: ranks on one host share its fast links
(local; ICI in the JAX package's words), hosts connect over the network
(cross; DCN there).

This module also owns the ALGORITHM vocabulary for topology-aware
reductions (the reference's ``HOROVOD_HIERARCHICAL_ALLREDUCE`` /
``HOROVOD_TORUS_ALLREDUCE`` toggles, ``nccl_operations.cc:606-830``):

* ``flat``          — one collective over all ranks (the default).
* ``hierarchical``  — reducescatter over each host's ranks (ICI),
  allreduce of the shards across hosts (DCN), allgather back.  Only
  1/local_size of the logical bytes cross the slow hop.
* ``torus``         — the same two-stage decomposition over a 2-D
  factorization of the rank space (Google's 2-D torus allreduce on
  TPU-v3 pods, arXiv:1909.09756), for multi-axis device meshes.

:func:`plan_decomposition` turns (algorithm, topology, set ranks) into
the inner-axis size the executors reshape their meshes by — or
``None`` when the request degrades to flat (heterogeneous hosts,
prime world sizes, tiny sets), exactly like the reference's
``is_homogeneous`` fallback.
"""

from dataclasses import dataclass, field
from typing import List

#: algorithm vocabulary, in autotune-grid order (core/autotune.py)
ALGORITHMS = ("flat", "hierarchical", "torus")

_ALGO_ALIASES = {
    # None / "" = UNSET (a process-wide default may apply); an
    # explicit 'flat' spelling = "one flat collective, overriding any
    # default" — the same unset-vs-explicit split wire_dtype carries
    None: None, "": None,
    "flat": "flat", "none": "flat", "ring": "flat",
    "hier": "hierarchical", "hierarchical": "hierarchical",
    "torus": "torus", "2d": "torus",
}


def normalize_algorithm(algorithm):
    """Canonicalize an algorithm spec -> None (unset) | 'flat'
    (explicit) | 'hierarchical' | 'torus'."""
    key = algorithm.strip().lower() if isinstance(algorithm, str) \
        else algorithm
    try:
        return _ALGO_ALIASES[key]
    except KeyError:
        raise ValueError(
            f"unknown allreduce algorithm {algorithm!r}: expected one "
            f"of {ALGORITHMS}")


def torus_inner(n):
    """Largest factor of ``n`` that is <= sqrt(n): the near-square 2-D
    factorization the torus decomposition reshapes the rank space by.
    Returns 1 for primes / n < 4 (no useful second axis)."""
    best = 1
    f = 1
    while f * f <= n:
        if n % f == 0:
            best = f
        f += 1
    return best


def _grouped_local_size(topology, ranks):
    """Per-host rank count when the set's ranks are grouped by host
    with the SAME count on every spanned host (the reference's
    ``is_homogeneous`` gate); None otherwise (or single-host /
    unknown topology)."""
    if topology is None:
        return None
    hosts = []
    for r in ranks:
        try:
            hosts.append(topology.host_of_rank[r])
        except IndexError:
            return None
    counts = {}
    for h in hosts:
        counts[h] = counts.get(h, 0) + 1
    if len(counts) < 2 or len(set(counts.values())) != 1:
        return None       # single host or heterogeneous
    # ranks must be grouped by host (the launcher emits hosts in slot
    # order, so this holds for every launched job)
    if any(hosts[i] > hosts[i + 1] for i in range(len(hosts) - 1)):
        return None
    return len(ranks) // len(counts)


def plan_decomposition(algorithm, topology, ranks):
    """Inner-axis size for a 2-stage reduction over ``ranks``, or
    ``None`` when the algorithm degrades to flat.

    ``hierarchical`` needs the set's ranks grouped by host with the
    SAME count on every spanned host (the reference's
    ``is_homogeneous`` gate on ``NCCLHierarchicalAllreduce``) and
    more than one host; ``torus`` needs a composite set size.  The
    inner axis is the fast (ICI) hop: host-local ranks for
    hierarchical, the near-square factor for torus — and on
    multi-host jobs the torus inner axis is CONSTRAINED to divisors
    of the per-host rank count so its heavy reducescatter/allgather
    hops never straddle a DCN boundary (otherwise the "fast" axis
    would be the slow one and the cross-byte accounting a lie)."""
    algorithm = normalize_algorithm(algorithm)
    if algorithm in (None, "flat"):
        return None
    n = len(ranks)
    if n < 4:
        return None
    local = _grouped_local_size(topology, ranks)
    if algorithm == "torus":
        if local is None:
            # single host (or no host map): any near-square split of
            # the one ICI domain works
            if topology is not None and topology.num_hosts > 1:
                # spans hosts but heterogeneous/ungrouped: no safe
                # inner axis
                return None
            inner = torus_inner(n)
            return inner if inner > 1 else None
        # multi-host: inner must divide the per-host count so each
        # inner group stays on one host; pick the divisor nearest the
        # near-square ideal, falling back to the whole host (= the
        # hierarchical split) when the host count itself is the only
        # intra-host factor
        divisors = [d for d in range(2, local + 1) if local % d == 0]
        if not divisors:
            return None
        near_square = [d for d in divisors if d * d <= n]
        return max(near_square) if near_square else min(divisors)
    # hierarchical: the whole host is the inner axis
    return local


def carve_stage_ranks(topology, n_stages, ranks=None):
    """Partition ``ranks`` into ``n_stages`` equal, contiguous pipeline
    stages, preferring HOST-ALIGNED boundaries so the pp hops —
    activations and activation gradients, the pipeline's only
    steady-state cross-stage traffic — land on the cross-host/DCN hop
    while each stage's dp×tp collectives stay on intra-host ICI
    (arXiv:1909.09756's pod layout; the pp analogue of what
    :func:`plan_decomposition` does for 2-stage reductions: slow
    traffic on the outer hop, heavy traffic on the inner).

    Stages must be EQUAL-SIZED (activations flow between
    corresponding (dp, tp) peers of adjacent stages; unequal widths
    would need a re-shard at every boundary), so the partition is the
    contiguous equal split of the host-grouped rank list — which IS
    host-aligned whenever any host-aligned equal partition exists,
    including heterogeneous host:slots layouts (e.g. slots 3+1+1+3 at
    pp=2: the boundary after the 4th rank falls between hosts).  When no
    boundary lands on a host edge (or there is no host map) the same
    split still runs, just with pp traffic riding ICI — reported via
    the returned flag so callers can warn.

    Returns ``(stage_ranks, host_aligned)``: a list of ``n_stages``
    rank lists plus whether every boundary fell on a host boundary.
    """
    n_stages = int(n_stages)
    if ranks is None:
        ranks = list(range(topology.size if topology is not None else 0))
    ranks = list(ranks)
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if not ranks or len(ranks) % n_stages != 0:
        raise ValueError(
            f"{len(ranks)} ranks not divisible into {n_stages} "
            f"equal pipeline stages")
    per = len(ranks) // n_stages
    stages = [ranks[i * per:(i + 1) * per] for i in range(n_stages)]
    if topology is None or n_stages == 1:
        return stages, n_stages == 1
    try:
        hosts = [topology.host_of_rank[r] for r in ranks]
    except IndexError:
        return stages, False
    # host-aligned only meaningful when ranks arrive grouped by host
    # (the launcher's slot order)
    if any(hosts[i] > hosts[i + 1] for i in range(len(hosts) - 1)):
        return stages, False
    aligned = all(i == len(ranks) or hosts[i - 1] != hosts[i]
                  for i in range(per, len(ranks), per))
    return stages, aligned


@dataclass
class Topology:
    """Static rank layout for one job."""
    size: int
    # host index per global rank; threads-mode jobs are single-host.
    host_of_rank: List[int] = field(default_factory=list)

    def __post_init__(self):
        if not self.host_of_rank:
            self.host_of_rank = [0] * self.size

    @property
    def num_hosts(self):
        return max(self.host_of_rank) + 1 if self.host_of_rank else 1

    def local_ranks(self, host):
        return [r for r, h in enumerate(self.host_of_rank) if h == host]

    def local_rank(self, rank):
        host = self.host_of_rank[rank]
        return self.local_ranks(host).index(rank)

    def local_size(self, rank):
        return len(self.local_ranks(self.host_of_rank[rank]))

    def cross_rank(self, rank):
        """Rank among same-local-rank peers across hosts (reference
        cross_comm semantics: one rank per node at each local index).
        With heterogeneous slot counts, only hosts that HAVE this local
        index participate in the cross communicator."""
        lr = self.local_rank(rank)
        own = self.host_of_rank[rank]
        return sum(1 for h in range(own)
                   if len(self.local_ranks(h)) > lr)

    def cross_size(self, rank):
        lr = self.local_rank(rank)
        return sum(1 for h in range(self.num_hosts)
                   if len(self.local_ranks(h)) > lr)

    def is_homogeneous(self):
        sizes = {len(self.local_ranks(h)) for h in range(self.num_hosts)}
        return len(sizes) <= 1
