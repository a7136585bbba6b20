"""Core runtime: negotiation, fusion, dispatch (port of
``horovod_tpu/core/engine.py``).

* Rank threads **submit** tensors (reference EnqueueTensorAllreduce);
  a background thread negotiates readiness -- a tensor executes only
  when every participating rank has submitted it (controller.cc:74-474)
  -- **fuses** ready allreduces into buckets under the fusion threshold
  (FuseResponses, controller.cc:901-1080) and runs each bucket on the
  :class:`~horovod_tpu_torch.ops.dist_ops.MeshExecutor`.
* A float allreduce bucket is packed into a persistent per-rank fusion
  buffer ON THE DEVICE by the ``scale_cast_batched`` kernel (prescale
  on the way in), reduced, and unpacked by the same kernel straight
  into the output tensors (postscale on the way out) -- the reference's
  batched-D2D memcpy and ScaleBuffer kernels in one launch per pass.
* A float Sum/Average bucket whose request asks for the hierarchical or
  torus algorithm runs as a 2-D decomposition (``_run_allreduce_2d``,
  ``engine.py:2400-2456``) over an inner and an outer wire, where the
  job's host map (``common/topology.py``) factors its set; else flat.
* An allreduce bucket may ride a narrower wire (``_dispatch_allreduce``,
  the flat branch of ``engine.py:2338-2398``): a 16-bit cast, or the
  block-scaled int8/int4 codec, whose encode (kernels B2/B4) runs on the
  device over each rank's packed fusion row and whose decode (B3/B5)
  runs in the executor.  The quantized branch packs with factor 1 and
  applies the pre/post scale to the f32 sum, as the JAX engine does.
* On the card the engine works on its own CUDA stream.  A submission
  carries an event recorded on the submitter's stream (the reference's
  ready event); the engine stream waits on it before the pack.  Each
  result carries an event recorded after the unpack, on which
  ``synchronize()`` makes the caller's stream wait.
* Completion flows back through :class:`~..core.handles.Handle`.
* Under the launcher (a :class:`~.store_controller.StoreController`,
  one or more rank threads per process) negotiation is global: the
  background loop reports locally-ready entries to the launcher's
  coordinator and runs the coordinator's fused batches in log order
  (``_store_cycle``, ``_apply_response``), every process set spanning
  processes reducing over a ``torch.distributed`` process group (the
  local rank rows stacked inside the process first).  A heartbeat thread
  keeps the coordinator's liveness scan fed, and a dead peer aborts the
  engine.  Once the coordinator has scheduled the same response list for
  K cycles and every process voted for it, the loop runs the
  steady-state negotiation bypass instead (``_bypass_cycle``,
  core/bypass.py): a one-element MIN vote over the job's group, then the
  cached list, with no coordinator traffic.  Without a controller the
  loop and its stacked executors are the single-process path,
  untouched.
"""

import bisect
import contextlib
import logging
import math
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..common import env as env_mod
from ..common.topology import Topology, plan_decomposition
from ..common.exceptions import (
    DuplicateNameError,
    HorovodInitError,
    HorovodInternalError,
    StalledTensorError,
    TensorShapeMismatchError,
)
from ..ops import cuda_kernels, dist_ops
from ..ops import quantize as qz
from ..ops import quantize_kernels
from .handles import Handle
from .message import ReduceOp, Request, RequestType

logger = logging.getLogger("horovod_tpu_torch")

# process-set removal is a barrier across the local rank threads: the bound
# on the wait for the peers' votes and for the set's in-flight collectives
PS_REMOVAL_TIMEOUT_SECS = 60.0


@dataclass
class Submission:
    """One rank's (possibly grouped) tensor submission -- the engine-side
    TensorTableEntry (reference common.h TensorTableEntry)."""
    rank: int
    request: Request
    names: List[str]
    payloads: List[torch.Tensor]        # contiguous, on the engine device
    handle: Handle
    #: per payload, a tensor to write the result into (or None)
    outputs: Optional[List[Optional[torch.Tensor]]] = None
    #: CUDA event recorded on the submitter's stream after the payloads
    #: were produced, and that stream (None on the CPU)
    ready_event: Any = None
    stream: Any = None


class NegotiationEntry:
    """Readiness table row (reference controller.cc:1115-1140)."""

    __slots__ = ("key", "subs", "first_time", "wire_default",
                 "wire_inner_default", "algo_default", "meta_fp")

    def __init__(self, key, wire_default=None, wire_inner_default=None,
                 algo_default=None):
        self.key = key
        # the negotiation meta's fingerprint, computed once an armed
        # bypass cycle first looks at the entry
        self.meta_fp = None
        self.subs: Dict[int, Submission] = {}
        self.first_time = time.monotonic()
        # the process-wide wire default, latched when the first local
        # rank arrives, so every rank of one negotiation sees one default;
        # the inner-hop wire and the reduction algorithm likewise
        self.wire_default = wire_default
        self.wire_inner_default = wire_inner_default
        self.algo_default = algo_default


class ProcessSetState:
    """Runtime state for one process set (reference process_set.h).
    ``executor`` is None on a process that hosts none of its ranks;
    ``group`` is the process group this set created (removal destroys
    it).  ``compiled_executor`` runs the compiled path's collectives:
    the same stacked executor in one process; across processes an
    executor over a second group of the same processes
    (``compiled_group``, destroyed with the set when the set made it),
    so that the caller's un-negotiated collectives never interleave with
    the engine thread's on one communicator."""

    def __init__(self, ps_id, ranks, executor, local_ranks=None,
                 group=None, compiled_executor=None, compiled_group=None):
        self.id = ps_id
        self.ranks = list(ranks)
        self.index = {r: i for i, r in enumerate(self.ranks)}
        self.local_ranks = list(local_ranks) if local_ranks is not None \
            else list(self.ranks)
        self.executor = executor
        self.group = group
        self.compiled_executor = compiled_executor
        self.compiled_group = compiled_group
        self.pending: "OrderedDict[str, NegotiationEntry]" = OrderedDict()
        #: multi-process: entries reported to the coordinator, waiting
        #: for the batch that schedules them
        self.awaiting: "OrderedDict[str, NegotiationEntry]" = OrderedDict()
        #: multi-process: per process index, the set's global ranks it
        #: hosts (the coordinator's stall attribution reads it)
        self.members_by_proc = None
        self.joined = set()                 # ranks that called join()
        self.last_joined = -1
        self.join_waiters: Dict[int, Handle] = {}
        # entries the engine thread collected and has not finished yet
        # (a removal drains them too)
        self.running = 0
        #: the 2-D grids' process groups this process is a member of
        #: (removal destroys them)
        self.groups_2d = []

    @property
    def size(self):
        return len(self.ranks)


def bucket_layout(bucket):
    """Fusion-buffer layout of an allreduce bucket, as
    ``_run_allreduce_bucket`` lays it out (engine.py:1986-1994 of the
    JAX package): ``[(entry, tensor_idx, offset, numel, shape)]`` with
    members packed back to back in bucket order.  Returns (layout,
    total elements)."""
    layout, offset = [], 0
    for entry in bucket:
        ref = next(iter(entry.subs.values()))
        for i, p in enumerate(ref.payloads):
            layout.append((entry, i, offset, p.numel(), tuple(p.shape)))
            offset += p.numel()
    return layout, offset


class Engine:
    """The per-process core runtime (reference HorovodGlobalState +
    BackgroundThreadLoop).  ``num_ranks`` ranks are hosted in this
    process, all on ``device``: global ranks ``[rank_offset, rank_offset
    + num_ranks)`` of a ``global_size`` world.  A ``controller`` makes
    negotiation global (``world_group`` the job's ``torch.distributed``
    process group, ``compiled_group`` a second group of the same
    processes for the compiled path, ``vote_group`` a gloo group of the
    same processes for the bypass's vote); ``ranks_of_proc`` gives each
    process's rank count when they differ (the launcher's
    ``ranks_per_proc="host"``), else every process hosts ``num_ranks``
    (engine.py:143-150 of the JAX package); ``topology`` is the job's
    host map (``common/topology.Topology``, one host by default)."""

    def __init__(self, num_ranks, device, config=None, controller=None,
                 rank_offset=0, global_size=None, world_group=None,
                 compiled_group=None, ranks_of_proc=None, vote_group=None,
                 chaos=None, topology=None):
        self.config = config or env_mod.Config()
        #: chaos fault injector (chaos/inject.py FaultInjector): the
        #: engine calls its ``on_collectives`` hook right before each
        #: ready report (where ``slow_rank`` fires), and its ``hung``
        #: flag stops the heartbeat (engine.py:247-251 of the JAX
        #: package)
        self.chaos = chaos
        self.num_local = num_ranks
        self.device = torch.device(device)
        self.controller = controller
        self.rank_offset = rank_offset
        self.global_size = global_size or num_ranks
        self.ranks_of_proc = list(ranks_of_proc) if ranks_of_proc \
            else None
        if self.ranks_of_proc:
            self._proc_starts = [sum(self.ranks_of_proc[:p])
                                 for p in range(len(self.ranks_of_proc))]
            if sum(self.ranks_of_proc) != self.global_size:
                raise ValueError(
                    f"ranks_of_proc sums to {sum(self.ranks_of_proc)} but "
                    f"the global size is {self.global_size}")
        self._world_group = world_group
        self._compiled_world_group = compiled_group
        #: the job's host map (common/topology.py): the 2-D algorithms
        #: plan their inner axis by it, and a collective whose set spans
        #: hosts counts its bytes on the cross-host hop
        self.topology = topology or Topology(size=self.global_size)
        self._lock = threading.Condition()
        self._shutdown = False
        self._aborted: Optional[BaseException] = None
        #: True when shutdown() left the engine thread blocked
        self.wedged = False
        self._hold_depth = 0
        self._stall_warned = set()
        self.process_sets: Dict[int, ProcessSetState] = {
            0: self._make_process_set_state(0, range(self.global_size))}
        self._next_ps_id = 1
        # removal barrier bookkeeping (see remove_process_set)
        self._removal_events: Dict[int, threading.Event] = {}
        self._removal_votes: Dict[int, set] = {}
        self._removed_ps_ids: set = set()
        # rank tuples of multi-process sets being built (dist.new_group
        # runs outside the lock): the other local rank threads wait for
        # the first one's build instead of starting their own
        self._building_ps: set = set()
        #: alltoall error-feedback residuals, keyed (set id, rank): the
        #: quantization error of the last exchange's padded per-peer-slot
        #: layout, re-injected slot by slot into the next exchange with
        #: the same layout and dropped when the layout changes
        #: (engine.py:220-226).  The engine thread writes them; a set's
        #: removal drops the set's.
        self._a2a_ef = {}
        #: persistent fusion buffers, keyed (local rank index, dtype)
        self._fusion = {}
        #: allreduce buckets executed (each packs and unpacks once per
        #: local rank)
        self.allreduce_buckets = 0
        #: fused allgather buckets (more than one entry in one gather)
        self.fused_allgather_runs = 0
        #: wire accounting under the JAX engine's names (engine.py:621-638):
        #: per allreduce bucket, the full-width bytes, the bytes the wire
        #: encoding puts on the interconnect per rank, and the buckets
        #: that rode the int8/int4 codec
        self.logical_wire_bytes = 0
        self.actual_wire_bytes = 0
        self.quantized_bucket_runs = 0
        #: the bytes of those that cross the slow (inter-host) hop
        #: (engine.py:629 of the JAX package), the bytes each hop of a
        #: reduction moves, keyed (hop, wire) with hop 'inner' or 'cross'
        #: (its WIRE_HOP_BYTES family), and the allreduce buckets run per
        #: reduction algorithm ('flat', 'hierarchical', 'torus')
        self.cross_wire_bytes = 0
        self.hop_wire_bytes = {}
        self.algo_runs = {}
        #: sharded weight-update rounds (core/sharded.ShardedUpdater's
        #: gradient reducescatters, one per rank and step; engine.py:645)
        self.sharded_update_runs = 0
        self.stream = None
        #: the compiled reducer's side stream: its own, so that its
        #: collectives (on the compiled group) never wait in one stream
        #: behind the engine thread's (on the set's group) across
        #: processes that issued the two in another order
        self.compiled_stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self.compiled_stream = torch.cuda.Stream(self.device)
        # idle polls of the coordinator are rate-limited (see _store_cycle)
        self._last_poll = 0.0
        #: steady-state negotiation bypass (core/bypass.py): armed by the
        #: coordinator's bypass_arm record once every process voted the
        #: same stable cycle fingerprint; while active the loop runs
        #: _bypass_cycle instead of _store_cycle.  The JAX package counts
        #: its cycles through telemetry (ROADMAP.md A17); the port keeps
        #: plain counters: armed cycles run on the cached list (hits),
        #: fallbacks to full negotiation, the seconds of the hits' votes
        #: and executions, and the seconds the un-armed tracker takes
        #: after each store cycle (what the bypass costs where it never
        #: arms)
        self._bypass = None
        self._vote_group = vote_group
        self._vote_ex = None
        self.bypass_hits = 0
        self.bypass_fallbacks = 0
        self.bypass_cycle_seconds = 0.0
        self.bypass_track_seconds = 0.0
        if self.multiproc and self.config.bypass_after_cycles > 0:
            from .bypass import BypassState
            self._bypass = BypassState(self.config.bypass_after_cycles,
                                       self.config.bypass_wait_secs)
        self._hb_stop = threading.Event()
        self._hb_thread = None
        if self.multiproc and self.config.heartbeat_secs > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                args=(self.config.heartbeat_secs,),
                name="horovod_tpu_torch-heartbeat", daemon=True)
            self._hb_thread.start()
        self._thread = threading.Thread(
            target=self._background_loop, name="horovod_tpu_torch-engine",
            daemon=True)
        self._thread.start()

    @property
    def num_ranks(self):
        """Global world size (``hvd.size()``)."""
        return self.global_size

    @property
    def multiproc(self):
        return self.controller is not None

    def _proc_of(self, global_rank):
        """Hosting process of a global rank: a table lookup for a
        heterogeneous host:slots job, integer division for the uniform
        layout (engine.py:655-663)."""
        if self.ranks_of_proc:
            return bisect.bisect_right(self._proc_starts, global_rank) - 1
        return global_rank // self.num_local

    # ------------------------------------------------------------------
    # worker liveness

    def _heartbeat_loop(self, interval):
        """Beat the coordinator's ``heartbeat`` verb from a thread of
        its own (engine.py:529-556): a peer whose beats stop is declared
        dead and its collectives fail; a beat answered ``dead`` aborts
        this engine, whose peers' collectives were already failed."""
        ranks = list(range(self.rank_offset,
                           self.rank_offset + self.num_local))
        host = env_mod.get_str(env_mod.HOROVOD_HOSTNAME)
        while not self._hb_stop.is_set():
            if self.chaos is not None and self.chaos.hung:
                # a chaos ``hang``: stop beating, so the coordinator's
                # liveness scan declares this process dead
                return
            try:
                if self.controller.heartbeat(ranks=ranks, host=host):
                    self.abort(HorovodInternalError(
                        "coordinator declared this worker dead after "
                        "missed heartbeats"))
                    return
            except Exception:  # noqa: BLE001 — the client already
                # retried with backoff; beat again next interval
                pass
            self._hb_stop.wait(interval)

    def _stop_heartbeat(self):
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None
            if not (self.chaos is not None and self.chaos.hung) \
                    and self._aborted is None:
                # clean shutdown: deregister so it never reads as a death
                try:
                    self.controller.heartbeat(bye=True)
                except Exception:  # noqa: BLE001 — coordinator gone
                    pass

    # ------------------------------------------------------------------
    # process sets

    def _make_process_set_state(self, ps_id, ranks):
        """A set's state.  Single process: a stacked executor over the
        rows of its member ranks.  Multi-process: the global set reduces
        over the job's process group; any other set whose members span
        processes gets a group of its own (``dist.new_group``, which
        every process calls in the same order, members or not); a set
        inside one process is stacked; a process hosting none of the
        set's ranks has no executor.  Over a group each process hosts
        the run of the set's positions that its rank threads hold
        (``proc_positions``).  Each group the compiled path uses is a
        second one over the same processes: the global set's is the
        engine's ``compiled_group``, another set's a second
        ``dist.new_group`` right after its own."""
        ranks = sorted(ranks)
        local = [r for r in ranks
                 if self.rank_offset <= r < self.rank_offset + self.num_local]
        if not self.multiproc:
            ex = dist_ops.MeshExecutor(self.device, len(ranks))
            return ProcessSetState(ps_id, ranks, ex, compiled_executor=ex)
        procs = sorted({self._proc_of(r) for r in ranks})
        group = created = cgroup = ccreated = None
        if ps_id == 0:
            group = self._world_group
            cgroup = self._compiled_world_group
        elif len(procs) > 1:
            group = created = dist.new_group(ranks=procs)
            cgroup = ccreated = dist.new_group(ranks=procs)
        grids = self._build_grids_2d(ranks, procs)
        executor = compiled = None
        if local:
            spans = len(procs) > 1 or ps_id == 0
            positions = [[i for i, r in enumerate(ranks)
                          if self._proc_of(r) == p] for p in procs]
            executor = dist_ops.MeshExecutor(
                self.device, len(ranks), group=group if spans else None,
                proc_positions=positions if spans else None)
            if cgroup is not None:
                compiled = dist_ops.MeshExecutor(
                    self.device, len(ranks), group=cgroup,
                    proc_positions=positions)
            elif not spans:
                # a set inside this process reduces stacked on both paths
                compiled = executor
            for inner, (eng_g, comp_g) in grids.items():
                executor.set_groups_2d(inner, *eng_g)
                if compiled is not None:
                    compiled.set_groups_2d(inner, *comp_g)
        state = ProcessSetState(ps_id, ranks, executor, local_ranks=local,
                                group=created if local else None,
                                compiled_executor=compiled,
                                compiled_group=ccreated if local else None)
        state.groups_2d = [g for pair in grids.values() for gs in pair
                           for g in gs if g is not None] if local else []
        state.members_by_proc = {}
        for r in ranks:
            state.members_by_proc.setdefault(
                str(self._proc_of(r)), []).append(r)
        return state

    def _build_grids_2d(self, ranks, procs):
        """The process groups of the set's 2-D grids, one rank a process:
        for each inner-axis size the topology plans for the set
        (``plan_decomposition`` of 'hierarchical' and of 'torus'), a group
        per grid row and a group per grid column, for the engine's
        executor and again for the compiled path's.  ``dist.new_group`` is
        collective over the whole job, so every process builds every
        group, in one order, members or not.  Returns ``{inner:
        ((row group, column group), (compiled row, compiled column))}``
        with this process's own groups (None where it is no member)."""
        if not self.multiproc or len(procs) != len(ranks) \
                or len(ranks) < 4:
            return {}
        inners = sorted({i for i in (
            plan_decomposition(a, self.topology, ranks)
            for a in ("hierarchical", "torus")) if i is not None})
        me = self._proc_of(self.rank_offset)
        grids = {}
        for inner in inners:
            outer = len(ranks) // inner
            rows = [[procs[y * inner + x] for x in range(inner)]
                    for y in range(outer)]
            cols = [[procs[y * inner + x] for y in range(outer)]
                    for x in range(inner)]
            pair = []
            for _ in ("engine", "compiled"):
                mine = [None, None]
                for k, members in enumerate((rows, cols)):
                    for m in members:
                        g = dist.new_group(ranks=m)
                        if me in m:
                            mine[k] = g
                pair.append(tuple(mine))
            grids[inner] = tuple(pair)
        return grids

    def add_process_set(self, ranks) -> int:
        """Register the set of ``ranks`` and return its id; registering
        the same ranks again returns the existing id (every rank calls
        it, engine.py:735-750)."""
        ranks = sorted(set(int(r) for r in ranks))
        if any(r < 0 or r >= self.num_ranks for r in ranks):
            raise ValueError(f"process set ranks {ranks} out of range")
        with self._lock:
            while True:
                for ps in self.process_sets.values():
                    if ps.ranks == ranks:
                        return ps.id
                if tuple(ranks) not in self._building_ps:
                    break
                # another local rank thread is building this set
                self._lock.wait(timeout=0.05)
            ps_id = self._next_ps_id
            self._next_ps_id += 1
            if not self.multiproc:
                self.process_sets[ps_id] = self._make_process_set_state(
                    ps_id, ranks)
                return ps_id
            self._building_ps.add(tuple(ranks))
        # the first local caller builds: dist.new_group waits for every
        # process of the job, so the set is built outside the lock and
        # the loop keeps serving the peers' collectives meanwhile
        try:
            state = self._make_process_set_state(ps_id, ranks)
            with self._lock:
                self.process_sets[ps_id] = state
        finally:
            with self._lock:
                self._building_ps.discard(tuple(ranks))
                self._lock.notify_all()
        return ps_id

    def remove_process_set(self, ps_id, rank=None) -> bool:
        """Deregister a set (engine.py:751-834).  Removal is a barrier
        across the local rank threads: it takes effect once every local
        rank has asked for it, then the set's fully submitted collectives
        drain before it disappears, so a fast rank cannot kill work its
        peers (or its own unsynchronized async handle) still have in
        flight.  A caller bound to no rank removes at once.  Returns True
        once the set is gone."""
        if ps_id == 0:
            raise ValueError("cannot remove the global process set")
        timeout = PS_REMOVAL_TIMEOUT_SECS
        with self._lock:
            ps = self.process_sets.get(ps_id)
            if ps is None:
                return ps_id in self._removed_ps_ids
            wait_ev = None
            if self.num_local > 1 and rank is not None:
                ev = self._removal_events.setdefault(ps_id, threading.Event())
                voters = self._removal_votes.setdefault(ps_id, set())
                voters.add(rank)
                if len(voters) < self.num_local:
                    wait_ev = ev
            if wait_ev is None:
                self._finalize_removal_locked(ps_id, ps, timeout)
                return True
        # the finalizer (or abort/shutdown) sets the event; waiters never
        # touch the barrier state
        wait_ev.wait(timeout=2 * timeout)
        with self._lock:
            if ps_id in self._removed_ps_ids:
                return True
        if self._aborted is not None:
            raise HorovodInternalError(
                f"a peer rank failed during remove_process_set: "
                f"{self._aborted!r}")
        if self._shutdown:
            raise HorovodInternalError(
                "engine shut down during remove_process_set")
        raise HorovodInternalError(
            f"remove_process_set({ps_id}) timed out waiting for peer rank "
            f"threads to request removal")

    def _finalize_removal_locked(self, ps_id, ps, timeout):
        """Drain, then drop the set (the last voter, lock held;
        engine.py:835-869).  Every local member has voted, so nothing
        more arrives: entries whose non-joined ranks have all submitted
        wait for the engine thread to run them; entries missing a live
        rank can never complete and fail."""
        deadline = time.monotonic() + timeout

        def incomplete(entry):
            return any(r not in entry.subs
                       for r in ps.local_ranks if r not in ps.joined)

        while (ps.pending or ps.awaiting or ps.running) \
                and self._aborted is None and not self._shutdown:
            for table in (ps.pending, ps.awaiting):
                for key, entry in list(table.items()):
                    if incomplete(entry) or time.monotonic() > deadline:
                        table.pop(key, None)
                        self._stall_warned.discard((ps_id, key))
                        if self.multiproc:
                            self.controller.forget(key)
                        for sub in entry.subs.values():
                            sub.handle.set_error(HorovodInternalError(
                                f"process set {ps_id} removed while "
                                f"{key} pending"))
            if not (ps.pending or ps.awaiting or ps.running):
                break
            self._lock.wait(timeout=0.05)   # let the engine thread drain
        self.process_sets.pop(ps_id, None)
        for group in [ps.group, ps.compiled_group] + ps.groups_2d:
            if group is not None:
                dist.destroy_process_group(group)
        for key in [k for k in list(self._a2a_ef) if k[0] == ps_id]:
            self._a2a_ef.pop(key, None)
        self._removed_ps_ids.add(ps_id)
        ev = self._removal_events.pop(ps_id, None)
        self._removal_votes.pop(ps_id, None)
        if ev is not None:
            ev.set()

    def get_process_set(self, ps_id) -> ProcessSetState:
        ps = self.process_sets.get(ps_id)
        if ps is None:
            raise ValueError(f"unknown process set id {ps_id}")
        return ps

    def process_set_ranks(self, ps_id):
        return list(self.get_process_set(ps_id).ranks)

    def count_sharded_update(self):
        with self._lock:
            self.sharded_update_runs += 1

    # ------------------------------------------------------------------
    # submission (rank threads)

    def submit(self, sub: Submission) -> Handle:
        """Register the submission in the negotiation table; the
        background thread executes it once all participating ranks
        arrive (reference operations.cc:1408-2060)."""
        with self._lock:
            if self._shutdown:
                raise HorovodInitError("horovod_tpu_torch has been shut down")
            if self._aborted is not None:
                sub.handle.set_error(HorovodInternalError(
                    f"horovod_tpu_torch aborted: {self._aborted!r}"))
                return sub.handle
            ps = self.get_process_set(sub.request.process_set_id)
            if sub.rank not in ps.local_ranks:
                raise ValueError(
                    f"rank {sub.rank} is not part of process set {ps.id}")
            key = self._negotiation_key(ps, sub)
            entry = ps.pending.get(key)
            if entry is None:
                entry = NegotiationEntry(
                    key, self.config.wire_dtype, self.config.wire_inner,
                    self.config.algorithm)
                ps.pending[key] = entry
            req = sub.request
            if (req.wire_dtype is None and entry.wire_default
                    and req.request_type in (RequestType.ALLREDUCE,
                                             RequestType.REDUCESCATTER)
                    and req.reduce_op in (ReduceOp.SUM, ReduceOp.AVERAGE)):
                # the latched default goes INTO the request before
                # negotiation (engine.py:903-926): ranks whose defaults
                # differ fail the cross-rank wire check
                req.wire_dtype = entry.wire_default
            if (req.wire_dtype is None and entry.wire_default
                    and req.request_type == RequestType.ALLTOALL):
                # an exchange moves raw segments, with no accumulation to
                # commute with, so any float payload may ride the
                # process-wide default wire (engine.py:928-936)
                req.wire_dtype = entry.wire_default
            if (req.wire_inner is None and entry.wire_inner_default
                    and req.request_type in (RequestType.ALLREDUCE,
                                             RequestType.ALLTOALL)
                    and (req.request_type == RequestType.ALLTOALL
                         or req.reduce_op in (ReduceOp.SUM,
                                              ReduceOp.AVERAGE))):
                # the inner-hop wire and the reduction algorithm latch the
                # same way (engine.py:936-952): one negotiation, one pair
                # and one algorithm
                req.wire_inner = entry.wire_inner_default
            if (req.algorithm is None and entry.algo_default
                    and req.request_type == RequestType.ALLREDUCE
                    and req.reduce_op in (ReduceOp.SUM, ReduceOp.AVERAGE)):
                req.algorithm = entry.algo_default
            if sub.rank in entry.subs:
                sub.handle.set_error(DuplicateNameError(
                    f"tensor {sub.names} submitted twice by rank "
                    f"{sub.rank} before completion"))
                return sub.handle
            entry.subs[sub.rank] = sub
            self._lock.notify_all()
        return sub.handle

    def join(self, rank, ps_id=0) -> Handle:
        """Join (engine.py:973-1005, operations.cc:1991-2024): the rank
        stops submitting; pending and later allreduces on the set take it
        as a zero contributor.  The handle completes when every rank of
        the set has joined and the set's pending entries drained, with the
        last rank to join as its result."""
        handle = Handle()
        with self._lock:
            if self._shutdown:
                raise HorovodInitError("horovod_tpu_torch has been shut down")
            if self._aborted is not None:
                handle.set_error(HorovodInternalError(
                    f"horovod_tpu_torch aborted: {self._aborted!r}"))
                return handle
            ps = self.get_process_set(ps_id)
            if rank in ps.joined:
                handle.set_error(HorovodInternalError(
                    f"rank {rank} already joined"))
                return handle
            ps.joined.add(rank)
            ps.last_joined = rank
            ps.join_waiters[rank] = handle
            self._lock.notify_all()
        if self.multiproc:
            if self._bypass is not None:
                # a joined rank stops submitting: the cached list can never
                # be fully ready again, so the next agreement round falls
                # back at once instead of waiting out the bound
                self._bypass.poison("join")
            # the coordinator counts the set's joined ranks across
            # processes and logs join_done once all have
            self.controller.report_join(
                ps_id, rank, len(ps.ranks),
                proc_members=len(ps.local_ranks))
        return handle

    @staticmethod
    def _negotiation_key(ps, sub: Submission):
        return (f"{sub.request.request_type.name}"
                f"|{'/'.join(sub.names)}|ps{ps.id}")

    def hold_cycles(self):
        """Context manager parking the negotiation loop: entries
        submitted inside the ``with`` dispatch together in ONE cycle on
        exit (deterministic fusion-bucket formation)."""

        @contextlib.contextmanager
        def _hold():
            with self._lock:
                self._hold_depth += 1
            try:
                yield self
            finally:
                with self._lock:
                    self._hold_depth = max(0, self._hold_depth - 1)
                    self._lock.notify_all()
        return _hold()

    # ------------------------------------------------------------------
    # background loop

    def _background_loop(self):
        if self.stream is not None:
            torch.cuda.set_device(self.device)
            ctx = torch.cuda.stream(self.stream)
        else:
            ctx = contextlib.nullcontext()
        with ctx:
            while True:
                cycle = max(self.config.cycle_time_ms, 0.05) / 1000.0
                with self._lock:
                    if not self._shutdown:
                        self._lock.wait(timeout=cycle)
                    if self._shutdown:
                        self._fail_all_pending_locked(HorovodInitError(
                            "shutdown during pending collective"))
                        break
                    if self._hold_depth:
                        continue
                    work = self._collect_ready_locked()
                    self._check_stalls_locked()
                if self.multiproc:
                    if self._bypass is not None and self._bypass.active:
                        # armed fast path: agree over the collective path
                        # and run the cached response list, with no
                        # coordinator traffic
                        self._bypass_cycle()
                    else:
                        self._store_cycle(work)
                    continue
                for ps, batch in work:
                    if self.chaos is not None:
                        # single-process twin of the store cycle's hook:
                        # slow-rank faults delay dispatch here
                        self.chaos.on_collectives(len(batch))
                    try:
                        self._execute_batch(ps, batch)
                    finally:
                        with self._lock:
                            ps.running -= len(batch)
                            self._lock.notify_all()

    def _collect_ready_locked(self):
        """ComputeResponseList analogue: pull entries that every
        non-joined local rank of the set has submitted."""
        work = []
        for ps in list(self.process_sets.values()):
            if not self.multiproc and ps.joined \
                    and len(ps.joined) == ps.size \
                    and not ps.pending and not ps.running:
                # resolve the join barrier only once the set's pending
                # entries drained: clearing ``joined`` earlier would strand
                # entries submitted before the join (engine.py:1117-1128)
                for h in ps.join_waiters.values():
                    h.set_result(ps.last_joined)
                ps.join_waiters.clear()
                ps.joined.clear()
                ps.last_joined = -1
            ready = []
            for key in list(ps.pending.keys()):
                entry = ps.pending[key]
                needed = [r for r in ps.local_ranks if r not in ps.joined]
                if all(r in entry.subs for r in needed):
                    ready.append(entry)
                    del ps.pending[key]
                    if self.multiproc:
                        ps.awaiting[key] = entry
                    self._stall_warned.discard((ps.id, key))
            if ready:
                if not self.multiproc:
                    ps.running += len(ready)
                work.append((ps, ready))
        return work

    def _check_stalls_locked(self):
        """Stall inspector (reference stall_inspector.{h,cc}): warn when
        a tensor is ready on some-but-not-all ranks past the warning
        time; error everyone past the shutdown time."""
        if self.config.stall_check_disable:
            return
        now = time.monotonic()
        for ps in self.process_sets.values():
            for key, entry in list(ps.pending.items()):
                age = now - entry.first_time
                wkey = (ps.id, key)
                if age > self.config.stall_warning_secs \
                        and wkey not in self._stall_warned:
                    missing = [r for r in ps.local_ranks
                               if r not in entry.subs and r not in ps.joined]
                    logger.warning(
                        "One or more tensors were submitted to be reduced "
                        "by some ranks but not all: %s stalled for %.0fs "
                        "(missing ranks: %s)", key, age, missing)
                    self._stall_warned.add(wkey)
                if (self.config.stall_shutdown_secs > 0
                        and age > self.config.stall_shutdown_secs):
                    del ps.pending[key]
                    self._stall_warned.discard(wkey)
                    for sub in entry.subs.values():
                        sub.handle.set_error(StalledTensorError(
                            f"tensor {key} stalled for {age:.0f}s"))
            # reported entries: the coordinator's ``stall`` records name
            # the missing global ranks (_apply_response); here only the
            # shutdown time applies
            for key, entry in list(ps.awaiting.items()):
                age = now - entry.first_time
                if (self.config.stall_shutdown_secs > 0
                        and age > self.config.stall_shutdown_secs):
                    del ps.awaiting[key]
                    self._stall_warned.discard((ps.id, key))
                    # no response will ever name this key for us: a
                    # resubmission must negotiate again
                    self.controller.forget(key)
                    for sub in entry.subs.values():
                        sub.handle.set_error(StalledTensorError(
                            f"tensor {key} stalled for {age:.0f}s"))

    def _fail_all_pending_locked(self, exc):
        self._stall_warned.clear()
        for ps in self.process_sets.values():
            for entry in list(ps.pending.values()) + \
                    list(ps.awaiting.values()):
                for sub in entry.subs.values():
                    sub.handle.set_error(exc)
            if self.multiproc:
                for key in ps.awaiting:
                    self.controller.forget(key)
            ps.pending.clear()
            ps.awaiting.clear()
            for h in ps.join_waiters.values():
                h.set_error(exc)
            ps.join_waiters.clear()

    # ------------------------------------------------------------------
    # multi-process negotiation over the coordinator

    def _meta_for(self, ps, entry):
        """Negotiation metadata sent to the coordinator, the Request wire
        message (engine.py:1274-1329 of the JAX package; reference
        message.h:59-143)."""
        first = next(iter(entry.subs.values()))
        req = first.request
        meta = {
            "key": entry.key,
            "type": req.request_type.name,
            "dtype": req.dtype,
            "shape": list(req.shape),
            "op": int(req.reduce_op),
            "pre": req.prescale_factor,
            "post": req.postscale_factor,
            "wire": req.wire_dtype,
            "wi": req.wire_inner,
            "algo": req.algorithm,
            "sfp": req.shard_fp,
            "ps": ps.id,
            "nbytes": sum(p.numel() * p.element_size()
                          for p in first.payloads),
            "nprocs": len(ps.members_by_proc),
            "nranks": ps.size,
            "root": req.root_rank,
            "members": ps.members_by_proc,
            "aux": {},
        }
        if req.group_shapes is not None:
            meta["gshapes"] = [list(s) for s in req.group_shapes]
        if req.request_type == RequestType.ALLGATHER:
            # per-local-rank first dims, ordered by global rank; the
            # coordinator merges them into the global dim0 table
            meta["aux"]["dim0s"] = [
                [int(entry.subs[r].payloads[i].shape[0])
                 if entry.subs[r].payloads[i].dim() else 1
                 for i in range(len(first.payloads))]
                for r in ps.local_ranks if r in entry.subs]
        if req.request_type == RequestType.ALLTOALL:
            meta["aux"]["splits"] = [
                list(entry.subs[r].request.splits)
                for r in ps.local_ranks if r in entry.subs]
        return meta

    def _store_cycle(self, work):
        """Report locally-ready entries; execute the coordinator's
        responses in log order (engine.py:1331-1385).  While anything is
        outstanding (entries reported, or a joined rank whose peers go
        on reducing) the poll waits up to 0.2 s for the log to grow;
        otherwise it only looks, at most every 50 ms, for liveness and
        stall records."""
        metas = []
        for ps, batch in work:
            for entry in batch:
                err = self._validate(ps, entry, local_only=True)
                if err is not None:
                    with self._lock:
                        ps.awaiting.pop(entry.key, None)
                    for sub in entry.subs.values():
                        sub.handle.set_error(err)
                    # tell the coordinator so peer processes holding
                    # this tensor fail instead of waiting forever
                    meta = self._meta_for(ps, entry)
                    meta["error"] = str(err)
                    metas.append(meta)
                    continue
                metas.append(self._meta_for(ps, entry))
        with self._lock:
            outstanding = any(ps.awaiting or ps.join_waiters
                              for ps in self.process_sets.values())
        now = time.monotonic()
        if not (metas or outstanding) and now - self._last_poll < 0.05:
            return
        self._last_poll = now
        if self.chaos is not None and metas:
            # chaos slow_rank fires here, after the entries went locally
            # ready and before report_ready, so this process is the
            # straggler the coordinator's stall attribution names
            self.chaos.on_collectives(len(metas))
        try:
            if metas:
                self.controller.report_ready(metas)
            responses = self.controller.poll(
                wait=0.2 if outstanding or metas else 0.0)
        except Exception as exc:  # noqa: BLE001 — coordinator death
            self.abort(exc)
            return
        for resp in responses:
            self._apply_response(resp)
        if self._bypass is not None and not self._bypass.active:
            t0 = time.perf_counter()
            self._bypass_track(responses)
            self.bypass_track_seconds += time.perf_counter() - t0
        if self.controller.take_rereport():
            # the epoch resync drained the restarted coordinator's (or
            # aggregator's) replayed log; whatever is still awaiting was
            # lost with the old pending table: report it again
            self._rereport_awaiting()

    # ------------------------------------------------------------------
    # steady-state negotiation bypass (core/bypass.py)

    def _bypass_track(self, responses):
        """Un-armed detection (engine.py:1376-1408): feed the applied
        responses to the tracker; when the awaiting tables drain, the
        cycle closes, and a list stable for K cycles votes its
        fingerprint to the coordinator (idempotent; voted again each
        stable cycle until the arm record arrives in the log)."""
        bp = self._bypass
        for resp in responses:
            bp.observe_response(resp)
        with self._lock:
            drained = all(not ps.awaiting
                          for ps in self.process_sets.values())
        if not drained:
            return
        fp = bp.cycle_complete()
        if fp is not None:
            try:
                self.controller.bypass_ready(fp)
            except Exception:  # noqa: BLE001 — advisory: the vote goes
                # out again next stable cycle; a coordinator gone here
                # only delays arming
                pass

    def _bypass_cycle(self):
        """One armed cycle (engine.py:1410-1470): wait for the cached
        tensors, agree through a one-element MIN allreduce over the
        global set's group (vote 1 = my locally ready entries match my
        cached list) and on unanimity run the cached response list with
        no coordinator traffic.  Any dissent is unanimous too (the same
        collective result everywhere), so every process falls back into
        full negotiation together."""
        from .bypass import meta_fingerprint
        bp = self._bypass
        with self._lock:
            ps0 = self.process_sets.get(0)
            foreign = any(ps.id != 0 and ps.awaiting
                          for ps in self.process_sets.values())
            awaiting_fps = {}
            if ps0 is not None:
                for key, entry in ps0.awaiting.items():
                    if entry.meta_fp is None:
                        entry.meta_fp = meta_fingerprint(
                            self._meta_for(ps0, entry))
                    awaiting_fps[key] = entry.meta_fp
        if ps0 is None:
            return
        decision = bp.decide(awaiting_fps, foreign)
        if decision is None:
            return
        vote, reason = decision
        if self.chaos is not None and vote == 1:
            # after_collectives triggers keep counting (and slow_rank
            # keeps making a straggler) while armed: the bypass replaces
            # report_ready, so the hook fires before the vote (fallback
            # cycles count through _rereport_awaiting's report instead)
            self.chaos.on_collectives(len(awaiting_fps))
        t0 = time.perf_counter()
        try:
            agreed = self._bypass_vote(ps0, vote)
        except Exception as exc:  # noqa: BLE001 — a failed agreement
            # collective means a dead or diverged peer: the same contract
            # as any peer failure
            self.abort(exc)
            return
        if agreed:
            # counted before the handles resolve, so a rank thread that
            # reads the counter after its result sees this cycle
            bp.cycles += 1
            self.bypass_hits += 1
            for i, resp in enumerate(bp.responses):
                self._apply_response(self._bypass_response(resp, i))
            self.bypass_cycle_seconds += time.perf_counter() - t0
        else:
            self.bypass_fallbacks += 1
            logger.info(
                "negotiation bypass disengaged (%s); falling back to full "
                "negotiation", reason or "peer mismatch")
            bp.disarm()
            # marks from the pre-arm race window would swallow the
            # re-report of re-used tensor names (the coordinator dropped
            # those entries when it armed)
            self.controller.clear_reported()
            self._rereport_awaiting()

    def _bypass_vote(self, ps0, vote):
        """The agreement exchange (the reference's response-cache
        CoordinateCacheAndState, collapsed to one MIN bit; engine.py:
        1472-1482): one row per local rank, 1 iff this process's state
        matches its cached list, so the reduced value is 1 only on global
        agreement, and the same on every rank.  It runs over the vote's
        own gloo group (``vote_group``) on the CPU: a process whose keys
        are ready waits there for the slowest one, as it waited at the
        coordinator before the bypass armed, and that group's timeout is
        the stall shutdown's, not the job group's."""
        ex = ps0.executor
        if self._vote_group is not None:
            if self._vote_ex is None:
                self._vote_ex = dist_ops.MeshExecutor(
                    "cpu", ex.num_ranks, group=self._vote_group,
                    proc_positions=ex.proc_positions)
            ex = self._vote_ex
        rows = [torch.full((1,), float(vote), dtype=torch.float32,
                           device=ex.device) for _ in ps0.local_ranks]
        out = ex.reduce(rows, ReduceOp.MIN)
        return bool(out[0].item() >= 0.5)

    def _bypass_response(self, resp, idx):
        """Cached batch response for one bypass execution: fresh
        deterministic trace ids (every process runs the same responses in
        the same order, so the cumulative sequence is the same
        everywhere), outside the coordinator's id space."""
        r = dict(resp)
        bp = self._bypass
        ids = {}
        for k in resp["keys"]:
            bp.trace_seq += 1
            ids[k] = (1 << 40) + bp.trace_seq
        r["trace"] = ids
        return r

    def _rereport_awaiting(self):
        """Report every entry still awaiting a coordinator response: the
        bypass fallback's recovery (entries were never reported while
        armed), and the coordinator-restart resync's.  Local validation
        runs here because armed-mode entries skipped the store cycle's."""
        with self._lock:
            items = [(ps, key, entry)
                     for ps in self.process_sets.values()
                     for key, entry in list(ps.awaiting.items())]
        metas = []
        for ps, key, entry in items:
            err = self._validate(ps, entry, local_only=True)
            if err is not None:
                with self._lock:
                    ps.awaiting.pop(key, None)
                for sub in entry.subs.values():
                    sub.handle.set_error(err)
                meta = self._meta_for(ps, entry)
                meta["error"] = str(err)
                metas.append(meta)
            else:
                metas.append(self._meta_for(ps, entry))
        if not metas:
            return
        if self.chaos is not None:
            # this is a ready report: the chaos collectives counter (and
            # slow_rank's pre-report sleep) sees it, as in _store_cycle
            self.chaos.on_collectives(len(metas))
        try:
            self.controller.report_ready(metas)
        except Exception as exc:  # noqa: BLE001 — coordinator death
            self.abort(exc)

    def _apply_response(self, resp):
        """One record of the coordinator's log (engine.py:1536-1674):
        a fused batch to run, a negotiation error, a stall attribution,
        a dead peer (abort), the bypass's arm record or a set's join
        barrier.  The JAX package's flight-recorder dump requests
        (``trace_dump``) have no recorder to dump here (ROADMAP.md
        A17)."""
        kind = resp.get("kind")
        if kind == "batch":
            self._apply_batch(resp)
        elif kind == "error":
            with self._lock:
                for cand in self.process_sets.values():
                    e = cand.awaiting.pop(resp["key"], None)
                    if e is not None:
                        self._stall_warned.discard((cand.id, resp["key"]))
                        for sub in e.subs.values():
                            sub.handle.set_error(TensorShapeMismatchError(
                                resp.get("message", "negotiation error")))
                        break
        elif kind == "stall":
            key, ps_id = resp.get("key"), resp.get("ps", 0)
            with self._lock:
                fresh = (ps_id, key) not in self._stall_warned
                self._stall_warned.add((ps_id, key))
            if fresh:
                logger.warning(
                    "One or more tensors were submitted to be reduced "
                    "by some ranks but not all: %s stalled for %ss "
                    "(missing global ranks: %s, hosted by non-reporting "
                    "processes %s)", key, resp.get("age", "?"),
                    resp.get("missing_ranks") or "unknown",
                    resp.get("missing_procs", []))
        elif kind == "dead":
            # a peer missed its heartbeats: every collective it belongs
            # to is doomed, so fail every pending and future handle now
            msg = resp.get("message") or (
                f"worker process {resp.get('proc')} hosting global "
                f"ranks {resp.get('ranks') or []} declared dead after "
                f"missed heartbeats")
            logger.warning("%s; failing pending collectives", msg)
            self.abort(HorovodInternalError(msg))
        elif kind == "bypass_arm":
            # the coordinated switch point: every process consumes this
            # record at the same position of its response stream and arms
            # the steady-state bypass
            if self._bypass is not None:
                self._bypass.on_arm(resp.get("fp"))
        elif kind == "join_done":
            with self._lock:
                ps = self.process_sets.get(resp.get("ps", 0))
                if ps is not None:
                    for h in ps.join_waiters.values():
                        h.set_result(resp.get("last", -1))
                    ps.join_waiters.clear()
                    ps.joined.clear()
                    ps.last_joined = -1

    def _apply_batch(self, resp):
        keys, metas = resp["keys"], resp.get("metas", {})
        ps = None
        with self._lock:
            m = metas.get(keys[0]) if keys else None
            if m is not None:
                ps = self.process_sets.get(m.get("ps", 0))
        if ps is None or not ps.local_ranks:
            # this process hosts no member of the set
            return
        entries, bad_key = [], None
        with self._lock:
            popped = {k: ps.awaiting.pop(k) for k in keys
                      if k in ps.awaiting}
            for k in keys:
                self._stall_warned.discard((ps.id, k))
                # our ranks joined before this entry: run it with zeros
                e = popped.get(k) or self._synthetic_entry(k, metas.get(k))
                if e is None:
                    bad_key = k
                    break
                entries.append(e)
            ps.running += len(entries)
        try:
            if bad_key is not None:
                # we cannot take part in this collective: peers would
                # hang in it, so fail loudly everywhere
                err = HorovodInternalError(
                    f"coordinator response for unknown tensor {bad_key}; "
                    f"aborting to avoid a hang")
                for pe in popped.values():
                    for sub in pe.subs.values():
                        sub.handle.set_error(err)
                self.abort(err)
                return
            self._run_bucket(ps, entries, aux=resp.get("aux", {}))
        except Exception as exc:  # noqa: BLE001 — deliver to waiters
            logger.exception("collective execution failed")
            wrapped = exc if isinstance(exc, HorovodInternalError) \
                else HorovodInternalError(str(exc))
            for e in entries:
                for sub in e.subs.values():
                    sub.handle.set_error(wrapped)
            if self.config.elastic:
                # a collective of an elastic job fails when a peer died
                # (gloo: "connection closed by peer"): the process group
                # is broken, so every pending collective fails now, into
                # the elastic restore path
                self.abort(wrapped)
        finally:
            with self._lock:
                ps.running -= len(entries)
                self._lock.notify_all()

    def _synthetic_entry(self, key, meta):
        """Zero-contribution entry for an allreduce batch our joined
        ranks did not submit (engine.py:1687-1710): the set's collective
        still needs this process's row.  Other ops refuse join."""
        if meta is None or meta["type"] != "ALLREDUCE":
            return None
        req = Request(
            request_type=RequestType.ALLREDUCE, tensor_name=key, rank=-1,
            dtype=meta["dtype"], shape=tuple(meta["shape"]),
            reduce_op=ReduceOp(meta["op"]),
            prescale_factor=meta["pre"], postscale_factor=meta["post"],
            process_set_id=meta["ps"], wire_dtype=meta.get("wire"),
            wire_inner=meta.get("wi"), algorithm=meta.get("algo"))
        zeros = torch.zeros(tuple(meta["shape"]),
                            dtype=getattr(torch, meta["dtype"]),
                            device=self.device)
        entry = NegotiationEntry(key)
        entry.subs[-1] = Submission(rank=-1, request=req, names=[key],
                                    payloads=[zeros], handle=Handle())
        return entry

    def _global_table(self, ps, entry, aux, field, local_value):
        """Per global rank of the set, ``field``'s value: local mode
        reads the submissions; store mode merges the coordinator's
        per-process aux (engine.py:2458-2480, 2630-2641)."""
        if not self.multiproc:
            return {r: local_value(entry.subs[r]) for r in ps.ranks}
        by_rank = {}
        for proc_str, a in (aux or {}).get(entry.key, {}).items():
            members = ps.members_by_proc.get(proc_str, [])
            for r, v in zip(members, a[field]):
                by_rank[r] = v
        return by_rank

    def _global_dim0s(self, ps, entry, aux, n_tensors):
        """``[tensor][position]`` first dims of an allgather."""
        table = self._global_table(
            ps, entry, aux, "dim0s",
            lambda sub: [int(p.shape[0]) if p.dim() else 1
                         for p in sub.payloads])
        return [[int(table[r][i]) for r in ps.ranks]
                for i in range(n_tensors)]

    def _global_splits(self, ps, entry, aux):
        """Every rank's alltoall send splits, in rank order."""
        table = self._global_table(ps, entry, aux, "splits",
                                   lambda sub: list(sub.request.splits))
        return [list(table[r]) for r in ps.ranks]

    # ------------------------------------------------------------------
    # execution

    def _execute_batch(self, ps, entries):
        """PerformOperation analogue: validate, fuse allreduces into
        buckets, run each bucket."""
        runnable = []
        for entry in entries:
            err = self._validate(ps, entry)
            if err is not None:
                for sub in entry.subs.values():
                    sub.handle.set_error(err)
                continue
            runnable.append(entry)
        for bucket in self._fuse(ps, runnable):
            try:
                self._run_bucket(ps, bucket)
            except Exception as exc:  # noqa: BLE001 — deliver to waiters
                logger.exception("collective execution failed")
                wrapped = exc if isinstance(exc, HorovodInternalError) \
                    else HorovodInternalError(str(exc))
                for entry in bucket:
                    for sub in entry.subs.values():
                        sub.handle.set_error(wrapped)

    def _validate(self, ps, entry, local_only=False) -> Optional[Exception]:
        """Cross-rank consistency checks (ConstructResponse,
        controller.cc:496-843): dtype, shape, op, scale factors, wire,
        shard layout and root must agree across ranks.  Multi-process
        (``local_only``) this covers the local ranks; the coordinator
        checks across processes and refuses join for non-allreduces."""
        subs = [entry.subs[r] for r in ps.ranks if r in entry.subs]
        first = subs[0].request
        rt = first.request_type
        for sub in subs[1:]:
            r = sub.request
            if r.dtype != first.dtype:
                return TensorShapeMismatchError(
                    f"Mismatched data types for {first.tensor_name}: rank "
                    f"{sub.rank} sent {r.dtype}, rank {subs[0].rank} sent "
                    f"{first.dtype}")
            if r.reduce_op != first.reduce_op:
                return TensorShapeMismatchError(
                    f"Mismatched reduce ops for {first.tensor_name}")
            if (r.prescale_factor != first.prescale_factor
                    or r.postscale_factor != first.postscale_factor):
                return TensorShapeMismatchError(
                    f"Mismatched prescale/postscale for {first.tensor_name}")
            if r.wire_dtype != first.wire_dtype:
                return TensorShapeMismatchError(
                    f"Mismatched wire dtypes for {first.tensor_name}: "
                    f"rank {sub.rank} sent {r.wire_dtype}, rank "
                    f"{subs[0].rank} sent {first.wire_dtype}")
            if r.wire_inner != first.wire_inner:
                return TensorShapeMismatchError(
                    f"Mismatched inner-hop wire dtypes for "
                    f"{first.tensor_name}: rank {sub.rank} sent "
                    f"{r.wire_inner}, rank {subs[0].rank} sent "
                    f"{first.wire_inner}")
            if r.algorithm != first.algorithm:
                # ranks that disagree would run different collectives
                # against each other (engine.py:1776-1780)
                return TensorShapeMismatchError(
                    f"Mismatched algorithms for {first.tensor_name}: "
                    f"rank {sub.rank} sent {r.algorithm}, rank "
                    f"{subs[0].rank} sent {first.algorithm}")
            if r.shard_fp != first.shard_fp:
                # a sharded weight update (core/sharded.py): ranks whose
                # shard layouts disagree would scatter and gather
                # different slices against each other
                return TensorShapeMismatchError(
                    f"Mismatched shard layouts for {first.tensor_name}: "
                    f"rank {sub.rank} sent {r.shard_fp}, rank "
                    f"{subs[0].rank} sent {first.shard_fp}")
            if rt == RequestType.BROADCAST and r.root_rank != first.root_rank:
                return TensorShapeMismatchError(
                    f"Mismatched broadcast root for {first.tensor_name}: "
                    f"{r.root_rank} vs {first.root_rank}")
            if rt in (RequestType.ALLREDUCE, RequestType.BROADCAST,
                      RequestType.REDUCESCATTER):
                if r.shape != first.shape:
                    return TensorShapeMismatchError(
                        f"Mismatched shapes for {first.tensor_name}: rank "
                        f"{sub.rank} sent {r.shape}, rank {subs[0].rank} "
                        f"sent {first.shape}")
                if r.group_shapes != first.group_shapes:
                    return TensorShapeMismatchError(
                        f"Mismatched group member shapes for "
                        f"{first.tensor_name}: rank {sub.rank} sent "
                        f"{r.group_shapes}, rank {subs[0].rank} sent "
                        f"{first.group_shapes}")
            elif rt in (RequestType.ALLGATHER, RequestType.ALLTOALL):
                if tuple(r.shape[1:]) != tuple(first.shape[1:]):
                    return TensorShapeMismatchError(
                        f"Mismatched non-first dimensions for "
                        f"{first.tensor_name}")
                gs_a = r.group_shapes or ()
                gs_b = first.group_shapes or ()
                if len(gs_a) != len(gs_b) or any(
                        tuple(a[1:]) != tuple(b[1:])
                        for a, b in zip(gs_a, gs_b)):
                    return TensorShapeMismatchError(
                        f"Mismatched group member non-first dimensions "
                        f"for {first.tensor_name}")
            if rt == RequestType.ALLTOALL:
                if r.splits is None or len(r.splits) != ps.size:
                    return TensorShapeMismatchError(
                        f"alltoall splits for {first.tensor_name} must "
                        f"have one entry per rank of the process set")
                if sum(r.splits) != (r.shape[0] if r.shape else 0):
                    return TensorShapeMismatchError(
                        f"alltoall splits for {first.tensor_name} must sum "
                        f"to the first dimension")
        if rt == RequestType.ALLTOALL and (
                first.splits is None or len(first.splits) != ps.size
                or sum(first.splits) != (first.shape[0]
                                         if first.shape else 0)):
            return TensorShapeMismatchError(
                f"alltoall splits invalid for {first.tensor_name}")
        if local_only:
            return None
        if len(subs) < ps.size and rt != RequestType.ALLREDUCE:
            return HorovodInternalError(
                f"rank(s) {[r for r in ps.ranks if r not in entry.subs]} "
                f"joined; {rt.name} does not support join")
        return None

    def _fuse(self, ps, entries):
        """FuseResponses analogue (engine.py:1853-1920): pack consecutive
        ready allreduce entries with matching (dtype, op, scales, wire,
        shard layout) into buckets up to the fusion threshold: quantized
        and full-width tensors never share a fusion buffer, nor does a
        sharded update's traffic with dense or differently laid-out
        traffic.  Consecutive allgathers of one (dtype, shard layout) fuse
        likewise (the threshold counts the gathered size), and consecutive
        alltoalls of one (dtype, wire, error feedback) merge into one
        exchange.  Other ops run one per bucket."""
        threshold = self.config.fusion_threshold_bytes
        buckets, cur, cur_bytes, cur_sig = [], [], 0, None
        for entry in entries:
            first = next(iter(entry.subs.values()))
            req = first.request
            rt = req.request_type
            nbytes = sum(p.numel() * p.element_size()
                         for p in first.payloads)
            if rt == RequestType.ALLREDUCE:
                sig = (rt, req.dtype, req.reduce_op, req.prescale_factor,
                       req.postscale_factor, req.wire_dtype, req.wire_inner,
                       req.algorithm, req.shard_fp)
            elif rt == RequestType.ALLGATHER:
                sig = (rt, req.dtype, req.shard_fp)
                nbytes *= ps.size
            elif rt == RequestType.ALLTOALL:
                sig = (rt, req.dtype, req.wire_dtype, req.wire_inner,
                       req.error_feedback)
            else:
                if cur:
                    buckets.append(cur)
                    cur, cur_bytes, cur_sig = [], 0, None
                buckets.append([entry])
                continue
            if cur and (sig != cur_sig or cur_bytes + nbytes > threshold):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(entry)
            cur_bytes += nbytes
            cur_sig = sig
        if cur:
            buckets.append(cur)
        return buckets

    def _run_bucket(self, ps, bucket, aux=None):
        """Run one fused bucket; ``aux`` is a multi-process batch's
        per-process allgather dims and alltoall splits."""
        rt = next(iter(bucket[0].subs.values())).request.request_type
        if rt == RequestType.ALLREDUCE:
            self._run_allreduce_bucket(ps, bucket)
        elif rt == RequestType.ALLGATHER:
            if len(bucket) > 1:
                self._run_allgather_fused(ps, bucket, aux)
            else:
                self._run_allgather(ps, bucket[0], aux)
        elif rt == RequestType.BROADCAST:
            self._run_broadcast(ps, bucket[0])
        elif rt == RequestType.ALLTOALL:
            self._run_alltoall(ps, bucket, aux)
        elif rt == RequestType.REDUCESCATTER:
            self._run_reducescatter(ps, bucket[0])
        elif rt == RequestType.BARRIER:
            for sub in bucket[0].subs.values():
                sub.handle.set_result(None)
        else:
            raise HorovodInternalError(f"unhandled op {rt}")

    def _local_subs(self, ps, entry):
        """Local participating submissions, ordered by global rank."""
        return {r: entry.subs[r] for r in ps.local_ranks if r in entry.subs}

    # -- device ordering ---------------------------------------------------

    def _await_inputs(self, subs):
        """Order the engine stream after each submitter's ready event,
        and tell the caching allocator that the engine stream uses the
        submitters' tensors (their blocks must not be recycled on the
        submitter's stream before the engine is done with them)."""
        if self.stream is None:
            return
        for sub in subs:
            if sub.ready_event is not None:
                self.stream.wait_event(sub.ready_event)
            if sub.stream is not None and sub.stream != self.stream:
                for t in sub.payloads:
                    t.record_stream(self.stream)
                for t in sub.outputs or ():
                    if t is not None:
                        t.record_stream(self.stream)

    def _done_event(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def _fusion_buffer(self, idx, dtype, total):
        """Persistent per-local-rank fusion buffer (the reference's
        FusionBufferManager), grown to the largest bucket seen."""
        buf = self._fusion.get((idx, dtype))
        if buf is None or buf.numel() < total:
            buf = torch.empty(total, dtype=dtype, device=self.device)
            self._fusion[(idx, dtype)] = buf
        return buf[:total]

    @staticmethod
    def _output(sub, i, shape, dtype, device):
        out = sub.outputs[i] if sub.outputs else None
        if out is not None:
            return out
        return torch.empty(shape, dtype=dtype, device=device)

    @staticmethod
    def _wire_for(req, dtype, op):
        """Effective wire of a float reduction (engine.py:2204-2224): the
        request's wire (the process-wide default was latched into it at
        submit), except that min/max/product and non-float payloads ship
        full width, as does a 16-bit wire for an already-16-bit tensor;
        'f32' is the explicit full-width override."""
        if op not in (ReduceOp.SUM, ReduceOp.AVERAGE) \
                or not dtype.is_floating_point:
            return None
        wire = req.wire_dtype
        if wire == "f32":
            return None
        if wire in ("fp16", "bf16") and dtype.itemsize <= 2:
            return None
        return wire

    def _spans_hosts(self, ps=None):
        """Whether the job (or one process set) crosses hosts
        (engine.py:2242-2251)."""
        hosts = self.topology.host_of_rank
        if ps is None:
            return self.topology.num_hosts > 1
        return len({hosts[r] for r in ps.ranks if r < len(hosts)}) > 1

    def account_wire(self, logical, actual, cross=None):
        """Add one collective's full-width bytes and the bytes its wire
        encoding moves (per rank) to the counters.  ``cross``: the bytes
        over the slow hop; None (a flat collective) counts all of
        ``actual`` there when the job spans hosts, else none."""
        if cross is None:
            cross = actual if self._spans_hosts() else 0
        self.logical_wire_bytes += int(logical)
        self.actual_wire_bytes += int(actual)
        self.cross_wire_bytes += int(cross)

    def _account_hop(self, hop, wire, nbytes):
        """Per-hop bytes (engine.py:2267-2273): ``hop`` 'inner' (the
        intra-host stage) or 'cross', ``wire`` that hop's encoding."""
        key = (hop, wire or "f32")
        self.hop_wire_bytes[key] = self.hop_wire_bytes.get(key, 0) \
            + int(nbytes)

    def _algo_plan(self, ps, req, op):
        """The bucket's effective (algorithm, inner-axis size)
        (engine.py:2298-2328): a hierarchical or torus request on a float
        Sum/Average payload whose set the topology factors, else flat,
        the reference's ``is_homogeneous`` fallback.  The JAX engine also
        requires one device per rank; the port's stacked rank threads
        stand for that layout, so every layout decomposes."""
        algo = req.algorithm
        if algo in (None, "flat") \
                or op not in (ReduceOp.SUM, ReduceOp.AVERAGE) \
                or not dist_ops.is_float(getattr(torch, req.dtype)):
            return "flat", None
        inner = plan_decomposition(algo, self.topology, ps.ranks)
        if inner is None:
            logger.debug("%s allreduce requested but process set %d (%d "
                         "ranks) does not decompose; running flat",
                         algo, ps.id, ps.size)
            return "flat", None
        return algo, inner

    @staticmethod
    def _inner_wire_for(req, outer, dtype):
        """The inner hop's effective wire (engine.py:2330-2336)."""
        return qz.effective_inner_wire(req.wire_inner, outer,
                                       dtype.itemsize)

    def _pack_rows(self, ps, bucket, layout, total, buf_dtype, factor,
                   scaled=False):
        """Per local rank, the bucket's members packed into the rank's
        device fusion buffer: one kernel launch for floats
        (``out_dtype(f32(x) * factor)``), integer scaling otherwise.
        Missing (joined) ranks' members stay zero."""
        rows = []
        for idx, r in enumerate(ps.local_ranks):
            subs = [e.subs[r] for e in bucket if r in e.subs]
            self._await_inputs(subs)
            buf = self._fusion_buffer(idx, buf_dtype, total)
            srcs, offs = [], []
            for entry, i, off, _n, _shape in layout:
                sub = entry.subs.get(r)
                if sub is not None:
                    srcs.append(sub.payloads[i])
                    offs.append(off)
            if len(srcs) < len(layout):
                buf.zero_()
            if dist_ops.is_float(buf_dtype):
                cuda_kernels.pack_scale_cast(srcs, buf, offs, factor)
            else:
                for src, off in zip(srcs, offs):
                    seg = buf[off:off + src.numel()]
                    seg.copy_(dist_ops.int_prescale(src.view(-1), factor)
                              if scaled else src.view(-1))
            rows.append(buf)
        return rows

    def _unpack_rows(self, ps, bucket, layout, ys, dtype, factor,
                     int_post=None):
        """Each local rank's result ``y`` unpacked into its outputs: one
        kernel launch for floats (``dst_dtype(f32(y) * factor)``); an f64
        output of a narrower wire is a plain widening copy (``factor`` is
        1 there); ``int_post`` = (op, R, postscale) scales integers.
        Returns {(id(entry), rank): [outputs]}."""
        results = {}
        for r, y in zip(ps.local_ranks, ys):
            dsts, offs = [], []
            for entry, i, off, n, shape in layout:
                sub = entry.subs.get(r)
                if sub is None:
                    continue
                out = self._output(sub, i, shape, dtype, self.device)
                results.setdefault((id(entry), r), []).append(out)
                dsts.append(out)
                offs.append(off)
            if dist_ops.is_float(dtype) and (
                    y.dtype == dtype or dtype != torch.float64):
                cuda_kernels.unpack_scale_cast(y, dsts, offs, factor)
            else:
                for dst, off in zip(dsts, offs):
                    seg = y[off:off + dst.numel()]
                    if int_post is not None:
                        seg = dist_ops.int_postscale(seg, *int_post)
                    dst.view(-1).copy_(seg)
        return results

    def _encode_quantized_rows(self, rows, logical_nbytes, wire):
        """Block-quantize each rank's packed row on the device (kernels
        B2/B4; an f64 row is narrowed to f32 first, as the numpy codec
        does) and account the wire: codes plus one bf16 scale per block
        (engine.py:2276-2296).  Returns (q_rows, s_rows)."""
        q_rows, s_rows = [], []
        for row in rows:
            q, s = quantize_kernels.encode(
                row if row.dtype in quantize_kernels.FLOAT_DTYPES
                else row.float(), wire)
            q_rows.append(q)
            s_rows.append(s)
        self.account_wire(logical_nbytes, q_rows[0].numel()
                           + s_rows[0].numel() * qz.SCALE_BYTES)
        self.quantized_bucket_runs += 1
        return q_rows, s_rows

    def _run_allreduce_bucket(self, ps, bucket):
        """Fused allreduce (MemcpyInFusionBuffer / MemcpyOutFusionBuffer,
        collective_operations.h:38-343) over the bucket's wire, the flat
        branch of ``engine.py:2338-2398``:

        * full width: per local rank one kernel launch packs the members
          into the device fusion buffer with prescale; one reduction over
          the buffers; one launch per rank unpacks with postscale;
        * fp16/bf16: the pack casts to the wire dtype (factor 1), the
          executor's allreduce scales and reduces in it, the unpack casts
          back;
        * int8/int4: the pack keeps the dtype (factor 1), each row is
          encoded on the device, the executor decodes, sums and scales in
          f32, and the unpack casts back: the pre/post scale applies to
          the decoded sum, never before the encode;
        * a hierarchical or torus request that the topology factors runs
          :meth:`_run_allreduce_2d` instead, over the wire pair.

        Joined/missing local ranks contribute zeros."""
        first = next(iter(bucket[0].subs.values()))
        req = first.request
        dtype = first.payloads[0].dtype
        op = req.reduce_op
        pre, post = req.prescale_factor, req.postscale_factor
        layout, total = bucket_layout(bucket)
        nbytes = total * dtype.itemsize
        wire = self._wire_for(req, dtype, op)
        algo, inner = self._algo_plan(ps, req, op)
        self.algo_runs[algo] = self.algo_runs.get(algo, 0) + 1
        if algo != "flat":
            results = self._run_allreduce_2d(ps, bucket, layout, total,
                                             dtype, wire, inner)
            self._finish_allreduce_bucket(ps, bucket, results)
            return
        spans = self._spans_hosts(ps)
        hop = "cross" if spans else "inner"
        if wire is None:
            self.account_wire(nbytes, nbytes, nbytes if spans else 0)
            self._account_hop(hop, None, nbytes)
            red_op, post_f, scaled = dist_ops.allreduce_plan(
                op, dtype, pre, post, ps.size)
            rows = self._pack_rows(ps, bucket, layout, total, dtype, pre,
                                   scaled)
            ys = ps.executor.reduce(rows, red_op)
            results = self._unpack_rows(
                ps, bucket, layout, ys, dtype, post_f,
                (op, ps.size, post) if scaled else None)
        elif wire in qz.WIRE_TORCH_DTYPES:
            wdt = qz.WIRE_TORCH_DTYPES[wire]
            self.account_wire(nbytes, total * 2, total * 2 if spans else 0)
            self._account_hop(hop, wire, total * 2)
            if dtype == torch.float64:
                rows = [row.to(wdt) for row in self._pack_rows(
                    ps, bucket, layout, total, dtype, 1.0)]
            else:
                rows = self._pack_rows(ps, bucket, layout, total, wdt, 1.0)
            ys = ps.executor.allreduce(rows, op, pre, post)
            results = self._unpack_rows(ps, bucket, layout, ys, dtype, 1.0)
        else:
            rows = self._pack_rows(ps, bucket, layout, total, dtype, 1.0)
            q_rows, s_rows = self._encode_quantized_rows(rows, nbytes, wire)
            self._account_hop(hop, wire, q_rows[0].numel()
                              + s_rows[0].numel() * qz.SCALE_BYTES)
            ys = ps.executor.allreduce_quantized(
                q_rows, s_rows, op, pre, post,
                nbits=4 if wire == "int4" else 8, n_elems=total)
            results = self._unpack_rows(ps, bucket, layout, ys, dtype, 1.0)
        self._finish_allreduce_bucket(ps, bucket, results)

    def _run_allreduce_2d(self, ps, bucket, layout, total, dtype, wire,
                          inner):
        """A hierarchical or torus bucket over the wire pair
        (``_dispatch_allreduce_2d``, engine.py:2400-2456): B1 packs each
        rank's members with the pre-scale, the executor's
        :meth:`~..ops.dist_ops.MeshExecutor.allreduce_2d` reducescatters
        over the inner hop, sums the 1/inner shard over the outer hop
        (full width, 16-bit, or the shared-scale int8/int4 sum) and
        post-scales the shard before it gathers back; B1 unpacks.  Only
        the shard crosses the outer hop, at the outer wire's width; its
        bytes count as cross bytes where the set spans hosts, and both
        hops' bytes count in ``hop_wire_bytes``."""
        req = next(iter(bucket[0].subs.values())).request
        itemsize = dtype.itemsize
        m = -(-total // inner)
        inner_wire = self._inner_wire_for(req, wire, dtype)
        iw_width = 2 if inner_wire else itemsize
        # the inner stage moves the payload twice: scatter and gather
        self._account_hop("inner", inner_wire, 2 * total * iw_width)
        if wire in ("int8", "int4"):
            cross = qz.quantized_psum_wire_nbytes(
                m, ps.size // inner, bits=4 if wire == "int4" else 8)
            actual = total * iw_width
            self.quantized_bucket_runs += 1
        else:
            cross = m * (2 if wire in qz.WIRE_TORCH_DTYPES else itemsize)
            actual = total * iw_width if (inner_wire or wire) \
                else total * itemsize
        self.account_wire(total * itemsize, actual,
                          cross if self._spans_hosts(ps) else 0)
        self._account_hop("cross", wire, cross)
        rows = self._pack_rows(ps, bucket, layout, total, dtype,
                               req.prescale_factor)
        ys = ps.executor.allreduce_2d(
            rows, req.reduce_op, 1.0, req.postscale_factor, inner,
            inner_wire=inner_wire, outer_wire=wire)
        return self._unpack_rows(ps, bucket, layout, ys, dtype, 1.0)

    def _finish_allreduce_bucket(self, ps, bucket, results):
        """Hand each local submission its outputs, after the engine
        stream's work."""
        self.allreduce_buckets += 1
        done = self._done_event()
        for entry in bucket:
            for r, sub in self._local_subs(ps, entry).items():
                outs = results[(id(entry), r)]
                sub.handle.set_result(
                    outs if len(sub.payloads) > 1 else outs[0], event=done)

    def _run_allgather(self, ps, entry, aux=None):
        """Allgather with per-rank first-dim sizes: pad to the max rows,
        gather, keep each rank's true rows (engine.py:2482)."""
        subs = self._local_subs(ps, entry)
        self._await_inputs(subs.values())
        first = next(iter(subs.values()))
        results = {r: [] for r in subs}
        dim0s = self._global_dim0s(ps, entry, aux, len(first.payloads))
        for i, ref in enumerate(first.payloads):
            dim0 = dim0s[i]
            rest = tuple(ref.shape[1:])
            rest_n = 1
            for d in rest:
                rest_n *= int(d)
            rows = []
            for r in subs:
                p = subs[r].payloads[i].view(-1)
                buf = torch.zeros(max(dim0) * rest_n, dtype=p.dtype,
                                  device=self.device)
                buf[:p.numel()] = p
                rows.append(buf)
            for r, g in zip(subs, ps.executor.allgather(rows, dim0, rest)):
                results[r].append(g)
        done = self._done_event()
        for r, sub in subs.items():
            outs = results[r]
            sub.handle.set_result(outs if len(outs) > 1 else outs[0],
                                  event=done)

    def _run_allgather_fused(self, ps, bucket, aux=None):
        """Fused allgather bucket (engine.py:2526-2604): every entry's
        tensors pack into ONE flat row per rank, padded to the largest
        rank's total, and ONE gather; each output is cut back out of the
        gathered stream by a slice table."""
        R = ps.size
        tables = []     # (entry, subs, n_tensors, rests, dim0s)
        for entry in bucket:
            subs = self._local_subs(ps, entry)
            ref = next(iter(subs.values()))
            n = len(ref.payloads)
            dim0s = self._global_dim0s(ps, entry, aux, n)
            rests = [tuple(ref.payloads[i].shape[1:]) for i in range(n)]
            tables.append((entry, subs, n, rests, dim0s))
        rest_ns = [[math.prod(r) for r in rests]
                   for _, _, _, rests, _ in tables]
        totals = [sum(dim0s[i][pos] * rns[i]
                      for (_, _, n, _, dim0s), rns in zip(tables, rest_ns)
                      for i in range(n))
                  for pos in range(R)]
        dtype = next(iter(bucket[0].subs.values())).payloads[0].dtype
        local = [r for r in ps.local_ranks if r in bucket[0].subs]
        max_t = max(totals, default=0)
        rows = []
        for r in local:
            parts = [subs[r].payloads[i].reshape(-1)
                     for (_, subs, n, _, _) in tables for i in range(n)]
            self._await_inputs([subs[r] for (_, subs, _, _, _) in tables])
            buf = torch.zeros(max_t, dtype=dtype, device=self.device)
            flat = torch.cat(parts) if parts else buf[:0]
            buf[:flat.numel()] = flat
            rows.append(buf)
        gathered = ps.executor.allgather(rows, totals, ())
        self.fused_allgather_runs += 1
        starts = [sum(totals[:pos]) for pos in range(R)]
        slices, offs = {}, list(starts)
        for pos in range(R):
            for e_idx, ((_, _, n, _, dim0s), rns) in enumerate(
                    zip(tables, rest_ns)):
                for i in range(n):
                    sz = dim0s[i][pos] * rns[i]
                    slices[(e_idx, i, pos)] = (offs[pos], offs[pos] + sz)
                    offs[pos] += sz
        results = []
        for r, g in zip(local, gathered):
            for e_idx, (_, subs, n, rests, dim0s) in enumerate(tables):
                outs = []
                for i in range(n):
                    segs = [g[a:b].view((dim0s[i][pos],) + rests[i])
                            for pos in range(R)
                            for a, b in (slices[(e_idx, i, pos)],)]
                    outs.append(torch.cat(segs, dim=0))
                results.append((subs[r].handle, outs))
        # the event follows every output's kernels
        done = self._done_event()
        for handle, outs in results:
            handle.set_result(outs if len(outs) > 1 else outs[0], event=done)

    @staticmethod
    def _wire_for_alltoall(req, dtype):
        """Effective wire of an exchange (engine.py:2226-2240): with no
        accumulation to commute with, any float payload may ride a narrow
        wire; integers, 'f32' and a 16-bit wire for a 16-bit tensor ship
        full width."""
        if not dist_ops.is_float(dtype):
            return None
        wire = req.wire_dtype
        if wire == "f32":
            return None
        if wire in ("fp16", "bf16") and dtype.itemsize <= 2:
            return None
        return wire

    def _encode_slots(self, ps, r, row, sends, seg_pad, wire, ef):
        """One rank's int8/int4 send row (engine.py:2734-2780): each
        destination slot padded to ``seg_pad`` (whole 256-blocks, so a
        block never spans two peers), the previous exchange's residual
        re-injected inside each slot's current segment when the layout is
        unchanged, encoded (B2/B4 on the card), and the new residual
        ``padded - decode(encode(padded))`` kept.  ``ef`` False is the
        stateless mode: no residual injected, none kept, and an earlier
        one dropped."""
        R = len(sends)
        padded = torch.zeros(R * seg_pad, dtype=torch.float32,
                             device=self.device)
        flat = row.float()
        off = 0
        for dst, ln in enumerate(sends):
            padded[dst * seg_pad:dst * seg_pad + ln] = flat[off:off + ln]
            off += ln
        key = (ps.id, r)
        if not ef:
            self._a2a_ef.pop(key, None)
            return quantize_kernels.encode(padded, wire)
        prev = self._a2a_ef.get(key)
        if prev is not None and prev.shape == padded.shape:
            for dst, ln in enumerate(sends):
                sl = slice(dst * seg_pad, dst * seg_pad + ln)
                padded[sl] += prev[sl]
        elif prev is not None:
            del self._a2a_ef[key]       # layout changed: never carried over
        q, s = quantize_kernels.encode(padded, wire)
        self._a2a_ef[key] = padded - quantize_kernels.decode(
            q, s, R * seg_pad, 4 if wire == "int4" else 8)
        return q, s

    def _run_alltoall(self, ps, bucket, aux=None):
        """Fused alltoall bucket (engine.py:2643-2859), the MoE dispatch
        and combine wire.  The bucket's entries share one (dtype, wire,
        error feedback): their per-destination segments merge into ONE
        exchange.  The wire is full width, fp16/bf16 (a cast each way),
        or int8/int4 with per-peer-slot padding to whole 256-blocks and
        per-slot error feedback (:meth:`_encode_slots`); the receiver
        decodes each source slot against exactly that source's scales
        (B3/B5 on the card).  The counters take rank 0's bytes."""
        R = ps.size
        entries = []
        for e in bucket:
            subs_e = self._local_subs(ps, e)
            first_e = next(iter(subs_e.values()))
            rest_e = tuple(first_e.payloads[0].shape[1:])
            splits_e = self._global_splits(ps, e, aux)
            entries.append((e, subs_e, first_e, rest_e, math.prod(rest_e),
                            splits_e))
        subs0 = entries[0][1]
        req = entries[0][2].request
        local_ranks = list(subs0)
        for (_, subs_e, *_r) in entries:
            self._await_inputs(subs_e.values())
        pdtype = entries[0][2].payloads[0].dtype
        itemsize = pdtype.itemsize
        # comb[src][dst]: elements src sends dst over the whole bucket
        comb = [[sum(sp[src][dst] * rn for (*_h, rn, sp) in entries)
                 for dst in range(R)] for src in range(R)]
        rows = []
        for r in local_ranks:
            p = ps.index[r]
            parts = []
            for dst in range(R):
                for (_, subs_e, _, _, rn, sp) in entries:
                    flat = subs_e[r].payloads[0].reshape(-1)
                    start = sum(sp[p][:dst]) * rn
                    parts.append(flat[start:start + sp[p][dst] * rn])
            rows.append(torch.cat(parts) if parts else
                        torch.zeros(0, dtype=pdtype, device=self.device))
        wire = self._wire_for_alltoall(req, pdtype) if R > 1 else None
        seg = max((comb[s][d] for s in range(R) for d in range(R)),
                  default=0)
        if wire in ("int8", "int4") and seg == 0:
            wire = None
        pos0 = ps.index[local_ranks[0]]
        logical = sum(comb[pos0]) * itemsize
        if wire in ("int8", "int4"):
            seg_pad = -(-seg // qz.BLOCK) * qz.BLOCK
            q_rows, s_rows = [], []
            for i, r in enumerate(local_ranks):
                q, s = self._encode_slots(
                    ps, r, rows[i], comb[ps.index[r]], seg_pad, wire,
                    req.error_feedback)
                q_rows.append(q)
                s_rows.append(s)
            self.account_wire(logical, q_rows[0].numel()
                              + s_rows[0].numel() * qz.SCALE_BYTES)
            self.quantized_bucket_runs += 1
            q_res, s_res = ps.executor.alltoall_codes(q_rows, s_rows)
            bits = 4 if wire == "int4" else 8
            flat_recv = []
            for i, r in enumerate(local_ranks):
                p = ps.index[r]
                full = quantize_kernels.decode(q_res[i], s_res[i],
                                               R * seg_pad, bits)
                flat_recv.append(torch.cat(
                    [full[src * seg_pad:src * seg_pad + comb[src][p]]
                     for src in range(R)]))
        elif wire in qz.WIRE_TORCH_DTYPES:
            wdt = qz.WIRE_TORCH_DTYPES[wire]
            self.account_wire(logical, sum(comb[pos0]) * 2)
            flat_recv, _ = ps.executor.alltoall(
                [row.to(wdt) for row in rows], comb)
        else:
            self.account_wire(logical, logical)
            flat_recv, _ = ps.executor.alltoall(rows, comb)
        # de-interleave: per source, the bucket's segments arrive in entry
        # order, the order the send side concatenated them
        results = []
        for i, r in enumerate(local_ranks):
            p = ps.index[r]
            buf = flat_recv[i]
            per_entry = {id(e): [] for (e, *_rest) in entries}
            off = 0
            for src in range(R):
                for (e, _, _, _, rn, sp) in entries:
                    ln = sp[src][p] * rn
                    per_entry[id(e)].append(buf[off:off + ln])
                    off += ln
            for (e, subs_e, _, rest_e, rn, sp) in entries:
                parts = per_entry[id(e)]
                out = torch.cat(parts).to(pdtype).view((-1,) + rest_e)
                rsp = torch.tensor([sp[src][p] for src in range(R)],
                                   dtype=torch.int32)
                results.append((subs_e[r].handle, out, rsp))
        # the event follows every output's kernels
        done = self._done_event()
        for handle, out, rsp in results:
            handle.set_result(out, event=done, extra=rsp)

    def _scatter_rows(self, subs, i, chunks, rest_n, dtype, factor):
        """Per local rank, payload ``i`` in the padded reducescatter
        layout ``(R * max_chunk * rest,)``: destination rank j's rows at
        ``j * max_chunk * rest``, the padding zero, ``dtype(f32(x) *
        factor)``.  A float payload is one launch of the scale/cast
        kernel per rank over a table of segments (one per destination,
        merged where the source and the layout are both contiguous, which
        leaves two at most at R = 2); integers are copied."""
        R = len(chunks)
        m = max(chunks) * rest_n
        segs, src = [], 0
        for j, c in enumerate(chunks):
            n = c * rest_n
            if segs and segs[-1][0] + segs[-1][2] == src \
                    and segs[-1][1] + segs[-1][2] == j * m:
                segs[-1][2] += n
            elif n:
                segs.append([src, j * m, n])
            src += n
        alloc = torch.empty if sum(chunks) == R * max(chunks) \
            else torch.zeros
        rows = []
        for sub in subs.values():
            flat = sub.payloads[i].reshape(-1)
            buf = alloc(R * m, dtype=dtype, device=self.device)
            if dist_ops.is_float(dtype) and dist_ops.is_float(flat.dtype):
                cuda_kernels.pack_scale_cast(
                    [flat[a:a + n] for a, _, n in segs], buf,
                    [b for _, b, _ in segs], factor)
            else:
                for a, b, n in segs:
                    buf[b:b + n].copy_(flat[a:a + n])
            rows.append(buf)
        return rows

    def _run_reducescatter(self, ps, entry):
        """Reducescatter (engine.py:2860-2964 of the JAX package).  Per
        payload, each local rank's padded row (:meth:`_scatter_rows`),
        then the payload's wire:

        * full width: the pack prescales (floats), the executor reduces,
          scatters and postscales;
        * fp16/bf16: the pack casts to the wire dtype, the executor scales
          and reduces in it, the result is cast back;
        * int8/int4: each row is encoded on the device (B2/B4), the
          executor decodes (B3/B5), sums in f32 and scales by pre * post.

        Grouped entries resolve to a list per rank."""
        subs = self._local_subs(ps, entry)
        self._await_inputs(subs.values())
        first = next(iter(subs.values()))
        req = first.request
        op, pre, post = req.reduce_op, req.prescale_factor, \
            req.postscale_factor
        results = {r: [] for r in subs}
        for i, ref in enumerate(first.payloads):
            dtype = ref.dtype
            d0 = int(ref.shape[0]) if ref.dim() else 1
            rest = tuple(ref.shape[1:])
            rest_n = math.prod(rest)
            chunks = ps.executor.chunk_sizes(d0, ps.size)
            nbytes = ps.size * max(chunks) * rest_n * dtype.itemsize
            wire = self._wire_for(req, dtype, op)
            if wire is None:
                self.account_wire(nbytes, nbytes)
                is_f = dist_ops.is_float(dtype)
                rows = self._scatter_rows(subs, i, chunks, rest_n, dtype,
                                          pre if is_f else 1.0)
                outs = ps.executor.reducescatter(
                    rows, d0, rest, op, 1.0 if is_f else pre, post)
            elif wire in qz.WIRE_TORCH_DTYPES:
                wdt = qz.WIRE_TORCH_DTYPES[wire]
                self.account_wire(nbytes, nbytes // dtype.itemsize * 2)
                if dtype == torch.float64:
                    rows = [row.to(wdt) for row in self._scatter_rows(
                        subs, i, chunks, rest_n, dtype, 1.0)]
                else:
                    rows = self._scatter_rows(subs, i, chunks, rest_n, wdt,
                                              1.0)
                outs = [cuda_kernels.cast(y, dtype) for y in
                        ps.executor.reducescatter(rows, d0, rest, op, pre,
                                                  post)]
            else:
                rows = self._scatter_rows(subs, i, chunks, rest_n, dtype,
                                          1.0)
                q_rows, s_rows = self._encode_quantized_rows(rows, nbytes,
                                                             wire)
                outs = [cuda_kernels.cast(y, dtype) for y in
                        ps.executor.reducescatter_quantized(
                            q_rows, s_rows, d0, rest, op, pre, post,
                            nbits=4 if wire == "int4" else 8,
                            n_elems=s_rows[0].numel() * qz.BLOCK)]
            for r, y in zip(subs, outs):
                results[r].append(y)
        done = self._done_event()
        for r, sub in subs.items():
            outs = results[r]
            sub.handle.set_result(outs if len(outs) > 1 else outs[0],
                                  event=done)

    def _run_broadcast(self, ps, entry):
        subs = self._local_subs(ps, entry)
        self._await_inputs(subs.values())
        first = next(iter(subs.values()))
        root_pos = ps.index.get(first.request.root_rank)
        if root_pos is None:
            for sub in subs.values():
                sub.handle.set_error(HorovodInternalError(
                    f"broadcast root {first.request.root_rank} not in "
                    f"process set {ps.id}"))
            return
        results = {r: [] for r in subs}
        for i, ref in enumerate(first.payloads):
            rows = [subs[r].payloads[i].view(-1) for r in subs]
            for r, o in zip(subs, ps.executor.broadcast(rows, root_pos)):
                out = subs[r].outputs[i] if subs[r].outputs else None
                if out is not None:
                    out.view(-1).copy_(o)
                else:
                    out = o.view(ref.shape)
                results[r].append(out)
        done = self._done_event()
        for r, sub in subs.items():
            outs = results[r]
            sub.handle.set_result(outs if len(outs) > 1 else outs[0],
                                  event=done)

    # ------------------------------------------------------------------

    def abort(self, exc: BaseException):
        """One rank failed -- fail every pending and future collective so
        no rank blocks forever."""
        with self._lock:
            if self._aborted is not None or self._shutdown:
                return
            self._aborted = exc
            self._fail_all_pending_locked(HorovodInternalError(
                f"a peer rank failed: {exc!r}"))
            for ev in self._removal_events.values():
                ev.set()
            self._lock.notify_all()

    def shutdown(self):
        with self._lock:
            if self._shutdown:
                return
            self._shutdown = True
            for ev in self._removal_events.values():
                ev.set()
            self._lock.notify_all()
        # an elastic teardown bounds its wait: an engine thread blocked in
        # a collective with a peer that left the round (an armed bypass
        # vote racing a resize) never returns, and the worker then
        # exec-restarts instead (basics.take_teardown_wedged)
        self._thread.join(timeout=env_mod.get_float(
            env_mod.HOROVOD_TEARDOWN_BARRIER_SECONDS, 10.0)
            if self.config.elastic else 30)
        self.wedged = self._thread.is_alive()
        if self.multiproc:
            # stop beating (with a goodbye) so a clean teardown never
            # reads as a missed-heartbeat death
            self._stop_heartbeat()
        for stream in (self.stream, self.compiled_stream):
            if stream is not None:
                stream.synchronize()
