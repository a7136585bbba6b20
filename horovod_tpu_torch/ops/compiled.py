"""Compiled-step collectives and the compiled train step (port of
``horovod_tpu/ops/compiled.py``).

Where the JAX package jits a program, the port builds a *program*: on the
CPU the plain function; on the card the same function captured once as a
CUDA graph over static input and output tensors and replayed
(:class:`_GraphProgram`).  Its first call runs the function for real
(warm-up: kernel builds, library handles and optimizer buffers come into
being outside any capture), its second call captures and replays, and
every later call copies the inputs that are not the static tensors into
them and replays.  Warm-up plus capture is timed as the compile.

Two deliverables, as in the JAX package:

* :class:`CompiledGroupedAllreduce`: a grouped allreduce as one program
  per shape signature.  Each rank packs its tensors per dtype into a
  fusion buffer with the pre-scale and unpacks the sum with the
  post-scale through the scale/cast kernel B1
  (``cuda_kernels.pack_scale_cast`` / ``unpack_scale_cast``,
  ``ops/csrc/scale_cast.cu``); the sum over the rank rows is the
  executor's.  The 16-bit and shared-scale int8/int4 wires are plain
  torch ops around that sum, with error feedback outside the program.
  The reducer runs eagerly on the card, on the engine's compiled-path
  stream: its inputs are fresh tensors at every call, so a graph would
  only add a copy of each.  :meth:`~CompiledGroupedAllreduce.stream` dispatches
  it bucket by bucket as tensors arrive.
* :func:`make_compiled_train_step`: forward, backward, the reduction
  over the ranks and the optimizer update as one program, on the card
  one CUDA graph.  ``sharded=True`` makes it the weight-update-sharded
  step: the gradients reducescatter (full width, 16-bit or the
  shared-scale int8/int4 wire with its error-feedback residual in the
  state), each rank's optimizer updates its flat 1/R shard of the
  parameters and holds only that shard of the optimizer state, and the
  updated shards gather back into the replicated parameters.

Every member rank must enter the same compiled collective in the same
order with the same shapes: there is no negotiation on this path.  Rank
threads of one process meet at a rendezvous, and the last to arrive
runs the program once for all of them.

Under the launcher every entry point runs over the set's compiled group (``ProcessSetState.compiled_executor``), a
second ``torch.distributed`` group of the same processes: the engine
thread issues its negotiated collectives on the set's own group, and
the compiled path's, issued un-negotiated from the caller's thread (or a
graph's), must never interleave with them on one communicator.  A
process's first call of each signature is checked against its peers'
through the coordinator's KV store (``_validate_signature_cross_process``):
a mismatch raises ``ValueError`` on every process.  A process hosting
several rank threads (the hybrid layout) meets them at one rendezvous,
stacks their rows and runs the group collective once for them all.
How a step's program
runs is decided before any capture, by :func:`capture_rule`: one CUDA
graph on the card when its collectives are stacked or NCCL's (NCCL
inside the graph), the same function uncaptured on the card over gloo
(gloo cannot be captured), the plain function on the CPU.

The JAX package's sharded step needs one device per rank (its shard
mode); the port's rank threads share one device, and each rank owns its
shard of the optimizer state and its error-feedback residual as tensors
of its own, which is the same call contract.

A third deliverable is :class:`CompiledAlltoall`: the equal-split
exchange of the MoE dispatch wire with the int8/int4 codec (B2-B5 on the
card) per destination slot and per-rank error feedback.

The reducer and the sharded step decompose per hop under
``algorithm='hierarchical'``/``'torus'`` or a :class:`TopologyHint`: an
inner (intra-host) and an outer (inter-host) hop, each with its own
wire, over the executor's 2-D grid (``MeshExecutor.allreduce_2d``).

Not ported yet, raising ``NotImplementedError`` naming its ROADMAP.md
item: wire integrity digests (A14).
"""

import contextlib
import math
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.optim.optimizer import _get_scalar_dtype
from torch.utils import _pytree as pytree

from ..common import basics
from ..common import env as env_mod
from ..common.process_sets import ProcessSet, global_process_set
from ..common.topology import normalize_algorithm, plan_decomposition
from ..core.message import Adasum, Average, ReduceOp, Sum
from ..core.sharded import (
    overlap_bucket_splits, overlap_segment_bounds, torch_dtype,
)
from . import cuda_kernels as K
from .adasum import adasum_reduce
from . import quantize as qz
from . import quantize_kernels
from .api import dtype_name
from .dist_ops import is_float

__all__ = [
    "CompiledAlltoall", "CompiledGroupedAllreduce", "CompiledPredict",
    "StagedBatch", "TopologyHint", "batch_signature", "capture_rule",
    "compiled_allreduce", "compiled_alltoall", "compiled_grouped_allreduce",
    "make_compiled_train_step", "program_cache_stats", "shared_program",
    "sharded_state_from_jax",
]

@dataclass(frozen=True)
class TopologyHint:
    """Explicit decomposition of a compiled reduction (``compiled.py:
    70-135`` of the JAX package): named axes and their sizes, the outer
    (slow) axis first.  The hint is part of the program cache key, so the
    same tensors reduced under different hints run distinct programs:
    ``TopologyHint(axes=("dp", "tp"), sizes=(2, 4))`` reduces within each
    tp group first, crosses dp once per shard, then gathers back.  A
    3-axis ``("pp", outer, inner)`` hint names a pipeline stage
    (``pp_stage``) of a job whose stages are separate process sets: the
    pp axis never enters the reduction (``reduce_axes``/``reduce_sizes``
    are the trailing two), it keeps per-stage programs distinct.  Without
    a hint the ``algorithm`` policy derives one from the job topology."""
    axes: Tuple[str, ...] = ("cross", "local")
    sizes: Tuple[int, ...] = (1, 1)
    #: pipeline stage this hint's process set belongs to (only meaningful
    #: with a leading "pp" axis)
    pp_stage: int = 0

    def __post_init__(self):
        if len(self.axes) != len(self.sizes) or \
                len(self.axes) not in (2, 3):
            raise ValueError(
                f"TopologyHint needs matching 2-axis (outer, inner) or "
                f"3-axis (pp, outer, inner) axes/sizes, got "
                f"axes={self.axes} sizes={self.sizes}")
        if len(self.axes) == 3 and self.axes[0] != "pp":
            raise ValueError(
                f"a 3-axis TopologyHint's leading axis must be 'pp', got "
                f"{self.axes[0]!r}")

    @property
    def reduce_axes(self):
        """The (outer, inner) axes the reduction decomposes over."""
        return self.axes[-2:]

    @property
    def reduce_sizes(self):
        return self.sizes[-2:]

    @property
    def inner(self):
        return self.sizes[-1]

    @property
    def outer(self):
        return self.sizes[-2]

    @property
    def pp(self):
        """Pipeline-stage count, 1 when the hint has no pp axis."""
        return self.sizes[0] if len(self.sizes) == 3 else 1

    def key(self):
        return (self.axes, self.sizes, self.pp_stage)


def _check_hint(topology_hint):
    """``topology_hint`` itself, or a ValueError for anything but a
    :class:`TopologyHint` (``compiled.py:470-472``)."""
    if topology_hint is not None and \
            not isinstance(topology_hint, TopologyHint):
        raise ValueError("topology_hint must be a TopologyHint")
    return topology_hint


def _hint_key(topology_hint):
    return topology_hint.key() if topology_hint is not None else None


def _checked_hint_inner(hint, num_ranks):
    """An explicit hint's inner size, checked against the set's size."""
    if hint.outer * hint.inner != num_ranks or hint.inner <= 1 \
            or hint.outer <= 1:
        raise ValueError(
            f"TopologyHint sizes {hint.sizes} do not factor the process "
            f"set's {num_ranks} ranks into a 2-D mesh")
    return hint


# ---------------------------------------------------------------------------
# rank meeting point

def _ps_state(process_set):
    """(engine, set state) of a compiled entry point's set; its
    collectives run on ``ps.compiled_executor``."""
    eng = basics.engine()
    ps_id = 0
    if isinstance(process_set, ProcessSet):
        if process_set.process_set_id is None:
            raise ValueError("process set is not registered")
        ps_id = process_set.process_set_id
    elif process_set is not None:
        ps_id = int(process_set)
    ps = eng.process_sets.get(ps_id)
    if ps is None:
        raise ValueError(f"unknown process set {ps_id}")
    if ps.compiled_executor is None:
        raise ValueError(
            f"process set {ps_id} has no compiled path in this process "
            + ("(it hosts none of the set's ranks)" if ps.executor is None
               else "(the engine was built without a compiled group)"))
    return eng, ps


class _Rendezvous:
    """Meeting point for the local rank threads of one process set: every
    local rank delivers its operand, the LAST arrival runs ``fn`` once on
    all of them, and all pick up its result (or its exception).
    Equivalent per-rank objects meet at one instance through the registry
    of :func:`_rendezvous_for`."""

    # how long to wait for PEERS to arrive; once the leader runs fn
    # (a first call builds kernels and captures) waiters wait on.  A
    # waiter also leaves when the runtime aborts (a peer rank failed).
    ARRIVAL_TIMEOUT = 600

    def __init__(self, n):
        self.n = n
        self._cond = threading.Condition()
        self._slots = {}
        self._result = None
        self._computing = None     # generation the leader is running
        self._generation = 0

    def run(self, pos, value, fn):
        """Deliver ``value`` for participant ``pos``; returns ``fn``'s
        result (computed once per generation on the full slot dict)."""
        with self._cond:
            gen = self._generation
            if pos in self._slots:
                raise RuntimeError(
                    f"participant {pos} entered the compiled collective "
                    "twice in one round (peer missing?)")
            self._slots[pos] = value
            if len(self._slots) == self.n:
                slots, self._slots = self._slots, {}
                self._computing = gen
                try:
                    self._result = (fn(slots), None)
                except BaseException as e:  # propagate to every waiter
                    self._result = (None, e)
                finally:
                    self._computing = None
                self._generation = gen + 1
                self._cond.notify_all()
            else:
                deadline = time.monotonic() + self.ARRIVAL_TIMEOUT
                while self._generation == gen:
                    self._cond.wait(timeout=0.5)
                    if self._generation != gen or self._computing == gen:
                        continue
                    # a peer is missing (or failed, aborting the engine):
                    # take our delivery back so a retry re-enters cleanly
                    aborted = getattr(basics._engine, "_aborted", True)
                    if aborted is not None \
                            or time.monotonic() > deadline:
                        self._slots.pop(pos, None)
                        raise RuntimeError(
                            "compiled collective rendezvous "
                            + ("abandoned: the runtime aborted or shut "
                               "down" if aborted is not None else
                               "timed out (a local rank never arrived)"))
            result, err = self._result
            if err is not None:
                raise err
            return result


def _caller_pos(eng, ps):
    """Position (index into the set's rank list) of the calling rank
    thread; None for a thread bound to no rank."""
    try:
        rank = basics.context().rank
    except Exception:
        return None
    if rank not in ps.index:
        raise ValueError(
            f"rank {rank} is not a member of process set {ps.id}")
    return ps.index[rank]


# process-global registries, cleared by reset_compiled_state (shutdown)
_RDV_REGISTRY = {}
_RDV_LOCK = threading.Lock()
_STEP_COUNTERS = {}
# per-(ps, tag) count of distinct signatures validated across processes,
# and the (ps, tag, signature) triples already validated
_SIG_COUNTERS = {}
_SIG_DONE = set()
# shared program cache: whichever rank leads a round reuses the program
# any earlier leader built (one build, and one capture, per process)
_PROGRAM_CACHE = {}
_PROGRAM_LOCK = threading.Lock()
#: process-wide program-cache counters (the JAX package's telemetry
#: families horovod_program_cache_{hits,misses}_total and
#: horovod_compile_seconds_total; the port has no telemetry package yet,
#: ROADMAP.md A17).  Monotonic over the process's life.
_STATS = {"hits": 0, "misses": 0, "compile_seconds": 0.0,
          "graph": 0, "uncaptured": 0, "reference": 0, "plain": 0}
_STATS_LOCK = threading.Lock()
_EX_UID = [0]


def _count(name, value=1):
    with _STATS_LOCK:
        _STATS[name] += value


def _ex_uid(ex):
    """Stable unique token per executor (id() can be recycled after an
    old executor is garbage-collected)."""
    uid = getattr(ex, "_compiled_uid", None)
    if uid is None:
        with _PROGRAM_LOCK:
            uid = getattr(ex, "_compiled_uid", None)
            if uid is None:
                _EX_UID[0] += 1
                uid = _EX_UID[0]
                ex._compiled_uid = uid
    return uid


def _rendezvous_for(ps, tag, n):
    key = (ps.id, tag)
    with _RDV_LOCK:
        rdv = _RDV_REGISTRY.get(key)
        if rdv is None or rdv.n != n:
            rdv = _Rendezvous(n)
            _RDV_REGISTRY[key] = rdv
        return rdv


def _validate_signature_cross_process(eng, ps, tag, sig):
    """First-call fingerprint exchange over the coordinator's KV store
    (the JAX package's): process A's Nth new signature of a collective
    must equal process B's Nth, or every process raises ``ValueError``;
    a peer that never publishes raises ``RuntimeError`` after
    ``HOROVOD_COMPILED_SIG_TIMEOUT`` seconds.  "New" is per process: a
    signature this process already exchanged under ``tag`` is not sent
    again, whichever of its rank threads' objects leads the call (in the
    hybrid layout the leader of a rendezvous changes from call to call).
    A single-process engine has nothing to exchange."""
    ctl = getattr(eng, "controller", None)
    if ctl is None or ctl.num_procs <= 1:
        return
    import hashlib
    import json

    taghash = hashlib.md5(repr(tag).encode()).hexdigest()[:12]
    fp = json.dumps(sig, sort_keys=True)
    done = (ps.id, taghash, fp)
    with _RDV_LOCK:
        if done in _SIG_DONE:
            return
        seq = _SIG_COUNTERS.get((ps.id, taghash), 0)
        _SIG_COUNTERS[(ps.id, taghash)] = seq + 1
    base = f"/compiled_sig/{ctl.round_id}/{ps.id}/{taghash}/{seq}"
    ctl.client.put(f"{base}/{ctl.proc_id}", fp.encode())
    deadline = time.monotonic() + env_mod.get_int(
        "HOROVOD_COMPILED_SIG_TIMEOUT", 120)
    for p in range(ctl.num_procs):
        if p == ctl.proc_id:
            continue
        raw = ctl.client.get(
            f"{base}/{p}", wait=max(deadline - time.monotonic(), 0.1))
        if raw is None:
            raise RuntimeError(
                f"compiled collective signature exchange timed out "
                f"waiting for process {p} (tag={tag}, seq={seq})")
        if raw.decode() != fp:
            raise ValueError(
                "compiled collective signature mismatch across "
                f"processes (tag={tag}, call #{seq}): this process has "
                f"{fp} but process {p} has {raw.decode()}")
    with _RDV_LOCK:
        _SIG_DONE.add(done)


# ---------------------------------------------------------------------------
# programs

class _TimedFirstCall:
    """A program that is its plain function; its first call lands in the
    compile seconds, as the JAX package times a jitted program's first
    call."""

    __slots__ = ("_fn", "_timed", "compile_seconds")

    def __init__(self, fn):
        self._fn = fn
        self._timed = False
        self.compile_seconds = 0.0

    def __call__(self, *args):
        if self._timed:
            return self._fn(*args)
        t0 = time.perf_counter()
        try:
            return self._fn(*args)
        finally:
            self._timed = True
            self.compile_seconds = time.perf_counter() - t0
            _count("compile_seconds", self.compile_seconds)


class _GraphProgram:
    """``fn`` as one CUDA graph on the card.

    Call 1 runs ``fn`` for real on the capture stream (warm-up: lazy
    kernel builds, cuBLAS/cuDNN handles and workspaces for that stream,
    optimizer buffers); its result is ``fn``'s own.  Call 2 captures
    ``fn`` over that call's inputs, which become the static inputs, and
    replays the graph.  Later calls copy every input tensor that is not
    the static one into it (same shape and dtype, or ValueError) and
    replay.  ``leaves(*args)`` lists the input tensors (by default the
    pytree leaves of the arguments; non-tensor leaves must not change).

    Warm-up and capture run on one thread of the program's own, whatever
    rank thread leads the call: cuDNN and cuBLAS keep their handles per
    thread, and a handle first made inside a capture invalidates it.
    Capture runs in ``"thread_local"`` mode, so another thread's CUDA
    calls (the engine's) cannot invalidate it; a failed capture raises.
    Replays run on the caller's current stream.  The outputs of a replay
    are the graph's static tensors, which the next replay overwrites:
    callers copy what they keep.  Warm-up plus capture are timed as the
    compile."""

    def __init__(self, fn, device, leaves=None):
        self._fn = fn
        self._leaves = leaves or (lambda *args: pytree.tree_leaves(args))
        self.device = device
        self._stream = None
        self._graph = None
        self._static_in = None
        self._static_out = None
        self._worker = None
        self.compile_seconds = 0.0
        #: captures and replays so far (one capture per program)
        self.captures = 0
        self.replays = 0

    def __call__(self, *args):
        if self._graph is None:
            warmup = self._stream is None
            t0 = time.perf_counter()
            try:
                out = self._on_own_thread(
                    self._warmup if warmup else self._capture, args)
            finally:
                dt = time.perf_counter() - t0
                self.compile_seconds += dt
                _count("compile_seconds", dt)
            if warmup:
                return out
        else:
            self._load(self._leaves(*args))
        self._graph.replay()
        self.replays += 1
        return self._static_out

    def _on_own_thread(self, step, args):
        if self._worker is None:
            self._worker = ThreadPoolExecutor(
                1, thread_name_prefix="hvd-graph")
        cur = torch.cuda.current_stream(self.device)
        ctx = getattr(basics._tls, "ctx", None)

        def run():
            torch.cuda.set_device(self.device)
            with basics.bound_context(ctx):
                return step(args, cur)
        failed = True
        try:
            out = self._worker.submit(run).result()
            failed = False
            return out
        finally:
            if failed or self._graph is not None:
                self._worker.shutdown()
                self._worker = None

    def _warmup(self, args, cur):
        s = torch.cuda.Stream(self.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            out = self._fn(*args)
        cur.wait_stream(s)
        # tensors made on the capture stream and used on the caller's
        for t in pytree.tree_leaves(out):
            if torch.is_tensor(t) and t.device.type == "cuda":
                t.record_stream(cur)
        self._stream = s
        return out

    def _capture(self, args, cur):
        static_in = list(self._leaves(*args))
        graph = torch.cuda.CUDAGraph()
        # (entering the capture synchronizes the device: the inputs the
        # caller's stream made are ready)
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            out = self._fn(*args)
        self._static_in, self._static_out = static_in, out
        self._graph = graph
        self.captures += 1
        return out

    @torch.no_grad()
    def _load(self, leaves):
        leaves = list(leaves)
        if len(leaves) != len(self._static_in):
            raise ValueError(
                f"program captured over {len(self._static_in)} inputs "
                f"called with {len(leaves)}")
        for new, old in zip(leaves, self._static_in):
            if new is old:
                continue
            if not torch.is_tensor(old):
                if new != old:
                    raise ValueError(f"program captured with the constant "
                                     f"{old!r} called with {new!r}")
                continue
            if not torch.is_tensor(new) or new.shape != old.shape \
                    or new.dtype != old.dtype:
                raise ValueError(
                    f"program captured over a {old.dtype} "
                    f"{tuple(old.shape)} input called with "
                    f"{getattr(new, 'dtype', type(new).__name__)} "
                    f"{tuple(getattr(new, 'shape', ()))}")
            old.copy_(new)


def capture_rule(device, backend=None):
    """How a program whose collectives ride ``backend`` runs on
    ``device``, decided before any capture: ``"graph"`` (one CUDA graph:
    CUDA tensors whose collectives are stacked, ``backend`` None, or
    NCCL's, captured inside the graph), ``"uncaptured"`` (CUDA tensors
    over any other backend, gloo: it cannot be captured, so the same
    function runs uncaptured on the card) or ``"plain"`` (the CPU)."""
    if torch.device(device).type != "cuda":
        return "plain"
    return "graph" if backend in (None, "nccl") else "uncaptured"


def executor_backend(ex, device):
    """The backend carrying ``device``'s tensors over executor ``ex``'s
    group (``"nccl"``, ``"gloo"``), or None for a stacked executor."""
    if ex is None or ex.stacked:
        return None
    group = ex.group
    get = getattr(group, "_get_backend", None)
    if get is not None:
        return get(torch.device(device)).name()
    return group.name()


def _make_program(fn, device, leaves=None, capture=True, backend=None):
    """The program of ``fn`` for ``device`` by :func:`capture_rule`: a
    CUDA graph on the card, the same function uncaptured on the card over
    a backend that cannot be captured, the plain function on the CPU.
    ``capture=False`` runs a would-be graph uncaptured: the reference a
    graph is checked against.  Each program built counts under its rule
    (``"reference"`` for ``capture=False``) in
    :func:`program_cache_stats`."""
    rule = capture_rule(device, backend)
    if rule == "graph" and not capture:
        rule = "reference"
    _count(rule)
    if rule == "graph":
        return _GraphProgram(fn, device, leaves)
    return _TimedFirstCall(fn)


def _shared_program(key, builder):
    with _PROGRAM_LOCK:
        prog = _PROGRAM_CACHE.get(key)
        if prog is None:
            _count("misses")
            prog = builder()
            _PROGRAM_CACHE[key] = prog
        else:
            _count("hits")
        return prog


def shared_program(key, builder):
    """Public entry to the process-wide program cache: the cached program
    for ``key``, or ``builder()`` (a zero-argument callable returning a
    program) built once.  Hits and misses land in
    :func:`program_cache_stats`.  Keys are namespaced by the caller."""
    return _shared_program(key, builder)


def program_cache_stats(by_rule=False):
    """(hits, misses) of the process-wide program cache as integers, for
    asserting zero steady-state rebuilds.  ``by_rule=True`` returns a
    dict of those and of the step programs built under each
    :func:`capture_rule` outcome: ``graph`` (CUDA graphs), ``uncaptured``
    (on the card over gloo), ``reference`` (``capture=False``) and
    ``plain`` (the CPU)."""
    with _STATS_LOCK:
        if by_rule:
            return {k: int(v) for k, v in _STATS.items()
                    if k != "compile_seconds"}
        return int(_STATS["hits"]), int(_STATS["misses"])


# ---------------------------------------------------------------------------
# grouped allreduce

class CompiledGroupedAllreduce:
    """Grouped allreduce as ONE program per shape signature (the
    reference's ``xla_mpi_ops.cc:185-307`` role).

    Call per local rank with a list of tensors on the runtime's device
    (or anything ``torch.as_tensor`` takes); returns the reduced tensors,
    same shapes and dtypes, new tensors per rank.  All member ranks must
    call with the same signature.  Instances with the same (op, scales,
    process set, name, wire) meet at one rendezvous.

    ``wire_dtype`` 'bf16'/'fp16' sums the fusion buffer at half width;
    'int8'/'int4' quantizes it against a per-256-block scale SHARED by the
    ranks (the max of their bf16-rounded absmax), sums the integer codes
    and decodes once; ``error_feedback`` then adds each rank's local
    quantization error into its next payload.  ``bucket_bytes`` (or
    ``HOROVOD_OVERLAP_BUCKET_BYTES``, latched once per call or stream)
    splits the plan into buckets, each its own program, bit for bit the
    grouped result.

    ``algorithm`` 'hierarchical'/'torus' (or a :class:`TopologyHint`,
    which implies torus) makes each buffer's program the executor's 2-D
    decomposition (``MeshExecutor.allreduce_2d``): ``wire_dtype`` is then
    the outer hop's wire and ``wire_inner`` the inner hop's, and error
    feedback keeps each rank's residual of its 1/inner shard of the outer
    hop.  The policy derives the grid from the job's host map and runs
    flat where it does not factor (``last_algorithm`` says which ran)."""

    def __init__(self, op=Average, prescale_factor=1.0,
                 postscale_factor=1.0, process_set=global_process_set,
                 name=None, force_program=False, wire_dtype=None,
                 error_feedback=False, algorithm=None,
                 topology_hint=None, wire_inner=None,
                 bucket_bytes=None):
        op = ReduceOp(op)
        if op not in (Average, Sum):
            raise ValueError(
                "compiled allreduce supports Average and Sum (the "
                "reference XLA op surface, xla_mpi_ops.cc:558-603)")
        self.op = op
        self.prescale = float(prescale_factor)
        self.postscale = float(postscale_factor)
        self.process_set = process_set
        self.name = name
        # run the program even at world size 1 (no host-copy shortcut)
        self.force_program = bool(force_program)
        self.algorithm = normalize_algorithm(algorithm)
        self.topology_hint = _check_hint(topology_hint)
        if topology_hint is not None and self.algorithm in (None, "flat"):
            self.algorithm = "torus"
        self.wire_dtype = qz.normalize_wire_dtype(wire_dtype)
        if self.wire_dtype == "f32":
            self.wire_dtype = None
        # the inner hop's wire, acting under a decomposition only
        self.wire_inner = qz.normalize_inner_wire(wire_inner)
        self.error_feedback = bool(error_feedback) \
            and self.wire_dtype in ("int8", "int4")
        self.bucket_bytes = None if bucket_bytes is None \
            else int(bucket_bytes)
        # (skey, pos, buf_idx) -> the rank's f32 residual: of its whole
        # buffer (flat), of its 1/inner shard (decomposed)
        self._residuals = {}
        #: wire accounting of the most recent call; the cross bytes are
        #: those over the slow (outer) hop
        self.last_logical_bytes = 0
        self.last_wire_bytes = 0
        self.last_cross_bytes = 0
        #: the algorithm the most recent call ran ('flat' where the policy
        #: degraded)
        self.last_algorithm = "flat"
        self._programs = {}
        self._validated = set()  # sigs fingerprint-checked across procs
        self._ex = None          # executor the cached programs target
        self._lock = threading.Lock()

    # -- program construction ------------------------------------------------

    def _signature(self, arrays):
        return tuple((tuple(a.shape), dtype_name(a.dtype)) for a in arrays)

    def _plan(self, arrays):
        return self._plan_from_sig(self._signature(arrays))

    @staticmethod
    def _plan_from_sig(sig):
        """Group members by dtype: ``[(dtype, [(index, size, shape)])]``
        in sorted dtype order (the per-dtype fusion buffers)."""
        groups = {}
        for i, (shape, dtype) in enumerate(sig):
            size = 1
            for s in shape:
                size *= int(s)
            groups.setdefault(str(dtype), []).append(
                (i, size, tuple(shape)))
        return [(d, groups[d]) for d in sorted(groups)]

    def _bucketize(self, plan, bucket_bytes, hint=None):
        """Split the plan into bucket miniplans, each a contiguous
        single-dtype slice of members dispatched as its own program;
        block-aligned under a flat quantized wire, so every bucket's
        shared scales are the grouped buffer's.  ``bucket_bytes`` <= 0
        keeps one bucket."""
        if bucket_bytes is None or bucket_bytes <= 0:
            return [plan]
        minis = []
        for dtype, members in plan:
            align = qz.BLOCK if hint is None and self._wire_use(dtype) in (
                "int8", "int4") else 1
            for s, e in overlap_bucket_splits(
                    [m[1] for m in members], torch_dtype(dtype).itemsize,
                    bucket_bytes, align=align):
                minis.append([(dtype, members[s:e])])
        return minis

    def _wire_use(self, dtype):
        """Effective wire of one plan buffer: float buffers follow the
        configured wire, a 16-bit wire is a no-op for 16-bit tensors, and
        integer buffers ship full width."""
        dt = torch_dtype(dtype)
        if not is_float(dt):
            return None
        use = self.wire_dtype
        if use in ("bf16", "fp16") and dt.itemsize == 2:
            return None
        return use

    def _inner_wire_use(self, dtype):
        """The inner hop's effective wire of one plan buffer under a
        decomposition (``quantize.effective_inner_wire``)."""
        dt = torch_dtype(dtype)
        if not is_float(dt):
            return None
        return qz.effective_inner_wire(self.wire_inner, self.wire_dtype,
                                       dt.itemsize)

    def _resolve_hint(self, eng, ps, ex):
        """The call's :class:`TopologyHint`, or None (flat): an explicit
        hint checked against the set's size, else the algorithm policy's
        grid over the job topology (``compiled.py:617-643``)."""
        if self.algorithm in (None, "flat"):
            return None
        if self.topology_hint is not None:
            return _checked_hint_inner(self.topology_hint, ex.num_ranks)
        inner = plan_decomposition(self.algorithm, eng.topology, ps.ranks)
        if inner is None:
            return None
        axes = ("cross", "local") if self.algorithm == "hierarchical" \
            else ("hvd_y", "hvd_x")
        return TopologyHint(axes=axes, sizes=(ex.num_ranks // inner, inner))

    def _build_2d(self, ex, plan, hint):
        """The decomposed program of one plan (``compiled.py:645-753``):
        per buffer the executor's :meth:`~.dist_ops.MeshExecutor.
        allreduce_2d` over the hint's grid, with the buffer's inner and
        outer wires; the post-scale (/R for Average) applies to the
        reduced shard, so the unpack's factor is 1.  ``res[j]``, the local
        ranks' stacked ``(L, m)`` residuals of a quantized buffer under
        error feedback, is updated in place and handed back."""
        R = ex.num_ranks
        op, post = self.op, self.postscale
        post_scale = post / R if op == Average else post

        def prog(bufs, res):
            outs = []
            for rows, (dtype, _), r in zip(bufs, plan, res):
                dt = torch_dtype(dtype)
                if not is_float(dt) and op == Average:
                    raise ValueError("Average needs floating-point tensors")
                y = ex.allreduce_2d(
                    rows, ReduceOp.SUM, 1.0,
                    post_scale if is_float(dt) else 1.0, hint.inner,
                    inner_wire=self._inner_wire_use(dtype),
                    outer_wire=self._wire_use(dtype), residual=r)[0]
                outs.append((y, 1.0, r))
            return outs

        return prog

    def _build(self, ex, plan, hint=None):
        """The program of one plan: ``prog(bufs, res) -> [(y, factor,
        resid)]`` where ``bufs[j]`` holds the local ranks' packed rows of
        plan buffer j, ``y`` their reduction before the post-scale,
        ``factor`` the scale the unpack applies (the post-scale, /R for
        Average), and ``resid`` the local ranks' ``(L, n)`` quantization
        errors of a quantized buffer (for error feedback), else None.  The
        sums are the executor's.  A hint builds :meth:`_build_2d`."""
        if hint is not None:
            return self._build_2d(ex, plan, hint)
        R = ex.num_ranks
        op, pre, post = self.op, self.prescale, self.postscale
        post_scale = post / R if op == Average else post
        out_scale = pre * post / R if op == Average else pre * post

        def reduce_quantized(rows, bits):
            # the scale is SHARED: the max over ranks of the bf16-rounded
            # local absmax, so every rank's codes are on one grid
            y, resid = qz.quantized_psum_ef(
                torch.stack([r.float() for r in rows]), bits, R,
                lambda t: ex.reduce(list(t.unbind(0)), ReduceOp.MAX)[0],
                lambda q: ex.reduce(list(q.unbind(0)), ReduceOp.SUM)[0])
            return y, out_scale, resid

        def reduce_buf(rows, dtype):
            dt = torch_dtype(dtype)
            use = self._wire_use(dtype)
            if use in ("int8", "int4"):
                y, factor, resid = reduce_quantized(
                    rows, 8 if use == "int8" else 4)
            elif use in ("bf16", "fp16"):
                wdt = qz.WIRE_TORCH_DTYPES[use]
                y = ex.reduce([r.to(wdt) for r in rows], ReduceOp.SUM)[0]
                factor, resid = post_scale, None
            else:
                if not is_float(dt) and op == Average:
                    raise ValueError("Average needs floating-point tensors")
                y = ex.reduce(rows, ReduceOp.SUM)[0]
                factor, resid = post_scale, None
            if torch.float64 in (y.dtype, dt) and y.dtype != dt:
                y = y.to(dt)     # B1 scales an f64 tensor only in f64
            return y, factor, resid

        def prog(bufs, res):
            return [reduce_buf(rows, d) for rows, (d, _) in zip(bufs, plan)]

        return prog

    def _program(self, ex, sig, plan, hint=None):
        with self._lock:
            if self._ex is not ex:
                # the engine re-initialized: programs for the old world
                # size would mis-average, and the residuals belong to the
                # old run
                self._programs.clear()
                self._validated.clear()
                self._residuals.clear()
                self._ex = ex
            entry = self._programs.get(sig)
            if entry is None:
                key = ("reduce", _ex_uid(ex), int(self.op), self.prescale,
                       self.postscale, self.wire_dtype, self.wire_inner,
                       self.error_feedback, _hint_key(hint), sig)
                entry = _shared_program(key, lambda: _TimedFirstCall(
                    self._build(ex, plan, hint)))
                self._programs[sig] = entry
            else:
                _count("hits")
            return entry

    # -- packing -------------------------------------------------------------

    def _pack_factor(self, dtype, hint):
        # a flat quantized buffer's pre-scale rides the decode (it is
        # linear); a decomposition pre-scales before anything, as the JAX
        # program does
        return 1.0 if hint is None and self._wire_use(dtype) in (
            "int8", "int4") else self.prescale

    def _pack(self, vals, plan, hint=None):
        """One fusion buffer per dtype; float members packed by B1 with
        the pre-scale."""
        bufs = []
        for dtype, members in plan:
            srcs = [vals[i] for i, _, _ in members]
            dt = torch_dtype(dtype)
            if not is_float(dt):
                bufs.append(torch.cat([s.reshape(-1) for s in srcs]))
                continue
            offsets, n = [], 0
            for _, size, _ in members:
                offsets.append(n)
                n += size
            buf = torch.empty(n, dtype=dt, device=srcs[0].device)
            K.pack_scale_cast(srcs, buf, offsets,
                              self._pack_factor(dtype, hint))
            bufs.append(buf)
        return bufs

    @staticmethod
    def _unpack(outs, plan):
        """Each member's result, by its index in the signature: float
        members unpacked by B1 with the program's factor, integer ones
        copied out."""
        results = {}
        for (y, factor, _), (dtype, members) in zip(outs, plan):
            dt = torch_dtype(dtype)
            offsets, n = [], 0
            for _, size, _ in members:
                offsets.append(n)
                n += size
            if is_float(dt):
                dsts = [torch.empty(shape, dtype=dt, device=y.device)
                        for _, _, shape in members]
                K.unpack_scale_cast(y, dsts, offsets, factor)
            else:
                dsts = [y.narrow(0, off, size).reshape(shape).clone()
                        for (_, size, shape), off in zip(members, offsets)]
            for (i, _, _), d in zip(members, dsts):
                results[i] = d
        return results

    # -- execution -----------------------------------------------------------

    def _validate(self, arrays):
        """World-size-independent validation (engine api rules)."""
        for a in arrays:
            if not is_float(a.dtype):
                if self.op == Average:
                    raise ValueError(
                        "Averaging is not supported for integer "
                        "tensors; use op=Sum")
                if self.prescale != 1.0 or self.postscale != 1.0:
                    raise ValueError("prescale/postscale require "
                                     "floating-point tensors")

    def _account_wire(self, plan, num_ranks, hint=None, multihost=False):
        """Per-rank interconnect bytes of the programs
        (``compiled.py:982-1031``).  A flat quantized program's transport
        is its integer partial sums (the narrowest exact accumulator) plus
        the bf16 absmax.  Under a decomposition only the 1/inner shard
        crosses the outer hop, at the outer wire's width, and the inner
        hops ship the inner wire.  Cross bytes: a flat program's whole
        wire when the job spans hosts; a policy's decomposition its
        shard's bytes when the job spans hosts; an explicit hint's outer
        axis is declared slow, so always its shard's."""
        logical = wire = cross = 0
        for dtype, members in plan:
            n = sum(size for _, size, _ in members)
            itemsize = torch_dtype(dtype).itemsize
            logical += n * itemsize
            use = self._wire_use(dtype)
            if hint is not None:
                m = -(-n // hint.inner)
                wire += n * (2 if self._inner_wire_use(dtype) else itemsize)
                if use in ("int8", "int4"):
                    cross += qz.quantized_psum_wire_nbytes(
                        m, hint.outer, bits=8 if use == "int8" else 4)
                else:
                    cross += m * (2 if use in ("bf16", "fp16")
                                  else itemsize)
            elif use in ("int8", "int4"):
                wire += qz.quantized_psum_wire_nbytes(
                    n, num_ranks, bits=8 if use == "int8" else 4)
            else:
                wire += qz.wire_nbytes(n, use, itemsize)
        self.last_logical_bytes = logical
        self.last_wire_bytes = wire
        if hint is None:
            self.last_cross_bytes = wire if multihost else 0
        elif self.topology_hint is not None:
            self.last_cross_bytes = cross
        else:
            self.last_cross_bytes = cross if multihost else 0
        self.last_algorithm = "flat" if hint is None else self.algorithm

    def _apply_residuals(self, sig, pos, bufs, plan):
        """Error feedback of a flat program, inject side: add the
        previous call's local quantization error into this call's payload
        (EF21)."""
        out = []
        for k, (buf, (dtype, _)) in enumerate(zip(bufs, plan)):
            r = self._residuals.get((sig, pos, k))
            if r is None or self._wire_use(dtype) not in ("int8", "int4"):
                out.append(buf)
            else:
                out.append((buf.float() + r).to(buf.dtype))
        return out

    def _hop_residuals(self, sig, pos, plan, hint):
        """Error feedback of a decomposed program: this rank's residual of
        its 1/inner shard per quantized buffer (zeros at first), which the
        program adds after the inner scatter and replaces."""
        out = []
        for k, (dtype, members) in enumerate(plan):
            if self._wire_use(dtype) not in ("int8", "int4"):
                out.append(None)
                continue
            r = self._residuals.get((sig, pos, k))
            if r is None:
                n = sum(size for _, size, _ in members)
                r = torch.zeros(-(-n // hint.inner), dtype=torch.float32,
                                device=basics.engine().device)
            out.append(r)
        return out

    def _update_residuals(self, sig, pos, outs, ex):
        """Error feedback, measure side: keep this rank's row of each
        quantized buffer's new residuals, measured against the SHARED
        scales inside the program."""
        row = ex.local_positions.index(pos)
        for k, (_y, _f, resid) in enumerate(outs):
            if resid is not None:
                self._residuals[(sig, pos, k)] = resid[row]

    def reset_wire_state(self):
        """Drop every error-feedback residual this reducer holds (elastic
        resize, checkpoint restore)."""
        with self._lock:
            self._residuals.clear()

    def stream(self, specs):
        """Open a bucket-granular dispatch stream: declare the signature
        up front (``specs``: tensors or ``(shape, dtype)`` templates in
        call order), then ``push(i, tensor)`` each tensor as backward
        produces it and ``result()`` at the end of the step.  A bucket
        launches the moment its members are all delivered, strictly in
        plan order."""
        return _BucketStream(self, specs)

    def __call__(self, arrays):
        arrays = list(arrays)
        if not arrays:
            return []
        # the grouped call IS a degenerate stream: everything pushed at
        # once, one code path for both dispatch modes
        st = _BucketStream(self, arrays)
        for i, a in enumerate(arrays):
            st.push(i, a)
        return st.result()


def _mini_sig(mp):
    """Member-order (shape, dtype) signature of one bucket miniplan — the
    bucket program's cache key."""
    return tuple((shape, dtype) for dtype, members in mp
                 for _i, _sz, shape in members)


class _BucketStream:
    """One bucket-granular dispatch round over a
    :class:`CompiledGroupedAllreduce`.

    Buckets launch strictly in plan order on every rank, whatever the
    push order.  The bucket size is latched once, at construction.  On
    the card a bucket's work (pack, sum, unpack, error feedback) runs on
    the engine's compiled-path stream after an event of the pushing
    stream, and ends in an event; ``result()`` makes the caller's stream
    wait only on the buckets still in flight.  Error-feedback residuals
    are keyed per (signature, bucket size, bucket)."""

    def __init__(self, red, specs):
        self.red = red
        sig = []
        for t in specs:
            if isinstance(t, tuple) and len(t) == 2 \
                    and not hasattr(t, "dtype"):
                shape, dtype = t
                sig.append((tuple(int(s) for s in shape),
                            dtype_name(dtype)))
            else:
                sig.append((tuple(t.shape), dtype_name(t.dtype)))
        self.sig = tuple(sig)
        self.n = len(sig)
        eng, ps = _ps_state(red.process_set)
        if eng.config.integrity:
            raise NotImplementedError(
                "wire integrity digests on the compiled path are not "
                "ported yet (ROADMAP.md A14); unset HOROVOD_INTEGRITY")
        self.eng, self.ps = eng, ps
        ex = ps.compiled_executor
        self.ex = ex
        self.device = eng.device
        self.side = eng.compiled_stream
        self.trivial = ex.num_ranks == 1 and not red.force_program
        self._vals = {}        # index -> delivered tensor
        self._inflight = []    # (results, done event)
        self._next = 0         # next bucket to launch
        self._done = False
        if self.trivial:
            self.bucket_bytes = 0
            self.buckets = []
            return
        bb = red.bucket_bytes
        if bb is None:
            bb = eng.config.overlap_bucket_bytes
        self.bucket_bytes = bb
        self.plan = red._plan_from_sig(self.sig)
        self.hint = red._resolve_hint(eng, ps, ex)
        red._account_wire(self.plan, ex.num_ranks, self.hint,
                          eng._spans_hosts(ps))
        self.buckets = red._bucketize(self.plan, bb, self.hint)
        # the grouped bucket keeps the caller-order signature (the legacy
        # cache key); buckets key on their own members
        self._progs = []
        for mp in self.buckets:
            bsig = self.sig if bb <= 0 else _mini_sig(mp)
            self._progs.append((red._program(ex, bsig, mp, self.hint),
                                bsig))
        n_local = len(ex.local_positions)
        if n_local == 1:
            self.pos = ex.local_positions[0]
            self.rdv = None
        else:
            self.pos = _caller_pos(eng, ps)
            if self.pos is None:
                raise ValueError(
                    "unbound caller: compiled collectives need a rank "
                    "context (call inside hvd.run)")
            self.rdv = _rendezvous_for(ps, self._tag(), n_local)

    def _tag(self):
        # the rendezvous identity; bucket_bytes deliberately excluded
        red = self.red
        return ("reduce", int(red.op), red.prescale, red.postscale,
                red.name, red.wire_dtype, red.wire_inner,
                red.error_feedback, _hint_key(getattr(self, "hint", None)))

    # -- delivery ------------------------------------------------------------

    def push(self, i, array):
        """Deliver tensor ``i`` (its position in the declared signature);
        launches every bucket whose members are now complete, in bucket
        order."""
        if self._done:
            raise RuntimeError("stream already finalized")
        if torch.is_tensor(array):
            if array.device != self.device:
                raise ValueError(f"tensor is on {array.device} but "
                                 f"horovod_tpu_torch runs on {self.device}")
            a = array.detach().contiguous()
        else:
            a = torch.as_tensor(array, device=self.device)
        if (tuple(a.shape), dtype_name(a.dtype)) != self.sig[i]:
            raise ValueError(
                f"pushed tensor {i} has ({tuple(a.shape)}, {a.dtype}) but "
                f"the stream declared {self.sig[i]}")
        if i in self._vals:
            raise RuntimeError(
                f"tensor {i} pushed twice in one stream round")
        self.red._validate([a])
        self._vals[i] = a
        if not self.trivial:
            self._advance()

    def _advance(self):
        while self._next < len(self.buckets):
            mp = self.buckets[self._next]
            if any(i not in self._vals
                   for _d, members in mp for i, _s, _sh in members):
                return
            self._launch_bucket(self._next, mp)
            self._next += 1

    @contextlib.contextmanager
    def _on_side(self, members):
        """Run the block on the compiled-path stream after the caller's
        stream, with the members' memory held for it; yields the caller's
        stream (None on the CPU)."""
        if self.side is None:
            yield None
            return
        cur = torch.cuda.current_stream(self.device)
        self.side.wait_stream(cur)
        for t in members:
            t.record_stream(self.side)
        with torch.cuda.stream(self.side):
            yield cur

    def _launch_bucket(self, k, mp):
        red, ex, eng, ps = self.red, self.ex, self.eng, self.ps
        bb = self.bucket_bytes
        prog, bsig = self._progs[k]
        skey = (self.sig, bb, k)
        vkey = (self.sig, bb)
        members = [self._vals[i] for _d, ms in mp for i, _s, _sh in ms]

        hint = self.hint

        def launch(slot_values):
            # slot_values: {pos: ((bsig, k), [buf per dtype], [residual
            # per dtype] or None)}; every local rank must bring the SAME
            # bucket of the SAME signature
            sigs = {p: v[0] for p, v in slot_values.items()}
            if len(set(sigs.values())) > 1:
                raise ValueError(
                    "compiled collective signature mismatch across "
                    f"local ranks: {sigs} — every member rank must call "
                    "with identical shapes/dtypes in the same order")
            if vkey not in red._validated:
                _validate_signature_cross_process(
                    eng, ps, self._tag(), (self.sig, bb))
                with red._lock:
                    red._validated.add(vkey)
            order = ex.local_positions
            rows = [[slot_values[p][1][j] for p in order]
                    for j in range(len(mp))]
            res = [None] * len(mp)
            if hint is not None and red.error_feedback:
                res = [None if slot_values[order[0]][2][j] is None
                       else torch.stack([slot_values[p][2][j]
                                         for p in order])
                       for j in range(len(mp))]
            return prog(rows, res)

        with self._on_side(members) as cur:
            bufs = red._pack(self._vals, mp, hint)
            res = None
            if red.error_feedback:
                if hint is None:
                    bufs = red._apply_residuals(skey, self.pos, bufs, mp)
                else:
                    res = red._hop_residuals(skey, self.pos, mp, hint)
            value = ((bsig, k), bufs, res)
            if self.rdv is None:
                outs = launch({self.pos: value})
            else:
                outs = self.rdv.run(self.pos, value, launch)
            results = red._unpack(outs, mp)
            if red.error_feedback:
                red._update_residuals(skey, self.pos, outs, ex)
            done = None
            if cur is not None:
                done = torch.cuda.Event()
                done.record(self.side)
                for t in results.values():
                    t.record_stream(cur)
        self._inflight.append((results, done))

    # -- completion ----------------------------------------------------------

    def result(self):
        """Order the caller's stream after every in-flight bucket and
        return the reduced tensors in the declared order."""
        if self._done:
            raise RuntimeError("stream already finalized")
        if len(self._vals) != self.n:
            missing = [i for i in range(self.n) if i not in self._vals]
            raise RuntimeError(
                "result() called before every declared tensor was "
                f"pushed (missing {missing})")
        self._done = True
        red = self.red
        if self.trivial:
            scale = red.prescale * red.postscale
            return [K.fused_scale_cast(a, scale)
                    if scale != 1.0 and is_float(a.dtype) else a.clone()
                    for a in (self._vals[i] for i in range(self.n))]
        results = {}
        for res, done in self._inflight:
            if done is not None and not done.query():
                torch.cuda.current_stream(self.device).wait_event(done)
            results.update(res)
        return [results[i] for i in range(self.n)]


# error-feedback residuals of the compiled alltoall, one per (executor,
# exchange identity, signature, rank position): each rank's residual is its
# own entry, so one rank's reset_wire_state() never drops a peer's (the JAX
# package's shared key races across rank threads, ROADMAP.md C)
_A2A_EF = {}
_A2A_EF_LOCK = threading.Lock()


class CompiledAlltoall:
    """Equal-split alltoall with its wire codec in one program (port of
    ``horovod_tpu/ops/compiled.py:1548-1800``): the MoE expert dispatch
    and combine wire, without negotiation.

    Call per local rank with a tensor whose first dimension divides by
    the set size R: slot j (``x.shape[0] / R`` rows) goes to rank j, and
    slot j of the result came from rank j.  A ragged exchange is refused
    (it rides ``hvd.alltoall``).  On the int8/int4 wire each destination
    slot is padded to whole 256-element blocks, so a block never spans
    two peers: the slot's codes and bf16 scales are what moves, and the
    receiver decodes each slot against its sender's scales (B2/B4 encode
    and B3/B5 decode on the card).  ``error_feedback`` keeps each rank's
    per-slot quantization residual and adds it to that rank's next
    exchange of the same signature; :meth:`reset_wire_state` drops it.

    One program per (signature, wire) in the shared program cache.  Like
    the compiled reducer it runs eagerly on the card: its inputs are
    fresh tensors at every call, so a graph would only add a copy.  All
    member ranks must call with one signature in one order; instances
    with the same (process set, name, wire) meet at one rendezvous.
    The exchange is single-hop: ``wire_inner`` and ``topology_hint`` are
    part of its identity, and a hint splits the byte accounting by hop
    (``last_hop_bytes``): the peers of this rank's inner-axis group are
    the fast hop (``compiled.py:1773-1800``)."""

    def __init__(self, process_set=global_process_set, name=None,
                 wire_dtype=None, wire_inner=None, topology_hint=None,
                 error_feedback=False, force_program=False):
        self.topology_hint = _check_hint(topology_hint)
        self.process_set = process_set
        self.name = name
        self.force_program = bool(force_program)
        self.wire_dtype = qz.normalize_wire_dtype(wire_dtype)
        if self.wire_dtype == "f32":
            self.wire_dtype = None
        self.wire_inner = qz.normalize_inner_wire(wire_inner)
        self.error_feedback = bool(error_feedback) \
            and self.wire_dtype in ("int8", "int4")
        #: wire accounting of the most recent call, and its split by hop:
        #: {'inner' or 'cross': (logical bytes, wire bytes)}
        self.last_logical_bytes = 0
        self.last_wire_bytes = 0
        self.last_hop_bytes = {}
        self._programs = {}
        self._validated = set()
        self._ef_keys = set()
        self._ex = None
        self._lock = threading.Lock()

    def _tag(self):
        return ("a2a", self.name, self.wire_dtype, self.wire_inner,
                self.error_feedback, _hint_key(self.topology_hint))

    def reset_wire_state(self):
        """Drop the error-feedback residuals this object's callers hold
        (elastic resize, quarantine)."""
        with _A2A_EF_LOCK:
            for k in self._ef_keys:
                _A2A_EF.pop(k, None)
            self._ef_keys.clear()

    @staticmethod
    def _seg_pad(m):
        """A quantized slot's length: whole 256-element blocks."""
        return -(-m // qz.BLOCK) * qz.BLOCK

    def _build(self, ex, n, dtype):
        """The exchange of per-local-rank rows ``(n,)`` laid out as R
        destination slots of ``m = n / R``: ``prog(rows, res) -> (outs,
        new_res)``, ``outs[i]`` the R source slots received by local
        position i, ``res``/``new_res`` the per-position f32 residuals
        (None without error feedback)."""
        R = ex.num_ranks
        wire, ef = self.wire_dtype, self.error_feedback
        eq = [[n // R] * R for _ in range(R)]

        def prog(rows, res):
            if wire in ("int8", "int4"):
                bits = 4 if wire == "int4" else 8
                q_rows, s_rows, new_res = [], [], []
                for i, x in enumerate(rows):
                    if ef and res is not None:
                        x = (x.float() + res[i]).to(x.dtype)
                    xf = x.float()
                    q, sc = quantize_kernels.encode(xf, wire)
                    q_rows.append(q)
                    s_rows.append(sc)
                    if ef:
                        new_res.append(xf - quantize_kernels.decode(
                            q, sc, n, bits))
                q_res, s_res = ex.alltoall_codes(q_rows, s_rows)
                outs = [quantize_kernels.decode(q, sc, n, bits).to(dtype)
                        for q, sc in zip(q_res, s_res)]
                return outs, (new_res if ef else None)
            if wire in qz.WIRE_TORCH_DTYPES:
                wdt = qz.WIRE_TORCH_DTYPES[wire]
                outs, _ = ex.alltoall([x.to(wdt) for x in rows], eq)
                return [o.to(dtype) for o in outs], None
            outs, _ = ex.alltoall(rows, eq)
            return outs, None

        return prog

    def _program(self, ex, sig):
        with self._lock:
            if self._ex is not ex:
                # the engine re-initialized: old programs and residuals
                # belong to the old run
                self._programs.clear()
                self._validated.clear()
                self.reset_wire_state()
                self._ex = ex
            prog = self._programs.get(sig)
            if prog is None:
                n, dtype = sig
                prog = _shared_program(
                    ("alltoall", _ex_uid(ex), self.wire_dtype,
                     self.wire_inner, self.error_feedback,
                     _hint_key(self.topology_hint), sig),
                    lambda: _TimedFirstCall(
                        self._build(ex, n, torch_dtype(dtype))))
                self._programs[sig] = prog
            else:
                _count("hits")
            return prog

    def _account(self, eng, ps, R, n_exact, n_padded, itemsize):
        """The call's bytes, split by destination hop: under a hint that
        factors the set, (inner - 1) / R of them go to this rank's
        inner-axis peers and (R - inner) / R cross the outer axis; without
        one the whole exchange is on one hop, the cross one when the set
        spans hosts."""
        wire = self.wire_dtype
        logical = n_exact * itemsize
        if wire in ("int8", "int4"):
            actual = qz.wire_nbytes(n_padded, wire, itemsize)
        elif wire in ("fp16", "bf16"):
            actual = n_exact * 2
        else:
            actual = logical
        self.last_logical_bytes = logical
        self.last_wire_bytes = actual
        hint = self.topology_hint
        if hint is not None and hint.outer > 1 \
                and hint.outer * hint.inner == R:
            by_hop = (("inner", (hint.inner - 1) / R),
                      ("cross", (R - hint.inner) / R))
        else:
            by_hop = (("cross" if eng._spans_hosts(ps) else "inner", 1.0),)
        self.last_hop_bytes = {hop: (int(logical * f), int(actual * f))
                               for hop, f in by_hop}

    def start(self, array):
        """Run the exchange; returns an object whose ``result()`` is this
        rank's received tensor (the exchange is eager and the caller's
        stream is ordered after it on return)."""
        eng, ps = _ps_state(self.process_set)
        if eng.config.integrity:
            raise NotImplementedError(
                "wire integrity digests on the compiled path are not "
                "ported yet (ROADMAP.md A14); unset HOROVOD_INTEGRITY")
        if torch.is_tensor(array):
            if array.device != eng.device:
                raise ValueError(f"tensor is on {array.device} but "
                                 f"horovod_tpu_torch runs on {eng.device}")
            a = array.detach().contiguous()
        else:
            a = torch.as_tensor(array, device=eng.device)
        ex = ps.compiled_executor
        R = ex.num_ranks
        if a.dim() < 1 or a.shape[0] % R != 0:
            raise ValueError(
                f"compiled alltoall needs equal splits: first dim "
                f"{a.shape[0] if a.dim() else None} must divide by the set "
                f"size {R} (ragged exchanges ride hvd.alltoall)")
        if R == 1 and not self.force_program:
            return _A2AResult(a.clone())
        rest = tuple(a.shape[1:])
        m_exact = (a.shape[0] // R) * math.prod(rest)
        wire = self.wire_dtype
        m = self._seg_pad(m_exact) \
            if wire in ("int8", "int4") and m_exact > 0 else m_exact
        n = R * m
        flat = a.reshape(-1)
        if m != m_exact:
            buf = torch.zeros(n, dtype=a.dtype, device=a.device)
            buf.view(R, m)[:, :m_exact] = flat.view(R, m_exact)
        else:
            buf = flat
        sig = (n, dtype_name(a.dtype))
        prog = self._program(ex, sig)
        n_local = len(ex.local_positions)
        pos = ex.local_positions[0] if n_local == 1 \
            else _caller_pos(eng, ps)
        if pos is None:
            raise ValueError(
                "unbound caller: compiled collectives need a rank context "
                "(call inside hvd.run)")
        tag = self._tag()
        ef_base = ("a2aef", _ex_uid(ex), tag, sig) \
            if self.error_feedback else None
        if ef_base is not None:
            with _A2A_EF_LOCK:
                self._ef_keys.add(ef_base + (pos,))
        cur = torch.cuda.current_stream(eng.device) \
            if eng.device.type == "cuda" else None
        ready = None
        if cur is not None:
            ready = torch.cuda.Event()
            ready.record(cur)

        def launch(slots):
            sigs = {p: v[0] for p, v in slots.items()}
            if len(set(sigs.values())) > 1:
                raise ValueError(
                    "compiled alltoall signature mismatch across local "
                    f"ranks: {sigs}")
            if sig not in self._validated:
                _validate_signature_cross_process(eng, ps, tag, sig)
                with self._lock:
                    self._validated.add(sig)
            order = list(ex.local_positions)
            lead = torch.cuda.current_stream(eng.device) \
                if cur is not None else None
            if lead is not None:
                for p in order:
                    lead.wait_event(slots[p][2])
                    slots[p][1].record_stream(lead)
            rows = [slots[p][1] for p in order]
            res = None
            if ef_base is not None:
                with _A2A_EF_LOCK:
                    got = [_A2A_EF.get(ef_base + (p,)) for p in order]
                res = got if all(g is not None for g in got) else None
            outs, new_res = prog(rows, res)
            if new_res is not None:
                with _A2A_EF_LOCK:
                    for p, r in zip(order, new_res):
                        _A2A_EF[ef_base + (p,)] = r
            done = None
            if lead is not None:
                done = torch.cuda.Event()
                done.record(lead)
            return dict(zip(order, outs)), done

        if n_local == 1:
            outs, done = launch({pos: (sig, buf, ready)})
        else:
            outs, done = _rendezvous_for(ps, tag, n_local).run(
                pos, (sig, buf, ready), launch)
        self._account(eng, ps, R, R * m_exact, n, a.element_size())
        out = outs[pos]
        if done is not None:
            # the leader's stream made the rows: this rank's stream reads
            # them (and cuts the slot padding off) after it
            cur.wait_event(done)
            out.record_stream(cur)
        if m != m_exact:
            out = out.view(R, m)[:, :m_exact]
        return _A2AResult(out.reshape((R * (a.shape[0] // R),) + rest))

    def __call__(self, array):
        """The synchronous exchange (``start(array).result()``)."""
        return self.start(array).result()


class _A2AResult:
    """A finished compiled exchange: ``result()`` is this rank's received
    tensor, ordered on the caller's stream."""

    __slots__ = ("_out",)

    def __init__(self, out):
        self._out = out

    def result(self):
        return self._out


_A2A_CACHE = {}
_A2A_LOCK = threading.Lock()


def compiled_alltoall(array, process_set=global_process_set,
                      wire_dtype=None, wire_inner=None, topology_hint=None,
                      error_feedback=False, name=None):
    """Equal-split alltoall through one program (no negotiation): the
    functional twin of :class:`CompiledAlltoall`, one object per
    identity, shared by the rank threads."""
    ps_id = process_set.process_set_id \
        if isinstance(process_set, ProcessSet) else int(process_set or 0)
    wire_dtype = qz.normalize_wire_dtype(wire_dtype)
    wire_inner = qz.normalize_inner_wire(wire_inner)
    topology_hint = _check_hint(topology_hint)
    key = (ps_id, name, wire_dtype, wire_inner, bool(error_feedback),
           _hint_key(topology_hint))
    with _A2A_LOCK:
        a2a = _A2A_CACHE.get(key)
        if a2a is None:
            a2a = CompiledAlltoall(
                process_set=process_set, name=name, wire_dtype=wire_dtype,
                wire_inner=wire_inner, topology_hint=topology_hint,
                error_feedback=error_feedback)
            _A2A_CACHE[key] = a2a
    return a2a(array)


# ---------------------------------------------------------------------------
# prediction

def batch_signature(tree):
    """Tree structure and leaf shapes/dtypes of a batch pytree: the batch
    identity, and :class:`CompiledPredict`'s cache key."""
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),
            tuple((tuple(getattr(x, "shape", ())),
                   dtype_name(getattr(x, "dtype", type(x).__name__)))
                  for x in leaves))


def _device_of(tree):
    for leaf in pytree.tree_leaves(tree):
        if torch.is_tensor(leaf):
            return leaf.device
    return torch.device("cpu")


class CompiledPredict:
    """Inference through the shared program cache: ``predict_fn(params,
    batch) -> outputs`` (run without autograd), one program per batch
    signature and device, on the card one CUDA graph each.  The params
    are taken as the same tensors for the object's life (a replica loads
    one checkpoint), so a replay copies only the batch.  Independent of
    the engine: it works before ``init()``."""

    def __init__(self, predict_fn, name="predict"):
        self.predict_fn = predict_fn
        self.name = name
        self._uid = None
        self._programs = {}
        self._lock = threading.Lock()

    def _predict(self, params, batch):
        with torch.no_grad():
            return self.predict_fn(params, batch)

    def _signature(self, batch):
        return batch_signature(batch)

    def _program(self, sig, device):
        with self._lock:
            prog = self._programs.get((sig, str(device)))
            if prog is None:
                if self._uid is None:
                    self._uid = _ex_uid(self)
                prog = _shared_program(
                    ("predict", self._uid, self.name, sig, str(device)),
                    lambda: _make_program(self._predict, device))
                self._programs[(sig, str(device))] = prog
            else:
                _count("hits")
            return prog

    def __call__(self, params, batch):
        prog = self._program(self._signature(batch), _device_of(batch))
        out = prog(params, batch)
        if isinstance(prog, _GraphProgram):
            # the next replay overwrites the graph's outputs
            out = pytree.tree_map(
                lambda t: t.clone() if torch.is_tensor(t) else t, out)
        return out

    def signatures(self):
        """Batch signatures built so far."""
        with self._lock:
            return [sig for sig, _ in self._programs]


# ---------------------------------------------------------------------------
# module functions

_REDUCERS = {}
_REDUCERS_LOCK = threading.Lock()


def _reducer(op, prescale_factor, postscale_factor, process_set,
             wire_dtype=None, algorithm=None, topology_hint=None,
             wire_inner=None):
    ps_id = process_set.process_set_id \
        if isinstance(process_set, ProcessSet) else int(process_set or 0)
    wire_dtype = qz.normalize_wire_dtype(wire_dtype)
    wire_inner = qz.normalize_inner_wire(wire_inner)
    algorithm = normalize_algorithm(algorithm)
    topology_hint = _check_hint(topology_hint)
    key = (int(ReduceOp(op)), float(prescale_factor),
           float(postscale_factor), ps_id, wire_dtype, wire_inner,
           algorithm, _hint_key(topology_hint))
    with _REDUCERS_LOCK:
        red = _REDUCERS.get(key)
        if red is None:
            red = CompiledGroupedAllreduce(
                op=op, prescale_factor=prescale_factor,
                postscale_factor=postscale_factor, process_set=process_set,
                wire_dtype=wire_dtype, algorithm=algorithm,
                topology_hint=topology_hint, wire_inner=wire_inner)
            _REDUCERS[key] = red
        return red


def compiled_grouped_allreduce(arrays, op=Average, prescale_factor=1.0,
                               postscale_factor=1.0,
                               process_set=global_process_set,
                               wire_dtype=None, algorithm=None,
                               topology_hint=None, wire_inner=None):
    """Grouped allreduce through one program (no engine negotiation)."""
    return _reducer(op, prescale_factor, postscale_factor,
                    process_set, wire_dtype, algorithm,
                    topology_hint, wire_inner)(arrays)


def compiled_allreduce(array, op=Average, prescale_factor=1.0,
                       postscale_factor=1.0,
                       process_set=global_process_set, wire_dtype=None,
                       algorithm=None, topology_hint=None,
                       wire_inner=None):
    """Single-tensor convenience over :func:`compiled_grouped_allreduce`."""
    return compiled_grouped_allreduce(
        [array], op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        wire_dtype=wire_dtype, algorithm=algorithm,
        topology_hint=topology_hint, wire_inner=wire_inner)[0]


def reset_compiled_state():
    """Drop cached reducers, exchanges, programs (and so their graphs),
    alltoall residuals and rendezvous: ``shutdown`` calls it, so that a
    re-``init`` at another world size never serves an old program.  The
    counters of :func:`program_cache_stats` keep counting."""
    with _REDUCERS_LOCK:
        _REDUCERS.clear()
    with _A2A_LOCK:
        _A2A_CACHE.clear()
    with _A2A_EF_LOCK:
        _A2A_EF.clear()
    with _RDV_LOCK:
        _RDV_REGISTRY.clear()
        _STEP_COUNTERS.clear()
        _SIG_COUNTERS.clear()
        _SIG_DONE.clear()
    with _PROGRAM_LOCK:
        _PROGRAM_CACHE.clear()


# ---------------------------------------------------------------------------
# the compiled train step

def _param_leaf(value, device):
    t = torch.as_tensor(value).detach().to(device, copy=True)
    return t.requires_grad_(t.is_floating_point())


def _optimizer_tensors(state):
    """The optimizer's state tensors, parameter by parameter in the
    params' order, keys sorted (with ``sharded=True``: every rank's
    parameter shards and optimizer state, :meth:`ShardedOptState.tensors`)."""
    opt, out = state["opt_state"], []
    if isinstance(opt, ShardedOptState):
        return opt.tensors()
    for p in state["params"].values():
        st = opt.state.get(p, {})
        out.extend(st[k] for k in sorted(st) if torch.is_tensor(st[k]))
    return out


def _fusion_groups(tensors, threshold):
    """The indices of ``tensors`` in groups of one dtype each (dtypes in
    first-seen order, the same on every process) split where a group
    would pass ``threshold`` bytes (0: never; a larger tensor is a group
    alone): the buffers of the process-group steps, each one collective.
    Over gloo on CUDA tensors a collective is a round trip through host
    memory, so a few, not one a leaf."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    groups = []
    for idx in by_dtype.values():
        cur, nbytes = [], 0
        for i in idx:
            b = tensors[i].numel() * tensors[i].element_size()
            if cur and threshold > 0 and nbytes + b > threshold:
                groups.append(cur)
                cur, nbytes = [], 0
            cur.append(i)
            nbytes += b
        groups.append(cur)
    return groups


@torch.no_grad()
def _adasum_leaves(ex, per_rank):
    """Each leaf's Adasum over the set's ranks: ``per_rank[i]`` is local
    rank i's list of gradient leaves.  Per dtype the leaves of each local
    rank are laid end to end and every rank's row gathered in rank order
    (``MeshExecutor.gather_tiles``: the stacked rows, or one group
    allgather), then :func:`~.adasum.adasum_reduce` runs on each leaf's
    columns."""
    out = [None] * len(per_rank[0])
    by_dtype = {}
    for j, g in enumerate(per_rank[0]):
        by_dtype.setdefault(g.dtype, []).append(j)
    for idx in by_dtype.values():
        stack = ex.gather_tiles([torch.cat([grads[j].reshape(-1)
                                            for j in idx])
                                 for grads in per_rank])
        off = 0
        for j in idx:
            ref = per_rank[0][j]
            n = ref.numel()
            out[j] = adasum_reduce(stack[:, off:off + n]).view(ref.shape)
            off += n
    return out


def _allreduce_flat(ex, tensors, threshold):
    """The sums of ``tensors`` over executor ``ex``'s process group, as
    new tensors of their shapes: one flat buffer per
    :func:`_fusion_groups` group, summed by one collective, packed and
    unpacked with torch ops."""
    out = [None] * len(tensors)
    for group in _fusion_groups(tensors, threshold):
        buf = torch.cat([tensors[i].detach().reshape(-1) for i in group])
        ex.reduce_across(buf, ReduceOp.SUM)
        o = 0
        for i in group:
            n = tensors[i].numel()
            out[i] = buf[o:o + n].view(tensors[i].shape)
            o += n
    return out


def _state_leaves(state, batch_rows):
    """The input tensors of one step: params, optimizer state, aux, the
    error-feedback residuals and the staged batch."""
    return (list(state["params"].values()) + _optimizer_tensors(state)
            + pytree.tree_leaves(state.get("aux", {}))
            + pytree.tree_leaves(state.get("grad_ef", {}))
            + pytree.tree_leaves(batch_rows))


def _capturable(opt, device):
    """On the card, an optimizer that keeps a host-side step count (Adam
    and its kin) keeps it on the card instead, as a graph needs."""
    if device.type == "cuda":
        for group in opt.param_groups:
            if "capturable" in group:
                group["capturable"] = True
    return opt


def _init_optimizer_state(opt):
    """Build the state of SGD with momentum and of the Adam family as the
    optimizers' own first step would (zeros, the step count 0), so that
    the sharded state exists as tensors from ``init_state`` on; a zero
    momentum buffer gives the first step's ``0 * m + g = g``, the clone
    the lazy path makes.  Other optimizers build theirs at the warm-up
    step."""
    adam = isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            if isinstance(opt, torch.optim.SGD) and group["momentum"]:
                st["momentum_buffer"] = torch.zeros_like(p)
            elif adam:
                on_card = group["capturable"] or group["fused"]
                st["step"] = torch.zeros((), dtype=_get_scalar_dtype(),
                                         device=p.device if on_card
                                         else "cpu")
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)
                if group["amsgrad"]:
                    st["max_exp_avg_sq"] = torch.zeros_like(p)


class _ShardLayout:
    """Where one parameter leaf's elements go in the sharded step.  The
    leaf is flattened and padded to ``pad`` (:meth:`_CompiledTrainStep.
    _shard_pad`); rank r owns ``m = pad // R`` elements: its slice of
    every segment (``segs``, :meth:`_CompiledTrainStep._seg_bounds`),
    concatenated in segment order, the JAX package's segment-major
    layout.  ``perm`` (None for one segment) maps shard order to the
    natural flat order (``shards.view(-1) = flat[perm]``), ``inv`` back.
    Under a 2-D decomposition (``inner`` > 1, one segment) the scatter
    over the inner axis and then the outer one leaves position ``p = y *
    inner + x`` of an ``(R // inner, inner)`` grid with natural slice ``x
    * (R // inner) + y``: ``owner`` maps positions to those slices."""

    __slots__ = ("n", "pad", "m", "segs", "perm", "inv", "owner",
                 "owner_inv")

    def __init__(self, n, pad, R, segs, device, inner=1):
        self.n, self.pad, self.m, self.segs = n, pad, pad // R, segs
        self.perm = self.inv = self.owner = self.owner_inv = None
        if inner > 1:
            outer = R // inner
            own = [(p % inner) * outer + p // inner for p in range(R)]
            self.owner = torch.tensor(own, device=device)
            self.owner_inv = torch.tensor(np.argsort(own), device=device)
        if len(segs) > 1:
            idx = np.empty(pad, np.int64)
            o = 0
            for r in range(R):
                for s, e in segs:
                    mi = (e - s) // R
                    idx[o:o + mi] = np.arange(s + r * mi, s + (r + 1) * mi)
                    o += mi
            self.perm = torch.from_numpy(idx).to(device)
            self.inv = torch.from_numpy(np.argsort(idx)).to(device)

    def shard(self, flat):
        """A natural-order padded flat (pad,) as the (R, m) rank shards."""
        if self.perm is not None:
            flat = flat.index_select(0, self.perm)
        shards = flat.view(-1, self.m)
        return shards if self.owner is None \
            else shards.index_select(0, self.owner)

    def natural(self, shards):
        """(R, m) rank shards as the natural-order padded flat (pad,)."""
        if self.owner is not None:
            shards = shards.index_select(0, self.owner_inv)
        flat = shards.reshape(-1)
        return flat if self.inv is None else flat.index_select(0, self.inv)

    def padded(self, t):
        """A tensor's flat elements, zero-padded to ``pad``."""
        flat = t.reshape(-1)
        if self.pad > self.n:
            flat = torch.nn.functional.pad(flat, (0, self.pad - self.n))
        return flat

    def shard_blocks(self, values, pos, block):
        """The entries of a per-block tensor ``values`` (one per
        ``block`` elements of the natural padded flat) that rank ``pos``'s
        shard covers, in shard order (its shard is whole blocks)."""
        nb = self.m // block
        if self.perm is None:
            return values[pos * nb:(pos + 1) * nb]
        idx = self.perm.view(-1, self.m)[pos][::block] // block
        return values.index_select(0, idx)


class ShardedOptState:
    """The optimizer state of the weight-update-sharded step, in place of
    the JAX package's flat dp-sharded optax leaves, for the set positions
    ``positions`` this process hosts (every rank for rank threads, its
    one rank under the launcher).  ``shards[i]`` is a ``(len(positions),
    pad // R)`` buffer of parameter leaf ``names[i]``'s dtype whose k-th
    row is rank ``positions[k]``'s flat shard of that parameter
    (segment-major, see ``_ShardLayout``); ``optimizers[k]`` is that
    rank's optimizer over its rows, so it holds that rank's shard of
    every moment, and only that.  Methods taking ``r`` take a set
    position this process hosts."""

    def __init__(self, names, shards, optimizers, positions=None):
        self.names = list(names)
        self.shards = list(shards)
        self.optimizers = list(optimizers)
        self.positions = list(range(len(self.optimizers))) \
            if positions is None else list(positions)

    def _row(self, r):
        if r not in self.positions:
            raise ValueError(f"rank position {r} is not hosted here "
                             f"(this state holds {self.positions})")
        return self.positions.index(r)

    def tensors(self):
        """The shard buffers, then each hosted rank's state tensors in
        parameter order, keys sorted."""
        out = list(self.shards)
        for r, opt in zip(self.positions, self.optimizers):
            for p in self.rank_params(r):
                st = opt.state.get(p, {})
                out.extend(st[k] for k in sorted(st)
                           if torch.is_tensor(st[k]))
        return out

    def optimizer(self, r):
        """Rank position r's optimizer."""
        return self.optimizers[self._row(r)]

    def rank_params(self, r):
        """Rank r's shard tensors (its optimizer's parameters), in
        parameter order."""
        return [p for g in self.optimizer(r).param_groups
                for p in g["params"]]

    def state_bytes(self, r):
        """Bytes of rank r's optimizer state tensors (device and host)."""
        opt = self.optimizer(r)
        return sum(v.numel() * v.element_size()
                   for p in self.rank_params(r)
                   for v in opt.state.get(p, {}).values()
                   if torch.is_tensor(v))

    def flat(self, key):
        """``{name: (len(positions) * m,)}``: the hosted ranks' shards of
        optimizer state ``key`` ('momentum_buffer', 'exp_avg', ...)
        concatenated in rank order; with every rank hosted and no
        TopologyHint, the layout of the JAX package's global flat leaves
        (under a hint position ``p = y * inner + x`` holds that layout's
        row ``x * outer + y``)."""
        out = {}
        for i, name in enumerate(self.names):
            rows = [opt.state[self.rank_params(r)[i]][key]
                    for r, opt in zip(self.positions, self.optimizers)]
            out[name] = torch.cat([t.reshape(-1) for t in rows])
        return out


class _CompiledTrainStep:
    """See :func:`make_compiled_train_step`."""

    def __init__(self, loss_fn, optimizer, op, process_set, donate,
                 has_aux=False, sharded=False, wire_dtype=None,
                 topology_hint=None, wire_inner=None):
        op = ReduceOp(op)
        if op not in (Average, Sum, Adasum):
            raise ValueError("op must be Average, Sum, or Adasum")
        self.sharded = bool(sharded)
        if self.sharded and op not in (Average, Sum):
            raise ValueError(
                "sharded=True supports op=Average or Sum (the "
                "reducescatter has no adasum combine)")
        # the gradient wire of the sharded reducescatter; the dense step
        # takes it and ignores it, as the JAX package's does
        self.wire_dtype = qz.normalize_wire_dtype(wire_dtype)
        if self.wire_dtype == "f32":
            self.wire_dtype = None
        # the sharded step's scatter and gather decompose per hop under a
        # hint (the dense step takes it and ignores it, as the JAX
        # package's does), the inner hop on ``wire_inner`` under a
        # quantized wire
        self.topology_hint = _check_hint(topology_hint)
        self.wire_inner = qz.normalize_inner_wire(wire_inner)
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.op = op
        self.process_set = process_set
        self.donate = donate
        self.has_aux = has_aux
        #: False runs the step's function uncaptured on the card: the
        #: reference a captured graph is checked against
        self.capture = True
        # the sharded step's segment size, latched once (the segment
        # layout is baked into the optimizer state's layout)
        self._bucket_bytes_latched = None
        self._layouts = {}
        self._prog = None
        self._ex = None
        self._tag = None
        self._sig_checked = False
        self._lock = threading.Lock()

    # -- program -------------------------------------------------------------

    def _grads(self, ex, state, batch_rows, take):
        """Each local rank's loss and gradients from the same params and
        its own copy of the aux, on its rows of the staged batch (row i is
        local position ``ex.local_positions[i]``'s), handed to ``take(i,
        grads)`` as they come.  Returns the trained params, the local
        losses and, with ``has_aux``, ``[(aux leaf, [its new value per
        local rank])]`` for :meth:`_finish_stacked` or
        :meth:`_finish_group` to write back."""
        loss_fn, has_aux = self.loss_fn, self.has_aux
        params = state["params"]
        train = [p for p in params.values() if p.requires_grad]
        losses, auxes = [], []
        for i in range(len(ex.local_positions)):
            batch = pytree.tree_map(lambda x: x[i], batch_rows)
            if has_aux:
                # BatchNorm updates its statistics in place: each rank
                # starts from its own copy of the same aux
                aux = pytree.tree_map(torch.clone, state["aux"])
                loss, new_aux = loss_fn(params, aux, batch)
                auxes.append(pytree.tree_leaves(new_aux))
            else:
                loss = loss_fn(params, batch)
            take(i, torch.autograd.grad(loss, train, allow_unused=True,
                                        materialize_grads=True))
            losses.append(loss.detach())
        aux_pairs = []
        if has_aux:
            dst = pytree.tree_leaves(state["aux"])
            if any(len(a) != len(dst) for a in auxes):
                raise ValueError("loss_fn's new aux must have the "
                                 "structure of the aux it was given")
            aux_pairs = [(t, [a[j] for a in auxes])
                         for j, t in enumerate(dst)]
        return train, losses, aux_pairs

    @staticmethod
    @torch.no_grad()
    def _finish_stacked(losses, aux_pairs, inner=1):
        """The stacked step's aux write-back (float leaves averaged over
        the ranks, the sync-BN convention; others rank 0's) and mean
        loss.  Over a 2-D grid (``inner`` > 1) each mean is the mean over
        the grid rows of the means over each row, as the JAX body's
        nested ``pmean`` is."""
        def mean(vals):
            t = torch.stack(vals)
            if inner > 1:
                t = t.view((-1, inner) + t.shape[1:]).mean(dim=1)
            return t.mean(dim=0)
        for t, vals in aux_pairs:
            t.copy_(mean(vals) if vals[0].is_floating_point() else vals[0])
        return mean(losses)

    @torch.no_grad()
    def _finish_group(self, ex, losses, aux_pairs, grads):
        """Over a process group: ``grads`` (this process's, summed over its
        local ranks) replaced by their sums over the set's ranks, the float
        aux leaves and the loss averaged over them (the JAX body's
        ``pmean``; a process's local ranks summed first), other aux leaves
        kept local ("taken as replicated", the first local rank's), all in
        one :func:`_allreduce_flat`.  An average is the sum, then
        ``div_(R)``, as the stacked step's.  Returns the loss."""
        R = ex.num_ranks

        def local_sum(vals):
            return vals[0] if len(vals) == 1 else \
                torch.stack(vals).sum(0, dtype=vals[0].dtype)
        floats = [local_sum(vals) for _t, vals in aux_pairs
                  if vals[0].is_floating_point()]
        summed = _allreduce_flat(ex, list(grads) + floats
                                 + [local_sum(losses)],
                                 self._fusion_threshold)
        grads[:] = summed[:len(grads)]
        it = iter(summed[len(grads):-1])
        for t, vals in aux_pairs:
            t.copy_(next(it).div_(R) if vals[0].is_floating_point()
                    else vals[0])
        return summed[-1].div_(R)

    def _apply(self, state, train, acc):
        """One optimizer update of the replicated params from ``acc``."""
        opt = state["opt_state"]
        for p, g in zip(train, acc):
            p.grad = g
        opt.step()
        for p in train:
            p.grad = None

    def _build(self, ex):
        """The dense step.  Stacked, JAX's ``vmap`` branch written out: the
        ranks' gradients (:meth:`_grads`) summed as they come, their mean
        (Average) or sum (Sum) over ranks, one optimizer update.  Over a
        process group, JAX's shard-mode body: this rank's gradients summed
        over the compiled group in a few flat buffers
        (:meth:`_finish_group`), the same mean or sum and update.  Params,
        optimizer state and aux are updated in place and the state
        returned with the mean loss."""
        op, R = self.op, ex.num_ranks
        if op == Adasum:
            return self._build_adasum(ex)

        def prog(state, batch_rows):
            acc = []

            def take(i, g):
                if i == 0:
                    acc.extend(g)
                else:
                    for a, gi in zip(acc, g):
                        a.add_(gi)
            train, losses, aux_pairs = self._grads(ex, state, batch_rows,
                                                   take)
            if ex.stacked:
                loss = self._finish_stacked(losses, aux_pairs)
            else:
                loss = self._finish_group(ex, losses, aux_pairs, acc)
            if op == Average:
                for a in acc:
                    a.div_(R)
            self._apply(state, train, acc)
            return state, loss

        return prog

    def _build_adasum(self, ex):
        """The dense step with ``op=Adasum``: JAX's bodies combine each
        gradient leaf on its own (``compiled.py:2205-2257``:
        ``adasum_reduce`` of the leaf's stacked or all-gathered rows),
        where the eager engine combines a whole fused bucket.  Each local
        rank's gradients are kept apart; :func:`_adasum_leaves` gathers
        every rank's rows and combines per leaf.  The loss and the aux
        are averaged as in the Average step."""
        def prog(state, batch_rows):
            per_rank = []
            train, losses, aux_pairs = self._grads(
                ex, state, batch_rows, lambda i, g: per_rank.append(g))
            if ex.stacked:
                loss = self._finish_stacked(losses, aux_pairs)
            else:
                loss = self._finish_group(ex, losses, aux_pairs, [])
            self._apply(state, train, _adasum_leaves(ex, per_rank))
            return state, loss

        return prog

    @property
    def _fusion_threshold(self):
        """The engine's fusion threshold: where the process-group step
        splits its flat gradient buffers."""
        return int(basics.engine().config.fusion_threshold_bytes)

    # -- weight-update sharding ----------------------------------------------

    def _quantized(self):
        return self.wire_dtype in ("int8", "int4")

    def _shard_pad(self, n, R):
        """Padded flat length of an ``n``-element leaf: a multiple of R so
        the scatter divides evenly, and of BLOCK*R under a quantized wire,
        so every rank's shard is whole quantization blocks."""
        unit = qz.BLOCK * R if self._quantized() else R
        return -(-n // unit) * unit

    def _overlap_bucket_bytes(self):
        """The segment size of the sharded step's scatter and gather, read
        from the engine's config (``HOROVOD_OVERLAP_BUCKET_BYTES``) once,
        at the first state init or program build, so one run never mixes
        segment layouts."""
        bb = self._bucket_bytes_latched
        if bb is None:
            bb = 0
            if self.sharded:
                eng, _ps = _ps_state(self.process_set)
                bb = int(getattr(eng.config, "overlap_bucket_bytes", 0)
                         or 0)
            self._bucket_bytes_latched = bb
        return bb

    def _seg_bounds(self, pad, R):
        """Scatter/gather segments of one padded flat leaf
        (``core.sharded.overlap_segment_bounds``), each a whole number of
        shard units, so the segmented reduction is bit for bit the
        unsegmented one.  Under a hint one segment: the per-hop split is
        the finer granularity already."""
        if self.topology_hint is not None:
            return [(0, pad)]
        unit = qz.BLOCK * R if self._quantized() else R
        return overlap_segment_bounds(pad, 4, self._overlap_bucket_bytes(),
                                      unit=unit)

    def _layout(self, n, R, device):
        key = (n, R, str(device))
        lay = self._layouts.get(key)
        if lay is None:
            pad = self._shard_pad(n, R)
            hint = self._shard_hint(R)
            lay = self._layouts[key] = _ShardLayout(
                n, pad, R, self._seg_bounds(pad, R), device,
                inner=hint.inner if hint is not None else 1)
        return lay

    def _shard_hint(self, R):
        """The hint of the sharded step, checked against the set's size
        (``compiled.py:2316-2325``), or None."""
        if self.topology_hint is None:
            return None
        return _checked_hint_inner(self.topology_hint, R)

    def _reduce_leaf(self, rows, res, lay, R):
        """The reducescatter of one leaf, before the shard split: the
        reduced padded flat f32 (pad,) in natural order, from the ranks'
        gradients ``rows``.  f32: the sum over ranks in rank order; 16-bit:
        the rows cast to the wire and summed there (the eager
        ``MeshExecutor.reducescatter``'s rounding); int8/int4: the JAX
        package's shared-scale integer partials, with ``res`` (R, pad) the
        ranks' error-feedback residuals, replaced in place.  Average
        multiplies by the f32 1/R."""
        n = lay.n
        wire = self.wire_dtype
        hint = self._shard_hint(R)
        if hint is not None:
            y = self._reduce_leaf_2d(rows, res, lay, hint)
        elif self._quantized():
            # x = g + res, the padding's gradient 0
            x = res.clone()
            for r, g in enumerate(rows):
                x[r, :n].add_(g.reshape(-1))
            y, new_res = qz.quantized_psum_ef(
                x, 8 if wire == "int8" else 4, R,
                lambda t: t.amax(0, keepdim=True),
                lambda q: q.sum(0, keepdim=True, dtype=q.dtype))
            res.copy_(new_res)
            y = y.view(-1)
        elif wire in ("bf16", "fp16"):
            wdt = qz.WIRE_TORCH_DTYPES[wire]
            y = torch.stack([g.reshape(-1).to(wdt) for g in rows]) \
                .sum(dim=0, dtype=wdt).float()
            y = lay.padded(y)
        else:
            y = rows[0].reshape(-1).float()
            for g in rows[1:]:
                y = y + g.reshape(-1)
            y = lay.padded(y)
        if self.op == Average:
            y = y * (1.0 / R)
        return y

    def _reduce_leaf_2d(self, rows, res, lay, hint):
        """:meth:`_reduce_leaf` per hop over the hint's ``(outer, inner)``
        grid of positions (``compiled.py:2405-2490``): the ranks' padded
        f32 gradients summed over each grid row's members (the inner
        scatter), then each 1/inner shard over the grid's rows (the outer
        scatter), both in the 16-bit wire if there is one.  int8/int4: the
        inner sum rides ``wire_inner`` (the effective inner wire of an f32
        payload), its shard gets the rank's residual ``res`` (``(R, pad //
        inner)``, replaced in place) and crosses the outer hop as the
        shared-scale integer sum.  Returns the reduced padded flat f32 in
        natural order."""
        inner, outer = hint.inner, hint.outer
        R, c = inner * outer, lay.pad // inner
        g = torch.zeros((R, lay.pad), dtype=torch.float32,
                        device=rows[0].device)
        for r, t in enumerate(rows):
            g[r, :lay.n] = t.reshape(-1)
        wire = self.wire_dtype
        if self._quantized():
            iw = qz.WIRE_TORCH_DTYPES.get(
                qz.effective_inner_wire(self.wire_inner, wire, 4))
            x = g if iw is None else g.to(iw)
            s = x.view(outer, inner, inner, c).sum(1, dtype=x.dtype)
            y, new_res = qz.quantized_psum_ef(
                s.float() + res.view(outer, inner, c),
                8 if wire == "int8" else 4, outer,
                lambda t: t.amax(0, keepdim=True),
                lambda q: q.sum(0, keepdim=True, dtype=q.dtype))
            res.copy_(new_res.view(R, c))
            return y.reshape(-1)
        wdt = qz.WIRE_TORCH_DTYPES.get(wire, torch.float32)
        x = g.to(wdt).view(outer, inner, inner, c)
        return x.sum(1, dtype=wdt).sum(0, dtype=wdt).float().reshape(-1)

    def _scatter_group(self, ex, grads, efs, layouts):
        """:meth:`_reduce_leaf` over a process group for a group of
        leaves: per local rank row k (``grads[k]`` that rank's gradients
        of the leaves), its reduced shard ``(m,)`` f32 of each leaf, in
        shard order.  Each leaf's padded flat gradient in shard order is
        an ``(R, m)`` block; the group's blocks side by side are one
        ``(R, M)`` buffer whose rows the executor's reduce-scatter sums
        (the local rows first) into each local rank's ``(M,)``, in the
        wire's dtype for f32 and 16-bit.  int8/int4: per local rank and
        leaf ``x = g + res`` (``res`` the leaf's ``(L, pad)`` residuals,
        row k replaced in place) and its bf16 block absmax; the absmax
        all-reduced with MAX into the shared scales, the codes
        reduce-scattered as an integer sum (int16 partials, which NCCL
        lacks and gloo refuses, summed as int32: the same values, the acc
        dtype is chosen so that nothing overflows) and decoded against
        each shard's scales.  Average multiplies by the f32 1/R.  Every
        sum is elementwise, so grouping changes no value, and at two
        ranks each is the stacked step's ``a + b``: the two are bit for
        bit."""
        R = ex.num_ranks
        positions = ex.local_positions
        wire = self.wire_dtype
        ms = [lay.m for lay in layouts]
        if self._quantized():
            bits = 8 if wire == "int8" else 4
            qmax = qz.quantized_qmax(bits)
            xs = []
            for k, gk in enumerate(grads):
                row = []
                for g, res, lay in zip(gk, efs, layouts):
                    x = res[k].clone()
                    x[:lay.n].add_(g.reshape(-1))
                    row.append(x.view(-1, qz.BLOCK))
                xs.append(row)
            absmax = [torch.cat([x.abs().amax(dim=1) for x in row])
                      .to(torch.bfloat16) for row in xs]
            shared_all = ex.reduce(absmax, ReduceOp.MAX)[0].float()
            acc = qz.quantized_acc_dtype(bits, R)
            if acc == torch.int16:
                acc = torch.int32
            nbs = [x.shape[0] for x in xs[0]]
            safes, code_rows = [], []
            o = 0
            for j, nb in enumerate(nbs):
                shared = shared_all[o:o + nb]
                o += nb
                # divide by a tensor: CUDA divides by a Python number as a
                # multiplication by its reciprocal
                scale = (shared / shared.new_full((), float(qmax))) \
                    .to(torch.bfloat16).float()
                safes.append(torch.where(scale > 0, scale,
                                         scale.new_ones(())))
            for k, row in enumerate(xs):
                codes = []
                for x, res, lay, safe in zip(row, efs, layouts, safes):
                    q = torch.round(x / safe[:, None]).clamp_(-qmax, qmax)
                    res[k].copy_((x - q * safe[:, None]).view(-1))
                    codes.append(lay.shard(q.to(acc).view(-1)))
                code_rows.append(torch.cat(codes, dim=1).reshape(-1))
            tiles = ex.reduce_tiles(code_rows, ReduceOp.SUM, sum(ms))
            out = [[(y.view(-1, qz.BLOCK)
                     * lay.shard_blocks(safe, pos, qz.BLOCK)[:, None])
                    .view(-1)
                    for y, lay, safe in zip(tile.float().split(ms),
                                            layouts, safes)]
                   for tile, pos in zip(tiles, positions)]
        else:
            wdt = qz.WIRE_TORCH_DTYPES[wire] if wire in ("bf16", "fp16") \
                else torch.float32
            rows = [torch.cat([lay.shard(lay.padded(g.reshape(-1).to(wdt)))
                               for g, lay in zip(gk, layouts)],
                              dim=1).reshape(-1) for gk in grads]
            tiles = ex.reduce_tiles(rows, ReduceOp.SUM, sum(ms))
            out = [list(tile.float().split(ms)) for tile in tiles]
        if self.op == Average:
            out = [[y * (1.0 / R) for y in row] for row in out]
        return out

    def _build_sharded(self, ex):
        """The weight-update-sharded step (the JAX package's
        ``_build_sharded``, flat decomposition): the ranks' gradients
        (:meth:`_grads`), then per parameter leaf the reducescatter
        (:meth:`_reduce_leaf`) into the ranks' shards, each rank's
        optimizer stepping its shards (its rows of the shard buffers,
        loaded from the replicated params), and the updated rows written
        back into the one replicated parameter tensor, the allgather.
        The rank threads of the stacked executor stand for the JAX
        package's one device per rank; over a process group a process is
        that device (:meth:`_build_sharded_group`)."""
        hint = self._shard_hint(ex.num_ranks)
        if not ex.stacked:
            if hint is not None:
                raise ValueError(
                    "a TopologyHint on the sharded compiled step runs on "
                    "the stacked layout (rank threads of one process); "
                    "across processes use the flat sharded step")
            return self._build_sharded_group(ex)
        R = ex.num_ranks
        inner = hint.inner if hint is not None else 1

        def prog(state, batch_rows):
            # every rank's gradients: the shared scales of a quantized
            # wire need all of them before any rank's codes
            grads = []
            train, losses, aux_pairs = self._grads(
                ex, state, batch_rows, lambda i, g: grads.append(g))
            loss = self._finish_stacked(losses, aux_pairs, inner)
            so = state["opt_state"]
            efs = list(state.get("grad_ef", {}).values()) \
                or [None] * len(train)
            with torch.no_grad():
                shard_grads = []
                for i, (p, buf, res) in enumerate(
                        zip(train, so.shards, efs)):
                    lay = self._layout(p.numel(), R, p.device)
                    y = self._reduce_leaf([g[i] for g in grads], res, lay,
                                          R)
                    shard_grads.append(lay.shard(y).to(p.dtype))
                    # this step's shard of the replicated params
                    buf.copy_(lay.shard(lay.padded(p.detach())))
                del grads
                for r, opt in enumerate(so.optimizers):
                    shards = so.rank_params(r)
                    for t, g in zip(shards, shard_grads):
                        t.grad = g[r]
                    opt.step()
                    for t in shards:
                        t.grad = None
                for p, buf in zip(train, so.shards):
                    lay = self._layout(p.numel(), R, p.device)
                    p.copy_(lay.natural(buf)[:lay.n].view_as(p))
            return state, loss

        return prog

    def _build_sharded_group(self, ex):
        """The sharded step over a process group, JAX ``_build_sharded``
        in its one-device-per-rank form: this process holds its ranks'
        shards only (one, or its rank threads' run).  Per group of leaves
        (:func:`_fusion_groups` of the parameters) :meth:`_scatter_group`
        reduces the local ranks' shards of the gradients, each local
        rank's optimizer steps its shards, and per group one allgather
        brings every rank's shards back into the replicated parameters
        in natural order."""
        R = ex.num_ranks
        positions = ex.local_positions
        lo, L = positions[0], len(positions)

        def prog(state, batch_rows):
            grads = [None] * L

            def take(i, g):
                grads[i] = list(g)
            train, losses, aux_pairs = self._grads(ex, state, batch_rows,
                                                   take)
            loss = self._finish_group(ex, losses, aux_pairs, [])
            so = state["opt_state"]
            efs = list(state.get("grad_ef", {}).values()) \
                or [None] * len(train)
            layouts = [self._layout(p.numel(), R, p.device) for p in train]
            groups = _fusion_groups(train, self._fusion_threshold)
            with torch.no_grad():
                shard_grads = [[None] * len(train) for _ in range(L)]
                for grp in groups:
                    ys = self._scatter_group(
                        ex, [[gk[i] for i in grp] for gk in grads],
                        [efs[i] for i in grp], [layouts[i] for i in grp])
                    for k, row in enumerate(ys):
                        for i, y in zip(grp, row):
                            shard_grads[k][i] = y.to(train[i].dtype)
                for p, buf, lay in zip(train, so.shards, layouts):
                    # this step's shards of the replicated params
                    buf.copy_(lay.shard(lay.padded(p.detach()))
                              [lo:lo + L])
                del grads
                for k, pos in enumerate(positions):
                    shards = so.rank_params(pos)
                    for t, g in zip(shards, shard_grads[k]):
                        t.grad = g
                    so.optimizer(pos).step()
                    for t in shards:
                        t.grad = None
                for grp in groups:
                    full = ex.gather_tiles(
                        [torch.cat([so.shards[i][k] for i in grp])
                         for k in range(L)])
                    cols = full.split([layouts[i].m for i in grp], dim=1)
                    for i, c in zip(grp, cols):
                        lay = layouts[i]
                        train[i].copy_(lay.natural(c)[:lay.n]
                                       .view_as(train[i]))
            return state, loss

        return prog

    def _program(self, ex, device):
        # built by whichever rank leads first; later leaders (other
        # instances) reuse it through the shared cache: one build and one
        # capture per process
        with self._lock:
            if self._ex is not ex:
                # re-init: a program for the old world would mis-average
                self._prog = None
                self._sig_checked = False
                self._ex = ex
            if self._prog is None:
                build = self._build_sharded if self.sharded else self._build

                def make():
                    return _make_program(build(ex), device,
                                         leaves=_state_leaves,
                                         capture=self.capture,
                                         backend=executor_backend(
                                             ex, device))
                if self._tag is not None:
                    # the sharded decomposition is part of the key: the
                    # same model under another wire or segment size is
                    # another program
                    mode = ("sharded", self.wire_dtype, self.wire_inner,
                            self._overlap_bucket_bytes(),
                            _hint_key(self.topology_hint)) \
                        if self.sharded else None
                    run = None if self.capture else "uncaptured"
                    self._prog = _shared_program(
                        ("step", _ex_uid(ex), self._tag, mode, run), make)
                else:
                    # untagged (single-rank) steps skip the shared cache
                    # but still count a miss
                    _count("misses")
                    self._prog = make()
            else:
                _count("hits")
            return self._prog

    def _step_tag(self, ps, rank):
        """Creation-order identity: rank r's Nth first-called compiled
        step pairs with rank s's Nth."""
        with self._lock:
            if self._tag is None:
                with _RDV_LOCK:
                    key = (ps.id, rank)
                    idx = _STEP_COUNTERS.get(key, 0)
                    _STEP_COUNTERS[key] = idx + 1
                self._tag = ("step", idx)
            return self._tag

    def _check_step_signature(self, eng, ps, state, batch):
        """First-step cross-process fingerprint of the (params, batch)
        shapes and dtypes."""
        if self._sig_checked:
            return
        tree = batch.tree if isinstance(batch, StagedBatch) else batch
        sig = tuple(
            (tuple(getattr(leaf, "shape", ())),
             dtype_name(getattr(leaf, "dtype", type(leaf).__name__)))
            for leaf in pytree.tree_leaves((state.get("params"), tree)))
        _validate_signature_cross_process(
            eng, ps, ("step_sig",) + tuple(self._tag or ()), sig)
        self._sig_checked = True

    # -- state ---------------------------------------------------------------

    def init_state(self, params, aux=None):
        """The train state ``{"params", "opt_state"[, "aux"]}`` on the
        runtime's device: ``params`` (a dict of tensors or arrays) copied
        into leaf tensors (float ones requiring grad), ``opt_state`` the
        ``optimizer`` built over them, ``aux`` (with ``has_aux``) copied.
        On the card an optimizer that keeps a host-side step count (Adam
        and its kin) is made ``capturable``.

        ``sharded=True`` builds the sharded state instead: the params
        replicated, ``opt_state`` a :class:`ShardedOptState` (per rank
        one optimizer over that rank's flat shards, its state built as
        tensors now), and under an int8/int4 wire ``grad_ef``, per trained
        parameter a zero ``(R, pad)`` f32 error-feedback residual whose
        row r is rank r's.  Over a process group the sharded state holds
        this process's ranks' shards only: one optimizer and one residual
        row per local rank thread."""
        eng, ps = _ps_state(self.process_set)
        dev = eng.device
        params = {k: _param_leaf(v, dev) for k, v in params.items()}
        if self.sharded:
            state = self._init_sharded(ps.compiled_executor, params, dev)
        else:
            state = {"params": params, "opt_state": _capturable(
                self.optimizer(list(params.values())), dev)}
        if self.has_aux:
            state["aux"] = pytree.tree_map(
                lambda x: torch.as_tensor(x).detach().to(dev, copy=True),
                {} if aux is None else aux)
        return state

    def _init_sharded(self, ex, params, dev):
        R, positions = ex.num_ranks, list(ex.local_positions)
        # the hosted positions are contiguous: every rank, or one
        lo, k = positions[0], len(positions)
        names = [name for name, p in params.items() if p.requires_grad]
        layouts = [self._layout(params[n].numel(), R, dev) for n in names]
        with torch.no_grad():
            shards = [lay.shard(lay.padded(params[n]))[lo:lo + k].clone()
                      for n, lay in zip(names, layouts)]
        opts = []
        for row in range(k):
            opt = _capturable(self.optimizer([b[row] for b in shards]), dev)
            _init_optimizer_state(opt)
            opts.append(opt)
        state = {"params": params,
                 "opt_state": ShardedOptState(names, shards, opts,
                                              positions)}
        if self._quantized():
            # under a hint the residual lives where the outer hop
            # quantizes: on the inner-scattered (pad // inner) shard
            hint = self._shard_hint(R)
            inner = hint.inner if hint is not None else 1
            state["grad_ef"] = {
                n: torch.zeros((k, lay.pad // inner), dtype=torch.float32,
                               device=dev)
                for n, lay in zip(names, layouts)}
        return state

    def _clone_state(self, state):
        """A state sharing no tensor with ``state``: cloned params, new
        optimizers over them (or over cloned shards) holding clones of the
        old ones' state and their groups' hyperparameters, cloned aux and
        residuals."""
        params = {k: v.detach().clone().requires_grad_(v.requires_grad)
                  for k, v in state["params"].items()}
        old = state["opt_state"]
        if isinstance(old, ShardedOptState):
            shards = [b.clone() for b in old.shards]
            opts = [self._clone_optimizer(
                o, [b[row] for b in shards], old.rank_params(r))
                for row, (r, o) in enumerate(zip(old.positions,
                                                 old.optimizers))]
            opt = ShardedOptState(old.names, shards, opts, old.positions)
        else:
            opt = self._clone_optimizer(old, list(params.values()),
                                        list(state["params"].values()))
        out = {"params": params, "opt_state": opt}
        for key in ("aux", "grad_ef"):
            if key in state:
                out[key] = pytree.tree_map(torch.clone, state[key])
        return out

    def _clone_optimizer(self, old, new_params, old_params):
        opt = self.optimizer(new_params)
        for g_new, g_old in zip(opt.param_groups, old.param_groups):
            g_new.update({k: v for k, v in g_old.items() if k != "params"})
        for p_old, p_new in zip(old_params, new_params):
            st = old.state.get(p_old)
            if st:
                opt.state[p_new] = {
                    k: v.clone() if torch.is_tensor(v) else v
                    for k, v in st.items()}
        return opt

    def _stage_batch(self, ex, slots, device):
        """{pos: batch_tree} for the local ranks -> one tree of (R, ...)
        tensors on ``device``."""
        trees = [slots[pos] for pos in ex.local_positions]
        flat = [pytree.tree_flatten(t) for t in trees]
        spec = flat[0][1]
        if any(s != spec for _, s in flat):
            raise ValueError(
                "compiled step signature mismatch across local ranks: "
                "batch trees differ")
        staged = [torch.stack([torch.as_tensor(leaves[k])
                               for leaves, _ in flat]).to(device)
                  for k in range(len(flat[0][0]))]
        return pytree.tree_unflatten(staged, spec)

    def _run(self, prog, state, rows):
        if not self.donate:
            state = self._clone_state(state)
        out, loss = prog(state, rows)
        if isinstance(prog, _GraphProgram):
            # the graph's outputs: the next replay overwrites them
            loss = loss.clone()
            if not self.donate:
                out = self._clone_state(out)
        return out, loss

    # -- call ----------------------------------------------------------------

    def place_batch(self, batch):
        """Stage this rank's batch on the device once; the returned
        :class:`StagedBatch` skips the per-step staging (and, in a
        captured step, is read in place: no copy per step)."""
        eng, ps = _ps_state(self.process_set)
        ex = ps.compiled_executor
        if len(ex.local_positions) != 1:
            raise ValueError(
                "place_batch is per-process: use it in one-rank-per-"
                "process deployments (rank threads stage via the "
                "rendezvous instead)")
        return StagedBatch(self._stage_batch(
            ex, {ex.local_positions[0]: batch}, eng.device))

    def __call__(self, state, batch):
        """Run one step with THIS rank's ``batch``; returns ``(new_state,
        loss)``.  All member ranks call per step."""
        eng, ps = _ps_state(self.process_set)
        ex = ps.compiled_executor
        n_local = len(ex.local_positions)
        if n_local == 1:
            # before the first program: a process whose shapes differ
            # from its peers' raises here, never inside a collective
            self._check_step_signature(eng, ps, state, batch)
            prog = self._program(ex, eng.device)
            rows = batch.tree if isinstance(batch, StagedBatch) else \
                self._stage_batch(ex, {ex.local_positions[0]: batch},
                                  eng.device)
            return self._run(prog, state, rows)
        pos = _caller_pos(eng, ps)
        if pos is None:
            raise ValueError(
                "unbound caller: run the compiled step from rank threads "
                "(hvd.run)")
        rdv = _rendezvous_for(
            ps, self._step_tag(ps, basics.context().rank), n_local)

        def launch_rdv(slots):
            # every rank passed the same state; the leader's program runs
            # on the first slot's
            first = slots[sorted(slots)[0]]
            self._check_step_signature(eng, ps, first[0], first[1])
            rows = self._stage_batch(
                ex, {p: slots[p][1] for p in slots}, eng.device)
            return self._run(self._program(ex, eng.device), first[0], rows)

        return rdv.run(pos, (state, batch), launch_rdv)


class StagedBatch:
    """Marker for a batch already staged on the step's device (see
    ``_CompiledTrainStep.place_batch``)."""

    __slots__ = ("tree",)

    def __init__(self, tree):
        self.tree = tree


def make_compiled_train_step(loss_fn, optimizer, *, op=Average,
                             process_set=global_process_set,
                             donate=True, has_aux=False,
                             sharded=False, wire_dtype=None,
                             topology_hint=None, wire_inner=None):
    """Build the compiled Horovod train step: forward, backward, the
    cross-rank gradient reduction and the optimizer update as one
    program, on the card one CUDA graph replayed every step after a
    warm-up step and a capture.

    ``loss_fn(params, batch) -> scalar tensor`` is the per-rank loss over
    dicts of tensors (with ``has_aux=True``: ``loss_fn(params, aux,
    batch) -> (loss, new_aux)``, threading mutable model state such as
    BatchNorm statistics; float aux leaves are averaged over the ranks,
    the sync-BN convention).  ``optimizer`` is a function from a list of
    parameters to a ``torch.optim.Optimizer`` (``parallel.train.sgd``,
    ``parallel.train.adamw``).  ``op`` is ``Average`` or ``Sum``.
    ``donate=True`` updates the state in place; ``donate=False`` leaves
    the caller's state untouched and returns a new one.

    Example (per rank), a model through ``torch.func.functional_call``::

        model = ResNet50(num_classes=1000)
        params = {k: p.detach() for k, p in model.named_parameters()}
        stats = {k: b for k, b in model.named_buffers()}

        def loss_fn(params, aux, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**params, **aux},
                                                (x,))
            return F.cross_entropy(logits, y), aux

        step = make_compiled_train_step(loss_fn, sgd(0.1, momentum=0.9),
                                        has_aux=True)
        state = step.init_state(params, aux=stats)
        for batch in shard_of_data:
            state, loss = step(state, batch)

    The captured graph reads its inputs at their capture-time addresses:
    a batch that is not the captured one is copied in (a
    :class:`StagedBatch` from :meth:`~_CompiledTrainStep.place_batch` is
    read in place), the optimizer's hyperparameters are constants of the
    graph, and the returned loss is a copy.

    ``sharded=True`` builds the weight-update-sharded step (ZeRO,
    arXiv:1909.09756) with the same call contract: each parameter's
    gradients reducescatter over the ranks, optionally over a 16-bit or
    shared-scale int8/int4 ``wire_dtype`` with an error-feedback residual
    in the state (``grad_ef``), each rank's optimizer updates its flat
    1/R shard of the parameters and holds only that shard of the
    optimizer state (``init_state`` builds the :class:`ShardedOptState`),
    and the updated shards gather back into the replicated parameters.
    ``HOROVOD_OVERLAP_BUCKET_BYTES`` splits each leaf's scatter and
    gather into segments, bit for bit the unsegmented step.  The dense
    step ignores ``wire_dtype``, as the JAX package's does.

    ``op=Adasum`` on the dense step combines each gradient leaf over the
    ranks with Adasum (as JAX's does; the eager engine combines per fused
    bucket).  ``op=Adasum`` with ``sharded=True`` raises ``ValueError``,
    as in the JAX package.

    ``topology_hint`` (a :class:`TopologyHint`) decomposes the sharded
    step's scatter and gather per hop: the gradients sum over the inner
    axis, then their 1/inner shards over the outer axis, each rank owns
    the slice the two scatters leave it, and the updated shards gather
    back over the outer axis, then the inner one.  Under a quantized
    ``wire_dtype`` the inner hop rides ``wire_inner`` and the outer hop
    the shared-scale codec, the residual (``grad_ef``) living on the
    1/inner shard.  The decomposed sharded step runs on the stacked
    layout (rank threads of one process); the dense step ignores the
    hint and ``wire_inner``, as the JAX package's does.
    """
    return _CompiledTrainStep(loss_fn, optimizer, op, process_set,
                              donate, has_aux=has_aux,
                              sharded=sharded, wire_dtype=wire_dtype,
                              topology_hint=topology_hint,
                              wire_inner=wire_inner)


# optax's flat state leaves and the torch optimizer state that holds them
_OPTAX_SLOTS = {"trace": "momentum_buffer", "mu": "exp_avg",
                "nu": "exp_avg_sq"}


def sharded_state_from_jax(step, params, opt_leaves, aux=None,
                           grad_ef=None):
    """The port's sharded train state for the JAX package's: the carrier
    of a mid-run ``make_compiled_train_step(sharded=True)`` state.

    ``step`` is the port's sharded step (its ``init_state`` runs inside
    ``hvd.run``, or in a process of a launcher's job, which takes its
    rank's rows); ``params`` and ``aux`` are the port's named arrays;
    ``opt_leaves`` maps an optax slot to ``{name: array}`` of the JAX
    package's global flat leaves, ``(pad,)`` in its segment-major layout:
    ``"trace"`` (``optax.sgd``'s momentum, into ``momentum_buffer``),
    ``"mu"`` and ``"nu"`` (``optax.adam``/``adamw``'s moments, into
    ``exp_avg`` and ``exp_avg_sq``), and ``"count"``, an integer (into
    each shard's ``step``).  ``grad_ef`` maps a name to its ``(R, pad)``
    residual.  Each JAX leaf must hold its elements in the port leaf's
    order: a flat leaf keeps no shape, so a conv kernel (HWIO there, OIHW
    here) or the flax LM's stacked layers would land on other elements."""
    state = step.init_state(params, aux=aux)
    so = state["opt_state"]
    # the JAX row each position owns: its own, or under a hint the
    # natural slice the two scatters leave it (``_ShardLayout.owner``)
    hint = step._shard_hint(len(so.positions)) \
        if len(so.positions) > 1 else None
    row = [(p % hint.inner) * hint.outer + p // hint.inner
           if hint is not None else p for p in range(max(so.positions) + 1)]
    with torch.no_grad():
        for slot, arrays in opt_leaves.items():
            if slot == "count":
                for r, opt in zip(so.positions, so.optimizers):
                    for p in so.rank_params(r):
                        opt.state[p]["step"].fill_(float(arrays))
                continue
            key = _OPTAX_SLOTS.get(slot)
            if key is None:
                raise ValueError(f"unknown optax slot {slot!r}; known: "
                                 f"{sorted(_OPTAX_SLOTS)} and 'count'")
            for i, name in enumerate(so.names):
                rows = torch.as_tensor(np.asarray(arrays[name])).view(
                    -1, so.shards[i].shape[1])
                for r, opt in zip(so.positions, so.optimizers):
                    st = opt.state[so.rank_params(r)[i]]
                    if key not in st:
                        raise ValueError(
                            f"the optimizer has no {key!r} for the optax "
                            f"slot {slot!r}")
                    st[key].copy_(rows[row[r]])
        for name, arr in (grad_ef or {}).items():
            state["grad_ef"][name].copy_(
                torch.as_tensor(np.asarray(arr))[[row[r] for r in
                                                  so.positions]])
    return state
