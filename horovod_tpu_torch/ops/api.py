"""Public collective-op API (port of ``horovod_tpu/ops/api.py``): sync,
``*_async`` handle and in-place variants of allreduce, grouped
allreduce, allgather, grouped allgather, broadcast, alltoall,
reducescatter and grouped reducescatter, plus ``barrier``, ``join``,
``synchronize``/``poll``, ``broadcast_object`` and ``allgather_object``.

Allreduces, reducescatters and alltoalls take ``wire_dtype=`` (None,
'f32', 'fp16', 'bf16', 'int8', 'int4' and their aliases), normalized at
the call: the wire the payload rides (``ops/quantize.py``).  Allreduces
also take ``algorithm=`` ('flat', 'hierarchical', 'torus'; None = the
process-wide default) and ``wire_inner=`` (the inner hop's wire under a
2-D decomposition, where ``wire_dtype`` is the outer hop's).  The grouped
reducescatter and allgather take ``shard_fp=``, the shard-layout
fingerprint of a sharded weight update (``core/sharded.py``), which the
engine validates across ranks.

Tensors stay on the runtime's device end to end: a payload is handed to
the engine as it is (made contiguous if it is not), and results come
back as tensors on the same device.  On the card ``synchronize()``
orders the caller's current stream after the engine's work.
"""

import pickle

import numpy as np
import torch

from ..common import basics
from ..common.process_sets import ProcessSet, global_process_set
from ..core.engine import Submission
from ..core.handles import Handle
from ..core.message import (
    Adasum, Average, Sum, Min, Max, Product, ReduceOp, Request, RequestType,
)
from ..common.topology import normalize_algorithm
from .quantize import normalize_inner_wire, normalize_wire_dtype

__all__ = [
    "allreduce", "allreduce_async", "allreduce_", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_async",
    "grouped_allreduce_", "grouped_allreduce_async_",
    "allgather", "allgather_async",
    "grouped_allgather", "grouped_allgather_async",
    "broadcast", "broadcast_async", "broadcast_", "broadcast_async_",
    "reducescatter", "reducescatter_async",
    "grouped_reducescatter", "grouped_reducescatter_async",
    "alltoall", "alltoall_async", "barrier", "join",
    "synchronize", "poll", "broadcast_object", "allgather_object",
    "Average", "Sum", "Adasum", "Min", "Max", "Product",
]


def _ps_id(process_set):
    if process_set is None:
        return 0
    if isinstance(process_set, ProcessSet):
        if process_set.process_set_id is None:
            raise ValueError("process set is not registered")
        return process_set.process_set_id
    return int(process_set)


def _resolve_op(op, average):
    """Reference op/average compatibility (torch/mpi_ops.py:150-190)."""
    if op is not None and average is not None:
        raise ValueError("The op parameter supersedes average; "
                         "please provide only one of them")
    if op is None:
        op = Average if average is None or average else Sum
    return ReduceOp(op)


def dtype_name(dtype) -> str:
    """Negotiation dtype string, the same names the JAX package uses
    (``float32``, ``bfloat16``, ``int32``, ...)."""
    return str(dtype).replace("torch.", "")


def _stage(tensor):
    """The payload the engine reads: ``tensor`` itself when it is a
    contiguous tensor on the runtime's device."""
    dev = basics.engine().device
    t = tensor if isinstance(tensor, torch.Tensor) else \
        torch.as_tensor(tensor, device=dev)
    if t.device != dev:
        raise ValueError(
            f"tensor is on {t.device} but horovod_tpu_torch runs on {dev}")
    t = t.detach()
    return t if t.is_contiguous() else t.contiguous()


def _inplace_output(target, payload):
    """Where the engine may write an in-place result directly: the
    target itself when the payload IS the target's memory."""
    return target if payload.data_ptr() == target.data_ptr() \
        and target.is_contiguous() else None


def _submit(request, payloads, names, outputs=None):
    eng = basics.engine()
    ready = stream = None
    if eng.device.type == "cuda":
        stream = torch.cuda.current_stream(eng.device)
        ready = torch.cuda.Event()
        ready.record(stream)
    sub = Submission(rank=request.rank, request=request, names=names,
                     payloads=payloads, handle=Handle(), outputs=outputs,
                     ready_event=ready, stream=stream)
    return eng.submit(sub)


def _wire_name(ctx, op_type, name):
    """Explicit names become ``<optype>.<name>`` (torch/mpi_ops.py:129),
    auto names come from the per-rank counter."""
    if not name:
        return ctx.next_name(op_type)
    if name.startswith(f"{op_type}."):
        return name
    return f"{op_type}.{name}"


# ----------------------------------------------------------------------------
# allreduce

def allreduce_async(tensor, average=None, name=None, op=None,
                    prescale_factor=1.0, postscale_factor=1.0,
                    process_set=global_process_set, wire_dtype=None,
                    algorithm=None, wire_inner=None, _target=None):
    wire_dtype = normalize_wire_dtype(wire_dtype)
    wire_inner = normalize_inner_wire(wire_inner)
    algorithm = normalize_algorithm(algorithm)
    t = _stage(tensor)
    ctx = basics.context()
    op = _resolve_op(op, average)
    name = _wire_name(ctx, "allreduce", name)
    req = Request(
        request_type=RequestType.ALLREDUCE, tensor_name=name, rank=ctx.rank,
        dtype=dtype_name(t.dtype), shape=tuple(t.shape), reduce_op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set_id=_ps_id(process_set), wire_dtype=wire_dtype,
        wire_inner=wire_inner, algorithm=algorithm)
    outputs = [_inplace_output(_target, t)] if _target is not None else None
    return _submit(req, [t], [name], outputs)


def allreduce(tensor, average=None, name=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set, wire_dtype=None,
              algorithm=None, wire_inner=None):
    return synchronize(allreduce_async(tensor, average, name, op,
                                       prescale_factor, postscale_factor,
                                       process_set, wire_dtype, algorithm,
                                       wire_inner))


def allreduce_async_(tensor, average=None, name=None, op=None,
                     prescale_factor=1.0, postscale_factor=1.0,
                     process_set=global_process_set, wire_dtype=None,
                     algorithm=None, wire_inner=None):
    """In-place variant: the result is written into ``tensor`` (by the
    unpack itself when ``tensor`` is contiguous)."""
    h = allreduce_async(tensor, average, name, op, prescale_factor,
                        postscale_factor, process_set, wire_dtype,
                        algorithm, wire_inner, _target=tensor)
    h.inplace_target = tensor
    return h


def allreduce_(tensor, average=None, name=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0,
               process_set=global_process_set, wire_dtype=None,
               algorithm=None, wire_inner=None):
    return synchronize(allreduce_async_(tensor, average, name, op,
                                        prescale_factor, postscale_factor,
                                        process_set, wire_dtype, algorithm,
                                        wire_inner))


class _MultiHandle:
    """Composite handle over per-dtype grouped submissions: a mixed-
    dtype group partitions into one fused submission per dtype and
    reassembles results in input order."""

    def __init__(self, parts, index_lists, n):
        self.parts = parts
        self.index_lists = index_lists
        self.n = n
        self.grouped = True
        self.inplace_target = None
        self.inplace_targets = None

    def done(self):
        return all(h.done() for h in self.parts)

    @property
    def events(self):
        return [h.event for h in self.parts]

    def wait(self, timeout=None):
        out = [None] * self.n
        for h, idxs in zip(self.parts, self.index_lists):
            res = h.wait(timeout)
            if not isinstance(res, list):
                res = [res]
            for i, r in zip(idxs, res):
                out[i] = r
        return out


def grouped_allreduce_async(tensors, average=None, name=None, op=None,
                            prescale_factor=1.0, postscale_factor=1.0,
                            process_set=global_process_set, wire_dtype=None,
                            algorithm=None, wire_inner=None, _targets=None):
    """Grouped ops negotiate and execute as one unit (reference
    EnqueueTensorAllreduces).  Mixed-dtype groups partition into one
    fused submission per dtype, in sorted dtype order."""
    if not tensors:
        raise ValueError("grouped_allreduce requires at least one tensor")
    wire_dtype = normalize_wire_dtype(wire_dtype)
    wire_inner = normalize_inner_wire(wire_inner)
    algorithm = normalize_algorithm(algorithm)
    ts = [_stage(t) for t in tensors]
    ctx = basics.context()
    op = _resolve_op(op, average)
    base = _wire_name(ctx, "grouped_allreduce", name)
    by_dtype = {}
    for i, t in enumerate(ts):
        by_dtype.setdefault(dtype_name(t.dtype), []).append(i)

    def submit(idxs, group_name):
        req = Request(
            request_type=RequestType.ALLREDUCE, tensor_name=group_name,
            rank=ctx.rank, dtype=dtype_name(ts[idxs[0]].dtype),
            shape=tuple(ts[idxs[0]].shape), reduce_op=op,
            prescale_factor=prescale_factor,
            postscale_factor=postscale_factor,
            process_set_id=_ps_id(process_set), group_id=0,
            group_shapes=tuple(tuple(ts[i].shape) for i in idxs),
            wire_dtype=wire_dtype, wire_inner=wire_inner,
            algorithm=algorithm)
        outputs = None
        if _targets is not None:
            outputs = [_inplace_output(_targets[i], ts[i]) for i in idxs]
        h = _submit(req, [ts[i] for i in idxs],
                    [f"{group_name}.{j}" for j in range(len(idxs))], outputs)
        h.grouped = True
        return h

    if len(by_dtype) == 1:
        h = submit(list(range(len(ts))), base)
    else:
        dts = sorted(by_dtype)
        h = _MultiHandle([submit(by_dtype[dt], f"{base}.{dt}") for dt in dts],
                         [by_dtype[dt] for dt in dts], len(ts))
    return h


def grouped_allreduce(tensors, average=None, name=None, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set, wire_dtype=None,
                      algorithm=None, wire_inner=None):
    return synchronize(grouped_allreduce_async(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set, wire_dtype, algorithm, wire_inner))


def grouped_allreduce_async_(tensors, average=None, name=None, op=None,
                             prescale_factor=1.0, postscale_factor=1.0,
                             process_set=global_process_set,
                             wire_dtype=None, algorithm=None,
                             wire_inner=None):
    h = grouped_allreduce_async(tensors, average, name, op, prescale_factor,
                                postscale_factor, process_set, wire_dtype,
                                algorithm, wire_inner,
                                _targets=list(tensors))
    h.inplace_targets = list(tensors)
    return h


def grouped_allreduce_(tensors, average=None, name=None, op=None,
                       prescale_factor=1.0, postscale_factor=1.0,
                       process_set=global_process_set, wire_dtype=None,
                       algorithm=None, wire_inner=None):
    return synchronize(grouped_allreduce_async_(
        tensors, average, name, op, prescale_factor, postscale_factor,
        process_set, wire_dtype, algorithm, wire_inner))


# ----------------------------------------------------------------------------
# allgather / grouped allgather / broadcast

def allgather_async(tensor, name=None, process_set=global_process_set):
    t = _stage(tensor)
    if t.dim() == 0:
        t = t.reshape(1)
    ctx = basics.context()
    name = _wire_name(ctx, "allgather", name)
    req = Request(
        request_type=RequestType.ALLGATHER, tensor_name=name, rank=ctx.rank,
        dtype=dtype_name(t.dtype), shape=tuple(t.shape),
        process_set_id=_ps_id(process_set))
    return _submit(req, [t], [name])


def allgather(tensor, name=None, process_set=global_process_set):
    return synchronize(allgather_async(tensor, name, process_set))


def _one_dtype(op_name, ts):
    """The joint request of a grouped op carries one dtype."""
    dtypes = {dtype_name(t.dtype) for t in ts}
    if len(dtypes) > 1:
        raise ValueError(f"{op_name} requires matching dtypes, got "
                         f"{sorted(dtypes)}")


def grouped_allgather_async(tensors, name=None,
                            process_set=global_process_set, shard_fp=None):
    """Jointly negotiated allgather of several tensors of one dtype (JAX
    ``api.py:322-357``): one submission, one handle resolving to a
    list."""
    if not tensors:
        raise ValueError("grouped_allgather requires at least one tensor")
    ts = [_stage(t) for t in tensors]
    ts = [t.reshape(1) if t.dim() == 0 else t for t in ts]
    _one_dtype("grouped_allgather", ts)
    ctx = basics.context()
    base = _wire_name(ctx, "grouped_allgather", name)
    req = Request(
        request_type=RequestType.ALLGATHER, tensor_name=base, rank=ctx.rank,
        dtype=dtype_name(ts[0].dtype), shape=tuple(ts[0].shape),
        process_set_id=_ps_id(process_set), group_id=0,
        group_shapes=tuple(tuple(t.shape) for t in ts), shard_fp=shard_fp)
    h = _submit(req, ts, [f"{base}.{i}" for i in range(len(ts))])
    h.grouped = True
    return h


def grouped_allgather(tensors, name=None, process_set=global_process_set,
                      shard_fp=None):
    return synchronize(grouped_allgather_async(tensors, name, process_set,
                                               shard_fp))


def broadcast_async(tensor, root_rank, name=None,
                    process_set=global_process_set, _target=None):
    t = _stage(tensor)
    ctx = basics.context()
    name = _wire_name(ctx, "broadcast", name)
    req = Request(
        request_type=RequestType.BROADCAST, tensor_name=name, rank=ctx.rank,
        dtype=dtype_name(t.dtype), shape=tuple(t.shape),
        root_rank=int(root_rank), process_set_id=_ps_id(process_set))
    outputs = [_inplace_output(_target, t)] if _target is not None else None
    return _submit(req, [t], [name], outputs)


def broadcast(tensor, root_rank, name=None, process_set=global_process_set):
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def broadcast_async_(tensor, root_rank, name=None,
                     process_set=global_process_set):
    h = broadcast_async(tensor, root_rank, name, process_set, _target=tensor)
    h.inplace_target = tensor
    return h


def broadcast_(tensor, root_rank, name=None, process_set=global_process_set):
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


# ----------------------------------------------------------------------------
# reducescatter

def reducescatter_async(tensor, op=Average, name=None, prescale_factor=1.0,
                        postscale_factor=1.0, process_set=global_process_set,
                        wire_dtype=None):
    """Reduce across ranks, then scatter along dim 0: rank j receives
    chunk j, the chunks as even as possible with the larger ones on the
    lower ranks (JAX ``api.py:455-483``)."""
    wire_dtype = normalize_wire_dtype(wire_dtype)
    t = _stage(tensor)
    if t.dim() == 0:
        raise ValueError("reducescatter requires a tensor with >=1 dim")
    ctx = basics.context()
    op = _resolve_op(op, None)
    name = _wire_name(ctx, "reducescatter", name)
    req = Request(
        request_type=RequestType.REDUCESCATTER, tensor_name=name,
        rank=ctx.rank, dtype=dtype_name(t.dtype), shape=tuple(t.shape),
        reduce_op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor,
        process_set_id=_ps_id(process_set), wire_dtype=wire_dtype)
    return _submit(req, [t], [name])


def reducescatter(tensor, op=Average, name=None, prescale_factor=1.0,
                  postscale_factor=1.0, process_set=global_process_set,
                  wire_dtype=None):
    return synchronize(reducescatter_async(
        tensor, op, name, prescale_factor, postscale_factor, process_set,
        wire_dtype))


def grouped_reducescatter_async(tensors, op=Average, name=None,
                                prescale_factor=1.0, postscale_factor=1.0,
                                process_set=global_process_set,
                                wire_dtype=None, shard_fp=None):
    """Jointly negotiated reducescatter of several tensors of one dtype
    (JAX ``api.py:485-533``): one submission, one handle resolving to a
    list."""
    if not tensors:
        raise ValueError("grouped_reducescatter requires at least one "
                         "tensor")
    wire_dtype = normalize_wire_dtype(wire_dtype)
    ts = [_stage(t) for t in tensors]
    if any(t.dim() == 0 for t in ts):
        raise ValueError("reducescatter requires tensors with >=1 dim")
    _one_dtype("grouped_reducescatter", ts)
    ctx = basics.context()
    op = _resolve_op(op, None)
    base = _wire_name(ctx, "grouped_reducescatter", name)
    req = Request(
        request_type=RequestType.REDUCESCATTER, tensor_name=base,
        rank=ctx.rank, dtype=dtype_name(ts[0].dtype),
        shape=tuple(ts[0].shape), reduce_op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set_id=_ps_id(process_set), group_id=0,
        group_shapes=tuple(tuple(t.shape) for t in ts),
        wire_dtype=wire_dtype, shard_fp=shard_fp)
    h = _submit(req, ts, [f"{base}.{i}" for i in range(len(ts))])
    h.grouped = True
    return h


def grouped_reducescatter(tensors, op=Average, name=None,
                          prescale_factor=1.0, postscale_factor=1.0,
                          process_set=global_process_set, wire_dtype=None,
                          shard_fp=None):
    return synchronize(grouped_reducescatter_async(
        tensors, op, name, prescale_factor, postscale_factor, process_set,
        wire_dtype, shard_fp))


# ----------------------------------------------------------------------------
# alltoall

def alltoall_async(tensor, splits=None, name=None,
                   process_set=global_process_set, wire_dtype=None,
                   wire_inner=None, error_feedback=True):
    """Send ``splits[j]`` rows of ``tensor`` (first dimension) to rank j
    of the set; equal splits when None (JAX ``api.py:392-435``).  The
    splits are checked here and raise ``ValueError``, as the reference
    does before it enqueues."""
    t = _stage(tensor)
    if t.dim() == 0:
        raise ValueError("alltoall requires a tensor with at least 1 dim")
    ps_size = len(basics.engine().process_set_ranks(_ps_id(process_set)))
    if splits is None:
        if t.shape[0] % ps_size != 0:
            raise ValueError(
                f"alltoall first dim {t.shape[0]} not divisible by "
                f"process-set size {ps_size}; pass explicit splits")
        splits = [t.shape[0] // ps_size] * ps_size
    arr = np.asarray(splits.cpu() if torch.is_tensor(splits) else splits)
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"alltoall splits must contain 32-bit integers, "
                         f"got {arr.dtype}")
    splits_t = tuple(int(s) for s in np.ravel(arr))
    if any(s < 0 for s in splits_t):
        raise ValueError(f"alltoall splits must be non-negative: "
                         f"{splits_t}")
    if sum(splits_t) != t.shape[0]:
        raise ValueError(
            f"alltoall splits sum to {sum(splits_t)} but the tensor's "
            f"first dimension is {t.shape[0]}")
    ctx = basics.context()
    name = _wire_name(ctx, "alltoall", name)
    req = Request(
        request_type=RequestType.ALLTOALL, tensor_name=name, rank=ctx.rank,
        dtype=dtype_name(t.dtype), shape=tuple(t.shape), splits=splits_t,
        process_set_id=_ps_id(process_set),
        wire_dtype=normalize_wire_dtype(wire_dtype),
        wire_inner=normalize_inner_wire(wire_inner),
        error_feedback=bool(error_feedback))
    h = _submit(req, [t], [name])
    h.returns_splits = True
    return h


def alltoall(tensor, splits=None, name=None, process_set=global_process_set,
             wire_dtype=None, wire_inner=None, error_feedback=True):
    """Returns ``(received tensor, received splits)``; the received
    splits are an int32 tensor on the CPU.  ``wire_dtype`` picks the
    exchange's wire (int8/int4: block-scaled codes and bf16 scales per
    destination slot), None inherits the process-wide default as the
    reductions do; ``error_feedback`` folds each peer slot's quantization
    residual into that slot's next exchange (off: stateless encode)."""
    return synchronize(alltoall_async(tensor, splits, name, process_set,
                                      wire_dtype, wire_inner,
                                      error_feedback))


# ----------------------------------------------------------------------------
# barrier / join / completion

def barrier(process_set=global_process_set):
    """Block until every rank of the set reaches the barrier (reference
    EnqueueBarrier, operations.cc:2026)."""
    ctx = basics.context()
    name = ctx.next_name("barrier")
    req = Request(
        request_type=RequestType.BARRIER, tensor_name=name, rank=ctx.rank,
        dtype="uint8", shape=(), process_set_id=_ps_id(process_set))
    _submit(req, [torch.zeros(0, dtype=torch.uint8,
                              device=basics.engine().device)],
            [name]).wait()


def join(device=None, process_set=global_process_set) -> int:
    """This rank is out of data: later allreduces on the set take it as a
    zero contributor.  Blocks until every rank of the set has joined and
    returns the last rank to join (reference operations.cc:1991).
    ``device`` is accepted for the reference's signature and unused."""
    ctx = basics.context()
    return basics.engine().join(ctx.rank, _ps_id(process_set)).wait()


def poll(handle) -> bool:
    return handle.done()


def _device_wait(handle, results):
    """Order the caller's stream after the engine's work, and mark the
    results as used on it (their blocks belong to the engine stream's
    pool)."""
    events = handle.events if isinstance(handle, _MultiHandle) \
        else [handle.event]
    events = [e for e in events if e is not None]
    if not events:
        return
    stream = torch.cuda.current_stream(basics.engine().device)
    for ev in events:
        stream.wait_event(ev)
    for t in results:
        t.record_stream(stream)


def _copy_back(target, result):
    if target is None or result is target:
        return result
    with torch.no_grad():
        target.copy_(result.view_as(target))
    return target


def synchronize(handle):
    """Wait for an async op and return its result(s); in-place variants
    return their targets."""
    result = handle.wait()
    if getattr(handle, "returns_splits", False):
        _device_wait(handle, [result])
        return result, handle.extra
    if getattr(handle, "grouped", False) and not isinstance(result, list):
        result = [result]
    _device_wait(handle, result if isinstance(result, list) else [result])
    if isinstance(result, list):
        targets = handle.inplace_targets or [None] * len(result)
        return [_copy_back(t, r) for t, r in zip(targets, result)]
    return _copy_back(handle.inplace_target, result)


# ----------------------------------------------------------------------------
# object broadcast (reference torch/functions.py broadcast_object)

def broadcast_object(obj, root_rank=0, name=None,
                     process_set=global_process_set):
    name = name or "broadcast_object"
    dev = basics.engine().device
    if basics.rank() == root_rank:
        raw = np.frombuffer(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL),
                            dtype=np.uint8)
        payload = torch.from_numpy(raw.copy()).to(dev)
    else:
        payload = torch.zeros(0, dtype=torch.uint8, device=dev)
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                   device=dev),
                      name=f"{name}.sz", process_set=process_set)
    ranks = basics.engine().process_set_ranks(_ps_id(process_set))
    n = int(sizes[ranks.index(root_rank)])
    if basics.rank() != root_rank:
        payload = torch.zeros(n, dtype=torch.uint8, device=dev)
    out = broadcast(payload, root_rank, name=f"{name}.data",
                    process_set=process_set)
    return pickle.loads(out.cpu().numpy().tobytes())


def allgather_object(obj, name=None, process_set=global_process_set):
    """Every rank's ``obj`` (pickled), in rank order of the set (JAX
    ``api.py:602-615``)."""
    name = name or "allgather_object"
    dev = basics.engine().device
    raw = np.frombuffer(pickle.dumps(obj, pickle.HIGHEST_PROTOCOL),
                        dtype=np.uint8)
    payload = torch.from_numpy(raw.copy()).to(dev)
    gathered = allgather(payload, name=f"{name}.data",
                         process_set=process_set).cpu().numpy()
    sizes = allgather(torch.tensor([payload.numel()], dtype=torch.int64,
                                   device=dev),
                      name=f"{name}.sz", process_set=process_set).cpu()
    out, off = [], 0
    for s in sizes.tolist():
        out.append(pickle.loads(gathered[off:off + s].tobytes()))
        off += s
    return out
