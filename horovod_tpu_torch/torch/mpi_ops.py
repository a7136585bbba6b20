"""Torch collective ops (port of ``horovod_tpu/torch/mpi_ops.py``: the
allreduce, grouped allreduce, allgather, grouped allgather, broadcast,
alltoall, reducescatter and grouped reducescatter autograd Functions and
their sync wrappers, with ``barrier`` and ``join``).  Unlike the JAX
package's torch frontend, tensors stay on their device: nothing is staged
through numpy.

Gradients (reference torch/mpi_ops.py:194-1100):

* allreduce grad = allreduce of the output grad (same op and scales)
* allgather grad = average-allreduce, then this rank's row slice
* broadcast grad = average-allreduce, zeroed on non-root ranks
* alltoall grad = alltoall of the output grad by the received splits
* reducescatter grad = allgather of the output grad, scaled by
  ``common/util.reducescatter_grad_factor`` times prescale * postscale
"""

import torch

from ..common import basics
from ..common.process_sets import global_process_set
from ..common import util as _util
from ..common.util import get_average_backwards_compatibility_fun
from ..ops import api as _api
from ..ops.api import (  # noqa: F401
    allreduce_async, allreduce_, allreduce_async_,
    grouped_allreduce_async, grouped_allreduce_, grouped_allreduce_async_,
    allgather_async, grouped_allgather_async, broadcast_async, broadcast_,
    broadcast_async_, alltoall_async, reducescatter_async,
    grouped_reducescatter_async, barrier, join, synchronize, poll,
    Average, Sum, Adasum, Min, Max, Product,
)
from .compression import Compression

# deprecated ``average=`` kwarg adapter (reference torch/mpi_ops.py:125)
handle_average_backwards_compatibility = \
    get_average_backwards_compatibility_fun(_api)


def _differentiable(*tensors):
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def _ps_rank_pos(process_set):
    ranks = basics.engine().process_set_ranks(_api._ps_id(process_set))
    return ranks.index(basics.rank())


def _ps_size(process_set):
    return len(basics.engine().process_set_ranks(_api._ps_id(process_set)))


class HorovodAllreduce(torch.autograd.Function):
    """Differentiable allreduce (reference torch/mpi_ops.py:194)."""

    @staticmethod
    def forward(ctx, tensor, average, name, op, prescale_factor,
                postscale_factor, process_set):
        ctx.average = average
        ctx.op = op
        ctx.prescale_factor = prescale_factor
        ctx.postscale_factor = postscale_factor
        ctx.process_set = process_set
        return _api.allreduce(tensor, average, name, op, prescale_factor,
                              postscale_factor, process_set)

    @staticmethod
    def backward(ctx, grad_output):
        return (allreduce(grad_output, average=ctx.average, op=ctx.op,
                          prescale_factor=ctx.prescale_factor,
                          postscale_factor=ctx.postscale_factor,
                          process_set=ctx.process_set),
                None, None, None, None, None, None)


class HorovodGroupedAllreduce(torch.autograd.Function):
    """Differentiable grouped allreduce (reference torch/mpi_ops.py:421)."""

    @staticmethod
    def forward(ctx, average, name, op, prescale_factor, postscale_factor,
                process_set, *tensors):
        ctx.average = average
        ctx.op = op
        ctx.prescale_factor = prescale_factor
        ctx.postscale_factor = postscale_factor
        ctx.process_set = process_set
        return tuple(_api.grouped_allreduce(
            list(tensors), average, name, op, prescale_factor,
            postscale_factor, process_set))

    @staticmethod
    def backward(ctx, *grad_outputs):
        grads = grouped_allreduce(list(grad_outputs), average=ctx.average,
                                  op=ctx.op,
                                  prescale_factor=ctx.prescale_factor,
                                  postscale_factor=ctx.postscale_factor,
                                  process_set=ctx.process_set)
        return (None, None, None, None, None, None, *grads)


class HorovodAllgather(torch.autograd.Function):
    """Differentiable allgather (reference torch/mpi_ops.py:630)."""

    @staticmethod
    def forward(ctx, tensor, name, process_set):
        ctx.scalar = tensor.dim() == 0
        ctx.dim0 = tensor.shape[0] if tensor.dim() else 1
        ctx.process_set = process_set
        return _api.allgather(tensor, name, process_set)

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = allreduce(grad_output, average=True,
                                 process_set=ctx.process_set)
        dims = allgather(torch.tensor([ctx.dim0],
                                      device=grad_output.device),
                         process_set=ctx.process_set)
        pos = _ps_rank_pos(ctx.process_set)
        offset = int(dims[:pos].sum()) if pos else 0
        grad = grad_reduced.narrow(0, offset, ctx.dim0)
        if ctx.scalar:
            grad = grad.reshape(())
        return grad, None, None


class HorovodGroupedAllgather(torch.autograd.Function):
    """Differentiable grouped allgather (JAX torch/mpi_ops.py:155)."""

    @staticmethod
    def forward(ctx, name, process_set, *tensors):
        ctx.scalars = [t.dim() == 0 for t in tensors]
        ctx.dim0s = [t.shape[0] if t.dim() else 1 for t in tensors]
        ctx.process_set = process_set
        return tuple(_api.grouped_allgather(list(tensors), name,
                                            process_set))

    @staticmethod
    def backward(ctx, *grad_outputs):
        grads_reduced = grouped_allreduce(list(grad_outputs), average=True,
                                          process_set=ctx.process_set)
        dims = allgather(torch.tensor(ctx.dim0s,
                                      device=grad_outputs[0].device)
                         .view(1, -1), process_set=ctx.process_set)
        pos = _ps_rank_pos(ctx.process_set)
        grads = []
        for i, g in enumerate(grads_reduced):
            offset = int(dims[:pos, i].sum()) if pos else 0
            g = g.narrow(0, offset, ctx.dim0s[i])
            grads.append(g.reshape(()) if ctx.scalars[i] else g)
        return (None, None, *grads)


class HorovodBroadcast(torch.autograd.Function):
    """Differentiable broadcast (reference torch/mpi_ops.py:813)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name, process_set):
        ctx.root_rank = root_rank
        ctx.process_set = process_set
        return _api.broadcast(tensor, root_rank, name, process_set)

    @staticmethod
    def backward(ctx, grad_output):
        grad_reduced = allreduce(grad_output, average=True,
                                 process_set=ctx.process_set)
        if basics.rank() != ctx.root_rank:
            grad_reduced = grad_reduced * 0
        return grad_reduced, None, None, None


class HorovodAlltoall(torch.autograd.Function):
    """Differentiable alltoall (reference torch/mpi_ops.py:960): the
    backward sends each received segment's gradient back to its source,
    an alltoall by the received splits.  On the card, rank threads of one
    process run such a blocking backward each on its own thread
    (``torch.autograd.set_multithreading_enabled(False)``): autograd's
    one worker thread per device would run one rank's exchange while the
    peer's waits behind it."""

    @staticmethod
    def forward(ctx, tensor, splits, name, process_set):
        out, recv_splits = _api.alltoall(tensor, splits, name, process_set)
        ctx.process_set = process_set
        ctx.recv_splits = recv_splits
        if splits is None:
            return out
        ctx.mark_non_differentiable(recv_splits)
        return out, recv_splits

    @staticmethod
    def backward(ctx, grad_output, *dead_gradients):
        grad, _ = _api.alltoall(grad_output.contiguous(),
                                splits=ctx.recv_splits,
                                process_set=ctx.process_set)
        return grad, None, None, None


def _reducescatter_grad_scale(ctx):
    """The reference's convention (or the exact adjoint, by
    ``HOROVOD_EXACT_ADJOINT_REDUCESCATTER``), then the linear
    prescale * postscale the forward applied."""
    return _util.reducescatter_grad_factor(
        ctx.op == Average, _ps_size(ctx.process_set)) \
        * ctx.prescale_factor * ctx.postscale_factor


class HorovodReducescatter(torch.autograd.Function):
    """Differentiable reducescatter (JAX torch/mpi_ops.py:222)."""

    @staticmethod
    def forward(ctx, tensor, name, op, process_set, prescale_factor,
                postscale_factor):
        ctx.op = op
        ctx.process_set = process_set
        ctx.prescale_factor = prescale_factor
        ctx.postscale_factor = postscale_factor
        return _api.reducescatter(tensor, op, name, prescale_factor,
                                  postscale_factor, process_set)

    @staticmethod
    def backward(ctx, grad_output):
        scale = _reducescatter_grad_scale(ctx)
        if scale != 1.0:
            grad_output = grad_output * scale
        return (allgather(grad_output, process_set=ctx.process_set),
                None, None, None, None, None)


class HorovodGroupedReducescatter(torch.autograd.Function):
    """Differentiable grouped reducescatter (JAX torch/mpi_ops.py:251)."""

    @staticmethod
    def forward(ctx, name, op, process_set, prescale_factor,
                postscale_factor, *tensors):
        ctx.op = op
        ctx.process_set = process_set
        ctx.prescale_factor = prescale_factor
        ctx.postscale_factor = postscale_factor
        return tuple(_api.grouped_reducescatter(
            list(tensors), op, name, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set))

    @staticmethod
    def backward(ctx, *grad_outputs):
        scale = _reducescatter_grad_scale(ctx)
        grads = [allgather(g * scale if scale != 1 else g,
                           process_set=ctx.process_set)
                 for g in grad_outputs]
        return (None, None, None, None, None, *grads)


# ----------------------------------------------------------------------------
# sync wrappers: differentiable for tensors that require grad

def allreduce(tensor, average=None, name=None, compression=Compression.none,
              op=None, prescale_factor=1.0, postscale_factor=1.0,
              process_set=global_process_set):
    """Allreduce; differentiable, with optional wire compression
    (reference torch/mpi_ops.py:215)."""
    compressed, cctx = compression.compress(tensor)
    if _differentiable(compressed):
        out = HorovodAllreduce.apply(compressed, average, name, op,
                                     prescale_factor, postscale_factor,
                                     process_set)
    else:
        out = _api.allreduce(compressed, average, name, op, prescale_factor,
                             postscale_factor, process_set)
    return compression.decompress(out, cctx)


def grouped_allreduce(tensors, average=None, name=None,
                      compression=Compression.none, op=None,
                      prescale_factor=1.0, postscale_factor=1.0,
                      process_set=global_process_set):
    pairs = [compression.compress(t) for t in tensors]
    compressed = [c for c, _ in pairs]
    if _differentiable(*compressed):
        outs = list(HorovodGroupedAllreduce.apply(
            average, name, op, prescale_factor, postscale_factor,
            process_set, *compressed))
    else:
        outs = _api.grouped_allreduce(compressed, average, name, op,
                                      prescale_factor, postscale_factor,
                                      process_set)
    return [compression.decompress(o, cc) for o, (_, cc) in zip(outs, pairs)]


def allgather(tensor, name=None, process_set=global_process_set):
    if _differentiable(tensor):
        return HorovodAllgather.apply(tensor, name, process_set)
    return _api.allgather(tensor, name, process_set)


def broadcast(tensor, root_rank, name=None, process_set=global_process_set):
    if _differentiable(tensor):
        return HorovodBroadcast.apply(tensor, root_rank, name, process_set)
    return _api.broadcast(tensor, root_rank, name, process_set)


def grouped_allgather(tensors, name=None, process_set=global_process_set):
    if _differentiable(*tensors):
        return list(HorovodGroupedAllgather.apply(name, process_set,
                                                  *tensors))
    return _api.grouped_allgather(tensors, name, process_set)


def alltoall(tensor, splits=None, name=None,
             process_set=global_process_set):
    """Reference return contract (torch/mpi_ops.py:984-1013): a bare
    tensor when ``splits`` is None, ``(tensor, received splits)`` when
    splits are given, on the autograd and the no-grad path alike."""
    if _differentiable(tensor):
        return HorovodAlltoall.apply(tensor, splits, name, process_set)
    out, recv_splits = _api.alltoall(tensor, splits, name, process_set)
    if splits is None:
        return out
    return out, recv_splits


def reducescatter(tensor, name=None, compression=Compression.none,
                  op=Average, process_set=global_process_set,
                  prescale_factor=1.0, postscale_factor=1.0):
    """Reducescatter; differentiable, with optional wire compression
    (JAX torch/mpi_ops.py:355)."""
    compressed, cctx = compression.compress(tensor)
    if _differentiable(compressed):
        out = HorovodReducescatter.apply(compressed, name, op, process_set,
                                         prescale_factor, postscale_factor)
    else:
        out = _api.reducescatter(compressed, op, name, prescale_factor,
                                 postscale_factor, process_set)
    return compression.decompress(out, cctx)


def grouped_reducescatter(tensors, name=None, compression=Compression.none,
                          op=Average, process_set=global_process_set,
                          prescale_factor=1.0, postscale_factor=1.0):
    pairs = [compression.compress(t) for t in tensors]
    compressed = [c for c, _ in pairs]
    if _differentiable(*compressed):
        outs = list(HorovodGroupedReducescatter.apply(
            name, op, process_set, prescale_factor, postscale_factor,
            *compressed))
    else:
        outs = _api.grouped_reducescatter(
            compressed, op, name, prescale_factor=prescale_factor,
            postscale_factor=postscale_factor, process_set=process_set)
    return [compression.decompress(o, cc) for o, (_, cc) in zip(outs, pairs)]


def sparse_allreduce_async(tensor, name, op,
                           process_set=global_process_set):
    """Average or sum a ``torch.sparse_coo_tensor`` by allgathering its
    indices and values (JAX torch/mpi_ops.py:388; reference
    torch/mpi_ops.py:567: allgather concatenates along dim 0, so the
    indices travel transposed).  Returns a zero-argument callable that
    completes the op and rebuilds the sparse tensor on the input's
    device."""
    t = tensor.coalesce() if not tensor.is_coalesced() else tensor
    indices_h = _api.allgather_async(
        t._indices().transpose(0, 1).contiguous(),
        name=f"{name}.indices", process_set=process_set)
    values_h = _api.allgather_async(t._values().contiguous(),
                                    name=f"{name}.values",
                                    process_set=process_set)

    def handle():
        values = _api.synchronize(values_h)
        indices = _api.synchronize(indices_h)
        if op == Average:
            values = values / _ps_size(process_set)
        if indices.numel() == 0 or values.numel() == 0:
            return torch.sparse_coo_tensor(
                torch.zeros((t.sparse_dim(), 0), dtype=torch.long,
                            device=t.device),
                torch.zeros((0, *t.shape[t.sparse_dim():]), dtype=t.dtype,
                            device=t.device), t.size(),
                check_invariants=False)
        # coalesce sums the entries several ranks contributed for one
        # index: the sparse counterpart of the dense reduction
        return torch.sparse_coo_tensor(
            indices.transpose(0, 1), values, t.size(),
            check_invariants=False).coalesce()

    return handle
