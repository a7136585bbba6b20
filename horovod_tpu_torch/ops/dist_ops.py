"""Collective executor over ``torch.distributed`` (port of
``horovod_tpu/ops/xla_ops.py::MeshExecutor``).

Two modes, as the reference has (``xla_ops.py:94-107``):

* **stacked** (``group=None``): every rank of the set lives in this
  process on one device (rank threads sharing a card, or the CPU).  The
  per-rank rows are stacked and reduced with plain tensor ops, as the
  JAX package's ``reduce_stacked`` does outside any kernel.
* **process group**: one rank per process (or per thread, in the CPU
  tests) over a ``torch.distributed`` ``ProcessGroup`` -- NCCL for CUDA
  tensors, gloo for CPU ones.  The executor calls the group object's
  own collectives, so a group built directly (``ProcessGroupGloo(store,
  rank, size)``) works as well as the default one.

Row convention: every method takes ``rows``, one flat tensor per rank
this process hosts (ordered by global rank), and returns one result
per such rank.
"""

import torch
import torch.distributed as dist

from ..core.message import ReduceOp
from . import quantize as qz
from . import quantize_kernels as qk
from .cuda_kernels import FLOAT_DTYPES, fused_scale_cast

_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def is_float(dtype) -> bool:
    return dtype in FLOAT_DTYPES


def allreduce_plan(op, dtype, prescale, postscale, num_ranks):
    """How an allreduce of ``dtype`` runs (xla_ops.py:193-233): returns
    (the unscaled reduction op, the float postscale, whether integer
    scaling applies).  A float Average is a Sum with postscale/R; an
    integer Average is a Sum that :func:`int_postscale` divides by R."""
    red_op = ReduceOp.SUM if op == ReduceOp.AVERAGE else op
    if is_float(dtype):
        if op == ReduceOp.AVERAGE:
            postscale = postscale / num_ranks
        return red_op, postscale, False
    return red_op, postscale, (op == ReduceOp.AVERAGE or prescale != 1.0
                               or postscale != 1.0)


# Integer pre/post scaling with the reference's semantics: scale in f64,
# truncate back; an integer average divides by the rank count instead
# of multiplying by 1/R, so exact multiples stay exact
# (xla_ops.py:224-233).  Plain tensor expressions: no TPU kernel
# computes these, and the float path (the kernel's) never takes them.

def int_prescale(x, prescale):
    return (x.to(torch.float64) * prescale).to(x.dtype)


def int_postscale(y, op, num_ranks, postscale):
    if op == ReduceOp.AVERAGE:
        return ((y.to(torch.float64) / num_ranks) * postscale).to(y.dtype)
    return (y.to(torch.float64) * postscale).to(y.dtype)


class MeshExecutor:
    """Executes collectives for one process set.

    ``device``: where the rows live.  ``group``: a ``ProcessGroup`` of
    ``num_ranks`` ranks in which this process hosts one rank, or None
    for stacked mode (this process hosts all ``num_ranks`` ranks)."""

    def __init__(self, device, num_ranks, group=None):
        self.device = torch.device(device)
        self.num_ranks = num_ranks
        self.group = group
        if group is not None and group.size() != num_ranks:
            raise ValueError(
                f"process group has {group.size()} ranks, executor "
                f"expects {num_ranks}")
        self.local_positions = [group.rank()] if group is not None \
            else list(range(num_ranks))

    @property
    def stacked(self):
        return self.group is None

    # -- the reduction itself ------------------------------------------------

    def reduce(self, rows, op: ReduceOp):
        """Unscaled reduction of the rows.  Stacked mode returns ONE
        tensor shared by every local rank (callers copy out of it);
        process-group mode reduces the row in place and returns it."""
        if op not in _DIST_OPS:
            raise ValueError(f"unsupported reduce op {op!r}")
        if self.stacked:
            x = torch.stack(rows)
            if op == ReduceOp.SUM:
                # dtype pinned: torch.sum promotes small ints to int64
                y = x.sum(0, dtype=x.dtype)
            elif op == ReduceOp.MIN:
                y = x.amin(0)
            elif op == ReduceOp.MAX:
                y = x.amax(0)
            else:
                y = x.prod(0, dtype=x.dtype)
            return [y] * len(rows)
        opts = dist.AllreduceOptions()
        opts.reduceOp = _DIST_OPS[op]
        self.group.allreduce([rows[0]], opts).wait()
        return [rows[0]]

    # -- allreduce -----------------------------------------------------------

    def allreduce(self, rows, op: ReduceOp, prescale=1.0, postscale=1.0):
        """rows: per-local-rank flat tensors of one shape.  Returns new
        per-local-rank result tensors: prescale, reduce, postscale, with
        a float Average as Sum and postscale/R (xla_ops.py:193-219)."""
        if rows[0].numel() == 0:
            return [r.clone() for r in rows]
        R = self.num_ranks
        red_op, post, scaled = allreduce_plan(op, rows[0].dtype, prescale,
                                              postscale, R)
        if is_float(rows[0].dtype):
            xs = [fused_scale_cast(r, prescale) for r in rows]
            return [fused_scale_cast(y, post)
                    for y in self.reduce(xs, red_op)]
        xs = [int_prescale(r, prescale) if scaled else r.clone()
              for r in rows]
        ys = self.reduce(xs, red_op)
        if scaled:
            return [int_postscale(y, op, R, postscale) for y in ys]
        return [ys[0]] + [y.clone() for y in ys[1:]]

    # -- quantized allreduce (int8 / int4 wire) ----------------------------

    def allreduce_quantized(self, q_rows, s_rows, op: ReduceOp,
                            prescale=1.0, postscale=1.0, nbits=8,
                            n_elems=None):
        """q_rows: per-local-rank codes (int8, or packed uint8 nibbles for
        ``nbits=4``); s_rows: per-local-rank f32 scales (nb,), each rank
        encoded with its own.  Decodes every rank's row (kernels B3/B5),
        sums them in f32 in rank order and multiplies by
        ``prescale * postscale`` (/R for Average), as
        ``xla_ops.py:455-516`` does.  Returns per-local-rank f32 results
        of ``n_elems`` elements (default: the whole code array).

        Stacked mode decodes the local rows (one result tensor shared by
        every local rank).  Process-group mode all-gathers the codes and
        the scales, then decodes all R rows.  The scales travel as the
        bytes of their bf16 values: they are bf16-rounded, so that is
        exact, the wire bytes are the codec's (codes + 2 per block), and
        uint8 is a type every backend gathers (gloo refuses int16, NCCL
        has no int16)."""
        post = float(prescale) * float(postscale)
        if op == ReduceOp.AVERAGE:
            post /= self.num_ranks
        elif op != ReduceOp.SUM:
            raise ValueError(
                f"quantized wire supports Sum/Average allreduce, got {op!r}")
        nb = s_rows[0].numel()
        n = int(n_elems) if n_elems is not None else nb * qz.BLOCK
        if self.stacked:
            qs, ss = q_rows, s_rows
        else:
            R = self.num_ranks
            qs = [torch.empty_like(q_rows[0]) for _ in range(R)]
            self.group.allgather([qs], [q_rows[0]]).wait()
            sb = s_rows[0].to(torch.bfloat16).view(torch.uint8)
            sbs = [torch.empty_like(sb) for _ in range(R)]
            self.group.allgather([sbs], [sb]).wait()
            ss = [b.view(torch.bfloat16).float() for b in sbs]
        y = None
        for q, s in zip(qs, ss):
            d = qk.decode(q, s, n, nbits)
            y = d if y is None else y.add_(d)
        if post != 1.0:
            y.mul_(post)
        return [y] * len(q_rows)

    # -- allgather -----------------------------------------------------------

    def allgather(self, rows, dim0_sizes, rest_shape):
        """Concatenate per-rank tensors along dim 0.  ``rows`` are the
        per-local-rank buffers padded and flattened to
        ``max(dim0_sizes) * prod(rest_shape)``; ``dim0_sizes`` are ALL
        ranks' true first dims."""
        rest = 1
        for d in rest_shape:
            rest *= int(d)
        shape = (sum(dim0_sizes),) + tuple(rest_shape)
        if max(dim0_sizes, default=0) == 0 or rest == 0:
            return [torch.zeros(shape, dtype=rows[0].dtype,
                                device=self.device) for _ in rows]
        if self.stacked:
            parts = rows
        else:
            parts = [torch.empty_like(rows[0]) for _ in range(self.num_ranks)]
            self.group.allgather([parts], [rows[0]]).wait()
        out = torch.cat([parts[r][: dim0_sizes[r] * rest]
                         for r in range(self.num_ranks)]).view(shape)
        return [out] + [out.clone() for _ in rows[1:]]

    # -- broadcast -----------------------------------------------------------

    def broadcast(self, rows, root_pos):
        if self.stacked:
            return [rows[root_pos].clone() for _ in rows]
        opts = dist.BroadcastOptions()
        opts.rootRank = int(root_pos)
        self.group.broadcast([rows[0]], opts).wait()
        return [rows[0]]
