"""Collective executor over ``torch.distributed`` (port of
``horovod_tpu/ops/xla_ops.py::MeshExecutor``).

Two modes, as the reference has (``xla_ops.py:94-107``):

* **stacked** (``group=None``): every rank of the set lives in this
  process on one device (rank threads sharing a card, or the CPU).  The
  per-rank rows are stacked and reduced with plain tensor ops, as the
  JAX package's ``reduce_stacked`` does outside any kernel.
* **process group**: one rank per process (or per thread, in the CPU
  tests) over a ``torch.distributed`` ``ProcessGroup`` -- NCCL for CUDA
  tensors, gloo for CPU ones, or gloo for CUDA tensors when the job asks
  for it (``HOROVOD_GPU_OPERATIONS=gloo``: two processes on one card).
  The executor calls the group object's own collectives, so a group
  built directly (``ProcessGroupGloo(store, rank, size)``) works as well
  as the default one.  Gloo takes CUDA tensors for every collective the
  executor calls (:data:`GLOO_CUDA_COLLECTIVES`), copying them through
  host memory itself.

Row convention: every method takes ``rows``, one flat tensor per rank
this process hosts (ordered by global rank), and returns one result
per such rank.
"""

import math
import time

import torch
import torch.distributed as dist

from ..core.message import ReduceOp
from . import quantize as qz
from . import quantize_kernels as qk
from .cuda_kernels import FLOAT_DTYPES, fused_scale_cast

#: the collectives the executor calls, all of which torch's gloo backend
#: runs on CUDA tensors (torch 2.11 on the H100); chip_smoke.py phase 16
#: and tests/test_torch_cuda_multiprocess.py check it on the card's torch
GLOO_CUDA_COLLECTIVES = frozenset(
    {"allreduce", "broadcast", "allgather", "alltoall_base",
     "reduce_scatter"})

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
        #: host-clock seconds inside the group's collectives (waiting for
        #: the peers included; an NCCL call returns once enqueued)
        self.collective_seconds = 0.0
        if group is not None and group.size() != num_ranks:
            raise ValueError(
                f"process group has {group.size()} ranks, executor "
                f"expects {num_ranks}")
        self.local_positions = [group.rank()] if group is not None \
            else list(range(num_ranks))

    @property
    def stacked(self):
        return self.group is None

    def _collective(self, work):
        """Wait for the group's collective ``work`` (the call that
        issued it is the argument: it runs inside the clock)."""
        t0 = time.perf_counter()
        try:
            work().wait()
        finally:
            self.collective_seconds += time.perf_counter() - t0

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
        self._collective(lambda: self.group.allreduce([rows[0]], opts))
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
        qs, ss = self._gathered_codes(q_rows, s_rows)
        y = None
        for q, s in zip(qs, ss):
            d = qk.decode(q, s, n, nbits)
            y = d if y is None else y.add_(d)
        if post != 1.0:
            y.mul_(post)
        return [y] * len(q_rows)

    # -- reducescatter -------------------------------------------------------

    @staticmethod
    def chunk_sizes(d0, num_ranks):
        """Uneven reducescatter chunking: as even as possible, larger
        chunks on lower ranks.  THE rule lives in ``core/sharded.py``: the
        shard planner slices by it, so one definition keeps the plan and
        the scatter from drifting."""
        from ..core.sharded import chunk_sizes
        return chunk_sizes(d0, num_ranks)

    def _scatter_layout(self, d0, rest_shape):
        """(chunks, m = max_chunk * rest, rest) of a reducescatter of
        ``d0`` rows of ``rest_shape``."""
        chunks = self.chunk_sizes(d0, self.num_ranks)
        rest = math.prod(int(d) for d in rest_shape)
        return chunks, max(chunks, default=0) * rest, rest

    def _reduce_tiles(self, rows, op, m):
        """Unscaled reducescatter of rows laid out as R tiles of ``m``:
        per local rank position ``pos``, the reduction over ranks of
        tile ``pos``.  Stacked mode reduces every tile at once (the
        results are views of one tensor); process-group mode runs the
        group's ``reduce_scatter`` (NCCL's on the card; gloo has it for
        every op and dtype on the CPU) into a new tile."""
        R = self.num_ranks
        if self.stacked:
            x = torch.stack(rows).view(R, R, m)
            if op == ReduceOp.SUM:
                y = x.sum(0, dtype=x.dtype)
            elif op == ReduceOp.MIN:
                y = x.amin(0)
            elif op == ReduceOp.MAX:
                y = x.amax(0)
            else:
                y = x.prod(0, dtype=x.dtype)
            return [y[pos] for pos in self.local_positions]
        out = torch.empty(m, dtype=rows[0].dtype, device=rows[0].device)
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _DIST_OPS[op]
        self._collective(lambda: self.group.reduce_scatter(
            [out], [list(rows[0].view(R, m).unbind(0))], opts))
        return [out]

    def reducescatter(self, rows, d0, rest_shape, op: ReduceOp,
                      prescale=1.0, postscale=1.0):
        """rows: per-local-rank buffers in the padded layout
        ``(R * max_chunk * rest,)``, destination rank j's rows at
        ``[j * max_chunk * rest, ...)`` (xla_ops.py:828-939).  Returns
        per-local-rank tensors ``(chunk_j, *rest)``, each in its own
        memory (unscaled stacked results are views of one tensor):
        prescale, reduce, postscale, a float Average as Sum with
        postscale/R, integer scaling as in :meth:`allreduce`.  Float
        scaling is the scale/cast kernel's (a factor of 1 is skipped: it
        is the identity)."""
        if op not in _DIST_OPS and op != ReduceOp.AVERAGE:
            raise ValueError(f"unsupported reducescatter op {op!r}")
        R = self.num_ranks
        dtype = rows[0].dtype
        chunks, m, rest = self._scatter_layout(d0, rest_shape)
        shapes = [(chunks[pos],) + tuple(rest_shape)
                  for pos in self.local_positions]
        if m == 0:
            return [torch.zeros(s, dtype=dtype, device=self.device)
                    for s in shapes]
        red_op, post, scaled = allreduce_plan(op, dtype, prescale,
                                              postscale, R)
        if is_float(dtype):
            xs = rows if prescale == 1.0 else \
                [fused_scale_cast(r, prescale) for r in rows]
        else:
            xs = [int_prescale(r, prescale) for r in rows] if scaled \
                else rows
        out = []
        for tile, pos, shape in zip(self._reduce_tiles(xs, red_op, m),
                                    self.local_positions, shapes):
            y = tile[:chunks[pos] * rest]
            if is_float(dtype) and post != 1.0:
                y = fused_scale_cast(y, post)
            elif not is_float(dtype) and scaled:
                y = int_postscale(y, op, R, postscale)
            out.append(y.view(shape))
        return out

    def reducescatter_quantized(self, q_rows, s_rows, d0, rest_shape,
                                op: ReduceOp, prescale=1.0, postscale=1.0,
                                nbits=8, n_elems=None):
        """Quantized :meth:`reducescatter` (xla_ops.py:518-582):
        ``q_rows``/``s_rows`` encode each rank's padded
        ``(R * max_chunk * rest,)`` row.  Decodes every rank's row
        (kernels B3/B5), sums the rows in f32 in rank order and multiplies
        by ``prescale * postscale`` (/R for Average).  Returns
        per-local-rank f32 ``(chunk_j, *rest)``.  Process-group mode
        gathers the codes and the bf16 scales as uint8 bytes, as
        :meth:`allreduce_quantized` does, and keeps its own tile."""
        post = float(prescale) * float(postscale)
        if op == ReduceOp.AVERAGE:
            post /= self.num_ranks
        elif op != ReduceOp.SUM:
            raise ValueError(
                f"quantized wire supports Sum/Average reducescatter, "
                f"got {op!r}")
        R = self.num_ranks
        chunks, m, rest = self._scatter_layout(d0, rest_shape)
        qs, ss = self._gathered_codes(q_rows, s_rows)
        y = None
        for q, s in zip(qs, ss):
            d = qk.decode(q, s, R * m, nbits).view(R, m)
            y = d if y is None else y.add_(d)
        if post != 1.0:
            y.mul_(post)
        return [y[pos][:chunks[pos] * rest].view(
                    (chunks[pos],) + tuple(rest_shape))
                for pos in self.local_positions]

    def _gathered_codes(self, q_rows, s_rows):
        """Every rank's codes and f32 scales: the local rows in stacked
        mode; in process-group mode gathered over the group, the scales
        as the bytes of their bf16 values (exact: they are bf16-rounded;
        the codec's 2 wire bytes a block; uint8 is a type every backend
        gathers, where gloo refuses int16 and NCCL has none)."""
        if self.stacked:
            return q_rows, s_rows
        R = self.num_ranks
        qs = [torch.empty_like(q_rows[0]) for _ in range(R)]
        self._collective(lambda: self.group.allgather([qs], [q_rows[0]]))
        sb = s_rows[0].to(torch.bfloat16).view(torch.uint8)
        sbs = [torch.empty_like(sb) for _ in range(R)]
        self._collective(lambda: self.group.allgather([sbs], [sb]))
        return qs, [b.view(torch.bfloat16).float() for b in sbs]

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
            self._collective(
                lambda: self.group.allgather([parts], [rows[0]]))
        out = torch.cat([parts[r][: dim0_sizes[r] * rest]
                         for r in range(self.num_ranks)]).view(shape)
        return [out] + [out.clone() for _ in rows[1:]]

    # -- alltoall ------------------------------------------------------------

    def alltoall(self, rows, splits, rest_shape=()):
        """``splits[r]`` is rank r's send-split vector (length R) over
        its first dimension, for ALL ranks of the set.  ``rows`` are the
        per-local-rank flat send buffers, destination j's segment of rank
        r at ``[sum(splits[r][:j]) * rest, ...)``.  Returns (per-local-rank
        received tensors ``(sum_j splits[j][r], *rest)``, the segments
        from each source in source order; per-local-rank received splits).

        Stacked mode is the permutation of the rows' segments by splits
        (xla_ops.py:658 pads every segment to the largest one for one
        static exchange; the values delivered are the same).  Process-group
        mode is the group's ``alltoall_base`` (``all_to_all_single``) with
        the exact split sizes."""
        R = self.num_ranks
        rest = math.prod(int(d) for d in rest_shape)
        recv = [[int(splits[j][r]) for j in range(R)] for r in range(R)]
        recv_local = [recv[pos] for pos in self.local_positions]
        dtype = rows[0].dtype if rows else torch.float32
        if self.stacked:
            starts = []
            for r in range(R):
                acc, st = 0, []
                for j in range(R):
                    st.append(acc * rest)
                    acc += int(splits[r][j])
                starts.append(st)
            out = []
            for pos in self.local_positions:
                segs = [rows[src].reshape(-1)[
                    starts[src][pos]:starts[src][pos]
                    + int(splits[src][pos]) * rest] for src in range(R)]
                y = torch.cat(segs) if segs else \
                    torch.zeros(0, dtype=dtype, device=self.device)
                out.append(y.view((-1,) + tuple(rest_shape)))
            return out, recv_local
        pos = self.local_positions[0]
        send = rows[0].reshape(-1)
        out = torch.empty(sum(recv[pos]) * rest, dtype=dtype,
                          device=send.device)
        self._collective(lambda: self.group.alltoall_base(
            out, send, [n * rest for n in recv[pos]],
            [int(s) * rest for s in splits[pos]], dist.AllToAllOptions()))
        return [out.view((-1,) + tuple(rest_shape))], recv_local

    def alltoall_codes(self, q_rows, s_rows):
        """Equal-slot exchange of a quantized wire (engine.py:2786-2789):
        ``q_rows``/``s_rows`` are per-local-rank codes and f32 scales laid
        out as R equal destination slots.  Returns the received codes and
        f32 scales per local rank, each the R source slots in source
        order.  Process-group mode ships the scales as the bytes of their
        bf16 values, as :meth:`_gathered_codes` does."""
        R = self.num_ranks
        q_seg = q_rows[0].numel() // R
        eq_q = [[q_seg] * R for _ in range(R)]
        q_res, _ = self.alltoall(q_rows, eq_q)
        if self.stacked:
            s_seg = s_rows[0].numel() // R
            s_res, _ = self.alltoall(s_rows, [[s_seg] * R for _ in range(R)])
            return q_res, s_res
        sb = [s.to(torch.bfloat16).view(torch.uint8) for s in s_rows]
        b_seg = sb[0].numel() // R
        b_res, _ = self.alltoall(sb, [[b_seg] * R for _ in range(R)])
        return q_res, [b.view(torch.bfloat16).float() for b in b_res]

    # -- broadcast -----------------------------------------------------------

    def broadcast(self, rows, root_pos):
        if self.stacked:
            return [rows[root_pos].clone() for _ in rows]
        opts = dist.BroadcastOptions()
        opts.rootRank = int(root_pos)
        self._collective(lambda: self.group.broadcast([rows[0]], opts))
        return [rows[0]]
