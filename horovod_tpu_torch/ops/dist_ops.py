"""Collective executor over ``torch.distributed`` (port of
``horovod_tpu/ops/xla_ops.py::MeshExecutor``).

Three layouts, as the reference has (``xla_ops.py:94-107``):

* **stacked** (``group=None``): every rank of the set lives in this
  process on one device (rank threads sharing a card, or the CPU).  The
  per-rank rows are stacked and reduced with plain tensor ops, as the
  JAX package's ``reduce_stacked`` does outside any kernel.
* **process group, one rank a process**: a ``torch.distributed``
  ``ProcessGroup`` -- NCCL for CUDA tensors, gloo for CPU ones, or gloo
  for CUDA tensors when the job asks for it
  (``HOROVOD_GPU_OPERATIONS=gloo``: two processes on one card).  The
  executor calls the group object's own collectives, so a group built
  directly (``ProcessGroupGloo(store, rank, size)``) works as well as the
  default one.  Gloo takes CUDA tensors for every collective the
  executor calls (:data:`GLOO_CUDA_COLLECTIVES`), copying them through
  host memory itself.
* **hybrid** (a group and ``proc_positions``): each process of the group
  hosts a contiguous run of the set's positions as rank threads.  The
  local rows are stacked inside the process first, then one group
  collective runs across the processes, over gloo and NCCL alike.  The
  global rank order is kept: the processes' runs follow the group's
  rank order.  A float sum is then ``(r0 + r1) + (r2 + r3)`` at 2 x 2
  where the stacked executor sums the four rows in one reduction, so
  the two agree to rounding, and exactly on integers and on values whose
  sums are exact in the dtype.

Row convention: every method takes ``rows``, one flat tensor per rank
this process hosts (ordered by global rank), and returns one result
per such rank.

:meth:`MeshExecutor.allreduce_2d` is the hierarchical/torus
decomposition over an ``(R // inner, inner)`` grid of the set's
positions, in each layout: stacked tensor sums; one rank a process over
the grid rows' and columns' groups (:meth:`~MeshExecutor.set_groups_2d`);
hybrid with one grid row a process, its inner hops inside the process.
"""

import math
import time

import torch
import torch.distributed as dist

from ..core.message import ReduceOp
from . import quantize as qz
from .adasum import adasum_reduce
from . import quantize_kernels as qk
from .cuda_kernels import FLOAT_DTYPES, cast, fused_scale_cast

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


def _stack_reduce(x, op):
    """Reduction of a stacked ``x`` over its first dimension."""
    if op == ReduceOp.SUM:
        # dtype pinned: torch.sum promotes small ints to int64
        return x.sum(0, dtype=x.dtype)
    if op == ReduceOp.MIN:
        return x.amin(0)
    if op == ReduceOp.MAX:
        return x.amax(0)
    return x.prod(0, dtype=x.dtype)


class MeshExecutor:
    """Executes collectives for one process set.

    ``device``: where the rows live.  ``group``: a ``ProcessGroup`` over
    the processes hosting the set's ``num_ranks`` ranks, or None for
    stacked mode (this process hosts all of them).  ``proc_positions``:
    per group rank, the set positions that process hosts, a contiguous
    ascending run each (default: one position a process, the group
    rank's own)."""

    def __init__(self, device, num_ranks, group=None, proc_positions=None):
        self.device = torch.device(device)
        self.num_ranks = num_ranks
        self.group = group
        #: host-clock seconds inside the group's collectives (waiting for
        #: the peers included; an NCCL call returns once enqueued), and
        #: the collectives issued (a captured graph's replays issue none)
        self.collective_seconds = 0.0
        self.collectives = 0
        #: inner-axis size -> (this process's inner-axis group, its
        #: outer-axis group) of the 2-D decompositions, one rank a process
        #: (:meth:`set_groups_2d`)
        self._groups_2d = {}
        if group is None:
            self.proc_positions = [list(range(num_ranks))]
            self.local_positions = list(range(num_ranks))
            return
        if proc_positions is None:
            proc_positions = [[g] for g in range(group.size())]
        self.proc_positions = [list(p) for p in proc_positions]
        flat = [q for p in self.proc_positions for q in p]
        if group.size() != len(self.proc_positions) \
                or flat != list(range(num_ranks)) \
                or any(not p for p in self.proc_positions):
            raise ValueError(
                f"process group of {group.size()} processes cannot host "
                f"positions {self.proc_positions} of a set of {num_ranks} "
                f"ranks (a contiguous ascending run a process, in group "
                f"rank order)")
        self.local_positions = self.proc_positions[group.rank()]
        self._counts = [len(p) for p in self.proc_positions]

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
            self.collectives += 1

    def _gather_local(self, local):
        """Every position's row, in position order, as one ``(R, ...)``
        tensor: the processes' stacked local rows ``local`` (``(L,
        ...)``) allgathered over the group.  Uneven runs are padded to
        the longest for the gather and cut back after it."""
        G, L = len(self._counts), max(self._counts)
        rest = tuple(local.shape[1:])
        if local.shape[0] < L:
            local = torch.cat([local, local.new_zeros(
                (L - local.shape[0],) + rest)])
        out = torch.empty((G, L) + rest, dtype=local.dtype,
                          device=local.device)
        self._collective(lambda: self.group.allgather(
            [list(out.unbind(0))], [local]))
        if min(self._counts) == L:
            return out.view((G * L,) + rest)
        return torch.cat([out[g, :n] for g, n in enumerate(self._counts)])

    # -- the reduction itself ------------------------------------------------

    def reduce(self, rows, op: ReduceOp):
        """Unscaled reduction of the rows.  Returns ONE tensor shared by
        every local rank (callers copy out of it): stacked mode reduces
        the stacked rows; over a process group the local rows are reduced
        in the process first (a single row is reduced in place), then
        across the processes.  Adasum gathers every rank's row and reduces
        the stack (xla_ops.py:248-250, 272-273): its pairwise tree is not a
        sum the processes could pre-reduce.  The gathered rows are in rank
        order because each process hosts a contiguous run of positions in
        group rank order (checked at construction)."""
        if op == ReduceOp.ADASUM:
            return [adasum_reduce(self.gather_tiles(rows))] * len(rows)
        if op not in _DIST_OPS:
            raise ValueError(f"unsupported reduce op {op!r}")
        if self.stacked:
            return [_stack_reduce(torch.stack(rows), op)] * len(rows)
        y = rows[0] if len(rows) == 1 else \
            _stack_reduce(torch.stack(rows), op)
        self.reduce_across(y, op)
        return [y] * len(rows)

    def reduce_across(self, t, op=ReduceOp.SUM):
        """Reduce one process-level tensor ``t`` in place across the
        group's processes (the compiled step's flat buffers, which sum
        the local ranks first); the identity when stacked."""
        if self.stacked:
            return t
        opts = dist.AllreduceOptions()
        opts.reduceOp = _DIST_OPS[op]
        self._collective(lambda: self.group.allreduce([t], opts))
        return t

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

    # -- 2-D decomposed allreduce (hierarchical / torus) --------------------

    def set_groups_2d(self, inner, inner_group, outer_group):
        """The process groups of an ``(R // inner, inner)`` grid this
        process is a member of, one rank a process: the group of its grid
        row (the inner axis) and of its grid column (the outer axis).
        ``dist.new_group`` is collective over the whole job, so the engine
        builds every row's and column's group on every process when it
        creates the set."""
        self._groups_2d[int(inner)] = (inner_group, outer_group)

    def _layout_2d(self, inner):
        """How the three stages run on an ``(R // inner, inner)`` grid of
        positions ``p = y * inner + x`` (row-major, as the JAX package's
        ``mesh2d``): 'stacked' (every row in this process), 'process' (one
        position a process, the stages over the row's and the column's
        groups) or 'hybrid' (each process hosts exactly one grid row: the
        inner stages stay in the process, the outer one crosses the set's
        group).  Any other layout raises: a decomposition never falls
        back silently."""
        R = self.num_ranks
        if inner <= 1 or R % inner or inner == R:
            raise ValueError(f"inner axis {inner} does not factor "
                             f"{R} ranks into a 2-D grid")
        if self.stacked:
            return "stacked"
        if all(len(p) == 1 for p in self.proc_positions):
            if inner not in self._groups_2d:
                raise ValueError(
                    f"no process groups for an inner axis of {inner} ranks "
                    f"(the set's grids: {sorted(self._groups_2d)}); they "
                    f"are built with the set, for the inner axes its "
                    f"topology plans")
            return "process"
        if all(len(p) == inner and p[0] % inner == 0
               for p in self.proc_positions):
            return "hybrid"
        raise ValueError(
            f"a 2-D decomposition with an inner axis of {inner} ranks needs "
            f"one rank a process or one grid row a process; the processes "
            f"host positions {self.proc_positions}")

    def _group_allreduce(self, group, t, op):
        opts = dist.AllreduceOptions()
        opts.reduceOp = _DIST_OPS[op]
        self._collective(lambda: group.allreduce([t], opts))
        return t

    def allreduce_2d(self, rows, op: ReduceOp, prescale=1.0, postscale=1.0,
                     inner=1, inner_wire=None, outer_wire=None,
                     residual=None):
        """Two-stage decomposed allreduce with a per-hop wire pair
        (``xla_ops.py:342-445``): a reducescatter over the inner (fast)
        axis, an allreduce of the 1/inner shard over the outer (slow)
        axis, an allgather back over the inner axis.  ``rows``: flat
        float tensors of one length, one per local rank.  ``inner_wire``
        (None, 'fp16', 'bf16', resolved by the caller) narrows both inner
        hops; ``outer_wire`` is the outer hop's: None (full width),
        'fp16'/'bf16', or 'int8'/'int4' (the shared-scale integer sum,
        :func:`quantize.quantized_psum_ef`).  The pre-scale applies
        before the inner cast, the post-scale (/R for Average) to the
        reduced shard before the gather-back cast, both through the
        scale/cast kernel B1.  The row is padded to a multiple of
        ``inner`` and cut back.  ``residual`` (quantized outer only): the
        local ranks' ``(L, m)`` f32 error-feedback residuals of their
        shards (``m = ceil(n / inner)``), added before the encode and
        replaced in place by the new ones.  Returns ONE result tensor
        shared by every local rank (callers copy out of it)."""
        n = rows[0].numel()
        dtype = rows[0].dtype
        if n == 0:
            return [r.clone() for r in rows]
        R = self.num_ranks
        if op == ReduceOp.AVERAGE:
            postscale = postscale / R
            op = ReduceOp.SUM
        if op != ReduceOp.SUM:
            raise ValueError(
                f"2-D decompositions support Sum/Average, got {op!r}")
        mode = self._layout_2d(inner)
        outer = R // inner
        npad = -(-n // inner) * inner
        m = npad // inner
        x = torch.stack(rows)
        if npad != n:
            x = torch.nn.functional.pad(x, (0, npad - n))
        if prescale != 1.0:
            x = fused_scale_cast(x, prescale)
        iw = qz.WIRE_TORCH_DTYPES.get(inner_wire)
        if iw is not None:
            x = cast(cast(x, torch.float32), iw)
        # stage 1 (inner): reducescatter into the 1/inner shards, held as
        # (grid rows here, shards a row here, m)
        if mode == "process":
            inner_g, outer_g = self._groups_2d[inner]
            s = torch.empty((1, 1, m), dtype=x.dtype, device=x.device)
            opts = dist.ReduceScatterOptions()
            opts.reduceOp = dist.ReduceOp.SUM
            self._collective(lambda: inner_g.reduce_scatter(
                [s.view(m)], [list(x.view(inner, m).unbind(0))], opts))
        else:
            rows_here = outer if mode == "stacked" else 1
            s = x.view(rows_here, inner, inner, m).sum(1, dtype=x.dtype)
            outer_g = self.group

        # stage 2 (outer): the shard's sum over the grid rows
        def osum(t):
            if mode == "stacked":
                return t.sum(0, keepdim=True, dtype=t.dtype)
            return self._group_allreduce(outer_g, t, ReduceOp.SUM)

        def omax(t):
            if mode == "stacked":
                return t.amax(0, keepdim=True)
            return self._group_allreduce(outer_g, t, ReduceOp.MAX)

        if outer_wire in ("int8", "int4"):
            sf = s.float()
            if residual is not None:
                sf = sf + residual.view(sf.shape)
            y, res = qz.quantized_psum_ef(
                sf, 8 if outer_wire == "int8" else 4, outer, omax, osum)
            if residual is not None:
                residual.copy_(res.view(residual.shape))
        elif outer_wire in qz.WIRE_TORCH_DTYPES:
            y = osum(cast(s.float(), qz.WIRE_TORCH_DTYPES[outer_wire]))
        else:
            # a 16-bit inner hop narrows that hop only: the outer sum
            # runs at the tensor's width
            y = osum(cast(s, dtype) if iw is not None else s)
        if dtype == torch.float64:
            y = y.to(dtype)
        y = fused_scale_cast(y, postscale, dtype) \
            if postscale != 1.0 else cast(y, dtype)
        if iw is not None:
            y = cast(cast(y, torch.float32), iw)
        # stage 3 (inner): the reduced shards gathered back
        if mode == "process":
            full = torch.empty((inner, m), dtype=y.dtype, device=y.device)
            self._collective(lambda: inner_g.allgather(
                [list(full.unbind(0))], [y.reshape(m)]))
        else:
            full = y
        full = cast(full.reshape(npad)[:n], dtype)
        return [full] * len(rows)

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

    def reduce_tiles(self, rows, op, m):
        """Unscaled reducescatter of rows laid out as R tiles of ``m``:
        per local rank position ``pos``, the reduction over ranks of
        tile ``pos``.  Stacked mode reduces every tile at once (the
        results are views of one tensor).  Over a process group the local
        rows are reduced in the process, then the group's
        ``reduce_scatter`` (NCCL's on the card; gloo has it for every op
        and dtype on the CPU) hands each process its run of tiles; with
        uneven runs an allreduce of every tile does, and each process
        keeps its own."""
        R = self.num_ranks
        if self.stacked:
            y = _stack_reduce(torch.stack(rows).view(R, R, m), op)
            return [y[pos] for pos in self.local_positions]
        x = rows[0] if len(rows) == 1 else \
            _stack_reduce(torch.stack(rows), op)
        L = len(self.local_positions)
        if min(self._counts) != max(self._counts):
            self.reduce_across(x, op)
            return [x.view(R, m)[pos] for pos in self.local_positions]
        G = len(self._counts)
        out = torch.empty(L * m, dtype=x.dtype, device=x.device)
        opts = dist.ReduceScatterOptions()
        opts.reduceOp = _DIST_OPS[op]
        self._collective(lambda: self.group.reduce_scatter(
            [out], [list(x.view(G, L * m).unbind(0))], opts))
        return list(out.view(L, m).unbind(0))

    def gather_tiles(self, rows):
        """Every rank's tile ``rows[i]`` (one flat tensor of ``m``
        elements per local rank) as one ``(R, m)`` tensor, rank order:
        the stacked rows, or the group's ``allgather`` of each process's
        stacked rows into the rows of a new tensor."""
        if self.stacked:
            return torch.stack(rows)
        return self._gather_local(torch.stack(rows))

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
        for tile, pos, shape in zip(self.reduce_tiles(xs, red_op, m),
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
        qs = list(self._gather_local(torch.stack(q_rows)).unbind(0))
        sb = torch.stack([s.to(torch.bfloat16).view(torch.uint8)
                          for s in s_rows])
        sbs = self._gather_local(sb).unbind(0)
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
        parts = rows if self.stacked else \
            self._gather_local(torch.stack(rows)).unbind(0)
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
        the exact split sizes, each process's local sources' segments
        sent together."""
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
        return self._alltoall_across(rows, splits, rest, rest_shape,
                                     dtype), recv_local

    def _alltoall_across(self, rows, splits, rest, rest_shape, dtype):
        """The exchange over the process group, one rank thread a
        process or several: one ``alltoall_base`` between the processes.
        To each process this one sends, for each of its destination
        positions in order, the segment from each local source in order;
        each destination's received segments are then its sources' in
        position order."""
        mine = self.local_positions
        R = self.num_ranks
        starts = [[sum(int(v) for v in splits[s][:d]) * rest
                   for d in range(R)] for s in range(R)]
        flat = [r.reshape(-1) for r in rows]
        parts, send_counts = [], []
        for dests in self.proc_positions:
            n_h = 0
            for d in dests:
                for i, s in enumerate(mine):
                    n = int(splits[s][d]) * rest
                    parts.append(flat[i][starts[s][d]:starts[s][d] + n])
                    n_h += n
            send_counts.append(n_h)
        recv_counts = [sum(int(splits[s][d]) * rest for d in mine
                           for s in srcs) for srcs in self.proc_positions]
        send = torch.cat(parts) if parts else \
            torch.zeros(0, dtype=dtype, device=self.device)
        out = torch.empty(sum(recv_counts), dtype=dtype, device=self.device)
        self._collective(lambda: self.group.alltoall_base(
            out, send, recv_counts, send_counts, dist.AllToAllOptions()))
        per_dest = {d: [] for d in mine}
        off = 0
        for srcs in self.proc_positions:
            for d in mine:
                for s in srcs:
                    n = int(splits[s][d]) * rest
                    per_dest[d].append(out[off:off + n])
                    off += n
        return [torch.cat(per_dest[d]).view((-1,) + tuple(rest_shape))
                for d in mine]

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
        """Every local rank's copy of the root position's row, each in
        memory of its own: the rows given are never written or returned
        (a non-in-place ``hvd.broadcast`` hands the caller's own tensor
        in as a row)."""
        if self.stacked:
            return [rows[root_pos].clone() for _ in rows]
        mine = self.local_positions
        root_proc = next(g for g, p in enumerate(self.proc_positions)
                         if root_pos in p)
        buf = rows[mine.index(root_pos)].clone() if root_pos in mine \
            else torch.empty_like(rows[0])
        opts = dist.BroadcastOptions()
        opts.rootRank = int(root_proc)
        self._collective(lambda: self.group.broadcast([buf], opts))
        return [buf] + [buf.clone() for _ in rows[1:]]
