"""ZeRO-grade weight-update sharding, the engine-path core (port of
``horovod_tpu/core/sharded.py``).

Each rank reducescatters the gradients, updates only its 1/dp shard of
the parameters and optimizer state, and allgathers the updated
parameters back (arXiv:1909.09756): the optimizer state shrinks by dp.

* :class:`ShardPlan`, the deterministic shard layout.  Parameters pack
  into contiguous flat buckets (runs of one (dtype, param-group) under
  the fusion threshold), and each bucket splits across ranks by
  :func:`chunk_sizes`, the executor's reducescatter rule, so the
  reducescatter's output IS the shard.  Buckets, chunks, offsets and the
  layout fingerprint are the JAX package's for the same specs; the
  fingerprint rides every collective as ``Request.shard_fp`` and a
  cross-rank mismatch fails loudly.
* :class:`ShardedUpdater`, the wire: gradients go out as a grouped
  reducescatter (with error feedback on the int8/int4 wires), and the
  updated parameter shards come back by a grouped allgather over the same
  wire with their own error-feedback state.  The master shard stays full
  width on its owner; every rank, owner included, installs the decoded
  value, so ranks stay bit-identical.

The port works on device tensors: ``pack``/``unpack`` are one launch each
of the scale/cast kernel (``ops/cuda_kernels.py``, B1) per bucket, and
the error feedback encodes and decodes with the codec kernels
(``ops/quantize_kernels.py``, B2-B5), as the dense optimizer's does.  On
the CPU the same functions take the kernels' plain versions.
"""

import hashlib
import json
import math
import threading

import torch

from .. import telemetry
from ..common import basics
from ..ops import api
from ..ops import cuda_kernels
from ..ops import quantize as qz
from ..ops import quantize_kernels

SHARD_LAYOUT_CHOICES = ("bucket", "flat")


def normalize_shard_layout(layout):
    """'bucket' (default: shard boundaries from fusion buckets) | 'flat'
    (one bucket per (dtype, group): fewest, largest collectives)."""
    if layout is None or layout == "":
        return "bucket"
    layout = str(layout).strip().lower()
    if layout not in SHARD_LAYOUT_CHOICES:
        raise ValueError(
            f"shard layout must be one of {SHARD_LAYOUT_CHOICES}, "
            f"got {layout!r}")
    return layout


def compression_wire(compression):
    """Wire format a compression marker or compressor asks for: the
    quantized markers carry ``wire`` ('int8'/'int4'), the fp16/bf16 cast
    compressors carry ``wire_dtype`` (a torch dtype).  Under sharded mode
    the cast happens on the collective wire itself."""
    w = getattr(compression, "wire", None)
    if w:
        return w
    wd = getattr(compression, "wire_dtype", None)
    if wd is None:
        return None
    name = str(wd)
    if "bfloat16" in name:
        return "bf16"
    if "float16" in name:
        return "fp16"
    return None


def chunk_sizes(n, dp):
    """THE uneven split rule: as even as possible, larger chunks on lower
    ranks (reference ReducescatterOp::ComputeOutputShapeForRank).  The
    executor's reducescatter delegates here, so the shard plan cannot
    drift from what the scatter returns."""
    base = n // dp
    extra = n % dp
    return [base + (1 if r < extra else 0) for r in range(dp)]


def overlap_bucket_splits(sizes, itemsize, bucket_bytes, align=1):
    """THE bucketization rule of bucket-granular overlap (the compiled
    reducer delegates here).  Splits ``sizes`` (per-member element
    counts, plan order) into contiguous ``(start, stop)`` member-index
    runs; a run closes at the first member where its payload reaches
    ``bucket_bytes`` AND the element count from member 0 is a multiple of
    ``align`` (the quantization block, so that every bucket boundary
    falls on the grouped buffer's block grid).  ``bucket_bytes`` <= 0 (or
    None) means one bucket."""
    n = len(sizes)
    if not n:
        return []
    if bucket_bytes is None or bucket_bytes <= 0:
        return [(0, n)]
    splits = []
    start, run_elems, total_elems = 0, 0, 0
    for i, sz in enumerate(sizes):
        run_elems += int(sz)
        total_elems += int(sz)
        full = run_elems * itemsize >= bucket_bytes
        aligned = align <= 1 or total_elems % align == 0
        if i == n - 1 or (full and aligned):
            splits.append((start, i + 1))
            start, run_elems = i + 1, 0
    return splits


def overlap_segment_bounds(n, itemsize, bucket_bytes, unit=1):
    """Within-buffer companion of :func:`overlap_bucket_splits`: one flat
    buffer of ``n`` elements as contiguous ``(start, stop)`` segments of
    at most ~``bucket_bytes`` each, every length a multiple of ``unit``
    (``n`` itself must be one).  ``bucket_bytes`` <= 0 means no split."""
    if n <= 0:
        return []
    if bucket_bytes is None or bucket_bytes <= 0:
        return [(0, n)]
    seglen = max(unit, (bucket_bytes // itemsize) // unit * unit)
    return [(s, min(s + seglen, n)) for s in range(0, n, seglen)]


def torch_dtype(name):
    """The torch dtype of a negotiation dtype string ('float32',
    'bfloat16', ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"unknown dtype {name!r}")
    return dt


class ShardBucket:
    """One contiguous flat buffer: members laid out back to back, the dp
    split at ``chunks`` boundaries."""

    __slots__ = ("index", "dtype", "group", "members", "n", "chunks",
                 "rank_offsets")

    def __init__(self, index, dtype, group, members, dp):
        self.index = index
        self.dtype = dtype          # dtype string, e.g. 'float32'
        self.group = group          # frontend param-group index
        #: [(key, size, shape)] in pack order
        self.members = members
        self.n = sum(m[1] for m in members)
        self.chunks = chunk_sizes(self.n, dp)
        self.rank_offsets = [sum(self.chunks[:pos]) for pos in range(dp)]

    def shard_slice(self, pos):
        """[start, end) of rank-position ``pos``'s shard in the bucket."""
        start = self.rank_offsets[pos]
        return start, start + self.chunks[pos]


class ShardPlan:
    """Deterministic shard layout over an ordered parameter list.

    ``specs`` is ``[(key, shape, dtype_str, group_index)]`` in the
    frontend's canonical order (param_groups order).  Buckets close when
    the (dtype, group) signature changes or the running size crosses
    ``threshold_bytes`` ('bucket' layout); 'flat' packs each (dtype,
    group) run into one bucket."""

    def __init__(self, specs, dp, threshold_bytes, layout="bucket"):
        if dp < 1:
            raise ValueError(f"dp must be >= 1, got {dp}")
        self.dp = int(dp)
        self.layout = normalize_shard_layout(layout)
        self.threshold_bytes = int(threshold_bytes)
        self.buckets = []
        cur, cur_sig, cur_bytes = [], None, 0
        for key, shape, dtype, group in specs:
            size = math.prod(int(d) for d in shape)
            nbytes = size * torch_dtype(dtype).itemsize
            sig = (dtype, group)
            closes = cur and (
                sig != cur_sig
                or (self.layout == "bucket"
                    and cur_bytes + nbytes > self.threshold_bytes))
            if closes:
                self.buckets.append(ShardBucket(
                    len(self.buckets), cur_sig[0], cur_sig[1], cur, self.dp))
                cur, cur_bytes = [], 0
            cur.append((key, size, tuple(int(d) for d in shape)))
            cur_bytes += nbytes
            cur_sig = sig
        if cur:
            self.buckets.append(ShardBucket(
                len(self.buckets), cur_sig[0], cur_sig[1], cur, self.dp))
        self.total_elems = sum(b.n for b in self.buckets)

    def fingerprint(self):
        """Stable layout identity, the JAX package's string byte for
        byte: every rank derives it from its own spec list; it rides each
        collective as ``shard_fp`` and the engine rejects a cross-rank
        mismatch before anything executes."""
        doc = [self.layout, self.dp,
               [[b.dtype, b.group,
                 [[k, s, list(shp)] for k, s, shp in b.members]]
                for b in self.buckets]]
        return hashlib.md5(
            json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]

    def local_elems(self, pos):
        return sum(b.chunks[pos] for b in self.buckets)

    # -- flat pack/unpack (one B1 launch each) -------------------------------

    def pack(self, bucket, tensors_by_key, dtype=None, factor=1.0,
             device=None):
        """Member tensors -> one flat bucket buffer of ``dtype`` (default
        the bucket's), ``dtype(f32(x) * factor)``; missing members
        contribute zeros (the unused-parameter case)."""
        dt = dtype or torch_dtype(bucket.dtype)
        present = [(tensors_by_key[key], off) for key, off, _
                   in self._members(bucket) if tensors_by_key.get(key)
                   is not None]
        if device is None:
            device = present[0][0].device if present else basics.device()
        full = len(present) == len(bucket.members)
        buf = (torch.empty if full else torch.zeros)(
            bucket.n, dtype=dt, device=device)
        if present:
            cuda_kernels.pack_scale_cast(
                [t.detach().to(device).contiguous() for t, _ in present],
                buf, [off for _, off in present], factor)
        return buf

    def unpack(self, bucket, buf, out=None, factor=1.0):
        """Flat bucket buffer -> ``{key: tensor}`` of the members' shapes,
        ``dst_dtype(f32(buf) * factor)``: new tensors of ``buf``'s dtype,
        or written into the contiguous ``out[key]`` (e.g. the model's
        parameters) for the members ``out`` names."""
        res, offs = {}, []
        for key, off, shape in self._members(bucket):
            if out is None:
                res[key] = torch.empty(shape, dtype=buf.dtype,
                                       device=buf.device)
            elif out.get(key) is not None:
                res[key] = out[key]
            else:
                continue
            offs.append(off)
        cuda_kernels.unpack_scale_cast(buf, list(res.values()), offs,
                                       factor)
        return res

    @staticmethod
    def _members(bucket):
        """(key, offset, shape) of each member, in pack order."""
        off = 0
        for key, size, shape in bucket.members:
            yield key, off, shape
            off += size


class ShardedUpdater:
    """The sharded weight-update wire of the engine-path frontends: the
    grouped reducescatter of gradient buckets and the grouped allgather
    of updated parameter shards, both over the configured wire, each with
    its own error-feedback residuals, and the layout fingerprint on every
    collective.

    ``state_bytes`` holds what :meth:`record_state_bytes` last recorded:
    ``{"shard": bytes this rank holds, "full": what the dense optimizer
    would hold}``, also exported as the ``horovod_optimizer_state_bytes``
    gauge; each gradient reducescatter round counts in
    ``horovod_sharded_update_runs_total``.  The updater registers with
    the step-integrity quarantine, which resets both wires' residuals
    (sharded.py:286-289 of the JAX package)."""

    def __init__(self, plan, process_set=None, op=None, grad_wire=None,
                 param_wire=None, name="shard"):
        self.plan = plan
        self.process_set = process_set
        self.op = api.Average if op is None else op
        #: wire of the gradient reducescatter (None defers to the
        #: engine's process-wide default)
        self.grad_wire = grad_wire
        #: wire of the updated-parameter allgather
        self.param_wire = param_wire
        self.name = name
        self.shard_fp = plan.fingerprint()
        self._grad_residuals = {}
        self._param_residuals = {}
        self._lock = threading.Lock()
        self.state_bytes = {"shard": 0, "full": 0}
        from .integrity import register_wire_state
        register_wire_state(self)

    def _ps(self):
        return self.process_set if self.process_set is not None else 0

    def my_pos(self):
        """This rank's position in the process set (its shard index)."""
        return basics.engine().get_process_set(
            api._ps_id(self._ps())).index[basics.context().rank]

    @staticmethod
    def _by_dtype(tensors):
        by = {}
        for i, t in enumerate(tensors):
            by.setdefault(api.dtype_name(t.dtype), []).append(i)
        return sorted(by.items())

    @staticmethod
    def _collect(handles, n):
        out = [None] * n
        for idxs, h in handles:
            res = api.synchronize(h)
            if not isinstance(res, (list, tuple)):
                res = [res]
            for i, r in zip(idxs, res):
                out[i] = r
        return out

    # -- gradient reducescatter ---------------------------------------------

    def _ef_inject_grad(self, i, buf, wire):
        """EF21 on the gradient wire, on the device: inject last step's
        quantization residual, keep this one (``x - fake_quantize(x)``
        through the codec kernels; the codec is a pure function of x, so
        this re-encode matches the engine's wire)."""
        with torch.no_grad():
            x = cuda_kernels.cast(buf, torch.float32)
            r = self._grad_residuals.get(i)
            if r is not None and r.shape == x.shape:
                x = x + r
            self._grad_residuals[i] = x - quantize_kernels.fake_quantize_wire(
                x, wire)
            return cuda_kernels.cast(x, buf.dtype)

    def reduce_grads(self, bucket_buffers):
        """Grouped reducescatter of the flat gradient buckets (one jointly
        negotiated group per dtype).  Returns this rank's shard per
        bucket."""
        wire = self.grad_wire
        bufs = list(bucket_buffers)
        if wire in ("int8", "int4"):
            bufs = [self._ef_inject_grad(i, b, wire)
                    for i, b in enumerate(bufs)]
        handles = [(idxs, api.grouped_reducescatter_async(
            [bufs[i] for i in idxs], op=self.op, name=f"{self.name}.rs.{dt}",
            process_set=self._ps(), wire_dtype=wire,
            shard_fp=self.shard_fp)) for dt, idxs in self._by_dtype(bufs)]
        out = self._collect(handles, len(bufs))
        telemetry.count_sharded_update()
        return out

    # -- updated-parameter allgather ------------------------------------------

    def gather_params(self, shard_buffers):
        """Allgather the updated shards back into full flat buckets over
        ``param_wire``.  Quantized wires ship codes and scales with one
        residual per bucket: the master shard never leaves full width on
        its owner, and every rank (owner included) installs the decoded
        value."""
        wire = self.param_wire
        if self.my_pos() == 0:
            self._account_param_wire(wire)
        if wire in ("int8", "int4"):
            waiter = self._gather_quantized(shard_buffers, wire)
        elif wire in ("fp16", "bf16"):
            waiter = self._gather_cast16(shard_buffers, wire)
        else:
            waiter = self._gather_plain(shard_buffers)
        return waiter()

    def _account_param_wire(self, wire):
        """The parameter allgather's bytes in the engine's wire counters,
        once per collective as the engine counts a reduction: the
        buckets at full width, and what the wire moves (every rank's
        codes plus 2 bytes a block, the 16-bit values, or the buckets).
        The engine cannot count them itself: to it the payload is codes."""
        for b in self.plan.buckets:
            itemsize = torch_dtype(b.dtype).itemsize
            if wire in ("int8", "int4"):
                bits = 4 if wire == "int4" else 8
                actual = sum(
                    qz.code_elems(qz.num_blocks(m), bits)
                    + qz.num_blocks(m) * qz.SCALE_BYTES for m in b.chunks)
            else:
                actual = qz.wire_nbytes(b.n, wire, itemsize)
            basics.engine().account_wire(b.n * itemsize, actual)

    def _gather_plain(self, shards, name="ag"):
        handles = [(idxs, api.grouped_allgather_async(
            [shards[i] for i in idxs], name=f"{self.name}.{name}.{dt}",
            process_set=self._ps(), shard_fp=self.shard_fp))
            for dt, idxs in self._by_dtype(shards)]
        return lambda: self._collect(handles, len(shards))

    def _gather_cast16(self, shards, wire):
        """The 16-bit wire: ``x = master + residual`` in f32, cast to the
        wire dtype (B1), the new residual ``x - f32(cast)``; the gathered
        16-bit buffers are cast back to each bucket's dtype (B1)."""
        wdt = qz.WIRE_TORCH_DTYPES[wire]
        sent, dtypes = [], []
        with torch.no_grad():
            for i, s in enumerate(shards):
                x = cuda_kernels.cast(s, torch.float32)
                r = self._param_residuals.get(i)
                if r is not None and r.shape == x.shape:
                    x = x + r
                tx = cuda_kernels.cast(x, wdt)
                self._param_residuals[i] = x - cuda_kernels.cast(
                    tx, torch.float32)
                sent.append(tx)
                dtypes.append(s.dtype)
        h = api.grouped_allgather_async(
            sent, name=f"{self.name}.ag16", process_set=self._ps(),
            shard_fp=self.shard_fp)

        def wait():
            res = api.synchronize(h)
            if not isinstance(res, (list, tuple)):
                res = [res]
            return [cuda_kernels.cast(r, dt) for r, dt in zip(res, dtypes)]
        return wait

    def _gather_quantized(self, shards, wire):
        """Codec allgather: encode this rank's shard once (with error
        feedback; B2/B4), gather codes and scales of all ranks, decode
        every rank's segment (B3/B5): 1 byte (int8) or half a byte (int4)
        an element on the wire, plus 2 a block: the scales travel as the
        bytes of their bf16 values, which is exact (they are bf16-rounded)
        and every backend gathers uint8 (the JAX package gathers them as
        f32)."""
        bits = 4 if wire == "int4" else 8
        codes, scales, dtypes = [], [], []
        with torch.no_grad():
            for i, s in enumerate(shards):
                x = cuda_kernels.cast(s.reshape(-1), torch.float32)
                r = self._param_residuals.get(i)
                if r is not None and r.shape == x.shape:
                    x = x + r
                q, sc = quantize_kernels.encode(x, wire)
                self._param_residuals[i] = x - quantize_kernels.decode(
                    q, sc, x.numel(), bits)
                codes.append(q)
                scales.append(sc.to(torch.bfloat16).view(torch.uint8))
                dtypes.append(s.dtype)
        hq = api.grouped_allgather_async(
            codes, name=f"{self.name}.agq", process_set=self._ps(),
            shard_fp=self.shard_fp)
        hs = api.grouped_allgather_async(
            scales, name=f"{self.name}.ags", process_set=self._ps(),
            shard_fp=self.shard_fp)
        plan = self.plan

        def wait():
            gq, gs = api.synchronize(hq), api.synchronize(hs)
            if not isinstance(gq, (list, tuple)):
                gq, gs = [gq], [gs]
            out = []
            for b, q_all, s_all, dt in zip(plan.buckets, gq, gs, dtypes):
                full = torch.empty(b.n, dtype=torch.float32,
                                   device=q_all.device)
                s_all = s_all.view(torch.bfloat16).float()
                qo = so = 0
                for pos in range(plan.dp):
                    m = b.chunks[pos]
                    nb = qz.num_blocks(m)
                    qlen = qz.code_elems(nb, bits)
                    if m:
                        start = b.rank_offsets[pos]
                        full[start:start + m] = quantize_kernels.decode(
                            q_all[qo:qo + qlen], s_all[so:so + nb], m, bits)
                    qo += qlen
                    so += nb
                out.append(cuda_kernels.cast(full, dt))
            return out
        return wait

    # -- re-shard ------------------------------------------------------------

    def gather_full(self, shard_buffers):
        """EXACT (full-width) allgather of per-bucket shard state, the
        deterministic re-shard primitive: state_dict gathers here, and a
        load at another dp re-slices the full buffers under its plan.
        Never rides a lossy wire."""
        return self._gather_plain([s.contiguous() for s in shard_buffers],
                                  name="full")()

    def reset_wire_state(self):
        """Drop every error-feedback residual (gradient and parameter
        wires): stale residuals of an old layout must never be injected
        into a new one.  (The JAX updater also clears the compiled path's
        per-hop residuals; the port's compiled reducer keeps its own and
        has its own ``reset_wire_state``.)"""
        with self._lock:
            self._grad_residuals.clear()
            self._param_residuals.clear()

    def record_state_bytes(self, shard_state_bytes):
        """The ÷dp evidence: ``shard`` is what this rank holds, ``full``
        what the dense optimizer would (the shard bytes scaled by total
        over local elements)."""
        local = max(self.plan.local_elems(self.my_pos()), 1)
        self.state_bytes = {
            "shard": int(shard_state_bytes),
            "full": int(round(shard_state_bytes * self.plan.total_elems
                              / local))}
        for scope, nbytes in self.state_bytes.items():
            telemetry.set_optimizer_state_bytes(scope, nbytes)

