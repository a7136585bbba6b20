"""End-to-end step integrity: wire digests, the divergence sentinel, the
update guards and the CRC trailers (port of
``horovod_tpu/core/integrity.py``).

* **Wire digests** -- a 64-bit content digest (:func:`digest64`) of each
  fused bucket's payloads held against their packed rows, and of its
  encoded wire rows at encode re-verified, before the collective
  consumes them.  The JAX package digests each payload at submit; here
  payloads are folded with their packed rows at the bucket's verdict,
  so the check spans the pack to the verdict and a payload written
  between its submit and the pack is not seen (ROADMAP C).  On the card the folds are computed by one kernel
  launch per bucket and watch (``ops/digest_kernels.py``,
  ``ops/csrc/digest.cu``) and stay on the device; a bucket's verdict is
  one small device-to-host read of its mismatch flags.  The engine's
  implicated-rank MIN vote makes a detection unanimous across processes
  before any handle resolves.
* **Divergence sentinel** -- every ``HOROVOD_INTEGRITY_SENTINEL_STEPS``
  the ranks fold their parameters into a fingerprint and agree on it in
  one small MIN allreduce (:class:`StepSentinel`); the update guard
  checks finiteness (and, when asked, the gradient norm) on the device
  and reads one scalar.
* **Rollback** -- every detection raises a :class:`StepIntegrityError`
  (a ``HorovodInternalError``), which the elastic retry loop answers by
  restoring the last commit; ``quarantine`` errors replay in place,
  ``evict`` errors re-raise so the driver blacklists the host.
* **CRC trailers** -- torn-write hardening of the elastic spill.

The digest is the JAX package's bit for bit: for every buffer the xor
and the wrapping sum of its little-endian uint64 words plus the tail,
mixed FNV-style across buffers.  A CPU tensor, numpy array or bytes
folds with numpy; a CUDA tensor only on the card.
"""

import logging
import struct
import weakref
import zlib

import numpy as np
import torch

from ..common.exceptions import HorovodInternalError
from ..ops import digest_kernels

logger = logging.getLogger("horovod_tpu_torch")

#: Process-wide registry of objects holding wire state (error-feedback
#: residuals): a quarantine resets every registered holder's
#: (integrity.py:61-69 of the JAX package)
_WIRE_STATE_REGISTRY = weakref.WeakSet()


def register_wire_state(obj):
    """Register an object exposing ``reset_wire_state()`` for
    quarantine-time residual resets (weakly referenced)."""
    if hasattr(obj, "reset_wire_state"):
        _WIRE_STATE_REGISTRY.add(obj)
    return obj


def reset_registered_wire_state():
    """Reset every registered holder's wire state (resilient: hygiene
    must not mask detection)."""
    for obj in list(_WIRE_STATE_REGISTRY):
        try:
            obj.reset_wire_state()
        except Exception:  # noqa: BLE001
            logger.exception("integrity: wire-state reset failed on %r",
                             type(obj).__name__)


_M64 = (1 << 64) - 1
_M63 = (1 << 63) - 1
_FNV_PRIME = 0x100000001b3
_FNV_SEED = 0xcbf29ce484222325

#: The "no corruption here" value of the implicated-rank MIN vote: exact
#: in float32 and larger than any real global rank.
OK_VOTE = float(1 << 24)


# ---------------------------------------------------------------------------
# digests


def _segment(a):
    """One buffer as (a tensor, or a uint8 numpy vector) and its byte
    count."""
    if isinstance(a, (bytes, bytearray, memoryview)):
        b = np.frombuffer(a, dtype=np.uint8)
        return b, b.size
    if torch.is_tensor(a):
        t = a.detach().reshape(-1)
        if not t.is_contiguous():
            t = t.contiguous()
        return t, t.numel() * t.element_size()
    b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return b, b.size


def _mix(folds_and_sizes):
    h = _FNV_SEED
    for f, n in folds_and_sizes:
        h = ((h ^ f) * _FNV_PRIME + n + 1) & _M64
    return h


def _buffer_folds(buffers):
    """(fold, byte count) of every buffer, CUDA tensors folded together
    in one kernel launch and read once."""
    segs = [_segment(a) for a in buffers]
    cuda = [s for s, _ in segs if torch.is_tensor(s) and s.is_cuda]
    dev_folds = iter(digest_kernels.fold_segments(cuda).cpu().tolist()) \
        if cuda else iter(())
    out = []
    for s, n in segs:
        if torch.is_tensor(s):
            if s.is_cuda:
                out.append((digest_kernels.to_u64(next(dev_folds)), n))
            else:
                out.append((digest_kernels.np_fold(
                    digest_kernels.byte_view(s).numpy()), n))
        else:
            out.append((digest_kernels.np_fold(s), n))
    return out


def digest64(buffers) -> int:
    """64-bit content digest of a sequence of tensors, numpy arrays or
    bytes: per-buffer folds mixed with an FNV-style multiply, so buffer
    order and lengths matter."""
    return _mix(_buffer_folds(buffers))


def _iter_leaves(tree):
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _iter_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree


def _leaf(leaf):
    return leaf if torch.is_tensor(leaf) else np.asarray(leaf)


def fold_fingerprint(tree) -> int:
    """Fold a (possibly nested dict/list/tuple) tree of tensors or arrays
    into a 63-bit fingerprint, dict keys sorted: the sentinel's replica
    identity."""
    return digest64([_leaf(leaf) for leaf in _iter_leaves(tree)]) & _M63


# ---------------------------------------------------------------------------
# errors


class StepIntegrityError(HorovodInternalError):
    """Base of every integrity detection: the elastic retry loop restores
    the last commit and replays."""

    #: rollback-reason label of horovod_integrity_rollbacks_total
    reason = "integrity"
    #: run_fn re-raises an eviction-grade error instead of restoring
    evict = False
    #: the verdict was unanimous and the mesh is healthy: replay in place
    quarantine = True


class WireIntegrityError(StepIntegrityError):
    """A wire or payload digest mismatch (or a peer's vote implicated a
    rank); carries the implicated global ``rank``."""

    reason = "wire_checksum"

    def __init__(self, message, rank=None, site=None):
        super().__init__(message)
        self.rank = rank
        self.site = site


class ReplicaDivergenceError(StepIntegrityError):
    """The sentinel's fingerprints disagree; ``suspects`` names the
    minority-fingerprint global ranks."""

    reason = "divergence"

    def __init__(self, message, suspects=()):
        super().__init__(message)
        self.suspects = tuple(suspects)


class NonFiniteUpdateError(StepIntegrityError):
    """The update guard found a nonfinite (or norm-bound violating)
    gradient before the optimizer applied it."""

    reason = "nonfinite"


class HostEvictionError(StepIntegrityError):
    """Repeated detections implicated a rank this process hosts: the
    worker exits and the driver blacklists the host."""

    reason = "eviction"
    evict = True

    def __init__(self, message, rank=None):
        super().__init__(message)
        self.rank = rank


# ---------------------------------------------------------------------------
# batched verification (one launch, one host read)


class FoldCheck:
    """Segments folded together and compared in one launch and one read:
    :meth:`add` queues a group of segments with their recorded folds (an
    int64 tensor on their device), :meth:`add_pair` a group of segments
    to hold against as many others (a payload against its packed copy);
    :meth:`run` folds every queued segment in one launch, compares on the
    device and reads the mismatch flags once, returning ``(tag, [changed
    segment indices])`` for the groups that changed."""

    __slots__ = ("segs", "expected", "tags", "sizes", "pairs")

    def __init__(self):
        self.segs, self.expected, self.tags, self.sizes = [], [], [], []
        self.pairs = []

    def add(self, segs, expected, tag):
        self.segs.extend(segs)
        self.expected.append(expected)
        self.tags.append(tag)
        self.sizes.append(len(segs))

    def add_pair(self, segs, against, tag):
        self.pairs.append((segs, against, tag))

    def run(self):
        a = [s for segs, _b, _t in self.pairs for s in segs]
        b = [s for _a, segs, _t in self.pairs for s in segs]
        if not (self.segs or a):
            return []
        new = digest_kernels.fold_segments(self.segs + a + b)
        n = len(self.segs)
        parts = []
        if self.expected:
            parts.append(new[:n] != torch.cat(
                [e.to(new.device) for e in self.expected]))
        if a:
            parts.append(new[n:n + len(a)] != new[n + len(a):])
        flags = (torch.cat(parts) if len(parts) > 1 else parts[0]) \
            .cpu().tolist()
        bad, i = [], 0
        groups = list(zip(self.tags, self.sizes)) + \
            [(tag, len(segs)) for segs, _b, tag in self.pairs]
        for tag, k in groups:
            idx = [j for j in range(k) if flags[i + j]]
            if idx:
                bad.append((tag, idx))
            i += k
        return bad


def _row_segments(row):
    bufs = row if isinstance(row, (list, tuple)) else (row,)
    out = []
    for a in bufs:
        s, _ = _segment(a)
        out.append(s if torch.is_tensor(s) else torch.from_numpy(s))
    return out


class BucketWatch:
    """Per-bucket wire-digest scope: the dispatch registers each hop's
    actual wire rows right after encode (codes and scales on quantized
    wires, the 16-bit cast on cast wires, the raw rows elsewhere), and
    :meth:`scan` re-verifies them, returning the lowest implicated global
    rank and a message naming the bucket, the hop and the wire.  A
    watch's folds stay on the rows' device; :meth:`fingerprints` mixes
    them into the JAX package's per-row ``digest64`` values."""

    __slots__ = ("label", "watches")

    def __init__(self, label):
        self.label = label
        self.watches = []

    def watch(self, site, hop, wire, rows, ranks):
        """Digest one hop's per-rank wire rows (each row a tensor or a
        tuple of tensors, e.g. (codes, scales)) in one launch."""
        segs = [_row_segments(r) for r in rows]
        flat = [s for row in segs for s in row]
        folds = digest_kernels.fold_segments(flat) if flat \
            else torch.zeros(0, dtype=torch.int64)
        self.watches.append((site, hop, wire, segs, list(ranks), folds))

    def fingerprints(self):
        """Per watch, the per-row ``digest64`` of the recorded folds."""
        out = []
        for _site, _hop, _wire, segs, _ranks, folds in self.watches:
            vals = [digest_kernels.to_u64(v) for v in folds.cpu().tolist()]
            fps, i = [], 0
            for row in segs:
                fps.append(_mix((vals[i + j], s.numel() * s.element_size())
                                for j, s in enumerate(row)))
                i += len(row)
            out.append(fps)
        return out

    def queue(self, check):
        """Queue every watched row into a :class:`FoldCheck`, tagged
        (watch index, row index)."""
        for w, (_s, _h, _w, segs, _r, folds) in enumerate(self.watches):
            i = 0
            for k, row in enumerate(segs):
                check.add(row, folds[i:i + len(row)], (w, k))
                i += len(row)

    def verdict(self, bad_tags):
        """``(bad_rank, message)`` of the lowest implicated rank among the
        changed rows ``bad_tags`` (from :meth:`queue`'s tags), or
        ``(None, None)``."""
        bad, msg = None, None
        for w, k in bad_tags:
            site, hop, wire, _segs, ranks, _f = self.watches[w]
            rank = ranks[k] if k < len(ranks) else -1
            if bad is None or rank < bad:
                bad = rank
                msg = (f"wire checksum mismatch in bucket {self.label!r} "
                       f"(site {site}, hop {hop}, wire {wire or 'f32'}): "
                       f"global rank {rank}'s encoded payload changed "
                       f"between encode and decode")
        return bad, msg

    def scan(self):
        """Re-verify every watch in one launch; ``(bad_rank, message)``
        for the lowest corrupted global rank, or ``(None, None)``."""
        check = FoldCheck()
        self.queue(check)
        return self.verdict([t for t, _idx in check.run()])


class IntegrityChecker:
    """Per-engine detection scoreboard: the ``evict_after``-th detection
    implicating one rank escalates to eviction (0 = never)."""

    def __init__(self, evict_after=3):
        self.evict_after = int(evict_after)
        self.detections = {}

    def record_detection(self, rank) -> bool:
        if rank is None:
            return False
        n = self.detections.get(rank, 0) + 1
        self.detections[rank] = n
        return self.evict_after > 0 and n >= self.evict_after


# ---------------------------------------------------------------------------
# divergence sentinel and update guards


def _quarantine_engine(reason, rank=None):
    """Best-effort engine quarantine from user-loop call sites."""
    try:
        from ..common import basics
        eng = basics._engine
        if eng is not None:
            eng.quarantine_step(reason, rank=rank)
    except Exception:  # noqa: BLE001 — hygiene must not mask detection
        logger.exception("integrity: engine quarantine failed")


def _sentinel_words(fp):
    """Four uint16 components of the fingerprint and their negations,
    exact in float32: one MIN allreduce gives min and -max of each."""
    w = [float((fp >> (16 * k)) & 0xFFFF) for k in range(4)]
    return np.array(w + [-x for x in w], np.float32)


def sentinel_agree(fp, allreduce_min):
    """One agreement round: True when every rank's fingerprint words
    match."""
    out = allreduce_min(_sentinel_words(fp))
    if torch.is_tensor(out):
        out = out.detach().cpu().numpy()
    out = np.asarray(out, np.float32).reshape(-1)
    mins, maxs = out[:4], -out[4:]
    return bool(np.array_equal(mins, maxs))


class StepSentinel:
    """Training-loop divergence sentinel and update guards.

    ``after_step(params, grads=grads)`` guards the update (nonfinite
    everywhere; the gradient norm when ``HOROVOD_INTEGRITY_MAX_GRAD_NORM``
    > 0) and every ``HOROVOD_INTEGRITY_SENTINEL_STEPS`` (default 50) runs
    one fingerprint agreement round."""

    def __init__(self, every=None, max_grad_norm=None,
                 process_set=None, name="hvd.integrity.sentinel"):
        from ..common import env as env_mod
        self.every = env_mod.get_int(
            env_mod.HOROVOD_INTEGRITY_SENTINEL_STEPS, 50) \
            if every is None else int(every)
        self.max_grad_norm = env_mod.get_float(
            env_mod.HOROVOD_INTEGRITY_MAX_GRAD_NORM, 0.0) \
            if max_grad_norm is None else float(max_grad_norm)
        self.process_set = process_set
        self.name = name
        self.steps = 0
        self.checks = 0

    def guard_update(self, grads):
        """Nonfinite / gradient-norm guard over a tree of gradients, on
        their device: per floating leaf one finiteness flag (and a f64
        sum of squares when the norm bound is set), accumulated on the
        device, then one scalar read.  No gradient is copied to the
        host."""
        from .. import telemetry

        bad = sq = None
        for leaf in _iter_leaves(grads):
            t = leaf if torch.is_tensor(leaf) else torch.as_tensor(
                np.asarray(leaf))
            if not t.is_floating_point():
                continue
            t = t.detach()
            nonfinite = ~torch.isfinite(t).all()
            bad = nonfinite if bad is None else bad | nonfinite.to(
                bad.device)
            if self.max_grad_norm > 0:
                s = torch.sum(torch.square(t.to(torch.float64)))
                sq = s if sq is None else sq + s.to(sq.device)
        if bad is not None and bool(bad):
            telemetry.count_integrity_check("corrupt", "guard")
            _quarantine_engine(NonFiniteUpdateError.reason)
            raise NonFiniteUpdateError(
                "integrity guard: nonfinite gradient/update detected "
                "before the optimizer applied — quarantining the step")
        norm = float(sq) ** 0.5 if sq is not None else 0.0
        if self.max_grad_norm > 0 and norm > self.max_grad_norm:
            telemetry.count_integrity_check("corrupt", "guard")
            _quarantine_engine(NonFiniteUpdateError.reason)
            raise NonFiniteUpdateError(
                f"integrity guard: gradient norm {norm:.3e} exceeds "
                f"HOROVOD_INTEGRITY_MAX_GRAD_NORM="
                f"{self.max_grad_norm:.3e} — quarantining the step")
        telemetry.count_integrity_check("ok", "guard")

    def check(self, params):
        """One agreement round now; returns the local fingerprint when
        replicas agree, raises :class:`ReplicaDivergenceError` when they
        do not."""
        import time as _time

        from .. import telemetry
        from ..common import basics
        from ..ops import api
        from .message import ReduceOp

        t0 = _time.monotonic()
        fp = fold_fingerprint(params)
        kwargs = {} if self.process_set is None \
            else {"process_set": self.process_set}
        dev = basics.engine().device

        def _armin(arr):
            return api.allreduce(torch.as_tensor(arr, device=dev),
                                 op=ReduceOp.MIN,
                                 name=f"{self.name}.{self.checks}", **kwargs)

        agreed = sentinel_agree(fp, _armin)
        self.checks += 1
        telemetry.observe_sentinel_seconds(_time.monotonic() - t0)
        if agreed:
            telemetry.count_integrity_check("ok", "sentinel")
            return fp
        telemetry.count_integrity_check("corrupt", "sentinel")
        fps = api.allgather_object(
            fp, name=f"{self.name}.who.{self.checks}", **kwargs)
        counts = {}
        for v in fps:
            counts[v] = counts.get(v, 0) + 1
        majority = max(counts.values())
        # allgather order is the set's position order: minority positions
        # map to global ranks
        set_ranks = list(getattr(self.process_set, "ranks", []) or []) \
            if self.process_set is not None else None
        suspects = tuple(
            set_ranks[i] if set_ranks and i < len(set_ranks) else i
            for i, v in enumerate(fps)
            if counts[v] < majority) if len(counts) > 1 else ()
        suspect = suspects[0] if suspects else None
        _quarantine_engine(ReplicaDivergenceError.reason, rank=suspect)
        raise ReplicaDivergenceError(
            f"integrity sentinel: replica param fingerprints diverged "
            f"({len(counts)} distinct values across {len(fps)} ranks; "
            f"minority rank(s) {list(suspects) or 'indeterminate'}) — "
            f"quarantining and rolling back to the last commit",
            suspects=suspects)

    def after_step(self, params, grads=None):
        """Guard the update, then run the agreement round on the
        sentinel cadence.  Returns True when a round ran."""
        if grads is not None:
            self.guard_update(grads)
        self.steps += 1
        if self.every > 0 and self.steps % self.every == 0:
            self.check(params)
            return True
        return False


# ---------------------------------------------------------------------------
# CRC trailers (torn-write hardening of the elastic spill)

TRAILER_MAGIC = b"HVDCRC1\n"
_TRAILER_LEN = len(TRAILER_MAGIC) + 12    # magic + <QI>(length, crc32)


class TrailerCorruptionError(RuntimeError):
    """A CRC-trailed payload failed verification; ``kind`` is
    ``"truncated"`` (a torn write) or ``"mismatch"`` (corrupted
    bytes)."""

    def __init__(self, message, kind):
        super().__init__(message)
        self.kind = kind


def crc_trailer(payload_len, crc):
    return TRAILER_MAGIC + struct.pack("<QI", payload_len,
                                       crc & 0xFFFFFFFF)


def append_crc_trailer(data: bytes) -> bytes:
    """``payload + magic + (length, crc32)``.  Pickle readers stop at the
    end of their stream, so a loader that knows no trailer ignores it."""
    return data + crc_trailer(len(data), zlib.crc32(data))


def has_crc_trailer(data: bytes) -> bool:
    return len(data) >= _TRAILER_LEN and \
        data[-_TRAILER_LEN:-12] == TRAILER_MAGIC


def strip_crc_trailer(data: bytes) -> bytes:
    """Verify and strip: the payload of a trailed blob after checking its
    length and CRC (raises :class:`TrailerCorruptionError`), or the input
    unchanged when it has no trailer."""
    if not has_crc_trailer(data):
        return data
    n, crc = struct.unpack("<QI", data[-12:])
    payload = data[:-_TRAILER_LEN]
    if n != len(payload):
        raise TrailerCorruptionError(
            f"CRC-trailed payload is torn: trailer records {n} bytes, "
            f"file holds {len(payload)}", kind="truncated")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TrailerCorruptionError(
            "CRC-trailed payload failed checksum verification (bit "
            "corruption in the stored bytes)", kind="mismatch")
    return payload
