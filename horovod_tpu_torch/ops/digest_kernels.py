"""Content folds of byte segments: the step-integrity digest kernel and
its plain versions.

The function is ``_fold`` of ``horovod_tpu/core/integrity.py`` (the port's
copy is :func:`np_fold`): over a segment's bytes, the xor and the
wrapping sum of its little-endian uint64 words plus the little-endian
tail, mixed as ``x ^ (s * 0x9E3779B97F4A7C15)``.  It is no TPU kernel:
the JAX package folds host bytes with numpy.  On the card the payloads
are CUDA tensors, so one CUDA kernel (``ops/csrc/digest.cu``) folds every
segment of a bucket or a watch in one launch (a tile pass and a
per-segment pass, the segment table in the launch's parameters; a list
longer than 1024 segments takes one launch a 1024), words counted from
each segment's own first byte whatever its alignment.  Xor and wrapping
add are exact in any order, so the device result equals numpy's bit for
bit.

Dispatch is by the device of the tensors: segments on the CPU fold
through numpy's view of their bytes (:func:`np_fold`); CUDA segments
launch the kernel, and a failure to build or launch raises -- a CUDA
tensor is never digested on the host.  :func:`plain_fold` is the plain
PyTorch version on any device (the card's yardstick).  The launches are
counted in :data:`launches`.

A fold is returned as a signed int64 holding the 64 bits (torch has no
uint64 arithmetic); :func:`to_u64` maps it back.
"""

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build

_M64 = (1 << 64) - 1
_SUM_MIX = 0x9E3779B97F4A7C15
#: input words one tile of the work list covers (digest.cu kTileWords)
TILE_WORDS = 8192

#: kernel launches (a tile pass and a fold pass each, of at most 1024
#: segments), since the last reset_launches()
launches = {"digest_fold": 0}
_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name):
    with _count_lock:
        launches[name] += 1


def to_u64(v):
    """The unsigned 64-bit value of a fold held as a signed int64."""
    return int(v) & _M64


def _as_i64(u):
    return u - (1 << 64) if u >= 1 << 63 else u


# ---------------------------------------------------------------------------
# plain versions

def np_fold(b):
    """``_fold`` of a uint8 numpy vector (integrity.py:108-132 of the JAX
    package): the unaligned view falls back to a byte-identical copy."""
    n8 = (b.size // 8) * 8
    x = s = 0
    if n8:
        body = b[:n8]
        try:
            w = body.view(np.uint64)
        except ValueError:          # unaligned slice offset
            w = np.frombuffer(body.tobytes(), np.uint64)
        x = int(np.bitwise_xor.reduce(w))
        s = int(np.add.reduce(w))   # wraps mod 2**64
    if n8 != b.size:
        tail = int.from_bytes(b[n8:].tobytes(), "little")
        x ^= tail
        s = (s + tail) & _M64
    return x ^ ((s * _SUM_MIX) & _M64)


def byte_view(t):
    """A tensor's bytes as a flat uint8 tensor (a view where it is
    contiguous)."""
    t = t.reshape(-1)
    if t.numel() == 0:
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    if not t.is_contiguous():
        t = t.contiguous()
    return t.view(torch.uint8)


def plain_fold(t):
    """The fold of a tensor's bytes with PyTorch operations on its own
    device: the xor by pairwise halving, the wrapping sum as two exact
    sums of the words' 32-bit halves.  Returns an unsigned int."""
    b = byte_view(t)
    n = b.numel()
    n8 = (n // 8) * 8
    x = s = 0
    if n8:
        w = b[:n8].clone().view(torch.int64)
        lo = (w & 0xFFFFFFFF).sum()
        hi = ((w >> 32) & 0xFFFFFFFF).sum()
        s = (int(lo) + (int(hi) << 32)) & _M64
        while w.numel() > 1:
            if w.numel() % 2:
                w = torch.cat([w, w.new_zeros(1)])
            w = torch.bitwise_xor(w[0::2], w[1::2])
        x = int(w[0]) & _M64
    if n8 != n:
        tail = int.from_bytes(bytes(b[n8:].cpu().tolist()), "little")
        x ^= tail
        s = (s + tail) & _M64
    return x ^ ((s * _SUM_MIX) & _M64)


# ---------------------------------------------------------------------------
# kernel

def _lib():
    lib = _build.load("hvd_digest", ["digest.cu"])
    if not getattr(lib, "_hvd_typed", False):
        lib.hvd_digest_fold.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.hvd_digest_fold.restype = ctypes.c_int
        lib.hvd_digest_tile_words.restype = ctypes.c_longlong
        lib.hvd_digest_table_size.argtypes = [ctypes.c_int]
        lib.hvd_digest_table_size.restype = ctypes.c_int
        if lib.hvd_digest_tile_words() != TILE_WORDS or tuple(
                lib.hvd_digest_table_size(k) for k in range(3)) \
                != TABLE_SIZES:
            raise RuntimeError("digest.cu's tile or table sizes differ "
                               "from digest_kernels'")
        lib._hvd_typed = True
    return lib


#: the segment capacities of the launch tables (digest.cu Table<N>); a
#: longer list is split into launches of the largest
TABLE_SIZES = (16, 256, 1024)


@functools.lru_cache(maxsize=1024)
def launch_tables(segs):
    """The parameter tables of the launches that fold ``segs``, a tuple of
    ``(device address, byte count)``: a tuple of ``(table, capacity,
    tiles, first segment, segment count)``, each table a read-only int64
    array laid out as digest.cu's ``Table<capacity>`` (the address, byte
    count and running tile count columns, then the count).  A bucket's
    segments repeat every step, so a list seen before is a cache hit."""
    out = []
    cap_max = TABLE_SIZES[-1]
    for first in range(0, len(segs), cap_max):
        chunk = segs[first:first + cap_max]
        cap = next(c for c in TABLE_SIZES if c >= len(chunk))
        table = np.zeros(3 * cap + 1, dtype=np.int64)
        tiles = 0
        for i, (ptr, nbytes) in enumerate(chunk):
            if nbytes:
                tiles += max(1, -(-(nbytes // 8) // TILE_WORDS))
            table[i], table[cap + i], table[2 * cap + i] = ptr, nbytes, tiles
        table[3 * cap] = len(chunk)
        table.flags.writeable = False
        out.append((table, cap, tiles, first, len(chunk)))
    return tuple(out)


def fold_segments(tensors):
    """One fold per tensor of ``tensors`` (each a contiguous tensor; its
    bytes are the segment), all on one device.  On the card: one launch
    over every segment, on the current stream, whose int64 result stays
    on the device.  On the CPU: a CPU int64 tensor of numpy's folds."""
    if not tensors:
        return torch.zeros(0, dtype=torch.int64)
    device = tensors[0].device
    for t in tensors:
        if t.device != device:
            raise ValueError(f"digest segments must share one device: "
                             f"{t.device} vs {device}")
    if device.type == "cpu":
        return torch.tensor(
            [_as_i64(np_fold(byte_view(t).numpy())) for t in tensors],
            dtype=torch.int64)
    if device.type != "cuda":
        raise ValueError(f"digest runs on cuda or cpu, not {device}")
    segs = []
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("digest segments must be contiguous")
        segs.append((t.data_ptr(), t.numel() * t.element_size()))
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    launches_ = launch_tables(tuple(segs))
    tiles = max(t for _tb, _c, t, _f, _n in launches_)
    partials = torch.empty(max(2 * tiles, 1), dtype=torch.int64,
                           device=device)
    out = torch.empty(len(segs), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _lib()
    for table, cap, tiles, first, n in launches_:
        # the table is copied into the launch's parameters
        err = lib.hvd_digest_fold(index, table.ctypes.data, cap, tiles,
                                  partials.data_ptr(),
                                  out.data_ptr() + 8 * first, stream)
        if err != 0:
            raise RuntimeError(f"digest_fold launch failed: cudaError "
                               f"{err} ({n} segments, {tiles} tiles)")
        _count("digest_fold")
    return out
