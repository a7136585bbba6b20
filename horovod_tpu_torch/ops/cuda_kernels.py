"""Fusion-buffer scale/cast kernel and its plain PyTorch version.

Port of ``horovod_tpu/ops/pallas_kernels.py::fused_scale_cast``: the
function ``out_dtype(f32(x) * f32(factor))`` (``f64`` throughout for an
``f64`` tensor, as the engine path scales it).  On the card one CUDA
kernel, ``scale_cast_batched`` (``ops/csrc/scale_cast.cu``), computes it
for a whole list of tensors per launch (up to :data:`MAX_ENTRIES`, whose
table travels in the launch's parameters, laid out by
:func:`launch_tables`); it is the engine's fusion-buffer pack (prescale on
the way in) and unpack (postscale on the way out).

Dispatch is by the device of the tensors: a tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel, and a failure to build
or launch raises.  Each public function counts its own kernel launches
in :data:`launches`.
"""

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build

#: dtype codes of ops/csrc/scale_cast.cu
_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
          torch.float64: 3}
FLOAT_DTYPES = tuple(_CODES)
#: entries one launch's parameter table holds (scale_cast.cu kMaxEntries)
MAX_ENTRIES = 256
#: input bytes one tile of the work list covers (scale_cast.cu: 512
#: threads x one 16-byte vector)
TILE_BYTES = 512 * 16

#: kernel launches per public function, since the last reset_launches()
launches = {"fused_scale_cast": 0, "pack_scale_cast": 0,
            "unpack_scale_cast": 0}
_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name):
    with _count_lock:
        launches[name] += 1


def compute_dtype(in_dtype, out_dtype):
    """f64 for an f64 tensor (which must stay f64), f32 otherwise."""
    for dt in (in_dtype, out_dtype):
        if dt not in _CODES:
            raise TypeError(f"scale_cast does not take {dt}")
    if torch.float64 in (in_dtype, out_dtype):
        if in_dtype != out_dtype:
            raise TypeError("scale_cast casts f64 only to f64")
        return torch.float64
    return torch.float32


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's yardstick)

def plain_scale_cast(x, factor, out_dtype):
    comp = compute_dtype(x.dtype, out_dtype)
    return (x.to(comp) * factor).to(out_dtype)


def _plain_pairs(pairs, factor):
    for src, dst in pairs:
        dst.copy_(plain_scale_cast(src, factor, dst.dtype))


# ---------------------------------------------------------------------------
# kernel

def _lib():
    lib = _build.load("hvd_scale_cast", ["scale_cast.cu"])
    if not getattr(lib, "_hvd_typed", False):
        lib.hvd_scale_cast_batched.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        lib.hvd_scale_cast_batched.restype = ctypes.c_int
        lib.hvd_scale_cast_tile_elems.argtypes = [ctypes.c_int]
        lib.hvd_scale_cast_tile_elems.restype = ctypes.c_longlong
        lib.hvd_scale_cast_max_entries.restype = ctypes.c_int
        for size in (2, 4, 8):
            if lib.hvd_scale_cast_tile_elems(size) != TILE_BYTES // size:
                raise RuntimeError("scale_cast.cu's tile differs from "
                                   "cuda_kernels.TILE_BYTES")
        if lib.hvd_scale_cast_max_entries() != MAX_ENTRIES:
            raise RuntimeError("scale_cast.cu's kMaxEntries differs from "
                               "cuda_kernels.MAX_ENTRIES")
        lib._hvd_typed = True
    return lib


@functools.lru_cache(maxsize=1024)
def launch_tables(rows, itemsize):
    """The parameter tables of the launches that cover ``rows``, a tuple
    of ``(src_ptr, dst_ptr, n)`` with inputs of ``itemsize`` bytes: a
    tuple of read-only int64 arrays of shape (k, 4), k <= MAX_ENTRIES,
    each row ``(src_ptr, dst_ptr, n, tile_end)`` where ``tile_end`` counts
    the tiles of that launch's entries up to this one.  Empty members
    take no entry.  The engine's buckets repeat every step, so a list
    seen before is a cache hit."""
    tile = TILE_BYTES // itemsize
    tables, chunk, tiles = [], [], 0
    for src, dst, n in rows:
        if n == 0:
            continue
        tiles += -(-n // tile)
        chunk.append((src, dst, n, tiles))
        if len(chunk) == MAX_ENTRIES:
            tables.append(chunk)
            chunk, tiles = [], 0
    if chunk:
        tables.append(chunk)
    out = []
    for chunk in tables:
        a = np.asarray(chunk, dtype=np.int64)
        a.flags.writeable = False
        out.append(a)
    return tuple(out)


def _check(pairs):
    """Validate (src, dst) flat views for one launch; returns the
    common device, in-dtype and out-dtype."""
    src0, dst0 = pairs[0]
    device = src0.device
    in_dt, out_dt = src0.dtype, dst0.dtype
    compute_dtype(in_dt, out_dt)
    for src, dst in pairs:
        if src.device != device or dst.device != device:
            raise ValueError(
                f"scale_cast tensors must share one device: {src.device}, "
                f"{dst.device} vs {device}")
        if src.dtype != in_dt or dst.dtype != out_dt:
            raise TypeError(
                f"scale_cast needs one input and one output dtype per "
                f"launch: {src.dtype}->{dst.dtype} vs {in_dt}->{out_dt}")
        if not (src.is_contiguous() and dst.is_contiguous()):
            raise ValueError("scale_cast tensors must be contiguous")
        if src.numel() != dst.numel():
            raise ValueError(
                f"scale_cast size mismatch: {src.numel()} vs {dst.numel()}")
    return device, in_dt, out_dt


def _launch(pairs, factor, name):
    device, in_dt, out_dt = _check(pairs)
    if device.type == "cpu":
        _plain_pairs(pairs, factor)
        return
    if device.type != "cuda":
        raise ValueError(f"scale_cast runs on cuda or cpu, not {device}")
    lib = _lib()
    tables = launch_tables(
        tuple((s.data_ptr(), d.data_ptr(), s.numel()) for s, d in pairs),
        in_dt.itemsize)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    for table in tables:
        # the table is copied into the launch's parameters
        err = lib.hvd_scale_cast_batched(
            index, table.ctypes.data, len(table), _CODES[in_dt],
            _CODES[out_dt], float(factor), stream)
        if err != 0:
            raise RuntimeError(
                f"scale_cast_batched launch failed: cudaError {err} "
                f"({len(table)} entries, {int(table[-1, 3])} tiles, "
                f"{in_dt}->{out_dt})")
        _count(name)


# ---------------------------------------------------------------------------
# public functions

def fused_scale_cast(x, factor, out_dtype=None):
    """``out_dtype(f32(x) * factor)`` as a new tensor of ``x``'s shape
    (the contract of pallas_kernels.fused_scale_cast)."""
    out_dtype = out_dtype or x.dtype
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    _launch([(x.reshape(-1), out.reshape(-1))], factor, "fused_scale_cast")
    return out


def scale_(x, factor):
    """``x = dtype(f32(x) * factor)`` in place, one launch (counted as
    ``fused_scale_cast``): each element is read and written by the same
    thread."""
    flat = x.view(-1)
    if flat.numel():
        _launch([(flat, flat)], factor, "fused_scale_cast")
    return x


def cast(x, dtype):
    """``dtype(x)``, and ``x`` itself where it is of ``dtype`` already:
    through the kernel between the float dtypes it takes, a plain cast
    into or out of f64 (the kernel casts f64 only to f64) or of an
    integer tensor."""
    if x.dtype == dtype:
        return x
    if torch.float64 in (x.dtype, dtype) or x.dtype not in _CODES \
            or dtype not in _CODES:
        return x.to(dtype)
    return fused_scale_cast(x, 1.0, dtype)


def pack_scale_cast(srcs, buf, offsets, factor):
    """``buf[off_i : off_i + n_i] = out_dtype(f32(src_i.flatten()) *
    factor)`` for every member, in one launch on the card per
    :data:`MAX_ENTRIES` members."""
    pairs = [(s.reshape(-1), buf.narrow(0, int(off), s.numel()))
             for s, off in zip(srcs, offsets)]
    if pairs:
        _launch(pairs, factor, "pack_scale_cast")


def unpack_scale_cast(buf, dsts, offsets, factor):
    """The inverse of :func:`pack_scale_cast`: each ``dst_i`` (any
    contiguous tensor, e.g. ``p.grad``) receives
    ``dst_dtype(f32(buf[off_i : off_i + n_i]) * factor)``."""
    # a non-contiguous dst stays as it is, for _check to refuse: a
    # flattened copy would take the result and drop it
    pairs = [(buf.narrow(0, int(off), d.numel()),
              d.view(-1) if d.is_contiguous() else d)
             for d, off in zip(dsts, offsets)]
    if pairs:
        _launch(pairs, factor, "unpack_scale_cast")
