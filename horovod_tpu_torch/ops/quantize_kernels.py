"""Block-scaled int8/int4 wire codec kernels and their wrappers (port of
the codec half of ``horovod_tpu/ops/pallas_kernels.py``: B2
``quantize_blockwise``, B3 ``dequantize_blockwise``, B4
``quantize_blockwise_int4`` and B5 ``dequantize_blockwise_int4``).

The function is the numpy codec's (``ops/quantize.py`` describes the
format and holds the plain versions): ``nb = ceil(n / 256)`` blocks,
codes ``(nb * 256,)`` int8 or ``(nb * 128,)`` uint8, scales ``(nb,)``
f32.  On the card two CUDA kernels (``ops/csrc/quantize.cu``) compute
it, each for both widths.

Dispatch is by the device of the tensors: a tensor on the CPU takes the
plain version; a CUDA tensor launches the kernel, and a failure to build
or launch raises.  Each public function counts its own kernel launches
in :data:`launches`.

``fake_quantize_blockwise`` and ``fake_quantize_blockwise_int4`` are the
quant->dequant round trip as autograd Functions whose backward is the
identity (the ``jax.custom_vjp`` pair of the reference); the backward
has no kernel of its own.
"""

import ctypes
import threading

import torch

from . import _build
from . import quantize as qz
from ..utils import profiler

#: dtype codes of ops/csrc/quantize.cu
_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
FLOAT_DTYPES = tuple(_CODES)

#: kernel launches per public function, since the last reset_launches()
launches = {"quantize_blockwise": 0, "dequantize_blockwise": 0,
            "quantize_blockwise_int4": 0, "dequantize_blockwise_int4": 0}
_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name):
    with _count_lock:
        launches[name] += 1


def _lib():
    lib = _build.load("hvd_quantize", ["quantize.cu"])
    if not getattr(lib, "_hvd_typed", False):
        lib.hvd_quantize_blockwise.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.hvd_quantize_blockwise.restype = ctypes.c_int
        lib.hvd_dequantize_blockwise.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.hvd_dequantize_blockwise.restype = ctypes.c_int
        lib._hvd_typed = True
    return lib


def _device_of(*tensors):
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"codec tensors must share one device: "
                             f"{t.device} vs {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the wire codec runs on cuda or cpu, not {device}")
    return device


def _index(device):
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# encode (B2, B4)

def _quantize(x, bits, name):
    if x.dtype not in _CODES:
        raise TypeError(f"{name} takes f32, f16 or bf16, not {x.dtype}")
    device = _device_of(x)
    if device.type == "cpu":
        plain = qz.plain_quantize_blockwise if bits == 8 \
            else qz.plain_quantize_blockwise_int4
        return plain(x)
    x = x.contiguous().reshape(-1)
    n = x.numel()
    nb = qz.num_blocks(n)
    codes = torch.empty(qz.code_elems(nb, bits),
                        dtype=torch.int8 if bits == 8 else torch.uint8,
                        device=device)
    scales = torch.empty(nb, dtype=torch.float32, device=device)
    if n == 0:
        return codes, scales
    err = _lib().hvd_quantize_blockwise(
        _index(device), x.data_ptr(), n, _CODES[x.dtype], bits,
        codes.data_ptr(), scales.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({n} elements, {x.dtype})")
    _count(name)
    return codes, scales


def quantize_blockwise(x):
    """Flat float tensor (f32, f16 or bf16) -> (codes int8 (nb * 256,),
    scales f32 (nb,))."""
    return _quantize(x, 8, "quantize_blockwise")


def quantize_blockwise_int4(x):
    """Flat float tensor -> (packed uint8 (nb * 128,), scales f32
    (nb,))."""
    return _quantize(x, 4, "quantize_blockwise_int4")


# ---------------------------------------------------------------------------
# decode (B3, B5)

def _dequantize(q, scales, n, out_dtype, bits, name):
    want = torch.int8 if bits == 8 else torch.uint8
    if q.dtype != want or scales.dtype != torch.float32:
        raise TypeError(f"{name} takes {want} codes and f32 scales, not "
                        f"{q.dtype} and {scales.dtype}")
    if out_dtype not in _CODES:
        raise TypeError(f"{name} writes f32, f16 or bf16, not {out_dtype}")
    nb = scales.numel()
    n = int(n)
    if q.numel() != qz.code_elems(nb, bits) or not 0 <= n <= nb * qz.BLOCK:
        raise ValueError(f"{name}: {q.numel()} codes and {nb} scales do not "
                         f"hold {n} elements")
    device = _device_of(q, scales)
    if device.type == "cpu":
        plain = qz.plain_dequantize_blockwise if bits == 8 \
            else qz.plain_dequantize_blockwise_int4
        return plain(q, scales, n, out_dtype)
    q, scales = q.contiguous(), scales.contiguous()
    out = torch.empty(n, dtype=out_dtype, device=device)
    if n == 0:
        return out
    err = _lib().hvd_dequantize_blockwise(
        _index(device), q.data_ptr(), scales.data_ptr(), n, bits,
        _CODES[out_dtype], out.data_ptr(), _stream(device))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({n} elements, {out_dtype})")
    _count(name)
    return out


def dequantize_blockwise(q, scales, n, out_dtype=torch.float32):
    """Inverse of :func:`quantize_blockwise`: ``(n,)`` of
    ``out_dtype(f32(q) * scale)``."""
    return _dequantize(q, scales, n, out_dtype, 8, "dequantize_blockwise")


def dequantize_blockwise_int4(q, scales, n, out_dtype=torch.float32):
    """Inverse of :func:`quantize_blockwise_int4`."""
    return _dequantize(q, scales, n, out_dtype, 4,
                       "dequantize_blockwise_int4")


def encode(x, wire):
    """``wire`` ('int8' or 'int4') encode of a flat float tensor."""
    return quantize_blockwise_int4(x) if wire == "int4" \
        else quantize_blockwise(x)


def decode(q, scales, n, bits, out_dtype=torch.float32):
    """Decode ``n`` elements of a ``bits``-wide (8 or 4) code array."""
    if bits == 4:
        return dequantize_blockwise_int4(q, scales, n, out_dtype)
    return dequantize_blockwise(q, scales, n, out_dtype)


def fake_quantize_wire(x, wire):
    """Quant->dequant round trip of ``x`` (any shape, same dtype) through
    the ``wire`` codec, one encode and one decode launch on the card,
    inside the ``hvd_quantize_encode`` and ``hvd_quantize_decode``
    profiler ranges (the error-feedback hooks' codec phases)."""
    with profiler.annotate("hvd_quantize_encode", x.device):
        q, s = encode(x.reshape(-1), wire)
    with profiler.annotate("hvd_quantize_decode", x.device):
        return decode(q, s, x.numel(), 4 if wire == "int4" else 8,
                      x.dtype).view(x.shape)


# ---------------------------------------------------------------------------
# straight-through fake quantization

class _FakeQuantize(torch.autograd.Function):
    """Forward: the round trip; backward: the identity, so gradients are
    exact with respect to the dequantized value."""

    @staticmethod
    def forward(ctx, x, wire):
        return fake_quantize_wire(x, wire)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quantize_blockwise(x):
    return _FakeQuantize.apply(x, "int8")


def fake_quantize_blockwise_int4(x):
    return _FakeQuantize.apply(x, "int4")
