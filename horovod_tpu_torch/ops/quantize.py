"""Block-scaled int8/int4 wire formats: the vocabulary and the plain
PyTorch codec (port of the framework-free part of
``horovod_tpu/ops/quantize.py``).

A float tensor is flattened and split into 256-element blocks; each
block travels as 256 integer codes plus ONE bfloat16 scale.

* **int8**: ``scale = bf16(absmax / 127)``, codes
  ``clip(rint(x / scale), -127, 127)``, one byte per element.
* **int4**: ``scale = bf16(absmax / 7)``, codes in [-7, 7] packed two per
  byte as biased nibbles ``q + 8``, even index in the low nibble.

Layout (the numpy codec's, ``quantize.py:175-290`` of the JAX package):
``nb = ceil(n / 256)`` blocks; codes ``(nb * 256,)`` int8 or
``(nb * 128,)`` uint8; scales ``(nb,)`` f32, already bf16-rounded; the
ragged last block is read as zeros, so padding encodes as code 0
(nibble 8).  A zero scale divides by 1.  A NaN quotient (an inf or NaN
in the block) encodes as code 0, so a block holding NaN or +-inf decodes
to all-NaN.

The ``plain_*`` functions here are the CPU path and the card's
yardstick for the kernels B2-B5 (``ops/csrc/quantize.cu``, wrapped by
``ops/quantize_kernels.py``).  Every division is by a tensor, never by a
Python number: PyTorch's CUDA ``div`` turns a division by a CPU scalar
into a multiplication by its reciprocal, which is not the same function.
"""

import torch

BLOCK = 256          # elements per scale block
SCALE_BYTES = 2      # bf16 scale per block

_WIRE_ALIASES = {
    # None / "" = UNSET (a process-wide default may apply); an explicit
    # f32 spelling = "ship full width, overriding any default"
    None: None, "": None,
    "f32": "f32", "fp32": "f32", "float32": "f32", "none": "f32",
    "f16": "fp16", "fp16": "fp16", "float16": "fp16",
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8", "i8": "int8",
    "int4": "int4", "i4": "int4",
}

#: single-hop wire dtype vocabulary (the per-call ``wire_dtype=``)
WIRE_CHOICES = (None, "fp16", "bf16", "int8", "int4")

#: wire dtypes legal on the fast intra-host (inner) hop: full width or a
#: 16-bit cast only
INNER_WIRE_CHOICES = (None, "f32", "fp16", "bf16")

#: legal (inner_wire, outer_wire) pairs, an enumeration
WIRE_PAIR_CHOICES = (
    (None, None),
    ("f32", "fp16"),
    ("f32", "bf16"),
    (None, "int8"),
    (None, "int4"),
    ("fp16", "fp16"),
    ("bf16", "bf16"),
    ("bf16", "int8"),
    ("bf16", "int4"),
)


def wire_pair_label(inner, outer):
    """A pair's spelling, ``'inner:outer'`` with f32 for full width (the
    autotune CSV and the ``horovod_autotune_best_config`` label;
    quantize.py:148-151 of the JAX package)."""
    return f"{inner or 'f32'}:{outer or 'f32'}"

#: torch dtype of each 16-bit wire
WIRE_TORCH_DTYPES = {"fp16": torch.float16, "bf16": torch.bfloat16}


def normalize_wire_dtype(wire):
    """Canonicalize a wire-dtype spec -> None (unset) | 'f32' (explicit
    full width) | 'fp16' | 'bf16' | 'int8' | 'int4'."""
    key = wire.strip().lower() if isinstance(wire, str) else wire
    try:
        return _WIRE_ALIASES[key]
    except KeyError:
        raise ValueError(
            f"unknown wire dtype {wire!r}; expected one of "
            "f32, fp16, bf16, int8, int4") from None


def normalize_inner_wire(wire):
    """Canonicalize an INNER-hop wire spec: the vocabulary of
    :func:`normalize_wire_dtype` minus the block-quantized formats,
    which are refused."""
    w = normalize_wire_dtype(wire)
    if w in ("int8", "int4"):
        raise ValueError(
            f"wire_inner={w!r} is not legal: block-quantized formats "
            "only apply to the cross-host (outer) hop — use fp16/bf16 "
            "or full width on the inner hop")
    return w


def effective_inner_wire(inner, outer, itemsize):
    """The uniform-shorthand rule: an unset inner inherits a 16-bit
    outer, a quantized outer leaves the inner hop full width, 'f32' is
    the explicit full-width override, and a 16-bit inner on an
    already-16-bit tensor is a no-op.  Returns the inner hop's wire
    (None = full width)."""
    if inner is None:
        inner = outer if outer in ("fp16", "bf16") else None
    if inner == "f32":
        inner = None
    if inner in ("fp16", "bf16") and itemsize <= 2:
        inner = None
    return inner


def wire_nbytes(n_elems, wire, itemsize):
    """Per-rank wire payload bytes for ``n_elems`` elements."""
    nb = -(-n_elems // BLOCK)
    if wire == "int8":
        return n_elems + nb * SCALE_BYTES
    if wire == "int4":
        # packed nibbles: half a byte per element (block-padded)
        return nb * (BLOCK // 2) + nb * SCALE_BYTES
    if wire in ("bf16", "fp16"):
        return n_elems * 2
    return n_elems * itemsize


def quantized_qmax(bits):
    """Symmetric code range per wire width: 127 (int8) / 7 (int4)."""
    if bits == 8:
        return 127
    if bits == 4:
        return 7
    raise ValueError(f"unsupported quantized wire width: {bits} bits")


def quantized_acc_dtype(bits, num_ranks):
    """Narrowest integer accumulator whose sum of ``num_ranks`` maxed-out
    codes stays exact: int8 wire int16 to 258 ranks, int32 beyond; int4
    wire int8 to 18 ranks, int16 to 4681, int32 beyond."""
    qmax = quantized_qmax(bits)
    for dt in (torch.int8, torch.int16, torch.int32):
        if num_ranks * qmax <= torch.iinfo(dt).max:
            return dt
    return torch.int32


def num_blocks(n):
    return -(-int(n) // BLOCK)


def quantized_psum_ef(x, bits, num_ranks, pmax, psum):
    """Shared-scale int8/int4 sum of ``x`` across one hop, and this
    side's error-feedback residual (``quantized_psum_ef_xla``,
    ``quantize.py:408-438`` of the JAX package).

    ``x`` is ``(..., n)`` float: the hop's participants' rows (leading
    dimensions) or one participant's.  Per 256-element block the bf16
    absmax is taken, its MAX across the hop (``pmax``) is the shared grid,
    ``scale = bf16(shared / qmax)``; the codes ``clip(round(x / scale))``
    sum across the hop as integers (``psum``) and decode with one multiply.
    ``pmax(t)`` and ``psum(t)`` reduce ``t`` across the hop and return a
    tensor that broadcasts against ``t`` (a stacked ``(R, ...)`` reduces
    over dim 0 with keepdim; a process reduces over its group in place).
    The codes reach ``psum`` as int32: the sum is exact in the narrowest
    accumulator :func:`quantized_acc_dtype` allows, so a wider one changes
    no value, and NCCL has no int16 and gloo refuses it.  Returns ``(y,
    resid)``: the f32 sum, shaped as the broadcast of the leading
    dimensions with ``(n,)``, and ``x - decode(codes)`` of ``x``'s shape
    and dtype.  ``num_ranks`` is the hop's size (the accumulator bound)."""
    qmax = quantized_qmax(bits)
    n = x.shape[-1]
    nb = num_blocks(n)
    xf = x.float()
    if nb * BLOCK != n:
        xf = torch.nn.functional.pad(xf, (0, nb * BLOCK - n))
    xb = xf.reshape(xf.shape[:-1] + (nb, BLOCK))
    shared = pmax(xb.abs().amax(dim=-1).to(torch.bfloat16)).float()
    # divide by a tensor: CUDA divides by a Python number as a
    # multiplication by its reciprocal
    scale = (shared / shared.new_full((), float(qmax))) \
        .to(torch.bfloat16).float()
    safe = torch.where(scale > 0, scale, scale.new_ones(()))
    q = torch.round(xb / safe[..., None]).clamp_(-qmax, qmax)
    resid = (xb - q * scale[..., None]).reshape(xf.shape)[..., :n] \
        .to(x.dtype)
    s = psum(q.to(torch.int32))
    y = s.float() * scale[..., None]
    return y.reshape(y.shape[:-2] + (nb * BLOCK,))[..., :n], resid


def quantized_psum_wire_nbytes(n_elems, num_ranks, bits=8):
    """Per-rank bytes of one :func:`quantized_psum_ef` hop as the JAX
    package counts them (``quantize.py:441``): the integer partials at
    the narrowest exact accumulator's width plus the bf16 absmax."""
    per = torch.iinfo(quantized_acc_dtype(bits, num_ranks)).bits // 8
    return n_elems * per + num_blocks(n_elems) * SCALE_BYTES


def code_elems(nb, bits):
    """Length of the code array of ``nb`` blocks."""
    return nb * BLOCK if bits == 8 else nb * (BLOCK // 2)


# ---------------------------------------------------------------------------
# plain codec (the CPU path, and the card's yardstick for B2-B5)

def _encode(x, qmax):
    """Flat float tensor -> (f32 codes (nb, BLOCK), f32 scales (nb,))."""
    x = x.reshape(-1).float()
    n = x.numel()
    nb = num_blocks(n)
    pad = nb * BLOCK - n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    xb = x.view(nb, BLOCK)
    # amax keeps a NaN, as numpy's max does
    absmax = xb.abs().amax(dim=1) if nb else x.new_zeros(0)
    scale = (absmax / absmax.new_full((), float(qmax))) \
        .to(torch.bfloat16).float()
    safe = torch.where(scale > 0, scale, scale.new_ones(()))
    q = torch.round(xb / safe[:, None]).clamp(-qmax, qmax)
    q = torch.where(torch.isnan(q), q.new_zeros(()), q)
    return q, scale


def plain_quantize_blockwise(x):
    """Flat float tensor -> (codes int8 (nb * 256,), scales f32 (nb,))."""
    q, scale = _encode(x, 127)
    return q.to(torch.int8).reshape(-1), scale


def _decode(q, scales, n, out_dtype):
    nb = scales.numel()
    y = q.reshape(nb, BLOCK).float() * scales.float()[:, None]
    return y.reshape(-1)[:n].to(out_dtype)


def plain_dequantize_blockwise(q, scales, n, out_dtype=torch.float32):
    """Inverse of :func:`plain_quantize_blockwise`: ``(n,)`` of
    ``out_dtype(f32(q) * scale)``."""
    return _decode(q, scales, n, out_dtype)


def pack_nibbles(q):
    """Int codes in [-7, 7], even length -> uint8, two per byte, biased
    by 8, even index in the low nibble."""
    b = (q.to(torch.int16) + 8).to(torch.uint8)
    return b[0::2] | (b[1::2] << 4)


def unpack_nibbles(packed):
    """Inverse of :func:`pack_nibbles` -> int8 codes in [-7, 7]."""
    p = packed.to(torch.uint8)
    lo = (p & 0x0F).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(-1)


def plain_quantize_blockwise_int4(x):
    """Flat float tensor -> (packed uint8 (nb * 128,), scales f32 (nb,))."""
    q, scale = _encode(x, 7)
    return pack_nibbles(q.to(torch.int8).reshape(-1)), scale


def plain_dequantize_blockwise_int4(packed, scales, n,
                                    out_dtype=torch.float32):
    """Inverse of :func:`plain_quantize_blockwise_int4`."""
    return _decode(unpack_nibbles(packed), scales, n, out_dtype)


def plain_fake_quantize_wire(x, wire):
    """Quant->dequant round trip of ``x`` (any shape, same dtype) through
    the ``wire`` ('int8' or 'int4') codec: the value the wire delivers."""
    if wire == "int4":
        q, s = plain_quantize_blockwise_int4(x)
        y = plain_dequantize_blockwise_int4(q, s, x.numel(), x.dtype)
    else:
        q, s = plain_quantize_blockwise(x)
        y = plain_dequantize_blockwise(q, s, x.numel(), x.dtype)
    return y.view(x.shape)
