"""horovod_tpu_torch's block-scaled wire codec (the plain PyTorch
versions the CPU takes, and the wrappers around kernels B2-B5) against
the JAX package's numpy codec and Pallas kernels.

Tolerance: bit for bit.  The codec is one f32 absmax, one correctly
rounded division and a round-to-nearest-even bf16 cast per block, one
correctly rounded division and a half-to-even rounding per element, and
one multiply and one RNE cast per decoded element, on every side.  The
one freedom is the int8 code of a NaN quotient (numpy's float-to-int
cast of NaN), so in blocks holding NaN or +-inf only the decoded values
(all NaN on both sides) are compared.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from horovod_tpu.ops import pallas_kernels
from horovod_tpu.ops import quantize as jqz
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import quantize as qz
from horovod_tpu_torch.ops import quantize_kernels as qk

SIZES = [1, 255, 256, 257, 70_000]
DTYPES = ["float32", "bfloat16", "float16"]
_NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16,
       "float16": np.float16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
QMAX = {8: 127, 4: 7}


def _to_torch(a):
    """Exact torch copy of a numpy array (bf16 through its bits)."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view({1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[
        a.dtype.itemsize])


def _np_codec(bits):
    if bits == 8:
        return jqz.np_quantize_blockwise, jqz.np_dequantize_blockwise
    return jqz.np_quantize_blockwise_int4, jqz.np_dequantize_blockwise_int4


def _port_codec(bits):
    if bits == 8:
        return qk.quantize_blockwise, qk.dequantize_blockwise
    return qk.quantize_blockwise_int4, qk.dequantize_blockwise_int4


def _random(n, seed):
    """Normal values whose scale varies over six decades across blocks."""
    rng = np.random.default_rng(seed)
    scale = np.repeat(10.0 ** rng.uniform(-3, 3, qz.num_blocks(n)), 256)[:n]
    return (rng.standard_normal(n) * scale).astype(np.float32)


def edge_blocks(qmax, seed=0):
    """Named 256-element f32 blocks that sit on the codec's edges."""
    rng = np.random.default_rng(seed)
    tiny = 2.0 ** -133                     # the least bf16 subnormal
    ties = ((np.arange(256) % (2 * qmax)) - qmax + 0.5) * 0.25
    ties[0] = qmax * 0.25                  # scale exactly 0.25: x/scale = k + 0.5
    # absmax / qmax = (1 + 1/qmax) * tiny rounds to tiny, so the largest
    # |x| / scale is qmax + 1 and the clip decides its code
    a = (qmax + 1) * tiny
    return {
        "zero": np.zeros(256),
        "subnormal_scale": rng.standard_normal(256) * 1e-38,
        "ties": ties,
        "clip": np.linspace(-1.0, 1.0, 256) * a,
    }


def _edge_input(qmax, names=("zero", "subnormal_scale", "ties", "clip")):
    blocks = edge_blocks(qmax)
    tail = _random(100, 9)                  # a ragged last block
    return np.concatenate([blocks[k] for k in names] + [tail]) \
        .astype(np.float32)


def _check_codec(x_np, bits, out_dtypes=("float32", "bfloat16")):
    enc_np, dec_np = _np_codec(bits)
    enc, dec = _port_codec(bits)
    qn, sn, n = enc_np(x_np)
    q, s = enc(_to_torch(x_np))
    assert q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert s.dtype == torch.float32 and s.shape == (qz.num_blocks(n),)
    np.testing.assert_array_equal(_bits(q), _bits(qn))
    np.testing.assert_array_equal(_bits(s), _bits(sn.astype(np.float32)))
    for od in out_dtypes:
        got = dec(q, s, n, _TORCH[od])
        want = dec_np(qn, sn, n, _NP[od])
        assert got.shape == (n,)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_codec_matches_numpy(bits, n, dtype):
    x = _random(n, seed=n).astype(_NP[dtype])
    qk.reset_launches()
    _check_codec(x, bits)
    # a CPU tensor takes the plain version: no kernel was launched
    assert set(qk.launches.values()) == {0}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_codec_edge_blocks_match_numpy(bits, dtype):
    qmax = QMAX[bits]
    x = _edge_input(qmax)
    xb = x[:1024].reshape(4, 256)
    scale = np.abs(xb).max(1) / np.float32(qmax)
    scale = scale.astype(ml_dtypes.bfloat16).astype(np.float32)
    # the blocks do sit on the edges they are named for
    assert scale[0] == 0 and 0 < scale[1] < 2.0 ** -126
    quot = xb[2] / scale[2]
    assert quot[0] == qmax and np.all(quot[1:] == np.floor(quot[1:]) + 0.5)
    assert np.abs(xb[3] / scale[3]).max() >= qmax + 0.5
    # (f16 flushes the two tiniest blocks to zero: still a valid case)
    _check_codec(x.astype(_NP[dtype]), bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_nonfinite_blocks_decode_to_nan(bits):
    rng = np.random.default_rng(4)
    blocks = [rng.standard_normal(256) for _ in range(4)]
    blocks[1][17] = np.nan
    blocks[2][200] = np.inf
    blocks[3][3] = -np.inf
    x = np.concatenate(blocks).astype(np.float32)
    enc_np, dec_np = _np_codec(bits)
    enc, dec = _port_codec(bits)
    with np.errstate(invalid="ignore"):
        qn, sn, n = enc_np(x)
        want = dec_np(qn, sn, n).reshape(4, 256)
    q, s = enc(_to_torch(x))
    got = dec(q, s, n).numpy().reshape(4, 256)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.isnan(want[1:]).all() and np.isnan(got[1:]).all()
    assert np.isnan(s[1].item()) and np.isinf(s[2].item())


@pytest.mark.parametrize("bits,n,dtype", [(8, 70_000, "float32"),
                                          (8, 257, "bfloat16"),
                                          (4, 70_000, "float32"),
                                          (4, 512 + 100, "float32")])
def test_plain_codec_matches_pallas_interpret(bits, n, dtype):
    """The Pallas kernels pad to 128-block rows: their first nb blocks
    are the codec's, the rest is zeros.  XLA on the CPU flushes
    subnormals, so the subnormal-scale edge blocks are held to the numpy
    codec only (above); the zero and tie blocks are held here too."""
    if n == 512 + 100:
        x = _edge_input(QMAX[bits], ("zero", "ties"))
    else:
        x = _random(n, seed=n + bits)
    x = x.astype(_NP[dtype])
    if bits == 8:
        pq, ps = pallas_kernels.quantize_blockwise(jnp.asarray(x),
                                                   interpret=True)
    else:
        pq, ps = pallas_kernels.quantize_blockwise_int4(jnp.asarray(x),
                                                        interpret=True)
    pq, ps = np.asarray(pq), np.asarray(ps)
    enc, dec = _port_codec(bits)
    q, s = enc(_to_torch(x))
    nb = s.numel()
    np.testing.assert_array_equal(_bits(q), _bits(pq[:q.numel()]))
    np.testing.assert_array_equal(_bits(s), _bits(ps[:nb]))
    assert not ps[nb:].any()
    if bits == 8:
        pdec = pallas_kernels.dequantize_blockwise(
            jnp.asarray(pq), jnp.asarray(ps), x.size, interpret=True)
    else:
        pdec = pallas_kernels.dequantize_blockwise_int4(
            jnp.asarray(pq), jnp.asarray(ps), x.size, interpret=True)
    np.testing.assert_array_equal(_bits(dec(q, s, x.size)),
                                  _bits(np.asarray(pdec)))


def test_nibble_pack_roundtrip_all_pairs():
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))
    codes = np.stack([lo.ravel(), hi.ravel()], axis=1).reshape(-1) \
        .astype(np.int8)
    packed = qz.pack_nibbles(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.numel() == 225
    np.testing.assert_array_equal(packed.numpy(),
                                  jqz.np_pack_nibbles(codes))
    np.testing.assert_array_equal(qz.unpack_nibbles(packed).numpy(), codes)


@pytest.mark.parametrize("bits,divisor", [(8, 254), (4, 14)])
def test_error_bound(bits, divisor):
    """Per-element error at most half the block scale: absmax / 254
    (int8), absmax / 14 (int4)."""
    x = (np.random.default_rng(bits).standard_normal(8192) * 5) \
        .astype(np.float32)
    enc, dec = _port_codec(bits)
    q, s = enc(torch.from_numpy(x))
    out = dec(q, s, x.size).numpy().reshape(-1, 256)
    blocks = x.reshape(-1, 256)
    bound = (np.abs(blocks).max(axis=1) / divisor + 1e-7)[:, None]
    assert np.all(np.abs(out - blocks) <= bound * 1.01)


@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quantize_matches_numpy_and_is_straight_through(bits):
    x_np = np.random.default_rng(13 + bits).standard_normal((3, 700)) \
        .astype(np.float32)
    fq_np = jqz.np_fake_quantize_blockwise(x_np) if bits == 8 \
        else jqz.np_fake_quantize_blockwise_int4(x_np)
    fq_fn = qk.fake_quantize_blockwise if bits == 8 \
        else qk.fake_quantize_blockwise_int4
    x = torch.from_numpy(x_np).requires_grad_()
    y = fq_fn(x)
    assert y.shape == x.shape and y.dtype == x.dtype
    np.testing.assert_array_equal(y.detach().numpy(), fq_np)
    np.testing.assert_array_equal(
        qz.plain_fake_quantize_wire(x.detach(), f"int{bits}").numpy(), fq_np)
    (y * 3.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.full(x.shape, 3.0, np.float32))


def test_wire_vocabulary_matches_jax():
    assert (qz.BLOCK, qz.SCALE_BYTES) == (jqz.BLOCK, jqz.SCALE_BYTES)
    assert qz._WIRE_ALIASES == jqz._WIRE_ALIASES
    assert qz.WIRE_CHOICES == jqz.WIRE_CHOICES
    assert qz.INNER_WIRE_CHOICES == jqz.INNER_WIRE_CHOICES
    assert qz.WIRE_PAIR_CHOICES == jqz.WIRE_PAIR_CHOICES
    spellings = [k for k in jqz._WIRE_ALIASES if k is not None]
    spellings += [" INT8 ", "Bf16", "float64", "int2", "q8"]
    for w in [None] + spellings:
        for fn in ("normalize_wire_dtype", "normalize_inner_wire"):
            try:
                want = getattr(jqz, fn)(w)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(qz, fn)(w)
            else:
                assert getattr(qz, fn)(w) == want, (fn, w)
    outers = jqz.WIRE_CHOICES + ("f32",)
    for inner in jqz.INNER_WIRE_CHOICES:
        for outer in outers:
            for itemsize in (2, 4, 8):
                assert qz.effective_inner_wire(inner, outer, itemsize) == \
                    jqz.effective_inner_wire(inner, outer, itemsize)
    for n in (0, 1, 255, 256, 257, 70_000, 25_557_032):
        for wire in outers:
            for itemsize in (2, 4, 8):
                assert qz.wire_nbytes(n, wire, itemsize) == \
                    jqz.wire_nbytes(n, wire, itemsize)
    for bits in (8, 4):
        assert qz.quantized_qmax(bits) == jqz.quantized_qmax(bits)
        for ranks in (1, 2, 18, 19, 258, 259, 4681, 4682, 1 << 20):
            got = qz.quantized_acc_dtype(bits, ranks)
            want = jqz.quantized_acc_dtype_np(bits, ranks)
            assert torch.empty(0, dtype=got).numpy().dtype == want
    with pytest.raises(ValueError):
        qz.quantized_qmax(2)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.ones(300)
    with pytest.raises(TypeError):
        qk.quantize_blockwise(x.double())
    q, s = qk.quantize_blockwise(x)
    with pytest.raises(TypeError):                   # int4 codes expected
        qk.dequantize_blockwise_int4(q, s, 300)
    with pytest.raises(ValueError):                  # more than nb blocks
        qk.dequantize_blockwise(q, s, 513)
    with pytest.raises(TypeError):
        qk.dequantize_blockwise(q, s, 300, torch.int32)
    with pytest.raises(ValueError):                  # neither cpu nor cuda
        qk.quantize_blockwise(torch.ones(300, device="meta"))
    q0, s0 = qk.quantize_blockwise(torch.ones(0))
    assert q0.numel() == 0 and s0.numel() == 0
    assert qk.dequantize_blockwise(q0, s0, 0).numel() == 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """nvcc failing is an error, never a quiet switch to the plain
    version."""
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load("hvd_quantize_failing", ["quantize.cu"])
    assert "hvd_quantize_failing" not in _build._libs
