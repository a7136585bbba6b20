"""horovod_tpu_torch.ops.flash_attention against the JAX package's
Pallas flash attention (interpret mode) and dense attention, on the same
numpy-seeded inputs.

On the CPU every wrapper takes its kernel's plain version, so these
tests hold the plain versions (and the autograd Function around them) to
the Pallas kernels; tests/test_torch_cuda_flash.py holds the CUDA
kernels to the plain versions on the card.

Tolerances.  f32: 2e-5 on values and 5e-5 on gradients, as
tests/test_pallas.py holds the Pallas kernels to dense attention
(summation order only; the port's plain forward takes one softmax over
the whole row where the kernel takes it tile by tile).  bf16: 2**-6 of
the largest magnitude of the reference tensor, two bf16 ulps at the
outputs' scale: the port rounds the probabilities to bf16 after
normalising by the row maximum, the Pallas kernel by the running
maximum of each tile, so single products differ by up to one bf16 ulp
before the final rounding adds another; and over each tensor a relative
L2 distance of at most 1e-2, which a fault on many rows exceeds however
small the rows' values are against the largest.  The rule the card
holds the CUDA kernels to (``error_ratio``, elementwise at each value's
own scale) is tested at the end of this file."""

from functools import partial

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.models.transformer import \
    dense_causal_attention as jax_dense
from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.models.transformer import dense_causal_attention
from horovod_tpu_torch.ops import flash_attention as fa

F32_TOL, F32_GRAD_TOL = 2e-5, 5e-5


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32).astype(dtype)
            for _ in range(3)]


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def _port_grads(fn, q, k, v):
    """Values and gradients of sum(fn(q, k, v)**2) through the port."""
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    (out.float() ** 2).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _jax_grads(fn, q, k, v):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)
    out = fn(q, k, v)
    return np.asarray(out, np.float32), [
        np.asarray(g, np.float32)
        for g in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("S,H,D,blocks", [
    (64, 2, 16, dict(block_q=16, block_k=16)),       # dividing
    (24, 1, 8, {}),                                   # default blocks fall back
    (12, 1, 8, {}),
    (32, 1, 8, dict(block_q=8, block_k=16)),          # uneven blocks
])
def test_flash_matches_pallas_and_dense(S, H, D, blocks):
    q, k, v = _qkv((2, S, H, D), seed=S)
    got = _np(fa.flash_attention(_t(q), _t(k), _t(v), **blocks))
    pallas = np.asarray(pk.flash_attention(q, k, v, interpret=True,
                                           **blocks))
    dense = np.asarray(jax_dense(q, k, v))
    _close(got, pallas, F32_TOL)
    _close(got, dense, F32_TOL)


@pytest.mark.parametrize("bq,bk,W", [
    (16, 16, 1), (16, 16, 5), (32, 8, 16), (8, 32, 17), (16, 16, 63),
    (16, 16, 64), (32, 8, 200), (16, 16, None)])
def test_flash_values_and_grads_match_pallas(bq, bk, W):
    """Windows at every block-boundary case (W < block, W % block != 0,
    W = S, W > S degenerating to full causal), values and dq/dk/dv."""
    q, k, v = _qkv((2, 64, 2, 8), seed=7)
    out, grads = _port_grads(partial(fa.flash_attention, block_q=bq,
                                     block_k=bk, window=W), q, k, v)
    ref_out, ref_grads = _jax_grads(partial(
        pk.flash_attention, block_q=bq, block_k=bk, window=W,
        interpret=True), q, k, v)
    _close(out, ref_out, F32_TOL, f"W={W}")
    for g, r in zip(grads, ref_grads):
        _close(g, r, F32_GRAD_TOL, f"W={W}")
    dense_w = W if W is not None and W < 64 else None
    _, dense_grads = _jax_grads(partial(jax_dense, window=dense_w),
                                q, k, v)
    for g, r in zip(grads, dense_grads):
        _close(g, r, F32_GRAD_TOL, f"dense W={W}")


def test_flash_independent_bwd_blocks():
    q = _qkv((1, 64, 2, 8), seed=3)[0]
    _, grads = _port_grads(partial(fa.flash_attention, block_q=16,
                                   block_k=16, bwd_block_q=32,
                                   bwd_block_k=8), q, q, q)
    _, ref = _jax_grads(partial(pk.flash_attention, block_q=16, block_k=16,
                                bwd_block_q=32, bwd_block_k=8,
                                interpret=True), q, q, q)
    _close(sum(grads), sum(ref), F32_GRAD_TOL)


def test_flash_bf16_matches_pallas():
    q, k, v = _qkv((1, 64, 2, 16), seed=11, dtype=ml_dtypes.bfloat16)
    out, grads = _port_grads(partial(fa.flash_attention, window=20),
                             q, k, v)
    ref_out, ref_grads = _jax_grads(partial(
        pk.flash_attention, block_q=16, block_k=16, window=20,
        interpret=True), *(jnp.asarray(a) for a in (q, k, v)))
    for got, want in zip([out, *grads], [ref_out, *ref_grads]):
        bound = 2.0 ** -6 * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("window", [None, 5])
def test_plain_kernels_match_pallas_kernels(window):
    """Each kernel's plain version against its Pallas kernel on the same
    (BH, S, D) inputs, lse and delta included."""
    BH, S, D = 3, 32, 8
    q, k, v = _qkv((BH, S, D), seed=5)
    dout = _qkv((BH, S, D), seed=6)[0]
    out, lse = fa.flash_fwd(_t(q), _t(k), _t(v), window)
    ref_out, ref_lse = pk._flash_fwd_call(q, k, v, 8, 16, window, True)
    _close(_np(out), np.asarray(ref_out), F32_TOL)
    _close(_np(lse), np.asarray(ref_lse)[:, 0], F32_TOL)
    dq, dk, dv = pk._flash_vjp_bwd(8, 16, 16, 8, window, True,
                                   (q, k, v, ref_out, ref_lse), dout)
    delta = (_t(dout) * out).sum(-1)
    got_dq = fa.flash_bwd_dq(_t(q), _t(k), _t(v), _t(dout), lse, delta,
                             window)
    got_dk, got_dv = fa.flash_bwd_dkv(_t(q), _t(k), _t(v), _t(dout), lse,
                                      delta, window)
    for g, r in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        _close(_np(g), np.asarray(r), F32_GRAD_TOL)


@pytest.mark.parametrize("window,offset", [(None, 0), (7, 0), (None, 5)])
def test_dense_attention_matches_jax(window, offset):
    q, k, v = _qkv((2, 16, 2, 8), seed=9)
    got = dense_causal_attention(_t(q), _t(k), _t(v), offset=offset,
                                 window=window)
    want = jax_dense(q, k, v, offset=offset, window=window)
    _close(_np(got), np.asarray(want), F32_TOL)


def _tiled_fwd(q, k, v, window, fault=None, tile=64):
    """The forward kernel's online softmax in plain torch: key tiles of
    ``tile``, p cast to v's dtype against the running maximum.  ``fault``
    drops the rescale of the running output (``"o"``) or of the running
    sum (``"l"``)."""
    BH, S, D = q.shape
    s_all = torch.matmul(q.float(), k.float().transpose(-1, -2)) / D ** 0.5
    mask = fa._visible(S, window, q.device)
    m = torch.full((BH, S), -1e30)
    l = torch.zeros(BH, S)
    o = torch.zeros(BH, S, D)
    for k0 in range(0, S, tile):
        vis = mask[:, k0:k0 + tile]
        s = torch.where(vis, s_all[..., k0:k0 + tile], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        l = (l if fault == "l" else l * alpha) + p.sum(-1)
        o = o if fault == "o" else o * alpha[..., None]
        o = o + torch.matmul(p.to(v.dtype).float(), v[:, k0:k0 + tile].float())
        m = m_new
    l = l.clamp_min(1e-30)
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def _rule_inputs(dtype, window, seed):
    g = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(2, 300, 64, generator=g).to(dtype)
                     for _ in range(4))
    out, lse = fa.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * out.float()).sum(-1)
    scales = fa.plain_error_scales(q, k, v, dout, out, lse, delta, window)
    return q, k, v, dout, out, lse, delta, scales


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("window", [None, 100])
def test_error_rule_holds_online_softmax_and_catches_a_lost_rescale(
        dtype, window):
    """The bound the card holds the forward kernel to (error_ratio) takes
    the kernel's own rounding, p cast against each tile's running
    maximum, and refuses a kernel that loses a rescale."""
    q, k, v, _, want, lse, _, scales = _rule_inputs(dtype, window, 21)
    got, got_lse = _tiled_fwd(q, k, v, window)
    assert not torch.equal(got, want)
    assert fa.error_ratio(got, want, dtype, scales["rss_out"])[1] <= 1.0
    assert fa.error_ratio(got_lse, lse, torch.float32)[1] <= 1.0
    for fault in ("o", "l"):
        bad, _ = _tiled_fwd(q, k, v, window, fault)
        assert fa.error_ratio(bad, want, dtype, scales["rss_out"])[1] > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_error_rule_catches_a_backward_mask_off_by_one(dtype):
    """dq, dk and dv of a backward that lets each query see one key too
    many exceed the bound; the right ones are within it."""
    q, k, v, dout, _, lse, delta, scales = _rule_inputs(dtype, 100, 22)
    want = [fa.plain_flash_bwd_dq(q, k, v, dout, lse, delta, 100),
            *fa.plain_flash_bwd_dkv(q, k, v, dout, lse, delta, 100)]
    bad = [fa.plain_flash_bwd_dq(q, k, v, dout, lse, delta, 101),
           *fa.plain_flash_bwd_dkv(q, k, v, dout, lse, delta, 101)]
    for name, w, b in zip(("dq", "dk", "dv"), want, bad):
        rss, noise = scales["rss_" + name], scales.get("noise_" + name)
        assert fa.error_ratio(w, w, dtype, rss, noise)[1] == 0.0
        assert fa.error_ratio(b, w, dtype, rss, noise)[1] > 1.0, name


def test_flash_refuses_what_jax_refuses():
    q = torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, q, q, window=0)
    prime = torch.zeros(1, 1031, 1, 8)
    with pytest.raises(ValueError, match="no block divisor"):
        fa.flash_attention(prime, prime, prime)
    # window >= S is full causal
    a = fa.flash_attention(q + 1, q, q, window=16)
    b = fa.flash_attention(q + 1, q, q)
    assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version_and_wrappers_check():
    fa.reset_launches()
    x = torch.ones(2, 8, 8)
    fa.flash_fwd(x, x, x)
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0}
    with pytest.raises(TypeError):
        fa.flash_fwd(x.double(), x.double(), x.double())
    with pytest.raises(ValueError):                     # shapes differ
        fa.flash_fwd(x, x[:, :4], x[:, :4])
    with pytest.raises(ValueError):                     # not contiguous
        fa.flash_fwd(x.transpose(1, 2), x, x)
    with pytest.raises(ValueError):                     # lse not (BH, S)
        fa.flash_bwd_dq(x, x, x, x, torch.zeros(2, 7), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="window"):
        fa.flash_bwd_dkv(x, x, x, x, torch.zeros(2, 8), torch.zeros(2, 8),
                         window=0)
