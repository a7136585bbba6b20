"""The arithmetic of the Hopper flash kernels (ops/csrc/flash_sm90.cu),
emulated in plain torch, against the port's plain versions and the JAX
package's Pallas kernels on the same numpy-seeded inputs.

The kernels run only on the card, so these emulations repeat, on the
CPU, the algorithm and the roundings each one commits to:

* the forward (B6): 128-row query tiles walking 128-key tiles from the
  kernel's first tile, an online softmax in the exp2 domain (the running
  max is the tile's max over its visible raw scores times
  scale * log2 e, and p = exp2(fma(s, scale * log2 e, -m)), one rounding),
  masked p set to 0 explicitly, p cast to the input dtype per tile
  before p . v, and lse = m * ln 2 + log(max(l, 1e-30));
* the dk/dv backward (B8): 128-key tiles walking 64-row query tiles,
  transposed scores K . Q^T and V . dO^T per query tile,
  p^T = exp2(s^T * scale * log2 e - lse * log2 e), zeroed where masked,
  ds^T = p^T (dp^T - delta), and T(p^T), T(ds^T) cast before the dv and
  dk products; dk times scale at the end.

Each emulation is held to the plain version under the rule the card
holds the kernels to (``flash_attention.error_ratio``, unchanged): bf16
and f16, D 64 and 128, S 128, 300 and 1000, windows None, 1, 100 and
S - 1.  At S <= 300, D 64 and windows None and 100 it is also held, under
the same rule, to the Pallas kernel run in interpret mode, as
tests/test_torch_flash.py runs it.  Two mutants of the forward show what
the rule refuses.
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import flash_attention as fa

LOG2E = 1.4426950408889634
NEG_INF = -1e30
DTYPES = {"bf16": (torch.bfloat16, ml_dtypes.bfloat16),
          "f16": (torch.float16, np.float16)}


def _inputs(dtype_name, BH, S, D, seed, n=4):
    """``n`` (BH, S, D) arrays rounded to the dtype, as numpy (for JAX)
    and torch tensors holding the same values."""
    tdt, ndt = DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((BH, S, D)).astype(np.float32).astype(ndt)
            for _ in range(n)]
    return arrs, [torch.from_numpy(a.astype(np.float32)).to(tdt)
                  for a in arrs]


def _mask(rows, cols, S, window):
    diff = rows[:, None] - cols[None, :]
    vis = (diff >= 0) & (cols[None, :] < S) & (rows[:, None] < S)
    if window:
        vis = vis & (diff < window)
    return vis


def emulate_fwd(q, k, v, window, fault=None, BQ=128, BK=128):
    """B6's arithmetic: ``(out, lse)``.  ``fault="masked_p"`` leaves
    masked p at exp2(s * scale * log2 e - m); ``fault="alpha"`` drops
    the rescale of the running sum and output."""
    BH, S, D = q.shape
    c = torch.tensor(LOG2E / math.sqrt(D), dtype=torch.float32)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    pos = torch.arange(S)
    out = torch.empty_like(q)
    lse = torch.empty(BH, S)
    for q0 in range(0, S, BQ):
        rows = pos[q0:q0 + BQ]
        m = torch.full((BH, len(rows)), NEG_INF)
        l = torch.zeros(BH, len(rows))
        o = torch.zeros(BH, len(rows), D)
        kt_end = min(-(-S // BK), (q0 + BQ - 1) // BK + 1)
        kt_begin = max(0, q0 - window + 1) // BK if window else 0
        for k0 in range(kt_begin * BK, kt_end * BK, BK):
            vis = _mask(rows, pos[k0:k0 + BK], S, window)
            raw = scores[:, q0:q0 + BQ, k0:k0 + BK]
            m_new = torch.maximum(
                m, torch.where(vis, raw, NEG_INF).amax(-1) * c)
            alpha = torch.exp2(m - m_new)
            # the kernel's FFMA: s * c - m rounded once (exact in f64)
            p = torch.exp2((raw.double() * c.double()
                            - m_new.double()[..., None]).float())
            if fault != "masked_p":
                p = torch.where(vis, p, 0.0)
            if fault != "alpha":
                l, o = l * alpha, o * alpha[..., None]
            l = l + p.sum(-1)
            o = o + torch.matmul(p.to(v.dtype).float(),
                                 v[:, k0:k0 + BK].float())
            m = m_new
        lc = l.clamp_min(1e-30)
        out[:, q0:q0 + BQ] = (o / lc[..., None]).to(q.dtype)
        lse[:, q0:q0 + BQ] = m * math.log(2.0) + torch.log(lc)
    return out, lse


def emulate_dkv(q, k, v, dout, lse, delta, window, BK=128, BQ=64):
    """B8's arithmetic: ``(dk, dv)``."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    c = torch.tensor(LOG2E * scale, dtype=torch.float32)
    lse2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    pos = torch.arange(S)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, S, BK):
        keys = slice(k0, k0 + BK)
        kt, vt = k[:, keys].float(), v[:, keys].float()
        acc_k = torch.zeros(BH, kt.shape[1], D)
        acc_v = torch.zeros(BH, kt.shape[1], D)
        qt_end = -(-S // BQ)
        if window:
            qt_end = min(qt_end, (k0 + BK - 1 + window - 1) // BQ + 1)
        for q0 in range(k0 // BQ * BQ, qt_end * BQ, BQ):
            qs = slice(q0, q0 + BQ)
            vis_t = _mask(pos[qs], pos[keys], S, window).T
            st = torch.matmul(kt, q[:, qs].float().transpose(-1, -2))
            dpt = torch.matmul(vt, dout[:, qs].float().transpose(-1, -2))
            pt = torch.where(vis_t, torch.exp2(st * c - lse2[:, None, qs]),
                             0.0)
            dst = pt * (dpt - delta[:, None, qs])
            acc_v += torch.matmul(pt.to(dout.dtype).float(),
                                  dout[:, qs].float())
            acc_k += torch.matmul(dst.to(q.dtype).float(), q[:, qs].float())
        dk[:, keys] = (acc_k * scale).to(k.dtype)
        dv[:, keys] = acc_v.to(v.dtype)
    return dk, dv


def _jax_block(S):
    return 64 if S == 128 else 100


CASES = [(name, D, S, window)
         for name in DTYPES for D in (64, 128) for S in (128, 300, 1000)
         for window in (None, 1, 100, S - 1)]


def _with_jax(D, S, window):
    return S <= 300 and D == 64 and window in (None, 100)


@pytest.mark.parametrize("dtype_name,D,S,window", CASES)
def test_fwd_tiles_match_plain_and_pallas(dtype_name, D, S, window):
    dtype = DTYPES[dtype_name][0]
    arrs, (q, k, v, dout) = _inputs(dtype_name, 2, S, D, seed=S + D)
    want, want_lse = fa.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * want.float()).sum(-1)
    sc = fa.plain_error_scales(q, k, v, dout, want, want_lse, delta, window)
    got, got_lse = emulate_fwd(q, k, v, window)
    assert fa.error_ratio(got, want, dtype, sc["rss_out"])[1] <= 1.0
    assert fa.error_ratio(got_lse, want_lse, torch.float32)[1] <= 1.0
    if _with_jax(D, S, window):
        b = _jax_block(S)
        j_out, j_lse = pk._flash_fwd_call(*arrs[:3], b, b, window, True)
        j_out = torch.from_numpy(np.asarray(j_out, np.float32)).to(dtype)
        j_lse = torch.from_numpy(np.array(j_lse)[:, 0])
        assert fa.error_ratio(got, j_out, dtype, sc["rss_out"])[1] <= 1.0
        assert fa.error_ratio(got_lse, j_lse, torch.float32)[1] <= 1.0


@pytest.mark.parametrize("dtype_name,D,S,window", CASES)
def test_dkv_tiles_match_plain_and_pallas(dtype_name, D, S, window):
    dtype = DTYPES[dtype_name][0]
    arrs, (q, k, v, dout) = _inputs(dtype_name, 2, S, D, seed=S + D + 1)
    out, lse = fa.plain_flash_fwd(q, k, v, window)
    if _with_jax(D, S, window):
        # the Pallas forward's out and lse feed both backward passes
        b = _jax_block(S)
        j_out, j_lse = pk._flash_fwd_call(*arrs[:3], b, b, window, True)
        _, j_dk, j_dv = pk._flash_vjp_bwd(b, b, b, b, window, True,
                                          (*arrs[:3], j_out, j_lse),
                                          arrs[3])
        out = torch.from_numpy(np.asarray(j_out, np.float32)).to(dtype)
        lse = torch.from_numpy(np.array(j_lse)[:, 0])
    delta = (dout.float() * out.float()).sum(-1)
    sc = fa.plain_error_scales(q, k, v, dout, out, lse, delta, window)
    got_dk, got_dv = emulate_dkv(q, k, v, dout, lse, delta, window)
    want_dk, want_dv = fa.plain_flash_bwd_dkv(q, k, v, dout, lse, delta,
                                              window)
    refs = [(want_dk, want_dv)]
    if _with_jax(D, S, window):
        refs.append(tuple(torch.from_numpy(np.asarray(t, np.float32))
                          .to(dtype) for t in (j_dk, j_dv)))
    for ref_dk, ref_dv in refs:
        assert fa.error_ratio(got_dk, ref_dk, dtype, sc["rss_dk"],
                              sc["noise_dk"])[1] <= 1.0
        assert fa.error_ratio(got_dv, ref_dv, dtype, sc["rss_dv"])[1] <= 1.0


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("window", [None, 100])
def test_rule_refuses_a_dropped_alpha_rescale(dtype_name, window):
    dtype = DTYPES[dtype_name][0]
    _, (q, k, v, dout) = _inputs(dtype_name, 2, 300, 64, seed=31)
    want, lse = fa.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * want.float()).sum(-1)
    sc = fa.plain_error_scales(q, k, v, dout, want, lse, delta, window)
    bad, _ = emulate_fwd(q, k, v, window, fault="alpha")
    assert fa.error_ratio(bad, want, dtype, sc["rss_out"])[1] > 1.0


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("window", [None, 100])
def test_rule_refuses_masked_p_taken_as_exp2_of_s_minus_m(dtype_name,
                                                         window):
    """Masked p must be 0 explicitly.  Taken as exp2(s * c - m) it adds
    the future keys of each diagonal tile (window None), and, while a
    row's running max is still the -1e30 sentinel on a tile wholly
    outside its window, exp2 of about +1e29 = inf, which the first
    visible tile's alpha = 0 turns into NaN (0 * inf) rather than
    wiping (window 100)."""
    dtype = DTYPES[dtype_name][0]
    _, (q, k, v, dout) = _inputs(dtype_name, 2, 300, 64, seed=32)
    want, lse = fa.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * want.float()).sum(-1)
    sc = fa.plain_error_scales(q, k, v, dout, want, lse, delta, window)
    bad, _ = emulate_fwd(q, k, v, window, fault="masked_p")
    assert fa.error_ratio(bad, want, dtype, sc["rss_out"])[1] > 1.0
    if window:
        assert torch.isnan(bad[:, 227:256]).all()
