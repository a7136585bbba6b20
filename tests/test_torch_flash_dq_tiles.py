"""The arithmetic of the Hopper dq kernel (B7, ``flash_dq_sm90_kernel`` of
ops/csrc/flash_sm90.cu), emulated in plain torch, against the port's
plain version and the JAX package's Pallas kernel on the same
numpy-seeded inputs.

The kernel runs only on the card, so this emulation repeats, on the CPU,
the algorithm and the roundings it commits to: 128-row query tiles
walking 128-key tiles over the loop bounds of pallas_kernels.py:323-327,
p = exp2(fma(s, scale * log2 e, -lse * log2 e)) (one rounding, with
lse * log2 e rounded once to f32), masked p set to 0 explicitly,
dS = p (dp - delta) in f32 and cast to the input dtype before the
dQ += T(dS) . K product, dQ accumulated in f32 and multiplied by the
scale once at the end.

It is held to the plain version under the rule the card holds the kernel
to (``flash_attention.error_ratio`` with ``rss_dq`` and ``noise_dq``,
unchanged): bf16 and f16, D 64 and 128, S 128, 300 and 1000, windows
None, 1, 100 and S - 1.  At S <= 300 it is also held, under the same
rule, to the Pallas kernel run in interpret mode.  A mutant that leaves
delta out of dS shows what the rule refuses.
"""

import math

import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_kernels as pk
from horovod_tpu_torch.ops import flash_attention as fa

from test_torch_flash_tiles import DTYPES, LOG2E, _inputs, _jax_block, _mask

#: the kernel's tiles (flash_sm90.cu DqCfg): query rows, key rows
BQ, BK = 128, 128


def emulate_dq(q, k, v, dout, lse, delta, window, fault=None):
    """B7's arithmetic: ``dq``.  ``fault="delta"`` leaves delta out of
    dS (dS = p dp)."""
    BH, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    c = torch.tensor(LOG2E * scale, dtype=torch.float32)
    nl = -(lse * torch.tensor(LOG2E, dtype=torch.float32))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    dps = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    pos = torch.arange(S)
    dq = torch.empty_like(q)
    for q0 in range(0, S, BQ):
        rows = slice(q0, q0 + BQ)
        acc = torch.zeros(BH, len(pos[rows]), D)
        kt_end = min(-(-S // BK), (q0 + BQ - 1) // BK + 1)
        kt_begin = max(0, q0 - window + 1) // BK if window else 0
        for k0 in range(kt_begin * BK, kt_end * BK, BK):
            keys = slice(k0, k0 + BK)
            vis = _mask(pos[rows], pos[keys], S, window)
            # the kernel's FFMA: s * c - lse * log2 e rounded once
            p = torch.exp2((scores[:, rows, keys].double() * c.double()
                            + nl[:, rows, None].double()).float())
            p = torch.where(vis, p, 0.0)
            dp = dps[:, rows, keys]
            ds = p * dp if fault == "delta" else \
                p * (dp - delta[:, rows, None])
            acc += torch.matmul(ds.to(q.dtype).float(), k[:, keys].float())
        dq[:, rows] = (acc * scale).to(q.dtype)
    return dq


CASES = [(name, D, S, window)
         for name in DTYPES for D in (64, 128) for S in (128, 300, 1000)
         for window in (None, 1, 100, S - 1)]


@pytest.mark.parametrize("dtype_name,D,S,window", CASES)
def test_dq_tiles_match_plain_and_pallas(dtype_name, D, S, window):
    dtype = DTYPES[dtype_name][0]
    arrs, (q, k, v, dout) = _inputs(dtype_name, 2, S, D, seed=S + D + 2)
    out, lse = fa.plain_flash_fwd(q, k, v, window)
    with_jax = S <= 300
    if with_jax:
        # the Pallas forward's out and lse feed both backward passes
        b = _jax_block(S)
        j_out, j_lse = pk._flash_fwd_call(*arrs[:3], b, b, window, True)
        j_dq, _, _ = pk._flash_vjp_bwd(b, b, b, b, window, True,
                                       (*arrs[:3], j_out, j_lse), arrs[3])
        out = torch.from_numpy(np.asarray(j_out, np.float32)).to(dtype)
        lse = torch.from_numpy(np.array(j_lse)[:, 0])
    delta = (dout.float() * out.float()).sum(-1)
    sc = fa.plain_error_scales(q, k, v, dout, out, lse, delta, window)
    got = emulate_dq(q, k, v, dout, lse, delta, window)
    refs = [fa.plain_flash_bwd_dq(q, k, v, dout, lse, delta, window)]
    if with_jax:
        refs.append(torch.from_numpy(np.asarray(j_dq, np.float32)).to(dtype))
    for ref in refs:
        assert fa.error_ratio(got, ref, dtype, sc["rss_dq"],
                              sc["noise_dq"])[1] <= 1.0


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("window", [None, 100])
def test_rule_refuses_delta_left_out_of_ds(dtype_name, window):
    dtype = DTYPES[dtype_name][0]
    _, (q, k, v, dout) = _inputs(dtype_name, 2, 300, 64, seed=33)
    out, lse = fa.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * out.float()).sum(-1)
    sc = fa.plain_error_scales(q, k, v, dout, out, lse, delta, window)
    want = fa.plain_flash_bwd_dq(q, k, v, dout, lse, delta, window)
    assert fa.error_ratio(emulate_dq(q, k, v, dout, lse, delta, window),
                          want, dtype, sc["rss_dq"], sc["noise_dq"])[1] <= 1.0
    bad = emulate_dq(q, k, v, dout, lse, delta, window, fault="delta")
    assert fa.error_ratio(bad, want, dtype, sc["rss_dq"],
                          sc["noise_dq"])[1] > 1.0
