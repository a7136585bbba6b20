"""The arithmetic of the Hopper conv+BN kernels (B9 ``conv_bn_fwd_sm90_kernel``,
B10 ``conv_bn_dx_sm90_kernel`` and ``conv_bn_dw_sm90_kernel`` of
ops/csrc/conv_bn_sm90.cu), emulated in plain torch, against the port's
plain versions and the JAX package's Pallas kernels on the same
numpy-seeded inputs.

The kernels run only on the card, so this emulation repeats, on the CPU,
the algorithm and the order of every sum they commit to, from the plan
the route computes (``conv_bn.sm90_plan``): products in 64-deep chunks
added in order; statistics per 128-row tile through the kernels' tree (a
thread's rows r and r + 8, a butterfly over the eight lane rows, the
eight consumer warps in order), the tiles of a CTA in order, then the
CTAs' rows through ``colsum_kernel``'s order; rows past M left out;
``ytot`` rounded to bf16 before both products; dw summed per M split and
the splits through ``colsum_kernel``'s order.

It is held to the plain versions under the rule the card holds the
kernels to (``conv_bn.fwd_error`` / ``bwd_error`` with the sm90 route's
depths), and to the Pallas kernels in interpret mode under the
reassociation bounds of tests/test_torch_conv_bn.py, with two ulps of
bf16 on y and dx as ``fwd_error`` allows (two f32 sums a hair apart can
round to neighbours a binade apart, one ulp of the larger).  Three
mutants show what the rule refuses: the tail's relu(b) rows counted in s1/s2, ytot
left unrounded, and the fold's mask dropped from dx.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_conv_bn as P
from horovod_tpu_torch.ops import conv_bn as C

from test_torch_conv_bn import (EPS, _bwd_bounds, _inputs, _jax, _np,
                                _torch, _ulp_bf16)

BF16 = torch.bfloat16
#: conv_bn_sm90.cu: rows of a forward/dx tile, depth of a chunk
ROWS, CHUNK = 128, 64


def colsum(part):
    """colsum_kernel's order over the rows of ``part`` (rows, cols):
    eight interleaved row sums (rows j, j + 8, ...) from 0, then added
    in order."""
    sums = []
    for j in range(8):
        s = torch.zeros(part.shape[1])
        for r in range(j, part.shape[0], 8):
            s = s + part[r]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def tile_sums(v):
    """One 128-row tile's column sums, ``v`` (tiles, 128, W) f32: each
    warp's rows r and r + 8, then the lane rows pairwise (r ^ 1, ^ 2,
    ^ 4), then the eight warps in order."""
    t = v.reshape(v.shape[0], 8, 2, 8, v.shape[-1])
    s = t[:, :, 0] + t[:, :, 1]
    s = s[:, :, 0::2] + s[:, :, 1::2]
    s = s[:, :, 0::2] + s[:, :, 1::2]
    s = s[:, :, 0] + s[:, :, 1]
    out = s[:, 0]
    for w in range(1, 8):
        out = out + s[:, w]
    return out


def cta_stats(v, cta_rows):
    """Statistics of per-row values ``v`` (M, W): zero-padded to whole
    tiles, each tile's tree, CTA p's tiles p, p + P, ... in order, then
    the CTAs' rows through colsum."""
    m, width = v.shape
    mt = -(-m // ROWS)
    pad = torch.zeros(mt * ROWS, width)
    pad[:m] = v
    tiles = tile_sums(pad.reshape(mt, ROWS, width))
    part = torch.zeros(cta_rows, width)
    for p in range(cta_rows):
        for t in range(p, mt, cta_rows):
            part[p] = part[p] + tiles[t]
    return colsum(part)


def chunked(a, b, depth):
    """``a @ b`` (f32) as 64-deep chunks of the contraction added in
    order."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for c in range(0, depth, CHUNK):
        out = out + a[:, c:c + CHUNK] @ b[c:c + CHUNK]
    return out


def emulate_fwd(x, a, b, w, fold, fault=None):
    """B9 on the sm90 route: ``(y, s1, s2)``.  ``fault="tail"`` sums the
    rows past M too (the fold turns their zeros into relu(b))."""
    m, k = x.shape
    n = w.shape[1]
    plan = C.sm90_plan(m, k, n)
    if fault == "tail":
        x = torch.cat([x, torch.zeros(plan["mt"] * ROWS - m, k,
                                      dtype=x.dtype)])
    xh = (C._fold_input(x, a, b) if fold else x).float()
    y32 = chunked(xh, w.float(), k)
    s1 = cta_stats(y32, plan["fwd_p"])
    s2 = cta_stats(y32 * y32, plan["fwd_p"])
    return y32[:m].to(x.dtype), s1, s2


def emulate_bwd(x, a, b, w, y, dy, ds1, ds2, fold, fault=None):
    """B10 on the sm90 route: ``(dx, dw, da, db)``.  ``fault="ytot"``
    leaves ytot unrounded, ``fault="mask"`` drops the fold's mask from
    dx."""
    m, k = x.shape
    n = w.shape[1]
    plan = C.sm90_plan(m, k, n)
    yt = dy.float() + ds1 + 2.0 * y.float() * ds2
    if fault != "ytot":
        yt = yt.to(BF16).float()
    dxh = chunked(yt, w.float().t(), n)
    if fold:
        pre = x.float() * a + b
        xh = torch.relu(pre).to(BF16).float()
        dxm = dxh if fault == "mask" else dxh * (pre > 0.0).float()
        dx = (dxm * a).to(x.dtype)
        da = cta_stats(dxm * x.float(), plan["dx_p"])
        db = cta_stats(dxm, plan["dx_p"])
    else:
        xh = x.float()
        dx, da, db = dxh.to(x.dtype), None, None
    part = torch.zeros(plan["splits"], k * n)
    for s in range(plan["splits"]):
        rows = slice(s * plan["rows_per"], (s + 1) * plan["rows_per"])
        xs, ts = xh[rows], yt[rows]
        part[s] = chunked(xs.t(), ts, xs.shape[0]).reshape(-1)
    return dx, colsum(part).reshape(k, n), da, db


def _problem(m, k, n, seed, fold):
    rng, x, w, a, b = _inputs(m, k, n, "bf16", seed)
    xt, wt = _torch(x, "bf16"), _torch(w, "bf16")
    at, bt = torch.from_numpy(a[0]), torch.from_numpy(b[0])
    dy = _torch(rng.standard_normal((m, n)) * 1e-3, "bf16")
    ds1 = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-5)
    ds2 = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-5)
    return (x, w, a, b), (xt, at, bt, wt, dy, ds1, ds2)


# M 320: a 64-row tail (the second consumer warpgroup wholly past M);
# M 17000: 133 tiles, so a CTA walks two; K 192: dw's second 128-wide k
# tile has one warpgroup; N 320: 64-wide tiles
PLAIN_SHAPES = [(320, 64, 64), (320, 64, 128), (320, 128, 64),
                (320, 128, 128), (17000, 64, 64), (1000, 192, 320),
                (3136, 512, 256)]


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("m,k,n", PLAIN_SHAPES)
def test_emulation_matches_plain_under_the_cards_rule(m, k, n, fold):
    _, (x, a, b, w, dy, ds1, ds2) = _problem(m, k, n, m + k + n, fold)
    assert C.route(x.dtype, k, n) == "sm90"
    fwd = emulate_fwd(x, a, b, w, fold)
    errs = C.fwd_error(x, a, b, w, fold, fwd)
    errs.update(C.bwd_error(x, a, b, w, fwd[0], dy, ds1, ds2, fold,
                            emulate_bwd(x, a, b, w, fwd[0], dy, ds1, ds2,
                                        fold)))
    assert max(r for _, r in errs.values()) <= 1.0, errs


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("k,n", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_emulation_matches_pallas_interpret(k, n, fold):
    m = 320
    (x, w, a, b), (xt, at, bt, wt, dyt, ds1t, ds2t) = _problem(
        m, k, n, 3 * k + n, fold)
    aj, bj = _jax(a, "f32"), _jax(b, "f32")
    y, s1, s2 = P._fwd_call(_jax(x, "bf16"), aj, bj, _jax(w, "bf16"), fold,
                            True)
    yt, s1t, s2t = emulate_fwd(xt, at, bt, wt, fold)
    want = _np(y)
    assert np.all(np.abs(_np(yt) - want) <= 2 * _ulp_bf16(want))
    for got_s, ref_s in ((s1t, s1), (s2t, s2)):
        np.testing.assert_allclose(_np(got_s), np.asarray(ref_s), rtol=1e-5,
                                   atol=1e-3)

    # the card's cotangent scales (dy 1e-3, ds1 and ds2 1e-5): XLA on the
    # CPU may contract ytot's (2y)*ds2 + (dy + ds1) into an fma, which can
    # move ytot's bf16 rounding by an ulp; at these scales that stays far
    # inside dx's two ulps
    dy, ds1, ds2 = _np(dyt), _np(ds1t), _np(ds2t)
    ref = P._bwd_call(_jax(x, "bf16"), aj, bj, _jax(w, "bf16"), y,
                      _jax(dy, "bf16"), _jax(ds1, "f32"), _jax(ds2, "f32"),
                      fold, True)
    yb = _torch(_np(y), "bf16")
    got = emulate_bwd(xt, at, bt, wt, yb, dyt, ds1t, ds2t, fold)
    ytot = _np((dyt.float() + ds1t + 2.0 * yb.float() * ds2t).to(BF16))
    dxm = _np(got[0]) / a if fold else None
    bounds = _bwd_bounds(x, a, b, w, ytot, dxm, fold)
    for name, g, r, bound in zip(("dx", "dw", "da", "db"), got, ref, bounds):
        if not fold and name in ("da", "db"):
            assert g is None
            continue
        r = _np(r).reshape(_np(g).shape)
        if name == "dx":
            bound = bound + 2 * EPS["bf16"] * np.abs(r)
        err = np.abs(_np(g) - r)
        assert np.all(err <= bound), (name, float(err.max()))


@pytest.mark.parametrize("m", [320, 1000])
def test_rule_refuses_tail_rows_in_the_statistics(m):
    _, (x, a, b, w, _, _, _) = _problem(m, 64, 128, 41, True)
    good = C.fwd_error(x, a, b, w, True, emulate_fwd(x, a, b, w, True))
    assert max(r for _, r in good.values()) <= 1.0
    bad = C.fwd_error(x, a, b, w, True,
                      emulate_fwd(x, a, b, w, True, fault="tail"))
    assert bad["s1"][1] > 1.0 and bad["s2"][1] > 1.0
    assert bad["y"][1] <= 1.0


@pytest.mark.parametrize("fold", [False, True])
def test_rule_refuses_unrounded_ytot(fold):
    _, (x, a, b, w, dy, ds1, ds2) = _problem(320, 128, 64, 43, fold)
    y = emulate_fwd(x, a, b, w, fold)[0]
    bad = C.bwd_error(x, a, b, w, y, dy, ds1, ds2, fold,
                      emulate_bwd(x, a, b, w, y, dy, ds1, ds2, fold,
                                  fault="ytot"))
    assert bad["dw"][1] > 1.0


def test_rule_refuses_a_dropped_mask():
    _, (x, a, b, w, dy, ds1, ds2) = _problem(320, 64, 64, 47, True)
    y = emulate_fwd(x, a, b, w, True)[0]
    bad = C.bwd_error(x, a, b, w, y, dy, ds1, ds2, True,
                      emulate_bwd(x, a, b, w, y, dy, ds1, ds2, True,
                                  fault="mask"))
    assert bad["dx"][1] > 1.0


# every distinct (M, K, N, fold) of a full-width ResNet-50 step at 64
# images per rank (chip_smoke.py fused_step_shapes)
STEP_SHAPES = [
    (200704, 64, 64), (200704, 64, 256), (200704, 256, 64),
    (200704, 256, 128), (50176, 128, 512), (50176, 512, 128),
    (50176, 512, 256), (12544, 256, 1024), (12544, 1024, 256),
    (12544, 1024, 512), (3136, 512, 2048), (3136, 2048, 512)]


@pytest.mark.parametrize("m,k,n", STEP_SHAPES)
def test_step_shapes_take_the_sm90_route_with_small_partials(m, k, n):
    """Every step shape in bf16 takes the sm90 route (f32 stays on WMMA);
    its plan covers M, keeps to one wave of CTAs where M allows, forms
    ytot at most 8 times, and writes fewer f32 dw partials than the
    WMMA route."""
    assert C.route(BF16, k, n) == "sm90"
    assert C.route(torch.float32, k, n) == "wmma"
    p = C.sm90_plan(m, k, n)
    assert p["mt"] * ROWS >= m > (p["mt"] - 1) * ROWS
    assert p["fwd_p"] * (n // p["fwd_bn"]) <= 132
    assert p["dx_p"] * (k // p["dx_bk"]) <= 132
    assert p["dw_tiles"] * p["splits"] <= 132
    assert p["rows_per"] % CHUNK == 0
    assert (p["splits"] - 1) * p["rows_per"] < m <= p["splits"] * p["rows_per"]
    assert k // p["dx_bk"] <= 8
    assert C.dw_partial_bytes(BF16, m, k, n) \
        < C.dw_partial_bytes(torch.float32, m, k, n)


def test_depths_follow_the_route():
    """fwd_error/bwd_error read the depths of the route the shape and
    dtype take: the WMMA kernels' for K = 96 (or f32), the sm90 plan's
    for K and N multiples of 64 in bf16."""
    m = 3136
    wmma = C._depths(BF16, m, 96, 80)
    assert wmma == C._depths(torch.float32, m, 96, 80)
    tile = C._TILE + C._colsum_depth(-(-m // C._TILE))
    rows_per = C._dw_rows_per(m, 96, 80)
    assert wmma == (tile, rows_per + C._colsum_depth(-(-m // rows_per)),
                    tile)
    p = C.sm90_plan(m, 512, 2048)
    assert C._depths(BF16, m, 512, 2048) == (
        11 + -(-p["mt"] // p["fwd_p"]) + C._colsum_depth(p["fwd_p"]),
        p["rows_per"] + C._colsum_depth(p["splits"]),
        11 + -(-p["mt"] // p["dx_p"]) + C._colsum_depth(p["dx_p"]))
