"""horovod_tpu_torch.ops.conv_bn against horovod_tpu.ops.pallas_conv_bn:
the fused 1x1-conv + BN op, its plain versions and its dispatch rule, on
the same numpy-seeded inputs.  The JAX side runs its Pallas kernels in
interpret mode, as its own tests do on the CPU.

Tolerances, per output element:

* forward ``y``: one bf16 ulp of the JAX value (both sides sum the same
  exact-in-f32 products in f32, in different orders, then round);
  ``s1``/``s2``: the JAX test's rtol 1e-5, atol 1e-3;
* backward: both sides round ``ytot`` to bf16 and multiply bf16 (or f32)
  operands with f32 sums, so they differ only by the order of those
  sums.  A sum of n terms in f32 lies within gamma(n) = n*u/(1 - n*u)
  (u = 2**-24) of the exact sum of the magnitudes, so two orders lie
  within 2*gamma(n+1)*sum|terms| of each other (n + 1: an f32 product is
  rounded too).  dx adds one ulp of its output dtype; ``da``/``db`` add
  what dx's error carries into them.  The bound is computed from the
  inputs (``_bwd_bounds``)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ops import pallas_conv_bn as P
from horovod_tpu.models import resnet as flax_resnet
from horovod_tpu_torch.ops import conv_bn as C
from horovod_tpu_torch.models.resnet import FoldedBN

U = 2.0 ** -24
EPS = {"bf16": 2.0 ** -7, "f32": 2.0 ** -23}
SHAPES = [(128, 32, 64), (96, 64, 32)]


def _gamma(n):
    return n * U / (1 - n * U)


def _ulp_bf16(v):
    """One bf16 ulp at |v| (the spacing of the binade holding v)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _inputs(m, k, n, dt, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    if dt == "bf16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        w = w.astype(ml_dtypes.bfloat16).astype(np.float32)
    a = rng.uniform(0.5, 1.5, (1, k)).astype(np.float32)
    b = rng.standard_normal((1, k)).astype(np.float32)
    return rng, x, w, a, b


def _jax(v, dt):
    return jnp.asarray(v).astype(jnp.bfloat16 if dt == "bf16"
                                 else jnp.float32)


def _torch(v, dt):
    return torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if dt == "bf16" else torch.float32)


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_forward_matches_pallas_interpret(m, k, n, fold, dt):
    _, x, w, a, b = _inputs(m, k, n, dt, seed=m + k + n)
    y, s1, s2 = P.conv1x1_bn(_jax(x, dt), _jax(w, dt),
                             fold=(jnp.asarray(a), jnp.asarray(b))
                             if fold else None,
                             interpret=True, use_pallas=True)
    yt, s1t, s2t = C.conv1x1_bn(
        _torch(x, dt), torch.from_numpy(w),
        fold=(torch.from_numpy(a), torch.from_numpy(b)) if fold else None)
    assert yt.dtype == _torch(x, dt).dtype and yt.shape == (m, n)
    want = _np(y)
    assert np.all(np.abs(_np(yt) - want) <= _ulp_bf16(want))
    np.testing.assert_allclose(_np(s1t), np.asarray(s1), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(_np(s2t), np.asarray(s2), rtol=1e-5,
                               atol=1e-3)


def _bwd_bounds(x, a, b, w, ytot, dxm, fold):
    """Per-element bounds of |port - JAX| for (dx, dw, da, db) from f32
    reassociation (module docstring), from float64 magnitudes."""
    m, k = x.shape
    n = w.shape[1]
    t = np.abs(ytot.astype(np.float64))
    xh = x.astype(np.float64)
    if fold:
        pre = xh * a + b
        xh = np.maximum(pre, 0).astype(np.float32).astype(
            ml_dtypes.bfloat16).astype(np.float64)
    e_dxh = 2 * _gamma(n + 1) * (t @ np.abs(w.astype(np.float64)).T)
    dw = 2 * _gamma(m + 1) * (np.abs(xh).T @ t)
    if not fold:
        return e_dxh, dw, None, None
    e_dxm = e_dxh
    absx = np.abs(x.astype(np.float64))
    da = (e_dxm * absx).sum(0) + 2 * _gamma(m + 1) * np.abs(
        dxm * x).sum(0)
    db = e_dxm.sum(0) + 2 * _gamma(m + 1) * np.abs(dxm).sum(0)
    return e_dxm * np.abs(a), dw, da, db


@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_backward_matches_pallas_interpret_and_bwd_xla(m, k, n, fold, dt):
    rng, x, w, a, b = _inputs(m, k, n, dt, seed=7 * m + k)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    y, _, _ = P._fwd_call(_jax(x, dt), aj, bj, _jax(w, dt), fold, True)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    ds1 = rng.standard_normal(n).astype(np.float32)
    ds2 = rng.standard_normal(n).astype(np.float32)
    refs = {
        "pallas": P._bwd_call(_jax(x, dt), aj, bj, _jax(w, dt), y,
                              _jax(dy, dt), jnp.asarray(ds1),
                              jnp.asarray(ds2), fold, True),
        "xla": P._bwd_xla(_jax(x, dt), aj, bj, _jax(w, dt), y, _jax(dy, dt),
                          jnp.asarray(ds1), jnp.asarray(ds2), fold)}
    yt = _torch(_np(y), dt)
    got = C.plain_bwd(_torch(x, dt), torch.from_numpy(a[0]),
                      torch.from_numpy(b[0]), _torch(w, dt), yt,
                      _torch(dy, dt), torch.from_numpy(ds1),
                      torch.from_numpy(ds2), fold)
    ytot = (_np(_torch(dy, dt)) + ds1 + 2.0 * _np(yt) * ds2).astype(
        np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)
    dxm = None
    if fold:
        dxm = _np(got[0]) / a  # dxm * a rounded; magnitudes only
    bounds = _bwd_bounds(x, a, b, w, ytot, dxm, fold)
    for label, ref in refs.items():
        for name, g, r, bound in zip(("dx", "dw", "da", "db"), got, ref,
                                     bounds):
            if not fold and name in ("da", "db"):
                assert g is None
                continue
            r = _np(r).reshape(_np(g).shape)
            if name == "dx":
                bound = bound + EPS[dt] * np.abs(r)
            err = np.abs(_np(g) - r)
            assert np.all(err <= bound), (
                f"{label} {name}: max |diff| {err.max()}, worst ratio "
                f"{(err / np.maximum(bound, 1e-30)).max()}")


@pytest.mark.parametrize("fold", [False, True])
def test_autograd_function_runs_the_plain_backward(fold):
    """On the CPU the differentiable op's gradients are plain_bwd's, bit
    for bit, with the cotangents of y, s1 and s2 combined; without a
    fold da and db are zeros (the JAX _vjp_bwd)."""
    rng, x, w, a, b = _inputs(64, 32, 48, "bf16", seed=11)
    xt = _torch(x, "bf16").requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    at = torch.from_numpy(a[0]).requires_grad_()
    bt = torch.from_numpy(b[0]).requires_grad_()
    y, s1, s2 = C.conv1x1_bn(xt, wt, fold=(at, bt) if fold else None)
    ry = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    r1 = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    r2 = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    ((y.float() * ry).sum() + (s1 * r1).sum() + (s2 * r2).sum()).backward()
    want = C.plain_bwd(xt.detach(), at.detach(), bt.detach(),
                       wt.detach().to(torch.bfloat16), y.detach(),
                       ry.to(torch.bfloat16), r1, r2, fold)
    assert torch.equal(xt.grad, want[0])
    assert torch.equal(wt.grad, want[1]) and wt.grad.dtype == torch.float32
    if fold:
        assert torch.equal(at.grad, want[2]) and torch.equal(bt.grad, want[3])
    else:
        assert at.grad is None and bt.grad is None


def test_dw_reaches_the_f32_parameter_unrounded():
    """Trap 1: the f32 master weight's gradient is the kernel's f32 dw,
    values bf16 cannot hold, as in JAX (whose custom VJP hands its f32 dw
    through w.astype(bf16)); autograd through w.to(bf16) would round."""
    rng, x, w, _, _ = _inputs(64, 32, 48, "bf16", seed=12)
    ry = rng.standard_normal((64, 48)).astype(np.float32)

    def loss_jax(w32):
        y, _, _ = P.conv1x1_bn(_jax(x, "bf16"), w32.astype(jnp.bfloat16),
                               interpret=True, use_pallas=True)
        return jnp.sum(y.astype(jnp.float32) * ry)

    gj = np.asarray(jax.grad(loss_jax)(jnp.asarray(w)))
    assert gj.dtype == np.float32
    assert np.any(gj.astype(ml_dtypes.bfloat16).astype(np.float32) != gj)

    wt = torch.from_numpy(w).requires_grad_()
    y, _, _ = C.conv1x1_bn(_torch(x, "bf16"), wt)
    (y.float() * torch.from_numpy(ry)).sum().backward()
    g = wt.grad
    assert g.dtype == torch.float32
    assert not torch.equal(g.to(torch.bfloat16).float(), g)
    # both are xh^T @ bf16(ry) in f32: f32 reassociation apart
    t = np.abs(ry.astype(ml_dtypes.bfloat16).astype(np.float64))
    bound = 2 * _gamma(65) * (np.abs(x.astype(np.float64)).T @ t)
    assert np.all(np.abs(g.numpy() - gj) <= bound)


def test_strided_and_unsupported_shapes_take_the_plain_path():
    """use_kernel=False and shapes supported_m refuses run the reference
    under autograd (counted in plain_calls): y rounded, the weight's
    gradient through w.to(x.dtype), as JAX differentiates _reference."""
    rng, x, w, _, _ = _inputs(17, 8, 16, "bf16", seed=13)
    C.reset_launches()
    for m, kw in ((17, {}), (64, {"use_kernel": False})):
        xt = _torch(rng.standard_normal((m, 8)), "bf16")
        wt = torch.from_numpy(w).requires_grad_()
        y, s1, s2 = C.conv1x1_bn(xt, wt, **kw)
        ry = torch.from_numpy(rng.standard_normal((m, 16)).astype(
            np.float32))
        (y.float() * ry).sum().backward()
        yr, s1r, s2r = C.reference(xt, torch.ones(8), torch.zeros(8),
                                   wt.detach().to(torch.bfloat16), False)
        assert torch.equal(y, yr) and torch.equal(s1, s1r)
        assert torch.equal(s2, s2r)
        # the bf16 weight's gradient, widened: bf16-representable
        assert torch.equal(wt.grad.to(torch.bfloat16).float(), wt.grad)
    assert C.plain_calls == {"conv1x1_bn": 2}
    assert C.launches == {"conv1x1_bn_fwd": 0, "conv1x1_bn_bwd": 0}
    C.reset_launches()


def test_wrappers_refuse_bad_inputs():
    x = torch.zeros(32, 8)
    w = torch.zeros(8, 16)
    a, b = torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError, match="do not match"):
        C.conv1x1_bn_fwd(x, a, b, torch.zeros(9, 16), False)
    with pytest.raises(TypeError, match="dtype"):
        C.conv1x1_bn_fwd(x, a, b, w.to(torch.bfloat16), False)
    with pytest.raises(ValueError, match="f32 values"):
        C.conv1x1_bn_fwd(x, a.double(), b, w, False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        C.conv1x1_bn_fwd(x.to("meta"), a.to("meta"), b.to("meta"),
                         w.to("meta"), False)
    with pytest.raises(ValueError, match="y and dy"):
        C.conv1x1_bn_bwd(x, a, b, w, torch.zeros(32, 15), torch.zeros(32, 16),
                         torch.zeros(16), torch.zeros(16), False)


def test_bn_fold_matches_jax():
    rng = np.random.default_rng(2)
    c, count = 16, 640
    y = (rng.standard_normal((count, c)) * 3 + 1.5).astype(np.float32)
    s1, s2 = y.sum(0), (y * y).sum(0)
    scale = np.linspace(0.5, 2.0, c, dtype=np.float32)
    bias = np.linspace(-1.0, 1.0, c, dtype=np.float32)
    aj, bj = P.bn_fold(jnp.asarray(s1), jnp.asarray(s2), count,
                       jnp.asarray(scale), jnp.asarray(bias))
    at, bt = C.bn_fold(*(torch.from_numpy(v) for v in (s1, s2)), count,
                       torch.from_numpy(scale), torch.from_numpy(bias))
    # elementwise f32 math on both sides; rsqrt may differ by an ulp
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=2e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=2e-6,
                               atol=1e-6)


@pytest.mark.parametrize("train", [True, False])
def test_folded_bn_matches_flax(train):
    """The fold and the running statistics of FoldedBN against flax's
    _FoldedBN, from the same scale, bias and statistics."""
    rng = np.random.default_rng(3)
    c, count = 12, 200
    y = (rng.standard_normal((count, c)) * 2 + 0.5).astype(np.float32)
    s1, s2 = y.sum(0), (y * y).sum(0)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(
                     np.float32),
                            "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(
                     np.float32),
                                 "var": rng.uniform(0.5, 1.5, c).astype(
                                     np.float32)}}
    mod = flax_resnet._FoldedBN(use_running_average=not train)
    (aj, bj), upd = mod.apply(variables, jnp.asarray(s1), jnp.asarray(s2),
                              count, mutable=["batch_stats"])
    bn = FoldedBN(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))
    bn.train(train)
    at, bt = bn(torch.from_numpy(s1), torch.from_numpy(s2), count)
    np.testing.assert_allclose(at.detach().numpy(), np.asarray(aj),
                               rtol=2e-6)
    np.testing.assert_allclose(bt.detach().numpy(), np.asarray(bj),
                               rtol=2e-6, atol=1e-6)
    stats = upd.get("batch_stats", variables["batch_stats"])
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)


def test_supported_m_equals_jax():
    ms = [16, 17, 48, 96, 1040, 1056, 3136, 12544, 50176, 200704, 401408]
    ks = [8, 64, 256, 1024, 2048, 4096]
    for m in ms:
        for k in ks:
            for n in (16, 64, 512, 2048, 4096):
                assert C.supported_m(m, k, n) == P.supported_m(m, k, n), \
                    (m, k, n)
                for bwd in (False, True):
                    assert C._pick_bm(m, k, n, bwd) == \
                        P._pick_bm(m, k, n, bwd)


def _emulated_kernel(x, a, b, w, dy, ds1, ds2, fold):
    """B9 and B10 computed in the kernels' orders on the CPU: products
    in 32-deep chunks, statistics per 64-row tile then over the tiles,
    dw over two row splits."""
    xh = (C._fold_input(x, a, b) if fold else x).float()
    wf = w.float()
    k = x.shape[1]
    y32 = sum(xh[:, c:c + 32] @ wf[c:c + 32] for c in
              reversed(range(0, k, 32)))
    tiles = list(y32.split(64))
    s1 = sum(t.sum(0) for t in tiles)
    s2 = sum((t * t).sum(0) for t in tiles)
    y = y32.to(x.dtype)
    yt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(torch.bfloat16) \
        .float()
    n = w.shape[1]
    dxh = sum(yt[:, c:c + 32] @ wf[:, c:c + 32].t() for c in
              reversed(range(0, n, 32)))
    half = x.shape[0] // 2
    dw = xh[half:].t() @ yt[half:] + xh[:half].t() @ yt[:half]
    if not fold:
        return (y, s1, s2), (dxh.to(x.dtype), dw, None, None)
    mask = ((x.float() * a + b) > 0).float()
    dxm = dxh * mask
    da = sum(t.sum(0) for t in (dxm * x.float()).split(64))
    db = sum(t.sum(0) for t in dxm.split(64))
    return (y, s1, s2), ((dxm * a).to(x.dtype), dw, da, db)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_error_rule_accepts_the_kernels_orders_and_refuses_faults(dt):
    """fwd_error/bwd_error, the rule the card holds B9 and B10 to, pass
    the same function summed in the kernels' orders and fail a dropped
    row tile, a dropped depth chunk and a lost ReLU mask."""
    m, k, n = 320, 96, 80
    rng, x, w, a, b = _inputs(m, k, n, dt, seed=21)
    xt, wt = _torch(x, dt), _torch(w, dt)
    at, bt = torch.from_numpy(a[0]), torch.from_numpy(b[0])
    dy = _torch(rng.standard_normal((m, n)) * 1e-3, dt)
    ds1 = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-5)
    ds2 = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-5)
    for fold in (False, True):
        fwd, bwd = _emulated_kernel(xt, at, bt, wt, dy, ds1, ds2, fold)
        errs = C.fwd_error(xt, at, bt, wt, fold, fwd)
        errs.update(C.bwd_error(xt, at, bt, wt, fwd[0], dy, ds1, ds2, fold,
                                bwd))
        assert max(r for _, r in errs.values()) <= 1.0, errs
        # a row tile left out of the statistics
        y, s1, s2 = fwd
        short = C.fwd_error(xt, at, bt, wt, fold,
                            (y, s1 - y[:64].float().sum(0), s2))
        assert short["s1"][1] > 1.0
        # a depth chunk left out of the product
        xh = (C._fold_input(xt, at, bt) if fold else xt).float()
        y_bad = (xh[:, 32:] @ wt.float()[32:]).to(xt.dtype)
        assert C.fwd_error(xt, at, bt, wt, fold,
                           (y_bad, s1, s2))["y"][1] > 1.0
        if fold:
            # the ReLU mask of the fold left out of dx
            yt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(
                torch.bfloat16).float()
            dx_unmasked = ((yt @ wt.float().t()) * at).to(xt.dtype)
            unmasked = C.bwd_error(xt, at, bt, wt, y, dy, ds1, ds2, fold,
                                   (dx_unmasked, *bwd[1:]))
            assert unmasked["dx"][1] > 1.0
