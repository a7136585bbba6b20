"""horovod_tpu_torch's Hopper conv+BN kernels on the card: B9
(``conv_bn_fwd_sm90_kernel``) and B10 (``conv_bn_dx_sm90_kernel``,
``conv_bn_dw_sm90_kernel``) of ``ops/csrc/conv_bn_sm90.cu`` against their
plain versions at every shape of a ResNet-50 step, the route rule and its
counters, reruns bit for bit, alignment and shape refusals, and the
differentiable op's gradients through the new kernels.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_conv_bn_sm90.py

Tolerance: ``conv_bn.fwd_error`` and ``conv_bn.bwd_error`` (every ratio
<= 1) with the sm90 route's summation depths (``conv_bn._depths``)."""

import ctypes

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import conv_bn as C

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
# every distinct (M, K, N, fold) of a full-width ResNet-50 step at 64
# images of 224 x 224 per rank; M = 3136 leaves a 64-row tail
STEP_SHAPES = [
    (200704, 64, 64, False), (200704, 64, 256, True),
    (200704, 64, 256, False), (200704, 256, 64, False),
    (200704, 256, 128, False), (50176, 128, 512, True),
    (50176, 512, 128, False), (50176, 512, 256, False),
    (12544, 256, 1024, True), (12544, 1024, 256, False),
    (12544, 1024, 512, False), (3136, 512, 2048, True),
    (3136, 2048, 512, False)]
# a 64-row tail, a CTA walking two tiles, dw's half-empty k tile
ODD_SHAPES = [(320, 64, 128), (17000, 64, 64), (1000, 192, 320), (16, 64, 64)]


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _problem(m, k, n, dtype, dev, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)
    x = t(m, k).to(dtype)
    w = (t(k, n) / k ** 0.5).to(dtype)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32)).to(dev)
    b = t(k, scale=0.5)
    dy = t(m, n, scale=1e-3).to(dtype)
    ds1 = t(n, scale=1e-5)
    ds2 = t(n, scale=1e-5)
    return x, a, b, w, dy, ds1, ds2


def _check(x, a, b, w, dy, ds1, ds2, fold):
    """Both kernels once, held to the rule; the route counters must show
    one call of each on the route the rule names."""
    k, n = w.shape
    C.reset_launches()
    y, s1, s2 = C.conv1x1_bn_fwd(x, a, b, w, fold)
    got = C.conv1x1_bn_bwd(x, a, b, w, y, dy, ds1, ds2, fold)
    torch.cuda.synchronize()
    r = C.route(x.dtype, k, n)
    assert {name for name, v in C.route_launches.items() if v} == {
        f"conv1x1_bn_fwd_{r}", f"conv1x1_bn_bwd_{r}"}
    errs = C.fwd_error(x, a, b, w, fold, (y, s1, s2))
    errs.update(C.bwd_error(x, a, b, w, y, dy, ds1, ds2, fold, got))
    bad = {name: v for name, v in errs.items() if not v[1] <= 1.0}
    assert not bad, bad
    C.reset_launches()
    return (y, s1, s2), got


@pytest.mark.parametrize("m,k,n,fold", STEP_SHAPES)
def test_step_shapes_take_the_sm90_route_and_match_plain(dev, m, k, n, fold):
    assert C.route(BF16, k, n) == "sm90"
    _check(*_problem(m, k, n, BF16, dev, m + k + n), fold)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("m,k,n", ODD_SHAPES)
def test_odd_shapes_on_the_sm90_route(dev, m, k, n, fold):
    _check(*_problem(m, k, n, BF16, dev, 3 * m + k + n), fold)


@pytest.mark.parametrize("m,k,n", [(3136, 512, 2048), (320, 64, 128),
                                   (200704, 64, 256)])
def test_plan_copy_equals_the_library(dev, m, k, n):
    """conv_bn.sm90_plan (the error rule's depths) is the library's
    plan; the kernels fit one CTA per SM."""
    route, plan = C.kernel_plan(BF16, m, k, n)
    assert route == "sm90"
    assert {f: plan[f] for f in C.sm90_plan(m, k, n)} == C.sm90_plan(m, k, n)
    for f in ("fwd_smem", "dx_smem", "dw_smem"):
        assert 0 < plan[f] <= 232448
    assert C.kernel_plan(torch.float32, m, k, n) == ("wmma", None)


@pytest.mark.parametrize("m,k,n", [(3136, 512, 2048), (200704, 64, 256),
                                   (1000, 192, 320)])
def test_rerun_is_bit_identical(dev, m, k, n):
    """Fixed-order sums, no float atomics: a rerun repeats every bit,
    the M tail and the fold included."""
    x, a, b, w, dy, ds1, ds2 = _problem(m, k, n, BF16, dev, 5)
    first = _check(x, a, b, w, dy, ds1, ds2, True)
    again = _check(x, a, b, w, dy, ds1, ds2, True)
    for p, q in zip((*first[0], *first[1]), (*again[0], *again[1])):
        assert torch.equal(p, q)


@pytest.mark.parametrize("dtype,k,n", [(BF16, 96, 64), (BF16, 64, 80),
                                       (torch.float32, 64, 64)])
def test_other_problems_stay_on_the_wmma_route(dev, dtype, k, n):
    assert C.route(dtype, k, n) == "wmma"
    _check(*_problem(320, k, n, dtype, dev, 9), True)


def _misaligned(t):
    """``t``'s values in a contiguous tensor whose data starts 2 bytes
    past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = flat[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def test_misaligned_tensors_are_refused(dev):
    x, a, b, w, dy, ds1, ds2 = _problem(320, 64, 128, BF16, dev, 11)
    y = C.conv1x1_bn_fwd(x, a, b, w, True)[0]
    C.reset_launches()
    with pytest.raises(ValueError, match="16-byte"):
        C.conv1x1_bn_fwd(_misaligned(x), a, b, w, True)
    with pytest.raises(ValueError, match="16-byte"):
        C.conv1x1_bn_fwd(x, a, b, _misaligned(w), True)
    with pytest.raises(ValueError, match="16-byte"):
        C.conv1x1_bn_bwd(x, a, b, w, y, _misaligned(dy), ds1, ds2, True)
    assert C.launches == {"conv1x1_bn_fwd": 0, "conv1x1_bn_bwd": 0}
    # the library itself refuses a misaligned TMA operand (no fallback)
    lib = C._lib()
    xm = _misaligned(x)
    fwd_floats, _ = C._workspace(lib, BF16, 320, 64, 128)
    ws = torch.empty(fwd_floats, dtype=torch.float32, device=dev)
    out = torch.empty(320, 128, dtype=BF16, device=dev)
    s12 = torch.empty(256, dtype=torch.float32, device=dev)
    err = lib.hvd_conv_bn_fwd(
        0, C._CODES[BF16], xm.data_ptr(), a.data_ptr(), b.data_ptr(),
        w.data_ptr(), out.data_ptr(), s12.data_ptr(), ws.data_ptr(), 320,
        64, 128, 1, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err != 0
    torch.cuda.synchronize()


def test_shape_refusals(dev):
    x, a, b, w, dy, ds1, ds2 = _problem(320, 64, 128, BF16, dev, 12)
    with pytest.raises(ValueError, match="do not match"):
        C.conv1x1_bn_fwd(x, a, b, w[:32], True)
    with pytest.raises(ValueError, match="y and dy"):
        C.conv1x1_bn_bwd(x, a, b, w, dy[:, :64], dy, ds1, ds2, True)
    with pytest.raises(ValueError, match="f32 values"):
        C.conv1x1_bn_bwd(x, a, b, w, dy, dy, ds1[:64], ds2, True)
    with pytest.raises(ValueError, match="contiguous"):
        C.conv1x1_bn_fwd(x.t().contiguous().t(), a, b, w, True)


@pytest.mark.parametrize("fold", [False, True])
def test_op_gradients_through_the_sm90_kernels(dev, fold):
    """The differentiable op on a step-like bf16 shape runs B9 and B10 on
    the sm90 route once each; its gradients are the kernels' outputs bit
    for bit, the f32 master weight's unrounded."""
    m, k, n = 3136, 256, 512
    x, a, b, w, dy, ds1, ds2 = _problem(m, k, n, BF16, dev, 13)
    w32 = w.float().requires_grad_()
    xg = x.clone().requires_grad_()
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    C.reset_launches()
    y, s1, s2 = C.conv1x1_bn(xg, w32, fold=(ag, bg) if fold else None)
    ((y.float() * dy.float()).sum() + (s1 * ds1).sum()
     + (s2 * ds2).sum()).backward()
    assert C.route_launches["conv1x1_bn_fwd_sm90"] == 1
    assert C.route_launches["conv1x1_bn_bwd_sm90"] == 1
    assert sum(C.route_launches.values()) == 2
    ones, zeros = torch.ones_like(a), torch.zeros_like(b)
    fa, fb = (a, b) if fold else (ones, zeros)
    want = C.conv1x1_bn_bwd(x, fa, fb, w, y.detach(), dy, ds1, ds2, fold)
    assert torch.equal(xg.grad, want[0])
    assert torch.equal(w32.grad, want[1]) and w32.grad.dtype == torch.float32
    if fold:
        assert torch.equal(ag.grad, want[2]) and torch.equal(bg.grad, want[3])
    C.reset_launches()
