"""horovod_tpu_torch's fused 1x1-conv + BN kernels on the card: B9
(forward) and B10 (backward) of ``ops/csrc/conv_bn.cu`` against their
plain versions, reruns bit for bit, and the differentiable op and the
fused ResNet on CUDA tensors.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs
on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_conv_bn.py

Tolerance: ``conv_bn.fwd_error`` and ``conv_bn.bwd_error`` (every ratio
<= 1): elementwise, the worst-case f32 rounding of the two products'
sums and of the kernel's statistics sums, plus one ulp of the output
dtype; over each tensor, relative L2 1e-2."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu_torch.models.resnet import ResNet, numpy_init
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import conv_bn as C

pytestmark = pytest.mark.cuda

# every distinct (M, K, N, fold) of a full-width ResNet-50 step at 64
# images of 224 x 224 per rank
STEP_SHAPES = [
    (200704, 64, 64, False), (200704, 64, 256, True),
    (200704, 64, 256, False), (200704, 256, 64, False),
    (200704, 256, 128, False), (50176, 128, 512, True),
    (50176, 512, 128, False), (50176, 512, 256, False),
    (12544, 256, 1024, True), (12544, 1024, 256, False),
    (12544, 1024, 512, False), (3136, 512, 2048, True),
    (3136, 2048, 512, False)]
# small and odd shapes: M not a multiple of the 64-row tile, K and N not
# multiples of 16
ODD_SHAPES = [(16, 64, 64), (48, 24, 40), (1040, 72, 8), (1040, 256, 100),
              (96, 1, 3)]


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
    y, s1, s2 = C.conv1x1_bn_fwd(x, a, b, w, fold)
    got = C.conv1x1_bn_bwd(x, a, b, w, y, dy, ds1, ds2, fold)
    torch.cuda.synchronize()
    errs = C.fwd_error(x, a, b, w, fold, (y, s1, s2))
    errs.update(C.bwd_error(x, a, b, w, y, dy, ds1, ds2, fold, got))
    bad = {k: v for k, v in errs.items() if not v[1] <= 1.0}
    assert not bad, bad
    return (y, s1, s2), got


@pytest.mark.parametrize("m,k,n,fold", STEP_SHAPES)
def test_kernels_match_plain_at_the_step_shapes(dev, m, k, n, fold):
    _check(*_problem(m, k, n, torch.bfloat16, dev, m + k + n), fold)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("m,k,n", ODD_SHAPES)
def test_kernels_match_plain_at_odd_shapes(dev, m, k, n, fold, dtype):
    _check(*_problem(m, k, n, dtype, dev, 7 * m + k + n), fold)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rerun_is_bit_identical(dev, dtype):
    """Fixed-order sums, no float atomics: a rerun repeats every bit."""
    x, a, b, w, dy, ds1, ds2 = _problem(12544, 256, 1024, dtype, dev, 5)
    first = _check(x, a, b, w, dy, ds1, ds2, True)
    again = _check(x, a, b, w, dy, ds1, ds2, True)
    for p, q in zip((*first[0], *first[1]), (*again[0], *again[1])):
        assert torch.equal(p, q)


def test_launch_counts_and_refusals(dev):
    x, a, b, w, dy, ds1, ds2 = _problem(64, 32, 16, torch.bfloat16, dev, 6)
    C.reset_launches()
    y, _, _ = C.conv1x1_bn_fwd(x, a, b, w, True)
    C.conv1x1_bn_bwd(x, a, b, w, y, dy, ds1, ds2, True)
    assert C.launches == {"conv1x1_bn_fwd": 1, "conv1x1_bn_bwd": 1}
    with pytest.raises(TypeError, match="f32 or bf16"):
        C.conv1x1_bn_fwd(x.half(), a, b, w.half(), True)
    with pytest.raises(ValueError, match="contiguous"):
        C.conv1x1_bn_fwd(x.t().contiguous().t(), a, b, w, True)
    assert C.launches["conv1x1_bn_fwd"] == 1
    C.reset_launches()


def test_failed_build_raises(dev, tmp_path, monkeypatch):
    """A CUDA tensor whose kernel cannot be built raises: no quiet
    switch to the plain version."""
    monkeypatch.setenv("HOROVOD_TPU_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    monkeypatch.delitem(_build._libs, "hvd_conv_bn", raising=False)
    x, a, b, w, *_ = _problem(64, 32, 16, torch.bfloat16, dev, 7)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        C.conv1x1_bn_fwd(x, a, b, w, False)


def test_op_gradients_on_the_card(dev):
    """The differentiable op on CUDA runs B9 and B10 once each, and the
    f32 master weight receives B10's f32 dw unrounded."""
    x, a, b, w, dy, ds1, ds2 = _problem(1024, 64, 128, torch.bfloat16, dev,
                                        8)
    w32 = w.float().requires_grad_()
    xg = x.clone().requires_grad_()
    ag, bg = a.clone().requires_grad_(), b.clone().requires_grad_()
    C.reset_launches()
    y, s1, s2 = C.conv1x1_bn(xg, w32, fold=(ag, bg))
    ((y.float() * dy.float()).sum() + (s1 * ds1).sum()
     + (s2 * ds2).sum()).backward()
    assert C.launches == {"conv1x1_bn_fwd": 1, "conv1x1_bn_bwd": 1}
    want = C.conv1x1_bn_bwd(x, a, b, w, y.detach(), dy, ds1, ds2, True)
    for got, ref in zip((xg.grad, w32.grad, ag.grad, bg.grad), want):
        assert torch.equal(got, ref)
    assert w32.grad.dtype == torch.float32
    assert not torch.equal(w32.grad.to(torch.bfloat16).float(), w32.grad)
    C.reset_launches()


def test_fused_resnet_step_on_the_card(dev):
    """A small fused ResNet (bf16) trains one step on the card through
    the kernels: 8 fused convolutions launch B9 and B10 once each, 4
    take the plain path, and the loss and gradients are finite."""
    model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=16,
                   dtype=torch.bfloat16, fused=True)
    model.load_state_dict(numpy_init(model, seed=0))
    model.to(dev)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 10, 4)).to(dev)
    C.reset_launches()
    loss = F.cross_entropy(model(x), y)
    loss.backward()
    torch.cuda.synchronize()
    assert C.launches == {"conv1x1_bn_fwd": 8, "conv1x1_bn_bwd": 8}
    assert C.plain_calls == {"conv1x1_bn": 4}
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
    C.reset_launches()
