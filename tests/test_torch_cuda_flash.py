"""horovod_tpu_torch's flash-attention kernels on the card: each kernel
against its plain version on the same inputs, the autograd Function's
gradients against the plain backward, the wrappers' refusals, and a
small LM step through make_lm_train_step.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_flash.py

Tolerances are those of ``flash_attention.error_ratio``, which
chip_smoke.py applies too.  Elementwise: f32 within 1e-5 of the largest
|plain| value, for summation order (TF32 is off); f16 and bf16 within
two ulps of the working type at each |plain| value (the outputs'
rounding) plus 8 eps times the root sum of squares of the terms the
element sums (their rounding to the working type, which kernel and plain
version do apart: the probabilities before p v and p^T dO, ds before
ds k and ds^T q).  Over each tensor, a relative L2 distance of at most
1e-2.  lse is f32 for every input dtype and is held as f32.  dq and dk
are also allowed 2**-16 of their summands' absolute scale: the f32
rounding of dp - delta, which is all they hold where that difference
cancels (window 1)."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models.transformer import TransformerConfig
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.parallel import make_lm_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_close(got, want, dtype, what, rss=None, noise=None):
    err, ratio = FA.error_ratio(got, want, dtype, rss, noise)
    assert ratio <= 1.0, (f"{what}: max |kernel - plain| {err}, {ratio} of "
                          f"its bound")


def _assert_grads_close(dq, dk, dv, want, scales, dtype):
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _assert_close(got, w, dtype, name, scales["rss_" + name],
                      scales.get("noise_" + name))


def _inputs(BH, S, D, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(BH, S, D, generator=g).to(dev, dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S,window", [(128, None), (1000, 100), (257, 1),
                                      (200, 199)])
def test_kernels_match_plain(dev, dtype, D, S, window):
    q, k, v, dout = _inputs(3, S, D, dtype, dev, seed=S + D)
    FA.reset_launches()
    out, lse = FA.flash_fwd(q, k, v, window)
    want_out, want_lse = FA.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * want_out.float()).sum(-1)
    dq = FA.flash_bwd_dq(q, k, v, dout, want_lse, delta, window)
    dk, dv = FA.flash_bwd_dkv(q, k, v, dout, want_lse, delta, window)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert lse.dtype == torch.float32 and lse.shape == (3, S)
    scales = FA.plain_error_scales(q, k, v, dout, want_out, want_lse, delta,
                                   window)
    _assert_close(out, want_out, dtype, "out", scales["rss_out"])
    _assert_close(lse, want_lse, torch.float32, "lse")
    want = [FA.plain_flash_bwd_dq(q, k, v, dout, want_lse, delta, window),
            *FA.plain_flash_bwd_dkv(q, k, v, dout, want_lse, delta, window)]
    _assert_grads_close(dq, dk, dv, want, scales, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_grads_match_plain_backward(dev, dtype):
    B, S, H, D = 2, 300, 3, 64
    g = torch.Generator().manual_seed(1)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g).to(dev, dtype)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.reset_launches()
    out = FA.flash_attention(*leaves, window=40)
    out.backward(dout)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()

    qf, kf, vf, df = map(fold, (q, k, v, dout))
    want_out, lse = FA.plain_flash_fwd(qf, kf, vf, 40)
    delta = (df.float() * want_out.float()).sum(-1)
    want = [FA.plain_flash_bwd_dq(qf, kf, vf, df, lse, delta, 40),
            *FA.plain_flash_bwd_dkv(qf, kf, vf, df, lse, delta, 40)]
    scales = FA.plain_error_scales(qf, kf, vf, df, want_out, lse, delta, 40)
    _assert_close(fold(out.detach()), want_out, dtype, "out",
                  scales["rss_out"])
    _assert_grads_close(*(fold(t.grad) for t in leaves), want, scales, dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros(2, 64, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # CPU/CUDA mix
        FA.flash_fwd(x, x.cpu(), x)
    with pytest.raises(TypeError):                   # f64
        FA.flash_fwd(*(torch.zeros(2, 64, 64, device=dev,
                                   dtype=torch.float64),) * 3)
    with pytest.raises(ValueError):                  # not contiguous
        FA.flash_fwd(x.transpose(1, 2), x, x)
    y = torch.zeros(2, 64, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # head dim not built
        FA.flash_fwd(y, y, y)
    rows = torch.zeros(2, 64, device=dev)
    with pytest.raises(ValueError):                  # lse on the CPU
        FA.flash_bwd_dq(x, x, x, x, rows.cpu(), rows)


def test_lm_step_on_card(dev):
    """A small LM through make_lm_train_step on the card: the flash step
    launches each kernel once per layer, gives the dense step's loss, and
    its gradients differ from the dense step's by no more than bf16
    noise: per tensor at most max(2e-2, twice the dense step's distance
    from the f32 gradients), and over all parameters it is no further
    from the f32 gradients than 1.25 x the dense step."""
    kw = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=2, d_ff=256,
              max_seq_len=256)
    tokens = np.random.default_rng(0).integers(0, 512, size=(2, 256))
    results = {}
    # the f32 yardstick is the dense model: it runs none of the kernels
    for impl, dtype in (("flash", torch.bfloat16), ("ring", torch.bfloat16),
                        ("ring", torch.float32)):
        init, step = make_lm_train_step(TransformerConfig(dtype=dtype, **kw),
                                        attention_impl=impl, device=dev)
        state = init(0)
        FA.reset_launches()
        state, loss = step(state, tokens)
        torch.cuda.synchronize()
        results[impl, dtype] = (float(loss), {
            n: p.grad.float() for n, p in
            state["model"].named_parameters()}, dict(FA.launches))
    (lf, gf, cf), (ld, gd, cd), (_, gr, _) = results.values()
    assert cf == {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
    assert cd == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert abs(lf - ld) <= 2e-3

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    for name in gf:
        assert rel(gf[name], gd[name]) <= max(
            2e-2, 2 * rel(gd[name], gr[name])), name
    flat = [torch.cat([g[n].flatten() for n in gr]) for g in (gf, gd, gr)]
    assert rel(flat[0], flat[2]) <= 1.25 * rel(flat[1], flat[2])
