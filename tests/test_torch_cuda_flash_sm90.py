"""The Hopper forward (B6) and dk/dv (B8) flash kernels of
ops/csrc/flash_sm90.cu on the card, at the cases their design can get
wrong: partial last tiles, windows around the 128-key tile, a partial
tile beside another head's non-finite rows (the 3-D tensor maps), reruns
(no atomics), and the autograd Function at both head dims.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_flash_sm90.py

The rule is ``flash_attention.error_ratio``, as in
tests/test_torch_cuda_flash.py and chip_smoke.py."""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as FA

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(BH, S, D, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(BH, S, D, generator=g).to(dev, dtype)
            for _ in range(4)]


def _check(got, want, dtype, what, rss=None, noise=None):
    err, ratio = FA.error_ratio(got, want, dtype, rss, noise)
    assert ratio <= 1.0, (f"{what}: max |kernel - plain| {err}, {ratio} of "
                          f"its bound")


def _check_fwd_dkv(q, k, v, dout, out, lse, dk, dv, window, dtype):
    """out, lse (unless None), dk and dv of the kernels against the plain
    versions on the same inputs (dk and dv from the plain forward's lse
    and delta)."""
    want_out, want_lse = FA.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * want_out.float()).sum(-1)
    scales = FA.plain_error_scales(q, k, v, dout, want_out, want_lse, delta,
                                   window)
    want_dk, want_dv = FA.plain_flash_bwd_dkv(q, k, v, dout, want_lse, delta,
                                              window)
    _check(out, want_out, dtype, "out", scales["rss_out"])
    if lse is not None:
        _check(lse, want_lse, torch.float32, "lse")
    _check(dk, want_dk, dtype, "dk", scales["rss_dk"], scales["noise_dk"])
    _check(dv, want_dv, dtype, "dv", scales["rss_dv"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [200, 257, 1000, 2047])
@pytest.mark.parametrize("window", [None, 127, 128, 129])
def test_partial_tiles_and_windows_match_plain(dev, dtype, D, S, window):
    q, k, v, dout = _inputs(2, S, D, dtype, dev, seed=S + D + (window or 0))
    out, lse = FA.flash_fwd(q, k, v, window)
    want_out, want_lse = FA.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * want_out.float()).sum(-1)
    dk, dv = FA.flash_bwd_dkv(q, k, v, dout, want_lse, delta, window)
    torch.cuda.synchronize()
    _check_fwd_dkv(q, k, v, dout, out, lse, dk, dv, window, dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 33, 64])
def test_sequences_shorter_than_a_tile_match_plain(dev, D, S):
    """The TMA boxes (64 or 128 rows) exceed the whole sequence."""
    dtype = torch.bfloat16
    q, k, v, dout = _inputs(3, S, D, dtype, dev, seed=S)
    out, lse = FA.flash_fwd(q, k, v)
    want_out, want_lse = FA.plain_flash_fwd(q, k, v)
    delta = (dout.float() * want_out.float()).sum(-1)
    dk, dv = FA.flash_bwd_dkv(q, k, v, dout, want_lse, delta)
    torch.cuda.synchronize()
    _check_fwd_dkv(q, k, v, dout, out, lse, dk, dv, None, dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [200, 1000])
def test_partial_tile_never_reads_the_next_head(dev, D, S):
    """Head 1 holds NaN in q, k, v and dO; head 0's partial last tile
    must read zeros past S, not head 1's rows, so its out, lse, dk and dv
    are finite and match the plain versions on head 0 alone."""
    dtype = torch.bfloat16
    q, k, v, dout = _inputs(2, S, D, dtype, dev, seed=7 + D)
    for t in (q, k, v, dout):
        t[1] = float("nan")
    out, lse = FA.flash_fwd(q, k, v)
    head0 = [t[:1].contiguous() for t in (q, k, v, dout)]
    want_out, want_lse = FA.plain_flash_fwd(*head0[:3])
    delta = (dout.float() * out.float()).sum(-1)
    lse_in = torch.cat([want_lse, lse[1:]])
    delta[0] = (head0[3].float() * want_out.float()).sum(-1)[0]
    dk, dv = FA.flash_bwd_dkv(q, k, v, dout, lse_in, delta)
    torch.cuda.synchronize()
    for name, t in (("out", out), ("lse", lse), ("dk", dk), ("dv", dv)):
        assert torch.isfinite(t[0]).all(), name
    _check_fwd_dkv(*head0, out[:1], lse[:1], dk[:1], dv[:1], None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_reruns_are_bit_identical(dev, dtype):
    q, k, v, dout = _inputs(8, 2048, 128, dtype, dev, seed=3)
    out, lse = FA.flash_fwd(q, k, v, 300)
    delta = (dout.float() * out.float()).sum(-1)
    dk, dv = FA.flash_bwd_dkv(q, k, v, dout, lse, delta, 300)
    out2, lse2 = FA.flash_fwd(q, k, v, 300)
    dk2, dv2 = FA.flash_bwd_dkv(q, k, v, dout, lse, delta, 300)
    torch.cuda.synchronize()
    for a, b in ((out, out2), (lse, lse2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
def test_autograd_launches_each_kernel_once(dev, D):
    B, S, H = 2, 333, 2
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(D)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g).to(dev, dtype)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.reset_launches()
    out = FA.flash_attention(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()

    qf, kf, vf, df = map(fold, (q, k, v, dout))
    _check_fwd_dkv(qf, kf, vf, df, fold(out.detach()), None,
                   fold(leaves[1].grad), fold(leaves[2].grad), None, dtype)
