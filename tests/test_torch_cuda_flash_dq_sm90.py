"""The Hopper dq kernel (B7, ``flash_dq_sm90_kernel`` of
ops/csrc/flash_sm90.cu) on the card, at the cases its design can get
wrong: partial last tiles, windows around the 128-key tile, sequences
shorter than a tile, a partial tile beside another head's non-finite rows
(the 3-D tensor maps), reruns (no atomics), and one launch of each kernel
per autograd backward.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_flash_dq_sm90.py

The rule is ``flash_attention.error_ratio`` with ``rss_dq`` and
``noise_dq``, as in chip_smoke.py."""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as FA

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(BH, S, D, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(BH, S, D, generator=g).to(dev, dtype)
            for _ in range(4)]


def _check_dq(q, k, v, dout, dq, window, dtype):
    """The kernel's dq against the plain version on the same inputs, with
    the plain forward's lse and delta."""
    out, lse = FA.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * out.float()).sum(-1)
    want = FA.plain_flash_bwd_dq(q, k, v, dout, lse, delta, window)
    sc = FA.plain_error_scales(q, k, v, dout, out, lse, delta, window)
    err, ratio = FA.error_ratio(dq, want, dtype, sc["rss_dq"],
                                sc["noise_dq"])
    assert ratio <= 1.0, (f"dq: max |kernel - plain| {err}, {ratio} of its "
                          f"bound")


def _dq(q, k, v, dout, window):
    out, lse = FA.plain_flash_fwd(q, k, v, window)
    delta = (dout.float() * out.float()).sum(-1)
    return FA.flash_bwd_dq(q, k, v, dout, lse, delta, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [200, 257, 1000, 2047])
@pytest.mark.parametrize("window", [None, 127, 128, 129])
def test_partial_tiles_and_windows_match_plain(dev, dtype, D, S, window):
    q, k, v, dout = _inputs(2, S, D, dtype, dev, seed=S + D + (window or 0))
    dq = _dq(q, k, v, dout, window)
    torch.cuda.synchronize()
    _check_dq(q, k, v, dout, dq, window, dtype)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [1, 33, 64])
def test_sequences_shorter_than_a_tile_match_plain(dev, D, S):
    """The TMA boxes (128 rows) exceed the whole sequence."""
    q, k, v, dout = _inputs(3, S, D, torch.bfloat16, dev, seed=S)
    dq = _dq(q, k, v, dout, None)
    torch.cuda.synchronize()
    _check_dq(q, k, v, dout, dq, None, torch.bfloat16)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [200, 1000])
def test_partial_tile_never_reads_the_next_head(dev, D, S):
    """Head 1 holds NaN in q, k, v and dO; head 0's partial last tiles
    must read zeros past S, not head 1's rows, so its dq is finite and
    matches the plain version on head 0 alone."""
    dtype = torch.bfloat16
    q, k, v, dout = _inputs(2, S, D, dtype, dev, seed=11 + D)
    head0 = [t[:1].clone() for t in (q, k, v, dout)]
    out, lse = FA.plain_flash_fwd(q, k, v)
    delta = (dout.float() * out.float()).sum(-1)
    for t in (q, k, v, dout):
        t[1] = float("nan")
    lse[1] = float("nan")
    delta[1] = float("nan")
    dq = FA.flash_bwd_dq(q, k, v, dout, lse, delta)
    torch.cuda.synchronize()
    assert torch.isfinite(dq[0]).all()
    _check_dq(*head0, dq[:1], None, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_reruns_are_bit_identical(dev, dtype):
    q, k, v, dout = _inputs(8, 2048, 128, dtype, dev, seed=5)
    out, lse = FA.flash_fwd(q, k, v, 300)
    delta = (dout.float() * out.float()).sum(-1)
    for window in (None, 300):
        a = FA.flash_bwd_dq(q, k, v, dout, lse, delta, window)
        b = FA.flash_bwd_dq(q, k, v, dout, lse, delta, window)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 128])
def test_autograd_launches_each_kernel_once(dev, D):
    B, S, H = 2, 333, 2
    dtype = torch.bfloat16
    g = torch.Generator().manual_seed(D + 1)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g).to(dev, dtype)
                     for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.reset_launches()
    FA.flash_attention(*leaves).backward(dout)
    torch.cuda.synchronize()
    assert FA.launches == {"flash_fwd": 1, "flash_bwd_dq": 1,
                           "flash_bwd_dkv": 1}

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()

    qf, kf, vf, df = map(fold, (q, k, v, dout))
    _check_dq(qf, kf, vf, df, fold(leaves[0].grad), None, dtype)
