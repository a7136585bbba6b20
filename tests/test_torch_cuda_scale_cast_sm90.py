"""The redesigned fusion-buffer scale/cast kernel (B1,
``scale_cast_batched`` of ops/csrc/scale_cast.cu: the table in the
launch's parameters, one tile a CTA found through the table's hints) on
the card: every dtype pair bit for bit with ``plain_scale_cast``, ragged
lists with unaligned offsets and empty members, a list longer than one
launch holds, and pack-then-unpack round trips.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_scale_cast_sm90.py

Tolerance: bit for bit (one correctly rounded multiply, one
round-to-nearest-even cast, as the plain version does)."""

import pytest
import torch

from horovod_tpu_torch.ops import cuda_kernels as K

pytestmark = pytest.mark.cuda

PAIRS = [(i, o) for i in (torch.float32, torch.float16, torch.bfloat16)
         for o in (torch.float32, torch.float16, torch.bfloat16)]
PAIRS.append((torch.float64, torch.float64))


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _members(sizes, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return [(torch.randn(n, generator=g, dtype=torch.float64) * 3)
            .to(dtype).to(dev) for n in sizes]


def _offsets(srcs):
    offs, total = [], 0
    for s in srcs:
        offs.append(total)
        total += s.numel()
    return offs, total


def _plain_pack(srcs, offs, total, factor, dtype, dev):
    want = torch.empty(total, dtype=dtype, device=dev)
    for s, off in zip(srcs, offs):
        want[off:off + s.numel()] = K.plain_scale_cast(s, factor, dtype)
    return want


@pytest.mark.parametrize("in_dt,out_dt", PAIRS)
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 16385, (1 << 20) + 3])
def test_every_dtype_pair_matches_plain(dev, in_dt, out_dt, n):
    (x,) = _members([n], in_dt, dev, seed=n)
    for factor in (1.0, 0.5, 1.0 / 3.0):
        got = K.fused_scale_cast(x, factor, out_dt)
        torch.cuda.synchronize()
        assert torch.equal(got, K.plain_scale_cast(x, factor, out_dt))


@pytest.mark.parametrize("in_dt,out_dt", PAIRS)
def test_ragged_unaligned_list_with_empty_members(dev, in_dt, out_dt):
    """Odd sizes put most members at offsets off the 16-byte vector
    alignment; empty members take no entry and no launch changes."""
    sizes = [3, 0, 4097, 1, 0, 130, 8191, 5, 6000, 0, 2]
    srcs = _members(sizes, in_dt, dev, seed=len(sizes))
    offs, total = _offsets(srcs)
    buf = torch.full((total,), float("nan"), dtype=out_dt, device=dev)
    K.reset_launches()
    K.pack_scale_cast(srcs, buf, offs, 1.0 / 3.0)
    torch.cuda.synchronize()
    assert K.launches["pack_scale_cast"] == 1
    assert torch.equal(buf, _plain_pack(srcs, offs, total, 1.0 / 3.0,
                                        out_dt, dev))


def test_a_list_longer_than_one_launch_holds(dev):
    n = 2 * K.MAX_ENTRIES + 37
    sizes = [(i * 53) % 700 + (i % 5 == 0) * 9000 for i in range(n)]
    srcs = _members(sizes, torch.float32, dev, seed=1)
    offs, total = _offsets(srcs)
    buf = torch.empty(total, dtype=torch.bfloat16, device=dev)
    K.reset_launches()
    K.pack_scale_cast(srcs, buf, offs, 0.25)
    torch.cuda.synchronize()
    assert K.launches["pack_scale_cast"] == 3
    assert torch.equal(buf, _plain_pack(srcs, offs, total, 0.25,
                                        torch.bfloat16, dev))


@pytest.mark.parametrize("src_dt,buf_dt", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float32, torch.float16), (torch.bfloat16, torch.float32),
    (torch.float64, torch.float64)])
def test_pack_then_unpack_round_trips(dev, src_dt, buf_dt):
    sizes = [9408, 64, 64, 1, 36864, 4097, 147456, 3, 1000, 2048000]
    srcs = _members(sizes, src_dt, dev, seed=7)
    offs, total = _offsets(srcs)
    buf = torch.empty(total, dtype=buf_dt, device=dev)
    K.pack_scale_cast(srcs, buf, offs, 0.5)
    outs = [torch.empty_like(s) for s in srcs]
    K.unpack_scale_cast(buf, outs, offs, 2.0)
    torch.cuda.synchronize()
    assert torch.equal(buf, _plain_pack(srcs, offs, total, 0.5, buf_dt, dev))
    for o, s, off in zip(outs, srcs, offs):
        want = K.plain_scale_cast(buf[off:off + s.numel()], 2.0, src_dt)
        assert torch.equal(o, want)
        if buf_dt == src_dt:
            assert torch.equal(o, s)
