"""The step-integrity digest kernel on the card (``ops/csrc/digest.cu``)
against its plain versions: numpy's fold of the same bytes and the plain
PyTorch fold on the device.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_digest_cuda.py

Tolerance: bit for bit (xor and wrapping add are exact in any order)."""

import numpy as np
import pytest
import torch

from horovod_tpu_torch.core import integrity
from horovod_tpu_torch.ops import digest_kernels as dk

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bytes(n, seed, dev):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, 256, n, dtype=np.uint8)).to(dev)


def _want(t):
    return dk.np_fold(dk.byte_view(t.cpu()).numpy())


def _got(segs):
    return [dk.to_u64(v) for v in dk.fold_segments(segs).cpu().tolist()]


@pytest.mark.parametrize("n", list(range(10)) + [16, 24, 64, 4096, 65536,
                                                 65537, 65543, 1 << 20])
def test_kernel_equals_numpy_by_size(dev, n):
    t = _bytes(n, n, dev)
    assert _got([t]) == [_want(t)]
    assert dk.plain_fold(t) == _want(t)


@pytest.mark.parametrize("offset", range(8))
def test_unaligned_segments(dev, offset):
    buf = _bytes(200_003, 5, dev)
    segs = [buf[offset + k * 999:offset + k * 999 + n]
            for k, n in enumerate((0, 1, 7, 8, 9, 65, 70_001, 128_000))]
    assert _got(segs) == [_want(s) for s in segs]


def test_bf16_slices_of_a_bucket_row(dev):
    row = torch.randn(100_001, device=dev).to(torch.bfloat16)
    offs = [0, 1, 3, 64, 999, 50_000]
    segs = [row[o:o + 4_001] for o in offs]
    assert _got(segs) == [_want(s) for s in segs]
    assert integrity.digest64(segs) == integrity.digest64(
        [s.cpu() for s in segs])


def test_resnet_sized_segment(dev):
    # 25,557,032 bf16 elements: one rank's ResNet-50 gradient row
    row = torch.randn(25_557_032, device=dev).to(torch.bfloat16)
    assert _got([row]) == [_want(row)]
    assert dk.plain_fold(row) == _want(row)


def test_many_segments_one_launch(dev):
    buf = _bytes(1 << 20, 9, dev)
    cuts = sorted(np.random.default_rng(1).integers(0, 1 << 20, 600))
    segs = [buf[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    dk.reset_launches()
    got = _got(segs)
    assert dk.launches["digest_fold"] == 1
    assert got == [_want(s) for s in segs]


def test_flip_changes_the_fold(dev):
    """A flipped bit below bit 62 of its word changes the fold (the top
    two bits of a whole word are the fold's blind spots, ROADMAP.md C);
    every flip folds as numpy folds it."""
    t = _bytes(4096, 3, dev)
    base = _got([t])[0]
    for byte, bit in ((0, 0), (1000, 3), (4094, 7), (4095, 6), (4095, 7)):
        u = t.clone()
        u[byte:byte + 1].bitwise_xor_(1 << bit)
        got = _got([u])[0]
        assert got == _want(u)
        if byte % 8 != 7 or bit < 6:
            assert got != base
