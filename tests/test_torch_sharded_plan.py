"""horovod_tpu_torch.core.sharded against horovod_tpu.core.sharded: the
shard plan over randomized parameter lists (built as
tests/test_sharded.py builds them, with 16-bit dtypes added) must have
the same buckets, members, chunks and offsets and the same fingerprint
string, byte for byte; pack and unpack round-trip and pack as the JAX
plan packs; and the split rules (chunk_sizes, overlap_bucket_splits,
overlap_segment_bounds), normalize_shard_layout and compression_wire
agree.  Everything here is exact: layouts are integers, and a pack is a
copy (a prescale factor of 0.5 is exact in every float dtype)."""

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.core import sharded as jsh
from horovod_tpu.torch.compression import Compression as JaxCompression
from horovod_tpu_torch.core import sharded as psh
from horovod_tpu_torch.torch.compression import Compression

DTYPES = ["float32", "float32", "bfloat16", "float16"]
_NP = {"float32": np.float32, "float16": np.float16,
       "bfloat16": ml_dtypes.bfloat16}


def _random_specs(rng, n):
    specs = []
    for i in range(n):
        ndim = rng.randint(0, 4)
        shape = tuple(int(rng.randint(1, 40)) for _ in range(ndim))
        group = int(rng.randint(0, 3))
        dtype = DTYPES[rng.randint(0, len(DTYPES))]
        specs.append((f"p{i}", shape, dtype, group))
    return specs


def _plans(trial):
    rng = np.random.RandomState(trial)
    specs = _random_specs(rng, int(rng.randint(1, 20)))
    dp = int(rng.choice([1, 2, 3, 4, 8]))
    threshold = int(rng.choice([64, 1024, 1 << 20]))
    layout = "bucket" if trial % 2 == 0 else "flat"
    return (specs, jsh.ShardPlan(specs, dp, threshold, layout=layout),
            psh.ShardPlan(specs, dp, threshold, layout=layout))


@pytest.mark.parametrize("trial", range(25))
def test_shard_plan_matches_jax(trial):
    specs, want, got = _plans(trial)
    assert got.fingerprint() == want.fingerprint()
    assert (got.dp, got.layout, got.total_elems) == \
        (want.dp, want.layout, want.total_elems)
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        assert (g.index, g.dtype, g.group, g.n) == \
            (w.index, w.dtype, w.group, w.n)
        assert g.members == w.members
        assert g.chunks == list(w.chunks)
        assert g.rank_offsets == list(w.rank_offsets)
        for pos in range(got.dp):
            assert g.shard_slice(pos) == tuple(w.shard_slice(pos))
    for pos in range(got.dp):
        assert got.local_elems(pos) == want.local_elems(pos)
    # another dp or layout is another fingerprint
    other = psh.ShardPlan(specs, got.dp + 1, got.threshold_bytes,
                          layout=got.layout)
    assert other.fingerprint() != got.fingerprint()


@pytest.mark.parametrize("trial", range(0, 25, 3))
def test_pack_unpack_round_trip_and_match_jax(trial):
    specs, want, got = _plans(trial)
    rng = np.random.RandomState(100 + trial)
    vals = {k: rng.standard_normal(shape).astype(np.float32).astype(
        _NP[dt]) for k, shape, dt, _g in specs}
    tvals = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        getattr(torch, dt)).reshape(shape)
        for (k, shape, dt, _g), v in zip(specs, vals.values())}
    for gb, wb in zip(got.buckets, want.buckets):
        dt = getattr(torch, gb.dtype)
        buf = got.pack(gb, tvals)
        assert buf.dtype == dt and buf.shape == (gb.n,)
        ref = want.pack(wb, vals, dtype=_NP[wb.dtype])
        np.testing.assert_array_equal(buf.float().numpy(),
                                      np.asarray(ref, np.float32))
        for key, t in got.unpack(gb, buf).items():
            assert torch.equal(t, tvals[key]) and t.dtype == dt
        # a missing member packs as zeros, a factor scales, and unpack
        # writes into the tensors it is given
        missing = gb.members[0][0]
        half = got.pack(gb, {k: v for k, v in tvals.items()
                             if k != missing}, factor=0.5, device="cpu")
        size = gb.members[0][1]
        assert not half[:size].any()
        assert torch.equal(half[size:], buf[size:] * 0.5)
        outs = {k: torch.empty(shape, dtype=dt)
                for k, size, shape in gb.members}
        got.unpack(gb, buf, out=outs, factor=2.0)
        for key, t in outs.items():
            assert torch.equal(t, tvals[key] * 2)


@pytest.mark.parametrize("n,dp", [(0, 1), (1, 4), (10, 3), (7, 7),
                                  (1000, 8), (25557032, 2)])
def test_chunk_sizes_match_jax(n, dp):
    assert psh.chunk_sizes(n, dp) == jsh.chunk_sizes(n, dp)
    assert sum(psh.chunk_sizes(n, dp)) == n


@pytest.mark.parametrize("trial", range(6))
def test_overlap_split_rules_match_jax(trial):
    rng = np.random.RandomState(trial)
    sizes = [int(s) for s in rng.randint(1, 5000, size=rng.randint(0, 30))]
    for itemsize in (2, 4):
        for bucket_bytes in (None, 0, 1024, 8192, 1 << 20):
            for align in (1, 256):
                assert psh.overlap_bucket_splits(
                    sizes, itemsize, bucket_bytes, align=align) == \
                    jsh.overlap_bucket_splits(sizes, itemsize, bucket_bytes,
                                              align=align)
            for unit in (1, 2, 512):
                n = sum(sizes) // unit * unit
                assert psh.overlap_segment_bounds(
                    n, itemsize, bucket_bytes, unit) == \
                    jsh.overlap_segment_bounds(n, itemsize, bucket_bytes,
                                               unit)


def test_layout_and_wire_vocabulary_match_jax():
    for spec in (None, "", "bucket", "FLAT", " flat "):
        assert psh.normalize_shard_layout(spec) == \
            jsh.normalize_shard_layout(spec)
    for mod in (psh, jsh):
        with pytest.raises(ValueError):
            mod.normalize_shard_layout("diagonal")
    assert psh.SHARD_LAYOUT_CHOICES == jsh.SHARD_LAYOUT_CHOICES
    for name in ("none", "fp16", "bf16", "int8", "int4"):
        assert psh.compression_wire(getattr(Compression, name)) == \
            jsh.compression_wire(getattr(JaxCompression, name))
    assert [psh.compression_wire(getattr(Compression, n)) for n in
            ("none", "fp16", "bf16", "int8", "int4")] == \
        [None, "fp16", "bf16", "int8", "int4"]


def test_env_knobs(monkeypatch):
    from horovod_tpu_torch.common import env
    assert env.Config().shard_layout == "bucket"
    assert not env.Config().sharded_optimizer
    monkeypatch.setenv("HOROVOD_SHARD_LAYOUT", "Flat")
    monkeypatch.setenv("HOROVOD_SHARDED_OPTIMIZER", "1")
    cfg = env.Config()
    assert cfg.shard_layout == "flat" and cfg.sharded_optimizer
    monkeypatch.setenv("HOROVOD_SHARD_LAYOUT", "diagonal")
    with pytest.raises(ValueError):
        env.Config()
