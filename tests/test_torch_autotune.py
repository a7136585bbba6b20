"""The Bayesian autotuner of horovod_tpu_torch (``core/optim.py``,
``core/autotune.py``, the engine's tuner and the coordinator's) against
the JAX package's.

The tuner scores bytes over wall time; both packages' clocks are replaced
by one fake clock, so the same byte sequence gives the same scores, and
then the same suggestions, the same CSV bytes and the same cache bytes.

Tolerance: exact throughout (the GP and the optimizer are the same numpy
code on the same inputs; the files are compared byte for byte); the
sharded re-shard test compares parameters bit for bit (SGD on the f32
wire is elementwise, so the layout moves no rounding)."""

import json
import threading
import types

import numpy as np
import pytest
import torch

import horovod_tpu.core.autotune as jat
import horovod_tpu.core.optim as jopt
import horovod_tpu_torch as thvd
import horovod_tpu_torch.core.autotune as tat
import horovod_tpu_torch.core.optim as topt
from horovod_tpu.runner.http import http_server as jax_http
from horovod_tpu_torch import telemetry as ttel
from horovod_tpu_torch.common import basics as tb
from horovod_tpu_torch.runner.http import http_server as torch_http


class _Clock:
    """A monotonic clock that advances one second a read."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        self.t += 1.0
        return self.t


@pytest.fixture()
def fake_clock(monkeypatch):
    for mod in (jat, tat):
        monkeypatch.setattr(mod, "time", _Clock())


def _config(**kw):
    cfg = dict(fusion_threshold_bytes=64 << 20, cycle_time_ms=1.0,
               pack_mt_threshold_bytes=8 << 20, cache_capacity=1024,
               wire_inner=None, wire_dtype=None, algorithm=None,
               pp_schedule="1f1b", pp_n_micro=0, shard_layout="bucket",
               overlap_bucket_bytes=0, moe_ep=0, moe_capacity_factor=1.25)
    cfg.update(kw)
    return types.SimpleNamespace(**cfg)


def _score_bytes(cfg):
    """A deterministic landscape over the applied configuration."""
    f = np.log2(cfg.fusion_threshold_bytes)
    c = np.log2(cfg.cycle_time_ms)
    return int(1e6 * (30 - (f - 24) ** 2 - (c - 1) ** 2))


# -- the optimizer ------------------------------------------------------------

def test_gaussian_process_matches_jax():
    rng = np.random.default_rng(0)
    X, y = rng.uniform(size=(7, 3)), rng.standard_normal(7)
    Xs = rng.uniform(size=(11, 3))
    gps = [m.GaussianProcess(length_scale=0.4, noise=1e-3)
           for m in (jopt, topt)]
    for gp in gps:
        gp.fit(X, y)
    (mj, sj), (mt, st) = (gp.predict(Xs) for gp in gps)
    assert np.array_equal(mj, mt) and np.array_equal(sj, st)
    assert np.array_equal(jopt.expected_improvement(mj, sj, 0.3),
                          topt.expected_improvement(mt, st, 0.3))


def test_bayesian_optimizer_suggestions_match_jax():
    bos = [m.BayesianOptimizer(dims=4, seed=3) for m in (jopt, topt)]
    for step in range(8):
        sj, st = (bo.suggest() for bo in bos)
        assert np.array_equal(sj, st), step
        score = float(-np.sum((sj - 0.3) ** 2))
        for bo in bos:
            bo.observe(sj, score)
    assert np.array_equal(bos[0].best()[0], bos[1].best()[0])


@pytest.mark.parametrize("dims", [
    {}, {"tune_sharded": True, "tune_overlap": True},
    {"tune_wire": False, "tune_algorithm": False},
    {"tune_moe": True}], ids=["six", "eight", "coordinator", "moe"])
def test_parameter_manager_matches_jax(tmp_path, fake_clock, dims):
    """Same scores, same suggestions: the applied configuration after
    every sample, the CSV log and the warm-start cache are the JAX
    package's, byte for byte."""
    cfgs = [_config(moe_ep=2 if dims.get("tune_moe") else 0)
            for _ in range(2)]
    pms = []
    for mod, cfg, tag in ((jat, cfgs[0], "j"), (tat, cfgs[1], "t")):
        pms.append(mod.ParameterManager(
            cfg, warmup_samples=1, steps_per_sample=2, max_samples=6,
            log_path=str(tmp_path / f"{tag}.csv"),
            cache_path=str(tmp_path / f"{tag}.json"), topo_fp="flat2",
            world_size=2, **dims))
    for pm in pms:
        pm.note_bucket_signature("sig")
    applied = [[], []]
    for _ in range(6 * 2):
        for k, (pm, cfg) in enumerate(zip(pms, cfgs)):
            pm.record_bytes(_score_bytes(cfg))
            applied[k].append(dict(vars(cfg)))
    assert applied[0] == applied[1]
    assert not pms[0].active and not pms[1].active
    assert pms[0].best_parameters() == pms[1].best_parameters()
    for pm in pms:
        pm.close()
    for ext in ("csv", "json"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes()
    lines = (tmp_path / "t.csv").read_text().splitlines()
    assert lines[0].startswith("sample,") and len(lines) == 7


def test_pipeline_dimension_refused_naming_a15():
    with pytest.raises(NotImplementedError, match="A15"):
        tat.ParameterManager(_config(), tune_pipeline=True)


# -- warm start ---------------------------------------------------------------

def test_warm_start_round_trip(tmp_path, fake_clock):
    cache = str(tmp_path / "warm.json")
    cfg = _config()
    pm = tat.ParameterManager(cfg, warmup_samples=1, steps_per_sample=2,
                              max_samples=5, cache_path=cache,
                              topo_fp="h4-4", world_size=8)
    pm.note_bucket_signature("sigA")
    assert not pm.warm_started
    for _ in range(5 * 2):
        pm.record_bytes(_score_bytes(cfg))
    assert not pm.active
    entry = json.load(open(cache))["sigA|h4-4|np8"]
    pm.close()
    cfg2 = _config()
    pm2 = tat.ParameterManager(cfg2, cache_path=cache, topo_fp="h4-4",
                               world_size=8)
    pm2.note_bucket_signature("sigA")
    assert pm2.warm_started
    assert cfg2.fusion_threshold_bytes == entry["fusion_threshold_bytes"]
    assert cfg2.cycle_time_ms == entry["cycle_time_ms"]
    assert (cfg2.wire_inner, cfg2.wire_dtype) == \
        (entry["wire_inner"], entry["wire_outer"])
    assert cfg2.algorithm == entry["algorithm"]
    pm2.close()
    for kw in ({"topo_fp": "h8", "world_size": 8},
               {"topo_fp": "h4-4", "world_size": 4}):
        pm3 = tat.ParameterManager(_config(), cache_path=cache, **kw)
        pm3.note_bucket_signature("sigA")
        assert not pm3.warm_started


def test_warm_start_survives_a_corrupt_cache(tmp_path):
    cache = tmp_path / "warm.json"
    cache.write_text("{not json")
    pm = tat.ParameterManager(_config(), cache_path=str(cache),
                              topo_fp="flat2", world_size=2)
    pm.note_bucket_signature("sig")
    assert not pm.warm_started


def test_cache_never_clobbers_a_better_prior(tmp_path, fake_clock):
    cache = str(tmp_path / "warm.json")

    def converge(nbytes):
        pm = tat.ParameterManager(_config(), warmup_samples=1,
                                  steps_per_sample=1, max_samples=3,
                                  cache_path=cache, topo_fp="flat4",
                                  world_size=4)
        pm.note_bucket_signature("sig")
        for _ in range(3):
            pm.record_bytes(nbytes)
        pm.close()
    converge(1 << 24)
    first = json.load(open(cache))["sig|flat4|np4"]
    converge(1 << 10)
    assert json.load(open(cache))["sig|flat4|np4"] == first


# -- the coordinator's tuner --------------------------------------------------

def _meta(key, nbytes):
    return dict(key=key, type="ALLREDUCE", dtype="float32", shape=[4],
                op=1, pre=1.0, post=1.0, ps=0, nbytes=nbytes, nprocs=1,
                root=-1, aux={})


def test_coordinator_tuner_matches_jax(tmp_path, fake_clock):
    """The same ready/poll script against both coordinators: the same
    responses and tuned parameters in every poll reply, the same CSV, and
    the current configuration journaled as ``tuned`` records."""
    out = []
    for mod, tag in ((jax_http, "j"), (torch_http, "t")):
        c = mod.Coordinator(world_size=1, autotune=True,
                            autotune_log=str(tmp_path / f"{tag}.csv"),
                            fusion_threshold_bytes=1 << 20)
        c._autotuner.steps_per_sample = 2
        c._autotuner.warmup_samples = 1
        c._autotuner.max_samples = 4
        replies = []
        for step in range(12):
            c.handle("ready", {"proc": 0, "nlocal": 1, "entries": [
                _meta(f"a{step}", 3 << 19), _meta(f"b{step}", 3 << 19)]})
            rep = c.handle("poll", {"cursor": 0, "wait": 0.0})
            replies.append((rep["tuned"], [r["keys"]
                                           for r in rep["responses"]]))
        c._autotuner.close()
        out.append((replies, c.fusion_threshold))
    assert out[0] == out[1]
    assert (tmp_path / "j.csv").read_bytes() == \
        (tmp_path / "t.csv").read_bytes()
    # the tuned threshold is applied at the coordinator
    assert out[1][1] != 1 << 20
    path = tmp_path / "journal.jsonl"
    server = torch_http.RendezvousServer(
        world_size=1, journal_path=str(path), autotune=True)
    try:
        server.coordinator.handle("ready", {
            "proc": 0, "nlocal": 1, "sid": "s",
            "entries": [_meta("x", 64)]})
    finally:
        server.stop()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["p"]["fusion_threshold_bytes"] for r in recs
            if r["k"] == "tuned"] == [128 << 20]


# -- the engine's tuner -------------------------------------------------------

def test_engine_tuner_in_rank_threads(tmp_path, monkeypatch):
    """HOROVOD_AUTOTUNE at 2 rank threads: one sample per two buckets,
    the CSV's columns are the JAX package's, the tuner converges and
    writes its cache, a second engine on the same cache starts at that
    best, and the autotune families show in the metrics."""
    log, cache = tmp_path / "at.csv", tmp_path / "at.json"
    for k, v in {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": str(log),
                 "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                 "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                 "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "4",
                 "HOROVOD_AUTOTUNE_CACHE": str(cache)}.items():
        monkeypatch.setenv(k, v)

    def fn():
        for i in range(10):
            thvd.allreduce(torch.ones(256), name=f"g.{i % 2}")
        eng = tb.engine()
        return (eng.autotuner.active, eng.autotuner.warm_started,
                eng.config.fusion_threshold_bytes,
                ttel.counter_total(ttel.AUTOTUNE_SAMPLES_FAMILY))
    first = thvd.run(fn, np=2, device="cpu")
    assert all(not active for active, *_ in first)
    assert first[0][3] >= 4
    header = log.read_text().splitlines()[0]
    jpm = jat.ParameterManager(_config(), log_path=str(tmp_path / "j.csv"))
    jpm.close()
    assert header == (tmp_path / "j.csv").read_text().splitlines()[0]
    assert len(log.read_text().splitlines()) == 5
    best = list(json.load(open(cache)).values())[0]
    second = thvd.run(fn, np=2, device="cpu")
    assert second[0][1] is True and best["fusion_threshold_bytes"] > 0
    assert ttel.AUTOTUNE_BEST_CONFIG_FAMILY in json.dumps(
        thvd.run(lambda: thvd.metrics(), np=1, device="cpu")[0])


def test_shard_layout_flip_reshards_in_step(monkeypatch):
    """The shard-layout dimension: a flip of config.shard_layout between
    steps re-shards every rank in the same step (the MIN vote), and the
    parameters stay bit for bit those of a run that never flipped."""
    from horovod_tpu_torch.core.autotune import ParameterManager
    from horovod_tpu_torch.torch import DistributedOptimizer

    def train(flip):
        bar = threading.Barrier(2)

        def fn():
            rng = np.random.default_rng(0)
            w = torch.from_numpy(rng.standard_normal((6, 5))
                                 .astype(np.float32))
            model = torch.nn.Linear(5, 6, bias=False)
            with torch.no_grad():
                model.weight.copy_(w)
            opt = DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters(), sharded=True)
            eng = tb.engine()
            if thvd.rank() == 0:
                eng.autotuner = ParameterManager(eng.config,
                                                 tune_sharded=True)
            bar.wait()
            layouts = []
            for step in range(3):
                x = torch.from_numpy(np.random.default_rng(
                    10 * step + thvd.rank()).standard_normal((4, 5))
                    .astype(np.float32))
                opt.zero_grad()
                model(x).square().sum().backward()
                if flip and step == 2 and thvd.rank() == 0:
                    eng.config.shard_layout = "flat"
                bar.wait()
                opt.step()
                layouts.append(opt._updater.plan.layout)
            bar.wait()
            if thvd.rank() == 0:
                eng.autotuner = None
                eng.config.shard_layout = "bucket"
            return model.weight.detach().clone(), layouts
        return thvd.run(fn, np=2, device="cpu")
    flipped, plain = train(True), train(False)
    assert [lay for _, lay in flipped] == [["bucket", "bucket", "flat"]] * 2
    for (a, _), (b, _) in zip(flipped, plain):
        assert torch.equal(a, b)
    assert torch.equal(flipped[0][0], flipped[1][0])
