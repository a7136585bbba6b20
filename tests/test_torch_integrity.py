"""End-to-end step integrity of horovod_tpu_torch (``core/integrity.py``,
the engine's and the compiled path's digests, the chaos bitflip sites,
the elastic loop's verdicts) against the JAX package, on the same
numpy-seeded inputs and the same seeded fault plans.

* The digests (``digest64``, ``fold_fingerprint``, ``BucketWatch``) of
  tensors equal the JAX package's of the same bytes, for every dtype, odd
  lengths, unaligned slices and duplicate words; the plain PyTorch fold
  equals numpy's.
* The drills run both packages' live engines at 4 rank threads (the JAX
  engine on 4 of the 8 virtual CPU devices, its shard mode) under the same
  plan: the same ``fired`` records, the same detections with their
  attributed ranks and messages, the same integrity counters, on every
  collective and wire, and on the 2-D allreduce over a patched two-host
  map.

Tolerance: digests, plans, ``fired`` logs and counters are exact (no
tensor math); the parameters of the replay test are compared bit for bit
(the same float operations in the same order)."""

import json
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu import telemetry as jtel
from horovod_tpu.chaos import inject as jinj
from horovod_tpu.chaos import plan as jplan
from horovod_tpu.common import basics as jb
from horovod_tpu.common.topology import Topology as JTopology
from horovod_tpu.core import integrity as jinteg
from horovod_tpu_torch import telemetry as ttel
from horovod_tpu_torch.chaos import inject as tinj
from horovod_tpu_torch.chaos import plan as tplan
from horovod_tpu_torch.common import basics as tb
from horovod_tpu_torch.common.topology import Topology
from horovod_tpu_torch.core import integrity as tinteg
from horovod_tpu_torch.core.integrity import (
    BucketWatch, HostEvictionError, IntegrityChecker, NonFiniteUpdateError,
    ReplicaDivergenceError, StepSentinel, WireIntegrityError, digest64,
    fold_fingerprint, sentinel_agree)
from horovod_tpu_torch.ops import digest_kernels as dk

NP = 4

DTYPES = [np.float32, np.float16, ml_dtypes.bfloat16, np.float64, np.int8,
          np.uint8, np.int32, np.int64, np.bool_]
LENGTHS = [0, 1, 3, 7, 8, 9, 255, 1025]


def _to_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _to_np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _rand(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.bool_:
        return rng.integers(0, 2, n).astype(np.bool_)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, n, dtype=dtype,
                            endpoint=True)
    return (rng.standard_normal(n) * 100).astype(dtype)


# -- digests ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES,
                         ids=[np.dtype(d).name for d in DTYPES])
def test_digest64_matches_jax_every_dtype(dtype):
    for n in LENGTHS:
        a = _rand(dtype, n, n)
        want = jinteg.digest64([a])
        assert digest64([_to_torch(a)]) == want
        assert digest64([a]) == want
        assert digest64([a.tobytes()]) == want
        assert dk.plain_fold(_to_torch(a)) == dk.np_fold(
            a.reshape(-1).view(np.uint8))
    # several buffers mix in order and length, as in the JAX package
    parts = [_rand(dtype, n, 7 + n) for n in (5, 0, 16)]
    assert digest64([_to_torch(p) for p in parts]) == \
        jinteg.digest64(parts)


@pytest.mark.parametrize("offset", range(8))
def test_digest64_unaligned_slices(offset):
    """Bucket slices start at any byte: the fold counts words from the
    segment's own first byte (the JAX package's unaligned copy)."""
    buf = _rand(np.uint8, 301, 3)
    for n in (0, 5, 8, 17, 64, 290 - offset):
        sl = buf[offset:offset + n]
        t = torch.from_numpy(buf)[offset:offset + n]
        assert digest64([t]) == jinteg.digest64([sl])
        assert dk.plain_fold(t) == dk.np_fold(sl)
    bf = _rand(ml_dtypes.bfloat16, 97, 4)
    tb16 = _to_torch(bf)
    for off in range(1, 9):
        assert digest64([tb16[off:off + 33]]) == \
            jinteg.digest64([bf[off:off + 33]])


def test_digest64_duplicate_words_and_flips():
    """N equal words xor to 0 for even N: the sum keeps such payloads
    apart.  A single flipped bit changes the digest, except the top bits
    of a whole word: bit 63 flips bit 63 of the xor and adds 2**63 to the
    sum, and ``2**63 * 0x9E37...15`` is 2**63 again (the multiplier is
    odd), so the two flips cancel in ``x ^ (s * mix)``; bit 62 cancels
    the same way whenever adding ``+-2**62`` to ``s * mix`` carries into
    no other bit.  Those blind spots are the JAX package's fold, kept bit
    for bit (ROADMAP.md C); on this input only the bit-63 flips are
    missed, as in the JAX package."""
    w = np.full(4, 0x0123456789ABCDEF, np.uint64)
    for k in (2, 4, 6):
        a = np.tile(w, k // 2 * 2)
        assert digest64([torch.from_numpy(a)]) == jinteg.digest64([a])
    assert digest64([np.tile(w, 2)]) != digest64([np.tile(w, 4)])
    a = _rand(np.float32, 17, 1)           # 64 word bytes + a 4-byte tail
    base = digest64([torch.from_numpy(a)])
    assert base == jinteg.digest64([a])
    blind = []
    for byte in range(a.nbytes):
        for bit in range(8):
            b = a.copy()
            b.view(np.uint8)[byte] ^= np.uint8(1 << bit)
            got = digest64([torch.from_numpy(b)])
            assert got == jinteg.digest64([b])
            if got == base:
                blind.append((byte, bit))
    assert blind == [(8 * k + 7, 7) for k in range(8)]


def test_fold_fingerprint_matches_jax():
    rng = np.random.default_rng(5)
    tree = {"b": rng.standard_normal(3), "a": [
        rng.standard_normal((2, 3)).astype(np.float32),
        _rand(ml_dtypes.bfloat16, 9, 2)], "c": np.array(7)}
    ttree = {"b": _to_torch(tree["b"]),
             "a": [_to_torch(x) for x in tree["a"]], "c": tree["c"]}
    assert fold_fingerprint(ttree) == jinteg.fold_fingerprint(tree)
    assert fold_fingerprint(ttree) < (1 << 63)


def test_bucket_watch_matches_jax():
    rows = [(_rand(np.int8, 512, r), _rand(np.float32, 2, 10 + r))
            for r in range(2)]
    trows = [tuple(torch.from_numpy(x.copy()) for x in row)
             for row in rows]
    jw, tw = jinteg.BucketWatch("grad_0+3"), BucketWatch("grad_0+3")
    jw.watch("engine", "cross", "int8", rows, [4, 5])
    tw.watch("engine", "cross", "int8", trows, [4, 5])
    assert tw.fingerprints() == [jw.watches[0][5]]
    assert tw.scan() == jw.scan() == (None, None)
    rows[1][0].view(np.uint8)[17] ^= 1
    trows[1][0].view(torch.uint8)[17] ^= 1
    assert tw.scan() == jw.scan()
    bad, msg = tw.scan()
    assert bad == 5 and "grad_0+3" in msg and "rank 5" in msg


def test_crc_trailers_match_jax():
    blob = b"x" * 100
    assert tinteg.append_crc_trailer(blob) == \
        jinteg.append_crc_trailer(blob)
    trailed = tinteg.append_crc_trailer(blob)
    assert tinteg.strip_crc_trailer(trailed) == blob
    with pytest.raises(tinteg.TrailerCorruptionError) as e:
        tinteg.strip_crc_trailer(trailed[:50] + trailed[51:])
    assert e.value.kind == "truncated"


def test_fold_segments_cpu_is_numpy():
    segs = [torch.from_numpy(_rand(np.uint8, n, n)) for n in (0, 3, 64, 77)]
    got = [dk.to_u64(v) for v in dk.fold_segments(segs).tolist()]
    assert got == [dk.np_fold(s.numpy()) for s in segs]


# -- the drills ---------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.run(lambda: None, np=NP, keep_alive=True)
    thvd.run(lambda: None, np=NP, device="cpu", keep_alive=True)
    yield jb.engine(), tb.engine()
    thvd.shutdown()
    jhvd.shutdown()


def _both(fn):
    j = jhvd.run(lambda: fn(jhvd, lambda x: x, np.asarray), np=NP)
    t = thvd.run(lambda: fn(thvd, _to_torch, _to_np), np=NP)
    return j, t


def _counters(tel):
    fam = tel.INTEGRITY_CHECKS_FAMILY
    return (tel.counter_total(fam, result="corrupt", site="engine"),
            tel.counter_total(fam, result="ok", site="engine"),
            tel.counter_total(tel.INTEGRITY_ROLLBACKS_FAMILY))


class _Armed:
    """Both engines under one seeded plan (and config), restored after."""

    def __init__(self, engines, events, seed=7, **config):
        self.engines = engines
        self.events = events
        self.seed = seed
        self.config = config

    def __enter__(self):
        doc = {"seed": self.seed, "events": self.events}
        self.saved = []
        for eng, inj, pl, integ in (
                (self.engines[0], jinj, jplan, jinteg),
                (self.engines[1], tinj, tplan, tinteg)):
            self.saved.append((eng, eng.chaos, eng.integrity, {
                k: getattr(eng.config, k) for k in self.config}))
            eng.chaos = inj.FaultInjector(pl.parse_plan(doc), proc=0,
                                          rank_offset=0, num_local=NP) \
                if self.events else None
            eng.integrity = integ.IntegrityChecker(evict_after=0)
            for k, v in self.config.items():
                setattr(eng.config, k, v)
        return self

    def fired(self):
        return [json.dumps(e.chaos.fired, sort_keys=True)
                for e, *_ in self.saved]

    def __exit__(self, *exc):
        for eng, chaos, integ, cfg in self.saved:
            eng.chaos, eng.integrity = chaos, integ
            for k, v in cfg.items():
                setattr(eng.config, k, v)


def _op(mod, to, coll, x, i):
    t = to(x)
    if coll == "allreduce":
        return mod.allreduce(t, op=mod.Sum, name=f"d.{i}")
    if coll == "reducescatter":
        return mod.reducescatter(t, op=mod.Sum, name=f"d.{i}")
    if coll == "allgather":
        return mod.allgather(t, name=f"d.{i}")
    return mod.alltoall(t, name=f"d.{i}")[0]


def _drill_fn(coll, steps=3):
    bar = threading.Barrier(NP)

    def fn(mod, to, back):
        r = mod.rank()
        x = np.random.RandomState(r).randn(32, 40).astype(np.float32)
        tel = jtel if mod is jhvd else ttel
        bar.wait()
        before = _counters(tel)
        bar.wait()
        errs = []
        for i in range(steps):
            try:
                _op(mod, to, coll, x, i)
                errs.append(None)
            except Exception as e:  # noqa: BLE001 — compared by class
                errs.append((type(e).__name__, getattr(e, "rank", None),
                             str(e)))
        bar.wait()
        delta = tuple(a - b for a, b in zip(_counters(tel), before))
        return errs, delta
    return fn


DRILLS = [(c, w, k)
          for c in ("allreduce", "reducescatter", "alltoall")
          for w in (None, "fp16", "int8", "int4")
          for k in ("bitflip_grad", "bitflip_wire")] + \
    [("allgather", None, k) for k in ("bitflip_grad", "bitflip_wire")]


@pytest.mark.parametrize("coll,wire,kind", DRILLS)
def test_engine_flips_detected_like_jax(engines, coll, wire, kind):
    """A flip at the second bucket, on rank 0 (grad: the packed payload;
    wire: the encoded rows): both packages fire the same byte, detect it
    in the same bucket, attribute it to rank 0 on every rank, count one
    corrupt check and one rollback, and go on clean."""
    events = [{"kind": kind, "proc": 0, "after_buckets": 2}]
    with _Armed(engines, events, wire_dtype=wire) as armed:
        j, t = _both(_drill_fn(coll))
        fired = armed.fired()
    assert fired[0] == fired[1] and json.loads(fired[1])
    assert j == t
    for errs, delta in t:
        assert errs[0] is None and errs[2] is None
        assert errs[1][0] == "WireIntegrityError" and errs[1][1] == 0
        assert delta[0] == 1 and delta[2] == 1


@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("kind", ["bitflip_grad", "bitflip_wire"])
def test_engine_flips_2d_like_jax(engines, wire, kind):
    """The hierarchical allreduce over a two-host map: the codec runs
    inside the decomposition, so both sites flip the packed rows and the
    payload folds catch them, as in the JAX package."""
    old = engines[0].topology, engines[1].topology
    engines[0].topology = JTopology(size=NP, host_of_rank=[0, 0, 1, 1])
    engines[1].topology = Topology(size=NP, host_of_rank=[0, 0, 1, 1])
    events = [{"kind": kind, "proc": 0, "after_buckets": 1}]
    try:
        with _Armed(engines, events, wire_dtype=wire,
                    algorithm="hierarchical") as armed:
            j, t = _both(_drill_fn("allreduce", steps=2))
            fired = armed.fired()
    finally:
        engines[0].topology, engines[1].topology = old
    assert fired[0] == fired[1]
    assert j == t
    assert all(errs[0][0] == "WireIntegrityError" and errs[1] is None
               for errs, _d in t)


def test_same_seed_fired_identical(engines):
    events = [{"kind": "bitflip_wire", "proc": 0, "after_buckets": 2},
              {"kind": "bitflip_grad", "proc": 0, "after_buckets": 3}]
    logs = []
    for _ in range(2):
        with _Armed(engines, events) as armed:
            fn = _drill_fn("allreduce", 4)
            thvd.run(lambda: fn(thvd, _to_torch, _to_np), np=NP)
            logs.append(armed.fired()[1])
    assert logs[0] == logs[1] and len(json.loads(logs[0])) == 2


def test_integrity_off_trains_on_garbage(engines):
    """With the digests off the flip goes through silently, into the
    same corrupted sum as the JAX package's."""
    events = [{"kind": "bitflip_grad", "proc": 0, "after_buckets": 1}]

    def fn(mod, to, back):
        x = np.ones(512, np.float32)
        return back(mod.allreduce(to(x), op=mod.Sum, name="off.0"))
    with _Armed(engines, events):
        engines[0].integrity = engines[1].integrity = None
        j, t = _both(fn)
    assert all(np.array_equal(a, b) for a, b in zip(j, t))
    assert not np.array_equal(t[0], np.full(512, NP, np.float32))


def test_payload_changed_between_submit_and_pack(engines):
    """A payload written between its submit and the bucket's pack (rank 2
    changes one element after its async submit, before its peers
    submit).  The JAX package digests each payload at submit, so it
    quarantines the step and attributes it to rank 2 on every rank.  The
    port folds each payload's packed slice right after the pack, so its
    check spans the pack to the verdict: the written value is packed and
    reduced as written, and the check counts ok (ROADMAP C).  Both
    outputs are pinned."""
    bar = threading.Barrier(NP)

    def fn(mod, to, back):
        r = mod.rank()
        x = to(np.arange(64, dtype=np.float32) + r)
        tel = jtel if mod is jhvd else ttel
        bar.wait()
        before = _counters(tel)
        bar.wait()
        if r == 2:
            h = mod.allreduce_async(x, op=mod.Sum, name="late.0")
            x[5] = 1000.0
        bar.wait()
        if r != 2:
            h = mod.allreduce_async(x, op=mod.Sum, name="late.0")
        out = err = None
        try:
            out = back(mod.synchronize(h))
        except Exception as e:  # noqa: BLE001 — compared by class
            err = (type(e).__name__, getattr(e, "rank", None), str(e))
        bar.wait()
        return err, tuple(a - b for a, b in zip(_counters(tel), before)), \
            out
    with _Armed(engines, []):
        j, t = _both(fn)
    want = sum(np.arange(64, dtype=np.float32) + r for r in range(NP))
    want[5] += 1000.0 - (5 + 2)
    for err, delta, out in j:
        assert err[:2] == ("WireIntegrityError", 2)
        assert "between submit and encode" in err[2]
        assert delta == (1.0, 0.0, 1.0) and out is None
    for err, delta, out in t:
        assert err is None and delta == (0.0, 1.0, 0.0)
        assert np.array_equal(out, want)


def test_quarantine_resets_every_wire_state(engines):
    """quarantine_step poisons an armed bypass (disarms a cold one),
    drops the tuner's in-flight sample and clears the engine's, the
    compiled path's and the frontends' error-feedback residuals."""
    from horovod_tpu_torch.core.autotune import ParameterManager
    from horovod_tpu_torch.core.bypass import BypassState
    from horovod_tpu_torch.ops import compiled as tc
    from horovod_tpu_torch.torch import Compression, DistributedOptimizer

    te = engines[1]
    te.autotuner = ParameterManager(te.config)
    thvd.bind_rank(0)
    try:
        te.autotuner.record_bytes(1 << 20)
        assert te.autotuner._steps == 1
        bp = BypassState(2, 1.0)
        bp.active = True
        te._bypass = bp
        te._a2a_ef[(0, 0)] = torch.zeros(4)
        tc._A2A_EF[("k",)] = torch.zeros(4)
        red = tc.CompiledGroupedAllreduce(wire_dtype="int8",
                                          error_feedback=True)
        red._residuals[("s", 0, 0)] = torch.zeros(4)
        model = torch.nn.Linear(4, 2)
        opt = DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            compression=Compression.int8)
        opt._residuals[next(model.parameters())] = torch.zeros(2, 4)
        te.quarantine_step("wire_checksum", rank=0)
        assert te.autotuner._steps == 0 and te.autotuner._t0 is None
        assert bp._poison == "integrity"
        assert not te._a2a_ef and not tc._A2A_EF
        assert not red._residuals and not opt._residuals
        bp2 = BypassState(2, 1.0)
        bp2._stable = 5
        te._bypass = bp2
        te.quarantine_step("wire_checksum", rank=0)
        assert bp2._stable == 0 and not bp2.active
    finally:
        thvd.unbind_rank()
        te.autotuner = None
        te._bypass = None


def test_eviction_after_three_detections(engines):
    """The default scoreboard (HOROVOD_INTEGRITY_EVICT_AFTER=3): the
    third detection implicating one rank is a HostEvictionError, in the
    same step as in the JAX package."""
    events = [{"kind": "bitflip_wire", "proc": 0, "after_buckets": 1,
               "count": 8}]
    with _Armed(engines, events, seed=3):
        engines[0].integrity = jinteg.IntegrityChecker()
        engines[1].integrity = IntegrityChecker()
        j, t = _both(_drill_fn("allreduce", 8))
    assert j == t
    errs = t[0][0]
    seen, evicted = {}, []
    for e in errs:
        seen[e[1]] = seen.get(e[1], 0) + 1
        evicted.append(e[0] == "HostEvictionError")
        assert evicted[-1] == (seen[e[1]] >= 3)
    assert any(evicted)


def test_compiled_detection_like_jax(engines):
    """The compiled reducer: the chaos sites fire on the primary rank
    thread, the detecting rank raises at result() with quarantine=False,
    its residuals are dropped, and the fired records are the JAX
    package's."""
    events = [{"kind": "bitflip_wire", "proc": 0, "after_buckets": 2}]
    reds = {}

    def fn(mod, to, back):
        red = reds.setdefault(mod.__name__, mod.CompiledGroupedAllreduce(
            op=mod.Sum, name="cme", force_program=True, wire_dtype="int8",
            error_feedback=True))
        x = np.random.RandomState(mod.rank()).randn(512).astype(np.float32)
        out = []
        for _ in range(3):
            try:
                red([to(x)])
                out.append(None)
            except Exception as e:  # noqa: BLE001 — compared by class
                out.append((type(e).__name__, e.rank, e.site,
                            getattr(e, "quarantine", None)))
        return out
    with _Armed(engines, events) as armed:
        j, t = _both(fn)
        fired = armed.fired()
    assert fired[0] == fired[1]
    assert j == t
    assert t[0][1] == ("WireIntegrityError", 0, "compiled", False)
    assert all(r == [None, None, None] for r in t[1:])


# -- the elastic loop ---------------------------------------------------------

def _run_fn_case(errors):
    from horovod_tpu_torch.common.elastic import run_fn
    calls = {"n": 0, "restored": 0, "reset": 0, "synced": 0}

    class S:
        def sync(self):
            calls["synced"] += 1

        def restore(self):
            calls["restored"] += 1

        def on_reset(self):
            pass

    def body(state):
        calls["n"] += 1
        if calls["n"] <= len(errors):
            raise errors[calls["n"] - 1]
        return "done"

    def reset():
        calls["reset"] += 1

    wrapped = run_fn(body, reset=reset)
    return wrapped, S(), calls


def test_run_fn_reraises_eviction_and_replays_quarantine(monkeypatch):
    from horovod_tpu_torch.common import elastic
    from horovod_tpu_torch.common.exceptions import HorovodInternalError

    class _NM:
        def init(self):
            pass

        def register_listener(self, s):
            pass

        def remove_listener(self, s):
            pass
    monkeypatch.setattr(elastic, "_get_notification_manager", _NM)
    wrapped, s, calls = _run_fn_case([
        WireIntegrityError("flip", rank=0),
        HostEvictionError("bad host", rank=0)])
    with pytest.raises(HostEvictionError):
        wrapped(s)
    # the wire error restored and replayed in place (no reset); the
    # eviction re-raised without another restore
    assert calls == {"n": 2, "restored": 1, "reset": 0, "synced": 2}
    wrapped, s, calls = _run_fn_case([HorovodInternalError("peer died")])
    assert wrapped(s) == "done"
    assert calls["restored"] == 1 and calls["reset"] == 1
    err = WireIntegrityError("compiled flip", rank=1)
    err.quarantine = False
    wrapped, s, calls = _run_fn_case([err])
    assert wrapped(s) == "done" and calls["reset"] == 1


# -- sentinel and guards ------------------------------------------------------

def test_sentinel_agree_shapes():
    fp_a = fold_fingerprint({"w": torch.ones(8)})
    fp_b = fold_fingerprint({"w": torch.ones(8) * 2})

    def fake_min(parties):
        def f(arr):
            return np.min(np.stack([tinteg._sentinel_words(p)
                                    for p in parties]), axis=0)
        return f
    assert sentinel_agree(fp_a, fake_min([fp_a, fp_a]))
    assert not sentinel_agree(fp_a, fake_min([fp_a, fp_b]))
    assert np.array_equal(tinteg._sentinel_words(fp_a),
                          jinteg._sentinel_words(fp_a))


def test_sentinel_rounds_and_guards(engines):
    """At 4 rank threads: an agreeing round counts ok; a rank whose
    parameters differ is named the suspect on every rank; the guards
    reject a nonfinite gradient and a norm over the bound on the
    gradient's device, reading one scalar."""
    bar = threading.Barrier(NP)

    def fn():
        r = thvd.rank()
        s = StepSentinel(every=2, max_grad_norm=10.0)
        params = {"w": torch.ones(32)}
        assert s.after_step(params, grads={"g": torch.ones(4)}) is False
        assert s.after_step(params) is True
        bar.wait()
        ok = ttel.counter_total(ttel.INTEGRITY_CHECKS_FAMILY, result="ok",
                                site="sentinel")
        bad = {"w": torch.ones(32) * (2 if r == 3 else 1)}
        try:
            s.check(bad)
            suspects = None
        except ReplicaDivergenceError as e:
            suspects = e.suspects
        with pytest.raises(NonFiniteUpdateError):
            s.guard_update({"g": torch.tensor([1.0, float("nan")])})
        with pytest.raises(NonFiniteUpdateError, match="norm"):
            s.guard_update({"g": torch.full((100,), 5.0)})
        s.guard_update({"step": torch.tensor(7)})
        return ok, suspects
    res = thvd.run(fn, np=NP)
    assert all(ok >= NP for ok, _ in res)
    assert all(sus == (3,) for _, sus in res)
    assert ttel.INTEGRITY_SENTINEL_SECONDS_FAMILY in thvd.metrics()


# -- the spill site -----------------------------------------------------------

def test_spill_site_counts_like_jax(monkeypatch, tmp_path):
    """A ``corrupt_spill`` flip on the second commit: a fresh state falls
    back to the previous commit and counts one corrupt and one ok check
    at the ``spill`` site, as the JAX package's does."""
    from horovod_tpu.common import elastic as jel
    from horovod_tpu_torch.common import elastic as tel
    doc = {"seed": 5, "events": [
        {"kind": "corrupt_spill", "proc": 0, "after_commits": 2}]}
    got = {}
    for name, el, tele, inj, pl in (("jax", jel, jtel, jinj, jplan),
                                    ("torch", tel, ttel, tinj, tplan)):
        spill = tmp_path / name
        spill.mkdir()
        monkeypatch.setenv("HOROVOD_STATE_SPILL", str(spill))
        monkeypatch.setenv("HOROVOD_HOSTNAME", "h")
        monkeypatch.setenv("HOROVOD_LOCAL_RANK", "0")
        inj._reset_for_tests()
        inj.install(pl.parse_plan(doc), proc=0)
        st = el.ObjectState(bcast_object=lambda o, **k: o,
                            get_rank=lambda: 0, x=0)
        for v in (1, 2):
            st.x = v
            st.commit()
        fired = inj.current().fired
        inj._reset_for_tests()
        fam = tele.INTEGRITY_CHECKS_FAMILY
        before = [tele.counter_total(fam, result=r, site="spill")
                  for r in ("corrupt", "ok")]
        fresh = el.ObjectState(bcast_object=lambda o, **k: o,
                               get_rank=lambda: 0, x=-1)
        after = [tele.counter_total(fam, result=r, site="spill")
                 for r in ("corrupt", "ok")]
        got[name] = (fresh.x, [a - b for a, b in zip(after, before)],
                     json.dumps(fired, sort_keys=True))
    assert got["jax"] == got["torch"]
    assert got["torch"][:2] == (1, [1, 1])
