"""The steady-state negotiation bypass (horovod_tpu_torch/core/bypass.py,
the coordinator's ``bypass_ready`` verb, the engine's armed cycle)
against the JAX package's:

(i)   ``BypassState`` driven by the same response and vote scripts in
      both packages: the same fingerprints, votes and armed-cycle
      decisions (the counterparts of tests/test_chaos.py's
      ``test_bypass_*`` tests, and an arm record that follows an
      ineligible cycle);
(ii)  the coordinator's arm quorum and disarm, both coordinators driven
      by one request script with every reply and the arm state compared,
      and the poll's cut at the ``bypass_arm`` record through each
      package's ``StoreController``;
(iii) a real 2-process CPU job at K=3 and a 5 s wait bound under each
      package's launcher (the counterpart of
      ``test_bypass_engage_fallback_rearm_real_job`` and
      tools/_bypass_worker.py): the bypass engages (hits > 0), a new
      tensor falls back with exact results, the bypass arms again, and a
      desynced dtype fails both ranks loudly; every result equals the JAX
      job's, bit for bit (small integers: exact in f32).
Plus the defaults: a multi-process engine arms after 5 stable cycles
unless told otherwise, as the JAX package's does.
"""

import json
import os
import sys
import textwrap

import numpy as np
import pytest

from horovod_tpu.core import bypass as jax_bypass
from horovod_tpu.common import env as jax_env
from horovod_tpu.runner.http import http_server as jax_http
from horovod_tpu.runner.proc_run import launch_procs as jax_launch_procs
from horovod_tpu_torch.common import env as torch_env
from horovod_tpu_torch.core import bypass as torch_bypass
from horovod_tpu_torch.runner.http import contract as torch_contract
from horovod_tpu_torch.runner.http import http_server as torch_http
from horovod_tpu_torch.runner.proc_run import (
    launch_procs as torch_launch_procs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
MODULES = {"jax": jax_bypass, "torch": torch_bypass}


def _meta(key, **over):
    m = dict(key=key, type="ALLREDUCE", dtype="float32", shape=[4], op=1,
             pre=1.0, post=1.0, ps=0, nbytes=16, nprocs=2, root=-1,
             members={"0": [0], "1": [1]}, aux={})
    m.update(over)
    return m


def _batch(key, **over):
    """A coordinator batch response for one allreduce entry."""
    meta = _meta(key, **over)
    return {"kind": "batch", "keys": [key], "metas": {key: meta},
            "aux": {key: {"0": {}, "1": {}}}, "trace": {key: 42}}


def _cycles(bp, responses, n):
    """Feed n identical cycles; the last cycle_complete()."""
    fp = None
    for _ in range(n):
        for r in responses:
            bp.observe_response(r)
        fp = bp.cycle_complete()
    return fp


def _both(script):
    """``script(module)`` for each package; the two traces must be
    equal, and the port's is returned."""
    traces = {name: script(mod) for name, mod in MODULES.items()}
    assert traces["torch"] == traces["jax"], traces
    return traces["torch"]


# -- (i) the state machine ------------------------------------------------------

def test_bypass_engages_after_k_stable_cycles():
    def script(mod):
        bp = mod.BypassState(after_cycles=3, wait_secs=5.0)
        first = _cycles(bp, [_batch("g.0"), _batch("g.1")], 2)
        fp = _cycles(bp, [_batch("g.0"), _batch("g.1")], 1)
        # trace/cache ids are volatile and must not shape the fingerprint
        bp2 = mod.BypassState(after_cycles=3, wait_secs=5.0)
        alt = [dict(_batch("g.0"), trace={"g.0": 999}), _batch("g.1")]
        return first, fp, _cycles(bp2, alt, 3)
    first, fp, alt = _both(script)
    assert first is None and fp is not None and alt == fp


def test_bypass_stability_resets_on_list_or_param_change():
    def script(mod):
        bp = mod.BypassState(after_cycles=2)
        out = [_cycles(bp, [_batch("g.0")], 2)]
        bp.disarm()                     # a wire flip under one name
        _cycles(bp, [_batch("g.0")], 1)
        out.append(_cycles(bp, [_batch("g.0", wire="int8")], 1))
        bp.disarm()                     # a new tensor joins the cycle
        _cycles(bp, [_batch("g.0")], 1)
        out.append(_cycles(bp, [_batch("g.0"), _batch("g.new")], 1))
        bp.disarm()                     # an error poisons the cycle
        _cycles(bp, [_batch("g.0")], 1)
        bp.observe_response({"kind": "error", "key": "g.0",
                             "message": "boom"})
        bp.observe_response(_batch("g.0"))
        out.append(bp.cycle_complete())
        return out
    out = _both(script)
    assert out[0] is not None and out[1:] == [None, None, None]


def test_bypass_arms_on_a_list_voted_before_an_ineligible_cycle():
    """The arm record of a vote may come after an ineligible cycle (a
    barrier): the voted list is kept and arms; the next stable run
    counts from 1 again."""
    def script(mod):
        out = []
        for again in (0, 1):
            bp = mod.BypassState(after_cycles=2)
            fp = _cycles(bp, [_batch("g.0"), _batch("g.1")], 2)
            out.append(_cycles(bp, [_batch("b.0", type="BROADCAST")], 1))
            out.append(_cycles(bp, [_batch("g.0"), _batch("g.1")], again))
            bp.on_arm(fp)
            out.append((fp is not None, bp.active, bp.broken,
                        sorted(bp.keys)))
        return out
    out = _both(script)
    assert out[2] == out[5] == (True, True, False, ["g.0", "g.1"])


def test_bypass_ineligible_kinds_never_vote():
    def script(mod):
        bp = mod.BypassState(after_cycles=1)
        a = _cycles(bp, [_batch("b.0", type="BROADCAST")], 3)
        bp = mod.BypassState(after_cycles=1)
        return a, _cycles(bp, [_batch("p.0", ps=1)], 3)
    assert _both(script) == (None, None)


def test_bypass_armed_decisions_matrix():
    def script(mod):
        bp = mod.BypassState(after_cycles=1, wait_secs=0.5)
        fp = _cycles(bp, [_batch("g.0"), _batch("g.1")], 1)
        bp.on_arm(fp)
        out = [bp.active, bp.broken]
        fps = {k: mod.meta_fingerprint(m)
               for r in bp.responses for k, m in r["metas"].items()}
        out.append(bp.decide(fps, foreign=False))          # match
        out.append(bp.decide({}, foreign=False))           # wait
        out.append(bp.decide(fps, foreign=True))           # foreign set
        out.append(bp.decide({**fps, "g.new": "x"}, foreign=False))
        bad = dict(fps)
        bad["g.0"] = mod.meta_fingerprint(
            _batch("g.0", wire="int8")["metas"]["g.0"])
        out.append(bp.decide(bad, foreign=False))          # params moved
        part = {"g.0": fps["g.0"]}
        out.append(bp.decide(part, foreign=False, now=100.0))
        out.append(bp.decide(part, foreign=False, now=100.7))
        bp._wait_t0 = None
        bp.poison("join")
        out.append(bp.decide(fps, foreign=False))
        return out
    out = _both(script)
    assert out == [True, False, (1, None), None, (0, "mismatch"),
                   (0, "mismatch"), (0, "mismatch"), None, (0, "timeout"),
                   (0, "join")]


def test_bypass_arm_with_unknown_fingerprint_is_broken_not_deadlock():
    """A process whose cycle moved on after voting still arms (else its
    peers' agreement collective would block for ever), but broken: its
    first vote is 0 and the fallback is unanimous."""
    def script(mod):
        bp = mod.BypassState(after_cycles=1)
        _cycles(bp, [_batch("g.0")], 1)
        bp.on_arm("some-other-fingerprint")
        return bp.active, bp.broken, bp.decide({}, foreign=False)
    assert _both(script) == (True, True, (0, "unarmed"))


def test_meta_fingerprint_matches_the_controllers():
    """The bypass's per-entry fingerprint and the response cache's are
    one definition in both packages."""
    from horovod_tpu_torch.core.store_controller import _fingerprint
    m = _meta("k", aux={"dim0s": [[1]]}, error="x", wire="bf16")
    assert torch_bypass.meta_fingerprint(m) == _fingerprint(m) == \
        jax_bypass.meta_fingerprint(m)
    assert torch_bypass.cycle_fingerprint([_batch("a")]) == \
        jax_bypass.cycle_fingerprint([_batch("a")])


# -- (ii) the coordinator -------------------------------------------------------

def _arm_script(c):
    """The request script of test_chaos.py's quorum test; returns the
    replies and the coordinator's bypass state after each request."""
    out = []

    def h(verb, req):
        rep = c.handle(verb, json.loads(json.dumps(req)))
        out.append((rep, c._bypass_armed_fp, dict(c._bypass_votes),
                    sorted(c._pending)))
    vote = lambda p, fp: {"proc": p, "sid": "ab"[p], "round": 0, "fp": fp}
    h("bypass_ready", vote(0, "f1"))      # one vote is not a quorum
    h("bypass_ready", vote(1, "f2"))      # disagreeing votes never arm
    h("ready", {"proc": 0, "nlocal": 1, "round": 0, "rid": 1, "sid": "a",
                "entries": [_meta("r.k")]})  # a report wipes the slate
    h("bypass_ready", vote(0, "f1"))
    h("bypass_ready", vote(1, "f1"))      # agreement arms
    h("bypass_ready", vote(1, "f1"))      # a replayed vote: still armed
    arm_log = [r for r in c._log if r.get("kind") == "bypass_arm"]
    h("ready", {"proc": 0, "nlocal": 1, "round": 0, "rid": 2, "sid": "a",
                "entries": [_meta("s.k")]})  # the fallback disarms
    h("bypass_ready", vote(0, "f3"))
    h("bypass_ready", vote(1, "f3"))      # a new stable phase re-arms
    h("join", {"ps": 0, "rank": 0, "ps_size": 2, "proc": 0, "jid": 1,
               "sid": "a"})               # a join disarms
    return out, arm_log, [r for r in c._log if r.get("kind") == "bypass_arm"]


def test_coordinator_arm_quorum_and_disarm():
    got = _arm_script(torch_http.Coordinator(world_size=2))
    ref = _arm_script(jax_http.Coordinator(world_size=2))
    assert got == ref
    steps, arm_log, arms = got
    assert [s[1] for s in steps] == [None, None, None, None, "f1", "f1",
                                     None, None, "f3", None]
    # the pre-arm race window's pending entry was dropped at arm time
    assert steps[4][3] == [] and steps[2][3] == ["r.k"]
    assert arm_log == [{"kind": "bypass_arm", "fp": "f1"}]
    assert [a["fp"] for a in arms] == ["f1", "f3"]
    # a vote may be replayed after a timeout: one slot a process
    assert "bypass_ready" in torch_contract.REPLAY_SAFE_VERBS


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_poll_truncates_at_bypass_arm_record(pkg):
    """The cursor fence: a batch scheduled AFTER the arm record must not
    be consumed by fast pollers only: every process stops its cursor at
    the arm and resumes from there after a fallback."""
    if pkg == "torch":
        from horovod_tpu_torch.core.store_controller import StoreController
        http = torch_http
    else:
        from horovod_tpu.core.store_controller import StoreController
        http = jax_http
    server = http.RendezvousServer(world_size=1)
    port = server.start()
    try:
        ctrl = StoreController("127.0.0.1", port, None, 0, 1, 1)
        coord = server.coordinator
        with coord._lock:
            coord._log_append({"kind": "batch", "keys": [], "metas": {},
                               "aux": {}, "trace": {}})
            coord._log_append({"kind": "bypass_arm", "fp": "f"})
            coord._log_append({"kind": "batch", "keys": ["late.k"],
                               "metas": {}, "aux": {}, "trace": {}})
        resp = ctrl.poll(wait=0)
        assert [r["kind"] for r in resp] == ["batch", "bypass_arm"]
        assert ctrl._cursor == 2
        resp = ctrl.poll(wait=0)
        assert [r.get("keys") for r in resp
                if r["kind"] == "batch"] == [["late.k"]]
    finally:
        server.stop()


def test_bypass_is_armed_by_default(monkeypatch):
    for var in ("HOROVOD_BYPASS_AFTER_CYCLES", "HOROVOD_BYPASS_WAIT_SECONDS"):
        monkeypatch.delenv(var, raising=False)
    got, ref = torch_env.Config(), jax_env.Config()
    assert (got.bypass_after_cycles, got.bypass_wait_secs) == \
        (ref.bypass_after_cycles, ref.bypass_wait_secs) == (5, 10.0)
    monkeypatch.setenv("HOROVOD_BYPASS_AFTER_CYCLES", "0")
    assert torch_env.Config().bypass_after_cycles == 0


# -- (iii) a real job ----------------------------------------------------------

BYPASS_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    PKG = sys.argv[1]
    if PKG == "jax":
        import horovod_tpu as hvd
        from horovod_tpu import telemetry
        T, N = (lambda a: a), np.asarray
        FAMILY = telemetry.BYPASS_CYCLES_FAMILY
        hits = lambda: telemetry.counter_total(FAMILY, outcome="hit")
        fallbacks = lambda: telemetry.counter_total(FAMILY,
                                                    outcome="fallback")
    else:
        import torch
        import horovod_tpu_torch as hvd
        T, N = torch.from_numpy, (lambda t: t.numpy())
        hits = lambda: hvd.engine().bypass_hits
        fallbacks = lambda: hvd.engine().bypass_fallbacks
    if PKG == "jax":
        from horovod_tpu.common.exceptions import TensorShapeMismatchError
    else:
        from horovod_tpu_torch.common.exceptions import \\
            TensorShapeMismatchError
    hvd.init()
    r = hvd.rank()
    out, log = {}, {}
    x = np.arange(256, dtype=np.float32) * (r + 1)
    # 1: engage after K=3 stable cycles
    for i in range(12):
        out["step%d" % i] = N(hvd.allreduce(T(x + i), op=hvd.Sum,
                                            name="bt.step"))
    log["hits1"] = hits()
    # 2: a new tensor disengages cleanly, with the exact result
    out["new"] = N(hvd.allreduce(T(x), op=hvd.Sum, name="bt.new"))
    log["fallbacks2"] = fallbacks()
    # 3: the steady phase arms again
    for i in range(8):
        out["again%d" % i] = N(hvd.allreduce(T(x - i), op=hvd.Sum,
                                             name="bt.step"))
    log["hits3"] = hits()
    # 4: a desynced rank: rank 1 ships float64 where rank 0 ships
    # float32 under the same name; both ranks must fail loudly
    bad = np.ones(256, np.float64 if r == 1 else np.float32)
    try:
        hvd.allreduce(T(bad), op=hvd.Sum, name="bt.mix")
        log["desync"] = "not detected"
    except TensorShapeMismatchError as exc:
        log["desync"] = "raised"
    # 5: the job still works
    out["after"] = N(hvd.allreduce(T(x), op=hvd.Sum, name="bt.after"))
    hvd.barrier()
    np.savez(os.path.join(os.environ["OUTDIR"], "%s_%d.npz" % (PKG, r)),
             **out)
    with open(os.path.join(os.environ["OUTDIR"], "%s_%d.json" % (PKG, r)),
              "w") as f:
        import json
        json.dump(log, f)
    hvd.shutdown()
""")


@pytest.mark.integration
def test_bypass_engage_fallback_rearm_real_job(tmp_path):
    script = tmp_path / "bypass_worker.py"
    script.write_text(BYPASS_WORKER)
    env = {"PYTHONPATH": REPO, "OUTDIR": str(tmp_path),
           "HOROVOD_BYPASS_AFTER_CYCLES": "3",
           "HOROVOD_BYPASS_WAIT_SECONDS": "5"}
    for pkg, launch in (("torch", torch_launch_procs),
                        ("jax", jax_launch_procs)):
        codes = launch([sys.executable, str(script), pkg], np=2,
                       platform="cpu", env=env, start_timeout=TIMEOUT)
        assert codes == [0, 0], (pkg, codes)
    for r in range(2):
        got = dict(np.load(tmp_path / f"torch_{r}.npz"))
        ref = dict(np.load(tmp_path / f"jax_{r}.npz"))
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and \
                np.array_equal(got[k], ref[k]), (r, k)
        assert np.array_equal(got["new"],
                              np.arange(256, dtype=np.float32) * 3)
        for pkg in ("torch", "jax"):
            log = json.loads((tmp_path / f"{pkg}_{r}.json").read_text())
            assert log["hits1"] > 0, (pkg, r, log)
            assert log["fallbacks2"] >= 1, (pkg, r, log)
            assert log["hits3"] > log["hits1"], (pkg, r, log)
            assert log["desync"] == "raised", (pkg, r, log)


SLOW_WORKER = textwrap.dedent("""
    import json, os, time
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    r = hvd.rank()
    x = torch.arange(64, dtype=torch.float32) * (r + 1)
    outs = [hvd.allreduce(x + i, op=hvd.Sum, name="slow.step").numpy()
            for i in range(8)]
    armed = hvd.engine().bypass_hits
    if r == 0:
        # a checkpoint or an evaluation on one process, longer than the
        # job's process-group timeout, while the others wait in the vote
        time.sleep(float(os.environ["SLOW_SECONDS"]))
    outs += [hvd.allreduce(x - i, op=hvd.Sum, name="slow.step").numpy()
             for i in range(3)]
    with open(os.path.join(os.environ["OUTDIR"], "slow_%d.json" % r),
              "w") as f:
        json.dump({"armed": armed, "hits": hvd.engine().bypass_hits,
                   "fallbacks": hvd.engine().bypass_fallbacks,
                   "outs": [o.tolist() for o in outs]}, f)
    hvd.shutdown()
""")


@pytest.mark.integration
def test_armed_vote_outwaits_a_slow_process(tmp_path):
    """With the bypass armed, a process that stays away longer than the
    process group's timeout (HOROVOD_TPU_INIT_TIMEOUT) neither aborts
    the process waiting for it in the vote nor costs a fallback: the
    vote has a group of its own with no such limit, as the waiting at
    the coordinator had none."""
    script = tmp_path / "slow_worker.py"
    script.write_text(SLOW_WORKER)
    env = {"PYTHONPATH": REPO, "OUTDIR": str(tmp_path),
           "HOROVOD_BYPASS_AFTER_CYCLES": "2",
           "HOROVOD_TPU_INIT_TIMEOUT": "10", "SLOW_SECONDS": "13"}
    codes = torch_launch_procs([sys.executable, str(script)], np=2,
                               platform="cpu", env=env,
                               start_timeout=TIMEOUT)
    assert codes == [0, 0], codes
    x = np.arange(64, dtype=np.float32)
    want = [(x + i) + (x * 2 + i) for i in range(8)] + \
        [(x - i) + (x * 2 - i) for i in range(3)]
    for r in range(2):
        log = json.loads((tmp_path / f"slow_{r}.json").read_text())
        assert log["armed"] > 0, (r, log["armed"])
        assert log["hits"] == log["armed"] + 3, (r, log["hits"])
        assert log["fallbacks"] == 0, (r, log["fallbacks"])
        for got, w in zip(log["outs"], want):
            assert np.array_equal(np.asarray(got, np.float32), w), r
