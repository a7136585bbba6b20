"""The port's chaos subsystem (horovod_tpu_torch/chaos) against the JAX
package's, on the same plans and seeds, in this process.

* Plans parse to the same events, or raise the same error class, in both
  packages; the kinds and triggers whose consumer the port has not
  ported raise ``NotImplementedError`` naming the ROADMAP.md item, and
  only those.
* Same-seed fire sequences are byte-identical across the packages: the
  ``FaultInjector``'s (request, collective and commit triggers, with
  ``p`` coins), the ``CoordFaultRunner``'s against a journaled
  rendezvous server, and the ``AggFaultRunner``'s against an aggregator
  server stand-in; the corrupted spill blob too.
* The wire actions (drop, delay, duplicate, injected 5xx) through each
  package's ``StoreClient`` against each package's coordinator: the same
  replies, the same coordinator state, the client retrying what it must.
* Coordinator-side rules (``http_error``, ``delay_ms``) answered the same
  way, the client's 5xx retries riding them out.

Exact comparisons: the modules are framework-free; the injected delays
are a few milliseconds and enter no comparison.
"""

import dataclasses
import json
import threading
import time
import types

import numpy as np
import pytest

from horovod_tpu import chaos as jax_chaos
from horovod_tpu.chaos import inject as jax_inject
from horovod_tpu.chaos import plan as jax_plan
from horovod_tpu.runner.http import http_client as jax_client
from horovod_tpu.runner.http import http_server as jax_http

from horovod_tpu_torch import chaos as torch_chaos
from horovod_tpu_torch.chaos import inject as torch_inject
from horovod_tpu_torch.chaos import plan as torch_plan
from horovod_tpu_torch.runner.http import http_client as torch_client
from horovod_tpu_torch.runner.http import http_server as torch_http

PKGS = {
    "jax": types.SimpleNamespace(chaos=jax_chaos, inject=jax_inject,
                                 plan=jax_plan, client=jax_client,
                                 http=jax_http),
    "torch": types.SimpleNamespace(chaos=torch_chaos, inject=torch_inject,
                                   plan=torch_plan, client=torch_client,
                                   http=torch_http),
}


def _events(plan):
    return [dataclasses.asdict(e) for e in plan.events]


def _parse(pkg, doc, seed=None):
    try:
        plan = PKGS[pkg].plan.parse_plan(json.dumps(doc),
                                         seed_override=seed)
        return ("ok", plan.seed, _events(plan))
    except Exception as exc:  # noqa: BLE001 — the class is compared
        return ("error", type(exc).__name__)


# -- parsing ------------------------------------------------------------------------

PLANS = [
    {"seed": 1234, "events": [
        {"kind": "kill", "proc": 1, "after_collectives": 3},
        {"kind": "exit", "proc": 0, "code": 3, "after_s": 5.0},
        {"kind": "hang", "proc": 1, "after_requests": 40},
        {"kind": "slow_rank", "rank": 1, "ms": 2500,
         "after_collectives": 2, "count": 1},
        {"kind": "drop", "proc": 0, "after_requests": 10, "count": 2},
        {"kind": "delay_ms", "proc": 0, "ms": 200, "after_requests": 5,
         "count": 4},
        {"kind": "duplicate", "proc": 0, "after_requests": 7},
        {"kind": "http_error", "proc": 0, "code": 503,
         "after_requests": 8, "count": 3},
        {"kind": "http_error", "side": "coord", "proc": 0, "verb": "poll",
         "code": 503, "after": 5, "count": 3},
        {"kind": "clock_skew", "proc": 1, "ms": 5000, "after_s": 2.0},
        {"kind": "coord_restart", "after_s": 5.0, "ms": 3000},
        {"kind": "coord_kill", "after": 200},
        {"kind": "agg_restart", "proc": 0, "after_s": 3.0, "ms": 1500},
        {"kind": "agg_kill", "proc": 1, "after_s": 8.0},
        {"kind": "corrupt_spill", "proc": 0, "after_commits": 2}]},
    {"events": [{"kind": "delay_ms", "proc": 0, "ms": 1, "p": 0.3,
                 "after_requests": 1, "count": 5}]},
    {},
    # malformed: each raises ValueError in both packages
    {"events": [{"kind": "nope", "after_s": 1}]},
    {"events": [{"kind": "kill", "after_collectives": 1}]},
    {"events": [{"kind": "kill", "proc": 0}]},
    {"events": [{"kind": "kill", "proc": 0, "after_s": 1,
                 "after_requests": 2}]},
    {"events": [{"kind": "coord_restart", "after": 1}]},
    {"events": [{"kind": "agg_restart", "after_collectives": 1,
                 "ms": 5}]},
    {"events": [{"kind": "slow_rank", "rank": 0, "after_s": 1}]},
    {"events": [{"kind": "drop", "proc": 0, "p": 0.0,
                 "after_requests": 1}]},
    {"events": [{"kind": "drop", "proc": 0, "count": 0,
                 "after_requests": 1}]},
    {"events": [{"kind": "http_error", "side": "coord",
                 "after_requests": 1}]},
    {"events": [{"kind": "drop", "side": "agg", "after_s": 1}]},
    {"events": [{"kind": "corrupt_spill", "proc": 0, "after_s": 1}]},
    {"events": [{"kind": "kill", "proc": 0, "after_requests": -1}]},
    {"events": [{"kind": "kill", "proc": 0, "side": "moon",
                 "after_s": 1}]},
    [1, 2],
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_plans_parse_alike(i):
    doc = PLANS[i]
    jax_out, torch_out = _parse("jax", doc), _parse("torch", doc)
    assert torch_out == jax_out
    if i >= 3:
        assert torch_out == ("error", "ValueError")


def test_seed_override_and_sources(tmp_path, monkeypatch):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLANS[1]))
    for source in (json.dumps(PLANS[1]), str(path), f"@{path}"):
        assert torch_plan.read_plan_source(source) == \
            jax_plan.read_plan_source(source)
        for pkg in PKGS:
            plan = PKGS[pkg].plan.load_plan(source, seed_override=9)
            assert plan.seed == 9
    monkeypatch.setenv("HOROVOD_FAULT_PLAN", str(path))
    monkeypatch.setenv("HOROVOD_FAULT_SEED", "5")
    assert _events(torch_plan.plan_from_env()) == \
        _events(jax_plan.plan_from_env())
    assert torch_plan.plan_from_env().seed == 5
    monkeypatch.delenv("HOROVOD_FAULT_PLAN")
    assert torch_plan.plan_from_env() is None


REFUSED = [
    ({"kind": "bitflip_grad", "proc": 1, "after_buckets": 3}, "A14"),
    ({"kind": "bitflip_wire", "proc": 1, "after_buckets": 6}, "A14"),
    ({"kind": "revoke_host", "host": "host3", "after": 12},
     "A17's fleet"),
    ({"kind": "restore_host", "proc": 2, "after_s": 4.0},
     "A17's fleet"),
    ({"kind": "kill_shard_server", "proc": 0, "after_samples": 5},
     "A17's data plane"),
    ({"kind": "kill", "proc": 0, "after_predicts": 3}, "A16"),
    ({"kind": "delay_ms", "proc": 0, "ms": 5, "after_decodes": 2},
     "A16"),
]


@pytest.mark.parametrize("event,item", REFUSED)
def test_unported_kinds_are_refused_naming_their_item(event, item):
    """The JAX package takes these; the port refuses each with the
    ROADMAP.md item that ports its consumer."""
    doc = {"events": [{"kind": "kill", "proc": 0, "after_s": 1}, event]}
    assert _parse("jax", doc)[0] == "ok"
    with pytest.raises(NotImplementedError, match=item):
        torch_plan.parse_plan(doc)
    # a malformed event of a refused kind is malformed first
    bad = dict(event, count=0)
    assert _parse("torch", {"events": [bad]}) == \
        _parse("jax", {"events": [bad]}) == ("error", "ValueError")


# -- fire sequences -----------------------------------------------------------------

def _injector_plan(seed):
    rs = np.random.RandomState(seed)
    events = []
    for _ in range(rs.randint(2, 6)):
        kind = rs.choice(["delay_ms", "drop", "duplicate", "http_error",
                          "slow_rank", "clock_skew"])
        trig = "after_collectives" if kind == "slow_rank" else \
            str(rs.choice(["after_requests", "after_collectives"]))
        ev = {"kind": str(kind), trig: int(rs.randint(0, 12)),
              "count": int(rs.randint(1, 5)),
              "p": float(rs.choice([1.0, 0.5, 0.25]))}
        if kind == "slow_rank":
            ev.update(rank=int(rs.randint(0, 2)), ms=1)
        else:
            ev.update(proc=int(rs.randint(0, 2)), ms=1)
        events.append(ev)
    events.append({"kind": "corrupt_spill", "proc": 0,
                   "after_commits": int(rs.randint(1, 3)),
                   "count": 2, "p": 0.5})
    return {"seed": int(rs.randint(0, 1000)), "events": events}


def _injector_run(pkg, doc, proc):
    m = PKGS[pkg]
    plan = m.plan.parse_plan(doc)
    inj = m.inject.FaultInjector(plan, proc=proc, rank_offset=proc,
                                 num_local=1)
    actions = []
    for i in range(30):
        actions.append(inj.before_request("POST", "/coord/ready"))
        if i % 3 == 0:
            inj.on_collectives(2)
    blobs = [inj.corrupt_spill(bytes(range(64))).hex() for _ in range(4)]
    return json.dumps({"fired": inj.fired, "actions": actions,
                       "blobs": blobs, "skew": inj.skew_seconds()},
                      sort_keys=True)


@pytest.mark.parametrize("seed", range(8))
def test_injector_fire_sequences_match(seed):
    doc = _injector_plan(seed)
    for proc in (0, 1):
        assert _injector_run("torch", doc, proc) == \
            _injector_run("jax", doc, proc)


def test_install_rebinds_one_injector():
    """``install`` is idempotent per process: a second call (an elastic
    re-init, a second rank thread's init) retargets the one injector and
    keeps its counters; its client hook rides the given client."""
    plan = torch_plan.parse_plan(
        {"events": [{"kind": "slow_rank", "rank": 3, "ms": 1,
                     "after_collectives": 1}]})
    torch_inject._reset_for_tests()
    try:
        client = torch_client.StoreClient("127.0.0.1", 1)
        a = torch_chaos.install(plan, proc=0, rank_offset=0, num_local=2,
                                client=client)
        assert torch_chaos.current() is a and client.middleware is a
        a.on_collectives(1)
        b = torch_chaos.install(plan, proc=1, rank_offset=2, num_local=2)
        assert b is a and (a.proc, a.rank_offset) == (1, 2)
        assert a._collectives == 1
    finally:
        torch_inject._reset_for_tests()


class _FakeAggServer:
    def __init__(self):
        self.aggregator = types.SimpleNamespace(requests=0)
        self.calls = []

    def stop_http(self):
        self.calls.append("stop")

    def restart(self):
        self.calls.append("restart")


def _agg_runner(pkg, doc):
    m = PKGS[pkg]
    srv = _FakeAggServer()
    runner = m.inject.AggFaultRunner(srv, m.plan.parse_plan(doc),
                                     agg_index=0).start()
    for n in range(1, 12):
        srv.aggregator.requests = n
        time.sleep(0.06)
    deadline = time.monotonic() + 5
    while len(runner.fired) < len(runner.events) and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    runner.stop()
    return json.dumps({"fired": runner.fired, "calls": srv.calls},
                      sort_keys=True)


def test_agg_runner_fire_sequences_match():
    doc = {"seed": 3, "events": [
        {"kind": "agg_restart", "proc": 0, "after": 4, "ms": 10},
        {"kind": "agg_kill", "after_s": 0.2},
        {"kind": "agg_restart", "proc": 1, "after": 2, "ms": 10}]}
    got = {pkg: _agg_runner(pkg, doc) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    fired = json.loads(got["torch"])["fired"]
    assert sorted(r["event"] for r in fired) == [0, 1]


def _coord_runner(pkg, tmp_path, doc):
    """A journaled server with the plan's coordinator rules and runner;
    ``clock`` requests drive its request triggers.  Returns the runner's
    record, the epoch after it and every client reply."""
    m = PKGS[pkg]
    env = {"HOROVOD_FAULT_PLAN": json.dumps(doc)}
    server = m.http.RendezvousServer(
        world_size=1, journal_path=str(tmp_path / f"{pkg}.jsonl"))
    m.inject.install_coordinator_rules(server.coordinator, env)
    port = server.start()
    runner = m.inject.start_coordinator_faults(server, env)
    client = m.client.StoreClient("127.0.0.1", port)
    client.outage_deadline = 10.0
    try:
        replies = []
        for i in range(6):
            out = client.coord("clock", {})
            replies.append(sorted(out))
            time.sleep(0.1)
        deadline = time.monotonic() + 5
        while len(runner.fired) < len(runner.events) and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        return json.dumps({"fired": runner.fired, "replies": replies,
                           "epoch": server.coordinator.coord_epoch,
                           "port": server.port == port}, sort_keys=True)
    finally:
        runner.stop()
        server.stop()


def test_coord_runner_fire_sequences_match(tmp_path):
    """``coord_restart`` on the 2nd ``clock`` request rebuilds the
    coordinator from its journal on the same port (epoch 2); the
    client's requests ride the outage.  Both packages record the same."""
    doc = {"seed": 11, "events": [
        {"kind": "coord_restart", "verb": "clock", "after": 2, "ms": 200}]}
    got = {pkg: _coord_runner(pkg, tmp_path, doc) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    out = json.loads(got["torch"])
    assert out["epoch"] == 2 and out["port"] is True
    assert out["fired"] == [{"event": 0, "kind": "coord_restart",
                             "n": 2.0, "trigger": "requests"}]


# -- wire actions and coordinator-side rules ---------------------------------------

def _meta(key):
    return {"key": key, "type": "ALLREDUCE", "dtype": "float32",
            "shape": [2], "op": 1, "pre": 1.0, "post": 1.0, "ps": 0,
            "nbytes": 8, "nprocs": 1, "nranks": 1, "root": -1,
            "members": {"0": [0]}, "aux": {}}


def _wire_run(pkg, doc):
    """Ready reports and polls through a client whose middleware is the
    plan's injector, against a live coordinator with the plan's
    coordinator-side rules."""
    m = PKGS[pkg]
    plan = m.plan.parse_plan(doc)
    server = m.http.RendezvousServer(world_size=1)
    m.inject.install_coordinator_rules(
        server.coordinator, {"HOROVOD_FAULT_PLAN": json.dumps(doc)})
    port = server.start()
    client = m.client.StoreClient("127.0.0.1", port)
    client._retry_base = 0.001
    client._retry_cap = 0.002
    inj = m.inject.FaultInjector(plan, proc=0)
    client.middleware = inj
    try:
        replies = []
        for i in range(8):
            replies.append(client.coord("ready", {
                "proc": 0, "round": 0, "rid": i + 1, "sid": "s",
                "entries": [_meta(f"k{i}")]}))
            out = client.coord("poll", {"cursor": 0, "wait": 0, "proc": 0,
                                        "round": 0})
            replies.append([r.get("keys") for r in out["responses"]])
        with server.coordinator._lock:
            state = {"log": [r.get("keys") for r in server.coordinator._log],
                     "seen": server.coordinator._ready_seen,
                     "injected": server.coordinator._chaos_injected}
        return json.dumps({"replies": replies, "fired": inj.fired,
                           "state": state}, sort_keys=True), client
    finally:
        server.stop()


def test_wire_actions_and_coordinator_rules_match():
    """A drop (the client reconnects and re-sends), a delay, a duplicate
    (the coordinator's rid dedup keeps it single-apply), injected 503s
    on both sides of the wire (the client retries them): the same
    replies, coordinator state and fired records in both packages; every
    report is scheduled once."""
    doc = {"seed": 5, "events": [
        {"kind": "drop", "proc": 0, "after_requests": 2},
        {"kind": "delay_ms", "proc": 0, "ms": 2, "after_requests": 4,
         "count": 2},
        {"kind": "duplicate", "proc": 0, "after_requests": 7},
        {"kind": "http_error", "proc": 0, "code": 503,
         "after_requests": 9, "count": 2},
        {"kind": "http_error", "side": "coord", "proc": 0,
         "verb": "poll", "code": 503, "after": 3, "count": 2},
        {"kind": "delay_ms", "side": "coord", "verb": "ready",
         "after": 5, "ms": 2}]}
    got = {pkg: _wire_run(pkg, doc) for pkg in PKGS}
    assert got["torch"][0] == got["jax"][0]
    out = json.loads(got["torch"][0])
    assert out["state"]["log"] == [[f"k{i}"] for i in range(8)]
    assert out["state"]["injected"] == {"coord_http_error": 2,
                                        "coord_stall": 1}
    client = got["torch"][1]
    # the drop reconnects at once; each 503 (client- or coordinator-side)
    # is one retry
    assert client.retries["ready"] >= 1 and client.retries["poll"] >= 2
    assert client.coord_requests == {"ready": 8, "poll": 8}


def test_client_gives_up_on_a_persistent_5xx():
    """A coordinator that keeps answering 503 exhausts the client's
    attempt budget (it is sick, not gone: no outage deadline)."""
    server = torch_http.RendezvousServer(world_size=1)
    server.coordinator.add_chaos_rule("http_error", verb="poll",
                                      count=100, code=503)
    port = server.start()
    try:
        client = torch_client.StoreClient("127.0.0.1", port)
        client.retry_attempts = 3
        client._retry_base = 0.001
        client._retry_cap = 0.002
        with pytest.raises(Exception, match="503"):
            client.coord("poll", {"cursor": 0, "wait": 0})
        assert client.retries["poll"] == 2
    finally:
        server.stop()


def test_cli_takes_the_chaos_journal_and_tier_flags(tmp_path):
    """``--fault-plan``, ``--fault-seed``,
    ``--coord-outage-deadline-seconds``, ``--control-plane-tier``,
    ``--agg-linger-ms`` and ``--agg-fallback-deadline-seconds`` reach the
    workers' environment as the JAX CLI maps them (a plan file inlined)."""
    from horovod_tpu.runner import config_parser as jax_config
    from horovod_tpu.runner import launch as jax_launch
    from horovod_tpu_torch.runner import config_parser as torch_config
    from horovod_tpu_torch.runner import launch as torch_launch
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(PLANS[0]))
    argv = ["-np", "2", "--fault-plan", str(plan), "--fault-seed", "9",
            "--coord-journal", str(tmp_path / "j.jsonl"),
            "--coord-outage-deadline-seconds", "45",
            "--control-plane-tier", "host", "--agg-linger-ms", "3.5",
            "--agg-fallback-deadline-seconds", "2.5",
            "--", "python", "t.py"]
    args = torch_launch.parse_args(argv)
    assert torch_launch.unported_flags(args) == []
    env, ref = {}, {}
    torch_config.set_env_from_args(env, args)
    jax_config.set_env_from_args(ref, jax_launch.parse_args(argv))
    keys = ("HOROVOD_FAULT_PLAN", "HOROVOD_FAULT_SEED",
            "HOROVOD_COORD_JOURNAL", "HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS",
            "HOROVOD_CONTROL_PLANE_TIER", "HOROVOD_AGG_LINGER_MS",
            "HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS")
    assert {k: env.get(k) for k in keys} == {k: ref.get(k) for k in keys}
    assert json.loads(env["HOROVOD_FAULT_PLAN"]) == PLANS[0]
    assert env["HOROVOD_CONTROL_PLANE_TIER"] == "host"
