"""The per-host aggregator tier in the port against the JAX package.

* The scenarios of tests/test_aggregator.py, each run on both packages'
  stacks (coordinator, ``AggregatorServer``, ``StoreController`` with its
  ``TieredStoreClient``): the two-tier (coord_epoch, agg_epoch) fence, a
  stateless aggregator restart drained then re-reported, a worker that
  outlives its aggregator and a coordinator restart, the direct
  fallback when the aggregator dies, a failed flush that leaves the rid
  dedup alone, the KV proxy, suspect-not-dead liveness, re-armed beats
  on a new registration, a registration that survives a coordinator
  restart, upstream batching by host, the owner's start and the
  co-hosted discovery, and the tier switch's spellings.
* The same two-host ready scripts (numpy-seeded keys over four
  processes, two a host) through both packages' aggregators: the
  upstream ``agg_ready`` batches (reports in process order) and every
  reply and polled response compare equal as JSON.

Exact comparisons throughout: the modules are framework-free.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

from horovod_tpu.core import store_controller as jax_sc
from horovod_tpu.runner.http import aggregator as jax_agg
from horovod_tpu.runner.http import http_client as jax_client
from horovod_tpu.runner.http import http_server as jax_http

from horovod_tpu_torch.core import store_controller as torch_sc
from horovod_tpu_torch.runner.http import aggregator as torch_agg
from horovod_tpu_torch.runner.http import http_client as torch_client
from horovod_tpu_torch.runner.http import http_server as torch_http

PKGS = {
    "jax": types.SimpleNamespace(http=jax_http, client=jax_client,
                                 agg=jax_agg, sc=jax_sc),
    "torch": types.SimpleNamespace(http=torch_http, client=torch_client,
                                   agg=torch_agg, sc=torch_sc),
}


def _meta(key, members):
    return {"key": key, "type": "ALLREDUCE", "dtype": "float32",
            "shape": [2], "op": 1, "pre": 1.0, "post": 1.0, "ps": 0,
            "nbytes": 8, "nprocs": len(members), "nranks": len(members),
            "root": -1, "members": members, "aux": {}}


@pytest.fixture(params=sorted(PKGS))
def stack(request, tmp_path):
    """A journaled coordinator and one aggregator over real HTTP."""
    m = PKGS[request.param]
    server = m.http.RendezvousServer(
        world_size=1, journal_path=str(tmp_path / "j.jsonl"))
    port = server.start()
    agg_srv = m.agg.AggregatorServer(None, lambda: m.agg.Aggregator(
        m.client.StoreClient("127.0.0.1", port), "host0", "h0", [0],
        linger_ms=1))
    aport = agg_srv.start()
    yield m, server, port, agg_srv, aport
    agg_srv.stop()
    server.stop()


def _controller(m, port, aport, proc=0, world=1):
    c = m.sc.StoreController("127.0.0.1", port, None, proc, world, 1,
                             agg_addr="127.0.0.1", agg_port=aport)
    # fast fallbacks for the tests, not the 5 s default
    c.client.agg.retry_attempts = 2
    c.client.agg.retry_deadline = 1.0
    c.client.agg.outage_deadline = 1.0
    return c


def _batches(resp):
    return [r["keys"] for r in resp if r.get("kind") == "batch"]


# -- two-tier epoch fencing ------------------------------------------------------

def test_stale_agg_epoch_rejected_before_verb_runs(stack):
    m, server, port, agg_srv, aport = stack
    agg = agg_srv.aggregator
    assert agg.agg_epoch == 1 and agg.coord_epoch == 1
    out = agg.handle("ready", {
        "proc": 0, "rid": 1, "sid": "s", "round": 0,
        "epoch": agg.coord_epoch, "agg_epoch": 0,
        "entries": [_meta("f.k", {"0": [0]})]})
    assert out == {"epoch_mismatch": True, "epoch": 1, "agg_epoch": 1}
    assert agg._batch == [] and 0 not in agg._ready_seen
    assert "f.k" not in server.coordinator._pending
    out = agg.handle("ready", {
        "proc": 0, "rid": 1, "sid": "s", "round": 0,
        "epoch": 0, "agg_epoch": agg.agg_epoch,
        "entries": [_meta("f.k", {"0": [0]})]})
    assert out["epoch_mismatch"] and "f.k" not in \
        server.coordinator._pending
    out = agg.handle("resync", {"proc": 0, "sid": "s",
                                "epoch": 0, "agg_epoch": 0})
    assert out["epoch"] == 1 and out["agg_epoch"] == 1


def test_agg_restart_bumps_epoch_and_resync_drains_replayed_log(stack):
    m, server, port, agg_srv, aport = stack
    ctrl = _controller(m, port, aport)
    assert ctrl.poll(wait=0) == []
    assert (ctrl.epoch, ctrl.agg_epoch) == (1, 1)
    ctrl.report_ready([_meta("a.k", {"0": [0]})])
    assert agg_srv.restart() == aport
    assert agg_srv.aggregator.agg_epoch == 2
    ctrl.report_ready([_meta("b.k", {"0": [0]})])
    assert ctrl.agg_epoch == 2
    assert _batches(ctrl.poll(wait=2.0)) == [["a.k"]]
    assert ctrl.take_rereport() is True
    ctrl.forget("b.k")
    ctrl.report_ready([_meta("b.k", {"0": [0]})])
    assert _batches(ctrl.poll(wait=2.0)) == [["b.k"]]
    with server.coordinator._lock:
        batches = [r for r in server.coordinator._log
                   if r.get("kind") == "batch"]
    assert [b["keys"] for b in batches] == [["a.k"], ["b.k"]]


def test_worker_outlives_aggregator_and_coordinator_restart(stack):
    m, server, port, agg_srv, aport = stack
    ctrl = _controller(m, port, aport)
    assert ctrl.poll(wait=0) == []
    ctrl.report_ready([_meta("a.k", {"0": [0]})])
    agg_srv.stop_http()
    assert server.restart_from_journal() == port
    assert server.coordinator.coord_epoch == 2
    assert agg_srv.start() == aport
    ctrl.report_ready([_meta("b.k", {"0": [0]})])
    assert (ctrl.epoch, ctrl.agg_epoch) == (2, 2)
    assert _batches(ctrl.poll(wait=2.0)) == [["a.k"]]
    assert ctrl.take_rereport() is True
    ctrl.forget("b.k")
    ctrl.report_ready([_meta("b.k", {"0": [0]})])
    assert _batches(ctrl.poll(wait=2.0)) == [["b.k"]]


# -- degradation -----------------------------------------------------------------

def test_dead_aggregator_falls_back_direct_never_deadlocks(stack):
    m, server, port, agg_srv, aport = stack
    ctrl = _controller(m, port, aport)
    ctrl.report_ready([_meta("a.k", {"0": [0]})])
    assert [r["keys"] for r in ctrl.poll(wait=2.0)] == [["a.k"]]
    agg_srv.stop()
    t0 = time.monotonic()
    ctrl.report_ready([_meta("b.k", {"0": [0]})])
    resp = ctrl.poll(wait=3.0)
    assert time.monotonic() - t0 < 20.0
    assert isinstance(ctrl.client, m.client.TieredStoreClient)
    assert ctrl.client.via_agg is False
    if ctrl.take_rereport():
        ctrl.forget("b.k")
        ctrl.report_ready([_meta("b.k", {"0": [0]})])
        resp = ctrl.poll(wait=3.0)
    assert _batches(resp) == [["b.k"]]


def test_failed_flush_does_not_poison_rid_dedup(stack):
    """A flush that fails upstream leaves the per-proc rid high-water
    alone: the worker's retry of the same rid is queued again instead of
    being answered from a stale cache."""
    m, server, port, agg_srv, aport = stack
    agg = agg_srv.aggregator
    agg.client.retry_attempts = 2
    agg.client.retry_deadline = 0.5
    agg.client.outage_deadline = 0.5
    req = {"proc": 0, "rid": 1, "sid": "s", "round": 0,
           "entries": [_meta("p.k", {"0": [0]})]}
    server.stop_http()
    with pytest.raises(m.agg.AggregatorUpstreamError):
        agg.handle("ready", dict(req))
    assert agg._ready_seen.get(0) is None
    assert server.start() == port
    out = agg.handle("ready", dict(req))
    assert not out.get("epoch_mismatch"), out
    assert "p.k" not in server.coordinator._pending
    assert agg._ready_seen[0] == 1


def test_kv_traffic_proxies_through_the_aggregator(stack):
    m, server, port, agg_srv, aport = stack
    cli = m.client.StoreClient("127.0.0.1", aport)
    cli.put("/scope/x", b"v1")
    assert server.store.get("/scope/x") == b"v1"
    assert cli.get("/scope/x") == b"v1"
    cli.delete("/scope/x")
    assert cli.get("/scope/x") is None


# -- coordinator-side liveness ---------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_silent_aggregator_marks_ranks_suspect_not_dead(pkg):
    c = PKGS[pkg].http.Coordinator(world_size=2, heartbeat_secs=0.2)
    c._agg_probe_grace = 0.6
    c.heartbeat_window = 0.3
    c.handle("agg_resync", {"agg": "h0", "sid": "s", "host": "hA",
                            "procs": [0, 1]})
    c.handle("agg_heartbeat", {"agg": "h0", "host": "hA", "beats": [
        {"proc": 0, "ranks": [0], "host": "hA"},
        {"proc": 1, "ranks": [1], "host": "hA"}]})
    time.sleep(0.4)
    with c._lock:
        c._scan_heartbeats()
    assert c.dead_procs() == {}
    c.handle("heartbeat", {"proc": 0, "ranks": [0], "host": "hA"})
    assert c._proc_via_agg[0] is None
    time.sleep(0.7)
    c.handle("heartbeat", {"proc": 0, "ranks": [0], "host": "hA"})
    dead = c.dead_procs()
    assert set(dead) == {1} and dead[1]["ranks"] == [1]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_agg_registration_rearms_hosted_beats(pkg):
    c = PKGS[pkg].http.Coordinator(world_size=1, heartbeat_secs=0.2,
                                   heartbeat_window=0.3)
    c._agg_probe_grace = 10.0
    c.handle("agg_resync", {"agg": "h0", "sid": "s1", "procs": [0]})
    c.handle("agg_heartbeat", {"agg": "h0", "beats": [
        {"proc": 0, "ranks": [0]}]})
    time.sleep(0.4)
    c.handle("agg_resync", {"agg": "h0", "sid": "s2", "procs": [0]})
    with c._lock:
        age = time.monotonic() - c._beats[0]
    assert age < 0.2
    assert c._agg_epoch["h0"] == 2


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_agg_session_survives_coordinator_restart(tmp_path, pkg):
    server = PKGS[pkg].http.RendezvousServer(
        world_size=2, journal_path=str(tmp_path / "j.jsonl"))
    server.start()
    c = server.coordinator
    out = c.handle("agg_resync", {"agg": "h0", "sid": "sX",
                                  "host": "hA", "procs": [0, 1]})
    assert out["agg_epoch"] == 1
    server.restart_from_journal()
    c2 = server.coordinator
    assert c2.coord_epoch == 2
    out = c2.handle("agg_resync", {"agg": "h0", "sid": "sX",
                                   "host": "hA", "procs": [0, 1]})
    assert out["agg_epoch"] == 1
    out = c2.handle("agg_resync", {"agg": "h0", "sid": "sY",
                                   "host": "hA", "procs": [0, 1]})
    assert out["agg_epoch"] == 2
    server.stop()


# -- fan-in ----------------------------------------------------------------------

class _Recorder:
    """Wraps an aggregator core's upstream ``coord`` to record every
    upstream request (verb, payload)."""

    def __init__(self, client):
        self.calls = []
        self._coord = client.coord
        self._lock = threading.Lock()
        client.coord = self

    def __call__(self, verb, payload, *a, **kw):
        with self._lock:
            self.calls.append((verb, json.loads(json.dumps(payload))))
        return self._coord(verb, payload, *a, **kw)


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_upstream_batching_scales_with_hosts_not_procs(pkg):
    """Four workers on one host ride one (at most two) ``agg_ready``
    requests upstream, and no worker verb reaches the coordinator
    directly."""
    m = PKGS[pkg]
    server = m.http.RendezvousServer(world_size=4)
    port = server.start()
    rec = {}

    def core():
        a = m.agg.Aggregator(m.client.StoreClient("127.0.0.1", port),
                             "host0", "h0", [0, 1, 2, 3], linger_ms=500)
        rec["agg"] = _Recorder(a.client)
        return a

    agg_srv = m.agg.AggregatorServer(None, core)
    aport = agg_srv.start()
    try:
        ctrls = [_controller(m, port, aport, proc=p, world=4)
                 for p in range(4)]
        direct = [_Recorder(c.client.direct) for c in ctrls]
        members = {str(p): [p] for p in range(4)}

        def one(c):
            c.report_ready([_meta("f.k", members)])
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                if any("f.k" in (r.get("keys") or ())
                       for r in c.poll(wait=0.5)):
                    return
            raise TimeoutError(c.proc_id)

        ts = [threading.Thread(target=one, args=(c,)) for c in ctrls]
        for t in ts:
            t.start()
        for t in ts:
            t.join(25)
        verbs = [v for v, _ in rec["agg"].calls]
        assert 1 <= verbs.count("agg_ready") <= 2
        assert sum(len(d.calls) for d in direct) == 0
    finally:
        agg_srv.stop()
        server.stop()


def _two_host_script(seed):
    """Rounds of ready reports over four processes (hosts of two): each
    round a seeded key list, every process reporting all of it."""
    rs = np.random.RandomState(seed)
    return [sorted({f"k{int(k)}" for k in rs.randint(0, 6,
                                                     rs.randint(1, 4))})
            for _ in range(rs.randint(2, 5))]


def _run_two_hosts(pkg, rounds):
    """Both hosts' aggregators (linger long enough that each round's
    batch is a host's two reports) in front of one coordinator; returns
    the upstream agg_ready batches, every reply and every process's
    polled batch records."""
    m = PKGS[pkg]
    server = m.http.RendezvousServer(world_size=4, stall_warning_secs=0.0,
                                     heartbeat_secs=0.0)
    port = server.start()
    recs, servers = {}, []
    for host, procs in ((0, [0, 1]), (1, [2, 3])):
        def core(host=host, procs=procs):
            a = m.agg.Aggregator(m.client.StoreClient("127.0.0.1", port),
                                 f"host{host}", f"h{host}", procs,
                                 linger_ms=5000, relay_secs=60.0)
            recs[host] = _Recorder(a.client)
            return a
        srv = m.agg.AggregatorServer(None, core)
        srv.start()
        servers.append(srv)
    members = {str(p): [p] for p in range(4)}
    replies = {p: [] for p in range(4)}
    polled = {p: [] for p in range(4)}
    cursors = {p: 0 for p in range(4)}
    try:
        for i, keys in enumerate(rounds):
            def one(p, keys=keys, i=i):
                agg = servers[p // 2].aggregator
                replies[p].append(agg.handle("ready", {
                    "proc": p, "rid": i + 1, "sid": f"s{p}", "round": 0,
                    "nlocal": 1,
                    "entries": [_meta(k, members) for k in keys]}))
                want = set(keys)
                deadline = time.monotonic() + 20
                while want and time.monotonic() < deadline:
                    out = agg.handle("poll", {"proc": p, "round": 0,
                                              "cursor": cursors[p],
                                              "wait": 1.0})
                    cursors[p] = out["cursor"]
                    for r in out["responses"]:
                        polled[p].append(r)
                        want -= set(r.get("keys") or ())
            ts = [threading.Thread(target=one, args=(p,)) for p in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
        batches = {}
        for host, rec in recs.items():
            batches[host] = [
                sorted((r for r in payload["reports"]),
                       key=lambda r: r["proc"])
                for verb, payload in rec.calls if verb == "agg_ready"]
        return {"batches": batches, "replies": replies,
                "polled": polled}
    finally:
        for srv in servers:
            srv.stop()
        server.stop()


def _strip_trace(obj):
    """The batch records' flow-trace ids are job-unique counters in the
    order batches were scheduled; both packages mint them the same way,
    but which host's batch lands first is a race, so they are dropped."""
    text = json.dumps(obj, sort_keys=True)
    data = json.loads(text)
    for per in data["polled"].values():
        for r in per:
            r.pop("trace", None)
    return json.dumps(data, sort_keys=True)


@pytest.mark.parametrize("seed", range(3))
def test_two_host_scripts_match_the_jax_package(seed):
    rounds = _two_host_script(seed)
    got = {pkg: _run_two_hosts(pkg, rounds) for pkg in PKGS}
    assert _strip_trace(got["torch"]) == _strip_trace(got["jax"])
    # one upstream batch a host a round, each carrying both reports
    for host in (0, 1):
        assert len(got["torch"]["batches"][host]) == len(rounds)
        assert all([r["proc"] for r in b] == [2 * host, 2 * host + 1]
                   for b in got["torch"]["batches"][host])


# -- launcher bootstrap ----------------------------------------------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_ensure_host_aggregator_owner_and_discovery(pkg, monkeypatch):
    m = PKGS[pkg]
    server = m.http.RendezvousServer(world_size=2)
    port = server.start()
    try:
        monkeypatch.setattr(m.agg, "_PROCESS_AGG", None)
        monkeypatch.setattr(m.agg, "_PROCESS_AGG_FAULTS", None)
        addr, aport, agg_id = m.agg.ensure_host_aggregator(
            "127.0.0.1", port, None, 0, [0, 0], start_timeout=10)
        assert agg_id == "host0" and aport > 0
        addr2, aport2, agg_id2 = m.agg.ensure_host_aggregator(
            "127.0.0.1", port, None, 1, [0, 0], start_timeout=10)
        assert (addr2, aport2, agg_id2) == (addr, aport, agg_id)
        assert server.coordinator._agg_sid.get("host0")
    finally:
        m.agg.stop_process_aggregator()
        server.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_tier_enabled_spellings(pkg, monkeypatch):
    tier_enabled = PKGS[pkg].agg.tier_enabled
    monkeypatch.delenv("HOROVOD_CONTROL_PLANE_TIER", raising=False)
    assert tier_enabled() is False
    monkeypatch.setenv("HOROVOD_CONTROL_PLANE_TIER", "flat")
    assert tier_enabled() is False
    for spelling in ("host", "2", "two"):
        monkeypatch.setenv("HOROVOD_CONTROL_PLANE_TIER", spelling)
        assert tier_enabled() is True
    assert tier_enabled({"HOROVOD_CONTROL_PLANE_TIER": "flat"}) is False
