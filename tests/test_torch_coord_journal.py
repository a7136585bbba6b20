"""The coordinator's crash survival in the port against the JAX package.

* Seeded request scripts (numpy ``RandomState``) drive a ``horovod_tpu``
  and a ``horovod_tpu_torch`` coordinator, each with a journal: ready
  reports over two processes (some complete, some partial), joins on a
  second process set, first beats and goodbyes, KV writes, bypass votes
  and aggregator registrations.  Both are then rebuilt from their
  journals (``restart_from_journal``) and driven on: fenced requests,
  ``resync``, polls from the old cursors, the ready reports again.
  Every reply, and the replayed state (``_journal_snapshot_locked``),
  compares equal as normalized JSON; the liveness scan is off, so no
  reply carries a time.
* The scenarios of tests/test_coord_journal.py, each run on both
  packages: replay restoring the control plane, a fresh job truncating a
  stale journal, the epoch fence over HTTP, the controller's drain then
  re-report, a journaled ``bye``, the liveness grace window, compaction,
  the torn tail and the outage deadline.
* The contract's verb tables are the JAX package's.

Nothing here has a tolerance: the modules are framework-free and every
comparison is exact.
"""

import json
import os
import re
import time
import types

import numpy as np
import pytest

from horovod_tpu.core import store_controller as jax_sc
from horovod_tpu.runner.http import contract as jax_contract
from horovod_tpu.runner.http import http_client as jax_client
from horovod_tpu.runner.http import http_server as jax_http
from horovod_tpu.runner.http import journal as jax_journal

from horovod_tpu_torch.core import store_controller as torch_sc
from horovod_tpu_torch.runner.http import contract as torch_contract
from horovod_tpu_torch.runner.http import http_client as torch_client
from horovod_tpu_torch.runner.http import http_server as torch_http
from horovod_tpu_torch.runner.http import journal as torch_journal

PKGS = {
    "jax": types.SimpleNamespace(
        http=jax_http, client=jax_client, journal=jax_journal, sc=jax_sc),
    "torch": types.SimpleNamespace(
        http=torch_http, client=torch_client, journal=torch_journal,
        sc=torch_sc),
}


def _meta(key, members, **over):
    m = {"key": key, "type": "ALLREDUCE", "dtype": "float32",
         "shape": [2], "op": 1, "pre": 1.0, "post": 1.0, "ps": 0,
         "nbytes": 8, "nprocs": len(members), "nranks": len(members),
         "root": -1, "members": members, "aux": {}}
    m.update(over)
    return m


def _norm(obj):
    """JSON with the timing fields dropped (``age``, the seconds of a
    dead worker's message)."""
    text = json.dumps(obj, sort_keys=True)
    text = re.sub(r'"age": [0-9.]+', '"age": 0', text)
    return re.sub(r"for [0-9.]+s", "for Xs", text)


def _server(pkg, tmp_path, name="j.jsonl", replay=False, **kw):
    kw.setdefault("world_size", 2)
    return PKGS[pkg].http.RendezvousServer(
        journal_path=str(tmp_path / name), journal_replay=replay, **kw)


# -- seeded scripts through both packages --------------------------------------

def _script(seed):
    """A request list from a seed: (verb or "kv", request)."""
    rs = np.random.RandomState(seed)
    reqs = []
    rid = {0: 0, 1: 0}
    jid = 0
    keys = [f"k{i}" for i in range(rs.randint(3, 7))]
    for _ in range(rs.randint(10, 25)):
        op = rs.choice(["ready", "ready", "ready", "join", "hb", "kv",
                        "vote", "agg", "poll"])
        proc = int(rs.randint(0, 2))
        sid = f"s{proc}"
        if op == "ready":
            rid[proc] += 1
            ks = sorted(set(rs.choice(keys, rs.randint(1, 3))))
            reqs.append(("ready", {
                "proc": proc, "round": 0, "rid": rid[proc], "sid": sid,
                "nlocal": 1, "entries": [
                    _meta(k, {"0": [0], "1": [1]},
                          nbytes=int(rs.choice([8, 64, 512])))
                    for k in ks]}))
        elif op == "join":
            jid += 1
            reqs.append(("join", {"ps": 1, "proc": proc, "rank": proc,
                                  "ps_size": 2, "proc_members": 1,
                                  "jid": jid, "sid": sid, "round": 0}))
        elif op == "hb":
            bye = bool(rs.randint(0, 4) == 0)
            reqs.append(("heartbeat", {"proc": proc, "ranks": [proc],
                                       "host": f"h{proc}", "round": 0,
                                       **({"bye": True} if bye else {})}))
        elif op == "kv":
            reqs.append(("kv", (f"/scope/{rs.randint(0, 4)}",
                                bytes(rs.randint(0, 256, 6).tolist()))))
        elif op == "vote":
            reqs.append(("bypass_ready", {
                "proc": proc, "sid": sid, "round": 0,
                "fp": f"fp{rs.randint(0, 2)}"}))
        elif op == "agg":
            reqs.append(("agg_resync", {
                "agg": f"host{rs.randint(0, 2)}", "sid": f"a{seed}",
                "host": "hostA", "procs": [0, 1]}))
        else:
            reqs.append(("poll", {"cursor": int(rs.randint(0, 3)),
                                  "wait": 0, "proc": proc, "round": 0}))
    return reqs


def _drive(pkg, tmp_path, reqs):
    """The script, a restart from the journal, then the fenced requests,
    the resyncs and the polls a worker makes after an outage.  Returns
    the replies and the replayed state."""
    kw = dict(stall_warning_secs=0.0, heartbeat_secs=0.0)
    server = _server(pkg, tmp_path, name=f"{pkg}.jsonl", **kw)
    c = server.coordinator
    replies = []
    for verb, req in reqs:
        if verb == "kv":
            server.store.put(*req)
            continue
        replies.append(c.handle(verb, json.loads(json.dumps(req))))
    server.coordinator.close()
    server = _server(pkg, tmp_path, name=f"{pkg}.jsonl", replay=True,
                     **kw)
    c = server.coordinator
    with c._lock:
        snap = c._journal_snapshot_locked()
    replay_counts = dict(c._journal_replayed)
    after = []
    for proc in (0, 1):
        after.append(c.handle("ready", {
            "proc": proc, "round": 0, "rid": 99, "sid": f"s{proc}",
            "epoch": 1, "entries": [_meta("x", {"0": [0], "1": [1]})]}))
        after.append(c.handle("resync", {"proc": proc, "sid": f"s{proc}",
                                         "round": 0}))
        after.append(c.handle("poll", {"cursor": 0, "wait": 0,
                                       "proc": proc, "round": 0,
                                       "epoch": 2}))
    for verb, req in reqs:
        if verb == "ready":
            after.append(c.handle("ready", {
                **json.loads(json.dumps(req)), "epoch": 2,
                "rid": req["rid"] + 1000}))
    after.append(c.handle("poll", {"cursor": 0, "wait": 0, "proc": 0,
                                   "round": 0, "epoch": 2}))
    kv = {k: v.decode("latin-1")
          for k, v in server.store.scope("/scope/").items()}
    c.close()
    return {"replies": replies, "snapshot": snap, "after": after,
            "replayed": replay_counts, "kv": kv,
            "journal_kinds": [json.loads(line)["k"] for line in open(
                tmp_path / f"{pkg}.jsonl") if line.strip()]}


@pytest.mark.parametrize("seed", range(6))
def test_scripted_restart_matches_the_jax_package(tmp_path, seed):
    reqs = _script(seed)
    got = {pkg: _drive(pkg, tmp_path, reqs) for pkg in PKGS}
    for part in ("replies", "snapshot", "after", "replayed", "kv",
                 "journal_kinds"):
        assert _norm(got["torch"][part]) == _norm(got["jax"][part]), part
    assert got["torch"]["snapshot"]["epoch"] == 2
    assert all(r == {"epoch_mismatch": True, "epoch": 2}
               for r in got["torch"]["after"][0:6:3])


def test_a_journaled_bypass_arm_is_replayed():
    """The arm record rides the journaled log: a restarted coordinator
    stays armed on the same fingerprint, so a replayed vote is answered
    ``armed`` and no second arm record is written."""
    import tempfile
    out = {}
    for pkg in PKGS:
        with tempfile.TemporaryDirectory() as d:
            from pathlib import Path
            s = _server(pkg, Path(d), world_size=2)
            c = s.coordinator
            for proc in (0, 1):
                c.handle("bypass_ready", {"proc": proc, "sid": f"s{proc}",
                                          "fp": "F", "round": 0})
            s.coordinator.close()
            s = _server(pkg, Path(d), replay=True, world_size=2)
            c = s.coordinator
            out[pkg] = [c._bypass_armed_fp,
                        c.handle("bypass_ready", {"proc": 0, "sid": "s0",
                                                  "fp": "F", "round": 0,
                                                  "epoch": 2}),
                        [r["kind"] for r in c._log]]
            c.close()
    assert out["torch"] == out["jax"] == ["F", {"armed": True},
                                          ["bypass_arm"]]


def test_contract_tables_match_the_jax_package():
    for name in ("REPLAY_SAFE_VERBS", "REPLAY_SAFE_KV_VERBS",
                 "REPLAY_DEDUP_ATTRS", "EPOCH_EXEMPT_VERBS", "STREAM_VERBS",
                 "CACHEABLE_TYPES"):
        assert getattr(torch_contract, name) == \
            getattr(jax_contract, name), name


# -- tests/test_coord_journal.py's scenarios, on both packages -------------------

@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_journal_replay_restores_control_plane(tmp_path, pkg):
    s1 = _server(pkg, tmp_path)
    c = s1.coordinator
    assert c.coord_epoch == 1
    done = _meta("done.k", {"0": [0], "1": [1]})
    c.handle("ready", {"proc": 0, "round": 0, "rid": 1, "sid": "sA",
                       "entries": [done]})
    c.handle("ready", {"proc": 1, "round": 0, "rid": 1, "sid": "sB",
                       "entries": [done]})
    c.handle("ready", {"proc": 0, "round": 0, "rid": 2, "sid": "sA",
                       "entries": [_meta("half.k",
                                         {"0": [0], "1": [1]})]})
    c.handle("join", {"ps": 1, "proc": 0, "rank": 0, "ps_size": 2,
                      "proc_members": 1, "jid": 4, "sid": "sA"})
    c.handle("heartbeat", {"proc": 1, "ranks": [1], "host": "hostB"})
    s1.store.put("/elastic/round", b'{"round": 0}')
    s1.store.put("/hvd_torch/device_uuid/0/1", b"GPU-1")
    s1.stop()

    s2 = _server(pkg, tmp_path, replay=True)
    c2 = s2.coordinator
    assert c2.coord_epoch == 2
    assert [r["kind"] for r in c2._log] == ["batch"]
    assert c2._log[0]["keys"] == ["done.k"]
    assert "half.k" not in c2._pending
    assert c2._proc_joined[1][0] == 1 and 4 in c2._join_seen[(1, 0)]
    assert c2._proc_sid == {0: "sA", 1: "sB"}
    assert c2._proc_ranks == {1: [1]} and c2._proc_hosts == {1: "hostB"}
    # the keys a worker reads after a restart: the elastic round and the
    # device-UUID exchange
    assert s2.store.get("/elastic/round") == b'{"round": 0}'
    assert s2.store.get("/hvd_torch/device_uuid/0/1") == b"GPU-1"
    assert not c2._beats
    assert c2._journal_replayed.get("log") == 1
    s2.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_fresh_job_truncates_stale_journal(tmp_path, pkg):
    s1 = _server(pkg, tmp_path)
    s1.coordinator.handle("join", {"ps": 0, "proc": 0, "rank": 0,
                                   "ps_size": 2, "proc_members": 1,
                                   "jid": 1, "sid": "s"})
    s1.stop()
    s2 = _server(pkg, tmp_path)
    assert s2.coordinator.coord_epoch == 1
    assert not s2.coordinator._proc_joined
    s2.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_epoch_fence_and_resync_over_http(tmp_path, pkg):
    server = _server(pkg, tmp_path, world_size=1)
    port = server.start()
    try:
        client = PKGS[pkg].client.StoreClient("127.0.0.1", port)
        out = client.coord("poll", {"cursor": 0, "wait": 0, "proc": 0,
                                    "round": 0})
        assert out["epoch"] == 1
        assert server.restart_from_journal() == port
        out = client.coord("ready", {"proc": 0, "round": 0, "rid": 9,
                                     "sid": "s", "epoch": 1,
                                     "entries": [_meta("x.k",
                                                       {"0": [0]})]})
        assert out == {"epoch_mismatch": True, "epoch": 2}
        assert "x.k" not in server.coordinator._pending
        out = client.coord("resync", {"proc": 0, "sid": "s",
                                      "round": 0})
        assert out["epoch"] == 2
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_controller_resync_drains_replayed_log_then_rereports(tmp_path,
                                                              pkg):
    """A batch scheduled (and journaled) before the crash but not yet
    consumed reaches the controller through the replayed log after the
    restart; only what is still unscheduled is re-reported."""
    server = _server(pkg, tmp_path, world_size=1)
    port = server.start()
    try:
        ctrl = PKGS[pkg].sc.StoreController("127.0.0.1", port, None, 0, 1,
                                            1)
        assert ctrl.poll(wait=0) == []
        assert ctrl.epoch == 1
        assert ctrl.take_rereport() is False
        ctrl.report_ready([_meta("a.k", {"0": [0]})])
        server.restart_from_journal()
        assert server.coordinator.coord_epoch == 2
        ctrl.report_ready([_meta("b.k", {"0": [0]})])
        assert ctrl.epoch == 2
        assert ctrl.take_rereport() is False      # not drained yet
        resp = ctrl.poll(wait=1.0)
        assert [r["keys"] for r in resp
                if r.get("kind") == "batch"] == [["a.k"]]
        assert ctrl.take_rereport() is True
        assert ctrl.take_rereport() is False
        ctrl.report_ready([_meta("b.k", {"0": [0]})])
        resp = ctrl.poll(wait=1.0)
        assert [r["keys"] for r in resp
                if r.get("kind") == "batch"] == [["b.k"]]
    finally:
        server.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_journaled_bye_is_not_a_death_after_restart(tmp_path, pkg):
    s1 = _server(pkg, tmp_path, heartbeat_secs=0.2)
    c = s1.coordinator
    c.handle("heartbeat", {"proc": 0, "ranks": [0], "host": "h0"})
    c.handle("heartbeat", {"proc": 1, "ranks": [1], "host": "h1"})
    c.handle("heartbeat", {"proc": 0, "bye": True})
    s1.stop()
    s2 = _server(pkg, tmp_path, replay=True, heartbeat_secs=0.2)
    c2 = s2.coordinator
    assert 0 not in c2._proc_ranks
    time.sleep(0.7)
    c2.handle("poll", {"cursor": 0, "wait": 0, "proc": 1, "round": 0,
                       "epoch": 2})
    assert c2.dead_procs() == {}
    c2.handle("heartbeat", {"proc": 1, "ranks": [1]})
    assert 1 in c2._beats
    s2.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_liveness_grace_window_after_restart(tmp_path, pkg):
    s1 = _server(pkg, tmp_path, heartbeat_secs=0.2, heartbeat_window=1.0)
    s1.coordinator.handle("heartbeat", {"proc": 0, "ranks": [0]})
    s1.stop()
    s2 = _server(pkg, tmp_path, replay=True, heartbeat_secs=0.2,
                 heartbeat_window=1.0)
    c2 = s2.coordinator
    assert c2._grace_until > time.monotonic()
    c2.handle("heartbeat", {"proc": 0, "ranks": [0]})
    with c2._lock:
        c2._beats[0] -= 0.5
        c2._scan_heartbeats()
    assert c2.dead_procs() == {}
    # past the window the same silence is a death
    with c2._lock:
        c2._grace_until = 0.0
        c2._beats[0] -= 5.0
        c2._scan_heartbeats()
    assert list(c2.dead_procs()) == [0]
    s2.stop()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_journal_compaction_preserves_state(tmp_path, pkg):
    m = PKGS[pkg]
    path = tmp_path / "j.jsonl"
    journal = m.journal.CoordJournal(str(path), max_bytes=600)
    store = m.http.KVStore()
    c = m.http.Coordinator(world_size=1, journal=journal)
    c.attach_store(store)
    store.journal = journal
    store.put("/scope/key", b"value")
    c.handle("join", {"ps": 0, "proc": 0, "rank": 0, "ps_size": 9,
                      "proc_members": 5, "jid": 3, "sid": "s"})
    for i in range(20):
        c.handle("ready", {"proc": 0, "round": 0, "rid": i + 1,
                           "sid": "s",
                           "entries": [_meta(f"k{i}", {"0": [0]})]})
        c.handle("poll", {"cursor": 0, "wait": 0, "proc": 0,
                          "round": 0})
    c.close()
    lines = [json.loads(line)
             for line in path.read_text().splitlines() if line]
    assert any(rec.get("k") == "snap" for rec in lines)
    assert os.path.getsize(path) < 16 * 600

    j2 = m.journal.CoordJournal(str(path))
    store2 = m.http.KVStore()
    c2 = m.http.Coordinator(world_size=1, journal=j2)
    c2.attach_store(store2)
    c2.restore_journal(j2.read())
    assert c2.coord_epoch == 2
    assert c2._proc_joined[0][0] == 1 and 3 in c2._join_seen[(0, 0)]
    assert store2.get("/scope/key") == b"value"
    assert c2._log_base + len(c2._log) == 20
    c2.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_journal_tolerates_torn_tail(tmp_path, pkg):
    path = tmp_path / "j.jsonl"
    j = PKGS[pkg].journal.CoordJournal(str(path))
    j.append({"k": "epoch", "epoch": 1})
    j.append({"k": "hb", "proc": 0, "ranks": [0], "host": "h"})
    j.close()
    with open(path, "a") as f:
        f.write('{"k": "hb", "proc": 1, "ra')
    records = PKGS[pkg].journal.CoordJournal(str(path)).read()
    assert [r["k"] for r in records] == ["epoch", "hb"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_outage_deadline_env_is_read(pkg, monkeypatch):
    client = PKGS[pkg].client.StoreClient("127.0.0.1", 1)
    assert client.outage_deadline == 120.0
    monkeypatch.setenv("HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS", "7.5")
    assert PKGS[pkg].client.StoreClient("127.0.0.1", 1) \
        .outage_deadline == 7.5


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_connection_failures_retry_up_to_outage_deadline(pkg):
    """Connection refused keeps a replay-safe request retrying under the
    outage deadline, not the tight per-request budget; an explicit
    budget (the teardown paths) caps it."""
    client = PKGS[pkg].client.StoreClient("127.0.0.1", 1)
    client.retry_attempts = 3
    client.retry_deadline = 0.2
    client.outage_deadline = 1.2
    client._retry_base = 0.02
    client._retry_cap = 0.05
    t0 = time.monotonic()
    with pytest.raises(OSError):
        client.coord("heartbeat", {"proc": 0})
    assert time.monotonic() - t0 >= 1.0
    t0 = time.monotonic()
    with pytest.raises(OSError):
        client.coord("heartbeat", {"proc": 0}, budget=(2, 0.3))
    assert time.monotonic() - t0 < 1.0


def test_restart_needs_a_journal(tmp_path):
    server = torch_http.RendezvousServer(world_size=1)
    with pytest.raises(RuntimeError, match="HOROVOD_COORD_JOURNAL"):
        server.restart_from_journal()
    server.stop()
