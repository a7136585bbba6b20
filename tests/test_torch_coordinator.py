"""The port's coordinator (horovod_tpu_torch/runner/http/http_server.py)
against the JAX package's: the same request sequences drive a
``horovod_tpu`` Coordinator and a ``horovod_tpu_torch`` one, and every
reply compares equal as JSON.  Timings enter only the ``age`` fields and
the dead-worker messages (seconds since the last beat), which are
normalised before the comparison.  Everything runs in this process.
Plus the port's RendezvousServer/StoreClient round trip with and
without the HMAC secret, and its StoreController's response-cache path.
"""

import json
import re
import time

import pytest

from horovod_tpu.runner.http import http_server as jax_http
from horovod_tpu_torch.core.store_controller import StoreController
from horovod_tpu_torch.runner.http import http_server as torch_http
from horovod_tpu_torch.runner.http.http_client import (
    StoreClient, put_data_into_kvstore, read_data_from_kvstore,
)


def _meta(key, nbytes=64, type_="ALLREDUCE", ps=0, nprocs=2, **kw):
    m = dict(key=key, type=type_, dtype="float32", shape=[4], op=1,
             pre=1.0, post=1.0, ps=ps, nbytes=nbytes, nprocs=nprocs,
             root=-1, aux={})
    m.update(kw)
    return m


def _norm(obj):
    """Drop the timing fields: ``age`` values and the seconds in a dead
    worker's message."""
    text = json.dumps(obj, sort_keys=True)
    text = re.sub(r'"age": [0-9.]+', '"age": 0', text)
    return re.sub(r"for [0-9.]+s", "for Xs", text)


def _drive(script, **coord_kwargs):
    """Run ``script(handle)`` against both coordinators; returns the two
    reply lists.  ``handle(verb, req)`` records each reply."""
    out = []
    for mod in (jax_http, torch_http):
        c = mod.Coordinator(**coord_kwargs)
        replies = []

        def handle(verb, req, _c=c, _r=replies):
            rep = _c.handle(verb, json.loads(json.dumps(req)))
            _r.append(rep)
            return rep

        script(handle)
        out.append(replies)
    return out


def _same(script, **coord_kwargs):
    jax_replies, torch_replies = _drive(script, **coord_kwargs)
    assert len(jax_replies) == len(torch_replies)
    for i, (a, b) in enumerate(zip(jax_replies, torch_replies)):
        assert _norm(a) == _norm(b), (i, a, b)
    return torch_replies


def _ready(proc, entries, **kw):
    return {"proc": proc, "nlocal": 1, "entries": entries, **kw}


def _poll(cursor=0, proc=None, wait=0.0):
    req = {"cursor": cursor, "wait": wait}
    if proc is not None:
        req["proc"] = proc
    return req


def test_negotiation_and_fusion_over_threshold():
    def script(h):
        h("ready", _ready(0, [_meta("a", 60), _meta("b", 60)]))
        h("poll", _poll())
        h("ready", _ready(1, [_meta("a", 60), _meta("b", 60)]))
        h("poll", _poll())
    replies = _same(script, world_size=2, fusion_threshold_bytes=100)
    assert [r["keys"] for r in replies[-1]["responses"]] == [["a"], ["b"]]


def test_fusion_under_threshold_and_op_boundaries():
    def script(h):
        h("ready", _ready(0, [
            _meta("a", 60, nprocs=1), _meta("b", 60, nprocs=1),
            _meta("g", 60, type_="ALLGATHER", nprocs=1,
                  aux={"dim0s": [[3]]}),
            _meta("c", 60, nprocs=1),
            _meta("d", 60, nprocs=1, wire="int8"),
            _meta("bc", 60, type_="BROADCAST", nprocs=1, root=0),
            _meta("e", 60, nprocs=1)]))
        h("poll", _poll())
    replies = _same(script, world_size=1, fusion_threshold_bytes=1000)
    assert [r["keys"] for r in replies[-1]["responses"]] == \
        [["a", "b"], ["g"], ["c"], ["d"], ["bc"], ["e"]]


def test_allgather_and_alltoall_aux_merge():
    def script(h):
        for p in (0, 1):
            h("ready", _ready(p, [
                _meta("ag", 24, type_="ALLGATHER",
                      aux={"dim0s": [[p + 1]]}),
                _meta("a2a", 24, type_="ALLTOALL",
                      aux={"splits": [[1, 2] if p == 0 else [2, 1]]})]))
        h("poll", _poll())
    replies = _same(script, world_size=2)
    aux = {k: v for r in replies[-1]["responses"]
           for k, v in r["aux"].items()}
    assert aux["ag"] == {"0": {"dim0s": [[1]]}, "1": {"dim0s": [[2]]}}


def test_response_cache_and_eviction():
    def script(h):
        h("ready", _ready(0, [_meta("a")]))
        h("ready", _ready(1, [_meta("a")]))
        out = h("poll", _poll(proc=0))
        cid = out["responses"][0]["cache_ids"]["a"]
        h("ready", _ready(0, [{"key": "a", "c": cid}]))
        h("ready", _ready(1, [{"key": "a", "c": cid}]))
        h("poll", _poll(1, proc=0))
        h("ready", _ready(0, [{"key": "zz", "c": 999}]))
        # capacity 2: a third key evicts the least recent
        for name in ("b", "x"):
            h("ready", _ready(0, [_meta(name)]))
            h("ready", _ready(1, [_meta(name)]))
        h("poll", _poll(2, proc=0))
        h("ready", _ready(0, [{"key": "a", "c": cid}]))
    replies = _same(script, world_size=2, fusion_threshold_bytes=10 ** 6,
                    cache_capacity=2)
    assert replies[6] == {"uncached": ["zz"]}
    assert replies[-1] == {"uncached": ["a"]}


def test_log_gc():
    def script(h):
        for step in range(5):
            h("ready", _ready(0, [_meta(f"t{step}", 60)]))
            h("ready", _ready(1, [_meta(f"t{step}", 60)]))
        h("poll", _poll(0, proc=0))
        h("poll", _poll(0, proc=1))
        h("poll", _poll(5, proc=0))
        h("poll", _poll(2, proc=1))
        h("poll", _poll(5, proc=1))
        h("ready", _ready(0, [_meta("n", 60)]))
        h("ready", _ready(1, [_meta("n", 60)]))
        h("poll", _poll(5, proc=0))
    replies = _same(script, world_size=2, fusion_threshold_bytes=100)
    assert [r["keys"] for r in replies[13]["responses"]] == \
        [["t2"], ["t3"], ["t4"]]
    assert replies[-1]["cursor"] == 6


@pytest.mark.parametrize("field,value", [
    ("dtype", "float64"), ("shape", [5]), ("wire", "int8"), ("op", 2),
    ("pre", 2.0), ("root", 1)])
def test_cross_process_validation_errors(field, value):
    def script(h):
        h("ready", _ready(0, [_meta("x")]))
        h("ready", _ready(1, [_meta("x", **{field: value})]))
        h("poll", _poll())
    replies = _same(script, world_size=2)
    assert replies[-1]["responses"][0]["kind"] == "error"


def test_error_meta_fails_every_process():
    def script(h):
        h("ready", _ready(0, [_meta("x", error="local shape mismatch")]))
        h("ready", _ready(1, [_meta("x")]))
        h("poll", _poll())
    replies = _same(script, world_size=2)
    assert replies[-1]["responses"] == [
        {"kind": "error", "key": "x", "message": "local shape mismatch"}]


def test_join_idempotent_and_exhaustion():
    def script(h):
        req = {"ps": 0, "rank": 0, "ps_size": 2, "proc": 0,
               "proc_members": 2, "jid": 1}
        h("join", dict(req))
        h("join", dict(req))          # a replay must be dropped
        h("join", {**req, "rank": 1, "jid": 2})
        h("poll", _poll())
    replies = _same(script, world_size=1)
    assert [r["kind"] for r in replies[-1]["responses"]] == ["join_done"]


def test_join_makes_allreduce_ready_and_refuses_others():
    def script(h):
        h("join", {"ps": 0, "rank": 0, "ps_size": 2, "proc": 0,
                   "proc_members": 1, "jid": 1, "sid": "s0"})
        h("ready", _ready(1, [_meta("ar"),
                              _meta("bc", type_="BROADCAST", root=1)],
                          sid="s1", rid=1))
        h("poll", _poll())
        h("join", {"ps": 0, "rank": 1, "ps_size": 2, "proc": 1,
                   "proc_members": 1, "jid": 1, "sid": "s1"})
        h("poll", _poll(2))
    replies = _same(script, world_size=2)
    kinds = [r["kind"] for r in replies[2]["responses"]]
    assert kinds == ["error", "batch"]
    assert replies[-1]["responses"][-1]["kind"] == "join_done"


def test_session_restart_and_ready_dedup():
    def script(h):
        h("ready", _ready(0, [_meta("t0", nprocs=1)], rid=1, sid="A"))
        h("ready", _ready(0, [_meta("t0", nprocs=1)], rid=1, sid="A"))
        h("poll", _poll(0, proc=0))
        h("ready", _ready(0, [_meta("t1", nprocs=1)], rid=1, sid="B"))
        h("poll", _poll(0, proc=0))
    replies = _same(script, world_size=1)
    assert [r["keys"] for r in replies[-1]["responses"]] == [["t1"]]


def test_stall_attribution():
    members = {"0": [0], "1": [1]}

    def script(h):
        h("ready", _ready(0, [_meta("st", members=members)]))
        time.sleep(0.15)
        h("poll", _poll(proc=0))
    replies = _same(script, world_size=2, stall_warning_secs=0.1)
    stall = replies[-1]["responses"][0]
    assert stall["kind"] == "stall" and stall["missing_ranks"] == [1]


def test_missed_heartbeats_fail_peers_fast():
    """tests/test_chaos.py:538's scenario: proc 1 stops beating; within
    the window its peers' pending negotiation fails, naming its global
    rank, and later reports fail at once."""
    members = {"0": [0], "1": [1]}

    def script(h):
        h("heartbeat", {"proc": 0, "ranks": [0], "host": "host-a"})
        h("heartbeat", {"proc": 1, "ranks": [1], "host": "host-b"})
        h("ready", _ready(0, [_meta("hb.k1", members=members)],
                          rid=1, sid="s0"))
        time.sleep(0.3)           # window 1.5 x 0.1 s
        h("heartbeat", {"proc": 0})
        h("poll", _poll(0, proc=0))
        h("ready", _ready(0, [_meta("hb.k2", members=members)],
                          rid=2, sid="s0"))
        h("poll", _poll(2, proc=0))
        h("heartbeat", {"proc": 1})
    replies = _same(script, world_size=2, heartbeat_secs=0.1)
    kinds = [r["kind"] for r in replies[4]["responses"]]
    assert kinds == ["dead", "error"]
    assert "[1]" in replies[4]["responses"][1]["message"]
    assert replies[6]["responses"][0]["key"] == "hb.k2"
    assert replies[-1] == {"dead": True}


def test_heartbeat_bye_is_not_a_death():
    def script(h):
        h("heartbeat", {"proc": 0, "ranks": [0]})
        h("heartbeat", {"proc": 1, "ranks": [1]})
        h("heartbeat", {"proc": 1, "bye": True})
        time.sleep(0.3)
        h("heartbeat", {"proc": 0})
        h("poll", _poll(proc=0))
    replies = _same(script, world_size=2, heartbeat_secs=0.1,
                    heartbeat_window=0.15)
    assert replies[-1]["responses"] == []


@pytest.mark.parametrize("secret", [None, b"k"])
def test_rendezvous_round_trip(secret):
    server = torch_http.RendezvousServer(secret=secret, world_size=1)
    port = server.start()
    try:
        client = StoreClient("127.0.0.1", port, secret)
        client.put("/ns/x", b"hello")
        assert client.get("/ns/x") == b"hello"
        assert client.get("/ns/missing") is None
        client.delete("/ns/x")
        assert client.get("/ns/x") is None
        out = client.coord("ready", _ready(0, [_meta("t", nprocs=1)]))
        assert out == {}
        out = client.coord("poll", _poll(proc=0))
        assert out["responses"][0]["keys"] == ["t"]
        if secret is not None:
            # a wrong secret is refused
            bad = StoreClient("127.0.0.1", port, b"wrong")
            with pytest.raises(Exception):
                bad.put("/ns/y", b"1")
        else:
            put_data_into_kvstore("127.0.0.1", port, "scope", "k",
                                  {"a": [1, 2]})
            assert read_data_from_kvstore("127.0.0.1", port, "scope",
                                          "k") == {"a": [1, 2]}
    finally:
        server.stop()


def test_store_controller_cache_roundtrip():
    """The worker-side controller learns cache ids from responses,
    reports by id on repeat, and recovers from eviction."""
    server = torch_http.RendezvousServer(
        secret=b"k", world_size=1, fusion_threshold_bytes=10 ** 6,
        cache_capacity=1)
    port = server.start()
    try:
        sc = StoreController("127.0.0.1", port, b"k", proc_id=0,
                             num_procs=1, nlocal=1)
        sent = []
        orig = sc.client.coord

        def spy(verb, payload, **kw):
            if verb == "ready":
                sent.append(payload["entries"])
            return orig(verb, payload, **kw)

        sc.client.coord = spy
        m1, m2 = _meta("g1", nprocs=1), _meta("g2", nprocs=1)
        sc.report_ready([m1])
        sc.poll(wait=1)
        sc.report_ready([m1])
        sc.poll(wait=1)
        assert sent[1] == [{"key": "g1", "c": 0}]
        sc.report_ready([m2])
        sc.poll(wait=1)
        sc.report_ready([m1])
        resp = sc.poll(wait=1)
        assert resp and resp[0]["keys"] == ["g1"]
        assert sent[-2] == [{"key": "g1", "c": 0}]   # stale hit
        assert sent[-1][0].get("type") == "ALLREDUCE"  # full resend
    finally:
        server.stop()


def test_journal_records_the_log(tmp_path):
    path = tmp_path / "journal.jsonl"
    server = torch_http.RendezvousServer(world_size=1,
                                         journal_path=str(path))
    try:
        c = server.coordinator
        c.handle("ready", _ready(0, [_meta("t", nprocs=1)], sid="s"))
        server.store.put("/ns/x", b"v")
    finally:
        server.stop()
    kinds = [json.loads(line)["k"] for line in path.read_text().splitlines()]
    assert kinds == ["epoch", "sess", "log", "kv"]


def test_autotune_refused():
    with pytest.raises(NotImplementedError, match="A14"):
        torch_http.Coordinator(world_size=1, autotune=True)
    with pytest.raises(NotImplementedError, match="A14"):
        torch_http.coordinator_kwargs({"HOROVOD_AUTOTUNE": "1"})


def _vote(proc, fp, **kw):
    return {"proc": proc, "sid": f"s{proc}", "round": 0, "fp": fp, **kw}


def test_bypass_votes_arm_and_disarm():
    """The bypass verb through ``_same``: votes that disagree, the quorum
    that arms (one ``bypass_arm`` record in the polled log, the pending
    race-window entry dropped), a replayed vote, the disarm on a report
    with entries and on a join, and votes missing their fields."""
    def script(h):
        h("ready", _ready(0, [_meta("g")], rid=1, sid="s0"))
        h("ready", _ready(1, [_meta("g")], rid=1, sid="s1"))
        h("poll", _poll(0, proc=0))
        h("bypass_ready", _vote(0, "x"))
        h("bypass_ready", _vote(1, "y"))
        h("ready", _ready(0, [_meta("w")], rid=2, sid="s0"))
        h("bypass_ready", _vote(0, "x"))
        h("bypass_ready", _vote(1, "x"))
        h("bypass_ready", _vote(1, "x"))
        h("poll", _poll(0, proc=1))
        h("ready", _ready(1, [_meta("w")], rid=2, sid="s1"))
        h("poll", _poll(0, proc=0))
        h("bypass_ready", _vote(0, "z"))
        h("bypass_ready", _vote(1, "z"))
        h("join", {"ps": 0, "rank": 0, "ps_size": 2, "proc": 0, "jid": 1,
                   "sid": "s0"})
        h("bypass_ready", _vote(0, "z"))
        h("bypass_ready", {"proc": 1})
        h("bypass_ready", {"fp": "z"})
        h("poll", _poll(0, proc=1))
    replies = _same(script, world_size=2, fusion_threshold_bytes=1000)
    arms = [r for rep in replies for r in rep.get("responses", [])
            if r.get("kind") == "bypass_arm"]
    assert {a["fp"] for a in arms} == {"x", "z"} and arms[-1]["fp"] == "z"
    assert replies[7] == replies[8] == {"armed": True}


def test_bypass_votes_of_three_procs_with_a_session_change():
    def script(h):
        for fp in ("a", "a"):
            for p in range(3):
                h("bypass_ready", _vote(p, fp))
        h("bypass_ready", _vote(2, "b", sid="new"))
        h("ready", _ready(2, [_meta("k", nprocs=3)], rid=1, sid="new"))
        for p in range(3):
            h("bypass_ready", _vote(p, "c"))
        h("poll", _poll(0, proc=0))
    _same(script, world_size=3)
