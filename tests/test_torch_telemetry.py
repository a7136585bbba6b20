"""The port's telemetry (``horovod_tpu_torch/telemetry``, the engine's
families, the coordinator's job-wide ``/metrics``) against the JAX
package's.

* The same sequence of registry operations renders byte for byte the
  same Prometheus text and JSON on both packages, and
  ``merge_snapshots`` merges the same snapshots to the same result.
* The port's engine registers the JAX engine's families: the same
  names, types, help text, label names and histogram bounds.
* After the same ``run(np=2)`` workload at rank threads, with fusion
  pinned (``HOROVOD_FUSION_THRESHOLD=0``: one bucket a tensor), the
  execution, wire-byte, algorithm, quantized-bucket, fused-allgather
  and bypass counters agree.
* Both coordinators merge the same pushed snapshots to the same
  ``/metrics.json`` and ``/metrics``.

No tensor math enters a render or a merge: those compare byte for byte.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.telemetry as jtel
import horovod_tpu_torch as thvd
import horovod_tpu_torch.telemetry as ttel
from horovod_tpu.runner.http import http_client as jax_client
from horovod_tpu.runner.http import http_server as jax_http
from horovod_tpu_torch.runner.http import http_client as torch_client
from horovod_tpu_torch.runner.http import http_server as torch_http

PKGS = {"jax": jtel, "torch": ttel}


def _script_basic(m):
    reg = m.MetricRegistry()
    c = reg.counter("horovod_test_total", "A counter", labelnames=("op",))
    c.labels(op="ALLREDUCE").inc(3)
    c.labels(op="BROADCAST").inc()
    c.labels(op="ALLREDUCE").inc(0.5)
    g = reg.gauge("horovod_test_gauge", "A gauge")
    g.set(7)
    g.dec(2)
    h = reg.histogram("horovod_test_seconds", "A histogram",
                      labelnames=("op",))
    for v in (0.00005, 0.001, 0.02, 3.0, 100.0):
        h.labels(op="x").observe(v)
    return reg


def _script_escapes(m):
    reg = m.MetricRegistry()
    c = reg.counter("horovod_esc_total", 'Help with \\ and\nnewline',
                    labelnames=("ranks", "name"))
    c.labels(ranks="0,1,+6", name='a"b\\c\nd').inc(2)
    reg.gauge("horovod_empty_help").set(-1.25)
    r = reg.histogram("horovod_req_seconds", "Requests",
                      buckets=m.REQUEST_LATENCY_BUCKETS)
    for v in (0.0004, 0.003, 0.2, 11.0):
        r.observe(v)
    reg.counter("horovod_big_total").inc(2 ** 60)
    return reg


def _script_catalogue(m):
    reg = m.fresh_registry()
    m.account_alltoall_bytes("inner", None, 1024, 1024)
    m.account_alltoall_bytes("cross", "int8", 4096, 1040)
    m.count_alltoall_run("compiled", "int8")
    m.add_exposed_comm_seconds("grouped", 0.125)
    m.count_overlap_buckets(3)
    m.count_fabric_retry("poll")
    m.count_fault_injected("drop")
    m.count_coord_resync()
    m.count_agg_fallback("direct")
    m.observe_control_cycle("worker", 0.004)
    m.count_sharded_update()
    m.set_optimizer_state_bytes("shard", 1000)
    m.set_optimizer_state_bytes("full", 2000)
    return reg


SCRIPTS = {"basic": _script_basic, "escapes": _script_escapes,
           "catalogue": _script_catalogue}


@pytest.mark.parametrize("script", list(SCRIPTS))
def test_renders_match_byte_for_byte(script):
    out = {}
    for name, m in PKGS.items():
        snap = SCRIPTS[script](m).snapshot()
        out[name] = (m.render_prometheus(snap),
                     m.render_json(snap, proc=3, round=1))
    assert out["torch"] == out["jax"]


def _snapshots(m):
    a, b = _script_basic(m), _script_basic(m)
    b.gauge("horovod_test_gauge").set(11)
    b.counter("horovod_only_b_total").inc()
    odd = m.MetricRegistry()
    odd.histogram("horovod_test_seconds", "A histogram",
                  labelnames=("op",), buckets=(1.0, 2.0)).labels(
        op="x").observe(1.5)
    return [a.snapshot(), b.snapshot(), odd.snapshot(), "not a dict"]


@pytest.mark.parametrize("render", ["json", "prometheus"])
def test_merge_snapshots_match(render):
    """Counters sum, gauges gain max/min samples, histograms merge bucket
    by bucket and a worker whose bounds differ is dropped: the same on
    both packages."""
    out = {}
    for name, m in PKGS.items():
        merged = m.merge_snapshots(_snapshots(m))
        out[name] = m.render_json(merged) if render == "json" \
            else m.render_prometheus(merged)
    assert out["torch"] == out["jax"]
    merged = json.loads(out["torch"])["families"] if render == "json" \
        else None
    if merged is not None:
        gauge = merged["horovod_test_gauge"]["samples"]
        assert sorted(s["value"] for s in gauge) == [5.0, 11.0]


def _family_meta(snap):
    return {name: (f["type"], f["help"], tuple(f["labelnames"]),
                   tuple(f.get("buckets") or ()))
            for name, f in snap.items()}


def test_engine_registers_the_jax_families(hvd_shutdown):
    """A fresh engine's catalogue: every family the JAX engine declares,
    with the same name, type, help, labels and bounds."""
    jhvd.run(lambda: None, np=2)
    jax_meta = _family_meta(jtel.metrics())
    thvd.run(lambda: None, np=2, device="cpu")
    torch_meta = _family_meta(ttel.metrics())
    assert len(jax_meta) > 30
    assert torch_meta == jax_meta


def _workload(hvd, tensor):
    def fn():
        r = hvd.rank()
        outs = []
        for i in range(3):
            outs.append(hvd.allreduce(tensor(np.full(300, r + i,
                                                     np.float32)),
                                      name=f"f{i}"))
        outs.append(hvd.allreduce(tensor(np.arange(1024, dtype=np.float32)
                                         * (r + 1) / 7), name="q",
                                  wire_dtype="int8"))
        outs.append(hvd.allreduce(tensor(np.full(512, r, np.float32)),
                                  name="h", wire_dtype="bf16"))
        outs.append(hvd.allgather(tensor(np.full((2, 3), r, np.float32)),
                                  name="g"))
        outs.append(hvd.broadcast(tensor(np.full(5, r, np.float32)), 0,
                                  name="b"))
        return len(outs)
    return fn


_COUNTERS = ("horovod_wire_logical_bytes_total",
             "horovod_wire_actual_bytes_total",
             "horovod_wire_cross_bytes_total",
             "horovod_allreduce_runs_total",
             "horovod_quantized_buckets_total",
             "horovod_fused_allgather_runs_total",
             "horovod_negotiation_bypass_cycles_total",
             "horovod_world_size")


def _counter_view(snap):
    out = {}
    for name in _COUNTERS:
        out[name] = sorted((tuple(sorted(s["labels"].items())), s["value"])
                           for s in snap[name]["samples"])
    out["executions"] = sorted(
        (s["labels"]["op"], s["count"])
        for s in snap["horovod_execution_seconds"]["samples"])
    out["negotiations"] = sorted(
        (s["labels"]["op"], s["count"])
        for s in snap["horovod_negotiation_seconds"]["samples"])
    return out


def test_counters_agree_after_the_same_workload(hvd_shutdown, monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    assert jhvd.run(_workload(jhvd, lambda a: a), np=2) == [7, 7]
    jax_view = _counter_view(jtel.metrics())
    assert thvd.run(_workload(thvd, torch.from_numpy), np=2,
                    device="cpu") == [7, 7]
    torch_view = _counter_view(ttel.metrics())
    assert torch_view == jax_view
    assert dict(torch_view["executions"])["ALLREDUCE"] == 5
    assert torch_view["horovod_quantized_buckets_total"] == [((), 1.0)]


def _push_and_scrape(pkg, snaps):
    http = {"jax": jax_http, "torch": torch_http}[pkg]
    client_mod = {"jax": jax_client, "torch": torch_client}[pkg]
    m = PKGS[pkg]
    server = http.RendezvousServer(world_size=2)
    port = server.start()
    try:
        client = client_mod.StoreClient("127.0.0.1", port)
        for proc, snap in enumerate(snaps):
            client.put(f"{m.TELEMETRY_KV_PREFIX}{proc}",
                       m.render_json(snap, proc=proc, round=0).encode())
        # a stale push (an earlier round) and a foreign value are skipped
        client.put(f"{m.TELEMETRY_KV_PREFIX}7",
                   m.render_json(snaps[0], proc=0, round=9).encode())
        client.put(f"{m.TELEMETRY_KV_PREFIX}x", b"not json")
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        js = urllib.request.urlopen(base + "/metrics.json",
                                    timeout=10).read().decode()
        return text, js
    finally:
        server.stop()


def test_coordinator_merges_the_same_pushed_snapshots():
    out = {}
    for pkg, m in PKGS.items():
        snaps = [_script_basic(m).snapshot(), _script_catalogue(m).snapshot()]
        out[pkg] = _push_and_scrape(pkg, snaps)
    assert out["torch"] == out["jax"]
    fams = json.loads(out["torch"][1])["families"]
    assert fams["horovod_test_total"]["samples"][0]["value"] == 3.5
    assert "horovod_coord_epoch" in fams
