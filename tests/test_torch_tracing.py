"""The port's tracing (``horovod_tpu_torch/utils``: the timeline and its
flight recorder, clock sync, the trace merger, the profiler glue, and
the engine's spans and ranges) against the JAX package's.

* ``estimate_offset`` gives the same offset and bound on the same
  synthetic ping samples.
* ``load_trace`` and ``merge_traces`` give the same events on the same
  files, truncated ones included; the port's ``python -m
  horovod_tpu_torch.utils.trace_merge`` writes what the JAX package's
  ``tools/trace_merge.py`` writes.
* The same event sequence fed to both ``Timeline`` classes gives the same
  events apart from ``ts`` (and the wall-clock epoch of the default
  ``clock_sync`` record), in the file and in the ring; the JAX side runs
  its Python writer, as tests/test_tracing.py:211 forces it.
* A 2-rank-thread allreduce run with ``HOROVOD_TIMELINE`` gives, per
  lane, the same multiset of ``(name, ph)`` as the JAX package's.
* The ring stays bounded, ``stop_timeline`` keeps the flight recorder,
  ``dump_trace`` works and ``close`` is idempotent; a monkeypatched
  ``annotate`` sees the fusion and codec ranges (tests/test_tracing.py:
  431), and a CPU profile records them on the engine's thread.
* A 2-process launcher job with the tracing and metrics flags: both
  per-process files, ``GET /timeline`` on two pids, ``POST
  /trace/dump`` and ``/metrics``.
"""

import collections
import contextlib
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.utils import clock_sync as jax_clock
from horovod_tpu.utils import timeline as jax_timeline
from horovod_tpu.utils import trace_merge as jax_merge
from horovod_tpu_torch.utils import clock_sync as torch_clock
from horovod_tpu_torch.utils import profiler as torch_profiler
from horovod_tpu_torch.utils import timeline as torch_timeline
from horovod_tpu_torch.utils import trace_merge as torch_merge

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- clock sync -----------------------------------------------------------------

SAMPLES = {
    "symmetric": [(0.0, 150.0, 100.0), (10.0, 180.0, 30.0),
                  (40.0, 240.0, 90.0)],
    "skewed": [(1e6, 5e6 + 30, 1e6 + 80), (2e6, 6e6 + 7, 2e6 + 9),
               (3e6, 7e6 + 500, 3e6 + 900)],
    "one": [(5.0, 2.0, 5.0)],
    "backwards": [(10.0, 0.0, 8.0), (20.0, 3.0, 26.0)],
}


@pytest.mark.parametrize("case", list(SAMPLES))
def test_estimate_offset_matches(case):
    out = []
    for m in (jax_clock, torch_clock):
        it = iter(SAMPLES[case])
        out.append(m.estimate_offset(lambda: next(it),
                                     samples=len(SAMPLES[case])))
    assert out[0] == out[1]


def test_clock_sync_round_records_the_same_offset():
    """One ClockSync round over a fake coordinator: the same offset and
    bound reach both timelines' ``clock_sync`` record."""
    recs = []
    for m, tl_mod in ((jax_clock, jax_timeline), (torch_clock,
                                                  torch_timeline)):
        tl = tl_mod.Timeline(None, ring_events=16)
        ticks = iter(range(0, 1000, 10))
        tl._ts = lambda: float(next(ticks))

        class Client:
            def coord(self, verb, req):
                assert verb == "clock"
                return {"t": 123.0}
        m.ClockSync(lambda: tl, Client(), samples=4).sync_once()
        rec = tl.clock_sync
        recs.append((rec["offset_us"], rec["uncertainty_us"],
                     rec["source"], rec["samples"]))
        tl.close()
    assert recs[0] == recs[1]


# -- trace files and the merger -------------------------------------------------

def _trace(pid, offset, n=4, sync=True):
    ev = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
           "args": {"name": f"rank {pid}"}}]
    if sync:
        ev.append({"name": "clock_sync", "ph": "M", "pid": pid, "tid": 0,
                   "args": {"offset_us": offset, "source": "coordinator"}})
    for i in range(n):
        ev.append({"name": "ALLREDUCE", "ph": "B" if i % 2 == 0 else "E",
                   "pid": pid, "tid": 1, "ts": 10.0 * i + pid})
    ev.append({"name": "negotiation", "cat": "hvd", "ph": "s", "id": 7,
               "pid": pid, "tid": 1, "ts": 1.0})
    return ev


def _write(path, events, shape):
    text = "[\n" + ",\n".join(json.dumps(e) for e in events)
    if shape == "whole":
        text += "\n]\n"
    elif shape == "trailing comma":
        text += ",\n"
    elif shape == "torn":
        text += ",\n" + json.dumps(events[-1])[:-7]
    path.write_text(text)


SHAPES = ["whole", "no bracket", "trailing comma", "torn"]


@pytest.mark.parametrize("shape", SHAPES)
def test_load_trace_matches(tmp_path, shape):
    path = tmp_path / "t.json"
    _write(path, _trace(1, 5e6), shape)
    assert torch_merge.load_trace(path) == jax_merge.load_trace(path)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("mix", ["synced", "one unsynced", "pid clash"])
def test_merge_traces_matches(tmp_path, mix, align):
    traces = [_trace(0, 1.6e15), _trace(1, 1.6e15 + 250)]
    if mix == "one unsynced":
        traces.append(_trace(2, 0, sync=False))
    elif mix == "pid clash":
        traces.append(_trace(1, 1.6e15 - 40))
    out = [m.merge_traces(json.loads(json.dumps(traces)), align=align)
           for m in (jax_merge, torch_merge)]
    assert out[0] == out[1]
    assert len({ev["pid"] for ev in out[1]}) == len(traces)


def test_trace_merge_cli_matches_the_jax_tool(tmp_path):
    files = []
    for pid, shape in ((0, "whole"), (1, "torn")):
        path = tmp_path / f"tl{pid}.json"
        _write(path, _trace(pid, 1e15 + 100 * pid), shape)
        files.append(str(path))
    outs = []
    for cmd in ([sys.executable, os.path.join(REPO, "tools",
                                              "trace_merge.py")],
                [sys.executable, "-m",
                 "horovod_tpu_torch.utils.trace_merge"]):
        out = tmp_path / f"merged{len(outs)}.json"
        proc = subprocess.run(cmd + ["-o", str(out)] + files, cwd=REPO,
                              env={**os.environ, "PYTHONPATH": REPO},
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(out.read_text())
    assert outs[0] == outs[1]


# -- the Timeline class ---------------------------------------------------------

def _feed(tl):
    tl.negotiate_start("grad/a", "ALLREDUCE")
    tl.negotiate_start("grad/b", "ALLREDUCE")
    tl.op_start(["grad/a", "grad/b"], "ALLREDUCE", algorithm="torus",
                flows={"grad/a": (11, 0.0), "grad/b": (12, 0.0)})
    tl.counter("queue_depth", {"pending": 2, "awaiting": 0})
    tl.op_end()
    tl.mark_cycle()
    with tl.span("compiled.reduce", "COMPILED_ALLREDUCE"):
        pass
    tl.negotiate_start('odd "name"\\x', "BROADCAST")
    tl.op_start(['odd "name"\\x'], "BROADCAST")
    tl.op_end()
    tl.set_clock_sync(42.0, 3.0, source="coordinator", samples=8)


def _strip(events):
    out = []
    for ev in events:
        ev = dict(ev)
        ev.pop("ts", None)
        if ev.get("name") == "clock_sync":
            args = dict(ev["args"])
            args.pop("synced_at_us", None)
            if args.get("source") == "wallclock":
                args.pop("offset_us")
            ev["args"] = args
        out.append(ev)
    return out


def _fed(mod, path):
    tl = mod.Timeline(str(path) if path else None, mark_cycles=True,
                      pid=3, process_name="ranks 3-4 (proc 1)",
                      ring_events=64)
    _feed(tl)
    ring = tl.ring_dump()
    if tl._q is not None:
        # let the writer drain before close: the JAX Python writer reads
        # its queue attribute every event, which close() clears
        while not tl._q.empty():
            time.sleep(0.01)
        time.sleep(0.05)
    tl.close()
    tl.close()
    return ring


@pytest.mark.parametrize("mode", ["file", "ring"])
def test_timeline_events_match(tmp_path, monkeypatch, mode):
    from horovod_tpu.core import native as native_mod
    monkeypatch.setattr(native_mod, "timeline_writer", lambda p: None)
    out = {}
    for name, mod in (("jax", jax_timeline), ("torch", torch_timeline)):
        path = tmp_path / f"{name}.json" if mode == "file" else None
        ring = _fed(mod, path)
        out[name] = (_strip(ring), _strip(torch_merge.load_trace(path))
                     if path else None)
    assert out["torch"] == out["jax"]
    if mode == "file":
        assert out["torch"][1][0]["name"] == "process_name"


def _lanes(events):
    """Per tensor lane, the multiset of ``(name, ph)``.  Lane 0 (the
    queue-depth counters, emitted whenever a cycle sees a queue) is left
    out: how many cycles see one is timing."""
    names = {ev["tid"]: ev["args"]["name"] for ev in events
             if ev.get("name") == "thread_name"}
    lanes = collections.defaultdict(collections.Counter)
    for ev in events:
        if ev.get("ph") != "M" and ev["tid"] in names:
            lanes[names[ev["tid"]]][(ev["name"], ev["ph"])] += 1
    return {k: dict(v) for k, v in lanes.items()}


def _allreduces(hvd, tensor):
    def fn():
        r = hvd.rank()
        for i in range(3):
            hvd.allreduce(tensor(np.full(64, r + i, np.float32)),
                          name=f"x{i}")
        hvd.allreduce(tensor(np.full(512, r, np.float32)), name="q",
                      wire_dtype="int8")
        return True
    return fn


def test_timeline_lanes_match_the_jax_package(hvd_shutdown, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "0")
    out = {}
    for name, hvd, tensor, kw in (
            ("jax", jhvd, lambda a: a, {}),
            ("torch", thvd, torch.from_numpy, {"device": "cpu"})):
        path = tmp_path / f"{name}.json"
        monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
        assert all(hvd.run(_allreduces(hvd, tensor), np=2, **kw))
        out[name] = _lanes(torch_merge.load_trace(path))
    assert out["torch"] == out["jax"]
    assert out["torch"]["allreduce.x0"][("ALLREDUCE", "B")] == 1
    assert out["torch"]["allreduce.x0"][("NEGOTIATE_ALLREDUCE", "B")] == 2


# -- the flight recorder and the user surface -----------------------------------

def test_ring_stays_bounded_and_lanes_are_capped():
    tl = torch_timeline.Timeline(None, ring_events=32)
    for i in range(3000):
        tl.negotiate_start(f"allreduce.noname.{i}", "ALLREDUCE")
        tl.op_start([f"allreduce.noname.{i}"], "ALLREDUCE")
        tl.op_end()
    assert len(tl._ring) == 32
    assert len(tl._tids) == 1024        # the ring-only lane cap
    dump = tl.ring_dump()
    assert dump[0]["name"] == "process_name"
    assert sum(1 for ev in dump if ev.get("ph") != "M") == 32
    tl.close()
    tl.close()


def test_stop_timeline_keeps_the_flight_recorder(hvd_shutdown, tmp_path):
    path = tmp_path / "tl.json"
    dump = tmp_path / "dump.json"

    def fn():
        r = thvd.rank()
        thvd.allreduce(torch.ones(8) * r, name="before")
        if r == 0:
            thvd.start_timeline(str(path), mark_cycles=True)
        thvd.allreduce(torch.ones(8) * r, name="during")
        thvd.barrier()
        if r == 0:
            with pytest.raises(ValueError, match="already active"):
                thvd.start_timeline(str(path))
            thvd.stop_timeline()
            assert thvd.engine().timeline.filename is None
        thvd.allreduce(torch.ones(8) * r, name="after")
        thvd.barrier()
        return thvd.dump_trace(str(dump)) if r == 0 else None

    got = thvd.run(fn, np=2, device="cpu")
    assert got[0] == str(dump)
    def lanes(events):
        return {ev["args"]["name"] for ev in events
                if ev.get("name") == "thread_name"}

    # the file holds what ran while it was open; the ring that
    # stop_timeline put in its place holds what ran after
    assert "allreduce.during" in lanes(torch_merge.load_trace(path))
    ring = json.loads(dump.read_text())
    assert "allreduce.after" in lanes(ring)
    assert "allreduce.during" not in lanes(ring)
    assert thvd.metrics()["horovod_trace_ring_dumps_total"]["samples"] == [
        {"labels": {"reason": "manual"}, "value": 1.0}]


def test_annotate_sees_the_fusion_and_codec_ranges(hvd_shutdown,
                                                   monkeypatch):
    seen = []

    @contextlib.contextmanager
    def recording(name, device=None):
        seen.append(name)
        yield

    monkeypatch.setattr(torch_profiler, "annotate", recording)

    def fn():
        thvd.allreduce(torch.ones(2048), name="prof_full")
        thvd.allreduce(torch.ones(2048), name="prof_q", wire_dtype="int8")
        return True

    assert all(thvd.run(fn, np=2, device="cpu"))
    assert {"hvd_fusion_pack", "hvd_fusion_unpack", "hvd_quantize_encode",
            "hvd_quantize_decode"} <= set(seen)


def test_profile_records_the_engine_thread_ranges(hvd_shutdown, tmp_path):
    """``profile(cuda=False)`` records every thread's ranges, the
    engine's too, and exports the Chrome trace; CUDA activity without a
    card raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_profiler.start_profile(str(tmp_path), cuda=True)

    def fn():
        thvd.allreduce(torch.ones(2048), name="x", wire_dtype="int8")
        return True

    with torch_profiler.profile(str(tmp_path / "prof"), cuda=False) as p:
        thvd.run(fn, np=2, device="cpu")
    names = {e.name for e in p.prof.events()}
    assert {"hvd_fusion_pack", "hvd_fusion_unpack", "hvd_quantize_encode",
            "hvd_quantize_decode"} <= names
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    tids = {ev["tid"] for ev in trace["traceEvents"]
            if ev.get("name") == "hvd_fusion_pack"}
    assert tids
    assert torch_profiler.stop_profile() is None


# -- a launcher job ---------------------------------------------------------------

WORKER = textwrap.dedent("""
    import json, os, sys, time, urllib.request
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    r = hvd.rank()
    eng = hvd.engine()
    for i in range(4):
        hvd.allreduce(torch.ones(256) * r, name=f"g{i % 2}")
    hvd.barrier()
    eng.push_metrics()
    hvd.barrier()
    out = {"buckets": eng.allreduce_buckets,
           "ring": eng.config.trace_ring_events,
           "sync": eng.config.clock_sync_secs}
    if r == 0:
        base = ("http://" + os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"]
                + ":" + os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"])
        def get(path, data=None):
            req = urllib.request.Request(base + path, data=data,
                                         method="POST" if data else "GET")
            return urllib.request.urlopen(req, timeout=60).read()
        out["dump_id"] = json.loads(get("/trace/dump", b"{}"))["dump_id"]
        merged = json.loads(get("/timeline?wait=20"))
        out["pids"] = sorted({ev["pid"] for ev in merged})
        out["metrics"] = get("/metrics").decode()
        fams = json.loads(get("/metrics.json"))["families"]
        out["executions"] = [s["count"] for s in
                             fams["horovod_execution_seconds"]["samples"]
                             if s["labels"]["op"] == "ALLREDUCE"]
    hvd.barrier()
    with open(os.path.join(sys.argv[1], f"w{r}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def test_launcher_job_traces_and_metrics(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    tl = tmp_path / "tl.json"
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--cpu", "--timeline-filename", str(tl),
         "--trace-ring-events", "512", "--trace-clock-sync-seconds", "1",
         "--metrics-push-seconds", "5", "--", sys.executable, str(worker),
         str(tmp_path)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    reps = [json.loads((tmp_path / f"w{r}.json").read_text())
            for r in range(2)]
    assert [(r["ring"], r["sync"]) for r in reps] == [(512, 1.0)] * 2
    assert reps[0]["pids"] == [0, 1] and reps[0]["dump_id"] >= 1
    assert reps[0]["executions"] == [sum(r["buckets"] for r in reps)]
    assert "# TYPE horovod_execution_seconds histogram" in \
        reps[0]["metrics"]
    files = [tl, tmp_path / "tl.proc1.json"]
    traces = [torch_merge.load_trace(p) for p in files]
    assert [sorted({ev["pid"] for ev in t}) for t in traces] == [[0], [1]]
    for t in traces:
        sources = {ev["args"]["source"] for ev in t
                   if ev.get("name") == "clock_sync"}
        assert sources == {"wallclock", "coordinator"}
    merged = torch_merge.merge_traces(traces)
    assert sorted({ev["pid"] for ev in merged}) == [0, 1]
