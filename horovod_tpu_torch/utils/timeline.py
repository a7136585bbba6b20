"""Chrome-tracing timeline (port of ``horovod_tpu/utils/timeline.py``).

Reimplements the reference Timeline subsystem
(``horovod/common/timeline.{h,cc}``; format documented in
docs/timeline.rst): per-tensor lanes with NEGOTIATING and operation
phases, written as Chrome trace-event JSON by an async writer so the
engine's dispatch loop never blocks on file IO.  View in
chrome://tracing or Perfetto.  Activate with ``HOROVOD_TIMELINE=path``
or ``start_timeline()``/``stop_timeline()`` at runtime (reference
operations.cc:1077-1109).

The writer is a Python queue and writer thread: the JAX package's
native C++ writer (``csrc/timeline.cpp``) has no counterpart in the
port, so this is the JAX module's own fallback path.

Op spans are host time: the engine enqueues a bucket's kernels on its
CUDA stream and moves on, so an ``ALLREDUCE`` span covers the launches,
not the device's work.  Device time is the profiler's
(``utils/profiler.py``).

Job-wide extensions (docs/timeline.md "Job-wide traces"):

* every event carries the worker's **pid** (its first global rank, not
  the reference's hardcoded ``pid: 0``) plus ``process_name`` metadata,
  so merged traces get one lane group per rank;
* a ``clock_sync`` metadata record maps this worker's private
  ``perf_counter`` epoch onto the launcher's wall clock
  (utils/clock_sync.py), letting ``utils/trace_merge.py`` and the
  launcher's ``GET /timeline`` place every rank on one time axis;
* Chrome **flow events** (``s``/``f``) tie each rank's NEGOTIATE span
  to the fused execution span through the coordinator-minted trace id,
  so a merged trace draws arrows from the last-arriving (straggler)
  rank into the collective it delayed;
* a bounded in-memory **flight-recorder ring** of recent events
  (``HOROVOD_TRACE_RING_EVENTS``, on by default — no file needed) that
  the engine dumps on stall warnings and on demand
  (``hvd.dump_trace()``).
"""

import atexit
import collections
import json
import queue
import re
import threading
import time

_NAME_SANITIZE = re.compile(r'[\\"\x00-\x1f]')

#: Chrome flow-event name/category shared by the ``s``/``f`` pair; the
#: trace viewer chains same-(cat, id) events in time order, so in a
#: merged trace the straggler's ``s`` is the arrow into the first
#: execution ``f``.
FLOW_NAME = "negotiation"
FLOW_CAT = "hvd"

#: the file writer's batching window: it sleeps this long after a batch's
#: first event before it drains and writes the batch
WRITER_BATCH_SECONDS = 0.05


class Timeline:
    """Async Chrome-trace writer (reference TimelineWriter,
    timeline.h:48-100) + flight-recorder ring.

    ``filename=None`` runs ring-only: no writer thread, no file — just
    the bounded in-memory ring the flight recorder dumps from.
    """

    def __init__(self, filename=None, mark_cycles=False, pid=0,
                 process_name=None, ring_events=0):
        self.filename = filename
        self.mark_cycles = mark_cycles
        self.pid = int(pid)
        self.process_name = process_name or f"rank {self.pid}"
        # wall-clock epoch captured adjacent to the perf_counter epoch:
        # the default clock_sync record (single-process jobs, and
        # multi-process before the first coordinator sync round) maps
        # ts=0 to this machine's wall clock
        self._epoch_unix_us = time.time() * 1e6
        self._start = time.perf_counter()
        self._tids = collections.OrderedDict()
        # ring-only timelines are ON BY DEFAULT for every job, so the
        # per-tensor lane map must stay bounded: auto-named tensors
        # ("allreduce.noname.N") mint a fresh lane per call and would
        # otherwise grow worker memory (and every ring dump) without
        # limit.  File-writing timelines keep the unbounded pre-ring
        # behavior — lanes are the file format and the user opted in.
        self._max_tids = None if filename \
            else max(1024, int(ring_events or 0))
        self._next_tid = 1
        self._lock = threading.Lock()
        self._open_ops = []
        self._q = None
        self._thread = None
        self._closed = False
        self._clock_sync = None
        self._ring = collections.deque(maxlen=int(ring_events)) \
            if ring_events and int(ring_events) > 0 else None
        # serializes emits against close(): no event may be queued after
        # the writer's end marker
        self._emit_lock = threading.Lock()
        if filename:
            self._q = queue.Queue()
            self._thread = threading.Thread(
                target=self._writer_loop, name="horovod_tpu_torch-timeline",
                daemon=True)
            self._thread.start()
        # a worker that exits without stop_timeline()/shutdown() must
        # still leave a parseable trace: the daemon writer threads die
        # mid-event at interpreter exit unless the file is finalized
        atexit.register(self.close)
        self._emit_meta("process_name", {"name": self.process_name})
        self.set_clock_sync(self._epoch_unix_us, 0.0,
                            source="wallclock", samples=0)

    # -- engine-facing hooks -------------------------------------------------

    def _ts(self):
        return (time.perf_counter() - self._start) * 1e6  # microseconds

    def _record(self, ev):
        """Append to the flight-recorder ring (lock-free: deque append
        is atomic under the GIL; the ring tolerates best-effort
        ordering across threads)."""
        if self._ring is not None:
            self._ring.append(ev)

    def _emit(self, name, ph, tid, ts):
        if self._ring is None and self._q is None:
            return
        ev = {"name": name, "ph": ph, "pid": self.pid, "tid": tid,
              "ts": ts}
        if ph == "i":
            ev["s"] = "g"    # global-scope instant marker
        self._record(ev)
        with self._emit_lock:
            if self._q is not None:
                self._q.put(ev)

    def _emit_flow(self, fid, ph, tid, ts):
        """Chrome flow event (``s`` start / ``f`` finish) on a tensor
        lane; same (cat, id) events chain across pids in the merged
        trace."""
        if self._ring is None and self._q is None:
            return
        ev = {"name": FLOW_NAME, "cat": FLOW_CAT, "ph": ph,
              "id": int(fid), "pid": self.pid, "tid": tid, "ts": ts}
        if ph == "f":
            ev["bp"] = "e"   # bind to the enclosing execution slice
        self._record(ev)
        with self._emit_lock:
            if self._q is not None:
                self._q.put(ev)

    def _emit_meta(self, name, args, tid=0):
        """Metadata ("M") record with an args payload (process_name,
        clock_sync)."""
        ev = {"name": name, "ph": "M", "pid": self.pid, "tid": tid,
              "args": dict(args)}
        with self._emit_lock:
            if self._q is not None:
                self._q.put(ev)

    def set_clock_sync(self, offset_us, uncertainty_us=None,
                       source="coordinator", samples=0):
        """Record the mapping from THIS timeline's ts domain to the
        reference (launcher wall) clock:
        ``reference_us ≈ ts + offset_us`` within ``uncertainty_us``.
        Emitted as a ``clock_sync`` metadata event — re-emitted on
        every drift re-sample; mergers use the last one."""
        self._clock_sync = {
            "offset_us": float(offset_us),
            "uncertainty_us": float(uncertainty_us)
            if uncertainty_us is not None else None,
            "source": source,
            "samples": int(samples),
            "synced_at_us": self._ts(),
        }
        self._emit_meta("clock_sync", self._clock_sync)

    def _tid(self, name):
        with self._lock:
            tid = self._tids.get(name)
            if tid is not None and self._max_tids is not None:
                # bounded (ring-only) mode evicts least-recently-USED:
                # without the touch, FIFO eviction would drop the
                # persistent hot tensors registered first and keep the
                # stale auto-named churn the bound exists to shed
                self._tids.move_to_end(name)
            if tid is None:
                if self._max_tids is not None \
                        and len(self._tids) >= self._max_tids:
                    # evict the oldest lane (tid number is NOT reused,
                    # so ring events referencing it merely lose their
                    # thread_name metadata in later dumps)
                    self._tids.popitem(last=False)
                tid = self._next_tid
                self._next_tid += 1
                self._tids[name] = tid
                clean = _NAME_SANITIZE.sub("_", name)[:90]
                with self._emit_lock:
                    if self._q is not None:
                        self._q.put({"name": "thread_name", "ph": "M",
                                     "pid": self.pid, "tid": tid,
                                     "args": {"name": clean}})
            return tid

    def negotiate_start(self, tensor_name, op_name):
        """A rank declared the tensor ready (reference
        Timeline::NegotiateStart, fed from controller.cc:1123)."""
        self._emit(f"NEGOTIATE_{op_name}", "B",
                   self._tid(tensor_name), self._ts())

    def op_start(self, tensor_names, op_name, algorithm=None,
                 flows=None):
        """Negotiation complete; collective starting (reference
        Timeline::Start + ActivityStartAll).  ``algorithm`` records
        the chosen reduction algorithm (flat / hierarchical / torus)
        as an instant marker on each tensor's lane, so traces show
        which hops a reduction took without changing the op event
        names the reference's own timeline tests assert.

        ``flows``: ``{tensor_name: (trace_id, ready_ts_us)}`` — for
        each entry of the bucket that carries a job-unique trace id,
        emit a flow start (``s``) at the moment this rank became
        locally ready and a flow finish (``f``) bound to the execution
        span, so merged traces draw the straggler arrow."""
        ts = self._ts()
        tids = []
        for n in tensor_names:
            tid = self._tid(n)
            tids.append(tid)
            self._emit(f"NEGOTIATE_{op_name}", "E", tid, ts)
            self._emit(op_name, "B", tid, ts)
            if algorithm is not None:
                self._emit(f"ALGO_{algorithm.upper()}", "i", tid, ts)
        if flows:
            for n, (fid, ready_ts) in flows.items():
                tid = self._tid(n)
                # the s must precede (or coincide with) the f it chains
                # into, and must land inside the NEGOTIATE slice
                self._emit_flow(fid, "s", tid, min(ready_ts, ts))
                self._emit_flow(fid, "f", tid, ts)
        with self._lock:
            self._open_ops.append((list(tids), op_name))

    def op_end(self):
        ts = self._ts()
        with self._lock:
            if not self._open_ops:
                return
            tids, op_name = self._open_ops.pop()
        for tid in tids:
            self._emit(op_name, "E", tid, ts)

    def mark_cycle(self):
        if self.mark_cycles:
            # reference marker name (timeline.cc MarkCycleStart; its
            # own test asserts the exact string)
            self._emit("CYCLE_START", "i", 0, self._ts())

    def counter(self, name, values):
        """Chrome counter ("C") event: ``values`` is a {series: number}
        dict rendered as a stacked area track in the trace viewer.  The
        engine mirrors its queue-depth and wire-byte gauges here every
        work cycle, so traces and /metrics tell one story
        (docs/timeline.md).  Safe from any thread; numbers only."""
        ts = self._ts()
        args = {str(k): float(v) for k, v in values.items()}
        self._record({"name": name, "ph": "C", "pid": self.pid,
                      "tid": 0, "ts": ts, "args": args})
        with self._emit_lock:
            if self._q is not None:
                self._q.put({"name": name, "ph": "C", "pid": self.pid,
                             "tid": 0, "ts": ts, "args": args})

    def span(self, tensor_name, op_name):
        """Self-contained B/E pair on the tensor's own lane — safe
        from ANY thread (no shared open-op stack, no negotiate
        pairing).  Used by the compiled (in-graph) path, which has no
        negotiation phase."""
        tid = self._tid(tensor_name)
        self._emit(op_name, "B", tid, self._ts())
        timeline = self

        class _Span:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                timeline._emit(op_name, "E", tid, timeline._ts())
                return False

        return _Span()

    # -- flight recorder -----------------------------------------------------

    @property
    def clock_sync(self):
        return dict(self._clock_sync) if self._clock_sync else None

    def ring_dump(self):
        """Snapshot the flight-recorder ring as a self-contained Chrome
        trace (list of event dicts).  Metadata that may have scrolled
        off the ring — process_name, per-tensor thread_name lanes, the
        latest clock_sync — is regenerated up front so the dump always
        parses stand-alone."""
        events = [{"name": "process_name", "ph": "M", "pid": self.pid,
                   "tid": 0, "args": {"name": self.process_name}}]
        with self._lock:
            tids = dict(self._tids)
        for name, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            clean = _NAME_SANITIZE.sub("_", name)[:90]
            events.append({"name": "thread_name", "ph": "M",
                           "pid": self.pid, "tid": tid,
                           "args": {"name": clean}})
        if self._clock_sync is not None:
            events.append({"name": "clock_sync", "ph": "M",
                           "pid": self.pid, "tid": 0,
                           "args": dict(self._clock_sync)})
        if self._ring is not None:
            # appends are GIL-atomic but ITERATING concurrently with
            # an append raises RuntimeError("deque mutated"); each
            # snapshot attempt is fast, so a short retry always wins
            for _ in range(8):
                try:
                    events.extend(list(self._ring))
                    break
                except RuntimeError:
                    continue
        return events

    # -- the writer thread ---------------------------------------------------

    def _writer_loop(self):
        # the queue is held here: close() drops the attribute before it
        # queues the end marker.  After the first event of a batch the
        # thread sleeps WRITER_BATCH_SECONDS, then drains what is queued
        # and flushes once: it wakes (and takes the GIL from the
        # engine's and the ranks' threads) a few times a second, not once
        # an event
        q = self._q
        with open(self.filename, "w") as f:
            f.write("[\n")
            first, done = True, False
            while not done:
                batch = [q.get()]
                if batch[0] is not None:
                    time.sleep(WRITER_BATCH_SECONDS)
                while len(batch) < 65536:
                    try:
                        batch.append(q.get_nowait())
                    except queue.Empty:
                        break
                parts = []
                for ev in batch:
                    if ev is None:
                        done = True
                        break
                    parts.append(json.dumps(ev))
                if parts:
                    f.write(("" if first else ",\n") + ",\n".join(parts))
                    first = False
                    f.flush()
            f.write("\n]\n")

    def close(self):
        """Finalize the writer (idempotent; also registered atexit so
        an unclean worker exit still leaves a parseable trace)."""
        with self._emit_lock:
            if self._closed:
                return
            self._closed = True
            q, self._q = self._q, None
        try:
            atexit.unregister(self.close)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
        if q is not None:
            q.put(None)
            self._thread.join(timeout=10)
