"""NTP-style clock-offset estimation between workers and the launcher
(port of ``horovod_tpu/utils/clock_sync.py``).

Every worker's timeline runs on its own private ``time.perf_counter``
epoch, so per-worker traces cannot be laid side by side: the same
collective appears at unrelated timestamps on every rank.  This module
estimates, per worker, the offset between the worker's timeline clock
and the launcher's wall clock — the reference clock every rank can
reach over the existing KV/coordinator fabric — so the trace merger
(utils/trace_merge.py, ``GET /timeline``) can place all ranks on one
time axis.

The estimator is the classic NTP midpoint: sample ``t0`` (local, before
the request), ``t_server`` (the coordinator's clock, from the ``clock``
verb) and ``t1`` (local, after).  Assuming the request and response
legs are symmetric, ``offset = t_server - (t0 + t1) / 2`` with error
bounded by half the round trip.  Repeated samples keep the minimum-RTT
one (its bound is tightest); the reported uncertainty is that RTT / 2.
A background thread re-samples periodically so clock drift over a long
job stays inside the uncertainty band.
"""

import logging
import threading

logger = logging.getLogger("horovod_tpu_torch")

#: Samples per sync round.  Eight round trips over the loopback/DCN
#: fabric cost well under a millisecond each; the min-RTT filter needs
#: a handful of draws to dodge scheduler hiccups.
DEFAULT_SAMPLES = 8


def estimate_offset(sample_fn, samples=DEFAULT_SAMPLES):
    """Estimate the server-clock offset from repeated ping samples.

    ``sample_fn()`` performs one round trip and returns
    ``(t0, t_server, t1)`` — all in the SAME unit (this codebase uses
    microseconds), ``t0``/``t1`` on the local clock, ``t_server`` on
    the reference clock.  Returns ``(offset, uncertainty)`` such that
    ``reference_time ≈ local_time + offset`` with
    ``|error| <= uncertainty`` (half the best round trip).
    """
    best_rtt = None
    best_off = 0.0
    for _ in range(max(int(samples), 1)):
        t0, t_server, t1 = sample_fn()
        rtt = max(float(t1) - float(t0), 0.0)
        off = float(t_server) - (float(t0) + float(t1)) / 2.0
        if best_rtt is None or rtt < best_rtt:
            best_rtt, best_off = rtt, off
    return best_off, best_rtt / 2.0


class ClockSync:
    """Worker-side periodic clock synchronization.

    Pings the coordinator's ``clock`` verb over the existing
    StoreClient fabric, estimates the offset between THIS worker's
    timeline epoch and the launcher's wall clock, and records it on the
    timeline as a ``clock_sync`` metadata event
    (:meth:`..utils.timeline.Timeline.set_clock_sync`).  Re-samples
    every ``interval`` seconds for drift; each re-sample emits a fresh
    record (the merger uses the last one).

    ``timeline_fn`` is a callable returning the CURRENT timeline (it
    can be swapped by ``start_timeline``/``stop_timeline`` at runtime).
    Failures are swallowed: clock sync is observability and must never
    kill a worker mid-teardown.
    """

    def __init__(self, timeline_fn, client, interval=30.0,
                 samples=DEFAULT_SAMPLES):
        self.timeline_fn = timeline_fn
        self.client = client
        self.interval = max(float(interval), 1.0)
        self.samples = samples
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="horovod_tpu_torch-clock-sync",
            daemon=True)

    def start(self):
        self._thread.start()
        return self

    def stop(self, timeout=5.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)

    def sync_once(self):
        """One sync round NOW (also the loop body)."""
        tl = self.timeline_fn()
        if tl is None:
            return None

        def sample():
            t0 = tl._ts()
            out = self.client.coord("clock", {})
            t1 = tl._ts()
            return t0, float(out["t"]) * 1e6, t1

        try:
            offset_us, err_us = estimate_offset(sample, self.samples)
        except Exception as exc:  # noqa: BLE001 — coordinator may be
            # unreachable (teardown, elastic reset); retry next round
            logger.debug("clock sync round failed: %s", exc)
            return None
        # chaos clock_skew faults shift THIS worker's estimated offset,
        # so skew scenarios flow through the real trace alignment path
        # (chaos/inject.py; 0.0 without a plan)
        from ..chaos import current_skew_seconds
        offset_us += current_skew_seconds() * 1e6
        tl.set_clock_sync(offset_us, err_us, source="coordinator",
                          samples=self.samples)
        return offset_us, err_us

    def _loop(self):
        while True:
            self.sync_once()
            if self._stop.wait(self.interval):
                return
