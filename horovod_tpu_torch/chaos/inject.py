"""Worker-side fault injection runtime (port of
``horovod_tpu/chaos/inject.py``).

One :class:`FaultInjector` per worker process, installed by
``hvd.init()`` when ``HOROVOD_FAULT_PLAN`` is set.  Faults strike the
REAL code paths, not mocks:

* **wire faults** (``drop`` / ``delay_ms`` / ``duplicate`` /
  ``http_error``) ride the :class:`StoreClient` middleware hook —
  they fire *before* the bytes leave the process, so the client's
  retry/backoff machinery is what recovers, exactly as it would from
  a flaky coordinator;
* **slow_rank** rides the engine's background loop — the injector
  sleeps right before ``report_ready``, so the coordinator's global
  stall attribution and the stall-triggered flight recorder see a
  genuine straggler;
* **process faults** (``kill`` / ``exit`` / ``hang`` /
  ``clock_skew``) are applied by whichever trigger matures first —
  a fabric-request count, a collective count, or the wall-offset
  chaos thread.  ``hang`` wedges the engine background thread AND
  stops the liveness heartbeat, emulating a fully-stuck process the
  coordinator must detect by missed beats.

Trigger counters advance under one lock and every probabilistic
decision draws from an RNG seeded by ``(plan seed, event index)``
(:meth:`FaultPlan.rng_for`), so two runs of the same plan produce the
identical fault sequence — ``fired`` records it for comparison, and the
same plan fires the same sequence here as in the JAX package.

* **corruption** (``bitflip_grad`` / ``bitflip_wire``) rides the
  engine's and the compiled path's encode seams (``corrupt_bucket``):
  one seeded byte of a packed payload row, or of an encoded wire row,
  is xor-ed on the device through a ``uint8`` view, after the digests
  the decode-side verify holds it against.

The JAX package's serving hooks (``before_predict``, ``before_decode``:
ROADMAP.md A16) have no consumer in the port; plan.py refuses the kinds
and triggers that would need them.
"""

import json
import logging
import os
import signal
import threading
import time

from .. import telemetry
from .plan import COORD_KINDS, FaultEvent, FaultPlan, PROCESS_KINDS

logger = logging.getLogger("horovod_tpu_torch.chaos")


def _count_injected(kind):
    """One injection, into the process-current registry's
    ``horovod_faults_injected_total{kind}`` (the injector's own ``fired``
    record keeps each injection's trigger and wall time)."""
    telemetry.count_fault_injected(kind)


class _EventState:
    """Runtime arming state for one event on this process."""

    __slots__ = ("event", "rng", "fires")

    def __init__(self, event: FaultEvent, rng):
        self.event = event
        self.rng = rng
        self.fires = 0

    def due(self, n: float) -> bool:
        """Whether the event fires at trigger point ``n`` (consumes
        one RNG draw per eligible point when probabilistic)."""
        e = self.event
        if self.fires >= e.count or n < e.at:
            return False
        if e.p < 1.0 and self.rng.random() >= e.p:
            return False
        self.fires += 1
        return True

    @property
    def exhausted(self):
        return self.fires >= self.event.count


class FaultInjector:
    """Applies one plan's worker-side events on this process."""

    def __init__(self, plan: FaultPlan, proc: int = 0,
                 rank_offset: int = 0, num_local: int = 1):
        self.plan = plan
        self.proc = proc
        self.rank_offset = rank_offset
        self.num_local = num_local
        self._lock = threading.Lock()
        self._requests = 0
        self._collectives = 0
        self._commits = 0
        self._buckets = 0
        #: bitflip_wire events matured at the grad site, waiting for the
        #: same bucket's wire site
        self._pending_wire = []
        self._epoch = time.monotonic()
        self._skew_ms = 0.0
        self._hang = threading.Event()
        #: chronological record of fired events — the determinism
        #: evidence two same-seed runs compare
        self.fired = []
        events = plan.worker_events(
            proc, rank_offset, rank_offset + num_local)
        self._by_trigger = {"requests": [], "collectives": [],
                            "wall": [], "commits": [], "buckets": []}
        for e in events:
            self._by_trigger[e.trigger].append(
                _EventState(e, plan.rng_for(e)))
        self._wall_thread = None
        if self._by_trigger["wall"]:
            self._wall_thread = threading.Thread(
                target=self._wall_loop, name="horovod_tpu_torch-chaos",
                daemon=True)
            self._wall_thread.start()

    # -- state ---------------------------------------------------------------

    @property
    def hung(self):
        """True once a ``hang`` event fired: the engine loop is wedged
        and the heartbeat thread must stop beating (the whole point —
        the coordinator's liveness scan has to notice)."""
        return self._hang.is_set()

    def skew_seconds(self):
        """Active ``clock_skew`` offset (seconds) — added to the clock
        estimator's measured offset (utils/clock_sync.py)."""
        return self._skew_ms / 1000.0

    def rebind(self, proc, rank_offset, num_local):
        """Elastic re-init under the same process: retarget without
        resetting counters — triggers count per process lifetime, so
        the fault sequence stays deterministic across rounds."""
        with self._lock:
            self.proc = proc
            self.rank_offset = rank_offset
            self.num_local = num_local

    # -- injection points ----------------------------------------------------

    def before_request(self, method, path):
        """StoreClient middleware hook: called before every fabric
        request (retries included — each attempt is a real request).
        Returns None or one wire action:
        ``("drop",)`` | ``("delay", secs)`` | ``("duplicate",)`` |
        ``("error", status)``."""
        if self._hang.is_set():
            self._park()
        with self._lock:
            self._requests += 1
            n = self._requests
            due = [st.event for st in self._by_trigger["requests"]
                   if st.due(n)]
        return self._apply(due, "requests", n, wire=True)

    def on_collectives(self, n_entries=1):
        """Engine background-loop hook: called with the number of
        entries about to be reported ready.  Sleeps here — before
        ``report_ready`` — when a ``slow_rank`` event matures, turning
        this process into the straggler the coordinator attributes."""
        for _ in range(max(int(n_entries), 1)):
            with self._lock:
                self._collectives += 1
                n = self._collectives
                due = [st.event for st in self._by_trigger["collectives"]
                       if st.due(n)]
            self._apply(due, "collectives", n)

    def corrupt_bucket(self, site, bufs):
        """Encode-site hook of the silent-data-corruption kinds
        (inject.py:214-243 of the JAX package).  The ``"grad"`` site
        counts one reduction bucket and applies due ``bitflip_grad``
        events to the packed payload rows, after the submit-time
        digests; ``bitflip_wire`` events maturing at the same bucket wait
        for the ``"wire"`` site (the encoded codes, scales or cast),
        which applies them after the encode digests.  Positions (row,
        byte, bit) draw from the event's private RNG and land in
        ``fired``, so same-seed runs corrupt identically."""
        states = self._by_trigger["buckets"]
        if not states:
            return
        if site == "grad":
            with self._lock:
                self._buckets += 1
                n = self._buckets
                due = [st for st in states if st.due(n)]
                grads = [st for st in due
                         if st.event.kind == "bitflip_grad"]
                self._pending_wire.extend(
                    (st, n) for st in due
                    if st.event.kind == "bitflip_wire")
            for st in grads:
                self._flip(st, bufs, "grad", n)
        else:
            with self._lock:
                pending, self._pending_wire = self._pending_wire, []
            for st, n in pending:
                self._flip(st, bufs, "wire", n)

    def _flip(self, st, bufs, site, n):
        """Flip one seeded bit of one seeded tensor of ``bufs`` in place:
        a one-byte xor through a ``uint8`` view, on the tensor's own
        device (inject.py:280-306 of the JAX package)."""
        import torch

        if not bufs:
            self._record(st.event, "buckets", n, site=site,
                         row=-1, byte=-1, bit=-1)
            return
        idx = st.rng.randrange(len(bufs))
        t = bufs[idx]
        view = t.reshape(-1).view(torch.uint8)
        if view.numel() == 0:
            self._record(st.event, "buckets", n, site=site,
                         row=idx, byte=-1, bit=-1)
            return
        byte = st.rng.randrange(view.numel())
        bit = st.rng.randrange(8)
        view[byte:byte + 1].bitwise_xor_(1 << bit)
        self._record(st.event, "buckets", n, site=site,
                     row=idx, byte=byte, bit=bit)

    def corrupt_spill(self, blob: bytes) -> bytes:
        """Spill-write hook (common/elastic.State._spill): counts one
        commit and flips a seeded bit in the serialized blob when a
        ``corrupt_spill`` event is due — the CRC trailer was computed
        over the TRUE bytes, so the flipped blob is exactly what a
        torn write leaves on disk."""
        states = self._by_trigger["commits"]
        if not states:
            return blob
        with self._lock:
            self._commits += 1
            n = self._commits
            due = [st for st in states if st.due(n)]
        if not due:
            return blob
        ba = bytearray(blob)
        for st in due:
            byte = st.rng.randrange(len(ba)) if ba else 0
            bit = st.rng.randrange(8)
            if ba:
                ba[byte] ^= 1 << bit
            self._record(st.event, "commits", n,
                         site="spill", byte=byte, bit=bit)
        return bytes(ba)

    # -- application ---------------------------------------------------------

    def _record(self, event: FaultEvent, trigger, n, **extra):
        entry = {"kind": event.kind, "event": event.index,
                 "trigger": trigger, "n": n, **extra}
        with self._lock:
            self.fired.append(entry)
        _count_injected(event.kind)
        logger.warning("chaos: injecting %s (event #%d, %s=%s, proc %d)",
                       event.kind, event.index, trigger, n, self.proc)

    def _apply(self, events, trigger, n, wire=False):
        """Fire matured events.  Process faults apply immediately; in
        a wire context (``before_request``) at most one wire action is
        returned, with delays stacked onto it — elsewhere delays sleep
        inline and the wire-only kinds (drop/duplicate/http_error,
        which only make sense against a request) are recorded but
        inert: plans should trigger those on ``after_requests``."""
        action = None
        delay = 0.0
        for e in events:
            self._record(e, trigger, n)
            if e.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)
            elif e.kind == "exit":
                os._exit(e.code)
            elif e.kind == "hang":
                self._hang.set()
                self._park()
            elif e.kind == "clock_skew":
                self._skew_ms += e.ms
            elif e.kind == "slow_rank":
                time.sleep(e.ms / 1000.0)
            elif e.kind == "delay_ms":
                delay += e.ms / 1000.0
            elif wire and action is None:   # drop/duplicate/http_error
                if e.kind == "drop":
                    action = ("drop",)
                elif e.kind == "duplicate":
                    action = ("duplicate",)
                else:
                    action = ("error", e.code)
        if delay:
            if not wire or action is not None:
                time.sleep(delay)       # inline (or delayed AND failed)
            else:
                action = ("delay", delay)
        return action

    def _park(self):
        """Simulated full-process hang: this thread blocks forever.
        The heartbeat thread observes :attr:`hung` and stops beating,
        so the ONLY way out is the coordinator declaring this worker
        dead and the elastic driver reaping the process."""
        threading.Event().wait()

    def _wall_loop(self):
        states = sorted(self._by_trigger["wall"],
                        key=lambda st: st.event.at)
        for st in states:
            while not st.exhausted:
                dt = self._epoch + st.event.at - time.monotonic()
                if dt > 0:
                    time.sleep(dt)
                secs = time.monotonic() - self._epoch
                if st.due(secs):
                    self._apply([st.event], "wall", round(secs, 3))
                else:
                    # probabilistic skip: redraw shortly — request/
                    # collective triggers redraw at every later
                    # trigger point, so the wall trigger must too
                    # (``break`` would abandon the event after one
                    # failed coin flip)
                    time.sleep(0.05)


def _wall_trigger_loop(st, stop, fire):
    """Shared wall-offset trigger for the service fault runners
    (Coord/Agg): fire the event at its scheduled offset, redrawing
    shortly on a probabilistic skip — ONE definition, so the two
    runners' same-seed determinism semantics can never diverge."""
    epoch = time.monotonic()
    while not st.exhausted and not stop.is_set():
        dt = epoch + st.event.at - time.monotonic()
        if dt > 0 and stop.wait(min(dt, 0.5)):
            return
        if time.monotonic() - epoch < st.event.at:
            continue
        secs = round(time.monotonic() - epoch, 3)
        if st.due(secs):
            fire(st.event, secs)
        else:
            time.sleep(0.05)    # probabilistic skip: redraw


# -- process-wide installation -------------------------------------------------

_INSTALLED = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan, proc=0, rank_offset=0, num_local=1,
            client=None):
    """Install (or rebind) the process-wide injector and hook it into
    the fabric client.  Idempotent per process: an elastic re-init
    retargets the existing injector so trigger counters — and with
    them the deterministic fault sequence — span the whole process
    lifetime."""
    global _INSTALLED
    with _INSTALL_LOCK:
        if _INSTALLED is None:
            _INSTALLED = FaultInjector(plan, proc=proc,
                                       rank_offset=rank_offset,
                                       num_local=num_local)
        else:
            _INSTALLED.rebind(proc, rank_offset, num_local)
        if client is not None:
            client.middleware = _INSTALLED
        return _INSTALLED


def current():
    """The process-wide injector, or None."""
    return _INSTALLED


def current_skew_seconds():
    """Injected clock skew (seconds); 0.0 without an active injector.
    Consumed by utils/clock_sync.py, so skew scenarios flow through the
    real trace-merge alignment path."""
    inj = _INSTALLED
    return inj.skew_seconds() if inj is not None else 0.0


def install_coordinator_rules(coordinator, env=None):
    """Install a plan's ``side: "coord"`` request-perturbing events
    (http_error/delay_ms) into a launcher's coordinator
    (runner/http/http_server.py Coordinator) so the server itself
    rejects or stalls chosen procs' requests.  The service-targeting
    kinds (coord_kill/coord_restart) are the CoordFaultRunner's —
    they act on the RendezvousServer, not on requests.  Reads
    ``HOROVOD_FAULT_PLAN`` from ``env``; returns the number of rules
    installed (0 when no plan / no coordinator-side events)."""
    from .plan import plan_from_env
    plan = plan_from_env(env)
    if plan is None:
        return 0
    rules = [e for e in plan.coordinator_rules()
             if e.kind not in COORD_KINDS]
    for e in rules:
        coordinator.add_chaos_rule(
            e.kind, proc=e.proc, verb=e.verb, after=e.at,
            count=e.count, code=e.code, ms=e.ms, p=e.p,
            rng=plan.rng_for(e))
    if rules:
        logger.warning("chaos: %d coordinator-side fault rule(s) "
                       "installed", len(rules))
    return len(rules)


class CoordFaultRunner:
    """Launcher-side applier of ``coord_kill`` / ``coord_restart``
    fault events: the chaos tier's way to SIGKILL the control plane
    itself (docs/fault_tolerance.md "Coordinator crash survival").

    ``coord_kill`` stops the rendezvous HTTP service for good — from
    the workers' view the coordinator is gone; only the negotiation
    bypass keeps steps flowing.  ``coord_restart`` stops it, sleeps
    the event's ``ms``, then rebuilds store + coordinator purely from
    the journal (``RendezvousServer.restart_from_journal``: epoch
    bumped, liveness grace armed) on the same port.

    The deterministic evidence two same-seed runs compare byte for byte
    lives in :attr:`fired` (kind/event/trigger/n only); wall-clock
    outage bounds ride separate ``t_stop``/``t_start`` keys.  Both are
    appended as JSON lines to ``HOROVOD_FAULT_COORD_LOG`` when set."""

    def __init__(self, server, plan: FaultPlan, env=None):
        self.server = server
        self.plan = plan
        self.env = env
        self.events = [e for e in plan.coordinator_rules()
                       if e.kind in COORD_KINDS]
        self.fired = []
        self._log_path = (env or os.environ).get(
            "HOROVOD_FAULT_COORD_LOG")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []
        self._signal_rules = []     # (state, event) of request triggers

    def _install_signal_rule(self, e, sig):
        self.server.coordinator.add_chaos_rule(
            "signal", proc=e.proc, verb=e.verb, after=e.at,
            count=1, event=sig)

    def start(self):
        for e in self.events:
            st = _EventState(e, self.plan.rng_for(e))
            if e.trigger == "requests":
                sig = threading.Event()
                self._install_signal_rule(e, sig)
                self._signal_rules.append((st, sig))
                t = threading.Thread(target=self._await_signal,
                                     args=(st, sig),
                                     name="horovod_tpu_torch-chaos-coord",
                                     daemon=True)
            else:
                t = threading.Thread(target=self._await_wall,
                                     args=(st,),
                                     name="horovod_tpu_torch-chaos-coord",
                                     daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()

    def _await_signal(self, st, sig):
        while not self._stop.is_set():
            if sig.wait(timeout=0.2):
                if st.due(st.event.at):
                    self._fire(st.event, st.event.at)
                return

    def _await_wall(self, st):
        _wall_trigger_loop(st, self._stop, self._fire)

    def _fire(self, event: FaultEvent, n):
        # the deterministic projection (compared across same-seed
        # runs) carries no wall-clock fields: a wall trigger records
        # its SCHEDULED offset (the measured seconds jitter at ms
        # resolution and live in t_stop/t_start instead)
        rec = {"kind": event.kind, "event": event.index,
               "trigger": event.trigger,
               "n": event.at if event.trigger == "wall" else n}
        logger.warning("chaos: injecting %s (event #%d, %s=%s)",
                       event.kind, event.index, event.trigger, n)
        times = {"t_stop": time.time()}
        self.server.stop_http()
        if event.kind == "coord_restart":
            time.sleep(event.ms / 1000.0)
            self.server.restart_from_journal()
            times["t_start"] = time.time()
            coord = self.server.coordinator
            with coord._lock:
                coord._chaos_injected["coord_restart"] = \
                    coord._chaos_injected.get("coord_restart", 0) + 1
            # the rebuilt coordinator lost the plan's request-level
            # rules; re-install them (their counters restart — the
            # plan describes the whole job, docs/fault_tolerance.md),
            # INCLUDING the signal triggers of this runner's own
            # not-yet-fired events — they would otherwise wait forever
            # on a rule living only in the discarded coordinator
            install_coordinator_rules(coord, self.env)
            for st, sig in self._signal_rules:
                if not st.exhausted and not sig.is_set():
                    self._install_signal_rule(st.event, sig)
        with self._lock:
            self.fired.append(rec)
        if self._log_path:
            try:
                with open(self._log_path, "a") as f:
                    f.write(json.dumps({**rec, **times},
                                       sort_keys=True) + "\n")
            except OSError:
                pass


class AggFaultRunner:
    """Owner-process applier of ``agg_kill`` / ``agg_restart`` fault
    events against one host's AggregatorServer — the chaos tier's way
    to kill the MIDDLE tier (docs/fault_tolerance.md "Per-host
    aggregator tier").

    ``agg_kill`` stops the aggregator HTTP service for good: local
    workers see connection failures, fall back to direct coordinator
    mode within ``HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS``, and the
    coordinator's liveness holds their verdict as *suspect* until the
    direct beats land.  ``agg_restart`` stops it, sleeps the event's
    ``ms``, then starts a FRESH stateless core on the same port — the
    coordinator bumps that aggregator's agg_epoch and every worker is
    re-fenced into resync + drain + re-report.

    Triggers mirror the CoordFaultRunner: ``after_s`` (wall) or
    ``after`` (the n-th request the aggregator handles, polled off
    its request counter; the deterministic evidence records the
    SCHEDULED threshold, like the coordinator runner's wall records).
    Fired records (plus wall-clock ``t_stop``/``t_start`` bounds) are
    appended to ``HOROVOD_FAULT_AGG_LOG`` when set."""

    def __init__(self, server, plan: FaultPlan, agg_index: int,
                 env=None):
        self.server = server
        self.plan = plan
        self.agg_index = agg_index
        self.events = plan.aggregator_events(agg_index)
        self.fired = []
        self._log_path = (env or os.environ).get(
            "HOROVOD_FAULT_AGG_LOG")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = []

    def start(self):
        for e in self.events:
            st = _EventState(e, self.plan.rng_for(e))
            target = self._await_requests if e.trigger == "requests" \
                else self._await_wall
            t = threading.Thread(target=target, args=(st,),
                                 name="horovod_tpu_torch-chaos-agg",
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()

    def _await_requests(self, st):
        """Fire once the aggregator has handled the event's n-th
        request (polled off the core's counter — restarted cores
        restart the count, like the coordinator's re-installed
        rules)."""
        while not self._stop.wait(0.05):
            agg = self.server.aggregator
            if agg is None or agg.requests < st.event.at:
                continue
            if st.due(st.event.at):
                self._fire(st.event, st.event.at)
            return

    def _await_wall(self, st):
        _wall_trigger_loop(st, self._stop, self._fire)

    def _fire(self, event: FaultEvent, n):
        # deterministic projection (compared across same-seed runs):
        # scheduled thresholds only, wall bounds ride t_stop/t_start
        rec = {"kind": event.kind, "event": event.index,
               "trigger": event.trigger,
               "n": event.at, "agg": self.agg_index}
        logger.warning("chaos: injecting %s on aggregator %s "
                       "(event #%d, %s=%s)", event.kind,
                       self.agg_index, event.index, event.trigger, n)
        _count_injected(event.kind)
        times = {"t_stop": time.time()}
        self.server.stop_http()
        if event.kind == "agg_restart":
            time.sleep(event.ms / 1000.0)
            self.server.restart()
            times["t_start"] = time.time()
        with self._lock:
            self.fired.append(rec)
        if self._log_path:
            try:
                with open(self._log_path, "a") as f:
                    f.write(json.dumps({**rec, **times},
                                       sort_keys=True) + "\n")
            except OSError:
                pass


def start_aggregator_faults(server, agg_index, env=None):
    """Start the agg_kill/agg_restart runner for one host's
    aggregator server, when the fault plan targets it.  Returns the
    runner or None."""
    from .plan import plan_from_env
    plan = plan_from_env(env)
    if plan is None or not plan.aggregator_events(agg_index):
        return None
    runner = AggFaultRunner(server, plan, agg_index, env=env).start()
    logger.warning("chaos: %d aggregator service fault(s) armed on "
                   "aggregator %s", len(runner.events), agg_index)
    return runner


def start_coordinator_faults(server, env=None):
    """Start the coord_kill/coord_restart runner for a launcher's
    rendezvous service, when the fault plan has such events.  Returns
    the runner or None."""
    from .plan import plan_from_env
    plan = plan_from_env(env)
    if plan is None:
        return None
    if not any(e.kind in COORD_KINDS
               for e in plan.coordinator_rules()):
        return None
    runner = CoordFaultRunner(server, plan, env=env).start()
    logger.warning("chaos: %d coordinator service fault(s) armed",
                   len(runner.events))
    return runner


def _reset_for_tests():
    global _INSTALLED
    with _INSTALL_LOCK:
        _INSTALLED = None
