"""Per-host aggregator (port of ``horovod_tpu/runner/http/aggregator.py``):
the middle tier of the two-tier control plane.

One coordinator per job is the classic control-plane scaling wall
(arXiv:1802.05799); the pod-scale playbook assumes control traffic
scales with HOSTS, not chips (arXiv:1909.09756).  This tier restores
that property for every path the steady-state bypass does not cover —
warm-up, resize, stall attribution, and every bypass fallback: each
host runs ONE aggregator (the same host map
``common/topology.plan_decomposition`` reshapes reduction meshes by),
its local workers speak the unchanged coordinator wire protocol to it
over the existing KV fabric, and the aggregator batches their
ready-reports, heartbeats and polls into one upstream stream
(``agg_ready`` / ``agg_heartbeat`` / ``agg_poll``), so the coordinator
handles O(hosts) requests per negotiation cycle instead of O(procs).

Fault tolerance COMPOSES per tier instead of multiplying:

* the aggregator is **stateless-restartable** — it holds only a
  mirror of the coordinator's response log plus per-proc dedup
  high-waters, all reconstructible from the coordinator (whose
  journal survives ITS crashes).  A restarted aggregator re-registers
  through the ``agg_resync`` handshake; the coordinator bumps that
  aggregator's ``agg_epoch``, and workers — which fence every verb on
  the ``(coord_epoch, agg_epoch)`` pair — recover with the SAME
  resync → drain-the-replayed-log → re-report sequence they already
  run for a coordinator restart;
* an aggregator **death is a resync, not a job death** — workers
  whose aggregator stops answering fall back to DIRECT coordinator
  mode (``TieredStoreClient``), and the coordinator treats a silent
  aggregator's hosted ranks as *suspect* (one extra liveness window
  for the fallback probing) rather than dead;
* a **coordinator** restart behind a surviving aggregator bumps only
  ``coord_epoch``: the aggregator resyncs upstream without an
  agg_epoch bump, and its workers are fenced once, exactly as in the
  flat topology.

Enabled by ``horovodrun --control-plane-tier host``
(``HOROVOD_CONTROL_PLANE_TIER=host``): the lowest-indexed worker
process of each host starts the aggregator as a daemon thread and
publishes its address under ``/agg/<host>`` in the launcher's KV
store; its co-hosted processes discover it there.  Chaos kinds
``agg_kill`` / ``agg_restart`` (chaos/inject.py ``AggFaultRunner``)
drill both failure modes deterministically.  The JAX package's tier
telemetry: the ``horovod_agg_epoch`` gauge, and each upstream flush
observed into ``horovod_control_cycle_seconds{tier="agg"}``.
"""

import json
import logging
import threading
import time

from ... import telemetry
from . import http_server as http_server_mod
from .contract import EPOCH_EXEMPT_VERBS
from .http_client import StoreClient
from ...common import env as env_mod

logger = logging.getLogger("horovod_tpu_torch")

#: default time the flusher waits after the first queued report so
#: co-reporting local workers join the same upstream batch (the knob
#: trading one linger against one upstream request per proc)
DEFAULT_LINGER_MS = 2.0


def observe_control_cycle(tier, seconds):
    """One upstream flush's latency, into the process-current registry's
    ``horovod_control_cycle_seconds{tier}``."""
    telemetry.observe_control_cycle(tier, seconds)


class AggregatorUpstreamError(ConnectionError):
    """The aggregator could not complete a worker's request upstream
    (coordinator unreachable / flush failed).  Surfaced to the worker
    as HTTP 503 so its client retries — and, through the
    TieredStoreClient, falls back to direct coordinator mode."""


class _PendingReport:
    """One local ready-report waiting for the next upstream flush."""

    __slots__ = ("req", "event", "reply", "error")

    def __init__(self, req):
        self.req = req
        self.event = threading.Event()
        self.reply = None
        self.error = None


class Aggregator:
    """One host's aggregator core (transport-free; AggregatorServer
    wraps it in HTTP).  Local workers call :meth:`handle` with the
    unchanged coordinator verb vocabulary; upstream traffic is the
    batched ``agg_*`` stream."""

    def __init__(self, upstream: StoreClient, agg_id, host, procs,
                 round_id=0, poll_wait=5.0, linger_ms=None,
                 relay_secs=None):
        self.client = upstream
        self.agg_id = agg_id
        self.host = host
        self.procs = list(procs)
        self.round_id = round_id
        self.poll_wait = poll_wait
        if linger_ms is None:
            linger_ms = env_mod.get_float(
                env_mod.HOROVOD_AGG_LINGER_MS, DEFAULT_LINGER_MS)
        self._linger = max(linger_ms, 0.0) / 1000.0
        if relay_secs is None:
            # beats relayed at a quarter of the worker interval keep
            # each proc's upstream beat cadence safely inside the
            # coordinator's 1.5x-interval death window
            hb = env_mod.get_float(
                env_mod.HOROVOD_HEARTBEAT_INTERVAL_SECONDS, 5.0)
            relay_secs = max(0.2, hb / 4.0) if hb > 0 else 1.0
        self._relay_secs = relay_secs
        #: the (coord_epoch, agg_epoch) pair this tier fences with —
        #: learned from the upstream agg_resync handshake
        self.coord_epoch = None
        self.agg_epoch = None
        import secrets as _secrets
        self._sid = _secrets.token_hex(8)
        self._lock = threading.Condition()
        # mirror of the coordinator's response log at ABSOLUTE
        # indices: worker cursors stay valid across a direct fallback
        # (and back), because every tier serves the same cursor space
        self._log = []
        self._log_base = 0
        self._cursors = {}          # proc -> consumed cursor (acked up)
        self._gen = 0               # bumped on round/mirror resets
        # per-proc dedup (the same contract the coordinator enforces:
        # local retries of a landed report are answered, not re-sent)
        self._ready_seen = {}
        self._ready_reply = {}
        self._proc_sid = {}
        self._join_seen = {}        # proc -> forwarded jids
        self._bypass_votes = {}     # proc -> last forwarded fp
        self._beats = {}            # proc -> last local beat monotonic
        self._fresh_beats = {}      # proc -> payload since last relay
        self._dead = set()          # upstream-declared-dead procs
        self._batch = []            # pending _PendingReport
        #: local requests handled — the ``after`` trigger counter for
        #: agg_kill/agg_restart chaos events (chaos/inject.py)
        self.requests = 0
        self._stop = threading.Event()
        self._threads = []

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if not self._resync_upstream():
            raise AggregatorUpstreamError(
                f"aggregator {self.agg_id}: coordinator unreachable "
                f"at registration")
        for name, target in (("poll", self._poll_loop),
                             ("flush", self._flush_loop),
                             ("beat", self._relay_loop)):
            t = threading.Thread(target=target,
                                 name=f"hvd-agg-{name}", daemon=True)
            t.start()
            self._threads.append(t)
        logger.info("aggregator %s up: %d hosted procs, agg_epoch %s",
                    self.agg_id, len(self.procs), self.agg_epoch)
        return self

    def stop(self):
        self._stop.set()
        with self._lock:
            self._lock.notify_all()
        for p in self._drain_batch():
            p.error = AggregatorUpstreamError("aggregator stopping")
            p.event.set()

    def _drain_batch(self):
        with self._lock:
            batch, self._batch = self._batch, []
        return batch

    # -- upstream handshakes -------------------------------------------------

    def _resync_upstream(self):
        """(Re-)register this aggregator session upstream and adopt
        the epochs/round/cursor the coordinator answers with.  The
        tier-level twin of the worker resync handshake — and like it,
        exempt from the fences it exists to re-learn."""
        try:
            out = self.client.coord("agg_resync", {
                "agg": self.agg_id, "sid": self._sid,
                "host": self.host, "procs": self.procs})
        except Exception as exc:  # noqa: BLE001 — caller degrades
            logger.warning("aggregator %s: upstream resync failed: %s",
                           self.agg_id, exc)
            return False
        with self._lock:
            self.coord_epoch = out.get("epoch")
            self.agg_epoch = out.get("agg_epoch")
            rnd = out.get("round")
            if rnd is not None and rnd != self.round_id:
                self._clear_round_locked(rnd)
            if not self._log and self._log_base == 0:
                # fresh mirror: start at the coordinator's current log
                # end; anything older is served by cursor pass-through
                self._log_base = int(out.get("cursor", 0))
            self._lock.notify_all()
        telemetry.registry().gauge(
            telemetry.AGG_EPOCH_FAMILY, telemetry.AGG_EPOCH_HELP).set(
            self.agg_epoch or 0)
        return True

    def _clear_round_locked(self, new_round):
        """Elastic reset: drop the old round's mirror and per-proc
        state; local workers' stale-round requests are answered
        ``{"stale": ...}`` exactly as the coordinator would."""
        self.round_id = new_round
        self._gen += 1
        self._log = []
        self._log_base = 0
        self._cursors.clear()
        self._ready_seen.clear()
        self._ready_reply.clear()
        self._proc_sid.clear()
        self._join_seen.clear()
        self._bypass_votes.clear()
        self._dead.clear()
        self._lock.notify_all()

    def _adopt_round(self, new_round):
        if new_round is None:
            return
        with self._lock:
            if new_round == self.round_id:
                return
            self._clear_round_locked(new_round)
        self._resync_upstream()

    def _upstream_verb(self, verb, payload, timeout=None):
        """Low-rate pass-through (join / bypass_ready / worker resync
        forwarding): attach the upstream epoch, absorb ONE epoch bump
        with a tier resync + retry."""
        payload = dict(payload)
        payload["epoch"] = self.coord_epoch
        out = self.client.coord(verb, payload, timeout=timeout)
        if out.get("epoch_mismatch"):
            self._resync_upstream()
            payload["epoch"] = self.coord_epoch
            out = self.client.coord(verb, payload, timeout=timeout)
        if out.get("stale"):
            self._adopt_round(out.get("round"))
        return out

    # -- local verb surface --------------------------------------------------

    def handle(self, verb, req):
        """Dispatch one local worker request (the coordinator's verb
        vocabulary, unchanged).  Every verb is fenced on the
        ``(coord_epoch, agg_epoch)`` pair BEFORE it runs — a worker
        holding either stale generation is told to resync, exactly
        like the coordinator's own epoch fence — except the exempt
        recovery/ping verbs."""
        with self._lock:
            self.requests += 1
        if verb == "clock":
            # pass-through: the coordinator's wall clock is THE
            # reference clock; the NTP midpoint method absorbs the
            # extra (symmetric) hop latency
            return self.client.coord("clock", {})
        epoch = req.get("epoch")
        agg_epoch = req.get("agg_epoch")
        if ((epoch is not None and epoch != self.coord_epoch)
                or (agg_epoch is not None
                    and agg_epoch != self.agg_epoch)) \
                and verb not in EPOCH_EXEMPT_VERBS:
            return {"epoch_mismatch": True, "epoch": self.coord_epoch,
                    "agg_epoch": self.agg_epoch}
        if req.get("round", self.round_id) != self.round_id:
            return {"stale": True, "round": self.round_id}
        if verb == "ready":
            return self._on_ready(req)
        if verb == "poll":
            return self._on_poll(req)
        if verb == "heartbeat":
            return self._on_heartbeat(req)
        if verb == "resync":
            return self._on_resync(req)
        if verb == "join":
            return self._on_join(req)
        if verb == "bypass_ready":
            return self._on_bypass_ready(req)
        raise ValueError(f"unknown aggregator verb {verb}")

    def _check_session_locked(self, proc, sid):
        """A fresh worker session restarts its local dedup counters
        (the coordinator applies the authoritative wipe when the new
        sid reaches it inside the next batch)."""
        if sid is None or self._proc_sid.get(proc) == sid:
            return
        self._proc_sid[proc] = sid
        self._ready_seen.pop(proc, None)
        self._ready_reply.pop(proc, None)
        self._join_seen.pop(proc, None)

    def _on_ready(self, req):
        """Queue one worker's ready report for the next batched
        upstream flush and block until that flush answers.  Local
        retries dedup on the per-proc rid high-water exactly like the
        coordinator's own handler, so a timed-out POST to THIS tier is
        replay-safe too."""
        proc = req.get("proc")
        rid = req.get("rid")
        with self._lock:
            self._check_session_locked(proc, req.get("sid"))
            if rid is not None:
                last = self._ready_seen.get(proc, 0)
                if rid == last:
                    return self._ready_reply.get(proc, {})
                if rid < last:
                    return {}
            pend = _PendingReport({
                "proc": proc, "rid": rid, "sid": req.get("sid"),
                "nlocal": req.get("nlocal"),
                "entries": req.get("entries", [])})
            self._batch.append(pend)
            self._lock.notify_all()
        # wait OUTSIDE the lock: the flusher needs it, and a parked
        # handler must never stall its co-reporters
        budget = self.client.retry_deadline + self._linger + 10.0
        if not pend.event.wait(budget) or pend.error is not None:
            # NOTHING committed: a failed/timed-out flush leaves the
            # rid high-water untouched, so the worker's 5xx retry
            # re-queues the report instead of being answered with a
            # stale cached reply (the upstream's own rid dedup keeps
            # a did-actually-land first flush single-apply)
            raise AggregatorUpstreamError(
                f"aggregator {self.agg_id}: upstream flush failed "
                f"({pend.error})")
        with self._lock:
            if rid is not None and \
                    rid > self._ready_seen.get(proc, 0):
                # dedup state commits ONLY once the flush answered —
                # the same only-idempotent-once-landed contract the
                # coordinator's _apply_ready_locked enforces
                self._ready_seen[proc] = rid
                self._ready_reply[proc] = pend.reply
        return pend.reply

    def _on_poll(self, req):
        """Serve the response-log mirror (absolute cursors).  A cursor
        below the mirror base — a worker older than this aggregator
        instance, draining what a restarted tier never fetched — is
        passed through to the coordinator verbatim, whose journaled
        log and session fencing remain the one source of truth."""
        proc = req.get("proc")
        cursor = req["cursor"]
        wait = req.get("wait", 10.0)
        round_at_entry = req.get("round", self.round_id)
        with self._lock:
            if proc is not None:
                self._cursors[proc] = max(
                    self._cursors.get(proc, 0), cursor)
            passthrough = cursor < self._log_base
        if passthrough:
            out = self._upstream_verb(
                "poll", {"proc": proc, "cursor": cursor, "wait": wait,
                         "round": round_at_entry},
                timeout=wait + 30)
            out.setdefault("agg_epoch", self.agg_epoch)
            return out
        deadline = time.monotonic() + wait
        with self._lock:
            while self._log_base + len(self._log) <= cursor:
                if self.round_id != round_at_entry:
                    return {"stale": True, "round": self.round_id}
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._stop.is_set():
                    return {"responses": [], "cursor": cursor,
                            "epoch": self.coord_epoch,
                            "agg_epoch": self.agg_epoch}
                self._lock.wait(remaining)
            if self.round_id != round_at_entry:
                return {"stale": True, "round": self.round_id}
            return {"responses": self._log[cursor - self._log_base:],
                    "cursor": self._log_base + len(self._log),
                    "epoch": self.coord_epoch,
                    "agg_epoch": self.agg_epoch}

    def _on_heartbeat(self, req):
        """Record a local beat for the next batched relay.  ``bye``
        forwards immediately (teardown must not wait a relay tick);
        a proc the coordinator declared dead learns it here from the
        cached relay verdict."""
        proc = req.get("proc")
        if proc is None:
            return {}
        if req.get("bye"):
            with self._lock:
                self._beats.pop(proc, None)
                self._fresh_beats.pop(proc, None)
            try:
                self.client.coord("agg_heartbeat", {
                    "agg": self.agg_id, "host": self.host,
                    "epoch": self.coord_epoch,
                    "beats": [{"proc": proc, "bye": True}]},
                    budget=(2, 3.0))
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
            return {}
        with self._lock:
            if proc in self._dead:
                return {"dead": True}
            self._beats[proc] = time.monotonic()
            self._fresh_beats[proc] = {
                k: req[k] for k in ("proc", "ranks", "host")
                if req.get(k) is not None}
        return {}

    def _on_resync(self, req):
        """Worker resync through the tier: forwarded upstream (the
        coordinator's session registry and journal stay authoritative
        — the drain cursor it answers covers records this mirror has
        not fetched yet), stamped with this aggregator's id so
        liveness knows the route, and augmented with the agg_epoch the
        worker will fence with from now on."""
        proc = req.get("proc")
        out = self.client.coord("resync", {
            "proc": proc, "sid": req.get("sid"),
            "round": self.round_id, "via_agg": self.agg_id})
        if out.get("stale"):
            self._adopt_round(out.get("round"))
            return out
        with self._lock:
            self._check_session_locked(proc, req.get("sid"))
            self.coord_epoch = out.get("epoch", self.coord_epoch)
        out = dict(out)
        out["agg_epoch"] = self.agg_epoch
        return out

    def _on_join(self, req):
        """Low-rate pass-through with local jid dedup: a jid is
        recorded only after the upstream accepted it, so a failed
        forward is retried, while a local retry of a landed join is
        answered without re-sending."""
        proc = req.get("proc")
        jid = req.get("jid")
        with self._lock:
            self._check_session_locked(proc, req.get("sid"))
            if jid is not None and \
                    jid in self._join_seen.get(proc, ()):
                return {}
        out = self._upstream_verb("join", {
            k: req[k] for k in ("ps", "rank", "ps_size", "proc",
                                "proc_members", "jid", "sid")
            if k in req})
        if jid is not None and not out.get("stale") \
                and not out.get("epoch_mismatch"):
            with self._lock:
                self._join_seen.setdefault(proc, set()).add(jid)
        return out

    def _on_bypass_ready(self, req):
        """Vote pass-through (idempotent per (proc, fp) upstream);
        the local slot only mirrors the last forwarded vote."""
        proc = req.get("proc")
        with self._lock:
            self._bypass_votes[proc] = req.get("fp")
        return self._upstream_verb("bypass_ready", {
            k: req[k] for k in ("proc", "sid", "fp") if k in req},
            timeout=5.0)

    # -- background loops ----------------------------------------------------

    def _poll_loop(self):
        """ONE upstream long-poll per host mirrors the response log
        for every local worker — the read-side fan-in.  Carries the
        hosted workers' consumed cursors (``acked``) so coordinator
        log GC keeps its every-proc guarantee with zero direct
        polls."""
        while not self._stop.is_set():
            with self._lock:
                cursor = self._log_base + len(self._log)
                acked = {str(p): c for p, c in self._cursors.items()}
                gen = self._gen
            try:
                out = self.client.coord("agg_poll", {
                    "agg": self.agg_id, "cursor": cursor,
                    "acked": acked, "wait": self.poll_wait,
                    "round": self.round_id,
                    "epoch": self.coord_epoch},
                    timeout=self.poll_wait + 30)
            except Exception:  # noqa: BLE001 — outage: the client
                # already retried with backoff; park briefly and try
                # again (workers fall back direct in the meantime)
                self._stop.wait(0.5)
                continue
            if out.get("stale"):
                self._adopt_round(out.get("round"))
                continue
            if out.get("epoch_mismatch"):
                self._resync_upstream()
                continue
            with self._lock:
                if self._gen != gen:
                    continue    # a reset raced this reply: drop it
                self.coord_epoch = out.get("epoch", self.coord_epoch)
                responses = out.get("responses", [])
                if responses:
                    self._log.extend(responses)
                self._lock.notify_all()

    def _flush_loop(self):
        """The write-side fan-in: every local ready report queued
        within one linger window rides ONE ``agg_ready`` upstream.
        An epoch bump mid-flush is NEVER blindly replayed — the
        waiting workers get the mismatch reply and recover with
        resync + drain + re-report, the same rule their own clients
        follow (docs/fault_tolerance.md)."""
        procs_set = set(self.procs)
        while not self._stop.is_set():
            with self._lock:
                while not self._batch and not self._stop.is_set():
                    self._lock.wait(0.25)
                if self._stop.is_set():
                    break
                # linger for co-reporters — but FULL local coverage
                # (every hosted proc queued a report) releases early:
                # the common all-procs-report cycle pays no linger at
                # all, while a partial batch waits out the window for
                # stragglers before going upstream
                deadline = time.monotonic() + self._linger
                while not self._stop.is_set():
                    if {p.req.get("proc")
                            for p in self._batch} >= procs_set:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(min(remaining, 0.05))
                batch, self._batch = self._batch, []
                epoch = self.coord_epoch
            if not batch:
                continue
            t0 = time.monotonic()
            try:
                out = self.client.coord("agg_ready", {
                    "agg": self.agg_id, "epoch": epoch,
                    "round": self.round_id,
                    "reports": [p.req for p in batch]})
            except Exception as exc:  # noqa: BLE001 — reported to the
                # parked handlers, which surface 503 to their workers
                for p in batch:
                    p.error = exc
                    p.event.set()
                continue
            try:
                observe_control_cycle("agg", time.monotonic() - t0)
            except Exception:  # noqa: BLE001 — accounting only
                pass
            if out.get("stale"):
                for p in batch:
                    p.reply = out
                    p.event.set()
                self._adopt_round(out.get("round"))
            elif out.get("epoch_mismatch"):
                self._resync_upstream()
                reply = {"epoch_mismatch": True,
                         "epoch": self.coord_epoch,
                         "agg_epoch": self.agg_epoch}
                for p in batch:
                    p.reply = reply
                    p.event.set()
            else:
                replies = out.get("replies", {})
                for p in batch:
                    p.reply = replies.get(str(p.req.get("proc")), {})
                    p.event.set()

    def _relay_loop(self):
        """Batched liveness relay: every proc that beat locally since
        the last tick rides ONE ``agg_heartbeat`` upstream.  Procs
        the coordinator declares dead are remembered so their next
        local beat is answered ``{"dead": true}``."""
        while not self._stop.wait(self._relay_secs):
            with self._lock:
                beats, self._fresh_beats = self._fresh_beats, {}
            if not beats:
                continue
            try:
                out = self.client.coord("agg_heartbeat", {
                    "agg": self.agg_id, "host": self.host,
                    "epoch": self.coord_epoch,
                    "beats": list(beats.values())}, timeout=5.0)
            except Exception:  # noqa: BLE001 — retried next tick with
                # the beats re-merged (newer local beats win)
                with self._lock:
                    for p, b in beats.items():
                        self._fresh_beats.setdefault(p, b)
                continue
            if out.get("epoch_mismatch"):
                self._resync_upstream()
                with self._lock:
                    for p, b in beats.items():
                        self._fresh_beats.setdefault(p, b)
                continue
            if out.get("dead"):
                with self._lock:
                    self._dead.update(out["dead"])


# -- HTTP transport ------------------------------------------------------------

OK = http_server_mod.OK
BAD_REQUEST = http_server_mod.BAD_REQUEST
FORBIDDEN = http_server_mod.FORBIDDEN
NOT_FOUND = http_server_mod.NOT_FOUND
UNAVAILABLE = 503


class _AggHandler(http_server_mod._Handler):
    """The worker-facing wire surface: same HMAC envelope and verb
    paths as the coordinator handler (workers cannot tell the tiers
    apart), with KV traffic proxied upstream verbatim — the
    aggregator caches nothing it cannot reconstruct."""

    @property
    def agg(self):
        return self.server.aggregator

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            return self._reply(FORBIDDEN)
        try:
            self.agg.client.put(self.path, body)
        except Exception:  # noqa: BLE001 — upstream outage
            return self._reply(UNAVAILABLE, b"agg: upstream put failed")
        self._reply(OK)

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if not self._verify(b""):
            return self._reply(FORBIDDEN)
        params = dict(p.split("=", 1) for p in query.split("&")
                      if "=" in p)
        try:
            wait = float(params.get("wait", 0))
        except ValueError:
            wait = 0.0
        try:
            value = self.agg.client.get(path, wait=wait)
        except Exception:  # noqa: BLE001 — upstream outage
            return self._reply(UNAVAILABLE, b"agg: upstream get failed")
        if value is None:
            return self._reply(NOT_FOUND)
        self._reply(OK, value)

    def do_DELETE(self):
        if not self._verify(b""):
            return self._reply(FORBIDDEN)
        try:
            self.agg.client.delete(self.path)
        except Exception:  # noqa: BLE001 — upstream outage
            return self._reply(UNAVAILABLE,
                               b"agg: upstream delete failed")
        self._reply(OK)

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            return self._reply(FORBIDDEN)
        if not self.path.startswith("/coord/"):
            return self._reply(BAD_REQUEST)
        verb = self.path[len("/coord/"):]
        try:
            req = json.loads(body) if body else {}
            resp = self.agg.handle(verb, req)
        except AggregatorUpstreamError as exc:
            # 503, not 400: the worker's client retries 5xx under its
            # tight budget, then the TieredStoreClient falls back to
            # direct coordinator mode — degradation, never deadlock
            return self._reply(UNAVAILABLE, str(exc).encode())
        except Exception as exc:  # noqa: BLE001 — reported to caller
            return self._reply(BAD_REQUEST,
                               json.dumps({"error": str(exc)}).encode(),
                               "application/json")
        self._reply(OK, json.dumps(resp).encode(), "application/json")


class AggregatorServer:
    """HTTP wrapper around one Aggregator core.  ``restart()`` builds
    a FRESH core on the SAME port — the stateless-restart drill chaos
    ``agg_restart`` runs: the new core's new session id makes the
    coordinator bump ``agg_epoch``, which re-fences every worker."""

    def __init__(self, secret, make_core):
        self.secret = secret
        self._make_core = make_core
        self.aggregator = None
        self._httpd = None
        self._thread = None
        self._bound_port = None

    def start(self, port=0) -> int:
        if port == 0 and self._bound_port:
            # a restarted aggregator must come back on the SAME port —
            # workers discovered the address once, via the KV record
            port = self._bound_port
        self.aggregator = self._make_core()
        self.aggregator.start()
        self._httpd = http_server_mod._ThreadingHTTPServer(
            ("0.0.0.0", port), _AggHandler)
        self._httpd.aggregator = self.aggregator
        self._httpd.secret = self.secret
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="hvd-aggregator",
            daemon=True)
        self._thread.start()
        self._bound_port = self._httpd.server_address[1]
        return self._bound_port

    @property
    def port(self):
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._bound_port

    def stop_http(self):
        """Tear the service down (chaos ``agg_kill``): local workers
        see connection failures and fall back to direct coordinator
        mode; the coordinator's liveness marks the hosted ranks
        suspect until their direct beats land."""
        if self.aggregator is not None:
            self.aggregator.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            # sever live keep-alives: a handler thread parked on an
            # old connection would keep serving the dead core
            self._httpd.close_all_connections()
            self._httpd = None

    def restart(self) -> int:
        """Stateless restart (chaos ``agg_restart``): fresh core, same
        port, nothing carried over — everything the tier needs comes
        back from the coordinator through agg_resync."""
        self.stop_http()
        return self.start()

    def stop(self):
        self.stop_http()


# -- per-process bootstrap -----------------------------------------------------
#
# The lowest-indexed worker process of each host owns that host's
# aggregator (one per host — the same ownership rule the reference's
# hierarchical collectives use for the local root); co-hosted
# processes discover its address through the launcher's KV store.

_PROCESS_AGG = None
_PROCESS_AGG_FAULTS = None
_AGG_LOCK = threading.Lock()

AGG_KV_PREFIX = "/agg/"


def tier_enabled(env=None):
    """Whether the per-host aggregator tier is requested
    (``HOROVOD_CONTROL_PLANE_TIER=host``; ``flat``/unset = the
    single-coordinator topology)."""
    val = (env_mod.get_str(env_mod.HOROVOD_CONTROL_PLANE_TIER)
           if env is None else
           env.get(env_mod.HOROVOD_CONTROL_PLANE_TIER))
    return str(val or "").strip().lower() in ("host", "2", "two")


def ensure_host_aggregator(rdv_addr, rdv_port, secret, proc_id,
                           host_of_proc, round_id=0,
                           start_timeout=60.0):
    """Start (owner) or discover (co-hosted) this host's aggregator.
    Returns ``(addr, port, agg_id)``.  Idempotent per process: an
    elastic re-init reuses the running aggregator — a new round flows
    through its stale-round adoption, not through a re-spawn."""
    global _PROCESS_AGG, _PROCESS_AGG_FAULTS
    host = host_of_proc[proc_id]
    procs = [p for p, h in enumerate(host_of_proc) if h == host]
    agg_id = f"host{host}"
    key = AGG_KV_PREFIX + agg_id
    direct = StoreClient(rdv_addr, rdv_port, secret)
    if proc_id == min(procs):
        with _AGG_LOCK:
            if _PROCESS_AGG is None:
                hostname = env_mod.get_str(env_mod.HOROVOD_HOSTNAME) \
                    or agg_id

                def make_core():
                    return Aggregator(
                        StoreClient(rdv_addr, rdv_port, secret),
                        agg_id=agg_id, host=hostname, procs=procs,
                        round_id=round_id)

                server = AggregatorServer(secret, make_core)
                port = server.start()
                addr = "127.0.0.1" \
                    if rdv_addr in ("127.0.0.1", "localhost") \
                    else http_server_mod.local_ip()
                direct.put(key, json.dumps(
                    {"addr": addr, "port": port}).encode())
                _PROCESS_AGG = server
                if env_mod.get_str(env_mod.HOROVOD_FAULT_PLAN):
                    from ...chaos.inject import start_aggregator_faults
                    _PROCESS_AGG_FAULTS = start_aggregator_faults(
                        server, agg_index=host)
        raw = direct.get(key, wait=start_timeout)
    else:
        raw = direct.get(key, wait=start_timeout)
    if raw is None:
        raise RuntimeError(
            f"aggregator address for {agg_id} never appeared at "
            f"{key} (owner proc {min(procs)} failed to start it?)")
    info = json.loads(raw)
    return info["addr"], int(info["port"]), agg_id


def stop_process_aggregator():
    """Engine-shutdown hook: stop this process's aggregator (if it
    owns one).  Co-hosted workers still running fall back to direct
    coordinator mode — the same degradation an agg_kill drills."""
    global _PROCESS_AGG, _PROCESS_AGG_FAULTS
    with _AGG_LOCK:
        server, _PROCESS_AGG = _PROCESS_AGG, None
        faults, _PROCESS_AGG_FAULTS = _PROCESS_AGG_FAULTS, None
    if faults is not None:
        faults.stop()
    if server is not None:
        server.stop()
