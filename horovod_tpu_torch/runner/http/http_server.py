"""HTTP KV store + rendezvous + coordinator service (port of
``horovod_tpu/runner/http/http_server.py``; reference
``horovod/runner/http/http_server.py`` KVStoreServer :35,
RendezvousServer :192).

The launcher hosts it.  Besides the KV store workers rendezvous against,
it hosts the **coordinator** the reference runs on rank 0's background
thread (``controller.cc:74-474``): worker processes POST locally-ready
tensor lists; the coordinator counts readiness across processes,
validates cross-process consistency, fuses ready allreduces under the
fusion threshold and appends fused responses to an ordered log every
worker polls.  The order of the log is the collective schedule: every
process issues the same collectives in the same order, as one
``torch.distributed`` process group needs.

Requests are HMAC-signed with the job secret (reference
runner/common/util/network.py:56).

The steady-state negotiation bypass's coordinator side is here: the
``bypass_ready`` vote, the ``bypass_arm`` record once every process
voted one fingerprint, and the disarm when a worker reports entries or
joins again (core/bypass.py).

Elastic rounds are here too: the driver's ``reset(world_size,
round_id)`` starts a round with fresh negotiation state, and a request
stamped with an earlier round gets ``{"stale": true}``, which fails the
worker's pending collectives (core/store_controller.py).

Crash survival: the coordinator journals its state-changing
transitions (journal.py); ``RendezvousServer.restart_from_journal``
rebuilds store and coordinator from the journal alone on the same port,
bumps the monotonic ``coord_epoch`` and opens a liveness grace window.
Every verb but the exempt ones (contract.py ``EPOCH_EXEMPT_VERBS``) is
fenced on the epoch before it runs; a fenced worker re-registers once
through ``resync``, drains the replayed log and re-reports what is still
awaiting (core/store_controller.py).  The per-host aggregator tier
(aggregator.py) speaks the ``agg_*`` verbs here, each aggregator with a
monotonic ``agg_epoch``.  Coordinator-side chaos rules (``http_error``,
``delay_ms`` and the service fault runner's ``signal``) are checked by
the handler before a verb runs (chaos/inject.py).

Not ported (ROADMAP.md): the ``/metrics``, ``/timeline`` and
``/trace/dump`` endpoints with the coordinator's telemetry families
(A17's telemetry and utils items); the coordinator-side autotuner (A14).
"""

import hashlib
import hmac
import json
import logging
import os
import socket
import socketserver
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler

from . import journal as journal_mod
from .contract import CACHEABLE_TYPES, EPOCH_EXEMPT_VERBS

logger = logging.getLogger("horovod_tpu_torch")

OK = 200
BAD_REQUEST = 400
FORBIDDEN = 403
NOT_FOUND = 404


def coordinator_kwargs(env=None):
    """RendezvousServer coordinator settings from a ``HOROVOD_*`` env
    mapping (default: os.environ): the response-cache capacity, the
    stall-inspector warning time (so the coordinator's global stall
    attribution fires on the workers' clock), the heartbeat interval
    and window, and the journal path.  ``HOROVOD_AUTOTUNE`` is refused
    (ROADMAP.md A14)."""
    env = os.environ if env is None else env

    def on(name):
        return str(env.get(name, "")).strip().lower() \
            in ("1", "true", "yes", "on")

    if on("HOROVOD_AUTOTUNE"):
        raise NotImplementedError(
            "HOROVOD_AUTOTUNE: the autotuner is not ported yet "
            "(ROADMAP.md A14)")
    kwargs = {}
    cap = env.get("HOROVOD_CACHE_CAPACITY")
    if cap is not None and str(cap).strip() != "":
        # 0 = response cache disabled (--disable-cache)
        kwargs["cache_capacity"] = int(cap)
    if on("HOROVOD_STALL_CHECK_DISABLE"):
        kwargs["stall_warning_secs"] = 0.0
    else:
        try:
            kwargs["stall_warning_secs"] = float(
                env.get("HOROVOD_STALL_CHECK_TIME_SECONDS") or 60.0)
        except ValueError:
            kwargs["stall_warning_secs"] = 60.0
    # the coordinator declares a proc dead once its heartbeats stop for
    # the window (default 1.5x the interval); interval 0 disables
    try:
        kwargs["heartbeat_secs"] = float(
            env.get("HOROVOD_HEARTBEAT_INTERVAL_SECONDS") or 5.0)
    except ValueError:
        kwargs["heartbeat_secs"] = 5.0
    try:
        kwargs["heartbeat_window"] = float(
            env.get("HOROVOD_HEARTBEAT_WINDOW_SECONDS") or 0.0)
    except ValueError:
        kwargs["heartbeat_window"] = 0.0
    # coordinator crash survival: journal control-plane transitions to
    # this path so a restarted rendezvous service replays them
    # (epoch-fenced).  REPLAY=1 opts a FRESH server into replaying an
    # existing file (a restarted launcher); by default a new job
    # truncates a stale journal on its path.
    if env.get("HOROVOD_COORD_JOURNAL"):
        kwargs["journal_path"] = env["HOROVOD_COORD_JOURNAL"]
        kwargs["journal_replay"] = on("HOROVOD_COORD_JOURNAL_REPLAY")
    return kwargs


def _digest(secret: bytes, payload: bytes) -> str:
    return hmac.new(secret, payload, hashlib.sha256).hexdigest()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence
        pass

    @property
    def store(self):
        return self.server.store

    def _verify(self, body: bytes) -> bool:
        secret = self.server.secret
        if secret is None:
            return True
        given = self.headers.get("X-HVD-Auth", "")
        return hmac.compare_digest(given, _digest(secret, body))

    def _reply(self, code, payload=b"", content_type="application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("Content-Type", content_type)
        self.end_headers()
        if payload:
            self.wfile.write(payload)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            return self._reply(FORBIDDEN)
        self.store.put(self.path, body)
        self._reply(OK)

    def do_GET(self):
        path, _, query = self.path.partition("?")
        if not self._verify(b""):
            return self._reply(FORBIDDEN)
        params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
        wait = float(params.get("wait", 0))
        value = self.store.get(path, timeout=wait)
        if value is None:
            return self._reply(NOT_FOUND)
        self._reply(OK, value)

    def do_DELETE(self):
        if not self._verify(b""):
            return self._reply(FORBIDDEN)
        self.store.delete(self.path)
        self._reply(OK)

    def do_POST(self):
        """Coordinator RPCs: /coord/<verb>, JSON body."""
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        if not self._verify(body):
            return self._reply(FORBIDDEN)
        if not self.path.startswith("/coord/"):
            return self._reply(BAD_REQUEST)
        verb = self.path[len("/coord/"):]
        try:
            req = json.loads(body) if body else {}
            # coordinator-side fault injection (fault-plan events with
            # side="coord"): reject or stall this request before the
            # verb runs — the client's backoff is what must recover
            act = self.server.coordinator.chaos_check(verb, req)
            if act is not None and act[0] == "error":
                return self._reply(
                    act[1], b"chaos: injected coordinator error")
            if act is not None and act[0] == "stall":
                time.sleep(act[1] / 1000.0)
            resp = self.server.coordinator.handle(verb, req)
        except Exception as exc:  # noqa: BLE001 — reported to caller
            return self._reply(BAD_REQUEST,
                               json.dumps({"error": str(exc)}).encode(),
                               "application/json")
        self._reply(OK, json.dumps(resp).encode(), "application/json")


class KVStore:
    """Blocking-get key/value store (reference KVStoreHandler).

    With a coordinator journal attached (``journal`` attribute, set by
    RendezvousServer AFTER any replay so restored entries are not
    re-journaled), every small write is recorded so a restarted
    service resurrects the KV state — elastic round assignments, user
    scopes — under the journal's size cap.  The bulky ephemeral
    namespaces (telemetry pushes, trace buffers) are excluded."""

    def __init__(self):
        self._data = {}
        self._cv = threading.Condition()
        self.journal = None

    def _journal_write(self, key, value):
        j = self.journal
        if j is None or key.startswith(journal_mod.KV_EXCLUDE_PREFIXES):
            return
        if value is not None and len(value) > j.kv_max_bytes:
            logger.debug("journal: skipping oversized KV value %s "
                         "(%d bytes)", key, len(value))
            return
        if value is None:
            j.append({"k": "kvdel", "key": key})
        else:
            j.append({"k": "kv", "key": key,
                      "v": journal_mod._b64(value)})

    def put(self, key, value: bytes):
        with self._cv:
            self._data[key] = value
            self._journal_write(key, value)
            self._cv.notify_all()

    def get(self, key, timeout=0.0):
        deadline = None
        with self._cv:
            while True:
                if key in self._data:
                    return self._data[key]
                if timeout <= 0:
                    return None
                import time
                if deadline is None:
                    deadline = time.monotonic() + timeout
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def delete(self, key):
        with self._cv:
            self._data.pop(key, None)
            self._journal_write(key, None)
            self._cv.notify_all()

    def restore(self, key, value: bytes):
        """Journal replay: restore an entry without re-journaling."""
        with self._cv:
            if value is None:
                self._data.pop(key, None)
            else:
                self._data[key] = value
            self._cv.notify_all()

    def scope(self, prefix):
        with self._cv:
            return {k: v for k, v in self._data.items()
                    if k.startswith(prefix)}


class Coordinator:
    """Server-side negotiation engine (the reference's rank-0
    coordinator, controller.cc ComputeResponseList/FuseResponses,
    relocated into the launcher's store service — same protocol, one
    fewer hop).

    Response cache (reference response_cache.{h,cc}): batch responses
    assign each tensor a cache id workers learn from the response; on
    repeat iterations a worker reports ``{"key", "c": id}`` instead of
    the full negotiation meta, and entries whose reports all carry the
    same id skip cross-process validation — the steady-state fast path
    that replaces the reference's two-bitvector CoordinateCacheAndState
    sync.  The LRU is capacity-bounded; reports naming an evicted id
    get the key back in ``uncached`` and resend the full meta."""

    def __init__(self, world_size: int,
                 fusion_threshold_bytes: int = 128 * 1024 * 1024,
                 cache_capacity: int = 1024, autotune: bool = False,
                 stall_warning_secs: float = 60.0,
                 heartbeat_secs: float = 5.0,
                 heartbeat_window: float = 0.0,
                 journal=None):
        if autotune:
            raise NotImplementedError(
                "the coordinator-side autotuner is not ported yet "
                "(ROADMAP.md A14)")
        self.world_size = world_size
        self.fusion_threshold = fusion_threshold_bytes
        self.cache_capacity = cache_capacity
        self.round_id = 0
        # crash-survival state (docs/fault_tolerance.md "Coordinator
        # crash survival"): coord_epoch is a monotonic generation id
        # bumped on every journal replay; StoreClients carry it on
        # every verb and a mismatch triggers ONE resync handshake
        # instead of blind replay.  The journal records state-changing
        # transitions so restore_journal can rebuild this object.
        self.coord_epoch = 1
        self._journal = journal
        self._replaying = False
        self._store = None              # attach_store (KV for snapshots)
        self._journal_replayed = {}     # record kind -> replay count
        # post-restart liveness grace: beats are only EXPECTED after a
        # proc's first post-restart beat, and no death is declared
        # before this instant — beats missed during the outage must
        # not read as deaths
        self._grace_until = 0.0
        # steady-state negotiation bypass (core/bypass.py): per-proc
        # cycle-fingerprint votes; when every proc votes the same
        # fingerprint a ``bypass_arm`` record rides the response log —
        # the coordinated instant all workers switch to the
        # coordinator-free fast path
        self._bypass_votes = {}
        self._bypass_armed_fp = None
        # coordinator-side stall inspector (reference
        # stall_inspector.cc relocated with the coordinator): an entry
        # pending past this age gets a ``stall`` response naming the
        # GLOBAL ranks of the processes that never reported it.
        # 0 disables (HOROVOD_STALL_CHECK_DISABLE).
        self.stall_warning_secs = stall_warning_secs
        # worker liveness (docs/fault_tolerance.md): workers beat via
        # the ``heartbeat`` verb; a proc whose beats stop for the
        # window (default 1.5x the interval) is declared dead — its
        # pending negotiations fail IMMEDIATELY with an error naming
        # the global ranks it hosts, instead of stall-timeout limbo.
        # A proc is only expected to beat after its FIRST beat, so
        # slow starters are never false-positived.  0 disables.
        self.heartbeat_secs = heartbeat_secs
        self.heartbeat_window = heartbeat_window
        # suspect grace for aggregator-routed procs: when a proc's
        # beats rode a now-silent aggregator, death is withheld for
        # the time its direct-fallback probing needs — the worker's
        # tight aggregator retry budget (the SAME env knob the
        # workers read: launcher and workers share the handoff) plus
        # one beat interval for the first direct beat to land
        from ...common import env as _env_mod
        self._agg_probe_grace = _env_mod.get_float(
            _env_mod.HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS, 5.0) \
            + max(heartbeat_secs, 0.0)
        self._lock = threading.Condition()
        # key -> {proc_id -> meta}
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        # Ordered response log.  Client cursors are absolute; entries
        # every process has polled past are garbage-collected and
        # _log_base keeps absolute cursors valid (without this the log
        # grows with every collective for the lifetime of the round —
        # millions of dicts over a long job).
        self._log = []
        self._log_base = 0
        self._cursors = {}      # proc_id -> highest absolute cursor seen
        self._joined = {}       # ps_id -> set of (proc, rank) joined
        self._proc_joined = {}  # ps_id -> {proc -> join count}
        self._exhausted = {}    # ps_id -> set of procs fully joined
        self._join_seen = {}    # (ps, proc) -> set of seen join ids
        self._ready_seen = {}   # proc -> highest seen ready-report id
        self._ready_reply = {}  # proc -> response of that ready report
        self._proc_sid = {}     # proc -> controller session id
        self._session_base = {}  # proc -> log index its session starts at
        self._errors = {}       # key -> error string
        self._pending_since = {}     # key -> first-report monotonic
        self._stall_warned_keys = set()  # once-per-stall dedup
        self._cache = OrderedDict()  # cache_id -> meta template (LRU)
        self._cache_by_key = {}      # key -> cache_id
        self._next_cache_id = 0
        # job-unique trace ids, one per scheduled negotiation entry:
        # batch responses carry them so every rank's flow events for
        # one collective chain on the same id (docs/timeline.md)
        self._next_trace_id = 0
        # flight-recorder dump requests appended to the response log
        # (stall auto-dumps, POST /trace/dump, GET /timeline)
        self._next_dump_id = 0
        # liveness state: proc -> last beat monotonic / hosted global
        # ranks / hostname; _dead holds declared-dead procs until the
        # next round reset (the elastic driver reads it to blacklist)
        self._beats = {}
        self._proc_ranks = {}
        self._proc_hosts = {}
        self._dead = {}
        # per-host aggregator tier (docs/fault_tolerance.md "Per-host
        # aggregator tier"): each host's aggregator registers a
        # session (agg_resync) and batches its workers' verbs into
        # agg_ready / agg_heartbeat / agg_poll.  _agg_epoch[agg] is
        # the tier's OWN generation id — bumped on every NEW session
        # of the same aggregator id, so a restarted (stateless)
        # aggregator fences its workers exactly like a restarted
        # coordinator fences everyone.  _proc_via_agg records each
        # proc's last-known beat route: a silent aggregator makes its
        # hosted procs SUSPECT, not dead — they get one extra liveness
        # window to fall back to direct beats before any verdict.
        self._agg_sid = {}      # agg -> session id
        self._agg_epoch = {}    # agg -> generation (monotonic per agg)
        self._agg_procs = {}    # agg -> hosted proc ids
        self._agg_hosts = {}    # agg -> hostname
        self._agg_beats = {}    # agg -> last upstream-contact monotonic
        self._agg_warned = set()  # once-per-silence warning dedup
        self._proc_via_agg = {}   # proc -> agg id (None = direct)
        # control-plane fan-in accounting ((verb, tier) -> requests),
        # exported through liveness_snapshot — the scale harness's
        # "coordinator load scales with hosts, not procs" evidence
        # coordinator-side chaos rules (fault-plan events with
        # side="coord": reject or stall a chosen proc's requests) and
        # the per-rule injection accounting exported via /metrics
        self._chaos_rules = []
        self._chaos_injected = {}

    def close(self):
        if self._journal is not None:
            self._journal.close()

    # -- journal plumbing (docs/fault_tolerance.md) --------------------------

    def attach_store(self, store):
        """Give the coordinator its paired KV store, for journal
        replay (restoring KV records) and compaction snapshots."""
        self._store = store

    def _j(self, rec):
        """Journal one record (no-op without a journal / during
        replay)."""
        if self._journal is not None and not self._replaying:
            self._journal.append(rec)

    def _log_append(self, rec):
        """THE response-log append point: journals the record with its
        absolute index so a restarted service replays the log workers
        have not consumed yet (their cursors stay valid).  Suppressed
        during replay — replayed joins must not re-emit the join_done
        records the journal already holds.  Must hold the lock."""
        if self._replaying:
            return
        idx = self._log_base + len(self._log)
        self._log.append(rec)
        self._j({"k": "log", "i": idx, "r": rec})

    def procs_seen(self) -> int:
        """How many worker processes have polled this round — the
        round-formation signal the elastic driver's re-init timeout
        watches."""
        with self._lock:
            return len(self._cursors)

    def reset(self, world_size: int, round_id: int = 0):
        """New elastic round: fresh negotiation state; stale-round
        requests are rejected (reference: a new gloo context per
        rendezvous, gloo_context.cc:168-206)."""
        with self._lock:
            self._j({"k": "reset", "world": world_size,
                     "round": round_id})
            self.world_size = world_size
            self.round_id = round_id
            self._bypass_votes.clear()
            self._bypass_armed_fp = None
            self._pending.clear()
            self._log.clear()
            self._log_base = 0
            self._cursors.clear()
            self._joined.clear()
            self._proc_joined.clear()
            self._exhausted.clear()
            self._join_seen.clear()
            self._ready_seen.clear()
            self._ready_reply.clear()
            self._proc_sid.clear()
            self._session_base.clear()
            self._errors.clear()
            self._pending_since.clear()
            self._stall_warned_keys.clear()
            self._cache.clear()
            self._cache_by_key.clear()
            self._beats.clear()
            self._proc_ranks.clear()
            self._proc_hosts.clear()
            self._dead.clear()
            # aggregator sessions are round-scoped (surviving
            # aggregators re-register on the stale reply, which bumps
            # their agg_epoch and re-fences their workers into the
            # new round); only the epoch counters survive — they are
            # monotonic per agg id for the life of the coordinator
            self._agg_sid.clear()
            self._agg_procs.clear()
            self._agg_beats.clear()
            self._agg_warned.clear()
            self._proc_via_agg.clear()
            # chaos rules persist across rounds (the plan describes
            # the whole job) but their request counters restart with
            # the round's fresh proc numbering
            for rule in self._chaos_rules:
                rule["n"] = 0
            self._lock.notify_all()

    def handle(self, verb, req):
        if verb == "clock":
            # NTP-style ping target (the JAX package's
            # utils/clock_sync.py; the aggregator route's probe here):
            # round-agnostic and lock-free
            return {"t": time.time()}
        epoch = req.get("epoch")
        if epoch is not None and epoch != self.coord_epoch \
                and verb not in EPOCH_EXEMPT_VERBS:
            # epoch fence: a request minted against a pre-restart
            # coordinator generation is rejected BEFORE any verb runs
            # — the cross-outage dedup blind HTTP replays rely on.
            # The client answers with one resync handshake.
            return {"epoch_mismatch": True, "epoch": self.coord_epoch}
        if req.get("round", self.round_id) != self.round_id:
            return {"stale": True, "round": self.round_id}
        if verb == "ready":
            return self._on_ready(req)
        if verb == "poll":
            return self._on_poll(req)
        if verb == "join":
            return self._on_join(req)
        if verb == "heartbeat":
            return self._on_heartbeat(req)
        if verb == "resync":
            return self._on_resync(req)
        if verb == "bypass_ready":
            return self._on_bypass_ready(req)
        if verb == "agg_resync":
            return self._on_agg_resync(req)
        if verb == "agg_ready":
            return self._on_agg_ready(req)
        if verb == "agg_heartbeat":
            return self._on_agg_heartbeat(req)
        if verb == "agg_poll":
            return self._on_agg_poll(req)
        raise ValueError(f"unknown coordinator verb {verb}")

    # -- worker liveness ----------------------------------------------------

    def _on_heartbeat(self, req):
        """Record a worker's liveness beat.  The first beat registers
        the proc (and the global ranks / hostname it carries, so a
        later death can be attributed); ``bye`` deregisters on clean
        shutdown — an elastic teardown must not read as a death.  A
        beat from an already-declared-dead proc (a hang that woke up,
        a network partition that healed) gets ``{"dead": true}`` back:
        its peers' collectives were already failed, so the only safe
        move for that worker is to restart into the next round.

        A DIRECT beat (this verb, as opposed to one relayed inside
        ``agg_heartbeat``) also clears the proc's aggregator route:
        it is the "direct-fallback probing succeeded" signal that
        takes the proc off a silent aggregator's suspect list."""
        proc = req.get("proc")
        if proc is None:
            return {}
        with self._lock:
            out = self._apply_heartbeat_locked(req, via=None)
            # beats are a liveness-scan clock too (AFTER recording
            # this beat — the caller is alive by definition): while
            # every worker is armed on the negotiation bypass nobody
            # polls, and a poll-clocked-only scan would never declare
            # a hung bypassed worker dead.  The elastic driver's
            # reaper reads dead_procs() in-process, so the verdict
            # reaches it — and reaping the hung process is what
            # unblocks the survivors' agreement collective.
            self._scan_heartbeats()
        return out

    def _apply_heartbeat_locked(self, req, via=None):
        """Beat-state mutation shared by the direct verb and the
        aggregator relay (``via`` = relaying agg id, None = direct).
        Must hold the lock."""
        proc = req.get("proc")
        if proc is None:
            return {}
        if req.get("bye"):
            # the bye INTENT is journaled: a restarted coordinator
            # must never re-arm liveness for a worker that already
            # said goodbye (its bye would otherwise be lost with
            # the in-memory beat table and the replayed first-beat
            # expectation would read its silence as a death)
            if self._beats.pop(proc, None) is not None or \
                    proc in self._proc_ranks:
                self._j({"k": "bye", "proc": proc})
            self._proc_ranks.pop(proc, None)
            self._proc_hosts.pop(proc, None)
            self._proc_via_agg.pop(proc, None)
            return {}
        if proc in self._dead:
            return {"dead": True}
        if proc not in self._beats:
            # first beat registers the proc: journaled so a
            # restarted coordinator keeps the rank/host attribution
            # (liveness itself re-arms only on a post-restart beat)
            self._j({"k": "hb", "proc": proc,
                     "ranks": req.get("ranks"),
                     "host": req.get("host")})
        self._beats[proc] = time.monotonic()
        self._proc_via_agg[proc] = via
        if req.get("ranks") is not None:
            self._proc_ranks[proc] = list(req["ranks"])
        if req.get("host"):
            self._proc_hosts[proc] = req["host"]
        return {}

    # -- epoch fencing + steady-state bypass (docs/fault_tolerance.md) -------

    def _on_resync(self, req):
        """Epoch resync handshake: a worker whose request hit the
        epoch fence re-registers here ONCE instead of blindly
        replaying.  A journal-replayed session (same sid) keeps its
        log position — the worker drains the replayed response log
        from its own absolute cursor, then re-reports whatever is
        still awaiting; a brand-new session starts at the log end as
        usual.  Idempotent: re-sending the same (proc, sid) changes
        nothing (REPLAY_SAFE_VERBS contract).

        ``via_agg`` records the route the handshake arrived on (the
        aggregator forwards its workers' resyncs upstream, stamping
        its id): liveness treats beats whose route went silent as
        suspect rather than dead.  A direct resync clears the route —
        the worker fell back to the coordinator."""
        proc = req.get("proc")
        with self._lock:
            if proc is not None:
                self._check_session(proc, req.get("sid"))
                self._proc_via_agg[proc] = req.get("via_agg")
                if proc in self._beats:
                    # the handshake itself proves liveness: a worker
                    # resyncing off a dead aggregator route must not
                    # be killed for the beats that died with it —
                    # its own direct beats resume within one interval
                    self._beats[proc] = max(self._beats[proc],
                                            time.monotonic())
            return {"epoch": self.coord_epoch, "round": self.round_id,
                    "cursor": self._log_base + len(self._log)}

    def _on_bypass_ready(self, req):
        """One worker's vote that its negotiated response list has
        been stable (same fingerprint) for K cycles.  When EVERY proc
        has voted the same fingerprint, a ``bypass_arm`` record rides
        the response log — consumed in log order, it is the
        coordinated instant all workers switch to the coordinator-free
        fast path (core/bypass.py).  Idempotent per (proc, fp): a
        replayed vote re-writes the same slot and an armed coordinator
        never re-arms the same fingerprint."""
        proc = req.get("proc")
        fp = req.get("fp")
        if proc is None or not fp:
            return {}
        with self._lock:
            self._check_session(proc, req.get("sid"))
            if self._bypass_armed_fp == fp:
                return {"armed": True}
            self._bypass_votes[proc] = fp
            world = max(self.world_size, 1)
            if len(self._bypass_votes) >= world and \
                    len(set(self._bypass_votes.values())) == 1:
                self._bypass_armed_fp = fp
                self._bypass_votes = {}
                # entries reported in the race window right before the
                # arm are dropped: every proc executes them through
                # the bypass (they ARE the armed list), and a batch
                # scheduled after the arm record would be consumed by
                # fast pollers only.  Entries that turn out NOT to be
                # coverable get re-reported by the unanimous fallback.
                for key in list(self._pending):
                    del self._pending[key]
                    self._pending_since.pop(key, None)
                    self._stall_warned_keys.discard(key)
                logger.info(
                    "steady-state negotiation bypass armed "
                    "(fingerprint %s..., %d procs)", fp[:12], world)
                self._log_append({"kind": "bypass_arm", "fp": fp})
                self._lock.notify_all()
                return {"armed": True}
        return {}

    def _disarm_bypass_locked(self):
        if self._bypass_armed_fp is not None:
            logger.info("steady-state negotiation bypass disarmed")
        self._bypass_armed_fp = None
        self._bypass_votes.clear()

    # -- per-host aggregator tier (docs/fault_tolerance.md) ------------------

    def _touch_agg_locked(self, agg):
        """Any upstream contact from an aggregator is a liveness beat
        for the tier (and re-arms the once-per-silence warning).
        Must hold the lock."""
        if agg is None:
            return
        self._agg_beats[agg] = time.monotonic()
        self._agg_warned.discard(agg)

    def _on_agg_resync(self, req):
        """Aggregator session registration — the tier's resync
        handshake, exempt from the epoch fence for the same reason
        ``resync`` is (a restarted aggregator re-learns the epochs it
        will fence everything else with).  A NEW session of a known
        aggregator id bumps that aggregator's ``agg_epoch``: the
        stateless restart contract — workers fencing on the
        (coord_epoch, agg_epoch) pair get a mismatch on first contact
        with the successor and answer with one worker-level resync,
        exactly like a coordinator restart.  Idempotent per
        (agg, sid); journaled so a restarted COORDINATOR keeps the
        registration (and the epoch keeps climbing, never resets).
        Round-agnostic: the reply carries the current round, which is
        how a surviving aggregator follows an elastic reset."""
        agg = req.get("agg")
        sid = req.get("sid")
        with self._lock:
            self._touch_agg_locked(agg)
            if agg is not None and self._agg_sid.get(agg) != sid:
                self._agg_sid[agg] = sid
                self._agg_epoch[agg] = self._agg_epoch.get(agg, 0) + 1
                self._agg_procs[agg] = [int(p)
                                        for p in req.get("procs", [])]
                if req.get("host"):
                    self._agg_hosts[agg] = req["host"]
                now = time.monotonic()
                for p in self._agg_procs[agg]:
                    # a weak routing hint only: beats are authoritative
                    # (a worker that already fell back direct must not
                    # be re-attributed to the re-registered aggregator
                    # until it actually routes through it again)
                    self._proc_via_agg.setdefault(p, agg)
                    # liveness grace, per tier (the agg-level twin of
                    # the coordinator's post-restart _grace_until): a
                    # NEW session means the old aggregator died — its
                    # workers' beats were lost with it, and they need
                    # a full window to re-fence/re-attach before
                    # silence may read as death
                    if p in self._beats and \
                            self._proc_via_agg.get(p) == agg:
                        self._beats[p] = max(self._beats[p], now)
                self._j({"k": "aggsess", "agg": agg, "sid": sid,
                         "host": self._agg_hosts.get(agg),
                         "procs": self._agg_procs[agg],
                         "epoch": self._agg_epoch[agg]})
                logger.info(
                    "aggregator %s (host %s) registered: %d hosted "
                    "procs, agg_epoch %d", agg,
                    self._agg_hosts.get(agg),
                    len(self._agg_procs[agg]), self._agg_epoch[agg])
            return {"epoch": self.coord_epoch,
                    "agg_epoch": self._agg_epoch.get(agg, 0),
                    "round": self.round_id,
                    "cursor": self._log_base + len(self._log)}

    def _on_agg_ready(self, req):
        """One aggregator's batched ready stream: every hosted proc's
        reports of this flush window in ONE request — the fan-in that
        makes coordinator load scale with hosts, not procs.  Each
        inner report dedups through the same per-proc rid high-water
        as the direct verb (``_ready_seen``), so a replayed batch is
        single-apply report-by-report; scheduling (``_advance``) runs
        once per batch."""
        agg = req.get("agg")
        replies = {}
        with self._lock:
            self._touch_agg_locked(agg)
            for rep in req.get("reports", []):
                replies[str(rep.get("proc"))] = \
                    self._apply_ready_locked(rep)
            self._fail_dead_entries_locked()
            self._advance()
            self._lock.notify_all()
        return {"replies": replies}

    def _on_agg_heartbeat(self, req):
        """One aggregator's batched liveness relay: every hosted proc
        that beat since the last relay, in one request.  Beats apply
        through the same idempotent ``_beats`` update as the direct
        verb, stamped with the relaying aggregator id (the route the
        suspect logic consults); the reply names the hosted procs the
        coordinator has declared dead so the aggregator can answer
        their local beats with ``{"dead": true}``."""
        agg = req.get("agg")
        dead = []
        with self._lock:
            self._touch_agg_locked(agg)
            if req.get("host"):
                self._agg_hosts[agg] = req["host"]
            for beat in req.get("beats", []):
                out = self._apply_heartbeat_locked(beat, via=agg)
                if out.get("dead"):
                    dead.append(beat.get("proc"))
            self._scan_heartbeats()
        return {"dead": dead} if dead else {}

    def _on_agg_poll(self, req):
        """One aggregator's shared long-poll: ONE upstream poll per
        host mirrors the response log for every local worker.
        ``acked`` carries the hosted workers' own consumed cursors
        (clamped by their journaled session bases) so log GC — which
        waits on every proc — keeps working with zero direct polls.
        Clocks the stall / liveness / compaction scans exactly like
        worker polls (the coordinator has no thread of its own)."""
        cursor = req["cursor"]
        agg = req.get("agg")
        round_at_entry = req.get("round", self.round_id)
        timeout = req.get("wait", 10.0)
        deadline = time.monotonic() + timeout
        with self._lock:
            if self.round_id != round_at_entry:
                return {"stale": True, "round": self.round_id}
            self._touch_agg_locked(agg)
            self._scan_stalls()
            self._scan_heartbeats()
            self._maybe_compact_locked()
            for p, c in (req.get("acked") or {}).items():
                p = int(p)
                c = int(c)
                base = self._session_base.get(p)
                if base is not None and c < base:
                    c = base
                self._cursors[p] = max(self._cursors.get(p, 0), c)
            self._gc_log()
            while self._log_base + len(self._log) <= cursor:
                if self.round_id != round_at_entry:
                    return {"stale": True, "round": self.round_id}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"responses": [], "cursor": cursor,
                            "epoch": self.coord_epoch,
                            "agg_epoch": self._agg_epoch.get(agg, 0)}
                self._lock.wait(remaining)
            if self.round_id != round_at_entry:
                return {"stale": True, "round": self.round_id}
            resp = self._log[max(0, cursor - self._log_base):]
            out = {"responses": resp,
                   "cursor": self._log_base + len(self._log),
                   "epoch": self.coord_epoch,
                   "agg_epoch": self._agg_epoch.get(agg, 0)}
            return out

    # -- journal restore + compaction ----------------------------------------

    def restore_journal(self, records):
        """Rebuild control-plane state from journal records (the
        restarted-service path: RendezvousServer.restart_from_journal).
        Bumps the monotonic epoch and opens the liveness grace window;
        the in-flight pending table is deliberately NOT restored —
        workers re-report it after their resync handshake."""
        with self._lock:
            self._replaying = True
            try:
                for rec in records:
                    self._restore_record_locked(rec)
            finally:
                self._replaying = False
            self.coord_epoch += 1
            grace = self.heartbeat_window or 1.5 * self.heartbeat_secs
            self._grace_until = time.monotonic() + max(grace, 0.0)
        self._j({"k": "epoch", "epoch": self.coord_epoch})
        replayed = sum(self._journal_replayed.values())
        logger.warning(
            "coordinator restored from journal: %d records replayed, "
            "epoch %d, round %d, %d response-log entries, liveness "
            "grace %.1fs", replayed, self.coord_epoch, self.round_id,
            len(self._log), max(self._grace_until - time.monotonic(),
                                0.0))

    def _restore_record_locked(self, rec):
        kind = rec.get("k")
        self._journal_replayed[kind] = \
            self._journal_replayed.get(kind, 0) + 1
        if kind == "epoch":
            self.coord_epoch = int(rec["epoch"])
        elif kind == "reset":
            self.world_size = rec["world"]
            self.round_id = rec["round"]
            self._restore_clear_locked()
        elif kind == "log":
            if not self._log:
                self._log_base = int(rec["i"])
            self._log.append(rec["r"])
            r = rec["r"]
            if r.get("kind") == "dead":
                self._dead[r["proc"]] = {
                    "ranks": r.get("ranks", []), "age": 0.0,
                    "host": r.get("host")}
            elif r.get("kind") == "bypass_arm":
                self._bypass_armed_fp = r.get("fp")
        elif kind == "sess":
            self._proc_sid[rec["proc"]] = rec["sid"]
            self._session_base[rec["proc"]] = rec["base"]
        elif kind == "join":
            self._apply_join_locked(rec["req"])
        elif kind == "hb":
            if rec.get("ranks") is not None:
                self._proc_ranks[rec["proc"]] = list(rec["ranks"])
            if rec.get("host"):
                self._proc_hosts[rec["proc"]] = rec["host"]
        elif kind == "bye":
            self._proc_ranks.pop(rec["proc"], None)
            self._proc_hosts.pop(rec["proc"], None)
        elif kind == "aggsess":
            # a restarted coordinator keeps the aggregator tier's
            # registrations (sid + monotonic agg_epoch + hosted
            # procs): the surviving aggregators resync without an
            # epoch bump, so their workers are never re-fenced by a
            # coordinator-only outage.  Liveness (_agg_beats) re-arms
            # only on post-restart contact, like worker beats.
            self._agg_sid[rec["agg"]] = rec["sid"]
            self._agg_epoch[rec["agg"]] = int(rec["epoch"])
            self._agg_procs[rec["agg"]] = [int(p)
                                           for p in rec.get("procs",
                                                            [])]
            if rec.get("host"):
                self._agg_hosts[rec["agg"]] = rec["host"]
            for p in self._agg_procs[rec["agg"]]:
                self._proc_via_agg.setdefault(p, rec["agg"])
        elif kind == "kv":
            if self._store is not None:
                self._store.restore(rec["key"],
                                    journal_mod._unb64(rec["v"]))
        elif kind == "kvdel":
            if self._store is not None:
                self._store.restore(rec["key"], None)
        elif kind == "snap":
            self._restore_snapshot_locked(rec["s"])

    def _restore_clear_locked(self):
        """Round-reset state clear during replay (mirrors reset())."""
        self._pending.clear()
        self._log.clear()
        self._log_base = 0
        self._joined.clear()
        self._proc_joined.clear()
        self._exhausted.clear()
        self._join_seen.clear()
        self._proc_sid.clear()
        self._session_base.clear()
        self._errors.clear()
        self._proc_ranks.clear()
        self._proc_hosts.clear()
        self._dead.clear()
        self._bypass_votes.clear()
        self._bypass_armed_fp = None
        self._agg_sid.clear()
        self._agg_procs.clear()
        self._agg_hosts.clear()
        self._agg_beats.clear()
        self._agg_warned.clear()
        self._proc_via_agg.clear()

    def _restore_snapshot_locked(self, s):
        self._restore_clear_locked()
        self.coord_epoch = s["epoch"]
        self.round_id = s["round"]
        self.world_size = s["world"]
        self._log = list(s.get("log", []))
        self._log_base = s.get("log_base", 0)
        for proc, sid, base in s.get("sess", []):
            self._proc_sid[proc] = sid
            self._session_base[proc] = base
        for ps, pairs in s.get("joined", {}).items():
            self._joined[int(ps)] = {(p, r) for p, r in pairs}
        for ps, counts in s.get("proc_joined", {}).items():
            self._proc_joined[int(ps)] = {int(p): c
                                          for p, c in counts.items()}
        for ps, procs in s.get("exhausted", {}).items():
            self._exhausted[int(ps)] = set(procs)
        for ps, proc, jids in s.get("join_seen", []):
            self._join_seen[(ps, proc)] = set(jids)
        self._proc_ranks = {int(p): r
                            for p, r in s.get("ranks", {}).items()}
        self._proc_hosts = {int(p): h
                            for p, h in s.get("hosts", {}).items()}
        self._dead = {int(p): dict(info)
                      for p, info in s.get("dead", {}).items()}
        for agg, sid, epoch, host, procs in s.get("aggs", []):
            self._agg_sid[agg] = sid
            self._agg_epoch[agg] = int(epoch)
            self._agg_hosts[agg] = host
            self._agg_procs[agg] = [int(p) for p in procs]
            for p in self._agg_procs[agg]:
                self._proc_via_agg.setdefault(p, agg)
        self._bypass_armed_fp = s.get("bypass_fp")
        if self._store is not None:
            for key, val in s.get("kv", {}).items():
                self._store.restore(key, journal_mod._unb64(val))

    def _journal_snapshot_locked(self):
        """Full current state for journal compaction (coordinator lock
        held; takes the store lock via scope() — lock order
        coordinator -> store everywhere, never the reverse)."""
        kv = {}
        if self._store is not None:
            for key, val in self._store.scope("").items():
                if key.startswith(journal_mod.KV_EXCLUDE_PREFIXES):
                    continue
                if len(val) > self._journal.kv_max_bytes:
                    continue
                kv[key] = journal_mod._b64(val)
        return {
            "epoch": self.coord_epoch, "round": self.round_id,
            "world": self.world_size,
            "log": list(self._log), "log_base": self._log_base,
            "sess": [[p, sid, self._session_base.get(p, 0)]
                     for p, sid in self._proc_sid.items()],
            "joined": {str(ps): sorted([p, r] for p, r in pairs)
                       for ps, pairs in self._joined.items()},
            "proc_joined": {str(ps): {str(p): c
                                      for p, c in counts.items()}
                            for ps, counts in self._proc_joined.items()},
            "exhausted": {str(ps): sorted(procs)
                          for ps, procs in self._exhausted.items()},
            "join_seen": [[ps, proc, sorted(jids)]
                          for (ps, proc), jids
                          in self._join_seen.items()],
            "ranks": {str(p): r for p, r in self._proc_ranks.items()},
            "hosts": {str(p): h for p, h in self._proc_hosts.items()},
            "dead": {str(p): dict(info)
                     for p, info in self._dead.items()},
            "aggs": [[agg, sid, self._agg_epoch.get(agg, 0),
                      self._agg_hosts.get(agg),
                      sorted(self._agg_procs.get(agg, []))]
                     for agg, sid in sorted(self._agg_sid.items())],
            "bypass_fp": self._bypass_armed_fp,
            "kv": kv, "tuned": None,
        }

    def _maybe_compact_locked(self):
        """Bound the journal: replace history with one snapshot record
        once the file exceeds its cap (clocked by worker polls, like
        the stall and liveness scans)."""
        if self._journal is None or not self._journal.needs_compaction():
            return
        self._journal.compact(self._journal_snapshot_locked())

    def _scan_heartbeats(self):
        """Declare procs whose beats stopped for the window dead and
        fail every negotiation blocked on them — fast explicit failure
        naming the dead GLOBAL ranks, instead of waiting for the stall
        timeout.  Clocked by worker polls like the stall scan (the
        coordinator has no thread of its own); detection latency is
        therefore window + one poll interval, under 2x the heartbeat
        interval with the default 1.5x window.  Must hold the lock."""
        if self.heartbeat_secs <= 0 or not self._beats:
            return
        now = time.monotonic()
        if now < self._grace_until:
            # post-restart grace: beats missed during the outage are
            # not deaths; liveness only counts beats after the window
            return
        window = self.heartbeat_window or 1.5 * self.heartbeat_secs
        died = False
        for proc, last in list(self._beats.items()):
            if proc in self._dead or now - last <= window:
                continue
            agg = self._proc_via_agg.get(proc)
            if agg is not None:
                agg_last = self._agg_beats.get(agg)
                if agg_last is None or now - agg_last > window:
                    # the proc's beats rode an aggregator that is
                    # itself silent: its hosted ranks are SUSPECT,
                    # not dead — withhold the verdict for the probe
                    # grace (the worker-side fallback budget + one
                    # beat interval; a direct beat or resync clears
                    # the route and normal rules resume); only a proc
                    # still silent PAST that grace failed the direct
                    # fallback too and is declared dead
                    if agg not in self._agg_warned:
                        self._agg_warned.add(agg)
                        logger.warning(
                            "aggregator %s (host %s) silent for "
                            "%.1fs; treating its %d hosted procs as "
                            "suspect pending direct-fallback probing",
                            agg, self._agg_hosts.get(agg),
                            (now - agg_last) if agg_last else
                            float("inf"),
                            len(self._agg_procs.get(agg, ())))
                    if now - last <= window + self._agg_probe_grace:
                        continue
            age = now - last
            ranks = self._proc_ranks.get(proc, [])
            self._dead[proc] = {"ranks": ranks, "age": round(age, 1),
                                "host": self._proc_hosts.get(proc)}
            logger.warning(
                "worker process %s (global ranks %s) missed heartbeats "
                "for %.1fs (interval %.1fs); failing its pending "
                "negotiations", proc, ranks or "unknown", age,
                self.heartbeat_secs)
            self._log_append({
                "kind": "dead", "proc": proc, "ranks": ranks,
                "host": self._proc_hosts.get(proc),
                "message": (f"worker process {proc} hosting global "
                            f"ranks {ranks} is unresponsive (missed "
                            f"heartbeats for {age:.1f}s)")})
            died = True
        if died:
            self._fail_dead_entries_locked()
            self._lock.notify_all()

    def _fail_dead_entries_locked(self):
        """Error-out pending entries blocked on a dead proc (and, via
        the _on_ready call site, entries reported AFTER the death).
        The error names the dead proc's global ranks so every waiting
        rank's exception points at the failed hardware."""
        if not self._dead:
            return
        for key in list(self._pending):
            ent = self._pending[key]
            meta = next(iter(ent.values()))
            members = meta.get("members") or {}
            for proc, info in self._dead.items():
                if proc in ent:
                    continue
                in_set = (str(proc) in members) if members \
                    else (0 <= proc < max(self.world_size, 1))
                if not in_set:
                    continue
                del self._pending[key]
                self._pending_since.pop(key, None)
                self._stall_warned_keys.discard(key)
                self._log_append({
                    "kind": "error", "key": key,
                    "message": (
                        f"worker process {proc} hosting global ranks "
                        f"{info.get('ranks', [])} is unresponsive "
                        f"(missed heartbeats); {key} cannot complete")})
                break

    def dead_procs(self):
        """Declared-dead procs this round: {proc: {ranks, host, age}}.
        The elastic driver polls this to blacklist hung hosts that
        never exit (runner/elastic/driver.py).  Doubles as a scan
        clock: with every worker bypassed (no polls) and ALL workers
        hung (no beats either), the driver's monitor loop is the only
        clock left."""
        with self._lock:
            self._scan_heartbeats()
            return {p: dict(info) for p, info in self._dead.items()}

    # -- coordinator-side chaos ----------------------------------------------

    def add_chaos_rule(self, kind, proc=None, verb=None, after=1,
                       count=1, code=503, ms=0.0, p=1.0, rng=None,
                       event=None):
        """Install one server-side fault rule: reject
        (``kind="http_error"``) or stall (``kind="delay_ms"``) the
        matching coordinator requests from the ``after``-th on, up to
        ``count`` firings — matching on verb and/or requesting proc.
        ``p`` gates each eligible request on a draw from ``rng`` (the
        plan's seeded per-event stream; skipped requests redraw at
        the next one, mirroring worker-side semantics).  Installed by
        launchers from fault-plan events with ``side: "coord"``.
        ``kind="signal"`` fires ``event.set()`` instead of perturbing
        the request — the hook the chaos CoordFaultRunner uses to
        trigger a coordinator kill/restart on the n-th request."""
        if kind not in ("http_error", "delay_ms", "signal"):
            raise ValueError(
                f"coordinator chaos supports http_error/delay_ms/"
                f"signal, not {kind}")
        if kind == "signal" and event is None:
            raise ValueError("signal rules need an event to set")
        import random as _random
        with self._lock:
            self._chaos_rules.append({
                "kind": kind, "proc": proc, "verb": verb,
                "after": int(after), "count": int(count),
                "code": int(code), "ms": float(ms),
                "p": float(p), "rng": rng or _random.Random(0),
                "event": event, "n": 0, "fires": 0})

    def chaos_check(self, verb, req):
        """Consulted by the HTTP handler before dispatching a verb.
        Returns None, ``("error", status)`` or ``("stall", ms)``."""
        if not self._chaos_rules:
            return None
        proc = req.get("proc") if isinstance(req, dict) else None
        action = None
        with self._lock:
            for rule in self._chaos_rules:
                if rule["verb"] not in (None, verb):
                    continue
                if rule["proc"] is not None and proc != rule["proc"]:
                    continue
                rule["n"] += 1
                if (action is not None and rule["kind"] != "signal") \
                        or rule["fires"] >= rule["count"] \
                        or rule["n"] < rule["after"]:
                    continue
                if rule["p"] < 1.0 and \
                        rule["rng"].random() >= rule["p"]:
                    continue    # probabilistic skip: redraw next time
                rule["fires"] += 1
                if rule["kind"] == "signal":
                    # trigger hook for the launcher-side coordinator
                    # fault runner (kill/restart on the n-th request);
                    # the request itself proceeds untouched
                    rule["event"].set()
                    continue
                if rule["kind"] == "http_error":
                    label = "coord_http_error"
                    action = ("error", rule["code"])
                else:
                    label = "coord_stall"
                    action = ("stall", rule["ms"])
                self._chaos_injected[label] = \
                    self._chaos_injected.get(label, 0) + 1
                logger.warning(
                    "chaos: coordinator injecting %s on %s from "
                    "proc %s", rule["kind"], verb, proc)
        return action

    def _check_session(self, proc, sid):
        """A fresh controller session (engine re-init against this
        live coordinator) restarts its report counters; drop the
        PER-PROCESS state of the previous session (locked by caller):

        * rid/jid dedup — or the new session's reports would be
          discarded as replays;
        * join/exhaustion flags — or the new session's collectives
          would complete without this process's contribution;
        * response-log position — or the new session's cursor-0 poll
          would replay the previous session's batches."""
        if sid is None:
            return
        if self._proc_sid.get(proc) != sid:
            self._proc_sid[proc] = sid
            self._ready_seen.pop(proc, None)
            self._ready_reply.pop(proc, None)
            for key in [k for k in self._join_seen if k[1] == proc]:
                del self._join_seen[key]
            # drop exactly THIS proc's join/exhaustion state
            # (_joined tracks (proc, rank) pairs so other procs'
            # fresh-session joins survive the cleanup)
            for ps_key in list(self._exhausted):
                self._exhausted[ps_key].discard(proc)
            for ps_key in list(self._proc_joined):
                self._proc_joined[ps_key].pop(proc, None)
            for ps_key in list(self._joined):
                self._joined[ps_key] = {
                    (p, rk) for (p, rk) in self._joined[ps_key]
                    if p != proc}
            # new sessions start polling at the CURRENT log end
            self._session_base[proc] = self._log_base + len(self._log)
            self._cursors.pop(proc, None)
            # journaled so a restarted coordinator recognizes the SAME
            # session (no state wipe, cursor fencing intact) instead of
            # treating the surviving worker as a fresh one
            self._j({"k": "sess", "proc": proc, "sid": sid,
                     "base": self._session_base[proc]})

    def _on_ready(self, req):
        """Worker announces locally-ready entries.
        req: {proc: int, nlocal: int, entries: [meta...]}
        meta: {key, type, dtype, shape, op, pre, post, ps, nbytes,
               names, root} — or the cache-hit form {key, c, aux}.
        Returns {uncached: [key...]} for cache ids this coordinator no
        longer holds (evicted / new round); the worker resends those
        with full metas."""
        with self._lock:
            reply = self._apply_ready_locked(req)
            # entries reported after a peer was declared dead must
            # fail now, not sit pending forever
            self._fail_dead_entries_locked()
            self._advance()
            self._lock.notify_all()
        return reply

    def _apply_ready_locked(self, req):
        """Ready-report mutation shared by the direct verb and the
        aggregator batch (``agg_ready`` applies one per report under a
        single lock hold).  Must hold the lock; the caller runs
        ``_fail_dead_entries_locked`` + ``_advance`` once per
        request."""
        proc = req["proc"]
        uncached = []
        self._check_session(proc, req.get("sid"))
        rid = req.get("rid")
        if rid is not None:
            # ready is only idempotent while the entry is still
            # pending; a replayed POST (dropped keep-alive or
            # timeout retry after the server processed the
            # original) could otherwise plant a phantom entry with
            # the PREVIOUS step's meta — dedup on the client's
            # monotonically increasing report id.  The CURRENT
            # rid's replay must get the ORIGINAL response back:
            # returning {} would swallow an ``uncached`` list and
            # strand the withheld metas forever (the client only
            # ever replays its latest report, so one slot per
            # proc suffices)
            last = self._ready_seen.get(proc, 0)
            if rid == last:
                return self._ready_reply.get(proc, {})
            if rid < last:
                return {}
            self._ready_seen[proc] = rid
        if req.get("entries"):
            # a worker reporting entries has left the bypass fast
            # path (the agreement vote made the exit unanimous):
            # disarm so a fresh stable phase must re-vote
            self._disarm_bypass_locked()
        for meta in req["entries"]:
            key = meta["key"]
            if "c" in meta:
                template = self._cache.get(meta["c"])
                if template is None or \
                        self._cache_by_key.get(key) != meta["c"]:
                    uncached.append(key)
                    continue
                self._cache.move_to_end(meta["c"])
                full = dict(template)
                full["aux"] = meta.get("aux", {})
                full["_cached"] = meta["c"]
                meta = full
            ent = self._pending.get(key)
            if ent is None:
                ent = self._pending[key] = {}
                self._pending_since[key] = time.monotonic()
            if proc not in ent:
                ent[proc] = meta
                if meta.get("error"):
                    # a process failed local validation: the whole
                    # tensor errors on every process
                    self._errors[key] = meta["error"]
                err = self._validate(key, ent)
                if err:
                    self._errors[key] = err
        reply = {"uncached": uncached} if uncached else {}
        if rid is not None:
            self._ready_reply[proc] = reply
        return reply

    def _validate(self, key, ent):
        """Cross-process consistency (reference ConstructResponse,
        controller.cc:496-843)."""
        metas = list(ent.values())
        first = metas[0]
        if all(m.get("_cached") is not None
               and m.get("_cached") == first.get("_cached")
               for m in metas):
            # every report resolved through the same cache entry:
            # the metas are one template by construction (fast path)
            return None
        for m in metas[1:]:
            for field, label in (("dtype", "data types"),
                                 ("op", "reduce ops"),
                                 ("pre", "prescale factors"),
                                 ("post", "postscale factors"),
                                 ("wire", "wire dtypes"),
                                 ("wi", "inner wire dtypes"),
                                 ("algo", "algorithms"),
                                 ("pp", "pipeline schedules"),
                                 ("sfp", "shard layouts"),
                                 ("root", "root ranks")):
                if m.get(field) != first.get(field):
                    return (f"Mismatched {label} for {key}: "
                            f"{m.get(field)} vs {first.get(field)}")
            if first["type"] in ("ALLREDUCE", "ADASUM", "BROADCAST",
                                 "REDUCESCATTER"):
                if m.get("shape") != first.get("shape"):
                    return (f"Mismatched shapes for {key}: "
                            f"{m.get('shape')} vs {first.get('shape')}")
                if m.get("gshapes") != first.get("gshapes"):
                    return (f"Mismatched group member shapes for {key}: "
                            f"{m.get('gshapes')} vs "
                            f"{first.get('gshapes')}")
            else:
                if m.get("shape", [])[1:] != first.get("shape", [])[1:]:
                    return f"Mismatched non-first dimensions for {key}"
                gs_a = m.get("gshapes") or []
                gs_b = first.get("gshapes") or []
                if len(gs_a) != len(gs_b) or any(
                        a[1:] != b[1:] for a, b in zip(gs_a, gs_b)):
                    return (f"Mismatched group member non-first "
                            f"dimensions for {key}")
        return None

    def _on_join(self, req):
        """A rank joined (ran out of data).  Tracks per-process
        exhaustion so entries become ready without the exhausted
        process's report, and emits join_done once every rank of the
        set joined (reference controller.cc:269-327,413-423)."""
        ps = req.get("ps", 0)
        proc = req.get("proc", -1)
        with self._lock:
            self._check_session(proc, req.get("sid"))
            if self._apply_join_locked(req):
                # journaled post-dedup: a restarted coordinator must
                # not lose joined/exhausted state (or the exhausted
                # proc's peers would wait for reports that never come),
                # and the replayed jid keeps outage-spanning join
                # retries single-apply
                self._j({"k": "join", "req": {
                    "ps": ps, "proc": proc, "rank": req.get("rank"),
                    "jid": req.get("jid"),
                    "proc_members": req.get("proc_members", 1),
                    "ps_size": req.get("ps_size", self.world_size)}})
            self._disarm_bypass_locked()
            self._advance()
            self._lock.notify_all()
        return {}

    def _apply_join_locked(self, req) -> bool:
        """Join-state mutation shared by the live verb and journal
        replay.  Returns False when the jid was already seen (dedup)."""
        ps = req.get("ps", 0)
        proc = req.get("proc", -1)
        jid = req.get("jid")
        if jid is not None:
            # joins are not naturally idempotent (per-proc counting
            # below); dedup on the client's join id so the http
            # client's reconnect-retry can safely re-send
            seen = self._join_seen.setdefault((ps, proc), set())
            if jid in seen:
                return False
            seen.add(jid)
        j = self._joined.setdefault(ps, set())
        j.add((proc, req["rank"]))
        pj = self._proc_joined.setdefault(ps, {})
        pj[proc] = pj.get(proc, 0) + 1
        if pj[proc] >= req.get("proc_members", 1):
            self._exhausted.setdefault(ps, set()).add(proc)
        if len(j) >= req.get("ps_size", self.world_size):
            self._log_append({"kind": "join_done", "ps": ps,
                              "last": req["rank"]})
            self._joined[ps] = set()
            self._proc_joined[ps] = {}
            self._exhausted[ps] = set()
        return True

    def _advance(self):
        """Move fully-ready entries (all non-exhausted processes
        reported) from pending to the ordered response log, fusing
        adjacent compatible allreduces (FuseResponses,
        controller.cc:901-1080).  Must hold the lock."""
        ready = []
        for key in list(self._pending.keys()):
            ent = self._pending[key]
            if len(ent) >= self._members_for(ent):
                meta = next(iter(ent.values()))
                del self._pending[key]
                self._pending_since.pop(key, None)
                # completion re-arms the once-per-stall warning for a
                # re-used tensor name (mirrors the worker-side
                # _discard_stall_mark contract)
                self._stall_warned_keys.discard(key)
                if key in self._errors:
                    self._log_append({"kind": "error", "key": key,
                                      "message": self._errors.pop(key)})
                else:
                    # merge per-process aux (allgather dims / alltoall
                    # splits) for the response
                    meta = dict(meta)
                    meta["aux_by_proc"] = {str(p): m.get("aux", {})
                                           for p, m in ent.items()}
                    ready.append(meta)
        # fuse
        bucket, bucket_bytes, sig = [], 0, None

        def flush():
            nonlocal bucket, bucket_bytes, sig
            if bucket:
                self._log_append(self._batch_response(bucket))
                bucket, bucket_bytes, sig = [], 0, None

        for meta in ready:
            if meta["type"] not in ("ALLREDUCE", "ADASUM",
                                    "ALLGATHER"):
                if self._exhausted.get(meta.get("ps", 0)):
                    # join only supports allreduce (reference
                    # controller.cc:413-423): other ops with joined
                    # processes error instead of hanging
                    self._log_append({
                        "kind": "error", "key": meta["key"],
                        "message": (f"{meta['type']} does not support "
                                    f"joined ranks")})
                    continue
                flush()
                self._log_append(self._batch_response([meta]))
                continue
            if meta["type"] == "ALLGATHER":
                if self._exhausted.get(meta.get("ps", 0)):
                    self._log_append({
                        "kind": "error", "key": meta["key"],
                        "message": "ALLGATHER does not support "
                                   "joined ranks"})
                    continue
                # same-dtype allgathers fuse like allreduces (the
                # reference packs allgather responses too,
                # controller.cc:901-1080); output-size accounting over
                # RANKS (nprocs undercounts by ranks_per_proc —
                # engine-side _fuse uses ps.size the same way)
                msig = ("ALLGATHER", meta["dtype"], meta["ps"])
                nbytes = meta["nbytes"] * max(
                    meta.get("nranks",
                             meta.get("nprocs", self.world_size)), 1)
            else:
                # wire pair and algorithm split buckets exactly like
                # the engine-side _fuse signature: a quantized or
                # hierarchical entry must not share a fused SPMD
                # program with a full-width / flat one, nor may two
                # halves of one bucket disagree on a hop's format
                msig = (meta["type"], meta["dtype"], meta["op"],
                        meta["pre"], meta["post"], meta["ps"],
                        meta.get("wire"), meta.get("wi"),
                        meta.get("algo"), meta.get("pp"))
                nbytes = meta["nbytes"]
            if bucket and (msig != sig or
                           bucket_bytes + nbytes >
                           self.fusion_threshold):
                flush()
            bucket.append(meta)
            bucket_bytes += nbytes
            sig = msig
        flush()

    def _batch_response(self, metas):
        cache_ids = {}
        templates = {}
        for m in metas:
            key = m["key"]
            # single filtered copy serves as both the wire meta and the
            # cache template, so the two can't drift apart
            templates[key] = {k: v for k, v in m.items()
                              if k not in ("aux", "aux_by_proc",
                                           "_cached")}
            if m["type"] not in CACHEABLE_TYPES \
                    or self.cache_capacity <= 0:
                # capacity 0 = cache disabled (an autotunable point —
                # the reference tunes cache on/off the same way)
                continue
            cid = self._cache_by_key.get(key)
            if cid is None:
                cid = self._next_cache_id
                self._next_cache_id += 1
                self._cache_by_key[key] = cid
                while len(self._cache) >= self.cache_capacity:
                    old_id, old_t = self._cache.popitem(last=False)
                    self._cache_by_key.pop(old_t["key"], None)
            self._cache[cid] = templates[key]
            self._cache.move_to_end(cid)
            cache_ids[key] = cid
        # job-unique trace ids, minted per negotiation entry at
        # scheduling time: every process receives the same id for the
        # same entry, so the flow events each rank emits chain into
        # one cross-rank arrow in the merged trace
        trace_ids = {}
        for m in metas:
            self._next_trace_id += 1
            trace_ids[m["key"]] = self._next_trace_id
        resp = {
            "kind": "batch",
            "keys": [m["key"] for m in metas],
            "metas": templates,
            "aux": {m["key"]: m.get("aux_by_proc", {}) for m in metas},
            "trace": trace_ids,
        }
        if cache_ids:
            resp["cache_ids"] = cache_ids
        return resp

    def _members_for(self, ent):
        meta = next(iter(ent.values()))
        nprocs = meta.get("nprocs", self.world_size)
        exhausted = self._exhausted.get(meta.get("ps", 0), set())
        return max(nprocs - len(exhausted), 1)

    def _scan_stalls(self):
        """Global stall attribution (reference stall_inspector.cc
        CheckForStalledTensors, which runs on the coordinator rank and
        names every missing rank): an entry some processes reported
        past the warning age is attributed to the GLOBAL ranks of the
        processes that never did (the ``members`` map each report
        carries), logged here and appended to the response log as a
        ``stall`` record — so every worker's warning (and exported
        ``horovod_stall_warnings_total`` labels) names the same
        ranks.  Once per stall; completion re-arms.  Must hold the
        lock; cheap (the pending table holds in-flight entries only),
        called from every poll."""
        if self.stall_warning_secs <= 0 or not self._pending:
            return
        now = time.monotonic()
        new_stalls = 0
        for key, ent in self._pending.items():
            t0 = self._pending_since.get(key)
            if t0 is None or now - t0 <= self.stall_warning_secs \
                    or key in self._stall_warned_keys:
                continue
            self._stall_warned_keys.add(key)
            meta = next(iter(ent.values()))
            ps = meta.get("ps", 0)
            members = meta.get("members") or {}
            exhausted = self._exhausted.get(ps, set())
            reported = set(ent.keys())
            if members:
                missing_procs = sorted(
                    int(p) for p in members
                    if int(p) not in reported
                    and int(p) not in exhausted)
            else:
                # report lacked the members map: fall back to the
                # world proc universe (exact for the global set)
                missing_procs = sorted(
                    set(range(self.world_size)) - reported - exhausted)
            missing_ranks = sorted(
                r for p in missing_procs
                for r in members.get(str(p), []))
            age = now - t0
            # attribution granularity is the PROCESS: a process only
            # reports once every local rank submitted, so the ranks
            # named are "hosted by a non-reporting process" — the
            # process's own local inspector narrows to the exact rank
            logger.warning(
                "One or more tensors were submitted to be reduced by "
                "some ranks but not all: %s stalled for %.0fs "
                "(non-reporting processes: %s, hosting global ranks: "
                "%s)", key, age, missing_procs,
                missing_ranks if members else "unknown")
            self._log_append({
                "kind": "stall", "key": key, "ps": ps,
                "age": round(age, 1),
                "missing_ranks": missing_ranks,
                "missing_procs": missing_procs,
            })
            new_stalls += 1
        if new_stalls:
            # every stall warning ships with the clock-aligned job
            # trace that explains it: ONE flight-recorder dump request
            # rides the log behind this scan's stall records (one
            # straggler can stall many tensors at once; per-key dump
            # requests would have every worker re-push its full ring
            # N times), so each worker — the straggler included, its
            # engine thread still polls — pushes its last-N-seconds
            # ring exactly once per stall burst
            self._next_dump_id += 1
            self._log_append({"kind": "trace_dump",
                              "id": self._next_dump_id,
                              "reason": "stall"})
            self._lock.notify_all()     # wake parked long-polls

    def _on_poll(self, req):
        """Long-poll for responses after cursor (absolute)."""
        cursor = req["cursor"]
        round_at_entry = req.get("round", self.round_id)
        timeout = req.get("wait", 10.0)
        proc = req.get("proc")
        deadline = time.monotonic() + timeout
        with self._lock:
            if self.round_id != round_at_entry:
                # a reset raced us past handle()'s unlocked check:
                # don't let a stale cursor poison the new round's GC
                return {"stale": True, "round": self.round_id}
            # polls arrive every worker cycle, so they are the stall
            # inspector's, the liveness scan's AND the journal
            # compactor's clock (the coordinator has no thread of its
            # own)
            self._scan_stalls()
            self._scan_heartbeats()
            self._maybe_compact_locked()
            if proc is not None:
                # a re-sessioned controller polls from cursor 0; its
                # session starts at the log position recorded when the
                # new session was first seen — never replay the
                # previous session's batches to it
                base = self._session_base.get(proc)
                if base is not None and cursor < base:
                    cursor = base
                # the client has consumed everything below its cursor
                self._cursors[proc] = max(self._cursors.get(proc, 0),
                                          cursor)
                self._gc_log()
            while self._log_base + len(self._log) <= cursor:
                if self.round_id != round_at_entry:
                    # an elastic reset happened while we were waiting:
                    # this worker's round is over — never hand it the
                    # new round's responses
                    return {"stale": True, "round": self.round_id}
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"responses": [], "cursor": cursor,
                            "epoch": self.coord_epoch}
                self._lock.wait(remaining)
            if self.round_id != round_at_entry:
                return {"stale": True, "round": self.round_id}
            resp = self._log[max(0, cursor - self._log_base):]
            # poll replies carry the epoch: the worker adopts it on
            # first contact and fences every later verb with it
            return {"responses": resp,
                    "cursor": self._log_base + len(self._log),
                    "epoch": self.coord_epoch}

    def _gc_log(self):
        """Drop log entries every process has polled past.  Must hold
        the lock.  Waits until all world_size processes have polled at
        least once so a late-starting process never misses entries."""
        if len(self._cursors) < max(self.world_size, 1):
            return
        low = min(self._cursors.values())
        drop = low - self._log_base
        if drop > 0:
            del self._log[:drop]
            self._log_base = low


class _ThreadingHTTPServer(socketserver.ThreadingMixIn,
                           socketserver.TCPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, *args, **kwargs):
        # live keep-alive connections, so a coordinator kill/restart
        # can sever them: a handler thread parked on an old keep-alive
        # would otherwise keep serving the PRE-restart coordinator
        # object, quietly splitting the control plane in two
        self._conns = set()
        self._conns_lock = threading.Lock()
        super().__init__(*args, **kwargs)

    def process_request(self, request, client_address):
        with self._conns_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conns_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def close_all_connections(self):
        with self._conns_lock:
            conns, self._conns = set(self._conns), set()
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def handle_error(self, request, client_address):
        # keep-alive sockets torn down by exiting workers are routine,
        # not server errors — don't spray tracebacks on every shutdown
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError, TimeoutError)):
            return
        super().handle_error(request, client_address)


class RendezvousServer:
    """KV + coordinator HTTP service hosted by the launcher (reference
    RendezvousServer, http_server.py:192)."""

    def __init__(self, secret: bytes = None, world_size: int = 0,
                 fusion_threshold_bytes: int = 128 * 1024 * 1024,
                 cache_capacity: int = 1024, autotune: bool = False,
                 stall_warning_secs: float = 60.0,
                 heartbeat_secs: float = 5.0,
                 heartbeat_window: float = 0.0,
                 journal_path: str = None,
                 journal_replay: bool = False):
        self._coord_kwargs = dict(
            world_size=world_size,
            fusion_threshold_bytes=fusion_threshold_bytes,
            cache_capacity=cache_capacity, autotune=autotune,
            stall_warning_secs=stall_warning_secs,
            heartbeat_secs=heartbeat_secs,
            heartbeat_window=heartbeat_window)
        self._journal_path = journal_path
        self.secret = secret
        self._httpd = None
        self._thread = None
        self._bound_port = None
        self._build(replay=journal_replay)

    def _build(self, replay):
        """(Re)build store + coordinator.  With a journal path: a
        fresh job truncates whatever a previous job left there, while
        ``replay=True`` (restart_from_journal, or
        ``HOROVOD_COORD_JOURNAL_REPLAY=1`` for a restarted launcher)
        rebuilds the control plane from the records and bumps the
        epoch."""
        journal = records = None
        if self._journal_path:
            journal = journal_mod.CoordJournal(self._journal_path)
            if replay:
                records = journal.read()
            elif os.path.exists(self._journal_path):
                journal.truncate()
        self.store = KVStore()
        self.coordinator = Coordinator(journal=journal,
                                       **self._coord_kwargs)
        self.coordinator.attach_store(self.store)
        if journal is not None:
            if records:
                self.coordinator.restore_journal(records)
            else:
                # first record of a fresh journal: the base epoch
                self.coordinator._j(
                    {"k": "epoch",
                     "epoch": self.coordinator.coord_epoch})
            # KV journaling goes live only AFTER replay so restored
            # entries are not re-journaled
            self.store.journal = journal

    def start(self, port=0) -> int:
        if port == 0 and self._bound_port:
            # a restarted service must come back on the SAME port —
            # workers have the address baked into their env handoff
            port = self._bound_port
        self._httpd = _ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._httpd.store = self.store
        self._httpd.coordinator = self.coordinator
        self._httpd.secret = self.secret
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hvd-rendezvous", daemon=True)
        self._thread.start()
        self._bound_port = self._httpd.server_address[1]
        return self._bound_port

    @property
    def port(self):
        # while the HTTP service is down (coord_kill window) the bound
        # port is still the service's identity: an elastic round reset
        # mid-outage must bake the REAL port into worker env, not None
        if self._httpd is not None:
            return self._httpd.server_address[1]
        return self._bound_port

    def stop_http(self):
        """Tear down the HTTP service only (chaos ``coord_kill``):
        state and journal stay, workers see connection failures and
        ride the bypass / outage-deadline retry path."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            # sever live keep-alives too: their handler threads hold
            # the OLD coordinator object and would keep answering
            self._httpd.close_all_connections()
            self._httpd = None

    def restart_from_journal(self) -> int:
        """Crash-recovery drill (chaos ``coord_restart``): drop ALL
        in-memory state, rebuild store + coordinator purely from the
        journal (epoch bumped, liveness grace armed) and re-serve on
        the same port.  Proves the journal alone carries the control
        plane."""
        if not self._journal_path:
            raise RuntimeError(
                "restart_from_journal requires a journal "
                "(HOROVOD_COORD_JOURNAL)")
        self.stop_http()
        self.coordinator.close()
        self._build(replay=True)
        return self.start()

    def stop(self):
        self.coordinator.close()
        self.stop_http()


def free_port():
    """Probe an OS-assigned free TCP port on THIS host (shared by every
    launcher; probe where the service will bind, never on the driver
    for a worker-hosted service)."""
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port



def local_ip():
    """This host's address as its own name resolves (127.0.0.1 when it
    does not resolve).  The launcher hands it to every worker as the
    rendezvous address when a job has a remote host (an all-local job
    uses 127.0.0.1), and uses it for ``proc_run.is_local``.  It is trusted
    as it is, as the JAX package trusts its own: a host whose name
    resolves to a loopback alias (``127.0.1.1``) gives remote workers an
    address they cannot reach."""
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
