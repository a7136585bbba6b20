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

Not ported (ROADMAP.md): the aggregator tier's verbs, journal restore
and compaction (with it the replay of a ``bypass_arm`` record after a
restart), coordinator-side chaos and the ``/metrics`` and ``/timeline``
endpoints (A17); the coordinator-side autotuner (A14).
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
from .contract import CACHEABLE_TYPES

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
    if env.get("HOROVOD_COORD_JOURNAL"):
        kwargs["journal_path"] = env["HOROVOD_COORD_JOURNAL"]
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
        if not self._verify(b""):
            return self._reply(FORBIDDEN)
        path, _, query = self.path.partition("?")
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
            resp = self.server.coordinator.handle(verb, req)
        except Exception as exc:  # noqa: BLE001 — reported to caller
            return self._reply(BAD_REQUEST,
                               json.dumps({"error": str(exc)}).encode(),
                               "application/json")
        self._reply(OK, json.dumps(resp).encode(), "application/json")


class KVStore:
    """Blocking-get key/value store (reference KVStoreHandler).

    With a coordinator journal attached (``journal`` attribute), every
    small write is recorded under the journal's size cap; the bulky
    ephemeral namespaces are excluded."""

    def __init__(self):
        self._data = {}
        self._cv = threading.Condition()
        self.journal = None

    def _journal_write(self, key, value):
        j = self.journal
        if j is None or key.startswith(journal_mod.KV_EXCLUDE_PREFIXES):
            return
        if value is not None and len(value) > journal_mod.KV_MAX_BYTES:
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




class Coordinator:
    """Server-side negotiation engine (the reference's rank-0
    coordinator, controller.cc ComputeResponseList/FuseResponses,
    relocated into the launcher's store service).

    Response cache (reference response_cache.{h,cc}): batch responses
    assign each tensor a cache id workers learn from the response; on
    repeat iterations a worker reports ``{"key", "c": id}`` instead of
    the full negotiation meta, and entries whose reports all carry the
    same id skip cross-process validation.  The LRU is
    capacity-bounded; reports naming an evicted id get the key back in
    ``uncached`` and resend the full meta."""

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
        # the coordinator generation the JAX package bumps on a journal
        # replay; the port never restarts one (A17), so it stays 1
        self.coord_epoch = 1
        # the elastic round (runner/elastic/driver.py): reset() starts a
        # new one, and a request stamped with another round is answered
        # ``{"stale": true}`` (0 in a static job, whose workers stamp 0)
        self.round_id = 0
        self._journal = journal
        # coordinator-side stall inspector (reference
        # stall_inspector.cc relocated with the coordinator): an entry
        # pending past this age gets a ``stall`` response naming the
        # GLOBAL ranks of the processes that never reported it.
        # 0 disables (HOROVOD_STALL_CHECK_DISABLE).
        self.stall_warning_secs = stall_warning_secs
        # worker liveness: workers beat via the ``heartbeat`` verb; a
        # proc whose beats stop for the window (default 1.5x the
        # interval) is declared dead, and its pending negotiations fail
        # at once with an error naming the global ranks it hosts.  A
        # proc is only expected to beat after its FIRST beat, so slow
        # starters are never false-positived.  0 disables.
        self.heartbeat_secs = heartbeat_secs
        self.heartbeat_window = heartbeat_window
        # steady-state negotiation bypass (core/bypass.py): per-proc
        # cycle-fingerprint votes; when every proc votes the same
        # fingerprint a ``bypass_arm`` record rides the response log, the
        # instant all workers switch to the coordinator-free fast path
        self._bypass_votes = {}
        self._bypass_armed_fp = None
        self._lock = threading.Condition()
        # key -> {proc_id -> meta}
        self._pending: "OrderedDict[str, dict]" = OrderedDict()
        # Ordered response log.  Client cursors are absolute; entries
        # every process has polled past are garbage-collected and
        # _log_base keeps absolute cursors valid.
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
        # job-unique ids, one per scheduled negotiation entry (the JAX
        # package's flow-event trace ids; the port's workers ignore
        # them, the log keeps the JAX package's records)
        self._next_trace_id = 0
        self._next_dump_id = 0
        # liveness state: proc -> last beat monotonic / hosted global
        # ranks / hostname; _dead holds declared-dead procs
        self._beats = {}
        self._proc_ranks = {}
        self._proc_hosts = {}
        self._dead = {}

    def close(self):
        if self._journal is not None:
            self._journal.close()

    # -- journal plumbing -----------------------------------------------------

    def _j(self, rec):
        """Journal one record (no-op without a journal)."""
        if self._journal is not None:
            self._journal.append(rec)

    def _log_append(self, rec):
        """THE response-log append point: journals the record with its
        absolute index.  Must hold the lock."""
        idx = self._log_base + len(self._log)
        self._log.append(rec)
        self._j({"k": "log", "i": idx, "r": rec})

    def procs_seen(self) -> int:
        """How many worker processes have polled this round: the
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
            self._lock.notify_all()

    def dead_procs(self):
        """Declared-dead procs this round: {proc: {ranks, host, age}}.
        The elastic driver polls this to blacklist hung hosts that never
        exit (runner/elastic/driver.py); it doubles as a scan clock, for
        a job whose workers are all armed on the bypass (no polls) and
        all hung (no beats)."""
        with self._lock:
            self._scan_heartbeats()
            return {p: dict(info) for p, info in self._dead.items()}

    def handle(self, verb, req):
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
        if verb == "bypass_ready":
            return self._on_bypass_ready(req)
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
        move for that worker is to stop."""
        proc = req.get("proc")
        if proc is None:
            return {}
        with self._lock:
            out = self._apply_heartbeat_locked(req)
            # beats are a liveness-scan clock too (AFTER recording
            # this beat — the caller is alive by definition): while
            # every worker is armed on the negotiation bypass nobody
            # polls, and a poll-clocked scan alone would never declare a
            # hung bypassed worker dead
            self._scan_heartbeats()
        return out

    def _apply_heartbeat_locked(self, req):
        """Beat-state mutation.  Must hold the lock."""
        proc = req.get("proc")
        if req.get("bye"):
            if self._beats.pop(proc, None) is not None or \
                    proc in self._proc_ranks:
                self._j({"k": "bye", "proc": proc})
            self._proc_ranks.pop(proc, None)
            self._proc_hosts.pop(proc, None)
            return {}
        if proc in self._dead:
            return {"dead": True}
        if proc not in self._beats:
            # first beat registers the proc with its rank/host
            # attribution
            self._j({"k": "hb", "proc": proc,
                     "ranks": req.get("ranks"),
                     "host": req.get("host")})
        self._beats[proc] = time.monotonic()
        if req.get("ranks") is not None:
            self._proc_ranks[proc] = list(req["ranks"])
        if req.get("host"):
            self._proc_hosts[proc] = req["host"]
        return {}

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
        window = self.heartbeat_window or 1.5 * self.heartbeat_secs
        died = False
        for proc, last in list(self._beats.items()):
            if proc in self._dead or now - last <= window:
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

    # -- steady-state negotiation bypass ---------------------------------------

    def _on_bypass_ready(self, req):
        """One worker's vote that its negotiated response list has been
        stable (one fingerprint) for K cycles.  When EVERY proc has voted
        the same fingerprint, a ``bypass_arm`` record rides the response
        log: consumed in log order, it is the instant all workers switch
        to the coordinator-free fast path (core/bypass.py).  Idempotent
        per (proc, fp): a replayed vote re-writes the same slot, and an
        armed coordinator never re-arms the same fingerprint."""
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
                # entries reported in the race window right before the arm
                # are dropped: every proc runs them through the bypass
                # (they ARE the armed list), and a batch scheduled after
                # the arm record would be consumed by fast pollers only.
                # Entries the list cannot cover are re-reported by the
                # unanimous fallback.
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

    # -- negotiation ----------------------------------------------------------

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
        """Ready-report mutation.  Must hold the lock; the caller runs
        ``_fail_dead_entries_locked`` + ``_advance``."""
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
            # a worker reporting entries has left the bypass fast path
            # (the agreement vote made the exit unanimous): disarm, so a
            # fresh stable phase must vote again
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
        """Join-state mutation.  Returns False when the jid was already
        seen (dedup)."""
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
                # a reset raced us past handle()'s unlocked check: don't
                # let a stale cursor poison the new round's GC
                return {"stale": True, "round": self.round_id}
            # polls arrive every worker cycle, so they are the stall
            # inspector's and the liveness scan's clock (the
            # coordinator has no thread of its own)
            self._scan_stalls()
            self._scan_heartbeats()
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
                    # this worker's round is over, so never hand it the
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
        # live keep-alive connections, so stop() can sever them
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
                 journal_path: str = None):
        journal = None
        if journal_path:
            journal = journal_mod.CoordJournal(journal_path)
            if os.path.exists(journal_path):
                # a new job truncates whatever a previous job left there
                journal.truncate()
        self.secret = secret
        self.store = KVStore()
        self.coordinator = Coordinator(
            world_size=world_size,
            fusion_threshold_bytes=fusion_threshold_bytes,
            cache_capacity=cache_capacity, autotune=autotune,
            stall_warning_secs=stall_warning_secs,
            heartbeat_secs=heartbeat_secs,
            heartbeat_window=heartbeat_window, journal=journal)
        if journal is not None:
            # first record of a fresh journal: the base epoch
            self.coordinator._j({"k": "epoch",
                                 "epoch": self.coordinator.coord_epoch})
            self.store.journal = journal
        self._httpd = None
        self._thread = None

    def start(self, port=0) -> int:
        self._httpd = _ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._httpd.store = self.store
        self._httpd.coordinator = self.coordinator
        self._httpd.secret = self.secret
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="hvd-rendezvous", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self):
        self.coordinator.close()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            # sever live keep-alives too: their handler threads would
            # otherwise keep answering
            self._httpd.close_all_connections()
            self._httpd = None


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
