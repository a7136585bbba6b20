"""Multi-process negotiation controller: talks to the launcher-hosted
HTTP coordinator (port of ``horovod_tpu/core/store_controller.py``).

Replaces the reference's controller transports
(``horovod/common/gloo/gloo_controller.cc``,
``mpi/mpi_controller.cc``): each process POSTs locally-ready tensors to the
launcher-hosted coordinator (runner/http/http_server.py Coordinator) and
polls an ordered response log.  The log fixes the global execution
order, so every process issues the same ``torch.distributed``
collectives in the same order, as one process group needs.

Every verb carries the (coord_epoch, agg_epoch) pair the worker last
learned.  A coordinator restarted from its journal, or a restarted
per-host aggregator, answers a stale pair with ``epoch_mismatch``: the
controller re-registers once (``resync``), drains the replayed response
log up to the resync cursor, then re-reports what is still awaiting
(:meth:`StoreController.take_rereport`); a ready is never blindly
replayed across an epoch bump.  With the aggregator tier
(``HOROVOD_CONTROL_PLANE_TIER=host``) the client is a
``TieredStoreClient``: the host's aggregator first, the coordinator as
the fallback.

Every request carries the elastic round (``round_id``, the round the
worker joined at the rendezvous; 0 in a static job).  A coordinator that
has moved to a newer round answers ``{"stale": true}``, which raises
:class:`StaleRoundError` (a ``HorovodInternalError``): the engine aborts,
and every pending collective of the old round fails into the elastic
restore path.
"""

import json
import threading

from ..common import env as env_mod
from ..common.exceptions import HorovodInternalError
from ..runner.http.http_client import StoreClient, TieredStoreClient
from ..runner.http.contract import CACHEABLE_TYPES as _CACHEABLE_TYPES


def _fingerprint(meta):
    """Canonical identity of a negotiation meta, aux/error excluded
    (reference response_cache.h:45-101 keys the LRU on tensor name +
    params the same way)."""
    return json.dumps(
        {k: v for k, v in meta.items() if k not in ("aux", "error")},
        sort_keys=True)


class StaleRoundError(HorovodInternalError):
    """The coordinator moved to a new elastic round: every in-flight
    collective of the old round must fail so workers fall into the
    restore/re-rendezvous path instead of hanging (reference: gloo
    context failure -> HorovodInternalError -> state.restore)."""


class StoreController:
    """One per worker process in multi-process jobs."""

    def __init__(self, addr, port, secret, proc_id, num_procs,
                 nlocal, poll_wait=5.0, round_id=0,
                 agg_addr=None, agg_port=None):
        if agg_addr is not None:
            # per-host aggregator tier: PRIMARY route is the host's
            # aggregator with a deliberately tight retry budget (a
            # silent aggregator must trigger the direct fallback in
            # seconds, not after the coordinator outage deadline);
            # the direct coordinator client keeps the
            # outage-spanning budget
            agg_client = StoreClient(agg_addr, agg_port, secret)
            fb = env_mod.get_float(
                env_mod.HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS, 5.0)
            agg_client.retry_attempts = 3
            agg_client.retry_deadline = fb
            agg_client.outage_deadline = fb
            self.client = TieredStoreClient(
                agg_client, StoreClient(addr, port, secret))
            self.client.on_route_change = self._on_route_change
        else:
            self.client = StoreClient(addr, port, secret)
        self.proc_id = proc_id
        self.num_procs = num_procs
        self.nlocal = nlocal
        self.poll_wait = poll_wait
        self.round_id = round_id
        self._cursor = 0
        self._reported = set()
        self._cache = {}      # key -> (cache_id, fingerprint)
        self._suppressed = {} # key -> full meta withheld on a cache hit
        self._lock = threading.Lock()
        self._jid = 0         # join-request id (idempotent retries)
        self._rid = 0         # ready-report id (idempotent retries)
        # session id: a NEW controller against the SAME coordinator
        # (engine shutdown + re-init without an elastic round reset)
        # must not have its reports deduplicated against the previous
        # controller's counters
        import secrets as _secrets
        self._sid = _secrets.token_hex(8)
        #: Coordinator generation (docs/fault_tolerance.md
        #: "Coordinator crash survival"): learned from poll replies,
        #: carried on every verb thereafter.  A mismatch reply means
        #: the rendezvous service restarted from its journal — one
        #: resync handshake re-registers the session instead of blind
        #: replay, then the engine drains the replayed response log
        #: and re-reports whatever is still awaiting.
        self.epoch = None
        #: aggregator generation (the second half of the
        #: (coord_epoch, agg_epoch) fence pair, docs/fault_tolerance
        #: "Per-host aggregator tier"): learned from the tier's
        #: replies, carried on every verb.  A restarted (stateless)
        #: aggregator registers a new session upstream, the
        #: coordinator bumps its agg_epoch, and this worker's first
        #: contact with the successor gets the SAME
        #: mismatch-then-resync recovery a coordinator restart does.
        #: The coordinator itself ignores the field, so a direct
        #: fallback needs no unstamping.
        self.agg_epoch = None
        self._drain_to = None
        self._rereport = False

    # -- epoch fencing -------------------------------------------------------

    def _on_route_change(self, reason):
        """TieredStoreClient switched routes (aggregator died ->
        direct, or a probe re-attached).  Either way the in-flight
        picture is unknown — the last batch may or may not have
        landed — so run the same resync + drain + re-report recovery
        an epoch bump triggers."""
        self.resync()

    def _stamp(self, payload):
        with self._lock:
            if self.epoch is not None:
                payload = {**payload, "epoch": self.epoch}
            if self.agg_epoch is not None:
                payload = {**payload, "agg_epoch": self.agg_epoch}
        return payload

    def _adopt_epochs(self, out):
        with self._lock:
            if out.get("epoch") is not None:
                self.epoch = out["epoch"]
            if out.get("agg_epoch") is not None:
                self.agg_epoch = out["agg_epoch"]

    def _coord(self, verb, payload, timeout=None, budget=None):
        """One coordinator verb with the (coord_epoch, agg_epoch)
        pair attached; handles the stale-round and epoch-mismatch
        replies in ONE place.  Either tier's fence may answer — the
        recovery is identical."""
        out = self.client.coord(verb, self._stamp(payload),
                                timeout=timeout, budget=budget)
        if out.get("stale"):
            raise StaleRoundError(
                f"coordinator moved to round {out.get('round')}")
        if out.get("epoch_mismatch"):
            self.resync()
            if verb == "ready":
                # never blind-replay a ready across an epoch bump: the
                # restarted coordinator may have scheduled these
                # entries pre-crash (the journaled log replays them).
                # Recovery is drain-then-rereport (take_rereport).
                return {}
            out = self.client.coord(verb, self._stamp(payload),
                                    timeout=timeout, budget=budget)
            if out.get("stale"):
                raise StaleRoundError(
                    f"coordinator moved to round {out.get('round')}")
            if out.get("epoch_mismatch"):
                raise HorovodInternalError(
                    "coordinator epoch moved twice within one request")
        self._adopt_epochs(out)
        return out

    def resync(self):
        """Epoch resync handshake against a restarted coordinator:
        re-register this session, adopt the new epoch, and arm the
        drain-then-rereport recovery — entries the old coordinator
        scheduled before dying arrive via the replayed log, and only
        what is STILL awaiting after the drain gets re-reported (full
        metas; the restarted response cache starts cold)."""
        out = self.client.coord("resync", {
            "proc": self.proc_id, "sid": self._sid,
            "round": self.round_id})
        if out.get("stale"):
            raise StaleRoundError(
                f"coordinator moved to round {out.get('round')}")
        with self._lock:
            self.epoch = out.get("epoch")
            self.agg_epoch = out.get("agg_epoch")
            self._drain_to = out.get("cursor", 0)
            self._rereport = True
            self._reported.clear()
            self._suppressed.clear()
            self._cache.clear()

    def take_rereport(self):
        """True ONCE per resync, and only after the replayed response
        log has been drained (cursor past the resync point) — the
        engine then re-reports every entry still awaiting."""
        with self._lock:
            if not self._rereport:
                return False
            if self._drain_to is not None \
                    and self._cursor < self._drain_to:
                return False
            self._rereport = False
            self._drain_to = None
            return True

    def bypass_ready(self, fp):
        """Vote this worker's stable cycle fingerprint (core/bypass.py
        step 1 -> 2).  Idempotent server-side; advisory here."""
        self._coord("bypass_ready", {
            "proc": self.proc_id, "round": self.round_id,
            "sid": self._sid, "fp": fp}, timeout=5.0)

    # -- reporting -----------------------------------------------------------

    def report_ready(self, metas):
        """Announce locally-ready entries (idempotent per key).  Keys
        whose params match a cached response template go out as tiny
        ``{key, c}`` records — the steady-state fast path."""
        fresh = []
        with self._lock:
            for m in metas:
                if m.get("error"):
                    # error notifications are fire-and-forget: the local
                    # handle already failed, and peers may never submit
                    # this tensor (so no response would ever clear a
                    # reported mark) — don't track, don't dedup
                    fresh.append(m)
                elif m["key"] not in self._reported:
                    self._reported.add(m["key"])
                    cached = self._cache.get(m["key"])
                    if cached is not None and \
                            m.get("type") in _CACHEABLE_TYPES and \
                            cached[1] == _fingerprint(m):
                        self._suppressed[m["key"]] = m
                        hit = {"key": m["key"], "c": cached[0]}
                        if m.get("aux"):
                            hit["aux"] = m["aux"]
                        fresh.append(hit)
                    else:
                        fresh.append(m)
        if fresh:
            self._post_ready(fresh)

    def _post_ready(self, entries):
        with self._lock:
            self._rid += 1
            rid = self._rid
        out = self._coord("ready", {
            "proc": self.proc_id, "nlocal": self.nlocal,
            "round": self.round_id, "entries": entries, "rid": rid,
            "sid": self._sid})
        uncached = out.get("uncached")
        if uncached:
            # the coordinator evicted (or never had) those cache ids:
            # resend the withheld full metas and drop the stale entries
            resend = []
            with self._lock:
                for key in uncached:
                    self._cache.pop(key, None)
                    full = self._suppressed.pop(key, None)
                    if full is not None:
                        resend.append(full)
            if resend:
                self._post_ready(resend)

    def clear_reported(self):
        """Drop ALL reported-key dedup marks.  Called by the engine
        when the bypass disengages: entries reported in the pre-arm
        race window were dropped server-side at arm time (and executed
        through the bypass), so their marks would otherwise silently
        swallow the re-report of any re-used tensor name — nothing is
        genuinely in flight at a bypass fallback."""
        with self._lock:
            self._reported.clear()
            self._suppressed.clear()

    def forget(self, key):
        """Drop a key from the reported set without a coordinator
        response.  Called by the engine whenever it removes an entry
        from ``awaiting`` through a path that will never yield a
        response for this process (stall shutdown, local validation
        failure, abort) — otherwise a later resubmission of the same
        tensor name would be silently skipped and hang the job."""
        with self._lock:
            self._reported.discard(key)
            self._suppressed.pop(key, None)

    def heartbeat(self, ranks=None, host=None, bye=False):
        """Liveness beat to the coordinator (docs/fault_tolerance.md):
        carries the global ranks this process hosts (so a later death
        is attributed to ranks, not just a proc index) and the
        hostname (so the elastic driver can blacklist the host).
        ``bye=True`` deregisters on clean shutdown.  Returns True if
        the coordinator has declared THIS process dead — the caller
        must abort and restart rather than keep computing against
        peers whose collectives were already failed."""
        payload = {"proc": self.proc_id, "round": self.round_id,
                   "sid": self._sid}
        if ranks is not None:
            payload["ranks"] = list(ranks)
        if host:
            payload["host"] = host
        if bye:
            payload["bye"] = True
        elif isinstance(self.client, TieredStoreClient):
            # the heartbeat loop is the probe clock: a fallen-back
            # worker re-pings its aggregator here and re-attaches
            # when an agg_restart brought it back
            self.client.maybe_probe()
        # the goodbye races teardown: a dead rendezvous service must
        # not wedge clean worker exit behind the outage-spanning
        # retry budget — one bounded retry, then give up
        out = self._coord("heartbeat", payload, timeout=5.0,
                          budget=(2, 3.0) if bye else None)
        return bool(out.get("dead"))

    def report_join(self, ps_id, rank, ps_size, proc_members=1):
        with self._lock:
            self._jid += 1
            jid = self._jid
        self._coord("join", {"ps": ps_id, "rank": rank,
                             "ps_size": ps_size,
                             "proc": self.proc_id,
                             "round": self.round_id,
                             "proc_members": proc_members,
                             "jid": jid, "sid": self._sid})

    # -- polling -------------------------------------------------------------

    def poll(self, wait=None):
        """Fetch responses past the cursor; returns list of response
        dicts ({kind: batch|error|join_done, ...})."""
        out = self._coord(
            "poll", {"cursor": self._cursor, "round": self.round_id,
                     "proc": self.proc_id,
                     "wait": self.poll_wait if wait is None else wait},
            timeout=(self.poll_wait if wait is None else wait) + 30)
        responses = out.get("responses", [])
        self._cursor = out.get("cursor", self._cursor)
        for j, r in enumerate(responses):
            if r.get("kind") == "bypass_arm":
                # the arm record is the coordinated mode switch: STOP
                # consuming the log exactly there, records before it
                # included.  A batch scheduled after the arm must not
                # be executed by fast pollers only (the slow ones
                # bypass those entries instead — a guaranteed
                # collective-order divergence); fencing the cursor to
                # the arm position makes every proc resume from the
                # same log point after a later fallback/resync.
                self._cursor -= len(responses) - (j + 1)
                responses = responses[:j + 1]
                break
        if responses:
            with self._lock:
                for r in responses:
                    cache_ids = r.get("cache_ids", {})
                    for k in r.get("keys", []):
                        self._reported.discard(k)
                        self._suppressed.pop(k, None)
                        cid = cache_ids.get(k)
                        meta = r.get("metas", {}).get(k)
                        if cid is not None and meta is not None and \
                                meta.get("type") in _CACHEABLE_TYPES:
                            self._cache[k] = (cid, _fingerprint(meta))
                    if "key" in r:          # error responses
                        self._reported.discard(r["key"])
                        self._suppressed.pop(r["key"], None)
                        self._cache.pop(r["key"], None)
        return responses
