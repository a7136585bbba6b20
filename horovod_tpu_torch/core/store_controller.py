"""Worker-side distributed controller: negotiation over the launcher's
HTTP coordinator (port of ``horovod_tpu/core/store_controller.py``).

Replaces the reference's controller transports
(``mpi/mpi_controller.cc`` MPI_Gatherv/Bcast, ``gloo/gloo_controller.cc``):
each worker *process* reports its locally-ready tensors to the
launcher-hosted coordinator (runner/http/http_server.py Coordinator) and
polls an ordered response log.  The log fixes the global execution
order, so every process issues the same ``torch.distributed``
collectives in the same order, as one process group needs.

The negotiation bypass's vote (``bypass_ready``) and the poll's cut at
the ``bypass_arm`` record are ported (core/bypass.py).  The JAX
package's coordinator-restart recovery (the epoch resync and the
drain-then-rereport handshake) and per-host aggregator route
(ROADMAP.md A17) are not: the port's coordinator never restarts, so
:meth:`StoreController.take_rereport` is always False.

Every request carries the elastic round (``round_id``, the round the
worker joined at the rendezvous; 0 in a static job).  A coordinator that
has moved to a newer round answers ``{"stale": true}``, which raises
:class:`StaleRoundError` (a ``HorovodInternalError``): the engine aborts,
and every pending collective of the old round fails into the elastic
restore path (store_controller.py:135-172 of the JAX package).
"""

import json
import secrets
import threading

from ..common.exceptions import HorovodInternalError
from ..runner.http.contract import CACHEABLE_TYPES as _CACHEABLE_TYPES
from ..runner.http.http_client import StoreClient


class StaleRoundError(HorovodInternalError):
    """The coordinator moved to a new elastic round: every in-flight
    collective of the old round must fail so workers fall into the
    restore/re-rendezvous path instead of hanging (reference: gloo
    context failure -> HorovodInternalError -> state.restore)."""


def _fingerprint(meta):
    """Canonical identity of a negotiation meta, aux/error excluded
    (reference response_cache.h:45-101 keys the LRU on tensor name +
    params the same way)."""
    return json.dumps(
        {k: v for k, v in meta.items() if k not in ("aux", "error")},
        sort_keys=True)


class StoreController:
    """One per worker process in multi-process jobs."""

    def __init__(self, addr, port, secret, proc_id, num_procs, nlocal,
                 poll_wait=5.0, round_id=0):
        self.client = StoreClient(addr, port, secret)
        self.proc_id = proc_id
        self.num_procs = num_procs
        self.nlocal = nlocal
        self.poll_wait = poll_wait
        #: the launcher's elastic round (0 in a static job)
        self.round_id = round_id
        self._cursor = 0
        self._reported = set()
        self._cache = {}      # key -> (cache_id, fingerprint)
        self._suppressed = {}  # key -> full meta withheld on a cache hit
        self._lock = threading.Lock()
        self._jid = 0         # join-request id (idempotent retries)
        self._rid = 0         # ready-report id (idempotent retries)
        # session id: a NEW controller against the SAME coordinator
        # (engine shutdown + re-init) must not have its reports
        # deduplicated against the previous controller's counters
        self._sid = secrets.token_hex(8)

    def _coord(self, verb, payload, timeout=None, budget=None):
        """One coordinator verb stamped with this worker's round; a
        stale-round reply raises :class:`StaleRoundError`."""
        out = self.client.coord(verb, {**payload, "round": self.round_id},
                                timeout=timeout, budget=budget)
        if out.get("stale"):
            raise StaleRoundError(
                f"coordinator moved to round {out.get('round')}")
        return out

    # -- the negotiation bypass ----------------------------------------------

    def take_rereport(self):
        """True once per coordinator-restart resync, after the replayed
        log drained (the JAX package's recovery).  The port's coordinator
        never restarts (ROADMAP.md A17), so there is nothing to
        re-report."""
        return False

    def bypass_ready(self, fp):
        """Vote this worker's stable cycle fingerprint (core/bypass.py
        step 1 -> 2).  Idempotent on the coordinator; advisory here."""
        self._coord("bypass_ready", {
            "proc": self.proc_id, "sid": self._sid, "fp": fp}, timeout=5.0)

    def clear_reported(self):
        """Drop every reported-key mark.  The engine calls it when the
        bypass disengages: entries reported in the race window before the
        arm were dropped by the coordinator at arm time (and ran through
        the bypass), so their marks would otherwise swallow the re-report
        of a re-used tensor name; nothing is in flight at a fallback."""
        with self._lock:
            self._reported.clear()
            self._suppressed.clear()

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
            "entries": entries, "rid": rid, "sid": self._sid})
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
        """Liveness beat to the coordinator: carries the global ranks
        this process hosts (so a later death is attributed to ranks)
        and the hostname.  ``bye=True`` deregisters on clean shutdown.
        Returns True if the coordinator has declared THIS process dead
        — the caller must abort rather than keep computing against
        peers whose collectives were already failed."""
        payload = {"proc": self.proc_id, "sid": self._sid}
        if ranks is not None:
            payload["ranks"] = list(ranks)
        if host:
            payload["host"] = host
        if bye:
            payload["bye"] = True
        # the goodbye races teardown: a dead rendezvous service must
        # not wedge clean worker exit behind the outage-spanning retry
        # budget — one bounded retry, then give up
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
                                   "proc_members": proc_members,
                                   "jid": jid, "sid": self._sid})

    # -- polling -------------------------------------------------------------

    def poll(self, wait=None):
        """Fetch responses past the cursor; returns list of response
        dicts ({kind: batch|error|join_done|stall|dead|bypass_arm,
        ...}), cut after a ``bypass_arm`` record."""
        wait = self.poll_wait if wait is None else wait
        out = self._coord(
            "poll", {"cursor": self._cursor, "proc": self.proc_id,
                     "wait": wait},
            timeout=wait + 30)
        responses = out.get("responses", [])
        self._cursor = out.get("cursor", self._cursor)
        for j, r in enumerate(responses):
            if r.get("kind") == "bypass_arm":
                # the arm record is the coordinated mode switch: stop
                # consuming the log exactly there.  A batch scheduled after
                # it must not run on the fast pollers only (the slow ones
                # bypass those entries instead, and the collective orders
                # diverge); the cursor fenced at the arm makes every
                # process resume from the same point after a fallback
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
