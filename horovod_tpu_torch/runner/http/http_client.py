"""Client for the launcher's KV/coordinator service (port of
``horovod_tpu/runner/http/http_client.py``; reference
``horovod/runner/http/http_client.py``: read/write/delete KV helpers).

Connections are persistent (HTTP/1.1 keep-alive, one per thread): the
multi-process hot path issues a ready-POST and a poll per negotiation
cycle, and a fresh TCP handshake per request would dominate small-op
latency.

Transient fabric failures (dropped keep-alives, a coordinator
restarting, a 5xx burst) retry with bounded exponential backoff and
jitter (``HOROVOD_FABRIC_RETRY_ATTEMPTS`` /
``HOROVOD_FABRIC_RETRY_DEADLINE_SECONDS``); connection failures, which
mean the server is gone, keep retrying up to the coordinator-outage
budget (``HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS``, default 120 s), so a
worker rides out a coordinator restart.  A ``TimeoutError`` is retried
only on the verbs whose server-side handling is deduplicated by a
client-supplied id (ready/join via rid/jid) or naturally idempotent
(heartbeat): replaying anything else could double-deliver.  The chaos
subsystem's fault middleware (chaos/inject.py) hooks in right before the
wire, so injected faults exercise exactly this machinery.
``TieredStoreClient`` is the per-host aggregator route with its direct
fallback (aggregator.py).
"""

import base64
import collections
import hashlib
import hmac
import http.client
import json
import logging
import pickle
import random
import threading
import time

from ... import telemetry
from ...common import env as env_mod


class _HTTPError(Exception):
    def __init__(self, code, msg=""):
        super().__init__(f"HTTP {code} {msg}")
        self.code = code


class _DroppedRequest(ConnectionError):
    """Chaos middleware swallowed the request before the wire — the
    client-visible symptom of a lost packet/connection."""


from .contract import REPLAY_SAFE_VERBS

logger = logging.getLogger("horovod_tpu_torch")


class StoreClient:
    def __init__(self, addr: str, port: int, secret: bytes = None,
                 timeout: float = 30.0):
        self.addr = addr
        self.port = port
        self.secret = secret
        self.timeout = timeout
        self._tls = threading.local()
        #: coordinator requests sent, per verb (each logical request once,
        #: retries not counted): what a step costs the control plane
        self.coord_requests = collections.Counter()
        #: retries, per verb label (also counted into the registry's
        #: ``horovod_fabric_retries_total{verb}``, :meth:`_count_retry`)
        self.retries = collections.Counter()
        #: chaos fault middleware (chaos/inject.py FaultInjector); its
        #: ``before_request(method, path)`` may drop, delay, duplicate
        #: or synthesize an HTTP error before the wire
        self.middleware = None
        # retry budget: attempts AND a wall deadline bound every
        # request's total retry time (env-tunable; docs/fault_tolerance)
        self.retry_attempts = env_mod.get_int(
            env_mod.HOROVOD_FABRIC_RETRY_ATTEMPTS, 8)
        self.retry_deadline = env_mod.get_float(
            env_mod.HOROVOD_FABRIC_RETRY_DEADLINE_SECONDS, 30.0)
        # coordinator-outage budget (docs/fault_tolerance.md
        # "Coordinator crash survival"): CONNECTION-SHAPE failures —
        # the server is gone, the request never completed server-side,
        # so replay is safe on every verb — and safe-timeout replays
        # keep retrying up to this wall deadline instead of the per-
        # request one, spanning a rendezvous-service restart.  5xx
        # keeps the tight budget: a server answering sick is not an
        # outage.
        self.outage_deadline = env_mod.get_float(
            env_mod.HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS, 120.0)
        self._retry_base = 0.05     # first backoff step (seconds)
        self._retry_cap = 2.0       # per-step ceiling

    # -- connection management ----------------------------------------------

    def _conn(self, timeout):
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(self.addr, self.port,
                                              timeout=timeout)
            self._tls.conn = conn
        elif conn.sock is not None:
            # adjust the live socket instead of reconnecting: the hot
            # path alternates ready-POST (default timeout) with
            # long-poll (larger timeout) on the same connection
            conn.sock.settimeout(timeout)
        else:
            conn.timeout = timeout
        return conn

    def _drop_conn(self):
        conn = getattr(self._tls, "conn", None)
        if conn is not None:
            conn.close()
        self._tls.conn = None
        self._tls.timeout = None

    # Connection-shape failures: safe to replay on every verb (the
    # request never completed server-side, or the verb is idempotent /
    # id-deduplicated).  A TIMEOUT is retried only for
    # REPLAY_SAFE_VERBS — the request may still be processing
    # server-side, so re-sending anything else could double-deliver.
    _RETRYABLE = (http.client.RemoteDisconnected,
                  http.client.CannotSendRequest,
                  http.client.BadStatusLine,
                  ConnectionResetError, ConnectionRefusedError,
                  ConnectionAbortedError, BrokenPipeError,
                  _DroppedRequest)

    def _count_retry(self, verb):
        """One retry attempt: the client's own count, and the registry's
        (resolved per call: the client outlives an engine's registry)."""
        self.retries[verb] += 1
        telemetry.count_fabric_retry(verb)

    def _backoff(self, attempt):
        """Exponential backoff with jitter, capped per step."""
        step = min(self._retry_cap, self._retry_base * (2 ** attempt))
        time.sleep(step * (0.5 + random.random()))

    def _send_once(self, method, path, body, headers, timeout,
                   duplicate=False):
        conn = self._conn(timeout)
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        if duplicate:
            # chaos 'duplicate': re-send the identical request on the
            # same connection (a replayed POST after a dropped
            # keep-alive) and serve the replay's response — the
            # server's rid/jid dedup is what keeps this harmless
            conn.request(method, path, body=body or None,
                         headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        return resp.status, data

    def _request(self, method, path, body=b"", timeout=None,
                 verb=None, retry_timeout=False, budget=None):
        """One logical request with bounded retries.  ``verb`` labels
        the retry counter; ``retry_timeout`` opts the verb into
        TimeoutError replays (REPLAY_SAFE_VERBS only).  ``budget`` is
        an explicit ``(attempts, seconds)`` override that ALSO caps
        the outage deadline — teardown-path callers (final metrics
        push, heartbeat bye) use it so a dead coordinator can never
        wedge a clean worker exit."""
        timeout = timeout or self.timeout
        verb = verb or method.lower()
        headers = dict(self._auth_headers(body))
        if body:
            headers["Content-Type"] = "application/json"
        attempts, deadline_s = budget or (self.retry_attempts,
                                          self.retry_deadline)
        start = time.monotonic()
        deadline = start + deadline_s
        # connection-shape failures (and safe-timeout replays) span a
        # coordinator outage: the server is down/restarting, not
        # answering sick, so keep retrying up to the outage deadline —
        # unless the caller pinned an explicit budget
        outage_deadline = start + (deadline_s if budget is not None
                                   else max(deadline_s,
                                            self.outage_deadline))
        attempt = 0
        while True:
            exhausted = (attempt + 1 >= max(attempts, 1)
                         or time.monotonic() > deadline)
            try:
                action = None
                mw = self.middleware
                if mw is not None:
                    action = mw.before_request(method, path)
                if action is not None and action[0] == "drop":
                    raise _DroppedRequest(
                        f"chaos: dropped {method} {path}")
                if action is not None and action[0] == "error":
                    status, data = action[1], b"chaos: injected error"
                else:
                    if action is not None and action[0] == "delay":
                        time.sleep(action[1])
                    status, data = self._send_once(
                        method, path, body, headers, timeout,
                        duplicate=(action is not None
                                   and action[0] == "duplicate"))
                if status >= 500 and not exhausted:
                    # transient server failure (restart, overload,
                    # injected burst): the response was fully read, so
                    # the keep-alive connection stays usable
                    self._count_retry(verb)
                    self._backoff(attempt)
                    attempt += 1
                    continue
                return status, data
            except TimeoutError:
                self._drop_conn()
                if not retry_timeout \
                        or time.monotonic() > outage_deadline:
                    raise
            except self._RETRYABLE:
                # stale keep-alive, server restart, or injected drop:
                # reconnect and replay under the outage deadline (the
                # request never completed server-side, so replay is
                # safe on every verb)
                self._drop_conn()
                if attempt == 0:
                    # the first connection-shape failure is routinely
                    # just an idle-closed keep-alive: reconnect and
                    # replay IMMEDIATELY, even past the deadline (a
                    # long-poll GET can outlive it legitimately) —
                    # the pre-backoff code's unconditional single
                    # reconnect, preserved.  Waiting is for servers
                    # that answered sick, not for a dropped socket.
                    self._count_retry(verb)
                    attempt = 1
                    continue
                if time.monotonic() > outage_deadline:
                    raise
            self._count_retry(verb)
            self._backoff(attempt)
            attempt += 1

    def _auth_headers(self, body: bytes):
        if self.secret is None:
            return {}
        digest = hmac.new(self.secret, body, hashlib.sha256).hexdigest()
        return {"X-HVD-Auth": digest}

    # -- API -----------------------------------------------------------------

    def put(self, key: str, value: bytes, budget=None):
        # KV puts are last-writer-wins: replaying a timed-out put is
        # safe, so the full retry surface applies.  ``budget`` caps
        # the retries for teardown-path callers (final metrics push).
        status, _ = self._request("PUT", key, value, verb="kv_put",
                                  retry_timeout=True, budget=budget)
        if status != 200:
            raise _HTTPError(status, f"PUT {key}")

    def get(self, key: str, wait: float = 0.0):
        path = key + (f"?wait={wait}" if wait else "")
        status, data = self._request(
            "GET", path, timeout=max(self.timeout, wait + 5),
            verb="kv_get", retry_timeout=True)
        if status == 404:
            return None
        if status != 200:
            raise _HTTPError(status, f"GET {key}")
        return data

    def delete(self, key: str):
        status, _ = self._request("DELETE", key, verb="kv_delete")
        if status != 200:
            raise _HTTPError(status, f"DELETE {key}")

    def coord(self, verb: str, payload: dict, timeout: float = None,
              budget=None):
        body = json.dumps(payload).encode()
        self.coord_requests[verb] += 1
        status, data = self._request(
            "POST", f"/coord/{verb}", body, timeout=timeout, verb=verb,
            # ready/join are rid/jid-deduplicated server-side and
            # heartbeat is naturally idempotent: a slow reply on those
            # POSTs is retried instead of killing the job
            retry_timeout=verb in REPLAY_SAFE_VERBS, budget=budget)
        if status != 200:
            raise _HTTPError(status, f"coord/{verb}: "
                                     f"{data[:200].decode(errors='replace')}")
        return json.loads(data or b"{}")


class TieredStoreClient:
    """Two-route fabric client for the per-host aggregator tier
    (docs/fault_tolerance.md "Per-host aggregator tier"): the PRIMARY
    route is the host's aggregator, the FALLBACK the coordinator
    itself.  An aggregator that stops answering — connection refused,
    timeout, or a 5xx it returns when IT cannot reach upstream —
    triggers a one-way switch to direct mode for this worker:
    degradation, never deadlock.  The aggregator client's retry
    budget is pinned tight (``HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS``)
    so the fallback fires in seconds, while the direct client keeps
    the coordinator-outage-spanning budget.

    ``maybe_probe()`` (clocked by the engine's heartbeat loop)
    re-pings a fallen-back aggregator occasionally and re-attaches
    when it answers — an ``agg_restart`` heals back to the batched
    path without a round reset.  Route changes invoke
    ``on_route_change(reason)`` so the StoreController can run its
    resync handshake: falling back (or re-attaching) mid-stream is
    recovered exactly like an epoch bump — resync, drain, re-report."""

    #: seconds between re-attach probes after a fallback
    PROBE_SECS = 10.0

    def __init__(self, agg_client: StoreClient,
                 direct_client: StoreClient):
        self.agg = agg_client
        self.direct = direct_client
        self.via_agg = True
        self.on_route_change = None
        self._route_lock = threading.Lock()
        self._fell_back_at = None

    # chaos middleware rides BOTH routes (one injector, one request
    # counter — the deterministic trigger stream must not depend on
    # which route a request took)
    @property
    def middleware(self):
        return self.direct.middleware

    @middleware.setter
    def middleware(self, mw):
        self.agg.middleware = mw
        self.direct.middleware = mw

    @property
    def coord_requests(self):
        """Coordinator-verb requests sent on both routes, per verb."""
        return self.agg.coord_requests + self.direct.coord_requests

    @staticmethod
    def _falls_back(exc):
        if isinstance(exc, _HTTPError):
            return exc.code >= 500
        return isinstance(exc, (OSError, TimeoutError,
                                http.client.HTTPException))

    def _call(self, name, args, kwargs):
        primary = self.agg if self.via_agg else self.direct
        try:
            return getattr(primary, name)(*args, **kwargs)
        except Exception as exc:  # noqa: BLE001 — classified below
            if primary is not self.agg or not self._falls_back(exc):
                raise
            self._fall_back(exc)
            return getattr(self.direct, name)(*args, **kwargs)

    def coord(self, verb, payload, timeout=None, budget=None):
        return self._call("coord", (verb, payload),
                          {"timeout": timeout, "budget": budget})

    def put(self, key, value, budget=None):
        return self._call("put", (key, value), {"budget": budget})

    def get(self, key, wait=0.0):
        return self._call("get", (key,), {"wait": wait})

    def delete(self, key):
        return self._call("delete", (key,), {})

    def _fall_back(self, exc):
        with self._route_lock:
            if not self.via_agg:
                return
            self.via_agg = False
            self._fell_back_at = time.monotonic()
        logger.warning(
            "aggregator route failed (%s: %s); falling back to "
            "direct coordinator mode", type(exc).__name__, exc)
        telemetry.count_agg_fallback("direct")
        self._notify("direct")

    def maybe_probe(self):
        """Probe a fallen-back aggregator (bounded, spaced) and
        re-attach when it answers.  Returns True on a re-attach."""
        with self._route_lock:
            if self.via_agg or self._fell_back_at is None or \
                    time.monotonic() - self._fell_back_at < \
                    self.PROBE_SECS:
                return False
            self._fell_back_at = time.monotonic()   # space the probes
        try:
            self.agg.coord("clock", {}, timeout=2.0, budget=(1, 2.5))
        except Exception:  # noqa: BLE001 — still down; stay direct
            return False
        with self._route_lock:
            self.via_agg = True
        logger.warning(
            "aggregator answering again; re-attaching to the "
            "batched control-plane route")
        telemetry.count_agg_fallback("reattach")
        self._notify("reattach")
        return True

    def _notify(self, reason):
        cb = self.on_route_change
        if cb is None:
            return
        try:
            cb(reason)
        except Exception:  # noqa: BLE001 — the route change already
            # happened; the controller's next fenced verb recovers
            pass


# -- reference-shaped module functions (horovod/runner/http/http_client.py
#    read_data_from_kvstore :22 / put_data_into_kvstore :35).  Values are
#    base64-encoded pickles; the signing key comes from HOROVOD_SECRET_KEY
#    when the server enforces HMAC. -------------------------------------------

def _env_secret():
    secret_hex = env_mod.get_str(env_mod.HOROVOD_SECRET_KEY)
    try:
        return bytes.fromhex(secret_hex) if secret_hex else None
    except ValueError:
        return None


def read_data_from_kvstore(addr, port, scope, key):
    try:
        client = StoreClient(addr, port, _env_secret())
        raw = client.get(f"/{scope}/{key}")
    except Exception as e:  # noqa: BLE001 — reference raises RuntimeError
        raise RuntimeError("Read data from KVStore server failed.", e)
    if raw is None:
        raise RuntimeError(
            f"Read data from KVStore server failed: no value at "
            f"/{scope}/{key}")
    return pickle.loads(base64.b64decode(raw))


def put_data_into_kvstore(addr, port, scope, key, value):
    try:
        client = StoreClient(addr, port, _env_secret())
        client.put(f"/{scope}/{key}", base64.b64encode(pickle.dumps(value)))
    except Exception as e:  # noqa: BLE001 — reference raises RuntimeError
        raise RuntimeError("Put data input KVStore server failed.", e)
