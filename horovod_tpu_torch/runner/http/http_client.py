"""Client for the launcher's KV/coordinator service (port of
``horovod_tpu/runner/http/http_client.py``; reference
``horovod/runner/http/http_client.py``: read/write/delete KV helpers).

Connections are persistent (HTTP/1.1 keep-alive, one per thread): the
multi-process hot path issues a ready-POST and a poll per negotiation
cycle, and a fresh TCP handshake per request would dominate small-op
latency.

Transient fabric failures (dropped keep-alives, a 5xx burst) retry with
bounded exponential backoff and jitter.  The JAX package's budgets for
riding out a coordinator restart (``HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS``)
are A17's: the port's coordinator never restarts.  A ``TimeoutError`` is
retried only on the verbs whose server-side handling is deduplicated by a
client-supplied id (ready/join via rid/jid) or naturally idempotent
(heartbeat): replaying anything else could double-deliver.  The JAX
package's per-host aggregator route (``TieredStoreClient``) and chaos
middleware are ROADMAP.md A17.
"""

import base64
import hashlib
import hmac
import http.client
import json
import pickle
import random
import threading
import time

from ...common import env as env_mod
from .contract import REPLAY_SAFE_VERBS


#: every request's retry budget: attempts and a wall deadline (the JAX
#: package's defaults), and the backoff's first step and ceiling
RETRY_ATTEMPTS = 8
RETRY_DEADLINE_S = 30.0
RETRY_BASE_S = 0.05
RETRY_STEP_CAP_S = 2.0


class _HTTPError(Exception):
    def __init__(self, code, msg=""):
        super().__init__(f"HTTP {code} {msg}")
        self.code = code


class StoreClient:
    def __init__(self, addr: str, port: int, secret: bytes = None,
                 timeout: float = 30.0):
        self.addr = addr
        self.port = port
        self.secret = secret
        self.timeout = timeout
        self._tls = threading.local()

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
                  ConnectionAbortedError, BrokenPipeError)

    @staticmethod
    def _backoff(attempt):
        """Exponential backoff with jitter, capped per step."""
        step = min(RETRY_STEP_CAP_S, RETRY_BASE_S * (2 ** attempt))
        time.sleep(step * (0.5 + random.random()))

    def _send_once(self, method, path, body, headers, timeout):
        conn = self._conn(timeout)
        conn.request(method, path, body=body or None, headers=headers)
        resp = conn.getresponse()
        return resp.status, resp.read()

    def _request(self, method, path, body=b"", timeout=None,
                 retry_timeout=False, budget=None):
        """One logical request with bounded retries: ``RETRY_ATTEMPTS``
        and ``RETRY_DEADLINE_S``, or ``budget = (attempts, seconds)``
        (the heartbeat goodbye's short one, so a dead coordinator never
        wedges a clean exit).  ``retry_timeout`` opts the verb into
        TimeoutError replays (REPLAY_SAFE_VERBS only)."""
        timeout = timeout or self.timeout
        headers = dict(self._auth_headers(body))
        if body:
            headers["Content-Type"] = "application/json"
        attempts, deadline_s = budget or (RETRY_ATTEMPTS, RETRY_DEADLINE_S)
        deadline = time.monotonic() + deadline_s
        attempt = 0
        while True:
            exhausted = (attempt + 1 >= max(attempts, 1)
                         or time.monotonic() > deadline)
            try:
                status, data = self._send_once(method, path, body,
                                               headers, timeout)
                if status >= 500 and not exhausted:
                    # transient server failure (overload): the response
                    # was fully read, so the keep-alive connection stays
                    # usable
                    self._backoff(attempt)
                    attempt += 1
                    continue
                return status, data
            except TimeoutError:
                self._drop_conn()
                if not retry_timeout or exhausted:
                    raise
            except self._RETRYABLE:
                # a stale keep-alive: the request never completed
                # server-side, so replay is safe on every verb
                self._drop_conn()
                if attempt == 0:
                    # the first connection-shape failure is routinely an
                    # idle-closed keep-alive: reconnect and replay at
                    # once, even past the deadline (a long poll can
                    # outlive it legitimately)
                    attempt = 1
                    continue
                if exhausted:
                    raise
            self._backoff(attempt)
            attempt += 1

    def _auth_headers(self, body: bytes):
        if self.secret is None:
            return {}
        digest = hmac.new(self.secret, body, hashlib.sha256).hexdigest()
        return {"X-HVD-Auth": digest}

    # -- API -----------------------------------------------------------------

    def put(self, key: str, value: bytes):
        # KV puts are last-writer-wins: replaying a timed-out put is
        # safe, so the full retry surface applies
        status, _ = self._request("PUT", key, value, retry_timeout=True)
        if status != 200:
            raise _HTTPError(status, f"PUT {key}")

    def get(self, key: str, wait: float = 0.0):
        path = key + (f"?wait={wait}" if wait else "")
        status, data = self._request(
            "GET", path, timeout=max(self.timeout, wait + 5),
            retry_timeout=True)
        if status == 404:
            return None
        if status != 200:
            raise _HTTPError(status, f"GET {key}")
        return data

    def delete(self, key: str):
        status, _ = self._request("DELETE", key)
        if status != 200:
            raise _HTTPError(status, f"DELETE {key}")

    def coord(self, verb: str, payload: dict, timeout: float = None,
              budget=None):
        body = json.dumps(payload).encode()
        status, data = self._request(
            "POST", f"/coord/{verb}", body, timeout=timeout,
            # ready/join are rid/jid-deduplicated server-side and
            # heartbeat is naturally idempotent: a slow reply on those
            # POSTs is retried instead of killing the job
            retry_timeout=verb in REPLAY_SAFE_VERBS, budget=budget)
        if status != 200:
            raise _HTTPError(status, f"coord/{verb}: "
                                     f"{data[:200].decode(errors='replace')}")
        return json.loads(data or b"{}")


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
