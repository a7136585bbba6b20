"""Worker-side host-update notifications (port of
``horovod_tpu/runner/elastic/worker.py``; reference
``horovod/runner/elastic/worker.py:32-119``
WorkerNotificationService/Manager, driver -> worker push).

The live channel is the launcher's KV store: the driver bumps a version
under ``/elastic/notify`` with every new round; a daemon thread polls it
and feeds the registered ``State`` listeners, which raise
``HostsUpdatedInterrupt`` at the next ``state.commit()``.  A new round
also ends this process's old one at once (:func:`_end_round`): the
coordinator answers the old round's requests ``{"stale": true}`` anyway,
but a worker armed on the negotiation bypass sends none, and would wait
in its vote for a peer that already left.
"""

import json
import logging
import threading
import time

from ...common import env as env_mod

logger = logging.getLogger("horovod_tpu_torch.elastic")

NOTIFY_KEY = "/elastic/notify"


def _end_round(round_id):
    """Abort this process's engine if it still serves a round older than
    ``round_id``: its pending collectives fail into the elastic restore
    path."""
    from ...common import basics
    from ...core.store_controller import StaleRoundError

    eng = basics._engine
    ctl = getattr(eng, "controller", None)
    if ctl is not None and round_id is not None and ctl.round_id < round_id:
        eng.abort(StaleRoundError(
            f"the elastic driver started round {round_id}"))


def _joined(info):
    from ...common import basics
    return info.get("round") is not None and \
        info["round"] <= basics._elastic_round


class WorkerNotificationManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._listeners = set()
        self._thread = None
        self._stop = threading.Event()
        self._seen_version = 0

    def init(self):
        with self._lock:
            if self._thread is not None:
                return
            if not env_mod.get_bool(env_mod.HOROVOD_ELASTIC):
                return
            addr = env_mod.get_str(env_mod.HOROVOD_RENDEZVOUS_ADDR)
            port = env_mod.get_int(env_mod.HOROVOD_RENDEZVOUS_PORT, 0)
            if not addr or not port:
                return
            secret = env_mod.get_str(env_mod.HOROVOD_SECRET_KEY)
            from ..http.http_client import StoreClient
            self._client = StoreClient(
                addr, port, bytes.fromhex(secret) if secret else None)
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True,
                name="hvd-notification")
            self._thread.start()

    def register_listener(self, listener):
        with self._lock:
            self._listeners.add(listener)

    def remove_listener(self, listener):
        with self._lock:
            self._listeners.discard(listener)

    def _poll_loop(self):
        while not self._stop.is_set():
            try:
                raw = self._client.get(NOTIFY_KEY, wait=5.0)
            except Exception:  # noqa: BLE001 — launcher went away
                time.sleep(1.0)
                continue
            if raw is None:
                continue
            try:
                info = json.loads(raw)
            except ValueError:
                continue
            version = info.get("version", 0)
            if version > self._seen_version:
                if self._seen_version != 0 and not _joined(info):
                    # version 0 -> first is the initial round, not a
                    # change; and a round this process already joined
                    # (its reset outran this thread) is no news
                    self.handle_hosts_updated(time.time(),
                                              info.get("round"))
                    _end_round(info.get("round"))
                self._seen_version = version
            else:
                time.sleep(0.5)

    def handle_hosts_updated(self, timestamp, update_res):
        """Direct dispatch (reference worker.py:85): the path the TCP
        WorkerNotificationService below uses too."""
        with self._lock:
            listeners = list(self._listeners)
        for listener in listeners:
            try:
                listener.on_hosts_updated(timestamp, update_res)
            except Exception:  # noqa: BLE001
                logger.exception("listener failed")


notification_manager = WorkerNotificationManager()


# -- reference-shaped surface (horovod/runner/elastic/worker.py) -------------
#
# The live notification channel above is the KV-store push.  The
# reference's TCP notification service is also provided, over the
# runner's pickled-message services (runner/common/util/network.py), for
# tooling that drives workers through it directly.

from enum import IntFlag  # noqa: E402

from ..common.util import network as _network  # noqa: E402

HOROVOD_GLOO_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_GLOO_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_GLOO_IFACE = "HOROVOD_GLOO_IFACE"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"


class HostUpdateResult(IntFlag):
    no_update = 0
    removed = 1
    added = 2
    mixed = removed | added


class HostsUpdatedRequest:
    """Driver -> worker: available hosts/slots changed (reference
    worker.py:38)."""

    def __init__(self, timestamp, res=HostUpdateResult.no_update):
        self.timestamp = timestamp
        self.res = res


class WorkerNotificationService(_network.BasicService):
    NAME = "worker notification service"

    def __init__(self, key, nic, manager):
        super().__init__(WorkerNotificationService.NAME, key,
                         [nic] if nic else None)
        self._manager = manager

    def _handle(self, req, client_address):
        if isinstance(req, HostsUpdatedRequest):
            self._manager.handle_hosts_updated(req.timestamp, req.res)
            return _network.AckResponse()
        return super()._handle(req, client_address)


class WorkerNotificationClient(_network.BasicClient):
    def __init__(self, addresses, key, verbose=0, match_intf=False):
        super().__init__(WorkerNotificationService.NAME, addresses,
                         key, verbose, match_intf=match_intf)

    def notify_hosts_updated(self, timestamp, update_res):
        self._send(HostsUpdatedRequest(timestamp, update_res))
