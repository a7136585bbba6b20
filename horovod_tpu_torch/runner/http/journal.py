"""Coordinator control-plane journal (port of
``horovod_tpu/runner/http/journal.py``, as far as the coordinator writes
it): a bounded append-only file of JSON-line records of the coordinator's
state-changing transitions (response-log appends, joins, session
registrations, first beats and goodbyes, small KV writes), enabled by
``HOROVOD_COORD_JOURNAL``.  Replaying it into a restarted coordinator
(``restart_from_journal``/``restore_journal``) and compacting it are
ROADMAP.md A17 and not ported.
"""

import base64
import json
import logging
import threading

logger = logging.getLogger("horovod_tpu_torch")

#: KV namespaces excluded from journaling: bulky, ephemeral, and
#: regenerated by workers within one push/dump interval anyway
#: (telemetry snapshot pushes, flight-recorder buffers, the data
#: service's per-step batch stream with its delete-based flow
#: control).
KV_EXCLUDE_PREFIXES = ("/telemetry/", "/trace/", "/data/")

#: KV values larger than this are not journaled
KV_MAX_BYTES = 64 << 10


def _b64(value: bytes) -> str:
    return base64.b64encode(value).decode("ascii")


class CoordJournal:
    """Append-only JSON-line journal, one instance per live coordinator.
    Thread-safe: appends come from the coordinator lock and the KV-store
    lock."""

    def __init__(self, path):
        self.path = path
        self._lock = threading.Lock()  # hvdlint: lock[journal:2]
        self._f = None
        self._closed = False
        self.appended = 0

    # -- lifecycle -----------------------------------------------------------

    def truncate(self):
        """Start a fresh journal (new job on a path holding a previous
        job's records)."""
        with self._lock:
            self._close_locked()
            with open(self.path, "w"):
                pass

    def _open_locked(self):
        if self._f is None:
            self._f = open(self.path, "a")
        return self._f

    def _close_locked(self):
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def close(self):
        """Terminal: a closed journal never writes again (a handler
        thread still finishing a request after the server stopped must
        not append)."""
        with self._lock:
            self._closed = True
            self._close_locked()

    # -- writing -------------------------------------------------------------

    def append(self, rec):
        """Append one record (flushed, not fsynced)."""
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._closed:
                return
            try:
                f = self._open_locked()
                f.write(line + "\n")
                f.flush()
                self.appended += 1
            except OSError as exc:
                # a full disk must never fail the live control plane
                logger.warning("coordinator journal append failed: %s",
                               exc)
