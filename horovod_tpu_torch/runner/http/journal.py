"""Coordinator control-plane journal (port of
``horovod_tpu/runner/http/journal.py``).

The launcher-hosted rendezvous service holds the job's control-plane
state: joins, sessions, the ordered response log, KV entries and
liveness expectations.  The journal is a bounded append-only file of
JSON-line records of its state-changing transitions (scheduled
response-log appends, joins, session registrations, first beats and
goodbyes, KV writes under a size cap, aggregator registrations, elastic
round resets), so a restarted service
(``RendezvousServer.restart_from_journal``) rebuilds the control plane,
bumps the monotonic ``coord_epoch`` and resumes on the same port while
workers ride the negotiation bypass (core/bypass.py) or the fabric
retry path across the outage.

Deliberately not journaled: the in-flight pending table (workers
re-report it after the epoch-fenced resync handshake, see
``Coordinator._on_resync``), per-proc poll cursors (clients carry
absolute cursors; the journaled session base fences them), rid
high-waters (the epoch fence rejects cross-restart replays before any
verb runs), and the bulky ephemeral KV namespaces.

Bounding: once the file exceeds ``HOROVOD_COORD_JOURNAL_MAX_BYTES`` the
coordinator compacts it into one ``snap`` record holding the full
current state (atomic tmp-file + rename).  Appends are flushed but not
fsynced; replay drops a torn final line.
"""

import base64
import json
import logging
import os
import threading

from ...common import env as env_mod

logger = logging.getLogger("horovod_tpu_torch")

#: KV namespaces excluded from journaling: bulky, ephemeral, and
#: regenerated by workers within one push/dump interval anyway
#: (telemetry snapshot pushes, flight-recorder buffers, the data
#: service's per-step batch stream with its delete-based flow
#: control).
KV_EXCLUDE_PREFIXES = ("/telemetry/", "/trace/", "/data/")

DEFAULT_MAX_BYTES = 8 << 20
DEFAULT_KV_MAX_BYTES = 64 << 10


def _b64(value: bytes) -> str:
    return base64.b64encode(value).decode("ascii")


def _unb64(text: str) -> bytes:
    return base64.b64decode(text.encode("ascii"))


class CoordJournal:
    """Append-only JSON-line journal with size-triggered compaction.

    One instance per live coordinator; a restart builds a NEW instance
    that first ``read()``s the predecessor's records, then appends its
    own epoch-bump.  Thread-safe: appends come from the coordinator
    lock, the KV-store lock and (rarely) the compactor."""

    def __init__(self, path, max_bytes=None, kv_max_bytes=None):
        self.path = path
        self.max_bytes = int(
            max_bytes if max_bytes is not None else
            env_mod.get_int(env_mod.HOROVOD_COORD_JOURNAL_MAX_BYTES,
                            DEFAULT_MAX_BYTES))
        self.kv_max_bytes = int(
            kv_max_bytes if kv_max_bytes is not None else
            env_mod.get_int(
                env_mod.HOROVOD_COORD_JOURNAL_KV_MAX_BYTES,
                DEFAULT_KV_MAX_BYTES))
        self._lock = threading.Lock()
        self._f = None
        self._bytes = 0
        self._closed = False
        self.appended = 0

    # -- lifecycle -----------------------------------------------------------

    def read(self):
        """Parse the existing journal into a record list, starting from
        the LAST ``snap`` record (earlier history is superseded).  A
        torn final line (crash mid-append) is dropped, not fatal."""
        records = []
        if not os.path.exists(self.path):
            return records
        try:
            with open(self.path, "r") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        # torn tail from a crash mid-append: anything
                        # after it is unreachable state — stop here
                        break
                    if rec.get("k") == "snap":
                        records = [rec]
                    else:
                        records.append(rec)
        except OSError as exc:
            logger.warning("coordinator journal %s unreadable (%s); "
                           "starting empty", self.path, exc)
            return []
        return records

    def truncate(self):
        """Start a fresh journal (new job on a path holding a previous
        job's records)."""
        with self._lock:
            self._close_locked()
            with open(self.path, "w"):
                pass
            self._bytes = 0

    def _open_locked(self):
        if self._f is None:
            self._f = open(self.path, "a")
            self._bytes = self._f.tell()
        return self._f

    def _close_locked(self):
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def close(self):
        """Terminal: a closed journal never writes again.  A stale
        handler thread still finishing a request against the
        PRE-restart coordinator must not be able to append a
        pre-restart record AFTER the successor journal replayed the
        file (it would replay as a duplicate on the next restart)."""
        with self._lock:
            self._closed = True
            self._close_locked()

    # -- writing -------------------------------------------------------------

    def append(self, rec):
        """Append one record (flushed, not fsynced — crash consistency
        is best-effort by design; replay drops a torn tail)."""
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self._closed:
                return
            try:
                f = self._open_locked()
                f.write(line + "\n")
                f.flush()
                self._bytes += len(line) + 1
                self.appended += 1
            except OSError as exc:
                # a full disk must degrade crash-survival, never the
                # live control plane
                logger.warning("coordinator journal append failed: %s",
                               exc)

    def needs_compaction(self):
        with self._lock:
            return not self._closed and self._bytes > self.max_bytes

    def compact(self, snapshot):
        """Replace the journal with one ``snap`` record holding the
        coordinator's full current state (atomic rename)."""
        tmp = self.path + ".tmp"
        with self._lock:
            if self._closed:
                return
            try:
                with open(tmp, "w") as f:
                    line = json.dumps({"k": "snap", "s": snapshot},
                                      sort_keys=True)
                    f.write(line + "\n")
                os.replace(tmp, self.path)
                self._close_locked()
                self._bytes = len(line) + 1
            except OSError as exc:
                logger.warning("coordinator journal compaction failed: "
                               "%s", exc)
