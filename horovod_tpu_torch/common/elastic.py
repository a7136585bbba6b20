"""Elastic training core: State commit/restore/sync and the retry loop
(port of ``horovod_tpu/common/elastic.py``; reference
``horovod/common/elastic.py``: State :26, ObjectState :116, run_fn :151).

A worker wraps its training function with ``run_fn``.  On
``HorovodInternalError`` (a peer died, or the driver moved the job to a
new round) the last committed state is restored and the job
re-rendezvouses; on ``HostsUpdatedInterrupt`` (raised at a commit after
the driver published a new round) the current state is kept and the
ranks re-sync.  ``reset`` tears the engine and its process group down
and re-initializes against the new round.
"""

import functools
import logging
import os
import pickle
import queue
import struct
import tempfile
import zlib

from . import env
from .exceptions import HorovodInternalError, HostsUpdatedInterrupt

logger = logging.getLogger("horovod_tpu_torch")

#: the spill's trailer: magic, then (payload length, CRC-32) as <QI>
#: (core/integrity.py:480-533 of the JAX package)
TRAILER_MAGIC = b"HVDCRC1\n"
_TRAILER_LEN = len(TRAILER_MAGIC) + 12


class TrailerCorruptionError(RuntimeError):
    """A CRC-trailed payload failed verification; ``kind`` is
    ``"truncated"`` (length mismatch: a torn write) or ``"mismatch"``
    (the CRC disagrees: corrupted bytes)."""

    def __init__(self, message, kind):
        super().__init__(message)
        self.kind = kind


def append_crc_trailer(data: bytes) -> bytes:
    """``payload + magic + (length, crc32)``.  Pickle readers stop at the
    end of their stream, so a loader that knows no trailer ignores it."""
    return data + TRAILER_MAGIC + struct.pack(
        "<QI", len(data), zlib.crc32(data) & 0xFFFFFFFF)


def strip_crc_trailer(data: bytes) -> bytes:
    """Verify and strip: the payload of a trailed blob after checking its
    length and CRC (raises :class:`TrailerCorruptionError`), or the input
    unchanged when it has no trailer."""
    if len(data) < _TRAILER_LEN or \
            data[-_TRAILER_LEN:-12] != TRAILER_MAGIC:
        return data
    n, crc = struct.unpack("<QI", data[-12:])
    payload = data[:-_TRAILER_LEN]
    if n != len(payload):
        raise TrailerCorruptionError(
            f"CRC-trailed payload is torn: trailer records {n} bytes, "
            f"file holds {len(payload)}", kind="truncated")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise TrailerCorruptionError(
            "CRC-trailed payload failed checksum verification (bit "
            "corruption in the stored bytes)", kind="mismatch")
    return payload


def _spill_path():
    """Per-worker state spill file.  The elastic driver sets
    ``HOROVOD_STATE_SPILL`` to a job directory; committed state is
    mirrored there so recovery survives a *process* restart (the
    exec-restart of a worker whose teardown wedged)."""
    d = env.get_str(env.HOROVOD_STATE_SPILL)
    if not d:
        return None
    host = env.get_str(env.HOROVOD_HOSTNAME, "localhost")
    slot = env.get_int(env.HOROVOD_LOCAL_RANK, 0)
    return os.path.join(d, f"state_{host}_{slot}.pkl")


def _count_commit():
    """One elastic commit.  The JAX package counts it into its telemetry
    registry, the training goodput its fleet controller aggregates; the
    port has no telemetry registry yet (ROADMAP.md A17's telemetry item),
    so there is nothing to count into."""


class State:
    """Base class: save/restore/sync plus registered reset callbacks
    (reference common/elastic.py:26-98)."""

    def __init__(self, **kwargs):
        self._host_messages = queue.Queue()
        self._last_updated_timestamp = 0
        self._reset_callbacks = []
        self._maybe_unspill()

    def register_reset_callbacks(self, callbacks):
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        self._host_messages = queue.Queue()
        self.reset()
        for callback in self._reset_callbacks:
            callback()

    def on_hosts_updated(self, timestamp, update_res):
        self._host_messages.put((timestamp, update_res))

    def commit(self):
        """Save, spill, and raise at this safe point if the driver
        published a new round since the last check."""
        self.save()
        self._spill()
        _count_commit()
        self.check_host_updates()

    # -- crash-durable spill ------------------------------------------------

    def _spill_payload(self):
        return None

    def _load_spill(self, payload):
        pass

    def _spill(self):
        """Write the spill with a CRC trailer, keeping the previous
        generation as ``<path>.prev``: a torn or corrupted write is
        detected at load, and recovery falls back to the previous commit
        instead of deserializing garbage.  The chaos ``corrupt_spill``
        fault rides this write (common/elastic.py:105-120 of the JAX
        package)."""
        path = _spill_path()
        payload = self._spill_payload()
        if path is None or payload is None:
            return
        tmp = None
        try:
            blob = append_crc_trailer(
                pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL))
            from .. import chaos as chaos_mod
            inj = chaos_mod.current()
            if inj is not None:
                # corrupt_spill rides the real write: the CRC was
                # computed over the true bytes, so the flipped blob is
                # what a torn write leaves behind
                blob = inj.corrupt_spill(blob)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            if os.path.exists(path):
                os.replace(path, path + ".prev")
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — the spill is best-effort
            logger.exception("elastic spill %s failed", path)
            if tmp and os.path.exists(tmp):
                os.unlink(tmp)

    def _maybe_unspill(self):
        path = _spill_path()
        if not path:
            return
        for candidate in (path, path + ".prev"):
            if not os.path.exists(candidate):
                continue
            try:
                with open(candidate, "rb") as f:
                    blob = strip_crc_trailer(f.read())
                payload = pickle.loads(blob)
            except Exception as exc:  # noqa: BLE001 — fall back, loudly
                logger.warning(
                    "elastic spill %s failed integrity verification "
                    "(%s: %s); falling back to %s", candidate,
                    type(exc).__name__, exc,
                    "the previous commit" if candidate == path
                    else "a fresh state")
                if candidate == path and isinstance(
                        exc, (TrailerCorruptionError,
                              pickle.UnpicklingError, EOFError)):
                    # the file itself is bad on disk: drop it now, or the
                    # next _spill rotates it over the good .prev
                    try:
                        os.unlink(candidate)
                    except OSError:
                        pass
                continue
            try:
                self._load_spill(payload)
                return
            except Exception:  # noqa: BLE001 — valid on disk, but does
                # not fit this state (keep it for a binary rollback)
                logger.exception(
                    "elastic spill %s verified but failed to install",
                    candidate)

    def check_host_updates(self):
        """Raise HostsUpdatedInterrupt if the driver pushed membership
        changes since the last check (reference :58-77)."""
        updated = False
        skip_sync = True
        while not self._host_messages.empty():
            timestamp, update_res = self._host_messages.get()
            if timestamp > self._last_updated_timestamp:
                self._last_updated_timestamp = timestamp
                updated = True
                # removals require rollback; additions may skip sync
                skip_sync = skip_sync and not bool(update_res)
        if updated:
            raise HostsUpdatedInterrupt(skip_sync)

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """State for arbitrary picklable attributes: save keeps an in-memory
    copy, sync broadcasts from rank 0 (reference
    common/elastic.py:116-148)."""

    def __init__(self, bcast_object, get_rank, **kwargs):
        self._bcast_object = bcast_object
        self._rank = get_rank
        self._saved_state = kwargs
        self._set_attrs()
        super().__init__()

    def save(self):
        new_state = {}
        for attr in self._saved_state.keys():
            new_state[attr] = getattr(self, attr)
        self._saved_state = new_state

    def restore(self):
        self._set_attrs()

    def sync(self):
        if self._saved_state:
            self._saved_state = self._bcast_object(self._saved_state)
            self._set_attrs()
            self._spill()

    def _set_attrs(self):
        for attr, value in self._saved_state.items():
            setattr(self, attr, value)

    def _spill_payload(self):
        return {"saved_state": self._saved_state}

    def _load_spill(self, payload):
        self._saved_state.update(payload.get("saved_state", {}))
        self._set_attrs()


def run_fn(func, reset):
    """Elastic retry loop (reference common/elastic.py:151-175)."""
    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        notification_manager = _get_notification_manager()
        notification_manager.init()
        notification_manager.register_listener(state)
        skip_sync = False
        try:
            while True:
                try:
                    if not skip_sync:
                        state.sync()
                    return func(state, *args, **kwargs)
                except HorovodInternalError:
                    # a peer died or the round moved on: roll back to the
                    # last commit (this covers failures inside sync() too,
                    # which the reference leaves uncaught).  The JAX
                    # package's integrity verdicts (eviction, in-place
                    # quarantine replay) come with its wire digests,
                    # ROADMAP.md A14
                    state.restore()
                    skip_sync = False
                except HostsUpdatedInterrupt as e:
                    skip_sync = e.skip_sync
                reset()
                state.on_reset()
        finally:
            notification_manager.remove_listener(state)
    return wrapper


def _get_notification_manager():
    """The launcher-side worker notification channel (idle when the
    process runs outside the elastic launcher)."""
    from ..runner.elastic.worker import notification_manager
    return notification_manager


def __getattr__(name):
    # reference common/elastic.py module attribute: the process-wide
    # notification manager (resolved lazily: importing the runner stack
    # here would pull it into every frontend import)
    if name == "notification_manager":
        return _get_notification_manager()
    raise AttributeError(f"module {__name__!r} has no attribute "
                         f"{name!r}")
