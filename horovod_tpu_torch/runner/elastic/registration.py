"""Worker state registry (port of
``horovod_tpu/runner/elastic/registration.py``; reference
``horovod/runner/elastic/registration.py``: READY/SUCCESS/FAILURE state
machine per slot, reset_limit enforcement :28-160)."""

import logging
import threading

logger = logging.getLogger("horovod_tpu_torch.elastic")

READY = "READY"
SUCCESS = "SUCCESS"
FAILURE = "FAILURE"


class WorkerStateRegistry:
    """Collects per-slot terminal states for one rendezvous round; when
    every slot of the round has recorded, decides: stop (all success),
    fail (all failure / reset limit), or resume with a new rendezvous
    (mixed — blacklisting failed hosts)."""

    def __init__(self, driver, host_manager, reset_limit=None,
                 verbose=False):
        self._driver = driver
        self._host_manager = host_manager
        self._reset_limit = reset_limit
        self._reset_count = 0
        self._lock = threading.Lock()
        self._states = {}          # (host, slot) -> state
        self._workers = {}         # state -> set of keys
        self._rendezvous_id = 0
        self._verbose = verbose
        self._size = 0

    def get_recorded_slots(self):
        return list(self._states.keys())

    def get(self, state):
        return list(self._workers.get(state, set()))

    def count(self, state):
        return len(self._workers.get(state, set()))

    def reset(self, size):
        with self._lock:
            self._states.clear()
            self._workers.clear()
            self._rendezvous_id += 1
            self._size = size

    def size(self):
        return self._size

    def last_rendezvous(self):
        return self._rendezvous_id

    def record_ready(self, host, slot):
        return self._record_state(host, slot, READY)

    def record_success(self, host, slot):
        return self._record_state(host, slot, SUCCESS)

    def record_failure(self, host, slot):
        return self._record_state(host, slot, FAILURE)

    def _record_state(self, host, slot, state):
        if self._driver.finished():
            return self._rendezvous_id
        key = (host, slot)
        complete = False
        with self._lock:
            if self._states.get(key) == FAILURE and state == READY:
                return self._rendezvous_id
            prev = self._states.get(key)
            if prev is not None:
                self._workers.get(prev, set()).discard(key)
            self._states[key] = state
            self._workers.setdefault(state, set()).add(key)
            rendezvous_id = self._rendezvous_id
            if len(self._states) >= self._size and \
                    all(s in (SUCCESS, FAILURE)
                        for s in self._states.values()):
                complete = True
        if complete:
            self._on_workers_recorded()
        return rendezvous_id

    def _on_workers_recorded(self):
        logger.info("all %d workers recorded", self._size)
        if self.count(SUCCESS) == self._size:
            self._driver.stop()
            return
        if self.count(FAILURE) == self._size:
            logger.error("all workers failed")
            self._driver.stop(error=True)
            return
        for host, slot in self.get(FAILURE):
            self._host_manager.blacklist(host)
        if not self.note_reset():
            self._driver.stop(error=True)
            return
        self._driver.resume()

    def note_reset(self) -> bool:
        """Count one round restart toward the reset limit.  Returns
        False when the limit is exhausted — EVERY restart path must
        consult this (the reference enforces reset_limit on each
        re-rendezvous, driver-triggered or registry-triggered)."""
        with self._lock:
            if self._reset_limit is not None and \
                    self._reset_count >= self._reset_limit:
                logger.error("reset limit %d reached; aborting job",
                             self._reset_limit)
                return False
            self._reset_count += 1
            return True
