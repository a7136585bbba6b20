"""Deadline helper (port of ``horovod_tpu/runner/common/util/timeout.py``;
reference ``horovod/runner/common/util/timeout.py``)."""

import time


class TimeoutException(Exception):
    pass


class Timeout:
    def __init__(self, timeout, message="Timed out waiting for "
                                        "{activity}."):
        self._timeout = timeout
        self._message = message
        self._deadline = time.time() + timeout

    def remaining(self):
        return max(0.0, self._deadline - time.time())

    # alias kept for code written against earlier drafts
    remaining_time_s = remaining

    def timed_out(self):
        return time.time() > self._deadline

    def check_time_out_for(self, activity):
        if self.timed_out():
            raise TimeoutException(
                self._message.format(activity=activity,
                                     timeout=self._timeout))
