"""In-memory rendezvous pipe (port of ``horovod_tpu/runner/util/
streams.py``; reference ``horovod/runner/util/streams.py``): single-slot, blocking on both
sides, usable with strings or bytes."""

import threading


class Pipe:
    def __init__(self):
        self._buf = None
        self._offs = 0
        self._cond = threading.Condition()
        self._closed = False

    def write(self, buf):
        with self._cond:
            while self._buf is not None and not self._closed:
                self._cond.wait()
            if self._closed:
                raise RuntimeError("Pipe is closed")
            self._buf = buf
            self._offs = 0
            self._cond.notify_all()

    def read(self, length=-1):
        with self._cond:
            while self._buf is None and not self._closed:
                self._cond.wait()
            if self._buf is None:
                return None
            if 0 < length < len(self._buf) - self._offs:
                end = self._offs + length
                out = self._buf[self._offs:end]
                self._offs = end
            else:
                out = self._buf[self._offs:]
                self._buf = None
            self._cond.notify_all()
            return out

    def flush(self):
        pass

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
