"""Async completion handles.

Port of the ``Handle`` of horovod_tpu/core/handles.py (the reference
torch binding's handle table, torch/handle_manager.h): every enqueued
collective returns a handle which ``poll()``/``synchronize()``
resolve.  The host side completes when the engine has enqueued the
work; on the card ``event`` is the CUDA event the caller's stream must
wait on before it reads the result (the reference's finished event).
"""

import threading
from typing import Any, Optional


class Handle:
    """Completion record for one enqueued tensor operation."""

    __slots__ = ("_event", "result", "error", "inplace_target",
                 "inplace_targets", "grouped", "event", "extra",
                 "returns_splits")

    def __init__(self):
        self._event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        # API-layer metadata: in-place write-back target(s)
        self.inplace_target: Any = None
        self.inplace_targets: Any = None
        # grouped ops always resolve to a list of tensors
        self.grouped: bool = False
        # CUDA event recorded after the work that produced ``result``
        # (None for CPU results)
        self.event: Any = None
        # an alltoall's received splits, and whether synchronize()
        # returns them beside the tensor
        self.extra: Any = None
        self.returns_splits: bool = False

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result, event=None, extra=None):
        self.result = result
        self.event = event
        self.extra = extra
        self._event.set()

    def set_error(self, exc: BaseException):
        self.error = exc
        self._event.set()

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("collective operation did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result
