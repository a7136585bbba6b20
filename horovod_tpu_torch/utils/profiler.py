"""Device-side profiling on ``torch.profiler`` (port of
``horovod_tpu/utils/profiler.py``).

SURVEY §5.1: the reference traces with (a) the host-side Timeline and
(b) NVTX ranges around every user-facing op for nsight
(``nvtx_op_range.{h,cc}``, started in EnqueueTensorAllreduces).  On the
card the device-side tracer is ``torch.profiler`` (CUPTI): its traces
carry every kernel with the host call that launched it.  This module is
the thin glue: start/stop a trace programmatically (the reference's
start_timeline/stop_timeline shape) and annotate host-side phases so
they appear as named ranges around the kernels they launch.

``annotate(name, device)`` is a ``torch.profiler.record_function``
always (a few microseconds when no profiler is attached), and on a CUDA
device also an NVTX range (``torch.cuda.nvtx``, the reference's
``NvtxOpRange``), which nsight and other CUPTI tools read.  The NVTX
half is chosen by device: a CPU-only torch build has no NVTX.
"""

import contextlib
import os
import threading

import torch

__all__ = ["annotate", "profile", "start_profile", "stop_profile",
           "TRACE_FILE"]

#: the Chrome trace ``stop_profile`` exports into the profile's logdir
TRACE_FILE = "trace.json"

_lock = threading.Lock()
_active = None          # (torch.profiler.profile, logdir)


def _wants_cuda(cuda):
    """The profile records CUDA activity unless told not to or the
    runtime runs on the CPU; asked for without a card, it raises."""
    if cuda is None:
        from ..common import basics
        cuda = not (basics.is_initialized()
                    and basics.engine().device.type == "cpu")
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA profile was asked for and no CUDA device is "
            "available; pass cuda=False to record the CPU only")
    return bool(cuda)


def start_profile(logdir=None, cuda=None):
    """Begin a ``torch.profiler`` trace of this process (reference
    analogue: horovod_start_timeline, operations.cc:1077): CPU activity
    of every thread (the engine's included) always, CUDA kernels and
    copies too unless ``cuda=False`` or the runtime was initialized on
    the CPU.  :func:`stop_profile` exports
    the Chrome trace into ``logdir`` (when given).  Raises if a profile
    started here is already running, or if CUDA activity is asked for
    without a card."""
    global _active
    acts = [torch.profiler.ProfilerActivity.CPU]
    if _wants_cuda(cuda):
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # every thread: the engine's ranges run on its own thread, which a
    # default profile (the starting thread's ops only) would not record
    from torch._C._profiler import _ExperimentalConfig
    config = _ExperimentalConfig(profile_all_threads=True)
    with _lock:
        if _active is not None:
            raise RuntimeError(
                "a profile is already active; stop_profile() first")
        prof = torch.profiler.profile(activities=acts,
                                      experimental_config=config)
        prof.start()
        _active = (prof, logdir)


def stop_profile():
    """Stop the running profile, export its Chrome trace to
    ``<logdir>/trace.json`` (when a logdir was given) and return the
    ``torch.profiler.profile`` object (its ``events()`` and
    ``key_averages()`` stay readable); None when none was running."""
    global _active
    with _lock:
        if _active is None:
            return None
        prof, logdir = _active
        _active = None
    prof.stop()
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    return prof


@contextlib.contextmanager
def annotate(name, device=None):
    """Named range around a host phase (the reference's NvtxOpRange):
    a ``record_function`` range, plus an NVTX range when ``device`` is
    a CUDA device."""
    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class _Profile:
    """``with profile(logdir) as p: ...`` -- ``p.prof`` is the stopped
    ``torch.profiler.profile`` after the block."""

    def __init__(self, logdir, cuda):
        self.logdir, self.cuda, self.prof = logdir, cuda, None

    def __enter__(self):
        start_profile(self.logdir, cuda=self.cuda)
        return self

    def __exit__(self, *exc):
        self.prof = stop_profile()
        return False


def profile(logdir=None, cuda=None):
    """Trace a scoped region: ``with profile('/tmp/trace'): step()``."""
    return _Profile(logdir, cuda)
