"""Global runtime state and rank contexts (port of the single-process
part of ``horovod_tpu/common/basics.py``).

Ranks hosted by this process are thread-bound contexts, as in the JAX
package; every rank of this process works on one device.  The device
is the card unless the caller asks for the CPU: ``init()`` without a
device takes ``cuda:<HOROVOD_LOCAL_RANK>`` and raises when there is no
CUDA device, rather than carrying on on the CPU.
"""

import threading
from contextlib import contextmanager

import torch

from . import env as env_mod
from .exceptions import HorovodInitError

_state_lock = threading.RLock()
_engine = None
_tls = threading.local()


class RankContext:
    """Per-rank identity + auto-naming counters (the reference names
    unnamed ops ``<op>.noname.<n>``)."""

    def __init__(self, rank):
        self.rank = rank
        self._counters = {}

    def next_name(self, op_name):
        n = self._counters.get(op_name, 0) + 1
        self._counters[op_name] = n
        return f"{op_name}.noname.{n}"


def resolve_device(device=None) -> torch.device:
    """The runtime's device: ``device`` if given, else the card of this
    process's local rank.  Raises when CUDA is asked for (explicitly or
    by default) and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise HorovodInitError(
                "horovod_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        device = torch.device(
            "cuda", env_mod.get_int(env_mod.HOROVOD_LOCAL_RANK, 0))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise HorovodInitError(f"{device} requested but CUDA is not "
                                   f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise HorovodInitError(f"unsupported device {device}")
    return device


def init(device=None, num_ranks=None, process_sets=None):
    """Start the runtime (reference horovod_init): ``num_ranks`` ranks
    hosted by this process (default 1) on ``device``; ``process_sets``
    (``ProcessSet`` objects) are registered at once."""
    global _engine
    with _state_lock:
        if _engine is not None:
            _bind_thread_if_unbound()
            return
        from ..core.engine import Engine

        _engine = Engine(num_ranks or 1, resolve_device(device),
                         config=env_mod.Config())
        _bind_thread_if_unbound()
        if process_sets:
            from . import process_sets as ps_mod
            for ps in process_sets:
                ps_mod.add_process_set(ps)


def _bind_thread_if_unbound():
    if getattr(_tls, "ctx", None) is None and _engine is not None \
            and _engine.num_local == 1:
        _tls.ctx = RankContext(0)


def bind_rank(rank):
    """Bind the calling thread to rank ``rank`` of this process."""
    if _engine is None:
        raise HorovodInitError("horovod_tpu_torch.init() has not been called")
    if rank < 0 or rank >= _engine.num_local:
        raise ValueError(
            f"local rank {rank} out of range [0, {_engine.num_local})")
    _tls.ctx = RankContext(rank)
    return _tls.ctx


def unbind_rank():
    _tls.ctx = None


@contextmanager
def bound_context(ctx):
    """Temporarily bind ``ctx`` to the calling thread.  Autograd runs
    CUDA backward work (and so the optimizer's gradient hooks) on its
    own device thread; the hooks carry the owning rank across with
    this."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    try:
        yield ctx
    finally:
        _tls.ctx = prev


def context() -> RankContext:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        if _engine is None:
            raise HorovodInitError(
                "horovod_tpu_torch has not been initialized; call init()")
        _bind_thread_if_unbound()
        ctx = getattr(_tls, "ctx", None)
        if ctx is None:
            raise HorovodInitError(
                "this thread is not bound to a rank; use "
                "horovod_tpu_torch.run() or bind_rank()")
    return ctx


def engine():
    if _engine is None:
        raise HorovodInitError(
            "horovod_tpu_torch has not been initialized; call init()")
    return _engine


def is_initialized():
    return _engine is not None


def shutdown():
    global _engine
    with _state_lock:
        if _engine is None:
            return
        from ..ops.compiled import reset_compiled_state
        from . import process_sets as ps_mod

        # a re-init at another world size must never serve an old program
        reset_compiled_state()
        ps_mod._reset()
        _engine.shutdown()
        _engine = None
        _tls.ctx = None


# -- topology queries (single process: every rank is local) ------------------

def rank():
    return context().rank


def size():
    return engine().num_ranks


def local_rank():
    return rank()


def local_size():
    return size()


def cross_rank():
    return 0


def cross_size():
    return 1


def is_homogeneous():
    return True


def device() -> torch.device:
    """The device the runtime's tensors live on."""
    return engine().device
