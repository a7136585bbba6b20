"""Process sets -- collectives over rank subsets (port of
``horovod_tpu/common/process_sets.py``).

Each registered set owns its own executor in the engine
(``Engine.add_process_set``): a stacked one over its member ranks' rows
in one process, or, under the launcher, a ``torch.distributed`` group of
its own when its members span processes, whose members may be rank
threads of several processes (the hybrid layout: each process stacks
its members' rows, and a process hosting none has no executor).  Every
process registers and removes the same sets in the same order, as in
the reference; of a process's rank threads the first to register a set
builds it and the others get its id.  Removal
is collective: every local rank votes, and the set drains its in-flight
collectives before it disappears (``Engine.remove_process_set``)."""

import threading

from . import basics
from .exceptions import HorovodInitError

_lock = threading.Lock()
_registered = {}   # id -> ProcessSet


class ProcessSet:
    """A set of global ranks collectives may be restricted to."""

    def __init__(self, ranks=None):
        # an empty rank list is a valid (inert) set; None means the
        # global set
        self.ranks = sorted(set(int(r) for r in ranks)) \
            if ranks is not None else None
        self.process_set_id = None

    def _require_registered(self):
        if self.process_set_id is None:
            raise ValueError(
                "process set is not yet registered with add_process_set() "
                "or init(process_sets=...)")

    def size(self):
        self._require_registered()
        return len(basics.engine().process_set_ranks(self.process_set_id))

    def rank(self):
        self._require_registered()
        ranks = basics.engine().process_set_ranks(self.process_set_id)
        me = basics.rank()
        return ranks.index(me) if me in ranks else -1

    def included(self):
        self._require_registered()
        return basics.rank() in basics.engine().process_set_ranks(
            self.process_set_id)

    def __repr__(self):
        return (f"ProcessSet(process_set_id={self.process_set_id}, "
                f"ranks={self.ranks})")


global_process_set = ProcessSet()
global_process_set.process_set_id = 0


def _register(ps: ProcessSet):
    if ps.process_set_id is not None:
        return ps
    if ps.ranks is None:
        raise ValueError("cannot register a process set without ranks")
    ps.process_set_id = basics.engine().add_process_set(ps.ranks)
    with _lock:
        _registered[ps.process_set_id] = ps
    return ps


def add_process_set(process_set) -> ProcessSet:
    """Register a new process set (a ``ProcessSet`` or a rank list);
    every rank may call it with the same ranks and gets the same id."""
    ps = process_set if isinstance(process_set, ProcessSet) \
        else ProcessSet(process_set)
    return _register(ps)


def remove_process_set(process_set) -> bool:
    """Deregister a set.  Collective: removal takes effect once every
    local rank thread has called it, after the set's in-flight
    collectives drained.  A caller bound to no rank removes at once.
    Returns False for the global set or an unknown id."""
    if isinstance(process_set, ProcessSet):
        # the object is shared by the rank threads; the first to finish
        # the removal clears process_set_id, so the others re-resolve it
        # through _removed_id
        ps_id = process_set.process_set_id
        if ps_id is None:
            ps_id = getattr(process_set, "_removed_id", None)
    else:
        ps_id = int(process_set)
    if ps_id is None or ps_id == 0:
        return False
    try:
        rank = basics.context().rank
    except HorovodInitError:
        rank = None
    ok = basics.engine().remove_process_set(ps_id, rank=rank)
    if ok:
        with _lock:
            reg = _registered.pop(ps_id, None)
        if reg is not None:
            reg._removed_id = ps_id
            reg.process_set_id = None
    return ok


def process_set_ids():
    return sorted([0] + list(_registered.keys()))


def _reset():
    with _lock:
        _registered.clear()
