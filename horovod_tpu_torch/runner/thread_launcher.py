"""In-process rank launcher (port of
``horovod_tpu/runner/thread_launcher.py``): one thread per rank, all
ranks on this process's device -- the analogue of the reference's
programmatic ``horovod.run(func, np=...)`` for the local case."""

import threading

from ..common import basics
from ..common import env as env_mod


class _RankThread(threading.Thread):
    def __init__(self, fn, rank, args, kwargs):
        super().__init__(name=f"hvd-rank-{rank}", daemon=True)
        self.fn = fn
        self.rank = rank
        self.args = args
        self.kwargs = kwargs
        self.result = None
        self.error = None

    def run(self):
        basics.bind_rank(self.rank)
        try:
            self.result = self.fn(*self.args, **self.kwargs)
        except BaseException as exc:  # noqa: BLE001 — reported to caller
            self.error = exc
        finally:
            basics.unbind_rank()


def run(fn, np=None, args=(), kwargs=None, device=None, keep_alive=False):
    """Run ``fn`` once per rank on ``np`` rank threads and return the
    per-rank results.  ``np`` defaults to the running engine's local
    ranks, else to the launcher's ``HOROVOD_TPU_RANKS_PER_PROC`` (this
    process's share of a hybrid job), else 1.  ``device`` defaults to the
    card (see ``basics.init``); ``keep_alive`` leaves the runtime
    initialized."""
    kwargs = kwargs or {}
    already = basics.is_initialized()
    if np is None:
        np = basics.engine().num_local if already else \
            env_mod.get_int(env_mod.HOROVOD_TPU_RANKS_PER_PROC, 1) or 1
    if not already:
        basics.init(device=device, num_ranks=np)
    elif basics.engine().num_local != np:
        raise ValueError(
            f"horovod_tpu_torch already initialized with "
            f"{basics.engine().num_local} local ranks; cannot run with "
            f"np={np}")
    threads = [_RankThread(fn, r, args, kwargs) for r in range(np)]
    first_error = None
    try:
        for t in threads:
            t.start()
        # the first rank failure aborts the engine so peers blocked in
        # collectives fail fast instead of deadlocking
        pending = list(threads)
        while pending:
            still = []
            for t in pending:
                t.join(timeout=0.05)
                if t.is_alive():
                    still.append(t)
                elif t.error is not None and first_error is None:
                    first_error = (t.rank, t.error)
                    basics.engine().abort(t.error)
            pending = still
    finally:
        if not keep_alive and not already:
            basics.shutdown()
    if first_error is not None:
        rank, err = first_error
        nfail = sum(1 for t in threads if t.error is not None)
        raise RuntimeError(
            f"{nfail}/{np} ranks failed; first failure on rank "
            f"{rank}: {err!r}") from err
    return [t.result for t in threads]
