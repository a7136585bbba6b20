"""Elastic API surface, ``hvd.elastic`` (port of
``horovod_tpu/elastic/__init__.py``; reference ``horovod/common/elastic.py``
re-exported per framework)."""

import os
import sys

from ..common import basics
from ..common.basics import init, shutdown
from ..common.elastic import ObjectState, State, run_fn  # noqa: F401


def _exec_restart():
    sys.stdout.flush()
    sys.stderr.flush()
    os.execv(sys.executable, [sys.executable] + sys.argv)


def _reset():
    """Tear the engine and its process group down and re-initialize
    against the next elastic round, in this process.  Two cases need a
    fresh process instead, which restores the last commit from the spill
    (common/elastic.py ``_spill_path``): an aborted NCCL job
    (:func:`basics.needs_exec_restart`) and a teardown that left the
    engine thread blocked in a collective
    (:func:`basics.take_teardown_wedged`)."""
    if basics.needs_exec_restart():
        _exec_restart()
    shutdown()
    if basics.take_teardown_wedged():
        _exec_restart()
    init()


def run(func):
    """Elastic retry loop: on a membership change or an internal error,
    re-rendezvous and continue from the last commit."""
    return run_fn(func, _reset)
