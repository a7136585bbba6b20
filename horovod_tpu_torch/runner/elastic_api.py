"""Programmatic elastic launch (port of
``horovod_tpu/runner/elastic_api.py``), shared by the platform
integrations: the Ray and Spark elastic entry points (reference
``ray/elastic.py``, ``spark/runner.py:312``) differ only in where host
discovery comes from; everything else (rendezvous server,
pickled-function worker command, ElasticDriver lifecycle) is this
helper.
"""

import os
import sys

from .elastic.driver import ElasticDriver
from .http.http_server import RendezvousServer, coordinator_kwargs

FN_KEY = "/elastic/fn"

# Worker stub: fetch the pickled (fn, args, kwargs) from the launcher's KV
# store over the authenticated channel whose coordinates arrive in the
# standard env handoff.  Remote workers need only horovod_tpu_torch
# installed, no shared filesystem (the reference ships the function the
# same way, through its run services' HMAC protocol).
_WORKER_STUB = """\
import os, pickle
from horovod_tpu_torch.runner.http.http_client import StoreClient
client = StoreClient(os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"],
                     int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"]),
                     bytes.fromhex(os.environ["HOROVOD_SECRET_KEY"]))
fn, a, kw = pickle.loads(client.get("{fn_key}", wait=30))
fn(*a, **kw)
"""


def run_elastic_fn(fn, args=(), kwargs=None, *, discovery, min_np,
                   max_np=None, env=None, reset_limit=None,
                   start_timeout=None, verbose=False, callbacks=None,
                   elastic_timeout=600, platform=None):
    """Run ``fn(*args, **kwargs)`` on every elastic worker.

    ``discovery`` provides ``find_available_hosts_and_slots()``; workers
    spawn per slot (ssh for remote hosts) and membership changes re-form
    the job.  ``start_timeout`` bounds the wait for ``min_np`` slots at
    startup, not the job's duration.  ``platform="cpu"`` puts the workers
    on the CPU (the launcher's ``--cpu``).

    ``callbacks`` (reference ray/elastic_v2.py:402-470): each callable
    receives every round-lifecycle event as a dict, ``{"event":
    "hosts_updated"|"round_start"|"worker_start"|"worker_exit", ...}``,
    as it happens.
    """
    try:
        # closures and lambdas ship as the reference's cloudpickle-based
        # run services ship them; stdlib pickle would serialize __main__
        # functions by reference, which the worker stub (whose __main__ is
        # the stub) can never resolve
        import cloudpickle
    except ImportError as exc:
        raise RuntimeError(
            "run_elastic_fn needs cloudpickle to ship the training "
            "function to the workers") from exc
    import secrets as _secrets

    env = dict(env or {})
    # workers must import horovod_tpu_torch even when the launcher runs it
    # from a source tree (sys.path does not survive exec)
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, env.get("PYTHONPATH",
                                      os.environ.get("PYTHONPATH", "")))
        if p)
    at_env = dict(os.environ)
    at_env.update(env)
    server = RendezvousServer(secret=bytes.fromhex(_secrets.token_hex(16)),
                              world_size=0, **coordinator_kwargs(at_env))
    server.start()
    try:
        server.store.put(FN_KEY, cloudpickle.dumps(
            (fn, tuple(args), dict(kwargs or {})), protocol=4))
        command = [sys.executable, "-c",
                   _WORKER_STUB.format(fn_key=FN_KEY)]
        on_event = None
        if callbacks:
            cbs = list(callbacks)

            def on_event(event):
                for cb in cbs:
                    cb(event)

        driver = ElasticDriver(server, discovery, min_np=min_np,
                               max_np=max_np or min_np, command=command,
                               env=env, reset_limit=reset_limit,
                               platform=platform, verbose=verbose,
                               on_event=on_event,
                               elastic_timeout=elastic_timeout)
        driver.start(start_timeout=start_timeout)
        ok = driver.join()
    finally:
        server.stop()
    if not ok:
        raise RuntimeError("elastic job failed")
