"""The elastic driver decides a round only after it has reaped every exit
that is already visible (horovod_tpu_torch/runner/elastic/driver.py
``_start_round``).

The window these tests force: a worker has exited (``poll()`` is not
None) but the monitor thread has not reaped it yet, and a round starts
(the discovery thread saw the blacklist change, or the monitor's own
restart).  Fake ``Popen`` objects stand in for the workers, so the window
is set up in order instead of waited for.  The same scripts run against
the JAX package's driver, whose respawn loop has the same window: the
observations of both are asserted, the reference's as recorded
behaviour (ROADMAP.md C).
"""

import json

from horovod_tpu.runner.elastic import discovery as jax_discovery
from horovod_tpu.runner.elastic import driver as jax_driver

from horovod_tpu_torch.runner.elastic import discovery as torch_discovery
from horovod_tpu_torch.runner.elastic import driver as torch_driver

PACKAGES = {"jax": (jax_driver, jax_discovery),
            "torch": (torch_driver, torch_discovery)}


class FakeProc:
    """A worker process whose exit the test sets."""

    def __init__(self, key):
        self.key = key
        self.returncode = None

    def poll(self):
        return self.returncode

    def terminate(self):
        if self.returncode is None:
            self.returncode = -15

    kill = terminate

    def wait(self, timeout=None):
        return self.returncode


class _Store:
    def __init__(self):
        self.kv = {}

    def put(self, key, value):
        self.kv[key] = value

    def get(self, key, timeout=0.0):
        return self.kv.get(key)


class _Coordinator:
    def reset(self, world_size, round_id=0):
        pass

    def dead_procs(self):
        return {}


class _Server:
    port = 1234
    secret = b"\x01" * 16

    def __init__(self):
        self.store = _Store()
        self.coordinator = _Coordinator()


def _driver(pkg):
    driver_mod, discovery_mod = PACKAGES[pkg]
    server = _Server()
    drv = driver_mod.ElasticDriver(
        server, discovery_mod.FixedHosts({"localhost": 1, "127.0.0.1": 1}),
        min_np=1, max_np=2, command=["true"],
        cooldown_range=(600, 600))
    spawned = []

    def spawn(key):
        spawned.append(key)
        drv._procs[key] = FakeProc(key)

    drv._spawn_worker = spawn
    drv._host_manager.update_available_hosts()
    return drv, server, spawned


def _round(server):
    return json.loads(server.store.kv[jax_driver.ROUND_KEY])


def _survivor_finished_before_the_round(pkg):
    """Round 1 at size 2; the 127.0.0.1 worker fails, its host is
    blacklisted and round 2 runs the survivor alone (as the monitor
    does).  The survivor finishes (exit 0), and before any reap a round
    starts."""
    drv, server, spawned = _driver(pkg)
    drv._start_round()
    first = list(spawned)
    failed = drv._procs["127.0.0.1:0"]
    failed.returncode = 17
    with drv._lock:
        del drv._procs["127.0.0.1:0"]
    drv._registry.record_failure("127.0.0.1", 0)
    drv._host_manager.blacklist("127.0.0.1")
    drv._registry.note_reset()
    drv._host_manager.update_available_hosts()
    drv._start_round()
    assert _round(server)["size"] == 1
    drv._procs["localhost:0"].returncode = 0     # the survivor is done
    drv._start_round()                           # the window
    return {"spawned_after_round_1": spawned[len(first):],
            "round": _round(server)["round"],
            "finished": drv.finished(), "error": drv._error}


def test_a_finished_survivor_is_not_respawned():
    """The port reaps the survivor's exit 0 first: the registry records
    the round's one success and ends the job; nothing is spawned and no
    third round is published.  The JAX driver respawns the finished
    slot into round 3: its worker would restore the last commit and
    train the last batch again (the log of the unsteady
    test_elastic_worker_failure_recovery)."""
    assert _survivor_finished_before_the_round("torch") == {
        "spawned_after_round_1": [], "round": 2, "finished": True,
        "error": False}
    assert _survivor_finished_before_the_round("jax") == {
        "spawned_after_round_1": ["localhost:0"], "round": 3,
        "finished": False, "error": False}


def _one_finished_of_two(pkg):
    """Round 1 at size 2: the localhost worker finishes (exit 0) while
    the other still runs, and a round starts before the reap."""
    drv, server, spawned = _driver(pkg)
    drv._start_round()
    n = len(spawned)
    drv._procs["localhost:0"].returncode = 0
    drv._start_round()
    obs = {"spawned": spawned[n:], "round": _round(server)["round"],
           "finished": drv.finished()}
    # the other worker finishes too: the job ends in success
    drv._procs["127.0.0.1:0"].returncode = 0
    with drv._lock:
        drv._reap_exits_locked(0.0)
    obs["finished_after_both"] = drv.finished()
    obs["error"] = drv._error
    return obs


def test_a_finishing_round_forms_no_new_round():
    """A worker that exited 0 makes the round a finishing one: the port
    forms no new round and spawns nothing; the job ends once the other
    worker finishes too."""
    assert _one_finished_of_two("torch") == {
        "spawned": [], "round": 1, "finished": False,
        "finished_after_both": True, "error": False}


def test_a_visible_failure_is_reaped_before_the_round():
    """A worker exited 17 and a round starts before the monitor saw it:
    the port records the failure and blacklists its host first, so the
    round is formed without that host and nothing is respawned there.
    The JAX driver respawns the failed slot into a size-2 round."""
    def script(pkg):
        drv, server, spawned = _driver(pkg)
        drv._start_round()
        n = len(spawned)
        drv._procs["127.0.0.1:0"].returncode = 17
        drv._start_round()
        info = _round(server)
        return {"spawned": spawned[n:], "size": info["size"],
                "assignments": info["assignments"]}

    assert script("torch") == {"spawned": [], "size": 1,
                               "assignments": {"localhost:0": 0}}
    assert script("jax") == {"spawned": ["127.0.0.1:0"], "size": 2,
                             "assignments": {"127.0.0.1:0": 0,
                                             "localhost:0": 1}}


def _monitor_once(drv):
    """Run the driver's monitor thread for a moment (both packages' loop
    body, as it runs), then stop it."""
    import threading
    import time
    t = threading.Thread(target=drv._monitor_workers, daemon=True)
    t.start()
    time.sleep(0.5)
    error = drv._error
    drv._shutdown.set()
    t.join(5)
    return error


def test_an_abort_after_a_peer_finished_is_not_respawned():
    """Round 1 at size 2: the localhost worker finishes (exit 0) and is
    reaped; then the other aborts at its exit (-6, which early in a
    round reads as re-rendezvous churn).  The port records a failure and
    spawns nothing: the job ends, in error, since one worker failed.
    The JAX driver respawns the aborted slot, whose new worker would
    restore the last commit and train again."""
    def script(pkg):
        drv, server, spawned = _driver(pkg)
        drv._start_round()
        n = len(spawned)
        drv._procs["localhost:0"].returncode = 0
        drv._procs["127.0.0.1:0"].returncode = -6
        error = _monitor_once(drv)
        return {"spawned": spawned[n:], "error": error}

    assert script("torch") == {"spawned": [], "error": True}
    assert script("jax") == {"spawned": ["127.0.0.1:0"], "error": False}


def test_a_late_discovery_change_forms_no_new_round():
    """Round 1 at size 2; the 127.0.0.1 worker fails, is reaped and its
    host blacklisted, and round 2 runs the survivor alone.  Then the
    discovery thread, which saw the blacklist change the available hosts
    before round 2 took it in, starts a round too (the race of chip_smoke
    phase 21 (b): rounds 2 and 3 a millisecond apart).  The port forms
    no round 3: the same live worker at the same rank.  The JAX driver
    publishes round 3."""
    def script(pkg):
        drv, server, spawned = _driver(pkg)
        drv._start_round()
        failed = drv._procs["127.0.0.1:0"]
        failed.returncode = 17
        with drv._lock:
            del drv._procs["127.0.0.1:0"]
        drv._registry.record_failure("127.0.0.1", 0)
        drv._host_manager.blacklist("127.0.0.1")
        drv._registry.note_reset()
        drv._host_manager.update_available_hosts()
        drv._start_round()
        n = len(spawned)
        drv._start_round()                       # the discovery thread
        info = _round(server)
        return {"spawned": spawned[n:], "round": info["round"],
                "assignments": info["assignments"]}

    assert script("torch") == {"spawned": [], "round": 2,
                               "assignments": {"localhost:0": 0}}
    assert script("jax") == {"spawned": [], "round": 3,
                             "assignments": {"localhost:0": 0}}
