"""The port's elastic modules (horovod_tpu_torch/runner/elastic,
common/elastic.py, torch/elastic) against the JAX package's, on the same
scripted inputs, in this process:

* ``HostManager`` change detection, blacklist and cooldown;
  ``WorkerStateRegistry`` success, failure, reset limit and
  ``note_reset`` (tests/test_elastic.py:26-150), each script run against
  both packages' classes and its observations compared;
* the driver's assignments and round records for the same host slots on
  a fake server (no worker is spawned: ``_spawn_worker`` records the
  slot), ``set_target_np``, ``suspend`` and ``unsuspend``;
* the coordinator's replies across ``reset`` (stale rounds);
* ``ObjectState`` and ``TorchState`` commit, restore and sync at 2 rank
  threads, and the crash-durable spill's round trip;
* ``ElasticSampler``'s index lists at sizes 1-4;
* the state-handler registry (tests/test_torch.py:290, :306, :769,
  :840).

Everything is compared exactly: the modules are framework-free, or the
states move tensors without arithmetic.
"""

import json
import os
import sys
import time

import pytest
import torch

import horovod_tpu as jax_hvd
import horovod_tpu.torch as jax_hvd_torch
from horovod_tpu.common import elastic as jax_elastic
from horovod_tpu.runner.elastic import discovery as jax_discovery
from horovod_tpu.runner.elastic import driver as jax_driver
from horovod_tpu.runner.elastic import registration as jax_registration
from horovod_tpu.runner.http import http_server as jax_http
from horovod_tpu.torch.elastic import sampler as jax_sampler

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu_torch.common import elastic as torch_elastic
from horovod_tpu_torch.runner.elastic import discovery as torch_discovery
from horovod_tpu_torch.runner.elastic import driver as torch_driver
from horovod_tpu_torch.runner.elastic import (
    registration as torch_registration,
)
from horovod_tpu_torch.runner.http import http_server as torch_http
from horovod_tpu_torch.torch.elastic import sampler as torch_sampler

PACKAGES = {
    "jax": (jax_discovery, jax_registration, jax_driver, jax_http),
    "torch": (torch_discovery, torch_registration, torch_driver,
              torch_http),
}


def _both(script):
    """``script(discovery, registration, driver, http)`` against both
    packages; asserts the two observation lists equal and returns the
    port's."""
    out = {name: script(*mods) for name, mods in PACKAGES.items()}
    assert out["jax"] == out["torch"], out
    return out["torch"]


class FakeDriver:
    def __init__(self):
        self.stopped = False
        self.error = False
        self.resumed = 0

    def finished(self):
        return self.stopped

    def stop(self, error=False):
        self.stopped = True
        self.error = error

    def resume(self):
        self.resumed += 1


# -- discovery and the registry ------------------------------------------------

def test_host_manager_change_detection():
    def script(discovery, *_):
        disc = discovery.FixedHosts({"b": 2})
        mgr = discovery.HostManager(disc)
        obs = [mgr.update_available_hosts(),
               mgr.current_hosts.count_available_slots(),
               mgr.update_available_hosts()]
        disc._available_hosts = {"b": 2, "a": 1, "c": 3}
        obs += [mgr.update_available_hosts(),
                mgr.current_hosts.host_assignment_order,
                mgr.current_hosts.count_available_slots()]
        disc._available_hosts = {"a": 1, "c": 4}
        obs += [mgr.update_available_hosts(),
                mgr.current_hosts.host_assignment_order,
                dict(mgr.current_hosts.host_slots)]
        return obs

    obs = _both(script)
    # ordering stability: the existing host keeps its place
    assert obs[4] == ["b", "a", "c"] and obs[7] == ["a", "c"]


def test_host_discovery_script_parsing(tmp_path):
    script_path = tmp_path / "d.sh"
    script_path.write_text("#!/bin/sh\necho h1:2\necho\necho h2\n")
    script_path.chmod(0o755)

    def script(discovery, *_):
        with pytest.raises(RuntimeError, match="slots"):
            discovery.HostDiscoveryScript(
                str(script_path)).find_available_hosts_and_slots()
        return discovery.HostDiscoveryScript(
            str(script_path), slots=3).find_available_hosts_and_slots()

    assert _both(script) == {"h1": 2, "h2": 3}


def test_host_manager_blacklist_and_cooldown():
    def script(discovery, *_):
        mgr = discovery.HostManager(discovery.FixedHosts({"a": 1, "b": 1}),
                                    cooldown_range=(0.05, 0.2))
        obs = [mgr.update_available_hosts()]
        mgr.blacklist("b")
        obs += [mgr.is_blacklisted("b"), mgr.update_available_hosts(),
                sorted(mgr.current_hosts.available_hosts)]
        # cooldown expiry resurrects the host
        time.sleep(0.3)
        obs += [mgr.is_blacklisted("b"), mgr.update_available_hosts(),
                sorted(mgr.current_hosts.available_hosts)]
        return obs

    assert _both(script) == [True, True, True, ["a"], False, True,
                             ["a", "b"]]


def test_host_state_backoff_grows_and_caps():
    def script(discovery, *_):
        state = discovery.HostState(cooldown_range=(1.0, 4.0))
        delays = []
        for _ in range(5):
            t0 = time.monotonic()
            state.blacklist()
            delays.append(state._cooldown_ends - t0)
        return [d >= lo and d <= hi + 0.1 for d, lo, hi in zip(
            delays, (1.0, 2.0, 4.0, 4.0, 4.0), (1.25, 2.5, 4.0, 4.0, 4.0))]

    assert all(_both(script))


def _registry_script(steps, reset_limit=None, size=2):
    def script(discovery, registration, *_):
        driver = FakeDriver()
        mgr = discovery.HostManager(discovery.FixedHosts({"a": 1, "b": 1}))
        mgr.update_available_hosts()
        reg = registration.WorkerStateRegistry(driver, mgr,
                                               reset_limit=reset_limit)
        reg.reset(size)
        obs = []
        for verb, host in steps:
            if verb == "note_reset":
                obs.append(reg.note_reset())
                continue
            getattr(reg, f"record_{verb}")(host, 0)
            obs.append((driver.stopped, driver.error, driver.resumed,
                        sorted(reg.get(registration.FAILURE)),
                        mgr.is_blacklisted("b"), reg.last_rendezvous()))
        return obs
    return script


@pytest.mark.parametrize("steps,reset_limit", [
    ([("success", "a"), ("success", "b")], None),
    ([("failure", "b"), ("success", "a")], None),
    ([("failure", "a"), ("failure", "b")], None),
    ([("failure", "b"), ("success", "a")], 0),
    ([("ready", "a"), ("failure", "b"), ("ready", "b"), ("success", "a")],
     None),
    ([("note_reset", None)] * 3, 2),
], ids=["all-success", "mixed", "all-failure", "reset-limit", "ready",
        "note-reset"])
def test_registry(steps, reset_limit):
    obs = _both(_registry_script(steps, reset_limit))
    if steps[-1][0] == "note_reset":
        assert obs == [True, True, False]


# -- the driver's rounds on a fake server --------------------------------------

class _FakeStore:
    def __init__(self):
        self.kv = {}

    def put(self, key, value):
        self.kv[key] = value

    def get(self, key, timeout=0.0):
        return self.kv.get(key)


class _FakeCoordinator:
    def __init__(self):
        self.resets = []

    def reset(self, world_size, round_id=0):
        self.resets.append((world_size, round_id))

    def dead_procs(self):
        return {}


class _FakeServer:
    port = 1234
    secret = b"\x01" * 16

    def __init__(self):
        self.store = _FakeStore()
        self.coordinator = _FakeCoordinator()


def _driver_for(driver_mod, discovery_mod, hosts, min_np, max_np):
    server = _FakeServer()
    drv = driver_mod.ElasticDriver(
        server, discovery_mod.FixedHosts(hosts), min_np=min_np,
        max_np=max_np, command=["true"])
    spawned = []
    drv._spawn_worker = spawned.append
    drv._host_manager.update_available_hosts()
    return drv, server, spawned


def _round(server):
    info = json.loads(server.store.kv[jax_driver.ROUND_KEY])
    # the store address is a free port of this host: only its host part
    # is the driver's choice
    if "coordinator" in info:
        info["coordinator"] = info["coordinator"].rsplit(":", 1)[0]
    return info


def test_driver_rounds_and_assignments():
    def script(discovery, registration, driver, http):
        drv, server, spawned = _driver_for(
            driver, discovery, {"localhost": 2, "127.0.0.1": 1}, 1, 4)
        drv._start_round()
        obs = [_round(server), list(spawned),
               server.coordinator.resets[-1],
               json.loads(server.store.kv[driver.NOTIFY_KEY]),
               drv.current_world_size()]
        slot = drv.get_slot_info("localhost", 1)
        obs.append((slot.rank, slot.local_rank, slot.local_size,
                    slot.cross_rank, slot.cross_size, slot.size))
        drv.record_ready("localhost", 1)
        obs.append(sorted(k for k in server.store.kv
                          if k.startswith("/elastic/joined")))
        # a blacklisted host leaves the next round
        drv._host_manager.blacklist("127.0.0.1")
        drv._host_manager.update_available_hosts()
        drv._start_round()
        obs += [_round(server), server.coordinator.resets[-1]]
        return obs

    obs = _both(script)
    assert obs[0]["size"] == 3 and obs[0]["assignments"] == {
        "127.0.0.1:0": 0, "localhost:0": 1, "localhost:1": 2}
    assert obs[7]["size"] == 2 and obs[7]["round"] == 2


def test_driver_set_target_np():
    def script(discovery, registration, driver, http):
        drv, server, spawned = _driver_for(driver, discovery,
                                           {"a": 2, "b": 2}, 1, 3)
        obs = [drv.set_target_np(2)]   # before start: no round formed
        drv._start_round()
        obs += [_round(server)["size"], drv.set_target_np(9),
                _round(server)["size"], drv.set_target_np(0),
                _round(server)["size"], server.coordinator.resets]
        drv.acquire_target_lever("fleet")
        obs += [drv.set_target_np(3, owner="autoscaler"),
                drv.set_target_np(2, owner="fleet", epoch=5),
                drv.set_target_np(3, owner="fleet", epoch=4)]
        return obs

    assert _both(script)[:6] == [2, 2, 3, 3, 1, 1]


def test_driver_suspend_and_unsuspend():
    def script(discovery, registration, driver, http):
        drv, server, spawned = _driver_for(driver, discovery, {"a": 2}, 1, 2)
        drv._start_round()
        drv.suspend(drain_grace=5.0)
        obs = [drv.suspended, _round(server),
               json.loads(server.store.kv[driver.NOTIFY_KEY]),
               server.coordinator.resets[-1]]
        drv._start_round()      # a suspended job forms no round
        obs.append(_round(server)["round"])
        drv.unsuspend()
        obs += [drv.suspended, _round(server), len(spawned)]
        return obs

    obs = _both(script)
    assert obs[1] == {"round": 2, "size": 0, "suspended": True,
                      "assignments": {}}
    assert obs[4] == 2 and obs[6]["round"] == 3


def test_suspended_round_exits_the_worker(monkeypatch):
    """A worker that finds its job suspended at the rendezvous exits
    cleanly (the JAX package's basics._elastic_rendezvous)."""
    from horovod_tpu_torch.common import basics

    class Client:
        def get(self, key, wait=0.0):
            return json.dumps({"round": 3, "size": 0, "suspended": True,
                               "assignments": {}}).encode()

    monkeypatch.setattr(basics, "_elastic_round", 2)
    with pytest.raises(SystemExit) as exc:
        basics._elastic_rendezvous(Client())
    assert exc.value.code == 0


def test_elastic_rendezvous_takes_the_rounds_layout(monkeypatch):
    from horovod_tpu_torch.common import basics

    class Client:
        def __init__(self):
            self.puts = []

        def get(self, key, wait=0.0):
            return json.dumps({
                "round": 4, "size": 3, "coordinator": "10.0.0.1:7",
                "assignments": {"h2:0": 0, "h1:0": 1, "h2:1": 2}}).encode()

        def put(self, key, value):
            self.puts.append(key)

    monkeypatch.setattr(basics, "_elastic_round", 1)
    monkeypatch.setenv("HOROVOD_HOSTNAME", "h2")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "1")
    client = Client()
    assert basics._elastic_rendezvous(client) == (
        2, 3, "10.0.0.1:7", 4, [0, 1, 0])
    assert client.puts == ["/elastic/joined/4/2"]
    assert basics._elastic_round == 4


# -- the coordinator across a reset --------------------------------------------

def _meta(key, nprocs=2):
    return dict(key=key, type="ALLREDUCE", dtype="float32", shape=[4], op=1,
                pre=1.0, post=1.0, ps=0, nbytes=16, nprocs=nprocs, root=-1,
                aux={})


def test_coordinator_replies_across_reset():
    def script(discovery, registration, driver, http):
        c = http.Coordinator(world_size=2)

        def h(verb, req):
            return json.loads(json.dumps(c.handle(verb, req)))
        obs = [h("ready", {"proc": 0, "nlocal": 1, "entries": [_meta("a")],
                           "round": 0}),
               h("heartbeat", {"proc": 0, "ranks": [0], "round": 0}),
               h("poll", {"cursor": 0, "proc": 0, "wait": 0.0, "round": 0}),
               c.procs_seen()]
        c.reset(world_size=1, round_id=1)
        obs += [c.round_id, c.world_size, c.procs_seen(), c.dead_procs(),
                h("ready", {"proc": 1, "nlocal": 1,
                            "entries": [_meta("a")], "round": 0}),
                h("poll", {"cursor": 0, "proc": 0, "wait": 0.0,
                           "round": 0}),
                h("heartbeat", {"proc": 0, "round": 0}),
                h("ready", {"proc": 0, "nlocal": 1,
                            "entries": [_meta("b", nprocs=1)],
                            "round": 1}),
                h("poll", {"cursor": 0, "proc": 0, "wait": 0.0,
                           "round": 1}),
                c.procs_seen()]
        for rec in obs[-2]["responses"]:
            rec.pop("trace", None)
        return obs

    obs = _both(script)
    assert obs[8] == {"stale": True, "round": 1}
    assert obs[12]["responses"][0]["keys"] == ["b"]


def test_a_poll_waiting_through_a_reset_gets_stale():
    import threading

    def script(discovery, registration, driver, http):
        c = http.Coordinator(world_size=1)
        out = {}
        t = threading.Thread(target=lambda: out.setdefault("r", c.handle(
            "poll", {"cursor": 0, "proc": 0, "wait": 5.0, "round": 0})))
        t.start()
        time.sleep(0.2)
        c.reset(world_size=1, round_id=1)
        t.join(5.0)
        return out["r"]

    assert _both(script) == {"stale": True, "round": 1}


def test_store_controller_raises_on_a_stale_round():
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.core.store_controller import (
        StaleRoundError, StoreController,
    )
    server = torch_http.RendezvousServer(secret=b"k" * 16, world_size=1)
    port = server.start()
    try:
        ctl = StoreController("127.0.0.1", port, b"k" * 16, 0, 1, 1,
                              round_id=0)
        ctl.report_ready([_meta("a", nprocs=1)])
        assert ctl.poll(wait=1.0)[0]["keys"] == ["a"]
        server.coordinator.reset(world_size=1, round_id=1)
        for call in (lambda: ctl.poll(wait=0.0),
                     lambda: ctl.report_ready([_meta("b", nprocs=1)]),
                     lambda: ctl.heartbeat(ranks=[0])):
            with pytest.raises(StaleRoundError, match="round 1"):
                call()
        assert issubclass(StaleRoundError, HorovodInternalError)
        ctl2 = StoreController("127.0.0.1", port, b"k" * 16, 0, 1, 1,
                               round_id=1)
        ctl2.report_ready([_meta("b", nprocs=1)])
        assert ctl2.poll(wait=1.0)[0]["keys"] == ["b"]
    finally:
        server.stop()


# -- ObjectState, TorchState and the spill -------------------------------------

def _model(seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU(),
                                torch.nn.Linear(4, 2))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(
                rng.standard_normal(tuple(p.shape)).astype("float32")))
    return model


def _state_script(pkg, run):
    """Commit, restore and sync of a TorchState and an ObjectState at 2
    rank threads: rank 1 starts from other weights and other attributes,
    a step moves both, restore takes the commit back, sync makes rank 0's
    the replicas'."""
    def fn():
        r = pkg.rank()
        model = _model(7 + r)
        opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)
        ts = pkg.elastic.TorchState(model=model, optimizer=opt, batch=r,
                                    epoch=10 + r)
        os_ = pkg.elastic_mod.ObjectState(
            bcast_object=pkg.broadcast_object, get_rank=pkg.rank,
            step=100 * (r + 1), tag=f"rank{r}")
        x = torch.full((5, 3), 0.5 + r)
        model(x).pow(2).sum().backward()
        opt.step()
        ts.batch += 1
        ts.commit()
        os_.step += 1
        os_.commit()
        committed = [p.detach().clone() for p in model.parameters()]
        with torch.no_grad():
            for p in model.parameters():
                p.add_(3.0)
        ts.batch = 99
        os_.tag = "moved"
        ts.restore()
        os_.restore()
        obs = {"restored": [torch.equal(p, c) for p, c in
                            zip(model.parameters(), committed)],
               "batch": ts.batch, "tag": os_.tag, "step": os_.step}
        ts.sync()
        os_.sync()
        obs.update(
            params=[p.detach().numpy().tolist()
                    for p in model.parameters()],
            momentum=[opt.state[p]["momentum_buffer"].numpy().tolist()
                      for p in model.parameters()],
            synced=(ts.batch, ts.epoch, os_.step, os_.tag))
        return obs
    return run(fn)


class _Pkg:
    def __init__(self, core, frontend, elastic_mod):
        self.rank = core.rank
        self.broadcast_object = frontend.broadcast_object
        self.elastic = frontend.elastic
        self.elastic_mod = elastic_mod


def test_object_and_torch_state_commit_restore_sync():
    got = _state_script(_Pkg(hvd, hvd_torch, torch_elastic),
                        lambda fn: hvd.run(fn, np=2, device="cpu"))
    want = _state_script(_Pkg(jax_hvd, jax_hvd_torch, jax_elastic),
                         lambda fn: jax_hvd.run(fn, np=2))
    assert got == want
    assert got[0]["restored"] == [True] * 4 and got[0]["batch"] == 1
    assert got[1]["synced"] == got[0]["synced"] == (1, 10, 101, "rank0")
    assert got[1]["params"] == got[0]["params"]


def test_restore_keeps_the_commit_apart():
    """A restore hands the optimizer a copy of the commit: the steps after
    it never change the commit, so a second failure restores the same
    state again."""
    def fn():
        model = _model(2)
        opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)
        ts = hvd_torch.elastic.TorchState(model=model, optimizer=opt)

        def step():
            opt.zero_grad()
            model(torch.ones(2, 3)).sum().backward()
            opt.step()
        step()
        ts.commit()
        want = [opt.state[p]["momentum_buffer"].clone()
                for p in model.parameters()]
        for _ in range(2):
            step()
            ts.restore()
            got = [opt.state[p]["momentum_buffer"]
                   for p in model.parameters()]
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        return True

    assert hvd.run(fn, np=1, device="cpu") == [True]


def test_spill_round_trip(tmp_path, monkeypatch):
    """The committed state survives a fresh process: a new TorchState
    built with the same spill directory restores the last commit (the
    exec-restart path), tensors on the CPU; a torn spill falls back to
    the previous commit."""
    monkeypatch.setenv("HOROVOD_STATE_SPILL", str(tmp_path))
    monkeypatch.setenv("HOROVOD_HOSTNAME", "h")
    monkeypatch.setenv("HOROVOD_LOCAL_RANK", "0")

    def fn():
        model = _model(1)
        opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)
        ts = hvd_torch.elastic.TorchState(model=model, optimizer=opt,
                                          batch=0)
        for b in range(2):
            opt.zero_grad()
            model(torch.ones(2, 3)).sum().backward()
            opt.step()
            ts.batch = b + 1
            ts.commit()
        return ([p.detach().clone() for p in model.parameters()],
                [opt.state[p]["momentum_buffer"].clone()
                 for p in model.parameters()])

    params, momentum = hvd.run(fn, np=1, device="cpu")[0]
    path = tmp_path / "state_h_0.pkl"
    assert path.exists() and (tmp_path / "state_h_0.pkl.prev").exists()

    def fresh():
        model = _model(99)
        opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)
        ts = hvd_torch.elastic.TorchState(model=model, optimizer=opt,
                                          batch=0)
        return (ts.batch, [p.detach().clone() for p in model.parameters()],
                [opt.state[p]["momentum_buffer"].clone()
                 for p in model.parameters()])

    batch, p2, m2 = hvd.run(fresh, np=1, device="cpu")[0]
    assert batch == 2
    assert all(torch.equal(a, b) for a, b in zip(params, p2))
    assert all(torch.equal(a, b) for a, b in zip(momentum, m2))
    # a torn latest spill: the previous commit (batch 1) is restored and
    # the bad file is dropped
    blob = path.read_bytes()
    path.write_bytes(blob[:len(blob) // 2] + blob[-20:])
    batch, _, _ = hvd.run(fresh, np=1, device="cpu")[0]
    assert batch == 1 and not path.exists()


def test_spill_trailer_matches_the_jax_package():
    from horovod_tpu.core import integrity
    blob = b"payload" * 10
    assert torch_elastic.append_crc_trailer(blob) == \
        integrity.append_crc_trailer(blob)
    trailed = torch_elastic.append_crc_trailer(blob)
    assert torch_elastic.strip_crc_trailer(trailed) == blob
    assert torch_elastic.strip_crc_trailer(blob) == blob
    with pytest.raises(torch_elastic.TrailerCorruptionError) as exc:
        torch_elastic.strip_crc_trailer(b"x" + trailed[1:])
    assert exc.value.kind == "mismatch"


def test_check_host_updates_and_run_fn():
    """The retry loop on scripted failures: an internal error restores
    the commit and syncs; a hosts update keeps the state (skip_sync for
    an update without removals); both reset."""
    def script(pkg_elastic, exceptions):
        calls = []

        class S(pkg_elastic.State):
            def __init__(self):
                super().__init__()
                self.v = 0

            def save(self):
                calls.append("save")

            def restore(self):
                calls.append("restore")

            def sync(self):
                calls.append("sync")

        attempts = iter([exceptions.HorovodInternalError("x"),
                         exceptions.HostsUpdatedInterrupt(True),
                         exceptions.HostsUpdatedInterrupt(False), None])

        def func(state):
            calls.append("func")
            exc = next(attempts)
            if exc is not None:
                raise exc
            return "ok"

        st = S()
        st.register_reset_callbacks([lambda: calls.append("callback")])
        res = pkg_elastic.run_fn(func, lambda: calls.append("reset"))(st)
        st.on_hosts_updated(1.0, 0)
        st.on_hosts_updated(0.5, 1)
        with pytest.raises(exceptions.HostsUpdatedInterrupt) as info:
            st.check_host_updates()
        return res, calls, info.value.skip_sync

    from horovod_tpu.common import exceptions as jax_exc
    from horovod_tpu_torch.common import exceptions as torch_exc
    got = script(torch_elastic, torch_exc)
    assert got == script(jax_elastic, jax_exc)
    assert got[1][:6] == ["sync", "func", "restore", "reset", "callback",
                          "sync"]


# -- ElasticSampler --------------------------------------------------------------

@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_elastic_sampler_index_lists(size, monkeypatch):
    """The same index lists as the JAX sampler, for every rank at this
    size: fresh, after record_batch calls, across set_epoch, and after a
    state_dict round trip into a world of another size."""
    def lists(sampler_mod):
        out = []
        for rank in range(size):
            monkeypatch.setattr(sampler_mod, "_world", lambda: (size, rank))
            s = sampler_mod.ElasticSampler(list(range(23)), shuffle=True,
                                           seed=5)
            obs = [list(iter(s)), len(s)]
            s.record_batch(0, 2)
            s.record_batch(1, 3)
            sd = s.state_dict()
            obs.append(sd)
            s.reset()
            obs.append(list(iter(s)))
            s.set_epoch(1)
            obs.append(list(iter(s)))
            monkeypatch.setattr(sampler_mod, "_world",
                                lambda: (size % 4 + 1, 0))
            s.load_state_dict(sd)
            obs.append(list(iter(s)))
            out.append(obs)
        return out

    assert lists(torch_sampler) == lists(jax_sampler)


def test_elastic_sampler_covers_the_dataset():
    def fn():
        sampler = hvd_torch.elastic.ElasticSampler(list(range(20)),
                                                   shuffle=False)
        assert len(sampler) == 5          # 20 / 4 ranks
        idx = list(iter(sampler))
        sampler.record_batch(0, 2)
        assert len(sampler.state_dict()["processed_indices"]) == 2
        return idx

    covered = set()
    for idx in hvd.run(fn, np=4, device="cpu"):
        covered.update(idx)
    assert covered == set(range(20))


# -- the state-handler registry ------------------------------------------------

def test_torch_state_save_restore():
    def fn():
        model = torch.nn.Linear(2, 2)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        state = hvd_torch.elastic.TorchState(model=model, optimizer=opt,
                                             batch=0, epoch=0)
        state.epoch = 5
        state.commit()
        w0 = model.weight.detach().clone()
        with torch.no_grad():
            model.weight.fill_(123.0)
        state.epoch = 9
        state.restore()
        assert torch.allclose(model.weight, w0)
        assert state.epoch == 5
        return True

    assert all(hvd.run(fn, np=4, device="cpu"))


def test_handler_registry_order_and_custom_types():
    from horovod_tpu.torch.elastic import state as jax_state
    from horovod_tpu_torch.torch.elastic import (
        ElasticSampler, SamplerStateHandler, StateHandler, TorchState,
        get_handler_registry, set_handler_registry,
    )
    from horovod_tpu_torch.torch.elastic.state import _get_handler

    registry = get_handler_registry()
    assert [(t.__name__, h.__name__) for t, h in registry] == [
        (t.__name__, h.__name__) for t, h in jax_state.get_handler_registry()]
    assert any(cls is SamplerStateHandler for _, cls in registry)

    class Clock:
        def __init__(self):
            self.t = 0

    class ClockHandler(StateHandler):
        def save(self):
            self._saved = self.value.t

        def restore(self):
            self.value.t = self._saved

        def sync(self):
            pass

    set_handler_registry(registry + [(Clock, ClockHandler)])
    try:
        assert isinstance(_get_handler(Clock()), ClockHandler)
        clock = Clock()
        st = TorchState(clock=clock, batch=0)
        clock.t = 4
        st.commit()
        clock.t = 9
        st.restore()
        assert clock.t == 4
    finally:
        set_handler_registry(registry)
    assert _get_handler(Clock()) is None

    def fn():
        model = torch.nn.Linear(2, 1)
        sampler = ElasticSampler(list(range(8)), shuffle=False)
        state = TorchState(model=model, sampler=sampler, batch=0)
        sampler.record_batch(0, 2)
        state.batch = 1
        state.save()
        sampler.record_batch(1, 2)
        state.batch = 2
        state.restore()
        assert state.batch == 1
        assert len(sampler.processed_indices) == 2  # rolled back
        return True

    assert all(hvd.run(fn, np=2, device="cpu"))


def test_sampler_sync_unions_progress():
    def fn():
        sampler = hvd_torch.elastic.ElasticSampler(list(range(8)),
                                                   shuffle=False)
        state = hvd_torch.elastic.TorchState(sampler=sampler)
        sampler.record_batch(0, 2)   # rank 0: {0,2}; rank 1: {1,3}
        assert len(sampler.processed_indices) == 2
        state.sync()
        assert sampler.processed_indices == {0, 1, 2, 3}
        return True

    assert all(hvd.run(fn, np=2, device="cpu"))


def test_reset_drops_the_optimizers_in_flight_state():
    """TorchState.reset (after an elastic reset): a DistributedOptimizer
    forgets the allreduces the old round left in flight and its wire
    residuals, so the next step's zero_grad and hooks start clean."""
    def fn():
        model = _model(3)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters(),
            compression=hvd_torch.Compression.int8)
        state = hvd_torch.elastic.TorchState(model=model, optimizer=opt)
        model(torch.ones(2, 3)).sum().backward()
        assert opt._handles and opt._residuals
        in_flight = [h for h, _ in opt._handles.values()]
        state.reset()
        assert not opt._handles and not opt._residuals
        assert set(opt._allreduce_delay.values()) == {1}
        # the old round's collectives are over before the next round
        # submits the same names (a real reset tears the engine down)
        for h in in_flight:
            hvd.synchronize(h)
        opt.zero_grad()
        model(torch.ones(2, 3)).sum().backward()
        opt.step()
        return True

    assert all(hvd.run(fn, np=2, device="cpu"))


def test_elastic_optimizer_hooks_at_one_process(monkeypatch):
    """An elastic job's DistributedOptimizer registers its hooks at any
    size (it may grow later); at one process they reduce nothing."""
    monkeypatch.setenv("HOROVOD_ELASTIC", "1")

    def fn():
        model = _model(3)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        assert len(opt._requires_update) == 4
        model(torch.ones(2, 3)).sum().backward()
        assert not opt._handles
        opt.step()
        return True

    assert hvd.run(fn, np=1, device="cpu") == [True]


def test_rank_context_follows_a_reinit(monkeypatch):
    """A one-rank process's context object takes the new rank at a
    re-init, so what holds it (the optimizer's hooks) follows."""
    from horovod_tpu_torch.common import basics
    monkeypatch.setattr(basics, "_proc_ctx", None)
    hvd.init(device="cpu")
    try:
        ctx = basics.context()
        ctx.next_name("allreduce")
        monkeypatch.setattr(ctx, "rank", 5)
        hvd.shutdown()
        hvd.init(device="cpu")
        assert basics.context() is ctx and ctx.rank == 0
        assert ctx.next_name("allreduce") == "allreduce.noname.1"
    finally:
        hvd.shutdown()


def test_exec_restart_rule(monkeypatch):
    """Only an aborted NCCL job needs a fresh process; an aborted gloo
    (or CPU) one re-initializes in place, and a teardown is flagged
    wedged once."""
    from horovod_tpu_torch.common import basics

    class Eng:
        _aborted = RuntimeError("peer died")

        class device:
            type = "cuda"

    monkeypatch.setattr(basics, "_engine", Eng())
    monkeypatch.setattr(basics, "_dist_up", True)
    monkeypatch.setenv("HOROVOD_GPU_OPERATIONS", "nccl")
    assert basics.needs_exec_restart()
    monkeypatch.setenv("HOROVOD_GPU_OPERATIONS", "gloo")
    assert not basics.needs_exec_restart()
    Eng.device.type = "cpu"
    monkeypatch.setenv("HOROVOD_GPU_OPERATIONS", "nccl")
    assert not basics.needs_exec_restart()
    monkeypatch.setattr(basics, "_teardown_wedged", True)
    assert basics.take_teardown_wedged()
    assert not basics.take_teardown_wedged()


# -- what stays refused; the remote spawn ----------------------------------------

def test_elastic_refusals():
    """An elastic job still refuses chaos's fault plan (A17) and the
    serving autoscaler (A16), and rank threads: an elastic worker holds
    one rank."""
    import argparse
    from horovod_tpu_torch.runner import elastic_run
    for key, item in (("HOROVOD_FAULT_PLAN", "A17"),
                      ("HOROVOD_SERVING", "A16")):
        with pytest.raises(NotImplementedError, match=item):
            elastic_run.check_elastic_env({key: "1"})
    with pytest.raises(ValueError, match="one rank"):
        elastic_run.run_elastic(argparse.Namespace(ranks_per_proc=2))


STUB_SSH = """#!/bin/sh
printf '%s\\0' "$@" > "{log}/call.$$"
for last; do :; done
exec env -i HOME="$HOME" TMPDIR="${{TMPDIR:-/tmp}}" \\
    PATH=/usr/local/bin:/usr/bin:/bin sh -c "$last"
"""


def test_the_driver_spawns_a_remote_slot_over_ssh(tmp_path, monkeypatch):
    """A slot on a host that is not this machine (192.0.2.1, RFC 5737:
    no packet goes to it) is spawned through ``ssh_command``, the worker
    env on ssh's stdin; the remote end is a stub ssh that runs it here
    in an emptied environment."""
    bin_dir, log = tmp_path / "bin", tmp_path / "ssh_log"
    bin_dir.mkdir()
    log.mkdir()
    (bin_dir / "ssh").write_text(STUB_SSH.format(log=log))
    (bin_dir / "ssh").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("LAUNCHER_ONLY_KEY", "stays")
    out = tmp_path / "env.json"
    server = _FakeServer()
    drv = torch_driver.ElasticDriver(
        server, torch_discovery.FixedHosts({"192.0.2.1": 1}), min_np=1,
        max_np=1, command=[sys.executable, "-c",
                           "import json, os; json.dump(dict(os.environ), "
                           f"open({str(out)!r}, 'w'))"],
        env={"EXPLICIT_KEY": "yes"}, platform="cpu")
    try:
        drv._spawn_worker("192.0.2.1:0")
        assert drv._procs["192.0.2.1:0"].wait(60) == 0
    finally:
        drv.stop()
        drv.join()
    calls = [p.read_bytes().split(b"\0")[:-1] for p in log.iterdir()]
    assert len(calls) == 1 and calls[0][-2] == b"192.0.2.1"
    assert not any(server.secret.hex().encode() in a for a in calls[0])
    env = json.loads(out.read_text())
    want = {"HOROVOD_ELASTIC": "1", "HOROVOD_HOSTNAME": "192.0.2.1",
            "HOROVOD_LOCAL_RANK": "0", "HOROVOD_TPU_RANKS_PER_PROC": "1",
            "HOROVOD_SECRET_KEY": server.secret.hex(),
            "HOROVOD_GLOO_RENDEZVOUS_PORT": "1234",
            "HOROVOD_TORCH_PLATFORM": "cpu", "EXPLICIT_KEY": "yes"}
    assert {k: env.get(k) for k in want} == want
    assert "LAUNCHER_ONLY_KEY" not in env
    # the driver's join removed the job's spill directory
    assert not os.path.exists(env["HOROVOD_STATE_SPILL"])
