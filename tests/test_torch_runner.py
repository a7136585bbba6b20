"""The port's launcher surface against the JAX package's
(horovod_tpu_torch/runner/ vs horovod_tpu/runner/): host parsing and slot
assignment, the config file and the CLI's argument parsing give the same
results for the same inputs, and ``slot_env`` hands a worker the same
environment but for the platform and backend keys.  Plus the port's
refusals (the hybrid layout, chaos and other unported flags, autotune,
what the compiled path still refuses on a multi-process engine) and its
backend rule for CUDA tensors, checked with fake device UUIDs; the
compiled path over a one-process gloo group against the stacked program
(bit for bit), its capture rule, and the signature exchange's round id.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.common.topology import Topology
from horovod_tpu.runner import config_parser as jax_config
from horovod_tpu.runner import gloo_run as jax_gloo_run
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner import proc_run as jax_proc_run
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodInitError
from horovod_tpu_torch.core.engine import Engine
from horovod_tpu_torch.core.store_controller import StoreController
from horovod_tpu_torch.ops import compiled as C
from horovod_tpu_torch.parallel.train import adamw, sgd
from horovod_tpu_torch.runner import config_parser as torch_config
from horovod_tpu_torch.runner import gloo_run as torch_gloo_run
from horovod_tpu_torch.runner import hosts as torch_hosts
from horovod_tpu_torch.runner import launch as torch_launch
from horovod_tpu_torch.runner import proc_run as torch_proc_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HOSTS = ["a:2,b:4,c", "localhost:4", "h1:1,h2:1,h3:2", "x:3,y:3"]


@pytest.mark.parametrize("spec", HOSTS)
def test_parse_hosts_matches(spec):
    a = jax_hosts.parse_hosts(spec)
    b = torch_hosts.parse_hosts(spec)
    assert [(h.hostname, h.slots) for h in a] == \
        [(h.hostname, h.slots) for h in b]


@pytest.mark.parametrize("spec,np_", [("a:2,b:2", 3), ("a:2,b:4,c", 7),
                                      ("localhost:4", 4), ("x:3,y:3", 5)])
def test_host_assignments_match(spec, np_):
    a = jax_hosts.get_host_assignments(jax_hosts.parse_hosts(spec), np_)
    b = torch_hosts.get_host_assignments(torch_hosts.parse_hosts(spec), np_)
    assert [vars(s) for s in a] == [vars(s) for s in b]
    assert jax_proc_run.host_of_rank_env(a) == \
        torch_proc_run.host_of_rank_env(b)


def test_host_assignments_refuse_overcommit():
    for mod in (jax_hosts, torch_hosts):
        with pytest.raises(ValueError):
            mod.get_host_assignments(mod.parse_hosts("a:1"), 2)


def test_parse_host_files_match(tmp_path):
    f = tmp_path / "hostfile"
    f.write_text("# comment\nnode1 slots=4\nnode2\n\nnode3 slots=2 # x\n")
    assert jax_hosts.parse_host_files(str(f)) == \
        torch_hosts.parse_host_files(str(f)) == "node1:4,node2:1,node3:2"


ARGVS = [
    ["-np", "2", "--", "python", "train.py"],
    ["-np", "4", "-H", "a:2,b:2", "--fusion-threshold-mb", "32",
     "--cycle-time-ms", "2.5", "--cache-capacity", "16", "--", "python",
     "t.py"],
    ["-np", "2", "--cpu", "--wire-dtype", "int8", "--no-stall-check",
     "--log-level", "DEBUG", "--heartbeat-interval-seconds", "0.5",
     "python", "t.py"],
    ["-np", "2", "--disable-cache", "--stall-check-warning-time-seconds",
     "5", "--stall-check-shutdown-time-seconds", "30", "--wire-outer",
     "bf16", "--start-timeout", "60", "--output-filename", "/tmp/o",
     "--", "python", "t.py"],
    ["-np", "8", "--autotune", "--timeline-filename", "/tmp/t.json",
     "--min-np", "2", "--max-np", "8", "--ranks-per-worker", "2",
     "--torus-allreduce", "--pipeline-stages", "2", "--", "python",
     "t.py"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_parsing_matches(argv):
    a = jax_launch.parse_args(list(argv))
    b = torch_launch.parse_args(list(argv))
    assert vars(a) == vars(b)
    env_a, env_b = {}, {}
    jax_config.set_env_from_args(env_a, a)
    torch_config.set_env_from_args(env_b, b)
    assert env_a == env_b


def test_config_file_matches(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("fusion-threshold-mb: 16\ncycle-time-ms: 3.0\n"
                   "no-stall-check: true\nverbose: true\n"
                   "cache-capacity: 64\n")
    argv = ["-np", "2", "--cycle-time-ms", "9", "--config-file", str(cfg),
            "--", "python", "t.py"]
    a = jax_launch.parse_args(list(argv))
    b = torch_launch.parse_args(list(argv))
    assert vars(a) == vars(b)
    assert b.fusion_threshold_mb == 16 and b.cycle_time_ms == 9
    ns_a = jax_config.parse_config_file(str(cfg), argparse.Namespace(
        fusion_threshold_mb=None, verbose=False, unknown=None))
    ns_b = torch_config.parse_config_file(str(cfg), argparse.Namespace(
        fusion_threshold_mb=None, verbose=False, unknown=None))
    assert vars(ns_a) == vars(ns_b)


#: keys whose values belong to each package's own device handoff
JAX_ONLY_KEYS = {"JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES"}
PORT_KEYS = {"HOROVOD_CPU_OPERATIONS", "HOROVOD_TORCH_PLATFORM"}


@pytest.mark.parametrize("platform", [None, "cpu"])
def test_slot_env_matches_but_for_the_platform(platform):
    slots = torch_hosts.get_host_assignments(
        torch_hosts.parse_hosts("a:2,b:2"), 4)
    hof = torch_proc_run.host_of_rank_env(slots)
    kw = dict(rdv_addr="127.0.0.1", rdv_port=1234,
              coordinator="127.0.0.1:999", secret_hex="ab", num_procs=4,
              platform=platform, host_of_rank=hof)
    for slot in slots:
        a = jax_proc_run.slot_env(slot, **kw)
        b = torch_proc_run.slot_env(slot, **kw)
        drop = JAX_ONLY_KEYS | PORT_KEYS
        assert {k: v for k, v in a.items() if k not in drop} == \
            {k: v for k, v in b.items() if k not in drop}
        assert b["HOROVOD_CPU_OPERATIONS"] == "gloo"
        assert b.get("HOROVOD_TORCH_PLATFORM") == platform
        assert not set(b) & JAX_ONLY_KEYS


def test_ssh_command_keeps_the_secret_off_argv():
    argv, payload = torch_proc_run.ssh_command(
        "host1", ["python", "t.py"],
        {"HOROVOD_SECRET_KEY": "s3cret", "HOME": "/x"}, cwd="/w")
    assert "s3cret" not in " ".join(argv)
    assert b"export HOROVOD_SECRET_KEY=s3cret" in payload
    assert b"HOME" not in payload
    assert argv[:2] == ["ssh", "-o"] and "host1" in argv


def test_gloo_run_env_helpers():
    slot = torch_hosts.get_host_assignments(
        torch_hosts.parse_hosts("a:2"), 2)[1]
    env = torch_gloo_run.create_slot_env_vars(slot)
    assert env["HOROVOD_RANK"] == "1" and env["HOROVOD_LOCAL_SIZE"] == "2"
    run = torch_gloo_run.create_run_env_vars("10.0.0.1", ["eth0"], 80)
    assert run["HOROVOD_CONTROLLER"] == "http" and \
        run["HOROVOD_GLOO_IFACE"] == "eth0"


# -- refusals -----------------------------------------------------------------

@pytest.mark.parametrize("argv,item", [
    (["-np", "2", "--pipeline-stages", "2"], "A15"),
    (["-np", "2", "--fault-plan",
      '{"events": [{"kind": "revoke_host", "host": "h", "after": 1}]}'],
     "A17"),
    (["-np", "2", "--fleet-spec", "fleet.json"], "A17"),
    (["-np", "2", "--autotune"], "A14"),
    (["-np", "2", "--autotune-log-file", "a.csv"], "A14"),
    (["-np", "2", "--serve-port", "8500"], "A16"),
    (["-np", "2", "--serve"], "A16"),
])
def test_cli_refuses_unported_flags(argv, item):
    """What the CLI still refuses; ``--ranks-per-worker``, the bypass
    flags (``test_cli_takes_the_hybrid_and_bypass_flags``), the elastic
    flags (tests/test_torch_elastic_jobs.py), and the chaos, journal and
    aggregator-tier flags (tests/test_torch_chaos.py) are ported: a fault
    plan is refused only where it names a kind whose consumer is not
    ported.  The autotune flags (A14) are ported: they reach the env the
    JAX launcher's reach."""
    if item == "A14":
        full = argv + ["--", "python", "t.py"]
        env, ref_env = {}, {}
        torch_config.set_env_from_args(env, torch_launch.parse_args(full))
        jax_config.set_env_from_args(ref_env, jax_launch.parse_args(full))
        keys = {k for k in ref_env if k.startswith("HOROVOD_AUTOTUNE")}
        assert keys
        assert {k: env.get(k) for k in keys} == \
            {k: ref_env[k] for k in keys}
        return
    with pytest.raises(NotImplementedError, match=item):
        torch_launch.run_commandline(argv + ["--", "python", "t.py"])


@pytest.mark.parametrize("flags,want", [
    (["--hierarchical-allreduce"], ["hierarchical", None, None]),
    (["--torus-allreduce"], ["torus", None, None]),
    (["--allreduce-algorithm", "torus"], ["torus", None, None]),
    (["--hierarchical-allreduce", "--wire-inner", "bf16", "--wire-outer",
      "int8"], ["hierarchical", "bf16", "int8"]),
], ids=["hierarchical", "torus", "generic", "wire-pair"])
def test_cli_hands_the_2d_flags_to_the_workers(tmp_path, monkeypatch, flags,
                                               want):
    """The 2-D algorithm flags and the inner wire reach a launched
    worker's environment, mapped as the JAX CLI maps them, and its
    ``Config`` reads them."""
    full = ["-np", "1", "--cpu"] + flags
    keys = ("HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_TORUS_ALLREDUCE",
            "HOROVOD_ALLREDUCE_ALGORITHM", "HOROVOD_WIRE_INNER",
            "HOROVOD_WIRE_OUTER")
    env, ref_env = {}, {}
    torch_config.set_env_from_args(env, torch_launch.parse_args(full))
    jax_config.set_env_from_args(ref_env, jax_launch.parse_args(full))
    assert {k: env.get(k) for k in keys} == \
        {k: ref_env.get(k) for k in keys}
    out = tmp_path / "cfg.json"
    code = ("import json, os; from horovod_tpu_torch.common.env import "
            "Config; c = Config(); json.dump([[c.algorithm, c.wire_inner, "
            "c.wire_dtype], {k: os.environ.get(k) for k in %r}], "
            "open(os.environ['CFG_OUT'], 'w'))" % (keys,))
    monkeypatch.setenv("CFG_OUT", str(out))
    monkeypatch.setenv("PYTHONPATH", REPO)
    assert torch_launch.run_commandline(
        full + ["--", sys.executable, "-c", code]) == 0
    cfg, worker_env = json.loads(out.read_text())
    assert cfg == want
    assert worker_env == {k: env.get(k) for k in keys}


def test_cli_takes_the_hybrid_and_bypass_flags():
    """``--ranks-per-worker`` (N or host) and the bypass flags reach the
    launcher and the workers' environment as the JAX CLI maps them."""
    for argv in (["-np", "4", "--ranks-per-worker", "2"],
                 ["-np", "3", "--ranks-per-worker", "host"],
                 ["-np", "2", "--bypass-after-cycles", "3",
                  "--bypass-wait-seconds", "2.5"]):
        full = argv + ["--", "python", "t.py"]
        args = torch_launch.parse_args(full)
        assert torch_launch.unported_flags(args) == []
        ref = jax_launch.parse_args(full)
        assert args.ranks_per_proc == ref.ranks_per_proc
        env, ref_env = {}, {}
        torch_config.set_env_from_args(env, args)
        jax_config.set_env_from_args(ref_env, ref)
        for key in ("HOROVOD_BYPASS_AFTER_CYCLES",
                    "HOROVOD_BYPASS_WAIT_SECONDS"):
            assert env.get(key) == ref_env.get(key)
    assert env["HOROVOD_BYPASS_AFTER_CYCLES"] == "3"


@pytest.mark.parametrize("flags,key,want", [
    (["--timeline-filename", "/tmp/tl.json"], "HOROVOD_TIMELINE",
     "/tmp/tl.json"),
    (["--timeline-mark-cycles"], "HOROVOD_TIMELINE_MARK_CYCLES", "1"),
    (["--trace-ring-events", "512"], "HOROVOD_TRACE_RING_EVENTS", "512"),
    (["--trace-dump-dir", "/tmp/dumps"], "HOROVOD_TRACE_DUMP_DIR",
     "/tmp/dumps"),
    (["--trace-clock-sync-seconds", "3"],
     "HOROVOD_TRACE_CLOCK_SYNC_SECONDS", "3.0"),
    (["--metrics-port", "9100"], "HOROVOD_METRICS_PORT", "9100"),
    (["--metrics-push-seconds", "0.5"], "HOROVOD_METRICS_PUSH_SECONDS",
     "0.5"),
])
def test_cli_takes_the_tracing_and_metrics_flags(flags, key, want):
    """The seven tracing and metrics flags are no longer refused and reach
    the workers' environment as the JAX CLI maps them."""
    full = ["-np", "2"] + flags + ["--", "python", "t.py"]
    args = torch_launch.parse_args(full)
    assert torch_launch.unported_flags(args) == []
    env, ref_env = {}, {}
    torch_config.set_env_from_args(env, args)
    jax_config.set_env_from_args(ref_env, jax_launch.parse_args(full))
    assert env[key] == ref_env[key] == want


def test_refusals_outside_the_cli(monkeypatch):
    """What the launcher still refuses: an np that the rank threads per
    process do not divide, or that is over the slots of ``-H`` (as the
    JAX package's launcher), and a fault plan that names a kind whose
    consumer is not ported (the fleet's host revocation, A17), in an
    elastic job too; the integrity flips (A14) are ported and pass.
    Workers on remote hosts (tests/test_torch_remote.py) and elastic runs
    (tests/test_torch_elastic_jobs.py) are ported: the elastic handoff
    adds what the JAX package's adds."""
    with pytest.raises(ValueError, match="ranks_per_proc='host'"):
        torch_proc_run.launch_procs(["true"], np=3, ranks_per_proc=2)
    with pytest.raises(ValueError, match="exceeds"):
        torch_proc_run.launch_procs(["true"], np=4, ranks_per_proc="host",
                                    hosts="localhost:2,127.0.0.1:1")
    flips = json.dumps({"events": [{"kind": "bitflip_wire", "proc": 0,
                                    "after_buckets": 2}]})
    env = {}
    torch_config.set_env_from_args(
        env, argparse.Namespace(fault_plan=flips))
    assert env["HOROVOD_FAULT_PLAN"] == flips
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.elastic.settings import ElasticSettings
    settings = ElasticSettings(
        discovery=FixedHosts({"localhost": 1}), min_num_proc=1,
        max_num_proc=1, elastic_timeout=10, reset_limit=None, num_proc=1)
    with pytest.raises(NotImplementedError, match="A17"):
        torch_gloo_run.gloo_run_elastic(
            settings, {"HOROVOD_FAULT_PLAN": json.dumps(
                {"events": [{"kind": "revoke_host", "host": "h",
                             "after": 1}]})}, ["python"])

    def elastic_keys(mod):
        on = mod.create_run_env_vars("h", None, 1, elastic=True)
        off = mod.create_run_env_vars("h", None, 1)
        return {k: v for k, v in on.items() if off.get(k) != v}
    assert elastic_keys(torch_gloo_run) == elastic_keys(jax_gloo_run) == {
        "HOROVOD_ELASTIC": "1"}


def test_init_refuses_the_hybrid_layout(monkeypatch):
    """The hybrid layout is ported; what init still refuses about it is a
    stale or incomplete hand-off: a per-process rank table of the wrong
    length, or no coordinator address."""
    monkeypatch.setenv("HOROVOD_CONTROLLER", "http")
    monkeypatch.setenv("HOROVOD_TPU_RANKS_PER_PROC", "2")
    with pytest.raises(HorovodInitError, match="HOROVOD_TPU_COORDINATOR"):
        basics.init(device="cpu")
    assert not basics.is_initialized()
    monkeypatch.setenv("HOROVOD_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("HOROVOD_TPU_NUM_PROCS", "2")
    monkeypatch.setenv("HOROVOD_TPU_RANKS_OF_PROC", "2,1,1")
    with pytest.raises(HorovodInitError, match="RANKS_OF_PROC"):
        basics.init(device="cpu")
    assert not basics.is_initialized()


def test_check_build_lists_the_port(capsys):
    assert torch_launch.run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "PyTorch" in out and "NCCL" in out and "JAX" not in out


# -- the backend rule for CUDA tensors -----------------------------------------

def test_nccl_on_a_shared_gpu_raises_naming_gloo():
    with pytest.raises(HorovodInitError,
                       match="HOROVOD_GPU_OPERATIONS=gloo"):
        basics.check_gpu_operations(["GPU-aaa", "GPU-aaa"], "nccl")
    with pytest.raises(HorovodInitError, match="processes 0 and 2"):
        basics.check_gpu_operations(["GPU-a", "GPU-b", "GPU-a"], "nccl")


def test_distinct_gpus_or_gloo_pass():
    basics.check_gpu_operations(["GPU-a", "GPU-b"], "nccl")
    basics.check_gpu_operations(["GPU-a", "GPU-a"], "gloo")
    with pytest.raises(HorovodInitError, match="nccl or gloo"):
        basics.check_gpu_operations(["GPU-a"], "mpi")


# -- a multi-process engine in one process (a world of one) -------------------

class _Controller:
    """The StoreController surface the engine calls, with no
    coordinator: nothing is ever scheduled."""
    proc_id, num_procs, round_id = 0, 1, 0

    def report_ready(self, metas):
        pass

    def poll(self, wait=0.0):
        return []

    def forget(self, key):
        pass

    def heartbeat(self, **kw):
        return False

    def take_rereport(self):
        return False


@pytest.fixture
def world_of_one(monkeypatch):
    store = dist.HashStore()
    pg = dist.ProcessGroupGloo(dist.PrefixStore("w1", store), 0, 1)
    cpg = dist.ProcessGroupGloo(dist.PrefixStore("w1c", store), 0, 1)
    eng = Engine(1, "cpu", controller=_Controller(), rank_offset=0,
                 global_size=1, world_group=pg, compiled_group=cpg)
    monkeypatch.setattr(basics, "_engine", eng)
    monkeypatch.setattr(basics, "_host_of_rank", [0])
    yield eng
    eng.shutdown()
    basics.unbind_rank()


def test_multiproc_engine_uses_the_process_group(world_of_one):
    ps = world_of_one.process_sets[0]
    ex, cex = ps.executor, ps.compiled_executor
    assert not ex.stacked and ex.num_ranks == 1
    assert world_of_one.multiproc
    # the compiled path has a group of its own over the same processes
    assert not cex.stacked and cex.num_ranks == 1
    assert cex.group is not ex.group


def test_compiled_entry_points_refuse_a_multiproc_engine(world_of_one,
                                                         monkeypatch):
    """What stays refused on a multi-process engine: a hint that is no
    TopologyHint (a ValueError, as in the JAX package), Adasum with the
    sharded step (a ValueError, as in the JAX package; the dense Adasum
    step is ported).  The integrity digests (A14) and the 2-D
    decompositions run (at one rank the policy degrades to flat; a hint
    that does not factor the set is a ValueError)."""
    def step():
        return hvd.make_compiled_train_step(
            lambda params, batch: params["w"].sum(),
            lambda params: torch.optim.SGD(params, lr=0.1))
    with pytest.raises(ValueError, match="must be a TopologyHint"):
        hvd.CompiledGroupedAllreduce(topology_hint=("a", "b"))
    with pytest.raises(ValueError, match="must be a TopologyHint"):
        hvd.CompiledAlltoall(topology_hint=("a", "b"))
    with pytest.raises(ValueError, match="must be a TopologyHint"):
        hvd.make_compiled_train_step(
            lambda params, batch: params["w"].sum(), sgd(0.1),
            topology_hint=("a", "b"))
    with pytest.raises(ValueError, match="adasum"):
        hvd.make_compiled_train_step(
            lambda params, batch: params["w"].sum(), sgd(0.1),
            op=hvd.Adasum, sharded=True)
    from horovod_tpu_torch import telemetry as ttel
    assert world_of_one.integrity is not None
    ok0 = ttel.counter_total(ttel.INTEGRITY_CHECKS_FAMILY, result="ok",
                             site="compiled")
    assert torch.equal(hvd.CompiledGroupedAllreduce(force_program=True)(
        [torch.ones(4)])[0], torch.ones(4))
    assert torch.equal(hvd.CompiledAlltoall(force_program=True)(
        torch.ones(4)), torch.ones(4))
    assert ttel.counter_total(ttel.INTEGRITY_CHECKS_FAMILY, result="ok",
                              site="compiled") == ok0 + 2
    # several rank threads per process are ported (tests/
    # test_torch_hybrid.py), and so are the 2-D decompositions (tests/
    # test_torch_allreduce_2d_multiprocess.py)
    red = hvd.CompiledGroupedAllreduce(algorithm="torus", force_program=True)
    assert torch.equal(red([torch.arange(4.0)])[0], torch.arange(4.0))
    assert red.last_algorithm == "flat"
    assert C.TopologyHint().key() == (("cross", "local"), (1, 1), 0)
    with pytest.raises(ValueError, match="do not factor"):
        hvd.CompiledGroupedAllreduce(
            force_program=True, topology_hint=C.TopologyHint())(
                [torch.ones(4)])
    with pytest.raises(ValueError, match="must be a TopologyHint"):
        hvd.compiled_alltoall(torch.ones(4), topology_hint=("a", "b"))
    state = step().init_state({"w": torch.ones(2)})
    assert set(state) == {"params", "opt_state"}


def _tiny_step_runs():
    """A small MLP through the dense compiled step (SGD momentum,
    Average), the sharded one (AdamW, int8 wire) and the compiled reducer
    (int8 wire with error feedback, and full width) on the current
    engine; every result as numpy."""
    rng = np.random.default_rng(3)
    params = {"w1": rng.standard_normal((6, 5)).astype(np.float32) * 0.3,
              "b1": rng.standard_normal(5).astype(np.float32) * 0.1,
              "w2": rng.standard_normal((5, 3)).astype(np.float32) * 0.3}
    batches = [(torch.from_numpy(rng.standard_normal((4, 6))
                                 .astype(np.float32)),
                torch.from_numpy(rng.standard_normal((4, 3))
                                 .astype(np.float32))) for _ in range(3)]

    def loss_fn(p, batch):
        x, y = batch
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return ((h @ p["w2"] - y) ** 2).mean()

    out = {}
    for label, opt, kw in (("dense", sgd(0.1, momentum=0.9), {}),
                           ("int8", adamw(1e-2),
                            {"sharded": True, "wire_dtype": "int8"})):
        step = hvd.make_compiled_train_step(loss_fn, opt, **kw)
        state = step.init_state(params)
        for i, batch in enumerate(batches):
            state, loss = step(state, batch)
            out[f"{label}.loss{i}"] = loss.numpy().copy()
        for k, v in state["params"].items():
            out[f"{label}.{k}"] = v.detach().numpy().copy()
        for k, v in state.get("grad_ef", {}).items():
            out[f"{label}.ef.{k}"] = v.numpy().copy()
    for wire in (None, "int8"):
        red = hvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=True, force_program=True,
            name=f"t{wire}")
        for call in range(2):
            res = red([torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)) for s in ((300,), (7, 11))])
            for j, t in enumerate(res):
                out[f"red.{wire}.{call}.{j}"] = t.numpy().copy()
    return out


def test_compiled_path_over_a_gloo_group_of_one_is_the_stacked_program(
        world_of_one, monkeypatch):
    """The dense and sharded steps and the reducer over a size-1
    ProcessGroupGloo (the compiled group's executor) equal the same
    entry points over the stacked executor bit for bit."""
    got = _tiny_step_runs()
    assert C.program_cache_stats(by_rule=True)["plain"] >= 2
    C.reset_compiled_state()
    stacked = Engine(1, "cpu")
    try:
        monkeypatch.setattr(basics, "_engine", stacked)
        assert stacked.process_sets[0].compiled_executor.stacked
        want = _tiny_step_runs()
    finally:
        stacked.shutdown()
        C.reset_compiled_state()
    assert sorted(got) == sorted(want)
    bad = [k for k in got if not np.array_equal(got[k], want[k])]
    assert not bad, bad


@pytest.mark.parametrize("device,backend,rule", [
    ("cuda", "nccl", "graph"), ("cuda:0", None, "graph"),
    ("cuda", "gloo", "uncaptured"), ("cpu", "gloo", "plain"),
    ("cpu", None, "plain")])
def test_capture_rule(device, backend, rule):
    """Decided before any capture, from the device and the compiled
    group's backend: NCCL (or stacked) on the card is one graph, gloo on
    the card runs uncaptured, the CPU is plain."""
    assert C.capture_rule(device, backend) == rule


def test_executor_backend_names_the_group(world_of_one):
    cex = world_of_one.process_sets[0].compiled_executor
    assert C.executor_backend(cex, "cpu") == "gloo"
    stacked = world_of_one.process_sets[0].executor.__class__("cpu", 2)
    assert C.executor_backend(stacked, "cpu") is None


class _KV:
    """The store client surface of the signature exchange."""

    def __init__(self, peer=None):
        self.data, self.peer = {}, peer

    def put(self, key, value):
        self.data[key] = value

    def get(self, key, wait=0.0):
        return self.peer(key) if self.peer else self.data.get(key)


def test_store_controller_keeps_the_round_id():
    assert StoreController("127.0.0.1", 1, None, 0, 2, 1).round_id == 0
    assert StoreController("127.0.0.1", 1, None, 0, 2, 1,
                           round_id=3).round_id == 3


@pytest.mark.parametrize("peer,raises", [
    ("same", None), ("other", ValueError), ("absent", RuntimeError)])
def test_signature_exchange_keys_by_round(monkeypatch, peer, raises):
    """Each process publishes its Nth fingerprint under the round id and
    reads its peers': equal passes, different raises ValueError, a peer
    that never publishes raises RuntimeError after the timeout."""
    monkeypatch.setenv("HOROVOD_COMPILED_SIG_TIMEOUT", "1")
    sig = ((4,), "float32")
    fp = json.dumps(sig, sort_keys=True).encode()
    answer = {"same": fp, "other": b'[[5], "float32"]', "absent": None}
    ctl = type("Ctl", (), {})()
    ctl.proc_id, ctl.num_procs, ctl.round_id = 0, 2, 7
    ctl.client = _KV(peer=lambda key: answer[peer])
    eng = type("Eng", (), {"controller": ctl})()
    ps = type("PS", (), {"id": 0})()
    C.reset_compiled_state()
    if raises is None:
        C._validate_signature_cross_process(eng, ps, ("t",), sig)
    else:
        with pytest.raises(raises, match="signature"):
            C._validate_signature_cross_process(eng, ps, ("t",), sig)
    (key,) = ctl.client.data
    assert key.startswith("/compiled_sig/7/0/") and key.endswith("/0/0")
    assert ctl.client.data[key] == fp
    C.reset_compiled_state()


@pytest.mark.parametrize("hosts", [[0, 0, 1, 1], [0, 0, 0, 1, 1],
                                   [0, 1, 2], [0, 0, 1, 1, 1, 1]])
def test_topology_queries_match_the_reference(monkeypatch, hosts):
    """rank/local/cross queries over a host layout, against the JAX
    package's Topology."""
    topo = Topology(size=len(hosts), host_of_rank=list(hosts))
    monkeypatch.setattr(basics, "_host_of_rank", list(hosts))
    monkeypatch.setattr(basics, "_engine", object())
    for r in range(len(hosts)):
        monkeypatch.setattr(basics, "rank", lambda r=r: r)
        assert (basics.local_rank(), basics.local_size(),
                basics.cross_rank(), basics.cross_size()) == \
            (topo.local_rank(r), topo.local_size(r), topo.cross_rank(r),
             topo.cross_size(r))
    assert basics.is_homogeneous() == topo.is_homogeneous()
