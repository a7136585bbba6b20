"""The port's launcher surface against the JAX package's
(horovod_tpu_torch/runner/ vs horovod_tpu/runner/): host parsing and slot
assignment, the config file and the CLI's argument parsing give the same
results for the same inputs, and ``slot_env`` hands a worker the same
environment but for the platform and backend keys.  Plus the port's
refusals (the hybrid layout, elastic and other unported flags, autotune,
a compiled entry point on a multi-process engine) and its backend rule
for CUDA tensors, checked with fake device UUIDs."""

import argparse

import pytest
import torch
import torch.distributed as dist

from horovod_tpu.common.topology import Topology
from horovod_tpu.runner import config_parser as jax_config
from horovod_tpu.runner import hosts as jax_hosts
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner import proc_run as jax_proc_run
import horovod_tpu_torch as hvd
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import HorovodInitError
from horovod_tpu_torch.core.engine import Engine
from horovod_tpu_torch.runner import config_parser as torch_config
from horovod_tpu_torch.runner import gloo_run as torch_gloo_run
from horovod_tpu_torch.runner import hosts as torch_hosts
from horovod_tpu_torch.runner import launch as torch_launch
from horovod_tpu_torch.runner import proc_run as torch_proc_run

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
    (["-np", "2", "--ranks-per-worker", "2"], "A24"),
    (["-np", "2", "--min-np", "1"], "A17"),
    (["-np", "2", "--host-discovery-script", "d.sh"], "A17"),
    (["-np", "2", "--autotune"], "A14"),
    (["-np", "2", "--hierarchical-allreduce"], "A8"),
    (["-np", "2", "--bypass-after-cycles", "3"], "A23"),
    (["-np", "2", "--serve"], "A16"),
])
def test_cli_refuses_unported_flags(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        torch_launch.run_commandline(argv + ["--", "python", "t.py"])


def test_refusals_outside_the_cli():
    with pytest.raises(NotImplementedError, match="A24"):
        torch_proc_run.launch_procs(["true"], np=2, ranks_per_proc=2)
    with pytest.raises(NotImplementedError, match="A17"):
        torch_config.set_env_from_args(
            {}, argparse.Namespace(fault_plan="{}"))
    with pytest.raises(NotImplementedError, match="A17"):
        torch_gloo_run.gloo_run_elastic(None, {}, ["python"])
    with pytest.raises(NotImplementedError, match="A17"):
        torch_gloo_run.create_run_env_vars("h", None, 1, elastic=True)


def test_init_refuses_the_hybrid_layout(monkeypatch):
    monkeypatch.setenv("HOROVOD_CONTROLLER", "http")
    monkeypatch.setenv("HOROVOD_TPU_RANKS_PER_PROC", "2")
    with pytest.raises(NotImplementedError, match="A24"):
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
    proc_id, num_procs = 0, 1

    def report_ready(self, metas):
        pass

    def poll(self, wait=0.0):
        return []

    def forget(self, key):
        pass

    def heartbeat(self, **kw):
        return False


@pytest.fixture
def world_of_one(monkeypatch):
    pg = dist.ProcessGroupGloo(dist.PrefixStore("w1", dist.HashStore()),
                               0, 1)
    eng = Engine(1, "cpu", controller=_Controller(), rank_offset=0,
                 global_size=1, world_group=pg)
    monkeypatch.setattr(basics, "_engine", eng)
    monkeypatch.setattr(basics, "_host_of_rank", [0])
    yield eng
    eng.shutdown()
    basics.unbind_rank()


def test_multiproc_engine_uses_the_process_group(world_of_one):
    ex = world_of_one.process_sets[0].executor
    assert not ex.stacked and ex.num_ranks == 1
    assert world_of_one.multiproc


def test_compiled_entry_points_refuse_a_multiproc_engine(world_of_one):
    with pytest.raises(NotImplementedError, match="A22"):
        hvd.CompiledGroupedAllreduce()([torch.ones(4)])
    with pytest.raises(NotImplementedError, match="A22"):
        hvd.CompiledAlltoall()(torch.ones(4))
    step = hvd.make_compiled_train_step(
        lambda params, batch: params["w"].sum(),
        lambda params: torch.optim.SGD(params, lr=0.1))
    with pytest.raises(NotImplementedError, match="A22"):
        step.init_state({"w": torch.ones(2)})


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
