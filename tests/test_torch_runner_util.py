"""The port's reference-shaped runner helpers against the JAX package's
(horovod_tpu_torch/runner/{common,util,driver,task}, run_task.py,
mpi_run.py, js_run.py and launch.py's reference surface vs horovod_tpu's):
each helper is called in both packages with the same inputs and the
outputs compared; the codec round-trips across the packages; the
driver/task and compute service flows of tests/test_aux.py run on the
port; MPI and jsrun launches raise, naming the port's launcher.
"""

import argparse
import io
import os
import threading

import pytest

from horovod_tpu.runner import js_run as jax_js_run
from horovod_tpu.runner import launch as jax_launch
from horovod_tpu.runner import mpi_run as jax_mpi_run
from horovod_tpu.runner import run_task as jax_run_task
from horovod_tpu.runner.common.util import codec as jax_codec
from horovod_tpu.runner.common.util import config_parser as jax_cfg
from horovod_tpu.runner.common.util import env as jax_env
from horovod_tpu.runner.common.util import host_hash as jax_host_hash
from horovod_tpu.runner.common.util import hosts as jax_hosts
from horovod_tpu.runner.common.util import safe_shell_exec as jax_safe
from horovod_tpu.runner.common.util import secret as jax_secret
from horovod_tpu.runner.common.util import settings as jax_settings
from horovod_tpu.runner.common.util import timeout as jax_timeout
from horovod_tpu.runner.common.util import tiny_shell_exec as jax_tiny
from horovod_tpu.runner.driver import driver_service as jax_driver
from horovod_tpu.runner.util import cache as jax_cache
from horovod_tpu.runner.util import lsf as jax_lsf
from horovod_tpu.runner.util import network as jax_network
from horovod_tpu.runner.util import remote as jax_remote
from horovod_tpu.runner.util import threads as jax_threads
from horovod_tpu_torch.runner import js_run as torch_js_run
from horovod_tpu_torch.runner import launch as torch_launch
from horovod_tpu_torch.runner import mpi_run as torch_mpi_run
from horovod_tpu_torch.runner import run_task as torch_run_task
from horovod_tpu_torch.runner.common.service import (
    compute_service as torch_compute,
)
from horovod_tpu_torch.runner.common.service import (
    driver_service as torch_driver_service,
)
from horovod_tpu_torch.runner.common.service import (
    task_service as torch_task_service,
)
from horovod_tpu_torch.runner.common.util import codec as torch_codec
from horovod_tpu_torch.runner.common.util import config_parser as torch_cfg
from horovod_tpu_torch.runner.common.util import env as torch_env
from horovod_tpu_torch.runner.common.util import host_hash as torch_host_hash
from horovod_tpu_torch.runner.common.util import hosts as torch_hosts
from horovod_tpu_torch.runner.common.util import safe_shell_exec as torch_safe
from horovod_tpu_torch.runner.common.util import secret as torch_secret
from horovod_tpu_torch.runner.common.util import settings as torch_settings
from horovod_tpu_torch.runner.common.util import timeout as torch_timeout
from horovod_tpu_torch.runner.common.util import tiny_shell_exec as torch_tiny
from horovod_tpu_torch.runner.driver import driver_service as torch_driver
from horovod_tpu_torch.runner.http.http_server import RendezvousServer
from horovod_tpu_torch.runner.task import task_service as torch_task
from horovod_tpu_torch.runner.util import cache as torch_cache
from horovod_tpu_torch.runner.util import lsf as torch_lsf
from horovod_tpu_torch.runner.util import network as torch_network
from horovod_tpu_torch.runner.util import remote as torch_remote
from horovod_tpu_torch.runner.util import streams as torch_streams
from horovod_tpu_torch.runner.util import threads as torch_threads


def _slot_tuple(s):
    return (s.hostname, s.rank, s.local_rank, s.local_size, s.cross_rank,
            s.cross_size, s.size)


# -- runner/common/util -------------------------------------------------------

@pytest.mark.parametrize("salt", [None, "other", "ü-salt"])
def test_host_hash_matches(salt):
    assert torch_host_hash.host_hash(salt) == jax_host_hash.host_hash(salt)


@pytest.mark.parametrize("spec,lo,hi", [
    ("a:2,b:3", 2, 4), ("a:2,b:3", 5, None), ("h1:1,h2:1,h3:2", 1, 3),
    ("x:4", 2, 9)])
def test_common_hosts_match(spec, lo, hi):
    assert torch_hosts.parse_hosts_and_slots(spec) == \
        jax_hosts.parse_hosts_and_slots(spec)
    got = torch_hosts.get_host_assignments(
        torch_hosts.parse_hosts(spec), lo, max_num_proc=hi)
    ref = jax_hosts.get_host_assignments(
        jax_hosts.parse_hosts(spec), lo, max_num_proc=hi)
    assert [_slot_tuple(s) for s in got] == [_slot_tuple(s) for s in ref]
    assert _slot_tuple(torch_hosts.INVALID_SLOT_INFO) == \
        _slot_tuple(jax_hosts.INVALID_SLOT_INFO)


def test_common_hosts_refuse_the_same():
    for mod in (torch_hosts, jax_hosts):
        with pytest.raises(ValueError, match="at least 6"):
            mod.get_host_assignments(mod.parse_hosts("a:2,b:3"), 6,
                                     max_num_proc=8)


@pytest.mark.parametrize("message", [
    "Timed out waiting for {activity}.",
    "Timed out waiting for {activity} after {timeout} s."])
def test_timeout_message_matches(message):
    msgs = []
    for mod in (torch_timeout, jax_timeout):
        t = mod.Timeout(-1, message)
        assert t.timed_out() and t.remaining() == 0.0
        with pytest.raises(mod.TimeoutException) as info:
            t.check_time_out_for("tasks to start")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    fresh = torch_timeout.Timeout(60)
    fresh.check_time_out_for("nothing")
    assert 0 < fresh.remaining_time_s() <= 60


@pytest.mark.parametrize("command", [
    "echo hello; exit 3", "echo out; echo err 1>&2", "exit 0",
    "printf 'a\\nb\\n'; exit 7"])
def test_safe_shell_exec_matches(command):
    got = []
    for mod in (torch_safe, jax_safe):
        out, err = io.StringIO(), io.StringIO()
        code = mod.execute(command, stdout=out, stderr=err, index=2)
        plain = mod.execute(command + " >/dev/null 2>&1")
        got.append((code, plain, out.getvalue(), err.getvalue()))
    assert got[0] == got[1]


def test_safe_shell_exec_event_ends_the_tree():
    codes = []
    for mod in (torch_safe, jax_safe):
        ev = threading.Event()
        threading.Timer(0.2, ev.set).start()
        codes.append(mod.execute("sleep 30; exit 1", events=[ev]))
    assert codes[0] == codes[1] == -15


@pytest.mark.parametrize("command", [
    "echo a; echo b 1>&2; exit 2", "true", "printf 'x'"])
def test_tiny_shell_exec_matches(command):
    assert torch_tiny.execute(command) == jax_tiny.execute(command)


def test_secret_matches():
    key = torch_secret.make_secret_key()
    assert len(key) == torch_secret.SECRET_LENGTH == jax_secret.SECRET_LENGTH
    d = torch_secret.compute_digest(key, b"message")
    assert d == jax_secret.compute_digest(key, b"message")
    assert jax_secret.check_digest(key, b"message", d)
    assert not torch_secret.check_digest(key, b"other", d)


@pytest.mark.parametrize("value", [
    {"x": (1, 2)}, [1.5, "s", None], b"\x00bytes", {"nested": {"a": [1]}}])
def test_codec_round_trips_across_the_packages(value):
    assert jax_codec.loads_base64(torch_codec.dumps_base64(value)) == value
    assert torch_codec.loads_base64(jax_codec.dumps_base64(value)) == value
    raw = torch_codec.dumps_base64(value, to_ascii=False)
    assert isinstance(raw, bytes)
    assert jax_codec.loads_base64(raw) == value


def test_codec_without_cloudpickle(monkeypatch):
    """The codec falls back to pickle where cloudpickle is missing (the
    GPU machines the port runs on need not have it)."""
    import builtins
    real = builtins.__import__

    def no_cloudpickle(name, *a, **kw):
        if name == "cloudpickle":
            raise ImportError(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_cloudpickle)
    enc = torch_codec.dumps_base64({"k": [1, 2]})
    assert jax_codec.loads_base64(enc) == {"k": [1, 2]}


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1)),
    ({"HOROVOD_RANK": "3", "HOROVOD_SIZE": "8"}, (3, 8)),
    ({"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "2"}, (1, 2)),
    ({"PMI_RANK": "5", "PMI_SIZE": "6"}, (5, 6)),
    ({"HOROVOD_RANK": "1"}, RuntimeError)])
def test_env_rank_and_size_match(monkeypatch, env, want):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "PMI_RANK", "PMI_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in (torch_env, jax_env):
        if want is RuntimeError:
            with pytest.raises(RuntimeError, match="only one of"):
                mod.get_env_rank_and_size()
        else:
            assert mod.get_env_rank_and_size() == want


def test_env_predicates_match(monkeypatch):
    for name in ("PATH", "OLDPWD", "BASH_FUNC_x%%", "HOROVOD_SECRET_KEY",
                 "HOROVOD_RANK"):
        assert torch_env.is_exportable(name) == jax_env.is_exportable(name)
    assert torch_env.LOG_LEVEL_STR == jax_env.LOG_LEVEL_STR
    monkeypatch.setenv("OMPI_MCA_plm_rsh_agent", torch_env.KUBEFLOW_MPI_EXEC)
    assert torch_env.is_kubeflow_mpi() and jax_env.is_kubeflow_mpi()


@pytest.mark.parametrize("kwargs", [
    {}, {"num_proc": 4, "verbose": 2, "ssh_port": 2222, "nics": {"eth0"}},
    {"hosts": "a:2,b:2", "start_timeout": 30, "output_filename": "/o",
     "prefix_output_with_timestamp": True, "elastic": True}])
def test_settings_match(kwargs):
    assert vars(torch_settings.Settings(**kwargs)) == \
        vars(jax_settings.Settings(**kwargs))


def test_config_parser_surface_matches():
    names = [n for n in dir(jax_cfg) if n.isupper()]
    assert {n: getattr(torch_cfg, n) for n in names} == \
        {n: getattr(jax_cfg, n) for n in names}
    outs = []
    for mod in (torch_cfg, jax_cfg):
        args = argparse.Namespace(fusion_threshold_mb=None, cycle_time_ms=5,
                                  cache_capacity=None)
        mod.set_args_from_config(
            args, {"fusion-threshold-mb": 32, "cycle-time-ms": 9,
                   "cache-capacity": 7, "unknown": 1}, {"cycle_time_ms"})
        outs.append(vars(args))
        mod.validate_config_args(args)
        with pytest.raises(ValueError, match="fusion"):
            mod.validate_config_args(argparse.Namespace(
                fusion_threshold_mb=-1))
    assert outs[0] == outs[1] == {"fusion_threshold_mb": 32,
                                  "cycle_time_ms": 5, "cache_capacity": 7}


# -- runner/util ---------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("python train.py", "h1", None, None, None),
    ("python train.py", "h2", 2222, "/k/id_rsa", 10),
    ("cd /w && exec x", "10.0.0.1", 22, None, 5)])
def test_remote_command_strings_match(monkeypatch, args):
    monkeypatch.delenv("OMPI_MCA_plm_rsh_agent", raising=False)
    assert torch_remote.get_ssh_command(*args) == \
        jax_remote.get_ssh_command(*args)
    assert torch_remote.get_remote_command(*args) == \
        jax_remote.get_remote_command(*args)
    monkeypatch.setenv("OMPI_MCA_plm_rsh_agent", jax_env.KUBEFLOW_MPI_EXEC)
    assert torch_remote.get_remote_command(*args) == \
        jax_remote.get_remote_command(*args)


@pytest.mark.parametrize("lsb,num_proc", [
    ({"LSB_MCPU_HOSTS": "batch 1 n1 4 n2 4"}, 8),
    ({"LSB_MCPU_HOSTS": "n1 3 n2 2"}, 5),
    ({"LSB_HOSTS": "n1 n1 n2 n3 n3"}, 7)])
def test_lsf_and_rankfile_match(monkeypatch, tmp_path, lsb, num_proc):
    for k in ("LSB_JOBID", "LSB_MCPU_HOSTS", "LSB_HOSTS"):
        monkeypatch.delenv(k, raising=False)
    for mod in (torch_js_run, jax_js_run):
        with pytest.raises(RuntimeError, match="LSF"):
            mod.generate_jsrun_rankfile(
                torch_settings.Settings(num_proc=num_proc),
                str(tmp_path / "none"))
    monkeypatch.setenv("LSB_JOBID", "42")
    for k, v in lsb.items():
        monkeypatch.setenv(k, v)
    for q in ("using_lsf", "get_compute_hosts", "get_num_processes",
              "get_num_cores", "get_num_threads"):
        assert getattr(torch_lsf.LSFUtils, q)() == \
            getattr(jax_lsf.LSFUtils, q)()
    with pytest.raises(RuntimeError, match="CSM"):
        torch_lsf.LSFUtils.get_num_gpus()
    files = []
    for mod, name in ((torch_js_run, "torch"), (jax_js_run, "jax")):
        path = mod.generate_jsrun_rankfile(
            torch_settings.Settings(num_proc=num_proc),
            str(tmp_path / f"{name}.rankfile"))
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    assert files[0].count(b"rank: ") == num_proc


def test_network_helpers_match():
    assert torch_network.get_local_host_addresses() == \
        jax_network.get_local_host_addresses()
    # IP literals and localhost: no name lookup leaves the machine
    names = ["127.0.0.1", "localhost", "192.0.2.1", "198.51.100.7"]
    assert torch_network.filter_local_addresses(names) == \
        jax_network.filter_local_addresses(names) == \
        ["192.0.2.1", "198.51.100.7"]
    for nic in (None, "lo", {"lo", "eth9"}, "eth9"):
        assert torch_network.get_local_intfs(nic) == \
            jax_network.get_local_intfs(nic)
    # each package's own local_ip (the port resolves its host name)
    from horovod_tpu_torch.runner.http.http_server import local_ip
    assert torch_network.get_driver_ip() == local_ip()
    server, port = torch_network.find_port(
        lambda addr: __import__("socketserver").TCPServer(
            addr, __import__("socketserver").BaseRequestHandler))
    try:
        assert 1024 <= port < 65536
    finally:
        server.server_close()


def test_threads_streams_and_cache(tmp_path):
    for mod in (torch_threads, jax_threads):
        assert mod.execute_function_multithreaded(
            lambda a, b: a * b, [[1, 2], [3, 4], [5, 6]]) == \
            {0: 2, 1: 12, 2: 30}
        with pytest.raises(ZeroDivisionError):
            mod.execute_function_multithreaded(lambda a: 1 / a, [[1], [0]])
        ev, got = threading.Event(), []
        t = mod.on_event(ev, got.append, args=("fired",))
        ev.set()
        t.join(timeout=5)
        assert got == ["fired"]
    pipe = torch_streams.Pipe()
    got = []
    t = torch_threads.in_thread(lambda: got.append(pipe.read(3)))
    pipe.write("hello")
    t.join(timeout=5)
    assert got == ["hel"] and pipe.read() == "lo"
    pipe.close()
    assert pipe.read() is None
    calls = []
    for mod, name in ((torch_cache, "t"), (jax_cache, "j")):
        cache = mod.Cache(str(tmp_path / name), 60, "params-1")
        cache.put("k", {"v": 1})
        assert mod.Cache(str(tmp_path / name), 60, "params-1").get("k") \
            == {"v": 1}
        assert mod.Cache(str(tmp_path / name), 60, "params-2").get("k") \
            is None

        @mod.use_cache()
        def probe(x):
            calls.append(x)
            return x + 1
        probe.cache = mod.Cache(str(tmp_path / (name + "u")), 60, "p")
        assert probe(1) == probe(1) == 2
    assert calls == [1, 1]


# -- mpi_run.py, js_run.py, launch.py's reference surface -----------------------

def test_mpi_and_jsrun_predicates_match():
    for q in ("is_open_mpi", "is_spectrum_mpi", "is_mpich", "is_intel_mpi",
              "mpi_available"):
        assert getattr(torch_mpi_run, q)() == getattr(jax_mpi_run, q)()
    assert torch_js_run.is_jsrun_installed() == \
        jax_js_run.is_jsrun_installed()


@pytest.mark.parametrize("run", [torch_mpi_run.mpi_run, torch_js_run.js_run])
def test_mpi_and_jsrun_refuse_naming_the_launcher(run):
    with pytest.raises(RuntimeError,
                       match="horovod_tpu_torch.runner.launch"):
        run(torch_settings.Settings(num_proc=2), None, {}, ["python"])


def test_launch_reference_surface_matches():
    for name in ("CACHE_FOLDER", "CACHE_STALENESS_THRESHOLD_MINUTES",
                 "SSH_ATTEMPTS", "SSH_CONNECT_TIMEOUT_S"):
        assert getattr(torch_launch, name) == getattr(jax_launch, name)
    for flags in [(None, None, None), (True, True, None), (None, True, None),
                  (None, None, True), (False, False, False)]:
        assert torch_launch.is_gloo_used(*flags) == \
            jax_launch.is_gloo_used(*flags)
    for mpi, js in [(False, False), (True, False), (False, True)]:
        picks = [mod.run_controller(
            True, lambda: "gloo", mpi, lambda: "mpi", js, lambda: "js")
            for mod in (torch_launch, jax_launch)]
        assert picks[0] == picks[1]
    parsed = []
    for mod in (torch_launch, jax_launch):
        over = set()
        p = argparse.ArgumentParser()
        p.add_argument("--nics", action=mod.make_nic_action(over))
        p.add_argument("--x", action=mod.make_override_action(over),
                       type=int)
        p.add_argument("--on", dest="flag",
                       action=mod.make_override_true_action(over))
        p.add_argument("--off", dest="flag",
                       action=mod.make_override_false_action(over))
        p.add_argument("--old", action=mod.make_deprecated_bool_action(
            over, "--new"))
        with pytest.warns(DeprecationWarning, match="--new"):
            a = p.parse_args(["--nics", "eth0, ib0", "--x", "3", "--on",
                              "--off", "--old"])
        parsed.append((vars(a), over))
    assert parsed[0] == parsed[1]
    assert parsed[0][0]["nics"] == {"eth0", "ib0"}


def test_check_build_action_prints_the_port(capsys):
    p = argparse.ArgumentParser()
    p.add_argument("--check-build",
                   action=torch_launch.make_check_build_action(None))
    with pytest.raises(SystemExit):
        p.parse_args(["--check-build"])
    out = capsys.readouterr().out
    assert "Horovod-TPU-Torch" in out and "[X] Gloo" in out


def test_cli_accepts_mpi_as_a_no_op():
    args = torch_launch.parse_args(["-np", "2", "--mpi", "--", "python"])
    assert args.mpi and torch_launch.unported_flags(args) == []


# -- the driver and task services ----------------------------------------------

def test_common_interfaces_match():
    for settings, names in [
            (torch_settings.Settings(verbose=0), ["localhost", "127.0.0.1"]),
            (torch_settings.Settings(verbose=0, nics={"eth0"}),
             ["127.0.0.1", "192.0.2.1"]),
            (torch_settings.Settings(verbose=0), ["192.0.2.1"])]:
        assert torch_driver.get_common_interfaces(settings, names) == \
            jax_driver.get_common_interfaces(settings, names)


def test_task_and_driver_services():
    """tests/test_aux.py's driver registration by host hash, task command
    execution with captured output, exit codes and idempotence, on the
    port (runner/common/service/{driver,task}_service.py)."""
    key = torch_secret.make_secret_key()
    driver = torch_driver_service.BasicDriverService(
        2, "test driver service", key)
    tasks = [torch_task_service.BasicTaskService(
        f"test task service #{i}", i, key) for i in range(2)]
    try:
        client = torch_driver_service.BasicDriverClient(
            "test driver service", driver.addresses(), key)
        for i, t in enumerate(tasks):
            client.register_task(i, t.addresses(), f"hosthash-{i % 2}")
        driver.wait_for_initial_registration(
            torch_timeout.Timeout(10, "{activity}"))
        assert sorted(driver.task_indices()) == [0, 1]
        assert driver.task_index_host_hash(0) == "hosthash-0"
        assert client.all_task_addresses(1) == tasks[1].addresses()

        task_client = torch_task_service.BasicTaskClient(
            "test task service #0", tasks[0].addresses(), key)
        task_client.run_command("echo hello-from-task; exit 7",
                                env={}, capture_stdout=True)
        out = io.StringIO()
        stdout_t, _ = task_client.stream_command_output(stdout=out)
        assert task_client.wait_for_command_exit_code(delay=0.1) == 7
        stdout_t.join(timeout=5)
        assert "hello-from-task" in out.getvalue()
        # a second run_command is idempotent: the same command result
        task_client.run_command("echo other", env={})
        assert task_client.command_result() == (True, 7)
    finally:
        for t in tasks:
            t.shutdown()
        driver.shutdown()


def test_horovodrun_task_service_handshake():
    key = torch_secret.make_secret_key()
    service = torch_task.HorovodRunTaskService(3, key)
    try:
        client = torch_task.HorovodRunTaskClient(3, service.addresses(), key)
        assert client.task_to_task_address_check_completed() == 3
        service.wait_for_task_to_task_address_check_finish_signal(
            torch_timeout.Timeout(5, "{activity}"))
        driver = torch_driver.HorovodRunDriverService(1, key)
        try:
            dclient = torch_driver.HorovodRunDriverClient(
                driver.addresses(), key)
            dclient.register_task(0, service.addresses(), "hh")
            assert driver.task_host_hash_indices() == {"hh": [0]}
        finally:
            driver.shutdown()
    finally:
        service.shutdown()


def test_a_wrong_key_is_refused():
    service = torch_task.HorovodRunTaskService(0, b"right-key")
    try:
        with pytest.raises(Exception):
            torch_task.HorovodRunTaskClient(0, service.addresses(),
                                            b"wrong-key")
    finally:
        service.shutdown()


def test_compute_service_registration():
    """tests/test_aux.py's dispatcher/worker registration and shutdown
    barrier, on the port (runner/common/service/compute_service.py)."""
    key = torch_secret.make_secret_key()
    service = torch_compute.ComputeService(1, 2, key)
    try:
        client = torch_compute.ComputeClient(service.addresses(), key)
        client.register_dispatcher(0, "grpc://somewhere:1234")
        assert client.wait_for_dispatcher_registration(0, timeout=5) \
            == "grpc://somewhere:1234"
        with pytest.raises(IndexError):
            client.register_dispatcher(3, "grpc://bad:1")
        with pytest.raises(ValueError, match="already been registered"):
            client.register_dispatcher(0, "grpc://elsewhere:1")
        client.register_worker_for_dispatcher(0, worker_id=0)
        client.register_worker_for_dispatcher(0, worker_id=1)
        client.wait_for_dispatcher_worker_registration(0, timeout=5)
        client.shutdown()
        client.wait_for_shutdown()
    finally:
        service.shutdown()
    with pytest.raises(ValueError):
        torch_compute.ComputeService(0, 1, key)


def _twenty_one():
    return 21


@pytest.mark.parametrize("run_task", [torch_run_task, jax_run_task])
def test_run_task_fetches_runs_and_publishes(monkeypatch, run_task):
    """run_task.main against the port's rendezvous service: the function
    from ``runfunc/func``, its result under ``runfunc_result/<rank>``."""
    from horovod_tpu_torch.runner.http.http_client import (
        put_data_into_kvstore, read_data_from_kvstore,
    )
    monkeypatch.delenv("HOROVOD_SECRET_KEY", raising=False)
    monkeypatch.setenv("HOROVOD_RANK", "1")
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    server = RendezvousServer()
    port = server.start()
    try:
        put_data_into_kvstore("127.0.0.1", port, "runfunc", "func",
                              _twenty_one)
        run_task.main("127.0.0.1", port)
        assert read_data_from_kvstore("127.0.0.1", port, "runfunc_result",
                                      "1") == 21
    finally:
        server.stop()


def test_no_module_imports_jax():
    """The new runner modules stand alone: importing them in a fresh
    interpreter loads neither jax nor horovod_tpu."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import horovod_tpu_torch.runner.run_task, "
            "horovod_tpu_torch.runner.mpi_run, "
            "horovod_tpu_torch.runner.js_run, "
            "horovod_tpu_torch.runner.driver.driver_service, "
            "horovod_tpu_torch.runner.task.task_service, "
            "horovod_tpu_torch.runner.common.service.compute_service, "
            "horovod_tpu_torch.runner.util.cache, "
            "horovod_tpu_torch.runner.util.lsf, "
            "horovod_tpu_torch.runner.common.util.config_parser, "
            "horovod_tpu_torch.selfcheck\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'horovod_tpu' or "
            "m.startswith('horovod_tpu.')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()
