"""Workers on remote hosts: the port's ``launch_procs`` spawns a host that
is not this machine over ssh, the worker env on ssh's stdin, against the
JAX package's launcher.

The "remote" host is ``192.0.2.1`` (RFC 5737 TEST-NET-1): an IP literal
resolves without a lookup and is neither ``127.*`` nor this machine's
``local_ip()``, so ``is_local`` calls it remote.  No packet goes to it:
the recorded spawns never run, and the live jobs find a stub ``ssh`` first
on PATH that runs the remote command here under ``sh`` with stdin passed
through (tests/test_integrations.py runs the remote script the same way),
in an emptied environment, so a remote worker sees only what the env
handoff gives it.
"""

import json
import os
import shlex
import sys
import time

import pytest

from horovod_tpu.runner import proc_run as jax_proc_run
from horovod_tpu_torch.runner import proc_run as torch_proc_run
from horovod_tpu_torch.runner.http.http_server import local_ip

REMOTE = "192.0.2.1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECRET = "ab" * 16
#: the keys that differ by design: each package's platform and backend
#: keys (slot_env), and the framework prefixes each forwards
PLATFORM_KEYS = {"JAX_PLATFORMS", "JAX_NUM_CPU_DEVICES",
                 "HOROVOD_CPU_OPERATIONS", "HOROVOD_TORCH_PLATFORM"}
FRAMEWORK_PREFIXES = ("JAX_", "XLA_", "TPU_", "TORCH_", "CUDA_", "NCCL_")

STUB_SSH = """#!/bin/sh
printf '%s\\0' "$@" > "{log}/call.$$"
for last; do :; done
exec env -i HOME="$HOME" TMPDIR="${{TMPDIR:-/tmp}}" \\
    PATH=/usr/local/bin:/usr/bin:/bin sh -c "$last"
"""


def _payload_env(payload):
    """The ``export K=V`` lines of an ssh stdin payload, as a dict."""
    env = {}
    for line in payload.decode().splitlines():
        assert line.startswith("export "), line
        k, _, v = line[len("export "):].partition("=")
        env[k] = shlex.split(v)[0] if v else ""
    return env


class _FakeServer:
    def __init__(self, **kwargs):
        pass

    def start(self):
        return 41000

    def stop(self):
        pass


class _DoneProc:
    def poll(self):
        return 0


def _record_spawns(monkeypatch, mod):
    """Replace ``mod``'s spawn, rendezvous service, ports, address and
    secret with fixed fakes; returns the list the spawns land in."""
    spawned = []

    def spawn(self, command, env, stdout=None, stderr=None,
              stdin_data=None):
        spawned.append((list(command), dict(env), stdin_data))
        p = _DoneProc()
        self.procs.append(p)
        return p
    monkeypatch.setattr(mod.ProcessPool, "spawn", spawn)
    monkeypatch.setattr(mod, "RendezvousServer", _FakeServer)
    monkeypatch.setattr(mod, "_free_port", lambda: 29500)
    monkeypatch.setattr(mod, "local_ip", lambda: "10.9.8.7")
    monkeypatch.setattr(mod._secrets, "token_hex", lambda n=16: SECRET)
    return spawned


def _clean_environ(monkeypatch):
    for k in list(os.environ):
        if k.startswith(FRAMEWORK_PREFIXES) or k == "HOROVOD_FAULT_PLAN":
            monkeypatch.delenv(k)
    monkeypatch.setenv("HOROVOD_LAUNCHER_SIDE", "travels")
    monkeypatch.setenv("LAUNCHER_ONLY_KEY", "stays")


@pytest.mark.parametrize("hosts,np_,rpp", [
    (f"localhost:1,{REMOTE}:1", 2, 1),
    (f"localhost:2,{REMOTE}:2", 4, 1),
    (f"localhost:1,{REMOTE}:2,198.51.100.3:1", 4, 1),
    (f"localhost:1,{REMOTE}:1", 4, 2),
    (f"localhost:2,{REMOTE}:1", 3, "host"),
])
def test_spawns_match_the_reference(monkeypatch, hosts, np_, rpp):
    """Every slot's spawn, recorded under a fixed secret and fixed ports:
    a remote slot's ssh argv and stdin payload (and a local slot's env)
    equal the JAX package's but for the platform keys."""
    _clean_environ(monkeypatch)
    got, ref = (_record_spawns(monkeypatch, m)
                for m in (torch_proc_run, jax_proc_run))
    env = {"EXPLICIT_KEY": "yes", "HOROVOD_GPU_OPERATIONS": "gloo"}
    cmd = [sys.executable, "train me.py", "--flag"]
    for mod in (torch_proc_run, jax_proc_run):
        assert mod.launch_procs(cmd, np=np_, hosts=hosts, ranks_per_proc=rpp,
                                env=dict(env), platform="cpu") == \
            [0] * len(got if mod is torch_proc_run else ref)
    assert len(got) == len(ref) > 0
    remote = 0
    for (g_cmd, g_env, g_in), (r_cmd, r_env, r_in) in zip(got, ref):
        assert g_cmd == r_cmd
        if g_in is None:
            assert r_in is None and g_cmd == cmd
            assert {k: v for k, v in g_env.items()
                    if k not in PLATFORM_KEYS} == \
                {k: v for k, v in r_env.items() if k not in PLATFORM_KEYS}
            continue
        remote += 1
        # ssh runs with the launcher's own env; the worker's is on stdin
        assert g_cmd[:5] == ["ssh", "-o", "StrictHostKeyChecking=no", "-o",
                             "BatchMode=yes"] and g_env == dict(os.environ)
        assert all(SECRET not in a for a in g_cmd)
        pg, pr = _payload_env(g_in), _payload_env(r_in)
        assert {k: v for k, v in pg.items() if k not in PLATFORM_KEYS} == \
            {k: v for k, v in pr.items() if k not in PLATFORM_KEYS}
        assert pg["HOROVOD_SECRET_KEY"] == SECRET
        assert pg["HOROVOD_TORCH_PLATFORM"] == "cpu"
        assert pg["EXPLICIT_KEY"] == "yes"
        assert pg["HOROVOD_LAUNCHER_SIDE"] == "travels"
        assert "LAUNCHER_ONLY_KEY" not in pg
        # the workers dial the launcher's routable address
        assert pg["HOROVOD_GLOO_RENDEZVOUS_ADDR"] == "10.9.8.7"
        assert pg["HOROVOD_TPU_COORDINATOR"] == "10.9.8.7:29500"
    assert remote == sum(1 for c, _, _ in got if c[0] == "ssh") > 0


def test_a_remote_rank_0_moves_the_store(monkeypatch):
    """With rank 0 on a remote host the torch.distributed store, which
    process 0 hosts, is addressed at that host, as in the JAX package."""
    _clean_environ(monkeypatch)
    got, ref = (_record_spawns(monkeypatch, m)
                for m in (torch_proc_run, jax_proc_run))
    for mod in (torch_proc_run, jax_proc_run):
        mod.launch_procs(["python", "t.py"], np=2,
                         hosts=f"{REMOTE}:1,localhost:1", platform="cpu")
    assert got[0][0][0] == "ssh" and got[1][2] is None
    coords = {_payload_env(got[0][2])["HOROVOD_TPU_COORDINATOR"],
              got[1][1]["HOROVOD_TPU_COORDINATOR"],
              _payload_env(ref[0][2])["HOROVOD_TPU_COORDINATOR"],
              ref[1][1]["HOROVOD_TPU_COORDINATOR"]}
    assert coords == {f"{REMOTE}:29500"}


def test_all_local_keeps_loopback(monkeypatch):
    _clean_environ(monkeypatch)
    got = _record_spawns(monkeypatch, torch_proc_run)
    torch_proc_run.launch_procs(["python", "t.py"], np=2,
                                hosts="localhost:1,127.0.0.1:1")
    assert all(c == ["python", "t.py"] and stdin is None
               for c, _, stdin in got)
    assert {e["HOROVOD_GLOO_RENDEZVOUS_ADDR"] for _, e, _ in got} == \
        {"127.0.0.1"}


WORKER = """
import json, os, sys
import torch
import horovod_tpu_torch as hvd

hvd.init()
r = hvd.rank()
s = hvd.allreduce(torch.arange(6, dtype=torch.float64) * (r + 1),
                  op=hvd.Sum, name="s")
a = hvd.allreduce(torch.full((3,), 2.0 * (r + 1)), name="a")
g = hvd.allgather(torch.full((r + 1, 2), float(r)), name="g")
keys = ("HOROVOD_GLOO_RENDEZVOUS_ADDR", "HOROVOD_TPU_COORDINATOR",
        "HOROVOD_HOSTNAME", "HOROVOD_TORCH_PLATFORM", "HOROVOD_GPU_OPERATIONS",
        "CUDA_VISIBLE_DEVICES", "PYTHONPATH", "EXPLICIT_KEY",
        "LAUNCHER_ONLY_KEY")
print(f"worker {r} on {os.environ['HOROVOD_HOSTNAME']}", flush=True)
with open(os.path.join(sys.argv[1], f"r{r}.json"), "w") as f:
    json.dump({"rank": r, "pid": os.getpid(), "sum": s.tolist(),
               "avg": a.tolist(), "gather": g.tolist(),
               "env": {k: os.environ.get(k) for k in keys}}, f)
hvd.shutdown()
"""


@pytest.fixture
def stub_ssh(tmp_path, monkeypatch):
    """A stub ``ssh`` first on the launcher's PATH; returns a reader of
    its calls (each its argv without ``ssh``)."""
    bin_dir, log = tmp_path / "bin", tmp_path / "ssh_log"
    bin_dir.mkdir()
    log.mkdir()
    stub = bin_dir / "ssh"
    stub.write_text(STUB_SSH.format(log=log))
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")

    def calls():
        return [p.read_bytes().split(b"\0")[:-1]
                for p in sorted(log.iterdir())]
    calls.stub = stub
    return calls


def test_a_job_through_ssh_gives_exact_results(tmp_path, monkeypatch,
                                                stub_ssh):
    """np=2 with rank 1 on the remote host through the stub: exact
    collectives, one ssh call, the forwarded keys present and a
    launcher-only key absent on the remote worker, and its stdout
    captured by ``output_filename``."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("LAUNCHER_ONLY_KEY", "stays")
    script, out = tmp_path / "worker.py", tmp_path / "res"
    script.write_text(WORKER)
    out.mkdir()
    t0 = time.monotonic()
    codes = torch_proc_run.launch_procs(
        [sys.executable, str(script), str(out)], np=2,
        hosts=f"localhost:1,{REMOTE}:1", platform="cpu",
        env={"PYTHONPATH": ROOT, "HOROVOD_GPU_OPERATIONS": "gloo",
             "EXPLICIT_KEY": "yes"},
        start_timeout=120, output_filename=str(tmp_path / "logs"))
    assert codes == [0, 0]
    assert time.monotonic() - t0 < 120
    res = [json.loads((out / f"r{r}.json").read_text()) for r in range(2)]
    for rec in res:
        assert rec["sum"] == [3.0 * i for i in range(6)]
        assert rec["avg"] == [3.0] * 3
        assert rec["gather"] == [[0.0, 0.0], [1.0, 1.0], [1.0, 1.0]]
    calls = stub_ssh()
    assert len(calls) == 1 and calls[0][-2] == REMOTE.encode()
    remote_env, local_env = res[1]["env"], res[0]["env"]
    assert remote_env == {
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": local_ip(),
        "HOROVOD_TPU_COORDINATOR": local_env["HOROVOD_TPU_COORDINATOR"],
        "HOROVOD_HOSTNAME": REMOTE, "HOROVOD_TORCH_PLATFORM": "cpu",
        "HOROVOD_GPU_OPERATIONS": "gloo", "CUDA_VISIBLE_DEVICES": "0",
        "PYTHONPATH": ROOT, "EXPLICIT_KEY": "yes",
        "LAUNCHER_ONLY_KEY": None}
    assert local_env["LAUNCHER_ONLY_KEY"] == "stays"
    assert local_env["HOROVOD_TPU_COORDINATOR"].startswith(local_ip() + ":")
    captured = (tmp_path / "logs" / "rank.001" / "stdout").read_text()
    assert f"worker 1 on {REMOTE}" in captured


def test_an_unreachable_host_fails_the_job(tmp_path, stub_ssh):
    """ssh's own exit code (255: the host cannot be reached) fails the
    job, and the local worker is stopped: no fallback to a local spawn."""
    stub_ssh.stub.write_text("#!/bin/sh\nexit 255\n")
    t0 = time.monotonic()
    codes = torch_proc_run.launch_procs(
        [sys.executable, "-c", "import time; time.sleep(60)"], np=2,
        hosts=f"localhost:1,{REMOTE}:1", platform="cpu", start_timeout=60)
    assert codes[1] == 255 and codes[0] != 0
    assert time.monotonic() - t0 < 30


def test_a_missing_ssh_is_an_error_naming_it(tmp_path, monkeypatch):
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    with pytest.raises(FileNotFoundError, match="ssh"):
        torch_proc_run.launch_procs(
            [sys.executable, "-c", "import time; time.sleep(60)"], np=2,
            hosts=f"localhost:1,{REMOTE}:1", platform="cpu",
            start_timeout=60)
