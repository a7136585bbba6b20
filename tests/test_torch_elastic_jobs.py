"""Elastic jobs on the CPU through the port's launcher
(``python -m horovod_tpu_torch.runner.launch ... --cpu``): the scenarios
of tests/test_elastic.py that tier-1 runs (scale up, worker-failure
recovery, scale down, the ``min_np`` timeout, repeated failures aborting
under ``--reset-limit``, the elastic timeout restarting a stuck round,
``run_elastic_fn``), with the port's workers; and one parity job: the same
torch worker (a 3-layer MLP in ``TorchState``, one worker dying at step
3) under the JAX package's launcher with ``horovod_tpu.torch`` and under
the port's, whose final parameters must agree within ``PARITY_ATOL``.

Every job runs with a ``--start-timeout`` and a subprocess timeout, so a
hang fails instead of eating the suite's clock.
"""

import os
import stat
import subprocess
import sys
import textwrap
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
#: the two packages' runs reduce over the same values in the same order
#: (a two-rank average is exact either way); the bound is a few f32 ulps
#: of parameters of magnitude ~1
PARITY_ATOL = 1e-6


def _script(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(textwrap.dedent(text))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def _launch(args, env=None, pkg="horovod_tpu_torch", timeout=TIMEOUT):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.runner.launch", *args],
        env={**os.environ, "PYTHONPATH": REPO, **(env or {})},
        capture_output=True, text=True, timeout=timeout)


ELASTIC_WORKER = """
    import os, sys
    import torch
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.elastic as elastic

    LOG = os.environ["HVD_TEST_LOG"]
    MODE = os.environ.get("HVD_TEST_MODE", "")
    MARKER = os.environ.get("HVD_FAIL_MARKER", "")
    hvd.init()

    def log(msg):
        with open(LOG, "a") as f:
            f.write(msg + "\\n")

    state = elastic.ObjectState(bcast_object=hvd.broadcast_object,
                                get_rank=hvd.rank, batch=0, at_goal=0)

    @elastic.run
    def train(state):
        while True:
            if (MODE == "fail" and state.batch == 3 and hvd.size() == 2
                    and os.environ["HOROVOD_HOSTNAME"] == "127.0.0.1"
                    and not os.path.exists(MARKER)):
                open(MARKER, "w").close()
                log(f"injecting failure on rank {hvd.rank()}")
                os._exit(17)
            out = hvd.allreduce(torch.full((2,), float(hvd.rank())),
                                op=hvd.Sum, name=f"b{state.batch}")
            assert out.tolist() == [float(sum(range(hvd.size())))] * 2
            log(f"batch {state.batch} rank {hvd.rank()} "
                f"size {hvd.size()} pid {os.getpid()}")
            state.batch += 1
            goal = {"up": hvd.size() == 2, "down": hvd.size() == 1,
                    "fail": state.batch >= 6}[MODE]
            state.at_goal += int(goal)
            if state.at_goal >= 3 or (MODE == "fail" and goal):
                return
            state.commit()

    train(state)
    log(f"done rank {hvd.rank()} size {hvd.size()}")
"""


def _elastic_job(tmp_path, mode, discovery, np_, extra=()):
    log = tmp_path / "log.txt"
    log.write_text("")
    worker = _script(tmp_path, "worker.py", ELASTIC_WORKER)
    disc = _script(tmp_path, "discover.sh", discovery.format(log=log))
    proc = _launch(["-np", str(np_), "--min-np", "1", "--max-np", "2",
                    "--cpu", "--host-discovery-script", disc,
                    "--start-timeout", "60", *extra, "--",
                    sys.executable, worker],
                   env={"HVD_TEST_LOG": str(log), "HVD_TEST_MODE": mode,
                        "HVD_FAIL_MARKER": str(tmp_path / "failed")})
    return proc, log.read_text()


def test_elastic_scale_up(tmp_path):
    """Start with one host; discovery adds a second once the first worker
    has made progress; the job ends only after 3 batches at size 2, and
    the first worker re-initialized in place (one pid)."""
    proc, content = _elastic_job(tmp_path, "up", """\
        #!/bin/sh
        echo localhost:1
        if grep -q "batch 2" {log} 2>/dev/null; then echo 127.0.0.1:1; fi
        """, 1)
    assert proc.returncode == 0, (proc.stderr[-3000:], content)
    assert "rank 1 size 2" in content, content
    first = {line.split("pid ")[1] for line in content.splitlines()
             if "rank 0" in line and "pid" in line}
    assert len(first) == 1, content


def test_elastic_worker_failure_recovery(tmp_path):
    """A worker exits 17 before batch 3's allreduce; its host is
    blacklisted (its cooldown outlasts the job) and the survivor
    finishes at size 1 from the commit after batch 2, in place."""
    proc, content = _elastic_job(
        tmp_path, "fail", "#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n",
        2, extra=("--blacklist-cooldown-range", "600", "600"))
    assert proc.returncode == 0, (proc.stderr[-3000:], content)
    assert "injecting failure" in content, content
    lines = content.splitlines()
    # the two workers append to the log independently: the survivor's
    # "batch 2" line may land after the injection line, so the rounds are
    # told apart by their size, not by their place in the log
    batches = [x for x in lines if x.startswith("batch")]
    at_two = [x.split(" pid")[0] for x in batches if "size 2" in x]
    assert sorted(at_two) == sorted(f"batch {b} rank {r} size 2"
                                    for b in range(3) for r in range(2)), \
        content
    at_one = [x for x in batches if "size 1" in x]
    assert [b.split(" pid")[0] for b in at_one] == [
        f"batch {b} rank 0 size 1" for b in (3, 4, 5)], content
    assert lines.index(next(x for x in lines if x.startswith("injecting"))) \
        < lines.index(at_one[0]), content
    survivor = {x.split("pid ")[1] for x in lines
                if x.startswith("batch") and "rank 1 size 2" in x}
    assert {b.split("pid ")[1] for b in at_one} == survivor, content
    assert "done rank 0 size 1" in content, content


def test_elastic_scale_down(tmp_path):
    """Start at two hosts; discovery drops one after progress; the
    remaining worker re-forms at size 1 and finishes."""
    proc, content = _elastic_job(tmp_path, "down", """\
        #!/bin/sh
        echo localhost:1
        if ! grep -q "batch 2" {log} 2>/dev/null; then echo 127.0.0.1:1; fi
        """, 2)
    assert proc.returncode == 0, (proc.stderr[-3000:], content)
    assert "size 2" in content, content
    assert "done rank 0 size 1" in content, content


def test_elastic_min_np_timeout(tmp_path):
    """Discovery never yields min_np slots: the launcher exits non-zero
    within the start timeout instead of waiting forever."""
    worker = _script(tmp_path, "worker.py", "print('never runs')\n")
    disc = _script(tmp_path, "d.sh", "#!/bin/sh\necho localhost:1\n")
    t0 = time.monotonic()
    proc = _launch(["-np", "3", "--min-np", "3", "--max-np", "4", "--cpu",
                    "--host-discovery-script", disc, "--start-timeout", "3",
                    "--", sys.executable, worker])
    assert proc.returncode != 0
    assert "timed out waiting for 3 slots" in proc.stdout
    assert time.monotonic() - t0 < 60


def test_elastic_repeated_failures_abort(tmp_path):
    """Workers die in every round: the job ends non-zero (every worker
    failed, or the reset limit ran out) instead of restarting forever."""
    log = tmp_path / "log.txt"
    log.write_text("")
    worker = _script(tmp_path, "worker.py", """
        import os
        import torch
        import horovod_tpu_torch as hvd
        import horovod_tpu_torch.elastic as elastic

        hvd.init()
        with open(os.environ["HVD_TEST_LOG"], "a") as f:
            f.write(f"start rank {hvd.rank()}\\n")
        state = elastic.ObjectState(bcast_object=hvd.broadcast_object,
                                    get_rank=hvd.rank, batch=0)

        @elastic.run
        def train(state):
            for b in range(3):
                hvd.allreduce(torch.ones(2), name=f"b{b}")
            os._exit(23)     # crash every time: the job never finishes

        train(state)
    """)
    disc = _script(tmp_path, "d.sh",
                   "#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
    proc = _launch(["-np", "2", "--min-np", "1", "--max-np", "2", "--cpu",
                    "--host-discovery-script", disc, "--reset-limit", "2",
                    "--start-timeout", "60", "--", sys.executable, worker],
                   env={"HVD_TEST_LOG": str(log)})
    assert proc.returncode != 0, proc.stdout[-500:]
    assert "start rank" in log.read_text()


def test_elastic_timeout_restarts_stuck_round(tmp_path):
    """``--elastic-timeout``: a round whose worker never rendezvouses is
    terminated and restarted, burning a reset; with the reset limit
    spent the job exits non-zero instead of hanging."""
    worker = _script(tmp_path, "worker.py", "import time\ntime.sleep(600)\n")
    t0 = time.monotonic()
    proc = _launch(["-np", "1", "--min-np", "1", "--max-np", "1", "--cpu",
                    "-H", "localhost:1", "--elastic-timeout", "3",
                    "--reset-limit", "1", "--start-timeout", "30", "--",
                    sys.executable, worker])
    assert proc.returncode != 0
    assert time.monotonic() - t0 < 60


def test_run_elastic_fn_ships_function(tmp_path):
    """The programmatic elastic API: the pickled function travels through
    the KV store to every worker (no shared filesystem)."""
    from horovod_tpu_torch.runner.elastic.discovery import FixedHosts
    from horovod_tpu_torch.runner.elastic_api import run_elastic_fn

    log = tmp_path / "log.txt"

    def worker(log_path):
        import torch

        import horovod_tpu_torch as hvd

        hvd.init()
        out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="t")
        with open(log_path, "a") as f:
            f.write(f"rank {hvd.rank()} size {hvd.size()} "
                    f"sum {float(out[0])}\n")
        hvd.shutdown()

    events = []
    run_elastic_fn(worker, (str(log),), discovery=FixedHosts(
        {"localhost": 2}), min_np=2, max_np=2, platform="cpu",
        start_timeout=60, callbacks=[events.append])
    content = log.read_text()
    assert content.count("size 2 sum 2.0") == 2, content
    assert [e["event"] for e in events].count("worker_start") == 2


PARITY_WORKER = """
    import os, sys
    import numpy as np
    import torch
    if sys.argv[1] == "jax":
        import horovod_tpu as hvd
        import horovod_tpu.torch as hvd_torch
    else:
        import horovod_tpu_torch as hvd
        import horovod_tpu_torch.torch as hvd_torch

    OUT, MARKER = sys.argv[2], sys.argv[3]
    hvd.init()
    rng = np.random.default_rng(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 3))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(
                tuple(p.shape)).astype(np.float32) * 0.5))
    opt = hvd_torch.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=model.named_parameters())
    state = hvd_torch.elastic.TorchState(model=model, optimizer=opt,
                                         batch=0)

    @hvd_torch.elastic.run
    def train(state):
        while state.batch < 6:
            step, r = state.batch, hvd.rank()
            if (step == 3 and hvd.size() == 2
                    and os.environ["HOROVOD_HOSTNAME"] == "127.0.0.1"
                    and not os.path.exists(MARKER)):
                open(MARKER, "w").close()
                os._exit(17)
            data = np.random.default_rng(100 * step + r)
            x = torch.from_numpy(data.standard_normal((8, 6)).astype(
                np.float32))
            y = torch.from_numpy(data.integers(0, 3, 8))
            opt.zero_grad()
            torch.nn.functional.cross_entropy(model(x), y).backward()
            opt.step()
            state.batch += 1
            state.commit()

    train(state)
    np.savez(os.path.join(OUT, f"params_{hvd.rank()}_{hvd.size()}.npz"),
             *[p.detach().numpy() for p in model.parameters()])
"""


def test_parity_with_the_jax_package(tmp_path):
    """The same torch worker and failure under both launchers: the
    survivors' final parameters (size 1 after the failure) agree."""
    worker = _script(tmp_path, "worker.py", PARITY_WORKER)
    disc = _script(tmp_path, "d.sh",
                   "#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
    params = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / pkg
        out.mkdir()
        proc = _launch(
            ["-np", "2", "--min-np", "1", "--max-np", "2", "--cpu",
             "--host-discovery-script", disc, "--blacklist-cooldown-range",
             "600", "600", "--start-timeout", "60", "--", sys.executable,
             worker, pkg, str(out), str(out / "failed")],
            pkg="horovod_tpu" if pkg == "jax" else "horovod_tpu_torch")
        assert proc.returncode == 0, (pkg, proc.stderr[-3000:])
        assert (out / "failed").exists()
        assert sorted(os.listdir(out)) == ["failed", "params_0_1.npz"]
        with np.load(out / "params_0_1.npz") as f:
            params[pkg] = [f[k] for k in sorted(f.files)]
    for a, b in zip(params["torch"], params["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARITY_ATOL)
