"""The multi-process path on the CPU, one rank per OS process, held
against the same jobs under the JAX package:

(i)   the collective matrix of tests/test_runner.py:405 at np=2, once
      under ``horovod_tpu_torch.runner.proc_run.launch_procs`` and once
      under ``horovod_tpu.runner.proc_run.launch_procs``; each job
      writes its results to an ``.npz`` and the two must be equal.
(ii)  a small torch model trains 3 steps at np=2 through each package's
      ``torch.DistributedOptimizer`` (the same model code, seeds and
      per-rank batches; buckets pinned by HOROVOD_FUSION_THRESHOLD=0 and
      a coordinator fusion threshold of 0), on the f32 and the int8
      wire; the port's job runs through the CLI,
      ``python -m horovod_tpu_torch.runner.launch -np 2 --cpu`` (iii).
(iv)  at np=3, process sets whose members span processes (each with a
      ``torch.distributed`` group of its own) reduce over their members
      only and are removed; then a worker that exits before its
      collective makes the survivors raise within the heartbeat window,
      and ``launch_procs`` returns a non-zero code.

Tolerances.  Every result of (i) is compared bit for bit: integers,
Sum, Min and Max are exact; a two-rank Average is a two-rank sum times
0.5 (exact); the scaled Average is the same correctly rounded f32
products on both sides; the int8 wire's two-rank decode-and-sum is the
same correctly rounded arithmetic on the same codes.  In (ii) the f32
run's parameters are bit for bit; on the int8 wire step 1's averaged
gradients are bit for bit and the final parameters within atol 1e-6, as
tests/test_torch_wire_slice.py holds them (the two packages' backward
passes may differ in the last bit of an f32 gradient, which the wire's
rounding can carry into a code).  Every launch has a start_timeout, so a
hang fails instead of eating the suite's clock.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from horovod_tpu.runner.proc_run import launch_procs as jax_launch_procs
from horovod_tpu_torch.runner.proc_run import (
    launch_procs as torch_launch_procs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
WINDOW = 3.0

MATRIX_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    PKG = sys.argv[1]
    if PKG == "jax":
        import jax
        import ml_dtypes
        jax.config.update("jax_enable_x64", True)   # as tests/conftest.py
        import horovod_tpu as hvd
        T = lambda a: a
        BF16 = lambda a: a.astype(ml_dtypes.bfloat16)
        N = lambda t: np.asarray(t).astype(np.float64) \\
            if np.asarray(t).dtype == ml_dtypes.bfloat16 else np.asarray(t)
    else:
        import torch
        import horovod_tpu_torch as hvd
        T = torch.from_numpy
        BF16 = lambda a: torch.from_numpy(a).to(torch.bfloat16)
        N = lambda t: t.double().numpy() if t.dtype == torch.bfloat16 \\
            else t.numpy()
    hvd.init()
    r, s = hvd.rank(), hvd.size()
    out = {}
    f = lambda *shape: (np.arange(np.prod(shape), dtype=np.float32)
                        .reshape(shape) * 0.37 + r) * (r + 1)

    out["sum"] = N(hvd.allreduce(T(f(7)), op=hvd.Sum, name="sum"))
    out["avg_scaled"] = N(hvd.allreduce(
        T(f(7)), op=hvd.Average, prescale_factor=0.3,
        postscale_factor=1.7, name="avg_scaled"))
    out["avg"] = N(hvd.allreduce(T(f(3, 2)), name="avg"))
    out["min"] = N(hvd.allreduce(T(f(5)), op=hvd.Min, name="min"))
    out["max"] = N(hvd.allreduce(T(f(5)), op=hvd.Max, name="max"))
    i32 = np.arange(6, dtype=np.int32) * (r + 3)
    out["int_sum"] = N(hvd.allreduce(T(i32), op=hvd.Sum, name="isum"))
    out["int_avg"] = N(hvd.allreduce(T(i32.copy()), op=hvd.Average,
                                     name="iavg"))
    out["f64"] = N(hvd.allreduce(T(f(4).astype(np.float64)), op=hvd.Sum,
                                 name="f64"))
    out["bf16"] = N(hvd.allreduce(BF16(f(6)), op=hvd.Sum, name="bf16"))
    q = np.linspace(-1.0, 1.0, 700, dtype=np.float32) * (r + 1)
    out["int8"] = N(hvd.allreduce(T(q), name="int8", wire_dtype="int8"))

    x = np.arange(5 * 2, dtype=np.float32).reshape(5, 2) * (r + 1)
    out["rs"] = N(hvd.reducescatter(T(x), op=hvd.Sum, name="rs"))
    out["rs_avg"] = N(hvd.reducescatter(T(x.copy()), op=hvd.Average,
                                        name="rs_avg"))
    g = hvd.grouped_allreduce([T(np.full(3, float(r), np.float32)),
                               T(np.full((2, 2), 1.0, np.float32))],
                              op=hvd.Sum, name="grp")
    out["grp0"], out["grp1"] = N(g[0]), N(g[1])
    m = hvd.grouped_allreduce(
        [T(np.full(3, float(r + 1), np.float32)),
         T(np.arange(4, dtype=np.int32) * (r + 1))], op=hvd.Sum,
        name="gmix")
    out["gmix0"], out["gmix1"] = N(m[0]), N(m[1])
    gr = hvd.grouped_reducescatter(
        [T(np.ones((s, 3), np.float32) * (r + 1)),
         T(np.ones((2 * s, 2), np.float32) * (r + 1))], op=hvd.Sum,
        name="grs")
    out["grs0"], out["grs1"] = N(gr[0]), N(gr[1])
    send = np.arange(3, dtype=np.float32).reshape(3, 1) + 10 * r
    a2a, recv = hvd.alltoall(T(send), splits=[1, 2] if r == 0 else [2, 1],
                             name="a2a")
    out["a2a"], out["a2a_recv"] = N(a2a), np.asarray(N(recv))
    out["ag"] = N(hvd.allgather(T(np.full((r + 1, 2), float(r),
                                          np.float32)), name="ag"))
    out["bc"] = N(hvd.broadcast(T(np.full(3, float(r), np.float32)),
                                root_rank=1, name="bc"))
    ps = hvd.add_process_set([0])
    if r == 0:
        out["ps0"] = N(hvd.allreduce(T(np.full(2, 7.0, np.float32)),
                                     op=hvd.Sum, name="ps0",
                                     process_set=ps))
    for it in range(4):
        h1 = hvd.allreduce_async(T(np.full(33, float(r + it), np.float32)),
                                 op=hvd.Sum, name="steady_a")
        h2 = hvd.allgather_async(T(np.full((2, 2), float(r + it),
                                           np.float32)), name="steady_g")
        out[f"steady_g{it}"] = N(hvd.synchronize(h2))
        out[f"steady_a{it}"] = N(hvd.synchronize(h1))
    hvd.barrier()
    if r == 0:
        last = hvd.join()
    else:
        out["tail"] = N(hvd.allreduce(T(np.ones(2, np.float32)),
                                      op=hvd.Sum, name="tail"))
        last = hvd.join()
    out["last_joined"] = np.asarray(last)
    np.savez(os.path.join(os.environ["OUTDIR"], f"{PKG}_{r}.npz"), **out)
    hvd.shutdown()
""")

TRAIN_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.nn.functional as F
    PKG = sys.argv[1]
    if PKG == "jax":
        import horovod_tpu as hvd
        import horovod_tpu.torch as frontend
    else:
        import horovod_tpu_torch as hvd
        import horovod_tpu_torch.torch as frontend
    hvd.init()
    r = hvd.rank()
    rng = np.random.default_rng(11)
    init = {"0.weight": rng.standard_normal((16, 8)) * 0.3,
            "0.bias": rng.standard_normal(16) * 0.1,
            "2.weight": rng.standard_normal((4, 16)) * 0.3,
            "2.bias": rng.standard_normal(4) * 0.1}
    brng = np.random.default_rng(100 + r)
    x = torch.from_numpy(brng.standard_normal((6, 8)).astype(np.float32))
    y = torch.from_numpy(brng.integers(0, 4, size=6))
    out = {}
    for wire in ("none", "int8"):
        model = torch.nn.Sequential(torch.nn.Linear(8, 16),
                                    torch.nn.ReLU(),
                                    torch.nn.Linear(16, 4))
        model.load_state_dict({k: torch.from_numpy(v.astype(np.float32))
                               for k, v in init.items()})
        frontend.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=getattr(frontend.Compression, wire))
        for step in range(3):
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.synchronize()
            if step == 0:
                for k, p in model.named_parameters():
                    out[f"{wire}.grad1.{k}"] = p.grad.numpy().copy()
            with opt.skip_synchronize():
                opt.step()
        for k, p in model.named_parameters():
            out[f"{wire}.param.{k}"] = p.detach().numpy().copy()
    np.savez(os.path.join(os.environ["OUTDIR"], f"{PKG}_{r}.npz"), **out)
    hvd.shutdown()
""")

DEATH_WORKER = textwrap.dedent("""
    import os, time
    import torch
    import horovod_tpu_torch as hvd
    hvd.init()
    r = hvd.rank()
    sets = [hvd.add_process_set([0, 2]), hvd.add_process_set([1, 2])]
    for ps in sets:
        if r in ps.ranks:
            out = hvd.allreduce(torch.full((3,), float(r + 1)), op=hvd.Sum,
                                name=f"ps{ps.process_set_id}",
                                process_set=ps)
            assert torch.equal(out, torch.full(
                (3,), float(sum(q + 1 for q in ps.ranks)))), out
            assert ps.size() == 2 and ps.rank() == ps.ranks.index(r)
        else:
            assert not ps.included()
    assert all(hvd.remove_process_set(ps) for ps in sets)
    assert hvd.process_set_ids() == [0]
    hvd.allreduce(torch.ones(2), name="warm")
    if r == 1:
        os._exit(0)           # no goodbye: its heartbeats just stop
    t0 = time.monotonic()
    try:
        hvd.allreduce(torch.ones(2), name="never")
    except Exception as exc:
        with open(os.path.join(os.environ["OUTDIR"], f"survivor{r}.txt"),
                  "w") as f:
            f.write(f"{time.monotonic() - t0:.3f}\\n{exc}")
        os._exit(7)
    os._exit(0)
""")


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _env(tmp_path, **extra):
    return {"PYTHONPATH": REPO, "OUTDIR": str(tmp_path), **extra}


def _load(tmp_path, pkg, np_=2):
    return [dict(np.load(tmp_path / f"{pkg}_{r}.npz")) for r in range(np_)]


@pytest.mark.integration
def test_collective_matrix_matches_jax_package(tmp_path):
    script = _write(tmp_path, "matrix.py", MATRIX_WORKER)
    for pkg, launch in (("torch", torch_launch_procs),
                        ("jax", jax_launch_procs)):
        codes = launch([sys.executable, script, pkg], np=2,
                       platform="cpu", env=_env(tmp_path),
                       start_timeout=TIMEOUT)
        assert codes == [0, 0], (pkg, codes)
    got, ref = _load(tmp_path, "torch"), _load(tmp_path, "jax")
    for r in range(2):
        assert set(got[r]) == set(ref[r])
        for k in ref[r]:
            assert got[r][k].shape == ref[r][k].shape, (r, k)
            assert np.array_equal(got[r][k], ref[r][k]), \
                (r, k, got[r][k], ref[r][k])
    # spot checks of the values themselves
    assert np.array_equal(got[0]["a2a"].ravel(), [0.0, 10.0, 11.0])
    assert np.array_equal(got[1]["bc"], np.ones(3, np.float32))
    assert np.array_equal(got[1]["tail"], np.ones(2, np.float32))
    assert int(got[0]["last_joined"]) == int(got[1]["last_joined"]) == 1


@pytest.mark.integration
def test_distributed_optimizer_matches_jax_package(tmp_path):
    """(ii) at np=2 on the f32 and int8 wires; the port's job through
    the CLI (iii)."""
    script = _write(tmp_path, "train.py", TRAIN_WORKER)
    env = _env(tmp_path, HOROVOD_FUSION_THRESHOLD="0")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.launch", "-np",
         "2", "--cpu", "--fusion-threshold-mb", "0", "--start-timeout",
         str(TIMEOUT), "--", sys.executable, script, "torch"],
        env={**os.environ, **env}, capture_output=True, text=True,
        timeout=TIMEOUT + 30)
    assert proc.returncode == 0, proc.stderr[-3000:]
    codes = jax_launch_procs([sys.executable, script, "jax"], np=2,
                             platform="cpu", env=env,
                             fusion_threshold_bytes=0,
                             start_timeout=TIMEOUT)
    assert codes == [0, 0]
    got, ref = _load(tmp_path, "torch"), _load(tmp_path, "jax")
    for k in ref[0]:
        # the replicas are bit for bit each other on both sides
        assert np.array_equal(got[0][k], got[1][k]), k
        assert np.array_equal(ref[0][k], ref[1][k]), k
        if k.startswith("none.") or ".grad1." in k:
            assert np.array_equal(got[0][k], ref[0][k]), k
        else:
            np.testing.assert_allclose(got[0][k], ref[0][k], rtol=0,
                                       atol=1e-6, err_msg=k)
    # the int8 wire moved the parameters off the f32 run's
    assert not np.array_equal(got[0]["int8.param.0.weight"],
                              got[0]["none.param.0.weight"])


@pytest.mark.integration
def test_process_sets_then_a_dead_worker(tmp_path):
    """(iv): heartbeat interval 1 s, death window 3 s (wide enough that
    a loaded machine does not starve a live worker's beats)."""
    script = _write(tmp_path, "death.py", DEATH_WORKER)
    t0 = time.monotonic()
    codes = torch_launch_procs(
        [sys.executable, script], np=3, platform="cpu",
        env=_env(tmp_path, HOROVOD_HEARTBEAT_INTERVAL_SECONDS="1",
                 HOROVOD_HEARTBEAT_WINDOW_SECONDS=str(WINDOW)),
        start_timeout=TIMEOUT, stop_on_failure=False)
    assert codes == [7, 0, 7], codes
    for r in (0, 2):
        waited, message = (tmp_path / f"survivor{r}.txt").read_text() \
            .split("\n", 1)
        # the window, one beat and one poll
        assert float(waited) < WINDOW + 2.0, waited
        assert "[1]" in message and "heartbeat" in message, message
    assert time.monotonic() - t0 < TIMEOUT
