"""The compiled path across processes on the card (ROADMAP.md A22): one
rank per process through the port's launcher.

* np=1 over NCCL: a small dense compiled step and a sharded one on the
  int8 wire, each one CUDA graph a step with NCCL's collectives inside
  it: exactly one capture, and the replays bit for bit the same program
  run uncaptured (``capture=False``); the compiled reducer with
  ``force_program=True`` bit for bit the engine's grouped allreduce;
* np=2 processes on ``cuda:0`` with ``HOROVOD_GPU_OPERATIONS=gloo``: the
  same steps run uncaptured by the capture rule (gloo cannot be
  captured), bit for bit the port's stacked run at 2 rank threads in
  this process, and a mismatched compiled signature raises
  ``ValueError`` on both processes.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs on
the card with ``pytest --noconftest``.
"""

import os
import sys
import textwrap

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.runner.proc_run import launch_procs

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
STEPS = 4

STEPS_SRC = textwrap.dedent("""
    import numpy as np
    import torch
    from horovod_tpu_torch.parallel.train import adamw, sgd

    def loss_fn(p, batch):
        x, y = batch
        h = torch.tanh(x @ p["w1"] + p["b1"])
        return ((h @ p["w2"] - y) ** 2).mean()

    def run_steps(hvd, dev, capture, steps):
        r = hvd.rank()
        prng = np.random.default_rng(11)
        init = {"w1": prng.standard_normal((64, 128)).astype(np.float32),
                "b1": prng.standard_normal(128).astype(np.float32),
                "w2": prng.standard_normal((128, 16)).astype(np.float32)}
        brng = np.random.default_rng(100 + r)
        batches = [tuple(torch.from_numpy(a).to(dev) for a in (
            brng.standard_normal((32, 64)).astype(np.float32),
            brng.standard_normal((32, 16)).astype(np.float32)))
            for _ in range(steps)]
        out, progs = {}, {}
        for label, opt, kw in (
                ("dense", sgd(0.01, momentum=0.9), {}),
                ("int8", adamw(1e-3), {"sharded": True,
                                       "wire_dtype": "int8"})):
            step = hvd.make_compiled_train_step(loss_fn, opt, **kw)
            step.capture = capture
            state = step.init_state(init)
            losses = []
            for b in batches:
                state, loss = step(state, b)
                losses.append(loss)
            out[f"{label}.losses"] = torch.stack(losses).cpu().numpy()
            for k, v in state["params"].items():
                out[f"{label}.{k}"] = v.detach().cpu().numpy()
            for k, v in state.get("grad_ef", {}).items():
                out[f"{label}.ef.{k}"] = v.cpu().numpy()
            progs[label] = step._prog
        return out, progs
""")

NCCL_WORKER = STEPS_SRC + textwrap.dedent("""
    import os
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import compiled as C
    from horovod_tpu_torch.ops import cuda_kernels as K
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=dev)
    before = C.program_cache_stats(by_rule=True)
    got, progs = run_steps(hvd, dev, True, %(steps)d)
    want, _ = run_steps(hvd, dev, False, %(steps)d)
    after = C.program_cache_stats(by_rule=True)
    for p in progs.values():
        assert (p.captures, p.replays) == (1, %(steps)d - 1), \\
            (p.captures, p.replays)
    assert after["graph"] - before["graph"] == 2, (before, after)
    assert after["reference"] - before["reference"] == 2, (before, after)
    bad = [k for k in got if not np.array_equal(got[k], want[k])]
    assert not bad, bad
    rng = np.random.default_rng(5)
    ts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .to(dev) for s in ((1000,), (33, 7), (4096,))]
    K.reset_launches()
    red = hvd.CompiledGroupedAllreduce(force_program=True)(ts)
    assert K.launches["pack_scale_cast"] and \\
        K.launches["unpack_scale_cast"], dict(K.launches)
    eng = hvd.grouped_allreduce(ts, name="g")
    assert all(torch.equal(a, b) for a, b in zip(red, eng))
    hvd.shutdown()
""")

GLOO_WORKER = STEPS_SRC + textwrap.dedent("""
    import os
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import compiled as C
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init(device=dev)
    before = C.program_cache_stats(by_rule=True)
    got, progs = run_steps(hvd, dev, True, %(steps)d)
    after = C.program_cache_stats(by_rule=True)
    assert after["uncaptured"] - before["uncaptured"] == 2, (before, after)
    assert after["graph"] == before["graph"], (before, after)
    assert all(not hasattr(p, "captures") for p in progs.values())
    try:
        hvd.compiled_allreduce(torch.ones(4 if hvd.rank() == 0 else 5,
                                          device=dev))
        raise SystemExit(3)
    except ValueError as e:
        assert "signature mismatch across processes" in str(e), e
    np.savez(os.path.join(os.environ["OUTDIR"], f"gloo_{hvd.rank()}.npz"),
             **got)
    hvd.shutdown()
""")


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _launch(tmp_path, src, np_, env=None):
    script = tmp_path / "worker.py"
    script.write_text(src % {"steps": STEPS})
    return launch_procs([sys.executable, str(script)], np=np_,
                        env={"PYTHONPATH": REPO, "OUTDIR": str(tmp_path),
                             "HOROVOD_COMPILED_SIG_TIMEOUT": "60",
                             **(env or {})},
                        start_timeout=TIMEOUT)


def test_np1_nccl_step_is_one_graph_bit_for_bit_uncaptured(tmp_path):
    assert _launch(tmp_path, NCCL_WORKER, 1) == [0]


def test_np2_gloo_uncaptured_is_the_stacked_run(tmp_path):
    codes = _launch(tmp_path, GLOO_WORKER, 2,
                    {"HOROVOD_GPU_OPERATIONS": "gloo"})
    assert codes == [0, 0]
    got = [dict(np.load(tmp_path / f"gloo_{r}.npz")) for r in range(2)]
    ns = {}
    exec(STEPS_SRC, ns)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    want = hvd.run(lambda: ns["run_steps"](hvd, dev, True, STEPS)[0],
                   np=2, device=dev)
    for r in range(2):
        assert sorted(got[r]) == sorted(want[r])
        for k, a in got[r].items():
            b = want[r][k][r:r + 1] if ".ef." in k else want[r][k]
            assert a.shape == b.shape and np.array_equal(a, b), (r, k)
