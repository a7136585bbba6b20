"""The multi-process path on the card: one rank per process through the
port's launcher (``horovod_tpu_torch.runner.proc_run.launch_procs``).

* np=2 processes on ``cuda:0`` with ``HOROVOD_GPU_OPERATIONS=gloo``: the
  collective matrix on CUDA tensors, each result exact against its host
  formula, and a small model trained through ``DistributedOptimizer``
  whose replicas end bit for bit equal;
* np=1 over NCCL: gradients averaged through the engine, bit for bit the
  local ones, with the scale/cast kernel launched;
* np=2 over NCCL on one card refuses at init, naming
  ``HOROVOD_GPU_OPERATIONS=gloo``;
* which of gloo's collectives take CUDA tensors, against
  ``dist_ops.GLOO_CUDA_COLLECTIVES`` (the executor stages the others).

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither jax nor the JAX package, so it runs on
the card with ``pytest --noconftest``.
"""

import os
import sys
import textwrap

import pytest
import torch

from horovod_tpu_torch.runner.proc_run import launch_procs

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150


@pytest.fixture(autouse=True)
def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


MATRIX = textwrap.dedent("""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as K
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    r, s = hvd.rank(), hvd.size()
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    def eq(got, want):
        assert np.array_equal(got.cpu().numpy(), np.asarray(want)), \\
            (got, want)
    base = np.arange(12, dtype=np.float32)
    rows = np.stack([base * (q + 1) - 3 * q for q in range(s)])
    for op, fold in ((hvd.Sum, lambda v: v.sum(0)),
                     (hvd.Average, lambda v: v.mean(0)),
                     (hvd.Min, lambda v: v.min(0)),
                     (hvd.Max, lambda v: v.max(0))):
        eq(hvd.allreduce(T(rows[r]), op=op, prescale_factor=2.0,
                         postscale_factor=0.5, name=f"ar{int(op)}"),
           fold(rows * 2.0) * 0.5)
    eq(hvd.allgather(T(np.full((r + 1, 3), float(r), np.float32)),
                     name="ag"),
       np.concatenate([np.full((q + 1, 3), float(q), np.float32)
                       for q in range(s)]))
    eq(hvd.broadcast(T(np.full(5, float(r), np.float32)), root_rank=1,
                     name="bc"), np.ones(5, np.float32))
    out, recv = hvd.alltoall(T(np.arange(3, dtype=np.float32) + 10 * r),
                             splits=[1, 2] if r == 0 else [2, 1],
                             name="a2a")
    eq(out, [0.0, 10.0, 11.0] if r == 0 else [1.0, 2.0, 12.0])
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    full = sum(x * (q + 1) for q in range(s))
    eq(hvd.reducescatter(T(x * (r + 1)), op=hvd.Sum, name="rs"),
       full[:3] if r == 0 else full[3:])
    q = torch.linspace(-1, 1, 1000, device=dev) * (r + 1)
    y = hvd.allreduce(q, name="int8", wire_dtype="int8")
    assert y.shape == q.shape and torch.isfinite(y).all()
    hvd.barrier()
    if r == 0:
        last = hvd.join()
    else:
        eq(hvd.allreduce(T(np.ones(2, np.float32)), op=hvd.Sum,
                         name="tail"), np.ones(2, np.float32))
        last = hvd.join()
    assert last == 1, last
    assert K.launches["pack_scale_cast"] > 0
    hvd.shutdown()
""")

TRAIN = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.torch as frontend
    from horovod_tpu_torch.ops import cuda_kernels as K
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    r = hvd.rank()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.ReLU(),
                                torch.nn.Linear(64, 10)).to(dev)
    if r == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    frontend.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = frontend.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=getattr(frontend.Compression, sys.argv[2]))
    g = torch.Generator().manual_seed(10 + r)
    x = torch.randn(16, 32, generator=g).to(dev)
    y = torch.randint(0, 10, (16,), generator=g).to(dev)
    for step in range(3):
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
    assert K.launches["pack_scale_cast"] > 0
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(sys.argv[1], f"params{r}.pt"))
    hvd.shutdown()
""")

NCCL_ONE = textwrap.dedent("""
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import cuda_kernels as K
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    assert hvd.size() == 1 and not hvd.engine().process_sets[0] \\
        .executor.stacked
    gs = [torch.randn(n, device=dev) for n in (5, 1000, 33)]
    want = [t.clone() for t in gs]
    hvd.grouped_allreduce_(gs, name="grads")
    assert all(torch.equal(a, b) for a, b in zip(gs, want))
    assert K.launches["pack_scale_cast"] > 0
    assert K.launches["unpack_scale_cast"] > 0
    hvd.shutdown()
""")

GLOO_PROBE = textwrap.dedent("""
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.dist_ops import GLOO_CUDA_COLLECTIVES
    dev = torch.device("cuda:0")
    hvd.init(device=dev)
    pg = dist.group.WORLD
    t = torch.ones(8, device=dev)
    calls = {
        "allreduce": lambda: pg.allreduce([t]),
        "broadcast": lambda: pg.broadcast([t], dist.BroadcastOptions()),
        "allgather": lambda: pg.allgather([[torch.empty_like(t)]], [t]),
        "alltoall_base": lambda: pg.alltoall_base(
            torch.empty_like(t), t, [], [], dist.AllToAllOptions()),
        "reduce_scatter": lambda: pg.reduce_scatter(
            [torch.empty_like(t)], [[t]], dist.ReduceScatterOptions()),
    }
    takes = set()
    for name, call in calls.items():
        try:
            call().wait()
            takes.add(name)
        except RuntimeError:
            pass
    assert set(GLOO_CUDA_COLLECTIVES) <= takes, (takes,
                                                 GLOO_CUDA_COLLECTIVES)
    hvd.shutdown()
""")


def _run(tmp_path, text, np_, env=None, args=(), output=None):
    script = tmp_path / "worker.py"
    script.write_text(text)
    return launch_procs([sys.executable, str(script), *args], np=np_,
                        env={"PYTHONPATH": REPO, **(env or {})},
                        start_timeout=TIMEOUT, output_filename=output)


def test_gloo_matrix_on_cuda_tensors(tmp_path):
    assert _run(tmp_path, MATRIX, 2,
                {"HOROVOD_GPU_OPERATIONS": "gloo"}) == [0, 0]


@pytest.mark.parametrize("wire", ["none", "int8"])
def test_replicas_bit_for_bit_over_gloo(tmp_path, wire):
    assert _run(tmp_path, TRAIN, 2, {"HOROVOD_GPU_OPERATIONS": "gloo"},
                args=(str(tmp_path), wire)) == [0, 0]
    p0 = torch.load(tmp_path / "params0.pt")
    p1 = torch.load(tmp_path / "params1.pt")
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_one_process_over_nccl(tmp_path):
    assert _run(tmp_path, NCCL_ONE, 1) == [0]


def test_nccl_on_one_card_refuses_naming_gloo(tmp_path):
    codes = _run(tmp_path, NCCL_ONE, 2, output=str(tmp_path / "out"))
    assert codes != [0, 0]
    err = "".join((tmp_path / "out" / f"rank.{r:03d}" / "stderr")
                  .read_text() for r in range(2))
    assert "HOROVOD_GPU_OPERATIONS=gloo" in err, err[-2000:]


def test_gloo_collectives_on_cuda_tensors(tmp_path):
    assert _run(tmp_path, GLOO_PROBE, 1,
                {"HOROVOD_GPU_OPERATIONS": "gloo"}) == [0]
