"""Adasum in the port (``ops/adasum.py``, the engine's Adasum buckets,
``MeshExecutor``'s Adasum reduction, ``DistributedOptimizer(op=Adasum)``
and ``make_compiled_train_step(op=Adasum)``) against the JAX package on
the same numpy-seeded inputs.

Tolerances.  The combine and the reduce: f32 rtol 1e-6 (the dot product
and the norms are f32 sums, reduced in other orders by XLA and torch);
bf16 and f16 one ulp of the output dtype (a sum one f32 ulp apart may
round the other way at the final cast).  The engine's and the compiled
step's results: rtol 1e-5 with atol 1e-6 (the same f32 sums, then one
optimizer update).  Both packages combine a fused bucket as one vector,
so the engine comparisons pin the buckets (one tensor a bucket through
``HOROVOD_FUSION_THRESHOLD=0``, or one grouped allreduce a bucket).  The
executor's own comparisons (over a gloo group, hybrid rows) are bit for
bit the stacked executor's: the same rows in the same order through the
same torch ops."""

import threading
import types

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import horovod_tpu as jhvd
import horovod_tpu.torch as jhvd_torch
import horovod_tpu_torch as thvd
import horovod_tpu_torch.torch as thvd_torch
from horovod_tpu.ops import adasum as jada
from horovod_tpu_torch.core.message import ReduceOp
from horovod_tpu_torch.ops import adasum as tada
from horovod_tpu_torch.ops.dist_ops import MeshExecutor
from horovod_tpu_torch.parallel.train import sgd

import jax.numpy as jnp
import ml_dtypes

DTYPES = {"f32": (torch.float32, jnp.float32, np.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16),
          "f16": (torch.float16, jnp.float16, np.float16)}


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    else:
        eps = float(torch.finfo(DTYPES[dtype][0]).eps)
        np.testing.assert_allclose(got, want, rtol=eps, atol=eps * 1e-3)


def _rows(R, n, seed, zero=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, n)).astype(np.float32)
    for r in zero:
        x[r] = 0.0
    return x


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["random", "a_zero", "b_zero", "both_zero",
                                  "identical", "orthogonal"])
def test_combine_matches_jax(dtype, case):
    tdt, jdt, ndt = DTYPES[dtype]
    x = _rows(2, 37, seed=3)
    if case == "a_zero":
        x[0] = 0
    elif case == "b_zero":
        x[1] = 0
    elif case == "both_zero":
        x[:] = 0
    elif case == "identical":
        x[1] = x[0]
    elif case == "orthogonal":
        x[0, 20:] = 0
        x[1, :20] = 0
    a, b = x.astype(ndt)
    got = tada.adasum_combine(torch.from_numpy(x[0]).to(tdt),
                              torch.from_numpy(x[1]).to(tdt))
    want = jada.adasum_combine(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == tdt
    _close(_np(got), np.asarray(want, np.float32), dtype)
    if case == "identical":        # coefficients 1/2 each: the row back
        _close(_np(got), x[0].astype(ndt).astype(np.float32), dtype)
    if case == "orthogonal":       # coefficients 1: the plain sum
        _close(_np(got), (a.astype(np.float32) + b.astype(np.float32)),
               dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R", [1, 2, 3, 4, 5])
def test_reduce_matches_jax(dtype, R):
    tdt, jdt, ndt = DTYPES[dtype]
    x = _rows(R, 64, seed=R, zero=(1,) if R > 2 else ())
    got = tada.adasum_reduce(torch.from_numpy(x).to(tdt))
    want = jada.adasum_reduce(jnp.asarray(x.astype(ndt)))
    assert got.dtype == tdt and tuple(got.shape) == (64,)
    _close(_np(got), np.asarray(want, np.float32), dtype)


def test_reduce_pairs_in_rank_order():
    """(0, 1), (2, 3), then the two results; a tail passes through."""
    x = torch.from_numpy(_rows(5, 16, seed=9))
    c = tada.adasum_combine
    want = c(c(c(x[0], x[1]), c(x[2], x[3])), x[4])
    assert torch.equal(tada.adasum_reduce(x), want)


# -- the engine -------------------------------------------------------------

def _engine_calls(hvd, rank, to, from_):
    """Per rank: one allreduce, pre/post-scaled, of a seeded row; one
    grouped allreduce of three tensors (one bucket, one combine over
    all of them); an integer-valued row whose combine is exact."""
    def fn():
        r = rank()
        rng = np.random.default_rng(100 + r)
        x = rng.standard_normal(33).astype(np.float32)
        g = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 2))]
        one = hvd.allreduce(to(x), op=hvd.Adasum, name="x")
        scaled = hvd.allreduce(to(x), op=hvd.Adasum, name="xs",
                               prescale_factor=0.5, postscale_factor=3.0)
        grouped = hvd.grouped_allreduce([to(t) for t in g], op=hvd.Adasum,
                                        name="g")
        ones = hvd.allreduce(to(np.full(4, float(r + 1), np.float32)),
                             op=hvd.Adasum, name="ones")
        return [from_(one), from_(scaled)] + \
            [from_(t) for t in grouped] + [from_(ones)]
    return fn


@pytest.mark.parametrize("np_", [2, 3, 4])
def test_allreduce_adasum_matches_jax_engine(np_, monkeypatch,
                                             hvd_shutdown):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    want = jhvd.run(_engine_calls(jhvd, jhvd.rank, lambda a: a,
                                  np.asarray), np=np_)
    got = thvd.run(_engine_calls(thvd, thvd.rank, torch.from_numpy,
                                 lambda t: t.numpy()), np=np_, device="cpu")
    for r in range(np_):
        for g, w in zip(got[r], want[r]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    for r in range(1, np_):
        for a, b in zip(got[r], got[0]):
            np.testing.assert_array_equal(a, b)


def test_allreduce_adasum_is_per_bucket(hvd_shutdown):
    """A grouped allreduce is one bucket: its combine takes ONE dot
    product over all its tensors, so it differs from three per-tensor
    combines (ROADMAP.md C, oracle cautions)."""
    def fn():
        r = thvd.rank()
        rng = np.random.default_rng(7 + r)
        g = [torch.from_numpy(rng.standard_normal(8).astype(np.float32))
             for _ in range(3)]
        grouped = thvd.grouped_allreduce(g, op=thvd.Adasum, name="g")
        single = [thvd.allreduce(t, op=thvd.Adasum, name=f"s{i}")
                  for i, t in enumerate(g)]
        return g, grouped, single
    res = thvd.run(fn, np=2, device="cpu")
    rows = [torch.cat(res[r][0]) for r in range(2)]
    whole = tada.adasum_reduce(torch.stack(rows))
    assert torch.equal(torch.cat(res[0][1]), whole)
    for i in range(3):
        assert torch.equal(res[0][2][i], tada.adasum_reduce(
            torch.stack([res[0][0][i], res[1][0][i]])))
    assert not torch.equal(torch.cat(res[0][2]), whole)


def test_join_contributes_zeros(hvd_shutdown):
    """A joined rank is a zero row, and adasum(a, 0) is a."""
    def fn():
        r = thvd.rank()
        if r == 1:
            thvd.join(device="cpu")
            return None
        x = torch.arange(1.0, 5.0)
        out = thvd.allreduce(x, op=thvd.Adasum, name="j")
        thvd.join(device="cpu")
        return out
    res = thvd.run(fn, np=2, device="cpu")
    assert torch.equal(res[0], torch.arange(1.0, 5.0))


# -- tests/test_collectives.py:543, :554 on both packages --------------------

def _identical(hvd, to, from_):
    def fn():
        return from_(hvd.allreduce(to(np.array([1.0, 2.0, 3.0],
                                               np.float32)), op=hvd.Adasum))
    return fn


def _orthogonal(hvd, to, from_):
    def fn():
        x = np.array([1.0, 0.0], np.float32) if hvd.rank() == 0 \
            else np.array([0.0, 1.0], np.float32)
        return from_(hvd.allreduce(to(x), op=hvd.Adasum))
    return fn


@pytest.mark.parametrize("case,expect", [(_identical, [1.0, 2.0, 3.0]),
                                         (_orthogonal, [1.0, 1.0])],
                         ids=["two_identical", "orthogonal"])
def test_collectives_adasum_cases(case, expect, hvd_shutdown):
    for out in jhvd.run(case(jhvd, lambda a: a, np.asarray), np=2):
        np.testing.assert_allclose(out, expect, rtol=1e-6)
    for out in thvd.run(case(thvd, torch.from_numpy, lambda t: t.numpy()),
                        np=2, device="cpu"):
        np.testing.assert_allclose(out, expect, rtol=1e-6)


# -- DistributedOptimizer(op=Adasum), tests/test_torch.py:587 ----------------

def _optimizer_run(hvd, frontend, rank):
    def fn():
        torch.manual_seed(7)
        with torch.no_grad():
            model = torch.nn.Linear(4, 1)
            rng = np.random.default_rng(11)
            model.weight.copy_(torch.from_numpy(
                rng.standard_normal((1, 4)).astype(np.float32)))
            model.bias.copy_(torch.from_numpy(
                rng.standard_normal(1).astype(np.float32)))
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05),
            named_parameters=model.named_parameters(), op=hvd.Adasum)
        gen = np.random.default_rng(rank())
        x = torch.from_numpy(gen.standard_normal((8, 4)).astype(np.float32))
        y = x.sum(dim=1, keepdim=True)
        losses = []
        for _ in range(10):
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(model(x), y)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        return losses, [p.detach().clone() for p in model.parameters()]
    return fn


def test_optimizer_adasum_matches_jax_frontend(monkeypatch, hvd_shutdown):
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    want = jhvd.run(_optimizer_run(jhvd, jhvd_torch, jhvd.rank), np=2)
    got = thvd.run(_optimizer_run(thvd, thvd_torch, thvd.rank), np=2,
                   device="cpu")
    for r in range(2):
        np.testing.assert_allclose(got[r][0], want[r][0], rtol=1e-5)
        for g, w in zip(got[r][1], want[r][1]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6)
        assert got[r][0][-1] < got[r][0][0]          # converging
    for a, b in zip(got[0][1], got[1][1]):
        assert torch.equal(a, b)                     # replicas in sync


# -- the compiled step, tests/test_compiled.py:387 ---------------------------

def _jax_compiled(np_):
    def loss_fn(params, batch):
        return jnp.sum(params["w"] * batch["x"]) + \
            jnp.sum(params["b"] * batch["y"])

    def fn():
        r = jhvd.rank()
        batch = {"x": np.arange(1, 5, dtype=np.float32) * (r + 1),
                 "y": np.array([3.0, -1.0], np.float32) * (r - 0.5)}
        ref = jhvd.allreduce(batch["x"].copy(), op=jhvd.Adasum,
                             name="ada_ref")
        step = jhvd.make_compiled_train_step(loss_fn, optax.sgd(1.0),
                                             op=jhvd.Adasum)
        state = step.init_state({"w": np.zeros(4, np.float32),
                                 "b": np.ones(2, np.float32)})
        state, _ = step(state, batch)
        return (np.asarray(ref), np.asarray(state["params"]["w"]),
                np.asarray(state["params"]["b"]))
    return jhvd.run(fn, np=np_)


def _port_compiled(np_):
    def loss_fn(params, batch):
        return torch.sum(params["w"] * batch["x"]) + \
            torch.sum(params["b"] * batch["y"])

    def fn():
        r = thvd.rank()
        batch = {"x": torch.arange(1, 5, dtype=torch.float32) * (r + 1),
                 "y": torch.tensor([3.0, -1.0]) * (r - 0.5)}
        ref = thvd.allreduce(batch["x"].clone(), op=thvd.Adasum,
                             name="ada_ref")
        step = thvd.make_compiled_train_step(loss_fn, sgd(1.0),
                                             op=thvd.Adasum)
        state = step.init_state({"w": torch.zeros(4), "b": torch.ones(2)})
        state, _ = step(state, batch)
        return (ref.numpy(), state["params"]["w"].detach().numpy().copy(),
                state["params"]["b"].detach().numpy().copy())
    return thvd.run(fn, np=np_, device="cpu")


@pytest.mark.parametrize("np_", [2, 3])
def test_compiled_adasum_matches_jax(np_, hvd_shutdown):
    want = _jax_compiled(np_)
    got = _port_compiled(np_)
    for r in range(np_):
        for g, w in zip(got[r], want[r]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        # per leaf: w's update is -adasum(grad of w), the engine's
        # one-tensor combine of the same rows
        np.testing.assert_allclose(-got[r][1], got[r][0], rtol=1e-6)
        xs = [np.array([3.0, -1.0], np.float32) * (q - 0.5)
              for q in range(np_)]
        b_want = 1.0 - tada.adasum_reduce(
            torch.from_numpy(np.stack(xs))).numpy()
        np.testing.assert_allclose(got[r][2], b_want, rtol=1e-6)


def test_compiled_adasum_sharded_still_refused():
    with pytest.raises(ValueError, match="adasum"):
        thvd.make_compiled_train_step(lambda p, b: p["w"].sum(), sgd(0.1),
                                      op=thvd.Adasum, sharded=True)


# -- the executor over a process group and the hybrid row order --------------

def _run_group(layout, body):
    """``body(ex)`` in one thread per simulated process, each a gloo group
    member hosting its ``layout`` positions; results in process order."""
    store = dist.HashStore()
    G, R = len(layout), sum(len(p) for p in layout)
    out, errs = [None] * G, []

    def run(g):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("ada", store), g, G)
            ex = MeshExecutor("cpu", R, group=pg, proc_positions=layout)
            out[g] = (ex.local_positions, body(ex))
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errs.append(exc)
    threads = [threading.Thread(target=run, args=(g,)) for g in range(G)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    if errs:
        raise errs[0]
    return out


ROWS = [torch.from_numpy(r) for r in _rows(4, 24, seed=21)]


@pytest.mark.parametrize("layout", [[[0], [1]], [[0, 1], [2, 3]],
                                    [[0], [1, 2]], [[0, 1, 2], [3]]],
                         ids=["2_procs", "2x2", "1+2", "3+1"])
def test_executor_adasum_over_a_group_matches_stacked(layout):
    """Over a gloo group (two processes, or the hybrid layout, even and
    uneven) every process gets the stacked executor's Adasum bit for bit:
    the process-major rows of the gather are the rank order, so the
    pairwise tree combines the same pairs."""
    R = sum(len(p) for p in layout)
    rows = ROWS[:R]
    want = MeshExecutor("cpu", R).reduce([r.clone() for r in rows],
                                         ReduceOp.ADASUM)[0]
    assert torch.equal(want, tada.adasum_reduce(torch.stack(rows)))
    scaled = MeshExecutor("cpu", R).allreduce([r.clone() for r in rows],
                                              ReduceOp.ADASUM, 0.5, 2.0)
    for positions, (got, got_scaled) in _run_group(
            layout, lambda ex: (
                ex.reduce([rows[p].clone() for p in ex.local_positions],
                          ReduceOp.ADASUM)[0],
                ex.allreduce([rows[p].clone() for p in ex.local_positions],
                             ReduceOp.ADASUM, 0.5, 2.0))):
        assert torch.equal(got, want), positions
        for i, p in enumerate(positions):
            assert torch.equal(got_scaled[i], scaled[p])


@pytest.mark.parametrize("ranks_of_proc", [None, [1, 3], [2, 2]],
                         ids=["uniform_2x2", "1+3", "hetero_2x2"])
def test_engine_layouts_keep_rank_order(ranks_of_proc):
    """Adasum's pairs follow row order, and the executor's gather is
    process-major, so the order holds only because every layout the
    engine builds is a contiguous run a process in group order
    (``Engine._proc_of`` is monotone in the rank); the executor refuses
    any other layout rather than reorder rows."""
    from horovod_tpu_torch.core.engine import Engine
    eng = types.SimpleNamespace(num_local=2, ranks_of_proc=ranks_of_proc,
                                _proc_starts=None)
    if ranks_of_proc:
        eng._proc_starts = [sum(ranks_of_proc[:i])
                            for i in range(len(ranks_of_proc))]
    ranks = list(range(4))
    procs = sorted({Engine._proc_of(eng, r) for r in ranks})
    positions = [[i for i, r in enumerate(ranks)
                  if Engine._proc_of(eng, r) == p] for p in procs]
    assert [q for p in positions for q in p] == ranks
    store = dist.HashStore()
    pg = dist.ProcessGroupGloo(dist.PrefixStore("lay", store), 0, 1)
    with pytest.raises(ValueError, match="contiguous ascending run"):
        MeshExecutor("cpu", 2, group=pg, proc_positions=[[1, 0]])
