"""reducescatter, grouped_reducescatter and grouped_allgather of
horovod_tpu_torch against the JAX package, each package running the same
user function through its own ``run(fn, np=...)`` (the port on the CPU)
on the same numpy-seeded inputs: Sum and Average with pre/post scale, on
the f32, bf16, int8 and int4 wires, first dimensions that do not divide
by the rank count; the engine's wire counters; the typed error on every
rank for a mismatched ``shard_fp``; the reducescatter autograd Functions'
backward; and ``DistributedOptimizer``'s positional signature.

Tolerance, tests/test_torch_wire.py's rule: bit for bit at np=2 (every
step is one correctly rounded operation on both sides).  At np=3 the
only freedom is the order of the sum over ranks: the bound is
4 eps (sum_r |term_r| scale + |want|), eps the unit roundoff of the
accumulating type (f32 on the f32 and quantized wires, whose terms are
the decoded rows; bf16 on the bf16 wire).  Wire counters are integers
and equal exactly; allgather and the backward's reductions of two terms
are exact."""

import threading
import warnings

import numpy as np
import pytest
import torch

import horovod_tpu
import horovod_tpu.torch as jax_torch
from horovod_tpu.common import basics as jax_basics
from horovod_tpu.ops import quantize as jqz
import horovod_tpu_torch
import horovod_tpu_torch.torch as port_torch
from horovod_tpu_torch.common import basics as port_basics
from horovod_tpu_torch.core.sharded import chunk_sizes

WIRES = ["f32", "bf16", "int8", "int4"]
SCALED = [("SUM", 1.0, 1.0), ("AVERAGE", 0.5, 3.0)]
SINGLE = (7, 3)
GROUP = [(5,), (2, 4), (300,)]
_EPS = {"f32": 2.0 ** -24, "int8": 2.0 ** -24, "int4": 2.0 ** -24,
        "bf16": 2.0 ** -8}


def _inputs(r):
    rng = np.random.default_rng(70 + r)
    single = rng.standard_normal(SINGLE).astype(np.float32)
    group = [(rng.standard_normal(s) * 2).astype(np.float32) for s in GROUP]
    return single, group


def _counters(mod_basics):
    e = mod_basics.engine()
    return np.array([e.logical_wire_bytes, e.actual_wire_bytes,
                     e.quantized_bucket_runs])


def _job(mod, mod_basics, to_pkg, from_pkg, wire, op, pre, post, np_):
    """One reducescatter, one grouped reducescatter and one grouped
    allgather per rank; returns per rank (results, rank 0's counter
    deltas over the two reducescatters)."""
    barrier = threading.Barrier(np_)

    def fn():
        r = mod.rank()
        single, group = _inputs(r)
        before = _counters(mod_basics)
        barrier.wait()
        kw = dict(op=getattr(mod, op.title()), prescale_factor=pre,
                  postscale_factor=post, wire_dtype=wire)
        a = mod.reducescatter(to_pkg(single), name="a", **kw)
        g = mod.grouped_reducescatter([to_pkg(x) for x in group], name="g",
                                      **kw)
        barrier.wait()
        delta = _counters(mod_basics) - before
        ag = mod.grouped_allgather([to_pkg(x) for x in group], name="ag")
        return [from_pkg(a)] + [from_pkg(x) for x in g] + \
            [from_pkg(x) for x in ag], delta

    if mod is horovod_tpu:
        return mod.run(fn, np=np_)
    return mod.run(fn, np=np_, device="cpu")


def _jax_job(*args):
    return _job(horovod_tpu, jax_basics, lambda x: x, np.asarray, *args)


def _port_job(*args):
    return _job(horovod_tpu_torch, port_basics, torch.from_numpy,
                lambda t: t.numpy(), *args)


def _chunk(x, np_, r):
    chunks = chunk_sizes(x.shape[0], np_)
    start = sum(chunks[:r])
    return x[start:start + chunks[r]]


def _terms(wire, xs, np_, r):
    """sum over ranks of |term| on rank r's chunk: the decoded padded
    rows on a quantized wire (each rank encodes its own padded row), the
    values otherwise."""
    if wire not in ("int8", "int4"):
        return sum(np.abs(_chunk(x, np_, r)) for x in xs)
    out = 0
    for x in xs:
        chunks = chunk_sizes(x.shape[0], np_)
        rest = int(np.prod(x.shape[1:]))
        m = max(chunks) * rest
        pad = np.zeros(np_ * m, np.float32)
        src = 0
        for j, c in enumerate(chunks):
            pad[j * m:j * m + c * rest] = x.reshape(-1)[src:src + c * rest]
            src += c * rest
        dec = jqz.np_fake_quantize_wire(pad, wire)
        out = out + np.abs(dec[r * m:r * m + chunks[r] * rest]).reshape(
            (chunks[r],) + x.shape[1:])
    return out


@pytest.mark.parametrize("np_", [2, 3])
@pytest.mark.parametrize("op,pre,post", SCALED)
@pytest.mark.parametrize("wire", WIRES)
def test_reducescatter_and_grouped_ops_match_jax(wire, op, pre, post, np_):
    want = _jax_job(wire, op, pre, post, np_)
    got = _port_job(wire, op, pre, post, np_)
    np.testing.assert_array_equal(got[0][1], want[0][1])
    # one encode per payload
    assert got[0][1][2] == (1 + len(GROUP) if wire in ("int8", "int4") else 0)
    inputs = [_inputs(r) for r in range(np_)]
    scale = abs(pre * post) / (np_ if op == "AVERAGE" else 1)
    n_rs = 1 + len(GROUP)
    for r in range(np_):
        assert len(got[r][0]) == len(want[r][0]) == n_rs + len(GROUP)
        for i, (g, w) in enumerate(zip(got[r][0], want[r][0])):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, i
            if np_ == 2 or i >= n_rs:
                np.testing.assert_array_equal(g, w, err_msg=f"{r} {i}")
                continue
            xs = [x[0] if i == 0 else x[1][i - 1] for x in inputs]
            bound = 4 * _EPS[wire] * (_terms(wire, xs, np_, r) * scale
                                      + np.abs(w))
            np.testing.assert_array_less(np.abs(g - w), bound + 1e-30)


def test_grouped_allgather_concatenates_ranks_in_order():
    def fn():
        r = horovod_tpu_torch.rank()
        out = horovod_tpu_torch.grouped_allgather(
            [torch.full((r + 1, 2), float(r)), torch.tensor(float(r))],
            name="cat")
        h = horovod_tpu_torch.grouped_allgather_async(
            [torch.arange(3) + r], name="one")
        return out, horovod_tpu_torch.synchronize(h)

    for out, one in horovod_tpu_torch.run(fn, np=3, device="cpu"):
        assert torch.equal(out[0], torch.cat(
            [torch.full((r + 1, 2), float(r)) for r in range(3)]))
        assert torch.equal(out[1], torch.arange(3.0))
        assert isinstance(one, list) and len(one) == 1
        assert torch.equal(one[0], torch.cat([torch.arange(3) + r
                                              for r in range(3)]))


def test_grouped_ops_refuse_mixed_dtypes_and_scalars():
    def fn():
        errors = []
        for call in (
                lambda: horovod_tpu_torch.grouped_allgather(
                    [torch.ones(2), torch.ones(2, dtype=torch.int32)]),
                lambda: horovod_tpu_torch.grouped_reducescatter(
                    [torch.ones(2), torch.ones(2, dtype=torch.float64)]),
                lambda: horovod_tpu_torch.reducescatter(torch.tensor(1.0)),
                lambda: horovod_tpu_torch.grouped_reducescatter([])):
            with pytest.raises(ValueError) as info:
                call()
            errors.append(str(info.value))
        return errors

    assert len(horovod_tpu_torch.run(fn, np=2, device="cpu")[0]) == 4


def test_shard_layout_mismatch_raises_typed_error_on_every_rank():
    """Ranks whose shard-layout fingerprints disagree fail the
    collective loudly on every rank, on both the reducescatter and the
    allgather side, as the JAX package does (tests/test_sharded.py)."""
    def make(mod, from_arr):
        def fn():
            rank = mod.rank()
            outcomes = []
            for op_name in ("rs", "ag"):
                fn_ = mod.grouped_reducescatter if op_name == "rs" \
                    else mod.grouped_allgather
                try:
                    fn_([from_arr(np.ones((8,), np.float32))],
                        name=f"mm.{op_name}", shard_fp=f"layout-{rank}")
                    outcomes.append((op_name, None, None))
                except Exception as exc:  # noqa: BLE001
                    outcomes.append((op_name, type(exc).__name__,
                                     str(exc)))
            ok = mod.grouped_reducescatter(
                [from_arr(np.full((8,), rank + 1.0, np.float32))],
                name="mm.ok", op=mod.Sum, shard_fp="same")
            return outcomes, np.asarray(ok[0])
        return fn

    want = horovod_tpu.run(make(horovod_tpu, np.asarray), np=2)
    got = horovod_tpu_torch.run(make(horovod_tpu_torch, torch.from_numpy),
                                np=2, device="cpu")
    for (outcomes, ok), (w_outcomes, w_ok) in zip(got, want):
        for (op_name, name, msg), (_, w_name, _) in zip(outcomes,
                                                        w_outcomes):
            assert name == w_name == "TensorShapeMismatchError", \
                (op_name, name, msg)
            assert "shard layout" in msg.lower(), msg
        np.testing.assert_array_equal(ok, w_ok)
        np.testing.assert_array_equal(ok, np.full(4, 3.0, np.float32))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("op", ["Sum", "Average"])
def test_reducescatter_backward_matches_jax(op, exact, monkeypatch):
    """HorovodReducescatter and HorovodGroupedReducescatter: the forward
    and the input gradient of ``sum(out * w_r)`` on each rank, against
    the JAX package's torch frontend, under the reference's convention
    and the exact adjoint (HOROVOD_EXACT_ADJOINT_REDUCESCATTER)."""
    if exact:
        monkeypatch.setenv("HOROVOD_EXACT_ADJOINT_REDUCESCATTER", "1")
    np_ = 2

    def make(mod):
        def fn():
            r = mod.rank()
            rng = np.random.default_rng(5 + r)
            x = torch.tensor(rng.standard_normal((5, 2)), dtype=torch.float32,
                             requires_grad=True)
            ys = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                               requires_grad=True) for s in ((4,), (7, 3))]
            kw = dict(op=getattr(mod, op), prescale_factor=0.5,
                      postscale_factor=2.0)
            out = mod.reducescatter(x, name="bw", **kw)
            gout = mod.grouped_reducescatter(ys, name="gbw", **kw)
            loss = (out * (r + 1.0)).sum() + sum(
                (g * (r + 2.0)).sum() for g in gout)
            loss.backward()
            return [t.detach().numpy().copy() for t in [out, *gout]], \
                [t.grad.numpy().copy() for t in [x, *ys]]
        return fn

    want = horovod_tpu.run(make(jax_torch), np=np_)
    got = horovod_tpu_torch.run(make(port_torch), np=np_, device="cpu")
    for (g_out, g_grad), (w_out, w_grad) in zip(got, want):
        for a, b in zip(g_out + g_grad, w_out + w_grad):
            np.testing.assert_array_equal(a, b)


def test_distributed_optimizer_positional_signature_matches_jax():
    """The factory binds a positional call as the JAX package's does:
    ``num_groups`` 7th, ``groups`` 8th, ``sparse_as_dense`` 9th,
    ``process_set`` 10th, ``sharded`` 11th."""
    import inspect
    from horovod_tpu.torch.optimizer import DistributedOptimizer as JaxDO
    from horovod_tpu_torch.torch.optimizer import DistributedOptimizer

    assert list(inspect.signature(DistributedOptimizer).parameters) == \
        list(inspect.signature(JaxDO).parameters)

    def fn():
        model = torch.nn.Linear(4, 2)
        params = list(model.parameters())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            opt = DistributedOptimizer(
                torch.optim.SGD(params, lr=0.1), None,
                port_torch.Compression.none, 1, port_torch.Average, 1.0, 2)
        deprecated = [w for w in caught
                      if issubclass(w.category, DeprecationWarning)]
        # sparse gradients are ported (A7): only the sharded wrapper
        # refuses sparse_as_dense
        assert DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                    sparse_as_dense=True).sparse_as_dense
        with pytest.raises(ValueError, match="sparse_as_dense"):
            DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                 sparse_as_dense=True, sharded=True)
        sharded = DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1), None,
            port_torch.Compression.none, 1, port_torch.Average, 1.0, 0, None,
            False, port_torch.global_process_set, True)
        with pytest.raises(ValueError, match="groups"):
            DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                 num_groups=2, sharded=True)
        return (len(opt._groups), len(deprecated),
                hasattr(sharded, "_shard_init"))

    # one rank: catch_warnings is process-wide, not per thread
    assert horovod_tpu_torch.run(fn, np=1, device="cpu")[0] == (2, 1, True)
