"""``horovod_tpu_torch.torch.SyncBatchNorm`` against the JAX package's
(``horovod_tpu.torch.SyncBatchNorm``) and against plain batch norm over
the concatenated global batch, at rank threads on the CPU.

Tolerances.  Port against the JAX module: rtol 1e-6 with atol 1e-6 for
outputs, running statistics and the input, weight and bias gradients
(the same torch math on both sides; only the allreduced sums come from
other reductions: the JAX engine sums in numpy or XLA, the port in
torch).  Against plain batch norm over the global batch: atol 1e-5, as
``tests/test_torch.py:264`` holds it (E[x^2] - mean^2 from allreduced
sums against torch's two-pass variance)."""

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu.torch as jhvd_torch
import horovod_tpu_torch as thvd
import horovod_tpu_torch.torch as thvd_torch

NP = 4


def _trun(fn, np_=NP):
    return thvd.run(fn, np=np_, device="cpu")


def _jrun(fn, np_=NP):
    return jhvd.run(fn, np=np_)


# -- tests/test_torch.py:244 and :264 on both packages ------------------------

def _running_mean_case(hvd, frontend):
    def fn():
        bn = frontend.SyncBatchNorm(3, momentum=1.0)
        bn.train()
        g = torch.Generator().manual_seed(hvd.rank())
        x = torch.randn(4, 3, 2, generator=g, requires_grad=True)
        out = bn(x)
        out.sum().backward()
        assert x.grad is not None
        return bn.running_mean.numpy().copy()
    return fn


@pytest.mark.parametrize("package", ["port", "jax"])
def test_sync_batch_norm(package, hvd_shutdown):
    if package == "port":
        means = _trun(_running_mean_case(thvd, thvd_torch))
    else:
        means = _jrun(_running_mean_case(jhvd, jhvd_torch))
    # running statistics identical across ranks (global statistics)
    for m in means[1:]:
        assert np.allclose(m, means[0], atol=1e-6)


@pytest.mark.parametrize("sizes", [[4] * NP, [2, 5, 3, 6][:NP]],
                         ids=["even", "uneven"])
@pytest.mark.parametrize("package", ["port", "jax"])
def test_sync_batch_norm_matches_global_batch(sizes, package, hvd_shutdown):
    """Per-rank shards (even or uneven) normalize like plain BN over the
    concatenated global batch (the sum/count packing weights ranks by
    their true element counts)."""
    xs = [torch.randn(s, 3, generator=torch.Generator().manual_seed(r))
          for r, s in enumerate(sizes)]
    hvd, frontend, run = (thvd, thvd_torch, _trun) if package == "port" \
        else (jhvd, jhvd_torch, _jrun)

    def fn():
        bn = frontend.SyncBatchNorm(3, momentum=1.0, affine=False)
        bn.train()
        return bn(xs[hvd.rank()]).detach().numpy()

    outs = run(fn)
    bn_ref = torch.nn.BatchNorm1d(3, momentum=1.0, affine=False)
    bn_ref.train()
    ref = bn_ref(torch.cat(xs)).detach().numpy()
    got = np.concatenate(outs)
    assert np.allclose(got, ref, atol=1e-5), np.abs(got - ref).max()


# -- the port against the JAX module ------------------------------------------

def _inputs(shape, sizes, seed=0):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((s,) + shape) * 2.0 + 0.5).astype(np.float32)
          for s in sizes]
    dys = [rng.standard_normal((s,) + shape).astype(np.float32)
           for s in sizes]
    w = rng.uniform(0.5, 1.5, shape[0]).astype(np.float32)
    b = rng.standard_normal(shape[0]).astype(np.float32)
    return xs, dys, w, b


def _module_case(hvd, frontend, xs, dys, w, b, steps, momentum,
                 process_set=None):
    def fn():
        r = hvd.rank()
        kw = {} if process_set is None else {"process_set": process_set()}
        bn = frontend.SyncBatchNorm(len(w), momentum=momentum, **kw)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(w))
            bn.bias.copy_(torch.from_numpy(b))
        bn.train()
        res = []
        for _ in range(steps):
            x = torch.from_numpy(xs[r]).requires_grad_()
            bn.zero_grad()
            out = bn(x)
            (out * torch.from_numpy(dys[r])).sum().backward()
            res.append((out.detach().numpy().copy(),
                        x.grad.numpy().copy(),
                        bn.weight.grad.numpy().copy(),
                        bn.bias.grad.numpy().copy()))
        bn.eval()
        ev = bn(torch.from_numpy(xs[r])).detach().numpy().copy()
        return (res, bn.running_mean.numpy().copy(),
                bn.running_var.numpy().copy(),
                int(bn.num_batches_tracked), ev)
    return fn


def _assert_same(got, want):
    for (rg, mg, vg, ng, eg), (rw, mw, vw, nw, ew) in zip(got, want):
        for step_g, step_w in zip(rg, rw):
            for a, b in zip(step_g, step_w):
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mg, mw, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(vg, vw, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(eg, ew, rtol=1e-6, atol=1e-6)
        assert ng == nw


@pytest.mark.parametrize("shape,sizes", [
    ((3,), [4, 4, 4, 4]), ((3, 5), [2, 5, 3, 6]), ((4, 3, 3), [2, 2, 3, 1])],
    ids=["1d", "2d_uneven", "3d_uneven"])
@pytest.mark.parametrize("momentum", [0.1, None])
def test_module_matches_jax(shape, sizes, momentum, hvd_shutdown):
    """Two training steps (outputs; input, weight and bias gradients),
    the running statistics (unbiased variance, a momentum or the
    cumulative average), and an eval-mode forward on them."""
    xs, dys, w, b = _inputs(shape, sizes)
    got = _trun(_module_case(thvd, thvd_torch, xs, dys, w, b, 2, momentum))
    want = _jrun(_module_case(jhvd, jhvd_torch, xs, dys, w, b, 2, momentum))
    _assert_same(got, want)
    # every rank holds the same statistics
    for g in got[1:]:
        np.testing.assert_array_equal(g[1], got[0][1])
        np.testing.assert_array_equal(g[2], got[0][2])


def test_input_gradient_matches_global_batch_autograd(hvd_shutdown):
    """The synchronized backward is autograd of plain batch norm over the
    concatenated batch (atol 1e-5)."""
    xs, dys, w, b = _inputs((3, 2), [3, 5, 2, 4], seed=4)
    got = _trun(_module_case(thvd, thvd_torch, xs, dys, w, b, 1, 0.1))
    bn = torch.nn.BatchNorm1d(3)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    x = torch.from_numpy(np.concatenate(xs)).requires_grad_()
    (bn(x) * torch.from_numpy(np.concatenate(dys))).sum().backward()
    np.testing.assert_allclose(np.concatenate([g[0][0][1] for g in got]),
                               x.grad.numpy(), atol=1e-5)
    # each rank's weight gradient is its own shard's: their sum is the
    # global one
    np.testing.assert_allclose(sum(g[0][0][2] for g in got),
                               bn.weight.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(got[0][1], bn.running_mean.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got[0][2], bn.running_var.numpy(),
                               atol=1e-5)


def test_size_one_and_eval_are_plain_batch_norm(hvd_shutdown):
    """At one rank (the job's size) and in eval mode the module is
    torch's own batch norm: no collective."""
    x = torch.from_numpy(_inputs((3, 4), [6])[0][0])

    def fn():
        bn = thvd_torch.SyncBatchNorm(3)
        ref = torch.nn.BatchNorm1d(3)
        out = bn(x)
        eng = thvd.engine()
        before = eng.allreduce_buckets
        bn.eval()
        ref.load_state_dict(bn.state_dict())
        ref.eval()
        return (torch.equal(out, torch.nn.BatchNorm1d(3)(x)),
                torch.equal(bn(x), ref(x)),
                eng.allreduce_buckets - before)

    assert _trun(fn, 1)[0] == (True, True, 0)

    def evalfn():
        bn = thvd_torch.SyncBatchNorm(3)
        bn.eval()
        eng = thvd.engine()
        before = eng.allreduce_buckets
        out = bn(x)
        return torch.equal(out, torch.nn.functional.batch_norm(
            x, torch.zeros(3), torch.ones(3), torch.ones(3),
            torch.zeros(3))), eng.allreduce_buckets - before

    assert _trun(evalfn, 2) == [(True, 0), (True, 0)]


def test_process_set(hvd_shutdown):
    """Statistics over a process set's ranks only; the ranks outside it
    run no SyncBatchNorm.  Both packages agree."""
    xs, dys, w, b = _inputs((3,), [4, 3, 5, 2], seed=6)

    def run_case(hvd, frontend, run):
        def fn():
            ps = hvd.add_process_set([0, 2])
            try:
                if hvd.rank() not in (0, 2):
                    return None
                return _module_case(hvd, frontend, xs, dys, w, b, 1, 0.1,
                                    process_set=lambda: ps)()
            finally:
                hvd.remove_process_set(ps)
        return run(fn)

    got = run_case(thvd, thvd_torch, _trun)
    want = run_case(jhvd, jhvd_torch, _jrun)
    assert got[1] is None and got[3] is None
    _assert_same([got[0], got[2]], [want[0], want[2]])
    # against plain batch norm over ranks 0 and 2's rows
    bn = torch.nn.BatchNorm1d(3, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    ref = bn(torch.from_numpy(np.concatenate([xs[0], xs[2]])))
    np.testing.assert_allclose(
        np.concatenate([got[0][0][0][0], got[2][0][0][0]]),
        ref.detach().numpy(), atol=1e-5)
