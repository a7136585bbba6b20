"""DistributedOptimizer(sharded=True) of horovod_tpu_torch against the JAX
package's and against the port's own dense optimizer, on the CPU at rank
threads, from the same numpy weights and numpy-seeded batches (as
tests/test_sharded.py's ``_torch_worker``): Adam and SGD with momentum at
np 2 and 4 on the f32 wire, the int8 and int4 wires with their
error-feedback residuals, a state-dict re-shard from dp 2 to dp 4,
parameters without gradients, the HOROVOD_SHARDED_OPTIMIZER default, and
the slice as a whole: a small conv + BN model trained 3 steps through
both packages.

Tolerance: the JAX bar of tests/test_sharded.py, max |delta| <= 2e-6 on
the parameters, against the JAX package's sharded run and against the
port's dense run (the flat shard update and the per-tensor one may
round a fused multiply-add apart, and at np=4 the sums over ranks
associate in another order); ranks bit-identical with each other.  At
np=2 every reduction is one correctly rounded operation and both
packages run the same torch optimizer on the same flat shards, so the
f32 runs and the quantized-wire runs (the same codec: the plain codec is
numpy's bit for bit, tests/test_torch_quantize.py) equal the JAX
package's bit for bit."""

import numpy as np
import pytest
import torch

import horovod_tpu
import horovod_tpu.torch as jax_torch
import horovod_tpu_torch
import horovod_tpu_torch.torch as port_torch

PARITY = 2e-6


def _run(pkg, fn, np_):
    if pkg is jax_torch:
        return horovod_tpu.run(fn, np=np_)
    return horovod_tpu_torch.run(fn, np=np_, device="cpu")


def _model():
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    rng = np.random.RandomState(0)
    model.load_state_dict({
        k: torch.tensor(rng.randn(*v.shape), dtype=torch.float32) * 0.1
        for k, v in model.state_dict().items()})
    return model


def _optimizer(name, params):
    if name == "adam":
        return torch.optim.Adam(params, lr=1e-2)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=1e-2, weight_decay=0.1)
    return torch.optim.SGD(params, lr=0.05, momentum=0.9)


def _worker(pkg, sharded, opt_name="adam", steps=4, wire="none",
            per_rank=True, seed=100, fixed_batch=False):
    model = _model()
    opt = pkg.DistributedOptimizer(
        _optimizer(opt_name, model.parameters()),
        named_parameters=model.named_parameters(),
        compression=getattr(pkg.Compression, wire), sharded=sharded)
    rng = np.random.RandomState(seed + (pkg.rank() if per_rank else 0))
    losses = []
    if fixed_batch:
        xb, yb = rng.randn(6, 8), rng.randn(6, 4)
    for _ in range(steps):
        if not fixed_batch:
            xb, yb = rng.randn(6, 8), rng.randn(6, 4)
        x = torch.tensor(xb, dtype=torch.float32)
        y = torch.tensor(yb, dtype=torch.float32)
        opt.zero_grad()
        loss = ((model(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, [p.detach().numpy().copy() for p in model.parameters()], \
        opt


def _params(results):
    return [r[1] for r in results]


def _worst(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def _ranks_identical(params):
    for r in range(1, len(params)):
        for a, b in zip(params[0], params[r]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("np_", [2, 4])
@pytest.mark.parametrize("opt_name", ["adam", "sgd"])
def test_sharded_matches_jax_and_dense(opt_name, np_):
    def job(pkg, sharded):
        return _params(_run(pkg, lambda: _worker(pkg, sharded, opt_name)[:2],
                            np_))

    port_sh = job(port_torch, True)
    jax_sh = job(jax_torch, True)
    port_dn = job(port_torch, False)
    _ranks_identical(port_sh)
    if np_ == 2:
        for a, b in zip(port_sh[0], jax_sh[0]):
            np.testing.assert_array_equal(a, b)
    assert _worst(port_sh[0], jax_sh[0]) <= PARITY
    assert _worst(port_sh[0], port_dn[0]) <= PARITY


@pytest.mark.parametrize("wire", ["int8", "int4", "bf16"])
def test_quantized_and_16bit_wires_match_jax(wire):
    """The gradient and parameter wires with their error feedback: the
    port's run equals the JAX package's bit for bit at np=2, ranks stay
    identical, both residual families populate on the quantized wires
    (the cast wire keeps parameter residuals only) and reset_wire_state
    drops them."""
    def fn(pkg):
        losses, params, opt = _worker(pkg, True, steps=6, wire=wire,
                                      seed=17, fixed_batch=True)
        upd = opt._updater
        grad_r, param_r = len(upd._grad_residuals), \
            len(upd._param_residuals)
        opt.reset_wire_state()
        return losses, params, (grad_r, param_r,
                                len(upd._grad_residuals)
                                + len(upd._param_residuals))

    got = _run(port_torch, lambda: fn(port_torch), 2)
    want = _run(jax_torch, lambda: fn(jax_torch), 2)
    _ranks_identical(_params(got))
    for a, b in zip(got[0][1], want[0][1]):
        np.testing.assert_array_equal(a, b)
    assert got[0][0] == want[0][0]
    n_buckets = got[0][2][1]
    quantized = wire in ("int8", "int4")
    assert got[0][2] == ((n_buckets if quantized else 0), n_buckets, 0)
    assert n_buckets >= 1
    assert np.mean(got[0][0][-3:]) < np.mean(got[0][0][:3])


def test_wire_counters_and_state_bytes():
    """Engine accounting: one sharded update per rank and step; per step
    and bucket the reducescatter's padded row (full width, and its int8
    codes plus 2 bytes a block) and the parameter allgather (the bucket,
    and every rank's codes plus 2 bytes a block) in the wire counters;
    the optimizer state per rank a half of the dense state, to within one
    element per bucket."""
    def fn():
        _l, _p, opt = _worker(port_torch, True, opt_name="sgd", steps=3,
                              wire="int8")
        eng = horovod_tpu_torch.engine()
        return (eng.sharded_update_runs, eng.logical_wire_bytes,
                eng.actual_wire_bytes, opt._updater.state_bytes,
                opt._updater.plan)

    runs, logical, actual, state, plan = horovod_tpu_torch.run(
        fn, np=2, device="cpu")[0]
    assert runs == 2 * 3
    want_l = want_a = 0
    for b in plan.buckets:
        row = 2 * max(b.chunks)
        nb = -(-row // 256)
        want_l += row * 4 + b.n * 4
        want_a += nb * 258 + sum(-(-m // 256) * 258 for m in b.chunks)
    assert (logical, actual) == (3 * want_l, 3 * want_a)
    # SGD momentum: one f32 buffer per element
    total = plan.total_elems
    assert abs(state["shard"] - total * 4 / 2) <= 4 * len(plan.buckets)
    assert state["full"] == pytest.approx(total * 4,
                                          abs=4 * len(plan.buckets))


def test_state_dict_reshards_from_dp2_to_dp4():
    """State saved at dp=2 restores at dp=4 by re-slicing (params and
    Adam moments), continuing where one never-resized run would be: the
    same per-rank data makes the dense single-rank run the oracle."""
    def reference():
        model = _model()
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        rng = np.random.RandomState(55)
        for _ in range(5):
            x = torch.tensor(rng.randn(6, 8), dtype=torch.float32)
            y = torch.tensor(rng.randn(6, 4), dtype=torch.float32)
            opt.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            opt.step()
        return [p.detach().numpy().copy() for p in model.parameters()]

    def phase1():
        _l, params, opt = _worker(port_torch, True, steps=3, per_rank=False,
                                  seed=55)
        return params, opt.state_dict()

    _params_a, sd = horovod_tpu_torch.run(phase1, np=2, device="cpu")[0]
    assert sd["hvd_sharded"]

    def phase2():
        model = _model()
        opt = port_torch.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters(), sharded=True)
        opt.load_state_dict(sd)
        rng = np.random.RandomState(55)
        for i in range(5):
            x = torch.tensor(rng.randn(6, 8), dtype=torch.float32)
            y = torch.tensor(rng.randn(6, 4), dtype=torch.float32)
            if i < 3:
                continue          # phase 1 took these
            opt.zero_grad()
            ((model(x) - y) ** 2).mean().backward()
            opt.step()
        return [p.detach().numpy().copy() for p in model.parameters()]

    got = horovod_tpu_torch.run(phase2, np=4, device="cpu")
    _ranks_identical(got)
    assert _worst(got[0], reference()) <= PARITY
    with pytest.raises(RuntimeError, match="sharded state dict"):
        horovod_tpu_torch.run(
            lambda: port_torch.DistributedOptimizer(
                torch.optim.Adam(_model().parameters()), sharded=True)
            .load_state_dict({"state": {}}), np=1, device="cpu")


def test_params_without_grads_are_skipped_like_dense():
    """A parameter whose grad is None keeps its value and its state, as
    the dense wrapper (and the JAX package's sharded one) leaves it."""
    def worker(pkg, sharded):
        model = _model()
        frozen = model[2].bias          # never receives a gradient
        opt = pkg.DistributedOptimizer(
            _optimizer("adamw", model.parameters()),
            named_parameters=model.named_parameters(), sharded=sharded)
        rng = np.random.RandomState(9)
        for _ in range(3):
            x = torch.tensor(rng.randn(6, 8), dtype=torch.float32)
            opt.zero_grad()
            h = torch.relu(model[0](x))
            (h @ model[2].weight.t()).pow(2).mean().backward()
            opt.step()
        return [p.detach().numpy().copy() for p in model.parameters()], \
            frozen.detach().numpy().copy()

    sh = _run(port_torch, lambda: worker(port_torch, True), 2)[0]
    dn = _run(port_torch, lambda: worker(port_torch, False), 2)[0]
    jx = _run(jax_torch, lambda: worker(jax_torch, True), 2)[0]
    np.testing.assert_array_equal(sh[1], dn[1])
    np.testing.assert_array_equal(sh[1], _model()[2].bias.detach().numpy())
    assert _worst(sh[0], dn[0]) <= PARITY
    for a, b in zip(sh[0], jx[0]):
        np.testing.assert_array_equal(a, b)


def test_env_default_engages_sharded(monkeypatch):
    monkeypatch.setenv("HOROVOD_SHARDED_OPTIMIZER", "1")

    def fn():
        model = _model()
        opt = port_torch.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2),
            named_parameters=model.named_parameters())
        dense = port_torch.DistributedOptimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2), sharded=False)
        return hasattr(opt, "_shard_init"), hasattr(dense, "_shard_init")

    assert horovod_tpu_torch.run(fn, np=2, device="cpu")[0] == (True, False)


# ---------------------------------------------------------------------------
# the slice as a whole

class _ConvBN(torch.nn.Module):
    """A small conv + BN classifier (the ResNet path's layer kinds)."""

    def __init__(self):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False)
        self.bn1 = torch.nn.BatchNorm2d(8)
        self.conv2 = torch.nn.Conv2d(8, 16, 3, stride=2, padding=1,
                                     bias=False)
        self.bn2 = torch.nn.BatchNorm2d(16)
        self.fc = torch.nn.Linear(16, 10)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        return self.fc(x.mean((2, 3)))


def _conv_bn_worker(pkg, sharded):
    model = _ConvBN()
    rng = np.random.RandomState(3)
    model.load_state_dict({
        k: torch.tensor(rng.standard_normal(v.shape) * 0.3,
                        dtype=v.dtype) if v.dtype.is_floating_point else v
        for k, v in model.state_dict().items()})
    opt = pkg.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters(), sharded=sharded)
    data = np.random.RandomState(40 + pkg.rank())
    losses = []
    for _ in range(3):
        x = torch.tensor(data.standard_normal((4, 3, 8, 8)),
                         dtype=torch.float32)
        y = torch.tensor(data.randint(0, 10, size=4))
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, [p.detach().numpy().copy() for p in model.parameters()]


def test_slice_conv_bn_model_trains_sharded_like_jax():
    got = _run(port_torch, lambda: _conv_bn_worker(port_torch, True), 2)
    want = _run(jax_torch, lambda: _conv_bn_worker(jax_torch, True), 2)
    dense = _run(port_torch, lambda: _conv_bn_worker(port_torch, False), 2)
    _ranks_identical(_params(got))
    assert all(np.isfinite(got[0][0]))
    assert got[0][0] == want[0][0]
    for a, b in zip(got[0][1], want[0][1]):
        np.testing.assert_array_equal(a, b)
    assert _worst(got[0][1], dense[0][1]) <= PARITY
