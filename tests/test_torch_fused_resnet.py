"""The fused ResNet of horovod_tpu_torch (``ResNet(fused=True)``) against
flax ``ResNet(fused=True)`` of the JAX package, on the same weights
(carried over by ``from_flax_variables``), at stages [1, 1, 1, 1], 8
filters, 4 images of 32 x 32, f32 ``dtype``.  The JAX side runs its Pallas
kernels in interpret mode (jitted); the port runs the plain versions of
its kernels, as on any CPU tensor.

Tolerances, per tensor, relative to the JAX value (L2 norm of the
difference over the L2 norm of the reference):

* eval logits and eval-mode gradients: 1e-4.  Both sides compute in
  f32; the fold rounds ``xh`` to bf16 and the backward rounds ``ytot``
  to bf16 on both sides, and in eval mode the folds come from the
  running statistics, which both sides hold bit for bit, so f32
  reassociation (~1e-7, measured 2e-7 and 6e-7) rarely flips one of
  those roundings;
* train logits and running statistics: 2e-3.  In training the folds
  come from batch statistics, which the two packages sum in different
  orders; ``var = s2/count - mean**2`` cancels, so ``a`` and ``b`` differ
  by ~1e-6 (measured 1.1e-6 at block 0's bn1), which flips bf16
  roundings of ``xh`` (2**-8 of an element each; 7 of block 0's 8192
  outputs move by more than 1e-5 of the largest) and the flips compound
  over the blocks (measured 3.7e-4 on the logits, 1.4e-4 on the worst
  running statistic);
* train-mode gradients and the SGD step: 0.1.  The BN backward through
  the statistics cancels, so ``ytot`` is a small difference of large
  terms and its bf16 rounding flips under any f32 change: the JAX
  package against itself, with the input moved by one f32 ulp, differs
  by up to 1.6% in a gradient tensor (``bn_init.bias``), and the port
  by 2.7% (gradients) and 2.2% (step).  Eval mode (above) holds the
  fused op's backward to 1e-4."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu.models.resnet import ResNet as FlaxResNet
from horovod_tpu_torch.models.resnet import (
    ResNet, ResNet50, from_flax_variables, fused_from_unfused, numpy_init)
from horovod_tpu_torch.ops import conv_bn
from test_conv_bn_fusion import _transplant

BATCH, HW, CLASSES = 4, 32, 10
KW = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=CLASSES,
          dtype=jnp.float32)
LR = 0.1


def _values(tree, rng):
    """numpy values for an eval_shape tree of a ResNet's variables:
    LeCun-normal kernels, non-trivial BN affine and statistics (flax
    inits each block's last BN scale to zero, which would zero most
    gradients)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _values(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        else:
            fan_in = math.prod(v.shape[:-1])
            out[k] = (rng.standard_normal(v.shape) / math.sqrt(fan_in)) \
                .astype(np.float32)
    return out


def _variables(model, seed):
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, HW, HW, 3)), train=False))
    rng = np.random.default_rng(seed)
    return {"params": _values(shapes["params"], rng),
            "batch_stats": _values(shapes["batch_stats"], rng)}


@pytest.fixture(scope="module")
def models():
    flax_model = FlaxResNet(fused=True, **KW)
    variables = _variables(flax_model, seed=1)
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((BATCH, HW, HW, 3)).astype(np.float32)
          for _ in range(2)]
    ys = [rng.integers(0, CLASSES, size=BATCH) for _ in range(2)]
    return flax_model, variables, xs, ys


def _port(variables, train):
    port = ResNet([1, 1, 1, 1], num_classes=CLASSES, num_filters=8,
                  dtype=torch.float32, fused=True)
    port.load_state_dict(from_flax_variables(variables))
    return port.train(train)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_grads(flax_model, variables, xs, ys, train):
    """The flax model's parameter gradients of each batch (one compile),
    as port state dicts."""
    def loss_fn(params, x, y):
        out = flax_model.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=train, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(out[0])
        return -jnp.mean(logp[jnp.arange(BATCH), y])
    grad_fn = jax.jit(jax.grad(loss_fn))
    return [from_flax_variables({"params": jax.tree_util.tree_map(
        np.asarray, grad_fn(variables["params"], x, y)),
        "batch_stats": variables["batch_stats"]}) for x, y in zip(xs, ys)]


def _port_grads(variables, x, y, train):
    port = _port(variables, train)
    F.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    return {k: p.grad for k, p in port.named_parameters()}


def test_layout_and_launch_routing(models):
    """The port's fused model has the flax fused tree's variables; on
    the CPU it routes the supported 1x1 convolutions through the fused
    op (plain versions, no kernel launch) and the strided projections
    and too-small shapes through the plain path."""
    _, variables, xs, _ = models
    port = _port(variables, True)
    state = from_flax_variables(variables)
    assert set(state) == set(port.state_dict())
    assert port.FusedBottleneckBlock_0.conv1.shape == (8, 8)
    assert not hasattr(port, "BottleneckBlock_0")
    conv_bn.reset_launches()
    with torch.no_grad():
        port(torch.from_numpy(xs[0]))
    # rows per stage 256, 64, 16, 4: block 3's conv3 has 4 rows, which
    # supported_m refuses; it and the 3 strided projections take the
    # plain path, the other 8 convolutions the fused op
    assert conv_bn.plain_calls["conv1x1_bn"] == 3 + 1
    assert conv_bn.launches == {"conv1x1_bn_fwd": 0, "conv1x1_bn_bwd": 0}
    conv_bn.reset_launches()


def test_eval_logits_match_flax(models):
    flax_model, variables, xs, _ = models
    ref = jax.jit(lambda x: flax_model.apply(variables, x, train=False))(
        xs[0])
    with torch.no_grad():
        out = _port(variables, False)(torch.from_numpy(xs[0]))
    assert _rel(out.numpy(), ref) <= 1e-4


def test_train_logits_and_running_stats_match_flax(models):
    flax_model, variables, xs, _ = models
    ref, upd = jax.jit(lambda x: flax_model.apply(
        variables, x, train=True, mutable=["batch_stats"]))(xs[0])
    port = _port(variables, True)
    with torch.no_grad():
        out = port(torch.from_numpy(xs[0]))
    assert _rel(out.numpy(), ref) <= 2e-3
    want = from_flax_variables({"params": variables["params"],
                                "batch_stats": jax.tree_util.tree_map(
                                    np.asarray, upd["batch_stats"])})
    got = port.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    # bn_init plus 3 folded BNs per block and bn_proj in each first block
    assert len(stats) == 2 * (1 + 4 * 3 + 4)
    for k in stats:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 2e-3, k


@pytest.mark.parametrize("train", [False, True])
def test_grads_match_flax(models, train):
    flax_model, variables, xs, ys = models
    (want,) = _jax_grads(flax_model, variables, xs[:1], ys[:1], train)
    got = _port_grads(variables, xs[0], ys[0], train)
    assert set(got) == {k for k in want if not k.endswith(
        ("running_mean", "running_var"))}
    bound = 0.1 if train else 1e-4
    worst = max(got, key=lambda k: _rel(got[k].numpy(), want[k].numpy()))
    assert _rel(got[worst].numpy(), want[worst].numpy()) <= bound, worst
    # the fused 1x1 kernels' gradients are f32 values bf16 cannot hold
    g = got["FusedBottleneckBlock_0.conv1"]
    assert not torch.equal(g.to(torch.bfloat16).float(), g)


def test_sgd_step_at_np2_matches_flax(models):
    """One SGD step of the fused model through DistributedOptimizer at
    np=2 rank threads on the CPU, against the JAX model's gradients of
    the two ranks' batches, averaged, applied the same way."""
    flax_model, variables, xs, ys = models
    state = from_flax_variables(variables)

    def fn():
        r = horovod_tpu_torch.rank()
        port = ResNet([1, 1, 1, 1], num_classes=CLASSES, num_filters=8,
                      dtype=torch.float32, fused=True)
        # rank 1 starts elsewhere: broadcast_parameters has to fix it
        port.load_state_dict({k: v + r for k, v in state.items()})
        hvd_torch.broadcast_parameters(port.state_dict(), root_rank=0)
        opt = hvd_torch.DistributedOptimizer(
            torch.optim.SGD(port.parameters(), lr=LR),
            named_parameters=port.named_parameters())
        opt.zero_grad()
        F.cross_entropy(port(torch.from_numpy(xs[r])),
                        torch.from_numpy(ys[r])).backward()
        opt.step()
        return {k: p.detach().clone() for k, p in port.named_parameters()}

    got = horovod_tpu_torch.run(fn, np=2, device="cpu")
    grads = _jax_grads(flax_model, variables, xs, ys, True)
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k
        step = (got[0][k] - state[k]).numpy()
        want = -LR * (grads[0][k].numpy() + grads[1][k].numpy()) * 0.5
        assert _rel(step, want) <= 0.1, k


def test_fused_from_unfused_matches_transplant():
    """fused_from_unfused maps an unfused state dict as the JAX test's
    _transplant maps flax variables."""
    std = FlaxResNet(**KW)
    fused = FlaxResNet(fused=True, **KW)
    std_vars = _variables(std, seed=3)
    fused_shapes = jax.eval_shape(lambda: fused.init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, HW, HW, 3)), train=False))
    want = from_flax_variables(_transplant(std_vars, fused_shapes))
    got = fused_from_unfused(from_flax_variables(std_vars))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_numpy_init_covers_the_fused_layout():
    """Full-width fused ResNet-50: 161 tensors, 25.56 M parameters, the
    same count as the standard model; numpy_init fills every entry, with
    a zero scale on each block's bn3 and fan-in scaled raw kernels."""
    model = ResNet50(num_classes=1000, fused=True)
    params = list(model.parameters())
    assert len(params) == 161
    assert sum(p.numel() for p in params) == 25_557_032
    state = numpy_init(model, seed=0)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    assert not model.FusedBottleneckBlock_0.bn3.weight.detach().any()
    assert model.FusedBottleneckBlock_0.bn1.weight.detach().eq(1).all()
    w = state["FusedBottleneckBlock_4.conv1"]
    assert w.shape == (512, 128)
    assert abs(float(w.std()) * math.sqrt(512) - 1.0) < 0.02
    # the same weights as the unfused model's, moved
    unfused = numpy_init(ResNet50(num_classes=1000), seed=0)
    assert set(fused_from_unfused(unfused)) == set(state)
