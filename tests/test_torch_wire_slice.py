"""The slice as a whole: data-parallel training over the int8 and int4
wires through ``DistributedOptimizer(compression=Compression.int8 /
int4)``, on the JAX package and on the port.

The tiny port ResNet (f32) trains at np=2 rank threads for 3
SGD-momentum steps from identical numpy-seeded weights on identical
per-rank batches, once through ``horovod_tpu.run`` +
``horovod_tpu.torch.DistributedOptimizer`` and once through
``horovod_tpu_torch.run(device="cpu")`` +
``horovod_tpu_torch.torch.DistributedOptimizer``, with per-parameter
error feedback on both sides.

Quantization blocks run over a fusion bucket, so the result depends on
how the gradients were fused.  Each case pins the buckets the same way
on both sides: ``HOROVOD_FUSION_THRESHOLD=0`` (one bucket per gradient,
whatever the hooks' timing) or ``groups=1`` (all gradients in one
grouped allreduce, in parameter order).

Tolerance: step 1's averaged gradients bit for bit (the codec, the
error-feedback arithmetic and a two-rank sum are the same correctly
rounded operations on both sides); the final parameters to atol 1e-6
(the backward passes of the two sides' models may differ in the last
bit of an f32 gradient, which the wire's rounding can carry into a
code); the ranks bit-identical."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu
import horovod_tpu.torch as jax_hvd_torch
import horovod_tpu_torch
import horovod_tpu_torch.torch as port_hvd_torch
from horovod_tpu_torch.models.resnet import ResNet, numpy_init

STEPS = 3


def _batches():
    rng = np.random.default_rng(5)
    return [(rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
             rng.integers(0, 10, size=4)) for _ in range(2)]


def _train(run, hvd_rank, frontend, wire, groups, state, batches):
    def fn():
        r = hvd_rank()
        model = ResNet([1, 1, 1, 1], num_classes=10, num_filters=8,
                       dtype=torch.float32)
        model.load_state_dict({k: v + r for k, v in state.items()})
        frontend.broadcast_parameters(model.state_dict(), root_rank=0)
        compression = getattr(frontend.Compression, wire)
        opt = frontend.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters(),
            compression=compression, groups=groups)
        x, y = (torch.from_numpy(a) for a in batches[r])
        first = None
        for step in range(STEPS):
            opt.zero_grad()
            F.cross_entropy(model(x), y).backward()
            opt.synchronize()
            if step == 0:
                first = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
            with opt.skip_synchronize():
                opt.step()
        residuals = len(opt._residuals)
        opt.reset_wire_state()
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        return first, params, residuals, len(opt._residuals)
    return run(fn)


@pytest.mark.parametrize("groups", [None, 1])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_quantized_dp_training_matches_jax_package(wire, groups,
                                                   monkeypatch):
    if groups is None:
        monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", "0")
    state = numpy_init(ResNet([1, 1, 1, 1], num_classes=10, num_filters=8),
                       seed=3)
    batches = _batches()
    ref = _train(lambda fn: horovod_tpu.run(fn, np=2), horovod_tpu.rank,
                 jax_hvd_torch, wire, groups, state, batches)
    got = _train(lambda fn: horovod_tpu_torch.run(fn, np=2, device="cpu"),
                 horovod_tpu_torch.rank, port_hvd_torch, wire, groups, state,
                 batches)
    names = set(dict(ResNet([1, 1, 1, 1], 10, 8).named_parameters()))
    for r in range(2):
        first, params, n_res, n_after = got[r]
        r_first, r_params, r_res, _ = ref[r]
        assert set(first) == set(r_first) == names
        for k in names:
            assert torch.equal(first[k], r_first[k]), k
            np.testing.assert_allclose(params[k].numpy(),
                                       r_params[k].numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)
        # one residual per parameter, and reset_wire_state() drops them
        assert n_res == r_res == len(names) and n_after == 0
    for k in names:
        assert torch.equal(got[0][1][k], got[1][1][k])
        assert torch.equal(got[0][0][k], got[1][0][k])


def test_error_feedback_residual_is_the_codec_error():
    """Two steps on one parameter: the residual after step 1 is
    ``g1 - fq(g1)`` and after step 2 ``x2 - fq(x2)`` with ``x2 = g2 +
    residual``, through the plain codec on the CPU."""
    from horovod_tpu_torch.ops import quantize as qz

    g = [torch.from_numpy(np.random.default_rng(s).standard_normal(700)
                          .astype(np.float32)) for s in (1, 2)]

    def fn():
        p = torch.nn.Parameter(torch.zeros(700))
        opt = port_hvd_torch.DistributedOptimizer(
            torch.optim.SGD([p], lr=0.0), named_parameters=[("p", p)],
            compression=port_hvd_torch.Compression.int4)
        res = []
        for gi in g:
            opt.zero_grad()
            (p * gi).sum().backward()
            opt.step()
            res.append(opt._residuals[p].clone())
        return res

    r1, r2 = horovod_tpu_torch.run(fn, np=2, device="cpu")[0]
    assert torch.equal(r1, g[0] - qz.plain_fake_quantize_wire(g[0], "int4"))
    x2 = g[1] + r1
    assert torch.equal(r2, x2 - qz.plain_fake_quantize_wire(x2, "int4"))
