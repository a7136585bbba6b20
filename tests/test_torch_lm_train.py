"""horovod_tpu_torch.parallel.make_lm_train_step against the JAX
package's make_lm_train_step on a one-device mesh (as
benchmarks/lm_mfu_bench.py builds it), from the same flax-initialised
weights and the same numpy tokens, and the LM under Horovod's own
contract (DistributedOptimizer over rank threads).

Tolerances.  SGD: the losses at rtol 1e-4 / atol 1e-5 and the parameters
at rtol 5e-4 / atol 5e-5, those of tests/test_parallel.py's flash-vs-
dense step (f32, summation order only).  AdamW: the losses at rtol 2e-4.
Adam divides each gradient by its running RMS, so where |g| is near eps
a difference of summation order in the gradient becomes a visible
difference in the update; the loss, which averages over every
parameter, stays close, while single parameters may not."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd
import horovod_tpu_torch.torch as hvd_torch
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import MeshSpec, build_mesh
from horovod_tpu.parallel import make_lm_train_step as jax_step
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel import make_lm_train_step
from horovod_tpu_torch.parallel.train import adamw

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
          max_seq_len=32, attention_window=12)
STEPS = 3


def _tokens(seed=0, shape=(2, 32)):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=shape).astype(np.int32)


def _run_jax(opt, tokens):
    cfg = jt.TransformerConfig(dtype=jnp.float32, **KW)
    mesh = build_mesh(MeshSpec(dp=1), jax.devices()[:1])
    init, step, _, _ = jax_step(mesh, cfg, optimizer=opt,
                                attention_impl="flash")
    state = init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    step = jax.jit(step)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return params0, losses, jax.tree_util.tree_map(np.asarray,
                                                   state["params"])


def _run_port(opt, params0, tokens):
    cfg = pt.TransformerConfig(dtype=torch.float32, **KW)
    init, step = make_lm_train_step(cfg, opt, device="cpu",
                                    attention_impl="flash")
    state = init(pt.from_flax_params(params0))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    assert state["step"] == STEPS
    return losses, state["model"]


def test_sgd_steps_match_jax():
    tokens = _tokens()
    params0, want_losses, want_params = _run_jax(optax.sgd(0.1), tokens)
    losses, model = _run_port(
        lambda ps: torch.optim.SGD(ps, lr=0.1), params0, tokens)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-5)
    want = pt.from_flax_params(want_params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=k)


def test_adamw_steps_match_jax():
    tokens = _tokens(1)
    params0, want_losses, _ = _run_jax(optax.adamw(1e-3), tokens)
    losses, _ = _run_port(adamw(1e-3), params0, tokens)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4)
    assert losses[-1] < losses[0]


def test_adamw_defaults_follow_optax():
    opt = adamw(3e-4)([torch.nn.Parameter(torch.zeros(2))])
    d = opt.defaults
    assert (d["lr"], d["betas"], d["eps"], d["weight_decay"]) == \
        (3e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_seed_init_and_dense_default():
    """An int seed initialises through numpy_init; the default
    attention_impl ("ring" without sequence parallelism) is the dense
    model, and it gives the flash step's loss on the same weights."""
    cfg = pt.TransformerConfig(dtype=torch.float32, **KW)
    tokens = _tokens(2)
    losses = {}
    for impl in ("ring", "flash"):
        init, step = make_lm_train_step(cfg, device="cpu",
                                        attention_impl=impl)
        state = init(4)
        attn = state["model"].layers[0].attn.attention_fn
        assert (attn is flash_attention) == (impl == "flash")
        _, loss = step(state, tokens)
        losses[impl] = float(loss)
    assert losses["ring"] == pytest.approx(losses["flash"], rel=1e-5)
    assert losses["flash"] == pytest.approx(np.log(64), abs=0.1)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(attention_impl="blocksparse"), ValueError, "attention_impl"),
    (dict(attention_impl="ulysses"), ValueError, "sequence_parallel"),
    (dict(sequence_parallel=True, attention_impl="flash"), ValueError,
     "flash"),
    (dict(sequence_parallel=True), NotImplementedError, "A15"),
    (dict(pipeline=2), NotImplementedError, "A15"),
    (dict(sharded=True, fused_ce=True), NotImplementedError, "A11"),
    (dict(fused_ce=True), NotImplementedError, "A11"),
])
def test_refusals(kw, exc, match):
    cfg = pt.TransformerConfig(dtype=torch.float32, **KW)
    with pytest.raises(exc, match=match):
        make_lm_train_step(cfg, device="cpu", **kw)


def test_entry_point_needs_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pt.TransformerConfig(dtype=torch.float32, **KW)
    with pytest.raises(hvd.HorovodInitError):
        make_lm_train_step(cfg)


def test_lm_under_distributed_optimizer():
    """Two rank threads train the LM (flash attention) through
    DistributedOptimizer(AdamW): step 1's averaged gradients are the
    plain average of the ranks' local gradients, and the ranks'
    parameters are bit-identical after three steps."""
    cfg = pt.TransformerConfig(dtype=torch.float32, **KW)
    with torch.device("meta"):
        shell = pt.TransformerLM(cfg)
    state = pt.numpy_init(shell, 0)
    batches = [_tokens(10 + r) for r in range(2)]
    local = {}

    def fn():
        r = hvd.rank()
        model = pt.TransformerLM(cfg, attention_fn=flash_attention)
        model.load_state_dict({k: v + r for k, v in state.items()})
        hvd_torch.broadcast_parameters(model.state_dict(), root_rank=0)
        params = list(model.parameters())
        capture = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: local.setdefault(r, {}).__setitem__(
                i, p.grad.clone())) for i, p in enumerate(params)]
        opt = hvd_torch.DistributedOptimizer(
            adamw(1e-3)(model.parameters()),
            named_parameters=model.named_parameters())
        t = torch.from_numpy(batches[r]).long()
        for step in range(STEPS):
            opt.zero_grad()
            pt.lm_loss(model(t)[:, :-1], t[:, 1:]).backward()
            opt.synchronize()
            if step == 0:
                grads = [p.grad.clone() for p in params]
                for h in capture:
                    h.remove()
            with opt.skip_synchronize():
                opt.step()
        return grads, [p.detach().clone() for p in params]

    (g0, p0), (g1, p1) = hvd.run(fn, np=2, device="cpu")
    for i, (a, b) in enumerate(zip(g0, g1)):
        assert torch.equal(a, b)
        assert torch.equal(a, (local[0][i] + local[1][i]) * 0.5)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)
