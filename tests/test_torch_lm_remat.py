"""The LM's memory path in the port (``models/transformer.py``: remat
with its three policies, ``pre_logits``, ``chunked_lm_loss``,
``make_fused_lm_loss``; ``parallel.make_lm_train_step(fused_ce=True)``)
against the JAX package's on the same flax-initialised weights and numpy
tokens, at a tiny f32 size on the CPU.

Tolerances.  f32 throughout.  Losses: rtol 1e-5 between the packages,
and the fused against the unfused loss within 1e-5 (as
``tests/test_models.py:110`` holds the JAX package's).  Gradients: 1e-4
of each tensor's largest magnitude between the packages (matmul and
softmax summation orders, as in ``tests/test_torch_transformer.py``),
1e-5 absolute fused against unfused.  Inside the port the remat policies
are bit for bit the step without remat: the checkpoint replays the same
ops on the same values.  Train steps: the tolerances of
``tests/test_torch_lm_train.py``."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu.parallel import MeshSpec, build_mesh
from horovod_tpu.parallel import make_lm_train_step as jax_step
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.ops import flash_attention as FA
from horovod_tpu_torch.parallel import make_lm_train_step

KW = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_ff=64,
          max_seq_len=32)
POLICIES = [None, "full", "dots", "dots_flash"]


def _cfgs(policy=None, **kw):
    base = dict(KW, **kw)
    remat = dict(remat=policy is not None, remat_policy=policy or "full")
    return (jt.TransformerConfig(dtype=jnp.float32, **remat, **base),
            pt.TransformerConfig(dtype=torch.float32, **remat, **base))


def _tokens(shape=(2, 32), seed=0):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=shape).astype(np.int32)


def _flax_params(jcfg, tokens, seed=1):
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(seed),
                                         jnp.asarray(tokens))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(pcfg, params, flash):
    kw = {"attention_fn": FA.flash_attention} if flash else {}
    model = pt.TransformerLM(pcfg, **kw)
    model.load_state_dict(pt.from_flax_params(params))
    return model


def _close(a, b, rtol=1e-4, name=""):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()),
                               err_msg=name)


def _port_grads(model, loss_fn, tokens):
    model.zero_grad(set_to_none=True)
    loss = loss_fn(torch.from_numpy(tokens).long())
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone()
                         for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_fused_loss_and_grads_match_jax(policy, flash):
    """``make_fused_lm_loss`` under each remat policy: loss and gradients
    against the JAX package's ``jax.value_and_grad`` of its own."""
    jcfg, pcfg = _cfgs(policy)
    tokens = _tokens()
    params = _flax_params(jcfg, tokens)
    jmodel = jt.TransformerLM(jcfg, attention_fn=jax_flash) if flash \
        else jt.TransformerLM(jcfg)
    want_loss, want_g = jax.value_and_grad(
        jt.make_fused_lm_loss(jmodel, 4))(params, jnp.asarray(tokens))
    want_g = pt.from_flax_params(jax.tree_util.tree_map(np.asarray, want_g))
    model = _port_model(pcfg, params, flash)
    loss, grads = _port_grads(model, pt.make_fused_lm_loss(model, 4), tokens)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    assert set(grads) == set(want_g)
    for k in want_g:
        _close(grads[k].numpy(), want_g[k].numpy(), name=k)


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_remat_is_bit_for_bit_no_remat(policy):
    jcfg, pcfg = _cfgs(policy)
    _, pcfg0 = _cfgs(None)
    tokens = _tokens(seed=3)
    params = _flax_params(jcfg, tokens)
    m0 = _port_model(pcfg0, params, True)
    m1 = _port_model(pcfg, params, True)
    l0, g0 = _port_grads(m0, pt.make_fused_lm_loss(m0, 8), tokens)
    l1, g1 = _port_grads(m1, pt.make_fused_lm_loss(m1, 8), tokens)
    assert l0 == l1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_unknown_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        pt.TransformerLM(_cfgs("bogus")[1])
    # remat off: the policy is not read, as in the JAX package
    pt.TransformerLM(pt.TransformerConfig(remat_policy="bogus", **KW))


class _FlashCounter:
    """Counts the plain flash forward's calls (the CPU path of the
    ``hvd_torch::flash_fwd`` operator)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        orig = FA.plain_flash_fwd

        def counting(*a, **k):
            self.calls += 1
            return orig(*a, **k)
        monkeypatch.setattr(FA, "plain_flash_fwd", counting)


@pytest.mark.parametrize("policy,replays", [
    (None, 0), ("full", 1), ("dots", 1), ("dots_flash", 0)])
def test_flash_forward_replays(policy, replays, monkeypatch):
    """The backward replays the flash forward under ``"full"`` and
    ``"dots"`` (once per layer), never under ``"dots_flash"``, which saves
    its ``(out, lse)``."""
    _, pcfg = _cfgs(policy)
    counter = _FlashCounter(monkeypatch)
    model = pt.TransformerLM(pcfg, attention_fn=FA.flash_attention)
    model.load_state_dict(pt.numpy_init(model, 0))
    loss = pt.make_fused_lm_loss(model, 4)(torch.from_numpy(
        _tokens()).long())
    assert counter.calls == pcfg.n_layers
    loss.backward()
    assert counter.calls == pcfg.n_layers * (1 + replays)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(policy):
    _, pcfg = _cfgs(policy)
    model = pt.TransformerLM(pcfg, attention_fn=FA.flash_attention)
    model.load_state_dict(pt.numpy_init(model, 0))
    loss = pt.make_fused_lm_loss(model, 4)(torch.from_numpy(
        _tokens()).long())
    with _OpCounter() as count:
        loss.backward()
    return count.ops


def test_dots_saves_the_2d_products():
    """``"dots"`` saves the outputs of the blocks' 2-D products
    (``aten.mm``; the counterpart of ``dots_with_no_batch_dims_saveable``):
    its backward runs the no-remat backward's products, where ``"full"``
    replays the blocks' forward products too: 6 of the 7 a block (q, k,
    v, o, gate, up; the replay stops once the last tensor the backward
    needs is back, before the down projection)."""
    mm = torch.ops.aten.mm.default
    flash = torch.ops.hvd_torch.flash_fwd.default
    base, full = _backward_ops(None), _backward_ops("full")
    dots, dots_flash = _backward_ops("dots"), _backward_ops("dots_flash")
    n = KW["n_layers"]
    assert full[mm] == base[mm] + 6 * n
    assert dots[mm] == base[mm] == dots_flash[mm]
    assert full[flash] == dots[flash] == n
    assert base[flash] == dots_flash[flash] == 0


def test_pre_logits_matches_jax():
    jcfg, pcfg = _cfgs()
    tokens = _tokens((2, 16))
    params = _flax_params(jcfg, tokens)
    jx, jemb = jt.TransformerLM(jcfg).apply({"params": params},
                                            jnp.asarray(tokens),
                                            pre_logits=True)
    model = _port_model(pcfg, params, False)
    x, emb = model(torch.from_numpy(tokens).long(), pre_logits=True)
    assert emb is model.embed
    _close(x.detach().numpy(), np.asarray(jx), name="x")
    np.testing.assert_array_equal(emb.detach().numpy(), np.asarray(jemb))
    # the logits are the tied projection of those hidden states
    logits = model(torch.from_numpy(tokens).long())
    assert torch.equal(logits, torch.matmul(x.float(), emb.float().t()))


def test_chunked_loss_matches_unfused_and_jax():
    """tests/test_models.py:110 on the port: the chunked loss equals
    ``lm_loss`` in value and gradients, in the pre-shifted form and the
    rolled-targets-with-weights form, and the JAX package's
    ``chunked_lm_loss`` on the same hidden states."""
    jcfg, pcfg = _cfgs()
    tokens = _tokens((2, 16), seed=5)
    params = _flax_params(jcfg, tokens)
    model = _port_model(pcfg, params, False)
    tok = torch.from_numpy(tokens).long()

    def unfused(t):
        return pt.lm_loss(model(t)[:, :-1], t[:, 1:])

    def fused_shifted(t):
        x, emb = model(t, pre_logits=True)
        return pt.chunked_lm_loss(x[:, :-1], emb, t[:, 1:], n_chunks=5)

    def fused_weighted(t):
        x, emb = model(t, pre_logits=True)
        w = torch.ones(t.shape)
        w[:, -1] = 0.0
        return pt.chunked_lm_loss(x, emb, torch.roll(t, -1, dims=1),
                                  n_chunks=4, weights=w)

    la, ga = _port_grads(model, unfused, tokens)
    for fused in (fused_shifted, fused_weighted,
                  pt.make_fused_lm_loss(model, 4)):
        lb, gb = _port_grads(model, fused, tokens)
        assert abs(la - lb) < 1e-5
        for k in ga:
            np.testing.assert_allclose(gb[k].numpy(), ga[k].numpy(),
                                       atol=1e-5, err_msg=k)

    x, emb = model(tok, pre_logits=True)
    got = pt.chunked_lm_loss(x, emb, torch.roll(tok, -1, dims=1),
                             n_chunks=4)
    want = jt.chunked_lm_loss(jnp.asarray(x.detach().numpy()),
                              jnp.asarray(emb.detach().numpy()),
                              jnp.roll(jnp.asarray(tokens), -1, axis=1),
                              n_chunks=4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        pt.chunked_lm_loss(x, emb, tok, n_chunks=7)
    # all weights 0: the loss is 0 (not 0/0), in both packages
    zero = pt.chunked_lm_loss(x, emb, tok, n_chunks=4,
                              weights=torch.zeros(tok.shape))
    jzero = jt.chunked_lm_loss(jnp.asarray(x.detach().numpy()),
                               jnp.asarray(emb.detach().numpy()),
                               jnp.asarray(tokens), n_chunks=4,
                               weights=jnp.zeros(tokens.shape, jnp.float32))
    assert float(zero) == float(jzero) == 0.0


def test_chunk_logits_are_not_saved():
    """Each chunk is checkpointed: the autograd graph keeps no (B, C, V)
    tensor, only the chunk's inputs."""
    _, pcfg = _cfgs()
    model = pt.TransformerLM(pcfg)
    model.load_state_dict(pt.numpy_init(model, 2))
    B, S, V = 2, 32, KW["vocab_size"]
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t
    x, emb = model(torch.from_numpy(_tokens()).long(), pre_logits=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        pt.chunked_lm_loss(x, emb, torch.zeros(B, S, dtype=torch.long),
                           n_chunks=4)
    assert saved and not any(len(s) == 3 and s[-1] == V for s in saved)


def _run_jax(tokens, ce_chunks):
    cfg = jt.TransformerConfig(dtype=jnp.float32, attention_window=12,
                               **KW)
    mesh = build_mesh(MeshSpec(dp=1), jax.devices()[:1])
    init, step, _, _ = jax_step(mesh, cfg, optimizer=optax.sgd(0.1),
                                attention_impl="flash", fused_ce=True,
                                ce_chunks=ce_chunks)
    state = init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    step = jax.jit(step)
    losses = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return params0, losses, jax.tree_util.tree_map(np.asarray,
                                                   state["params"])


@pytest.mark.parametrize("policy", [None, "dots_flash"])
def test_fused_ce_train_steps_match_jax(policy):
    tokens = _tokens()
    params0, want_losses, want_params = _run_jax(tokens, 4)
    cfg = pt.TransformerConfig(dtype=torch.float32, attention_window=12,
                               remat=policy is not None,
                               remat_policy=policy or "full", **KW)
    init, step = make_lm_train_step(
        cfg, lambda ps: torch.optim.SGD(ps, lr=0.1), device="cpu",
        attention_impl="flash", fused_ce=True, ce_chunks=4)
    state = init(pt.from_flax_params(params0))
    losses = []
    for _ in range(3):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-5)
    want = pt.from_flax_params(want_params)
    got = state["model"].state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=5e-4, atol=5e-5, err_msg=k)
