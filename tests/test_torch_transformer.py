"""horovod_tpu_torch.models.transformer against the flax TransformerLM of
the JAX package, on the same weights (carried over by from_flax_params).

Tolerances.  f32: 1e-4 relative to the largest magnitude of each
compared tensor (summation order of the matmuls and softmax only).
bf16: 2**-5 of the largest logit magnitude: both models round every
activation to bf16, at places where the two frameworks' kernels differ
(XLA fuses and rounds once where torch rounds per op), and two layers
of such roundings move a logit by a few bf16 ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.ops.pallas_kernels import flash_attention as jax_flash
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.ops.flash_attention import flash_attention

RTOL = 1e-4


def _cfgs(**kw):
    base = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq_len=32)
    base.update(kw)
    dtype = base.pop("dtype", "f32")
    return (jt.TransformerConfig(dtype={"f32": jnp.float32,
                                        "bf16": jnp.bfloat16}[dtype], **base),
            pt.TransformerConfig(dtype={"f32": torch.float32,
                                        "bf16": torch.bfloat16}[dtype],
                                 **base))


def _flax_params(jcfg, tokens, seed=0):
    params = jt.TransformerLM(jcfg).init(jax.random.PRNGKey(seed),
                                         jnp.asarray(tokens))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(cfg, shape=(2, 16), seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _close(a, b, rtol=RTOL, name=""):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=rtol,
                               atol=rtol * float(np.abs(b).max()),
                               err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(), dict(n_kv_heads=2), dict(attention_window=5),
    dict(d_model=64, n_heads=2, d_ff=128)])
@pytest.mark.parametrize("flash", [False, True])
def test_logits_match_flax(kw, flash):
    jcfg, pcfg = _cfgs(**kw)
    tokens = _tokens(jcfg)
    params = _flax_params(jcfg, tokens)
    want = jt.TransformerLM(jcfg).apply({"params": params},
                                        jnp.asarray(tokens))
    model = pt.TransformerLM(
        pcfg, **({"attention_fn": flash_attention} if flash else {}))
    model.load_state_dict(pt.from_flax_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == (2, 16, 64)
    _close(got.numpy(), want)


def test_logits_match_flax_bf16():
    jcfg, pcfg = _cfgs(dtype="bf16")
    tokens = _tokens(jcfg)
    params = _flax_params(jcfg, tokens)
    want = jt.TransformerLM(jcfg).apply({"params": params},
                                        jnp.asarray(tokens))
    assert want.dtype == jnp.float32
    model = pt.TransformerLM(pcfg)
    model.load_state_dict(pt.from_flax_params(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32
    _close(got.numpy(), want, rtol=2.0 ** -5)


def test_grads_match_flax():
    """Loss and every parameter's gradient, flash attention in the port
    against the Pallas kernel (interpret mode) in the flax model."""
    jcfg, pcfg = _cfgs(attention_window=6)
    tokens = _tokens(jcfg)
    params = _flax_params(jcfg, tokens)
    jmodel = jt.TransformerLM(jcfg, attention_fn=jax_flash)

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens))
        return jt.lm_loss(logits[:, :-1], jnp.asarray(tokens)[:, 1:])

    loss, grads = jax.value_and_grad(loss_fn)(params)
    want = pt.from_flax_params(jax.tree_util.tree_map(np.asarray, grads))
    model = pt.TransformerLM(pcfg, attention_fn=flash_attention)
    model.load_state_dict(pt.from_flax_params(params))
    t = torch.from_numpy(tokens).long()
    got_loss = pt.lm_loss(model(t)[:, :-1], t[:, 1:])
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(loss),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for k, p in named.items():
        _close(p.grad.numpy(), want[k].numpy(), name=k)


def test_loader_layout_and_numpy_init():
    """Every flax parameter lands in one port parameter of the right
    shape, and numpy_init fills the same keys deterministically with
    flax's initializer scales."""
    jcfg, pcfg = _cfgs(n_kv_heads=2)
    params = _flax_params(jcfg, _tokens(jcfg))
    state = pt.from_flax_params(params)
    model = pt.TransformerLM(pcfg)
    assert set(state) == set(model.state_dict())
    n_flax = sum(np.size(a) for a in jax.tree_util.tree_leaves(params))
    assert sum(v.numel() for v in state.values()) == n_flax
    model.load_state_dict(state)
    # wq (M, H, D) -> (H*D, M): the projection of a unit vector picks a row
    wq = params["layers"]["attn"]["wq"]["kernel"][1]
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.weight.detach().numpy()[:, 3],
        wq[3].reshape(-1))
    a, b = pt.numpy_init(model, 5), pt.numpy_init(model, 5)
    assert set(a) == set(state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.1)
    w = a["layers.0.mlp.wo.weight"]                      # fan_in = d_ff
    assert float(w.std()) == pytest.approx((1 / 64) ** 0.5, rel=0.1)
    assert float(w.abs().max()) <= 2 * (1 / 64) ** 0.5 / 0.8796 + 1e-6
    assert torch.equal(a["ln_final.scale"], torch.ones(32))


def test_rope_matches_jax():
    np.testing.assert_array_equal(pt.rope_angles(16, 32, 10000.0),
                                  jt.rope_angles(16, 32, 10000.0))
    x = np.random.default_rng(2).standard_normal((2, 8, 3, 16)).astype(
        np.float32)
    angles = jt.rope_angles(16, 8, 10000.0)
    _close(pt.apply_rope(torch.from_numpy(x), torch.from_numpy(angles))
           .numpy(), jt.apply_rope(jnp.asarray(x), jnp.asarray(angles)),
           rtol=1e-6)


def test_unported_features_raise():
    _, pcfg = _cfgs()
    # the MoE layer is ported; its exchange over an ep mesh axis is not
    from horovod_tpu_torch.parallel import moe as pmoe
    x, rw = torch.zeros(4, 8), torch.zeros(8, 2)
    ew, ewo = torch.zeros(2, 8, 4), torch.zeros(2, 4, 8)
    with pytest.raises(NotImplementedError, match="A15"):
        pmoe.capacity_moe_apply(x, rw, ew, ew, ewo, topk=1,
                                capacity_factor=1.0, axis_name="ep")
    with pytest.raises(NotImplementedError, match="A15"):
        pmoe.quantized_all_to_all(x, "ep", "int8")
    # remat, pre_logits and the fused chunked loss are ported (A11,
    # tests/test_torch_lm_remat.py); what stays refused is an unknown
    # remat policy, a sequence the chunks do not divide, and decoding
    with pytest.raises(ValueError, match="remat_policy"):
        pt.TransformerLM(_cfgs(remat=True, remat_policy="bogus")[1])
    pt.TransformerLM(_cfgs(remat=True)[1])
    model = pt.TransformerLM(pcfg)
    for p in model.parameters():
        torch.nn.init.normal_(p, std=0.02)
    t = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A16"):
        model(t, decode=True)
    x, emb = model(t, pre_logits=True)
    assert tuple(x.shape) == (1, 4, pcfg.d_model) and emb is model.embed
    with pytest.raises(NotImplementedError, match="A16"):
        pt.make_generate_fn(model, max_new_tokens=2)
    with pytest.raises(ValueError, match="not divisible"):
        pt.chunked_lm_loss(x, emb, t, n_chunks=3)
    assert torch.isfinite(pt.make_fused_lm_loss(model, n_chunks=2)(t))
