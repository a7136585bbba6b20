"""parallel/moe.py and the MoE layer of horovod_tpu_torch against the JAX
package, on the same numpy-seeded inputs.

Tolerances.
* Integer and slot arithmetic (capacity, ep snapping, labels, dispatch
  plans, the scatter into slots, the straight-through gradient) is bit
  for bit on the same inputs, ties included.  The combine's mix is a
  K-term sum of products that XLA on the CPU may contract into fmas:
  within 2 eps of the sum of the terms' magnitudes (f32 and bf16).
* ``top_k_gating``: the softmax's ``exp`` is XLA's on one side and
  PyTorch's on the other, which differ by up to 2 ulp (measured 1.2e-7
  on probabilities below 1), so the weights are held to 4 ulp of their
  value.  The routes are bit for bit: exact ties (equal logits) go to the
  lowest expert index on both sides, and a route may only differ where
  the k-th and (k+1)-th probabilities are within that tolerance, which
  the test reports instead of hiding.
* The 2-layer, d_model 64, E 4 MoE LM in f32, both branches: logits and
  the loss at rtol 1e-5 / atol 2e-6 (f32 summation order), every layer's
  dropped count exact, and three AdamW steps' losses at rtol 2e-4
  (tests/test_torch_lm_train.py's rule for AdamW)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import MeshSpec, build_mesh
from horovod_tpu.parallel import make_lm_train_step as jax_step
from horovod_tpu.parallel import moe as jm
from horovod_tpu_torch.models import transformer as pt
from horovod_tpu_torch.parallel import make_lm_train_step
from horovod_tpu_torch.parallel import moe as tm
from horovod_tpu_torch.parallel.train import adamw

ULP_TOL = 4 * 2.0 ** -24


def _logits(seed, shape, ties=True):
    lg = (np.random.default_rng(seed).standard_normal(shape) * 3) \
        .astype(np.float32)
    if ties:
        lg[::5, 1] = lg[::5, 3]             # exact ties inside the top k
        lg[1::7, :] = 0.5                   # a row of all-equal logits
    return lg


def test_scalar_helpers_match():
    for args in ((128, 8, 2, 1.25), (1, 64, 1, 1.0), (10240, 8, 2, 1.25),
                 (37, 3, 2, 0.7)):
        assert tm.expert_capacity(*args) == jm.expert_capacity(*args)
    assert tm.expert_capacity(10240, 8, 2, 1.25) == 3200
    for ep in range(0, 10):
        for ws in (1, 2, 4, 6, 8):
            assert tm.snap_ep(ep, ws) == jm.snap_ep(ep, ws)
    assert tm.MOE_CHOICES == jm.MOE_CHOICES
    for ep, cf in tm.MOE_CHOICES:
        assert tm.moe_label(ep, cf) == jm.moe_label(ep, cf)
        assert tm.parse_moe_label(tm.moe_label(ep, cf)) == (ep, cf)
    assert tm.dense_flop_matched_ff(2048, 2) == \
        jm.dense_flop_matched_ff(2048, 2) == 4096
    with pytest.raises(ValueError):
        tm.expert_capacity(4, 0, 1, 1.0)
    with pytest.raises(ValueError):
        tm.parse_moe_label("cf1.0")


@pytest.mark.parametrize("shape,k", [((64, 8), 2), ((4096, 8), 2),
                                     ((333, 4), 1), ((200, 16), 4)])
def test_top_k_gating(shape, k):
    lg = _logits(shape[0], shape)
    wj, ij = jm.top_k_gating(jnp.asarray(lg), k)
    wt, it = tm.top_k_gating(torch.from_numpy(lg), k)
    wj, ij = np.asarray(wj), np.asarray(ij)
    np.testing.assert_allclose(wt.numpy(), wj, rtol=ULP_TOL, atol=0)
    differ = np.nonzero((it.numpy() != ij).any(-1))[0]
    if differ.size:
        probs = np.sort(np.asarray(jax.nn.softmax(lg, -1)), -1)[:, ::-1]
        margin = probs[differ, k - 1] - probs[differ, k]
        assert (margin <= ULP_TOL * probs[differ, k - 1]).all(), margin
    assert differ.size == 0       # no near-tie moved a route here
    # exact ties go to the lowest index
    tie_rows = np.arange(1, shape[0], 7)
    np.testing.assert_array_equal(it.numpy()[tie_rows],
                                  np.tile(np.arange(k), (tie_rows.size, 1)))


@pytest.mark.parametrize("E,cap", [(8, 20), (8, 3), (4, 1000)])
def test_dispatch_plan_dispatch_combine(E, cap):
    """Plans, slots and the mix, bit for bit on the same routes (in f32
    and bf16), with overflow that drops."""
    T, M, K = 96, 16, 2
    lg = _logits(E, (T, E))
    wj, ij = jm.top_k_gating(jnp.asarray(lg), K)
    idx = np.asarray(ij)
    w = np.asarray(wj)
    pj, kj, dj = jm.make_dispatch_plan(jnp.asarray(idx), E, cap)
    pt_, kt, dt = tm.make_dispatch_plan(torch.from_numpy(idx).long(), E,
                                        cap)
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert int(dt) == int(dj)
    x = np.random.default_rng(1).standard_normal((T, M)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        sj = jm.moe_dispatch(jnp.asarray(x, jdt), jnp.asarray(idx), pj, kj,
                             E, cap)
        st = tm.moe_dispatch(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(idx).long(), pt_, kt, E, cap)
        np.testing.assert_array_equal(st.float().numpy(),
                                      np.asarray(sj, np.float32))
        out = np.tanh(np.asarray(sj, np.float32)) * 3
        yj = jm.moe_combine(jnp.asarray(out, jdt), jnp.asarray(idx), pj,
                            kj, jnp.asarray(w))
        yt = tm.moe_combine(torch.from_numpy(out).to(tdt),
                            torch.from_numpy(idx).long(), pt_, kt,
                            torch.from_numpy(w))
        # the mix is a K-term sum of products, which XLA may contract into
        # fmas: two roundings of the sum's terms' magnitude apart at most
        eps = 2.0 ** -24 if tdt == torch.float32 else 2.0 ** -9
        ob = torch.from_numpy(out).to(tdt).float().reshape(E * cap, M)
        slot = torch.from_numpy(idx).long() * cap + torch.clamp(
            pt_, max=cap - 1)
        wb = (torch.from_numpy(w) * kt).to(tdt).float()
        mag = (wb.abs()[..., None] * ob[slot].abs()).sum(1).numpy()
        assert np.all(np.abs(yt.float().numpy() - np.asarray(
            yj, np.float32)) <= 2 * eps * mag)


def test_token_major_priority_and_overflow():
    idx = torch.zeros(6, 1, dtype=torch.long)
    pos, keep, dropped = tm.make_dispatch_plan(idx, 4, 4)
    assert keep.view(-1).tolist() == [True] * 4 + [False] * 2
    assert pos.view(-1).tolist() == [0, 1, 2, 3, 4, 5]
    assert int(dropped) == 2
    T, E, cap = 32, 4, 5
    lg = np.zeros((T, E), np.float32)
    lg[:, 0] = 10.0
    w, idx = tm.top_k_gating(torch.from_numpy(lg), 1)
    pos, keep, dropped = tm.make_dispatch_plan(idx, E, cap)
    assert int(dropped) == T - cap
    x = torch.arange(T, dtype=torch.float32)[:, None]
    slots = tm.moe_dispatch(x, idx, pos, keep, E, cap)
    assert slots[0, :, 0].tolist() == list(range(cap))
    y = tm.moe_combine(slots, idx, pos, keep, w)
    assert (y[cap:] == 0).all()


def test_straight_through_gradient():
    w = torch.tensor([0.6, 0.4], requires_grad=True)
    keep = torch.tensor([True, False])
    y = (tm.straight_through(w, keep) * 2.0).sum()
    assert float(y.detach()) == pytest.approx(1.2)
    y.backward()
    g = jax.grad(lambda v: jnp.sum(jm.straight_through(
        v, jnp.asarray([True, False])) * 2.0))(jnp.asarray([0.6, 0.4]))
    np.testing.assert_array_equal(w.grad.numpy(), np.asarray(g))
    assert w.grad.tolist() == [2.0, 2.0]


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_capacity_moe_apply(cf):
    """The single-rank layer in f32 against JAX on the same weights,
    forward and the gradient of every input."""
    T, M, E, Fd, K = 128, 32, 4, 16, 2
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(s).astype(np.float32) * sc
            for s, sc in (((T, M), 1.0), ((M, E), 0.3), ((E, M, Fd), 0.2),
                          ((E, M, Fd), 0.2), ((E, Fd, M), 0.2))]

    def jloss(*a):
        y, aux = jm.capacity_moe_apply(*a, topk=K, capacity_factor=cf)
        return jnp.sum(y * jnp.cos(jnp.arange(y.size).reshape(y.shape))), \
            (y, aux["n_dropped"])

    (lj, (yj, dj)), gj = jax.value_and_grad(
        jloss, argnums=tuple(range(5)), has_aux=True)(
        *[jnp.asarray(a) for a in arrs])
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    yt, aux = tm.capacity_moe_apply(*ts, topk=K, capacity_factor=cf)
    lt = (yt * torch.cos(torch.arange(yt.numel(), dtype=torch.float32)
                         .view(yt.shape))).sum()
    lt.backward()
    assert int(aux["n_dropped"]) == int(dj)
    assert aux["capacity"] == jm.expert_capacity(T, E, K, cf)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               rtol=1e-5, atol=2e-6)
    for t, g in zip(ts, gj):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# the MoE LM

KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=32,
          max_seq_len=32, num_experts=4, expert_top_k=2)


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, KW["vocab_size"], size=(2, 32)).astype(np.int32)


@pytest.mark.parametrize("cf", [0.0, 1.25, 0.5])
def test_moe_lm_forward_matches_jax(cf):
    """Logits, the loss and each layer's dropped count from the same flax
    weights carried over by from_flax_params; the router of layer 0
    routes the same on both sides."""
    jcfg = jt.TransformerConfig(dtype=jnp.float32, moe_capacity_factor=cf,
                                **KW)
    model = jt.TransformerLM(jcfg)
    tokens = _tokens(3)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(tokens))
    lj = model.apply(params, jnp.asarray(tokens))
    tcfg = pt.TransformerConfig(dtype=torch.float32, moe_capacity_factor=cf,
                                **KW)
    tmod = pt.TransformerLM(tcfg)
    state = pt.from_flax_params(params["params"])
    tmod.load_state_dict(state)
    assert set(state) == set(tmod.state_dict())
    seen = []
    for blk in tmod.layers:
        blk.moe.register_forward_hook(
            lambda mod, inp, out: seen.append(inp[0].detach().numpy()))
    lt = tmod(torch.from_numpy(tokens))
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=1e-5, atol=2e-6)
    loss_j = jt.lm_loss(lj[:, :-1], jnp.asarray(tokens)[:, 1:])
    loss_t = pt.lm_loss(lt[:, :-1], torch.from_numpy(tokens)[:, 1:].long())
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5)
    if cf > 0:
        # flax's sow inside nn.scan keeps no intermediates, so the JAX
        # routing functions recount each layer's drops from the router
        # logits of that layer's input (the whole route, router included)
        E, K, T = KW["num_experts"], KW["expert_top_k"], tokens.size
        cap = jm.expert_capacity(T, E, K, cf)
        dropped = []
        for i, x in enumerate(seen):
            kern = params["params"]["layers"]["moe"]["router"]["kernel"][i]
            lg = jnp.asarray(x.reshape(T, -1)) @ kern
            _, idx = jm.top_k_gating(lg, K)
            dropped.append(int(jm.make_dispatch_plan(idx, E, cap)[2]))
        assert [int(b.moe.moe_dropped) for b in tmod.layers] == dropped
        if cf < 1:
            assert min(dropped) > 0
    else:
        assert all(b.moe.moe_dropped is None for b in tmod.layers)


@pytest.mark.parametrize("cf", [0.0, 1.25])
def test_moe_lm_adamw_steps_match_jax(cf):
    jcfg = jt.TransformerConfig(dtype=jnp.float32, moe_capacity_factor=cf,
                                **KW)
    mesh = build_mesh(MeshSpec(dp=1), jax.devices()[:1])
    init, step, _, _ = jax_step(mesh, jcfg, optimizer=optax.adamw(1e-3),
                                attention_impl="flash")
    tokens = _tokens(4)
    state = init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params0 = jax.tree_util.tree_map(np.asarray, state["params"])
    step = jax.jit(step)
    want = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(tokens))
        want.append(float(loss))
    tcfg = pt.TransformerConfig(dtype=torch.float32, moe_capacity_factor=cf,
                                **KW)
    tinit, tstep = make_lm_train_step(tcfg, adamw(1e-3), device="cpu",
                                      attention_impl="flash")
    tstate = tinit(pt.from_flax_params(params0))
    got = []
    for _ in range(3):
        tstate, loss = tstep(tstate, tokens)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=2e-4)
    assert got[-1] < got[0]
    moe0 = tstate["model"].layers[0].moe
    assert moe0.router.weight.grad is not None
    assert moe0.wi_gate.grad.abs().sum() > 0


def test_numpy_init_moe_shapes_and_scale():
    cfg = pt.TransformerConfig(dtype=torch.float32, **KW)
    with torch.device("meta"):
        model = pt.TransformerLM(cfg)
    state = pt.numpy_init(model, 0)
    E, M, Fd = KW["num_experts"], KW["d_model"], KW["d_ff"]
    assert state["layers.0.moe.router.weight"].shape == (E, M)
    assert state["layers.1.moe.wi_gate"].shape == (E, M, Fd)
    assert state["layers.1.moe.wo"].shape == (E, Fd, M)
    # flax's LeCun normal counts the E axis into fan_in
    std = float(state["layers.0.moe.wi_up"].std())
    assert std == pytest.approx((1.0 / (E * M)) ** 0.5, rel=0.1)
    assert set(state) == set(model.state_dict())
