"""The weight-update-sharded compiled step,
``make_compiled_train_step(sharded=True, wire_dtype=...)``, of
horovod_tpu_torch against the JAX package's on the CPU: the same
numpy-seeded inputs through both, rank threads on both sides.  The JAX
package runs its sharded step in shard mode, one of the 8 virtual CPU
devices per rank (tests/conftest.py); the port's rank threads share one
device and each owns its shard of the optimizer state and its
error-feedback residual.

Tolerances:

* a loss whose gradient is its batch (``sum(w * b)``), plain SGD at lr
  1, so that both packages feed the wire the same gradients and the
  update is one rounding: parameters and error-feedback residuals bit
  for bit at np = 2 on every wire, with Average and Sum.  At np = 4 the
  JAX package sums four f32 or 16-bit rows in another order, rounding
  its partial sums (the port sums in rank order and rounds once): the
  parameters within two ulps of the wire's format (f32 2**-23, bf16
  2**-7, fp16 2**-10 relative) at the largest reduced gradient, per step
  (measured on fp16: 1.25 ulps after 3 steps); the integer sums of the
  quantized wires are exact, so those stay bit for bit;
* the linear-regression worker of tests/test_sharded.py (SGD momentum
  0.9, 4 steps): losses rtol 1e-6 and parameters within 1e-5 of the
  largest change the steps made (measured 1.5e-8 absolute), because the
  packages' matmuls sum in other orders and the JAX package's jitted
  program may contract ``x1*pre + x0*pre`` or the momentum's
  ``g + decay * t`` into an FMA (ROADMAP.md C, oracle cautions); at
  np = 4 on the 16-bit wires, as above, two ulps of the wire per step
  of that change and losses rtol 1e-5 (measured 4e-5 absolute, 6.7e-7
  relative on fp16).  No quantization code flips between the packages
  on these inputs: the int8/int4 runs sit at float noise too;
* the optimizer state's layout against the JAX package's global flat
  leaves (``trace``, ``mu``, ``nu``, ``count``), segmented or not, and
  the parameters beside them: rtol 1e-6 with an absolute 1e-6 of the
  tensor's largest magnitude (torch's SGD and AdamW round their updates
  in another order than optax; a layout fault moves whole elements);
* the small ResNet sharded on the f32 wire: the bounds of
  tests/test_torch_compiled.py's dense comparison;
* the LM (2 layers, 64 wide, AdamW) against flax ``TransformerLM`` with
  ``optax.adamw``: the losses at rtol 2e-4, those of
  tests/test_torch_lm_train.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu_torch.core.message import Adasum
from horovod_tpu_torch.ops import compiled as tc
from horovod_tpu_torch.parallel.train import adamw, sgd


def trun(fn, np_):
    return thvd.run(fn, np=np_, device="cpu")


def jrun(fn, np_):
    try:
        return jhvd.run(fn, np=np_)
    finally:
        if jhvd.is_initialized():
            jhvd.shutdown()


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


WIRES = [None, "f32", "bf16", "fp16", "int8", "int4"]


# ---------------------------------------------------------------------------
# the wire: a loss whose gradient is its batch


SHAPES = {"a": (300,), "b": (37,), "c": (5, 130)}


def _exact_params():
    rng = np.random.RandomState(3)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _exact_batch(rank, step):
    rng = np.random.RandomState(1000 * step + rank)
    return {k: (rng.randn(*s) * (1 + rank)).astype(np.float32)
            for k, s in SHAPES.items()}


def _jax_exact(op, wire, steps=3):
    def loss(params, batch):
        return sum(jnp.sum(params[k] * batch[k]) for k in SHAPES)

    def fn():
        step = jhvd.make_compiled_train_step(
            loss, optax.sgd(1.0), op=op, sharded=True, wire_dtype=wire)
        state = step.init_state({k: jnp.asarray(v) for k, v in
                                 _exact_params().items()})
        for s in range(steps):
            state, _ = step(state, _exact_batch(jhvd.rank(), s))
        ef = {k: np.asarray(v) for k, v in state.get("grad_ef", {}).items()}
        return {k: np.asarray(v) for k, v in state["params"].items()}, ef
    return fn


def _port_exact(op, wire, steps=3):
    def loss(params, batch):
        return sum((params[k] * batch[k]).sum() for k in SHAPES)

    def fn():
        step = thvd.make_compiled_train_step(
            loss, sgd(1.0), op=op, sharded=True, wire_dtype=wire)
        state = step.init_state(_exact_params())
        for s in range(steps):
            batch = {k: torch.from_numpy(v)
                     for k, v in _exact_batch(thvd.rank(), s).items()}
            state, _ = step(state, batch)
        ef = {k: _np(v) for k, v in state.get("grad_ef", {}).items()}
        return {k: _np(v) for k, v in state["params"].items()}, ef
    return fn


_ULP = {None: 2.0 ** -23, "f32": 2.0 ** -23, "bf16": 2.0 ** -7,
        "fp16": 2.0 ** -10}


def _reduced_max(np_, op, steps=3):
    """The largest |reduced gradient| of any step of the exact loss."""
    out = 0.0
    for s in range(steps):
        bs = [_exact_batch(r, s) for r in range(np_)]
        for k in SHAPES:
            g = np.abs(np.sum([b[k] for b in bs], axis=0, dtype=np.float64))
            out = max(out, float(g.max()) / (np_ if op == "average" else 1))
    return out


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("op", ["average", "sum"])
@pytest.mark.parametrize("np_", [2, 4])
def test_wire_matches_jax(np_, op, wire):
    """The reducescatter, the shard update and the gather against the
    JAX package's on the same gradients: parameters after 3 steps and the
    error-feedback residuals (int8/int4)."""
    jop, top = (jhvd.Average, thvd.Average) if op == "average" \
        else (jhvd.Sum, thvd.Sum)
    (jp, jef), = jrun(_jax_exact(jop, wire), np_)[:1]
    got = trun(_port_exact(top, wire), np_)
    for tp, tef in got:
        assert set(tef) == set(jef) == (
            set(SHAPES) if wire in ("int8", "int4") else set())
        exact = np_ == 2 or wire in ("int8", "int4")
        for k in SHAPES:
            if exact:
                assert np.array_equal(tp[k], jp[k]), k
            else:
                bound = 2 * 3 * _ULP[wire] * _reduced_max(np_, op)
                np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                           atol=bound, err_msg=k)
        for k in jef:
            assert tef[k].shape == jef[k].shape
            assert np.array_equal(tef[k], jef[k]), k


# ---------------------------------------------------------------------------
# the linear-regression worker of tests/test_sharded.py


def _lin_params():
    rng = np.random.RandomState(0)
    return {"w1": (rng.randn(8, 16) * .1).astype(np.float32),
            "b1": (rng.randn(16) * .1).astype(np.float32),
            "w2": (rng.randn(16, 4) * .1).astype(np.float32)}


def _lin_batches(rank, steps):
    rng = np.random.RandomState(100 + rank)
    return [(rng.randn(6, 8).astype(np.float32),
             rng.randn(6, 4).astype(np.float32)) for _ in range(steps)]


def _jax_lin(op, wire, opt, steps=4, sharded=True):
    def loss(params, batch):
        x, y = batch
        h = jax.nn.relu(x @ params["w1"] + params["b1"])
        return jnp.mean((h @ params["w2"] - y) ** 2)

    def fn():
        step = jhvd.make_compiled_train_step(
            loss, opt, op=op, sharded=sharded, wire_dtype=wire)
        state = step.init_state({k: jnp.asarray(v)
                                 for k, v in _lin_params().items()})
        losses = []
        for b in _lin_batches(jhvd.rank(), steps):
            state, loss_v = step(state, b)
            losses.append(float(loss_v))
        return losses, {k: np.asarray(v) for k, v in
                        state["params"].items()}, state
    return fn


def _port_lin(op, wire, opt, steps=4, sharded=True):
    def loss(params, batch):
        x, y = batch
        h = torch.relu(x @ params["w1"] + params["b1"])
        return ((h @ params["w2"] - y) ** 2).mean()

    def fn():
        step = thvd.make_compiled_train_step(
            loss, opt, op=op, sharded=sharded, wire_dtype=wire)
        state = step.init_state(_lin_params())
        losses = []
        for x, y in _lin_batches(thvd.rank(), steps):
            state, loss_v = step(state, (torch.from_numpy(x),
                                         torch.from_numpy(y)))
            losses.append(float(loss_v))
        return losses, {k: _np(v) for k, v in state["params"].items()}, \
            state
    return fn


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("op", ["average", "sum"])
@pytest.mark.parametrize("np_", [2, 4])
def test_linear_worker_matches_jax(np_, op, wire):
    """tests/test_sharded.py's worker, SGD momentum 0.9 on both sides, 4
    steps: every rank's losses and parameters against the JAX package's
    sharded step."""
    jop, top = (jhvd.Average, thvd.Average) if op == "average" \
        else (jhvd.Sum, thvd.Sum)
    jl, jp, _ = jrun(_jax_lin(jop, wire, optax.sgd(0.05, momentum=0.9)),
                     np_)[0]
    got = trun(_port_lin(top, wire, sgd(0.05, momentum=0.9)), np_)
    p0 = _lin_params()
    moved = max(float(np.abs(jp[k] - p0[k]).max()) for k in p0)
    wide = np_ == 4 and wire in ("bf16", "fp16")
    rel = 2 * 4 * _ULP[wire] if wide else 1e-5
    for tl, tp, _ in got:
        np.testing.assert_allclose(tl, jl, rtol=1e-5 if wide else 1e-6)
        for k in p0:
            np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                       atol=rel * moved, err_msg=k)


# ---------------------------------------------------------------------------
# the optimizer state: layout, segments, per-rank bytes, the carrier


def _optax_slots(opt_state):
    """``{slot: leaf tree}`` of an optax state's ``trace``/``mu``/``nu``/
    ``count`` fields."""
    out = {}
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "_fields")):
        for f in ("trace", "mu", "nu", "count"):
            if f in getattr(st, "_fields", ()):
                out[f] = getattr(st, f)
    return out


_TORCH_SLOT = {"trace": "momentum_buffer", "mu": "exp_avg",
               "nu": "exp_avg_sq"}


def _with_buckets(bb, fn):
    """Run ``fn`` with ``HOROVOD_OVERLAP_BUCKET_BYTES`` = ``bb`` (both
    packages build their config at init, inside ``run``)."""
    old = os.environ.get("HOROVOD_OVERLAP_BUCKET_BYTES")
    os.environ["HOROVOD_OVERLAP_BUCKET_BYTES"] = str(bb)
    try:
        return fn()
    finally:
        if old is None:
            os.environ.pop("HOROVOD_OVERLAP_BUCKET_BYTES")
        else:
            os.environ["HOROVOD_OVERLAP_BUCKET_BYTES"] = old


def _exact_run(pkg, opt, wire, steps, bb, np_=2):
    """``(step, state)`` of every rank after ``steps`` steps of the exact
    loss in ``pkg`` ('jax' or 'port') with ``bb`` segment bytes."""
    run = jrun if pkg == "jax" else trun

    def worker():
        loss = (lambda p, b: sum(jnp.sum(p[k] * b[k]) for k in SHAPES)) \
            if pkg == "jax" else \
            (lambda p, b: sum((p[k] * b[k]).sum() for k in SHAPES))
        mod = jhvd if pkg == "jax" else thvd
        step = mod.make_compiled_train_step(loss, opt, sharded=True,
                                            wire_dtype=wire)
        state = step.init_state(_exact_params())
        for s in range(steps):
            b = _exact_batch(mod.rank(), s)
            if pkg != "jax":
                b = {k: torch.from_numpy(v) for k, v in b.items()}
            state, _ = step(state, b)
        return step, state
    return _with_buckets(bb, lambda: run(worker, np_))


@pytest.mark.parametrize("bb", [0, 8])
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_opt_state_layout_matches_jax(opt, wire, bb):
    """Every rank's shard of every moment, concatenated in rank order,
    against the JAX package's global flat leaves: one segment per leaf
    (bb 0) and the segment-major layout of bucket-granular segments (bb
    8 splits every f32 leaf into 2-element segments and the 1024-element
    int8 leaf into two)."""
    jopt, topt = ((optax.sgd(0.5, momentum=0.9), sgd(0.5, momentum=0.9))
                  if opt == "sgd" else (optax.adamw(1e-2), adamw(1e-2)))
    (_jstep, jstate), _ = _exact_run("jax", jopt, wire, 3, bb)
    got = _exact_run("port", topt, wire, 3, bb)
    slots = _optax_slots(jstate["opt_state"])
    assert set(slots) == ({"trace"} if opt == "sgd"
                          else {"mu", "nu", "count"})
    step, state = got[0]
    so = state["opt_state"]
    assert isinstance(so, tc.ShardedOptState) and so.names == list(SHAPES)
    for slot, tree in slots.items():
        if slot == "count":
            for r, o in enumerate(so.optimizers):
                for p in so.rank_params(r):
                    assert float(o.state[p]["step"]) == int(tree) == 3
            continue
        flat = so.flat(_TORCH_SLOT[slot])
        for k in SHAPES:
            want = np.asarray(tree[k])
            assert flat[k].shape == want.shape
            np.testing.assert_allclose(_np(flat[k]), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=(slot, k))
    for k in SHAPES:
        want = np.asarray(jstate["params"][k])
        np.testing.assert_allclose(_np(state["params"][k]), want,
                                   rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    # each rank holds its 1/R of every moment
    n_slots = 1 if opt == "sgd" else 2
    pad = sum(step._shard_pad(int(np.prod(s)), 2) for s in SHAPES.values())
    for r in range(2):
        extra = 0 if opt == "sgd" else 4 * len(SHAPES)   # step counts
        assert so.state_bytes(r) == n_slots * 4 * pad // 2 + extra


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
def test_segmented_is_bit_for_bit_unsegmented(wire):
    """Bucket-granular segments of the scatter and the gather (bb 8:
    2-element f32 segments; the 1024-element leaf in two block-aligned
    halves under int8/int4) give the unsegmented step's parameters and
    residuals bit for bit, as in the JAX package's
    test_compiled_sharded_bucketized_bitwise_parity."""
    def snap(bb):
        (step, state), _ = _exact_run("port", sgd(0.5, momentum=0.9),
                                      wire, 3, bb)
        segs = [len(step._layout(int(np.prod(s)), 2,
                                 torch.device("cpu")).segs)
                for s in SHAPES.values()]
        return segs, {k: _np(v) for k, v in state["params"].items()}, \
            {k: _np(v) for k, v in state.get("grad_ef", {}).items()}

    s0, p0, e0 = snap(0)
    s1, p1, e1 = snap(8)
    assert s0 == [1, 1, 1] and max(s1) > 1
    for k in p0:
        assert np.array_equal(p0[k], p1[k]), k
    for k in e0:
        assert np.array_equal(e0[k], e1[k]), k


@pytest.mark.parametrize("wire,bb", [(None, 0), ("int8", 8)])
def test_carrier_resumes_a_jax_run(wire, bb):
    """``sharded_state_from_jax`` takes a JAX sharded state after 2 steps
    (params, the flat ``trace`` leaves in their segment-major layout,
    ``grad_ef``) into the port, which runs steps 3-4 to the JAX package's
    residuals bit for bit and its parameters within the layout test's
    bound (optax's momentum may round as an FMA; fresh runs of both
    packages differ by the same ulp)."""
    steps = 4

    def jfn():
        loss = lambda p, b: sum(jnp.sum(p[k] * b[k]) for k in SHAPES)
        step = jhvd.make_compiled_train_step(
            loss, optax.sgd(0.5, momentum=0.9), sharded=True,
            wire_dtype=wire)
        state = step.init_state(_exact_params())
        mid = None
        for s in range(steps):
            state, _ = step(state, _exact_batch(jhvd.rank(), s))
            if s == 1:
                mid = jax.tree_util.tree_map(np.asarray, (
                    state["params"], _optax_slots(state["opt_state"]),
                    state.get("grad_ef", {})))
        return mid, jax.tree_util.tree_map(np.asarray, (
            state["params"], state.get("grad_ef", {})))

    (mid, (want_p, want_ef)), _ = _with_buckets(bb, lambda: jrun(jfn, 2))

    def tfn():
        loss = lambda p, b: sum((p[k] * b[k]).sum() for k in SHAPES)
        step = thvd.make_compiled_train_step(
            loss, sgd(0.5, momentum=0.9), sharded=True, wire_dtype=wire)
        params, slots, ef = mid
        state = tc.sharded_state_from_jax(step, params, slots,
                                          grad_ef=ef)
        for s in range(2, steps):
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                    _exact_batch(thvd.rank(), s).items()})
        return ({k: _np(v) for k, v in state["params"].items()},
                {k: _np(v) for k, v in state.get("grad_ef", {}).items()})

    for got_p, got_ef in _with_buckets(bb, lambda: trun(tfn, 2)):
        assert set(got_ef) == set(want_ef)
        for k in SHAPES:
            np.testing.assert_allclose(
                got_p[k], want_p[k], rtol=1e-6,
                atol=1e-6 * np.abs(want_p[k]).max(), err_msg=k)
        for k in want_ef:
            assert np.array_equal(got_ef[k], want_ef[k]), k


def test_donate_false_keeps_the_sharded_state():
    """``donate=False`` leaves the caller's params, shards, moments and
    residuals untouched; both modes give the same new state."""
    def fn():
        outs = {}
        for donate in (False, True):
            step = thvd.make_compiled_train_step(
                lambda p, b: sum((p[k] * b[k]).sum() for k in SHAPES),
                sgd(0.5, momentum=0.9), sharded=True, wire_dtype="int8",
                donate=donate)
            state = step.init_state(_exact_params())
            b = {k: torch.from_numpy(v)
                 for k, v in _exact_batch(thvd.rank(), 0).items()}
            state, _ = step(state, b)
            before = [t.clone() for t in tc._state_leaves(state, [])]
            new, _ = step(state, b)
            kept = all(torch.equal(a, t) for a, t in
                       zip(before, tc._state_leaves(state, [])))
            outs[donate] = (kept, new is state,
                            [_np(t) for t in tc._state_leaves(new, [])])
        return outs

    for outs in trun(fn, 2):
        assert outs[False][0] and not outs[False][1]
        assert not outs[True][0] and outs[True][1]
        assert all(np.array_equal(a, b)
                   for a, b in zip(outs[False][2], outs[True][2]))


# ---------------------------------------------------------------------------
# the contract around the step


def test_dense_step_ignores_wire_dtype():
    """The dense step takes a ``wire_dtype`` and ignores it, as the JAX
    package's ``_build`` does: bit for bit the step without one."""
    outs = [trun(_port_lin(thvd.Average, w, sgd(0.05, momentum=0.9),
                           sharded=False), 2)[0][:2]
            for w in (None, "int8")]
    assert outs[0][0] == outs[1][0]
    assert all(np.array_equal(outs[0][1][k], outs[1][1][k])
               for k in outs[0][1])


def test_sharded_f32_is_bit_for_bit_dense():
    """At np 2 and 4 the sharded f32 step sums the ranks' gradients in
    the dense step's order and runs the same elementwise update on the
    shards: losses and parameters bit for bit."""
    for np_ in (2, 4):
        sh, dn = (trun(_port_lin(thvd.Average, None,
                                 sgd(0.05, momentum=0.9), sharded=s), np_)
                  for s in (True, False))
        assert sh[0][0] == dn[0][0]
        assert all(np.array_equal(sh[0][1][k], dn[0][1][k])
                   for k in dn[0][1])


def test_adasum_and_decompositions_refused():
    """The sharded step refuses Adasum, and a hint that is no
    TopologyHint, as the JAX package's does; an inner wire and a
    TopologyHint are taken (tests/test_torch_allreduce_2d.py runs
    them)."""
    loss = (lambda p, b: p["w"].sum())
    with pytest.raises(ValueError, match="Average or Sum"):
        thvd.make_compiled_train_step(loss, sgd(0.1), sharded=True,
                                      op=Adasum)
    for mod, opt in ((thvd, sgd(0.1)), (jhvd, optax.sgd(0.1))):
        with pytest.raises(ValueError, match="must be a TopologyHint"):
            mod.make_compiled_train_step(loss, opt, sharded=True,
                                         topology_hint=("dp", "tp"))
    for kw in (dict(wire_inner="bf16"),
               dict(wire_dtype="int8", wire_inner="bf16"),
               dict(wire_dtype="int4", topology_hint=thvd.TopologyHint(
                   ("dp", "tp"), (2, 2)))):
        step = thvd.make_compiled_train_step(loss, sgd(0.1), sharded=True,
                                             **kw)
        assert step.wire_inner == kw.get("wire_inner")
        assert step.topology_hint == kw.get("topology_hint")


def test_program_cache_key_names_the_decomposition():
    """One program per (wire, segment size): two sharded steps on the
    same tag but another wire are two programs; repeat calls hit."""
    def fn():
        h0, m0 = tc.program_cache_stats()
        steps = [thvd.make_compiled_train_step(
            lambda p, b: (p["w"] * b).sum(), sgd(0.1), sharded=True,
            wire_dtype=w) for w in (None, "int8")]
        for step in steps:
            state = step.init_state({"w": np.ones(4, np.float32)})
            for _ in range(3):
                state, _ = step(state, torch.ones(4))
        h1, m1 = tc.program_cache_stats()
        keys = [k for k in tc._PROGRAM_CACHE if k[0] == "step"]
        return m1 - m0, {k[3][:4] for k in keys}

    misses, modes = trun(fn, 2)[0]
    assert misses == 2 and modes == {("sharded", None, None, 0),
                                     ("sharded", "int8", None, 0)}


def test_lm_train_step_sharded_is_the_dense_step(monkeypatch):
    """``make_lm_train_step(sharded=True)``, or ``HOROVOD_SHARDED_OPTIMIZER``
    with ``sharded=None``, at its one data-parallel rank is the dense
    step, as the JAX package's on a dp = 1 mesh: bit for bit."""
    from horovod_tpu_torch.models import transformer as pt
    from horovod_tpu_torch.parallel import make_lm_train_step

    cfg = pt.TransformerConfig(dtype=torch.float32, vocab_size=64,
                               d_model=32, n_layers=2, n_heads=4, d_ff=64,
                               max_seq_len=16)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 16))
    outs = []
    for kw, env in ((dict(sharded=False), None), (dict(sharded=True), None),
                    ({}, "1")):
        if env:
            monkeypatch.setenv("HOROVOD_SHARDED_OPTIMIZER", env)
        init, step = make_lm_train_step(cfg, device="cpu", **kw)
        state = init(0)
        losses = [float(step(state, tokens)[1]) for _ in range(2)]
        outs.append((losses, {k: v.detach().clone() for k, v in
                              state["model"].state_dict().items()}))
    for losses, sd in outs[1:]:
        assert losses == outs[0][0]
        assert all(torch.equal(sd[k], outs[0][1][k]) for k in sd)


# ---------------------------------------------------------------------------
# models


def test_small_resnet_sharded_matches_jax():
    """tests/test_torch_compiled.py's small ResNet (stages 1-1-1-1, 8
    filters, BatchNorm statistics in the aux) through both packages'
    sharded steps on the f32 wire, held to that test's unfused bounds."""
    from test_torch_compiled import RESNET_BOUNDS, small_resnet_case

    small_resnet_case(*RESNET_BOUNDS[0], sharded=True)


LM_KW = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128,
             max_seq_len=32)


@pytest.mark.parametrize("wire", [None, "bf16"])
def test_small_lm_sharded_matches_flax(wire):
    """A 2-layer, 64-wide LM through the sharded step with AdamW at np=2,
    against flax ``TransformerLM`` with ``optax.adamw`` through the JAX
    package's sharded step, from the same weights and tokens: 3 steps'
    losses.  (The JAX model stacks its layers into one leaf per weight,
    the port keeps one per layer, so the flat layouts differ; the f32 and
    16-bit wires are elementwise, where the layout cannot matter.)"""
    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as pt

    jcfg = jt.TransformerConfig(dtype=jnp.float32, **LM_KW)
    toks = [np.random.default_rng(20 + r).integers(
        0, LM_KW["vocab_size"], size=(2, 32)).astype(np.int32)
        for r in range(2)]
    jmodel = jt.TransformerLM(jcfg)
    params0 = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(toks[0]))["params"])

    def jfn():
        def loss(p, t):
            logits = jmodel.apply({"params": p}, t)
            return jt.lm_loss(logits[:, :-1], t[:, 1:])
        step = jhvd.make_compiled_train_step(
            loss, optax.adamw(1e-3), sharded=True, wire_dtype=wire)
        state = step.init_state(params0)
        out = []
        for _ in range(3):
            state, v = step(state, toks[jhvd.rank()])
            out.append(float(v))
        return out

    pcfg = pt.TransformerConfig(dtype=torch.float32, **LM_KW)
    with torch.device("meta"):
        model = pt.TransformerLM(pcfg)

    def tfn():
        def loss(p, t):
            logits = torch.func.functional_call(model, p, (t,))
            return pt.lm_loss(logits[:, :-1], t[:, 1:])
        step = thvd.make_compiled_train_step(
            loss, adamw(1e-3), sharded=True, wire_dtype=wire)
        state = step.init_state(pt.from_flax_params(params0))
        out = []
        for _ in range(3):
            state, v = step(state, torch.from_numpy(
                toks[thvd.rank()]).long())
            out.append(float(v))
        return out, state["opt_state"]

    want = jrun(jfn, 2)[0]
    for got, so in trun(tfn, 2):
        np.testing.assert_allclose(got, want, rtol=2e-4)
        assert got[-1] < got[0]
        n = sum(p.numel() for p in model.parameters())
        # AdamW's two moments, each rank half of them (+ its step counts)
        assert abs(so.state_bytes(0) - 2 * 4 * n / 2) <= 4 * 2 * len(
            so.names) + 4 * len(so.names)


# ---------------------------------------------------------------------------
# ROADMAP.md C items 1-3: where the JAX compiled reducer differs from the
# JAX engine, the port follows the engine


def test_bool_sum_stays_bool():
    """C item 1, ``[True, False, rank == 1]`` with Sum at np=2.  Port
    compiled: ``[True, False, True]`` bool.  JAX engine: the same.  JAX
    compiled: ``[2, 0, 1]`` int32 (``reduce_plain``'s ``jnp.sum`` promotes
    bool and nothing casts back)."""
    def make(r):
        return np.array([True, False, r == 1])

    got = trun(lambda: thvd.compiled_allreduce(
        torch.from_numpy(make(thvd.rank())), op=thvd.Sum), 2)
    for g in got:
        assert g.dtype == torch.bool
        assert _np(g).tolist() == [True, False, True]
    eng = jrun(lambda: jhvd.allreduce(make(jhvd.rank()), op=jhvd.Sum,
                                      name="b"), 2)
    comp = jrun(lambda: jhvd.compiled_allreduce(make(jhvd.rank()),
                                                op=jhvd.Sum), 2)
    assert np.asarray(eng[0]).tolist() == [True, False, True]
    assert np.asarray(comp[0]).tolist() == [2, 0, 1]


def test_f64_average_is_exact():
    """C item 2, f64 Average of ``RandomState(0).randn(37) / 3`` on both
    ranks: the port's compiled result is the exact mean (B1 scales f64 in
    f64), as the JAX engine's is; the JAX compiled result is off by f32
    rounding (its f64 sum scaled in f32; 2.07e-8 here)."""
    x = np.random.RandomState(0).randn(37) / 3
    got = trun(lambda: thvd.compiled_allreduce(torch.from_numpy(x)), 2)
    for g in got:
        assert g.dtype == torch.float64 and np.array_equal(_np(g), x)
    eng = jrun(lambda: jhvd.allreduce(x, name="f"), 2)
    comp = jrun(lambda: jhvd.compiled_allreduce(x), 2)
    assert np.array_equal(np.asarray(eng[0]), x)
    err = float(np.abs(np.asarray(comp[0]) - x).max())
    assert 0 < err <= 2.0 ** -23 * float(np.abs(x).max()), err


def test_nan_under_compiled_int8_keeps_the_block_nan():
    """C item 3, rank 0 ``[NaN] + [0.5] * 300``, rank 1 ``[1.0] + [0.5] *
    300`` (f32), Average over the int8 wire: the port's compiled result
    is NaN over all of block 0 and 0.5 on the int8 grid after it
    (0.49996948), bit for bit the JAX engine's (the codec's NaN-keeping
    absmax); the JAX compiled program returns finite values (0.49996948
    at element 0 on XLA's CPU), which is not a contract."""
    def make(r):
        return np.array([np.nan if r == 0 else 1.0] + [0.5] * 300,
                        np.float32)

    want_nan = np.arange(301) < 256
    got = trun(lambda: thvd.compiled_allreduce(
        torch.from_numpy(make(thvd.rank())), wire_dtype="int8"), 2)
    eng = np.asarray(jrun(lambda: jhvd.allreduce(
        make(jhvd.rank()), name="n", wire_dtype="int8"), 2)[0])
    assert np.array_equal(np.isnan(eng), want_nan)
    for g in got:
        g = _np(g)
        assert np.array_equal(np.isnan(g), want_nan)
        assert np.array_equal(g[256:], eng[256:])
        np.testing.assert_allclose(g[256:], 0.5, rtol=1e-4)
    comp = jrun(lambda: jhvd.compiled_allreduce(make(jhvd.rank()),
                                                wire_dtype="int8"), 2)
    assert np.all(np.isfinite(np.asarray(comp[0])))
