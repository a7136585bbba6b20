"""horovod_tpu_torch.ops.compiled against horovod_tpu.ops.compiled on the
CPU: the same numpy-seeded inputs through both packages' compiled
reducers and compiled train steps, rank threads on both sides
(``hvd.run``).  On the CPU the port's programs are its plain functions
and B1 (the scale/cast kernel) its plain version.

Tolerances:

* reductions of integer-valued data, the quantized and 16-bit wires
  with error feedback over 3 calls, and bucketized against grouped:
  bit for bit.  The codes, the shared scales and the integer sums are
  exact, and the float sums run over 2 ranks, one rounding;
* pre/post-scaled float allreduces: rtol 1e-6, because the JAX
  package's jitted program may contract ``x1*pre + x0*pre`` into an FMA
  (ROADMAP.md C, oracle cautions);
* linear-regression train steps: rtol 1e-6 (float sums in other
  orders);
* the small ResNet's 3 compiled steps (stages 1-1-1-1, 8 filters,
  32 x 32, 4 images a rank, f32, SGD at lr 1e-3 with momentum 0.9):
  relative L2 of the 3 losses 1e-3 unfused / 1e-2 fused (measured
  9.7e-5 / 3.4e-3), of the change the steps made to all parameters 0.1
  / 0.2 (measured 0.055 / 0.097), of the worst batch statistic 2e-3 /
  1e-2 (measured 3.2e-4 / 3.1e-3).  The model is ill-conditioned:
  BatchNorm over the 4 rows of the last stage amplifies f32
  reassociation, so that plain torch and plain JAX SGD on the same
  model, batches and weights (no compiled step on either side) already
  differ by 0.28%, 1.35% and 4.7% in the parameters' change after 1, 2
  and 3 steps; and the fused blocks round ``xh`` and ``ytot`` to bf16,
  roundings that flip under any f32 change
  (``tests/test_torch_fused_resnet.py``).  A reduction or optimizer
  fault (a Sum for the mean, a lost momentum, an unaveraged or shared
  statistic) moves these by far more.
"""

import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu.models.resnet import ResNet as FlaxResNet
from horovod_tpu_torch.models.resnet import ResNet, from_flax_variables
from horovod_tpu_torch.ops import compiled as tc
from horovod_tpu_torch.ops import cuda_kernels
from horovod_tpu_torch.parallel.train import sgd

NP = 4


def trun(fn, np_=NP):
    return thvd.run(fn, np=np_, device="cpu")


def jrun(fn, np_=NP):
    try:
        return jhvd.run(fn, np=np_)
    finally:
        if jhvd.is_initialized():
            jhvd.shutdown()


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# the grouped reducer: the cases of tests/test_compiled.py


def test_compiled_allreduce_average():
    def make(r):
        return np.arange(8, dtype=np.float32) * (r + 1)

    want = jrun(lambda: jhvd.compiled_allreduce(make(jhvd.rank())))

    def fn():
        out = thvd.compiled_allreduce(torch.from_numpy(make(thvd.rank())))
        out -= 1.0          # results are new, writable tensors
        return out + 1.0

    got = trun(fn)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g), w)
    assert np.array_equal(_np(got[0]), np.arange(8) * 2.5)


def test_compiled_allreduce_sum_matches_engine():
    def fn():
        x = torch.arange(16, dtype=torch.float64) + thvd.rank()
        fast = thvd.compiled_allreduce(x, op=thvd.Sum)
        slow = thvd.allreduce(x, op=thvd.Sum, name="slow")
        assert torch.equal(fast, slow)
        return fast

    got = trun(fn)
    want = jrun(lambda: jhvd.compiled_allreduce(
        np.arange(16, dtype=np.float64) + jhvd.rank(), op=jhvd.Sum))
    assert all(np.array_equal(_np(g), w) for g, w in zip(got, want))


def _mixed(r):
    return [np.ones((3, 4), np.float32) * (r + 1),
            np.full((5,), float(r), np.float64),
            np.arange(6, dtype=np.int32) * (r + 1),
            np.ones((2, 2), np.float32) * r]


def test_compiled_grouped_mixed_dtypes():
    """One program reduces a mixed f32/f64/int32 group (one fusion
    buffer per dtype)."""
    want = jrun(lambda: jhvd.compiled_grouped_allreduce(
        _mixed(jhvd.rank()), op=jhvd.Sum))
    got = trun(lambda: thvd.compiled_grouped_allreduce(
        [torch.from_numpy(a) for a in _mixed(thvd.rank())], op=thvd.Sum))
    for g_rank, w_rank in zip(got, want):
        for g, w in zip(g_rank, w_rank):
            assert _np(g).dtype == w.dtype and np.array_equal(_np(g), w)
    tri = sum(range(1, NP + 1))
    assert np.array_equal(_np(got[0][2]), np.arange(6) * tri)


def test_compiled_allreduce_prescale_postscale():
    """The gradient-predivide split (pre=1/f, post=f) cancels for
    Average; scaled values match the JAX package's within 1e-6."""
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(64).astype(np.float32) for _ in range(NP)]
    kw = dict(prescale_factor=0.3, postscale_factor=1.7)
    want = jrun(lambda: jhvd.compiled_allreduce(xs[jhvd.rank()], **kw))
    got = trun(lambda: thvd.compiled_allreduce(
        torch.from_numpy(xs[thvd.rank()]), **kw))
    np.testing.assert_allclose(_np(got[0]), want[0], rtol=1e-6, atol=1e-7)
    cancel = trun(lambda: thvd.compiled_allreduce(
        torch.ones(4) * (thvd.rank() + 1), prescale_factor=0.5,
        postscale_factor=2.0))
    assert np.allclose(_np(cancel[0]), np.mean(np.arange(1, NP + 1)))


@pytest.mark.parametrize("case", ["int_average", "min_op"])
def test_compiled_allreduce_refusals(case):
    """An integer Average and an op other than Average/Sum raise
    ValueError on every rank, in both packages."""
    def call(pkg, rank):
        if case == "int_average":
            x = np.arange(4, dtype=np.int32)
            if pkg is thvd:
                x = torch.from_numpy(x)
            return pkg.compiled_allreduce(x, op=pkg.Average)
        return pkg.compiled_allreduce(
            torch.ones(4) if pkg is thvd else np.ones(4, np.float32),
            op=pkg.Min)

    for pkg, runner in ((jhvd, jrun), (thvd, trun)):
        def fn():
            with pytest.raises(ValueError):
                call(pkg, pkg.rank())
            return True
        assert all(runner(fn))


def test_compiled_allreduce_process_set():
    """The global process set, by object and by id; an unregistered or
    unknown set is refused (the port has one process set until
    add_process_set lands, ROADMAP.md A2/A3/A5)."""
    def fn():
        r = thvd.rank()
        x = torch.ones(4) * (r + 1)
        a = thvd.compiled_allreduce(x, process_set=thvd.global_process_set)
        b = thvd.compiled_allreduce(x, process_set=0)
        assert torch.equal(a, b)
        with pytest.raises(ValueError, match="not registered"):
            thvd.compiled_allreduce(x, process_set=thvd.ProcessSet([0, 1]))
        with pytest.raises(ValueError, match="unknown process set"):
            thvd.compiled_allreduce(x, process_set=7)
        return a

    assert all(np.allclose(_np(o), 2.5) for o in trun(fn))


def test_compiled_reducer_reuses_programs():
    """Steady state hits the program cache; a new signature builds one
    new program."""
    barrier = threading.Barrier(NP, timeout=60)

    def fn():
        red = thvd.CompiledGroupedAllreduce(op=thvd.Sum)
        x = [torch.ones(4) * thvd.rank()]
        red(x)
        n1 = len(red._programs)
        barrier.wait()
        hits, misses = tc.program_cache_stats()
        barrier.wait()
        red(x)
        red([torch.ones(4)])              # same signature
        assert len(red._programs) == n1 == 1
        barrier.wait()
        # every rank's reducer hit the cache twice; nothing was rebuilt
        assert tc.program_cache_stats() == (hits + 2 * NP, misses)
        barrier.wait()
        red([torch.ones(5)])              # new signature -> new program
        assert len(red._programs) == 2
        return True

    misses = tc.program_cache_stats()[1]
    assert all(trun(fn))
    # one build per signature, shared by the ranks' reducers
    assert tc.program_cache_stats()[1] == misses + 2


def test_compiled_reducer_survives_reinit():
    """A long-lived reducer never serves a program built for a previous
    engine's world size after shutdown and re-init."""
    red = thvd.CompiledGroupedAllreduce(op=thvd.Average)
    outs = trun(lambda: red([torch.ones(4) * (thvd.rank() + 1)])[0], 4)
    assert all(np.allclose(_np(o), 2.5) for o in outs)
    outs = trun(lambda: red([torch.ones(4) * (thvd.rank() + 1)])[0], 2)
    assert all(np.allclose(_np(o), 1.5) for o in outs), outs


def test_compiled_allreduce_signature_mismatch_raises():
    """Mismatched shapes across rank threads fail loudly on every rank."""
    def fn():
        n = 4 if thvd.rank() == 0 else 5
        with pytest.raises((ValueError, RuntimeError)) as ei:
            thvd.compiled_allreduce(torch.ones(n))
        assert "signature mismatch" in str(ei.value)
        return True

    assert all(trun(fn))


# ---------------------------------------------------------------------------
# wires and buckets, bit for bit

# at 4 KB buckets every wire splits these into 3 buckets: [0], [1-3],
# [4-5]; the quantized wires close a bucket only where the running
# element count is a multiple of the 256-element block (4096 and 3584)
SHAPES = [(1024,), (300,), (212,), (2048,), (5,), (64, 40)]


def _grads(seed, r):
    rng = np.random.default_rng(seed * 100 + r)
    return [rng.standard_normal(s).astype(np.float32) * (1 + r)
            for s in SHAPES]


def _jax_wire(wire, ef, calls, bucket_bytes=0):
    def fn():
        red = jhvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=ef, name="w",
            bucket_bytes=bucket_bytes)
        return [red(_grads(c, jhvd.rank())) for c in range(calls)]
    return jrun(fn, 2)


def _port_wire(wire, ef, calls, bucket_bytes=0, pushes=None):
    def fn():
        red = thvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=ef, name="w",
            bucket_bytes=bucket_bytes)
        out = []
        for c in range(calls):
            g = [torch.from_numpy(a) for a in _grads(c, thvd.rank())]
            if pushes is None:
                out.append(red(g))
                continue
            st = red.stream(g)
            assert len(st.buckets) == 3
            for i in pushes:
                st.push(i, g[i])
            out.append(st.result())
        return [[_np(t) for t in call] for call in out]
    return trun(fn, 2)


@pytest.mark.parametrize("wire,ef", [("int8", True), ("int4", True),
                                     ("int8", False), ("bf16", False),
                                     ("fp16", False)])
def test_wire_matches_jax_bit_for_bit(wire, ef):
    """The shared-scale int8/int4 wire with error feedback, and the
    16-bit wires, over 3 calls at np=2, grouped on both sides (buckets
    pinned: bucket_bytes=0), equal the JAX package's bit for bit."""
    want = _jax_wire(wire, ef, 3)
    got = _port_wire(wire, ef, 3)
    for r in range(2):
        for c in range(3):
            for g, w in zip(got[r][c], want[r][c]):
                assert g.dtype == w.dtype
                assert np.array_equal(g.view(np.uint32), w.view(np.uint32)), \
                    (wire, r, c)


@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
def test_bucketized_matches_grouped_bit_for_bit(wire):
    """3 buckets of ~4 KB (block-aligned under a quantized wire), pushed
    in reverse order, give the grouped result bit for bit over 3 calls
    with error feedback; the JAX package's bucketized reducer agrees."""
    ef = wire in ("int8", "int4")
    grouped = _port_wire(wire, ef, 3)
    pushes = list(range(len(SHAPES)))[::-1]
    bucketed = _port_wire(wire, ef, 3, bucket_bytes=4096, pushes=pushes)
    want = _jax_wire(wire, ef, 3, bucket_bytes=4096)
    for r in range(2):
        for c in range(3):
            for g, b, w in zip(grouped[r][c], bucketed[r][c], want[r][c]):
                assert np.array_equal(g, b) and np.array_equal(b, w)


def test_buckets_launch_in_plan_order():
    """A bucket launches when its members are in, strictly in plan
    order: pushing the last member first launches nothing."""
    def fn():
        red = thvd.CompiledGroupedAllreduce(bucket_bytes=1)
        g = [torch.from_numpy(a) for a in _grads(0, thvd.rank())]
        st = red.stream([(tuple(a.shape), a.dtype) for a in g])
        assert len(st.buckets) == len(SHAPES)
        last = len(SHAPES) - 1
        st.push(last, g[last])
        assert st._next == 0
        for i in range(last):
            st.push(i, g[i])
        assert st._next == len(SHAPES)
        return [_np(t) for t in st.result()]

    got = trun(fn, 2)
    for g, a, b in zip(got[0], _grads(0, 0), _grads(0, 1)):
        assert np.array_equal(g, (a + b) * np.float32(0.5))


def test_wire_accounting():
    def fn():
        red = thvd.CompiledGroupedAllreduce(wire_dtype="int8")
        red([torch.from_numpy(a) for a in _grads(0, thvd.rank())])
        return red.last_logical_bytes, red.last_wire_bytes

    def jfn():
        red = jhvd.CompiledGroupedAllreduce(wire_dtype="int8")
        red(_grads(0, jhvd.rank()))
        return red.last_logical_bytes, red.last_wire_bytes

    assert trun(fn, 2) == jrun(jfn, 2)


def test_b1_packs_and_unpacks(monkeypatch):
    """Each rank's float fusion buffer goes through the scale/cast
    wrappers (their plain versions on the CPU: no kernel launch)."""
    seen = []
    for name in ("pack_scale_cast", "unpack_scale_cast"):
        def spy(*a, _f=getattr(cuda_kernels, name), _n=name, **k):
            seen.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(cuda_kernels, name, spy)
    cuda_kernels.reset_launches()
    trun(lambda: thvd.compiled_grouped_allreduce(
        [torch.ones(3), torch.ones(2, dtype=torch.float64)]), 2)
    # per rank: one pack and one unpack per dtype buffer
    assert seen.count("pack_scale_cast") == 4
    assert seen.count("unpack_scale_cast") == 4
    assert sum(cuda_kernels.launches.values()) == 0


# ---------------------------------------------------------------------------
# the train step


W0 = np.full((3, 1), 0.25, np.float32)


def _lin_data(r):
    rng = np.random.RandomState(r)
    x = rng.rand(8, 3).astype(np.float32)
    return x, x.sum(axis=1, keepdims=True).astype(np.float32)


def test_compiled_train_step_matches_jax_and_serial_sgd():
    """The stacked program equals serial SGD on the mean of the ranks'
    losses, and the JAX package's compiled step."""
    def jfn():
        def loss_fn(params, batch):
            x, y = batch
            return jnp.mean((x @ params["w"] - y) ** 2)
        step = jhvd.make_compiled_train_step(loss_fn, optax.sgd(0.1))
        state = step.init_state({"w": W0.copy()})
        losses = []
        for _ in range(5):
            state, loss = step(state, _lin_data(jhvd.rank()))
            losses.append(float(loss))
        return np.asarray(state["params"]["w"]), losses

    def fn():
        def loss_fn(params, batch):
            x, y = batch
            return ((x @ params["w"] - y) ** 2).mean()
        step = thvd.make_compiled_train_step(loss_fn, sgd(0.1))
        state = step.init_state({"w": W0})
        losses = []
        for _ in range(5):
            state, loss = step(state, _lin_data(thvd.rank()))
            losses.append(float(loss))
        return _np(state["params"]["w"]), losses

    want, got = jrun(jfn), trun(fn)
    for w, l in got:
        assert np.array_equal(w, got[0][0])
        np.testing.assert_allclose(w, want[0][0], rtol=1e-6)
        np.testing.assert_allclose(l, want[0][1], rtol=1e-6)
    batches = [_lin_data(r) for r in range(NP)]
    w = W0.astype(np.float64)
    for _ in range(5):
        g = np.mean([2 * x.T @ (x @ w - y) / len(x) for x, y in batches],
                    axis=0)
        w = w - 0.1 * g
    np.testing.assert_allclose(got[0][0], w, rtol=1e-5)


def test_compiled_train_step_sum_op():
    def fn():
        step = thvd.make_compiled_train_step(
            lambda params, batch: (params["w"] * batch).sum(), sgd(1.0),
            op=thvd.Sum)
        state = step.init_state({"w": np.zeros(3, np.float32)})
        state, _ = step(state, torch.ones(3) * (thvd.rank() + 1))
        return _np(state["params"]["w"])

    for w in trun(fn):
        assert np.array_equal(w, -np.ones(3) * sum(range(1, NP + 1)))


def test_compiled_train_step_has_aux():
    """aux threads through the step: float leaves averaged over ranks,
    others rank 0's (as the JAX package's stacked program)."""
    def jfn():
        def loss_fn(params, aux, batch):
            loss = jnp.mean((batch @ params["w"]) ** 2)
            return loss, {"running": aux["running"] * 0.9
                          + 0.1 * jnp.mean(batch),
                          "count": aux["count"] + 1}
        step = jhvd.make_compiled_train_step(loss_fn, optax.sgd(0.01),
                                             has_aux=True)
        state = step.init_state(
            {"w": np.ones((3, 1), np.float32)},
            aux={"running": np.zeros((), np.float32),
                 "count": np.zeros((), np.int32)})
        state, loss = step(state, np.full((2, 3), float(jhvd.rank()),
                                          np.float32))
        return float(state["aux"]["running"]), int(state["aux"]["count"])

    def fn():
        def loss_fn(params, aux, batch):
            loss = ((batch @ params["w"]) ** 2).mean()
            return loss, {"running": aux["running"] * 0.9
                          + 0.1 * batch.mean(),
                          "count": aux["count"] + 1}
        step = thvd.make_compiled_train_step(loss_fn, sgd(0.01),
                                             has_aux=True)
        state = step.init_state(
            {"w": np.ones((3, 1), np.float32)},
            aux={"running": np.zeros((), np.float32),
                 "count": np.zeros((), np.int32)})
        state, loss = step(state, torch.full((2, 3), float(thvd.rank())))
        return float(state["aux"]["running"]), int(state["aux"]["count"])

    got, want = trun(fn), jrun(jfn)
    assert all(np.isclose(g[0], 0.1 * np.mean(range(NP))) for g in got)
    assert [g[1] for g in got] == [w[1] for w in want] == [1] * NP
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-6)


def test_compiled_train_step_donate_false_keeps_state():
    """donate=False leaves the caller's state (params and momentum
    buffers) untouched; donate=True updates it in place; both give the
    same new state."""
    def loss_fn(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    def fn():
        outs = {}
        for donate in (False, True):
            step = thvd.make_compiled_train_step(
                loss_fn, sgd(0.1, momentum=0.9), donate=donate)
            state = step.init_state({"w": W0})
            state, _ = step(state, _lin_data(thvd.rank()))
            before = state["params"]["w"].detach().clone()
            buf = state["opt_state"].state[state["params"]["w"]][
                "momentum_buffer"].clone()
            new, _ = step(state, _lin_data(thvd.rank()))
            kept = torch.equal(state["params"]["w"], before) and torch.equal(
                state["opt_state"].state[state["params"]["w"]][
                    "momentum_buffer"], buf)
            outs[donate] = (kept, new is state, _np(new["params"]["w"]))
        return outs

    for outs in trun(fn, 2):
        assert outs[False][0] and not outs[False][1]
        assert not outs[True][0] and outs[True][1]
        assert np.array_equal(outs[False][2], outs[True][2])


def test_place_batch_single_rank():
    """A staged batch (one rank per process) trains as the unstaged one
    does, and rank threads are refused place_batch."""
    def loss_fn(params, batch):
        x, y = batch
        return ((x @ params["w"] - y) ** 2).mean()

    def fn():
        out = []
        for staged in (False, True):
            step = thvd.make_compiled_train_step(loss_fn, sgd(0.1))
            state = step.init_state({"w": W0})
            batch = _lin_data(0)
            feed = step.place_batch(batch) if staged else batch
            for _ in range(3):
                state, loss = step(state, feed)
            out.append(_np(state["params"]["w"]))
        return out

    a, b = trun(fn, 1)[0]
    assert np.array_equal(a, b)

    def refused():
        step = thvd.make_compiled_train_step(loss_fn, sgd(0.1))
        with pytest.raises(ValueError, match="per-process"):
            step.place_batch(_lin_data(0))
        return True
    assert all(trun(refused, 2))


def test_compiled_predict_one_program_per_signature():
    def predict(params, batch):
        return batch["x"] @ params["w"]

    pred = tc.CompiledPredict(predict)
    params = {"w": torch.ones(3, 2)}
    h0, m0 = tc.program_cache_stats()
    for n in (4, 4, 8, 4):
        out = pred(params, {"x": torch.ones(n, 3)})
        assert out.shape == (n, 2) and not out.requires_grad
    assert len(pred.signatures()) == 2
    h1, m1 = tc.program_cache_stats()
    assert (h1 - h0, m1 - m0) == (2, 2)
    assert tc.batch_signature({"x": torch.ones(4, 3)}) == \
        tc.batch_signature({"x": np.ones((4, 3), np.float32)})


# ---------------------------------------------------------------------------
# the small ResNet through both compiled steps


BATCH, HW, CLASSES, STEPS, LR = 4, 32, 10, 3, 1e-3
KW = dict(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=CLASSES,
          dtype=jnp.float32)


def _values(tree, rng):
    """LeCun-normal kernels and non-trivial BN affine and statistics
    (flax's zero last-BN scales would zero most gradients)."""
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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _resnet_batches():
    rng = np.random.default_rng(5)
    return [[(rng.standard_normal((BATCH, HW, HW, 3)).astype(np.float32),
              rng.integers(0, CLASSES, size=BATCH).astype(np.int32))
             for _ in range(2)] for _ in range(STEPS)]


RESNET_BOUNDS = [(False, 1e-3, 0.1, 2e-3), (True, 1e-2, 0.2, 1e-2)]


@pytest.mark.parametrize("fused,loss_bound,param_bound,stat_bound",
                         RESNET_BOUNDS)
def test_small_resnet_compiled_step_matches_jax(fused, loss_bound,
                                                param_bound, stat_bound):
    small_resnet_case(fused, loss_bound, param_bound, stat_bound)


def small_resnet_case(fused, loss_bound, param_bound, stat_bound,
                      **step_kw):
    """3 compiled steps of the small ResNet in both packages at np=2
    (``step_kw`` to both ``make_compiled_train_step`` calls) held to the
    module docstring's bounds."""
    flax_model = FlaxResNet(fused=fused, **KW)
    shapes = jax.eval_shape(lambda: flax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, HW, HW, 3)), train=False))
    rng = np.random.default_rng(1)
    variables = {"params": _values(shapes["params"], rng),
                 "batch_stats": _values(shapes["batch_stats"], rng)}
    batches = _resnet_batches()

    def jfn():
        def loss_fn(params, aux, batch):
            x, y = batch
            logits, mutated = flax_model.apply(
                {"params": params, "batch_stats": aux}, x, train=True,
                mutable=["batch_stats"])
            logp = jax.nn.log_softmax(logits)
            loss = -jnp.mean(jnp.take_along_axis(logp, y[:, None], -1))
            return loss, mutated["batch_stats"]
        step = jhvd.make_compiled_train_step(
            loss_fn, optax.sgd(LR, momentum=0.9), has_aux=True, **step_kw)
        state = step.init_state(variables["params"],
                                aux=variables["batch_stats"])
        losses = []
        for s in range(STEPS):
            state, loss = step(state, batches[s][jhvd.rank()])
            losses.append(float(loss))
        return losses, from_flax_variables(jax.tree_util.tree_map(
            np.asarray, {"params": state["params"],
                         "batch_stats": state["aux"]}))

    state0 = from_flax_variables(variables)

    def fn():
        with torch.device("meta"):
            model = ResNet([1, 1, 1, 1], num_classes=CLASSES,
                           num_filters=8, dtype=torch.float32, fused=fused)
        names = {k for k, _ in model.named_parameters()}
        params = {k: v for k, v in state0.items() if k in names}
        aux = {k: v for k, v in state0.items() if k not in names}

        def loss_fn(params, aux, batch):
            x, y = batch
            logits = torch.func.functional_call(model, {**params, **aux},
                                                (x,))
            return F.cross_entropy(logits, y.long()), aux

        step = thvd.make_compiled_train_step(
            loss_fn, sgd(LR, momentum=0.9), has_aux=True, **step_kw)
        state = step.init_state(params, aux=aux)
        losses = []
        for s in range(STEPS):
            state, loss = step(state, batches[s][thvd.rank()])
            losses.append(float(loss))
        out = {k: _np(v) for k, v in state["params"].items()}
        out.update({k: _np(v) for k, v in state["aux"].items()})
        return losses, out

    (jl, jstate), _ = jrun(jfn, 2)
    (tl, tstate), (tl1, tstate1) = trun(fn, 2)
    assert tl == tl1 and all(np.array_equal(tstate[k], tstate1[k])
                             for k in tstate)
    jstate = {k: _np(v) for k, v in jstate.items()}
    assert set(tstate) == set(jstate)
    stats = [k for k in tstate if k.endswith(("running_mean", "running_var"))]
    params = [k for k in tstate if k not in stats]
    # the change the 3 steps made, over all parameters
    moved = math.sqrt(
        sum(float(np.sum((tstate[k] - jstate[k]) ** 2)) for k in params)
        / sum(float(np.sum((jstate[k] - _np(state0[k])) ** 2))
              for k in params))
    worst_stat = max(stats, key=lambda k: _rel(tstate[k], jstate[k]))
    assert _rel(tl, jl) <= loss_bound, (tl, jl)
    assert moved <= param_bound, moved
    assert _rel(tstate[worst_stat], jstate[worst_stat]) <= stat_bound, \
        worst_stat


# ---------------------------------------------------------------------------
# what is not ported, and the 2-D surface that is


def _outcome(call):
    """``("ok", None)`` or ``(exception type name, message)``."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return type(e).__name__, str(e)
    return "ok", None


@pytest.mark.parametrize("case", [
    "sharded", "step_wire", "step_hint", "adasum", "algorithm",
    "topology_hint", "alltoall", "alltoall_fn", "integrity"])
def test_not_ported_raises_naming_its_item(case, monkeypatch):
    """Wire integrity digests stay refused, naming ROADMAP.md A14.  The
    2-D surface (ROADMAP.md A8) is ported: each call has the JAX
    package's outcome, constructed or refused with its ValueError (a hint
    that is no TopologyHint).  ``compiled_alltoall`` with a tuple hint is
    refused by the port's check; the JAX function fails on the tuple's
    missing ``key()`` before its constructor checks (AttributeError)."""
    def calls(mod, opt):
        loss = (lambda p, b: p["w"].sum())
        hint = mod.TopologyHint(axes=("dp", "tp"), sizes=(2, 2))
        return {
            "sharded": lambda: mod.make_compiled_train_step(
                loss, opt, sharded=True, topology_hint=("dp", "tp")),
            "step_wire": lambda: mod.make_compiled_train_step(
                loss, opt, sharded=True, wire_dtype="int8",
                wire_inner="bf16", topology_hint=hint),
            "step_hint": lambda: mod.make_compiled_train_step(
                loss, opt, wire_inner="bf16", topology_hint=hint),
            "adasum": lambda: mod.make_compiled_train_step(
                loss, opt, op=2, topology_hint=("dp", "tp")),
            "algorithm": lambda: mod.CompiledGroupedAllreduce(
                algorithm="torus"),
            "topology_hint": lambda: mod.CompiledGroupedAllreduce(
                topology_hint=hint),
            "alltoall": lambda: mod.CompiledAlltoall(
                topology_hint=("dp", "tp")),
            "alltoall_fn": lambda: mod.compiled_alltoall(
                np.ones(4, np.float32) if mod is jhvd else torch.ones(4),
                topology_hint=("dp", "tp")),
        }
    if case == "integrity":
        monkeypatch.setenv("HOROVOD_INTEGRITY", "1")
        with pytest.raises((NotImplementedError, RuntimeError)) as ei:
            trun(lambda: thvd.compiled_allreduce(torch.ones(2)), 2)
        err = ei.value
        while not isinstance(err, NotImplementedError) and err.__cause__:
            err = err.__cause__
        assert isinstance(err, NotImplementedError)
        assert "ROADMAP.md A14" in str(err)
        return
    got = _outcome(calls(thvd, sgd(0.1))[case])
    want = _outcome(calls(jhvd, optax.sgd(0.1))[case])
    if case == "alltoall_fn":
        assert want[0] == "AttributeError"
        want = ("ValueError", "topology_hint must be a TopologyHint")
    assert got == want, (case, got, want)
    if got[0] == "ok":
        obj = calls(thvd, sgd(0.1))[case]()
        ref = calls(jhvd, optax.sgd(0.1))[case]()
        for attr in ("algorithm", "wire_inner", "wire_dtype", "sharded"):
            if hasattr(ref, attr):
                assert getattr(obj, attr) == getattr(ref, attr), attr
        hint = getattr(ref, "topology_hint", None)
        assert (obj.topology_hint.key() if hint is not None else None) == \
            (hint.key() if hint is not None else None)


def test_unknown_algorithm_is_a_value_error():
    with pytest.raises(ValueError):
        thvd.CompiledGroupedAllreduce(algorithm="butterfly")
    assert thvd.CompiledGroupedAllreduce(algorithm="flat").algorithm == "flat"
