"""The hierarchical and torus allreduces of horovod_tpu_torch (the
engine's ``_run_allreduce_2d``, ``MeshExecutor.allreduce_2d``, the
compiled reducer's 2-D program and the decomposed sharded step) against
the JAX package's live engine, on the same numpy-seeded inputs: the cases
of ``tests/test_op_matrix.py`` (algorithm x op x wire pair x path, the
cross-byte budget, the heterogeneous fallback, a single-host torus, the
mismatch refusals, a process set that does not factor, the dp x tp
``TopologyHint`` and the per-hop error feedback), run through both.

Both packages run 4 rank threads for the whole module.  The JAX engine
runs one of the 8 virtual CPU devices per rank (tests/conftest.py), its
shard mode, the only layout where it decomposes; the port's stacked
executor stands for that layout (ROADMAP.md C).  A two-host layout is
patched onto both engines' ``topology`` ([0, 0, 1, 1]), as
``test_op_matrix.py``'s fixture does.

Tolerances:

* f32 at 2 x 2, every wire pair, both paths: bit for bit.  Each sum of the
  grid adds two terms (one correctly rounded operation in any order), the
  16-bit casts and the shared-scale codec are the same functions on both
  sides (the integer sums are exact), and the scales are one multiply;
* f64, f16 and bf16 tensors: the engine path bit for bit; the compiled
  path bit for bit where it does not scale, else within one ulp of the
  dtype at the result (16-bit: the JAX program casts a buffer's decoded
  sum to the dtype before it scales it, the port scales the f32 sum once
  through B1), and for f64 one f32 ulp at the result plus one at the sum
  of the scaled terms' magnitudes (the JAX program scales an f64 buffer
  in f32, before and after the sum; the port scales it in f64);
* the byte counters are integers and equal the JAX engine's exactly;
* every result also sits within ``test_op_matrix.py``'s ``WIRE_ATOL`` of
  the f64 sum.
"""

import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu import telemetry as jtel
from horovod_tpu.common import basics as jb
from horovod_tpu.common.exceptions import \
    TensorShapeMismatchError as JaxMismatch
from horovod_tpu.common.topology import Topology as JTopology
from horovod_tpu_torch.common import basics as tb
from horovod_tpu_torch.common.exceptions import TensorShapeMismatchError
from horovod_tpu_torch.common.topology import Topology
from horovod_tpu_torch.ops import compiled as tc
from horovod_tpu_torch.parallel.train import sgd

NP = 4
WIRE_ATOL = {None: 1e-5, "fp16": 3e-2, "bf16": 3e-1, "int8": 2e-1,
             "int4": 1.6}
HINT = ((("dp", "tp"), (2, 2)))


@pytest.fixture(scope="module")
def engines():
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.run(lambda: None, np=NP, keep_alive=True)
    thvd.run(lambda: None, np=NP, device="cpu", keep_alive=True)
    yield jb.engine(), tb.engine()
    thvd.shutdown()
    jhvd.shutdown()


@pytest.fixture()
def hosts(engines):
    """Patch a host map onto both engines' topology for one test."""
    je, te = engines
    old = je.topology, te.topology

    def set_map(host_of_rank):
        je.topology = JTopology(size=NP, host_of_rank=list(host_of_rank))
        te.topology = Topology(size=NP, host_of_rank=list(host_of_rank))
        return je, te
    yield set_map
    je.topology, te.topology = old


def _to_torch(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(x)


def _to_np(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _both(fn):
    """``fn(mod, to_pkg, from_pkg)`` per rank under both packages:
    (JAX results, port results)."""
    j = jhvd.run(lambda: fn(jhvd, lambda x: x, np.asarray), np=NP)
    t = thvd.run(lambda: fn(thvd, _to_torch, _to_np), np=NP)
    return j, t


def _input(rank, n=1000, dtype=np.float32):
    return np.random.default_rng(rank).standard_normal(n).astype(dtype)


def _allreduce(mod, to, back, tag, path, x, **kw):
    if path == "compiled":
        return back(mod.compiled_allreduce(to(x), **kw))
    return back(mod.allreduce(to(x), name=f"m2d.{tag}", **kw))


def _assert_bitwise(j, t):
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), \
            np.abs(a.astype(np.float64) - b.astype(np.float64)).max()


def _counters(eng):
    return (eng.logical_wire_bytes, eng.actual_wire_bytes,
            eng.cross_wire_bytes, eng.quantized_bucket_runs)


# ---------------------------------------------------------------------------
# algorithm x op x wire x path, and the per-hop wire pairs

ALGO_CASES = [(a, o, w, p)
              for a in ("hierarchical", "torus")
              for o in ("Sum", "Average")
              for w in (None, "fp16", "int8")
              for p in ("engine", "compiled")]


@pytest.mark.parametrize(
    "algo,op,wire,path", ALGO_CASES,
    ids=[f"{a}-{o}-{w or 'f32'}-{p}" for a, o, w, p in ALGO_CASES])
def test_algorithm_matrix(hosts, algo, op, wire, path):
    je, te = hosts([0, 0, 1, 1])
    runs0 = dict(je.algo_runs), dict(te.algo_runs)
    c0 = _counters(je), _counters(te)
    tag = f"algo.{algo}.{op}.{wire}.{path}"

    def fn(mod, to, back):
        x = _input(mod.rank())
        return _allreduce(mod, to, back, tag, path, x, op=getattr(mod, op),
                          algorithm=algo, wire_dtype=wire)

    j, t = _both(fn)
    _assert_bitwise(j, t)
    xs = np.stack([_input(r).astype(np.float64) for r in range(NP)])
    want = xs.sum(0) if op == "Sum" else xs.mean(0)
    assert np.allclose(t[0], want, atol=WIRE_ATOL[wire])
    if path == "engine":
        # the decomposition really ran, on both sides, with equal bytes
        assert te.algo_runs.get(algo, 0) == runs0[1].get(algo, 0) + 1
        assert je.algo_runs.get(algo, 0) == runs0[0].get(algo, 0) + 1
        dj = np.subtract(_counters(je), c0[0])
        dt = np.subtract(_counters(te), c0[1])
        assert list(dt) == list(dj), (dt, dj)


PAIR_CASES = [(iw, ow, a, p)
              for iw, ow in ((None, "int8"), (None, "int4"),
                             ("bf16", "int8"), ("bf16", "int4"),
                             ("bf16", None), ("fp16", "fp16"))
              for a in ("hierarchical", "torus")
              for p in ("engine", "compiled")]


@pytest.mark.parametrize(
    "iw,ow,algo,path", PAIR_CASES,
    ids=[f"{iw or 'f32'}:{ow or 'f32'}-{a}-{p}" for iw, ow, a, p in
         PAIR_CASES])
def test_wire_pair_matrix(hosts, iw, ow, algo, path):
    je, te = hosts([0, 0, 1, 1])
    runs0 = te.algo_runs.get(algo, 0)
    tag = f"pair.{iw}.{ow}.{algo}.{path}"

    def fn(mod, to, back):
        x = _input(mod.rank())
        return _allreduce(mod, to, back, tag, path, x, op=mod.Sum,
                          algorithm=algo, wire_dtype=ow or "f32",
                          wire_inner=iw or "f32")

    j, t = _both(fn)
    _assert_bitwise(j, t)
    want = np.stack([_input(r).astype(np.float64) for r in range(NP)]) \
        .sum(0)
    assert np.allclose(t[0], want,
                       atol=WIRE_ATOL[ow] + (5e-2 if iw else 0.0))
    if path == "engine":
        assert te.algo_runs.get(algo, 0) == runs0 + 1


DTYPE_CASES = [(d, o, w, iw, p, s)
               for d in ("float64", "float16", "bfloat16")
               for o in ("Sum", "Average")
               for w, iw in ((None, None), ("int8", None),
                             ("int4", "bf16"), (None, "bf16"))
               for p in ("engine", "compiled")
               for s in ((1.0, 1.0), (0.5, 3.0))]


@pytest.mark.parametrize(
    "dtype,op,wire,iw,path,scales", DTYPE_CASES,
    ids=[f"{d}-{o}-{iw or 'f32'}:{w or 'f32'}-{p}-{s[0]}x{s[1]}"
         for d, o, w, iw, p, s in DTYPE_CASES])
def test_dtype_matrix(hosts, dtype, op, wire, iw, path, scales):
    hosts([0, 0, 1, 1])
    npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    pre, post = scales
    tag = f"dt.{dtype}.{op}.{wire}.{iw}.{path}.{pre}"

    def fn(mod, to, back):
        x = _input(mod.rank(), 600, npdt)
        return _allreduce(mod, to, back, tag, path, x, op=getattr(mod, op),
                          algorithm="torus", wire_dtype=wire, wire_inner=iw,
                          prescale_factor=pre, postscale_factor=post)

    j, t = _both(fn)
    scaled = op == "Average" or pre != 1.0 or post != 1.0
    if path == "engine" or not scaled:
        _assert_bitwise(j, t)
        return
    # one ulp of the scaling's format (f32 for an f64 buffer in the JAX
    # program, the dtype for a 16-bit one) at the result and at the sum of
    # the scaled terms (the JAX program rounds each pre-scaled f64 term
    # to f32)
    ulp = {"float64": 2.0 ** -23, "float16": 2.0 ** -10,
           "bfloat16": 2.0 ** -7}[dtype]
    mag = pre * post / (NP if op == "Average" else 1)
    terms = np.abs(np.stack([_input(r, 600, npdt).astype(np.float64)
                             for r in range(NP)])).sum(0) * mag
    for a, b in zip(j, t):
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        bound = ulp * (np.abs(b64) + (terms if dtype == "float64" else 0))
        assert np.all(np.abs(a64 - b64) <= bound), np.abs(a64 - b64).max()


# ---------------------------------------------------------------------------
# the byte accounting


def test_hierarchical_cross_byte_budget(hosts):
    """test_op_matrix.py's budget, on both engines: hierarchical moves at
    most 1/local_size of the logical bytes across the hosts, the int8
    outer wire a further >= 1.9x fewer, and a flat reduction pays its
    whole wire there.  The counters equal the JAX engine's."""
    je, te = hosts([0, 0, 1, 1])

    def run_one(wire, name, algorithm="hierarchical"):
        before = _counters(je), _counters(te)

        def fn(mod, to, back):
            x = np.ones(1 << 14, np.float32) * (mod.rank() + 1)
            mod.allreduce(to(x), op=mod.Sum, name=name,
                          algorithm=algorithm, wire_dtype=wire)
            return True
        _both(fn)
        dj = np.subtract(_counters(je), before[0])
        dt = np.subtract(_counters(te), before[1])
        assert list(dt) == list(dj), (wire, dt, dj)
        return int(dt[0]), int(dt[2])

    dl, dc = run_one(None, "m2d.budget.f32")
    assert dl > 0 and dc <= dl / 2 * 1.01 + 64, (dc, dl)
    _, dc8 = run_one("int8", "m2d.budget.int8")
    assert dc8 <= dc / 1.9, (dc8, dc)
    dlf, dcf = run_one(None, "m2d.budget.flat", algorithm=None)
    assert dcf == dlf


def _jax_hop(h):
    fam = jtel.metrics().get(jtel.WIRE_HOP_BYTES_FAMILY, {})
    return sum(s.get("value", 0.0) for s in fam.get("samples", [])
               if s.get("labels", {}).get("hop") == h)


def test_per_hop_cross_bytes_split(hosts):
    """test_op_matrix.py's hop split: with the (bf16, int4) pair the
    inner hop moves the payload twice at bf16 width and the cross hop the
    quantized shard; int4's cross bytes undercut int8's.  Both hops equal
    the JAX engine's telemetry family."""
    je, te = hosts([0, 0, 1, 1])
    n = 1 << 14

    def port_hop(h):
        return sum(v for (hop, _w), v in te.hop_wire_bytes.items()
                   if hop == h)

    def run_one(wire, name):
        before = [(_jax_hop(h), port_hop(h)) for h in ("inner", "cross")]

        def fn(mod, to, back):
            mod.allreduce(to(np.ones(n, np.float32)), op=mod.Sum,
                          name=name, algorithm="hierarchical",
                          wire_dtype=wire, wire_inner="bf16")
            return True
        _both(fn)
        out = []
        for h, (bj, bt) in zip(("inner", "cross"), before):
            dj, dt = _jax_hop(h) - bj, port_hop(h) - bt
            assert dt == dj, (h, dt, dj)
            out.append(dt)
        return out

    di8, dc8 = run_one("int8", "m2d.hop.i8")
    di4, dc4 = run_one("int4", "m2d.hop.i4")
    assert di8 == di4 == 2 * n * 2
    assert 0 < dc4 < dc8 <= n * 2 + 256 and dc4 <= n + 256
    assert te.hop_wire_bytes[("cross", "int4")] >= dc4


# ---------------------------------------------------------------------------
# fallbacks and refusals


def test_heterogeneous_host_slots_fall_back_flat(hosts):
    """3 + 1 slots: hierarchical cannot factor (the reference's
    is_homogeneous gate): the request runs flat, exactly, and counts as
    flat on both engines."""
    je, te = hosts([0, 0, 0, 1])
    flat0 = je.algo_runs.get("flat", 0), te.algo_runs.get("flat", 0)
    hier0 = te.algo_runs.get("hierarchical", 0)

    def fn(mod, to, back):
        x = np.full(64, float(mod.rank() + 1), np.float32)
        return back(mod.allreduce(to(x), op=mod.Sum, name="m2d.hetero",
                                  algorithm="hierarchical"))
    j, t = _both(fn)
    _assert_bitwise(j, t)
    assert np.array_equal(t[0], np.full(64, 10.0, np.float32))
    assert je.algo_runs.get("flat", 0) == flat0[0] + 1
    assert te.algo_runs.get("flat", 0) == flat0[1] + 1
    assert te.algo_runs.get("hierarchical", 0) == hier0


def test_torus_on_single_host(engines):
    """A composite set factors into the near-square grid on one host;
    no byte crosses hosts."""
    je, te = engines
    t0, c0 = te.algo_runs.get("torus", 0), te.cross_wire_bytes

    def fn(mod, to, back):
        x = np.arange(130, dtype=np.float64) * (mod.rank() + 1)
        return back(mod.allreduce(to(x), op=mod.Sum, name="m2d.torus1h",
                                  algorithm="torus"))
    j, t = _both(fn)
    _assert_bitwise(j, t)
    np.testing.assert_allclose(t[0], np.arange(130) * 10.0)
    assert te.algo_runs.get("torus", 0) == t0 + 1
    assert te.cross_wire_bytes == c0


@pytest.mark.parametrize("field", ["algorithm", "wire_inner"])
def test_mismatch_fails_loudly(engines, field):
    """Ranks that disagree on the algorithm or on the inner-hop wire
    would run different collectives against each other: negotiation
    refuses, in both packages."""
    def fn(mod, to, back):
        kw = {"algorithm": "torus" if mod.rank() == 0 else "flat"} \
            if field == "algorithm" else \
            {"algorithm": "torus", "wire_dtype": "int8",
             "wire_inner": "bf16" if mod.rank() == 0 else "f32"}
        try:
            mod.allreduce(to(np.ones(8, np.float32)), op=mod.Sum,
                          name=f"m2d.mix.{field}", **kw)
            return False
        except (TensorShapeMismatchError, JaxMismatch):
            return True
    j, t = _both(fn)
    assert all(j) and all(t)


def test_quantized_inner_wire_rejected(engines):
    def fn(mod, to, back):
        try:
            mod.allreduce(to(np.ones(8, np.float32)), op=mod.Sum,
                          name="m2d.badiw", wire_inner="int4")
            return False
        except ValueError:
            return True
    j, t = _both(fn)
    assert all(j) and all(t)


def test_process_set_that_does_not_factor(hosts):
    """Ranks 1 and 2 sit on different hosts, one a host: no grid, so the
    request runs flat over the sub-set and stays exact."""
    hosts([0, 0, 1, 1])

    def fn(mod, to, back):
        ps = mod.add_process_set([1, 2])
        try:
            if mod.rank() in (1, 2):
                x = np.ones(32, np.float32) * (mod.rank() + 1)
                return back(mod.allreduce(
                    to(x), op=mod.Sum, process_set=ps, name="m2d.psalgo",
                    algorithm="hierarchical"))
            return None
        finally:
            mod.remove_process_set(ps)
    j, t = _both(fn)
    assert np.array_equal(t[1], np.full(32, 5.0, np.float32))
    _assert_bitwise([j[1], j[2]], [t[1], t[2]])


def test_distributed_optimizer_takes_the_config_algorithm(engines):
    """``DistributedOptimizer`` has no algorithm argument: the engine
    latches the process-wide default (``HOROVOD_TORUS_ALLREDUCE`` sets
    ``Config.algorithm``) into every gradient's request at submit."""
    import horovod_tpu_torch.torch as hvd_torch

    je, te = engines
    te.config.algorithm = "torus"
    t0 = te.algo_runs.get("torus", 0)
    try:
        def fn():
            model = torch.nn.Linear(8, 4)
            rng = np.random.default_rng(7)
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.from_numpy(rng.standard_normal(
                        tuple(p.shape)).astype(np.float32)))
            opt = hvd_torch.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.1),
                named_parameters=model.named_parameters())
            x = torch.from_numpy(_input(thvd.rank(), 16).reshape(2, 8))
            for _ in range(2):
                opt.zero_grad()
                model(x).pow(2).sum().backward()
                opt.step()
            return [p.detach().clone() for p in model.parameters()]
        out = thvd.run(fn, np=NP)
    finally:
        te.config.algorithm = None
    assert te.algo_runs.get("torus", 0) >= t0 + 2
    for ps in out[1:]:
        for a, b in zip(out[0], ps):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the compiled path's hint, alltoall and error feedback


def test_compiled_torus_dp_tp_mesh_hint(engines):
    """An explicit dp x tp hint pins the decomposition, rides the cache
    key, and moves 1/tp of the bytes across dp, in both packages."""
    def fn(mod, to, back):
        red = mod.CompiledGroupedAllreduce(
            op=mod.Sum, force_program=True, name="m2d.dp_tp",
            topology_hint=mod.TopologyHint(axes=HINT[0], sizes=HINT[1]))
        out = back(red([to(_input(mod.rank(), 512))])[0])
        return out, red.last_algorithm, red.last_cross_bytes, \
            red.last_logical_bytes
    j, t = _both(fn)
    _assert_bitwise([o[0] for o in j], [o[0] for o in t])
    for o in t:
        assert o[1] == "torus" and o[2] * 2 == o[3]
    assert [o[1:] for o in t] == [o[1:] for o in j]


def test_topology_hint_is_checked(engines):
    with pytest.raises(ValueError, match="TopologyHint"):
        tc.TopologyHint(axes=("a", "b", "c"), sizes=(1, 2, 2))
    with pytest.raises(ValueError, match="TopologyHint"):
        tc.TopologyHint(axes=("a",), sizes=(4,))
    h = tc.TopologyHint(axes=("pp", "dp", "tp"), sizes=(2, 2, 2),
                        pp_stage=1)
    assert (h.reduce_axes, h.outer, h.inner, h.pp, h.key()) == \
        (("dp", "tp"), 2, 2, 2, (("pp", "dp", "tp"), (2, 2, 2), 1))

    def fn():
        red = thvd.CompiledGroupedAllreduce(
            op=thvd.Sum, name="m2d.badhint",
            topology_hint=thvd.TopologyHint(("dp", "tp"), (4, 2)))
        try:
            red([torch.ones(8)])
            return False
        except ValueError as e:
            return "do not factor" in str(e)
    assert all(thvd.run(fn, np=NP))


def test_compiled_alltoall_hint_splits_bytes_by_hop(engines):
    """The exchange stays single-hop (its result is the flat exchange's,
    bit for bit the JAX package's); a hint splits its bytes: (inner - 1)
    / R to the inner-axis peers, (R - inner) / R across."""
    def fn(mod, to, back):
        a2a = mod.CompiledAlltoall(
            name="m2d.a2a", topology_hint=mod.TopologyHint(HINT[0],
                                                           HINT[1]))
        x = _input(mod.rank(), 4 * 96).reshape(4 * 24, 4)
        out = back(a2a(to(x)))
        return out, getattr(a2a, "last_hop_bytes", None), \
            a2a.last_logical_bytes
    j, t = _both(fn)
    _assert_bitwise([o[0] for o in j], [o[0] for o in t])
    for _out, hops, logical in t:
        assert hops == {"inner": (logical // 4, logical // 4),
                        "cross": (logical // 2, logical // 2)}


def test_per_hop_error_feedback_and_reset(hosts):
    """int4 outer wire with error feedback over the torus: the residual
    lives on each rank's 1/inner shard, is carried across calls (the
    results equal the JAX package's three calls in a row bit for bit) and
    ``reset_wire_state`` drops it."""
    hosts([0, 0, 1, 1])
    bar = threading.Barrier(NP)

    def fn(mod, to, back):
        red = mod.CompiledGroupedAllreduce(
            op=mod.Sum, wire_dtype="int4", algorithm="torus",
            error_feedback=True, force_program=True, name="m2d.ef")
        x = _input(mod.rank(), 600)
        outs = [back(red([to(x)])[0]) for _ in range(3)]
        if mod is thvd:
            shapes = sorted(tuple(r.shape) for r in red._residuals.values())
            bar.wait(timeout=60)
            red.reset_wire_state()
            return outs, shapes, len(red._residuals)
        return outs, None, None
    j, t = _both(fn)
    for a, b in zip(j, t):
        _assert_bitwise(a[0], b[0])
    for _outs, shapes, left in t:
        assert shapes == [(300,)] and left == 0
    # the residual moved the later calls
    assert not np.array_equal(t[0][0][0], t[0][0][1])


# ---------------------------------------------------------------------------
# the decomposed sharded step

SHAPES = {"a": (300,), "b": (37,), "c": (5, 130)}


def _params():
    rng = np.random.RandomState(3)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _batch(rank, step):
    rng = np.random.RandomState(1000 * step + rank)
    return {k: (rng.randn(*s) * (1 + rank)).astype(np.float32)
            for k, s in SHAPES.items()}


STEP_CASES = [(w, iw, op) for w, iw in ((None, None), ("bf16", None),
                                        ("fp16", None), ("int8", None),
                                        ("int8", "bf16"), ("int4", "bf16"))
              for op in ("Average", "Sum")]


@pytest.mark.parametrize(
    "wire,iw,op", STEP_CASES,
    ids=[f"{iw or 'f32'}:{w or 'f32'}-{op}" for w, iw, op in STEP_CASES])
def test_sharded_step_under_a_hint(engines, wire, iw, op):
    """``make_compiled_train_step(sharded=True, topology_hint=...)`` on a
    loss whose gradient is its batch, plain SGD at lr 1, 3 steps: the
    parameters and the 1/inner-shard residuals bit for bit the JAX
    package's (every sum of the 2 x 2 grid adds two terms)."""
    def jfn():
        def loss(params, batch):
            return sum(jnp.sum(params[k] * batch[k]) for k in SHAPES)
        step = jhvd.make_compiled_train_step(
            loss, optax.sgd(1.0), op=getattr(jhvd, op), sharded=True,
            wire_dtype=wire, wire_inner=iw,
            topology_hint=jhvd.TopologyHint(HINT[0], HINT[1]))
        state = step.init_state({k: jnp.asarray(v)
                                 for k, v in _params().items()})
        for s in range(3):
            state, _ = step(state, _batch(jhvd.rank(), s))
        ef = {k: np.asarray(v) for k, v in state.get("grad_ef", {}).items()}
        return {k: np.asarray(v) for k, v in state["params"].items()}, ef

    def tfn():
        def loss(params, batch):
            return sum((params[k] * batch[k]).sum() for k in SHAPES)
        step = thvd.make_compiled_train_step(
            loss, sgd(1.0), op=getattr(thvd, op), sharded=True,
            wire_dtype=wire, wire_inner=iw,
            topology_hint=thvd.TopologyHint(HINT[0], HINT[1]))
        state = step.init_state(_params())
        for s in range(3):
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                    _batch(thvd.rank(), s).items()})
        ef = {k: v.numpy() for k, v in state.get("grad_ef", {}).items()}
        return {k: v.detach().numpy() for k, v in state["params"].items()}, \
            ef

    j = jhvd.run(jfn, np=NP)
    t = thvd.run(tfn, np=NP)
    for (jp, jef), (tp, tef) in zip(j, t):
        for k in SHAPES:
            assert np.array_equal(tp[k], jp[k]), \
                (k, np.abs(tp[k] - jp[k]).max())
        assert sorted(tef) == sorted(jef)
        # the JAX package's global residual is laid out inner-axis major
        # (its dim-0 sharding over (tp, dp)): position p = y * 2 + x is its
        # row x * 2 + y; the port keeps a row per position
        rows = [(p % 2) * 2 + p // 2 for p in range(NP)]
        for k in jef:
            assert tef[k].shape == jef[k].shape
            assert np.array_equal(tef[k], jef[k][rows]), k


def _optax_slots(opt_state):
    """``{slot: leaf tree}`` of an optax state's ``trace`` field."""
    import jax
    out = {}
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: hasattr(x, "_fields")):
        if "trace" in getattr(st, "_fields", ()):
            out["trace"] = st.trace
    return out


@pytest.mark.parametrize("wire", [None, "int8"])
def test_carrier_resumes_a_jax_run_under_a_hint(engines, wire):
    """``sharded_state_from_jax`` takes the JAX package's decomposed
    sharded state after 2 steps (its global flat ``trace`` leaves and
    residuals laid out inner-axis major) onto the positions that own
    those slices; 2 more steps reach the JAX package's residuals bit for
    bit and its parameters within test_torch_compiled_sharded.py's carrier
    bound (optax's momentum may round as an FMA)."""
    import jax

    hint = HINT

    def jfn():
        def loss(p, b):
            return sum(jnp.sum(p[k] * b[k]) for k in SHAPES)
        step = jhvd.make_compiled_train_step(
            loss, optax.sgd(0.5, momentum=0.9), sharded=True,
            wire_dtype=wire, topology_hint=jhvd.TopologyHint(*hint))
        state = step.init_state({k: jnp.asarray(v)
                                 for k, v in _params().items()})
        mid = None
        for s in range(4):
            state, _ = step(state, _batch(jhvd.rank(), s))
            if s == 1:
                mid = jax.tree_util.tree_map(np.asarray, (
                    state["params"], _optax_slots(state["opt_state"]),
                    state.get("grad_ef", {})))
        return mid, jax.tree_util.tree_map(np.asarray, (
            state["params"], state.get("grad_ef", {})))

    (mid, (want_p, want_ef)) = jhvd.run(jfn, np=NP)[0]

    def tfn():
        def loss(p, b):
            return sum((p[k] * b[k]).sum() for k in SHAPES)
        step = thvd.make_compiled_train_step(
            loss, sgd(0.5, momentum=0.9), sharded=True, wire_dtype=wire,
            topology_hint=thvd.TopologyHint(*hint))
        params, slots, ef = mid
        state = tc.sharded_state_from_jax(step, params, slots, grad_ef=ef)
        for s in range(2, 4):
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                    _batch(thvd.rank(), s).items()})
        return ({k: v.detach().numpy() for k, v in state["params"].items()},
                {k: v.numpy() for k, v in state.get("grad_ef", {}).items()})

    rows = [(p % 2) * 2 + p // 2 for p in range(NP)]
    for got_p, got_ef in thvd.run(tfn, np=NP):
        assert set(got_ef) == set(want_ef)
        for k in SHAPES:
            np.testing.assert_allclose(
                got_p[k], want_p[k], rtol=1e-6,
                atol=1e-6 * np.abs(want_p[k]).max(), err_msg=k)
        for k in want_ef:
            assert np.array_equal(got_ef[k], want_ef[k][rows]), k
