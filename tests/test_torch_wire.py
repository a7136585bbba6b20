"""The quantized and 16-bit allreduce wires of horovod_tpu_torch (the
engine's ``_dispatch_allreduce`` and ``MeshExecutor.allreduce_quantized``)
against the JAX package, on the same numpy-seeded inputs.

Both packages run the same user function through their own
``run(fn, np=...)`` (the port on the CPU): ``allreduce`` and
``grouped_allreduce`` with ``wire_dtype`` in {int8, int4, fp16, bf16,
f32}, Sum and Average with pre/post scale.

Tolerance: bit for bit at np=2 (every step is one correctly rounded
operation on both sides: the codec, whose equality with the numpy codec
tests/test_torch_quantize.py holds, a two-term sum, one multiply, one
cast).  At np=4 the only freedom is the order of the sum over ranks (the
port sums in rank order, XLA in its own, and on the CPU it rounds every
partial sum of a 16-bit wire to 16 bits): the bound is 4 eps sum_r
|term_r| (times the scale factors), eps the unit roundoff of the
accumulating type (f32 for the quantized wires, where the terms are the
decoded rows; the wire dtype for a 16-bit wire, plus four of its eps of
the result for the last cast).  The wire-byte counters are integers and
equal exactly."""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu
from horovod_tpu.common import basics as jax_basics
from horovod_tpu.core.message import ReduceOp as JaxReduceOp
from horovod_tpu.ops import quantize as jqz
from horovod_tpu.ops.xla_ops import MeshExecutor as JaxMeshExecutor
import horovod_tpu_torch
from horovod_tpu_torch.common import basics as port_basics
from horovod_tpu_torch.core.message import ReduceOp
from horovod_tpu_torch.ops import quantize_kernels as qk
from horovod_tpu_torch.ops.dist_ops import MeshExecutor

WIRES = ["int8", "int4", "fp16", "bf16", "f32"]
SCALED = [("SUM", 1.0, 1.0), ("AVERAGE", 0.5, 3.0)]
GROUP = [(7,), (513,), (2, 129)]
_EPS = {"int8": 2.0 ** -24, "int4": 2.0 ** -24, "f32": 2.0 ** -24,
        "fp16": 2.0 ** -11, "bf16": 2.0 ** -8}


def _inputs(r):
    rng = np.random.default_rng(40 + r)
    single = (rng.standard_normal(1000) * 3).astype(np.float32)
    group = [rng.standard_normal(s).astype(np.float32) for s in GROUP]
    return single, group


def _counters(mod_basics):
    e = mod_basics.engine()
    return np.array([e.logical_wire_bytes, e.actual_wire_bytes,
                     e.quantized_bucket_runs])


def _job(mod, mod_basics, to_pkg, from_pkg, wire, op, pre, post, np_):
    """One allreduce and one grouped allreduce per rank; returns per
    rank (results, counter deltas read by rank 0)."""
    barrier = threading.Barrier(np_)

    def fn():
        r = mod.rank()
        single, group = _inputs(r)
        before = _counters(mod_basics)
        barrier.wait()
        kw = dict(op=getattr(mod, op.title()), prescale_factor=pre,
                  postscale_factor=post, wire_dtype=wire)
        a = mod.allreduce(to_pkg(single), name="a", **kw)
        g = mod.grouped_allreduce([to_pkg(x) for x in group], name="g", **kw)
        barrier.wait()
        delta = _counters(mod_basics) - before
        return [from_pkg(a)] + [from_pkg(x) for x in g], delta

    if mod is horovod_tpu:
        return mod.run(fn, np=np_)
    return mod.run(fn, np=np_, device="cpu")


def _jax_job(*args):
    return _job(horovod_tpu, jax_basics, lambda x: x, np.asarray, *args)


def _port_job(*args):
    return _job(horovod_tpu_torch, port_basics, torch.from_numpy,
                lambda t: t.numpy(), *args)


def _terms(wire, rows):
    """|term| of each rank, summed: the decoded rows of a quantized
    wire, the rows themselves otherwise."""
    if wire in ("int8", "int4"):
        rows = [np.abs(jqz.np_fake_quantize_wire(r, wire)) for r in rows]
    return sum(np.abs(r) for r in rows)


@pytest.mark.parametrize("np_", [2, 4])
@pytest.mark.parametrize("op,pre,post", SCALED)
@pytest.mark.parametrize("wire", WIRES)
def test_allreduce_wire_matches_jax(wire, op, pre, post, np_):
    want = _jax_job(wire, op, pre, post, np_)
    got = _port_job(wire, op, pre, post, np_)
    # rank 0's counter deltas: the JAX engine's byte counts exactly
    np.testing.assert_array_equal(got[0][1], want[0][1])
    quantized = wire in ("int8", "int4")
    assert got[0][1][2] == (2 if quantized else 0)
    inputs = [_inputs(r) for r in range(np_)]
    scale = abs(pre * post) / (np_ if op == "AVERAGE" else 1)
    for r in range(np_):
        for i, (g, w) in enumerate(zip(got[r][0], want[r][0])):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            if np_ == 2:
                np.testing.assert_array_equal(g, w, err_msg=f"{r} {i}")
                continue
            if i == 0:
                rows = [x[0] for x in inputs]
            else:
                # a grouped member's blocks run over the fused bucket
                flat = [np.concatenate([m.ravel() for m in x[1]])
                        for x in inputs]
                off = sum(int(np.prod(s)) for s in GROUP[:i - 1])
                n = int(np.prod(GROUP[i - 1]))
                terms = _terms(wire, flat)[off:off + n].reshape(g.shape)
                rows = None
            if rows is not None:
                terms = _terms(wire, rows)
            bound = 4 * _EPS[wire] * (terms * scale + np.abs(w))
            np.testing.assert_array_less(np.abs(g - w), bound + 1e-30)
    # every rank holds the same result
    for r in range(1, np_):
        for a, b in zip(got[0][0], got[r][0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("wire,floor", [("int8", 3.9), ("int4", 7.5)])
def test_wire_ratio(wire, floor):
    def fn():
        x = torch.from_numpy(_inputs(horovod_tpu_torch.rank())[0])
        big = torch.cat([x] * 66)                      # 66,000 elements
        before = _counters(port_basics)
        horovod_tpu_torch.allreduce(big, name="big", wire_dtype=wire)
        return _counters(port_basics) - before

    logical, actual, runs = horovod_tpu_torch.run(fn, np=2,
                                                  device="cpu")[0]
    assert runs == 1 and logical == 66_000 * 4
    assert logical / actual > floor


def test_nonlinear_ops_ship_full_width():
    def fn():
        r = horovod_tpu_torch.rank()
        x = torch.from_numpy(_inputs(r)[0])
        before = _counters(port_basics)
        out = [horovod_tpu_torch.allreduce(x, name=f"m{op}", op=op,
                                           wire_dtype="int8")
               for op in (horovod_tpu_torch.Max, horovod_tpu_torch.Min)]
        return out, _counters(port_basics) - before

    res = horovod_tpu_torch.run(fn, np=2, device="cpu")
    rows = [torch.from_numpy(_inputs(r)[0]) for r in range(2)]
    (mx, mn), delta = res[0]
    assert torch.equal(mx, torch.maximum(*rows))
    assert torch.equal(mn, torch.minimum(*rows))
    assert delta[2] == 0 and delta[0] == delta[1] == 2 * 1000 * 4


def _default_wire_job(mod, mod_basics, to_pkg, from_pkg):
    def fn():
        x = to_pkg(_inputs(mod.rank())[0])
        before = _counters(mod_basics)
        explicit = mod.allreduce(x, name="exp32", op=mod.Sum,
                                 wire_dtype="f32")
        mid = _counters(mod_basics)
        default = mod.allreduce(x, name="dflt", op=mod.Sum)
        return (from_pkg(explicit), from_pkg(default), mid - before,
                _counters(mod_basics) - mid)
    if mod is horovod_tpu:
        return mod.run(fn, np=2)
    return mod.run(fn, np=2, device="cpu")


def test_explicit_f32_overrides_config_default(monkeypatch):
    monkeypatch.setenv("HOROVOD_WIRE_DTYPE", "int8")
    want = _default_wire_job(horovod_tpu, jax_basics, lambda x: x,
                             np.asarray)
    got = _default_wire_job(horovod_tpu_torch, port_basics,
                            torch.from_numpy, lambda t: t.numpy())
    exact = _inputs(0)[0] + _inputs(1)[0]
    for r in range(2):
        explicit, default, d_exp, d_dflt = got[r]
        np.testing.assert_array_equal(explicit, exact)
        np.testing.assert_array_equal(default, want[r][1])
        assert not np.array_equal(default, exact)
        assert d_exp[2] == 0 and d_dflt[2] == 1
        np.testing.assert_array_equal(d_exp, want[r][2])
        np.testing.assert_array_equal(d_dflt, want[r][3])


def test_config_reads_outer_over_shorthand(monkeypatch):
    from horovod_tpu_torch.common.env import Config
    monkeypatch.setenv("HOROVOD_WIRE_DTYPE", "bf16")
    assert Config().wire_dtype == "bf16"
    monkeypatch.setenv("HOROVOD_WIRE_OUTER", "I4")
    assert Config().wire_dtype == "int4"
    monkeypatch.setenv("HOROVOD_WIRE_OUTER", "int3")
    with pytest.raises(ValueError):
        Config()


def test_wire_mismatch_raises_on_every_rank():
    def fn():
        r = horovod_tpu_torch.rank()
        try:
            horovod_tpu_torch.allreduce(torch.ones(300), name="w",
                                        wire_dtype="int8" if r else None)
        except horovod_tpu_torch.TensorShapeMismatchError as exc:
            return str(exc)
        return "no error"

    out = horovod_tpu_torch.run(fn, np=2, device="cpu")
    assert all("Mismatched wire dtypes" in m for m in out), out
    with pytest.raises(RuntimeError, match="unknown wire dtype"):
        horovod_tpu_torch.run(
            lambda: horovod_tpu_torch.allreduce(torch.ones(3),
                                                wire_dtype="int3"),
            np=1, device="cpu")


# (name, wire) submitted in this order while the negotiation loop is held
MIXED = [("a", "int8"), ("b", "int8"), ("c", None), ("d", "int4"),
         ("e", "bf16"), ("f", "int8")]


def _drive_mixed(mod, mod_basics, to_pkg, init_kwargs):
    mod.init(**init_kwargs)
    try:
        eng = mod_basics.engine()
        batches = []
        orig = eng._fuse

        def spy(ps, entries):
            buckets = orig(ps, entries)
            batches.append([[e.key.split("|")[1] for e in b]
                            for b in buckets])
            return buckets
        eng._fuse = spy
        handles = [None, None]

        def rank_fn(r):
            mod_basics.bind_rank(r)
            rng = np.random.default_rng(70 + r)
            handles[r] = [mod.allreduce_async(
                to_pkg(rng.standard_normal(300 + 37 * i).astype(np.float32)),
                name=name, op=mod.Sum, wire_dtype=wire)
                for i, (name, wire) in enumerate(MIXED)]

        with eng.hold_cycles():
            threads = [threading.Thread(target=rank_fn, args=(r,))
                       for r in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        results = [[np.asarray(mod.synchronize(h)) for h in hs]
                   for hs in handles]
        return batches, results, _counters(mod_basics)
    finally:
        mod.shutdown()


def test_mixed_wires_never_share_a_bucket():
    jb, jr, jc = _drive_mixed(horovod_tpu, jax_basics, lambda x: x,
                              {"num_ranks": 2})
    pb, pr, pc = _drive_mixed(horovod_tpu_torch, port_basics,
                              torch.from_numpy,
                              {"num_ranks": 2, "device": "cpu"})
    assert pb == jb == [[["allreduce.a", "allreduce.b"], ["allreduce.c"],
                         ["allreduce.d"], ["allreduce.e"], ["allreduce.f"]]]
    np.testing.assert_array_equal(pc, jc)
    for r in range(2):
        for g, w in zip(pr[r], jr[r]):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the executor alone

def _coded_rows(n_ranks, bits, n, seed):
    rng = np.random.default_rng(seed)
    rows = [(rng.standard_normal(n) * 2).astype(np.float32)
            for _ in range(n_ranks)]
    enc = jqz.np_quantize_blockwise if bits == 8 \
        else jqz.np_quantize_blockwise_int4
    coded = [enc(r)[:2] for r in rows]
    port = [qk.quantize_blockwise(torch.from_numpy(r)) if bits == 8 else
            qk.quantize_blockwise_int4(torch.from_numpy(r)) for r in rows]
    return coded, port


def _gloo_run(n_ranks, body):
    store = dist.HashStore()
    out, errs = [None] * n_ranks, []

    def worker(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("q", store), r,
                                       n_ranks)
            out[r] = body(MeshExecutor("cpu", n_ranks, group=pg), r)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errs:
        raise errs[0]
    return out


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_executor_quantized_stacked_and_gloo_match_jax(bits, n_ranks):
    """The stacked executor against the JAX executor (bit for bit at 2
    ranks, the sum-order bound at 4), and the process-group executor
    (gloo rank threads) against the stacked one, bit for bit."""
    n = 3 * 256 + 77
    coded, port = _coded_rows(n_ranks, bits, n, seed=bits + n_ranks)
    for (q, s), (qn, sn) in zip(port, coded):
        assert np.array_equal(q.numpy(), qn)
    npad = coded[0][1].size * 256
    jax_ex = JaxMeshExecutor([__import__("jax").devices("cpu")[0]] * n_ranks,
                             n_ranks)
    want = jax_ex.allreduce_quantized(
        [c[0] for c in coded], [c[1] for c in coded], JaxReduceOp.AVERAGE,
        0.5, 3.0, nbits=bits, n_elems=npad)[0]
    stacked = MeshExecutor("cpu", n_ranks).allreduce_quantized(
        [p[0] for p in port], [p[1] for p in port], ReduceOp.AVERAGE,
        0.5, 3.0, nbits=bits)
    assert len(stacked) == n_ranks and stacked[0].shape == (npad,)
    got = stacked[0].numpy()
    if n_ranks == 2:
        np.testing.assert_array_equal(got, want)
    else:
        terms = sum(np.abs(qk.decode(q, s, npad, bits).numpy())
                    for q, s in port)
        np.testing.assert_array_less(
            np.abs(got - want), 4 * 2.0 ** -24 * terms * 1.5 / n_ranks
            + 1e-30)
    gloo = _gloo_run(n_ranks, lambda ex, r: ex.allreduce_quantized(
        [port[r][0]], [port[r][1]], ReduceOp.AVERAGE, 0.5, 3.0,
        nbits=bits, n_elems=n)[0])
    for r in range(n_ranks):
        assert torch.equal(gloo[r], stacked[0][:n])
    with pytest.raises(ValueError):
        MeshExecutor("cpu", n_ranks).allreduce_quantized(
            [p[0] for p in port], [p[1] for p in port], ReduceOp.MAX)


def test_bf16_scales_are_exact_on_the_wire():
    """The process-group executor ships each scale as its bf16 bytes:
    exact, because the codec's scales are bf16-rounded already."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(5000)
                         .astype(np.float32) * 1e-3)
    _, s = qk.quantize_blockwise(x)
    assert torch.equal(s.to(torch.bfloat16).float(), s)
    assert (torch.from_numpy(s.to(torch.bfloat16).view(torch.int16)
                             .numpy().view(ml_dtypes.bfloat16)
                             .astype(np.float32)) == s).all()
