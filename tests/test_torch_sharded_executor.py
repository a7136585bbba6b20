"""horovod_tpu_torch.ops.dist_ops.MeshExecutor.reducescatter and
reducescatter_quantized against horovod_tpu.ops.xla_ops.MeshExecutor on
the same padded rows: every reduce op x dtype x pre/post scale, on the
int8 and int4 wires, with uneven first dimensions (d0 not a multiple of
the rank count, and d0 below it, so that some ranks' chunks are empty),
in stacked mode and in process-group mode (gloo, one rank thread per
rank over one HashStore; gloo has reduce_scatter for every op and dtype
in this torch, so the executor calls it directly).

Tolerance, tests/test_torch_executor.py's rule: exact at 2 ranks (a sum,
min, max or product of two values is one correctly rounded operation on
both sides, and every scaling is one multiply).  At 4 ranks a float sum
or product associates in another order on each side: the bound is
4 eps sum_i |x_i| (times the scale factors) for a sum, 4 eps |want| for a
product; the quantized wires sum the decoded rows in f32, so there the
bound is 4 eps_f32 (sum_i |decoded_i| scale + |want|).  Min, max and
integers stay exact at any rank count."""

import functools
import itertools
import math
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.core.message import ReduceOp as JaxReduceOp
from horovod_tpu.ops import quantize as jqz
from horovod_tpu.ops.xla_ops import MeshExecutor as JaxMeshExecutor
from horovod_tpu_torch.core.message import ReduceOp
from horovod_tpu_torch.core.sharded import chunk_sizes
from horovod_tpu_torch.ops import quantize_kernels as qk
from horovod_tpu_torch.ops.dist_ops import MeshExecutor

OPS = ["SUM", "AVERAGE", "MIN", "MAX", "PRODUCT"]
DTYPES = ["float32", "float64", "bfloat16", "int32"]
SCALES = [(1.0, 1.0), (0.5, 3.0)]
REST = (3,)
#: per rank count: an uneven d0 and one below the rank count
D0 = {2: (5, 1), 4: (7, 3)}
_EPS = {"float32": 2.0 ** -23, "float64": 2.0 ** -52, "bfloat16": 2.0 ** -7}
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16, "int32": torch.int32}


def _tensors(n_ranks, d0, dtype, op, seed):
    """Per rank a (d0, *REST) numpy array of ``dtype``."""
    rng = np.random.default_rng(seed)
    shape = (d0,) + REST
    if dtype == "int32":
        lo, hi = (-3, 4) if op == "PRODUCT" else (-50, 51)
        return [rng.integers(lo, hi, size=shape).astype(np.int32)
                for _ in range(n_ranks)]
    f = [rng.standard_normal(shape).astype(np.float32)
         for _ in range(n_ranks)]
    if dtype == "float64":
        return [x.astype(np.float64) for x in f]
    if dtype == "bfloat16":
        return [x.astype(ml_dtypes.bfloat16) for x in f]
    return f


def _padded(x, n_ranks):
    """The padded reducescatter layout, built here independently of the
    engine: destination rank j's rows at j * max_chunk * rest, zeros
    between."""
    chunks = chunk_sizes(x.shape[0], n_ranks)
    rest = math.prod(x.shape[1:])
    m = max(chunks) * rest
    flat = x.reshape(-1)
    buf = np.zeros(n_ranks * m, dtype=x.dtype)
    src = 0
    for j, c in enumerate(chunks):
        buf[j * m:j * m + c * rest] = flat[src:src + c * rest]
        src += c * rest
    return buf


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float64).numpy()
    return np.asarray(a).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _jax_executor(n_ranks):
    ex = JaxMeshExecutor([jax.devices("cpu")[0]] * n_ranks, n_ranks)
    assert not ex.shard_mode
    return ex


def _want(xs, n_ranks, op, pre, post):
    rows = [_padded(x, n_ranks) for x in xs]
    return _jax_executor(n_ranks).reducescatter(
        rows, xs[0].shape[0], REST, JaxReduceOp[op], pre, post)


def _terms(xs, n_ranks, pos):
    """sum_i |x_i| over rank ``pos``'s chunk."""
    chunks = chunk_sizes(xs[0].shape[0], n_ranks)
    start = sum(chunks[:pos])
    return sum(np.abs(_f64(x))[start:start + chunks[pos]] for x in xs)


def _check(got, want, xs, n_ranks, pos, dtype, op, pre, post):
    assert tuple(got.shape) == tuple(np.shape(want))
    g, w = _f64(got), _f64(want)
    if n_ranks == 2 or dtype == "int32" or op in ("MIN", "MAX"):
        np.testing.assert_array_equal(g, w)
        return
    if op == "PRODUCT":
        bound = 4 * _EPS[dtype] * np.abs(w)
    else:
        scale = abs(pre * post) / (n_ranks if op == "AVERAGE" else 1)
        bound = 4 * _EPS[dtype] * scale * _terms(xs, n_ranks, pos)
    np.testing.assert_array_less(np.abs(g - w), bound + 1e-300)


CASES = list(itertools.product(OPS, DTYPES, SCALES))


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("op,dtype,scales", CASES)
def test_stacked_reducescatter_matches_jax(op, dtype, scales, n_ranks):
    pre, post = scales
    ex = MeshExecutor("cpu", n_ranks)
    for k, d0 in enumerate(D0[n_ranks]):
        xs = _tensors(n_ranks, d0, dtype, op, seed=10 * n_ranks + k)
        want = _want(xs, n_ranks, op, pre, post)
        rows = [_to_torch(_padded(x, n_ranks)) for x in xs]
        got = ex.reducescatter(rows, d0, REST, ReduceOp[op], pre, post)
        assert len(got) == n_ranks
        for pos, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == _TORCH[dtype]
            _check(g, w, xs, n_ranks, pos, dtype, op, pre, post)
        # each rank's result is its own memory
        others = [g.clone() for g in got[1:]]
        got[0].add_(1)
        assert all(torch.equal(a, b) for a, b in zip(got[1:], others))


def _gloo_run(n_ranks, body):
    """Run ``body(executor, rank)`` on ``n_ranks`` threads, each holding
    its own gloo ProcessGroup over one HashStore."""
    store = dist.HashStore()
    out, errs = [None] * n_ranks, []

    def worker(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("rs", store), r,
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
def test_process_group_reducescatter_matches_jax(n_ranks):
    """Every op x dtype x scale x d0 case through gloo, in one group per
    rank count (group setup dominates the cost)."""
    cases = [(op, dt, sc, d0, _tensors(n_ranks, d0, dt, op,
                                       seed=100 + 10 * n_ranks + k))
             for op, dt, sc in CASES for k, d0 in enumerate(D0[n_ranks])]

    def body(ex, r):
        assert ex.local_positions == [r] and not ex.stacked
        return [ex.reducescatter([_to_torch(_padded(xs[r], n_ranks))], d0,
                                 REST, ReduceOp[op], *sc)[0]
                for op, dt, sc, d0, xs in cases]

    per_rank = _gloo_run(n_ranks, body)
    for i, (op, dtype, (pre, post), _d0, xs) in enumerate(cases):
        want = _want(xs, n_ranks, op, pre, post)
        for r in range(n_ranks):
            _check(per_rank[r][i], want[r], xs, n_ranks, r, dtype, op, pre,
                   post)


# ---------------------------------------------------------------------------
# the quantized wires

QCASES = [("int8", "SUM", 1.0, 1.0), ("int8", "AVERAGE", 0.5, 3.0),
          ("int4", "SUM", 1.0, 1.0), ("int4", "AVERAGE", 0.5, 3.0)]


def _q_inputs(n_ranks, d0, wire, seed):
    """Per rank: the padded f32 row, the JAX codec's codes and scales,
    and the port's (the plain codec on the CPU)."""
    xs = _tensors(n_ranks, d0, "float32", "SUM", seed)
    rows = [_padded(x * 3, n_ranks) for x in xs]
    enc = jqz.np_quantize_blockwise_int4 if wire == "int4" \
        else jqz.np_quantize_blockwise
    jax_codes = [enc(r)[:2] for r in rows]
    port_codes = [qk.encode(torch.from_numpy(r), wire) for r in rows]
    return rows, jax_codes, port_codes


def _q_check(got, want, rows, wire, n_ranks, pos, d0, op, pre, post):
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(np.shape(want))
    g, w = _f64(got), _f64(want)
    if n_ranks == 2:
        np.testing.assert_array_equal(g, w)
        return
    chunks = chunk_sizes(d0, n_ranks)
    m = max(chunks) * math.prod(REST)
    dec = [np.abs(jqz.np_fake_quantize_wire(r, wire)).astype(np.float64)
           for r in rows]
    terms = sum(d[pos * m:pos * m + chunks[pos] * math.prod(REST)]
                for d in dec).reshape(w.shape)
    scale = abs(pre * post) / (n_ranks if op == "AVERAGE" else 1)
    bound = 4 * 2.0 ** -24 * (terms * scale + np.abs(w))
    np.testing.assert_array_less(np.abs(g - w), bound + 1e-30)


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("wire,op,pre,post", QCASES)
def test_reducescatter_quantized_matches_jax(wire, op, pre, post, n_ranks):
    bits = 4 if wire == "int4" else 8
    ex = MeshExecutor("cpu", n_ranks)
    for k, d0 in enumerate(D0[n_ranks] + (300,)):
        rows, jax_codes, port_codes = _q_inputs(n_ranks, d0, wire,
                                                seed=200 + 10 * n_ranks + k)
        for (jq, js), (pq, ps) in zip(jax_codes, port_codes):
            np.testing.assert_array_equal(pq.numpy(), jq)
            np.testing.assert_array_equal(ps.numpy(), js)
        npad = port_codes[0][1].numel() * jqz.BLOCK
        want = _jax_executor(n_ranks).reducescatter_quantized(
            [c[0] for c in jax_codes], [c[1] for c in jax_codes], d0, REST,
            JaxReduceOp[op], pre, post, nbits=bits, n_elems=npad)
        got = ex.reducescatter_quantized(
            [c[0] for c in port_codes], [c[1] for c in port_codes], d0, REST,
            ReduceOp[op], pre, post, nbits=bits, n_elems=npad)
        for pos, (g, w) in enumerate(zip(got, want)):
            _q_check(g, w, rows, wire, n_ranks, pos, d0, op, pre, post)

        def body(pg_ex, r):
            return pg_ex.reducescatter_quantized(
                [port_codes[r][0]], [port_codes[r][1]], d0, REST,
                ReduceOp[op], pre, post, nbits=bits, n_elems=npad)[0]

        # process-group mode on the first d0 (gloo group setup is slow)
        if k == 0:
            for pos, g in enumerate(_gloo_run(n_ranks, body)):
                _q_check(g, want[pos], rows, wire, n_ranks, pos, d0, op,
                         pre, post)


def test_reducescatter_refuses_what_the_wire_cannot_sum():
    ex = MeshExecutor("cpu", 2)
    q, s = qk.encode(torch.ones(512), "int8")
    with pytest.raises(ValueError, match="Sum/Average"):
        ex.reducescatter_quantized([q, q], [s, s], 4, (128,), ReduceOp.MAX)
    with pytest.raises(ValueError, match="unsupported"):
        ex.reducescatter([torch.ones(4)] * 2, 2, (2,), ReduceOp.ADASUM)


@pytest.mark.parametrize("n,dp", [(0, 3), (5, 2), (7, 4), (3, 4), (8, 8)])
def test_chunk_sizes_match_jax(n, dp):
    assert MeshExecutor.chunk_sizes(n, dp) == JaxMeshExecutor.chunk_sizes(
        n, dp) == chunk_sizes(n, dp)
