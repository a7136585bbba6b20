"""alltoall of horovod_tpu_torch against the JAX package: each package
runs the same user function through its own ``run(fn, np=...)`` (the port
on the CPU) on the same numpy-seeded inputs.

Covered: uniform, variable-split, 2-D and zero-split exchanges and the
dtype matrix; the fp16/bf16 wires; the int8/int4 wire with per-peer-slot
padding, with error feedback on over three calls (outputs, received
splits, every rank's residual, the engine's wire counters) and off; the
residual dropped on a layout change; a fused bucket of two exchanges;
``CompiledAlltoall`` on every wire with and without error feedback, its
ragged refusal and its per-rank ``reset_wire_state``; the autograd
Function's gradient; the fused allgather; and the process-group
executor's exchange over gloo against the stacked one.

Tolerance: bit for bit everywhere.  An exchange moves values without
arithmetic; the 16-bit wires are one rounding each way on both sides;
the int8/int4 codec is the numpy codec on both sides (the port's plain
codec is bit-equal to it, tests/test_torch_quantize.py), and the
residual is one f32 subtraction of exact values."""

import threading

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu
import horovod_tpu.torch as jax_torch
from horovod_tpu.common import basics as jax_basics
import horovod_tpu_torch
import horovod_tpu_torch.torch as port_torch
from horovod_tpu_torch.common import basics as port_basics
from horovod_tpu_torch.ops import compiled as port_compiled
from horovod_tpu_torch.ops.dist_ops import MeshExecutor

NP = 4
_TORCH = {"float32": torch.float32, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
          "bfloat16": torch.bfloat16, "float16": torch.float16}
_NP = {"bfloat16": ml_dtypes.bfloat16}


def _np_dtype(name):
    return _NP.get(name, np.dtype(name))


def _to_port(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _from_port(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.float().numpy().astype(ml_dtypes.bfloat16)
        return t.detach().numpy()
    return t


def _run(pkg, fn):
    if pkg == "jax":
        return horovod_tpu.run(lambda: fn(horovod_tpu, np.asarray,
                                          np.asarray), np=NP)
    return horovod_tpu_torch.run(lambda: fn(horovod_tpu_torch, _to_port,
                                            _from_port), np=NP,
                                 device="cpu")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype == ml_dtypes.bfloat16:
        a, b = a.astype(np.float32), b.astype(np.float32)
    np.testing.assert_array_equal(a, b)


def _both(fn):
    """fn(mod, to, frm) -> per-rank list of arrays; runs it in both
    packages and holds every element bit for bit."""
    want, got = _run("jax", fn), _run("port", fn)
    for w, g in zip(want, got):
        assert len(w) == len(g)
        for a, b in zip(w, g):
            _same(a, b)
    return got


def _splits(r):
    return [(r + j) % 3 for j in range(NP)]


# ---------------------------------------------------------------------------
# the plain exchange

def test_alltoall_uniform():
    def fn(mod, to, frm):
        r = mod.rank()
        x = np.array([r * 10 + j for j in range(NP)], dtype=np.int32)
        out, recv = mod.alltoall(to(x))
        return [frm(out), np.asarray(frm(recv)).astype(np.int32)]

    got = _both(fn)
    for r, (out, recv) in enumerate(got):
        np.testing.assert_array_equal(out, [j * 10 + r for j in range(NP)])
        np.testing.assert_array_equal(recv, np.ones(NP, np.int32))


@pytest.mark.parametrize("rest", [(), (3,), (2, 5)])
def test_alltoall_variable_splits(rest):
    def fn(mod, to, frm):
        r = mod.rank()
        sp = _splits(r)
        rng = np.random.default_rng(10 + r)
        x = rng.standard_normal((sum(sp),) + rest).astype(np.float32)
        out, recv = mod.alltoall(to(x), splits=sp, name="var")
        return [frm(out), np.asarray(frm(recv)).astype(np.int32)]

    got = _both(fn)
    for r, (out, recv) in enumerate(got):
        np.testing.assert_array_equal(recv, [_splits(j)[r]
                                             for j in range(NP)])
        assert out.shape == (sum(recv),) + rest


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "uint8", "bfloat16"])
def test_alltoall_dtype_matrix(dtype):
    def fn(mod, to, frm):
        r = mod.rank()
        x = (np.arange(3 * NP * 2).reshape(3 * NP, 2) + 7 * r) % 50
        out, recv = mod.alltoall(to(x.astype(_np_dtype(dtype))),
                                 name=f"dt.{dtype}")
        return [frm(out), np.asarray(frm(recv)).astype(np.int32)]

    got = _both(fn)
    assert got[0][0].dtype == _np_dtype(dtype)


def test_alltoall_zero_splits_and_refusals():
    """One nonzero destination per rank; the splits errors are
    ValueErrors before anything is enqueued, in both packages."""
    def fn(mod, to, frm):
        r = mod.rank()
        sp = [0] * NP
        sp[(r + 1) % NP] = 3
        out, recv = mod.alltoall(to(np.full((3, 2), float(r), np.float32)),
                                 splits=sp, name="zero")
        errs = []
        for bad in ([1] * NP, [-1] + [1] * NP, [0.5] * NP):
            try:
                mod.alltoall(to(np.zeros((3, 2), np.float32)), splits=bad)
            except ValueError:
                errs.append(1)
        return [frm(out), np.asarray(frm(recv)).astype(np.int32),
                np.array(errs)]

    got = _both(fn)
    for r, (out, recv, errs) in enumerate(got):
        assert errs.tolist() == [1, 1, 1]
        assert np.all(out == float((r - 1) % NP))


# ---------------------------------------------------------------------------
# the wires

def _counters(mod):
    e = (jax_basics if mod is horovod_tpu else port_basics).engine()
    return np.array([e.logical_wire_bytes, e.actual_wire_bytes,
                     e.quantized_bucket_runs])


def _residual(mod, r):
    e = (jax_basics if mod is horovod_tpu else port_basics).engine()
    res = e._a2a_ef.get((0, r))
    if res is None:
        return np.zeros(0, np.float32)
    return np.asarray(res) if mod is horovod_tpu else res.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wire", ["fp16", "bf16", "int8", "int4"])
def test_alltoall_wire_error_feedback_three_calls(wire, dtype):
    """Three exchanges of one layout (ragged splits, so every slot pads
    differently to its 256-blocks) with error feedback, then one without:
    outputs, received splits, each rank's residual after every call and
    rank 0's counter deltas."""
    barrier = threading.Barrier(NP)

    def fn(mod, to, frm):
        r = mod.rank()
        sp = [40 + 30 * ((r + j) % 3) for j in range(NP)]
        outs = []
        barrier.wait()
        before = _counters(mod)
        barrier.wait()
        for call in range(3):
            rng = np.random.default_rng(100 * call + r)
            x = (rng.standard_normal((sum(sp), 3)) * (call + 1)) \
                .astype(_np_dtype(dtype))
            out, recv = mod.alltoall(to(x), splits=sp, wire_dtype=wire,
                                     name=f"ef.{call}")
            barrier.wait()
            outs += [frm(out), np.asarray(frm(recv)).astype(np.int32),
                     _residual(mod, r)]
        barrier.wait()
        outs.append(_counters(mod) - before)
        out, _ = mod.alltoall(to(x), splits=sp, wire_dtype=wire,
                              error_feedback=False, name="ef.off")
        barrier.wait()
        outs += [frm(out), _residual(mod, r)]
        return outs

    got = _both(fn)
    delta = got[0][9]
    if wire in ("int8", "int4"):
        assert delta[2] == 3 and got[0][2].size > 0 and got[0][11].size == 0
        if dtype == "float32":
            assert delta[0] > delta[1]
    else:
        assert delta[2] == 0


def test_alltoall_ef_dropped_on_layout_change():
    def fn(mod, to, frm):
        r = mod.rank()
        a = np.linspace(-1.0, 1.0, NP * 512).astype(np.float32) + r
        mod.alltoall(to(a), wire_dtype="int8", name="lay.a")
        first = _residual(mod, r)
        b = np.linspace(-1.0, 1.0, NP * 1024).astype(np.float32) - r
        out, _ = mod.alltoall(to(b), wire_dtype="int8", name="lay.b")
        second = _residual(mod, r)
        assert first.size == a.size and second.size == b.size
        return [frm(out), first, second]

    _both(fn)


def test_alltoall_fused_bucket_of_two_exchanges():
    """Two exchanges submitted inside one held cycle fuse into one
    bucket (one wire, one set of per-slot scales over both)."""
    def fn(mod, to, frm):
        r = mod.rank()
        e = (jax_basics if mod is horovod_tpu else port_basics).engine()
        x = (np.arange(NP * 300, dtype=np.float32) * 0.01 - r) \
            .reshape(NP * 100, 3)
        y = (np.cos(np.arange(NP * 2 * 50, dtype=np.float32)) + r) \
            .reshape(NP * 2, 50)
        barrier.wait()
        with e.hold_cycles():
            hx = mod.alltoall_async(to(x), wire_dtype="int8", name="fx")
            hy = mod.alltoall_async(to(y), wire_dtype="int8", name="fy")
            barrier.wait()
        ox, _ = mod.synchronize(hx)
        oy, _ = mod.synchronize(hy)
        return [frm(ox), frm(oy), _residual(mod, r)]

    barrier = threading.Barrier(NP)
    got = _both(fn)
    assert got[0][2].size == NP * 512          # one slot of 2 blocks a peer


# ---------------------------------------------------------------------------
# CompiledAlltoall

@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("wire", [None, "bf16", "int8", "int4"])
def test_compiled_alltoall_wires(wire, ef):
    """Slots of 512 elements (whole blocks): the JAX package's quantized
    CompiledAlltoall raises on a slot that needs padding (its result is
    reshaped before the padding is cut off, horovod_tpu/ops/
    compiled.py:1545), so padded slots are held to the plain codec in
    :func:`test_compiled_alltoall_padded_slots`."""
    def fn(mod, to, frm):
        r = mod.rank()
        a2a = mod.CompiledAlltoall(name="c", wire_dtype=wire,
                                   error_feedback=ef, force_program=True)
        outs = []
        for call in range(3):
            rng = np.random.default_rng(7 * call + r)
            x = rng.standard_normal((NP * 8, 64)).astype(np.float32)
            outs.append(frm(a2a(to(x))))
        outs.append(np.array([a2a.last_logical_bytes, a2a.last_wire_bytes]))
        try:
            a2a(to(np.zeros((NP + 1, 2), np.float32)))
            outs.append(np.array(0))
        except ValueError:
            outs.append(np.array(1))
        a2a.reset_wire_state()
        return outs

    got = _both(fn)
    assert got[0][-1] == 1
    assert got[0][-2][0] == NP * 8 * 64 * 4


@pytest.mark.parametrize("ef", [False, True])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_compiled_alltoall_padded_slots(wire, ef):
    """Slots of 165 elements pad to one 256-block each: every received
    slot is bit for bit the numpy codec's decode of the sender's slot
    (plus, with error feedback, the sender's residual from the previous
    call, itself ``padded - decode(encode(padded))``)."""
    from horovod_tpu.ops import quantize as jqz

    enc = jqz.np_quantize_blockwise_int4 if wire == "int4" \
        else jqz.np_quantize_blockwise
    dec = jqz.np_dequantize_blockwise_int4 if wire == "int4" \
        else jqz.np_dequantize_blockwise

    def inputs(call, r):
        rng = np.random.default_rng(7 * call + r)
        return rng.standard_normal((NP * 5, 33)).astype(np.float32)

    def fn():
        r = horovod_tpu_torch.rank()
        a2a = horovod_tpu_torch.CompiledAlltoall(
            name="pad", wire_dtype=wire, error_feedback=ef)
        return [a2a(torch.from_numpy(inputs(c, r))).numpy()
                for c in range(3)]

    got = horovod_tpu_torch.run(fn, np=NP, device="cpu")
    res = [[np.zeros(256, np.float32) for _ in range(NP)]
           for _ in range(NP)]                         # [src][dst]
    for c in range(3):
        for dst in range(NP):
            want = []
            for src in range(NP):
                slot = np.zeros(256, np.float32)
                slot[:165] = inputs(c, src).reshape(NP, 165)[dst]
                if ef and c:
                    slot = slot + res[src][dst]
                q, sc, _ = enc(slot)
                d = dec(q, sc, 256)
                if ef:
                    res[src][dst] = slot - d
                want.append(d[:165])
            np.testing.assert_array_equal(
                got[dst][c], np.concatenate(want).reshape(NP * 5, 33))


def test_compiled_alltoall_reset_is_per_rank():
    """Each rank's residual is its own entry: one rank's reset drops its
    own and leaves its peers'."""
    def fn():
        r = horovod_tpu_torch.rank()
        a2a = horovod_tpu_torch.CompiledAlltoall(
            name="reset", wire_dtype="int8", error_feedback=True)
        a2a(torch.linspace(-1.0, 1.0, NP * 512) + r)
        keys = set(a2a._ef_keys)
        barrier.wait()
        assert len(keys) == 1
        held = [k for k in port_compiled._A2A_EF if k[2][1] == "reset"]
        assert len(held) == NP
        barrier.wait()
        if r == 0:
            a2a.reset_wire_state()
        barrier.wait()
        left = [k for k in port_compiled._A2A_EF if k[2][1] == "reset"]
        assert len(left) == NP - 1 and not (set(left) & keys if r == 0
                                           else not set(left) & keys)
        return True

    barrier = threading.Barrier(NP)
    assert all(horovod_tpu_torch.run(fn, np=NP, device="cpu"))


# ---------------------------------------------------------------------------
# autograd, fused allgather, the process-group executor

def test_horovod_alltoall_gradient():
    """Forward and backward of the autograd Function, with and without
    splits, against the JAX package's torch frontend."""
    def fn(mod):
        r = mod.rank()
        sp = _splits(r)
        x = torch.from_numpy(np.random.default_rng(r).standard_normal(
            (sum(sp), 3)).astype(np.float32)).requires_grad_()
        out, recv = mod.alltoall(x, splits=sp)
        w = torch.arange(out.numel(), dtype=torch.float32).view(out.shape)
        (out * w).sum().backward()
        y = torch.ones(NP * 2, requires_grad=True)
        z = mod.alltoall(y * (r + 1))
        (z * z).sum().backward()
        return [out.detach().numpy(), np.asarray(recv), x.grad.numpy(),
                y.grad.numpy()]

    want = horovod_tpu.run(lambda: fn(jax_torch), np=NP)
    got = horovod_tpu_torch.run(lambda: fn(port_torch), np=NP,
                                device="cpu")
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_allgather():
    barrier = threading.Barrier(NP)

    def fn(mod, to, frm):
        r = mod.rank()
        e = (jax_basics if mod is horovod_tpu else port_basics).engine()
        before = e.fused_allgather_runs
        barrier.wait()
        with e.hold_cycles():
            hs = [mod.allgather_async(
                to(np.full((1 + (r + i) % 3, 2 + i), 10 * r + i,
                           np.float32)), name=f"fag.{i}")
                for i in range(3)]
            barrier.wait()
        outs = [frm(mod.synchronize(h)) for h in hs]
        barrier.wait()
        outs.append(np.array(e.fused_allgather_runs - before))
        return outs

    got = _both(fn)
    assert got[0][-1] == 1


def test_executor_alltoall_process_group_matches_stacked():
    splits = [[1, 2, 0], [0, 1, 3], [2, 2, 1]]
    rows = [torch.arange(sum(splits[r]) * 2, dtype=torch.float32)
            .view(-1, 2) + 100 * r for r in range(3)]
    stacked, recv = MeshExecutor("cpu", 3).alltoall(rows, splits, (2,))
    store = dist.HashStore()
    out = [None] * 3

    def worker(r):
        pg = dist.ProcessGroupGloo(dist.PrefixStore("a2a", store), r, 3)
        ex = MeshExecutor("cpu", 3, group=pg)
        out[r] = ex.alltoall([rows[r]], splits, (2,))
        q = torch.arange(3 * 4, dtype=torch.int8) + r
        s = torch.tensor([0.5, 0.25, 2.0]) * (r + 1)
        out[r] += ex.alltoall_codes([q], [s])

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for r in range(3):
        assert torch.equal(out[r][0][0], stacked[r])
        assert out[r][1][0] == recv[r]
        q_res, s_res = out[r][2], out[r][3]
        want_q = torch.cat([torch.arange(4 * r, 4 * r + 4,
                                         dtype=torch.int8) + j
                            for j in range(3)])
        assert torch.equal(q_res[0], want_q)
        assert s_res[0].tolist() == [[0.5, 0.25, 2.0][r] * (j + 1)
                                     for j in range(3)]
