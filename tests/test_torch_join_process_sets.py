"""barrier, join, allgather_object and process sets of horovod_tpu_torch
against the JAX package: each package runs the same user function through
its own ``run(fn, np=...)`` (the port on the CPU) on the same inputs.

Covered: the barrier; join with uneven batches (a joined rank is a zero
contributor), repeated join rounds, join inside a process set with an
entry submitted before the join, the join value, and the refusal of an
alltoall that a joined rank did not submit; ``allgather_object``;
process-set allreduce with sets registered at ``init``; every collective
on a set added at run time; removal while peers are still in flight, and
with an unsynchronized async handle outstanding; the global set and
unknown ids.

Tolerance: bit for bit.  The sums here are of small integers (exact in
every dtype) or of one term and zeros."""

import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu
import horovod_tpu_torch
from horovod_tpu_torch.common import basics as port_basics

NP = 4


def _to_port(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _from_port(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.float().numpy().astype(ml_dtypes.bfloat16)
        return t.numpy()
    return t


def _run(pkg, fn, np_=NP, **init):
    if pkg == "jax":
        if init:
            horovod_tpu.init(num_ranks=np_, **init)
        try:
            return horovod_tpu.run(
                lambda: fn(horovod_tpu, np.asarray, np.asarray), np=np_)
        finally:
            if horovod_tpu.is_initialized():
                horovod_tpu.shutdown()
    if init:
        horovod_tpu_torch.init(device="cpu", num_ranks=np_, **init)
    try:
        return horovod_tpu_torch.run(
            lambda: fn(horovod_tpu_torch, _to_port, _from_port), np=np_,
            device="cpu")
    finally:
        if horovod_tpu_torch.is_initialized():
            horovod_tpu_torch.shutdown()


def _same(want, got):
    """Nested lists/tuples of arrays, ints and objects, equal bit for
    bit."""
    if isinstance(want, (list, tuple)):
        assert len(want) == len(got)
        for w, g in zip(want, got):
            _same(w, g)
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        w, g = np.asarray(want), np.asarray(got)
        assert w.shape == g.shape and w.dtype == g.dtype, (w, g)
        if w.dtype == ml_dtypes.bfloat16:
            w, g = w.astype(np.float32), g.astype(np.float32)
        np.testing.assert_array_equal(w, g)
    else:
        assert want == got, (want, got)


def _both(fn, np_=NP, **init):
    want = _run("jax", fn, np_, **init)
    got = _run("port", fn, np_, **init)
    _same(want, got)
    return got


# ---------------------------------------------------------------------------
# barrier, join

def test_barrier():
    def fn(mod, to, frm):
        r = mod.rank()
        time.sleep(0.03 * r)
        mod.barrier()
        return time.monotonic()

    times = _run("port", fn)
    assert max(times) - min(times) < 0.5
    _both(lambda mod, to, frm: mod.barrier())


def test_join_uneven_batches():
    """Rank 0 has 2 batches, the others 4: after rank 0 joins, the sums
    take it as zeros; join returns the last rank to join."""
    def fn(mod, to, frm):
        r = mod.rank()
        outs = [frm(mod.allreduce(to(np.full(3, 1.0 + r, np.float32)),
                                  op=mod.Sum, name=f"b{i}"))
                for i in range(2 if r == 0 else 4)]
        if r == 1:
            time.sleep(0.2)      # rank 1 is the last to join
        return outs, mod.join()

    got = _both(fn)
    for r, (outs, last) in enumerate(got):
        assert last == 1
        np.testing.assert_array_equal(outs[0], np.full(3, 10.0))
        if r:
            np.testing.assert_array_equal(outs[3], np.full(3, 9.0))


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32",
                                   "bfloat16"])
def test_join_matrix(dtype):
    """Rank 3 joins at once; Average divides by the set size, so the
    joined rank's zero is in the mean."""
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)

    def fn(mod, to, frm):
        r = mod.rank()
        if r == 3:
            return None, mod.join() in range(NP)
        x = (np.arange(4) + r + 1).astype(dt)
        s = frm(mod.allreduce(to(x), op=mod.Sum, name=f"j.{dtype}"))
        a = frm(mod.allreduce(to(x * 4), op=mod.Average,
                              name=f"ja.{dtype}")) \
            if dtype != "int32" else None
        return [s, a], mod.join() in range(NP)

    _both(fn)


def test_repeated_join_rounds():
    def fn(mod, to, frm):
        first = mod.join()
        out = frm(mod.allreduce(to(np.ones(2, np.float32)), op=mod.Sum,
                                name="between_joins"))
        return first >= 0, out, mod.join() >= 0

    got = _both(fn)
    for ok1, out, ok2 in got:
        assert ok1 and ok2
        np.testing.assert_array_equal(out, np.full(2, float(NP)))


def test_join_refuses_alltoall():
    """An op that does not support join fails on the ranks that
    submitted it when a peer has joined."""
    def fn(mod, to, frm):
        r = mod.rank()
        if r == 0:
            mod.join()
            return "joined"
        try:
            mod.alltoall(to(np.zeros(NP, np.float32)), name="a2a.join")
        except Exception as exc:     # noqa: BLE001 — the typed refusal
            msg = str(exc)
        mod.join()
        return "does not support join" in msg

    got = _both(fn)
    assert got == ["joined"] + [True] * (NP - 1)


def test_join_resolves_after_pending_entries_drain():
    """An async allreduce submitted BEFORE its rank joins executes with
    the joined peer as zeros, and the join waits for it."""
    def fn(mod, to, frm):
        r = mod.rank()
        ps = mod.add_process_set([0, 1])
        h = None
        if r == 0:
            h = mod.allreduce_async(to(np.ones(2, np.float32)), op=mod.Sum,
                                    process_set=ps, name="prejoin")
            mod.join(process_set=ps)
        elif r == 1:
            mod.join(process_set=ps)
        assert mod.remove_process_set(ps)
        return frm(mod.synchronize(h)) if h is not None else None

    got = _both(fn)
    np.testing.assert_array_equal(got[0], np.ones(2, np.float32))


def test_allgather_object():
    def fn(mod, to, frm):
        r = mod.rank()
        return mod.allgather_object(
            {"r": r, "pad": "x" * (10 ** r)} if r < 3 else "tiny")

    got = _both(fn)
    assert got[0][3] == "tiny" and got[0][2]["r"] == 2


# ---------------------------------------------------------------------------
# process sets

def test_process_set_allreduce_registered_at_init():
    def fn(mod, to, frm):
        r = mod.rank()
        ps = sets[0] if r % 2 == 0 else sets[1]
        out = frm(mod.allreduce(to(np.full(4, float(r), np.float32)),
                                op=mod.Sum, process_set=ps))
        return out, ps.size(), ps.rank(), ps.included()

    for pkg in ("jax", "port"):
        mod = horovod_tpu if pkg == "jax" else horovod_tpu_torch
        sets = [mod.ProcessSet([0, 2]), mod.ProcessSet([1, 3])]
        got = _run(pkg, fn, process_sets=sets)
        for r, (out, sz, psr, inc) in enumerate(got):
            np.testing.assert_array_equal(
                out, np.full(4, 2.0 if r % 2 == 0 else 4.0, np.float32))
            assert (sz, psr, inc) == (2, r // 2, True)


@pytest.mark.parametrize("op_name", ["allreduce", "grouped_allreduce",
                                     "allgather", "broadcast",
                                     "reducescatter", "alltoall"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_process_set_matrix(op_name, dtype):
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)

    def fn(mod, to, frm):
        ps = mod.add_process_set([1, 2])
        try:
            r = mod.rank()
            if r not in (1, 2):
                return None
            x = (np.arange(4) * (r + 1)).astype(dt)
            name = f"ps.{op_name}.{dtype}"
            if op_name == "allreduce":
                return frm(mod.allreduce(to(x), op=mod.Sum, name=name,
                                         process_set=ps))
            if op_name == "grouped_allreduce":
                return [frm(t) for t in mod.grouped_allreduce(
                    [to(x), to(x[:2])], op=mod.Sum, name=name,
                    process_set=ps)]
            if op_name == "allgather":
                return frm(mod.allgather(to(x.reshape(2, 2)), name=name,
                                         process_set=ps))
            if op_name == "broadcast":
                return frm(mod.broadcast(to(x), root_rank=2, name=name,
                                         process_set=ps))
            if op_name == "reducescatter":
                return frm(mod.reducescatter(to(x.reshape(2, 2)),
                                             op=mod.Sum, name=name,
                                             process_set=ps))
            out, recv = mod.alltoall(to(x), name=name, process_set=ps)
            return [frm(out), np.asarray(frm(recv)).astype(np.int32)]
        finally:
            mod.remove_process_set(ps)

    _both(fn)


def test_remove_process_set_waits_for_inflight_peers():
    """Ranks outside the set vote for removal at once; the members are
    still inside their allreduce on it, which completes."""
    def fn(mod, to, frm):
        r = mod.rank()
        ps = mod.add_process_set([0, 1])
        out = None
        if r in (0, 1):
            time.sleep(0.1)
            out = frm(mod.allreduce(to(np.ones(2, np.float32)), op=mod.Sum,
                                    process_set=ps, name="inflight"))
        return out, mod.remove_process_set(ps)

    got = _both(fn)
    assert all(ok for _, ok in got)
    np.testing.assert_array_equal(got[0][0], np.full(2, 2.0, np.float32))


def test_remove_process_set_drains_async_handles():
    def fn(mod, to, frm):
        r = mod.rank()
        ps = mod.add_process_set([0, 1, 2])
        h = None
        if r < 3:
            h = mod.allreduce_async(to(np.ones(2, np.float32) * (r + 1)),
                                    op=mod.Sum, process_set=ps,
                                    name="drain_me")
        ok = mod.remove_process_set(ps)
        return ok, (frm(mod.synchronize(h)) if h is not None else None)

    got = _both(fn)
    np.testing.assert_array_equal(got[0][1], np.full(2, 6.0, np.float32))


def test_add_remove_process_set_ids():
    """Ids, re-registration, the global set, and that a removed set's
    executor goes with it."""
    def fn(mod, to, frm):
        ps = mod.add_process_set([0, 1, 3])
        again = mod.add_process_set(mod.ProcessSet([0, 1, 3]))
        pid = ps.process_set_id
        assert again.process_set_id == pid
        ok = mod.remove_process_set(ps)
        return pid, ok, mod.remove_process_set(mod.global_process_set)

    got = _both(fn)
    assert got[0] == (1, True, False)


def test_removed_set_leaves_the_engine():
    def fn():
        ps = horovod_tpu_torch.add_process_set([0, 2])
        eng = port_basics.engine()
        assert ps.process_set_id in eng.process_sets
        barrier.wait()
        horovod_tpu_torch.remove_process_set(ps)
        return sorted(eng.process_sets)

    barrier = threading.Barrier(NP)
    assert horovod_tpu_torch.run(fn, np=NP, device="cpu") == [[0]] * NP
