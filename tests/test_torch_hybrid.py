"""The hybrid layout on the CPU: several rank threads per process, across
processes (horovod_tpu_torch/ops/dist_ops.py's executor with
``proc_positions``; the launcher's ``ranks_per_proc``), held against the
JAX package's jobs and the port's stacked executor:

(i)   ``MeshExecutor`` over a gloo group whose processes (threads here)
      host runs of 2+2, 2+1, 1+2+1 and 3 positions: every collective
      equal to the stacked executor's on the same rows, and a broadcast
      that leaves its input rows untouched (a repaired fault: over a
      process group the non-root process's own tensor was overwritten by
      ``hvd.broadcast``, and the result aliased it).
(ii)  ``test_hybrid_procs_with_rank_threads``: np=4 as 2 processes x 2
      rank threads (tests/test_runner.py:824), and
      ``test_heterogeneous_host_slots``: ``ranks_per_proc="host"`` with
      ``-H localhost:2,127.0.0.1:1`` at np=3 (tests/test_runner.py:880):
      the same worker under both packages' launchers, its collective
      matrix compared rank by rank.
(iii) the compiled path at 2 x 2: ``make_compiled_train_step`` dense
      (SGD momentum) and sharded (AdamW, f32 and int8 wires),
      ``CompiledGroupedAllreduce`` and ``CompiledAlltoall``, one worker
      under both packages' launchers (optax on the JAX side), then the
      port's job against the same calls at 4 rank threads in one
      process.

Tolerances.  Every value of the matrix is exact in f32 (small integers,
power-of-two scales) but two: a Sum of seeded normal values and the
int8 wire's decode-and-sum, held to rtol 1e-6 (a few ulp): at 2 x 2 the
port sums ``(r0 + r1) + (r2 + r3)``, the local rows first, where a
stacked reduction or the JAX package's program may associate otherwise
(ROADMAP.md C, "Ring order at np > 2").  The compiled steps' losses and
parameters after 3 steps and the f32 reducer are held to the JAX
package's job at rtol 1e-5 with atol 1e-6 (measured: at most 4.8e-7
apart; the two packages' backward passes and optimizers may differ in
the last bits, and a four-rank sum associates otherwise), the
exchanges and the int8 reducer bit for bit; and to the port's stacked
run at the same bound, its f32 exchange bit for bit.  Every launch has
a start_timeout.
"""

import os
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.runner.proc_run import launch_procs as jax_launch_procs
from horovod_tpu_torch.core.message import ReduceOp
from horovod_tpu_torch.ops.dist_ops import MeshExecutor
from horovod_tpu_torch.runner.proc_run import (
    launch_procs as torch_launch_procs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
RTOL = 1e-6

# -- (i) the executor over simulated processes --------------------------------


def _layout(counts):
    out, acc = [], 0
    for n in counts:
        out.append(list(range(acc, acc + n)))
        acc += n
    return out


def _run_group(counts, body):
    """``body(ex)`` in one thread per simulated process, each with a gloo
    group member hosting its run of positions; returns the results in
    process order."""
    store = dist.HashStore()
    G, R = len(counts), sum(counts)
    out, errs = [None] * G, []

    def run(g):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("h", store), g, G)
            ex = MeshExecutor("cpu", R, group=pg,
                              proc_positions=_layout(counts))
            out[g] = (ex.local_positions, body(ex))
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errs.append(exc)
    threads = [threading.Thread(target=run, args=(g,)) for g in range(G)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errs:
        raise errs[0]
    return out


def _rows(R):
    rng = np.random.default_rng(5)
    return [torch.from_numpy(rng.integers(-6, 6, 12).astype(np.float32))
            for _ in range(R)]


@pytest.mark.parametrize("counts", [[2, 2], [2, 1], [1, 2, 1], [3]])
def test_executor_matches_stacked(counts):
    R = sum(counts)
    rows = _rows(R)
    splits = [[(s + d) % 3 for d in range(R)] for s in range(R)]
    m = 3

    def calls(ex, positions):
        local = [rows[p].clone() for p in positions]
        q = [torch.from_numpy(np.full(256, p + 1, np.int8))
             for p in positions]
        s = [torch.full((1,), 0.5 * (p + 1)) for p in positions]
        return {
            "sum": ex.reduce([t.clone() for t in local], ReduceOp.SUM)[0],
            "min": ex.reduce([t.clone() for t in local], ReduceOp.MIN)[0],
            "prod": ex.reduce([t.clone() for t in local],
                              ReduceOp.PRODUCT)[0],
            "avg": ex.allreduce(local, ReduceOp.AVERAGE, 2.0, 0.5),
            "tiles": ex.reduce_tiles(
                [torch.arange(R * m, dtype=torch.float32) * (p + 1)
                 for p in positions], ReduceOp.SUM, m),
            "gather": ex.gather_tiles([torch.full((4,), float(p))
                                       for p in positions]),
            "ag": ex.allgather(
                [torch.cat([torch.full((p + 1,), float(p)),
                            torch.zeros(R - p - 1)]) for p in positions],
                [p + 1 for p in range(R)], ()),
            "a2a": ex.alltoall(
                [torch.arange(sum(splits[p]), dtype=torch.float32)
                 + 100 * p for p in positions], splits),
            "codes": ex._gathered_codes(q, s),
            "rs": ex.reducescatter(
                [torch.arange(R * 2, dtype=torch.float32) * (p + 1)
                 for p in positions], R + 1, (), ReduceOp.SUM),
        }

    ref = calls(MeshExecutor("cpu", R), list(range(R)))
    for positions, got in _run_group(
            counts, lambda ex: calls(ex, ex.local_positions)):
        assert torch.equal(got["sum"], ref["sum"])
        assert torch.equal(got["min"], ref["min"])
        assert torch.equal(got["prod"], ref["prod"])
        assert torch.equal(got["gather"], ref["gather"])
        assert [c.tolist() for c in got["codes"][0]] == \
            [c.tolist() for c in ref["codes"][0]]
        assert [c.tolist() for c in got["codes"][1]] == \
            [c.tolist() for c in ref["codes"][1]]
        for i, p in enumerate(positions):
            assert torch.equal(got["avg"][i], ref["avg"][p])
            assert torch.equal(got["tiles"][i], ref["tiles"][p])
            assert torch.equal(got["ag"][i], ref["ag"][p])
            assert torch.equal(got["a2a"][0][i], ref["a2a"][0][p])
            assert got["a2a"][1][i] == ref["a2a"][1][p]
            assert torch.equal(got["rs"][i], ref["rs"][p])


@pytest.mark.parametrize("counts", [[1, 1], [2, 2], [2, 1]])
def test_broadcast_leaves_the_input_untouched(counts):
    """The repaired fault: over a process group the executor broadcast
    into the non-root process's row in place, which is the caller's own
    tensor for ``hvd.broadcast(x, root)``, and returned that row, so the
    result aliased the input.  Now every local rank gets memory of its
    own and the input rows keep their values."""
    R = sum(counts)
    root = R - 1

    def body(ex):
        rows = [torch.full((5,), float(p)) for p in ex.local_positions]
        outs = ex.broadcast(rows, root)
        kept = all(torch.equal(t, torch.full((5,), float(p)))
                   for t, p in zip(rows, ex.local_positions))
        aliased = any(o.data_ptr() == t.data_ptr()
                      for o in outs for t in rows)
        shared = len({o.data_ptr() for o in outs}) < len(outs)
        return kept, aliased, shared, [o.tolist() for o in outs]

    for positions, (kept, aliased, shared, outs) in _run_group(counts, body):
        assert kept and not aliased and not shared, positions
        assert outs == [[float(root)] * 5] * len(positions)


def test_executor_refuses_a_layout_that_does_not_fit():
    store = dist.HashStore()
    pg = dist.ProcessGroupGloo(dist.PrefixStore("bad", store), 0, 1)
    with pytest.raises(ValueError, match="contiguous ascending run"):
        MeshExecutor("cpu", 3, group=pg, proc_positions=[[0, 2]])
    with pytest.raises(ValueError, match="contiguous ascending run"):
        MeshExecutor("cpu", 2, group=pg)


# -- (ii) jobs under both packages' launchers ---------------------------------

MATRIX_WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    PKG = sys.argv[1]
    if PKG == "jax":
        import horovod_tpu as hvd
        T = lambda a: a
        N = np.asarray
    else:
        import torch
        import horovod_tpu_torch as hvd
        T = torch.from_numpy
        N = lambda t: t.numpy()

    def fn():
        r, s = hvd.rank(), hvd.size()
        out = {"topo": np.array([hvd.local_rank(), hvd.local_size(),
                                 hvd.cross_rank(), hvd.cross_size(),
                                 int(hvd.is_homogeneous())])}
        base = np.arange(12, dtype=np.float32)
        for op, name in ((hvd.Sum, "sum"), (hvd.Average, "avg"),
                         (hvd.Min, "min"), (hvd.Max, "max")):
            x = base * (r + 1) - 3 * r
            out[name] = N(hvd.allreduce(
                T(x), op=op, prescale_factor=2.0, postscale_factor=0.25,
                name="ar_" + name))
        rnd = np.random.default_rng(r).standard_normal(33) \\
            .astype(np.float32)
        out["rand_sum"] = N(hvd.allreduce(T(rnd), op=hvd.Sum, name="rnd"))
        i32 = np.arange(6, dtype=np.int32) * (r + 3)
        out["i32"] = N(hvd.allreduce(T(i32), op=hvd.Sum, name="i32"))
        q = np.linspace(-1.0, 1.0, 700, dtype=np.float32) * (r + 1)
        out["int8"] = N(hvd.allreduce(T(q), name="int8", wire_dtype="int8"))
        out["ag"] = N(hvd.allgather(
            T(np.full((r + 1, 3), float(r), np.float32)), name="ag"))
        x0 = np.full(5, float(r), np.float32)
        out["bc"] = N(hvd.broadcast(T(x0), root_rank=s - 1, name="bc"))
        out["bc_input"] = np.asarray(x0).copy()
        splits = [(r + j) % 3 for j in range(s)]
        send = (np.arange(2 * sum(splits), dtype=np.float32)
                .reshape(-1, 2) + 100 * r)
        a2a, recv = hvd.alltoall(T(send), splits=splits, name="a2a")
        out["a2a"], out["a2a_recv"] = N(a2a), np.asarray(N(recv))
        rs_in = np.arange(2 * (s + 1), dtype=np.float32).reshape(-1, 2)
        out["rs"] = N(hvd.reducescatter(T(rs_in * (r + 1)), op=hvd.Sum,
                                        name="rs"))
        g = hvd.grouped_allreduce([T(np.full(3, float(r), np.float32)),
                                   T(np.full((2, 2), 1.0, np.float32))],
                                  op=hvd.Sum, name="grp")
        out["grp0"], out["grp1"] = N(g[0]), N(g[1])
        ps = hvd.add_process_set([1, 2])
        if r in (1, 2):
            out["ps"] = N(hvd.allreduce(T(np.full(2, r + 0.5, np.float32)),
                                        op=hvd.Sum, name="ps",
                                        process_set=ps))
        hvd.remove_process_set(ps)
        for it in range(8):
            out["steady%d" % it] = N(hvd.allreduce(
                T(np.full(5, float(r + it), np.float32)), op=hvd.Sum,
                name="steady"))
        hvd.barrier()
        if r == 0:
            last = hvd.join()
        else:
            out["tail"] = N(hvd.allreduce(T(np.ones(2, np.float32)),
                                          op=hvd.Sum, name="tail"))
            last = hvd.join()
        out["last_joined"] = np.asarray(last)
        np.savez(os.path.join(os.environ["OUTDIR"], "%s_%d.npz" % (PKG, r)),
                 **out)
        return r

    hvd.run(fn)
""")

CLOSE = ("rand_sum", "int8")
#: which of the late joiners joins last is a race on both sides
RACY = ("last_joined",)


def _jobs(tmp_path, np_, **kw):
    script = tmp_path / "matrix.py"
    script.write_text(MATRIX_WORKER)
    env = {"PYTHONPATH": REPO, "OUTDIR": str(tmp_path),
           "HOROVOD_BYPASS_AFTER_CYCLES": "3"}
    for pkg, launch in (("torch", torch_launch_procs),
                        ("jax", jax_launch_procs)):
        codes = launch([sys.executable, str(script), pkg], np=np_,
                       platform="cpu", env=env, start_timeout=TIMEOUT, **kw)
        assert codes == [0] * len(codes) and len(codes) == 2, (pkg, codes)
    got = [dict(np.load(tmp_path / f"torch_{r}.npz")) for r in range(np_)]
    ref = [dict(np.load(tmp_path / f"jax_{r}.npz")) for r in range(np_)]
    for r in range(np_):
        assert set(got[r]) == set(ref[r]), r
        for k in ref[r]:
            a, b = got[r][k], ref[r][k]
            assert a.shape == b.shape and a.dtype == b.dtype, (r, k)
            if k in CLOSE:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=0,
                                           err_msg=f"rank {r} {k}")
            elif k in RACY:
                assert 0 < int(a) < np_ and 0 < int(b) < np_, (r, k, a, b)
                assert int(a) == int(got[0][k]), (r, k)
            else:
                assert np.array_equal(a, b), (r, k, a, b)
    return got


@pytest.mark.integration
def test_hybrid_procs_with_rank_threads(tmp_path):
    """np=4 as 2 processes x 2 rank threads, on two simulated hosts (the
    JAX test's ``localhost:1,127.0.0.1:1``)."""
    got = _jobs(tmp_path, 4, ranks_per_proc=2,
                hosts="localhost:1,127.0.0.1:1")
    assert [list(g["topo"]) for g in got] == [
        [0, 2, 0, 2, 1], [1, 2, 0, 2, 1], [0, 2, 1, 2, 1], [1, 2, 1, 2, 1]]
    assert np.array_equal(got[0]["sum"], (np.arange(12) * 10 - 18) * 0.5)
    assert np.array_equal(got[1]["bc"], np.full(5, 3.0, np.float32))
    assert np.array_equal(got[1]["bc_input"], np.full(5, 1.0, np.float32))
    assert np.array_equal(got[2]["ps"], np.full(2, 4.0, np.float32))


@pytest.mark.integration
def test_heterogeneous_host_slots(tmp_path):
    """``ranks_per_proc="host"``: one process per host entry with 2 and 1
    rank threads; uneven allgather and alltoall across the 2+1
    boundary."""
    got = _jobs(tmp_path, 3, ranks_per_proc="host",
                hosts="localhost:2,127.0.0.1:1")
    assert [list(g["topo"]) for g in got] == [
        [0, 2, 0, 2, 0], [1, 2, 0, 1, 0], [0, 1, 1, 2, 0]]
    assert got[0]["ag"].shape == (6, 3)
    assert np.array_equal(got[2]["a2a_recv"], [2, 0, 1])


# -- (iii) the compiled path at 2 x 2 ---------------------------------------

COMPILED_WORKER = textwrap.dedent("""
    import os
    import sys
    import threading
    import numpy as np

    rng = np.random.default_rng(3)
    PARAMS = {"w1": rng.standard_normal((6, 5)).astype(np.float32) * 0.3,
              "b1": rng.standard_normal(5).astype(np.float32) * 0.1,
              "w2": rng.standard_normal((5, 3)).astype(np.float32) * 0.3}


    def _adapters(pkg):
        if pkg == "jax":
            import jax.numpy as jnp
            import optax
            import horovod_tpu as hvd
            T = lambda a: np.ascontiguousarray(a)
            N = lambda t: np.array(t)

            def loss_fn(p, batch):
                x, y = batch
                h = jnp.tanh(x @ p["w1"] + p["b1"])
                return jnp.mean((h @ p["w2"] - y) ** 2)
            opts = {"sgd": lambda: optax.sgd(0.1, momentum=0.9),
                    "adamw": lambda: optax.adamw(1e-2)}
            params = lambda: {k: jnp.asarray(v) for k, v in PARAMS.items()}
            # the JAX package keeps its cross-process signature verdict
            # on the object of a call's rendezvous leader, which may be
            # either rank thread's, so at 2 rank threads a process the
            # exchange ran again whenever the leader changed and timed
            # out.  Here the verdict is kept once a process, as the
            # port keeps it: a step is checked once any call of it
            # returned; a reducer shares one verdict set a name
            verdicts, lock = {}, threading.Lock()

            def checked(obj, name):
                with lock:
                    if hasattr(obj, "_sig_checked"):
                        obj._sig_checked = True
                    else:
                        obj._validated = verdicts.setdefault(
                            name, obj._validated)
                return obj
        else:
            import torch
            import horovod_tpu_torch as hvd
            from horovod_tpu_torch.parallel.train import adamw, sgd
            T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
            N = lambda t: t.detach().numpy().copy()

            def loss_fn(p, batch):
                x, y = batch
                h = torch.tanh(x @ p["w1"] + p["b1"])
                return ((h @ p["w2"] - y) ** 2).mean()
            opts = {"sgd": lambda: sgd(0.1, momentum=0.9),
                    "adamw": lambda: adamw(1e-2)}
            params = lambda: PARAMS
            checked = lambda obj, name: obj
        return hvd, T, N, loss_fn, opts, params, checked


    def make_fn(pkg):
        hvd, T, N, loss_fn, opts, params, checked = _adapters(pkg)

        def fn():
            r = hvd.rank()
            brng = np.random.default_rng(50 + r)
            batches = [(T(brng.standard_normal((4, 6)).astype(np.float32)),
                        T(brng.standard_normal((4, 3)).astype(np.float32)))
                       for _ in range(3)]
            out = {}
            for label, opt, kw in (
                    ("dense", "sgd", {}),
                    ("f32", "adamw", {"sharded": True}),
                    ("int8", "adamw", {"sharded": True,
                                       "wire_dtype": "int8"})):
                step = hvd.make_compiled_train_step(loss_fn, opts[opt](),
                                                    **kw)
                state = step.init_state(params())
                for i, batch in enumerate(batches):
                    state, loss = step(state, batch)
                    checked(step, label)
                    out[f"{label}.loss{i}"] = np.asarray(float(loss),
                                                         np.float64)
                for k, v in state["params"].items():
                    out[f"{label}.{k}"] = N(v)
            grads = [np.random.default_rng(7 + r).standard_normal(300)
                     .astype(np.float32),
                     np.full((2, 3), float(r + 1), np.float32)]
            for wire in (None, "int8"):
                red = checked(hvd.CompiledGroupedAllreduce(
                    op=hvd.Sum, wire_dtype=wire, name=f"red{wire}",
                    error_feedback=wire is not None), f"red{wire}")
                for call in range(2):
                    res = red([T(g) for g in grads])
                    out[f"red{wire}.{call}"] = np.concatenate(
                        [N(t).reshape(-1) for t in res])
            x = (np.arange(4 * 256, dtype=np.float32).reshape(4, 256)
                 * 0.01 + r).astype(np.float32)
            for wire in (None, "int8"):
                a2a = hvd.CompiledAlltoall(wire_dtype=wire,
                                           name=f"a2a{wire}")
                out[f"a2a{wire}"] = N(a2a(T(x)))
            if os.environ.get("OUTDIR"):
                np.savez(os.path.join(os.environ["OUTDIR"],
                                      f"{pkg}_{r}.npz"), **out)
            return out
        return hvd, fn


    if __name__ == "__main__":
        hvd, fn = make_fn(sys.argv[1])
        hvd.init()
        hvd.run(fn)
        hvd.shutdown()
""")

#: the compiled legs held bit for bit against the JAX package's job: the
#: exchanges move values and codes, and the int8 reducer sums its
#: decoded rows in rank order on both sides (a loss is a four-rank
#: average, so its last bit may follow the summation order)
EXACT = ("a2aNone", "a2aint8", "redint8.0", "redint8.1")


@pytest.mark.integration
def test_hybrid_compiled_step_matches_stacked(tmp_path, monkeypatch):
    """The compiled legs at 2 processes x 2 rank threads under both
    packages' launchers (the JAX package runs them across its
    processes, with optax), held against each other, then the port's
    job against its own run at 4 rank threads in one process."""
    script = tmp_path / "compiled_worker.py"
    script.write_text(COMPILED_WORKER)
    jobs = {}
    for pkg, launch in (("torch", torch_launch_procs),
                        ("jax", jax_launch_procs)):
        codes = launch(
            [sys.executable, str(script), pkg], np=4, ranks_per_proc=2,
            platform="cpu", env={"PYTHONPATH": REPO,
                                 "OUTDIR": str(tmp_path)},
            start_timeout=TIMEOUT)
        assert codes == [0, 0], (pkg, codes)
        jobs[pkg] = [dict(np.load(tmp_path / f"{pkg}_{r}.npz"))
                     for r in range(4)]
    got, want = jobs["torch"], jobs["jax"]
    for r in range(4):
        assert set(got[r]) == set(want[r]), r
        for k, b in want[r].items():
            a = got[r][k]
            assert a.shape == b.shape, (r, k, a.shape, b.shape)
            if k in EXACT:
                assert np.array_equal(a, b), (r, k)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=f"rank {r} {k}")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.delenv("OUTDIR", raising=False)
    import compiled_worker
    hvd, fn = compiled_worker.make_fn("torch")
    ref = hvd.run(fn, np=4, device="cpu")
    for r in range(4):
        assert set(got[r]) == set(ref[r])
        for k, b in ref[r].items():
            if k.startswith("a2aNone"):
                assert np.array_equal(got[r][k], b), (r, k)
            else:
                np.testing.assert_allclose(got[r][k], b, rtol=1e-5,
                                           atol=1e-6,
                                           err_msg=f"rank {r} {k}")
        # replicas agree bit for bit inside the hybrid job
        for k in got[r]:
            if not k.startswith("a2a"):
                assert np.array_equal(got[r][k], got[0][k]), (r, k)
