"""The compiled path across processes on the CPU (ROADMAP.md A22): one
rank per OS process, the compiled group a second gloo group of the
job's processes, held against the same legs under the JAX package and
against the port's own stacked run (with a fusion threshold that
splits the process-group steps' flat buffers and leaf groups).

One worker (``LEGS``) runs, with weights and batches from numpy seeds:
the dense compiled step of a small MLP (SGD momentum 0.9) under Average
and Sum; the sharded step (AdamW) on the f32 and int8 wires; the
compiled reducer's matrix (Average, Sum, pre/post scale, the bf16 wire,
uint8 Sum, the int8 wire with error feedback over 3 calls); ``.stream``
against the grouped call (full width and int8, buckets pushed in
reverse); ``CompiledAlltoall`` on f32, int8 and int4 with error feedback
over two calls; and a mismatched ``compiled_allreduce`` signature.  Each
np=2 job (``launch_procs``, ``platform="cpu"`` for the JAX package,
``--cpu``'s platform for the port, a ``start_timeout`` on every launch,
three launches in the file) writes an ``.npz`` per rank.  The JAX
package runs every leg across processes, so no leg falls back to its
rank-thread run.

Tolerances.  Against the JAX package: the reducer, ``.stream`` and the
alltoall legs bit for bit (integers, two-rank float sums, one rounding;
power-of-two scales; the wires' codes, shared scales and integer sums
are exact), each step's first loss bit for bit; the later losses and
the final parameters within atol 1e-6, the bound
tests/test_torch_multiprocess.py holds its trained parameters to: the
two packages' backward passes may differ in the last bit of an f32
gradient, and optax may contract the momentum into an FMA (measured:
at most 3.6e-7).  Against the port's stacked run at 2 rank threads in
this process: every result bit for bit, the error-feedback residuals
included (a two-rank sum is ``a + b`` over gloo as in the stacked sum,
and an average is that sum, then ``div_(2)``, on both sides).  Both
packages' processes raise ``ValueError`` on the mismatched signature.
"""

import os
import sys

import numpy as np
import pytest

from horovod_tpu.runner.proc_run import launch_procs as jax_launch_procs
import horovod_tpu_torch as thvd
from horovod_tpu_torch.runner.proc_run import (
    launch_procs as torch_launch_procs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150
NP = 2
FUSION_BYTES = 600

LEGS = r'''
import numpy as np


def _adapters(pkg):
    if pkg == "jax":
        import jax
        import jax.numpy as jnp
        import ml_dtypes
        import optax
        T = lambda a: np.ascontiguousarray(a)
        N = lambda t: np.asarray(t).astype(np.float64) \
            if np.asarray(t).dtype == ml_dtypes.bfloat16 else np.asarray(t)

        def loss(p, batch):
            x, y = batch
            h = jnp.tanh(x @ p["w1"] + p["b1"])
            return jnp.mean((h @ p["w2"] - y) ** 2)
        opts = {"sgd": optax.sgd(0.1, momentum=0.9),
                "adamw": optax.adamw(1e-2)}
        params = lambda p: {k: jnp.asarray(v) for k, v in p.items()}
    else:
        import torch
        from horovod_tpu_torch.parallel.train import adamw, sgd
        T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        N = lambda t: t.detach().double().numpy() \
            if t.dtype == torch.bfloat16 else t.detach().numpy()

        def loss(p, batch):
            x, y = batch
            h = torch.tanh(x @ p["w1"] + p["b1"])
            return ((h @ p["w2"] - y) ** 2).mean()
        opts = {"sgd": sgd(0.1, momentum=0.9), "adamw": adamw(1e-2)}
        params = lambda p: p
    return T, N, loss, opts, params


def legs(hvd, pkg, mismatch):
    """Every leg of the compiled path at this rank; returns {name: array}."""
    T, N, loss, opts, to_params = _adapters(pkg)
    r = hvd.rank()
    out = {}
    prng = np.random.default_rng(11)
    init = {"w1": prng.standard_normal((8, 16)).astype(np.float32) * 0.3,
            "b1": prng.standard_normal(16).astype(np.float32) * 0.1,
            "w2": prng.standard_normal((16, 4)).astype(np.float32) * 0.3}
    brng = np.random.default_rng(100 + r)
    batches = [(brng.standard_normal((6, 8)).astype(np.float32),
                brng.standard_normal((6, 4)).astype(np.float32))
               for _ in range(3)]
    # (1) the dense step, SGD momentum, Average and Sum; (2) the sharded
    # step, AdamW, on the f32 and int8 wires
    for label, kw in (("dense_avg", dict(op=hvd.Average)),
                      ("dense_sum", dict(op=hvd.Sum)),
                      ("shard_f32", dict(sharded=True)),
                      ("shard_int8", dict(sharded=True,
                                          wire_dtype="int8"))):
        opt = opts["adamw" if kw.get("sharded") else "sgd"]
        step = hvd.make_compiled_train_step(loss, opt, **kw)
        state = step.init_state(to_params(init))
        for i, (x, y) in enumerate(batches):
            state, lv = step(state, (T(x), T(y)))
            out[f"{label}.loss{i}"] = np.asarray(float(lv), np.float64)
        for k, v in state["params"].items():
            out[f"{label}.{k}"] = N(v)
        if pkg == "torch":
            for k, v in state.get("grad_ef", {}).items():
                out[f"{label}.ef.{k}"] = N(v)
    # (3) the compiled reducer's matrix
    f = lambda *shape: (np.arange(np.prod(shape), dtype=np.float32)
                        .reshape(shape) * 0.37 + r) * (r + 1)
    out["red.avg"] = N(hvd.compiled_allreduce(T(f(7, 3))))
    out["red.sum"] = N(hvd.compiled_allreduce(T(f(9)), op=hvd.Sum))
    out["red.scaled"] = N(hvd.compiled_allreduce(
        T(f(5)), op=hvd.Sum, prescale_factor=0.5, postscale_factor=0.25))
    out["red.bf16"] = N(hvd.compiled_allreduce(T(f(300)),
                                               wire_dtype="bf16"))
    u8 = (np.arange(10) % 7 + r).astype(np.uint8)
    out["red.u8"] = N(hvd.compiled_allreduce(T(u8), op=hvd.Sum))
    q = np.random.default_rng(40 + r).standard_normal(700) \
        .astype(np.float32)
    red8 = hvd.CompiledGroupedAllreduce(wire_dtype="int8",
                                        error_feedback=True, name="ef8")
    for call in range(3):
        g = red8([T(q * (call + 1)), T(f(3, 5))])
        out[f"red.int8.{call}.0"], out[f"red.int8.{call}.1"] = \
            N(g[0]), N(g[1])
    # (4) .stream: buckets pushed in reverse order against the grouped call
    shapes = [(512,), (256, 3), (100,), (7, 9), (1024,)]
    srng = np.random.default_rng(60 + r)
    vals = [srng.standard_normal(s).astype(np.float32) for s in shapes]
    for wire in (None, "int8"):
        grouped = hvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=wire is not None,
            name=f"sg{wire}", bucket_bytes=0)
        bucketed = hvd.CompiledGroupedAllreduce(
            wire_dtype=wire, error_feedback=wire is not None,
            name=f"sb{wire}", bucket_bytes=2048)
        a = grouped([T(v) for v in vals])
        st = bucketed.stream([T(v) for v in vals])
        for i in reversed(range(len(vals))):
            st.push(i, T(vals[i]))
        b = st.result()
        for i in range(len(vals)):
            out[f"stream.{wire}.grouped.{i}"] = N(a[i])
            out[f"stream.{wire}.bucketed.{i}"] = N(b[i])
    # (5) the compiled alltoall, f32 / int8 / int4, error feedback over
    # two calls (slots of whole 256-blocks: 2 rows x 256 a peer)
    arng = np.random.default_rng(80 + r)
    for wire in (None, "int8", "int4"):
        a2a = hvd.CompiledAlltoall(wire_dtype=wire,
                                   error_feedback=wire is not None,
                                   name=f"a2a{wire}")
        for call in range(2):
            x = arng.standard_normal((4, 256)).astype(np.float32)
            out[f"a2a.{wire}.{call}"] = N(a2a(T(x)))
    # (6) a mismatched signature raises ValueError on every process
    if mismatch:
        out["sig.ok"] = N(hvd.compiled_allreduce(
            T(np.full(4, float(r + 1), np.float32)), op=hvd.Sum))
        try:
            hvd.compiled_allreduce(T(np.ones(4 if r == 0 else 5,
                                             np.float32)))
            out["sig.raised"] = np.asarray(0)
        except ValueError as e:
            out["sig.raised"] = np.asarray(
                int("signature mismatch across processes" in str(e)))
    return out
'''

WORKER = r'''
import os, sys
import numpy as np
PKG = sys.argv[1]
if PKG == "jax":
    import horovod_tpu as hvd
else:
    import horovod_tpu_torch as hvd
ns = {}
exec(open(os.environ["LEGS"]).read(), ns)
hvd.init()
out = ns["legs"](hvd, PKG, True)
np.savez(os.path.join(os.environ["OUTDIR"], f"{PKG}_{hvd.rank()}.npz"),
         **out)
hvd.shutdown()
'''


def _job(tmp_path, pkg, launch, env=None):
    legs = tmp_path / "legs.py"
    legs.write_text(LEGS)
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    codes = launch([sys.executable, str(worker), pkg], np=NP,
                   platform="cpu", start_timeout=TIMEOUT,
                   env={"PYTHONPATH": REPO, "OUTDIR": str(tmp_path),
                        "LEGS": str(legs), **(env or {})})
    assert codes == [0] * NP, (pkg, codes)
    out = [dict(np.load(tmp_path / f"{pkg}_{r}.npz")) for r in range(NP)]
    # the mismatched signature raised ValueError on every process
    assert [int(o.pop("sig.raised")) for o in out] == [1] * NP, pkg
    assert [o.pop("sig.ok").tolist() for o in out] == [[3.0] * 4] * NP
    return out


def _later(key):
    """A trained step's result past its first loss."""
    return key.split(".")[0] in ("dense_avg", "dense_sum", "shard_f32",
                                 "shard_int8") and not key.endswith("loss0")


@pytest.mark.integration
def test_compiled_legs_match_the_jax_package(tmp_path):
    got = _job(tmp_path, "torch", torch_launch_procs)
    want = _job(tmp_path, "jax", jax_launch_procs)
    for r in range(NP):
        keys = [k for k in got[r] if ".ef." not in k]
        assert sorted(keys) == sorted(want[r]), r
        for k in keys:
            a, b = got[r][k], want[r][k]
            assert a.shape == b.shape, (r, k, a.shape, b.shape)
            if _later(k):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                           err_msg=f"rank {r} {k}")
            else:
                assert a.dtype == b.dtype, (r, k, a.dtype, b.dtype)
                assert np.array_equal(a, b), (r, k)


@pytest.mark.integration
def test_process_group_is_the_stacked_run(tmp_path, monkeypatch):
    # a fusion threshold below the MLP's 832 f32 bytes: the process-group
    # steps split their flat buffers and the sharded step its leaf groups
    # ([w1, b1], [w2]); the stacked run reads the same setting
    env = {"HOROVOD_FUSION_THRESHOLD": str(FUSION_BYTES)}
    got = _job(tmp_path, "torch", torch_launch_procs, env)
    monkeypatch.setenv("HOROVOD_FUSION_THRESHOLD", str(FUSION_BYTES))
    ns = {}
    exec(LEGS, ns)
    want = thvd.run(lambda: ns["legs"](thvd, "torch", False), np=NP,
                    device="cpu")
    for r in range(NP):
        assert sorted(got[r]) == sorted(want[r]), r
        for k, a in got[r].items():
            b = want[r][k]
            if ".ef." in k:
                # the stacked state holds every rank's residual row, a
                # process its own
                b = b[r:r + 1]
            assert a.shape == b.shape and a.dtype == b.dtype, (r, k)
            assert np.array_equal(a, b), (r, k)
    # the residuals moved: the int8 legs ran error feedback
    assert any(np.any(v) for k, v in got[0].items() if ".ef." in k)
