"""The hierarchical and torus allreduces of horovod_tpu_torch across
processes, over gloo on the CPU, against the same user function run at 4
rank threads in one process (the stacked executor) with the same host map.

Two launcher jobs of one worker, each on the two simulated hosts
``localhost`` and ``127.0.0.1`` (both local: no ssh), so the launcher's
host map is ``[0, 0, 1, 1]``:

* np=4, one rank a process: the executor runs the inner hops over each
  grid row's process group and the outer hop over each grid column's,
  groups the engine builds for every set when it creates it;
* np=4 as 2 processes x 2 rank threads: each process hosts one grid row,
  so the inner hops stay inside it and only the outer sum crosses the
  processes.

The worker runs the engine path (Sum, Average with scales, every wire
pair, a grouped call) and the compiled reducer (the policy's grid with
int4 error feedback over two calls, and a dp x tp ``TopologyHint``).
Tolerance: bit for bit.  At 2 x 2 every sum adds two terms, in both
layouts as in the stacked run (``(r0 + r1) + (r2 + r3)``), and the
shared-scale codec's integer sums are exact.  The byte counters of each
process equal the single process's."""

import os
import sys
import textwrap

import numpy as np
import pytest

from horovod_tpu_torch.runner.proc_run import launch_procs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 150

WORKER = textwrap.dedent("""
    import os
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics


    def fn():
        r = hvd.rank()
        rng = np.random.default_rng(r)
        x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
        out = {}
        for label, kw in (
                ("torus", dict(op=hvd.Sum, algorithm="torus")),
                ("hier.avg", dict(op=hvd.Average, algorithm="hierarchical",
                                  prescale_factor=0.5,
                                  postscale_factor=3.0)),
                ("hier.bf16:int8", dict(op=hvd.Sum, algorithm="hier",
                                        wire_dtype="int8",
                                        wire_inner="bf16")),
                ("torus.int4", dict(op=hvd.Sum, algorithm="torus",
                                    wire_dtype="int4")),
                ("torus.fp16", dict(op=hvd.Average, algorithm="torus",
                                    wire_dtype="fp16"))):
            out[label] = hvd.allreduce(x, name=label, **kw).numpy()
        group = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((37,), (5, 130))]
        res = hvd.grouped_allreduce(group, name="grouped", algorithm="torus",
                                    wire_dtype="bf16")
        out["grouped"] = np.concatenate([t.numpy().reshape(-1) for t in res])
        red = hvd.CompiledGroupedAllreduce(
            op=hvd.Sum, algorithm="hierarchical", wire_dtype="int4",
            error_feedback=True, name="ef")
        for call in range(2):
            out[f"compiled.ef{call}"] = red([x])[0].numpy()
        hint = hvd.CompiledGroupedAllreduce(
            op=hvd.Average, name="hint",
            topology_hint=hvd.TopologyHint(("dp", "tp"), (2, 2)))
        out["compiled.hint"] = hint([x, group[1]])[1].numpy()
        out["compiled.cross"] = np.array(
            [red.last_cross_bytes, hint.last_cross_bytes,
             hint.last_logical_bytes])
        hvd.barrier()
        eng = basics.engine()
        out["algo_runs"] = np.array([eng.algo_runs.get(a, 0) for a in
                                     ("flat", "hierarchical", "torus")])
        out["bytes"] = np.array([eng.logical_wire_bytes,
                                 eng.actual_wire_bytes,
                                 eng.cross_wire_bytes])
        out["hosts"] = np.array(eng.topology.host_of_rank)
        if os.environ.get("OUTDIR"):
            np.savez(os.path.join(os.environ["OUTDIR"], f"w_{r}.npz"),
                     **out)
        return out


    if __name__ == "__main__":
        hvd.init()
        hvd.run(fn)
        hvd.shutdown()
""")


@pytest.fixture(scope="module")
def stacked(tmp_path_factory):
    """The worker's function at 4 rank threads in this process, with the
    jobs' host map on the engine."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common.topology import Topology

    path = tmp_path_factory.mktemp("stacked") / "worker_2d.py"
    path.write_text(WORKER)
    sys.path.insert(0, str(path.parent))
    try:
        import worker_2d
    finally:
        sys.path.remove(str(path.parent))
    hvd.run(lambda: None, np=4, device="cpu", keep_alive=True)
    try:
        basics.engine().topology = Topology(size=4,
                                            host_of_rank=[0, 0, 1, 1])
        return hvd.run(worker_2d.fn, np=4)
    finally:
        hvd.shutdown()


def _job(tmp_path, **kw):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    codes = launch_procs([sys.executable, str(script)], np=4,
                         platform="cpu", start_timeout=TIMEOUT,
                         env={"PYTHONPATH": REPO,
                              "OUTDIR": str(tmp_path)}, **kw)
    return codes, [dict(np.load(tmp_path / f"w_{r}.npz")) for r in range(4)]


def _check(got, ref):
    for r in range(4):
        assert set(got[r]) == set(ref[r]), r
        for k, b in ref[r].items():
            a = got[r][k]
            assert a.shape == b.shape and a.dtype == b.dtype, (r, k)
            assert np.array_equal(a, b), (r, k, np.abs(
                a.astype(np.float64) - b.astype(np.float64)).max())
    assert list(got[0]["hosts"]) == [0, 0, 1, 1]
    flat, hier, torus = got[0]["algo_runs"]
    # every engine call decomposed (the barrier is no allreduce)
    assert (flat, hier, torus) == (0, 2, 4)
    logical, _actual, cross = got[0]["bytes"]
    assert 0 < cross < logical


@pytest.mark.integration
def test_one_rank_a_process(tmp_path, stacked):
    """np=4 processes, the grid's row and column groups over gloo."""
    codes, got = _job(tmp_path, hosts="localhost:2,127.0.0.1:2")
    assert codes == [0, 0, 0, 0]
    _check(got, stacked)


@pytest.mark.integration
def test_two_processes_of_two_rank_threads(tmp_path, stacked):
    """2 processes x 2 rank threads: one grid row a process."""
    codes, got = _job(tmp_path, ranks_per_proc=2,
                      hosts="localhost:1,127.0.0.1:1")
    assert codes == [0, 0]
    _check(got, stacked)
