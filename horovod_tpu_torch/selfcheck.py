"""Multi-process engine self-check (port of ``horovod_tpu/selfcheck.py``,
the engine part): the coordinator/store-controller protocol exercised end
to end at N OS processes through the port's launcher.

The reference validates its controller with multi-worker integration
runs (``test/integration/``, ``controller.h:78-110`` negotiation
contract); this is the equivalent harness.  The scenario,
:func:`check_collectives`, runs the negotiated surfaces the coordinator
owns on torch tensors with the JAX worker's exact asserts: negotiated
allreduce, grouped mixed-dtype allreduce, uneven allgather, non-uniform
alltoall, a dynamic process set and join.  The JAX worker's last part,
the parallel package's dp/tp SPMD train step over a process-spanning
mesh (``spmd_lm_check``), waits on the port of the parallel package
(ROADMAP.md A15).
"""

import os
import sys
import textwrap


def spmd_lm_check(steps: int = 3, expect_devices: int = None):
    """The JAX package's pod-shape SPMD scenario: a dp x tp mesh over
    every process's device.  Not ported: it needs the parallel package's
    mesh and sharded LM step (ROADMAP.md A15)."""
    raise NotImplementedError(
        "spmd_lm_check needs the parallel package's dp x tp mesh, which "
        "is not ported yet (ROADMAP.md A15)")


def check_collectives():
    """The self-check's collectives on this rank, each result asserted
    exactly (small integers: every value is exact in f32).  Runs inside a
    rank (a launcher worker after ``init()``, or a rank thread of
    ``run``) on the runtime's device; returns the outputs, on the CPU, by
    name."""
    import torch
    from . import (
        Average, Sum, add_process_set, allgather, allreduce, alltoall,
        device, grouped_allreduce, join, rank, remove_process_set, size,
    )

    r, n = rank(), size()
    dev = device()
    got = {}

    # negotiated allreduce
    out = allreduce(torch.ones(8, device=dev) * (r + 1), op=Average)
    want = sum(i + 1.0 for i in range(n)) / n
    assert torch.allclose(out.cpu(), torch.full((8,), want)), (r, out)
    got["allreduce"] = out.cpu()

    # grouped mixed-dtype allreduce (per-dtype fused submissions)
    a, b = grouped_allreduce(
        [torch.full((4,), float(r + 1), device=dev),
         torch.full((3,), r + 1, dtype=torch.int64, device=dev)],
        op=Sum, name="gmix")
    tot = sum(i + 1 for i in range(n))
    assert torch.equal(a.cpu(), torch.full((4,), float(tot))), a
    assert torch.equal(b.cpu(), torch.full((3,), tot,
                                           dtype=torch.int64)), b
    got["gmix_f32"], got["gmix_i64"] = a.cpu(), b.cpu()

    # allgather with uneven first dims: the coordinator merges the
    # per-process first-dim tables in rank order
    g = allgather(torch.full((r % 3 + 1, 2), float(r), device=dev),
                  name="ag")
    assert tuple(g.shape) == (sum(i % 3 + 1 for i in range(n)), 2), g.shape
    off = 0
    for j in range(n):
        rows = j % 3 + 1
        assert torch.allclose(g[off:off + rows].cpu(),
                              torch.full((rows, 2), float(j))), (r, j)
        off += rows
    got["allgather"] = g.cpu()

    # alltoall with non-uniform splits (rank j sends k+1 rows to rank k);
    # exact delivery across every process boundary
    splits = [k + 1 for k in range(n)]
    x = torch.arange(sum(splits), dtype=torch.float32,
                     device=dev) + 1000.0 * r
    out, recv = alltoall(x, splits=splits, name="a2a")
    assert [int(v) for v in recv] == [r + 1] * n, (r, recv)
    src_off = sum(splits[:r])
    off = 0
    for j in range(n):
        want_rows = torch.arange(r + 1, dtype=torch.float32) + src_off \
            + 1000.0 * j
        assert torch.allclose(out[off:off + r + 1].cpu(), want_rows), (r, j)
        off += r + 1
    got["alltoall"], got["alltoall_recv"] = out.cpu(), recv.cpu()

    # dynamic process sets: add (evens), reduce inside, remove;
    # registration and the draining removal barrier are collective
    evens = [i for i in range(n) if i % 2 == 0]
    ps = add_process_set(evens)
    if r in evens:
        sub = allreduce(torch.ones(2, device=dev), op=Sum, name="psred",
                        process_set=ps)
        assert torch.allclose(sub.cpu(), torch.full((2,), float(len(
            evens)))), sub
        got["psred"] = sub.cpu()
    remove_process_set(ps)

    # join: every rank but the last submits one extra allreduce; the
    # joined rank's zero contribution must merge (reference Join op)
    if r != n - 1:
        tail = allreduce(torch.ones(2, device=dev), op=Sum, name="tail")
        assert torch.allclose(tail.cpu(), torch.full((2,), float(
            n - 1))), tail
        got["tail"] = tail.cpu()
    last = join()
    assert last >= 0, last
    got["join"] = last
    return got


#: Worker: one rank per process (``HOROVOD_SELFCHECK_DEVICE`` names its
#: device; unset, ``init()``'s default), the launcher's slot table
#: against the runtime's topology, then :func:`check_collectives`.
ENGINE_CHECK_WORKER = textwrap.dedent("""
    import os
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.selfcheck import check_collectives

    hvd.init(device=os.environ.get("HOROVOD_SELFCHECK_DEVICE") or None)
    r, n = hvd.rank(), hvd.size()

    # the launcher's slot table is the runtime's topology
    for name in ("local_rank", "local_size", "cross_rank", "cross_size"):
        want = int(os.environ["HOROVOD_" + name.upper()])
        assert getattr(hvd, name)() == want, (r, name, want)

    check_collectives()
    # the JAX worker ends with spmd_lm_check, the dp x tp train step over
    # a mesh spanning the processes: it waits on ROADMAP.md A15

    print(f"ENGINE-CHECK OK {r}/{n}")
    hvd.shutdown()
""")


def run_engine_selfcheck(np_procs: int = 8, start_timeout: float = 420,
                         device=None, hosts: str = None, env: dict = None):
    """Launch ``np_procs`` one-rank worker PROCESSES through the port's
    launcher (``torch.distributed`` plus the HTTP store controller) and
    run the negotiated-op scenario.  Raises on any nonzero worker exit.

    ``device``: the workers' device.  None runs on the card, each process
    on ``cuda:<local rank>``; ``"cpu"`` runs on the CPU over gloo; another
    value (``"cuda:0"``) puts every worker on that device, which on one
    card needs ``env={"HOROVOD_GPU_OPERATIONS": "gloo"}`` (NCCL refuses
    two ranks on one GPU, and ``init()`` says so).  ``hosts`` is the
    launcher's ``-H``: a host that is not this machine gets its workers
    over ssh.  The worker runs as ``python -c``, so a remote host needs
    only this Python and this checkout at the same paths."""
    from .runner.proc_run import launch_procs

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    job_env = {"PYTHONPATH": repo, **(env or {})}
    cpu = device is not None and str(device) == "cpu"
    if device is not None and not cpu:
        job_env["HOROVOD_SELFCHECK_DEVICE"] = str(device)
    codes = launch_procs(
        [sys.executable, "-c", ENGINE_CHECK_WORKER], np=np_procs,
        hosts=hosts, platform="cpu" if cpu else None, env=job_env,
        start_timeout=start_timeout)
    if codes != [0] * np_procs:
        raise RuntimeError(
            f"engine self-check failed at np={np_procs}: exit codes "
            f"{codes}")
    return True
