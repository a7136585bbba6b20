"""The port's engine self-check (horovod_tpu_torch/selfcheck.py) and its
build-feature queries against the JAX package's.

The self-check's collectives run through both packages' rank threads at
np=4 on the same inputs (the JAX side is the JAX worker's own ops,
``horovod_tpu/selfcheck.py`` ENGINE_CHECK_WORKER, without its SPMD part),
every output equal bit for bit: small integers, exact in every dtype.
Then the whole self-check as four worker processes under the port's
launcher on the CPU, all local and with two workers through a stub ssh.
"""

import os

import numpy as np
import pytest

import horovod_tpu
import horovod_tpu.common.basics as jax_basics
import horovod_tpu.torch as jax_hvd_torch
import horovod_tpu_torch
import horovod_tpu_torch.torch as port_hvd_torch
from horovod_tpu_torch import selfcheck
from horovod_tpu_torch.common import basics as port_basics

NP = 4
BUILD_QUERIES = sorted(n for n in dir(jax_basics)
                       if n.endswith(("_built", "_enabled"))
                       or n == "mpi_threads_supported")


def _jax_collectives():
    """The JAX worker's collectives (ENGINE_CHECK_WORKER) on this rank,
    with its asserts; returns the outputs by the port's names."""
    hvd = horovod_tpu
    r, n = hvd.rank(), hvd.size()
    got = {}
    out = hvd.allreduce(np.ones(8, np.float32) * (r + 1), op=hvd.Average)
    assert np.allclose(out, np.mean([i + 1.0 for i in range(n)]))
    got["allreduce"] = np.asarray(out)
    a, b = hvd.grouped_allreduce(
        [np.full(4, r + 1, np.float32), np.full(3, r + 1, np.int64)],
        op=hvd.Sum, name="gmix")
    got["gmix_f32"], got["gmix_i64"] = np.asarray(a), np.asarray(b)
    g = hvd.allgather(np.full((r % 3 + 1, 2), float(r), np.float32),
                      name="ag")
    got["allgather"] = np.asarray(g)
    splits = [k + 1 for k in range(n)]
    x = np.arange(sum(splits), dtype=np.float32) + 1000.0 * r
    out, recv = hvd.alltoall(x, splits=splits, name="a2a")
    got["alltoall"] = np.asarray(out)
    got["alltoall_recv"] = np.asarray(recv).astype(np.int32)
    evens = [i for i in range(n) if i % 2 == 0]
    ps = hvd.add_process_set(evens)
    if r in evens:
        got["psred"] = np.asarray(hvd.allreduce(
            np.ones(2, np.float32), op=hvd.Sum, name="psred",
            process_set=ps))
    hvd.remove_process_set(ps)
    if r != n - 1:
        got["tail"] = np.asarray(hvd.allreduce(
            np.ones(2, np.float32), op=hvd.Sum, name="tail"))
    got["join"] = hvd.join()
    return got


def test_collectives_match_the_reference_in_rank_threads():
    try:
        ref = horovod_tpu.run(_jax_collectives, np=NP)
    finally:
        if horovod_tpu.is_initialized():
            horovod_tpu.shutdown()
    try:
        got = horovod_tpu_torch.run(selfcheck.check_collectives, np=NP,
                                    device="cpu")
    finally:
        if horovod_tpu_torch.is_initialized():
            horovod_tpu_torch.shutdown()
    for r in range(NP):
        assert sorted(got[r]) == sorted(ref[r]), r
        for k, want in ref[r].items():
            if k == "join":
                continue
            have = got[r][k].numpy()
            assert have.dtype == want.dtype and have.shape == want.shape, k
            np.testing.assert_array_equal(have, want, err_msg=f"{k} {r}")
    # join's value is the last rank to join, a race among simultaneous
    # joiners on both sides: both name a rank of the job
    assert all(0 <= got[r]["join"] < NP and 0 <= ref[r]["join"] < NP
               for r in range(NP))


def test_engine_selfcheck_in_processes():
    assert selfcheck.run_engine_selfcheck(NP, start_timeout=150,
                                          device="cpu")


def test_engine_selfcheck_with_workers_through_ssh(tmp_path, monkeypatch):
    """Phase 19 (b)'s job on the CPU: -H localhost:2,192.0.2.1:2, the two
    workers of the TEST-NET-1 address through a stub ssh that runs the
    remote command here; the workers hold the runtime's local and cross
    ranks and sizes to the launcher's slot table."""
    log = tmp_path / "log"
    log.mkdir()
    stub = tmp_path / "ssh"
    stub.write_text(f"#!/bin/sh\ntouch {log}/call.$$\n"
                    'for last; do :; done\nexec sh -c "$last"\n')
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert selfcheck.run_engine_selfcheck(
        NP, start_timeout=150, device="cpu", hosts="localhost:2,192.0.2.1:2")
    assert len(list(log.iterdir())) == 2


def test_engine_selfcheck_raises_on_a_failed_worker():
    """A worker that cannot start (no CUDA device here) fails the check
    with the exit codes."""
    with pytest.raises(RuntimeError, match="exit codes"):
        selfcheck.run_engine_selfcheck(2, start_timeout=120,
                                       device="cuda:0")


def test_spmd_lm_check_waits_on_the_parallel_package():
    with pytest.raises(NotImplementedError, match="A15"):
        selfcheck.spmd_lm_check()


@pytest.mark.parametrize("name", BUILD_QUERIES)
def test_build_queries_exist_where_the_reference_exports_them(name):
    assert callable(getattr(port_basics, name))
    assert isinstance(getattr(port_basics, name)(), bool)
    assert hasattr(port_hvd_torch, name) == hasattr(jax_hvd_torch, name)
    assert hasattr(horovod_tpu_torch, name) == hasattr(horovod_tpu, name)


def test_build_queries_answer_from_the_torch_build():
    import torch
    import torch.distributed as dist
    assert port_basics.gloo_built() == dist.is_gloo_available()
    assert port_basics.nccl_built() == dist.is_nccl_available()
    assert port_basics.mpi_built() == dist.is_mpi_available()
    assert port_basics.cuda_built() == (torch.version.cuda is not None)
    assert not port_basics.xla_built() and not port_basics.tpu_built()
    assert port_basics.gloo_enabled() and not port_basics.mpi_enabled()
    assert not port_basics.mpi_threads_supported()
