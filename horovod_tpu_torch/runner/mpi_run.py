"""MPI launch surface (port of ``horovod_tpu/runner/mpi_run.py``;
reference ``horovod/runner/mpi_run.py``).

The port has no MPI controller: the launcher accepts ``--mpi`` as a
compatibility no-op and uses the HTTP store controller, with
``torch.distributed`` (NCCL or gloo) as the data plane.  The detection
predicates are real probes of the local ``mpirun``; ``mpi_run`` itself
fails loudly with the supported launcher instead of silently doing
something different from what the caller asked."""

from .common.util.tiny_shell_exec import execute as _exec


def _mpirun_version_output():
    result = _exec("mpirun --version")
    if result is None or result[1] != 0:
        return None
    return result[0]


def is_open_mpi():
    out = _mpirun_version_output()
    return out is not None and "Open MPI" in out


def is_spectrum_mpi():
    out = _mpirun_version_output()
    return out is not None and "IBM Spectrum MPI" in out


def is_mpich():
    out = _mpirun_version_output()
    return out is not None and ("MPICH" in out or "HYDRA" in out)


def is_intel_mpi():
    out = _mpirun_version_output()
    return out is not None and "Intel(R) MPI" in out


def mpi_available(env=None):
    return _mpirun_version_output() is not None


def mpi_run(settings, nics, env, command, stdout=None, stderr=None):
    raise RuntimeError(
        "MPI launch is not supported by horovod_tpu_torch: it has no "
        "MPI controller or data plane. Use its launcher (python -m "
        "horovod_tpu_torch.runner.launch, without --mpi, or "
        "horovod_tpu_torch.runner.proc_run.launch_procs): it provides "
        "the same rendezvous/env-handoff contract over the HTTP store "
        "controller and torch.distributed.")
