"""Environment-handoff helpers (port of ``horovod_tpu/runner/common/util/
env.py``; reference ``horovod/runner/common/util/env.py``).  The launcher hands workers a
filtered copy of its environment (proc_run.py carries the same
``HOROVOD_*`` contract); these predicates decide what crosses."""

import os
import re

from . import secret

LOG_LEVEL_STR = ["FATAL", "ERROR", "WARNING", "INFO", "DEBUG", "TRACE"]

IGNORE_REGEXES = {"BASH_FUNC_.*", "OLDPWD", secret.HOROVOD_SECRET_KEY}

KUBEFLOW_MPI_EXEC = "/etc/mpi/kubexec.sh"


def is_exportable(v):
    return not any(re.match(r, v) for r in IGNORE_REGEXES)


def get_env_rank_and_size():
    """Rank/size of this process from whichever launcher env contract
    is present (reference env.py:33).  The port's launcher publishes
    HOROVOD_RANK/HOROVOD_SIZE; the MPI/PMI names are honored for
    scripts arriving from other launchers."""
    rank_env = ["HOROVOD_RANK", "OMPI_COMM_WORLD_RANK", "PMI_RANK"]
    size_env = ["HOROVOD_SIZE", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"]
    for rank_var, size_var in zip(rank_env, size_env):
        rank = os.environ.get(rank_var)
        size = os.environ.get(size_var)
        if rank is not None and size is not None:
            return int(rank), int(size)
        if rank is not None or size is not None:
            raise RuntimeError(
                f"Could not determine process rank and size: only one "
                f"of {rank_var} and {size_var} found in environment")
    return 0, 1


def is_kubeflow_mpi():
    return os.environ.get("OMPI_MCA_plm_rsh_agent") == KUBEFLOW_MPI_EXEC
