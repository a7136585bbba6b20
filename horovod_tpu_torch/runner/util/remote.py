"""Remote command synthesis (port of ``horovod_tpu/runner/util/
remote.py``; reference ``horovod/runner/util/remote.py``).  The worker-spawn path
(proc_run.ssh_command) builds argv lists; these string-form helpers
are the reference surface used by spark/ray drivers."""

from ..common.util import env as env_util

SSH_COMMAND_PREFIX = ("ssh -o PasswordAuthentication=no "
                      "-o StrictHostKeyChecking=no")


def get_ssh_command(local_command, host, port=None, identity_file=None,
                    timeout_s=None):
    port_arg = f"-p {port}" if port is not None else ""
    identity_arg = f"-i {identity_file}" if identity_file else ""
    timeout_arg = (f"-o ConnectTimeout={timeout_s}"
                   if timeout_s is not None else "")
    return (f"{SSH_COMMAND_PREFIX} {host} {port_arg} {identity_arg} "
            f"{timeout_arg} {local_command}")


def get_remote_command(local_command, host, port=None,
                       identity_file=None, timeout_s=None):
    if env_util.is_kubeflow_mpi():
        return f"{env_util.KUBEFLOW_MPI_EXEC} {host} {local_command}"
    return get_ssh_command(local_command, host, port, identity_file,
                           timeout_s)
