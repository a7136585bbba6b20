"""Launcher settings objects (port of ``horovod_tpu/runner/common/util/
settings.py``; reference ``horovod/runner/common/util/settings.py``).
The launcher passes plain argparse namespaces internally
(runner/launch.py); these classes are the reference-shaped bundle for
the programmatic surfaces (ray, spark) and for ported tooling.  MPI-only fields
(extra_mpi_args, binding_args, tcp_flag) are carried but unused."""


class BaseSettings:
    def __init__(self, num_proc=None, verbose=0, ssh_port=None,
                 ssh_identity_file=None, extra_mpi_args=None,
                 tcp_flag=None, binding_args=None, key=None,
                 start_timeout=None, output_filename=None,
                 run_func_mode=None, nics=None, elastic=False,
                 prefix_output_with_timestamp=False):
        self.num_proc = num_proc
        self.verbose = verbose
        self.ssh_port = ssh_port
        self.ssh_identity_file = ssh_identity_file
        self.extra_mpi_args = extra_mpi_args
        self.tcp_flag = tcp_flag
        self.binding_args = binding_args
        self.key = key
        self.start_timeout = start_timeout
        self.output_filename = output_filename
        self.run_func_mode = run_func_mode
        self.nics = nics
        self.elastic = elastic
        self.prefix_output_with_timestamp = prefix_output_with_timestamp


class Settings(BaseSettings):
    def __init__(self, hosts=None, **kwargs):
        super().__init__(**kwargs)
        self.hosts = hosts
