"""Gloo-role launch surface (port of ``horovod_tpu/runner/gloo_run.py``;
reference ``horovod/runner/gloo_run.py``).

The gloo controller's role (rendezvous, per-slot env handoff, worker
spawn) is played by the HMAC-HTTP store controller and
``proc_run.launch_procs``, or in an elastic job by the elastic driver
(``runner/elastic_run.py``); this module keeps the reference's static
and elastic entry points and helpers on top of that machinery.
"""

import os

from .proc_run import launch_procs


def create_slot_env_vars(slot_info):
    """Per-slot identity env (reference gloo_run.py:66): the names
    proc_run.slot_env hands every worker."""
    return {
        "HOROVOD_HOSTNAME": slot_info.hostname,
        "HOROVOD_RANK": str(slot_info.rank),
        "HOROVOD_SIZE": str(slot_info.size),
        "HOROVOD_LOCAL_RANK": str(slot_info.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot_info.local_size),
        "HOROVOD_CROSS_RANK": str(slot_info.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot_info.cross_size),
    }


def create_run_env_vars(server_ip, nics, port, elastic=False):
    """Rendezvous-location env (reference gloo_run.py:203), with the
    port's CPU backend (gloo)."""
    env = {
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": server_ip,
        "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
        "HOROVOD_CONTROLLER": "http",
        "HOROVOD_CPU_OPERATIONS": "gloo",
    }
    if nics:
        env["HOROVOD_GLOO_IFACE"] = list(nics)[0]
    if elastic:
        env["HOROVOD_ELASTIC"] = "1"
    return env


def _settings_to_kwargs(settings, env, command):
    kwargs = dict(
        command=list(command) if isinstance(command, (list, tuple))
        else [command],
        np=settings.num_proc,
        hosts=getattr(settings, "hosts", None),
        env=dict(env or os.environ),
        verbose=bool(settings.verbose),
        output_filename=settings.output_filename,
    )
    if settings.start_timeout is not None:
        remaining = getattr(settings.start_timeout, "remaining", None)
        kwargs["start_timeout"] = remaining() if callable(remaining) \
            else float(settings.start_timeout)
    return kwargs


def gloo_run(settings, nics, env, server_ip, command):
    """Static launch (reference gloo_run.py:242-300).  ``nics`` and
    ``server_ip`` belong to the reference's ssh+gloo machinery; the
    store-controller launcher owns rendezvous and spawn, so they are
    accepted and unused.  Raises when a worker exits non-zero."""
    exit_codes = launch_procs(**_settings_to_kwargs(settings, env,
                                                    command))
    failed = [(i, c) for i, c in enumerate(exit_codes) if c != 0]
    if failed:
        raise RuntimeError(
            f"Horovod detected that one or more processes exited with "
            f"non-zero status: {failed}")


def launch_gloo_elastic(command_or_func, exec_command, settings, env,
                        get_common_interfaces, rendezvous,
                        executable=None):
    """Elastic launch (reference gloo_run.py:303): the elastic driver and
    the KV rendezvous (runner/elastic_run.py).  ``exec_command``,
    ``get_common_interfaces`` and ``rendezvous`` belong to the
    reference's ssh+gloo machinery and are accepted and unused.  Returns
    the job's exit code."""
    from argparse import Namespace

    from .elastic_run import run_elastic

    discovery = getattr(settings, "discovery", None)
    args = Namespace(
        np=settings.num_proc,
        min_np=getattr(settings, "min_num_proc", None),
        max_np=getattr(settings, "max_num_proc", None),
        hosts=getattr(settings, "hosts", None),
        discovery=discovery if not isinstance(discovery, str) else None,
        host_discovery_script=discovery if isinstance(discovery, str)
        else getattr(settings, "discovery_script", None),
        slots_per_host=getattr(settings, "slots", None),
        blacklist_cooldown_range=getattr(settings, "cooldown_range", None),
        command=command_or_func
        if isinstance(command_or_func, (list, tuple))
        else [command_or_func],
        verbose=bool(settings.verbose),
        start_timeout=None,
        output_filename=settings.output_filename,
        reset_limit=getattr(settings, "reset_limit", None),
        elastic_timeout=getattr(settings, "elastic_timeout", None) or 600,
        cpu=False,
        ranks_per_worker=1,
        extra_env=dict(env) if env else None,
    )
    return run_elastic(args)


def gloo_run_elastic(settings, env, command_or_func, executable=None):
    """Reference gloo_run.py:370."""
    return launch_gloo_elastic(command_or_func, None, settings, env,
                               None, None, executable)
