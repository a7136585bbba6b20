"""Gloo-role launch surface (port of the static part of
``horovod_tpu/runner/gloo_run.py``; reference
``horovod/runner/gloo_run.py``).

The gloo controller's role (rendezvous, per-slot env handoff, worker
spawn) is played by the HMAC-HTTP store controller and
``proc_run.launch_procs``; this module keeps the reference's static entry
points and helpers on top of that machinery.  The elastic ones
(``launch_gloo_elastic``, ``gloo_run_elastic``) are ROADMAP.md A17.
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
    if elastic:
        raise NotImplementedError(
            "elastic runs are not ported yet (ROADMAP.md A17)")
    env = {
        "HOROVOD_GLOO_RENDEZVOUS_ADDR": server_ip,
        "HOROVOD_GLOO_RENDEZVOUS_PORT": str(port),
        "HOROVOD_CONTROLLER": "http",
        "HOROVOD_CPU_OPERATIONS": "gloo",
    }
    if nics:
        env["HOROVOD_GLOO_IFACE"] = list(nics)[0]
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


def gloo_run_elastic(settings, env, command_or_func, executable=None):
    """Reference gloo_run.py:370: ROADMAP.md A17."""
    raise NotImplementedError(
        "elastic runs are not ported yet (ROADMAP.md A17)")
