"""Elastic job entry (port of ``horovod_tpu/runner/elastic_run.py``;
reference ``horovod/runner/gloo_run.py:303-368`` launch_gloo_elastic).

A fault plan (``HOROVOD_FAULT_PLAN``) installs its coordinator-side
events into the elastic rendezvous service, as the JAX package's does;
a plan naming a kind the port has not ported is refused when it is
parsed (chaos/plan.py).  The serving autoscaler (``HOROVOD_SERVING``,
ROADMAP.md A16) is refused here.
"""

import os
import secrets as _secrets

from .config_parser import set_env_from_args
from .elastic.discovery import FixedHosts, HostDiscoveryScript
from .elastic.driver import ElasticDriver
from .http.http_server import RendezvousServer, coordinator_kwargs


def check_elastic_env(env):
    """Refuse the elastic features the port has not ported yet: the
    serving autoscaler, and a fault plan that names a kind or trigger
    whose consumer is not ported (parsing the plan raises, naming the
    item)."""
    if env.get("HOROVOD_FAULT_PLAN"):
        from ..chaos.plan import plan_from_env
        plan_from_env(env)
    if str(env.get("HOROVOD_SERVING", "")).strip().lower() in (
            "1", "true", "yes", "on"):
        raise NotImplementedError(
            "HOROVOD_SERVING: the serving autoscaler is not ported yet "
            "(ROADMAP.md A16)")


def run_elastic(args):
    if getattr(args, "ranks_per_proc", 1) != 1:
        raise ValueError("an elastic worker holds one rank: "
                         "--ranks-per-worker must be 1 in an elastic job")
    min_np = args.min_np or args.np
    max_np = args.max_np or args.np
    if getattr(args, "discovery", None) is not None:
        # programmatic callers (gloo_run.launch_gloo_elastic /
        # ElasticSettings) hand over a ready HostDiscovery object
        discovery = args.discovery
    elif args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        slots=args.slots_per_host)
    elif args.hosts:
        from .hosts import parse_hosts
        discovery = FixedHosts({h.hostname: h.slots
                                for h in parse_hosts(args.hosts)})
    else:
        raise ValueError(
            "elastic mode needs --host-discovery-script or -H hosts")

    env = {}
    set_env_from_args(env, args)
    # programmatic callers (gloo_run.launch_gloo_elastic) pass a base env
    # for the workers; CLI-derived HOROVOD_* entries win over it
    extra = getattr(args, "extra_env", None)
    if extra:
        env = {**extra, **env}
    at_env = dict(os.environ)
    at_env.update(env)
    check_elastic_env(at_env)
    # the coordinator's fusion threshold, as the static launcher sets it
    mb = getattr(args, "fusion_threshold_mb", None)
    server = RendezvousServer(
        secret=bytes.fromhex(_secrets.token_hex(16)), world_size=0,
        fusion_threshold_bytes=int((64 if mb is None else mb) * 1024 * 1024),
        **coordinator_kwargs(at_env))
    coord_faults = None
    if at_env.get("HOROVOD_FAULT_PLAN"):
        # coordinator-side fault-plan events (side="coord") install into
        # the elastic rendezvous service too; rules persist across round
        # resets (elastic_run.py:43-54 of the JAX package)
        from ..chaos import (
            install_coordinator_rules, start_coordinator_faults,
        )
        install_coordinator_rules(server.coordinator, at_env)
    server.start()
    if at_env.get("HOROVOD_FAULT_PLAN"):
        coord_faults = start_coordinator_faults(server, at_env)
    cooldown = tuple(args.blacklist_cooldown_range) \
        if args.blacklist_cooldown_range else None
    driver = ElasticDriver(
        server, discovery, min_np=min_np, max_np=max_np,
        command=args.command, env=env, reset_limit=args.reset_limit,
        cooldown_range=cooldown,
        platform="cpu" if args.cpu else None, verbose=args.verbose,
        # at_env carries both the --elastic-timeout handoff and a
        # user-exported HOROVOD_ELASTIC_TIMEOUT, so the driver and the
        # workers' rendezvous (common/basics.py) agree on the bound
        elastic_timeout=float(
            at_env.get("HOROVOD_ELASTIC_TIMEOUT") or 600))
    try:
        # --start-timeout bounds the wait for min_np slots, NOT the job's
        # run time (reference launch_gloo_elastic semantics)
        driver.start(start_timeout=args.start_timeout)
        ok = driver.join()
    except TimeoutError as exc:
        print(f"horovod_tpu_torch elastic: {exc}", flush=True)
        driver.stop(error=True)
        driver.join()
        return 1
    finally:
        if coord_faults is not None:
            coord_faults.stop()
        server.stop()
    return 0 if ok else 1
