"""``horovodrun`` CLI for the port (port of ``horovod_tpu/runner/launch.py``;
reference ``horovod/runner/launch.py``: arg surface :286-528,
run_commandline :830, _run :806).

    python -m horovod_tpu_torch.runner.launch -np 2 [--cpu] -- python train.py

A static job spawns one worker process per ``--ranks-per-worker`` ranks
(or per host entry with ``--ranks-per-worker host``) with the full
``HOROVOD_*`` env handoff (proc_run.py); a ``-H`` host that is not this
machine gets its workers over ssh.  ``--min-np``, ``--max-np`` or
``--host-discovery-script`` make the job elastic (elastic_run.py): the
elastic driver spawns one worker a slot, each holding one rank, and
re-forms the job when a worker dies or discovery changes.  ``--mpi`` and
``--gloo`` are accepted and change nothing, as in the JAX package.  The
parser is the JAX package's, flag for flag; the flags of features the
port has not ported yet are refused with the ROADMAP.md item that ports
them (the fleet: A17; pipelining: A15; serving: A16).  The six
``--autotune*`` flags reach the workers' env, and ``--autotune`` turns on
the coordinator-side tuner.  The tracing and telemetry flags (``--timeline-filename``,
``--timeline-mark-cycles``, ``--trace-ring-events``, ``--trace-dump-dir``,
``--trace-clock-sync-seconds``, ``--metrics-port``,
``--metrics-push-seconds``) reach the workers' env.
"""

import argparse
import os
import sys

from .config_parser import parse_config_file, set_env_from_args
from .hosts import parse_host_files

#: (parsed attribute, ROADMAP.md item): flags whose features are not
#: ported; a run that sets one is refused
_UNPORTED_FLAGS = (
    ("fleet_spec", "A17"),
    ("pipeline_stages", "A15"), ("num_microbatches", "A15"),
    ("pipeline_schedule", "A15"), ("pipeline_chunks", "A15"),
    ("serve", "A16"), ("serve_port", "A16"), ("serve_max_batch_size", "A16"),
    ("serve_max_latency_ms", "A16"), ("serve_batch_buckets", "A16"),
    ("serve_slo_p99_ms", "A16"), ("serve_queue_high", "A16"),
    ("serve_autoscale_seconds", "A16"), ("serve_drain_seconds", "A16"),
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="horovodrun",
        description="Launch a horovod_tpu_torch distributed job.")
    parser.add_argument("-v", "--version", action="store_true",
                        help="Shows horovod_tpu_torch version.")
    parser.add_argument("-np", "--num-proc", type=int, dest="np",
                        help="Total number of training ranks.")
    parser.add_argument("-H", "--hosts", dest="hosts",
                        help="host1:slots,host2:slots list.")
    parser.add_argument("-hostfile", "--hostfile", dest="hostfile",
                        help="Host file with 'name slots=N' lines.")
    parser.add_argument("--ranks-per-worker", default=1,
                        dest="ranks_per_proc",
                        type=lambda s: s if s == "host" else int(s),
                        help="Rank threads per worker process, or "
                             "'host': one process per -H entry holding "
                             "that entry's slots (the reference's "
                             "heterogeneous h1:4,h2:2 layout).")
    parser.add_argument("--cpu", action="store_true",
                        help="Run the workers on the CPU (gloo).")
    parser.add_argument("--gloo", action="store_true",
                        help="Accepted for reference compatibility; CPU "
                             "tensors always ride gloo.")
    parser.add_argument("--mpi", action="store_true",
                        help="Accepted for reference compatibility.")
    parser.add_argument("--check-build", action="store_true",
                        help="Show available framework frontends.")
    parser.add_argument("--start-timeout", type=float, default=None,
                        help="Seconds to wait for the job to finish "
                             "launching.")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--output-filename", default=None,
                        help="directory for per-rank output capture: "
                             "worker stdout/stderr are saved to "
                             "<dir>/rank.<rank>/{stdout,stderr} "
                             "(rank zero-padded)")
    parser.add_argument("--config-file", dest="config_file",
                        help="YAML file with launcher parameters.")
    # tunables (reference launch.py:373-431)
    parser.add_argument("--fusion-threshold-mb", type=float, default=None)
    parser.add_argument("--cycle-time-ms", type=float, default=None)
    parser.add_argument("--cache-capacity", type=int, default=None)
    # topology-aware collectives (the source fork's NCCL torus-
    # allreduce flag plus upstream's hierarchical toggle, mapped to
    # the same HOROVOD_* env names workers read)
    parser.add_argument("--torus-allreduce", action="store_true",
                        help="decompose float Sum/Average allreduces "
                             "over a 2-D torus factorization of the "
                             "ranks (HOROVOD_TORUS_ALLREDUCE)")
    parser.add_argument("--hierarchical-allreduce", action="store_true",
                        help="reducescatter within each host, "
                             "allreduce the shards across hosts, "
                             "allgather back "
                             "(HOROVOD_HIERARCHICAL_ALLREDUCE)")
    parser.add_argument("--allreduce-algorithm", default=None,
                        choices=["flat", "hierarchical", "torus"],
                        help="generic spelling of the algorithm knob "
                             "(HOROVOD_ALLREDUCE_ALGORITHM); the "
                             "boolean flags above win when both are "
                             "given")
    # per-hop quantized wire (docs/concepts.md "Per-hop wire")
    parser.add_argument("--wire-dtype", default=None,
                        choices=["f32", "fp16", "bf16", "int8",
                                 "int4"],
                        help="uniform wire shorthand for every "
                             "reduction (HOROVOD_WIRE_DTYPE): 16-bit "
                             "values apply to both hops of a "
                             "decomposed allreduce, int8/int4 to the "
                             "cross-host hop only")
    parser.add_argument("--wire-inner", default=None,
                        choices=["f32", "fp16", "bf16"],
                        help="intra-host/ICI hop wire of the per-hop "
                             "pair (HOROVOD_WIRE_INNER; quantized "
                             "formats are not legal on this hop)")
    parser.add_argument("--wire-outer", default=None,
                        choices=["f32", "fp16", "bf16", "int8",
                                 "int4"],
                        help="cross-host/DCN hop wire of the per-hop "
                             "pair (HOROVOD_WIRE_OUTER; wins over "
                             "--wire-dtype)")
    # MPMD pipeline runtime (docs/parallelism.md)
    parser.add_argument("--pipeline-stages", type=int, default=None,
                        help="carve the job into this many pipeline "
                             "stages backed by per-stage process "
                             "sets (HOROVOD_PP_STAGES; 1 = no "
                             "pipelining)")
    parser.add_argument("--num-microbatches", type=int, default=None,
                        help="microbatches per pipelined step "
                             "(HOROVOD_PP_MICROBATCHES; 0 = auto, "
                             "also the autotuner's seventh-dimension "
                             "sweep variable)")
    parser.add_argument("--pipeline-schedule", default=None,
                        choices=["gpipe", "1f1b", "interleaved"],
                        help="pipeline schedule the per-rank "
                             "instruction streams follow "
                             "(HOROVOD_PP_SCHEDULE; default 1f1b, "
                             "gpipe is the fill-drain fallback)")
    parser.add_argument("--pipeline-chunks", type=int, default=None,
                        help="model chunks per stage for the "
                             "interleaved schedule "
                             "(HOROVOD_PP_CHUNKS; 0 = auto: 2)")
    parser.add_argument("--autotune-cache-file", default=None,
                        help="local JSON warm-start cache of "
                             "converged autotune optima keyed by "
                             "(bucket signature, topology, world "
                             "size) (HOROVOD_AUTOTUNE_CACHE)")
    # timeline + job-wide tracing (docs/timeline.md)
    parser.add_argument("--timeline-filename", default=None)
    parser.add_argument("--timeline-mark-cycles", action="store_true")
    parser.add_argument("--trace-ring-events", type=int, default=None,
                        help="flight-recorder ring size per worker "
                             "(events; 0 disables) — the buffer stall "
                             "warnings auto-dump and GET /timeline "
                             "merges (HOROVOD_TRACE_RING_EVENTS)")
    parser.add_argument("--trace-dump-dir", default=None,
                        help="directory flight-recorder auto-dumps "
                             "are written into as stand-alone Chrome "
                             "traces (HOROVOD_TRACE_DUMP_DIR; unset = "
                             "KV push only)")
    parser.add_argument("--trace-clock-sync-seconds", type=float,
                        default=None,
                        help="cadence of the NTP-style clock re-sync "
                             "mapping each worker's timeline onto the "
                             "launcher's clock "
                             "(HOROVOD_TRACE_CLOCK_SYNC_SECONDS)")
    # telemetry (docs/observability.md)
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="base port for per-worker Prometheus "
                             "/metrics endpoints (worker i binds "
                             "port+i on its host); also enables the "
                             "job-wide /metrics on the launcher's "
                             "rendezvous service "
                             "(HOROVOD_METRICS_PORT)")
    parser.add_argument("--metrics-push-seconds", type=float,
                        default=None,
                        help="cadence of worker snapshot pushes into "
                             "the job-wide aggregation "
                             "(HOROVOD_METRICS_PUSH_SECONDS)")
    # autotune
    parser.add_argument("--autotune", action="store_true")
    parser.add_argument("--autotune-log-file", default=None)
    parser.add_argument("--autotune-warmup-samples", type=int,
                        default=None)
    parser.add_argument("--autotune-steps-per-sample", type=int,
                        default=None)
    parser.add_argument("--autotune-bayes-opt-max-samples", type=int,
                        default=None)
    parser.add_argument("--disable-cache", action="store_true",
                        help="disable the coordinator response cache "
                             "(HOROVOD_CACHE_CAPACITY=0)")
    # chaos + liveness (docs/fault_tolerance.md)
    parser.add_argument("--fault-plan", default=None,
                        help="seeded fault-injection plan: inline "
                             "JSON, @/path, or a path to a JSON file "
                             "(HOROVOD_FAULT_PLAN); worker-side "
                             "events ride the env handoff, "
                             "coordinator-side events install into "
                             "the launcher's rendezvous service")
    parser.add_argument("--fault-seed", type=int, default=None,
                        help="override the plan's RNG seed "
                             "(HOROVOD_FAULT_SEED)")
    parser.add_argument("--heartbeat-interval-seconds", type=float,
                        default=None,
                        help="worker liveness heartbeat cadence; the "
                             "coordinator fails a silent worker's "
                             "pending collectives after ~1.5x this "
                             "(0 disables; "
                             "HOROVOD_HEARTBEAT_INTERVAL_SECONDS)")
    parser.add_argument("--heartbeat-window-seconds", type=float,
                        default=None,
                        help="explicit missed-beat death window "
                             "(default 1.5x the interval; "
                             "HOROVOD_HEARTBEAT_WINDOW_SECONDS)")
    # coordinator crash survival + steady-state bypass
    # (docs/fault_tolerance.md "Coordinator crash survival")
    parser.add_argument("--coord-journal", default=None,
                        help="path for the launcher-side control-plane "
                             "journal; a restarted rendezvous service "
                             "replays it (epoch-fenced) instead of "
                             "killing every healthy worker "
                             "(HOROVOD_COORD_JOURNAL)")
    parser.add_argument("--coord-outage-deadline-seconds", type=float,
                        default=None,
                        help="how long replay-safe fabric requests "
                             "keep retrying across a coordinator "
                             "outage (default 120; "
                             "HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS)")
    parser.add_argument("--bypass-after-cycles", type=int, default=None,
                        help="identical negotiation cycles before the "
                             "ranks bypass the coordinator via a "
                             "bitvector agreement on the collective "
                             "path (0 disables; default 5; "
                             "HOROVOD_BYPASS_AFTER_CYCLES)")
    parser.add_argument("--bypass-wait-seconds", type=float,
                        default=None,
                        help="bound on each bypass cycle's wait for "
                             "the cached tensors before forcing full "
                             "renegotiation "
                             "(HOROVOD_BYPASS_WAIT_SECONDS)")
    # per-host aggregator tier (docs/fault_tolerance.md "Per-host
    # aggregator tier"): coordinator load scales with hosts, not procs
    parser.add_argument("--control-plane-tier", default=None,
                        choices=["flat", "host"],
                        help="control-plane topology: 'flat' fans "
                             "every proc into the coordinator; "
                             "'host' runs one aggregator per host "
                             "that batches its workers' ready-"
                             "reports/heartbeats/polls upstream "
                             "(HOROVOD_CONTROL_PLANE_TIER)")
    parser.add_argument("--agg-linger-ms", type=float, default=None,
                        help="aggregator batching window: how long "
                             "the upstream flusher waits for "
                             "co-reporting local workers "
                             "(HOROVOD_AGG_LINGER_MS)")
    parser.add_argument("--agg-fallback-deadline-seconds",
                        type=float, default=None,
                        help="how long a worker's requests retry "
                             "against a silent aggregator before "
                             "falling back to direct coordinator "
                             "mode (HOROVOD_AGG_FALLBACK_DEADLINE_"
                             "SECONDS)")
    # serving tier (docs/serving.md): --serve marks the job as an
    # inference fleet — workers run hvd.serving.start() replicas, the
    # knobs ride the same HOROVOD_SERVING_* env handoff as every other
    # launcher setting, and (elastic jobs) the launcher attaches the
    # SLO autoscaler to the elastic driver
    parser.add_argument("--serve", action="store_true",
                        help="serving job: enable the serving env "
                             "handoff and (with elastic flags) the "
                             "SLO-driven autoscaler "
                             "(HOROVOD_SERVING=1)")
    parser.add_argument("--serve-port", type=int, default=None,
                        help="base port for per-replica HTTP predict "
                             "frontends (replica i on a host binds "
                             "port+i; HOROVOD_SERVING_PORT)")
    parser.add_argument("--serve-max-batch-size", type=int,
                        default=None,
                        help="dynamic batcher: max requests per "
                             "device batch "
                             "(HOROVOD_SERVING_MAX_BATCH_SIZE)")
    parser.add_argument("--serve-max-latency-ms", type=float,
                        default=None,
                        help="dynamic batcher: max time a request "
                             "waits for co-riders "
                             "(HOROVOD_SERVING_MAX_LATENCY_MS)")
    parser.add_argument("--serve-batch-buckets", default=None,
                        help="comma-separated bucketed batch sizes "
                             "the compiled path pads to (default: "
                             "powers of two up to the max; "
                             "HOROVOD_SERVING_BATCH_BUCKETS)")
    parser.add_argument("--serve-slo-p99-ms", type=float, default=None,
                        help="p99 latency SLO the autoscaler defends "
                             "(HOROVOD_SERVING_SLO_P99_MS)")
    parser.add_argument("--serve-queue-high", type=int, default=None,
                        help="queue-depth high-water mark that also "
                             "triggers scale-up "
                             "(HOROVOD_SERVING_QUEUE_HIGH)")
    parser.add_argument("--serve-autoscale-seconds", type=float,
                        default=None,
                        help="autoscaler evaluation cadence "
                             "(HOROVOD_SERVING_AUTOSCALE_SECONDS)")
    parser.add_argument("--serve-drain-seconds", type=float,
                        default=None,
                        help="max time a draining replica waits for "
                             "queued requests before shutdown "
                             "(HOROVOD_SERVING_DRAIN_SECONDS)")
    # stall check
    parser.add_argument("--no-stall-check", action="store_true")
    parser.add_argument("--stall-check-warning-time-seconds", type=float,
                        default=None)
    parser.add_argument("--stall-check-shutdown-time-seconds", type=float,
                        default=None)
    parser.add_argument("--log-level", default=None,
                        choices=["TRACE", "DEBUG", "INFO", "WARNING",
                                 "ERROR", "FATAL"])
    # elastic (reference launch.py elastic group)
    parser.add_argument("--min-np", type=int, default=None)
    parser.add_argument("--max-np", type=int, default=None)
    parser.add_argument("--host-discovery-script", default=None)
    parser.add_argument("--slots-per-host", type=int, default=None)
    parser.add_argument("--reset-limit", type=int, default=None)
    # default None (not 600): the env handoff in set_env_from_args
    # only fires when the flag is given, so an exported
    # HOROVOD_ELASTIC_TIMEOUT keeps flowing through untouched; the
    # 600 s fallback lives in the driver and the worker init barrier
    parser.add_argument("--elastic-timeout", type=float, default=None,
                        help="bound on each round's (re-)initialization "
                             "after a membership change; a round whose "
                             "workers never all rendezvous restarts "
                             "(never bounds healthy training; "
                             "default 600)")
    parser.add_argument("--blacklist-cooldown-range", type=int, nargs=2,
                        default=None)
    # multi-tenant fleet (docs/fleet.md): N jobs over one shared host
    # pool; per-job commands/env live in the spec, so the ordinary
    # -np/command surface is not used
    parser.add_argument("--fleet-spec", default=None,
                        help="JSON fleet spec (inline, @/path, or a "
                             "bare path): jobs + shared host pool for "
                             "the multi-tenant fleet controller "
                             "(HOROVOD_FLEET_SPEC); see docs/fleet.md")
    parser.add_argument("command", nargs=argparse.REMAINDER,
                        help="Command to run on each rank.")
    args = parser.parse_args(argv)
    if args.config_file:
        parse_config_file(args.config_file, args)
    return args


def unported_flags(args):
    """``[(flag, ROADMAP.md item)]`` of the parsed flags whose features
    the port has not ported (a flag counts when it is set: not None,
    False or an empty list)."""
    out = []
    for attr, item in _UNPORTED_FLAGS:
        value = getattr(args, attr, None)
        if value not in (None, False, []):
            out.append(("--" + attr.replace("_", "-"), item))
    return out


def check_build():
    """The port's frontends, controllers and tensor operations, each line
    read from the build-feature queries of ``common/basics.py``."""
    from ..common import basics
    from ..version import __version__

    def mark(flag):
        return "X" if flag else " "
    lines = [f"Horovod-TPU-Torch v{__version__}:", "",
             "Available frameworks:", "    [X] PyTorch", "",
             "Available controllers:",
             f"    [{mark(basics.mpi_enabled())}] MPI",
             f"    [{mark(basics.gloo_enabled())}] Gloo (the HTTP store "
             f"coordinator)", "", "Available tensor operations:",
             f"    [{mark(basics.nccl_built())}] NCCL (CUDA tensors, one "
             f"process a GPU)",
             f"    [{mark(basics.ddl_built())}] DDL",
             f"    [{mark(basics.ccl_built())}] CCL",
             f"    [{mark(basics.mpi_built())}] MPI",
             f"    [{mark(basics.gloo_built())}] Gloo (CPU tensors; CUDA "
             f"tensors with HOROVOD_GPU_OPERATIONS=gloo)"]
    print("\n".join(lines))


def _run_static(args):
    from .proc_run import launch_procs
    env = {}
    set_env_from_args(env, args)
    # the coordinator's fusion threshold (0 is a threshold too: one
    # bucket per tensor)
    mb = 64 if args.fusion_threshold_mb is None else args.fusion_threshold_mb
    fusion = int(mb * 1024 * 1024)
    codes = launch_procs(
        args.command, np=args.np, hosts=args.hosts,
        ranks_per_proc=args.ranks_per_proc, env=env,
        platform="cpu" if args.cpu else None,
        verbose=args.verbose, fusion_threshold_bytes=fusion,
        start_timeout=args.start_timeout,
        output_filename=args.output_filename)
    return max(codes) if codes else 0


def _run_elastic(args):
    from .elastic_run import run_elastic
    return run_elastic(args)


def run_commandline(argv=None):
    args = parse_args(argv)
    if args.version:
        from ..version import __version__
        print(__version__)
        return 0
    if args.check_build:
        check_build()
        return 0
    refused = unported_flags(args)
    if refused:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(
                f"{flag} (ROADMAP.md {item})" for flag, item in refused))
    if not args.command:
        print("horovodrun: no command given", file=sys.stderr)
        return 2
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if args.hostfile:
        args.hosts = parse_host_files(args.hostfile)
    if args.np is None:
        print("horovodrun: -np is required", file=sys.stderr)
        return 2
    if args.host_discovery_script or args.min_np or args.max_np:
        return _run_elastic(args)
    return _run_static(args)


def main():
    sys.exit(run_commandline())


# -- reference launch.py surface (launch.py:426-546 of the JAX package:
#    constants, controller selection, argparse action factories) -------------

CACHE_FOLDER = os.path.join(os.path.expanduser("~"), ".horovod")
CACHE_STALENESS_THRESHOLD_MINUTES = 60
SSH_ATTEMPTS = 3
SSH_CONNECT_TIMEOUT_S = 10


def is_gloo_used(use_gloo=None, use_mpi=None, use_jsrun=None):
    """Reference launch.py is_gloo_used: gloo (the store controller's
    role here) is the launcher unless MPI or jsrun was asked for by name,
    which the port refuses (runner/mpi_run.py, runner/js_run.py)."""
    return bool(use_gloo) or not (use_mpi or use_jsrun)


def run_controller(use_gloo, gloo_run_fn, use_mpi, mpi_run_fn,
                   use_jsrun, js_run_fn, verbosity=0):
    """Pick and invoke the launch path (reference launch.py
    run_controller).  The gloo-role path is the only live one; an
    explicit MPI or jsrun request reaches its run fn, which raises
    naming the supported launcher."""
    if use_mpi:
        return mpi_run_fn()
    if use_jsrun:
        return js_run_fn()
    return gloo_run_fn()


def make_override_action(override_args):
    """argparse action recording which flags the user set explicitly,
    so config-file values don't clobber them (reference launch.py
    make_override_action; consumed by
    common.util.config_parser.set_args_from_config)."""

    class StoreOverrideAction(argparse.Action):
        def __init__(self, option_strings, dest, default=None,
                     type=None, choices=None, required=False,
                     help=None, nargs=None, const=None, metavar=None):
            super().__init__(option_strings=option_strings, dest=dest,
                             default=default, type=type,
                             choices=choices, required=required,
                             help=help, nargs=nargs, const=const,
                             metavar=metavar)

        def __call__(self, parser, args, values, option_string=None):
            override_args.add(self.dest)
            setattr(args, self.dest, values)

    return StoreOverrideAction


def make_override_bool_action(override_args, bool_value):
    """Const-storing flag action (reference launch.py:185): --flag
    pairs register one action with True and its --no-flag twin with
    False, both recording the override."""

    class StoreOverrideBoolAction(argparse.Action):
        def __init__(self, option_strings, dest, required=False,
                     help=None):
            super().__init__(option_strings=option_strings, dest=dest,
                             const=bool_value, nargs=0, default=None,
                             required=required, help=help)

        def __call__(self, parser, args, values, option_string=None):
            override_args.add(self.dest)
            setattr(args, self.dest, self.const)

    return StoreOverrideBoolAction


def make_override_true_action(override_args):
    return make_override_bool_action(override_args, True)


def make_override_false_action(override_args):
    return make_override_bool_action(override_args, False)


def make_deprecated_bool_action(override_args, replacement_option):
    class DeprecatedBoolAction(argparse.Action):
        def __init__(self, option_strings, dest, **kwargs):
            kwargs.setdefault("nargs", 0)
            kwargs.pop("const", None)
            super().__init__(option_strings, dest, **kwargs)

        def __call__(self, parser, args, values, option_string=None):
            import warnings
            warnings.warn(
                f"Argument {option_string} is deprecated; use "
                f"{replacement_option} instead", DeprecationWarning)
            override_args.add(self.dest)
            setattr(args, self.dest, True)

    return DeprecatedBoolAction


def make_check_build_action(np_arg):
    class CheckBuildAction(argparse.Action):
        def __init__(self, option_strings, dest, **kwargs):
            kwargs.setdefault("nargs", 0)
            super().__init__(option_strings, dest, **kwargs)

        def __call__(self, parser, args, values, option_string=None):
            check_build()
            parser.exit()

    return CheckBuildAction


def make_nic_action(_override_args=None):
    class StoreNicAction(argparse.Action):
        def __call__(self, parser, args, values, option_string=None):
            if _override_args is not None:
                _override_args.add(self.dest)
            setattr(args, self.dest,
                    set(v.strip() for v in str(values).split(",")
                        if v.strip()))

    return StoreNicAction


if __name__ == "__main__":
    main()
