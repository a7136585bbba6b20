"""CLI/config-file -> environment translation (port of
``horovod_tpu/runner/config_parser.py``; reference
``horovod/runner/common/util/config_parser.py``: set_env_from_args maps
``--fusion-threshold-mb`` -> ``HOROVOD_FUSION_THRESHOLD`` etc.; a YAML
config file feeds the same overrides, launch.py:345-348).  The mapping
is the JAX package's, flag for flag, so a worker sees the same
``HOROVOD_*`` settings under either launcher; the port's own workers
read the subset it has ported (common/env.py), and the launcher refuses
the flags whose features are not ported (runner/launch.py)."""


# reference config_parser.py constants
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_METRICS_PORT = "HOROVOD_METRICS_PORT"
HOROVOD_METRICS_PUSH_SECONDS = "HOROVOD_METRICS_PUSH_SECONDS"
HOROVOD_TRACE_RING_EVENTS = "HOROVOD_TRACE_RING_EVENTS"
HOROVOD_TRACE_DUMP_DIR = "HOROVOD_TRACE_DUMP_DIR"
HOROVOD_TRACE_CLOCK_SYNC_SECONDS = "HOROVOD_TRACE_CLOCK_SYNC_SECONDS"
HOROVOD_FAULT_PLAN = "HOROVOD_FAULT_PLAN"
HOROVOD_FAULT_SEED = "HOROVOD_FAULT_SEED"
HOROVOD_HEARTBEAT_INTERVAL_SECONDS = "HOROVOD_HEARTBEAT_INTERVAL_SECONDS"
HOROVOD_HEARTBEAT_WINDOW_SECONDS = "HOROVOD_HEARTBEAT_WINDOW_SECONDS"
HOROVOD_COORD_JOURNAL = "HOROVOD_COORD_JOURNAL"
HOROVOD_ELASTIC_TIMEOUT = "HOROVOD_ELASTIC_TIMEOUT"
HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS = \
    "HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS"
HOROVOD_BYPASS_AFTER_CYCLES = "HOROVOD_BYPASS_AFTER_CYCLES"
HOROVOD_BYPASS_WAIT_SECONDS = "HOROVOD_BYPASS_WAIT_SECONDS"
HOROVOD_CONTROL_PLANE_TIER = "HOROVOD_CONTROL_PLANE_TIER"
HOROVOD_AGG_LINGER_MS = "HOROVOD_AGG_LINGER_MS"
HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS = \
    "HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
# topology-aware collectives (common/env.py reads these; the boolean
# pair carries the reference's knob names, the generic one the
# flat/hierarchical/torus spelling)
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_TORUS_ALLREDUCE = "HOROVOD_TORUS_ALLREDUCE"
HOROVOD_ALLREDUCE_ALGORITHM = "HOROVOD_ALLREDUCE_ALGORITHM"
# per-hop quantized wire (common/env.py reads these: DTYPE is the
# uniform shorthand, INNER/OUTER the explicit per-hop pair)
HOROVOD_WIRE_DTYPE = "HOROVOD_WIRE_DTYPE"
HOROVOD_WIRE_INNER = "HOROVOD_WIRE_INNER"
HOROVOD_WIRE_OUTER = "HOROVOD_WIRE_OUTER"
# MPMD pipeline runtime (common/env.py reads these;
# docs/parallelism.md knob catalogue)
HOROVOD_PP_STAGES = "HOROVOD_PP_STAGES"
HOROVOD_PP_MICROBATCHES = "HOROVOD_PP_MICROBATCHES"
HOROVOD_PP_SCHEDULE = "HOROVOD_PP_SCHEDULE"
HOROVOD_PP_CHUNKS = "HOROVOD_PP_CHUNKS"
HOROVOD_AUTOTUNE_CACHE = "HOROVOD_AUTOTUNE_CACHE"


def set_env_from_args(env: dict, args) -> dict:
    """Translate parsed CLI args into HOROVOD_* env entries."""
    def setb(name, val):
        if val:
            env[name] = "1"

    if getattr(args, "fusion_threshold_mb", None) is not None:
        env[HOROVOD_FUSION_THRESHOLD] = str(
            int(args.fusion_threshold_mb * 1024 * 1024))
    if getattr(args, "cycle_time_ms", None) is not None:
        env[HOROVOD_CYCLE_TIME] = str(args.cycle_time_ms)
    if getattr(args, "cache_capacity", None) is not None:
        env[HOROVOD_CACHE_CAPACITY] = str(args.cache_capacity)
    if getattr(args, "timeline_filename", None):
        env[HOROVOD_TIMELINE] = args.timeline_filename
    setb(HOROVOD_TIMELINE_MARK_CYCLES,
         getattr(args, "timeline_mark_cycles", False))
    if getattr(args, "trace_ring_events", None) is not None:
        env[HOROVOD_TRACE_RING_EVENTS] = str(args.trace_ring_events)
    if getattr(args, "trace_dump_dir", None):
        env[HOROVOD_TRACE_DUMP_DIR] = args.trace_dump_dir
    if getattr(args, "trace_clock_sync_seconds", None) is not None:
        env[HOROVOD_TRACE_CLOCK_SYNC_SECONDS] = str(
            args.trace_clock_sync_seconds)
    setb(HOROVOD_AUTOTUNE, getattr(args, "autotune", False))
    if getattr(args, "autotune_log_file", None):
        env[HOROVOD_AUTOTUNE_LOG] = args.autotune_log_file
    if getattr(args, "autotune_warmup_samples", None) is not None:
        env["HOROVOD_AUTOTUNE_WARMUP_SAMPLES"] = str(
            args.autotune_warmup_samples)
    if getattr(args, "autotune_steps_per_sample", None) is not None:
        env["HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"] = str(
            args.autotune_steps_per_sample)
    if getattr(args, "autotune_bayes_opt_max_samples", None) is not None:
        env["HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"] = str(
            args.autotune_bayes_opt_max_samples)
    if getattr(args, "disable_cache", False):
        # capacity 0 disables the coordinator response cache entirely
        # (reference --disable-cache -> HOROVOD_CACHE_CAPACITY=0)
        env[HOROVOD_CACHE_CAPACITY] = "0"
    if getattr(args, "metrics_port", None) is not None:
        env[HOROVOD_METRICS_PORT] = str(args.metrics_port)
    if getattr(args, "metrics_push_seconds", None) is not None:
        env[HOROVOD_METRICS_PUSH_SECONDS] = str(
            args.metrics_push_seconds)
    if getattr(args, "fault_plan", None):
        raise NotImplementedError(
            "--fault-plan: chaos fault injection is not ported yet "
            "(ROADMAP.md A17)")
    if getattr(args, "fault_seed", None) is not None:
        env[HOROVOD_FAULT_SEED] = str(args.fault_seed)
    if getattr(args, "heartbeat_interval_seconds", None) is not None:
        env[HOROVOD_HEARTBEAT_INTERVAL_SECONDS] = str(
            args.heartbeat_interval_seconds)
    if getattr(args, "heartbeat_window_seconds", None) is not None:
        env[HOROVOD_HEARTBEAT_WINDOW_SECONDS] = str(
            args.heartbeat_window_seconds)
    if getattr(args, "elastic_timeout", None) is not None:
        # the elastic driver bounds each round's re-init with this
        # launcher-side, but workers ALSO wait on it at the init
        # barrier (common/basics.py reads HOROVOD_ELASTIC_TIMEOUT) —
        # without the handoff the flag silently didn't reach them
        # (found by hvdlint knob-flag-unhandled)
        env[HOROVOD_ELASTIC_TIMEOUT] = str(args.elastic_timeout)
    if getattr(args, "coord_journal", None):
        env[HOROVOD_COORD_JOURNAL] = args.coord_journal
    if getattr(args, "coord_outage_deadline_seconds", None) is not None:
        env[HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS] = str(
            args.coord_outage_deadline_seconds)
    if getattr(args, "bypass_after_cycles", None) is not None:
        env[HOROVOD_BYPASS_AFTER_CYCLES] = str(
            args.bypass_after_cycles)
    if getattr(args, "bypass_wait_seconds", None) is not None:
        env[HOROVOD_BYPASS_WAIT_SECONDS] = str(
            args.bypass_wait_seconds)
    if getattr(args, "control_plane_tier", None):
        env[HOROVOD_CONTROL_PLANE_TIER] = args.control_plane_tier
    if getattr(args, "agg_linger_ms", None) is not None:
        env[HOROVOD_AGG_LINGER_MS] = str(args.agg_linger_ms)
    if getattr(args, "agg_fallback_deadline_seconds", None) is not None:
        env[HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS] = str(
            args.agg_fallback_deadline_seconds)
    if getattr(args, "serve", False):
        env["HOROVOD_SERVING"] = "1"
        # the autoscaler is blind without the replicas' snapshot
        # stream: serving jobs push metrics even when no --metrics-port
        # is exposed (an explicit --metrics-push-seconds above wins)
        env.setdefault("HOROVOD_METRICS_PUSH_SECONDS", "2")
    if getattr(args, "serve_port", None) is not None:
        env["HOROVOD_SERVING_PORT"] = str(args.serve_port)
    if getattr(args, "serve_max_batch_size", None) is not None:
        env["HOROVOD_SERVING_MAX_BATCH_SIZE"] = str(
            args.serve_max_batch_size)
    if getattr(args, "serve_max_latency_ms", None) is not None:
        env["HOROVOD_SERVING_MAX_LATENCY_MS"] = str(
            args.serve_max_latency_ms)
    if getattr(args, "serve_batch_buckets", None):
        env["HOROVOD_SERVING_BATCH_BUCKETS"] = \
            str(args.serve_batch_buckets)
    if getattr(args, "serve_slo_p99_ms", None) is not None:
        env["HOROVOD_SERVING_SLO_P99_MS"] = str(args.serve_slo_p99_ms)
    if getattr(args, "serve_queue_high", None) is not None:
        env["HOROVOD_SERVING_QUEUE_HIGH"] = str(args.serve_queue_high)
    if getattr(args, "serve_autoscale_seconds", None) is not None:
        env["HOROVOD_SERVING_AUTOSCALE_SECONDS"] = str(
            args.serve_autoscale_seconds)
    if getattr(args, "serve_drain_seconds", None) is not None:
        env["HOROVOD_SERVING_DRAIN_SECONDS"] = str(
            args.serve_drain_seconds)
    setb(HOROVOD_STALL_CHECK_DISABLE,
         getattr(args, "no_stall_check", False))
    if getattr(args, "stall_check_warning_time_seconds", None) is not None:
        env[HOROVOD_STALL_CHECK_TIME_SECONDS] = str(
            args.stall_check_warning_time_seconds)
    if getattr(args, "stall_check_shutdown_time_seconds", None) is not None:
        env[HOROVOD_STALL_SHUTDOWN_TIME_SECONDS] = str(
            args.stall_check_shutdown_time_seconds)
    if getattr(args, "log_level", None):
        env[HOROVOD_LOG_LEVEL] = args.log_level
    setb(HOROVOD_TORUS_ALLREDUCE,
         getattr(args, "torus_allreduce", False))
    setb(HOROVOD_HIERARCHICAL_ALLREDUCE,
         getattr(args, "hierarchical_allreduce", False))
    if getattr(args, "allreduce_algorithm", None):
        env[HOROVOD_ALLREDUCE_ALGORITHM] = args.allreduce_algorithm
    if getattr(args, "wire_dtype", None):
        env[HOROVOD_WIRE_DTYPE] = args.wire_dtype
    if getattr(args, "wire_inner", None):
        env[HOROVOD_WIRE_INNER] = args.wire_inner
    if getattr(args, "wire_outer", None):
        env[HOROVOD_WIRE_OUTER] = args.wire_outer
    if getattr(args, "pipeline_stages", None) is not None:
        env[HOROVOD_PP_STAGES] = str(args.pipeline_stages)
    if getattr(args, "num_microbatches", None) is not None:
        env[HOROVOD_PP_MICROBATCHES] = str(args.num_microbatches)
    if getattr(args, "pipeline_schedule", None):
        env[HOROVOD_PP_SCHEDULE] = args.pipeline_schedule
    if getattr(args, "pipeline_chunks", None) is not None:
        env[HOROVOD_PP_CHUNKS] = str(args.pipeline_chunks)
    if getattr(args, "autotune_cache_file", None):
        env[HOROVOD_AUTOTUNE_CACHE] = args.autotune_cache_file
    return env


def parse_config_file(path, args):
    """Apply a YAML config file onto the args namespace (reference
    launch.py:345-348 + config_parser.py): CLI flags win over file
    values, file values win over defaults."""
    import yaml
    with open(path) as f:
        config = yaml.safe_load(f) or {}
    for key, value in config.items():
        attr = key.replace("-", "_")
        if hasattr(args, attr) and getattr(args, attr) in (None, False):
            setattr(args, attr, value)
    return args
