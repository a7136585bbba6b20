"""Reference import path ``horovod.runner.common.util.config_parser``
(port of ``horovod_tpu/runner/common/util/config_parser.py``): the live
implementation is the port's ``runner/config_parser.py``; this module
re-exports it and carries the reference's full env-name constant set
(names the port does not act on are accepted so that ported config
files parse)."""

from ...config_parser import (  # noqa: F401
    HOROVOD_AUTOTUNE,
    HOROVOD_AUTOTUNE_LOG,
    HOROVOD_CACHE_CAPACITY,
    HOROVOD_CYCLE_TIME,
    HOROVOD_FUSION_THRESHOLD,
    HOROVOD_HIERARCHICAL_ALLREDUCE,
    HOROVOD_LOG_LEVEL,
    HOROVOD_STALL_CHECK_DISABLE,
    HOROVOD_STALL_CHECK_TIME_SECONDS,
    HOROVOD_STALL_SHUTDOWN_TIME_SECONDS,
    HOROVOD_TIMELINE,
    HOROVOD_TIMELINE_MARK_CYCLES,
    HOROVOD_TORUS_ALLREDUCE,
    parse_config_file,
    set_env_from_args,
)
from .env import LOG_LEVEL_STR as LOG_LEVELS  # noqa: F401

# autotune sampling knobs (the JAX package's core/autotune.py reads
# these; the port's autotuner is ROADMAP.md A14)
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = \
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = \
    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"

# reference names the port does not act on (accepted for config-file
# compatibility).  HOROVOD_HIERARCHICAL_ALLREDUCE /
# HOROVOD_TORUS_ALLREDUCE are re-exported above: the launcher hands their
# flags to the workers, whose Config reads them (common/env.py).
HOROVOD_GLOO_TIMEOUT_SECONDS = "HOROVOD_GLOO_TIMEOUT_SECONDS"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"
HOROVOD_MPI_THREADS_DISABLE = "HOROVOD_MPI_THREADS_DISABLE"
HOROVOD_NUM_NCCL_STREAMS = "HOROVOD_NUM_NCCL_STREAMS"
HOROVOD_THREAD_AFFINITY = "HOROVOD_THREAD_AFFINITY"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"
NCCL_IB_DISABLE = "NCCL_IB_DISABLE"


def set_args_from_config(args, config, override_args):
    """Apply a parsed config dict onto the args namespace, skipping
    names the user overrode on the CLI (reference config_parser.py
    set_args_from_config)."""
    for key, value in (config or {}).items():
        attr = key.replace("-", "_")
        if attr in (override_args or set()):
            continue
        if hasattr(args, attr):
            setattr(args, attr, value)
    return args


def validate_config_args(args):
    """Reference config_parser.py validate_config_args — range checks
    on the tunables."""
    fusion = getattr(args, "fusion_threshold_mb", None)
    if fusion is not None and fusion < 0:
        raise ValueError("--fusion-threshold-mb must be >= 0")
    cycle = getattr(args, "cycle_time_ms", None)
    if cycle is not None and cycle <= 0:
        raise ValueError("--cycle-time-ms must be > 0")
    cache = getattr(args, "cache_capacity", None)
    if cache is not None and cache < 0:
        raise ValueError("--cache-capacity must be >= 0")
