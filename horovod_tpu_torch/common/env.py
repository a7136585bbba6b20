"""Environment-variable configuration: the subset of
``horovod_tpu/common/env.py`` this port reads, under the same
``HOROVOD_*`` names and defaults (reference common/common.h:115-149)."""

import logging
import os

from ..ops.quantize import normalize_inner_wire, normalize_wire_dtype

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
# default wire of float Sum/Average allreduces: f32|fp16|bf16|int8|int4.
# OUTER (the cross-host hop, the only hop of a flat collective) wins
# over the uniform WIRE_DTYPE shorthand
HOROVOD_WIRE_DTYPE = "HOROVOD_WIRE_DTYPE"
HOROVOD_WIRE_OUTER = "HOROVOD_WIRE_OUTER"
# the inner (intra-host) hop's wire under a hierarchical/torus allreduce
HOROVOD_WIRE_INNER = "HOROVOD_WIRE_INNER"
# default reduction algorithm: flat|hierarchical|torus; the reference's
# boolean toggles alias it (TORUS wins over HIERARCHICAL)
HOROVOD_ALLREDUCE_ALGORITHM = "HOROVOD_ALLREDUCE_ALGORITHM"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_TORUS_ALLREDUCE = "HOROVOD_TORUS_ALLREDUCE"
# max payload bytes per compiled bucket program (0 = one grouped program)
HOROVOD_OVERLAP_BUCKET_BYTES = "HOROVOD_OVERLAP_BUCKET_BYTES"
# wire integrity digests: on by default in the JAX package; the port has
# none yet (ROADMAP.md A14), so only an explicit request reads it, and
# the compiled reducer refuses it
HOROVOD_INTEGRITY = "HOROVOD_INTEGRITY"
# reducescatter backward convention: default matches the reference (Sum
# grad x= size, Average unscaled); 1 = the true adjoint of the forward
HOROVOD_EXACT_ADJOINT_REDUCESCATTER = \
    "HOROVOD_EXACT_ADJOINT_REDUCESCATTER"
# ZeRO-grade weight-update sharding (core/sharded.py): 1 makes
# DistributedOptimizer default to sharded=True; the shard-bucket layout
# is bucket (fusion-threshold buckets) or flat (one per dtype and group)
HOROVOD_SHARDED_OPTIMIZER = "HOROVOD_SHARDED_OPTIMIZER"
HOROVOD_SHARD_LAYOUT = "HOROVOD_SHARD_LAYOUT"

# the launcher's env handoff (runner/proc_run.slot_env; reference
# gloo_run.py:66-103): topology, the rendezvous/coordinator address and
# its HMAC secret, and this worker's process index
HOROVOD_CONTROLLER = "HOROVOD_CONTROLLER"
HOROVOD_HOSTNAME = "HOROVOD_HOSTNAME"
HOROVOD_RENDEZVOUS_ADDR = "HOROVOD_GLOO_RENDEZVOUS_ADDR"
HOROVOD_RENDEZVOUS_PORT = "HOROVOD_GLOO_RENDEZVOUS_PORT"
HOROVOD_SECRET_KEY = "HOROVOD_SECRET_KEY"
HOROVOD_TPU_PROC_INDEX = "HOROVOD_TPU_PROC_INDEX"
HOROVOD_TPU_NUM_PROCS = "HOROVOD_TPU_NUM_PROCS"
HOROVOD_TPU_RANKS_PER_PROC = "HOROVOD_TPU_RANKS_PER_PROC"
HOROVOD_TPU_COORDINATOR = "HOROVOD_TPU_COORDINATOR"
HOROVOD_TPU_HOST_OF_RANK = "HOROVOD_TPU_HOST_OF_RANK"
# the port's device and backend handoff: the launcher's --cpu puts the
# workers on the CPU; CPU tensors always ride gloo, CUDA tensors ride
# NCCL unless GPU_OPERATIONS=gloo (the reference's own knob name)
HOROVOD_TORCH_PLATFORM = "HOROVOD_TORCH_PLATFORM"
HOROVOD_GPU_OPERATIONS = "HOROVOD_GPU_OPERATIONS"
# seconds init() waits for torch.distributed's rendezvous
HOROVOD_TPU_INIT_TIMEOUT = "HOROVOD_TPU_INIT_TIMEOUT"
# worker liveness: the beat cadence (0 disables); the launcher's
# coordinator reads it too, with HOROVOD_HEARTBEAT_WINDOW_SECONDS
# (runner/http/http_server.coordinator_kwargs)
HOROVOD_HEARTBEAT_INTERVAL_SECONDS = "HOROVOD_HEARTBEAT_INTERVAL_SECONDS"
# steady-state negotiation bypass (core/bypass.py): identical negotiation
# cycles before the ranks agree over the collective path instead of the
# coordinator (0 disables), and the bound on an armed cycle's wait for
# the cached tensors before the unanimous fallback
HOROVOD_BYPASS_AFTER_CYCLES = "HOROVOD_BYPASS_AFTER_CYCLES"
HOROVOD_BYPASS_WAIT_SECONDS = "HOROVOD_BYPASS_WAIT_SECONDS"
# per-process rank counts of a heterogeneous host:slots job (the
# launcher's ranks_per_proc="host"), one entry per process
HOROVOD_TPU_RANKS_OF_PROC = "HOROVOD_TPU_RANKS_OF_PROC"
# elastic jobs (runner/elastic/driver.py spawns every worker with
# HOROVOD_ELASTIC=1): the crash-durable state spill directory
# (common/elastic.py), the bound on a worker's wait for its round at the
# rendezvous (the reference's --elastic-timeout), and the bound on an
# elastic teardown's wait for the engine thread (a thread wedged in a
# collective with a peer that left makes the worker exec-restart)
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_STATE_SPILL = "HOROVOD_STATE_SPILL"
HOROVOD_ELASTIC_TIMEOUT = "HOROVOD_ELASTIC_TIMEOUT"
HOROVOD_TEARDOWN_BARRIER_SECONDS = "HOROVOD_TEARDOWN_BARRIER_SECONDS"
# chaos and fabric hardening (the JAX package's names and defaults):
# HOROVOD_FAULT_PLAN names a seeded fault plan (inline JSON, @path or a
# bare file path; horovodrun --fault-plan), HOROVOD_FAULT_SEED overrides
# its seed; the coordinator declares a proc dead after
# HEARTBEAT_WINDOW seconds without a beat (0 = 1.5x the interval);
# fabric retries are bounded by attempts and a wall deadline
HOROVOD_FAULT_PLAN = "HOROVOD_FAULT_PLAN"
HOROVOD_FAULT_SEED = "HOROVOD_FAULT_SEED"
HOROVOD_HEARTBEAT_WINDOW_SECONDS = "HOROVOD_HEARTBEAT_WINDOW_SECONDS"
HOROVOD_FABRIC_RETRY_ATTEMPTS = "HOROVOD_FABRIC_RETRY_ATTEMPTS"
HOROVOD_FABRIC_RETRY_DEADLINE_SECONDS = \
    "HOROVOD_FABRIC_RETRY_DEADLINE_SECONDS"
# coordinator crash survival: COORD_JOURNAL names the launcher-side
# control-plane journal a restarted rendezvous service replays
# (epoch-fenced), with its compaction threshold and per-value KV cap;
# COORD_OUTAGE_DEADLINE bounds how long connection failures and
# replay-safe requests keep retrying across a coordinator outage
HOROVOD_COORD_JOURNAL = "HOROVOD_COORD_JOURNAL"
HOROVOD_COORD_JOURNAL_MAX_BYTES = "HOROVOD_COORD_JOURNAL_MAX_BYTES"
HOROVOD_COORD_JOURNAL_KV_MAX_BYTES = \
    "HOROVOD_COORD_JOURNAL_KV_MAX_BYTES"
HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS = \
    "HOROVOD_COORD_OUTAGE_DEADLINE_SECONDS"
# per-host aggregator tier (runner/http/aggregator.py): TIER selects the
# control-plane topology (flat = every proc talks to the coordinator,
# host = one aggregator per host batches its workers' traffic
# upstream); LINGER_MS is the aggregator's batching window;
# FALLBACK_DEADLINE bounds a worker's retries against a silent
# aggregator before it falls back to direct coordinator mode
HOROVOD_CONTROL_PLANE_TIER = "HOROVOD_CONTROL_PLANE_TIER"
HOROVOD_AGG_LINGER_MS = "HOROVOD_AGG_LINGER_MS"
HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS = \
    "HOROVOD_AGG_FALLBACK_DEADLINE_SECONDS"

DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 1.0
DEFAULT_STALL_WARNING_SECS = 60.0


def get_bool(name, default=False):
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() in ("1", "true", "yes", "on")


def _warn_malformed(name, val, default):
    logging.getLogger("horovod_tpu_torch").warning(
        "%s=%r is not a valid number; using default %r", name, val, default)


def get_int(name, default=0):
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return int(val)
    except ValueError:
        _warn_malformed(name, val, default)
        return default


def get_str(name, default=None):
    val = os.environ.get(name)
    return default if val is None or not val.strip() else val.strip()


def get_float(name, default=0.0):
    val = os.environ.get(name)
    if val is None or not val.strip():
        return default
    try:
        return float(val)
    except ValueError:
        _warn_malformed(name, val, default)
        return default


class Config:
    """Engine knobs, read once at ``init()``."""

    def __init__(self):
        self.fusion_threshold_bytes = get_int(
            HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES)
        self.cycle_time_ms = get_float(HOROVOD_CYCLE_TIME,
                                       DEFAULT_CYCLE_TIME_MS)
        self.stall_check_disable = get_bool(HOROVOD_STALL_CHECK_DISABLE)
        self.stall_warning_secs = get_float(
            HOROVOD_STALL_CHECK_TIME_SECONDS, DEFAULT_STALL_WARNING_SECS)
        self.stall_shutdown_secs = get_float(
            HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0)
        # process-wide default wire (per-request wire_dtype= overrides;
        # None = full width), normalized: an unknown spelling raises
        self.wire_dtype = normalize_wire_dtype(
            os.environ.get(HOROVOD_WIRE_OUTER)
            or os.environ.get(HOROVOD_WIRE_DTYPE))
        # the inner (intra-host) hop's default wire under a 2-D
        # decomposition: full width or 16-bit only
        self.wire_inner = normalize_inner_wire(
            os.environ.get(HOROVOD_WIRE_INNER))
        # default reduction algorithm of float Sum/Average allreduces
        # (per-request algorithm= overrides); the reference's boolean
        # toggles alias the generic knob, TORUS winning over
        # HIERARCHICAL (env.py:440-451 of the JAX package)
        from .topology import normalize_algorithm
        if get_bool(HOROVOD_TORUS_ALLREDUCE):
            self.algorithm = "torus"
        elif get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE):
            self.algorithm = "hierarchical"
        else:
            self.algorithm = normalize_algorithm(
                os.environ.get(HOROVOD_ALLREDUCE_ALGORITHM))
        # latched once per compiled reducer call or stream
        self.overlap_bucket_bytes = get_int(HOROVOD_OVERLAP_BUCKET_BYTES, 0)
        self.integrity = get_bool(HOROVOD_INTEGRITY, False)
        # the default frontends resolve sharded=None against, and the
        # shard-bucket layout (a malformed one fails here, at init)
        self.sharded_optimizer = get_bool(HOROVOD_SHARDED_OPTIMIZER)
        from ..core.sharded import normalize_shard_layout
        self.shard_layout = normalize_shard_layout(
            os.environ.get(HOROVOD_SHARD_LAYOUT, "").strip())
        # multi-process jobs beat the coordinator from their own thread
        self.heartbeat_secs = get_float(
            HOROVOD_HEARTBEAT_INTERVAL_SECONDS, 5.0)
        # multi-process jobs arm the negotiation bypass after K stable
        # cycles by default, as the JAX package's do (env.py:506-509)
        self.bypass_after_cycles = get_int(HOROVOD_BYPASS_AFTER_CYCLES, 5)
        self.bypass_wait_secs = get_float(HOROVOD_BYPASS_WAIT_SECONDS, 10.0)
        # a worker of an elastic job (env.py:469 of the JAX package)
        self.elastic = get_bool(HOROVOD_ELASTIC)
        # the seeded fault plan's source (chaos/plan.py reads it)
        self.fault_plan = get_str(HOROVOD_FAULT_PLAN)
