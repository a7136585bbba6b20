"""Job-wide observability (port of ``horovod_tpu/telemetry``): one metric
registry, Prometheus/JSON exposition, coordinator-side aggregation.

* :mod:`.registry` -- counters / gauges / bounded-bucket histograms in
  labeled families, cheap enough to update from the engine's dispatch
  loop;
* :mod:`.exporter` -- Prometheus text format v0.0.4 and JSON snapshots,
  the per-worker HTTP endpoint (``HOROVOD_METRICS_PORT``), the worker to
  coordinator snapshot push over the launcher's KV fabric;
* job-wide aggregation (counters sum, gauges per-worker max/min,
  histograms merge) served from the coordinator's ``/metrics``
  (runner/http/http_server.py).

The family catalogue below is the JAX package's, names, help text and
labels defined once here.  Families whose layers the port has not
ported (serving, the data plane, checkpoints, the pipeline runtime, the
fleet controller, integrity) are declared for parity and stay unused
until those slices land.

User surface: ``hvd.metrics()`` (snapshot dict),
``hvd.start_metrics_server()``.
"""

from .registry import (  # noqa: F401
    MetricRegistry, registry, install_registry, fresh_registry,
    merge_snapshots, DEFAULT_LATENCY_BUCKETS,
    REQUEST_LATENCY_BUCKETS,
)
from .exporter import (  # noqa: F401
    render_prometheus, render_json, MetricsServer,
    start_metrics_server, MetricsPusher, TELEMETRY_KV_PREFIX,
    CONTENT_TYPE_LATEST,
)


# -- fabric / chaos / liveness families (docs/fault_tolerance.md):
#    THE definitions every declaring site shares — the StoreClient,
#    the chaos injector, the engine catalogue and the coordinator's
#    hand-built liveness snapshot must not drift apart (the registry
#    keeps the first declaration's help/labels on re-registration).

FABRIC_RETRIES_FAMILY = "horovod_fabric_retries_total"
FABRIC_RETRIES_HELP = ("Fabric request retries (reconnects, 5xx, "
                       "safe timeouts), by verb")
FAULTS_INJECTED_FAMILY = "horovod_faults_injected_total"
FAULTS_INJECTED_HELP = ("Faults injected by the chaos subsystem, "
                        "by kind")
WORKER_ALIVE_FAMILY = "horovod_worker_alive"
WORKER_ALIVE_HELP = ("Worker liveness from coordinator heartbeats "
                     "(1 = beating, 0 = declared dead)")

# -- coordinator crash survival + steady-state bypass families
#    (docs/fault_tolerance.md "Coordinator crash survival"):
#    coord_epoch/journal live on the coordinator's liveness snapshot,
#    the bypass families on every worker's registry.

COORD_EPOCH_FAMILY = "horovod_coord_epoch"
COORD_EPOCH_HELP = ("Coordinator generation id; bumped every time a "
                    "restarted rendezvous service replays its journal")
JOURNAL_REPLAYED_FAMILY = "horovod_coord_journal_replayed_total"
JOURNAL_REPLAYED_HELP = ("Journal records replayed by the last "
                         "coordinator restart, by record kind")
BYPASS_CYCLES_FAMILY = "horovod_negotiation_bypass_cycles_total"
BYPASS_CYCLES_HELP = ("Steady-state negotiation bypass cycles: "
                      "outcome=hit executed the cached response list "
                      "without the coordinator, outcome=fallback "
                      "disengaged into full negotiation")
BYPASS_CYCLE_SECONDS_FAMILY = "horovod_bypass_cycle_seconds"
BYPASS_CYCLE_SECONDS_HELP = ("Agreement-vote + execution time of "
                             "bypass hit cycles")
COORD_RESYNCS_FAMILY = "horovod_coord_resyncs_total"
COORD_RESYNCS_HELP = ("Epoch-fenced resync handshakes this worker "
                      "performed against a restarted coordinator")

# -- per-host aggregator tier (docs/fault_tolerance.md "Per-host
#    aggregator tier"): the control-plane fan-in families live on the
#    coordinator's liveness snapshot (request counts per verb and
#    tier, distinct downstream clients per tier) — the scale harness's
#    "coordinator load scales with hosts, not procs" evidence — while
#    the per-tier cycle histogram is observed worker-side (one
#    negotiation round trip) and aggregator-side (one upstream batch
#    flush), and fallbacks/epoch ride the process registries.

CONTROL_REQUESTS_FAMILY = "horovod_control_requests_total"
CONTROL_REQUESTS_HELP = ("Control-plane requests handled by the "
                         "coordinator, by verb and by tier (agg = "
                         "batched aggregator upstream verbs, worker = "
                         "direct worker verbs)")
CONTROL_REQUESTS_LABELS = ("verb", "tier")
CONTROL_FANIN_FAMILY = "horovod_control_fanin_clients"
CONTROL_FANIN_HELP = ("Distinct downstream clients currently attached "
                      "to the coordinator, per control-plane tier "
                      "(agg = live per-host aggregators, direct = "
                      "procs beating without an aggregator)")
CONTROL_FANIN_LABELS = ("tier",)
CONTROL_CYCLE_SECONDS_FAMILY = "horovod_control_cycle_seconds"
CONTROL_CYCLE_SECONDS_HELP = ("Control-plane cycle time per tier "
                              "(worker = one negotiation round trip, "
                              "agg = one batched upstream flush)")
CONTROL_CYCLE_SECONDS_LABELS = ("tier",)
AGG_FALLBACKS_FAMILY = "horovod_agg_fallbacks_total"
AGG_FALLBACKS_HELP = ("Worker route changes off/onto the per-host "
                      "aggregator (reason=direct: fell back to the "
                      "coordinator, reason=reattach: probed back "
                      "onto a returned aggregator)")
AGG_EPOCH_FAMILY = "horovod_agg_epoch"
AGG_EPOCH_HELP = ("Per-host aggregator generation id; bumped every "
                  "time a (re)started aggregator re-registers with "
                  "the coordinator")

# -- multi-tenant fleet controller (docs/fleet.md): the per-job
#    goodput + chips-allocated families the day-in-the-life gate
#    asserts from the fleet's merged /metrics, plus the preemption /
#    suspension / SLO-conformance accounting.  The controller's own
#    registry is the only writer; the families are defined ONCE here
#    so tools/fleet_smoke.py and tests never drift from it.  The
#    training goodput unit is the worker-side elastic commit counter
#    below (serving goodput rides the existing
#    horovod_serving_requests_total{outcome="ok"}).

SERVING_REQUESTS_FAMILY = "horovod_serving_requests_total"
SERVING_REQUESTS_HELP = "Predict requests completed, by outcome"
FLEET_CHIPS_FAMILY = "horovod_fleet_chips_allocated"
FLEET_CHIPS_HELP = ("Worker slots (chips) the fleet controller "
                    "currently allocates to each job")
FLEET_CHIPS_LABELS = ("job",)
FLEET_GOODPUT_FAMILY = "horovod_fleet_job_goodput_total"
FLEET_GOODPUT_HELP = ("Per-job goodput units observed from the job's "
                      "merged telemetry (training: elastic commits, "
                      "serving: requests answered ok)")
FLEET_GOODPUT_LABELS = ("job",)
FLEET_PREEMPTIONS_FAMILY = "horovod_fleet_preemptions_total"
FLEET_PREEMPTIONS_HELP = ("Fleet reconfiguration actions applied "
                          "through the elasticity lever, by job and "
                          "action (grow/shrink/suspend/resume)")
FLEET_PREEMPTIONS_LABELS = ("job", "action")
FLEET_JOB_RUNNING_FAMILY = "horovod_fleet_job_running"
FLEET_JOB_RUNNING_HELP = ("1 while the job is placed and running, "
                          "0 while suspended or pending")
FLEET_JOB_RUNNING_LABELS = ("job",)
FLEET_SLO_BREACH_FAMILY = "horovod_fleet_slo_breach_ticks_total"
FLEET_SLO_BREACH_HELP = ("Reconcile ticks during which a serving "
                         "job's SLO signals (p99 / queue depth) were "
                         "in breach")
FLEET_SLO_BREACH_LABELS = ("job",)
ELASTIC_COMMITS_FAMILY = "horovod_elastic_commits_total"
ELASTIC_COMMITS_HELP = ("Elastic state commits by this worker — the "
                        "training goodput unit the fleet controller "
                        "aggregates per job")

# -- families registered from more than one layer (hvdlint checker 4
#    `telemetry-dup-family`): the compiled-path cache counters are
#    bumped by ops/compiled.py and pre-declared by the engine's
#    catalogue; the autotune families by core/autotune.py and the
#    catalogue; elastic resizes by common/basics.py and the catalogue.
#    One name + one help here, imported everywhere.

PROGRAM_CACHE_HITS_FAMILY = "horovod_program_cache_hits_total"
PROGRAM_CACHE_HITS_HELP = "Compiled-path program cache hits"
PROGRAM_CACHE_MISSES_FAMILY = "horovod_program_cache_misses_total"
PROGRAM_CACHE_MISSES_HELP = ("Compiled-path program cache misses "
                             "(new builds)")
COMPILE_SECONDS_FAMILY = "horovod_compile_seconds_total"
COMPILE_SECONDS_HELP = ("Seconds spent building + first-compiling "
                        "programs")
AUTOTUNE_SAMPLES_FAMILY = "horovod_autotune_samples_total"
AUTOTUNE_SAMPLES_HELP = "Autotune sample windows scored"
AUTOTUNE_BEST_SCORE_FAMILY = "horovod_autotune_best_score_bytes_per_sec"
AUTOTUNE_BEST_SCORE_HELP = ("Best autotune score observed (logical "
                            "bytes/sec)")
AUTOTUNE_BEST_CONFIG_FAMILY = "horovod_autotune_best_config"
AUTOTUNE_BEST_CONFIG_HELP = ("Current best autotune configuration "
                             "(value 1; the labels are the config)")
AUTOTUNE_BEST_CONFIG_LABELS = ("fusion_threshold_bytes",
                               "cycle_time_ms", "wire", "algorithm",
                               "pipeline", "shard_layout",
                               "overlap_bucket", "experts")
ELASTIC_RESIZE_FAMILY = "horovod_elastic_resize_events_total"
ELASTIC_RESIZE_HELP = ("Elastic membership changes seen by this "
                       "worker")

# -- per-hop wire accounting (docs/concepts.md "Per-hop wire"): the
#    engine's reduction dispatch and collective_bench both consume
#    these, so the family name lives ONCE here.  `hop` is the
#    decomposition stage the bytes rode (inner = intra-host / ICI,
#    cross = cross-host / DCN); `wire` is THAT hop's encoding — which
#    is how cross_wire_bytes splits by hop and wire under the per-hop
#    pair (a torus bucket with pair bf16:int4 accounts its ICI bytes
#    under {hop=inner, wire=bf16} and its DCN bytes under
#    {hop=cross, wire=int4}).

WIRE_HOP_BYTES_FAMILY = "horovod_wire_hop_bytes_total"
WIRE_HOP_BYTES_HELP = ("Interconnect bytes per decomposition hop, "
                       "labeled by that hop's wire encoding "
                       "(hop=inner: intra-host/ICI, hop=cross: "
                       "cross-host/DCN)")
WIRE_HOP_BYTES_LABELS = ("hop", "wire")

# -- ZeRO-grade weight-update sharding (docs/parallelism.md
#    "Weight-update sharding"; core/sharded.py + the sharded
#    frontends + ops/compiled.py): the state gauge is THE ÷dp
#    evidence — scope="shard" is what this rank actually holds,
#    scope="full" the dense equivalent, and a scrape divides them to
#    read dp.  The runs counter ticks once per
#    reducescatter→shard-update→allgather round.

OPTIMIZER_STATE_BYTES_FAMILY = "horovod_optimizer_state_bytes"
OPTIMIZER_STATE_BYTES_HELP = (
    "Optimizer-state bytes, by scope (shard = held by this rank "
    "under weight-update sharding, full = the dense equivalent; "
    "full/shard reads as dp)")
OPTIMIZER_STATE_BYTES_LABELS = ("scope",)
SHARDED_UPDATE_RUNS_FAMILY = "horovod_sharded_update_runs_total"
SHARDED_UPDATE_RUNS_HELP = (
    "Sharded weight-update rounds executed (reducescatter grads -> "
    "1/dp shard update -> allgather updated params)")

# -- end-to-end step integrity (docs/fault_tolerance.md "Silent data
#    corruption"; core/integrity.py): the checks counter is bumped at
#    every verification site (result=ok per clean bucket/round,
#    result=corrupt per detection; site in engine | compiled |
#    sentinel | guard | spill | broadcast), the rollbacks counter once
#    per quarantined step (labeled by the detection reason), and the
#    histogram times the divergence sentinel's fingerprint-fold +
#    MIN/MAX agreement rounds.  One definition here — the engine
#    catalogue, core/integrity.py and tools/integrity_smoke.py all
#    import it.

INTEGRITY_CHECKS_FAMILY = "horovod_integrity_checks_total"
INTEGRITY_CHECKS_HELP = (
    "Step-integrity verifications, by result (ok | corrupt) and site "
    "(engine/compiled wire checksums, sentinel agreement rounds, "
    "update guards, spill/broadcast CRC checks)")
INTEGRITY_CHECKS_LABELS = ("result", "site")
INTEGRITY_ROLLBACKS_FAMILY = "horovod_integrity_rollbacks_total"
INTEGRITY_ROLLBACKS_HELP = (
    "Steps quarantined by an integrity detection (update discarded, "
    "wire/bypass/autotune state reset, replay from the last elastic "
    "commit), by detection reason")
INTEGRITY_ROLLBACKS_LABELS = ("reason",)
INTEGRITY_SENTINEL_SECONDS_FAMILY = "horovod_integrity_sentinel_seconds"
INTEGRITY_SENTINEL_SECONDS_HELP = (
    "Wall seconds per divergence-sentinel round (param fingerprint "
    "fold + MIN/MAX agreement allreduce)")

# -- MPMD pipeline runtime (docs/parallelism.md; parallel/runtime.py):
#    the runtime and pp_smoke/benchmarks consume these, so the family
#    names live ONCE here.  `schedule` label values are the latched
#    "<schedule>@<n_micro>" tag (schedule.pp_label) the engine
#    cross-rank-validates on every overlapped gradient reduce.

PP_STEPS_FAMILY = "horovod_pp_steps_total"
PP_STEPS_HELP = ("Pipeline training steps executed, labeled by the "
                 "step's latched schedule@n_micro tag")
PP_STEPS_LABELS = ("schedule",)
PP_OVERLAP_FAMILY = "horovod_pp_overlapped_reductions_total"
PP_OVERLAP_HELP = ("Gradient allreduces submitted asynchronously into "
                   "pipeline bubbles (reduce ticks routed through the "
                   "engine before the step's last backward finished)")
PP_BUBBLE_FRACTION_FAMILY = "horovod_pp_bubble_fraction"
PP_BUBBLE_FRACTION_HELP = ("Analytic idle fraction of the stage x "
                           "tick grid for the latched schedule")
PP_RECV_WAIT_FAMILY = "horovod_pp_recv_wait_seconds_total"
PP_RECV_WAIT_HELP = ("Seconds stages spent blocked on activation / "
                     "gradient hops — the measured (residual) bubble "
                     "time after overlap, labeled by stage")
PP_RECV_WAIT_LABELS = ("stage",)

# -- bucket-granular comm/compute overlap (ops/compiled.py): the
#    compiled reducer splits the grouped program into per-bucket
#    programs dispatched as gradients arrive, pipelined against the
#    remaining backward compute.  `path` is the dispatch mode, a
#    closed set: "grouped" (single pre-overlap program) or
#    "bucketized".  Exposed-comm seconds is the wall time the caller
#    sat blocked on in-flight collective programs AFTER its own
#    compute finished — the un-hidden remainder the overlap PR
#    exists to shrink.

EXPOSED_COMM_SECONDS_FAMILY = "horovod_exposed_comm_seconds_total"
EXPOSED_COMM_SECONDS_HELP = (
    "Wall seconds the compiled path spent blocked on in-flight "
    "collective programs after its own compute had finished (the "
    "exposed, un-overlapped communication remainder), by dispatch "
    "path (grouped | bucketized)")
EXPOSED_COMM_SECONDS_LABELS = ("path",)
OVERLAP_BUCKETS_FAMILY = "horovod_overlap_buckets_dispatched_total"
OVERLAP_BUCKETS_HELP = (
    "Bucket-granular collective programs dispatched by the compiled "
    "path (one grouped launch counts 1; a bucketized step counts one "
    "per bucket)")

# -- fused quantized alltoall (docs/parallelism.md "Expert
#    parallelism"; core/engine.py + ops/compiled.py): the MoE
#    dispatch/combine wire.  Logical bytes are what the caller's exact
#    segments would cost at payload width; wire bytes are what the
#    encoded exchange actually moved (codes + block scales under
#    int8/int4, block-padded) — the logical/wire quotient is the
#    compression evidence (int8 ~3.97x).  `hop` classes each byte by
#    the destination peer's host (inner = same host / ICI, cross =
#    other host / DCN); `wire` is the exchange's encoding.  The runs
#    counter ticks once per exchange by path (engine | compiled), and
#    exposed seconds is the wall time a caller sat blocked on an
#    in-flight compiled alltoall after its own compute finished.

ALLTOALL_LOGICAL_BYTES_FAMILY = "horovod_alltoall_logical_bytes_total"
ALLTOALL_LOGICAL_BYTES_HELP = (
    "Alltoall payload bytes at logical (payload-dtype) width, by the "
    "destination hop class and the exchange's wire encoding")
ALLTOALL_LOGICAL_BYTES_LABELS = ("hop", "wire")
ALLTOALL_WIRE_BYTES_FAMILY = "horovod_alltoall_wire_bytes_total"
ALLTOALL_WIRE_BYTES_HELP = (
    "Alltoall bytes actually moved on the wire (encoded codes + "
    "block scales under int8/int4), by destination hop class and "
    "wire encoding")
ALLTOALL_WIRE_BYTES_LABELS = ("hop", "wire")
ALLTOALL_RUNS_FAMILY = "horovod_alltoall_runs_total"
ALLTOALL_RUNS_HELP = (
    "Alltoall exchanges executed, by path (engine | compiled) and "
    "wire encoding")
ALLTOALL_RUNS_LABELS = ("path", "wire")
ALLTOALL_EXPOSED_SECONDS_FAMILY = "horovod_alltoall_exposed_seconds_total"
ALLTOALL_EXPOSED_SECONDS_HELP = (
    "Wall seconds callers spent blocked on in-flight alltoall "
    "programs after their own compute had finished, by path")
ALLTOALL_EXPOSED_SECONDS_LABELS = ("path",)
# continuous-batching LM serving (docs/serving.md "Continuous
# batching"): TTFT + token throughput are the latency/goodput pair
# the autoscaler and the fleet controller size continuous jobs on,
# and the KV-block gauge is the paged cache's occupancy/leak signal
SERVING_TTFT_FAMILY = "horovod_serving_ttft_seconds"
SERVING_TTFT_HELP = (
    "Time to first generated token per sequence: submit to the "
    "prefill's first emitted token (continuous-batching decode path)")
SERVING_TOKENS_FAMILY = "horovod_serving_tokens_total"
SERVING_TOKENS_HELP = (
    "Tokens generated by the continuous batcher's decode loop "
    "(prefill first-tokens included) — the serving goodput unit "
    "tokens/sec signals derive from")
KV_BLOCKS_IN_USE_FAMILY = "horovod_kv_blocks_in_use"
KV_BLOCKS_IN_USE_HELP = (
    "Paged KV cache blocks currently allocated to live decode "
    "slots; must return to 0 on drain (leak check)")

# -- pod-scale data plane (docs/data.md): the journaled shard
#    service's wire/queue/cursor families, the eval-job goodput unit
#    the fleet controller aggregates for kind=eval, and the async
#    CRC-anchored checkpoint accounting.  One definition here — the
#    shard ledger, the data servers, tools/data_smoke.py and the
#    scale harness's data-plane phase all import it.

DATA_WIRE_BYTES_FAMILY = "horovod_data_wire_bytes_total"
DATA_WIRE_BYTES_HELP = (
    "Serialized sample-batch bytes moved by the data service "
    "(shard server -> consumer), by direction (sent | received)")
DATA_WIRE_BYTES_LABELS = ("direction",)
DATA_QUEUE_DEPTH_FAMILY = "horovod_data_queue_depth"
DATA_QUEUE_DEPTH_HELP = (
    "Batches currently staged ahead of consumption, per shard "
    "server (the input-bound backpressure signal)")
DATA_QUEUE_DEPTH_LABELS = ("shard",)
DATA_CURSOR_LAG_FAMILY = "horovod_data_cursor_lag"
DATA_CURSOR_LAG_HELP = (
    "Samples delivered to consumers but not yet acknowledged into "
    "the journaled shard cursor, per shard (the bounded-replay "
    "window a coordinator crash could replay)")
DATA_CURSOR_LAG_LABELS = ("shard",)
DATA_SAMPLES_FAMILY = "horovod_data_samples_total"
DATA_SAMPLES_HELP = (
    "Samples through the sharded input service, by outcome "
    "(delivered = handed to a consumer, acked = cursor journaled)")
DATA_SAMPLES_LABELS = ("outcome",)
DATA_REFORMS_FAMILY = "horovod_data_shard_reforms_total"
DATA_REFORMS_HELP = (
    "Shard-map re-formations from journaled cursors (resize, shard-"
    "server death, resume from suspend), by reason")
DATA_REFORMS_LABELS = ("reason",)
EVAL_BATCHES_FAMILY = "horovod_eval_batches_total"
EVAL_BATCHES_HELP = (
    "Eval batches scored against journaled eval-shard cursors — the "
    "eval-job goodput unit the fleet controller aggregates per job")
CKPT_ASYNC_COMMITS_FAMILY = "horovod_ckpt_async_commits_total"
CKPT_ASYNC_COMMITS_HELP = (
    "Async checkpoint commit outcomes (anchored = all shards landed "
    "and the commit record journaled, torn = a save died before "
    "anchoring, fallback = restore skipped past a torn save)")
CKPT_ASYNC_COMMITS_LABELS = ("outcome",)
CKPT_SHARD_BYTES_FAMILY = "horovod_ckpt_shard_bytes_total"
CKPT_SHARD_BYTES_HELP = (
    "CRC-trailed checkpoint shard bytes streamed to the store by "
    "the async checkpointer's background thread")


def account_alltoall_bytes(hop, wire, logical, actual):
    """Accumulate one alltoall hop's logical and wire bytes, into the
    process-current registry."""
    w = wire or "f32"
    registry().counter(
        ALLTOALL_LOGICAL_BYTES_FAMILY, ALLTOALL_LOGICAL_BYTES_HELP,
        labelnames=ALLTOALL_LOGICAL_BYTES_LABELS).labels(
        hop=hop, wire=w).inc(int(logical))
    registry().counter(
        ALLTOALL_WIRE_BYTES_FAMILY, ALLTOALL_WIRE_BYTES_HELP,
        labelnames=ALLTOALL_WIRE_BYTES_LABELS).labels(
        hop=hop, wire=w).inc(int(actual))


def count_alltoall_run(path, wire):
    """One alltoall exchange on ``path``, into the process-current
    registry."""
    registry().counter(
        ALLTOALL_RUNS_FAMILY, ALLTOALL_RUNS_HELP,
        labelnames=ALLTOALL_RUNS_LABELS).labels(
        path=path, wire=wire or "f32").inc()


def add_alltoall_exposed_seconds(path, seconds):
    """Accumulate exposed alltoall wall seconds (exchange in flight,
    no local compute left to hide it), into the process-current
    registry."""
    registry().counter(
        ALLTOALL_EXPOSED_SECONDS_FAMILY, ALLTOALL_EXPOSED_SECONDS_HELP,
        labelnames=ALLTOALL_EXPOSED_SECONDS_LABELS).labels(
        path=path).inc(seconds)


def add_exposed_comm_seconds(path, seconds):
    """Accumulate exposed-communication wall seconds (collective in
    flight, no local compute left to hide it) for one dispatch path,
    into the process-current registry."""
    registry().counter(
        EXPOSED_COMM_SECONDS_FAMILY, EXPOSED_COMM_SECONDS_HELP,
        labelnames=EXPOSED_COMM_SECONDS_LABELS).labels(
        path=path).inc(seconds)


def count_overlap_buckets(n=1):
    """Count bucket programs dispatched by the compiled path, into
    the process-current registry."""
    registry().counter(OVERLAP_BUCKETS_FAMILY,
                       OVERLAP_BUCKETS_HELP).inc(n)


def count_fabric_retry(verb):
    """One fabric retry attempt, into the process-current registry
    (resolved per call: the engine installs a fresh registry each
    lifecycle and the StoreClient outlives it)."""
    registry().counter(FABRIC_RETRIES_FAMILY, FABRIC_RETRIES_HELP,
                       labelnames=("verb",)).labels(verb=verb).inc()


def count_fault_injected(kind):
    """One chaos injection, into the process-current registry."""
    registry().counter(FAULTS_INJECTED_FAMILY, FAULTS_INJECTED_HELP,
                       labelnames=("kind",)).labels(kind=kind).inc()


def count_coord_resync():
    """One epoch resync handshake (the StoreController performed it
    against a restarted coordinator), into the process-current
    registry."""
    registry().counter(COORD_RESYNCS_FAMILY, COORD_RESYNCS_HELP).inc()


def count_agg_fallback(reason):
    """One worker route change off/onto its per-host aggregator
    (TieredStoreClient), into the process-current registry."""
    registry().counter(AGG_FALLBACKS_FAMILY, AGG_FALLBACKS_HELP,
                       labelnames=("reason",)).labels(
        reason=reason).inc()


def observe_control_cycle(tier, seconds):
    """One control-plane cycle observation (worker negotiation round
    trip, or aggregator upstream flush), into the process-current
    registry."""
    registry().histogram(
        CONTROL_CYCLE_SECONDS_FAMILY, CONTROL_CYCLE_SECONDS_HELP,
        labelnames=CONTROL_CYCLE_SECONDS_LABELS).labels(
        tier=tier).observe(seconds)


def count_integrity_check(result, site):
    """One integrity verification outcome, into the process-current
    registry (resolved per call: the engine installs a fresh registry
    each lifecycle and the elastic spill path outlives it)."""
    registry().counter(
        INTEGRITY_CHECKS_FAMILY, INTEGRITY_CHECKS_HELP,
        labelnames=INTEGRITY_CHECKS_LABELS).labels(
        result=result, site=site).inc()


def count_integrity_rollback(reason):
    """One quarantined step (integrity detection -> update discarded,
    replay from the last elastic commit), into the process-current
    registry."""
    registry().counter(
        INTEGRITY_ROLLBACKS_FAMILY, INTEGRITY_ROLLBACKS_HELP,
        labelnames=INTEGRITY_ROLLBACKS_LABELS).labels(
        reason=reason).inc()


def observe_sentinel_seconds(seconds):
    """One divergence-sentinel round's wall time, into the
    process-current registry."""
    registry().histogram(
        INTEGRITY_SENTINEL_SECONDS_FAMILY,
        INTEGRITY_SENTINEL_SECONDS_HELP).observe(seconds)


def count_sharded_update():
    """One sharded weight-update round (core/sharded.ShardedUpdater
    or the pp runtime's sharded dp hop), into the process-current
    registry."""
    registry().counter(SHARDED_UPDATE_RUNS_FAMILY,
                       SHARDED_UPDATE_RUNS_HELP).inc()


def set_optimizer_state_bytes(scope, nbytes):
    """Export this worker's optimizer-state bytes under ``scope``
    ('shard' | 'full') — the weight-update-sharding memory evidence."""
    registry().gauge(
        OPTIMIZER_STATE_BYTES_FAMILY, OPTIMIZER_STATE_BYTES_HELP,
        labelnames=OPTIMIZER_STATE_BYTES_LABELS).labels(
        scope=scope).set(int(nbytes))


def observe_serving_ttft(seconds):
    """One sequence's time-to-first-token, into the process-current
    registry (submit → first emitted token on the continuous decode
    path)."""
    registry().histogram(
        SERVING_TTFT_FAMILY, SERVING_TTFT_HELP,
        buckets=REQUEST_LATENCY_BUCKETS).observe(seconds)


def count_serving_tokens(n=1):
    """``n`` tokens emitted by the continuous batcher, into the
    process-current registry."""
    registry().counter(SERVING_TOKENS_FAMILY,
                       SERVING_TOKENS_HELP).inc(int(n))


def set_kv_blocks_in_use(n):
    """Current paged KV cache block occupancy (live decode slots),
    into the process-current registry."""
    registry().gauge(KV_BLOCKS_IN_USE_FAMILY,
                     KV_BLOCKS_IN_USE_HELP).set(int(n))


def add_data_wire_bytes(direction, nbytes):
    """Accumulate serialized data-service bytes for ``direction``
    ('sent' | 'received'), into the process-current registry."""
    registry().counter(
        DATA_WIRE_BYTES_FAMILY, DATA_WIRE_BYTES_HELP,
        labelnames=DATA_WIRE_BYTES_LABELS).labels(
        direction=direction).inc(int(nbytes))


def set_data_queue_depth(shard, depth):
    """Current staged-batch depth for one shard server, into the
    process-current registry."""
    registry().gauge(
        DATA_QUEUE_DEPTH_FAMILY, DATA_QUEUE_DEPTH_HELP,
        labelnames=DATA_QUEUE_DEPTH_LABELS).labels(
        shard=str(shard)).set(int(depth))


def set_data_cursor_lag(shard, lag):
    """Delivered-but-unacked sample count for one shard, into the
    process-current registry."""
    registry().gauge(
        DATA_CURSOR_LAG_FAMILY, DATA_CURSOR_LAG_HELP,
        labelnames=DATA_CURSOR_LAG_LABELS).labels(
        shard=str(shard)).set(int(lag))


def count_data_samples(outcome, n=1):
    """``n`` samples through the sharded input service under
    ``outcome`` ('delivered' | 'acked'), into the process-current
    registry."""
    registry().counter(
        DATA_SAMPLES_FAMILY, DATA_SAMPLES_HELP,
        labelnames=DATA_SAMPLES_LABELS).labels(
        outcome=outcome).inc(int(n))


def count_data_reform(reason):
    """One shard-map re-formation from journaled cursors, into the
    process-current registry."""
    registry().counter(
        DATA_REFORMS_FAMILY, DATA_REFORMS_HELP,
        labelnames=DATA_REFORMS_LABELS).labels(reason=reason).inc()


def count_eval_batches(n=1):
    """``n`` eval batches scored — the eval goodput unit, into the
    process-current registry."""
    registry().counter(EVAL_BATCHES_FAMILY,
                       EVAL_BATCHES_HELP).inc(int(n))


def count_ckpt_commit(outcome):
    """One async-checkpoint commit outcome ('anchored' | 'torn' |
    'fallback'), into the process-current registry."""
    registry().counter(
        CKPT_ASYNC_COMMITS_FAMILY, CKPT_ASYNC_COMMITS_HELP,
        labelnames=CKPT_ASYNC_COMMITS_LABELS).labels(
        outcome=outcome).inc()


def add_ckpt_shard_bytes(nbytes):
    """Accumulate CRC-trailed checkpoint shard bytes streamed by the
    async checkpointer, into the process-current registry."""
    registry().counter(CKPT_SHARD_BYTES_FAMILY,
                       CKPT_SHARD_BYTES_HELP).inc(int(nbytes))


def metrics():
    """Snapshot of the process-current registry (JSON-able dict keyed
    by family name) — the programmatic twin of ``GET /metrics.json``."""
    return registry().snapshot()


def counter_total(name, **labels):
    """Convenience: current value of a counter/gauge family summed
    over children (or one child when ``labels`` are given).  Benchmarks
    read deltas of these instead of reaching into engine attributes."""
    fam = registry().get(name)
    if fam is None:
        return 0.0
    if labels:
        return fam.value(**labels)
    return fam.total()
