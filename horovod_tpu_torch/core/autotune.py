"""Runtime parameter autotuning (port of ``horovod_tpu/core/autotune.py``;
reference ``horovod/common/parameter_manager.{h,cc}``: score = bytes/sec
over sample windows, warmup discard, Bayesian optimization over tunables,
CSV log via HOROVOD_AUTOTUNE_LOG, converge-to-best after max samples).

The vector, the suggestions, the CSV and the cache are the JAX
package's for the same scores.  Some dimensions differ in what applies
them here: the multithreaded-pack threshold is kept although the port
packs on the device (``config.pack_mt_threshold_bytes`` is written and
read by nothing, as the JAX coordinator-side tuner already sweeps it
where nothing applies it), so that the vector and the CSV stay the JAX
package's; so are the response-cache capacity on the engine (only the
coordinator has the cache) and the MoE pair (its reader, the
expert-parallel ``capacity_moe_apply``, is ROADMAP.md A15's); the
pipeline dimension is refused (``tune_pipeline=True`` raises: the MPMD
pipeline runtime is A15).

Tunables here are the six that exist on the TPU engine: the fusion
threshold (bucket size for packed allreduces), the cycle time (how
long the background thread batches submissions), the
multithreaded-pack threshold (bucket size above which the native pack
fans out across threads), the coordinator response-cache capacity
(the reference tunes cache on/off, parameter_manager.h:65; here the
LRU size tunes smoothly with 0 = disabled), the per-hop WIRE PAIR
((inner, outer) — full width / 16-bit on the intra-host/ICI hop,
anything up to block-scaled int4 on the cross-host/DCN hop,
ops/quantize.py WIRE_PAIR_CHOICES: a LEGAL-PAIR ENUMERATION swept as
ONE categorical, not a cross product — intra-hop int4 is never
legal, so the grid never proposes it), and the reduction ALGORITHM
(flat / hierarchical / torus, common/topology.py — the reference's
HOROVOD_HIERARCHICAL_ALLREDUCE / HOROVOD_TORUS_ALLREDUCE toggles as
one swept categorical).  The score is LOGICAL bytes/sec —
gradient goodput — so shrinking the wire payload (or keeping it off
the cross-host hop) raises the score exactly when the interconnect,
not the chip, is the bottleneck: that is how the parameter manager
learns to turn quantization or hierarchical routing on for
network-bound jobs and leave them off when the extra hops outweigh
the saved slow-hop bytes.  Algorithms that do not factor the running
topology silently execute flat (engine._algo_plan), so a sweep never
breaks a job — it just scores the fallback.
"""

import json
import os
import time

import numpy as np

from .optim import BayesianOptimizer
from .sharded import SHARD_LAYOUT_CHOICES
from ..common.env import OVERLAP_BUCKET_CHOICES
from ..common.topology import ALGORITHMS
from ..ops.quantize import WIRE_PAIR_CHOICES, wire_pair_label
# the pipeline dimension is refused (ROADMAP.md A15): no PP_CHOICES
PP_CHOICES = None
pp_label = None
# MOE_CHOICES / moe_label load lazily (parallel.moe): only MoE jobs
# (config.moe_experts > 0) pay the parallel import
MOE_CHOICES = None
moe_label = None

# log2 bounds: fusion threshold 1 MiB .. 256 MiB, cycle 0.5 .. 32 ms,
# MT-pack threshold 1 MiB .. 64 MiB, cache capacity 0 .. 4096 entries
_FUSION_LO, _FUSION_HI = 20.0, 28.0
_CYCLE_LO, _CYCLE_HI = -1.0, 5.0
_PACKMT_LO, _PACKMT_HI = 20.0, 26.0
_CACHE_BITS = 12.0


class ParameterManager:
    def __init__(self, config, warmup_samples=3, steps_per_sample=10,
                 max_samples=20, log_path=None, seed=0, tune_wire=True,
                 tune_algorithm=True, tune_pipeline=False,
                 tune_sharded=False, tune_overlap=False,
                 tune_moe=False, cache_path=None, topo_fp="local",
                 world_size=1):
        self.config = config
        self.warmup_samples = warmup_samples
        self.steps_per_sample = steps_per_sample
        self.max_samples = max_samples
        self.active = True
        # tune_wire=False / tune_algorithm=False drop those categorical
        # dimensions entirely: the coordinator-side autotuner
        # (runner/http/http_server) has no distribution channel for a
        # tuned wire format or algorithm (workers applying a new
        # default at different cycles would fail the cross-process
        # consistency check), and sweeping a dimension nothing applies
        # would waste samples and write never-applied values into the
        # CSV
        self.tune_wire = bool(tune_wire)
        self.tune_algorithm = bool(tune_algorithm)
        # seventh dimension: the pipeline (schedule, n_micro) pair —
        # only swept when the job actually runs the MPMD pipeline
        # runtime (config.pp_stages > 1); the runtime re-latches the
        # pair at each step start and snaps an indivisible n_micro to
        # the nearest legal value, so a sweep can propose any bin
        # without breaking a step mid-flight
        self.tune_pipeline = bool(tune_pipeline)
        if self.tune_pipeline:
            raise NotImplementedError(
                "tune_pipeline: the autotuner's pipeline dimension sweeps "
                "the MPMD pipeline runtime, which is not ported yet "
                "(ROADMAP.md A15)")
        # EIGHTH dimension: the shard-bucket layout of the sharded
        # weight update (core/sharded.SHARD_LAYOUT_CHOICES) — only
        # swept when the job runs DistributedOptimizer(sharded=True);
        # the updaters re-shard deterministically when a sweep flips
        # it (a coordinated vote, never mid-step)
        self.tune_sharded = bool(tune_sharded)
        # NINTH dimension: the compiled path's overlap bucket ceiling
        # (common/env.OVERLAP_BUCKET_CHOICES; 0 = one grouped
        # program) — only swept when HOROVOD_OVERLAP_AUTOTUNE opts
        # in: the dense reducer re-reads config.overlap_bucket_bytes
        # at each stream's start (never mid-stream), so a sweep can
        # flip the ceiling without splitting one step across bucket
        # layouts; the sharded train step latches it once at build
        self.tune_overlap = bool(tune_overlap)
        # TENTH dimension: the MoE routing geometry — the
        # (expert-parallel degree, capacity factor) pair
        # (parallel/moe.MOE_CHOICES) swept as ONE categorical, only
        # when the job actually hosts experts (config.moe_experts >
        # 0).  ep trades alltoall fan-out against per-rank expert
        # count; the capacity factor trades dropped tokens against
        # padded exchange bytes — both move the same wire, so they
        # sweep together.  The MoE layer re-latches the pair at step
        # start and snaps an ep that does not divide the set to the
        # nearest legal degree, so a sweep can propose any bin
        # without re-sharding mid-step
        self.tune_moe = bool(tune_moe)
        if self.tune_moe:
            global MOE_CHOICES, moe_label
            from ..parallel.moe import MOE_CHOICES, moe_label
        # warm start (docs/autotune.md "Warm start"): a local JSON
        # cache of converged best configs keyed by (bucket signature,
        # topology, world size) — production jobs start at
        # yesterday's optimum instead of re-learning from scratch.
        # The key completes when the engine notes the first fusion
        # bucket's signature (note_bucket_signature); convergence
        # persists under the same key.
        self.cache_path = cache_path
        self._key_suffix = f"{topo_fp}|np{int(world_size)}"
        if self.tune_sharded:
            # sharded jobs score a different wire/threshold landscape
            # (reducescatter+allgather vs allreduce): their optima
            # never warm-start a dense job, or vice versa
            self._key_suffix += "|sharded"
        if self.tune_overlap:
            # an overlap-swept optimum is only meaningful to jobs
            # that dispatch bucket-granular programs
            self._key_suffix += "|overlap"
        if self.tune_moe:
            # an expert job's optimum scores the alltoall wire on
            # top of the reduction wire — meaningless to dense jobs
            self._key_suffix += "|moe"
        self._cache_key = None
        self.warm_started = False
        dims = 4 + int(self.tune_wire) + int(self.tune_algorithm) \
            + int(self.tune_pipeline) + int(self.tune_sharded) \
            + int(self.tune_overlap) + int(self.tune_moe)
        self._bo = BayesianOptimizer(dims=dims, seed=seed)
        self._samples = 0
        self._steps = 0
        self._bytes = 0
        self._t0 = None
        self._current = self._encode(
            config.fusion_threshold_bytes, config.cycle_time_ms,
            getattr(config, "pack_mt_threshold_bytes", 8 << 20),
            getattr(config, "cache_capacity", 1024),
            (getattr(config, "wire_inner", None),
             getattr(config, "wire_dtype", None)),
            getattr(config, "algorithm", None),
            (getattr(config, "pp_schedule", None),
             getattr(config, "pp_n_micro", 0)),
            getattr(config, "shard_layout", None),
            getattr(config, "overlap_bucket_bytes", None),
            (getattr(config, "moe_ep", 0),
             getattr(config, "moe_capacity_factor", 0.0)))
        self._best_score = -np.inf
        self._best = self._current
        self._log = open(log_path, "w") if log_path else None
        if self._log:
            wire_col = "wire_pair," if self.tune_wire else ""
            algo_col = "algorithm," if self.tune_algorithm else ""
            pp_col = "pipeline," if self.tune_pipeline else ""
            shard_col = "shard_layout," if self.tune_sharded else ""
            ov_col = "overlap_bucket_bytes," if self.tune_overlap \
                else ""
            moe_col = "moe," if self.tune_moe else ""
            self._log.write(
                "sample,fusion_threshold_bytes,cycle_time_ms,"
                f"pack_mt_threshold_bytes,cache_capacity,{wire_col}"
                f"{algo_col}{pp_col}{shard_col}{ov_col}{moe_col}"
                "score_bytes_per_sec\n")

    # -- encoding ------------------------------------------------------------

    def _encode(self, fusion_bytes, cycle_ms, pack_mt_bytes,
                cache_capacity, wire_pair=None, algorithm=None,
                pp_pair=None, shard_layout=None, overlap_bucket=None,
                moe_pair=None):
        x0 = (np.log2(max(fusion_bytes, 1)) - _FUSION_LO) / \
            (_FUSION_HI - _FUSION_LO)
        x1 = (np.log2(max(cycle_ms, 2 ** _CYCLE_LO)) - _CYCLE_LO) / \
            (_CYCLE_HI - _CYCLE_LO)
        x2 = (np.log2(max(pack_mt_bytes, 1)) - _PACKMT_LO) / \
            (_PACKMT_HI - _PACKMT_LO)
        x3 = np.log2(cache_capacity + 1) / _CACHE_BITS
        xs = [x0, x1, x2, x3]
        if self.tune_wire:
            # fifth dimension: the per-hop (inner, outer) wire pair as
            # a categorical grid over [0, 1] (WIRE_PAIR_CHOICES at bin
            # centers — the BO's continuous suggestion snaps to the
            # nearest legal pair in _decode; quantized inner hops are
            # not in the enumeration, so the tuner can never propose
            # one).  Seeds canonicalize to the enumeration's spelling:
            # an unset inner INHERITS a 16-bit outer (the uniform
            # shorthand lands on the uniform bin), while an explicit
            # 'f32' inner keeps the cross-hop-only bin; an 'f32'
            # outer encodes as full width.  'f32' is only a distinct
            # spelling AGAINST a 16-bit outer — against a quantized or
            # unset outer the inner hop runs full width either way
            # (effective_inner_wire), so those seeds land on the
            # matching (None, outer) bin, and an API-legal 16-bit
            # inner the grid does not enumerate (e.g. fp16 over a
            # quantized outer) seeds its byte-equivalent 16-bit bin.
            inner, outer = wire_pair or (None, None)
            outer = None if outer == "f32" else outer
            if inner is None and outer in ("fp16", "bf16"):
                inner = outer
            elif inner == "f32" and outer not in ("fp16", "bf16"):
                inner = None
            try:
                wi = WIRE_PAIR_CHOICES.index((inner, outer))
            except ValueError:
                if inner in ("fp16", "bf16") and outer in ("int8", "int4"):
                    wi = WIRE_PAIR_CHOICES.index(("bf16", outer))
                else:
                    wi = 0
            xs.append((wi + 0.5) / len(WIRE_PAIR_CHOICES))
        if self.tune_algorithm:
            # sixth dimension: reduction algorithm over the same kind
            # of categorical grid; an unset default encodes as flat
            try:
                ai = ALGORITHMS.index(algorithm or "flat")
            except ValueError:
                ai = 0
            xs.append((ai + 0.5) / len(ALGORITHMS))
        if self.tune_pipeline:
            # seventh dimension: the pipeline (schedule, n_micro)
            # pair over the PP_CHOICES enumeration; an incumbent
            # n_micro outside the grid seeds the nearest bin of its
            # schedule so its score is attributed to its own
            # neighborhood, never to gpipe@2
            sched, m = pp_pair or (None, 0)
            sched = sched or "1f1b"
            try:
                pi = PP_CHOICES.index((sched, int(m or 0)))
            except ValueError:
                cands = [i for i, (s2, _) in enumerate(PP_CHOICES)
                         if s2 == sched] or [0]
                pi = min(cands, key=lambda i: abs(
                    PP_CHOICES[i][1] - int(m or PP_CHOICES[i][1])))
            xs.append((pi + 0.5) / len(PP_CHOICES))
        if self.tune_sharded:
            # eighth dimension: the shard-bucket layout categorical
            # (an unset default encodes as 'bucket')
            try:
                si = SHARD_LAYOUT_CHOICES.index(
                    shard_layout or "bucket")
            except ValueError:
                si = 0
            xs.append((si + 0.5) / len(SHARD_LAYOUT_CHOICES))
        if self.tune_overlap:
            # ninth dimension: the overlap bucket ceiling as a
            # categorical over OVERLAP_BUCKET_CHOICES; an incumbent
            # off the grid (hand-set env knob) seeds its nearest bin
            # so its score stays in its own neighborhood
            b = int(overlap_bucket or 0)
            oi = min(range(len(OVERLAP_BUCKET_CHOICES)),
                     key=lambda j: abs(OVERLAP_BUCKET_CHOICES[j] - b))
            xs.append((oi + 0.5) / len(OVERLAP_BUCKET_CHOICES))
        if self.tune_moe:
            # tenth dimension: the (ep, capacity factor) pair over
            # the MOE_CHOICES enumeration; an incumbent off the grid
            # (hand-set knobs) seeds the nearest bin of its ep degree
            # so its score stays in its own fan-out neighborhood
            ep, cf = moe_pair or (0, 0.0)
            ep = int(ep or 1)
            cf = float(cf or 1.25)
            try:
                mi = MOE_CHOICES.index((ep, cf))
            except ValueError:
                cands = [i for i, (e2, _) in enumerate(MOE_CHOICES)
                         if e2 == ep] or list(range(len(MOE_CHOICES)))
                mi = min(cands, key=lambda i: (
                    abs(MOE_CHOICES[i][0] - ep),
                    abs(MOE_CHOICES[i][1] - cf)))
            xs.append((mi + 0.5) / len(MOE_CHOICES))
        return np.clip(xs, 0.0, 1.0)

    def _decode(self, x):
        fusion = int(2 ** (_FUSION_LO + x[0] * (_FUSION_HI - _FUSION_LO)))
        cycle = float(2 ** (_CYCLE_LO + x[1] * (_CYCLE_HI - _CYCLE_LO)))
        pack_mt = int(2 ** (_PACKMT_LO + x[2] * (_PACKMT_HI - _PACKMT_LO)))
        # capacity 0 (cache off) is reachable at the low end — the
        # reference's cache-enabled toggle as the floor of a smooth dim
        cache = int(round(2 ** (x[3] * _CACHE_BITS))) - 1
        out = [fusion, cycle, pack_mt, cache]
        i = 4
        if self.tune_wire:
            wi = min(int(x[i] * len(WIRE_PAIR_CHOICES)),
                     len(WIRE_PAIR_CHOICES) - 1)
            out.append(WIRE_PAIR_CHOICES[wi])
            i += 1
        if self.tune_algorithm:
            ai = min(int(x[i] * len(ALGORITHMS)), len(ALGORITHMS) - 1)
            out.append(ALGORITHMS[ai])
            i += 1
        if self.tune_pipeline:
            pi = min(int(x[i] * len(PP_CHOICES)), len(PP_CHOICES) - 1)
            out.append(PP_CHOICES[pi])
            i += 1
        if self.tune_sharded:
            si = min(int(x[i] * len(SHARD_LAYOUT_CHOICES)),
                     len(SHARD_LAYOUT_CHOICES) - 1)
            out.append(SHARD_LAYOUT_CHOICES[si])
            i += 1
        if self.tune_overlap:
            oi = min(int(x[i] * len(OVERLAP_BUCKET_CHOICES)),
                     len(OVERLAP_BUCKET_CHOICES) - 1)
            out.append(OVERLAP_BUCKET_CHOICES[oi])
            i += 1
        if self.tune_moe:
            mi = min(int(x[i] * len(MOE_CHOICES)),
                     len(MOE_CHOICES) - 1)
            out.append(MOE_CHOICES[mi])
        return tuple(out)

    # -- recording (engine hot path) ----------------------------------------

    def record_bytes(self, nbytes):
        """One fused collective completed (reference
        ParameterManager::Update counts tensor bytes per step)."""
        if not self.active:
            return
        if self._t0 is None:
            self._t0 = time.monotonic()
        self._bytes += nbytes
        self._steps += 1
        if self._steps >= self.steps_per_sample:
            self._finish_sample()

    def abort_sample(self):
        """Discard the in-flight sample window (the engine's
        integrity quarantine): a quarantined step's window spans a
        rollback + replay, so its bytes/sec would score the current
        config against fictitious timing.  The next clean step starts
        a fresh window."""
        self._bytes = 0
        self._steps = 0
        self._t0 = None

    def _metrics_record(self, score):
        """Export the sample count, best score and best config
        (telemetry/registry.py; docs/observability.md) — the CSV log's
        scrape-able twin."""
        from .. import telemetry

        reg = telemetry.registry()
        reg.counter(telemetry.AUTOTUNE_SAMPLES_FAMILY,
                    telemetry.AUTOTUNE_SAMPLES_HELP).inc()
        reg.gauge(telemetry.AUTOTUNE_BEST_SCORE_FAMILY,
                  telemetry.AUTOTUNE_BEST_SCORE_HELP
                  ).set(max(self._best_score, score)
                        if self._best_score != -np.inf else score)
        decoded = self._decode(self._best)
        fusion, cycle, _, _ = decoded[:4]
        i = 4
        wire = algo = pipeline = shard = overlap = experts = ""
        if self.tune_wire:
            wire = wire_pair_label(*decoded[i])
            i += 1
        if self.tune_algorithm:
            algo = decoded[i]
            i += 1
        if self.tune_pipeline:
            pipeline = pp_label(*decoded[i])
            i += 1
        if self.tune_sharded:
            shard = decoded[i]
            i += 1
        if self.tune_overlap:
            overlap = str(decoded[i])
            i += 1
        if self.tune_moe:
            experts = moe_label(*decoded[i])
        best = reg.gauge(
            telemetry.AUTOTUNE_BEST_CONFIG_FAMILY,
            telemetry.AUTOTUNE_BEST_CONFIG_HELP,
            labelnames=telemetry.AUTOTUNE_BEST_CONFIG_LABELS)
        # the gauge is an info-style marker: exactly ONE labeled child
        # (the current best) — a new best replaces, never accumulates
        best.clear()
        best.labels(fusion_threshold_bytes=fusion,
                    # hvdlint: ignore[telemetry-unbounded-label] info-gauge: best.clear() above caps it at ONE live child; the label IS the payload
                    cycle_time_ms=f"{cycle:.3f}", wire=wire,
                    algorithm=algo, pipeline=pipeline,
                    shard_layout=shard,
                    overlap_bucket=overlap,
                    experts=experts).set(1)

    def _finish_sample(self):
        elapsed = max(time.monotonic() - self._t0, 1e-6)
        score = self._bytes / elapsed
        self._samples += 1
        if self._log:
            decoded = self._decode(self._current)
            fusion, cycle, pack_mt, cache = decoded[:4]
            i = 4
            wire_col = algo_col = pp_col = shard_col = ov_col = ""
            moe_col = ""
            if self.tune_wire:
                wire_col = f"{wire_pair_label(*decoded[i])},"
                i += 1
            if self.tune_algorithm:
                algo_col = f"{decoded[i]},"
                i += 1
            if self.tune_pipeline:
                pp_col = f"{pp_label(*decoded[i])},"
                i += 1
            if self.tune_sharded:
                shard_col = f"{decoded[i]},"
                i += 1
            if self.tune_overlap:
                ov_col = f"{decoded[i]},"
                i += 1
            if self.tune_moe:
                moe_col = f"{moe_label(*decoded[i])},"
            self._log.write(
                f"{self._samples},{fusion},{cycle:.3f},{pack_mt},"
                f"{cache},{wire_col}{algo_col}{pp_col}{shard_col}"
                f"{ov_col}{moe_col}{score:.1f}\n")
            self._log.flush()
        if self._samples > self.warmup_samples:
            self._bo.observe(self._current, score)
            if score > self._best_score:
                self._best_score = score
                self._best = self._current
        try:
            self._metrics_record(score)
        except Exception:  # noqa: BLE001 — telemetry must never kill
            pass           # a tuning session
        if self._samples >= self.max_samples:
            # converge: pin best parameters, stop tuning (reference
            # parameter_manager.cc final tuning state) — and persist
            # them so the next same-shaped job warm-starts here
            self._apply(self._best)
            self.active = False
            try:
                self._save_cache()
            except Exception:  # noqa: BLE001 — the cache is an
                pass           # optimization, never a failure mode
        else:
            self._current = self._bo.suggest()
            self._apply(self._current)
        self._steps = 0
        self._bytes = 0
        self._t0 = None

    def _apply(self, x):
        decoded = self._decode(x)
        fusion, cycle, pack_mt, cache = decoded[:4]
        self.config.fusion_threshold_bytes = fusion
        self.config.cycle_time_ms = cycle
        self.config.pack_mt_threshold_bytes = pack_mt
        self.config.cache_capacity = cache
        i = 4
        if self.tune_wire:
            # one categorical, both halves applied at one instant —
            # the engine's per-entry latch (submit) then freezes the
            # pair per negotiation so a mid-submit flip can never
            # split one tensor across wire formats
            inner, outer = decoded[i]
            self.config.wire_inner = inner
            self.config.wire_dtype = outer
            i += 1
        if self.tune_algorithm:
            self.config.algorithm = decoded[i]
            i += 1
        if self.tune_pipeline:
            # one categorical again: schedule and n_micro flip
            # together; the pipeline runtime latches the pair at its
            # next step start (and the engine per negotiation entry),
            # so the running step finishes under its own schedule
            sched, m = decoded[i]
            self.config.pp_schedule = sched
            self.config.pp_n_micro = int(m)
            i += 1
        if self.tune_sharded:
            # the sharded updaters re-read this at their coordinated
            # re-shard vote (a flip re-shards between steps, never
            # splits one)
            self.config.shard_layout = decoded[i]
            i += 1
        if self.tune_overlap:
            # the compiled reducer latches this per stream (every
            # stream re-reads it at construction), so a flip takes
            # effect at the NEXT step's first bucket — one step can
            # never split across bucket layouts
            self.config.overlap_bucket_bytes = int(decoded[i])
            i += 1
        if self.tune_moe:
            # one categorical: ep and capacity factor flip together;
            # the MoE layer latches the pair at its next step start
            # (snapping ep to a divisor of the set size), so the
            # running step's routing geometry never splits
            ep, cf = decoded[i]
            self.config.moe_ep = int(ep)
            self.config.moe_capacity_factor = float(cf)

    def best_parameters(self):
        return self._decode(self._best)

    # -- warm-start cache ----------------------------------------------------

    def note_bucket_signature(self, sig):
        """The engine observed its first fusion bucket: ``sig`` (a
        stable hash of the bucket's tensor keys/shapes/dtype)
        completes the cache key — (bucket signature, topology, world
        size) — and triggers the one warm-start lookup.  Idempotent;
        only the first signature counts (steady-state training re-forms
        the same buckets every cycle, which is what makes the key
        stable across jobs)."""
        if self._cache_key is not None:
            return
        self._cache_key = f"{sig}|{self._key_suffix}"
        if self.cache_path:
            try:
                self._load_cache()
            except Exception:  # noqa: BLE001 — a corrupt cache file
                pass           # must never take down a job

    def _cache_entry(self):
        decoded = self._decode(self._best)
        fusion, cycle, pack_mt, cache = decoded[:4]
        entry = {"fusion_threshold_bytes": int(fusion),
                 "cycle_time_ms": float(cycle),
                 "pack_mt_threshold_bytes": int(pack_mt),
                 "cache_capacity": int(cache),
                 "score_bytes_per_sec": float(self._best_score)
                 if self._best_score != -np.inf else 0.0}
        i = 4
        if self.tune_wire:
            entry["wire_inner"], entry["wire_outer"] = decoded[i]
            i += 1
        if self.tune_algorithm:
            entry["algorithm"] = decoded[i]
            i += 1
        if self.tune_pipeline:
            entry["pp_schedule"], entry["pp_n_micro"] = decoded[i]
            i += 1
        if self.tune_sharded:
            entry["shard_layout"] = decoded[i]
            i += 1
        if self.tune_overlap:
            entry["overlap_bucket_bytes"] = int(decoded[i])
            i += 1
        if self.tune_moe:
            ep, cf = decoded[i]
            entry["moe_ep"] = int(ep)
            entry["moe_capacity_factor"] = float(cf)
        return entry

    def _load_cache(self):
        if not (self.cache_path and os.path.exists(self.cache_path)):
            return
        with open(self.cache_path) as f:
            data = json.load(f)
        entry = data.get(self._cache_key)
        if not isinstance(entry, dict):
            return
        seed = self._encode(
            entry.get("fusion_threshold_bytes",
                      self.config.fusion_threshold_bytes),
            entry.get("cycle_time_ms", self.config.cycle_time_ms),
            entry.get("pack_mt_threshold_bytes",
                      getattr(self.config, "pack_mt_threshold_bytes",
                              8 << 20)),
            entry.get("cache_capacity",
                      getattr(self.config, "cache_capacity", 1024)),
            (entry.get("wire_inner"), entry.get("wire_outer")),
            entry.get("algorithm"),
            (entry.get("pp_schedule"), entry.get("pp_n_micro", 0)),
            entry.get("shard_layout"),
            entry.get("overlap_bucket_bytes"),
            (entry.get("moe_ep", 0),
             entry.get("moe_capacity_factor", 0.0)))
        # start the sweep AT the cached optimum: it becomes both the
        # applied config and the BO's incumbent, so early suggestions
        # explore around it instead of from scratch
        self._best = self._current = seed
        self._apply(seed)
        # the log-scale encoding quantizes integers by ~1 ulp; apply
        # the EXACT cached values on top so the job runs yesterday's
        # optimum verbatim, not its nearest grid point
        for attr, key in (("fusion_threshold_bytes",
                           "fusion_threshold_bytes"),
                          ("cycle_time_ms", "cycle_time_ms"),
                          ("pack_mt_threshold_bytes",
                           "pack_mt_threshold_bytes"),
                          ("cache_capacity", "cache_capacity"),
                          ("overlap_bucket_bytes",
                           "overlap_bucket_bytes")):
            if key in entry:
                setattr(self.config, attr, entry[key])
        self.warm_started = True

    def _save_cache(self):
        if not (self.cache_path and self._cache_key):
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.cache_path)),
                    exist_ok=True)
        # advisory lock on a sidecar (os.replace swaps the cache
        # file's inode, so locking the cache itself would not
        # serialize writers): two jobs sharing one cache converge
        # concurrently under DIFFERENT keys — without the lock the
        # second read-merge-replace drops the first job's entry
        lock = open(f"{self.cache_path}.lock", "w")
        try:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass   # no flock: keep the lock-free best effort
            data = {}
            if os.path.exists(self.cache_path):
                try:
                    with open(self.cache_path) as f:
                        data = json.load(f)
                except (OSError, ValueError):
                    data = {}
            if not isinstance(data, dict):
                data = {}
            prior = data.get(self._cache_key) or {}
            if prior.get("score_bytes_per_sec", -1.0) > \
                    float(self._best_score):
                return   # never clobber a better prior optimum
            data[self._cache_key] = self._cache_entry()
            tmp = f"{self.cache_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.cache_path)   # readers never see a
        finally:                               # torn file
            lock.close()

    def close(self):
        if self._log:
            self._log.close()
            self._log = None
