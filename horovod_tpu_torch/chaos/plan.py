"""Declarative, seeded fault plans (port of ``horovod_tpu/chaos/plan.py``).

A fault plan is a JSON document describing *when* and *where* faults
strike a running job, so the robustness surface (elastic restart, host
blacklisting, stall attribution, the coordinator's journal restart, the
aggregator tier, fabric retries) can be exercised deterministically
instead of waiting for real failures.

The schema, the triggers and the seeded coins are the JAX package's, so
the same plan parses to the same events and the same seed draws the same
fire sequence in both packages.  Kinds and triggers whose consumer the
port has not ported yet are refused with ``NotImplementedError`` naming
the ROADMAP.md item, after the plan passed the JAX package's validation
(``REFUSED_KINDS``, ``REFUSED_TRIGGERS``).

Schema (``HOROVOD_FAULT_PLAN`` — inline JSON, ``@/path``, or a bare
path to a JSON file; ``horovodrun --fault-plan`` forwards it)::

    {
      "seed": 1234,                  # shared RNG seed (default 0)
      "events": [
        {"kind": "kill",       "proc": 1, "after_collectives": 3},
        {"kind": "exit",       "proc": 0, "code": 3, "after_s": 5.0},
        {"kind": "hang",       "proc": 1, "after_requests": 40},
        {"kind": "slow_rank",  "rank": 1, "ms": 2500,
                               "after_collectives": 2, "count": 1},
        {"kind": "drop",       "proc": 0, "after_requests": 10,
                               "count": 2},
        {"kind": "delay_ms",   "proc": 0, "ms": 200,
                               "after_requests": 5, "count": 4},
        {"kind": "duplicate",  "proc": 0, "after_requests": 7},
        {"kind": "http_error", "proc": 0, "code": 503,
                               "after_requests": 8, "count": 3},
        {"kind": "http_error", "side": "coord", "proc": 0,
                               "verb": "poll", "code": 503,
                               "after": 5, "count": 3},
        {"kind": "clock_skew", "proc": 1, "ms": 5000, "after_s": 2.0},
        {"kind": "coord_restart", "after_s": 5.0, "ms": 3000},
        {"kind": "coord_kill", "after": 200},
        {"kind": "agg_restart", "proc": 0, "after_s": 3.0,
                                "ms": 1500},
        {"kind": "agg_kill", "proc": 1, "after_s": 8.0},
        {"kind": "revoke_host", "host": "host3", "after": 12},
        {"kind": "restore_host", "host": "host3", "after": 18},
        {"kind": "bitflip_grad", "proc": 1, "after_buckets": 3},
        {"kind": "bitflip_wire", "proc": 1, "after_buckets": 6},
        {"kind": "corrupt_spill", "proc": 0, "after_commits": 2}
      ]
    }

Every event names exactly one trigger — ``after_requests`` (the n-th
fabric request this process issues), ``after_collectives`` (the n-th
collective this process reports ready), ``after_predicts`` (the n-th
predict request this process's serving frontend receives — the
ingestion path of the serving package, counted on its OWN
counter so adding serving traffic never perturbs the fabric-request
stream an existing plan was seeded against), ``after_decodes`` (the
n-th decode tick this process's continuous batcher runs —
serving/continuous.py, again its own counter), or ``after_s``
(wall-clock offset from injector install) — plus a target (``proc``
index, or ``rank`` for ``slow_rank``; terminal kinds require an
explicit target so a sloppy plan cannot kill every process at once).  ``count`` fires
the event on that many consecutive trigger points (default 1);
``p`` gates each firing on a coin flip drawn from an RNG seeded by
``(seed, event index)``, so two runs of the same plan make identical
fire/skip decisions, the determinism the chaos tests assert.

Events with ``"side": "coord"`` are applied by the *launcher* to its
coordinator instead of by workers: they reject (``http_error``) or
stall (``delay_ms``) a chosen proc's coordinator requests server-side
(``after`` counts that proc's matching requests).  See
docs/fault_tolerance.md for the full scenario → expected-behavior
matrix.
"""

import json
import os
import random
from dataclasses import dataclass, field
from typing import List, Optional

#: Worker-side fault kinds, by injection point.
PROCESS_KINDS = ("kill", "exit", "hang", "clock_skew")
WIRE_KINDS = ("drop", "delay_ms", "duplicate", "http_error")
ENGINE_KINDS = ("slow_rank",)
#: Launcher-side kinds targeting the rendezvous service ITSELF
#: (docs/fault_tolerance.md "Coordinator crash survival"):
#: ``coord_kill`` tears the HTTP service down for good; steps keep
#: flowing only on the negotiation bypass.  ``coord_restart`` tears it
#: down for ``ms`` milliseconds, then rebuilds store + coordinator
#: purely from the journal (epoch bumped) on the same port.  Both are
#: implicitly ``side: "coord"`` and trigger on ``after_s`` (wall) or
#: ``after`` (the n-th coordinator request).
COORD_KINDS = ("coord_kill", "coord_restart")
#: Aggregator-tier kinds, mirroring the coordinator pair
#: (docs/fault_tolerance.md "Per-host aggregator tier"): ``agg_kill``
#: tears one host's aggregator down for good — its workers fall back
#: to direct coordinator mode; ``agg_restart`` tears it down for
#: ``ms`` milliseconds, then starts a FRESH stateless core on the
#: same port (agg_epoch bumped upstream, workers re-fenced).  Both
#: are implicitly ``side: "agg"``; ``proc`` names the target host/
#: aggregator index (None = every host's aggregator), and the
#: trigger is ``after_s`` (wall) or ``after`` (the n-th request that
#: host's aggregator handles).
AGG_KINDS = ("agg_kill", "agg_restart")
#: Fleet-controller kinds (docs/fleet.md "Chaos"): ``revoke_host``
#: removes a host from the shared pool — every job placed on it is
#: reassigned through the SAME preemption-by-elasticity path a real
#: preemption or hardware death takes (one mechanism for both drills);
#: ``restore_host`` returns it.  Both are implicitly ``side: "fleet"``
#: and applied by the launcher's FleetController; the target is
#: ``host`` (a pool hostname) or ``proc`` (the host's index in the
#: spec's pool order), and the trigger is ``after`` (the n-th
#: reconcile tick — deterministic across same-seed runs) or
#: ``after_s`` (wall offset).
FLEET_KINDS = ("revoke_host", "restore_host")
#: Silent-data-corruption kinds (docs/fault_tolerance.md "Silent data
#: corruption"; core/integrity.py): ``bitflip_grad`` flips one seeded
#: bit in a packed gradient payload at the fusion-encode site (after
#: the submit-time digests — the payload checksum must catch it);
#: ``bitflip_wire`` flips one seeded bit in the ENCODED wire bytes
#: (codes/scales on quantized wires, the cast or raw buffer
#: otherwise) after the encode digests — the decode-side verify must
#: catch it.  Both trigger on ``after_buckets`` (the n-th collective
#: bucket — reduction, reducescatter or allgather — this process
#: encodes).  ``corrupt_spill`` flips one seeded
#: bit in an elastic spill blob as it is written (``after_commits`` =
#: the n-th spill), exercising the CRC-trailer fallback.  The seeded
#: (byte, bit) draws ride the event's private RNG stream, so the
#: ``fired`` evidence (site/row/byte/bit included) is byte-identical
#: across same-seed runs.
INTEGRITY_KINDS = ("bitflip_grad", "bitflip_wire", "corrupt_spill")
#: Data-plane kinds (docs/data.md "Failure-mode matrix"):
#: ``kill_shard_server`` stops one shard server abruptly mid-epoch —
#: no end-of-shard sentinel, its staged tail stays undelivered — so
#: the drill exercises the ledger's reform-from-journaled-cursors
#: path (exactly-once visitation across the kill).  The target is
#: ``proc`` (the shard index) and the trigger is ``after_samples``
#: (the n-th sample that shard server publishes — its OWN counter,
#: so adding data-plane events never perturbs the fabric-request
#: stream an existing plan was seeded against).
DATA_KINDS = ("kill_shard_server",)
KINDS = PROCESS_KINDS + WIRE_KINDS + ENGINE_KINDS + COORD_KINDS \
    + AGG_KINDS + FLEET_KINDS + INTEGRITY_KINDS + DATA_KINDS

#: Kinds the plan schema knows whose consumer the port has not ported
#: yet: a plan naming one is refused, with the ROADMAP.md item that
#: ports it.
REFUSED_KINDS = {
    "bitflip_grad": "the integrity digests (ROADMAP.md A14)",
    "bitflip_wire": "the integrity digests (ROADMAP.md A14)",
    "revoke_host": "the fleet controller (ROADMAP.md A17's fleet)",
    "restore_host": "the fleet controller (ROADMAP.md A17's fleet)",
    "kill_shard_server": "the data plane (ROADMAP.md A17's data plane)",
}
#: Triggers whose counter lives in a module the port has not ported.
REFUSED_TRIGGERS = {
    "after_predicts": "the serving frontend (ROADMAP.md A16)",
    "after_decodes": "the continuous batcher (ROADMAP.md A16)",
}

#: Trigger spellings -> canonical trigger name.
_TRIGGERS = {"after_requests": "requests",
             "after_collectives": "collectives",
             "after_predicts": "predicts",
             # the continuous batcher's decode ticks (serving/
             # continuous.py), own counter for the same reason: a
             # decode-replica kill drill must never perturb the
             # fabric-request or predict streams a plan was seeded
             # against
             "after_decodes": "decodes",
             "after_s": "wall",
             # integrity kinds count encode/spill sites
             # (core/integrity.py; their OWN counters, so adding
             # corruption events never perturbs the fabric-request
             # stream an existing plan was seeded against)
             "after_buckets": "buckets",
             "after_commits": "commits",
             # data-plane kinds count samples a shard server publishes
             # (data/shard_service.py; its OWN counter — see
             # DATA_KINDS)
             "after_samples": "samples",
             # coordinator-side rules count matching requests
             "after": "requests"}


@dataclass
class FaultEvent:
    """One scheduled fault (see module docstring for the schema)."""

    index: int                      # position in the plan (RNG stream id)
    kind: str
    trigger: str                    # requests | collectives | wall
    at: float                       # trigger threshold (count or seconds)
    proc: Optional[int] = None      # target process index (None = any)
    rank: Optional[int] = None      # target global rank (slow_rank)
    verb: Optional[str] = None      # coordinator-side verb filter
    code: int = 503                 # exit status / HTTP status
    ms: float = 0.0                 # delay / skew magnitude
    count: int = 1                  # consecutive trigger points to fire on
    p: float = 1.0                  # per-firing probability (seeded RNG)
    side: str = "worker"            # worker | coord | agg | fleet | data
    host: Optional[str] = None      # fleet-side pool hostname target


@dataclass
class FaultPlan:
    """Parsed, validated plan.  ``events`` keep their JSON order; the
    order is the RNG-stream identity, so editing a plan reshuffles
    only the edited events' randomness."""

    seed: int = 0
    events: List[FaultEvent] = field(default_factory=list)

    def worker_events(self, proc: int, rank_lo: int = 0,
                      rank_hi: int = 0) -> List[FaultEvent]:
        """Events this worker process must inject: worker-side events
        targeting its proc index, or (for rank-targeted events) a
        global rank inside [rank_lo, rank_hi)."""
        out = []
        for e in self.events:
            if e.side != "worker":
                continue
            if e.rank is not None:
                if rank_lo <= e.rank < rank_hi:
                    out.append(e)
            elif e.proc is None or e.proc == proc:
                out.append(e)
        return out

    def coordinator_rules(self) -> List[FaultEvent]:
        """Events the launcher installs into its coordinator."""
        return [e for e in self.events if e.side == "coord"]

    def fleet_events(self) -> List[FaultEvent]:
        """Events the launcher's FleetController applies to its shared
        host pool (revoke_host / restore_host)."""
        return [e for e in self.events if e.side == "fleet"]

    def data_events(self) -> List[FaultEvent]:
        """Events the sharded data service applies to its own shard
        servers (kill_shard_server; ``proc`` is the shard index — the
        service hosting the shard threads arms them itself, like the
        FleetController arms its pool events)."""
        return [e for e in self.events if e.side == "data"]

    def aggregator_events(self, agg_index: int) -> List[FaultEvent]:
        """Service faults the process owning aggregator ``agg_index``
        (= its host index) must apply — targeted by ``proc``, or
        untargeted (every host's aggregator)."""
        return [e for e in self.events
                if e.side == "agg"
                and (e.proc is None or e.proc == agg_index)]

    def rng_for(self, event: FaultEvent) -> random.Random:
        """The event's private RNG stream — a pure function of
        (plan seed, event index), so every process and every run draws
        the same sequence for the same event."""
        return random.Random(f"{self.seed}:{event.index}")


def _parse_event(index: int, raw: dict) -> FaultEvent:
    if not isinstance(raw, dict):
        raise ValueError(f"fault event #{index} is not an object: {raw!r}")
    kind = raw.get("kind")
    if kind not in KINDS:
        raise ValueError(
            f"fault event #{index}: unknown kind {kind!r} "
            f"(valid: {', '.join(KINDS)})")
    side = raw.get("side", "worker")
    if side not in ("worker", "coord", "agg", "fleet", "data"):
        raise ValueError(
            f"fault event #{index}: side must be 'worker', 'coord', "
            f"'agg', 'fleet' or 'data', got {side!r}")
    if kind in COORD_KINDS:
        # coordinator-targeting kinds are coord-side by definition
        side = "coord"
    if kind in AGG_KINDS:
        # aggregator-targeting kinds are agg-side by definition
        side = "agg"
    if kind in FLEET_KINDS:
        # pool-targeting kinds are fleet-side by definition
        side = "fleet"
    if kind in DATA_KINDS:
        # shard-server-targeting kinds are data-side by definition
        # (applied by the sharded data service hosting the shard
        # threads; ``proc`` is the shard index, not a process index)
        side = "data"
    if side == "data" and kind not in DATA_KINDS:
        raise ValueError(
            f"fault event #{index}: data-side events support "
            f"{', '.join(DATA_KINDS)}, not {kind}")
    if side == "coord" and kind not in (
            "http_error", "delay_ms") + COORD_KINDS:
        raise ValueError(
            f"fault event #{index}: coordinator-side events support "
            f"http_error (reject), delay_ms (stall), coord_kill and "
            f"coord_restart, not {kind}")
    if side == "agg" and kind not in AGG_KINDS:
        raise ValueError(
            f"fault event #{index}: aggregator-side events support "
            f"agg_kill and agg_restart, not {kind}")
    if side == "fleet" and kind not in FLEET_KINDS:
        raise ValueError(
            f"fault event #{index}: fleet-side events support "
            f"revoke_host and restore_host, not {kind}")
    if kind in FLEET_KINDS and raw.get("host") is None \
            and raw.get("proc") is None:
        raise ValueError(
            f"fault event #{index}: {kind} requires a 'host' (pool "
            f"hostname) or 'proc' (pool-order host index) target")
    triggers = [k for k in _TRIGGERS if k in raw]
    if len(triggers) != 1:
        raise ValueError(
            f"fault event #{index} ({kind}): exactly one trigger of "
            f"{sorted(_TRIGGERS)} required, got {triggers or 'none'}")
    trig_key = triggers[0]
    at = float(raw[trig_key])
    if at < 0:
        raise ValueError(
            f"fault event #{index}: trigger {trig_key} must be >= 0")
    if side == "coord" and kind not in COORD_KINDS \
            and trig_key != "after":
        raise ValueError(
            f"fault event #{index}: coordinator-side events count "
            f"matching requests via 'after', not {trig_key}")
    if kind in COORD_KINDS + AGG_KINDS + FLEET_KINDS \
            and trig_key not in ("after", "after_s"):
        raise ValueError(
            f"fault event #{index}: {kind} triggers on 'after' "
            f"(n-th service request / reconcile tick) or 'after_s' "
            f"(wall), not {trig_key}")
    if kind in ("bitflip_grad", "bitflip_wire") \
            and trig_key != "after_buckets":
        raise ValueError(
            f"fault event #{index}: {kind} triggers on "
            f"'after_buckets' (the n-th reduction bucket this process "
            f"encodes), not {trig_key}")
    if kind == "corrupt_spill" and trig_key != "after_commits":
        raise ValueError(
            f"fault event #{index}: corrupt_spill triggers on "
            f"'after_commits' (the n-th elastic spill this process "
            f"writes), not {trig_key}")
    if trig_key in ("after_buckets", "after_commits") \
            and kind not in INTEGRITY_KINDS:
        raise ValueError(
            f"fault event #{index}: trigger {trig_key} is reserved "
            f"for the integrity kinds ({', '.join(INTEGRITY_KINDS)}), "
            f"not {kind}")
    if kind in DATA_KINDS and trig_key != "after_samples":
        raise ValueError(
            f"fault event #{index}: {kind} triggers on "
            f"'after_samples' (the n-th sample the targeted shard "
            f"server publishes), not {trig_key}")
    if trig_key == "after_samples" and kind not in DATA_KINDS:
        raise ValueError(
            f"fault event #{index}: trigger after_samples is "
            f"reserved for the data-plane kinds "
            f"({', '.join(DATA_KINDS)}), not {kind}")
    if kind in DATA_KINDS and raw.get("proc") is None:
        raise ValueError(
            f"fault event #{index}: {kind} requires an explicit "
            f"'proc' target (the shard index) — an untargeted kill "
            f"would take down every shard server at once")
    if kind == "coord_restart" and not raw.get("ms"):
        raise ValueError(
            f"fault event #{index}: coord_restart needs 'ms' > 0 "
            f"(the outage duration before the journal restart)")
    if kind == "agg_restart" and not raw.get("ms"):
        raise ValueError(
            f"fault event #{index}: agg_restart needs 'ms' > 0 "
            f"(the outage duration before the stateless restart)")
    proc = raw.get("proc")
    rank = raw.get("rank")
    if kind == "slow_rank":
        if rank is None and proc is None:
            raise ValueError(
                f"fault event #{index}: slow_rank needs 'rank' "
                f"(global rank) or 'proc'")
        if not raw.get("ms"):
            raise ValueError(
                f"fault event #{index}: slow_rank needs 'ms' > 0")
    if kind in ("kill", "exit", "hang") and proc is None and rank is None:
        # terminal faults must name their victim explicitly — an
        # untargeted kill would take down every process at once and the
        # "recovery" scenario under test with it
        raise ValueError(
            f"fault event #{index}: {kind} requires an explicit "
            f"'proc' target")
    p = float(raw.get("p", 1.0))
    if not 0.0 < p <= 1.0:
        raise ValueError(
            f"fault event #{index}: p must be in (0, 1], got {p}")
    count = int(raw.get("count", 1))
    if count < 1:
        raise ValueError(f"fault event #{index}: count must be >= 1")
    refused = REFUSED_KINDS.get(kind) or REFUSED_TRIGGERS.get(trig_key)
    if refused is not None:
        raise NotImplementedError(
            f"fault event #{index}: {kind} on {trig_key} is not ported "
            f"yet: {refused}")
    return FaultEvent(
        index=index, kind=kind,
        trigger=_TRIGGERS[trig_key], at=at,
        proc=int(proc) if proc is not None else None,
        rank=int(rank) if rank is not None else None,
        verb=raw.get("verb"),
        code=int(raw.get("code", 503 if kind == "http_error" else 1)),
        ms=float(raw.get("ms", 0.0)),
        count=count, p=p, side=side,
        host=str(raw["host"]) if raw.get("host") is not None else None)


def parse_plan(doc, seed_override=None) -> FaultPlan:
    """Parse a plan from a dict or JSON string."""
    if isinstance(doc, (str, bytes)):
        doc = json.loads(doc)
    if not isinstance(doc, dict):
        raise ValueError(f"fault plan must be a JSON object, got "
                         f"{type(doc).__name__}")
    seed = int(doc.get("seed", 0)) if seed_override is None \
        else int(seed_override)
    events = [_parse_event(i, e)
              for i, e in enumerate(doc.get("events", []))]
    return FaultPlan(seed=seed, events=events)


def read_plan_source(source: str) -> str:
    """Resolve a plan source to its JSON text: inline JSON (leading
    ``{``), ``@/path``, or a bare file path.  THE one definition of
    what ``HOROVOD_FAULT_PLAN`` / ``--fault-plan`` may contain — the
    launcher uses it too, to inline file contents into the env handoff
    for ssh workers."""
    text = source.strip()
    if text.startswith("@"):
        with open(text[1:]) as f:
            return f.read()
    if not text.startswith("{") and os.path.exists(text):
        with open(text) as f:
            return f.read()
    return text


def load_plan(source: str, seed_override=None) -> FaultPlan:
    """Load a plan from inline JSON, ``@/path``, or a bare file path."""
    return parse_plan(read_plan_source(source),
                      seed_override=seed_override)


def plan_from_env(env=None) -> Optional[FaultPlan]:
    """The plan named by ``HOROVOD_FAULT_PLAN`` (+ optional
    ``HOROVOD_FAULT_SEED`` override), or None when unset.  A malformed
    plan raises — silently dropping the faults a test scheduled would
    make that test pass vacuously."""
    env = os.environ if env is None else env
    raw = env.get("HOROVOD_FAULT_PLAN")
    if not raw or not str(raw).strip():
        return None
    seed = env.get("HOROVOD_FAULT_SEED")
    return load_plan(str(raw),
                     seed_override=int(seed) if seed else None)
