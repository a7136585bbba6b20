"""Control-plane wire contract (port of
``horovod_tpu/runner/http/contract.py``): the definitions shared by the
client (http_client.py), the server (http_server.py), the aggregator
tier (aggregator.py), the worker-side controller
(core/store_controller.py) and the bypass state machine
(core/bypass.py), kept in one place so the sides of the wire cannot
drift apart.  The values are the JAX package's, verb for verb
(tests/test_torch_coord_journal.py compares them).
"""

#: Verbs whose POSTs the coordinator deduplicates on a client id
#: (rid/jid), on idempotent per-slot state (resync session
#: registration, bypass_ready votes), or that are naturally idempotent
#: (heartbeat) — the only coordinator verbs where retrying a TIMEOUT
#: is safe (the original may still have landed).  Across a coordinator
#: restart the epoch fence rejects any blind replay BEFORE its verb
#: runs, so the contract holds outage-spanning too.
#:
#: The aggregator tier (runner/http/aggregator.py) batches worker
#: verbs into the ``agg_*`` upstream verbs; each inherits the dedup
#: of the per-proc reports it carries (``agg_ready``: per-proc rid,
#: ``agg_heartbeat``: naturally idempotent beats, ``agg_resync``:
#: idempotent per-(agg, sid) registration), so the SAME contract holds
#: across all three tiers — worker↔aggregator, aggregator↔coordinator,
#: and the direct worker↔coordinator fallback.
REPLAY_SAFE_VERBS = ("ready", "join", "heartbeat", "resync",
                     "bypass_ready", "agg_ready", "agg_heartbeat",
                     "agg_resync")

#: KV-path pseudo-verbs that are replay-safe by DATA MODEL rather than
#: by dedup: puts are last-writer-wins and gets are reads, so a
#: timed-out request can be blindly re-sent.  (kv_delete is excluded:
#: delete-then-recreate races a replayed delete.)
REPLAY_SAFE_KV_VERBS = ("kv_put", "kv_get")

#: The server-side dedup / idempotency structure each replay-safe verb
#: handler must route through (attribute names on the Coordinator).
REPLAY_DEDUP_ATTRS = {
    "ready": ("_ready_seen",),          # rid high-water + cached reply
    "join": ("_join_seen",),            # per-(ps, proc) jid sets
    "heartbeat": ("_beats",),           # last-beat map: re-beat = update
    "resync": ("_proc_sid",),           # session re-registration
    "bypass_ready": ("_bypass_votes",),  # per-proc vote slot
    # aggregator-tier verbs: the batch envelope dedups through the
    # per-proc structures of the reports it carries
    "agg_ready": ("_ready_seen",),      # per-proc rid high-waters
    "agg_heartbeat": ("_beats",),       # beats are idempotent updates
    "agg_resync": ("_agg_sid",),        # per-agg session registration
}

#: Verbs that bypass the coordinator epoch fence: ``clock`` is a
#: lock-free, state-free NTP ping that must answer with minimal
#: jitter; ``resync`` IS the fence's recovery handshake (it cannot be
#: fenced by the epoch it exists to re-learn), and ``agg_resync`` is
#: the same handshake for the aggregator tier — a restarted
#: aggregator re-registers through it to learn the epochs it will
#: fence everything else with.  Every other verb must be rejected on
#: an epoch mismatch BEFORE its handler runs.
EPOCH_EXEMPT_VERBS = ("clock", "resync", "agg_resync")

#: Long-poll stream verbs: fenced like any other verb, NEVER
#: timeout-replayed (a long poll legitimately outlives the request
#: timeout), and idempotent by cursor — re-polling a cursor re-serves
#: the same log suffix.  Every ``_on_<verb>`` handler on a
#: coordinator-shaped class is classified in exactly one of
#: REPLAY_SAFE_VERBS / EPOCH_EXEMPT_VERBS / STREAM_VERBS, on all three
#: tiers.
STREAM_VERBS = ("poll", "agg_poll")

#: Negotiation-meta types eligible for the coordinator response cache
#: AND the steady-state bypass (reference response_cache.cc
#: eligibility): metas identical across steps.  Shared by the server's
#: cache admission, the worker controller's hit path and the bypass
#: eligibility filter — three sites that previously each held a copy.
CACHEABLE_TYPES = ("ALLREDUCE", "ADASUM")
