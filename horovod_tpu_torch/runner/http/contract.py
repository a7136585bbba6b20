"""Control-plane wire contract (port of
``horovod_tpu/runner/http/contract.py``): the definitions shared by the
client (http_client.py), the server (http_server.py), the worker-side
controller (core/store_controller.py) and the bypass state machine
(core/bypass.py), kept in one place so the two sides of the wire cannot
drift apart.

The port serves the static-job verbs and the negotiation bypass's vote:
the aggregator tier and the coordinator-restart resync are ROADMAP.md
A17 and have no verbs here."""

#: Verbs whose POSTs the coordinator deduplicates on a client id
#: (``ready``: rid, ``join``: jid), on idempotent per-slot state
#: (``bypass_ready``: one vote slot per process), or that are naturally
#: idempotent (``heartbeat``): the only coordinator verbs where retrying
#: a TIMEOUT is safe (the original may still have landed; the long
#: ``poll`` is idempotent by cursor but legitimately outlives a request
#: timeout).
REPLAY_SAFE_VERBS = ("ready", "join", "heartbeat", "bypass_ready")

#: Negotiation-meta types eligible for the coordinator response cache
#: AND the steady-state bypass (reference response_cache.cc
#: eligibility): metas identical across steps.  Shared by the server's
#: cache admission, the worker controller's hit path and the bypass
#: eligibility filter.
CACHEABLE_TYPES = ("ALLREDUCE", "ADASUM")
