"""Control-plane wire contract (port of
``horovod_tpu/runner/http/contract.py``): the definitions shared by the
client (http_client.py), the server (http_server.py) and the worker-side
controller (core/store_controller.py), kept in one place so the two sides
of the wire cannot drift apart.

The port serves the static-job verbs only: the aggregator tier, the
negotiation bypass and the coordinator-restart resync are ROADMAP.md
A17/A23 and have no verbs here."""

#: Verbs whose POSTs the coordinator deduplicates on a client id
#: (``ready``: rid, ``join``: jid) or that are naturally idempotent
#: (``heartbeat``): the only coordinator verbs where retrying a TIMEOUT
#: is safe (the original may still have landed; the long ``poll`` is
#: idempotent by cursor but legitimately outlives a request timeout).
REPLAY_SAFE_VERBS = ("ready", "join", "heartbeat")

#: Negotiation-meta types eligible for the coordinator response cache:
#: metas identical across steps (reference response_cache.cc
#: eligibility).  Shared by the server's cache admission and the worker
#: controller's hit path.
CACHEABLE_TYPES = ("ALLREDUCE", "ADASUM")
