"""Elastic rendezvous verbs (port of
``horovod_tpu/runner/elastic/rendezvous.py``; reference
``horovod/runner/elastic/rendezvous.py``).

The live elastic rendezvous in this build is KV-published rounds: the
driver writes ``/elastic/round`` with the full assignment table and
workers long-poll it (driver.py ROUND_KEY / common/basics.py
``_elastic_rendezvous``) — one write per round instead of one GET per
worker.  The reference's per-worker verbs are provided here as a
functional adapter over the same driver state for tooling that speaks
them.
"""

from ..common.util import codec

# GET methods
GET_RANK_AND_SIZE = "rank_and_size"

# PUT methods
PUT_WORKER_ADDRESSES = "worker_addresses"


def create_rendezvous_handler(driver):
    """Returns a handler whose ``get``/``put`` implement the
    reference's scope verbs against ``driver`` (reference
    rendezvous.py:27-54)."""

    class ElasticRendezvousHandler:
        def get(self, scope, key):
            if scope == GET_RANK_AND_SIZE:
                host, local_rank = key.rsplit(":", 1)
                driver.record_ready(host, int(local_rank))
                slot_info = driver.get_slot_info(host, int(local_rank))
                return slot_info

            raise KeyError(f"unknown GET scope: {scope}")

        def put(self, scope, key, value):
            if scope == PUT_WORKER_ADDRESSES:
                host, local_rank = key.rsplit(":", 1)
                addresses, secret_key = codec.loads_base64(value)
                driver.register_worker_server(
                    host, int(local_rank), addresses, secret_key)
                return

            raise KeyError(f"unknown PUT scope: {scope}")

    return ElasticRendezvousHandler()
