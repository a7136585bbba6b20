"""Resharding-aware elastic sampler (port of
``horovod_tpu/torch/elastic/sampler.py``; reference
``horovod/torch/elastic/sampler.py:24``).

The reference's contract is count-based: ``record_batch`` advances a
GLOBAL ``processed_num`` (``batch_size * num_replicas`` — every rank
consumed a batch in lockstep), and a reset repartitions the indices
past that count over the new world.  ``processed_indices`` is kept as
an additional per-rank record (the JAX package's richer contract;
the state handler unions it across ranks on sync so resumption works
even when callers recorded uneven progress)."""

import math
import random

import torch

from ...common import basics


def _world():
    if basics.is_initialized():
        return basics.size(), basics.rank()
    return 1, 0


class ElasticSampler(torch.utils.data.Sampler):
    """Reference sampler.py:24-140."""

    def __init__(self, dataset, shuffle=True, seed=0):
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = seed

        self.epoch = 0
        self.processed_indices = set()
        self.processed_num = 0

        self.num_replicas = 0
        self.rank = 0
        self.remaining_indices = []
        self.num_samples = 0
        self.total_size = 0

        self.reset()

    def set_epoch(self, epoch):
        """Reference sampler.py:61 — call at the END of an epoch so a
        partially completed epoch is not reprocessed."""
        self.epoch = epoch
        self.processed_num = 0
        self.processed_indices = set()
        self.reset()

    def record_batch(self, batch_idx, batch_size):
        """Record one processed batch (reference sampler.py:78: the
        whole world consumed ``batch_size`` samples each)."""
        self.processed_num += batch_size * self.num_replicas
        # per-rank record of the actual indices (beyond-reference; the
        # state handler unions these on sync so a resize is exact even
        # with uneven per-rank progress)
        local = self.indices[batch_idx * batch_size:
                             (batch_idx + 1) * batch_size]
        self.processed_indices.update(local)

    def load_state_dict(self, state_dict):
        self.epoch = state_dict["epoch"]
        self.processed_indices = set(
            state_dict.get("processed_indices", ()))
        # earlier builds stored only the index set; derive the count
        self.processed_num = state_dict.get(
            "processed_num", len(self.processed_indices))
        self.reset()

    def state_dict(self):
        return dict(epoch=self.epoch,
                    processed_num=self.processed_num,
                    processed_indices=sorted(self.processed_indices))

    def reset(self):
        self.num_replicas, self.rank = _world()

        # exclude what this epoch already consumed: the count prefix
        # of the epoch's shuffled order (reference sampler.py:97) PLUS
        # any individually recorded indices beyond it — the state
        # handler syncs the conservative min-count across ranks with
        # the union of consumed indices, so a resize neither re-serves
        # trained samples nor drops ones a slower rank never saw
        all_indices = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(all_indices)
        remaining = all_indices[self.processed_num:]
        if self.processed_indices:
            consumed = self.processed_indices
            remaining = [i for i in remaining if i not in consumed]
        self.remaining_indices = remaining

        self.num_samples = int(math.ceil(
            len(self.remaining_indices) / self.num_replicas))
        self.total_size = self.num_samples * self.num_replicas
        # materialize this rank's slice eagerly so record_batch can
        # name the consumed indices without requiring an __iter__ first
        self._subsample()

    def _subsample(self):
        indices = list(self.remaining_indices)
        indices += indices[: (self.total_size - len(indices))]
        self.indices = indices[self.rank: self.total_size:
                               self.num_replicas]

    def __iter__(self):
        self._subsample()
        return iter(self.indices)

    def __len__(self):
        return self.num_samples
