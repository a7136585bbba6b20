"""Parameter/optimizer-state broadcast helpers (port of
``horovod_tpu/torch/functions.py``; reference
``horovod/torch/functions.py``)."""

import collections

import torch

from ..common.process_sets import global_process_set
from ..ops import api


def broadcast_parameters(params, root_rank, process_set=global_process_set):
    """Broadcast model parameters (in place) from ``root_rank``
    (reference functions.py:59).  Accepts ``model.state_dict()`` or
    ``model.named_parameters()``."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif isinstance(params, collections.abc.Iterable):
        params = list(params)
    handles = []
    for name, p in params:
        if p is None or not torch.is_tensor(p):
            continue
        handles.append(api.broadcast_async_(
            p.data, root_rank, name=f"broadcast.{name}",
            process_set=process_set))
    for h in handles:
        api.synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank,
                              process_set=global_process_set):
    """Broadcast the optimizer state from ``root_rank`` (reference
    functions.py:118) as one pickled object, so every rank takes the
    same collective path whatever state it holds locally."""
    if len(optimizer.param_groups) == 0:
        raise ValueError("optimizer is empty")
    state = api.broadcast_object(optimizer.state_dict(), root_rank,
                                 name="opt_state", process_set=process_set)
    optimizer.load_state_dict(state)
    # the reference's dummy step leaves a zero .grad on every
    # grad-requiring parameter (functions.py:94-95)
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)


broadcast_object = api.broadcast_object
allgather_object = api.allgather_object
