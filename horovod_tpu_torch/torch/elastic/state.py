"""Torch elastic state and the public state-handler registry (port of
``horovod_tpu/torch/elastic/state.py``; reference
``horovod/torch/elastic/state.py:27-180``).

Users can register handlers for custom object types with
``set_handler_registry``: the registry maps an ``isinstance`` check to a
handler class, first match wins (reference state.py:142-162).
"""

import copy

import torch

from ...common import basics
from ...common.elastic import ObjectState
from ..functions import (
    broadcast_object, broadcast_optimizer_state, broadcast_parameters,
)
from .sampler import ElasticSampler


def _to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU: the spill is
    read by a fresh process, which loads the tensors onto its own device
    (``load_state_dict`` copies into the live parameters, and an
    optimizer casts its state to each parameter's device)."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return type(obj)((k, _to_cpu(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class StateHandler:
    """Save/restore/sync protocol for one stateful object (reference
    state.py:71-88).  ``saved_state``/``load_saved_state`` extend the
    reference contract for the crash-durable spill path
    (common/elastic.py ``_spill_path``)."""

    def __init__(self, value):
        self.value = value

    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def set_value(self, value):
        self.value = value

    def saved_state(self):
        return None

    def load_saved_state(self, saved):
        pass


class ModelStateHandler(StateHandler):
    """Handles ``torch.nn.Module`` (reference state.py:89-103)."""

    def __init__(self, model):
        super().__init__(model)
        self._saved_model_state = copy.deepcopy(model.state_dict())

    def save(self):
        self._saved_model_state = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(self._saved_model_state)

    def sync(self):
        broadcast_parameters(self.value.state_dict(), root_rank=0)

    def saved_state(self):
        return self._saved_model_state

    def load_saved_state(self, saved):
        self._saved_model_state = saved


class OptimizerStateHandler(StateHandler):
    """Handles ``torch.optim.Optimizer`` (reference state.py:104-118)."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        self._saved_state = copy.deepcopy(optimizer.state_dict())

    def save(self):
        self._saved_state = copy.deepcopy(self.value.state_dict())

    def restore(self):
        # a copy: torch's load_state_dict takes the tensors as they are
        # (same dtype and device), and the steps after this restore would
        # otherwise update the commit itself in place
        self.value.load_state_dict(copy.deepcopy(self._saved_state))

    def sync(self):
        broadcast_optimizer_state(self.value, root_rank=0)

    def saved_state(self):
        return self._saved_state

    def load_saved_state(self, saved):
        self._saved_state = saved


class SamplerStateHandler(StateHandler):
    """Handles ``ElasticSampler``: epoch and processed indices travel with
    the state, so a restored or resized job resumes mid-epoch (reference
    state.py:119-135)."""

    def __init__(self, sampler):
        super().__init__(sampler)
        self._saved_sampler_state = copy.deepcopy(sampler.state_dict())

    def save(self):
        self._saved_sampler_state = copy.deepcopy(self.value.state_dict())

    def restore(self):
        self.value.load_state_dict(self._saved_sampler_state)

    def sync(self):
        # progress is global but may be unevenly recorded at a resize:
        # take the conservative MIN count (no rank skips samples a slower
        # peer never saw) plus the UNION of individually consumed indices
        # (no rank re-serves samples a faster peer already trained on);
        # reset() honors both
        from ..functions import allgather_object
        state = self.value.state_dict()
        all_states = allgather_object(state)
        merged = set()
        for s in all_states:
            merged.update(s.get("processed_indices", ()))
        state["processed_indices"] = sorted(merged)
        state["processed_num"] = min(
            s.get("processed_num", 0) for s in all_states)
        self.value.load_state_dict(broadcast_object(state))

    def saved_state(self):
        return self._saved_sampler_state

    def load_saved_state(self, saved):
        self._saved_sampler_state = saved


_handler_registry = [
    (torch.nn.Module, ModelStateHandler),
    (torch.optim.Optimizer, OptimizerStateHandler),
    (ElasticSampler, SamplerStateHandler),
]


def get_handler_registry():
    return _handler_registry


def set_handler_registry(registry):
    global _handler_registry
    _handler_registry = registry


def _get_handler(v):
    for handler_type, handler_cls in _handler_registry:
        if isinstance(v, handler_type):
            return handler_cls(v)
    return None


def _get_handlers(kwargs):
    handlers = {}
    remainder = {}
    for name, value in kwargs.items():
        handler = _get_handler(value)
        if handler is not None:
            handlers[name] = handler
        else:
            remainder[name] = value
    return handlers, remainder


class TorchState(ObjectState):
    """State of a torch training job: model(s), optimizer(s), sampler(s),
    plus arbitrary picklable attributes (reference state.py:27-70)."""

    def __init__(self, model=None, optimizer=None, **kwargs):
        kwargs.update(dict(model=model, optimizer=optimizer))
        kwargs = {k: v for k, v in kwargs.items()
                  if not (v is None and k in ("model", "optimizer"))}
        self._handlers, kwargs = _get_handlers(kwargs)
        for name, handler in self._handlers.items():
            setattr(self, name, handler.value)
        super().__init__(bcast_object=broadcast_object,
                         get_rank=basics.rank, **kwargs)

    def save(self):
        for handler in self._handlers.values():
            handler.save()
        super().save()

    def restore(self):
        for handler in self._handlers.values():
            handler.restore()
        super().restore()

    def sync(self):
        for handler in self._handlers.values():
            handler.sync()
        super().sync()

    def reset(self):
        """After the elastic reset: the gradient stream is discontinuous,
        so a ``DistributedOptimizer`` forgets the allreduces the old round
        left in flight and drops its error-feedback residuals (its
        ``reset_wire_state``), never injecting them into the new round."""
        for handler in self._handlers.values():
            if not isinstance(handler, OptimizerStateHandler):
                continue
            for name in ("_drop_handles", "reset_wire_state"):
                fn = getattr(handler.value, name, None)
                if fn is not None:
                    fn()

    def __setattr__(self, name, value):
        if hasattr(self, "_handlers") and name in self._handlers:
            self._handlers[name].set_value(value)
        super().__setattr__(name, value)

    # the crash-durable spill covers model and optimizer state too (the
    # exec-restart recovery path, common/elastic.py _spill_path)
    def _spill_payload(self):
        payload = super()._spill_payload() or {}
        payload["handlers"] = {
            name: _to_cpu(handler.saved_state())
            for name, handler in self._handlers.items()}
        return payload

    def _load_spill(self, payload):
        super()._load_spill(payload)
        for name, saved in payload.get("handlers", {}).items():
            handler = self._handlers.get(name)
            if handler is not None and saved is not None:
                handler.load_saved_state(saved)
                handler.restore()
