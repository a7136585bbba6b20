"""Torch elastic API (port of ``horovod_tpu/torch/elastic/__init__.py``;
reference ``horovod/torch/elastic/__init__.py``).

``run`` wraps a training function in the elastic retry loop; the state
classes live in :mod:`.state`, the resharding sampler in :mod:`.sampler`.
"""

from ...common.elastic import run_fn
from .sampler import ElasticSampler  # noqa: F401
from .state import (  # noqa: F401
    ModelStateHandler,
    OptimizerStateHandler,
    SamplerStateHandler,
    StateHandler,
    TorchState,
    get_handler_registry,
    set_handler_registry,
)


def run(func):
    """Decorator: the elastic retry loop, re-initializing the engine and
    its process group on a reset (reference torch/elastic/__init__.py
    run)."""
    from ...elastic import _reset
    return run_fn(func, _reset)
