"""The LM training step (port of ``horovod_tpu/parallel/train.py``
``make_lm_train_step``, single-device data parallelism).

Where the JAX package compiles forward, backward and the optimizer update
into one program over a mesh, the port runs them eagerly on one device:
``make_lm_train_step(cfg, device=...)`` takes the device where JAX takes
the mesh.  ``attention_impl="flash"`` runs attention through the flash
kernels (``ops/flash_attention.py``); ``"ring"`` without sequence
parallelism is the dense model, as in the JAX package.  Sequence
parallelism, the pipeline runtime and the fused loss are not ported yet
and raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

import torch

from ..common.basics import resolve_device
from ..models.transformer import (
    TransformerConfig, TransformerLM, lm_loss, numpy_init,
)
from ..ops.flash_attention import flash_attention


def adamw(learning_rate=1e-3):
    """``torch.optim.AdamW`` with optax ``adamw``'s defaults: betas (0.9,
    0.999), eps 1e-8, weight decay 1e-4 (torch's own default is 1e-2).
    optax applies ``-lr * (adam + wd * p)``, torch ``p * (1 - lr * wd)``
    and then the Adam step: the same map."""
    def build(params):
        return torch.optim.AdamW(params, lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    return build


def sgd(learning_rate, momentum=None):
    """``torch.optim.SGD`` as optax ``sgd(learning_rate, momentum)``:
    ``buf = momentum * buf + g`` then ``p -= lr * buf`` (torch's dampening
    0, no Nesterov); without momentum ``p -= lr * g``."""
    def build(params):
        return torch.optim.SGD(params, lr=learning_rate,
                               momentum=momentum or 0.0)
    return build


def make_lm_train_step(cfg: TransformerConfig, optimizer=None, *,
                       device=None, sequence_parallel: bool = False,
                       attention_impl: str = "ring",
                       learning_rate: float = 1e-3,
                       fused_ce: bool = False,
                       pipeline=None, sharded=None):
    """Build ``(init, step)`` for the transformer on ``device`` (the card
    unless ``device="cpu"``).

    ``optimizer`` is a function from the model's parameters to a
    ``torch.optim.Optimizer`` (default :func:`adamw` at
    ``learning_rate``).  ``init(params)`` takes an int seed (weights from
    :func:`~..models.transformer.numpy_init`) or a state dict (e.g. from
    :func:`~..models.transformer.from_flax_params`) and returns the
    state ``{"model", "optimizer", "step"}``.  ``step(state, tokens) ->
    (state, loss)`` trains one step on the (B, S) token ids, updating
    the state in place, and returns the loss as a device scalar without
    waiting for it; the gradients of the step stay in ``p.grad``.

    ``sharded`` (in the JAX package None reads
    ``HOROVOD_SHARDED_OPTIMIZER``) shards the optimizer state over the
    step's data-parallel ranks.  This step runs one data-parallel rank on
    one device, where the sharded step is the dense one, as the JAX
    package's is on a mesh with dp = 1, so every value gives the dense
    step; the LM sharded across rank threads is
    ``make_compiled_train_step(..., sharded=True)`` over the model's loss.
    """
    if attention_impl not in ("ring", "ulysses", "flash"):
        raise ValueError(
            f"attention_impl must be 'ring', 'ulysses', or 'flash', "
            f"got {attention_impl!r}")
    if pipeline is not None:
        raise NotImplementedError(
            "the pipeline runtime is not ported yet (ROADMAP.md A15)")
    if not sequence_parallel and attention_impl not in ("ring", "flash"):
        raise ValueError(
            "attention_impl='ulysses' only takes effect with "
            "sequence_parallel=True — set it, or drop attention_impl")
    if sequence_parallel:
        if attention_impl == "flash":
            raise ValueError(
                "attention_impl='flash' is the single-shard flash "
                "kernel; with sequence_parallel use 'ring' or 'ulysses'")
        raise NotImplementedError(
            "sequence parallelism is not ported yet (ROADMAP.md A15)")
    if fused_ce:
        raise NotImplementedError(
            "the fused chunked loss is not ported yet (ROADMAP.md A11)")
    device = resolve_device(device)
    optimizer = optimizer or adamw(learning_rate)
    kwargs = {"attention_fn": flash_attention} \
        if attention_impl == "flash" else {}

    def init(params):
        with torch.device("meta"):
            model = TransformerLM(cfg, **kwargs)
        state = numpy_init(model, params) if isinstance(params, int) \
            else params
        model.to_empty(device=device)
        model.load_state_dict(state)
        return {"model": model,
                "optimizer": optimizer(list(model.parameters())),
                "step": 0}

    def step(state, tokens):
        model, opt = state["model"], state["optimizer"]
        tokens = torch.as_tensor(tokens, device=device)
        opt.zero_grad(set_to_none=True)
        logits = model(tokens)
        # next-token prediction: shift targets left
        loss = lm_loss(logits[:, :-1], tokens[:, 1:])
        loss.backward()
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    return init, step
