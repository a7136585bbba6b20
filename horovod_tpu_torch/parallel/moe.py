"""Expert parallelism: capacity-factor token routing (port of
``horovod_tpu/parallel/moe.py``).

The fixed-capacity formulation (Switch / GShard style): tokens scatter
into per-expert slots of a static size, overflow is dropped
deterministically and underflow is zero-padded, so the dispatched
tensor's shape never depends on the routing.  The static ``(E, C, M)``
layout is what the alltoall wire wants: equal splits, so the exchange
rides :class:`~..ops.compiled.CompiledAlltoall` or ``hvd.alltoall`` with
the int8/int4 codec.

Determinism: the same logits give the same routes and the same drops.
Top-k breaks ties by the lowest expert index, as ``lax.top_k`` does
(``torch.topk`` promises no order among equal values, so the top k are
taken from a stable descending sort), and slot priority is token-major
(token t's k-th choice outranks token t+1's first).

``quantized_all_to_all`` and ``capacity_moe_apply(axis_name=...)`` run
inside ``shard_map`` over an ``ep`` mesh axis in the JAX package; the
port has no mesh yet and refuses them (ROADMAP.md A15).
"""

import torch
import torch.nn.functional as F

__all__ = [
    "MOE_EP_CHOICES", "MOE_CF_CHOICES", "MOE_CHOICES", "moe_label",
    "parse_moe_label", "snap_ep", "expert_capacity", "top_k_gating",
    "make_dispatch_plan", "straight_through", "moe_dispatch",
    "moe_combine", "capacity_moe_apply", "quantized_all_to_all",
    "dense_flop_matched_ff",
]

#: expert-parallel degrees the autotuner sweeps (snapped to a divisor of
#: the set size by :func:`snap_ep`)
MOE_EP_CHOICES = (1, 2, 4, 8)

#: capacity factors the autotuner sweeps
MOE_CF_CHOICES = (1.0, 1.25, 1.5)

#: the (ep, capacity factor) pairs, one categorical dimension
MOE_CHOICES = tuple(
    (ep, cf) for ep in MOE_EP_CHOICES for cf in MOE_CF_CHOICES)


def moe_label(ep, cf):
    """The pair's spelling, ``ep<ep>xcf<cf>``."""
    return f"ep{int(ep)}xcf{float(cf):g}"


def parse_moe_label(label):
    """Inverse of :func:`moe_label` -> (ep, capacity_factor)."""
    body = label.strip().lower()
    if not body.startswith("ep") or "xcf" not in body:
        raise ValueError(f"not a moe label: {label!r}")
    ep_s, cf_s = body[2:].split("xcf", 1)
    return int(ep_s), float(cf_s)


def snap_ep(ep, world_size):
    """Largest divisor of ``world_size`` that is <= max(ep, 1): every
    rank hosts the same number of experts (the equal-splits contract of
    the alltoall wire)."""
    ep = max(int(ep or 1), 1)
    world_size = max(int(world_size), 1)
    best = 1
    for d in range(1, min(ep, world_size) + 1):
        if world_size % d == 0:
            best = d
    return best


def expert_capacity(n_tokens, num_experts, topk, capacity_factor):
    """Per-expert slot count ``ceil(cf * tokens * topk / experts)``, at
    least 1 (the JAX package's float arithmetic)."""
    if num_experts < 1:
        raise ValueError("num_experts must be >= 1")
    slots = float(capacity_factor) * int(n_tokens) * int(topk)
    return max(int(-(-slots // num_experts)), 1)


def top_k_gating(logits, topk):
    """Softmax over ALL experts in f32, the k largest (ties to the lowest
    index), renormalized among the selected.  Returns ``(weights, idx)``,
    both ``(..., topk)``, idx int64.  The selection carries no gradient;
    the router learns through the selected weights."""
    probs = torch.softmax(logits.float(), dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = srt[..., :topk], order[..., :topk]
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx


def one_hot(idx, num_classes):
    """``F.one_hot`` (int64) without its range check, which on the card
    waits for the device to read the indices back."""
    return (idx[..., None] == torch.arange(
        num_classes, device=idx.device)).to(torch.int64)


def make_dispatch_plan(idx, num_experts, capacity):
    """Slot assignment of the routed choices ``idx`` (T, K): returns
    ``(pos, keep, n_dropped)``, ``pos`` (T, K) int64 each choice's slot in
    its expert's arrival order, ``keep`` (T, K) bool the choices under
    ``capacity``, ``n_dropped`` the overflow count (a 0-d int32 tensor).
    Priority is token-major: a running count per expert over the choices
    flattened t-major."""
    T, K = idx.shape
    # expert-major (E, TK): the running count is a scan along the long
    # axis (a scan down 8 columns of 20480 rows ran 3.8 ms on an H100)
    oh = one_hot(idx.reshape(T * K), num_experts).t()        # (E, TK)
    pos = ((torch.cumsum(oh, dim=1) - 1) * oh).sum(dim=0)    # (TK,)
    keep = pos < capacity
    n_dropped = (~keep).sum().to(torch.int32)
    return pos.reshape(T, K), keep.reshape(T, K), n_dropped


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, keep):
        return weights * keep.to(weights.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def straight_through(weights, keep):
    """``weights * keep`` forward; identity to ``weights`` backward, so
    the router keeps its gradient for the choices that overflowed."""
    return _StraightThrough.apply(weights, keep)


def _slots(idx, pos, capacity):
    """Flat slot of each choice: ``idx * C + min(pos, C - 1)`` (a dropped
    choice is clamped onto the expert's last slot and adds x * 0)."""
    return (idx.reshape(-1) * capacity
            + torch.clamp(pos.reshape(-1), max=capacity - 1))


def moe_dispatch(x, idx, pos, keep, num_experts, capacity):
    """Scatter tokens ``x`` (T, M) into the slot tensor ``(E, C, M)``: the
    kept choice (t, k) lands at ``[idx[t, k], pos[t, k]]``, empty slots
    are zero.  A dropped choice adds ``x * 0`` at its expert's last slot,
    as the JAX scatter-add does: exact for finite ``x`` (an inf or NaN
    token makes that slot NaN in both packages).  ``index_add_`` on the
    card adds with atomics; the sums are still exact, since every
    duplicate index adds zero to the one kept value."""
    T, M = x.shape
    K = idx.shape[1]
    vals = x.repeat_interleave(K, dim=0) \
        * keep.reshape(T * K, 1).to(x.dtype)
    out = torch.zeros(num_experts * capacity, M, dtype=x.dtype,
                      device=x.device)
    out = out.index_add(0, _slots(idx, pos, capacity), vals)
    return out.view(num_experts, capacity, M)


def moe_combine(expert_out, idx, pos, keep, weights):
    """Gather the expert outputs back to token order and mix:
    ``y[t] = sum_k st(w)[t, k] * out[idx[t, k], pos[t, k]]``; dropped
    choices contribute zero."""
    E, C, M = expert_out.shape
    T, K = idx.shape
    flat = expert_out.reshape(E * C, M)
    # index_select: its backward is an index_add (the JAX scatter-add);
    # advanced indexing's backward sorts the indices first
    gathered = flat.index_select(0, _slots(idx, pos, C)).view(T, K, M)
    gathered = gathered * keep.view(T, K, 1).to(flat.dtype)
    w = straight_through(weights, keep).to(flat.dtype)
    return torch.einsum("tk,tkm->tm", w, gathered)


def expert_swiglu(slots, wi_gate, wi_up, wo):
    """The experts' SwiGLU on their slots: ``(E, C, M)`` with ``wi_*``
    (E, M, F) and ``wo`` (E, F, M), the JAX einsums ``ecm,emf->ecf`` and
    ``ecf,efm->ecm`` as batched products."""
    gate = F.silu(torch.bmm(slots, wi_gate))
    up = torch.bmm(slots, wi_up)
    return torch.bmm(gate * up, wo)


def capacity_moe_apply(x, router_w, wi_gate, wi_up, wo, *, topk,
                       capacity_factor, axis_name=None, wire=None):
    """One fixed-capacity MoE FFN on one rank: route, dispatch, SwiGLU
    experts, combine.  ``x`` (T, M); ``router_w`` (M, E); expert weights
    with a leading E axis.  Returns ``(y, aux)``, ``aux`` holding
    ``n_dropped`` and ``capacity``.  ``axis_name`` (the exchange over an
    ``ep`` mesh axis) is not ported yet (ROADMAP.md A15)."""
    if axis_name is not None:
        raise NotImplementedError(
            "capacity_moe_apply over an ep mesh axis is not ported yet "
            "(ROADMAP.md A15); exchange the slots with hvd.alltoall or "
            "CompiledAlltoall")
    T, M = x.shape
    E = router_w.shape[-1]
    logits = x.float() @ router_w.float()
    weights, idx = top_k_gating(logits, topk)
    cap = expert_capacity(T, E, topk, capacity_factor)
    pos, keep, n_dropped = make_dispatch_plan(idx, E, cap)
    slots = moe_dispatch(x, idx, pos, keep, E, cap)
    out = expert_swiglu(slots, wi_gate, wi_up, wo)
    y = moe_combine(out, idx, pos, keep, weights).to(x.dtype)
    return y, {"n_dropped": n_dropped, "capacity": cap}


def quantized_all_to_all(x, axis_name, wire=None):
    """The in-graph exchange over an ``ep`` mesh axis: not ported yet
    (ROADMAP.md A15)."""
    raise NotImplementedError(
        "quantized_all_to_all over an ep mesh axis is not ported yet "
        "(ROADMAP.md A15); use hvd.alltoall(..., wire_dtype=...) or "
        "CompiledAlltoall")


def dense_flop_matched_ff(d_ff_expert, topk):
    """Hidden width of the dense FFN whose per-token FLOPs match a top-k
    MoE with per-expert hidden ``d_ff_expert``."""
    return int(d_ff_expert) * int(topk)
