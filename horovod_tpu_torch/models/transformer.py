"""Decoder-only Transformer LM in PyTorch (port of
``horovod_tpu/models/transformer.py``, the dense training model).

Pre-RMSNorm, rotary position embeddings (channels split in halves),
SwiGLU or a top-k mixture of experts (``num_experts > 0``: the dense
one-hot dispatch, or fixed-capacity routing through ``parallel/moe.py``
when ``moe_capacity_factor > 0``), a tied embedding, f32 parameters and
activations in ``cfg.dtype``.  Layer for layer the flax model, so that
its parameters load as they are (:func:`from_flax_params`):

* flax's ``nn.scan`` over a stacked ``layers`` axis becomes an
  ``nn.ModuleList`` of :class:`DecoderBlock`;
* ``DenseGeneral`` kernels ``(M, H, D)`` and ``(H, D, M)`` become
  ``(out, in)`` weights used through ``F.linear`` on ``(M, H*D)`` views;
* the logits and the attention scores come out in f32, as the flax
  model's ``preferred_element_type=float32`` einsums give them.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: KV-cache decoding and ``make_generate_fn`` (A16), remat,
``pre_logits`` and the fused chunked loss (A11).
"""

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_ff: int = 1408
    max_seq_len: int = 2048
    num_experts: int = 0
    expert_top_k: int = 2
    moe_capacity_factor: float = 0.0
    n_kv_heads: Optional[int] = None
    attention_window: Optional[int] = None
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    remat: bool = False
    remat_policy: str = "full"

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def kv_heads(self):
        kv = self.n_kv_heads if self.n_kv_heads is not None \
            else self.n_heads
        if kv < 1 or self.n_heads % kv:
            raise ValueError(
                f"n_kv_heads ({kv}) must divide n_heads "
                f"({self.n_heads})")
        return kv


def rope_angles(head_dim: int, max_seq: int, theta: float) -> np.ndarray:
    """Precomputed rotary angles (max_seq, head_dim // 2), float32."""
    inv_freq = 1.0 / theta ** (np.arange(0, head_dim, 2) / head_dim)
    pos = np.arange(max_seq)
    return np.einsum("s,f->sf", pos, inv_freq).astype(np.float32)


def apply_rope(x, angles):
    """x: (B, S, H, D); angles: (S, D//2) -- rotate the two halves of the
    channels, in f32."""
    sin = torch.sin(angles)[None, :, None, :]
    cos = torch.cos(angles)[None, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_causal_attention(q, k, v, *, offset=0, window=None):
    """Reference attention inner: (B, S, H, D) -> (B, S, H, D), causal,
    optionally windowed.  Scores in f32: the operands are upcast, which
    keeps every product of bf16 inputs exact, as the flax einsum with
    ``preferred_element_type=float32`` does."""
    depth = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(depth)
    q_pos = torch.arange(q.shape[1], device=q.device)[:, None] + offset
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = q_pos >= k_pos
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class Dense(nn.Module):
    """Bias-free dense layer: f32 ``weight`` (out, in), applied in
    ``dtype`` (flax ``Dense(use_bias=False, dtype=dtype,
    param_dtype=float32)``)."""

    def __init__(self, features_in, features_out, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features_out, features_in))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim, dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + 1e-6)
        return (y * self.scale).to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Callable = dense_causal_attention):
        super().__init__()
        self.cfg, self.attention_fn = cfg, attention_fn
        H, KV, D, M = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
        self.wq = Dense(M, H * D, cfg.dtype)
        self.wk = Dense(M, KV * D, cfg.dtype)
        self.wv = Dense(M, KV * D, cfg.dtype)
        self.wo = Dense(H * D, M, cfg.dtype)

    def forward(self, x, angles):
        cfg = self.cfg
        B, S, _ = x.shape
        H, KV, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q = apply_rope(self.wq(x).view(B, S, H, D), angles)
        k = apply_rope(self.wk(x).view(B, S, KV, D), angles)
        v = self.wv(x).view(B, S, KV, D)
        if KV != H:
            # GQA: each kv head serves H/KV query heads (jnp.repeat)
            k = k.repeat_interleave(H // KV, dim=2)
            v = v.repeat_interleave(H // KV, dim=2)
        if cfg.attention_window is not None:
            o = self.attention_fn(q, k, v, window=cfg.attention_window)
        else:
            o = self.attention_fn(q, k, v)
        return self.wo(o.reshape(B, S, H * D))


class SwiGLU(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        M, Fd = cfg.d_model, cfg.d_ff
        self.wi_gate = Dense(M, Fd, cfg.dtype)
        self.wi_up = Dense(M, Fd, cfg.dtype)
        self.wo = Dense(Fd, M, cfg.dtype)

    def forward(self, x):
        return self.wo(F.silu(self.wi_gate(x)) * self.wi_up(x))


class MoE(nn.Module):
    """Top-k mixture of experts (flax ``MoE``, ``transformer.py:265-327``
    of the JAX package): an f32 router, expert weights with a leading E
    axis kept in f32 and cast to ``cfg.dtype`` (``wi_gate``/``wi_up``
    (E, M, F), ``wo`` (E, F, M)).  With ``moe_capacity_factor > 0`` the
    tokens route into fixed-capacity slots (``parallel/moe.py``) and the
    step's dropped choices stay readable in :attr:`moe_dropped` (the
    flax ``sow("intermediates", "moe_dropped")``); otherwise every expert
    runs on every token under a one-hot dispatch."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        E, M, Fd = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Linear(M, E, bias=False)
        self.wi_gate = nn.Parameter(torch.empty(E, M, Fd))
        self.wi_up = nn.Parameter(torch.empty(E, M, Fd))
        self.wo = nn.Parameter(torch.empty(E, Fd, M))
        #: dropped choices of the last capacity-routed forward (0-d int32)
        self.moe_dropped = None

    def forward(self, x):
        from ..parallel import moe as moe_mod

        cfg = self.cfg
        B, S, M = x.shape
        E, K, dt = cfg.num_experts, cfg.expert_top_k, cfg.dtype
        logits = F.linear(x.float(), self.router.weight.float())
        wi_gate, wi_up = self.wi_gate.to(dt), self.wi_up.to(dt)
        wo = self.wo.to(dt)
        if cfg.moe_capacity_factor > 0:
            T = B * S
            w, idx = moe_mod.top_k_gating(logits.reshape(T, E), K)
            cap = moe_mod.expert_capacity(T, E, K, cfg.moe_capacity_factor)
            pos, keep, n_dropped = moe_mod.make_dispatch_plan(idx, E, cap)
            slots = moe_mod.moe_dispatch(x.reshape(T, M), idx, pos, keep,
                                         E, cap)
            ye = moe_mod.expert_swiglu(slots, wi_gate, wi_up, wo)
            y = moe_mod.moe_combine(ye, idx, pos, keep, w)
            self.moe_dropped = n_dropped.detach()
            return y.reshape(B, S, M).to(dt)
        w, idx = moe_mod.top_k_gating(logits, K)
        dispatch = moe_mod.one_hot(idx, E).to(dt)           # (B, S, K, E)
        combine = dispatch * w[..., None].to(dt)
        xe = torch.einsum("bske,bsm->ebsm", dispatch, x)
        gate = F.silu(torch.einsum("ebsm,emf->ebsf", xe, wi_gate))
        up = torch.einsum("ebsm,emf->ebsf", xe, wi_up)
        ye = torch.einsum("ebsf,efm->ebsm", gate * up, wo)
        return torch.einsum("bske,ebsm->bsm", combine, ye)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Callable = dense_causal_attention):
        super().__init__()
        self.ln_attn = RMSNorm(cfg.d_model, cfg.dtype)
        self.attn = Attention(cfg, attention_fn)
        self.ln_mlp = RMSNorm(cfg.d_model, cfg.dtype)
        # flax names the block's feed-forward "moe" or "mlp" (:338)
        self.ff_name = "moe" if cfg.num_experts else "mlp"
        self.add_module(self.ff_name,
                        MoE(cfg) if cfg.num_experts else SwiGLU(cfg))

    def forward(self, x, angles):
        x = x + self.attn(self.ln_attn(x), angles)
        return x + getattr(self, self.ff_name)(self.ln_mlp(x))


class TransformerLM(nn.Module):
    """Token ids (B, S) -> logits (B, S, V) in f32."""

    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Callable = dense_causal_attention):
        super().__init__()
        if cfg.remat:
            raise NotImplementedError(
                "remat is not ported yet (ROADMAP.md A11)")
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, attention_fn) for _ in range(cfg.n_layers))
        self.ln_final = RMSNorm(cfg.d_model, cfg.dtype)
        self._angles = {}

    def angles(self, device):
        """The rotary angles on ``device`` (made once per device)."""
        a = self._angles.get(device)
        if a is None:
            cfg = self.cfg
            a = self._angles[device] = torch.from_numpy(rope_angles(
                cfg.head_dim, cfg.max_seq_len, cfg.rope_theta)).to(device)
        return a

    def forward(self, tokens, *, decode=False, pre_logits=False):
        if decode:
            raise NotImplementedError(
                "KV-cache decoding is not ported yet (ROADMAP.md A16)")
        if pre_logits:
            raise NotImplementedError(
                "pre_logits (for the fused chunked loss) is not ported "
                "yet (ROADMAP.md A11)")
        cfg = self.cfg
        x = self.embed[tokens].to(cfg.dtype)
        angles = self.angles(tokens.device)[:tokens.shape[1]]
        for block in self.layers:
            x = block(x, angles)
        x = self.ln_final(x)
        # logits in f32 from cfg.dtype operands: the bf16-rounded operands
        # are upcast (exact products, f32 sums), as the flax einsum with
        # preferred_element_type=float32 computes them
        return torch.matmul(x.float(), self.embed.to(cfg.dtype).float().t())


def lm_loss(logits, targets):
    """Mean next-token cross-entropy; targets already shifted."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, targets[..., None])[..., 0]
    return -ll.mean()


def chunked_lm_loss(*args, **kwargs):
    raise NotImplementedError(
        "the fused chunked loss is not ported yet (ROADMAP.md A11)")


def make_fused_lm_loss(*args, **kwargs):
    raise NotImplementedError(
        "the fused chunked loss is not ported yet (ROADMAP.md A11)")


def make_generate_fn(*args, **kwargs):
    raise NotImplementedError(
        "KV-cache generation is not ported yet (ROADMAP.md A16)")


# ---------------------------------------------------------------------------
# weights

def _truncated_normal(rng, shape, std):
    """flax's truncated normal: standard normal cut to [-2, 2], scaled
    so that the result has standard deviation ``std``."""
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2
    return x * np.float32(std / 0.87962566103423978)


def numpy_init(model: TransformerLM, seed):
    """A state dict for ``model`` drawn from ``numpy`` with ``seed``,
    with flax's initializers: normal(0.02) embedding, LeCun-normal
    (truncated) dense kernels, unit RMSNorm scales.  The same seed gives
    the same weights on every device."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name == "embed":
            state[name] = rng.standard_normal(shape, dtype=np.float32) \
                * np.float32(0.02)
        elif name.endswith(".scale"):
            state[name] = np.ones(shape, np.float32)
        elif len(shape) == 3:
            # expert kernels (E, in, out): flax's fan_in counts the E
            # axis as receptive field, E * in
            state[name] = _truncated_normal(
                rng, shape, math.sqrt(1.0 / (shape[0] * shape[1])))
        else:                                    # (out, in): fan_in = in
            state[name] = _truncated_normal(rng, shape,
                                            math.sqrt(1.0 / shape[1]))
    return {k: torch.from_numpy(v) for k, v in state.items()}


def from_flax_params(params):
    """The port's ``state_dict`` for the flax ``params`` tree of
    ``horovod_tpu.models.transformer.TransformerLM`` (nested dicts of
    arrays): the stacked ``layers`` axis splits into blocks, and each
    kernel becomes an ``(out, in)`` weight."""
    def arr(x):
        return np.array(x, dtype=np.float32)

    state = {"embed": arr(params["embed"]),
             "ln_final.scale": arr(params["ln_final"]["scale"])}
    layers = params["layers"]
    L = arr(layers["ln_attn"]["scale"]).shape[0]
    for i in range(L):
        pre = f"layers.{i}."
        for ln in ("ln_attn", "ln_mlp"):
            state[pre + ln + ".scale"] = arr(layers[ln]["scale"])[i]
        for name in ("wq", "wk", "wv"):               # (M, H, D)
            k = arr(layers["attn"][name]["kernel"])[i]
            state[pre + f"attn.{name}.weight"] = k.reshape(k.shape[0], -1).T
        k = arr(layers["attn"]["wo"]["kernel"])[i]    # (H, D, M)
        state[pre + "attn.wo.weight"] = k.reshape(-1, k.shape[-1]).T
        if "moe" in layers:
            moe = layers["moe"]
            state[pre + "moe.router.weight"] = \
                arr(moe["router"]["kernel"])[i].T      # (M, E) -> (E, M)
            for name in ("wi_gate", "wi_up", "wo"):   # leading E axis
                state[pre + f"moe.{name}"] = arr(moe[name])[i]
            continue
        for name in ("wi_gate", "wi_up", "wo"):       # (in, out)
            state[pre + f"mlp.{name}.weight"] = \
                arr(layers["mlp"][name]["kernel"])[i].T
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in state.items()}
