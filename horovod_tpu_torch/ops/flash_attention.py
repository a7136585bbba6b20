"""Causal flash attention: three hand-written Hopper kernels, their plain
PyTorch versions, and the differentiable ``flash_attention``.

Port of ``horovod_tpu/ops/pallas_kernels.py::flash_attention`` and its
three Pallas kernels (forward ``_flash_kernel``, backward
``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``).  On the card
they are the CUDA kernels of ``ops/csrc/flash_sm90.cu`` for bf16 and f16
inputs (wgmma, TMA, scores in registers) and of
``ops/csrc/flash_attention.cu`` for f32; the plain
versions below compute the same functions, with the same casts, on
``(BH, S, D)`` tensors:

* ``flash_fwd(q, k, v, window) -> (out, lse)``: scores ``f32(q . k^T)``
  times ``1/sqrt(D)``, causal (and windowed) mask, softmax in f32, ``p``
  cast to ``v``'s dtype before ``p . v``, ``out`` in the input dtype,
  ``lse`` (BH, S) f32;
* ``flash_bwd_dq(q, k, v, dout, lse, delta, window) -> dq``;
* ``flash_bwd_dkv(q, k, v, dout, lse, delta, window) -> (dk, dv)``.

The plain versions materialise the (S, S) scores in f32: they are a
yardstick of values, not of speed.  Dispatch is by the device of the
tensors: CPU tensors take the plain version; CUDA tensors launch the
kernel, and a failure to build or launch raises.  Each kernel counts its
launches in :data:`launches`.
"""

import ctypes
import math
import threading

import torch

from . import _build

#: dtype codes of ops/csrc/flash_attention.cu
_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
#: head dims the kernels are built for
HEAD_DIMS = (64, 128)
_NEG_INF = -1e30

#: kernel launches per kernel, since the last reset_launches()
launches = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for k in launches:
            launches[k] = 0


def _count(name):
    with _count_lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's yardstick)

def _visible(S, window, device):
    pos = torch.arange(S, device=device)
    diff = pos[:, None] - pos[None, :]
    mask = diff >= 0
    if window:
        mask = mask & (diff < window)
    return mask


def _probs(q, k, lse, window):
    """p = exp(s - lse) on the visible pairs, 0 elsewhere, in f32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    return torch.where(_visible(q.shape[1], window, q.device), p, 0.0)


def plain_flash_fwd(q, k, v, window=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(q.shape[1], window, q.device)
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l[..., None]).to(q.dtype), m + torch.log(l)


def plain_flash_bwd_dq(q, k, v, dout, lse, delta, window=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, window)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(ds.to(k.dtype).float(), k.float())
            * scale).to(q.dtype)


def plain_flash_bwd_dkv(q, k, v, dout, lse, delta, window=None):
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, window)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def plain_error_scales(q, k, v, dout, out, lse, delta, window=None):
    """Elementwise scales, in f32 and shaped like each output, of how far
    a kernel may lie from the plain version on the same inputs.

    ``rss_out``, ``rss_dq``, ``rss_dk``, ``rss_dv``: the root sum of
    squares of the terms each output element sums after their cast to
    the working dtype (``p v / l`` for out, ``p^T dO`` for dv,
    ``scale ds k`` for dq, ``scale ds^T q`` for dk).  Kernel and plain
    version round each term on its own, by at most eps/2 of it, so by
    Hoeffding's inequality the two sums differ by more than
    ``8 * eps * rss`` with probability below ``2 * exp(-32)``.

    ``noise_dq``, ``noise_dk``: the backward on absolute values, with
    ``|dO| |v|^T + rowsum(|dO| * |out|)`` in place of ``dp - delta``.
    f32 rounding of ``dp`` and ``delta`` perturbs dq and dk by up to
    ``2 * D * 2**-24`` of these; where ``dp - delta`` cancels (wholly at
    window 1, where dq and dk are 0) that noise is all there is."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = _probs(q, k, lse, window)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds2 = (p * (dp - delta[..., None])).square()
    p2 = p.square()
    del dp
    sq = {name: t.float().square() for name, t in
          (("q", q), ("k", k), ("v", v), ("dout", dout))}
    scales = {
        "rss_out": torch.matmul(p2, sq["v"]).sqrt(),
        "rss_dv": torch.matmul(p2.transpose(-1, -2), sq["dout"]).sqrt(),
        "rss_dq": torch.matmul(ds2, sq["k"]).sqrt() * scale,
        "rss_dk": torch.matmul(ds2.transpose(-1, -2), sq["q"]).sqrt() * scale}
    del p2, ds2
    dp_abs = torch.matmul(dout.float().abs(),
                          v.float().abs().transpose(-1, -2))
    delta_abs = (dout.float().abs() * out.float().abs()).sum(dim=-1)
    w = p * (dp_abs + delta_abs[..., None])
    scales["noise_dq"] = torch.matmul(w, k.float().abs()) * scale
    scales["noise_dk"] = torch.matmul(w.transpose(-1, -2),
                                      q.float().abs()) * scale
    return scales


def error_ratio(got, want, dtype, rss=None, noise=None):
    """``(max |got - want|, ratio)``: how far a kernel's output ``got``
    lies from the plain version's ``want``, computed from inputs of
    ``dtype``, against its bounds; the kernel passes where ``ratio <= 1``.

    ``ratio`` is the larger of two.  Elementwise, ``|got - want|`` over
    ``1e-5 * max|want|`` for f32 (summation order, TF32 off), or for
    16-bit types over two ulps of ``dtype`` at ``|want|`` (the outputs'
    rounding) plus ``8 * eps * rss`` (the rounding of the summed terms,
    see :func:`plain_error_scales`).  Over the tensor, the relative L2
    distance over ``1e-2``.  dq and dk add ``2**-16 * noise`` to both."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    if dtype == torch.float32:
        bound = torch.full_like(mag, 1e-5 * float(mag.max()))
    else:
        eps = torch.finfo(dtype).eps
        ulp = torch.ldexp(torch.full_like(mag, eps),
                          torch.frexp(mag).exponent - 1)
        bound = 2 * ulp + 8 * eps * rss
    l2_bound = 1e-2 * float(mag.norm())
    if noise is not None:
        bound = bound + 2.0 ** -16 * noise
        l2_bound += 2.0 ** -16 * float(noise.norm())
    elem = float((diff / bound.clamp_min(torch.finfo(torch.float32).tiny))
                 .max())
    l2 = float(diff.norm()) / l2_bound if l2_bound else float(diff.norm())
    err = float(diff.max())
    if not math.isfinite(err):
        return err, math.inf
    return err, max(elem, l2)


# ---------------------------------------------------------------------------
# kernels

def _lib():
    lib = _build.load("hvd_flash", ["flash_attention.cu", "flash_sm90.cu"])
    if not getattr(lib, "_hvd_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hvd_flash_fwd.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
        lib.hvd_flash_bwd_dq.argtypes = [i, p, p, p, p, p, p, p,
                                         i, i, i, i, i, p]
        lib.hvd_flash_bwd_dkv.argtypes = [i, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, p]
        for fn in (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq,
                   lib.hvd_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib._hvd_typed = True
    return lib


def _check(name, window, qkv, rows=()):
    """Validate one launch's inputs: ``window`` None or >= 1, ``qkv``
    (BH, S, D) tensors of one dtype, ``rows`` (BH, S) f32 tensors, all
    contiguous on one device.  Returns the device."""
    if window is not None and int(window) < 1:
        raise ValueError(f"{name}: window must be None or >= 1, got "
                         f"{window}")
    q = qkv[0]
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (BH, S, D), got {tuple(q.shape)}")
    if q.dtype not in _CODES:
        raise TypeError(f"{name} does not take {q.dtype}")
    device = q.device
    for t in qkv:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(
                f"{name}: q, k, v (and dout) need one shape and dtype: "
                f"{tuple(t.shape)} {t.dtype} vs {tuple(q.shape)} {q.dtype}")
    for t in rows:
        if t.shape != q.shape[:2] or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse and delta must be f32 "
                             f"{tuple(q.shape[:2])}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    for t in (*qkv, *rows):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if device.type == "cuda":
        if q.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: the kernel takes head dims "
                             f"{HEAD_DIMS}, got {q.shape[-1]}")
        if any(t.data_ptr() % 16 for t in qkv):
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
    return device


def _launch(name, fn, q, window, *ptrs):
    """Call ``fn`` (a C entry point) on ``q``'s device and stream; raise
    on a cudaError, count the launch otherwise."""
    device = q.device
    BH, S, D = q.shape
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    err = fn(index, *ptrs, BH, S, D, 0 if window is None else int(window),
             _CODES[q.dtype], torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"(BH={BH}, S={S}, D={D}, {q.dtype})")
    _count(name)


def flash_fwd(q, k, v, window=None):
    """``(out, lse)`` of causal attention over (BH, S, D) ``q, k, v``."""
    if _check("flash_fwd", window, (q, k, v)).type == "cpu":
        return plain_flash_fwd(q, k, v, window)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", _lib().hvd_flash_fwd, q, window, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr())
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, window=None):
    """``dq`` of :func:`flash_fwd`, given its ``lse`` and
    ``delta = rowsum(f32(dout) * f32(out))``."""
    if _check("flash_bwd_dq", window, (q, k, v, dout),
              (lse, delta)).type == "cpu":
        return plain_flash_bwd_dq(q, k, v, dout, lse, delta, window)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _lib().hvd_flash_bwd_dq, q, window,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, window=None):
    """``(dk, dv)`` of :func:`flash_fwd`; arguments as for
    :func:`flash_bwd_dq`."""
    if _check("flash_bwd_dkv", window, (q, k, v, dout),
              (lse, delta)).type == "cpu":
        return plain_flash_bwd_dkv(q, k, v, dout, lse, delta, window)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", _lib().hvd_flash_bwd_dkv, q, window,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr())
    return dk, dv


# ---------------------------------------------------------------------------
# the differentiable function

class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        out, lse = flash_fwd(q, k, v, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        # rowsum(dO * O) in plain torch, as the JAX package computes it
        # outside its kernels (pallas_kernels.py:496)
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, ctx.window)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, ctx.window)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, block_q=512, block_k=512,
                    bwd_block_q=None, bwd_block_k=None, window=None):
    """Causal attention (B, S, H, D) -> (B, S, H, D), flash-style, with
    the contract of ``horovod_tpu.ops.pallas_kernels.flash_attention``.

    Differentiable: the forward kernel saves its logsumexp and the
    backward runs the dq and dk/dv kernels, which recompute the
    probabilities tile by tile; the (S, S) matrix never exists.
    ``window`` restricts each query to the last ``window`` positions
    (``window < 1`` raises; ``window >= S`` is full causal).

    ``block_q``, ``block_k``, ``bwd_block_q`` and ``bwd_block_k`` are
    validated as the JAX package validates them (a sequence longer than
    1024 with no block divisor of at least 8 raises), but they do not
    set the CUDA tiles: the kernels choose their own (for 16-bit inputs
    128 queries x 128 keys forward and dq, 128 keys x 64 queries dk/dv;
    32 x 32 for f32) and mask a sequence the tile does not divide.
    """
    B, S, H, D = q.shape
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= S:
            window = None

    def _fit_block(requested):
        b = min(requested, S)
        if S % b == 0:
            return b
        b = next(d for d in range(b, 0, -1) if S % d == 0)
        if b < 8:
            if S > 1024:
                raise ValueError(
                    f"flash_attention: seq len {S} has no block "
                    f"divisor in [8, {min(requested, S)}] (S is "
                    f"prime-ish); pad the sequence to a multiple of "
                    f"128 or use dense_causal_attention")
            b = S
        return b

    for b in (block_q, block_k, bwd_block_q, bwd_block_k):
        if b is not None:
            _fit_block(b)

    def fold(t):
        return t.transpose(1, 2).reshape(B * H, S, D).contiguous()

    out = _Flash.apply(fold(q), fold(k), fold(v), window)
    return out.reshape(B, H, S, D).transpose(1, 2)
