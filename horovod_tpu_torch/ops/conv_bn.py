"""Fused 1x1 convolution + BatchNorm statistics: two hand-written Hopper
kernels, their plain PyTorch versions, and the differentiable
``conv1x1_bn``.

Port of ``horovod_tpu/ops/pallas_conv_bn.py``.  A 1x1 convolution over
an NHWC activation is the product ``(B*H*W, Cin) @ (Cin, Cout)``; the op
absorbs the BatchNorm work around it:

* ``y = xh @ w`` with f32 accumulation, ``y`` in ``x``'s dtype;
* prologue: with ``fold=(a, b)`` the upstream BN's normalize and ReLU,
  ``xh = bf16(relu(x * a + b))``, else ``xh = x``;
* epilogue: ``s1 = sum_rows y`` and ``s2 = sum_rows y*y`` from the f32
  ``y``, the downstream BN's batch statistics;
* backward: ``dx``, ``dw`` and, with a fold, ``da`` and ``db`` in one
  call, with the combined cotangent ``ytot = bf16(dy + ds1 + 2*y*ds2)``.

On the card the forward is B9 (replacing ``_fwd_kernel`` / ``_fwd_call``)
and the backward B10 (replacing ``_bwd_kernel`` / ``_bwd_call``).  Which
kernels a call reaches is a fixed rule on dtype and shape
(:func:`route`, a copy of ``sm90_route`` in ``ops/csrc/conv_bn.cu``):

* bf16 with K and N multiples of 64 (every fused convolution of a
  ResNet-50 step): ``ops/csrc/conv_bn_sm90.cu``, ``conv_bn_fwd_sm90_kernel``
  forward, ``conv_bn_dx_sm90_kernel`` and ``conv_bn_dw_sm90_kernel``
  backward (wgmma, a TMA ring, the fold and ``ytot`` formed in registers);
* everything else (f32, bf16 of other widths): the WMMA kernels
  ``conv_bn_fwd_kernel``, ``conv_bn_dx_kernel`` and ``conv_bn_dw_kernel``
  of ``ops/csrc/conv_bn.cu``.

Both end in a fixed-order column sum in ``colsum_kernel``'s order (the
sm90 route's ``colsum4_kernel`` takes four columns to a thread): 2
launches forward, 3 backward.  The rule is never a reaction to a
failure: a failed build or launch, or a misaligned tensor on the sm90
route, raises.

Dispatch mirrors the JAX function: ``use_kernel=False``, or a shape
:func:`supported_m` refuses, takes :func:`reference` under autograd (the
reference's own semantics, counted in :data:`plain_calls`).  Otherwise
the op is :class:`_Conv1x1BN`: a CPU tensor runs the plain versions
(:func:`reference`, :func:`plain_bwd`), a CUDA tensor the kernels, and a
failure to build or launch raises.  Each kernel wrapper counts its calls
in :data:`launches` and the route they took in :data:`route_launches`.
"""

import ctypes
import math
import threading

import torch

from . import _build

#: dtype codes of ops/csrc/conv_bn.cu
_CODES = {torch.float32: 0, torch.bfloat16: 2}

#: kernel wrapper calls, since the last reset_launches(); one forward
#: call makes 2 CUDA launches, one backward call 3 (ops/csrc/conv_bn.cu)
launches = {"conv1x1_bn_fwd": 0, "conv1x1_bn_bwd": 0}
#: the same calls by the route they took (:func:`route`)
route_launches = {f"{name}_{r}": 0 for name in launches
                  for r in ("sm90", "wmma")}
#: calls of conv1x1_bn that took the plain path by dispatch
plain_calls = {"conv1x1_bn": 0}
_count_lock = threading.Lock()


def reset_launches():
    with _count_lock:
        for d in (launches, route_launches, plain_calls):
            for k in d:
                d[k] = 0


def _count(table, name):
    with _count_lock:
        table[name] += 1


# ---------------------------------------------------------------------------
# dispatch rule (copied from the JAX module, which it must equal)

# VMEM block budget of the TPU kernels for picking the M-block size
_VMEM_BUDGET = 40 * 1024 * 1024


def _pick_bm(m, k, n, backward=False):
    """Largest M-block <= 1040 that divides ``m``, is a multiple of 16
    and fits the TPU kernels' VMEM budget; None if there is none."""
    fixed = k * n * 2 + (k * n * 4 if backward else 0)
    per_row = (2 * (k + n)) * 2 if not backward \
        else (2 * (2 * k + 2 * n)) * 2
    budget = _VMEM_BUDGET - fixed
    best = None
    for bm in range(16, 1041, 16):
        if m % bm == 0 and bm * per_row <= budget:
            best = bm
    return best


def supported_m(m, k, n):
    """Whether the fused path takes an (m, k) x (k, n) problem (the JAX
    package's tiling rule, so both packages route the same shapes)."""
    return _pick_bm(m, k, n) is not None \
        and _pick_bm(m, k, n, backward=True) is not None


def bn_fold(s1, s2, count, scale, bias, epsilon=1e-5):
    """Batch-stat fold: per-channel ``(a, b)`` such that ``y*a + b ==
    scale * (y - mean)/sqrt(var+eps) + bias`` (biased variance
    ``s2/count - mean**2``)."""
    mean = s1 / count
    var = s2 / count - mean * mean
    inv = scale * torch.rsqrt(var + epsilon)
    return inv, bias - mean * inv


# ---------------------------------------------------------------------------
# route rule and the sm90 route's tiling (copied from ops/csrc/conv_bn.cu
# sm90_route and ops/csrc/conv_bn_sm90.cu make_plan, which they must equal)

#: conv_bn_sm90.cu: CTAs of one wave, rows of a forward/dx tile, rows of a
#: dw chunk, and the additions on a path through one tile's column-sum
#: tree (a thread's row pair 1, the butterfly over eight lanes 3, the
#: eight consumer warps in order 7)
_SM90_SMS, _SM90_ROWS, _SM90_CHUNK, _SM90_TREE = 132, 128, 64, 11


def route(dtype, k, n):
    """``"sm90"`` (``conv_bn_sm90.cu``) for bf16 with K and N multiples of
    64, else ``"wmma"`` (``conv_bn.cu``'s kernels)."""
    return "sm90" if dtype == torch.bfloat16 and k % 64 == 0 \
        and n % 64 == 0 else "wmma"


def _tile_width(rows, dim):
    """The widest of 256, 128 dividing ``dim`` that gives half a wave of
    tiles beside ``rows`` 128-row tiles, else 64."""
    for w in (256, 128):
        if dim % w == 0 and rows * (dim // w) >= _SM90_SMS // 2:
            return w
    return 64


def sm90_plan(m, k, n):
    """The sm90 route's tiling of an (m, k) x (k, n) problem: 128-row
    tiles ``mt``; the forward's width ``fwd_bn`` over N and CTAs per N
    tile ``fwd_p`` (each walks tiles p, p + fwd_p, ... and writes one
    statistics row); dx's ``dx_bk`` and ``dx_p`` likewise over K; dw's
    128 x ``dw_bn`` tiles ``dw_tiles`` and its M splits of ``rows_per``
    rows (``splits`` of them)."""
    mt = -(-m // _SM90_ROWS)
    fwd_bn = _tile_width(mt, n)
    dx_bk = _tile_width(mt, k)
    dw_bn = 256 if n % 256 == 0 else 128 if n % 128 == 0 else 64
    dw_tiles = -(-k // 128) * (n // dw_bn)
    chunks = -(-m // _SM90_CHUNK)
    splits = max(1, min(chunks, _SM90_SMS // dw_tiles))
    rows_per = -(-chunks // splits) * _SM90_CHUNK
    return {"mt": mt, "fwd_bn": fwd_bn,
            "fwd_p": max(1, min(mt, _SM90_SMS // (n // fwd_bn))),
            "dx_bk": dx_bk,
            "dx_p": max(1, min(mt, _SM90_SMS // (k // dx_bk))),
            "dw_bn": dw_bn, "dw_tiles": dw_tiles, "rows_per": rows_per,
            "splits": -(-m // rows_per)}


def dw_partial_bytes(dtype, m, k, n):
    """Bytes of f32 dw partials one backward call writes (and its reduce
    reads back): splits x K x N x 4 on either route."""
    if route(dtype, k, n) == "sm90":
        return sm90_plan(m, k, n)["splits"] * k * n * 4
    return -(-m // _dw_rows_per(m, k, n)) * k * n * 4


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the card's yardstick)

def _fold_input(x, a, b):
    """``bf16(relu(x*a + b))``: multiply, then add, each rounded."""
    return torch.relu(x.float() * a + b).to(torch.bfloat16)


def reference(x, a, b, w, fold):
    """``(y, s1, s2)``: ``y`` in ``x.dtype``, f32 sums from the f32 ``y``.
    The product runs in f32 (``xh.float() @ w.float()``): bf16 products
    are exact in f32, and a bf16 matmul would round ``y`` before the
    sums are taken.  Differentiable, as the JAX ``_reference`` is."""
    xh = _fold_input(x, a, b) if fold else x
    y = xh.float() @ w.float()
    return y.to(x.dtype), y.sum(dim=0), (y * y).sum(dim=0)


def plain_bwd(x, a, b, w, y, dy, ds1, ds2, fold):
    """``(dx, dw, da, db)`` as the TPU backward kernel computes them
    (``_bwd_xla``): the combined cotangent rounded to bf16, both products
    in f32; ``da``, ``db`` are None without a fold."""
    ytot = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(torch.bfloat16)
    yt = ytot.float()
    if fold:
        pre = x.float() * a + b
        mask = (pre > 0.0).float()
        xh = torch.relu(pre).to(torch.bfloat16)
    else:
        xh = x
    dxh = yt @ w.float().t()
    dw = xh.float().t() @ yt
    if not fold:
        return dxh.to(x.dtype), dw, None, None
    dxm = dxh * mask
    return ((dxm * a).to(x.dtype), dw, (dxm * x.float()).sum(dim=0),
            dxm.sum(dim=0))


# ---------------------------------------------------------------------------
# how far a kernel may lie from the plain version

_U = 2.0 ** -24
_EPS = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
# the kernels' tiling (ops/csrc/conv_bn.cu: kTile, kDepth, kTargetCtas,
# kReduceRows): the depth of their sums enters the bounds below
_TILE, _DEPTH, _TARGET_CTAS, _REDUCE_ROWS = 64, 32, 2112, 8


def _gamma(n):
    return n * _U / (1 - n * _U)


def _colsum_depth(rows):
    """Additions in a row of conv_bn.cu's fixed-order column sum."""
    return -(-rows // _REDUCE_ROWS) + _REDUCE_ROWS


def _depths(dtype, m, k, n):
    """Additions on a path through the kernels' sums on the route of
    ``(dtype, k, n)``: (s1/s2, dw, da/db).  WMMA: a 64-row tile summed in
    order, then the tiles; sm90: one tile's tree, the CTA's tiles in
    order, then the CTAs' rows; dw on both: the rows of a split, then the
    splits."""
    if route(dtype, k, n) == "sm90":
        p = sm90_plan(m, k, n)
        stats = [_SM90_TREE + -(-p["mt"] // rows) + _colsum_depth(rows)
                 for rows in (p["fwd_p"], p["dx_p"])]
        return stats[0], p["rows_per"] + _colsum_depth(p["splits"]), \
            stats[1]
    tile = _TILE + _colsum_depth(-(-m // _TILE))
    rows_per = _dw_rows_per(m, k, n)
    return tile, rows_per + _colsum_depth(-(-m // rows_per)), tile


def _dw_rows_per(m, k, n):
    """conv_bn.cu ``dw_rows_per``: M rows of each dw split."""
    tiles = -(-k // _TILE) * -(-n // _TILE)
    chunks = -(-m // _DEPTH)
    splits = max(1, min(chunks, -(-_TARGET_CTAS // tiles)))
    return -(-chunks // splits) * _DEPTH


def _ratio(name, got, want, bound, out):
    diff = (got.double() - want.double()).abs()
    bound = bound.double()
    elem = float((diff / bound.clamp_min(1e-300)).max())
    l2 = float(diff.norm()) / max(1e-2 * float(want.double().norm()), 1e-300)
    err = float(diff.max())
    out[name] = (err, max(elem, l2) if math.isfinite(err) else math.inf)


def fwd_error(x, a, b, w, fold, got):
    """``{output: (max |got - want|, ratio)}`` of a forward ``got = (y,
    s1, s2)`` against the plain version; the kernel passes where every
    ratio is <= 1.

    ``y`` is held to :func:`reference`'s ``y``, ``s1``/``s2`` to the same
    f32 ``y`` summed in f64.  Bounds, per element: an f32 sum of n terms
    lies within gamma(n) = n*u/(1 - n*u) (u = 2**-24) of the exact sum
    of their magnitudes, the kernel's within 2*gamma(n) (the tensor
    cores' accumulation truncates), so the two products differ by at
    most 3*gamma(K+1)*(|xh| @ |w|); rounding y to its dtype can then
    part them by one ulp of the larger neighbour, up to eps*|want| (eps
    = 2**-7 bf16, 2**-23 f32), and the bound allows two, so that a flip
    at a binade's edge reads 0.5 and not 1; the kernel sums a statistic
    in at most ``depth`` additions on any path (:func:`_depths`, by the
    route: on the WMMA route 64 + ceil(T/8) + 8, T = ceil(M/64) tiles; on
    the sm90 route 11 + ceil(mt/P) + ceil(P/8) + 8, P CTA rows), which
    adds 2*gamma(depth) of the summed magnitudes.  Over the tensor, the
    relative L2 distance over 1e-2."""
    m, k = x.shape
    out = {}
    xh = (_fold_input(x, a, b) if fold else x).float()
    y32 = xh @ w.float()
    e_y = 3 * _gamma(k + 1) * (xh.abs() @ w.float().abs())
    y_plain = y32.to(x.dtype)
    _ratio("y", got[0], y_plain,
           e_y + 2 * _EPS[x.dtype] * y_plain.float().abs(), out)
    depth = _depths(x.dtype, m, k, w.shape[1])[0]
    ya = y32.abs() + e_y
    y64 = y32.double()
    _ratio("s1", got[1], y64.sum(0), e_y.double().sum(0)
           + 2 * _gamma(depth) * ya.double().sum(0), out)
    _ratio("s2", got[2], (y64 * y64).sum(0),
           (2 * ya.double() * e_y.double()).sum(0)
           + 2 * _gamma(depth + 1) * (ya.double() ** 2).sum(0), out)
    return out


def bwd_error(x, a, b, w, y, dy, ds1, ds2, fold, got):
    """``{output: (max |got - want|, ratio)}`` of a backward ``got = (dx,
    dw, da, db)`` against the plain version, as :func:`fwd_error`: ``dx``
    held to :func:`plain_bwd`'s, ``dw``, ``da``, ``db`` to f64 sums of the
    same rounded operands.  Both sides form ``ytot`` and the mask with
    the same correctly rounded operations, so they share them bit for
    bit; the products over N differ by at most 3*gamma(N+1) of their
    magnitudes (and dx by two ulps of its dtype), and the kernel's sums
    over M are at most rows_per + ceil(S/8) + 8 (dw, S splits) or the
    statistics' depth of :func:`fwd_error` (da, db, over dx's tiles)
    additions deep (:func:`_depths`)."""
    m, k = x.shape
    n = w.shape[1]
    out = {}
    yt = (dy.float() + ds1 + 2.0 * y.float() * ds2).to(torch.bfloat16) \
        .float()
    wf = w.float()
    dxh = yt @ wf.t()
    e_dxh = 3 * _gamma(n + 1) * (yt.abs() @ wf.abs().t())
    if fold:
        pre = x.float() * a + b
        mask = (pre > 0.0).float()
        xh = torch.relu(pre).to(torch.bfloat16).float()
        dxm = dxh * mask
        e_dxm = e_dxh * mask
        dx_plain = (dxm * a).to(x.dtype)
        e_dx = e_dxm * a.abs()
    else:
        xh = x.float()
        dx_plain = dxh.to(x.dtype)
        e_dx = e_dxh
    _ratio("dx", got[0], dx_plain,
           e_dx + 2 * _EPS[x.dtype] * dx_plain.float().abs(), out)
    _, depth, depth_ab = _depths(x.dtype, m, k, n)
    _ratio("dw", got[1], xh.double().t() @ yt.double(),
           2 * _gamma(depth) * (xh.abs().t() @ yt.abs()).double(), out)
    if fold:
        depth = depth_ab
        xf = x.float()
        dxa = (dxm.abs() + e_dxm).double()
        _ratio("da", got[2], (dxm.double() * xf.double()).sum(0),
               (e_dxm.double() * xf.abs().double()).sum(0)
               + 2 * _gamma(depth + 1) * (dxa * xf.abs().double()).sum(0),
               out)
        _ratio("db", got[3], dxm.double().sum(0), e_dxm.double().sum(0)
               + 2 * _gamma(depth) * dxa.sum(0), out)
    return out


# ---------------------------------------------------------------------------
# kernels

def _lib():
    lib = _build.load("hvd_conv_bn", ["conv_bn.cu", "conv_bn_sm90.cu"])
    if not getattr(lib, "_hvd_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.hvd_conv_bn_workspace.argtypes = [
            i, ll, i, i, ctypes.POINTER(ll), ctypes.POINTER(ll)]
        lib.hvd_conv_bn_workspace.restype = None
        lib.hvd_conv_bn_plan.argtypes = [i, ll, i, i, ctypes.POINTER(ll)]
        lib.hvd_conv_bn_plan.restype = None
        lib.hvd_conv_bn_fwd.argtypes = [i, i, p, p, p, p, p, p, p,
                                        ll, i, i, i, p]
        lib.hvd_conv_bn_bwd.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                        p, p, p, p, p, ll, i, i, i, p]
        lib.hvd_conv_bn_fwd.restype = ctypes.c_int
        lib.hvd_conv_bn_bwd.restype = ctypes.c_int
        lib._hvd_typed = True
    return lib


def _workspace(lib, dtype, m, k, n):
    fwd, bwd = ctypes.c_longlong(), ctypes.c_longlong()
    lib.hvd_conv_bn_workspace(_CODES[dtype], m, k, n, ctypes.byref(fwd),
                              ctypes.byref(bwd))
    return fwd.value, bwd.value


#: fields of hvd_conv_bn_plan after the route flag: sm90_plan's, then the
#: dynamic shared memory of the forward, dx and dw kernels it launches
PLAN_FIELDS = ("mt", "fwd_bn", "fwd_p", "dx_bk", "dx_p", "dw_bn",
               "dw_tiles", "rows_per", "splits", "fwd_smem", "dx_smem",
               "dw_smem")


def kernel_plan(dtype, m, k, n):
    """The library's own route and plan of a problem: ``("wmma", None)``
    or ``("sm90", {field: value})`` (:data:`PLAN_FIELDS`), for checking
    :func:`route` and :func:`sm90_plan` against it.  Builds the library."""
    out = (ctypes.c_longlong * (1 + len(PLAN_FIELDS)))()
    _lib().hvd_conv_bn_plan(_CODES[dtype], m, k, n, out)
    if not out[0]:
        return "wmma", None
    return "sm90", dict(zip(PLAN_FIELDS, out[1:]))


def _check(name, x, a, b, w, mn=(), rows=()):
    """Validate one call: ``x`` (M, K), ``w`` (K, N) of x's dtype, ``a``,
    ``b`` K f32 values, ``mn`` (M, N) tensors of x's dtype, ``rows`` N f32
    values, all contiguous on one device.  Returns (device, M, K, N)."""
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"{name}: x (M, K) and w (K, N) do not match: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if w.dtype != x.dtype:
        raise TypeError(f"{name}: w must have x's dtype {x.dtype}, not "
                        f"{w.dtype}")
    for t in (a, b):
        if t.numel() != k or t.dtype != torch.float32:
            raise ValueError(f"{name}: a and b must be {k} f32 values, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in mn:
        if t.shape != (m, n) or t.dtype != x.dtype:
            raise ValueError(f"{name}: y and dy must be {x.dtype} "
                             f"{(m, n)}, got {tuple(t.shape)} {t.dtype}")
    for t in rows:
        if t.numel() != n or t.dtype != torch.float32:
            raise ValueError(f"{name}: ds1 and ds2 must be {n} f32 values")
    device = x.device
    for t in (x, a, b, w, *mn, *rows):
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {device}")
    if device.type == "cuda":
        if x.dtype not in _CODES:
            raise TypeError(f"{name}: the kernel takes f32 or bf16, not "
                            f"{x.dtype}")
        if min(m, k, n) < 1:
            raise ValueError(f"{name}: empty problem {(m, k, n)}")
        if not all(t.is_contiguous() for t in (x, a, b, w, *mn, *rows)):
            raise ValueError(f"{name}: tensors must be contiguous")
        if route(x.dtype, k, n) == "sm90" and any(
                t.data_ptr() % 16 for t in (x, a, b, w, *mn, *rows)):
            raise ValueError(f"{name}: the sm90 route's TMA and vector "
                             f"loads need 16-byte aligned tensors")
    return device, m, k, n


def _run(name, fn, device, dtype, *args):
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    err = fn(index, _CODES[dtype], *args,
             torch.cuda.current_stream(device).cuda_stream)
    m, k, n = args[-4:-1]
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"(M, K, N = {(m, k, n)}, {dtype})")
    _count(launches, name)
    _count(route_launches, f"{name}_{route(dtype, k, n)}")


def conv1x1_bn_fwd(x, a, b, w, fold):
    """B9: ``(y, s1, s2)`` of ``xh @ w`` (see :func:`reference`)."""
    device, m, k, n = _check("conv1x1_bn_fwd", x, a, b, w)
    if device.type == "cpu":
        return reference(x, a, b, w, fold)
    lib = _lib()
    fwd_floats, _ = _workspace(lib, x.dtype, m, k, n)
    y = torch.empty((m, n), dtype=x.dtype, device=device)
    s12 = torch.empty(2 * n, dtype=torch.float32, device=device)
    ws = torch.empty(fwd_floats, dtype=torch.float32, device=device)
    _run("conv1x1_bn_fwd", lib.hvd_conv_bn_fwd, device, x.dtype,
         x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
         y.data_ptr(), s12.data_ptr(), ws.data_ptr(), m, k, n, int(fold))
    return y, s12[:n], s12[n:]


def conv1x1_bn_bwd(x, a, b, w, y, dy, ds1, ds2, fold):
    """B10: ``(dx, dw, da, db)`` (see :func:`plain_bwd`); ``da`` and
    ``db`` are None without a fold."""
    device, m, k, n = _check("conv1x1_bn_bwd", x, a, b, w, (y, dy),
                             (ds1, ds2))
    if device.type == "cpu":
        return plain_bwd(x, a, b, w, y, dy, ds1, ds2, fold)
    lib = _lib()
    _, bwd_floats = _workspace(lib, x.dtype, m, k, n)
    dx = torch.empty_like(x)
    dw = torch.empty((k, n), dtype=torch.float32, device=device)
    dab = torch.empty(2 * k, dtype=torch.float32, device=device)
    ytot = torch.empty((m, n), dtype=torch.bfloat16, device=device)
    ws = torch.empty(bwd_floats, dtype=torch.float32, device=device)
    _run("conv1x1_bn_bwd", lib.hvd_conv_bn_bwd, device, x.dtype,
         x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
         y.data_ptr(), dy.data_ptr(), ds1.data_ptr(), ds2.data_ptr(),
         dx.data_ptr(), dw.data_ptr(), dab.data_ptr(), ytot.data_ptr(),
         ws.data_ptr(), m, k, n, int(fold))
    if not fold:
        return dx, dw, None, None
    return dx, dw, dab[:k], dab[k:]


# ---------------------------------------------------------------------------
# the differentiable op

class _Conv1x1BN(torch.autograd.Function):
    """Forward B9, backward B10 (the ``jax.custom_vjp`` of the JAX
    module).  ``w`` is the f32 master weight: it is cast to ``x``'s dtype
    here, so its gradient is B10's f32 ``dw`` unrounded, as JAX hands the
    custom VJP's f32 ``dw`` through ``w.astype(bf16)``; autograd through
    ``w.to(bf16)`` would round it to bf16."""

    @staticmethod
    def forward(ctx, x, a, b, w, fold):
        wc = w.to(x.dtype).contiguous()
        y, s1, s2 = conv1x1_bn_fwd(x, a, b, wc, fold)
        ctx.save_for_backward(x, a, b, wc, y)
        ctx.fold = fold
        ctx.set_materialize_grads(False)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, a, b, w, y = ctx.saved_tensors
        n = w.shape[1]
        # a cotangent autograd leaves out is zero (in eval mode the
        # folded BN ignores the statistics)
        dy = torch.zeros_like(y) if dy is None else dy.contiguous()
        zeros = None
        if ds1 is None or ds2 is None:
            zeros = torch.zeros(n, dtype=torch.float32, device=y.device)
        ds1 = zeros if ds1 is None else ds1.contiguous()
        ds2 = zeros if ds2 is None else ds2.contiguous()
        dx, dw, da, db = conv1x1_bn_bwd(x, a, b, w, y, dy, ds1, ds2,
                                        ctx.fold)
        if da is None:
            da, db = torch.zeros_like(a), torch.zeros_like(b)
        return dx, da, db, dw, None


def conv1x1_bn(x, w, fold=None, *, use_kernel=None):
    """Fused ``y = relu(x*a + b) @ w`` (or plain ``x @ w``) returning
    ``(y, colsum(y), colsum(y*y))``, the contract of the JAX
    ``conv1x1_bn``.

    Args:
      x: ``(M, K)`` activations, contiguous (an NHWC view of a
        channels_last tensor is one).
      w: ``(K, N)`` weight, usually the f32 master parameter; it is cast
        to ``x``'s dtype for the product and its gradient stays f32.
      fold: optional ``(a, b)`` per-channel f32 affine of K values (any
        shape), the upstream BN's normalize and ReLU folded into the
        input read.  ``None`` consumes ``x`` as it is.
      use_kernel: False takes the plain path (the JAX ``use_pallas=False``);
        None takes the fused op where :func:`supported_m` allows.
    Returns:
      ``(y, s1, s2)``: ``y`` ``(M, N)`` in ``x.dtype`` and per-channel f32
      sums for the downstream BN.
    """
    m, k = x.shape
    n = w.shape[1]
    do_fold = fold is not None
    if do_fold:
        a, b = fold
        a = a.reshape(k).float()
        b = b.reshape(k).float()
    else:
        a = torch.ones(k, dtype=torch.float32, device=x.device)
        b = torch.zeros(k, dtype=torch.float32, device=x.device)
    if use_kernel is None:
        use_kernel = supported_m(m, k, n)
    if not use_kernel:
        _count(plain_calls, "conv1x1_bn")
        return reference(x, a, b, w.to(x.dtype), do_fold)
    return _Conv1x1BN.apply(x.contiguous(), a.contiguous(), b.contiguous(),
                            w, do_fold)
