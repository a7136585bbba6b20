"""ResNet v1.5 in PyTorch (port of ``horovod_tpu/models/resnet.py``):
the standard model and, with ``fused=True``, the model whose 1x1
convolutions run through the fused conv+BN op (``ops/conv_bn.py``).

Layer for layer the flax model, so that its variables load as they are
(:func:`from_flax_variables`):

* module names follow flax's (``conv_init``, ``bn_init``,
  ``BottleneckBlock_<i>.Conv_<j>`` / ``BatchNorm_<j>``, ``conv_proj``,
  ``norm_proj``, ``head``);
* the forward takes NHWC input like the flax model and keeps activations
  in ``channels_last`` memory inside;
* ``dtype`` mirrors flax's ``dtype=bf16, param_dtype=f32``: parameters
  and batch statistics stay f32, convolutions and normalization run in
  ``dtype``, the head in f32;
* convolutions pad like flax's ``"SAME"``: a stride-2 3x3 conv over an
  even input pads (0, 1), where torch's ``padding=1`` would pad (1, 1);
* BatchNorm updates its running statistics as flax does: momentum 0.9
  on the old value, and the biased batch variance;
* the fused blocks (``FusedBottleneckBlock_<i>``) keep the flax layout
  of ``FusedBottleneckBlock``: raw ``(Cin, Cout)`` parameters ``conv1``,
  ``conv3`` and ``conv_proj``, a 3x3 ``conv2``, and folded BNs ``bn1``,
  ``bn2``, ``bn3``, ``bn_proj``.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_bn import bn_fold, conv1x1_bn


def same_padding(size, kernel, stride):
    """flax/XLA ``"SAME"`` padding (lo, hi) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False)`` on NCHW-shaped,
    channels_last tensors.  ``padding`` is ``"SAME"`` or flax's explicit
    ``((lo, hi), (lo, hi))``."""

    def __init__(self, cin, cout, kernel, stride=1, padding="SAME",
                 dtype=torch.float32):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))

    def forward(self, x):
        if self.padding == "SAME":
            (hl, hh), (wl, wh) = (
                same_padding(x.shape[2], self.kernel, self.stride),
                same_padding(x.shape[3], self.kernel, self.stride))
        else:
            (hl, hh), (wl, wh) = self.padding
        w = self.weight.to(self.dtype, memory_format=torch.channels_last)
        if hl == hh and wl == wh:
            return F.conv2d(x, w, stride=self.stride, padding=(hl, wl))
        return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=self.stride)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the
    channel dimension, f32 parameters and statistics."""

    def __init__(self, channels, momentum=0.9, eps=1e-5,
                 dtype=torch.float32, zero_scale=False):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           unbiased=False)
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
            y = F.batch_norm(x, None, None, self.weight, self.bias,
                             training=True, eps=self.eps)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var,
                             self.weight, self.bias, training=False,
                             eps=self.eps)
        return y.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with projection shortcut."""

    def __init__(self, cin, filters, stride, dtype):
        super().__init__()
        self.Conv_0 = Conv(cin, filters, 1, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype=dtype)
        self.Conv_1 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype=dtype)
        self.Conv_2 = Conv(filters, filters * 4, 1, dtype=dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype=dtype,
                                     zero_scale=True)
        self.conv_proj = self.norm_proj = None
        if cin != filters * 4 or stride != 1:
            self.conv_proj = Conv(cin, filters * 4, 1, stride, dtype=dtype)
            self.norm_proj = BatchNorm(filters * 4, dtype=dtype)

    def forward(self, x):
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(residual))
        return F.relu(residual + y)


class FoldedBN(nn.Module):
    """BatchNorm as a per-channel affine fold ``(a, b)`` (the flax
    ``_FoldedBN``): it takes the per-channel ``(sum, sum of squares)``
    that the producing op computed and returns the affine that the
    consumer applies, ``y*a + b``.  f32 ``weight``/``bias`` and running
    statistics; in training the batch variance is ``s2/count - mean**2``
    and the running statistics move with momentum 0.9; in eval the
    running statistics make the fold."""

    def __init__(self, channels, momentum=0.9, eps=1e-5, zero_scale=False):
        super().__init__()
        self.momentum, self.eps, self.zero_scale = momentum, eps, zero_scale
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, s1, s2, count):
        if not self.training:
            inv = self.weight * torch.rsqrt(self.running_var + self.eps)
            return inv, self.bias - self.running_mean * inv
        with torch.no_grad():
            mean = s1 / count
            var = s2 / count - mean * mean
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return bn_fold(s1, s2, count, self.weight, self.bias, self.eps)


def relu_affine(y, a, b, dtype):
    """``relu(y*a + b)`` in ``dtype``, computed in f32 (the one BN
    normalize of the fused block that is written out, because its
    consumer is the 3x3 convolution)."""
    return torch.relu(y.float() * a + b).to(dtype)


def _rows(x):
    """The (B*H*W, C) rows of an NCHW-shaped channels_last tensor: a view
    when ``x`` is channels_last contiguous."""
    return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])


def _unrows(rows, like_shape):
    """Inverse of :func:`_rows`: (B*H*W, C) -> NCHW-shaped channels_last."""
    bsz, _, h, w = like_shape
    return rows.reshape(bsz, h, w, -1).permute(0, 3, 1, 2)


class FusedBottleneckBlock(nn.Module):
    """The bottleneck block on the fused conv+BN path (the flax
    ``FusedBottleneckBlock``): each non-strided 1x1 convolution is one
    :func:`conv1x1_bn` whose epilogue yields its BN's statistics, and the
    upstream BN's normalize + ReLU rides the next op's input read.  The
    3x3 convolution stays a library convolution, as it stays an XLA
    convolution in the JAX package; the strided projection takes the
    plain path, as it does there."""

    def __init__(self, cin, filters, stride, dtype):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.conv1 = nn.Parameter(torch.empty(cin, filters))
        self.conv2 = Conv(filters, filters, 3, stride, dtype=dtype)
        self.conv3 = nn.Parameter(torch.empty(filters, filters * 4))
        self.bn1 = FoldedBN(filters)
        self.bn2 = FoldedBN(filters)
        self.bn3 = FoldedBN(filters * 4, zero_scale=True)
        self.conv_proj = self.bn_proj = None
        if cin != filters * 4 or stride != 1:
            self.conv_proj = nn.Parameter(torch.empty(cin, filters * 4))
            self.bn_proj = FoldedBN(filters * 4)

    def forward(self, x):
        flat = _rows(x)
        y1, s11, s12 = conv1x1_bn(flat, self.conv1)
        a1, b1 = self.bn1(s11, s12, flat.shape[0])
        x2 = _unrows(relu_affine(y1, a1, b1, self.dtype), x.shape)

        y2 = self.conv2(x2)
        y2f = _rows(y2)
        # the 3x3 output's statistics from the rounded y2, in f32
        y2_32 = y2f.float()
        a2, b2 = self.bn2(y2_32.sum(dim=0), (y2_32 * y2_32).sum(dim=0),
                          y2f.shape[0])
        y3, s31, s32 = conv1x1_bn(y2f, self.conv3, fold=(a2, b2))
        a3, b3 = self.bn3(s31, s32, y3.shape[0])

        if self.conv_proj is not None:
            s = self.stride
            xs = _rows(x[:, :, ::s, ::s])
            yp, sp1, sp2 = conv1x1_bn(xs, self.conv_proj,
                                      use_kernel=False if s != 1 else None)
            ap, bp = self.bn_proj(sp1, sp2, yp.shape[0])
            res = yp.float() * ap + bp
        else:
            res = flat.float()
        out = torch.relu(y3.float() * a3 + b3 + res)
        return _unrows(out.to(self.dtype), y2.shape)


class ResNet(nn.Module):
    """ResNet v1.5.  ``stage_sizes``: blocks per stage.  Input NHWC.
    ``fused=True`` builds :class:`FusedBottleneckBlock` s (named
    ``FusedBottleneckBlock_<i>``, as flax names them)."""

    def __init__(self, stage_sizes, num_classes=1000, num_filters=64,
                 dtype=torch.bfloat16, fused=False):
        super().__init__()
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2,
                              padding=((3, 3), (3, 3)), dtype=dtype)
        self.bn_init = BatchNorm(num_filters, dtype=dtype)
        self.block_names = []
        block = FusedBottleneckBlock if fused else BottleneckBlock
        cin, k = num_filters, 0
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"{block.__name__}_{k}"
                self.add_module(name, block(cin, filters, stride, dtype))
                self.block_names.append(name)
                cin, k = filters * 4, k + 1
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        return self.head(x.float())


def ResNet50(**kwargs):
    return ResNet([3, 4, 6, 3], **kwargs)


def numpy_init(model, seed):
    """A state dict for ``model`` drawn from ``numpy`` with ``seed``,
    with flax's initializers: LeCun-normal kernels, zero biases, unit BN
    scales (zero on each block's last BN), zero/unit running stats.
    The same seed gives the same weights on every rank and device.  The
    fused blocks' raw ``(Cin, Cout)`` kernels have fan-in ``Cin``."""
    rng = np.random.default_rng(seed)
    state = {}
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(mod, FusedBottleneckBlock):
            for name in ("conv1", "conv3", "conv_proj"):
                p = getattr(mod, name)
                if p is not None:
                    state[prefix + name] = rng.standard_normal(
                        tuple(p.shape), dtype=np.float32) / np.float32(
                            math.sqrt(p.shape[0]))
        if isinstance(mod, (Conv, nn.Linear)):
            w = mod.weight
            fan_in = math.prod(w.shape[1:])
            state[prefix + "weight"] = rng.standard_normal(
                tuple(w.shape), dtype=np.float32) / np.float32(
                    math.sqrt(fan_in))
            if isinstance(mod, nn.Linear):
                state[prefix + "bias"] = np.zeros(w.shape[0], np.float32)
        elif isinstance(mod, (BatchNorm, FoldedBN)):
            c = mod.weight.shape[0]
            state[prefix + "weight"] = (np.zeros if mod.zero_scale
                                        else np.ones)(c, np.float32)
            state[prefix + "bias"] = np.zeros(c, np.float32)
            state[prefix + "running_mean"] = np.zeros(c, np.float32)
            state[prefix + "running_var"] = np.ones(c, np.float32)
    return {k: torch.from_numpy(v) for k, v in state.items()}


def from_flax_variables(variables):
    """The port's ``state_dict`` for the flax ``{"params",
    "batch_stats"}`` tree of ``horovod_tpu.models.resnet.ResNet``
    (nested dicts of numpy arrays), standard or fused: conv kernels HWIO
    -> OIHW, the Dense kernel (in, out) -> (out, in), BN scale/bias/
    mean/var -> weight/bias/running_mean/running_var, and the fused
    blocks' raw (Cin, Cout) kernels as they are."""
    state = {}

    def walk(params, stats, prefix):
        for name, sub in params.items():
            key = prefix + name
            if not isinstance(sub, dict):
                state[key] = np.asarray(sub)
            elif "kernel" in sub:
                k = np.asarray(sub["kernel"])
                if k.ndim == 4:
                    state[key + ".weight"] = k.transpose(3, 2, 0, 1)
                else:
                    state[key + ".weight"] = k.T
                    state[key + ".bias"] = np.asarray(sub["bias"])
            elif "scale" in sub:
                st = stats[name]
                state[key + ".weight"] = np.asarray(sub["scale"])
                state[key + ".bias"] = np.asarray(sub["bias"])
                state[key + ".running_mean"] = np.asarray(st["mean"])
                state[key + ".running_var"] = np.asarray(st["var"])
            else:
                walk(sub, stats.get(name, {}), key + ".")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in state.items()}


# unfused -> fused names inside a block (tests/test_conv_bn_fusion.py
# ``_transplant``)
_FUSED_CONVS = {"Conv_0": "conv1", "Conv_2": "conv3",
                "conv_proj": "conv_proj"}
_FUSED_BNS = {"BatchNorm_0": "bn1", "BatchNorm_1": "bn2",
              "BatchNorm_2": "bn3", "norm_proj": "bn_proj"}


def fused_from_unfused(state_dict):
    """The ``ResNet(fused=True)`` state dict holding the same weights as
    a ``fused=False`` state dict: ``BottleneckBlock_<i>`` becomes
    ``FusedBottleneckBlock_<i>``, its 1x1 kernels (Cout, Cin, 1, 1)
    become raw (Cin, Cout) parameters, ``Conv_1`` becomes ``conv2`` and
    the BatchNorms ``bn1``, ``bn2``, ``bn3``, ``bn_proj``; the stem and
    the head keep their names."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        if not parts[0].startswith("BottleneckBlock_"):
            out[key] = value
            continue
        block = "Fused" + parts[0]
        sub, leaf = parts[1], parts[2:]
        if sub in _FUSED_CONVS:
            out[f"{block}.{_FUSED_CONVS[sub]}"] = value[:, :, 0, 0].t() \
                .contiguous()
        elif sub == "Conv_1":
            out[".".join([block, "conv2", *leaf])] = value
        elif sub in _FUSED_BNS:
            out[".".join([block, _FUSED_BNS[sub], *leaf])] = value
        else:
            raise KeyError(f"unmapped {key}")
    return out
