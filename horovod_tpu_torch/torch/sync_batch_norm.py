"""SyncBatchNorm (port of ``horovod_tpu/torch/sync_batch_norm.py``;
reference ``horovod/torch/sync_batch_norm.py:218``): batch statistics
computed across every rank of the process set through allreduce, so that
small per-rank batches normalize as one global batch.

The forward allreduces ``[sum(x), sum(x^2), count]`` in one collective;
the backward allreduces ``[sum(dy), sum(dy * xmu)]`` in one and rebuilds
``dx`` from the global means.  Each goes through the engine, whose
packing and unpacking of the fusion buffer are the scale/cast kernel's
(B1) on the card.

The backward is a blocking collective inside autograd.  Autograd runs a
CUDA backward on one worker thread per device, so two rank threads of one
process on one card would run one rank's collective while the peer's
waits behind it: each rank thread runs its backward under
``torch.autograd.set_multithreading_enabled(False)`` (as with
``HorovodAlltoall``), which keeps the backward on the thread that called
it.  Either way the backward re-binds the rank that ran the forward
(``basics.bound_context``), as the optimizer's hooks do.
"""

import threading

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from ..common import basics
from ..common.process_sets import global_process_set
from ..ops import api


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, input, weight, bias, eps, process_set, tag):
        dims = [0] + list(range(2, input.dim()))
        count = torch.tensor([float(input.numel() // input.size(1))],
                             device=input.device)
        x_sum = input.sum(dims)
        x_sqsum = (input * input).sum(dims)
        packed = torch.cat([x_sum, x_sqsum, count]).detach()
        summed = api.allreduce(packed, op=api.Sum,
                               name=f"sync_bn_fwd.{tag}",
                               process_set=process_set)
        C = input.size(1)
        n = summed[-1]
        mean = summed[:C] / n
        var = summed[C:2 * C] / n - mean * mean
        invstd = torch.rsqrt(var + eps)

        ctx.save_for_backward(input, weight, mean, invstd, n)
        ctx.process_set = process_set
        ctx.tag = tag
        ctx.rank_ctx = basics.context()

        shape = [1, -1] + [1] * (input.dim() - 2)
        out = (input - mean.view(shape)) * invstd.view(shape)
        if weight is not None:
            out = out * weight.view(shape)
        if bias is not None:
            out = out + bias.view(shape)
        mean_out, var_out = mean.detach(), var.detach()
        ctx.mark_non_differentiable(mean_out, var_out, n)
        return out, mean_out, var_out, n

    @staticmethod
    def backward(ctx, grad_out, _gm, _gv, _gn):
        input, weight, mean, invstd, n = ctx.saved_tensors
        dims = [0] + list(range(2, input.dim()))
        shape = [1, -1] + [1] * (input.dim() - 2)
        C = input.size(1)

        xmu = input - mean.view(shape)
        sum_dy = grad_out.sum(dims)
        sum_dy_xmu = (grad_out * xmu).sum(dims)

        packed = torch.cat([sum_dy, sum_dy_xmu]).detach()
        with basics.bound_context(ctx.rank_ctx):
            summed = api.allreduce(packed, op=api.Sum,
                                   name=f"sync_bn_bwd.{ctx.tag}",
                                   process_set=ctx.process_set)
        mean_dy = (summed[:C] / n).view(shape)
        mean_dy_xmu = (summed[C:] / n).view(shape)

        w = weight.view(shape) if weight is not None else 1.0
        dx = (grad_out - mean_dy
              - xmu * invstd.view(shape) ** 2 * mean_dy_xmu) \
            * invstd.view(shape) * w

        dweight = (grad_out * xmu * invstd.view(shape)).sum(dims) \
            if weight is not None else None
        dbias = grad_out.sum(dims) if ctx.needs_input_grad[2] else None
        return dx, dweight, dbias, None, None, None


_tag_tls = threading.local()


def _next_tag():
    """Per-thread construction counter: every rank (thread or process)
    builds its modules in the same order, so the n-th SyncBatchNorm gets
    the same collective name on every rank; a process-wide counter would
    race between rank threads."""
    n = getattr(_tag_tls, "n", 0) + 1
    _tag_tls.n = n
    return n


class SyncBatchNorm(_BatchNorm):
    """Drop-in for ``torch.nn.BatchNorm*`` under data parallelism.

    As in the JAX package, the one-rank shortcut (plain batch norm) reads
    the job's size, not the process set's."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True,
                 process_set=global_process_set):
        super().__init__(num_features, eps, momentum, affine,
                         track_running_stats)
        self.process_set = process_set
        self._tag = _next_tag()

    def _check_input_dim(self, input):
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D input)")

    def forward(self, input):
        if not self.training or basics.size() == 1:
            return super().forward(input)
        self._check_input_dim(input)

        out, mean, var, n = _SyncBatchNormFn.apply(
            input, self.weight, self.bias, self.eps, self.process_set,
            self._tag)

        if self.track_running_stats:
            if self.momentum is None:
                exp_factor = 1.0 / float(self.num_batches_tracked + 1)
            else:
                exp_factor = self.momentum
            with torch.no_grad():
                self.num_batches_tracked += 1
                unbiased = var * (n / torch.clamp(n - 1.0, min=1.0))
                self.running_mean.mul_(1 - exp_factor).add_(
                    mean, alpha=exp_factor)
                self.running_var.mul_(1 - exp_factor).add_(
                    unbiased, alpha=exp_factor)
        return out
