"""DistributedOptimizer for torch (port of ``horovod_tpu/torch/optimizer.py``
``_DistributedOptimizer`` and ``DistributedOptimizer``, reference
``horovod/torch/optimizer.py``).

Wrap any ``torch.optim.Optimizer``: per-parameter hooks fire as autograd
accumulates gradients and launch async allreduces at once, overlapping
communication with the rest of backward; ``step()`` synchronizes first.
Gradients stay on their device: with no compression the engine's
unpack kernel writes the averaged gradient straight into ``p.grad``.

``compression=Compression.int8`` (or ``.int4``) sends each gradient over
the block-scaled quantized wire with error feedback: before the submit,
the parameter's residual from the previous step is added into the
gradient, and the new residual ``x - fake_quantize(x)`` is kept, both
computed on the gradient's device by the codec kernels (the JAX package
does this on the host in numpy).  Sharded and Adasum modes are later
slices' work.
"""

import warnings
from contextlib import contextmanager

import torch

from ..common import basics
from ..common.process_sets import global_process_set
from ..ops import api
from ..ops import quantize_kernels
from ..ops.api import Average, Sum
from .compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    """Mixin whose methods are grafted onto a dynamic subclass of the
    wrapped optimizer's class (reference optimizer.py:516): the
    instance keeps the wrapped optimizer's param_groups/state/defaults
    and gains hook-driven allreduce."""

    def _dist_init(self, named_parameters=None,
                   compression=Compression.none,
                   backward_passes_per_step=1, op=Average,
                   gradient_predivide_factor=1.0, groups=None,
                   process_set=global_process_set):
        self._compression = compression
        # the int8/int4 compressors are markers: the collective quantizes
        # the fused buffer, and this optimizer owns the error-feedback
        # residuals (one optimizer, and so one set, per rank)
        self._wire_dtype = getattr(compression, "wire", None)
        self._residuals = {}
        self.op = op
        self.gradient_predivide_factor = gradient_predivide_factor
        self.process_set = process_set
        # autograd runs a CUDA backward's hooks on its own device
        # thread: the hooks submit under the rank that built the
        # optimizer
        self._rank_ctx = basics.context()

        if named_parameters is not None:
            named_parameters = list(named_parameters)
            if any(not isinstance(p, tuple) or len(p) != 2
                   for p in named_parameters):
                raise ValueError(
                    "named_parameters should be a sequence of "
                    "tuples (name, parameter)")
            names = [k for k, _ in named_parameters]
            dups = {n for n in names if names.count(n) > 1}
            if dups:
                raise ValueError(
                    f"named_parameters contains duplicate names "
                    f"{sorted(dups)}; parameters need unique names")
            all_param_ids = {id(v) for group in self.param_groups
                             for v in group["params"]}
            if all_param_ids - {id(v) for _, v in named_parameters}:
                raise ValueError(
                    "named_parameters was specified, but one or more "
                    "model parameters were not named")
            self._parameter_names = {v: k for k, v in named_parameters}
        else:
            self._parameter_names = {
                v: f"allreduce.noname.{i}.{j}"
                for i, group in enumerate(self.param_groups)
                for j, v in enumerate(group["params"])}

        self.backward_passes_per_step = backward_passes_per_step
        self._allreduce_delay = {}
        self._handles = {}
        self._requires_update = set()
        self._synchronized = False
        self._should_synchronize = True

        # group -> list of params for grouped (jointly fused) allreduce
        self._groups = None
        if groups is not None:
            if isinstance(groups, int):
                params_flat = [p for g in self.param_groups
                               for p in g["params"] if p.requires_grad]
                if groups > 0:
                    n = max(1, (len(params_flat) + groups - 1) // groups)
                    self._groups = [params_flat[i:i + n]
                                    for i in range(0, len(params_flat), n)]
            else:
                self._groups = [list(g) for g in groups]
        self._group_of = {}
        for gi, g in enumerate(self._groups or []):
            for p in g:
                self._group_of[id(p)] = gi
        self._group_pending = {gi: set() for gi in
                               range(len(self._groups or []))}

        if basics.size() > 1:
            self._register_hooks()

    # -- hook plumbing ------------------------------------------------------

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue
                self._requires_update.add(p)
                self._allreduce_delay[p] = self.backward_passes_per_step
                p.register_post_accumulate_grad_hook(self._make_hook(p))

    def _make_hook(self, p):
        def hook(param):
            with basics.bound_context(self._rank_ctx):
                self._on_grad_ready(p)
        return hook

    def _on_grad_ready(self, p):
        if p.grad is None:
            return
        if p in self._handles and self._handles[p][0] is not None:
            if self._allreduce_delay[p] <= 0:
                raise AssertionError(
                    "Gradients were computed more than "
                    "backward_passes_per_step times before call to "
                    "step(). Increase backward_passes_per_step to "
                    "accumulate gradients locally.")
        if p.grad.requires_grad:
            raise AssertionError("gradient of a parameter requires grad")
        if p.grad.is_sparse:
            raise ValueError("sparse gradients are not supported by "
                             "horovod_tpu_torch yet")
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            gi = self._group_of.get(id(p))
            if gi is None:
                self._handles[p] = self._allreduce_grad_async(p)
            else:
                self._group_pending[gi].add(p)
                if len(self._group_pending[gi]) == len(self._groups[gi]):
                    self._grouped_allreduce_async(gi)

    # -- collective launches -------------------------------------------------

    def _scale_factors(self):
        """Split the average as prescale=1/gpf, postscale=gpf (the
        engine applies a further 1/size for Average)."""
        if self.op == Average and self.gradient_predivide_factor != 1.0:
            return (1.0 / self.gradient_predivide_factor,
                    self.gradient_predivide_factor)
        return 1.0, 1.0

    def _wire_for(self, grad):
        """The compressor's wire for one gradient: float gradients on
        Sum/Average, the only reductions whose math commutes with the
        quantized decode."""
        if self._wire_dtype is None or not grad.dtype.is_floating_point \
                or self.op not in (Average, Sum):
            return None
        return self._wire_dtype

    def _ef_inject(self, p, grad, wire):
        """Error feedback (EF21) on the gradient's device: ``x = grad +
        residual`` in f32, the new residual ``x - fake_quantize(x)``
        through the wire's encode and decode kernels, and ``x`` returned
        in the gradient's dtype.  It runs on the hook's thread and
        stream, before the submit records the ready event."""
        with torch.no_grad():
            x = grad.float()
            r = self._residuals.get(p)
            if r is not None and r.shape == x.shape:
                x = x + r
            self._residuals[p] = x - quantize_kernels.fake_quantize_wire(
                x, wire)
            return x if grad.dtype == torch.float32 else x.to(grad.dtype)

    def reset_wire_state(self):
        """Drop the error-feedback residuals.  Call when the gradient
        stream is discontinuous (a reshaped parameter, a restored
        optimizer state), so that stale errors are never injected."""
        self._residuals.clear()

    def _allreduce_grad_async(self, p):
        prescale, postscale = self._scale_factors()
        name = self._parameter_names.get(p)
        wire = self._wire_for(p.grad)
        if wire is not None:
            x = self._ef_inject(p, p.grad, wire)
            if x is not p.grad:
                with torch.no_grad():
                    p.grad.copy_(x)
        if wire is not None or self._compression is Compression.none:
            # in place: the unpack writes the result into p.grad
            handle = api.allreduce_async_(
                p.grad, name=name, op=self.op, prescale_factor=prescale,
                postscale_factor=postscale, process_set=self.process_set,
                wire_dtype=wire)
            return handle, None
        compressed, ctx = self._compression.compress(p.grad)
        handle = api.allreduce_async(
            compressed, name=name, op=self.op, prescale_factor=prescale,
            postscale_factor=postscale, process_set=self.process_set)
        return handle, ctx

    def _grouped_allreduce_async(self, gi):
        group = self._groups[gi]
        tensors, ctxs = [], []
        wire = None
        for p in group:
            t, c = self._compression.compress(p.grad)
            w = self._wire_for(t)
            if w is not None:
                t = self._ef_inject(p, t, w)
                wire = w
            tensors.append(t)
            ctxs.append(c)
        prescale, postscale = self._scale_factors()
        handle = api.grouped_allreduce_async(
            tensors, op=self.op, name=f"group.{gi}",
            prescale_factor=prescale, postscale_factor=postscale,
            process_set=self.process_set, wire_dtype=wire)
        for p, c in zip(group, ctxs):
            self._handles[p] = (handle, ("group", gi, c))
        self._group_pending[gi] = set()

    # -- synchronize / step ---------------------------------------------------

    def synchronize(self):
        """Flush every outstanding allreduce and write averaged grads
        back (reference optimizer.py:255-303)."""
        if basics.size() <= 1:
            self._synchronized = True
            return
        with basics.bound_context(self._rank_ctx):
            # params whose hook never fired (unused in forward) or fired
            # fewer than backward_passes_per_step times still get
            # averaged, and their delays reset (optimizer.py:260-266);
            # members of partially ready groups go out one by one
            for p in self._requires_update - set(self._handles):
                if p.grad is not None:
                    self._handles[p] = self._allreduce_grad_async(p)
            for pending in self._group_pending.values():
                pending.clear()
            group_results = {}
            for p, (handle, ctx) in list(self._handles.items()):
                if isinstance(ctx, tuple) and ctx and ctx[0] == "group":
                    _, gi, comp_ctx = ctx
                    if gi not in group_results:
                        group_results[gi] = api.synchronize(handle)
                    idx = [id(q) for q in self._groups[gi]].index(id(p))
                    out = self._compression.decompress(
                        group_results[gi][idx], comp_ctx)
                else:
                    out = self._compression.decompress(
                        api.synchronize(handle), ctx)
                if out is not p.grad:
                    with torch.no_grad():
                        p.grad.copy_(out.view_as(p.grad))
                self._allreduce_delay[p] = self.backward_passes_per_step
            self._handles.clear()
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        """The caller already called synchronize() before step()."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.synchronize() was called before "
                    "optimizer.step(), which can cause gradients to be "
                    "synchronized twice. Wrap optimizer.step() in "
                    "`with optimizer.skip_synchronize():` to avoid the "
                    "redundant synchronization")
            self.synchronize()
        self._synchronized = False
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() "
                "but before optimizer.step() or optimizer.synchronize(). "
                "This is prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)

    def set_backward_passes_per_step(self, passes):
        self.backward_passes_per_step = passes
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = passes


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average,
                         gradient_predivide_factor=1.0, groups=None,
                         process_set=global_process_set):
    """Wrap ``optimizer`` so gradient averaging happens across ranks
    (reference ``horovod/torch/optimizer.py:516``)."""
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average")
    methods = {k: v for k, v in _DistributedOptimizer.__dict__.items()
               if k not in ("__dict__", "__weakref__")}
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,), methods)
    inst = cls.__new__(cls)
    inst.__dict__.update(optimizer.__dict__)
    # an LRScheduler patches ``step`` onto the instance it wraps; the
    # copied bound method would shadow the distributed step()
    inst.__dict__.pop("step", None)
    inst._dist_init(named_parameters, compression, backward_passes_per_step,
                    op, gradient_predivide_factor, groups, process_set)
    return inst
