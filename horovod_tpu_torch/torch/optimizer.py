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
does this on the host in numpy).

``op=Adasum`` runs the same hooks: the engine combines the fused
buckets with Adasum (``ops/adasum.py``).  A sparse gradient (an
``nn.Embedding(sparse=True)``) goes through ``sparse_allreduce_async``
(its indices and values allgathered), or densified first with
``sparse_as_dense=True``.

``sharded=True`` is ZeRO-grade weight-update sharding
(:class:`_ShardedDistributedOptimizer`).
"""

import inspect
import warnings
from contextlib import contextmanager

import torch

from ..common import basics
from ..common import env as env_mod
from ..common.process_sets import global_process_set
from ..core.sharded import ShardedUpdater, ShardPlan, compression_wire
from ..ops import api
from ..ops import cuda_kernels
from ..ops import quantize_kernels
from ..ops.api import Average, ReduceOp, Sum
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
                   sparse_as_dense=False, process_set=global_process_set):
        self._compression = compression
        # the int8/int4 compressors are markers: the collective quantizes
        # the fused buffer, and this optimizer owns the error-feedback
        # residuals (one optimizer, and so one set, per rank)
        self._wire_dtype = getattr(compression, "wire", None)
        self._residuals = {}
        # a step quarantine (core/integrity.py) resets these residuals
        # too: the in-place rollback never reaches the elastic reset
        # (optimizer.py:44-47 of the JAX package)
        from ..core.integrity import register_wire_state
        register_wire_state(self)
        self.op = op
        self.gradient_predivide_factor = gradient_predivide_factor
        self.sparse_as_dense = sparse_as_dense
        self.process_set = process_set
        self._sparse_scale_warned = False
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

        # an elastic job may grow past one process later, so its hooks
        # go in at any size (reference optimizer.py: size() > 1 or
        # HOROVOD_ELASTIC)
        if basics.size() > 1 or basics.engine().config.elastic:
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
        if p.grad is None or basics.size() <= 1:
            # one process reduces nothing (an elastic round of one)
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
        self._allreduce_delay[p] -= 1
        if self._allreduce_delay[p] == 0:
            gi = self._group_of.get(id(p))
            try:
                if gi is not None and p.grad.is_sparse and \
                        not self.sparse_as_dense:
                    # a sparse gradient cannot join a dense fused group:
                    # the parameter leaves its group for good, so the
                    # dense members keep fusing, and goes through the
                    # sparse path on its own
                    group = self._groups[gi]
                    group[:] = [q for q in group if id(q) != id(p)]
                    del self._group_of[id(p)]
                    if group and \
                            len(self._group_pending[gi]) == len(group):
                        self._grouped_allreduce_async(gi)
                    gi = None
                if gi is None:
                    self._handles[p] = self._allreduce_grad_async(p)
                else:
                    self._group_pending[gi].add(p)
                    if len(self._group_pending[gi]) == \
                            len(self._groups[gi]):
                        self._grouped_allreduce_async(gi)
            except BaseException:
                self._drop_handles()
                raise

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

    def _prepare_grad(self, p):
        """The gradient the collective takes: ``p.grad``, or its dense
        copy under ``sparse_as_dense``."""
        grad = p.grad
        if grad.is_sparse and self.sparse_as_dense:
            grad = grad.to_dense()
        return grad

    def _sparse_allreduce_async(self, p, grad):
        """A sparse gradient's allgather of indices and values (JAX
        optimizer.py:194-210), uncompressed and unscaled."""
        if not self._sparse_scale_warned and (
                self._compression is not Compression.none
                or self.gradient_predivide_factor != 1.0):
            warnings.warn(
                "sparse gradients bypass compression and "
                "gradient_predivide_factor: the sparse allreduce moves "
                "exact index/value pairs uncompressed and averages "
                "without the pre/postscale split", stacklevel=3)
            self._sparse_scale_warned = True
        from .mpi_ops import sparse_allreduce_async
        handle = sparse_allreduce_async(
            grad, name=self._parameter_names.get(p), op=self.op,
            process_set=self.process_set)
        return handle, ("sparse",)

    def _allreduce_grad_async(self, p):
        grad = self._prepare_grad(p)
        if grad.is_sparse:
            return self._sparse_allreduce_async(p, grad)
        prescale, postscale = self._scale_factors()
        name = self._parameter_names.get(p)
        wire = self._wire_for(grad)
        if wire is not None:
            x = self._ef_inject(p, grad, wire)
            if x is not grad:
                with torch.no_grad():
                    grad.copy_(x)
        if wire is not None or self._compression is Compression.none:
            # in place: the unpack writes the result into the gradient
            handle = api.allreduce_async_(
                grad, name=name, op=self.op, prescale_factor=prescale,
                postscale_factor=postscale, process_set=self.process_set,
                wire_dtype=wire)
            return handle, None
        compressed, ctx = self._compression.compress(grad)
        handle = api.allreduce_async(
            compressed, name=name, op=self.op, prescale_factor=prescale,
            postscale_factor=postscale, process_set=self.process_set)
        return handle, ctx

    def _grouped_allreduce_async(self, gi):
        group = self._groups[gi]
        tensors, ctxs = [], []
        wire = None
        for p in group:
            t, c = self._compression.compress(self._prepare_grad(p))
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
        try:
            self._synchronize()
        except BaseException:
            self._drop_handles()
            raise
        self._synchronized = True

    def _drop_handles(self):
        """Forget every in-flight allreduce after one failed (a peer died,
        or the elastic round moved on): the elastic loop restores and
        steps again, and a stale handle would refuse its ``zero_grad``."""
        self._handles.clear()
        for pending in self._group_pending.values():
            pending.clear()
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = self.backward_passes_per_step

    def _synchronize(self):
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
            try:
                group_results = {}
                for p, (handle, ctx) in list(self._handles.items()):
                    if ctx == ("sparse",):
                        with torch.no_grad():
                            p.grad = handle()   # the callable completes it
                        self._allreduce_delay[p] = \
                            self.backward_passes_per_step
                        continue
                    if isinstance(ctx, tuple) and ctx and \
                            ctx[0] == "group":
                        _, gi, comp_ctx = ctx
                        if gi not in group_results:
                            group_results[gi] = api.synchronize(handle)
                        idx = [id(q) for q in
                               self._groups[gi]].index(id(p))
                        out = self._compression.decompress(
                            group_results[gi][idx], comp_ctx)
                    else:
                        out = self._compression.decompress(
                            api.synchronize(handle), ctx)
                    if p.grad.is_sparse:
                        # sparse_as_dense: the dense result replaces it
                        p.grad = out.view_as(p)
                    elif out is not p.grad:
                        with torch.no_grad():
                            p.grad.copy_(out.view_as(p.grad))
                    self._allreduce_delay[p] = \
                        self.backward_passes_per_step
            except BaseException:
                # a failed collective (an integrity verdict, a dead peer)
                # leaves no handle behind: the others are waited for, so
                # none writes into a gradient after the elastic loop has
                # restored the commit, and the replay starts clean
                for handle, ctx in self._handles.values():
                    if ctx != ("sparse",):
                        try:
                            api.synchronize(handle)
                        except Exception:  # noqa: BLE001 — same failure
                            pass
                self._handles.clear()
                raise
            self._handles.clear()

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


class _ShardedDistributedOptimizer(torch.optim.Optimizer):
    """ZeRO-grade weight-update sharding (JAX ``torch/optimizer.py:394``;
    arXiv:1909.09756): in ``step()`` the gradients go out as a grouped
    REDUCESCATTER of flat buckets, a shadow instance of the wrapped
    optimizer's class updates only this rank's 1/dp shard of the
    parameters and optimizer state (one flat shard tensor per bucket on
    the device; element-wise optimizers such as SGD, Adam and AdamW update
    a flat buffer as they would each tensor), and the updated parameters
    ALLGATHER back over the same wire with their own error-feedback state
    (``core/sharded.ShardedUpdater``).  The optimizer state per rank is
    the dense one over dp: ``self._updater.state_bytes`` holds both.

    Grafted onto a dynamic subclass of the wrapped optimizer's class like
    the dense wrapper, but the outer instance's per-parameter state stays
    empty (the memory saved): ``param_groups`` keeps the model's
    parameters, so LR schedulers and ``zero_grad`` work unchanged, and the
    group hyperparameters are mirrored into the shadow's groups at every
    step.  On the card every pack, unpack and cast of the step is a
    launch of the scale/cast kernel (B1) and the int8/int4 wires encode
    and decode with the codec kernels (B2-B5)."""

    def _shard_init(self, named_parameters=None,
                    compression=Compression.none, op=Average,
                    gradient_predivide_factor=1.0,
                    process_set=global_process_set):
        if op not in (Average, Sum):
            raise ValueError(
                "sharded=True supports op=Average or Sum (the "
                "reducescatter wire has no adasum combine)")
        self._compression = compression
        self._wire_dtype = compression_wire(compression)
        self.op = op
        self.gradient_predivide_factor = gradient_predivide_factor
        self.process_set = process_set
        self._parameter_names = {}
        if named_parameters is not None:
            self._parameter_names = {v: k for k, v in named_parameters}
        self._updater = None
        self._shadow = None
        self._shadow_params = []      # [(bucket, flat shard tensor)]
        self._by_name = {}
        self._synchronized = False
        self._should_synchronize = True

    # -- plan / build --------------------------------------------------------

    def _param_name(self, gi, pi, p):
        return self._parameter_names.get(p, f"shardopt.noname.{gi}.{pi}")

    def _specs(self):
        specs, by_name = [], {}
        for gi, group in enumerate(self.param_groups):
            for pi, p in enumerate(group["params"]):
                if not p.requires_grad:
                    continue
                name = self._param_name(gi, pi, p)
                specs.append((name, tuple(p.shape), api.dtype_name(p.dtype),
                              gi))
                by_name[name] = p
        return specs, by_name

    def _dp(self):
        return len(basics.engine().process_set_ranks(
            self.process_set.process_set_id or 0))

    def _build(self, layout=None):
        eng = basics.engine()
        layout = layout if layout is not None else eng.config.shard_layout
        specs, self._by_name = self._specs()
        plan = ShardPlan(specs, self._dp(),
                         eng.config.fusion_threshold_bytes, layout=layout)
        self._updater = ShardedUpdater(
            plan, process_set=self.process_set, op=self.op,
            grad_wire=self._wire_dtype, param_wire=self._wire_dtype,
            name="shardopt")
        pos = self._updater.my_pos()
        # the shadow optimizer: one flat shard tensor per bucket, in the
        # group of its bucket, so each inherits its group's options
        self._shadow_params = []
        groups = [dict(g, params=[]) for g in self.param_groups]
        for b in plan.buckets:
            s, e = b.shard_slice(pos)
            full = plan.pack(b, self._by_name)
            t = torch.nn.Parameter(full[s:e].clone(), requires_grad=True)
            self._shadow_params.append((b, t))
            groups[b.group]["params"].append(t)
        # constructor-required args (SGD's lr) from the wrapped instance's
        # defaults, filtered to what the constructor takes (AdamW's
        # defaults carry keys its __init__ rejects)
        sig = inspect.signature(self._base_cls.__init__)
        ctor = {k: v for k, v in self.defaults.items()
                if k in sig.parameters}
        self._shadow = self._base_cls(
            [g for g in groups if g["params"]], **ctor)
        self._record_state_bytes()

    def _mirror_hyperparams(self):
        """Outer group options (LR schedules mutate them) -> shadow."""
        shadow_groups = {id(t): sg for sg in self._shadow.param_groups
                         for t in sg["params"]}
        for b, t in self._shadow_params:
            sg = shadow_groups[id(t)]
            for k, v in self.param_groups[b.group].items():
                if k != "params":
                    sg[k] = v

    def _record_state_bytes(self):
        shard_bytes = sum(v.numel() * v.element_size()
                          for st in self._shadow.state.values()
                          for v in st.values() if torch.is_tensor(v))
        if shard_bytes == 0:
            # before the first step the state is not materialized: the
            # master shards stand in
            shard_bytes = sum(t.numel() * t.element_size()
                              for _, t in self._shadow_params)
        self._updater.record_state_bytes(shard_bytes)

    # -- step ----------------------------------------------------------------

    def _scale_factors(self):
        if self.op == Average and self.gradient_predivide_factor != 1.0:
            return (1.0 / self.gradient_predivide_factor,
                    self.gradient_predivide_factor)
        return 1.0, 1.0

    def _maybe_reshard(self):
        """The autotuner's shard-layout dimension flips
        ``config.shard_layout`` between steps (optimizer.py:530-553 of
        the JAX package).  The flip is coordinated by a one-element MIN
        vote, so every rank re-shards in the same step or none does, and
        the re-shard is deterministic: the full state gathered exactly,
        re-sliced under the new plan, the error-feedback residuals
        dropped."""
        eng = basics.engine()
        if eng.autotuner is None:
            return
        want = getattr(eng.config, "shard_layout",
                       self._updater.plan.layout)
        flag = 1.0 if want != self._updater.plan.layout else 0.0
        out = api.allreduce(
            torch.tensor([flag], dtype=torch.float32, device=eng.device),
            op=ReduceOp.MIN, name="shardopt.reshard",
            process_set=self.process_set)
        if float(out[0]) >= 0.5:
            state = self._gather_full_state()
            self._build(layout=want)
            self._load_full_state(state)
            self._updater.reset_wire_state()

    def _grads(self):
        grads = {}
        for n, p in self._by_name.items():
            if p.grad is not None:
                if p.grad.is_sparse:
                    raise ValueError(
                        "sharded=True does not support sparse gradients "
                        "(the shard layout is dense flat buckets); use "
                        "the dense DistributedOptimizer")
                grads[n] = p.grad
        return grads

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self._updater is None:
            self._build()
        else:
            self._maybe_reshard()
        if self._dp() <= 1:
            # a single rank: the dense update is the sharded update
            self._dense_single_rank_step()
        else:
            self._sharded_step()
        self._record_state_bytes()
        self._opt_called = True
        base = self.__dict__.get("_lr_sched_base_opt")
        if base is not None:
            base._opt_called = True
        return loss

    def _sharded_step(self):
        self._mirror_hyperparams()
        plan = self._updater.plan
        prescale, postscale = self._scale_factors()
        grads = self._grads()
        shard_grads = self._updater.reduce_grads(
            [plan.pack(b, grads, factor=prescale) for b in plan.buckets])
        for (_b, t), g in zip(self._shadow_params, shard_grads):
            t.grad = cuda_kernels.fused_scale_cast(g, postscale) \
                if postscale != 1.0 else g
        self._shadow_update(set(self._by_name) - set(grads))
        full = self._updater.gather_params(
            [t.detach() for _, t in self._shadow_params])
        with torch.no_grad():
            for (b, _t), buf in zip(self._shadow_params, full):
                plan.unpack(b, buf, out=self._param_data(b))

    def _dense_single_rank_step(self):
        # world size 1: the shadow machinery runs locally, so the code
        # path (and the state layout) is the sharded one; the shards are
        # the whole buckets
        self._mirror_hyperparams()
        plan = self._updater.plan
        grads = self._grads()
        for b, t in self._shadow_params:
            t.grad = plan.pack(b, grads)
        self._shadow_update(set(self._by_name) - set(grads))
        with torch.no_grad():
            for b, t in self._shadow_params:
                plan.unpack(b, t.detach(), out=self._param_data(b))

    def _shadow_update(self, missing):
        """The shadow optimizer's step.  The dense wrapper skips params
        whose grad is None (torch optimizers never touch them); the flat
        shard update cannot skip elementwise, so those members' param
        and state slices are restored after it: weight decay and moment
        decay must not move a never-trained param."""
        snap = self._snapshot_missing(missing) if missing else None
        self._shadow.step()
        if snap is not None:
            self._restore_missing(snap)

    def _param_data(self, bucket):
        return {key: self._by_name[key].data for key, _s, _sh
                in bucket.members}

    def _missing_slices(self, bucket, missing, pos):
        """Intersections of this rank's shard with the flat ranges of
        ``missing`` members, as local [lo, hi) pairs."""
        s, e = bucket.shard_slice(pos)
        out, off = [], 0
        for key, size, _shape in bucket.members:
            if key in missing:
                lo, hi = max(off, s), min(off + size, e)
                if lo < hi:
                    out.append((lo - s, hi - s))
            off += size
        return out

    def _snapshot_missing(self, missing):
        pos = self._updater.my_pos()
        snap = []
        for b, t in self._shadow_params:
            ranges = self._missing_slices(b, missing, pos)
            if not ranges:
                snap.append(None)
                continue
            state = {k: v.detach().clone()
                     for k, v in self._shadow.state.get(t, {}).items()
                     if torch.is_tensor(v) and v.numel() > 1}
            snap.append((ranges, t.detach().clone(), state))
        return snap

    def _restore_missing(self, snap):
        with torch.no_grad():
            for (_b, t), entry in zip(self._shadow_params, snap):
                if entry is None:
                    continue
                ranges, old_t, old_state = entry
                st = self._shadow.state.get(t, {})
                for lo, hi in ranges:
                    t.data[lo:hi] = old_t[lo:hi]
                    for k, v in st.items():
                        if not torch.is_tensor(v) or v.numel() <= 1:
                            continue
                        prev = old_state.get(k)
                        if prev is not None:
                            v[lo:hi] = prev[lo:hi]
                        else:
                            # state created this step: the dense
                            # optimizer would not have made it for a
                            # no-grad param; zeros are what a later
                            # lazy init starts from
                            v[lo:hi] = 0

    # -- dense-wrapper API compatibility -------------------------------------

    def synchronize(self):
        """No pending handles in sharded mode: the reducescatter, update
        and allgather all run inside step()."""
        self._synchronized = True

    @contextmanager
    def skip_synchronize(self):
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def set_backward_passes_per_step(self, passes):
        # gradients accumulate in p.grad between step() calls; there are
        # no per-parameter hooks to re-arm in sharded mode
        self.backward_passes_per_step = passes

    def reset_wire_state(self):
        """Drop every error-feedback residual (gradient and parameter
        wires): call when the gradient stream is discontinuous."""
        if self._updater is not None:
            self._updater.reset_wire_state()

    # -- deterministic re-shard (state dicts across world sizes) -------------

    def _gather_full_state(self):
        """Layout-independent full state: per-parameter master values and
        optimizer-state tensors, gathered exactly from the shards
        (``ShardedUpdater.gather_full``).  The unit is the parameter, so a
        load at any dp or layout re-slices cleanly."""
        plan = self._updater.plan
        shadow = [t for _, t in self._shadow_params]
        masters = self._updater.gather_full([t.detach() for t in shadow])
        states = [self._shadow.state.get(t, {}) for t in shadow]
        state_keys = sorted({k for st in states for k, v in st.items()
                             if torch.is_tensor(v) and v.numel() > 1})
        full_state = {}
        for k in state_keys:
            shards = []
            for t, st in zip(shadow, states):
                v = st.get(k)
                shards.append(v.detach().float().reshape(-1)
                              if torch.is_tensor(v) and v.numel() > 1
                              else torch.zeros(t.numel(), device=t.device))
            full_state[k] = self._updater.gather_full(shards)
        scalars = {k: v for st in states for k, v in st.items()
                   if not torch.is_tensor(v) or v.numel() <= 1}
        per_param = {}
        for bi, b in enumerate(plan.buckets):
            for n, v in plan.unpack(b, masters[bi]).items():
                per_param.setdefault(n, {})["param"] = v
            for k, bufs in full_state.items():
                for n, v in plan.unpack(b, bufs[bi]).items():
                    per_param[n][k] = v
        return {"per_param": per_param, "scalars": scalars,
                "groups": [{k: v for k, v in g.items() if k != "params"}
                           for g in self.param_groups]}

    def _load_full_state(self, full):
        plan = self._updater.plan
        pos = self._updater.my_pos()
        dev = basics.device()
        per_param = {n: {k: v.to(dev) for k, v in st.items()}
                     for n, st in full["per_param"].items()}
        state_keys = sorted({k for st in per_param.values() for k in st
                             if k != "param"})
        for b, t in self._shadow_params:
            s, e = b.shard_slice(pos)
            master = plan.pack(b, {n: st.get("param")
                                   for n, st in per_param.items()},
                               device=dev)
            with torch.no_grad():
                t.data.copy_(master[s:e])
            st = self._shadow.state.setdefault(t, {})
            for k in state_keys:
                buf = plan.pack(b, {n: v.get(k) for n, v in
                                    per_param.items()},
                                dtype=torch.float32, device=dev)
                st[k] = buf[s:e].to(t.dtype, copy=True)
            for k, v in full.get("scalars", {}).items():
                st[k] = v.clone() if torch.is_tensor(v) else v
        # install the loaded masters into the model's parameters
        fullbufs = self._updater.gather_full(
            [t.detach() for _, t in self._shadow_params])
        with torch.no_grad():
            for (b, _t), buf in zip(self._shadow_params, fullbufs):
                plan.unpack(b, buf, out=self._param_data(b))

    def state_dict(self):
        """FULL (gathered) state, independent of the layout and of dp, so
        a job at another world size restores by re-slicing."""
        if self._updater is None:
            self._build()
        return {"hvd_sharded": True, **self._gather_full_state()}

    def load_state_dict(self, state_dict):
        if not state_dict.get("hvd_sharded"):
            raise ValueError(
                "load_state_dict on a sharded DistributedOptimizer "
                "expects a sharded state dict (state_dict() of the same "
                "wrapper); dense torch state dicts do not carry the flat "
                "shard layout")
        if self._updater is None:
            self._build()
        for g, saved in zip(self.param_groups, state_dict.get("groups", [])):
            g.update(saved)
        self._load_full_state(state_dict)
        self._updater.reset_wire_state()


def _graft(optimizer, mixin):
    """An instance of a dynamic subclass of ``optimizer``'s class with
    ``mixin``'s methods, sharing ``optimizer``'s state (reference
    optimizer.py:516)."""
    methods = {k: v for k, v in mixin.__dict__.items()
               if k not in ("__dict__", "__weakref__")}
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,), methods)
    inst = cls.__new__(cls)
    inst.__dict__.update(optimizer.__dict__)
    # an LRScheduler patches ``step`` onto the instance it wraps; the
    # copied bound method would shadow the distributed step()
    inst.__dict__.pop("step", None)
    # schedulers made on ``optimizer`` before wrapping keep watching it
    inst.__dict__["_lr_sched_base_opt"] = optimizer
    return inst


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=Average,
                         gradient_predivide_factor=1.0, num_groups=0,
                         groups=None, sparse_as_dense=False,
                         process_set=global_process_set, sharded=None):
    """Wrap ``optimizer`` so gradient averaging happens across ranks
    (reference ``horovod/torch/optimizer.py:516``; the JAX package's
    signature and positional order).

    ``sharded=True`` (default: ``HOROVOD_SHARDED_OPTIMIZER``) selects
    ZeRO-grade weight-update sharding: reducescatter the gradients,
    update only this rank's 1/dp shard of the parameters and optimizer
    state, allgather the updated parameters.  ``num_groups`` is the
    deprecated spelling of an integer ``groups``."""
    if gradient_predivide_factor != 1.0 and op != Average:
        raise ValueError(
            "gradient_predivide_factor not supported with op != Average")
    if sharded is None:
        sharded = env_mod.get_bool(env_mod.HOROVOD_SHARDED_OPTIMIZER)
    if sharded:
        if groups is not None or num_groups != 0:
            raise ValueError(
                "groups/num_groups do not apply with sharded=True: the "
                "shard layout IS the grouping (fusion-bucket derived)")
        if sparse_as_dense:
            raise ValueError(
                "sparse_as_dense is not supported with sharded=True")
        inst = _graft(optimizer, _ShardedDistributedOptimizer)
        inst.__dict__["_base_cls"] = optimizer.__class__
        inst._shard_init(
            list(named_parameters) if named_parameters is not None
            else None, compression, op, gradient_predivide_factor,
            process_set)
        inst.backward_passes_per_step = backward_passes_per_step
        return inst
    if num_groups != 0:
        warnings.warn(
            "Parameter `num_groups` has been replaced by `groups` and "
            "will be removed", DeprecationWarning)
        if groups is None:
            groups = num_groups
    inst = _graft(optimizer, _DistributedOptimizer)
    inst._dist_init(named_parameters, compression, backward_passes_per_step,
                    op, gradient_predivide_factor, groups, sparse_as_dense,
                    process_set)
    return inst
