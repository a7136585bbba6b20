"""Helpers shared across the API surface (the part of
``horovod_tpu/common/util.py`` the port uses)."""

import warnings


def get_average_backwards_compatibility_fun(reduce_ops):
    """Adapter from the deprecated ``average=`` kwarg to ``op=``
    (reference util.py:214-232): passing both is an error, ``average``
    alone warns and maps True/False to Average/Sum, neither defaults
    to Average."""

    def impl(op, average):
        if op is not None:
            if average is not None:
                raise ValueError(
                    "The op parameter supersedes average. Please "
                    "provide only one of them.")
            return op
        if average is not None:
            warnings.warn(
                "Parameter `average` has been replaced with `op` and "
                "will be removed in v1.0", DeprecationWarning)
            return reduce_ops.Average if average else reduce_ops.Sum
        return reduce_ops.Average

    return impl


def reducescatter_grad_factor(op_is_average, size):
    """Scalar the reducescatter backward multiplies the allgathered
    cotangent by, before the linear prescale*postscale the forward
    applied (``horovod_tpu/common/util.py:204``).

    Default: the reference's convention (Sum gradient scaled by the
    world size, Average unscaled), which is size x the true adjoint of
    the Sum forward.  ``HOROVOD_EXACT_ADJOINT_REDUCESCATTER=1`` opts into
    the exact adjoint (Sum unscaled, Average /= size); the two coincide
    at world size 1."""
    from . import env as env_mod

    exact = env_mod.get_bool(env_mod.HOROVOD_EXACT_ADJOINT_REDUCESCATTER)
    if op_is_average:
        return 1.0 / size if exact else 1.0
    return 1.0 if exact else float(size)
