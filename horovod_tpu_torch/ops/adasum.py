"""Adasum reduction (port of ``horovod_tpu/ops/adasum.py``; reference
``horovod/common/ops/adasum/adasum.h:38``).

Gradients are combined pairwise by a projection-weighted sum

    combine(a, b) = (1 - a.b / (2|a|^2)) * a + (1 - a.b / (2|b|^2)) * b

in a recursive pairing over the ranks.  The JAX package computes this in
``jnp`` outside any Pallas kernel, so the port computes it with torch ops
on the rows' device: the stacked rows of rank threads, or the rows an
executor gathered from the other processes.
"""

import torch


def adasum_combine(a, b):
    """Pairwise Adasum combine (adasum.h:344-430, ComputeDotAndNormSqrds
    and ScaledAdd).  The dot product and both squared norms are taken in
    f32; a zero norm gives its side a coefficient of 1; the result is cast
    back to ``a``'s dtype."""
    af = a.float()
    bf = b.float()
    dot = torch.sum(af * bf)
    na = torch.sum(af * af)
    nb = torch.sum(bf * bf)
    one = torch.ones((), dtype=torch.float32, device=af.device)
    acoeff = torch.where(na == 0.0, one,
                         1.0 - dot / (2.0 * torch.where(na == 0.0, one, na)))
    bcoeff = torch.where(nb == 0.0, one,
                         1.0 - dot / (2.0 * torch.where(nb == 0.0, one, nb)))
    return (acoeff * af + bcoeff * bf).to(a.dtype)


def adasum_reduce(stacked):
    """Reduce an ``(R, ...)`` stack of per-rank rows, in rank order, with
    recursive pairwise Adasum (adasum.h:195's recursion): (0, 1), (2, 3),
    ... at each level, an odd tail passed through unchanged, so any R
    works (the reference needs a power of two)."""
    rows = list(stacked.unbind(0))
    while len(rows) > 1:
        nxt = [adasum_combine(rows[i], rows[i + 1])
               for i in range(0, len(rows) - 1, 2)]
        if len(rows) % 2 == 1:
            nxt.append(rows[-1])
        rows = nxt
    return rows[0]
