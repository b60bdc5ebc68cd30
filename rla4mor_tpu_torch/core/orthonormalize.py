"""Gram-Schmidt orthonormalisation.

Counterpart of ``gram_schmidt`` in ``rla4mor_tpu/core/orthonormalize.py``.
In the sketched workflow it runs on k x r sketch-space matrices (small), as
classical Gram-Schmidt with one re-orthogonalisation pass (CGS-2).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from rla4mor_tpu_torch.core.products import Product


def gram_schmidt(
    U,
    product: Optional[Product] = None,
    offset: int = 0,
    return_R: bool = False,
    reiterate: bool = True,
    atol: float = 0.0,
):
    """CGS-2 on the columns of U (n, r), w.r.t. ``product`` (l2 if None).

    Columns ``[:offset]`` are taken as orthonormal already (incremental
    mode). A column whose orthogonalised norm is ``<= atol`` (or not finite)
    becomes a zero column with ``R[j, j] = 0``, so R stays (r, r) and the
    caller handles rank deficiency with a pseudo-inverse. R holds both
    passes' coefficients and ``R[:offset, :offset] = I``."""
    Q = torch.as_tensor(U).clone()
    n, r = Q.shape
    R = torch.zeros((r, r), dtype=Q.dtype, device=Q.device)
    R[:offset, :offset] = torch.eye(offset, dtype=Q.dtype, device=Q.device)

    def inner(X, y):
        if product is None:
            return X.conj().T @ y
        return X.conj().T @ torch.as_tensor(product.op.apply(y)).to(y)

    def norm(y):
        return torch.linalg.vector_norm(y) if product is None else product.norm(y)

    for j in range(offset, r):
        v = Q[:, j]
        c = torch.zeros(j, dtype=Q.dtype, device=Q.device)
        for _ in range(2 if reiterate else 1):
            if j > 0:
                cj = inner(Q[:, :j], v)
                v = v - Q[:, :j] @ cj
                c = c + cj
        nv = float(norm(v))
        R[:j, j] = c
        if nv <= atol or not math.isfinite(nv):
            Q[:, j] = 0.0
        else:
            Q[:, j] = v / nv
            R[j, j] = nv
    return (Q, R) if return_R else Q
