"""Gram-Schmidt orthonormalisation and POD.

Counterpart of ``rla4mor_tpu/core/orthonormalize.py`` (``gram_schmidt``,
``pod``).
In the sketched workflow it runs on k x r sketch-space matrices (small), as
classical Gram-Schmidt with one re-orthogonalisation pass (CGS-2).
:func:`masked_append` is the fixed-shape incremental form the padded
reductor (``mor/padded_reductor.py``) and the greedy driver
(``parallel/driver.py``) share.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

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


def pod(U, product: Optional[Product] = None, modes: Optional[int] = None,
        rtol: Optional[float] = 1e-7):
    """POD by the method of snapshots: the eigendecomposition of the Gram
    matrix U^H R U (r, r) gives the R-orthonormal modes U V / sqrt(lambda).
    Returns (modes (n, q), singular values (q,)), descending.

    ``rtol`` keeps the singular values above ``rtol`` times the largest (the
    method's noise floor is about sqrt(eps), hence 1e-7), at most ``modes``
    of them; ``rtol=None`` keeps exactly ``modes``."""
    U = torch.as_tensor(U)
    RU = U if product is None else torch.as_tensor(product.op.apply(U)).to(U)
    G = U.conj().T @ RU
    G = 0.5 * (G + G.conj().T)
    lam, V = torch.linalg.eigh(G)
    lam, V = lam.flip(0), V.flip(1)  # descending
    svals = torch.sqrt(torch.clamp(lam, min=0.0))
    if rtol is None:
        if modes is None:
            raise ValueError("pod: rtol=None needs modes")
        keep = min(modes, svals.shape[0])
    else:
        ref = float(svals[0]) if svals.shape[0] else 1.0
        keep = int((svals > rtol * ref).sum())
        if modes is not None:
            keep = min(keep, modes)
    svals = svals[:keep]
    safe = torch.clamp(svals, min=torch.finfo(svals.dtype).tiny)
    return U @ (V[:, :keep] / safe[None, :]).to(U.dtype), svals


def masked_append(srb: torch.Tensor, ncols: torch.Tensor, su: torch.Tensor,
                  columns: Sequence[Tuple[torch.Tensor, torch.Tensor, int]] = (),
                  ok: Optional[torch.Tensor] = None):
    """Masked incremental CGS-2 append to a padded sketched basis.

    ``srb`` (k, r_max) holds ``ncols`` (a 0-d int tensor on the device)
    orthonormal columns, zeros after them. The sketch ``su`` (k,) is
    orthogonalised against them twice, and each ``(stack, col, axis)`` of
    ``columns`` (a stack whose ``axis`` is the basis index, and a new column
    of it) takes the same combination: ``col - stack . coeffs``. Then all
    are scaled by the remaining norm and written at index ``ncols``, which
    advances, where the append is ok: ``ncols < r_max``, ``su`` keeps more
    than 100 eps of its norm (else it is already, numerically, in the basis)
    and that norm is finite, and ``ok`` (an extra 0-d bool) holds. Otherwise
    every tensor is left as it was. Shapes never change and the host never
    reads the counter: the update of the JAX package's padded reductor and
    of its sharded driver. Returns ``(srb, stacks, ncols)``."""
    r_max = srb.shape[1]
    col_mask = (torch.arange(r_max, device=srb.device) < ncols).to(su.dtype)
    nrm0 = torch.linalg.vector_norm(su)  # raw sketch scale, before the passes
    cols = [col for _, col, _ in columns]
    for _ in range(2):  # one re-orthogonalisation pass
        coeffs = (srb.conj().T @ su) * col_mask
        su = su - srb @ coeffs
        cols = [col - torch.tensordot(stack, coeffs, dims=([axis], [0]))
                for (stack, _, axis), col in zip(columns, cols)]
    nrm_raw = torch.linalg.vector_norm(su)
    nrm = torch.clamp(nrm_raw, min=1e-30)
    real = su.real.dtype if su.is_complex() else su.dtype
    fine = ((ncols < r_max) & (nrm_raw > 100 * torch.finfo(real).eps * nrm0)
            & torch.isfinite(nrm_raw))
    if ok is not None:
        fine = fine & ok
    # the write index saturates at r_max - 1, where nothing is written
    c_write = torch.clamp(ncols, max=r_max - 1).long()

    def put(stack, col, axis):
        index = (slice(None),) * axis + (c_write,)
        new = stack.clone()
        new[index] = torch.where(fine, col / nrm, stack[index])
        return new

    stacks = [put(stack, col, axis) for (stack, _, axis), col in zip(columns, cols)]
    return put(srb, su, 1), stacks, ncols + fine.to(ncols.dtype)
