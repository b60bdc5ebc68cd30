"""Inner products with square-root factors and implicit inverses.

Counterpart of ``rla4mor_tpu/core/products.py``: an SPD ``product`` R, its
implicit inverse R^-1 and a square root Q with Q^H Q = R.
"""

from __future__ import annotations

import scipy.sparse as sps
import torch

from rla4mor_tpu_torch.core.linops import (
    HostLUInverse,
    HostSparseOp,
    IdentityOp,
    LinOp,
    SparseCholeskyOp,
)


class Product:
    """Bundle (R, R^-1, Q) for an SPD inner product R = Q^H Q."""

    def __init__(self, op: LinOp, inv: LinOp, sqrt: LinOp):
        self.op = op
        self.inv = inv
        self.sqrt = sqrt
        self.dim = op.source_dim

    @classmethod
    def identity(cls, dim: int) -> "Product":
        eye = IdentityOp(dim)
        return cls(eye, eye, eye)

    @classmethod
    def from_sparse(cls, S, device=None, dtype=None) -> "Product":
        """SPD scipy sparse matrix: SuperLU inverse + LU->Cholesky sqrt, all
        on the host, returning tensors on ``device``."""
        S = sps.csc_matrix(S)
        return cls(
            HostSparseOp(S, device=device, dtype=dtype),
            HostLUInverse(S, symmetric=True, device=device, dtype=dtype),
            SparseCholeskyOp(S, device=device, dtype=dtype),
        )

    def inner(self, U, V=None) -> torch.Tensor:
        """U^H R V (V defaults to U)."""
        V = U if V is None else V
        RV = torch.as_tensor(self.op.apply(V))
        return torch.as_tensor(U).to(RV).conj().T @ RV

    def norm(self, U) -> torch.Tensor:
        """Column-wise R-norms of U (n, b) -> (b,)."""
        U = torch.as_tensor(U)
        single = U.dim() == 1
        Um = U[:, None] if single else U
        RU = torch.as_tensor(self.op.apply(Um))
        sq = torch.sum(Um.to(RU).conj() * RU, dim=0).real
        out = torch.sqrt(torch.clamp(sq, min=0.0))
        return out[0] if single else out
