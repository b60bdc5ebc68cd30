"""Stationary parametric models: full-order (FOM) and reduced-order (ROM).

Counterpart of ``rla4mor_tpu/models/stationary.py``.

* :class:`StationaryFOM` — affine operator with host-sparse terms; ``solve``
  assembles and factorises on the host (scipy ``splu``) and hands the
  solution to ``device``.
* :class:`StationaryROM` — dense affine stacks on a device. ``solve``,
  ``output`` and ``estimate_error`` take one Mu or a batched Mu: a batch is
  a leading dimension of the assembled ``(B, r, r)`` systems, solved by one
  batched ``torch.linalg.solve`` (Galerkin) or SVD (least squares).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from rla4mor_tpu_torch.core.affine import AffineDense, AffineOp
from rla4mor_tpu_torch.core.linops import HostSparseOp, to_numpy
from rla4mor_tpu_torch.core.parameters import Mu, ParameterSpace, eval_coefficients
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device


class StationaryFOM:
    """A(mu) u = b(mu) with affine A, b; optional output functional s = C u."""

    def __init__(
        self,
        operator: AffineOp,
        rhs: AffineOp,
        output_functional: Optional[AffineDense] = None,
        products: Optional[Dict[str, Product]] = None,
        parameter_space: Optional[ParameterSpace] = None,
        name: str = "fom",
        device=None,
        dtype=None,
    ):
        self.operator = operator
        self.rhs = rhs
        self.output_functional = output_functional
        self.products = products or {}
        self.parameter_space = parameter_space
        self.name = name
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.solution_dim = operator.source_dim

    def assemble_sparse(self, mu: Mu) -> sps.csc_matrix:
        theta = eval_coefficients(self.operator.coefficients, mu,
                                  device="cpu").numpy()
        out = None
        for t, term in enumerate(self.operator.terms):
            if not isinstance(term, HostSparseOp):
                raise TypeError("assemble_sparse needs sparse terms")
            m = theta[t] * term.S
            out = m if out is None else out + m
        return out.tocsc()

    def assemble_rhs(self, mu: Mu) -> np.ndarray:
        """Host float64 right-hand side at one parameter."""
        if isinstance(self.rhs, AffineDense):
            return to_numpy(self.rhs.assemble_vec(mu))
        return self.rhs.assemble_dense(mu)[:, 0]

    def solve_host(self, mu: Mu) -> np.ndarray:
        """Direct sparse solve on the host (float64 numpy)."""
        return spla.splu(self.assemble_sparse(mu)).solve(self.assemble_rhs(mu))

    def solve(self, mu: Mu) -> torch.Tensor:
        """Direct sparse solve on the host, returned on ``device``."""
        return as_tensor(self.solve_host(mu), self.device, self.dtype)

    def solve_many(self, mus) -> torch.Tensor:
        return torch.stack([self.solve(mu) for mu in mus], dim=1)

    def output(self, u, mu: Mu):
        return self.output_functional.apply(u, mu)

    def residual_norm(self, u, mu: Mu, product: Optional[Product] = None) -> torch.Tensor:
        """||A(mu) u - b(mu)|| of u (n,) or of each column of u (n, b): the
        l2 norm, or the ``product`` norm. The residual is formed on the host
        in float64 (the operator's terms are host sparse matrices); the
        norms come back on ``device``."""
        U = to_numpy(u)
        b = self.assemble_rhs(mu)
        r = self.assemble_sparse(mu) @ U - (b[:, None] if U.ndim > 1 else b)
        if product is None:
            return as_tensor(np.linalg.norm(r, axis=0), self.device, self.dtype)
        return product.norm(as_tensor(r, self.device, self.dtype))


class ResidualErrorEstimator:
    """|| lhs(mu) u - rhs(mu) ||_2 — the sketched residual estimator."""

    def __init__(self, lhs: AffineDense, rhs: AffineDense):
        self.lhs = lhs  # (T, k, r)
        self.rhs = rhs  # (Tb, k, 1)

    def estimate_error(self, u, mu: Mu) -> torch.Tensor:
        """u (r,) for one Mu, (B, r) for a batched Mu -> () or (B,); for one
        Mu, u may also be (r, b) columns -> (b,)."""
        A = self.lhs.assemble(mu)
        u = torch.as_tensor(u).to(A)
        b = self.rhs.assemble_vec(mu)
        if u.dim() == A.dim():  # (r, b) columns at one Mu
            return torch.linalg.vector_norm(A @ u - b[:, None], dim=0)
        return torch.linalg.vector_norm((A @ u[..., None])[..., 0] - b, dim=-1)


class StationaryROM:
    """Dense affine reduced model.

    ``ls=False``: Galerkin square solve. ``ls=True``: least-squares
    (minres) solve of a sketched rectangular system by an economic SVD with
    the relative cutoff ``max(ls_rcond, 100 eps) * s_max``."""

    def __init__(
        self,
        lhs: AffineDense,
        rhs: AffineDense,
        output_functional: Optional[AffineDense] = None,
        error_estimator: Optional[ResidualErrorEstimator] = None,
        ls: bool = False,
        ls_rcond: float = 1e-13,
    ):
        self.lhs = lhs
        self.rhs = rhs
        self.output_functional = output_functional
        self.error_estimator = error_estimator
        self.ls = ls
        self.ls_rcond = float(ls_rcond)

    def solve(self, mu: Mu) -> torch.Tensor:
        """Reduced coefficients: (r,) for one Mu, (B, r) for a batch."""
        A = self.lhs.assemble(mu)
        b = self.rhs.assemble_vec(mu)
        if self.ls:
            U, s, Vh = torch.linalg.svd(A, full_matrices=False)
            eps = torch.finfo(s.dtype).eps
            cutoff = max(self.ls_rcond, 100 * eps) * s.amax(dim=-1, keepdim=True)
            s_inv = torch.where(s > cutoff, 1.0 / s, torch.zeros_like(s))
            Ub = (U.conj().transpose(-1, -2) @ b[..., None])[..., 0]
            return (Vh.conj().transpose(-1, -2) @ (s_inv * Ub)[..., None])[..., 0]
        return torch.linalg.solve(A, b)

    def output(self, u, mu: Mu) -> torch.Tensor:
        return self.output_functional.apply(u, mu)

    def estimate_error(self, mu: Mu, u=None) -> torch.Tensor:
        if u is None:
            u = self.solve(mu)
        return self.error_estimator.estimate_error(u, mu)

    def solve_and_estimate_batch(self, mus_batched: Mu):
        u = self.solve(mus_batched)
        return u, self.error_estimator.estimate_error(u, mus_batched)
