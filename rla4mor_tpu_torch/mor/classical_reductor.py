"""Classical (unsketched) reduced-basis reductor.

Counterpart of ``rla4mor_tpu/mor/classical_reductor.py``: standard Galerkin
RB with the exact affine residual-norm error estimator. Offline, the Riesz
representatives of all residual terms are computed and their Gram matrix
assembled, so the online estimator is

    ||r(u, mu)||_{R^-1}^2 = z(mu, u)^H G z(mu, u),

with z the affine coefficient vector. It is the sketched reductor's
fallback on an empty basis.
"""

from __future__ import annotations

from typing import Optional

import torch

from rla4mor_tpu_torch.core.affine import materialize, project
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt
from rla4mor_tpu_torch.core.parameters import Mu, eval_coefficients
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import StationaryFOM, StationaryROM
from rla4mor_tpu_torch.utils.config import default_dtype
from rla4mor_tpu_torch.utils.logger import get_logger


class GramResidualEstimator:
    """Exact Riesz residual norm from the precomputed Gram matrix.

    Residual terms: columns [A_j U | b_l]; coefficient vector at (mu, u):
    z = [theta_j(mu) u ; -theta_b_l(mu)].
    """

    def __init__(self, gram: torch.Tensor, op_coeffs, rhs_coeffs, r: int):
        self.gram = gram  # ((T*r + Tb), (T*r + Tb))
        self.op_coeffs = tuple(op_coeffs)
        self.rhs_coeffs = tuple(rhs_coeffs)
        self.r = r

    def estimate_error(self, u, mu: Mu) -> torch.Tensor:
        """u (r,) for one Mu, (B, r) for a batched Mu -> () or (B,); for one
        Mu, u may also be (r, b) columns -> (b,)."""
        G = self.gram
        th_op = eval_coefficients(self.op_coeffs, mu, device=G.device).to(G.dtype)
        th_rhs = eval_coefficients(self.rhs_coeffs, mu, device=G.device).to(G.dtype)
        u = torch.as_tensor(u).to(G)
        if th_op.dim() == 1 and u.dim() == 2:  # (r, b) columns at one Mu
            u = u.T
        batch = u.shape[:-1]
        z_op = (th_op[..., :, None] * u[..., None, :]).reshape(*batch, -1)
        z = torch.cat([z_op, -th_rhs.expand(*batch, th_rhs.shape[-1])], dim=-1)
        val = (z.conj()[..., None, :] @ (G @ z[..., None]))[..., 0, 0].real
        return torch.sqrt(torch.clamp(val, min=0.0))


class ClassicalReductor:
    """Galerkin RB with exact residual estimator (the unsketched baseline)."""

    def __init__(
        self,
        fom: StationaryFOM,
        product: Optional[Product] = None,
        orthonormalize: bool = True,
        log_level: int = 20,
    ):
        self.fom = fom
        n = fom.solution_dim
        self.product = product if product is not None else Product.identity(n)
        self.orthonormalize = orthonormalize
        self.logger = get_logger("mor.classical", log_level)
        self.device = fom.device
        self.rb = torch.zeros((n, 0), dtype=default_dtype(fom.device),
                              device=fom.device)
        self.mu_basis: list = []

    @property
    def basis_size(self) -> int:
        return self.rb.shape[1]

    def extend_basis(self, U, mu=None) -> None:
        U = torch.as_tensor(U).to(self.device)
        if U.dim() == 1:
            U = U[:, None]
        if mu is not None:
            self.mu_basis.extend([mu] * U.shape[1])
        rb = torch.cat([self.rb.to(U.dtype), U], dim=1)
        if self.orthonormalize:
            rb = gram_schmidt(rb, product=self.product, offset=self.basis_size)
        self.rb = rb

    def reduce(self, **_ignored) -> StationaryROM:
        """Project the FOM and assemble the exact residual estimator (T r + Tb
        R^-1 solves and their Gram matrix: what sketching avoids)."""
        U = self.rb
        r = self.basis_size
        lhs = project(self.fom.operator, U, U)
        rhs = project(self.fom.rhs, U, None)
        output = None
        if self.fom.output_functional is not None:
            output = project(self.fom.output_functional, None, U)

        # residual columns [A_j U | b_l], Riesz-lifted, Gram matrix
        self.logger.info("assembling residual Gram matrix")
        cols = [torch.as_tensor(term.apply(U)).to(U) for term in self.fom.operator.terms]
        rhs_mat = materialize(self.fom.rhs)
        cols.extend(rhs_mat.stack[t].to(U) for t in range(rhs_mat.stack.shape[0]))
        C = torch.cat(cols, dim=1)
        riesz = torch.as_tensor(self.product.inv.apply(C)).to(C)
        gram = C.conj().T @ riesz
        gram = 0.5 * (gram + gram.conj().T)

        estimator = GramResidualEstimator(gram, self.fom.operator.coefficients,
                                          rhs_mat.coefficients, r)
        return StationaryROM(lhs, rhs, output_functional=output,
                             error_estimator=estimator)

    def reconstruct(self, u_reduced) -> torch.Tensor:
        return self.rb @ torch.as_tensor(u_reduced).to(self.rb)
