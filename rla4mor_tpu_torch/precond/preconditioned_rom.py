"""Preconditioned Galerkin ROM assembly.

Counterpart of ``rla4mor_tpu/precond/preconditioned_rom.py``. The ROM
approximates A(mu)^-1 by P(mu_p) = sum_i y_i P_i (y = mu_p['precond']) and
solves the preconditioned Galerkin system

    U^H R P(y) A(mu) U  u  =  U^H R P(y) b(mu),

with the sketched-residual error estimator || Theta_res P(y) (A(mu) U u -
b(mu)) ||.

Two assembly modes, as in the JAX package:

* **naive**: the product expanded into p*T affine terms with coefficients
  y_i * theta_j (a :class:`StationaryROM`);
* **stable**: factored through R-orthonormal intermediate image bases V
  with span{R^-1 A_j U} (``core/image.py::estimate_image``): the ROM
  operator is the product of two affine factors (sum_i y_i U^H R P_i R V)
  @ (sum_j theta_j V^H A_j U), p + T terms (a :class:`FactoredROM`).

Every ``solve`` / ``estimate_error`` takes one Mu or a batched Mu (a
leading batch dimension on every leaf, ``core.parameters.mu_stack``); a
batch is solved by one batched ``torch.linalg.solve``.
"""

from __future__ import annotations

from typing import Optional

import torch

from rla4mor_tpu_torch.core.affine import AffineDense, materialize, project
from rla4mor_tpu_torch.core.linops import LinOp
from rla4mor_tpu_torch.core.parameters import Mu, ProjectionCoefficient
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import (
    ResidualErrorEstimator,
    StationaryFOM,
    StationaryROM,
)
from rla4mor_tpu_torch.ops.embeddings import Embedding
from rla4mor_tpu_torch.utils.logger import get_logger


def _mv(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A @ u for a vector u (one per matrix of a batch) or columns u."""
    u = u.to(A)
    if u.dim() == A.dim() - 1:
        return (A @ u[..., None])[..., 0]
    return A @ u


class FactoredResidualEstimator:
    """|| L(mu) Rf(mu) u - Lb(mu) Rb(mu) ||_2 with affine factors."""

    def __init__(self, lhs_left: AffineDense, lhs_right: AffineDense,
                 rhs_left: AffineDense, rhs_right: AffineDense):
        self.lhs_left = lhs_left      # (p, k, d1)
        self.lhs_right = lhs_right    # (T, d1, r)
        self.rhs_left = rhs_left      # (p, k, d2)
        self.rhs_right = rhs_right    # (Tb, d2, 1)

    def estimate_error(self, u, mu: Mu) -> torch.Tensor:
        """u (r,) for one Mu, (B, r) for a batched Mu -> () or (B,); for one
        Mu, u may also be (r, b) columns -> (b,)."""
        L = self.lhs_left.assemble(mu)
        u = torch.as_tensor(u)
        r = _mv(L, _mv(self.lhs_right.assemble(mu), u))
        b = _mv(self.rhs_left.assemble(mu), self.rhs_right.assemble_vec(mu))
        if u.dim() == L.dim():  # (r, b) columns at one Mu
            return torch.linalg.vector_norm(r - b[:, None], dim=0)
        return torch.linalg.vector_norm(r - b, dim=-1)


class FactoredROM:
    """ROM whose lhs and rhs are products of two affine factors (stable
    mode)."""

    def __init__(self, lhs_left, lhs_right, rhs_left, rhs_right,
                 output_functional=None, error_estimator=None):
        self.lhs_left = lhs_left      # (p, r, d1), coefficients y_i
        self.lhs_right = lhs_right    # (T, d1, r), coefficients theta_j
        self.rhs_left = rhs_left      # (p, r, d2)
        self.rhs_right = rhs_right    # (Tb, d2, 1)
        self.output_functional = output_functional
        self.error_estimator = error_estimator

    @property
    def dim(self) -> int:
        return self.lhs_right.source_dim

    def assemble(self, mu: Mu):
        """(A (r, r), b (r,)), or (B, r, r) and (B, r) for a batched Mu."""
        A = self.lhs_left.assemble(mu) @ self.lhs_right.assemble(mu)
        b = _mv(self.rhs_left.assemble(mu), self.rhs_right.assemble_vec(mu))
        return A, b

    def solve(self, mu: Mu) -> torch.Tensor:
        A, b = self.assemble(mu)
        return torch.linalg.solve(A, b)

    def solve_batch(self, mus_batched: Mu) -> torch.Tensor:
        return self.solve(mus_batched)

    def estimate_error(self, mu: Mu, u=None) -> torch.Tensor:
        if u is None:
            u = self.solve(mu)
        return self.error_estimator.estimate_error(u, mu)


class PreconditionedRom:
    """Assembles the preconditioned Galerkin ROM one direction at a time."""

    def __init__(
        self,
        fom: StationaryFOM,
        reduced_basis,
        residual_embedding: Embedding,
        intermediate_bases: Optional[dict] = None,
        product: Optional[Product] = None,
        stable_galerkin: bool = True,
        log_level: int = 20,
    ):
        self.fom = fom
        self.reduced_basis = torch.as_tensor(reduced_basis)
        self.residual_embedding = residual_embedding
        self.intermediate_bases = intermediate_bases
        self.product = (product if product is not None
                        else Product.identity(fom.solution_dim))
        self.stable_galerkin = stable_galerkin and intermediate_bases is not None
        self.logger = get_logger("precond.rom", log_level)
        self.mu_added: list = []
        self.rom = None

        U = self.reduced_basis
        self._RU = torch.as_tensor(self.product.op.apply(U))
        # Theta_res^H columns (n, k): the rows of the residual embedding
        self._res_cols = torch.as_tensor(residual_embedding.source_array())
        if self.stable_galerkin:
            V1 = torch.as_tensor(intermediate_bases["lhs"])
            V2 = torch.as_tensor(intermediate_bases["rhs"])
            self._RV1 = torch.as_tensor(self.product.op.apply(V1))
            self._RV2 = torch.as_tensor(self.product.op.apply(V2))
            # the fixed right factors V^H A_j U and V^H b_l
            self._right_lhs = project(fom.operator, V1, U)
            self._right_rhs = project(fom.rhs, V2, None)
        # the naive mode's sums, and the stable mode's left factors
        # (one term per direction)
        self._gal_lhs = self._gal_rhs = self._res_lhs = self._res_rhs = None
        self._left_gal_lhs = self._left_gal_rhs = None
        self._left_res_lhs = self._left_res_rhs = None

    def _output(self):
        if self.fom.output_functional is None:
            return None
        return project(self.fom.output_functional, None, self.reduced_basis)

    def _add_preconditioner_naive(self, P: LinOp) -> StationaryROM:
        """The p*T-term expansion."""
        y_i = ProjectionCoefficient("precond", len(self.mu_added))
        U = self.reduced_basis
        # C = P^H R U:  U^H R P A_j U = C^H (A_j U)
        C = torch.as_tensor(P.apply_adjoint(self._RU))
        gal_lhs = project(self.fom.operator, C, U).scale(y_i)
        gal_rhs = materialize(project(self.fom.rhs, C, None)).scale(y_i)
        # D = P^H Theta_res^H:  Theta_res P A_j U = D^H (A_j U)
        D = torch.as_tensor(P.apply_adjoint(self._res_cols))
        res_lhs = project(self.fom.operator, D, U).scale(y_i)
        res_rhs = materialize(project(self.fom.rhs, D, None)).scale(y_i)

        if self._gal_lhs is None:
            self._gal_lhs, self._gal_rhs = gal_lhs, gal_rhs
            self._res_lhs, self._res_rhs = res_lhs, res_rhs
        else:
            self._gal_lhs = self._gal_lhs.add(gal_lhs)
            self._gal_rhs = self._gal_rhs.add(gal_rhs)
            self._res_lhs = self._res_lhs.add(res_lhs)
            self._res_rhs = self._res_rhs.add(res_rhs)
        return StationaryROM(
            self._gal_lhs, self._gal_rhs, output_functional=self._output(),
            error_estimator=ResidualErrorEstimator(self._res_lhs, self._res_rhs))

    def _add_preconditioner_stable(self, P: LinOp) -> FactoredROM:
        """The p+T-term factored form."""
        y_i = ProjectionCoefficient("precond", len(self.mu_added))
        C = torch.as_tensor(P.apply_adjoint(self._RU))        # (n, r)
        D = torch.as_tensor(P.apply_adjoint(self._res_cols))  # (n, k)

        def extend(acc, left, RV):
            blk = AffineDense((left.conj().T @ RV.to(left))[None], (y_i,))
            return blk if acc is None else acc.add(blk)

        self._left_gal_lhs = extend(self._left_gal_lhs, C, self._RV1)  # U^H R P R V1
        self._left_gal_rhs = extend(self._left_gal_rhs, C, self._RV2)
        self._left_res_lhs = extend(self._left_res_lhs, D, self._RV1)  # Theta P R V1
        self._left_res_rhs = extend(self._left_res_rhs, D, self._RV2)
        estimator = FactoredResidualEstimator(
            self._left_res_lhs, self._right_lhs, self._left_res_rhs, self._right_rhs)
        return FactoredROM(
            self._left_gal_lhs, self._right_lhs, self._left_gal_rhs, self._right_rhs,
            output_functional=self._output(), error_estimator=estimator)

    def add_preconditioner(self, P: LinOp, mu: Optional[Mu] = None) -> None:
        self.logger.info("adding preconditioner direction %d", len(self.mu_added))
        if self.stable_galerkin:
            rom = self._add_preconditioner_stable(P)
        else:
            rom = self._add_preconditioner_naive(P)
        self.mu_added.append(mu)
        self.rom = rom
