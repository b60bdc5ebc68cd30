"""Matrix-free advection-diffusion stencil FOM (non-SPD), on the device.

Counterpart of ``rla4mor_tpu/models/stencil_advection.py``: the
discretisation of the host-assembled
:class:`~rla4mor_tpu_torch.models.advection_diffusion.AdvectionDiffusionFOM`
(Q1 diffusion stiffness plus lumped central-difference advection) applied
as gather-form stencils on the node grid, solved by device BiCGStab
(``core/solvers.py``) instead of a host factorisation:

    A(mu) = eps K + bx Cx + by Cy,   mu = {'eps': (1,), 'velocity': (2,)}

Grid conventions follow :mod:`rla4mor_tpu_torch.models.stencil`: node grid
(N+1, N+1) with leading batch dimensions allowed, Dirichlet ring masked,
row index = y, column = x.
"""

from __future__ import annotations

from typing import Tuple

import torch

from rla4mor_tpu_torch.core.parameters import ParameterSpace
from rla4mor_tpu_torch.core.solvers import bicgstab
from rla4mor_tpu_torch.models.stencil import (
    FlatGridOp,
    _pad,
    interior_mask,
    preconditioner,
    stencil_apply,
    stiffness_diag_raw,
)
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device


def advection_apply(u: torch.Tensor, h: float, axis: int) -> torch.Tensor:
    """Lumped central-difference advection C_axis u in gather form:
    (h/2)(u_east - u_west) at each interior node (axis 0: x, the last
    dimension; axis 1: y, the one before), the Dirichlet ring masked on
    input and output. Equals the host ``AdvectionDiffusionFOM``'s advection
    matrices on interior nodes."""
    M = u.shape[-1]
    mask = interior_mask(M, u.dtype, u.device)
    up = _pad(u * mask)
    if axis == 0:
        diff = up[..., 1:M + 1, 2:] - up[..., 1:M + 1, :M]
    else:
        diff = up[..., 2:, 1:M + 1] - up[..., :M, 1:M + 1]
    return (h / 2.0) * diff * mask


class StencilAdvectionDiffusion:
    """Matrix-free non-SPD affine FOM A(mu) = eps K + bx Cx + by Cy on
    ``device`` (the current card unless named), working dtype by default."""

    is_spd = False
    n_terms = 3
    # kappa() is the SPD diffusion part, the V-cycle's hook, not the operator
    kappa_is_full_operator = False

    def __init__(
        self,
        num_intervals: int = 64,
        dtype=None,
        eps_range: Tuple[float, float] = (0.05, 1.0),
        velocity_range: Tuple[float, float] = (-1.0, 1.0),
        device=None,
    ):
        self.num_intervals = int(num_intervals)
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.n_nodes = self.num_intervals + 1
        self.h = 1.0 / self.num_intervals
        self.parameter_space = ParameterSpace.make({"eps": 1, "velocity": 2})
        self._eps_range = eps_range
        self._velocity_range = velocity_range

    @property
    def solution_shape(self):
        return (self.n_nodes, self.n_nodes)

    def _ones(self, dtype) -> torch.Tensor:
        N = self.num_intervals
        return torch.ones((N, N), dtype=dtype, device=self.device)

    def theta_vector(self, mu) -> torch.Tensor:
        """(eps, bx, by): (3,), or (B, 3) for a batched Mu."""
        return torch.cat([as_tensor(mu["eps"], self.device, self.dtype),
                          as_tensor(mu["velocity"], self.device, self.dtype)], dim=-1)

    def apply(self, mu, u: torch.Tensor) -> torch.Tensor:
        theta = self.theta_vector(mu).to(u.dtype)
        out = theta[0] * stencil_apply(u, self._ones(u.dtype))
        out = out + theta[1] * advection_apply(u, self.h, 0)
        return out + theta[2] * advection_apply(u, self.h, 1)

    def apply_term(self, t: int, u: torch.Tensor) -> torch.Tensor:
        if t == 0:
            return stencil_apply(u, self._ones(u.dtype))
        return advection_apply(u, self.h, t - 1)

    def product_apply(self, u: torch.Tensor) -> torch.Tensor:
        """h1_0 product R = K (the diffusion stiffness)."""
        return stencil_apply(u, self._ones(u.dtype))

    def term_box_bounds(self) -> list:
        """l2 boxes of the symmetrised terms: K is PSD with lambda <= 16/3
        (unit coefficient); the advection terms are anti-symmetric on
        interior nodes, so their symmetric parts vanish."""
        return [(0.0, 16.0 / 3.0), (0.0, 0.0), (0.0, 0.0)]

    def rhs(self, dtype=None) -> torch.Tensor:
        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.solution_shape, self.h * self.h, dtype=dt,
                          device=self.device)
        return load * interior_mask(self.n_nodes, dt, self.device)

    def kappa(self, mu, dtype=None) -> torch.Tensor:
        """Element diffusion field eps * ones, the SPD part of A(mu): the
        V-cycle on it preconditions BiCGStab (the cell Peclet number
        |b| h / (2 eps) is small at fine h)."""
        dt = self.dtype if dtype is None else dtype
        eps = as_tensor(mu["eps"], self.device, dt).reshape(-1)[0]
        return self._ones(dt) * eps

    def jacobi_diag(self, mu) -> torch.Tensor:
        """diag A(mu) = eps diag K (central differences have a zero
        diagonal); 1 on the Dirichlet ring."""
        eps = as_tensor(mu["eps"], self.device, self.dtype).reshape(-1)[0]
        d = eps * stiffness_diag_raw(self._ones(self.dtype))
        return torch.where(d > 0, d, torch.ones_like(d))

    def solve_bicgstab_result(self, mu, tol=1e-8, maxiter=4000, precond="jacobi"):
        """Matrix-free BiCGStab solve preconditioned by ``precond``
        ('jacobi' or 'mg', the V-cycle on :meth:`kappa`), with its
        :class:`~rla4mor_tpu_torch.core.solvers.CGResult`."""
        return bicgstab(lambda u: self.apply(mu, u), self.rhs(),
                        precond=preconditioner(self, mu, precond), tol=tol,
                        maxiter=maxiter)

    def solve_bicgstab(self, mu, tol=1e-8, maxiter=4000, precond="jacobi"):
        return self.solve_bicgstab_result(mu, tol, maxiter, precond).x

    def output(self, u: torch.Tensor) -> torch.Tensor:
        """Mean-value functional (lumped integral), per grid of the leading
        dimensions."""
        return u.sum(dim=(-2, -1)) * self.h * self.h

    # -- flattened-vector LinOp views ---------------------------------------
    def term_linop(self, t: int) -> "AdvectionTermOp":
        return AdvectionTermOp(self, t)

    def affine_operator(self):
        """AffineOp over flattened vectors: eps K + bx Cx + by Cy."""
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.parameters import ProjectionCoefficient

        return AffineOp(
            tuple(self.term_linop(t) for t in range(self.n_terms)),
            (ProjectionCoefficient("eps", 0), ProjectionCoefficient("velocity", 0),
             ProjectionCoefficient("velocity", 1)),
        )

    def sample_parameters(self, count: int, key: int = 0) -> list:
        """Uniform samples within the per-name ranges (eps > 0), as the host
        ``AdvectionDiffusionFOM`` draws them (``sample_advection``)."""
        from rla4mor_tpu_torch.models.advection_diffusion import sample_advection

        return sample_advection(count, key, self._eps_range, self._velocity_range,
                                self.device, self.dtype)


class AdvectionTermOp(FlatGridOp):
    """LinOp view of one term on flattened vectors: t = 0 the symmetric
    stiffness K, t = 1 / 2 the advection Cx / Cy, anti-symmetric on interior
    nodes, whose ``H`` is the negated operator."""

    def __init__(self, fom: StencilAdvectionDiffusion, t: int, sign: float = 1.0):
        super().__init__(fom.n_nodes)
        self.fom = fom
        self.t = t
        self.sign = sign

    def _grid_apply(self, grid):
        out = self.fom.apply_term(self.t, grid)
        return out if self.sign == 1.0 else self.sign * out

    def apply_adjoint(self, V, mu=None):
        # not FlatGridOp's symmetric alias: the advection terms are
        # anti-symmetric
        return self.H.apply(V, mu)

    @property
    def H(self):
        if self.t == 0:
            return self
        return AdvectionTermOp(self.fom, self.t, sign=-self.sign)
