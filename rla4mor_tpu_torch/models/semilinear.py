"""Monotone semilinear reaction-diffusion: the nonlinear-in-state family.

Counterpart of ``rla4mor_tpu/models/semilinear.py``:

    A(mu) u + c(mu) M_L g(u) = f   on the unit square, u = 0 on the boundary,

with A(mu) the matrix-free Q1 thermal-block stiffness (``models/stencil.py``),
M_L the lumped Q1 mass (h^2 on interior nodes: the reaction acts nodewise,
so one DEIM point is one node), g a monotone nondecreasing scalar function
applied elementwise and c(mu) >= 0. With g' >= 0 the operator
F(u) = A u + c M_L g(u) - f is strongly monotone with the linear part's
constant, so the Newton Jacobian A + c M_L g'(u) is SPD (Newton-CG) and
||u - u_r|| <= ||F(u_r)|| / alpha_LB(mu) with the linear family's
certified coercivity (``mor/semilinear_reductor.py``).

:meth:`SemilinearStencilFOM.solve_newton` is a Python loop on the device:
full Newton steps from u = 0, each an inner preconditioned CG (Jacobi, or
the V-cycle of the linear stiffness replayed from a CUDA graph on the
card). It differs from the JAX package's ``lax.while_loop`` as that loop
was meant to work (queue 3 of ROADMAP.md): one residual evaluation a step
(the JAX body evaluates it twice); the stagnation stop keeps the better of
the last two iterates (the JAX loop returns the last); and the loop says
why it stopped (``converged``, ``stagnated`` or ``max_newton``). Where
the JAX loop meets its tolerance, the iterates are the same.

:class:`SemilinearInstationaryFOM` is the IMEX heat composition: implicit
diffusion, explicit reaction, one linear SPD solve a step.
"""

from __future__ import annotations

import time

import torch

from rla4mor_tpu_torch.core.parameters import ParameterSpace
from rla4mor_tpu_torch.core.solvers import cg, group_norm
from rla4mor_tpu_torch.models.stencil import (
    StencilThermalBlock,
    interior_mask,
    mass_apply,
    mass_diag,
)
from rla4mor_tpu_torch.utils.config import as_tensor, sync

# each entry: (g, g') with g monotone nondecreasing and g(0) = 0 (u = 0 stays
# the Dirichlet-compatible rest state)
NONLINEARITIES = {
    "cubic": (lambda u: u * u * u, lambda u: 3.0 * u * u),
    "expm1": (torch.expm1, torch.exp),
    # u + atan(u): strongly monotone (g' >= 1), not a polynomial
    "arctan": (lambda u: u + torch.atan(u), lambda u: 1.0 + 1.0 / (1.0 + u * u)),
}

# sup of g' over [-U, U], the local Lipschitz constant of the certified IMEX
# bound (each g' is even or monotone, so the sup is at +-U or global)
NONLINEARITY_DG_SUP = {
    "cubic": lambda U: 3.0 * U * U,
    "expm1": torch.exp,
    "arctan": lambda U: torch.full_like(U, 2.0),
}

# spectral bounds of the consistent Q1 mass relative to h^2 on the uniform
# square grid: M = M1 (x) M1 with 1-D eigenvalues h (2 + cos t) / 3 in
# [h/3, h], so M's lie in [h^2/9, h^2] (the interior block by interlacing)
MASS_REL_SPECTRUM = (1.0 / 9.0, 1.0)


class SemilinearStencilFOM:
    """Matrix-free monotone semilinear FOM on the stencil protocol.

    A(mu) u + c(mu) M_L g(u) = f with A the ``grid_shape`` thermal block,
    c(mu) = ``reaction_scale`` * mu['reaction'][0] and g one of
    :data:`NONLINEARITIES`; parameters in the box ``mu_range`` (diffusion a
    block and one reaction entry). Every ``solve_newton`` appends its
    readings to ``solve_log`` (see there)."""

    is_spd = True  # the Newton Jacobian is SPD (monotone g)

    def __init__(self, grid_shape=(2, 2), num_intervals: int = 64, dtype=None,
                 nonlinearity: str = "cubic", reaction_scale: float = 100.0,
                 mu_range=(0.1, 1.0), device=None):
        self.linear = StencilThermalBlock(grid_shape, num_intervals, dtype, device)
        self.grid_shape = tuple(grid_shape)
        self.num_intervals = int(num_intervals)
        self.device, self.dtype = self.linear.device, self.linear.dtype
        self.n_nodes = self.num_intervals + 1
        self.h = 1.0 / self.num_intervals
        if nonlinearity not in NONLINEARITIES:
            raise ValueError(f"unknown nonlinearity {nonlinearity!r}; one of "
                             f"{sorted(NONLINEARITIES)}")
        self.nonlinearity = nonlinearity
        self.g, self.dg = NONLINEARITIES[nonlinearity]
        self.reaction_scale = float(reaction_scale)
        if mu_range[0] < 0:
            raise ValueError("monotonicity needs c(mu) >= 0: mu_lo >= 0")
        self.parameter_space = ParameterSpace.make(
            {"diffusion": self.linear.n_terms, "reaction": 1}, *mu_range)
        self.solve_log: list = []

    @property
    def solution_shape(self):
        return self.linear.solution_shape

    @property
    def n_dof(self) -> int:
        return self.n_nodes * self.n_nodes

    def reaction(self, mu, dtype=None) -> torch.Tensor:
        """c(mu): () for one Mu, (B,) for a batched one."""
        r = as_tensor(mu["reaction"], self.device, dtype or self.dtype)
        return self.reaction_scale * r[..., 0]

    def mass_lumped_diag(self, dtype=None) -> torch.Tensor:
        """Lumped Q1 mass diagonal: h^2 on interior nodes, 0 on the ring."""
        return (self.h * self.h) * interior_mask(self.n_nodes, dtype or self.dtype,
                                                 self.device)

    def apply_linear(self, mu, u: torch.Tensor) -> torch.Tensor:
        return self.linear.apply(mu, u)

    def apply_nonlinear(self, mu, u: torch.Tensor) -> torch.Tensor:
        """c(mu) M_L g(u), nodewise on the interior."""
        return self.reaction(mu, u.dtype) * self.mass_lumped_diag(u.dtype) * self.g(u)

    def residual(self, mu, u: torch.Tensor) -> torch.Tensor:
        """F(u) = A(mu) u + c M_L g(u) - f (zero on the ring)."""
        return self._residual(self.linear, mu, u)

    def jacobian_apply(self, mu, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """J(u) v = A(mu) v + c M_L g'(u) v (SPD for monotone g)."""
        return self._jacobian_apply(self.linear, mu, u, v)

    def jacobian_diag(self, mu, u: torch.Tensor) -> torch.Tensor:
        """diag J(u) for Jacobi preconditioning (>= diag A > 0)."""
        return self._jacobian_diag(self.linear, mu, u)

    # -- the same on the whole grid (lin = self.linear) or on this rank's
    # slab (lin = self.linear.slab(mesh)) ---------------------------------
    def _lumped(self, lin, dtype) -> torch.Tensor:
        """M_L on ``lin``'s rows."""
        if lin is self.linear:
            return self.mass_lumped_diag(dtype)
        return (self.h * self.h) * lin.slab.mask(dtype, self.device)

    def _residual(self, lin, mu, u: torch.Tensor) -> torch.Tensor:
        nonlinear = self.reaction(mu, u.dtype) * self._lumped(lin, u.dtype) * self.g(u)
        return lin.apply(mu, u) + nonlinear - lin.rhs(u.dtype)

    def _jacobian_apply(self, lin, mu, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        w = self.reaction(mu, v.dtype) * self._lumped(lin, v.dtype) * self.dg(u)
        return lin.apply(mu, v) + w * v

    def _jacobian_diag(self, lin, mu, u: torch.Tensor) -> torch.Tensor:
        return (lin.jacobi_diag(mu)
                + self.reaction(mu, u.dtype) * self._lumped(lin, u.dtype) * self.dg(u))

    def _linear_part(self, mesh, axis: str):
        """The linear family on the whole grid, or its slab on ``mesh``."""
        return self.linear if mesh is None else self.linear.slab(mesh, axis)

    def rhs(self, dtype=None) -> torch.Tensor:
        return self.linear.rhs(dtype)

    def output(self, u) -> torch.Tensor:
        """Mean-value functional (lumped integral)."""
        return u.sum(dim=(-2, -1)) * self.h * self.h

    def affine_operator(self):
        """AffineOp of the linear part (for ``MinThetaCoercivity``: the
        monotone bound needs only the linear family's coercivity)."""
        return self.linear.affine_operator()

    def _preconditioner(self, mu, cg_precond: str, f: torch.Tensor, lin=None):
        """u -> the inner CG's preconditioner at the iterate u."""
        lin = self.linear if lin is None else lin
        if cg_precond == "mg":
            if lin is not self.linear:
                raise ValueError("cg_precond='mg' on a mesh: the slabs take Jacobi (the "
                                 "V-cycle's power-of-two element count leaves an odd number "
                                 "of node rows, which an even 'dof' axis does not split)")
            from rla4mor_tpu_torch.core.graphs import graphed
            from rla4mor_tpu_torch.models.multigrid import make_vcycle

            # the V-cycle of the linear stiffness (the reaction diagonal is
            # O(c h^2 g') and does not change the conditioning), one CUDA
            # graph for the whole solve on the card
            vc = graphed(make_vcycle(self.linear.kappa(mu)), f)
            return lambda u: vc
        if cg_precond == "jacobi":
            def precond_for(u):
                diag = self._jacobian_diag(lin, mu, u)
                return lambda r: r / diag
            return precond_for
        raise ValueError(f"cg_precond must be 'jacobi' or 'mg': {cg_precond!r}")

    def solve_newton(self, mu, newton_tol: float = 1e-9, max_newton: int = 30,
                     cg_tol: float = 1e-10, cg_maxiter: int = 2000,
                     cg_precond: str = "jacobi", return_info: bool = False,
                     mesh=None, axis: str = "dof"):
        """Newton-CG from u = 0 with full steps.

        Stops ``converged`` once ||F(u)||_2 <= newton_tol ||f||_2;
        ``stagnated`` once a step cuts the residual by less than 10% (a
        float32 iterate at 4.2M DoF cannot show a 1e-6 residual: its stored
        value floors it near eps_f32 lam_max ||u||), returning the better of
        the last two iterates; ``max_newton`` after that many steps. One
        residual evaluation a step. ``cg_precond``: ``'jacobi'`` (diagonal
        of J(u)) or ``'mg'`` (the V-cycle of A(mu): needs a power-of-two
        ``num_intervals``; the float32 recipe at scale).

        ``mesh``: the residual, the Jacobian, g and the lumped mass on this
        rank's row slab (``linear.slab(mesh)``), every norm and the CG's
        inner products summed over ``axis``; Jacobi only. u is then the
        rank's slab of the solution.

        Returns u, or (u, info) with ``return_info``: ``iters`` (Newton
        steps taken, the stagnated one included), ``reason``, ``rel_res``
        (||F(u)|| / ||f|| of the returned u), ``residuals`` (the relative
        residual after each step, u = 0 first), ``cg_iters`` and
        ``seconds``; the same dict goes to ``solve_log``."""
        lin = self._linear_part(mesh, axis)
        group = None if mesh is None else lin.group
        if mesh is None:
            def residual(u):
                return self.residual(mu, u)
        else:
            def residual(u):
                return self._residual(lin, mu, u)
        f = lin.rhs()
        precond_for = self._preconditioner(mu, cg_precond, f, lin)
        t0 = time.perf_counter()
        fnorm = max(float(group_norm(f, group)), torch.finfo(f.dtype).tiny)
        thresh = newton_tol * fnorm
        u = torch.zeros_like(f)
        F = residual(u)
        rnorm = float(group_norm(F, group))
        k, residuals, cg_iters = 0, [rnorm / fnorm], []
        while rnorm > thresh and k < max_newton:
            uk = u
            res = cg(lambda v: self._jacobian_apply(lin, mu, uk, v), -F,
                     precond=precond_for(uk), tol=cg_tol, maxiter=cg_maxiter, group=group)
            cg_iters.append(res.iters)
            u_new = u + res.x
            F_new = residual(u_new)
            rn_new = float(group_norm(F_new, group))
            k += 1
            residuals.append(rn_new / fnorm)
            if rn_new <= thresh or rn_new <= 0.9 * rnorm:
                u, F, rnorm = u_new, F_new, rn_new
                continue
            if rn_new < rnorm:  # stagnated: keep the better of the last two
                u, F, rnorm = u_new, F_new, rn_new
            reason = "stagnated"
            break
        else:
            reason = "converged" if rnorm <= thresh else "max_newton"
        sync(u.device)
        info = {"iters": k, "reason": reason, "rel_res": rnorm / fnorm,
                "residuals": residuals, "cg_iters": cg_iters,
                "seconds": time.perf_counter() - t0}
        self.solve_log.append(info)
        return (u, info) if return_info else u

    def solve(self, mu) -> torch.Tensor:
        """Flat solve (a column of length n_dof)."""
        return self.solve_newton(mu).reshape(-1)

    def solve_many(self, mus) -> torch.Tensor:
        return torch.stack([self.solve(mu) for mu in mus], dim=1)

    def sample_parameters(self, count: int, seed: int = 0):
        return self.parameter_space.sample_randomly(count, seed, device=self.device,
                                                    dtype=self.dtype)


class SemilinearInstationaryFOM:
    """IMEX semilinear heat equation over the monotone reaction family:

        M u^{k+1} + dt A(mu) u^{k+1} = M u^k + dt (f - c(mu) M_L g(u^k)),

    implicit diffusion (consistent Q1 mass M), explicit reaction (lumped
    M_L): one linear SPD solve a step, warm-started Jacobi-CG, the loop of
    ``InstationaryStencilFOM``; first order in dt."""

    def __init__(self, fom: SemilinearStencilFOM, T: float = 1.0, nt: int = 50):
        self.fom = fom
        self.T = float(T)
        self.nt = int(nt)
        self.dt = self.T / self.nt
        self.parameter_space = fom.parameter_space
        self.u0 = torch.zeros(fom.solution_shape, dtype=fom.dtype, device=fom.device)

    @property
    def solution_shape(self):
        return self.fom.solution_shape

    def _mass_apply(self, v: torch.Tensor) -> torch.Tensor:
        return mass_apply(v, self.fom.h)

    def solve(self, mu, tol: float = 1e-9, maxiter: int = 400,
              store_every: int = 1, mesh=None, axis: str = "dof") -> torch.Tensor:
        """(*solution_shape, n_stored) trajectory including u0, time axis
        last (``store_every`` keeps every s-th step). ``mesh``: the IMEX
        loop on this rank's row slab (M + dt A one halo exchange an apply);
        the rank's slab of the trajectory is returned."""
        fom, dt = self.fom, self.dt
        if self.nt % store_every:
            raise ValueError(f"store_every={store_every} must divide nt={self.nt}")
        c = fom.reaction(mu)
        if mesh is None:
            b, ml, u, group = fom.rhs(), fom.mass_lumped_diag(), self.u0, None
            mass = self._mass_apply

            def B(v):
                return self._mass_apply(v) + dt * fom.apply_linear(mu, v)

            dia = mass_diag(fom.n_nodes, fom.h, fom.dtype, fom.device) \
                + dt * fom.linear.jacobi_diag(mu)
        else:
            lin = fom._linear_part(mesh, axis)
            b, ml, u, group = lin.rhs(), fom._lumped(lin, fom.dtype), lin.slab.local(self.u0), \
                lin.group
            mass, B = lin.mass_apply, lin.shifted(mu, dt)
            dia = lin.mass_diag() + dt * lin.jacobi_diag(mu)
        stored = [u]
        for k in range(1, self.nt + 1):
            rhs = mass(u) + dt * (b - c * ml * fom.g(u))
            u = cg(B, rhs, x0=u, precond=lambda r: r / dia, tol=tol, maxiter=maxiter,
                   group=group).x
            if k % store_every == 0:
                stored.append(u)
        return torch.stack(stored, dim=-1)

    def solve_flat(self, mu, **kw) -> torch.Tensor:
        traj = self.solve(mu, **kw)
        return traj.reshape(-1, traj.shape[-1])

    def output_trajectory(self, traj) -> torch.Tensor:
        """Mean-value output at each stored step: (n_stored,)."""
        h2 = self.fom.h * self.fom.h
        return traj.sum(dim=tuple(range(traj.dim() - 1))) * h2

    def sample_parameters(self, count: int, seed: int = 0):
        return self.fom.sample_parameters(count, seed)


__all__ = ["NONLINEARITIES", "NONLINEARITY_DG_SUP", "MASS_REL_SPECTRUM",
           "SemilinearStencilFOM", "SemilinearInstationaryFOM"]
