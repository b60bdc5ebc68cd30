"""Matrix-free Newmark-beta wave FOM on the stencil families (device).

Counterpart of ``rla4mor_tpu/models/wave_stencil.py``: ``WaveFOM`` factors
M + beta dt^2 A(mu) on the host; here each implicit acceleration solve

    (M + beta dt^2 A(mu)) a_{k+1} = b - A(mu) u*_k

runs warm-started preconditioned CG (BiCGStab for the non-SPD families) on
the matrix-free stencil operators, with the Jacobi diagonal of
M + beta dt^2 A or the mass-shifted V-cycle (``mass_dt = beta dt^2``) as
the preconditioner; on the card the cycle is captured once a trajectory in
a CUDA graph (``core/graphs.py``) and replayed at every iteration. The JAX
package writes the trajectory as one ``lax.scan``; here it is a Python
loop over the steps on the stencil's device. The backend (consistent Q1
mass in 2-D, the families' ``mass_apply_grid`` / ``mass_diag_grid`` /
``apply_field`` hooks otherwise) is ``InstationaryStencilFOM``'s.
"""

from __future__ import annotations

import time

import torch

from rla4mor_tpu_torch.core.solvers import bicgstab, cg, group_norm
from rla4mor_tpu_torch.models.instationary_stencil import (
    InstationaryStencilFOM,
    _FlatParabolicView,
)
from rla4mor_tpu_torch.models.wave import check_newmark
from rla4mor_tpu_torch.utils.config import sync


class WaveStencilFOM(InstationaryStencilFOM):
    """Newmark-beta wave equation over a stencil-protocol FOM.

    State lives on the node grid (Dirichlet shell zero); ``u0`` / ``v0``
    default to zero (with the stencil's f = 1 load as forcing the membrane
    rings up from rest). Every ``solve`` appends its readings to
    ``solve_log``: ``iters`` and ``rel_res`` of each acceleration solve
    (the final recursive residual over the step's right-hand side),
    ``mass_iters`` of the initial mass solve, and ``seconds``."""

    def __init__(self, stencil, T: float = 1.0, nt: int = 100, u0=None, v0=None,
                 beta: float = 0.25, gamma: float = 0.5, parameter_range=(0.1, 1.0)):
        self.beta, self.gamma = check_newmark(beta, gamma)
        super().__init__(stencil, T=T, nt=nt, u0=u0, parameter_range=parameter_range)
        del self.time_theta  # not a theta scheme
        shape = stencil.solution_shape
        self.v0 = (torch.zeros(shape, dtype=self.dtype, device=self.device) if v0 is None
                   else torch.as_tensor(v0).to(self.device, self.dtype))

    def _preconditioner(self, mu, kappa, c: float, precond: str, example: torch.Tensor):
        """Jacobi of M + c A(mu), or the mass-shifted V-cycle replayed from a
        CUDA graph on the card."""
        if precond == "mg":
            if len(self.solution_shape) != 2 or kappa is None:
                raise ValueError("precond='mg' needs a 2-D kappa-field family "
                                 "(models/multigrid.py); use 'jacobi' otherwise")
            from rla4mor_tpu_torch.core.graphs import graphed
            from rla4mor_tpu_torch.models.multigrid import make_vcycle

            return graphed(make_vcycle(kappa, mass_dt=c), example)
        if precond == "jacobi":
            dia = self._mass_diag() + c * self.stencil.jacobi_diag(mu)
            return lambda r: r / dia  # noqa: E731
        raise ValueError(f"unknown preconditioner {precond!r}")

    def solve(self, mu, tol: float = 1e-7, maxiter: int = 200, precond: str = "jacobi",
              store_every: int = 1, mesh=None, axis: str = "dof") -> torch.Tensor:
        """(*solution_shape, n_stored) displacement trajectory including u0,
        time axis last; ``store_every=s`` keeps every s-th step. The
        acceleration is warm-started across steps (consecutive a_k differ by
        O(dt)); the consistent initial one comes from the mass solve
        M a0 = b - A u0 by Jacobi-CG. ``mesh``: the Newmark loop on this
        rank's slab, as ``InstationaryStencilFOM.solve``'s (Jacobi only;
        the rank's slab of the trajectory is returned)."""
        st = self.stencil
        dt, beta, gamma = self.dt, self.beta, self.gamma
        c = beta * dt * dt
        if self.nt % store_every:
            raise ValueError(f"store_every={store_every} must divide nt={self.nt}")
        solver = cg if getattr(st, "is_spd", True) else bicgstab
        if mesh is not None:
            sl, A_mu, S_op, M_pre = self._mesh_ops(mu, c, precond, mesh, axis)
            b, mass, m_dia, group = sl.rhs(), sl.mass_apply, sl.mass_diag(), sl.group
            u, v = sl.slab.local(self.u0), sl.slab.local(self.v0)
        else:
            A_mu, kappa = self._make_stiff(mu)
            b, mass, m_dia, group = st.rhs(), self._mass_apply, self._mass_diag(), None
            u, v = self.u0, self.v0

            def S_op(v):  # implicit side: M + beta dt^2 A
                return self._mass_apply(v) + c * A_mu(v)

            M_pre = self._preconditioner(mu, kappa, c, precond, b)
        t0 = time.perf_counter()
        init = cg(mass, b - A_mu(u), precond=lambda r: r / m_dia, tol=tol, maxiter=maxiter,
                  group=group)
        a = init.x
        stored, iters, rel_res = [u], [], []
        for k in range(1, self.nt + 1):
            u_star = u + dt * v + dt * dt * (0.5 - beta) * a
            v_star = v + dt * (1.0 - gamma) * a
            rhs = b - A_mu(u_star)
            res = solver(S_op, rhs, x0=a, precond=M_pre, tol=tol, maxiter=maxiter, group=group)
            a = res.x
            u = u_star + c * a
            v = v_star + gamma * dt * a
            iters.append(res.iters)
            rel_res.append(float(res.residual_norm) / max(float(group_norm(rhs, group)), 1e-30))
            if k % store_every == 0:
                stored.append(u)
        sync(u.device)
        self.solve_log.append({"iters": iters, "rel_res": rel_res,
                               "mass_iters": init.iters,
                               "seconds": time.perf_counter() - t0})
        return torch.stack(stored, dim=-1)

    def as_reductor_fom(self, **solve_kw) -> "_FlatWaveView":
        """The ``WaveFOM``-shaped view for ``WaveReductor`` / ``pod_greedy``:
        flat trajectories and the affine stencil operator, rhs and mass as
        LinOps. ``solve_kw`` (tol, maxiter, precond, store_every) go to every
        FOM solve; ``store_every=s`` subsamples the snapshots while the ROM
        still steps all ``nt`` steps (compare at ``rec[:, ::s]``)."""
        return _FlatWaveView(self, solve_kw)


class _FlatWaveView(_FlatParabolicView):
    """The ``WaveFOM``-shaped interface of a :class:`WaveStencilFOM` (flat
    columns, affine LinOps): the parabolic view with Newmark's constants and
    the initial velocity."""

    def _scheme(self, fom) -> None:
        self.v0 = self._local(fom.v0).reshape(-1)
        self.beta, self.gamma = fom.beta, fom.gamma


__all__ = ["WaveStencilFOM"]
