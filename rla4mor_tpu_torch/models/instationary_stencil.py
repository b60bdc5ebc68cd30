"""Matrix-free implicit-Euler parabolic FOM on the stencil families (device).

Counterpart of ``rla4mor_tpu/models/instationary_stencil.py``. Each step of
the theta scheme solves

    (M + theta dt A(mu)) u_{k+1} = (M - (1 - theta) dt A(mu)) u_k + dt b

by preconditioned CG (BiCGStab for the non-SPD families) on the matrix-free
stencil operators, warm-started at u_k, with the Jacobi diagonal of
M + theta dt A or the mass-shifted V-cycle (``make_vcycle(mass_dt=...)``)
as the preconditioner. On the card the V-cycle of a trajectory is captured
once in a CUDA graph (``core/graphs.py``) and replayed at every iteration. The JAX package writes the trajectory as one
``lax.scan``; here it is a Python loop over the steps on the stencil's
device. No host factorisation is involved, so the FOM scales to millions
of nodes.

The 2-D families use the consistent Q1 mass of ``models/stencil.py``; a
family with the hooks ``mass_apply_grid`` / ``mass_diag_grid`` /
``apply_field`` (the 3-D block, the non-affine families and their EIM
surrogates) is used through them. ``as_reductor_fom`` gives the
flat-vector view that ``InstationaryReductor`` and ``pod_greedy`` take.
"""

from __future__ import annotations

import math
import time

import torch

from rla4mor_tpu_torch.core.parameters import ParameterSpace
from rla4mor_tpu_torch.core.solvers import bicgstab, cg
from rla4mor_tpu_torch.models.instationary import _check_theta
from rla4mor_tpu_torch.models.stencil import FlatGridOp, mass_apply, mass_diag, stencil_apply
from rla4mor_tpu_torch.utils.config import sync


class InstationaryStencilFOM:
    """Theta-scheme heat equation over a stencil-protocol FOM (the thermal
    block, its 3-D form, the non-affine families, their EIM surrogates).

    State lives on the node grid (Dirichlet ring zero), A(mu) is the
    stencil's own operator, f = 1 (the stencil's ``rhs``), u0 = 0 unless
    given. Every ``solve`` appends its per-step solver readings to
    ``solve_log`` (``iters``, ``rel_res``: the final recursive residual over
    the step's right-hand side, and ``seconds``)."""

    def __init__(self, stencil, T: float = 1.0, nt: int = 50, u0=None,
                 parameter_range=(0.1, 1.0), time_theta: float = 1.0):
        self.time_theta = _check_theta(time_theta)
        self.stencil = stencil
        self.T = float(T)
        self.nt = int(nt)
        self.dt = self.T / self.nt
        self.h = stencil.h
        self.device, self.dtype = stencil.device, stencil.dtype
        shape = stencil.solution_shape
        self.u0 = (torch.zeros(shape, dtype=self.dtype, device=self.device) if u0 is None
                   else torch.as_tensor(u0).to(self.device, self.dtype))
        ps = getattr(stencil, "parameter_space", None)
        if ps is None:
            if not hasattr(stencil, "grid_shape"):
                raise TypeError(
                    "stencil-protocol FOM must provide a parameter_space (non-thermal-"
                    "block families) or grid_shape (thermal block): "
                    f"{type(stencil).__name__} has neither")
            ps = ParameterSpace.make({"diffusion": math.prod(stencil.grid_shape)},
                                     *parameter_range)
        self.parameter_space = ps
        self.solve_log: list = []

    # -- rank-generic backend: the consistent Q1 mass and 2-D stencil, or the
    # family's own hooks --------------------------------------------------
    def _mass_apply(self, v: torch.Tensor) -> torch.Tensor:
        st = self.stencil
        if hasattr(st, "mass_apply_grid"):
            return st.mass_apply_grid(v)
        return mass_apply(v, self.h)

    def _mass_diag(self) -> torch.Tensor:
        st = self.stencil
        if hasattr(st, "mass_diag_grid"):
            return st.mass_diag_grid()
        return mass_diag(st.n_nodes, self.h, st.dtype, st.device)

    def _stiff_apply(self, v: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
        st = self.stencil
        if hasattr(st, "apply_field"):
            return st.apply_field(kappa, v)
        return stencil_apply(v, kappa)

    def _make_stiff(self, mu):
        """(A(mu) as a grid -> grid closure, the kappa field or None): a
        kappa-field family evaluates its field once a parameter; a family
        whose kappa is only part of its operator (advection-diffusion:
        the SPD part, for the V-cycle) is applied as a whole."""
        st = self.stencil
        if hasattr(st, "kappa") and getattr(st, "kappa_is_full_operator", True):
            kappa = st.kappa(mu)
            return (lambda v: self._stiff_apply(v, kappa)), kappa
        return (lambda v: st.apply(mu, v)), None

    @property
    def solution_shape(self):
        return self.stencil.solution_shape

    def solve(self, mu, tol: float = 1e-7, maxiter: int = 200, precond: str = "jacobi",
              store_every: int = 1) -> torch.Tensor:
        """(*solution_shape, n_stored) trajectory including u0, time axis
        last. ``store_every=s`` keeps every s-th step (s must divide nt).
        ``precond``: ``'jacobi'`` (diagonal of M + theta dt A) or ``'mg'``
        (the mass-shifted V-cycle: a 2-D kappa-field family with
        power-of-two element counts)."""
        st = self.stencil
        dt, th = self.dt, self.time_theta
        if self.nt % store_every:
            raise ValueError(f"store_every={store_every} must divide nt={self.nt}")
        A_mu, kappa = self._make_stiff(mu)
        b = st.rhs()
        # M + theta dt A is SPD iff A is; the others by warm-started BiCGStab
        solver = cg if getattr(st, "is_spd", True) else bicgstab

        def B(v):  # implicit side: M + theta dt A
            return self._mass_apply(v) + th * dt * A_mu(v)

        if precond == "mg":
            if len(self.solution_shape) != 2 or kappa is None:
                raise ValueError("precond='mg' needs a 2-D kappa-field family "
                                 "(models/multigrid.py); use 'jacobi' otherwise")
            from rla4mor_tpu_torch.core.graphs import graphed
            from rla4mor_tpu_torch.models.multigrid import make_vcycle

            # a cycle is thousands of small kernels: replayed from one CUDA
            # graph on the card (the same kernels, so the same values)
            M_pre = graphed(make_vcycle(kappa, mass_dt=th * dt), b)
        elif precond == "jacobi":
            dia = self._mass_diag() + th * dt * st.jacobi_diag(mu)
            M_pre = lambda r: r / dia  # noqa: E731
        else:
            raise ValueError(f"unknown preconditioner {precond!r}")

        t0 = time.perf_counter()
        u = self.u0
        stored, iters, rel_res = [u], [], []
        for k in range(1, self.nt + 1):
            rhs = self._mass_apply(u) + dt * b  # explicit side: (M - (1 - th) dt A) u
            if th < 1.0:
                rhs = rhs - (1.0 - th) * dt * A_mu(u)
            res = solver(B, rhs, x0=u, precond=M_pre, tol=tol, maxiter=maxiter)
            u = res.x
            iters.append(res.iters)
            rel_res.append(float(res.residual_norm)
                           / max(float(torch.linalg.vector_norm(rhs)), 1e-30))
            if k % store_every == 0:
                stored.append(u)
        sync(u.device)
        self.solve_log.append({"iters": iters, "rel_res": rel_res,
                               "seconds": time.perf_counter() - t0})
        return torch.stack(stored, dim=-1)

    def solve_flat(self, mu, **kw) -> torch.Tensor:
        """(n, n_stored) flat-column view of :meth:`solve`."""
        traj = self.solve(mu, **kw)
        return traj.reshape(-1, traj.shape[-1])

    def as_reductor_fom(self, **solve_kw) -> "_FlatParabolicView":
        """The ``InstationaryFOM``-shaped view for ``InstationaryReductor`` /
        ``pod_greedy``: flat trajectories and the affine stencil operator,
        rhs and mass as LinOps, so the whole greedy runs on the device.
        ``solve_kw`` (tol, maxiter, precond, store_every) go to every FOM
        solve. ``store_every=s`` subsamples the snapshot trajectories the
        greedy PODs; the ROM still steps all ``nt`` steps (compare at the
        stored steps, ``rec[:, ::s]``)."""
        return _FlatParabolicView(self, solve_kw)


class MassStencilOp(FlatGridOp):
    """LinOp view of the FOM's mass on flat vectors (consistent Q1 in 2-D,
    the family's ``mass_apply_grid`` otherwise)."""

    def __init__(self, fom: InstationaryStencilFOM):
        super().__init__(grid_shape=fom.solution_shape)
        self.fom = fom

    def _grid_apply(self, grid):
        return self.fom._mass_apply(grid)

    @property
    def H(self):
        return self


_UNBUILT = object()  # lazy-output sentinel (None is a valid built value)


def _mean_value_output(fom):
    """The family's lumped-integral output (``st.output``: sum(u) h^d, uniform
    weights) as an affine (1, 1, n) row, or None when the family defines no
    output. The weight comes from ``output(ones)`` by linearity; two one-hot
    probes and a homogeneity probe (output(2 e) = 2 output(e)) reject a
    non-uniform or nonlinear output instead of deriving a wrong row."""
    from rla4mor_tpu_torch.core.affine import AffineDense
    from rla4mor_tpu_torch.core.parameters import ONE

    st = fom.stencil
    if not hasattr(st, "output"):
        return None
    shape = tuple(fom.solution_shape)
    n = math.prod(shape)
    dev = getattr(st, "device", None)
    ones = torch.ones(shape, dtype=st.dtype, device=dev)
    c = float(st.output(ones)) / n

    def weight_at(flat_index, amplitude=1.0):
        e = torch.zeros(n, dtype=st.dtype, device=dev)
        e[flat_index] = amplitude
        return float(st.output(e.reshape(shape)))

    w0, w_mid, w0_scaled = weight_at(0), weight_at(n // 2), weight_at(0, 2.0)
    tol = 1e-5 * (abs(c) + 1e-30)
    if not (abs(w0 - c) <= tol and abs(w_mid - c) <= tol
            and abs(w0_scaled - 2.0 * w0) <= 2 * tol):
        raise NotImplementedError(
            f"{type(st).__name__}.output is not a uniform-weight linear functional; "
            f"_mean_value_output cannot derive its affine row (weight[0]={w0:.6e}, "
            f"weight[n//2]={w_mid:.6e}, output(2 e0)={w0_scaled:.6e} vs mean weight "
            f"{c:.6e})")
    return AffineDense(torch.full((1, 1, n), c, dtype=st.dtype, device=dev), (ONE,))


class _FlatParabolicView:
    """The ``InstationaryFOM``-shaped interface of an
    :class:`InstationaryStencilFOM` (flat columns, affine LinOps)."""

    def __init__(self, fom: InstationaryStencilFOM, solve_kw):
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.linops import DenseOp
        from rla4mor_tpu_torch.core.parameters import ONE

        self._fom = fom
        self._solve_kw = dict(solve_kw)
        st = fom.stencil
        self.device, self.dtype = fom.device, fom.dtype
        self.operator = st.affine_operator()
        self.rhs = AffineOp((DenseOp(st.rhs().reshape(-1, 1), device=self.device,
                                     dtype=self.dtype),), (ONE,))
        self.mass = MassStencilOp(fom)
        self.solution_dim = math.prod(fom.solution_shape)
        self.u0 = fom.u0.reshape(-1)
        self.T, self.nt, self.dt = fom.T, fom.nt, fom.dt
        self._scheme(fom)
        self.parameter_space = fom.parameter_space
        self.products: dict = {}
        self._output_functional = _UNBUILT  # the (1, 1, n) row, built on first use

    def _scheme(self, fom) -> None:
        """The time scheme's constants, as the host FOM names them."""
        self.time_theta = fom.time_theta

    @property
    def stencil_fom(self) -> InstationaryStencilFOM:
        return self._fom

    @property
    def output_functional(self):
        if self._output_functional is _UNBUILT:
            self._output_functional = _mean_value_output(self._fom)
        return self._output_functional

    def solve(self, mu) -> torch.Tensor:
        return self._fom.solve_flat(mu, **self._solve_kw)

    def solve_many(self, mus) -> torch.Tensor:
        return torch.stack([self.solve(mu) for mu in mus], dim=0)


__all__ = ["InstationaryStencilFOM", "MassStencilOp"]
