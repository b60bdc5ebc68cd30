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
from rla4mor_tpu_torch.core.solvers import bicgstab, cg, group_norm
from rla4mor_tpu_torch.models.instationary import _check_theta
from rla4mor_tpu_torch.models.stencil import (
    FlatGridOp,
    ThermalSlab,
    mass_apply,
    mass_diag,
    stencil_apply,
)
from rla4mor_tpu_torch.utils.config import sync


class InstationaryStencilFOM:
    """Theta-scheme heat equation over a stencil-protocol FOM (the thermal
    block, its 3-D form, the non-affine families, their EIM surrogates).

    State lives on the node grid (Dirichlet ring zero), A(mu) is the
    stencil's own operator, f = 1 (the stencil's ``rhs``), u0 = 0 unless
    given. Every ``solve`` appends its per-step solver readings to
    ``solve_log`` (``iters``, ``rel_res``: the final recursive residual over
    the step's right-hand side, ``step_s``: each step's host seconds, and
    ``seconds``)."""

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

    def slab(self, mesh, axis: str = "dof"):
        """The stencil's slab view on ``mesh`` (``stencil.slab``: the thermal
        block in 2-D and 3-D and the advection family)."""
        st = self.stencil
        if not hasattr(st, "slab"):
            raise NotImplementedError(f"{type(st).__name__} has no row-slab form yet: it "
                                      "runs on one device")
        return st.slab(mesh, axis)

    @staticmethod
    def gather(local: torch.Tensor, mesh, axis: str = "dof") -> torch.Tensor:
        """The whole grid (trajectory) from every rank's slab of it (its
        leading axis), on every rank: for checks, not for the time loop."""
        from rla4mor_tpu_torch.parallel import mesh as pm

        return pm.all_gather_rows(local, pm.axis_group(mesh, axis), dim=0)

    def _mesh_ops(self, mu, c: float, precond: str, mesh, axis: str):
        """(the slab view, A(mu), M + c A(mu), Jacobi of M + c A) on this
        rank's slab: each operator apply one halo exchange."""
        if precond != "jacobi":
            raise ValueError(
                f"precond={precond!r} on a mesh: the slabs take Jacobi. The V-cycle "
                "needs a power-of-two element count, so the N + 1 node rows are odd "
                "and do not split over an even 'dof' axis")
        sl = self.slab(mesh, axis)
        dia = sl.mass_diag() + c * sl.jacobi_diag(mu)
        return sl, sl.operator(mu), sl.shifted(mu, c), lambda r: r / dia

    def solve(self, mu, tol: float = 1e-7, maxiter: int = 200, precond: str = "jacobi",
              store_every: int = 1, mesh=None, axis: str = "dof") -> torch.Tensor:
        """(*solution_shape, n_stored) trajectory including u0, time axis
        last. ``store_every=s`` keeps every s-th step (s must divide nt).
        ``precond``: ``'jacobi'`` (diagonal of M + theta dt A) or ``'mg'``
        (the mass-shifted V-cycle: a 2-D kappa-field family with
        power-of-two element counts).

        ``mesh``: a ``DeviceMesh`` whose ``axis`` splits the grid's leading
        axis (node rows, or z-planes in 3-D; it must divide them): each rank
        steps its slab (:meth:`slab`), the solver's inner products summed
        over the axis (``cg`` / ``bicgstab(group=)``), and the implicit
        operator M + theta dt A costs one halo exchange an apply. Jacobi
        only. Returns the rank's slab of the trajectory (:meth:`gather`
        assembles it)."""
        st = self.stencil
        dt, th = self.dt, self.time_theta
        if self.nt % store_every:
            raise ValueError(f"store_every={store_every} must divide nt={self.nt}")
        # M + theta dt A is SPD iff A is; the others by warm-started BiCGStab
        solver = cg if getattr(st, "is_spd", True) else bicgstab
        if mesh is not None:
            sl, A_mu, B, M_pre = self._mesh_ops(mu, th * dt, precond, mesh, axis)
            return self._steps(A_mu, B, sl.mass_apply, sl.rhs(), M_pre,
                               sl.slab.local(self.u0), sl.group, solver, tol, maxiter,
                               store_every)
        A_mu, kappa = self._make_stiff(mu)
        b = st.rhs()

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

        return self._steps(A_mu, B, self._mass_apply, b, M_pre, self.u0, None, solver, tol,
                           maxiter, store_every)

    def _steps(self, A_mu, B, mass, b, M_pre, u, group, solver, tol, maxiter,
               store_every) -> torch.Tensor:
        """The theta-scheme loop from ``u`` on the grid or a slab (``group``)."""
        dt, th = self.dt, self.time_theta
        t0 = time.perf_counter()
        stored, iters, rel_res, step_s = [u], [], [], []
        for k in range(1, self.nt + 1):
            t_step = time.perf_counter()
            rhs = mass(u) + dt * b  # explicit side: (M - (1 - th) dt A) u
            if th < 1.0:
                rhs = rhs - (1.0 - th) * dt * A_mu(u)
            res = solver(B, rhs, x0=u, precond=M_pre, tol=tol, maxiter=maxiter, group=group)
            u = res.x
            iters.append(res.iters)
            # the host reads the residual: the step's work is done
            rel_res.append(float(res.residual_norm) / max(float(group_norm(rhs, group)), 1e-30))
            step_s.append(time.perf_counter() - t_step)
            if k % store_every == 0:
                stored.append(u)
        sync(u.device)
        self.solve_log.append({"iters": iters, "rel_res": rel_res, "step_s": step_s,
                               "seconds": time.perf_counter() - t0})
        return torch.stack(stored, dim=-1)

    def solve_flat(self, mu, **kw) -> torch.Tensor:
        """(n, n_stored) flat-column view of :meth:`solve`."""
        traj = self.solve(mu, **kw)
        return traj.reshape(-1, traj.shape[-1])

    def as_reductor_fom(self, mesh=None, axis: str = "dof",
                        **solve_kw) -> "_FlatParabolicView":
        """The ``InstationaryFOM``-shaped view for ``InstationaryReductor`` /
        ``pod_greedy``: flat trajectories and the affine stencil operator,
        rhs and mass as LinOps, so the whole greedy runs on the device.
        ``solve_kw`` (tol, maxiter, precond, store_every) go to every FOM
        solve. ``store_every=s`` subsamples the snapshot trajectories the
        greedy PODs; the ROM still steps all ``nt`` steps (compare at the
        stored steps, ``rec[:, ::s]``).

        ``mesh``: the view of this rank's slab (:meth:`solve` on the mesh):
        its columns are the slab's flattened rows (``local_dim`` of the
        ``solution_dim``, from ``row_offset``), its operators act on them,
        and ``group`` names the axis over which the reductor sums its
        contractions. The 2-D thermal block's only: another family on a
        mesh raises ``ValueError``."""
        return _FlatParabolicView(self, solve_kw, mesh, axis)


class MassStencilOp(FlatGridOp):
    """LinOp view of the FOM's mass on flat vectors (consistent Q1 in 2-D,
    the family's ``mass_apply_grid`` otherwise), or on this rank's slab's
    flattened rows (``mesh``)."""

    def __init__(self, fom: InstationaryStencilFOM, mesh=None, axis: str = "dof"):
        self._apply = fom._mass_apply
        shape = fom.solution_shape
        if mesh is not None:
            sl = fom.slab(mesh, axis)
            self._apply, shape = sl.mass_apply, sl.local_shape
        super().__init__(grid_shape=shape)
        self.fom = fom

    def _grid_apply(self, grid):
        return self._apply(grid)

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
    :class:`InstationaryStencilFOM` (flat columns, affine LinOps), on one
    device or on this rank's slab (``mesh``)."""

    def __init__(self, fom: InstationaryStencilFOM, solve_kw, mesh=None, axis: str = "dof"):
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.linops import DenseOp
        from rla4mor_tpu_torch.core.parameters import ONE

        self._fom = fom
        self._solve_kw = dict(solve_kw)
        st = fom.stencil
        self.device, self.dtype = fom.device, fom.dtype
        self.solution_dim = math.prod(fom.solution_shape)
        # the slab's rows: [row_offset, row_offset + local_dim) of the columns
        self.group, self.row_offset = None, None
        self.local_dim = self.solution_dim
        self._local = lambda grid: grid  # a whole grid -> the view's rows of it
        if mesh is not None:
            sl = fom.slab(mesh, axis)
            if not isinstance(sl, ThermalSlab):
                raise ValueError("the reductor's slab view is the 2-D thermal block's: "
                                 f"{type(fom.stencil).__name__} on a mesh is not ported")
            self._solve_kw.update(mesh=mesh, axis=axis)
            self.group, self.row_offset = sl.group, sl.row_offset
            self.local_dim = math.prod(sl.local_shape)
            st, self._local = sl, sl.slab.local
        self.operator = st.affine_operator()
        self.rhs = AffineOp((DenseOp(st.rhs().reshape(-1, 1), device=self.device,
                                     dtype=self.dtype),), (ONE,))
        self.mass = MassStencilOp(fom, mesh, axis)
        self.u0 = self._local(fom.u0).reshape(-1)
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
        """The (1, 1, n) output row, its slab's columns on a mesh."""
        if self._output_functional is _UNBUILT:
            of = _mean_value_output(self._fom)
            if of is not None and self.row_offset is not None:
                from rla4mor_tpu_torch.core.affine import AffineDense

                cols = of.stack[..., self.row_offset:self.row_offset + self.local_dim]
                of = AffineDense(cols.contiguous(), of.coefficients)
            self._output_functional = of
        return self._output_functional

    def solve(self, mu) -> torch.Tensor:
        return self._fom.solve_flat(mu, **self._solve_kw)

    def solve_many(self, mus) -> torch.Tensor:
        return torch.stack([self.solve(mu) for mu in mus], dim=0)


__all__ = ["InstationaryStencilFOM", "MassStencilOp"]
