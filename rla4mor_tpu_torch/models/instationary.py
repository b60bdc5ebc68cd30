"""Instationary (parabolic) parametric models and their reduction.

Counterpart of ``rla4mor_tpu/models/instationary.py``:

    M du/dt + A(mu) u = b(mu),  u(0) = u0,  on (0, T] with nt theta steps.

* :class:`InstationaryFOM` — one host SuperLU factorisation of
  M + theta dt A(mu) a parameter and nt back-substitutions (as
  ``StationaryFOM.solve``); the trajectory goes to ``device``;
* :class:`InstationaryROM` — dense reduced mass / stiffness on a device.
  The JAX package runs the time loop as one ``lax.scan`` per parameter and
  vmaps it; here it is a Python loop over time steps, batched over a
  leading parameter dimension: S = M_r + theta dt A_r(mu) is LU-factored
  once for the whole batch, and each step is one batched ``lu_solve``. The
  sketched space-time residual accumulator
  eta = sqrt(dt sum_k ||Theta R^-1 r_k||^2) runs in the same loop;
* :class:`InstationaryReductor` — Galerkin reduction with that estimator.
  Each ``reduce`` sketches the whole block [M V | A_1 V ... A_q V | b] in
  one ``embedding.apply`` (the same linear map column by column as the JAX
  package's one sketch a term);
* :func:`pod_greedy` — POD-greedy over the sketched estimate (or the
  certified bound with ``coercivity=``); each sweep is one batched ROM
  solve over the whole training set.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from rla4mor_tpu_torch.core.affine import AffineDense, AffineOp, materialize
from rla4mor_tpu_torch.core.linops import HostSparseOp, to_numpy
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt
from rla4mor_tpu_torch.core.parameters import Mu, ParameterSpace, eval_coefficients, mu_stack
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.core.solvers import group_sum
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device, sync
from rla4mor_tpu_torch.utils.logger import get_logger


def _check_theta(time_theta: float) -> float:
    if not 0.0 < time_theta <= 1.0:
        raise ValueError(f"time_theta must lie in (0, 1], got {time_theta} (explicit "
                         "Euler would need a mass solve and a CFL bound)")
    return float(time_theta)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A x: (..., k, r) with (..., r) -> (..., k), in the promoted
    dtype (a real sketch of a complex state stays complex)."""
    dt = torch.promote_types(A.dtype, x.dtype)
    return (A.to(dt) @ x.to(dt)[..., None])[..., 0]


class InstationaryFOM:
    """Theta-scheme parabolic FOM with affine A(mu), b(mu) and a fixed host
    sparse mass M.

    ``time_theta=1`` (default) is implicit Euler, ``0.5`` Crank-Nicolson;
    any theta in (0, 1]. Trajectories are solved on the host in float64 (or
    complex128) and returned on ``device`` in ``dtype``."""

    def __init__(self, operator: AffineOp, rhs, mass: HostSparseOp, T: float = 1.0,
                 nt: int = 50, u0=None, output_functional=None, products=None,
                 parameter_space: Optional[ParameterSpace] = None,
                 time_theta: float = 1.0, name: str = "instationary_fom",
                 device=None, dtype=None):
        self.time_theta = _check_theta(time_theta)
        self.operator = operator
        self.rhs = rhs
        self.mass = mass
        self.T = float(T)
        self.nt = int(nt)
        self.dt = self.T / self.nt
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        n = operator.source_dim
        self.solution_dim = n
        self.u0 = (torch.zeros(n, dtype=self.dtype, device=self.device) if u0 is None
                   else as_tensor(u0, self.device, self.dtype))
        self.output_functional = output_functional
        self.products = products or {}
        self.parameter_space = parameter_space
        self.name = name

    def assemble_sparse(self, mu: Mu) -> sps.csc_matrix:
        """Host sparse A(mu) (the ``StationaryFOM`` protocol name, which the
        coercivity bounds read)."""
        theta = eval_coefficients(self.operator.coefficients, mu, device="cpu").numpy()
        out = None
        for t, term in enumerate(self.operator.terms):
            m = theta[t] * term.S
            out = m if out is None else out + m
        return out.tocsc()

    def assemble_rhs(self, mu: Mu) -> np.ndarray:
        if isinstance(self.rhs, AffineDense):
            return to_numpy(self.rhs.assemble_vec(mu))
        return self.rhs.assemble_dense(mu)[:, 0]

    def _theta_matrices(self, mu: Mu):
        """(S = M + theta dt A, C = M - (1 - theta) dt A, b) on the host in
        the promoted float64 / complex128 dtype."""
        A = self.assemble_sparse(mu)
        M = sps.csc_matrix(self.mass.S)
        b = np.asarray(self.assemble_rhs(mu))
        dt_num = np.promote_types(np.promote_types(A.dtype, b.dtype), np.float64)
        th = self.time_theta
        S = sps.csc_matrix(M + th * self.dt * A, dtype=dt_num)
        C = sps.csc_matrix(M - (1.0 - th) * self.dt * A, dtype=dt_num)
        return S, C, b.astype(dt_num)

    def solve_host(self, mu: Mu) -> np.ndarray:
        """(n, nt+1) host trajectory: (M + theta dt A) u_{k+1} =
        (M - (1 - theta) dt A) u_k + dt b, one factorisation a parameter."""
        S, C, b = self._theta_matrices(mu)
        lu = spla.splu(S, permc_spec="MMD_AT_PLUS_A")
        u = to_numpy(self.u0).astype(b.dtype)
        out = [u]
        for _ in range(self.nt):
            u = lu.solve(np.asarray(C @ u) + self.dt * b)
            out.append(u)
        return np.stack(out, axis=1)

    def solve(self, mu: Mu) -> torch.Tensor:
        return as_tensor(self.solve_host(mu), self.device, self.dtype)

    def solve_many(self, mus) -> torch.Tensor:
        return torch.stack([self.solve(mu) for mu in mus], dim=0)  # (m, n, nt+1)


class InstationaryROM:
    """Dense reduced parabolic model: trajectory and sketched space-time
    residual estimate in one time loop, for one Mu or a batched one."""

    def __init__(self, mass_r, lhs: AffineDense, rhs_r: AffineDense, u0_r, dt: float,
                 nt: int, est_mass=None, est_lhs: Optional[AffineDense] = None,
                 est_rhs: Optional[AffineDense] = None,
                 output_functional: Optional[AffineDense] = None,
                 time_theta: float = 1.0):
        self.time_theta = float(time_theta)
        self.mass_r = mass_r          # (r, r)
        self.lhs = lhs                # (T, r, r)
        self.rhs_r = rhs_r            # (Tb, r, 1)
        self.u0_r = u0_r              # (r,)
        self.dt = float(dt)
        self.nt = int(nt)
        self.est_mass = est_mass      # (k, r)    Theta R^-1 M V
        self.est_lhs = est_lhs        # (T, k, r) Theta R^-1 A_t V
        self.est_rhs = est_rhs        # (Tb, k, 1) Theta R^-1 b_l
        self.output_functional = output_functional

    @property
    def dim(self) -> int:
        return self.mass_r.shape[0]

    def solve(self, mu: Mu, return_estimate: bool = False):
        """(r, nt+1) trajectory for one Mu, (B, r, nt+1) for a batched one;
        with ``return_estimate`` also eta = sqrt(dt sum_k ||sketched r_k||^2),
        () or (B,)."""
        A = self.lhs.assemble(mu)
        b = self.rhs_r.assemble_vec(mu)
        dt = torch.promote_types(torch.promote_types(A.dtype, b.dtype), self.mass_r.dtype)
        A, b, M = A.to(dt), b.to(dt), self.mass_r.to(dt)
        th, h = self.time_theta, self.dt
        S = M + th * h * A
        C = M - (1.0 - th) * h * A
        # S is the same at every step: one LU for the whole loop (and batch)
        LU, piv = torch.linalg.lu_factor(S)
        u = self.u0_r.to(dt).expand(b.shape).clone()
        estimating = return_estimate and self.est_lhs is not None
        if estimating:
            sA = self.est_lhs.assemble(mu)
            sb = self.est_rhs.assemble_vec(mu)
            acc = torch.zeros(b.shape[:-1], dtype=u.real.dtype, device=u.device)
        traj = [u]
        for _ in range(self.nt):
            u_new = torch.linalg.lu_solve(LU, piv, (_mv(C, u) + h * b)[..., None])[..., 0]
            if estimating:
                u_th = th * u_new + (1.0 - th) * u
                r = _mv(self.est_mass, u_new - u) / h + _mv(sA, u_th) - sb
                acc = acc + (r.abs() ** 2).sum(dim=-1)
            u = u_new
            traj.append(u)
        traj = torch.stack(traj, dim=-1)
        if not return_estimate:
            return traj
        if not estimating:  # no embedding: the JAX package's zero estimate
            return traj, torch.zeros(b.shape[:-1], dtype=u.real.dtype, device=u.device)
        return traj, torch.sqrt(h * acc)

    def estimate_error(self, mu: Mu) -> torch.Tensor:
        if self.est_lhs is None:
            raise ValueError(
                "this ROM was reduced without an embedding: the sketched space-time "
                "residual estimator is unavailable (construct "
                "InstationaryReductor(..., embedding=...) to enable it)")
        return self.solve(mu, return_estimate=True)[1]

    def output(self, U, mu: Mu) -> torch.Tensor:
        """Outputs (q, nt+1) of a trajectory, (B, q, nt+1) of a batch."""
        if self.output_functional is None:
            raise ValueError("this ROM has no output functional")
        return self.output_functional.apply(U, mu)


class InstationaryReductor:
    """Galerkin reduction of an instationary FOM with a sketched space-time
    residual estimator (Theta = ``embedding``, Riesz lift R^-1 =
    ``product.inv``).

    On a slab view (``InstationaryStencilFOM.as_reductor_fom(mesh=...)``:
    its ``group``, ``local_dim`` and ``row_offset``) the basis holds this
    rank's rows, every n-axis contraction is summed over the group, and the
    sketch goes through a sharded embedding (``ShardedSrhtEmbedding`` /
    ``ShardedGaussianEmbedding`` of the whole ``solution_dim``) at the
    rank's ``row_offset``; the reduced model is the same on every rank.
    ``product`` then acts on the rank's rows (the identity by default)."""

    def __init__(self, fom, embedding=None, product: Optional[Product] = None,
                 log_level: int = 20):
        self.fom = fom
        self.group = getattr(fom, "group", None)
        self.row_offset = getattr(fom, "row_offset", None)
        n = getattr(fom, "local_dim", fom.solution_dim)
        self.product = product if product is not None else Product.identity(n)
        self.embedding = embedding
        self.rb = torch.zeros((n, 0), dtype=fom.dtype, device=fom.device)
        self.reduce_calls = 0
        self.logger = get_logger("mor.instationary", log_level)

    @property
    def basis_size(self) -> int:
        return self.rb.shape[1]

    def extend_basis(self, U) -> None:
        """Append columns and R-orthonormalise them against the basis."""
        self.rb = append_basis(self.rb, U, self.product, self.group)

    def project_trajectory(self, traj) -> torch.Tensor:
        """R-orthogonal projection error of an (n, nt+1) trajectory."""
        return project_out(self.rb, traj, self.product, self.group)

    def reduce(self, pad_to: Optional[int] = None) -> InstationaryROM:
        """Emit the reduced model.

        ``pad_to=r_max`` pads every reduced quantity to r_max columns
        (identity on the dead mass diagonal, zeros elsewhere): the dead
        coordinates stay exactly zero, so the trajectory and estimate equal
        the unpadded ROM's, and every ROM of a greedy run has one shape."""
        self.reduce_calls += 1
        fom, V = self.fom, self.rb
        r = V.shape[1]
        mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs = project_time_system(
            fom, V, self.product, self.embedding, self.group, self.row_offset)
        Ru0 = torch.as_tensor(self.product.op.apply(fom.u0)).to(V)
        u0_r = group_sum(V.conj().T @ Ru0, self.group)
        out = None
        of = fom.output_functional
        if isinstance(of, AffineDense):
            stack = of.stack.to(torch.promote_types(of.stack.dtype, V.dtype))
            out = AffineDense(group_sum(torch.einsum("tqn,nr->tqr", stack,
                                                      V.to(stack.dtype)), self.group),
                              of.coefficients)
        if pad_to is not None:
            mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs = pad_time_system(
                pad_to, r, mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs)
            p = int(pad_to) - r
            u0_r = torch.nn.functional.pad(u0_r, (0, p))
            if out is not None:
                out = AffineDense(torch.nn.functional.pad(out.stack, (0, p)),
                                  out.coefficients)
        return InstationaryROM(mass_r, lhs, rhs_r, u0_r, fom.dt, fom.nt,
                               est_mass=est_mass, est_lhs=est_lhs, est_rhs=est_rhs,
                               output_functional=out,
                               time_theta=getattr(fom, "time_theta", 1.0))

    def reconstruct(self, traj_r) -> torch.Tensor:
        """V a: (n, nt+1) from (r, nt+1), (B, n, nt+1) from a batch."""
        a = torch.as_tensor(traj_r).to(self.rb.device)
        dt = torch.promote_types(self.rb.dtype, a.dtype)
        return self.rb.to(dt) @ a.to(dt)


def append_basis(rb: torch.Tensor, U, product: Product, group=None) -> torch.Tensor:
    """``rb`` (R-orthonormal columns) with the columns of U appended and
    R-orthonormalised against it (CGS-2); ``group``: the rows are a rank's."""
    U = torch.as_tensor(U).to(rb.device)
    if U.dim() == 1:
        U = U[:, None]
    dt = torch.promote_types(rb.dtype, U.dtype)
    return gram_schmidt(torch.cat([rb.to(dt), U.to(dt)], dim=1), product=product,
                        offset=rb.shape[1], group=group)


def project_out(V: torch.Tensor, X, product: Product, group=None) -> torch.Tensor:
    """X - V V^H R X: the R-orthogonal projection error of X's columns onto
    the R-orthonormal basis V (``group``: the rows are a rank's)."""
    X = torch.as_tensor(X)
    if V.shape[1] == 0:
        return X
    dt = torch.promote_types(V.dtype, X.dtype)
    RX = torch.as_tensor(product.op.apply(X)).to(X.device, dt)
    V = V.to(dt)
    return X.to(dt) - V @ group_sum(V.conj().T @ RX, group)


def sketch_block(embedding, product: Product, blocks: Sequence[torch.Tensor],
                 row_offset: Optional[int] = None):
    """Theta R^-1 of each column block in one ``embedding.apply`` of their
    concatenation (one kernel launch where the embedding has one) -> the
    sketched blocks, split as given. ``row_offset``: the blocks are a
    rank's rows from that global row, sketched by a sharded embedding
    (the whole sketch on every rank)."""
    dt = blocks[0].dtype
    for X in blocks[1:]:
        dt = torch.promote_types(dt, X.dtype)
    X = torch.cat([X.to(dt) for X in blocks], dim=1)
    X = torch.as_tensor(product.inv.apply(X))
    Y = torch.as_tensor(embedding.apply(X) if row_offset is None
                        else embedding.apply(X, row_offset=row_offset))
    return torch.split(Y, [X.shape[1] for X in blocks], dim=1)


def project_time_system(fom, V, product: Product, embedding, group=None,
                        row_offset: Optional[int] = None):
    """Galerkin and sketch projections: the reduced mass, stiffness and rhs,
    and the sketched residual images Theta R^-1 [M V | A_t V | b_t], one
    embedding apply for the whole block. Returns
    (mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs). ``group`` /
    ``row_offset``: V and the FOM's operators are a rank's rows (a slab
    view), the Galerkin products summed over the group in one reduction."""
    Vh = V.conj().T
    MV = torch.as_tensor(fom.mass.apply(V)).to(V.device)
    AV = [torch.as_tensor(t.apply(V)).to(V.device) for t in fom.operator.terms]
    rhs_mat = fom.rhs if isinstance(fom.rhs, AffineDense) else materialize(fom.rhs)
    rstack = rhs_mat.stack.to(V.device)
    dt = torch.promote_types(rstack.dtype, V.dtype)
    rhs_loc = torch.einsum("nr,tnl->trl", V.conj().to(dt), rstack.to(dt))
    gal = torch.stack([Vh @ MV.to(V.dtype)] + [Vh @ a.to(V.dtype) for a in AV])
    if group is not None:  # one reduction for the mass, the terms and the rhs
        flat = group_sum(torch.cat([gal.reshape(-1).to(dt), rhs_loc.reshape(-1)]), group)
        gal = flat[:gal.numel()].reshape(gal.shape).to(gal.dtype)
        rhs_loc = flat[gal.numel():].reshape(rhs_loc.shape)
    mass_r = gal[0].clone()
    lhs = AffineDense(gal[1:].clone(), fom.operator.coefficients)
    rhs_r = AffineDense(rhs_loc, rhs_mat.coefficients)
    est_mass = est_lhs = est_rhs = None
    if embedding is not None:
        T = len(AV)
        parts = sketch_block(embedding, product, [MV, *AV, *rstack], row_offset)
        est_mass = parts[0]
        est_lhs = AffineDense(torch.stack(parts[1:1 + T]), fom.operator.coefficients)
        est_rhs = AffineDense(torch.stack(parts[1 + T:]), rhs_mat.coefficients)
    return mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs


def pad_time_system(pad_to, r, mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs):
    """Dead-block padding to ``pad_to`` coordinates: identity on the dead
    mass diagonal, zeros everywhere else, so the dead coordinates stay zero
    through the time loop."""
    R = int(pad_to)
    if R < r:
        raise ValueError(f"pad_to={R} is smaller than the basis ({r})")
    p = R - r
    F = torch.nn.functional
    eye_dead = torch.diag(torch.cat([torch.zeros(r), torch.ones(p)])).to(mass_r)
    mass_r = F.pad(mass_r, (0, p, 0, p)) + eye_dead
    lhs = AffineDense(F.pad(lhs.stack, (0, p, 0, p)), lhs.coefficients)
    rhs_r = AffineDense(F.pad(rhs_r.stack, (0, 0, 0, p)), rhs_r.coefficients)
    if est_mass is not None:
        est_mass = F.pad(est_mass, (0, p))
        est_lhs = AffineDense(F.pad(est_lhs.stack, (0, p)), est_lhs.coefficients)
    return mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs


def _coercivity_table(coercivity, training_set) -> np.ndarray:
    """alpha_LB at every training parameter: a host ``tabulate`` (the SCM)
    or one call on the batched Mu."""
    if hasattr(coercivity, "tabulate"):
        alphas = coercivity.tabulate(list(training_set))
    else:
        alphas = coercivity(mu_stack(list(training_set)))
    alphas = np.asarray(to_numpy(torch.as_tensor(alphas)), dtype=np.float64)
    return np.broadcast_to(alphas, (len(training_set),))


def pod_greedy(fom, reductor: InstationaryReductor, training_set: Sequence[Mu],
               max_extensions: int = 10, modes_per_extension: int = 1, atol: float = 0.0,
               rtol: float = 0.0, pad_to: Optional[int] = None,
               pod_method: str = "snapshots", coercivity=None,
               log_level: int = 20, mesh=None) -> Tuple[InstationaryROM, dict]:
    """POD-greedy (Haasdonk / Ohlberger): greedy over mu by the sketched
    space-time residual estimate; each extension appends the leading POD
    mode(s) of the R-orthogonal projection-error trajectory at the worst mu.
    The sweep is one batched ROM solve over the training set.

    ``pad_to=r_max``: every ROM of the run is padded to r_max (one shape;
    the final ROM is handed back at its live size). ``pod_method``:
    ``"snapshots"`` (method of snapshots) or ``"randomized"``
    (``core.rsvd.pod_randomized``, no Gram matrix). ``coercivity``: a
    ``mu -> alpha_LB(mu)`` evaluated on the batched training Mu (e.g.
    ``mor.bounds.MinThetaCoercivity``) or an object with ``tabulate`` (an
    SCM) upgrades the scores to the certified final-time bounds
    eta / sqrt(alpha_LB) (needs ``time_theta >= 1/2``).

    ``mesh``: the counterpart of the JAX package's ``mu_sharding``: the
    sweep's training batch is split over the mesh's ``"mu"`` axis
    (``batch_share``: a multiple of it) and the estimates all-gathered, so
    every rank takes the same argmax. The trajectories and the basis are
    DoF-sharded by the reductor's slab view (``as_reductor_fom(mesh=...)``);
    every rank returns the same history.

    History: ``selected_mus``, ``max_estimates``, and the seconds of each
    FOM trajectory (``fom_s``) and of each extension (``extension_s``: the
    sweep before it, the trajectory, its POD, the append and the reduce)."""
    from rla4mor_tpu_torch.core.orthonormalize import pod as pod_snapshots
    from rla4mor_tpu_torch.core.rsvd import pod_randomized

    group = getattr(reductor, "group", None)  # a slab view's (the parabolic reductor)
    if pod_method == "snapshots":
        def pod(U, product, modes):
            return pod_snapshots(U, product=product, modes=modes, group=group)
    elif pod_method == "randomized":
        if group is not None:
            raise ValueError("pod_method='randomized' runs on one device; a slab view "
                             "takes 'snapshots'")
        def pod(U, product, modes):
            return pod_randomized(U, product=product, modes=modes, rtol=1e-7)
    else:
        raise ValueError(f"unknown pod_method {pod_method!r}")
    if reductor.embedding is None:
        raise ValueError("pod_greedy drives the greedy by the sketched space-time "
                         "residual estimate: InstationaryReductor needs an embedding")
    if pad_to is not None and pad_to < max_extensions * modes_per_extension:
        raise ValueError(f"pad_to={pad_to} must hold the full final basis")
    if coercivity is not None and fom.time_theta < 0.5:
        raise ValueError("certified POD-greedy (coercivity=...) needs time_theta >= 1/2 "
                         f"(got {fom.time_theta}); see mor.bounds.parabolic_error_bound")
    logger = get_logger("mor.pod_greedy", log_level)
    history = {"selected_mus": [], "max_estimates": [], "fom_s": [], "extension_s": []}
    device = reductor.rb.device
    mus_batched = mu_stack(list(training_set))
    sweep_batch, gather = mus_batched, (lambda est: est)
    if mesh is not None and "mu" in mesh.mesh_dim_names:
        from rla4mor_tpu_torch.parallel import mesh as pm

        share = pm.batch_share(len(training_set), mesh, "mu")
        sweep_batch = {key: v[share] for key, v in mus_batched.items()}
        gather = lambda est: pm.gather_batch(est, mesh, "mu")  # noqa: E731

    def extend(mu, t_start):
        t0 = time.perf_counter()
        traj = fom.solve(mu)
        sync(device)
        history["fom_s"].append(time.perf_counter() - t0)
        modes, _ = pod(reductor.project_trajectory(traj), reductor.product,
                       modes_per_extension)
        if modes.shape[1] == 0:
            return None
        reductor.extend_basis(modes)
        history["selected_mus"].append(mu)
        rom = reductor.reduce(pad_to=pad_to)
        sync(device)
        history["extension_s"].append(time.perf_counter() - t_start)
        return rom

    rom = extend(training_set[0], time.perf_counter())
    sqrt_alphas = None
    if coercivity is not None:
        alphas = _coercivity_table(coercivity, training_set)
        if not np.all(alphas > 0):
            # sqrt of a non-positive bound would flow NaN into the argmax
            bad = np.flatnonzero(~(alphas > 0))
            raise ValueError(
                f"certified pod_greedy: coercivity lower bound is not positive at "
                f"{bad.size} training parameter(s) (first index {int(bad[0])}, value "
                f"{float(alphas[bad[0]]):.3e}); tighten the SCM fit (more anchors) or "
                "drop coercivity= for indicator-only greedy")
        sqrt_alphas = np.sqrt(alphas)

    first_max = None
    for it in range(1, max_extensions):
        t_start = time.perf_counter()
        estimates = to_numpy(gather(rom.estimate_error(sweep_batch)))
        if sqrt_alphas is not None:
            estimates = estimates / sqrt_alphas
        imax = int(np.argmax(estimates))
        emax = float(estimates[imax])
        history["max_estimates"].append(emax)
        if first_max is None:
            first_max = emax
        logger.info("pod-greedy it=%d basis=%d max_est=%.3e", it, reductor.basis_size, emax)
        if emax <= atol or (rtol and emax <= rtol * first_max):
            break
        new = extend(training_set[imax], t_start)
        if new is None:
            logger.info("pod-greedy: projection error exhausted")
            break
        rom = new
    if pad_to is not None:
        rom = reductor.reduce()  # the live-size ROM
    return rom, history


def instationary_thermal_block(grid_shape=(2, 2), num_intervals: int = 16, T: float = 1.0,
                               nt: int = 50, parameter_range=(0.1, 1.0),
                               time_theta: float = 1.0, device=None,
                               dtype=None) -> InstationaryFOM:
    """Parabolic thermal block: the l2 mass and the stationary affine
    stiffness (heat equation with block-wise diffusion, f = 1, u0 = 0)."""
    from rla4mor_tpu_torch.models.thermal_block import ThermalBlockFOM

    st = ThermalBlockFOM(grid_shape, num_intervals, parameter_range, device=device,
                         dtype=dtype)
    return InstationaryFOM(
        operator=st.operator, rhs=st.rhs, mass=st.l2_product.op, T=T, nt=nt,
        output_functional=st.output_functional, products=st.products,
        parameter_space=st.parameter_space, time_theta=time_theta,
        name=st.name + "_parabolic", device=st.device, dtype=st.dtype)


__all__ = ["InstationaryFOM", "InstationaryROM", "InstationaryReductor", "pod_greedy",
           "project_time_system", "pad_time_system", "sketch_block", "append_basis",
           "project_out", "instationary_thermal_block"]
