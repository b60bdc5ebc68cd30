"""Second-order-in-time (wave) parametric models and their reduction.

Counterpart of ``rla4mor_tpu/models/wave.py``:

    M u'' + A(mu) u = b(mu),   u(0) = u0, u'(0) = v0,

stepped by Newmark-beta (default beta = 1/4, gamma = 1/2: the average
acceleration scheme, implicit, unconditionally stable, second order).

* :class:`WaveFOM` — one host SuperLU factorisation of M + beta dt^2 A(mu)
  a parameter and nt back-substitutions, the mass LU cached per dtype (as
  ``InstationaryFOM``); the trajectory goes to ``device``;
* :class:`WaveROM` — dense reduced mass and stiffness on a device. The JAX
  package runs the Newmark loop as one ``lax.scan`` a parameter and vmaps
  it; here it is a Python loop over the steps, batched over a leading
  parameter dimension: one batched LU of M_r + beta dt^2 A_r(mu) for the
  whole loop, one batched ``lu_solve`` a step, and the sketched residual
  accumulator eta = sqrt(dt sum_k ||Theta R^-1 (M a_k + A u_k - b)||^2) in
  the same loop (an error indicator: wave bounds need energy arguments);
* :class:`WaveReductor` — Galerkin reduction with that indicator; each
  ``reduce`` sketches [M V | A_1 V ... A_q V | b] in one embedding apply
  (``project_time_system``). ``pod_greedy`` drives it unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from rla4mor_tpu_torch.core.affine import AffineDense, AffineOp
from rla4mor_tpu_torch.core.linops import HostSparseOp, to_numpy
from rla4mor_tpu_torch.core.parameters import Mu, ParameterSpace, eval_coefficients
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.instationary import (
    _mv,
    append_basis,
    pad_time_system,
    project_out,
    project_time_system,
)
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device
from rla4mor_tpu_torch.utils.logger import get_logger


def check_newmark(beta: float, gamma: float) -> tuple:
    if not (beta > 0 and 0.5 <= gamma <= 1.0):
        raise ValueError(f"Newmark needs beta > 0 and gamma in [1/2, 1], got "
                         f"beta={beta}, gamma={gamma}")
    return float(beta), float(gamma)


class WaveFOM:
    """Newmark-beta wave FOM with affine A(mu), b(mu) and a fixed host sparse
    mass M. Trajectories are solved on the host in float64 and returned on
    ``device`` in ``dtype``."""

    def __init__(self, operator: AffineOp, rhs, mass: HostSparseOp, T: float = 1.0,
                 nt: int = 100, u0=None, v0=None, beta: float = 0.25, gamma: float = 0.5,
                 output_functional=None, products=None,
                 parameter_space: Optional[ParameterSpace] = None, name: str = "wave_fom",
                 device=None, dtype=None):
        self.beta, self.gamma = check_newmark(beta, gamma)
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

        def init(x):
            return (torch.zeros(n, dtype=self.dtype, device=self.device) if x is None
                    else as_tensor(x, self.device, self.dtype))

        self.u0, self.v0 = init(u0), init(v0)
        self.output_functional = output_functional
        self.products = products or {}
        self.parameter_space = parameter_space
        self.name = name
        self._lu_M: dict = {}  # numpy dtype -> SuperLU of the fixed mass

    def assemble_sparse(self, mu: Mu) -> sps.csc_matrix:
        """Host sparse A(mu) (the name the coercivity bounds read)."""
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

    def solve_host(self, mu: Mu, return_velocity: bool = False):
        """(n, nt+1) host displacement trajectory (and velocity).

        Predictors u* = u + dt v + dt^2 (1/2 - beta) a, v* = v + dt (1 -
        gamma) a; accelerations from (M + beta dt^2 A) a+ = b - A u*;
        correctors u+ = u* + beta dt^2 a+, v+ = v* + gamma dt a+. One
        factorisation a parameter; a0 from the mass: M a0 = b - A u0."""
        A = self.assemble_sparse(mu)
        M = sps.csc_matrix(self.mass.S)
        dt, beta, gamma = self.dt, self.beta, self.gamma
        b = np.asarray(self.assemble_rhs(mu))
        dtype = np.promote_types(np.promote_types(A.dtype, b.dtype), np.float64)
        b = b.astype(dtype)
        lu = spla.splu(sps.csc_matrix(M + beta * dt * dt * A, dtype=dtype),
                       permc_spec="MMD_AT_PLUS_A")
        lu_M = self._lu_M.get(dtype)
        if lu_M is None:  # M does not depend on mu: one factorisation a dtype
            lu_M = self._lu_M[dtype] = spla.splu(sps.csc_matrix(M, dtype=dtype),
                                                 permc_spec="MMD_AT_PLUS_A")
        u = to_numpy(self.u0).astype(dtype)
        v = to_numpy(self.v0).astype(dtype)
        a = lu_M.solve(b - np.asarray(A @ u))
        us, vs = [u], [v]
        for _ in range(self.nt):
            u_star = u + dt * v + dt * dt * (0.5 - beta) * a
            v_star = v + dt * (1.0 - gamma) * a
            a = lu.solve(b - np.asarray(A @ u_star))
            u = u_star + beta * dt * dt * a
            v = v_star + gamma * dt * a
            us.append(u)
            vs.append(v)
        traj = np.stack(us, axis=1)
        return (traj, np.stack(vs, axis=1)) if return_velocity else traj

    def solve(self, mu: Mu, return_velocity: bool = False):
        out = self.solve_host(mu, return_velocity)
        if return_velocity:
            return tuple(as_tensor(x, self.device, self.dtype) for x in out)
        return as_tensor(out, self.device, self.dtype)

    def solve_many(self, mus) -> torch.Tensor:
        return torch.stack([self.solve(mu) for mu in mus], dim=0)


class WaveROM:
    """Dense reduced Newmark model: trajectory and sketched space-time
    residual indicator in one time loop, for one Mu or a batched one."""

    def __init__(self, mass_r, lhs: AffineDense, rhs_r: AffineDense, u0_r, v0_r, dt: float,
                 nt: int, beta: float, gamma: float, est_mass=None,
                 est_lhs: Optional[AffineDense] = None,
                 est_rhs: Optional[AffineDense] = None,
                 output_functional: Optional[AffineDense] = None):
        self.mass_r = mass_r          # (r, r)
        self.lhs = lhs                # (T, r, r)
        self.rhs_r = rhs_r            # (Tb, r, 1)
        self.u0_r = u0_r
        self.v0_r = v0_r
        self.dt = float(dt)
        self.nt = int(nt)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.est_mass = est_mass      # (k, r)     Theta R^-1 M V
        self.est_lhs = est_lhs        # (T, k, r)  Theta R^-1 A_t V
        self.est_rhs = est_rhs        # (Tb, k, 1) Theta R^-1 b_l
        self.output_functional = output_functional

    @property
    def dim(self) -> int:
        return self.mass_r.shape[0]

    def solve(self, mu: Mu, return_estimate: bool = False,
              return_acceleration: bool = False):
        """(r, nt+1) displacement trajectory for one Mu, (B, r, nt+1) for a
        batched one; with ``return_estimate`` also the indicator eta, () or
        (B,); with ``return_acceleration`` also the reduced accelerations,
        shaped as the trajectory (a_0 first)."""
        A = self.lhs.assemble(mu)
        b = self.rhs_r.assemble_vec(mu)
        dt = torch.promote_types(torch.promote_types(A.dtype, b.dtype), self.mass_r.dtype)
        A, b, M = A.to(dt), b.to(dt), self.mass_r.to(dt)
        h, beta, gamma = self.dt, self.beta, self.gamma
        c = beta * h * h
        # the implicit matrix is the same at every step: one LU for the loop
        S_lu = torch.linalg.lu_factor(M + c * A)
        M_lu = torch.linalg.lu_factor(M)
        u = self.u0_r.to(dt).expand(b.shape).clone()
        v = self.v0_r.to(dt).expand(b.shape).clone()
        a = torch.linalg.lu_solve(*M_lu, (b - _mv(A, u))[..., None])[..., 0]
        estimating = return_estimate and self.est_lhs is not None
        if estimating:
            sA = self.est_lhs.assemble(mu)
            sb = self.est_rhs.assemble_vec(mu)
            acc = torch.zeros(b.shape[:-1], dtype=u.real.dtype, device=u.device)
        traj, accel = [u], [a]
        for _ in range(self.nt):
            u_star = u + h * v + h * h * (0.5 - beta) * a
            v_star = v + h * (1.0 - gamma) * a
            a = torch.linalg.lu_solve(*S_lu, (b - _mv(A, u_star))[..., None])[..., 0]
            u = u_star + c * a
            v = v_star + gamma * h * a
            if estimating:
                r = _mv(self.est_mass, a) + _mv(sA, u) - sb
                acc = acc + (r.abs() ** 2).sum(dim=-1)
            traj.append(u)
            accel.append(a)
        out = [torch.stack(traj, dim=-1)]
        if return_estimate:
            out.append(torch.sqrt(h * acc) if estimating else
                       torch.zeros(b.shape[:-1], dtype=u.real.dtype, device=u.device))
        if return_acceleration:
            out.append(torch.stack(accel, dim=-1))
        return out[0] if len(out) == 1 else tuple(out)

    def estimate_error(self, mu: Mu) -> torch.Tensor:
        if self.est_lhs is None:
            raise ValueError(
                "this ROM was reduced without an embedding: the sketched space-time "
                "residual indicator is unavailable")
        return self.solve(mu, return_estimate=True)[1]

    def output(self, U, mu: Mu) -> torch.Tensor:
        """Outputs (q, nt+1) of a trajectory, (B, q, nt+1) of a batch."""
        if self.output_functional is None:
            raise ValueError("this ROM has no output functional")
        return self.output_functional.apply(U, mu)


class WaveReductor:
    """Galerkin reduction of a wave FOM (the protocol of
    ``InstationaryReductor``: ``pod_greedy`` drives it unchanged)."""

    def __init__(self, fom, embedding=None, product: Optional[Product] = None,
                 log_level: int = 20):
        self.fom = fom
        n = fom.solution_dim
        self.product = product if product is not None else Product.identity(n)
        self.embedding = embedding
        self.rb = torch.zeros((n, 0), dtype=fom.dtype, device=fom.device)
        self.reduce_calls = 0
        self.logger = get_logger("mor.wave", log_level)

    @property
    def basis_size(self) -> int:
        return self.rb.shape[1]

    def extend_basis(self, U) -> None:
        """Append columns and R-orthonormalise them against the basis."""
        self.rb = append_basis(self.rb, U, self.product)

    def project_trajectory(self, traj) -> torch.Tensor:
        """R-orthogonal projection error of an (n, nt+1) trajectory."""
        return project_out(self.rb, traj, self.product)

    def reduce(self, pad_to: Optional[int] = None) -> WaveROM:
        """Emit the reduced model; ``pad_to`` gives the dead block identity
        mass and zero couplings, so the dead coordinates of u, v and a stay
        exactly zero and every ROM of a greedy run has one shape."""
        self.reduce_calls += 1
        fom, V = self.fom, self.rb
        r = V.shape[1]
        mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs = project_time_system(
            fom, V, self.product, self.embedding)
        Vh = V.conj().T
        u0_r = Vh @ torch.as_tensor(self.product.op.apply(fom.u0)).to(V)
        v0_r = Vh @ torch.as_tensor(self.product.op.apply(fom.v0)).to(V)
        out = None
        of = fom.output_functional
        if isinstance(of, AffineDense):
            stack = of.stack.to(torch.promote_types(of.stack.dtype, V.dtype))
            out = AffineDense(torch.einsum("tqn,nr->tqr", stack, V.to(stack.dtype)),
                              of.coefficients)
        if pad_to is not None:
            mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs = pad_time_system(
                pad_to, r, mass_r, lhs, rhs_r, est_mass, est_lhs, est_rhs)
            p = int(pad_to) - r
            F = torch.nn.functional
            u0_r, v0_r = F.pad(u0_r, (0, p)), F.pad(v0_r, (0, p))
            if out is not None:
                out = AffineDense(F.pad(out.stack, (0, p)), out.coefficients)
        return WaveROM(mass_r, lhs, rhs_r, u0_r, v0_r, fom.dt, fom.nt, fom.beta, fom.gamma,
                       est_mass=est_mass, est_lhs=est_lhs, est_rhs=est_rhs,
                       output_functional=out)

    def reconstruct(self, traj_r) -> torch.Tensor:
        """V a: (n, nt+1) from (r', nt+1) (a padded trajectory's first r
        rows), (B, n, nt+1) from a batch."""
        a = torch.as_tensor(traj_r).to(self.rb.device)[..., :self.basis_size, :]
        dt = torch.promote_types(self.rb.dtype, a.dtype)
        return self.rb.to(dt) @ a.to(dt)


def wave_thermal_block(grid_shape=(2, 2), num_intervals: int = 16, T: float = 1.0,
                       nt: int = 100, parameter_range=(0.1, 1.0), u0_bump: bool = True,
                       device=None, dtype=None) -> WaveFOM:
    """The wave equation on the thermal-block geometry: the l2 mass, the
    block-wise stiffness (a wave speed a block), f = 0 and, with ``u0_bump``,
    the displacement sin(pi x) sin(pi y) at rest: a standing wave whose
    solution manifold depends on the parameter."""
    from rla4mor_tpu_torch.core.parameters import ConstantCoefficient
    from rla4mor_tpu_torch.models.thermal_block import ThermalBlockFOM

    st = ThermalBlockFOM(grid_shape, num_intervals, parameter_range, device=device,
                         dtype=dtype)
    n = st.solution_dim
    u0 = None
    if u0_bump:
        x = np.arange(1, num_intervals) / num_intervals
        X, Y = np.meshgrid(x, x, indexing="xy")
        u0 = (np.sin(np.pi * X) * np.sin(np.pi * Y)).reshape(-1)
        assert u0.shape == (n,)
    zero_rhs = AffineDense(torch.zeros((1, n, 1), dtype=st.dtype, device=st.device),
                           (ConstantCoefficient(0.0),))
    return WaveFOM(operator=st.operator, rhs=zero_rhs, mass=st.l2_product.op, T=T, nt=nt,
                   u0=u0, output_functional=st.output_functional, products=st.products,
                   parameter_space=st.parameter_space,
                   name=f"wave_thermal_block_n{num_intervals}", device=st.device,
                   dtype=st.dtype)


__all__ = ["WaveFOM", "WaveROM", "WaveReductor", "wave_thermal_block"]
