"""Goal-oriented parabolic MOR: discrete-adjoint corrected outputs.

Counterpart of ``rla4mor_tpu/models/instationary_primal_dual.py``. For the
theta-scheme recursion (S = M + theta dt A, C = M - (1 - theta) dt A)

    S u_k = C u_{k-1} + dt b,   k = 1..K,

and the final-time output s(mu) = l(mu)^H u_K, the discrete adjoint runs
backward,

    S^H z_K = l,   S^H z_k = C^H z_{k+1}   (k = K-1..1),

and summation by parts gives s - s_r = sum_k z_k^H r_k exactly, with
r_k = C u_{r,k-1} + dt b - S u_{r,k} (u0 in the reduced space). With z
replaced by its reduced approximation Z zeta, the dual-corrected output

    s_c = s_r + sum_k zeta_k^H (Z^H M V (a_{k-1} - a_k) - dt Z^H A V a_th,k
                                + dt Z^H b)

has s - s_c = sum_k (z_k - Z zeta_k)^H r_k: a product of the dual and primal
errors. Both factors are estimated by the sketched space-time residuals,
giving the indicator eta_s = eta_pr eta_du. ``output_kind='integral'`` is
the right-endpoint quadrature s = dt sum_k l^H u_k (its adjoint has the
source dt l at every backward step).

Online, ``output_corrected`` runs the primal loop, the backward dual loop
(one LU of the reduced S^H) and the correction sum, for one Mu or a batched
one, as the primal ROM does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from rla4mor_tpu_torch.core.affine import AffineDense, as_affine, materialize
from rla4mor_tpu_torch.core.linops import to_numpy
from rla4mor_tpu_torch.core.orthonormalize import pod
from rla4mor_tpu_torch.core.parameters import Mu, conj_coefficient, mu_stack
from rla4mor_tpu_torch.models.instationary import (
    InstationaryReductor,
    InstationaryROM,
    _mv,
    append_basis,
    pad_time_system,
    project_out,
    sketch_block,
)
from rla4mor_tpu_torch.utils.config import as_tensor
from rla4mor_tpu_torch.utils.logger import get_logger


def _check_output_kind(kind: str) -> None:
    if kind not in ("final", "integral"):
        raise ValueError(f"output_kind must be 'final' or 'integral': {kind!r}")


def _output_terms(fom) -> AffineDense:
    """The output functional as an affine stack of column vectors l_t
    (s = l(mu)^H u, l(mu) = sum_t conj(theta_t) l_t), a single output."""
    of = fom.output_functional
    if of is None:
        raise ValueError("goal-oriented reduction needs output_functional")
    ofd = materialize(as_affine(of))
    if ofd.range_dim != 1:
        raise ValueError("dual correction supports single outputs")
    return ofd.H  # (To, n, 1), conjugated coefficients


def solve_dual(fom, mu: Mu, output_kind: str = "final") -> torch.Tensor:
    """(n, nt) exact discrete-adjoint trajectory z_1 .. z_K on the FOM's
    device; one host factorisation of S^H a parameter.

    ``'final'``: the adjoint of s = l^H u_K (S^H z_K = l, homogeneous
    backward recursion); ``'integral'``: of s = dt sum_k l^H u_k
    (S^H z_K = dt l; S^H z_k = C^H z_{k+1} + dt l)."""
    _check_output_kind(output_kind)
    S, C, _ = fom._theta_matrices(mu)
    l = to_numpy(_output_terms(fom).assemble_vec(mu))
    dt_num = np.promote_types(S.dtype, l.dtype)
    lu = spla.splu(sps.csc_matrix(S.conj().T, dtype=dt_num), permc_spec="MMD_AT_PLUS_A")
    l = l.astype(dt_num)
    CH = sps.csc_matrix(C.conj().T)
    integral = output_kind == "integral"
    dt = fom.dt
    z = lu.solve(dt * l if integral else l)
    out = [z]
    for _ in range(fom.nt - 1):
        rhs = np.asarray(CH @ z)
        if integral:
            rhs = rhs + dt * l
        z = lu.solve(rhs)
        out.append(z)
    out.reverse()  # forward order z_1 .. z_K
    return as_tensor(np.stack(out, axis=1), fom.device, fom.dtype)


class InstationaryCorrectedOutputROM:
    """Primal :class:`InstationaryROM`, the reduced discrete adjoint, the
    correction projections and the sketched dual-residual pieces."""

    def __init__(self, rom_pr: InstationaryROM, mass_zz, lhs_zz: AffineDense,
                 l_z: AffineDense, rhs_z: AffineDense, mass_zv, op_zv: AffineDense,
                 est_mass_z=None, est_lhs_z=None, est_l=None, output_kind: str = "final"):
        _check_output_kind(output_kind)
        self.output_kind = output_kind
        self.rom_pr = rom_pr
        self.mass_zz = mass_zz        # (rz, rz)      Z^H M Z
        self.lhs_zz = lhs_zz          # (T, rz, rz)   Z^H A_t^H Z, conjugated thetas
        self.l_z = l_z                # (To, rz, 1)   Z^H l_t
        self.rhs_z = rhs_z            # (Tb, rz, 1)   Z^H b_t
        self.mass_zv = mass_zv        # (rz, rv)      Z^H M V
        self.op_zv = op_zv            # (T, rz, rv)   Z^H A_t V
        self.est_mass_z = est_mass_z  # (k, rz)       Theta R^-1 M Z
        self.est_lhs_z = est_lhs_z    # (T, k, rz)    Theta R^-1 A_t^H Z
        self.est_l = est_l            # (To, k, 1)    Theta R^-1 l_t

    def _plain_from_traj(self, traj, mu) -> torch.Tensor:
        outs = self.rom_pr.output(traj, mu)[..., 0, :]
        if self.output_kind == "integral":
            return self.rom_pr.dt * outs[..., 1:].sum(dim=-1)
        return outs[..., -1]

    def output_plain(self, mu: Mu) -> torch.Tensor:
        return self._plain_from_traj(self.rom_pr.solve(mu), mu)

    def solve_dual_reduced(self, mu: Mu):
        """(zeta (rz, nt) in forward order, or (B, rz, nt); eta_du)."""
        rom = self.rom_pr
        th, dt, K = rom.time_theta, rom.dt, rom.nt
        Azz = self.lhs_zz.assemble(mu)
        l_r = self.l_z.assemble_vec(mu)
        cdt = torch.promote_types(torch.promote_types(Azz.dtype, l_r.dtype),
                                  self.mass_zz.dtype)
        Azz, l_r, Mzz = Azz.to(cdt), l_r.to(cdt), self.mass_zz.to(cdt)
        Szz = Mzz + th * dt * Azz  # already Z^H S^H Z (adjoint terms, conj thetas)
        Czz = Mzz - (1.0 - th) * dt * Azz
        integral = self.output_kind == "integral"
        LU, piv = torch.linalg.lu_factor(Szz)

        def solve(rhs):
            return torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]

        zeta_K = solve(dt * l_r if integral else l_r)
        estimating = self.est_mass_z is not None
        acc = torch.zeros(l_r.shape[:-1], dtype=zeta_K.real.dtype, device=zeta_K.device)
        if estimating:
            skM = self.est_mass_z
            skA = self.est_lhs_z.assemble(mu)
            skl = self.est_l.assemble_vec(mu)
            # terminal residual, 1/dt-scaled: l - S^H Z zeta_K (final),
            # dt l - S^H Z zeta_K (integral)
            lK = skl if integral else skl / dt
            rho = lK - _mv(skM, zeta_K) / dt - th * _mv(skA, zeta_K)
            acc = acc + (rho.abs() ** 2).sum(dim=-1)
        zetas = [zeta_K]
        zeta_next = zeta_K
        for _ in range(K - 1):
            rhs = _mv(Czz, zeta_next)
            if integral:
                rhs = rhs + dt * l_r
            zeta = solve(rhs)
            if estimating:
                rho = (_mv(skM, zeta_next - zeta) / dt
                       - _mv(skA, th * zeta + (1.0 - th) * zeta_next))
                if integral:
                    rho = rho + skl
                acc = acc + (rho.abs() ** 2).sum(dim=-1)
            zetas.append(zeta)
            zeta_next = zeta
        zetas.reverse()
        return torch.stack(zetas, dim=-1), torch.sqrt(dt * acc)

    def output_corrected(self, mu: Mu):
        """(s_c, eta_s): the discrete-adjoint corrected output (final-time or
        time-integrated, per ``output_kind``) and the residual-product
        indicator; () each for one Mu, (B,) for a batch."""
        rom = self.rom_pr
        th, dt = rom.time_theta, rom.dt
        traj, eta_pr = rom.solve(mu, return_estimate=True)   # (..., rv, K+1)
        s = self._plain_from_traj(traj, mu)
        zetas, eta_du = self.solve_dual_reduced(mu)          # (..., rz, K)
        a_prev, a_cur = traj[..., :-1], traj[..., 1:]
        Ozv = self.op_zv.assemble(mu)                         # (..., rz, rv)
        bz = self.rhs_z.assemble_vec(mu)                      # (..., rz)
        cdt = torch.promote_types(torch.promote_types(traj.dtype, Ozv.dtype), bz.dtype)
        a_th = th * a_cur + (1.0 - th) * a_prev
        resid = (self.mass_zv.to(cdt) @ (a_prev - a_cur).to(cdt)
                 - dt * (Ozv.to(cdt) @ a_th.to(cdt)) + dt * bz.to(cdt)[..., None])
        corr = (zetas.conj() * resid).sum(dim=(-2, -1))
        return s + corr, eta_pr * eta_du


class InstationaryPrimalDualReductor:
    """A primal :class:`InstationaryReductor` and a dual reduced basis for the
    discrete adjoint, emitting :class:`InstationaryCorrectedOutputROM`.

    ``extend(mu)`` solves both trajectories at mu and appends the leading POD
    modes of each R-orthogonal projection-error trajectory;
    ``extend_primal`` / ``extend_dual`` append given columns. Without
    ``embedding_dual`` the dual embedding is the primal one at seed + 77."""

    def __init__(self, fom, embedding=None, embedding_dual=None, product=None,
                 output_kind: str = "final", log_level: int = 20):
        _check_output_kind(output_kind)
        self.output_kind = output_kind
        self.fom = fom
        self.lterms = _output_terms(fom)  # validates a single output
        self.primal = InstationaryReductor(fom, embedding=embedding, product=product,
                                           log_level=log_level)
        self.product = self.primal.product
        if embedding_dual is None and embedding is not None:
            embedding_dual = embedding.with_seed(embedding.seed + 77)
        self.embedding_dual = embedding_dual
        self.rb_dual = torch.zeros((fom.solution_dim, 0), dtype=fom.dtype,
                                   device=fom.device)
        self.logger = get_logger("mor.instationary_pd", log_level)

    @property
    def dual_basis_size(self) -> int:
        return self.rb_dual.shape[1]

    def extend_primal(self, U) -> None:
        self.primal.extend_basis(U)

    def extend_dual(self, Z) -> None:
        self.rb_dual = append_basis(self.rb_dual, Z, self.product)

    def project_dual_trajectory(self, ztraj) -> torch.Tensor:
        return project_out(self.rb_dual, ztraj, self.product)

    def extend(self, mu: Mu, modes_per_extension: int = 1) -> None:
        err_p = self.primal.project_trajectory(self.fom.solve(mu))
        modes_p, _ = pod(err_p, product=self.product, modes=modes_per_extension)
        if modes_p.shape[1]:
            self.extend_primal(modes_p)
        ztraj = solve_dual(self.fom, mu, output_kind=self.output_kind)
        modes_z, _ = pod(self.project_dual_trajectory(ztraj), product=self.product,
                         modes=modes_per_extension)
        if modes_z.shape[1]:
            self.extend_dual(modes_z)

    def reduce(self, pad_to=None, pad_dual_to=None) -> InstationaryCorrectedOutputROM:
        """Emit the corrected-output ROM. ``pad_to`` / ``pad_dual_to`` fix the
        primal / dual shapes: the dead primal columns of the correction
        projections are zero, and the dead dual block gets an identity mass
        diagonal and zero couplings, so zeta is zero there and the corrected
        output and indicator equal the live-size ROM's."""
        fom = self.fom
        V, Z = self.primal.rb, self.rb_dual
        rom_pr = self.primal.reduce(pad_to=pad_to)
        Zh = Z.conj().T
        MZ = torch.as_tensor(fom.mass.apply(Z)).to(Z)
        mass_zz = Zh @ MZ
        AtZ = [torch.as_tensor(t.apply(Z)).to(Z) for t in fom.operator.terms]
        conj_coeffs = tuple(conj_coefficient(c) for c in fom.operator.coefficients)
        # Z^H A_t^H Z = (A_t Z)^H Z; the conjugated thetas make it Z^H A(mu)^H Z
        lhs_zz = AffineDense(torch.stack([a.conj().T @ Z for a in AtZ]), conj_coeffs)
        lstack = self.lterms.stack.to(Z.device)
        cdt = torch.promote_types(lstack.dtype, Z.dtype)
        l_z = AffineDense(torch.einsum("nr,tnl->trl", Z.conj().to(cdt), lstack.to(cdt)),
                          self.lterms.coefficients)
        rhs_mat = fom.rhs if isinstance(fom.rhs, AffineDense) else materialize(fom.rhs)
        rstack = rhs_mat.stack.to(Z.device)
        cdt = torch.promote_types(rstack.dtype, Z.dtype)
        rhs_z = AffineDense(torch.einsum("nr,tnl->trl", Z.conj().to(cdt), rstack.to(cdt)),
                            rhs_mat.coefficients)
        mass_zv = Zh @ torch.as_tensor(fom.mass.apply(V)).to(Z)
        op_zv = AffineDense(torch.stack([Zh @ torch.as_tensor(t.apply(V)).to(Z)
                                         for t in fom.operator.terms]),
                            fom.operator.coefficients)

        est_mass_z = est_lhs_z = est_l = None
        if self.embedding_dual is not None:
            T = len(AtZ)
            AhZ = [torch.as_tensor(t.apply_adjoint(Z)).to(Z) for t in fom.operator.terms]
            parts = sketch_block(self.embedding_dual, self.product, [MZ, *AhZ, *lstack])
            est_mass_z = parts[0]
            est_lhs_z = AffineDense(torch.stack(parts[1:1 + T]), conj_coeffs)
            est_l = AffineDense(torch.stack(parts[1 + T:]), self.lterms.coefficients)

        F = torch.nn.functional
        if pad_to is not None:  # zero dead-primal columns
            p = int(pad_to) - V.shape[1]
            if p < 0:
                raise ValueError(f"pad_to={pad_to} is smaller than the primal basis")
            mass_zv = F.pad(mass_zv, (0, p))
            op_zv = AffineDense(F.pad(op_zv.stack, (0, p)), op_zv.coefficients)
        if pad_dual_to is not None:
            rz = Z.shape[1]
            q = int(pad_dual_to) - rz
            if q < 0:
                raise ValueError(f"pad_dual_to={pad_dual_to} is smaller than the dual basis")
            # the dual block padded as the primal one (identity dead mass)
            mass_zz, lhs_zz, l_z, est_mass_z, est_lhs_z, _ = pad_time_system(
                pad_dual_to, rz, mass_zz, lhs_zz, l_z, est_mass_z, est_lhs_z, None)
            rhs_z = AffineDense(F.pad(rhs_z.stack, (0, 0, 0, q)), rhs_z.coefficients)
            mass_zv = F.pad(mass_zv, (0, 0, 0, q))
            op_zv = AffineDense(F.pad(op_zv.stack, (0, 0, 0, q)), op_zv.coefficients)
        return InstationaryCorrectedOutputROM(
            rom_pr, mass_zz, lhs_zz, l_z, rhs_z, mass_zv, op_zv, est_mass_z=est_mass_z,
            est_lhs_z=est_lhs_z, est_l=est_l, output_kind=self.output_kind)


def output_pod_greedy(fom, reductor: InstationaryPrimalDualReductor, training_set,
                      max_extensions: int = 10, modes_per_extension: int = 1,
                      atol: float = 0.0, rtol: float = 0.0, pad_to: Optional[int] = None,
                      log_level: int = 20):
    """Goal-oriented POD-greedy: extend the primal and the dual bases at the
    worst output indicator eta_s = eta_pr eta_du (one batched
    ``output_corrected`` over the training set a sweep). Returns
    ``(rom, history)``; ``pad_to`` pads both bases' quantities to one shape
    for the whole run (the final ROM comes back at its live size)."""
    if reductor.primal.embedding is None or reductor.embedding_dual is None:
        raise ValueError(
            "output_pod_greedy drives the greedy by eta_s = eta_pr * eta_du: the "
            "reductor needs primal and dual embeddings (with embedding=None every "
            "indicator is exactly 0 and the greedy would stop after one extension)")
    if pad_to is not None and pad_to < max_extensions * modes_per_extension:
        raise ValueError(f"pad_to={pad_to} must hold the full final basis")
    logger = get_logger("mor.output_pod_greedy", log_level)
    history = {"selected_mus": [], "max_indicators": []}
    mus_batched = mu_stack(list(training_set))

    mu0 = training_set[0]
    reductor.extend(mu0, modes_per_extension=modes_per_extension)
    history["selected_mus"].append(mu0)
    first_max = None
    rom = reductor.reduce(pad_to=pad_to, pad_dual_to=pad_to)
    for it in range(1, max_extensions):
        etas = to_numpy(rom.output_corrected(mus_batched)[1])
        imax = int(np.argmax(etas))
        emax = float(etas[imax])
        history["max_indicators"].append(emax)
        if first_max is None:
            first_max = emax
        logger.info("output-pod-greedy it=%d basis=%d/%d max_eta_s=%.3e", it,
                    reductor.primal.basis_size, reductor.dual_basis_size, emax)
        if emax <= atol or (rtol and emax <= rtol * first_max):
            break
        mu = training_set[imax]
        reductor.extend(mu, modes_per_extension=modes_per_extension)
        history["selected_mus"].append(mu)
        rom = reductor.reduce(pad_to=pad_to, pad_dual_to=pad_to)
    if pad_to is not None:
        rom = reductor.reduce()  # the live-size ROM
    return rom, history
