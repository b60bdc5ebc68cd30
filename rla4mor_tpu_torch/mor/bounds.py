"""Coercivity and inf-sup lower bounds: residual estimates -> error bounds.

Counterpart of the stationary half of ``rla4mor_tpu/mor/bounds.py``:

* :class:`MinThetaCoercivity` — for parametrically coercive problems (SPD
  terms, positive coefficients) the min-theta bound
  alpha_LB(mu) = alpha(mu_ref) min_q theta_q(mu) / theta_q(mu_ref), and
  :func:`error_bound` = sketched residual / alpha_LB(mu);
* :class:`InfSupLowerBound` — the Weyl / Lipschitz inf-sup lower bound
  beta_LB(mu) = max_j [beta(mu_j) - sum_q |theta_q(mu) - theta_q(mu_j)|
  sigma_max(Q^-H A_q Q^-1)] for non-coercive families, and
  :func:`inf_sup_error_bound` = residual / beta_LB(mu), ``inf`` where the
  lower bound is not positive. :class:`~rla4mor_tpu_torch.mor.scm.ScmInfSup`
  has the same call surface.

The offline parts (one host ``eigsh`` of (sym A(mu_ref), R); dense SVDs of
Q^-H A Q^-1) run on the host in float64 as in the JAX package. The online
bounds are tensor expressions of the coefficients: one Mu or a batched Mu
(a leading dimension). The bounds hold up to the sketch's distortion, like
every sketched quantity.

The parabolic bounds (:func:`parabolic_error_bound`,
:func:`parabolic_output_error_bound`) certify the theta-scheme ROMs of
``models/instationary.py`` and ``models/instationary_primal_dual.py`` from
their sketched space-time residuals.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from rla4mor_tpu_torch.core.linops import to_numpy
from rla4mor_tpu_torch.core.parameters import Mu, eval_coefficients


def _operator(fom):
    return fom.operator if hasattr(fom, "operator") else fom.affine_operator()


def _host_dense(op) -> np.ndarray:
    """A host operator (sparse ``S`` or ``apply_host``) or tensor as a dense
    float64 / complex128 array."""
    if sps.issparse(op):
        return op.toarray()
    if hasattr(op, "S"):
        return op.S.toarray() if sps.issparse(op.S) else np.asarray(op.S)
    if hasattr(op, "apply_host"):
        return op.apply_host(np.eye(op.source_dim))
    return to_numpy(op.matrix() if hasattr(op, "matrix") else op)


def _theta(coefficients, mu: Mu) -> torch.Tensor:
    """Coefficient values (..., T) in float64 / complex128 on Mu's device."""
    th = eval_coefficients(coefficients, mu)
    return th.to(torch.complex128 if th.is_complex() else torch.float64)


class MinThetaCoercivity:
    """alpha_LB(mu) for a parametrically coercive affine operator.

    ``fom``: a FOM with host-sparse SPD terms and positive coefficients, or
    any FOM exposing ``affine_operator()``; ``mu_ref``: the reference
    parameter; ``product``: the R of the coercivity norm (default: the
    operator at mu_ref itself, so alpha_ref = 1); ``alpha_ref``: the
    coercivity of A(mu_ref) in the estimator's norm, given (then no
    ``product``)."""

    def __init__(self, fom, mu_ref: Mu, product=None, alpha_ref: float | None = None):
        self.coefficients = tuple(_operator(fom).coefficients)
        self.theta_ref = _theta(self.coefficients, mu_ref).cpu()
        if self.theta_ref.is_complex() or not bool((self.theta_ref > 0).all()):
            raise ValueError("min-theta needs positive real reference coefficients")
        if alpha_ref is not None:
            if product is not None:
                raise ValueError("pass either an explicit alpha_ref or a product to "
                                 "eigensolve against, not both")
            self.alpha_ref = float(alpha_ref)
        elif product is None:
            self.alpha_ref = 1.0
        else:
            A_ref = fom.assemble_sparse(mu_ref)
            R = sps.csc_matrix(product.op.S if hasattr(product.op, "S")
                               else _host_dense(product.op))
            # smallest generalized eigenvalue of (sym(A_ref), R)
            A_sym = 0.5 * (A_ref + A_ref.conj().T)
            w = spla.eigsh(A_sym, k=1, M=R, sigma=0, which="LM", return_eigenvectors=False)
            self.alpha_ref = float(w[0])
        if self.alpha_ref <= 0:
            raise ValueError("operator not coercive at mu_ref")

    def __call__(self, mu: Mu) -> torch.Tensor:
        """alpha_LB(mu) = alpha_ref min_q theta_q(mu) / theta_q(mu_ref): () for
        one Mu, (B,) for a batched one."""
        theta = _theta(self.coefficients, mu)
        if theta.is_complex():
            raise ValueError("min-theta needs real coefficients")
        return self.alpha_ref * (theta / self.theta_ref.to(theta.device)).amin(dim=-1)


def error_bound(rom, mu: Mu, coercivity, u_r=None) -> torch.Tensor:
    """R-norm error bound (up to the sketch's distortion): the sketched
    residual norm over alpha_LB(mu)."""
    if u_r is None:
        u_r = rom.solve(mu)
    est = rom.error_estimator.estimate_error(u_r, mu)
    return est / torch.as_tensor(coercivity(mu)).to(est)


def parabolic_error_bound(rom, mu: Mu, coercivity, kind: str = "final") -> torch.Tensor:
    """Certified (up to the sketch's distortion) bound for the theta-scheme
    parabolic ROM (Grepl / Patera 2005), any ``time_theta >= 1/2``.

    With M SPD, A(mu) R-coercive with lower bound alpha_LB(mu), zero initial
    error and eta(mu)^2 = dt sum_k ||r_k||_{R^-1}^2 (the ROM's
    ``estimate_error``, r_k at the theta-averaged state), the discrete energy
    estimate telescopes to
    ||e(T)||_M^2 + dt alpha sum_k ||e_th^k||_R^2 <= eta^2 / alpha, so

        kind='final'     : ||e(T)||_M                     <= eta / sqrt(alpha_LB)
        kind='spacetime' : sqrt(dt sum_k ||e_th^k||_R^2)  <= eta / alpha_LB.

    One Mu or a batched one. Pair it with a coercivity built on the same
    product R that the reductor's embedding sketches in."""
    if rom.time_theta < 0.5:
        raise ValueError(
            f"parabolic_error_bound needs time_theta >= 1/2 (got {rom.time_theta}): "
            "the discrete energy estimate telescopes only for A-stable theta schemes")
    if kind not in ("final", "spacetime"):
        raise ValueError(f"kind must be 'final' or 'spacetime': {kind!r}")
    eta = rom.estimate_error(mu)
    alpha = torch.as_tensor(coercivity(mu)).to(eta)
    return eta / torch.sqrt(alpha) if kind == "final" else eta / alpha


def parabolic_output_error_bound(rom, mu: Mu, coercivity):
    """Certified (up to the sketch's distortion) goal-oriented bound for the
    dual-corrected parabolic output of an ``InstationaryCorrectedOutputROM``:
    |s(mu) - s_c(mu)| <= eta_pr(mu) eta_du(mu) / alpha_LB(mu). Returns
    ``(s_c, bound)``.

    The correction is built on the exact discrete adjoint, so
    s - s_c = sum_k <r_pr^k, z^k - Z zeta^k>; Cauchy-Schwarz and the backward
    energy estimate (:func:`parabolic_error_bound`, kind='spacetime') bound
    it for implicit Euler, where the adjoint pairing states are the dual
    scheme's theta-averages. For 1/2 <= theta < 1 they are not, and the
    product is only an indicator: the function refuses."""
    if rom.rom_pr.time_theta != 1.0:
        raise ValueError(
            "parabolic_output_error_bound is rigorous for implicit Euler only "
            f"(time_theta == 1, got {rom.rom_pr.time_theta}): the adjoint pairing "
            "states coincide with the dual theta-averages only there; use "
            "output_corrected's indicator directly for other A-stable schemes")
    s_c, ind = rom.output_corrected(mu)
    return s_c, ind / torch.as_tensor(coercivity(mu)).to(ind)


class InfSupLowerBound:
    """Perturbation ("SCM-lite") inf-sup lower bound for non-coercive affine
    families (Helmholtz, advection-diffusion).

    With beta(mu) = sigma_min(B(mu)), B(mu) = Q^-H A(mu) Q^-1 (R = Q^H Q),
    Weyl's inequality gives for every reference parameter mu_j

        beta(mu) >= beta(mu_j) - sum_q |theta_q(mu) - theta_q(mu_j)| gamma_q,
        gamma_q = sigma_max(Q^-H A_q Q^-1),

    and beta_LB(mu) = max_j of these is a lower bound wherever it is
    positive. Offline: one dense sigma_min per reference and one dense
    sigma_max per term (host LAPACK, float64; use moderate dimensions or
    pass ``betas`` / ``gammas``)."""

    def __init__(self, fom, mu_refs, product=None, betas=None, gammas=None):
        op = _operator(fom)
        self.coefficients = tuple(op.coefficients)
        self.theta_refs = torch.stack([_theta(self.coefficients, mu).cpu()
                                       for mu in mu_refs])                 # (J, T)
        if betas is not None and gammas is not None:
            self.betas = torch.as_tensor(np.asarray(betas, np.float64))
            self.gammas = torch.as_tensor(np.asarray(gammas, np.float64))
            return

        Qd = None if product is None else _host_dense(product.sqrt)

        def weighted(Ad):
            if Qd is None:
                return Ad
            B = np.linalg.solve(Qd.conj().T, Ad)        # Q^-H A
            return np.linalg.solve(Qd.T, B.T).T         # (Q^-H A) Q^-1

        self.gammas = torch.as_tensor(np.array([
            np.linalg.svd(weighted(_host_dense(term)), compute_uv=False)[0]
            for term in op.terms]))
        self.betas = torch.as_tensor(np.array([
            np.linalg.svd(weighted(fom.assemble_sparse(mu).toarray()), compute_uv=False)[-1]
            for mu in mu_refs]))

    def __call__(self, mu: Mu) -> torch.Tensor:
        """beta_LB(mu): () for one Mu, (B,) for a batched one; may be <= 0
        far from every reference (:func:`inf_sup_error_bound` gives inf)."""
        theta = _theta(self.coefficients, mu)
        dev = theta.device
        diff = (theta[..., None, :] - self.theta_refs.to(dev)).abs()      # (..., J, T)
        cand = self.betas.to(dev) - diff.to(torch.float64) @ self.gammas.to(dev)
        return cand.amax(dim=-1)


def inf_sup_error_bound(rom, mu: Mu, infsup, u_r=None) -> torch.Tensor:
    """R-norm error bound (up to the sketch's distortion) for non-coercive
    problems: the residual norm over beta_LB(mu), ``inf`` where the lower
    bound is not positive (never mistaken for a good bound)."""
    if u_r is None:
        u_r = rom.solve(mu)
    est = rom.error_estimator.estimate_error(u_r, mu)
    beta = torch.as_tensor(infsup(mu)).to(device=est.device, dtype=torch.float64)
    bound = est.to(torch.float64) / beta.clamp(min=torch.finfo(torch.float64).tiny)
    return torch.where(beta > 0, bound, torch.full_like(bound, float("inf")))
