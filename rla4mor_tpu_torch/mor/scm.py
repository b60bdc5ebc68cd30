"""Successive constraint method (SCM): LP-based coercivity and inf-sup
lower bounds.

Counterpart of ``rla4mor_tpu/mor/scm.py``. The SCM (Huynh, Rozza, Sen and
Patera, CRAS 345 (2007) 473-478) bounds

    alpha(mu) = lambda_min(sum_q c_q(mu) T_q, R)

(Hermitian T_q, real c_q, SPD R) by relaxing the Rayleigh-quotient set
{y_q = u^H T_q u / u^H R u} to the polytope of the per-term spectral box
prod_q [sigma_q^-, sigma_q^+] cut by the anchors' half-spaces
c(mu_j) . y >= alpha(mu_j): alpha_LB(mu) = min over the polytope of
c(mu) . y is a small LP (``scipy.optimize.linprog``, HiGHS, on the host;
torch has no LP), a lower bound for any anchor set, and alpha_UB(mu) =
min_j c(mu) . y*(mu_j) over the anchors' Rayleigh vectors an upper one.
``fit`` anchors the training parameter with the worst gap until the gaps
are below ``tol``.

Inf-sup constants reduce to this form by squaring (:class:`ScmInfSup`):
beta(mu)^2 = lambda_min(A^H R^-1 A, R), whose expansion over term pairs
has Hermitian matrices with real coefficients even for complex theta:

    conj(t_q) t_q' M + conj(t_q') t_q M^H
        = Re(conj(t_q) t_q') (M + M^H) + Im(conj(t_q) t_q') i (M - M^H),

M = A_q^H R^-1 A_q'.

The dense generalized eigenproblems are most of the cost (one per box
term and per anchor). They run on ``device`` in float64 / complex128,
whatever the run's dtype: the pencil (T, R) is reduced by the Cholesky
factor R = L L^H to L^-1 T L^-H, whose ``torch.linalg.eigh`` gives the
spectrum (scipy's ``eigh(T, R)`` makes the same reduction; torch has no
generalized or subset ``eigh``, so each call computes every eigenvalue).
Use moderate FOM dimensions: each is an n x n dense problem.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from scipy.optimize import linprog

from rla4mor_tpu_torch.core.parameters import Mu, eval_coefficients
from rla4mor_tpu_torch.mor.bounds import _host_dense
from rla4mor_tpu_torch.utils.config import resolve_device


def _dense(op) -> torch.Tensor:
    """A term (sparse matrix, host operator, array or tensor) as a dense
    float64 / complex128 tensor on the CPU."""
    if isinstance(op, torch.Tensor):
        return op.detach().cpu().to(torch.complex128 if op.is_complex() else torch.float64)
    arr = op if isinstance(op, np.ndarray) else _host_dense(op)
    return torch.as_tensor(np.asarray(arr, np.complex128 if np.iscomplexobj(arr)
                                      else np.float64))


def _product_dense(product, n: int) -> torch.Tensor:
    return (torch.eye(n, dtype=torch.float64) if product is None
            else _dense(product.op))


def _coefficients_host(coefficients, mu: Mu) -> np.ndarray:
    return eval_coefficients(coefficients, mu, device="cpu").numpy()


class ScmHermitian:
    """SCM for alpha(mu) = lambda_min(sum_q c_q(mu) T_q, R) with Hermitian
    ``terms`` T_q and a real coefficient map ``theta_fn`` (mu -> (T,)).

    The generic engine: :class:`ScmCoercivity` / :class:`ScmInfSup` build
    the (terms, theta_fn) pair from a FOM. ``R`` is the SPD metric (dense).
    The terms and R live on ``device`` (default the current CUDA device)."""

    def __init__(self, terms: Sequence, theta_fn: Callable[[Mu], np.ndarray], R,
                 device=None):
        self.device = resolve_device(device)
        dense = [_dense(T) for T in terms]
        dt = torch.complex128 if any(T.is_complex() for T in dense) else torch.float64
        self.terms = [T.to(self.device, dt) for T in dense]
        self.theta_fn = theta_fn
        self.R = _dense(R).to(self.device, dt)
        n = self.R.shape[0]
        if any(tuple(T.shape) != (n, n) for T in self.terms):
            raise ValueError(f"SCM terms must be {n} x {n}")
        self._L = torch.linalg.cholesky(self.R)
        # per-term spectral box: extreme generalized eigenvalues of (T, R)
        box = []
        for T in self.terms:
            w = torch.linalg.eigvalsh(self._reduce(T))
            box.append((float(w[0]), float(w[-1])))
        self.box = box
        # greedy anchor state
        self.anchor_mus: list = []
        self.anchor_thetas = np.zeros((0, len(self.terms)))
        self.anchor_alphas = np.zeros((0,))
        self.anchor_ystars = np.zeros((0, len(self.terms)))

    def _reduce(self, A: torch.Tensor) -> torch.Tensor:
        """L^-1 A L^-H, Hermitian with the spectrum of the pencil (A, R)."""
        B = torch.linalg.solve_triangular(self._L, A, upper=False)
        C = torch.linalg.solve_triangular(self._L, B.mH, upper=False).mH
        return 0.5 * (C + C.mH)

    # -- exact eigensolve at one parameter --------------------------------
    def _assemble(self, theta: np.ndarray) -> torch.Tensor:
        A = torch.zeros_like(self.terms[0])
        for c, T in zip(theta, self.terms):
            A += float(c) * T
        return A

    def alpha_exact(self, mu: Mu):
        """(alpha(mu), y*): the smallest generalized eigenpair of (sum c_q
        T_q, R), y*_q the Rayleigh coordinates of its vector."""
        theta = self._theta(mu)
        w, V = torch.linalg.eigh(self._reduce(self._assemble(theta)))
        u = torch.linalg.solve_triangular(self._L.mH, V[:, :1], upper=True)[:, 0]
        den = torch.real(u.conj() @ (self.R @ u))
        ystar = torch.stack([torch.real(u.conj() @ (T @ u)) for T in self.terms]) / den
        return float(w[0]), ystar.cpu().numpy()

    def _theta(self, mu: Mu) -> np.ndarray:
        th = np.asarray(self.theta_fn(mu), dtype=np.float64)
        if th.shape != (len(self.terms),):
            raise ValueError(f"theta_fn gave shape {th.shape}, not ({len(self.terms)},)")
        return th

    # -- bounds ------------------------------------------------------------
    def lower(self, mu: Mu) -> float:
        """alpha_LB(mu): the LP over the box and the anchors' half-spaces; a
        lower bound for any anchor set (none: the box alone)."""
        theta = self._theta(mu)
        if len(self.anchor_alphas):
            A_ub, b_ub = -self.anchor_thetas, -self.anchor_alphas
        else:
            A_ub = b_ub = None
        res = linprog(theta, A_ub=A_ub, b_ub=b_ub, bounds=self.box, method="highs")
        if not res.success:  # the polytope is never empty; a numerical
            # failure falls back to the box's own bound
            return float(sum(min(t * lo, t * hi) for t, (lo, hi) in zip(theta, self.box)))
        return float(res.fun)

    def upper(self, mu: Mu) -> float:
        """alpha_UB(mu): the least c(mu) . y* over the anchors (inf without)."""
        if not len(self.anchor_ystars):
            return float("inf")
        return float(np.min(self.anchor_ystars @ self._theta(mu)))

    __call__ = lower

    def tabulate(self, mus: Sequence[Mu]) -> np.ndarray:
        """The lower bounds at ``mus``."""
        return np.array([self.lower(mu) for mu in mus])

    # -- offline greedy ------------------------------------------------------
    def add_anchor(self, mu: Mu) -> float:
        alpha, ystar = self.alpha_exact(mu)
        self.anchor_mus.append(mu)
        self.anchor_thetas = np.vstack([self.anchor_thetas, self._theta(mu)])
        self.anchor_alphas = np.append(self.anchor_alphas, alpha)
        self.anchor_ystars = np.vstack([self.anchor_ystars, ystar])
        return alpha

    def fit(self, training_mus: Sequence[Mu], tol: float = 0.1,
            max_anchors: int = 30) -> dict:
        """Greedy SCM: anchor the training parameter with the worst relative
        gap (1 - LB/UB, inf while LB <= 0 < UB) until the largest gap is at
        most ``tol`` or there are ``max_anchors``. Returns ``{"max_gap": [per
        iteration], "n_anchors": ...}``."""
        mus = list(training_mus)
        history = {"max_gap": [], "n_anchors": 0}
        if not len(self.anchor_alphas):
            self.add_anchor(mus[0])
        while len(self.anchor_alphas) < max_anchors:
            lbs = np.array([self.lower(mu) for mu in mus])
            ubs = np.array([self.upper(mu) for mu in mus])
            with np.errstate(divide="ignore", invalid="ignore"):
                gaps = np.where((lbs > 0) & (ubs > 0), 1.0 - lbs / ubs,
                                np.where(ubs > 0, np.inf, 0.0))
            worst = int(np.argmax(gaps))
            history["max_gap"].append(float(gaps[worst]))
            if gaps[worst] <= tol:
                break
            self.add_anchor(mus[worst])
        history["n_anchors"] = int(len(self.anchor_alphas))
        return history


class ScmCoercivity(ScmHermitian):
    """SCM coercivity lower bound alpha_LB(mu) <= lambda_min(sym A(mu), R)
    for an affine FOM with real coefficients: needs neither SPD terms nor
    positive coefficients, only coercivity on the sampled region."""

    def __init__(self, fom, product=None, device=None):
        coeffs = tuple(fom.operator.coefficients)
        terms = []
        for t in fom.operator.terms:
            T = _dense(t)
            terms.append(0.5 * (T + T.mH))  # symmetric part
        R = _product_dense(product, terms[0].shape[0])

        def theta_fn(mu):
            th = _coefficients_host(coeffs, mu)
            if np.iscomplexobj(th):
                if not np.allclose(th.imag, 0):
                    raise ValueError("ScmCoercivity needs real coefficients; use "
                                     "ScmInfSup for complex families")
                th = th.real
            return np.asarray(th, dtype=np.float64)

        super().__init__(terms, theta_fn, R, device=fom.device if device is None else device)


class ScmInfSup:
    """SCM inf-sup lower bound by the squared operator:
    beta(mu)^2 = lambda_min(A(mu)^H R^-1 A(mu), R), complex coefficients
    (Helmholtz) through the Re / Im pair expansion (module docstring): the
    expanded family has T(T+1)/2 real-part and T(T-1)/2 imaginary-part
    terms. ``__call__(mu)`` is beta_LB(mu) = sqrt(max(alpha_LB, 0)), the
    call surface of ``bounds.InfSupLowerBound`` (host LP: one Mu a call).
    The products M = A_q^H R^-1 A_q' and the eigensolves run on ``device``
    (default: the FOM's) in float64 / complex128."""

    def __init__(self, fom, product=None, device=None):
        dev = resolve_device(fom.device if device is None else device)
        base_coeffs = tuple(fom.operator.coefficients)
        A_terms = [_dense(t).to(dev) for t in fom.operator.terms]
        T = len(A_terms)
        R = _product_dense(product, A_terms[0].shape[0]).to(dev)
        L = torch.linalg.cholesky(R)
        Rinv_A = [torch.cholesky_solve(A, L) for A in A_terms]
        terms: list[torch.Tensor] = []
        self._pairs: list[tuple[int, int, str]] = []
        for q in range(T):
            for qp in range(q, T):
                M = A_terms[q].mH @ Rinv_A[qp]
                if qp == q:
                    terms.append(0.5 * (M + M.mH))  # Hermitian up to rounding
                    self._pairs.append((q, q, "re"))
                else:
                    terms.append(M + M.mH)
                    self._pairs.append((q, qp, "re"))
                    terms.append(1j * (M - M.mH))
                    self._pairs.append((q, qp, "im"))
        del Rinv_A
        pairs = self._pairs

        def theta_fn(mu):
            th = _coefficients_host(base_coeffs, mu)
            out = np.empty(len(pairs))
            for i, (q, qp, part) in enumerate(pairs):
                z = np.conj(th[q]) * th[qp]
                out[i] = float(np.real(z) if part == "re" else np.imag(z))
            return out

        self.scm = ScmHermitian(terms, theta_fn, R, device=dev)

    def fit(self, training_mus, tol: float = 0.1, max_anchors: int = 30) -> dict:
        return self.scm.fit(training_mus, tol=tol, max_anchors=max_anchors)

    def lower(self, mu: Mu) -> float:
        return float(np.sqrt(max(self.scm.lower(mu), 0.0)))

    def upper(self, mu: Mu) -> float:
        ub = self.scm.upper(mu)
        if not np.isfinite(ub):
            return float("inf")
        # a tiny negative squared bound near an inf-sup zero gives 0, not NaN
        return float(np.sqrt(max(ub, 0.0)))

    __call__ = lower

    def tabulate(self, mus) -> np.ndarray:
        return np.array([self.lower(mu) for mu in mus])
