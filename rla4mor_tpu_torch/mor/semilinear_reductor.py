"""POD-DEIM reduction of the monotone semilinear family, certified.

Counterpart of ``rla4mor_tpu/mor/semilinear_reductor.py`` for
:class:`~rla4mor_tpu_torch.models.semilinear.SemilinearStencilFOM`.

Offline: POD of Newton-solved snapshots -> basis V (n, r); DEIM
(``mor/eim.py``) of the nonlinearity snapshots g(u_i) -> nodal basis U and
magic points P (and reserve points for the DEIM indicator); the reduced
stacks V^T A_b V; the hyperreduction matrices W = V^T M_L U (P^T U)^-1
(r, m) and P V (m, r); the residual columns
C = [f | A_1 V .. A_B V | M_L U (P^T U)^-1], compressed either exactly (the
Gram C^T C) or through an embedding (Theta C: one ``embedding.apply`` of
the whole block, one SRHT kernel launch).

Online: a dense (r, r) Newton on A_hat(mu) a + c(mu) W g(P V a) = b_hat. The
JAX package runs it as a ``while_loop`` under ``vmap``; here it is one
batched Newton over a leading parameter dimension with a per-row
convergence mask and one batched ``torch.linalg.solve`` a step. The
residual norm ||C w(a, mu)|| with w = [1, -theta (x) a, -c g(P V a)] is the
exact l2 norm of the DEIM residual (up to the sketch's distortion), plus
the reserve-point DEIM indicator.

Certificate (R = l2, strong monotonicity):
||u - u_r||_2 <= (||r_deim(u_r)||_2 + c h^2 ||g - I_m g||_2) / alpha_LB(mu),
the second term estimated from the reserve points; the IMEX parabolic
composition's rigorous bound is :meth:`SemilinearInstationaryROM.certified_error_bound`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rla4mor_tpu_torch.core.affine import AffineDense
from rla4mor_tpu_torch.core.orthonormalize import pod
from rla4mor_tpu_torch.core.parameters import Mu, ProjectionCoefficient, eval_coefficients
from rla4mor_tpu_torch.models.semilinear import (
    MASS_REL_SPECTRUM,
    NONLINEARITIES,
    NONLINEARITY_DG_SUP,
)
from rla4mor_tpu_torch.mor.eim import deim


def _reaction(reaction_scale: float, mu: Mu, like: torch.Tensor) -> torch.Tensor:
    """c(mu) as ``like``'s dtype and device: () or (B,)."""
    r = torch.as_tensor(mu["reaction"]).to(like.device, like.dtype)
    return reaction_scale * r[..., 0]


def _theta(coefficients, mu: Mu, like: torch.Tensor) -> torch.Tensor:
    return eval_coefficients(coefficients, mu, device=like.device).to(like.dtype)


class SemilinearResidualEstimator:
    """l2 norm of the DEIM residual and the reserve-point DEIM indicator.

    ``gram`` is either the (ncols, ncols) Gram C^T C (``sketched=False``)
    or the (k, ncols) sketch Theta C (``sketched=True``); w is laid out
    [1 | -theta (x) a | -c g_pts]."""

    def __init__(self, gram, Pv_res, pred_res, sketched: bool, mass_scale: float,
                 n_interior: int):
        self.gram = torch.as_tensor(gram)
        # reserve-point pieces (both None without reserve points)
        self.Pv_res = None if Pv_res is None else torch.as_tensor(Pv_res)
        self.pred_res = None if pred_res is None else torch.as_tensor(pred_res)
        self.sketched = bool(sketched)
        self.mass_scale = float(mass_scale)  # h^2
        self.n_interior = int(n_interior)

    def residual_norm(self, w: torch.Tensor) -> torch.Tensor:
        """||C w|| for weight vectors w (..., ncols) -> (...)."""
        G = self.gram.to(w.dtype)
        Gw = w @ G.T
        if self.sketched:
            return torch.linalg.vector_norm(Gw, dim=-1)
        return torch.sqrt(torch.clamp((w * Gw).sum(dim=-1), min=0.0))

    def deim_scale(self) -> float:
        """h^2 sqrt(n_interior): the sup-norm indicator as an l2 surrogate."""
        return self.mass_scale * math.sqrt(float(self.n_interior))

    def deim_indicator(self, g_pts: torch.Tensor, g_res: torch.Tensor) -> torch.Tensor:
        """h^2 sqrt(n_int) max |g_res - pred_res g_pts| over the reserve
        points (a lower-bound-flavoured indicator, as ``EimInterpolant``'s)
        -> (...) for g_pts (..., m), g_res (..., m_res)."""
        if self.pred_res is None:
            return torch.zeros(g_pts.shape[:-1], dtype=g_pts.dtype, device=g_pts.device)
        pred = g_pts @ self.pred_res.to(g_pts.dtype).T
        return self.deim_scale() * (g_res - pred).abs().amax(dim=-1)


class SemilinearROM:
    """Dense hyperreduced semilinear ROM; every online method takes one Mu
    or a batched one."""

    def __init__(self, lhs: AffineDense, rhs_hat, W, Pv, output_row,
                 error_estimator: Optional[SemilinearResidualEstimator], nonlinearity: str,
                 reaction_scale: float, newton_tol: float = 1e-11, max_newton: int = 50):
        self.lhs = lhs                                   # (B, r, r) reduced stacks
        self.rhs_hat = torch.as_tensor(rhs_hat)          # (r,)
        self.W = torch.as_tensor(W)                      # (r, m) V^T M_L U S
        self.Pv = torch.as_tensor(Pv)                    # (m, r) V rows at the points
        self.output_row = None if output_row is None else torch.as_tensor(output_row)
        self.error_estimator = error_estimator
        self.nonlinearity = str(nonlinearity)
        self.reaction_scale = float(reaction_scale)
        self.newton_tol = float(newton_tol)
        self.max_newton = int(max_newton)

    @property
    def dim(self) -> int:
        return self.lhs.source_dim

    @property
    def n_deim(self) -> int:
        return self.W.shape[1]

    def _gdg(self):
        return NONLINEARITIES[self.nonlinearity]

    def reaction(self, mu: Mu) -> torch.Tensor:
        return _reaction(self.reaction_scale, mu, self.W)

    def solve(self, mu: Mu) -> torch.Tensor:
        """Dense Newton with full steps from a = 0: (r,) for one Mu, (B, r)
        for a batched one. A row stops once ||F(a)|| <= newton_tol ||b||
        (or after ``max_newton`` steps), as each row's ``while_loop`` does in
        the JAX package; the strong monotonicity of V^T F(V .) makes the
        solution unique."""
        g, dg = self._gdg()
        A = self.lhs.assemble(mu)
        dt = A.dtype
        c = self.reaction(mu).to(dt)
        b = self.rhs_hat.to(dt)
        W, Pv = self.W.to(dt), self.Pv.to(dt)
        batch = A.shape[:-2]
        cw = c[..., None, None] * W   # c W, (..., r, m)

        def F(a):
            return (A @ a[..., None])[..., 0] + (cw @ g(a @ Pv.T)[..., None])[..., 0] - b

        bn = max(float(torch.linalg.vector_norm(b)), torch.finfo(dt).tiny)
        a = torch.zeros(batch + (self.dim,), dtype=dt, device=A.device)
        for _ in range(self.max_newton):
            Fa = F(a)
            active = torch.linalg.vector_norm(Fa, dim=-1) > self.newton_tol * bn
            if not bool(active.any()):
                break
            J = A + (cw * dg(a @ Pv.T)[..., None, :]) @ Pv
            step = torch.linalg.solve(J, Fa[..., None])[..., 0]
            a = torch.where(active[..., None], a - step, a)
        return a

    def solve_batch(self, mus_batched: Mu) -> torch.Tensor:
        return self.solve(mus_batched)

    def output(self, a, mu: Mu | None = None) -> torch.Tensor:
        if self.output_row is None:
            raise ValueError("this ROM has no output row")
        return a @ self.output_row.to(a.dtype)

    def estimate_error(self, mu: Mu, a=None, include_deim: bool = True) -> torch.Tensor:
        """l2 residual norm of the hyperreduced solution (exact up to the
        sketch's distortion) plus the reserve-point DEIM indicator; divide by
        the linear family's certified alpha_LB(mu) for the monotone bound."""
        est = self.error_estimator
        if est is None:
            raise ValueError("this ROM has no error estimator")
        if a is None:
            a = self.solve(mu)
        g, _ = self._gdg()
        theta = _theta(self.lhs.coefficients, mu, a)
        c = self.reaction(mu).to(a.dtype)
        g_pts = g(a @ self.Pv.to(a.dtype).T)
        w = torch.cat([torch.ones(a.shape[:-1] + (1,), dtype=a.dtype, device=a.device),
                       -(theta[..., :, None] * a[..., None, :]).flatten(-2),
                       -c[..., None] * g_pts], dim=-1)
        rnorm = est.residual_norm(w)
        if include_deim and est.Pv_res is not None:
            g_res = g(a @ est.Pv_res.to(a.dtype).T)
            rnorm = rnorm + c * est.deim_indicator(g_pts, g_res)
        return rnorm

    def solve_and_estimate_batch(self, mus_batched: Mu):
        a = self.solve(mus_batched)
        return a, self.estimate_error(mus_batched, a)


class SemilinearInstationaryROM:
    """Hyperreduced IMEX semilinear heat ROM:

        (M_hat + dt A_hat(mu)) a^{k+1} = M_hat a^k + dt (b_hat - c(mu) W g(P V a^k)),

    Cholesky-factored once a parameter (batched over a leading parameter
    dimension), nt dense triangular solves and nt DEIM point evaluations.

    :meth:`certified_error_bound` is the monotone IMEX composition of the
    JAX package (its class docstring has the theorem): with the per-step
    defects rho^k, the DEIM gaps d^k, r_k = ||rho^k|| + ||d^k||, the
    linear family's alpha, the sup L of g' over the window [-U, U] and the
    consistent-mass floor m_lo h^2,

        ||e^K||_2^2 <= dt sum_{k<K} r_k^2 / ((alpha - c h^2 L) m_lo h^2)

    whenever c h^2 L < alpha; the window U = U_r + margin is closed by a
    bootstrap (the bound must stay <= margin), else the bound is inf and
    flagged uncertified."""

    def __init__(self, lhs: AffineDense, M_hat, rhs_hat, W, Pv, output_row,
                 error_estimator: Optional[SemilinearResidualEstimator], nonlinearity: str,
                 reaction_scale: float, nt: int, dt: float, v_row_sup: float = float("nan")):
        self.lhs = lhs
        self.M_hat = torch.as_tensor(M_hat)
        self.rhs_hat = torch.as_tensor(rhs_hat)
        self.W = torch.as_tensor(W)
        self.Pv = torch.as_tensor(Pv)
        self.output_row = None if output_row is None else torch.as_tensor(output_row)
        self.error_estimator = error_estimator
        self.nonlinearity = str(nonlinearity)
        self.reaction_scale = float(reaction_scale)
        self.nt = int(nt)
        self.dt = float(dt)
        # max row 2-norm of V: ||V a||_inf <= v_row_sup ||a||_2, the a-priori
        # sup factor of the bootstrap (NaN in files of the older format)
        self.v_row_sup = float(v_row_sup)

    @property
    def dim(self) -> int:
        return self.lhs.source_dim

    def reaction(self, mu: Mu) -> torch.Tensor:
        return _reaction(self.reaction_scale, mu, self.W)

    def solve(self, mu: Mu) -> torch.Tensor:
        """(r, nt+1) reduced trajectory from a0 = 0 (time axis last), (B, r,
        nt+1) for a batched Mu."""
        g, _ = NONLINEARITIES[self.nonlinearity]
        A = self.lhs.assemble(mu)
        dt_ = A.dtype
        h = self.dt
        c = self.reaction(mu).to(dt_)
        Mh = self.M_hat.to(dt_)
        L = torch.linalg.cholesky(Mh + h * A)
        b = self.rhs_hat.to(dt_)
        cw = c[..., None, None] * self.W.to(dt_)
        Pv = self.Pv.to(dt_)
        a = torch.zeros(A.shape[:-2] + (self.dim,), dtype=dt_, device=A.device)
        traj = [a]
        for _ in range(self.nt):
            rhs = a @ Mh.T + h * (b - (cw @ g(a @ Pv.T)[..., None])[..., 0])
            a = torch.cholesky_solve(rhs[..., None], L)[..., 0]
            traj.append(a)
        return torch.stack(traj, dim=-1)

    def solve_batch(self, mus_batched: Mu) -> torch.Tensor:
        return self.solve(mus_batched)

    def output_trajectory(self, traj) -> torch.Tensor:
        if self.output_row is None:
            raise ValueError("this ROM has no output row")
        return self.output_row.to(traj.dtype) @ traj

    def _step_residuals(self, mu: Mu, traj, include_deim: bool):
        """(rnorms, deim), each (..., nt): ||rho^k||_2 from the weights
        [-1 | theta (x) a^{k+1} | c g(P V a^k) | (a^{k+1} - a^k) / dt] over the
        columns [f | A_b V | M_L U S | M V], and the reserve-point estimate
        of ||d^k||_2 (zeros without reserve points or with
        ``include_deim=False``)."""
        est = self.error_estimator
        if est is None:
            raise ValueError("this ROM has no error estimator")
        g, _ = NONLINEARITIES[self.nonlinearity]
        dtype = traj.dtype
        a_old = traj[..., :-1].transpose(-1, -2)      # (..., nt, r)
        a_new = traj[..., 1:].transpose(-1, -2)
        theta = _theta(self.lhs.coefficients, mu, traj)  # (..., T)
        c = self.reaction(mu).to(dtype)
        g_pts = g(a_old @ self.Pv.to(dtype).T)         # (..., nt, m)
        Ws = torch.cat([
            torch.full(a_old.shape[:-1] + (1,), -1.0, dtype=dtype, device=traj.device),
            (theta[..., None, :, None] * a_new[..., :, None, :]).flatten(-2),
            c[..., None, None] * g_pts,
            (a_new - a_old) / self.dt,
        ], dim=-1)
        rnorms = est.residual_norm(Ws)
        if include_deim and est.Pv_res is not None:
            g_res = g(a_old @ est.Pv_res.to(dtype).T)
            pred = g_pts @ est.pred_res.to(dtype).T
            deim_ = c[..., None] * est.deim_scale() * (g_res - pred).abs().amax(dim=-1)
        else:
            deim_ = torch.zeros_like(rnorms)
        return rnorms, deim_

    def estimate_error(self, mu: Mu, traj=None, include_deim: bool = True) -> torch.Tensor:
        """sqrt(dt sum_k ||rho^k||^2) (+ the DEIM term's) of the trajectory:
        the greedy's score; :meth:`certified_error_bound` makes it a bound."""
        if traj is None:
            traj = self.solve(mu)
        rnorms, deim_ = self._step_residuals(mu, traj, include_deim)
        eta = torch.sqrt(self.dt * (rnorms * rnorms).sum(dim=-1))
        if include_deim:
            eta = eta + torch.sqrt(self.dt * (deim_ * deim_).sum(dim=-1))
        return eta

    def certified_error_bound(self, mu: Mu, coercivity, traj=None, margin=None,
                              v_row_sup: float | None = None, include_deim: bool = True):
        """Rigorous final-time state-error bound ||u^nt - V a^nt||_2 (class
        docstring). ``coercivity``: the linear family's certified l2
        alpha_LB, a callable of Mu. ``margin``: the bootstrap window
        U = U_r + margin (default: the smallest certified rung of the
        ladder 0.01 (1 + U_r) 1.5^j, j < 24).

        Returns ``(bound, info)`` (scalars, or (B,) for a batched Mu):
        ``bound`` is inf where the reaction beats the dissipation or the
        bootstrap fails (``info['certified']`` False), never a finite
        number that does not hold. ``info``: ``bound_max``, ``margin``,
        ``L``, ``alpha``, ``U_r``, ``certified``."""
        est = self.error_estimator
        if est is None:
            raise ValueError("this ROM has no error estimator")
        if traj is None:
            traj = self.solve(mu)
        s_V = self.v_row_sup if v_row_sup is None else float(v_row_sup)
        if not np.isfinite(s_V):
            raise ValueError("certified_error_bound needs v_row_sup (the POD basis "
                             "row-sup factor); refit, or pass v_row_sup= explicitly")
        rnorms, deim_ = self._step_residuals(mu, traj, include_deim)
        r = rnorms + deim_
        dtype = r.dtype
        h2 = est.mass_scale
        m_lo, _ = MASS_REL_SPECTRUM
        batch = r.shape[:-1]
        alpha = torch.as_tensor(coercivity(mu)).to(r.device, dtype)
        alpha = (alpha.reshape(batch) if alpha.numel() == math.prod(batch)
                 else alpha.expand(batch))
        c = self.reaction(mu).to(dtype).expand(batch)
        U_r = s_V * torch.linalg.vector_norm(traj, dim=-2).amax(dim=-1)
        S_T = self.dt * (r * r).sum(dim=-1)  # the whole space-time residual sum
        dg_sup = NONLINEARITY_DG_SUP[self.nonlinearity]

        def bound_for(m):
            """(final bound, certified, L) for the window U_r + m (the
            cumulative sums are monotone, so the final value bounds every
            step's and the bootstrap needs only it)."""
            L = dg_sup(U_r[..., None] + m).to(dtype)
            gap = alpha[..., None] - c[..., None] * h2 * L
            ok = gap > 0
            gap_s = torch.where(ok, gap, torch.ones_like(gap))
            b_T = torch.sqrt(S_T[..., None] / (gap_s * m_lo * h2))
            return b_T, ok & (b_T <= m), L

        if margin is None:
            # the window must satisfy bound(L(U_r + m)) <= m: too small fails
            # the check, too large inflates L; the smallest certified rung
            ladder = 1.5 ** torch.arange(24, dtype=dtype, device=r.device)
            margins = 0.01 * (1.0 + U_r)[..., None] * ladder
            b_T, cert, Ls = bound_for(margins)
            pick = torch.where(cert, margins, torch.full_like(margins, math.inf)).argmin(dim=-1,
                                                                                     keepdim=True)
            certified = cert.any(dim=-1)
            margin = margins.gather(-1, pick)[..., 0]
            bound_last = b_T.gather(-1, pick)[..., 0]
            L = Ls.gather(-1, pick)[..., 0]
        else:
            margin = torch.as_tensor(margin).to(r.device, dtype).expand(batch)
            b_T, cert, Ls = bound_for(margin[..., None])
            bound_last, certified, L = b_T[..., 0], cert[..., 0], Ls[..., 0]
        inf = torch.full_like(bound_last, math.inf)
        bound = torch.where(certified, bound_last, inf)
        info = {"bound_max": bound, "margin": margin, "L": L, "alpha": alpha, "U_r": U_r,
                "certified": certified}
        return bound, info


# ---------------------------------------------------------------------------
# offline
# ---------------------------------------------------------------------------


def _deim_split(G, deim_modes, deim_rtol, n_reserve):
    """DEIM of G with the last ``n_reserve`` terms (at most all but one) kept
    as reserve points."""
    full = deim(G, modes=deim_modes, rtol=deim_rtol)
    m_total = full.basis.shape[1]
    n_res = min(n_reserve, max(m_total - 1, 0))
    return full.truncate(m_total - n_res, n_res) if n_res > 0 else full


@dataclass
class SemilinearReductor:
    """POD-DEIM offline stage for ``SemilinearStencilFOM``.

    ``embedding``: None -> the exact Gram residual estimator (small and
    medium n); an embedding on n_dof rows -> the sketched estimator (the
    n-sized residual columns compressed to k rows once, offline, in one
    ``apply``). ``last_basis`` / ``last_interpolant``: the POD basis and
    DEIM interpolant behind the last ROM (reconstruction, diagnostics);
    ``last_picked``: the training indices the last ``greedy`` solved."""

    fom: object
    embedding: object | None = None
    last_basis: object = None
    last_interpolant: object = None
    last_picked: object = None

    def fit(self, mus_train, modes: Optional[int] = None, pod_rtol: float = 1e-7,
            deim_modes: Optional[int] = None, deim_rtol: float = 1e-7, n_reserve: int = 2,
            snapshots=None, **solve_kw) -> SemilinearROM:
        """POD-DEIM from Newton snapshots (``snapshots`` (n, m) given, or
        solved at ``mus_train`` with ``solve_kw``)."""
        fom = self.fom
        if snapshots is None:
            snapshots = torch.stack([fom.solve_newton(m, **solve_kw).reshape(-1)
                                     for m in mus_train], dim=1)
        S = torch.as_tensor(snapshots)
        V, _ = pod(S, modes=modes, rtol=pod_rtol)
        # g(0) = 0 on the Dirichlet ring: those rows are zero, never picked
        interp = _deim_split(fom.g(S), deim_modes, deim_rtol, n_reserve)
        return self._assemble_rom(V, interp)

    def _pieces(self, V: torch.Tensor, interp):
        """The reduced stacks, rhs, W, P V, reserve pieces, the residual
        columns [f | A_b V | M_L U S] and the output row of basis V."""
        self.last_basis = V
        self.last_interpolant = interp
        fom = self.fom
        B = fom.linear.n_terms
        AV = [torch.as_tensor(fom.linear.term_linop(b).apply(V)) for b in range(B)]
        lhs = AffineDense(torch.stack([V.T @ av for av in AV]),
                          tuple(ProjectionCoefficient("diffusion", b) for b in range(B)))
        f = fom.rhs(V.dtype).reshape(-1)
        m = interp.n_terms
        pts = interp.active_points
        U_act = interp.basis[:, :m].to(V.dtype)
        S_inv = torch.linalg.inv(interp.interp_matrix[:m, :m].to(V.dtype))
        ml = fom.mass_lumped_diag(V.dtype).reshape(-1)
        MUS = ml[:, None] * (U_act @ S_inv)   # (n, m)
        res_pts = interp.reserve_points
        if res_pts.shape[0] > 0:
            Pv_res, pred_res = V[res_pts, :], U_act[res_pts, :] @ S_inv
        else:
            Pv_res = pred_res = None
        out_row = (fom.h * fom.h) * V.sum(dim=0)
        return {"lhs": lhs, "rhs_hat": V.T @ f, "W": V.T @ MUS, "Pv": V[pts, :],
                "Pv_res": Pv_res, "pred_res": pred_res, "out_row": out_row,
                "columns": [f[:, None], *AV, MUS]}

    def _estimator(self, C: torch.Tensor, p: dict) -> SemilinearResidualEstimator:
        """The Gram C^T C, or Theta C in one embedding apply."""
        fom = self.fom
        if self.embedding is None:
            gram, sketched = C.T @ C, False
        else:
            gram, sketched = torch.as_tensor(self.embedding.apply(C)), True
        return SemilinearResidualEstimator(gram, p["Pv_res"], p["pred_res"], sketched,
                                           mass_scale=fom.h * fom.h,
                                           n_interior=(fom.n_nodes - 2) ** 2)

    def _assemble_rom(self, V, interp) -> SemilinearROM:
        V = torch.as_tensor(V)
        p = self._pieces(V, interp)
        est = self._estimator(torch.cat(p["columns"], dim=1), p)
        fom = self.fom
        return SemilinearROM(p["lhs"], p["rhs_hat"], p["W"], p["Pv"], p["out_row"], est,
                             nonlinearity=fom.nonlinearity,
                             reaction_scale=fom.reaction_scale)

    def fit_instationary(self, ifom, mus_train, modes: Optional[int] = None,
                         pod_rtol: float = 1e-7, deim_modes: Optional[int] = None,
                         deim_rtol: float = 1e-7, n_reserve: int = 2, store_every: int = 1,
                         snapshots=None, **solve_kw) -> SemilinearInstationaryROM:
        """POD-DEIM over IMEX trajectories of a ``SemilinearInstationaryFOM``:
        every stored state of every training trajectory (u0 = 0 dropped),
        DEIM over their nonlinearity images; the residual columns add the
        consistent-mass block M V."""
        from rla4mor_tpu_torch.models.stencil import mass_apply

        fom = self.fom
        if ifom.fom is not fom:
            raise ValueError("the reductor's FOM must be the IMEX FOM's spatial FOM")
        if snapshots is None:
            snapshots = torch.cat([ifom.solve_flat(m, store_every=store_every,
                                                   **solve_kw)[:, 1:]
                                   for m in mus_train], dim=1)
        S = torch.as_tensor(snapshots)
        V, _ = pod(S, modes=modes, rtol=pod_rtol)
        interp = _deim_split(fom.g(S), deim_modes, deim_rtol, n_reserve)
        p = self._pieces(V, interp)
        grids = V.T.reshape(V.shape[1], *fom.solution_shape)
        MV = mass_apply(grids, fom.h).reshape(V.shape[1], -1).T
        est = self._estimator(torch.cat([*p["columns"], MV], dim=1), p)
        return SemilinearInstationaryROM(
            p["lhs"], V.T @ MV, p["rhs_hat"], p["W"], p["Pv"], p["out_row"], est,
            nonlinearity=fom.nonlinearity, reaction_scale=fom.reaction_scale,
            nt=ifom.nt, dt=ifom.dt,
            v_row_sup=float(torch.linalg.vector_norm(V, dim=1).max()))

    def greedy(self, mus_train, n_steps: int, coercivity=None, deim_rtol: float = 1e-7,
               n_reserve: int = 2, seed_index: int = 0, verbose: bool = False, log=print,
               **solve_kw):
        """Strong greedy over the training set, scored by the certified
        indicator estimate_error / alpha_LB (the raw residual norm without
        ``coercivity``): each step refits POD-DEIM on the snapshots so far,
        sweeps the whole training set in one batched solve-and-estimate and
        Newton-solves only the argmax. Returns ``(rom, history)``,
        ``history[k]`` the max indicator before step k's enrichment."""
        from rla4mor_tpu_torch.core.parameters import mu_stack
        from rla4mor_tpu_torch.models.instationary import _coercivity_table

        mus = list(mus_train)
        batched = mu_stack(mus)
        picked = self.last_picked = [seed_index]
        snaps = [self.fom.solve_newton(mus[seed_index], **solve_kw).reshape(-1)]
        history = []
        rom = None
        alphas = (np.ones(len(mus)) if coercivity is None
                  else _coercivity_table(coercivity, mus))
        for step in range(1, n_steps + 1):
            rom = self.fit(None, snapshots=torch.stack(snaps, dim=1), pod_rtol=1e-10,
                           deim_rtol=deim_rtol, n_reserve=n_reserve)
            _, est_b = rom.solve_and_estimate_batch(batched)
            ests = est_b.detach().cpu().numpy().astype(np.float64) / alphas
            ests[np.asarray(picked, int)] = 0.0
            imax = int(np.argmax(ests))
            history.append(float(ests[imax]))
            if verbose:
                log(f"[semilinear greedy] step {step}: max indicator {history[-1]:.3e} at "
                    f"mu #{imax}")
            if step == n_steps or imax in picked:
                break
            picked.append(imax)
            snaps.append(self.fom.solve_newton(mus[imax], **solve_kw).reshape(-1))
        return rom, history


__all__ = ["SemilinearResidualEstimator", "SemilinearROM", "SemilinearInstationaryROM",
           "SemilinearReductor"]
