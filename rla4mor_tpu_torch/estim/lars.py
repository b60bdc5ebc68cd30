"""LARS / LASSO-LARS regularisation paths.

Counterpart of ``rla4mor_tpu/estim/lars.py``. Both solve
min_beta 0.5 ||x - D beta||^2 + alpha ||beta||_1 and produce the
piecewise-linear path with LASSO sign-drop handling; ``alphas`` are
max_j |d_j^T r| at the breakpoints.

* The host paths (``*_np``, :func:`lars_weighted_path`,
  :func:`lars_weighted_path_complex`, :func:`complex_lasso_cd`,
  :func:`lars_weighted_path_group`) are numpy float64 code, copied from the
  JAX package (which keeps them numpy too): the variable-length exact
  paths, kept as the oracles.
* The device paths keep the JAX names, ``_jax`` suffix included. Each
  takes one observation vector x (m,) or a batch of them, (B, m), against
  one dictionary D, and runs on D's device. The JAX package runs one
  column as a ``lax.while_loop`` (or ``lax.scan``) and ``jax.vmap``s it
  over columns; here the batch is a leading dimension of every tensor of
  the loop's state, and a column that has finished keeps its state while
  the others go on, as the vmapped loop's lanes do. The host reads
  whether all columns have finished once every ``_CHECK_EVERY`` steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from rla4mor_tpu_torch.core.solvers import svd_thin

# steps between the host's reads of whether every column has finished
_CHECK_EVERY = 16


# ---------------------------------------------------------------------------
# host paths (numpy float64, variable length, exact breakpoints)
# ---------------------------------------------------------------------------


def lars_lasso_path_np(
    D: np.ndarray,
    x: np.ndarray,
    alpha_min: float = 0.0,
    max_steps: Optional[int] = None,
    tol: float = 1e-12,
) -> Tuple[np.ndarray, np.ndarray]:
    """LASSO-LARS homotopy. Returns (coefs (K, P), alphas (P,)) with
    coefs[:, 0] = 0 at alpha = max|D^T x| and subsequent breakpoints."""
    D = np.asarray(D, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64).reshape(-1)
    m, K = D.shape
    if max_steps is None:
        max_steps = 8 * min(m, K)

    beta = np.zeros(K)
    active: list[int] = []
    signs = np.zeros(K)
    coefs = [beta.copy()]
    c = D.T @ x
    lam = np.abs(c).max()
    alphas = [lam]

    just_dropped = False
    for _ in range(max_steps):
        if lam <= alpha_min + tol:
            break
        c = D.T @ (x - D @ beta)
        inactive = [j for j in range(K) if j not in active]
        # a variable enters when its correlation reaches lambda — except on
        # the step right after a drop (Efron et al. lasso modification)
        if not just_dropped and inactive:
            j_new = inactive[int(np.argmax(np.abs(c[inactive])))]
            if np.abs(c[j_new]) >= lam - 1e-9 * max(lam, 1):
                active.append(j_new)
                signs[j_new] = np.sign(c[j_new])
        just_dropped = False
        if not active:
            break

        A = np.array(active)
        G = D[:, A].T @ D[:, A]
        try:
            w = np.linalg.solve(G, signs[A])
        except np.linalg.LinAlgError:
            w = np.linalg.lstsq(G, signs[A], rcond=None)[0]
        u = D[:, A] @ w  # equiangular-ish direction; d_a^T u = s_a

        # max step until lambda target
        gamma_max = lam - alpha_min

        # step to the next entering variable
        a = D.T @ u
        gamma_in = gamma_max
        for j in range(K):
            if j in active:
                continue
            for num, den in ((lam - c[j], 1 - a[j]), (lam + c[j], 1 + a[j])):
                if den > tol:
                    g = num / den
                    if tol < g < gamma_in:
                        gamma_in = g

        # step to the next sign change (drop)
        gamma_drop = np.inf
        drop_idx = -1
        for idx, jj in enumerate(active):
            if abs(w[idx]) > tol:
                g = -beta[jj] / w[idx]
                if tol < g < gamma_drop:
                    gamma_drop = g
                    drop_idx = idx

        gamma = min(gamma_in, gamma_drop, gamma_max)
        beta = beta.copy()
        beta[A] += gamma * w
        lam -= gamma

        if gamma == gamma_drop and drop_idx >= 0:
            jj = active.pop(drop_idx)
            beta[jj] = 0.0
            signs[jj] = 0.0
            just_dropped = True

        coefs.append(beta.copy())
        alphas.append(lam)
    return np.stack(coefs, axis=1), np.asarray(alphas)


def _ols_debias(D, x, path, rcond=1e-10):
    """OLS re-fit on each path point's support."""
    out = np.zeros_like(path)
    for i in range(path.shape[1]):
        ind = np.nonzero(path[:, i])[0]
        if ind.size:
            sol, *_ = np.linalg.lstsq(D[:, ind], x, rcond=rcond)
            out[ind, i] = sol
    return out


def lars_weighted_path(
    D,
    x,
    alpha: float = 0.0,
    weights: Optional[np.ndarray] = None,
    scale: float = 1e3,
    ols: bool = True,
    return_path: bool = True,
    max_steps: Optional[int] = None,
):
    """Weighted/rescaled LASSO-LARS path.

    The dictionary columns are divided by ``weights``, the data multiplied
    by ``scale`` (larger scale => longer path), alpha scaled accordingly;
    the returned path is de-scaled. With ``return_path`` the initial
    all-zero point is dropped."""
    D = np.asarray(D, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    K = D.shape[1]
    w = np.ones(K) if weights is None else np.asarray(weights, dtype=np.float64)
    D_ = D / w
    x_ = x * scale
    alpha_ = alpha * scale / K

    path_, alphas_ = lars_lasso_path_np(D_, x_, alpha_min=alpha_,
                                        max_steps=max_steps)
    if ols:
        path_ = _ols_debias(D_, x_, path_)
    path = path_ / w.reshape(-1, 1) / scale
    alphas = alphas_ / scale
    if return_path:
        path = path[:, 1:]
        alphas = alphas[1:]
    else:
        path = path[:, -1:]
        alphas = alphas[-1:]
    return path, alphas


def _stack_complex_np(D, x):
    """Real stacking of a complex LS problem: min ||w - D beta|| over
    complex beta becomes a real problem in [Re beta; Im beta] with the
    doubled dictionary [[Re D, -Im D], [Im D, Re D]]."""
    Dr, Di = np.real(D), np.imag(D)
    Ds = np.block([[Dr, -Di], [Di, Dr]])
    xs = np.concatenate([np.real(x), np.imag(x)])
    return Ds, xs


def lars_weighted_path_complex(
    D, x, alpha: float = 0.0, weights=None, scale: float = 1e3,
    ols: bool = True, return_path: bool = True, max_steps=None,
):
    """Complex dictionary LARS via the standard R^{2n} real-stacking
    reduction.

    CAVEAT (documented, inherent to the reduction): the l1 penalty acts
    on |Re beta_j| + |Im beta_j| separately, NOT on |beta_j| — the real
    and imaginary parts of one atom are independent path variables
    (no group sparsity), so a path point's support may be "half an atom".
    With the per-step OLS debias and manifold-distance selection this is
    harmless in practice; a group-LARS is the exact alternative.
    """
    D = np.asarray(D, dtype=np.complex128)
    x = np.asarray(x, dtype=np.complex128)
    K = D.shape[1]
    Ds, xs = _stack_complex_np(D, x)
    w2 = None if weights is None else np.concatenate([weights, weights])
    path_s, alphas = lars_weighted_path(
        Ds, xs, alpha, w2, scale, ols, return_path, max_steps
    )
    return path_s[:K] + 1j * path_s[K:], alphas


def _complex_soft_threshold(z, t):
    """prox of t*|.| for complex z: shrink the modulus, keep the phase."""
    a = np.abs(z)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(a > t, 1.0 - t / np.where(a > 0, a, 1.0), 0.0)
    return scale * z


def complex_lasso_cd(
    D: np.ndarray,
    x: np.ndarray,
    alpha: float,
    beta0: Optional[np.ndarray] = None,
    kkt_tol: float = 1e-10,
    max_iter: int = 50_000,
) -> np.ndarray:
    """Complex LASSO  min 0.5||x - D beta||^2 + alpha sum_j |beta_j|
    (modulus penalty == group LASSO over (Re, Im) pairs) by cyclic
    coordinate descent with exact complex soft-threshold updates.

    Converges to KKT residual <= ``kkt_tol * alpha_max``:
    ``|c_j| <= alpha`` on the inactive set and ``c_j == alpha *
    beta_j/|beta_j|`` on the active set, ``c = D^H (x - D beta)``.
    The corrector of :func:`lars_lasso_path_complex_np`."""
    D = np.asarray(D, np.complex128)
    x = np.asarray(x, np.complex128).reshape(-1)
    K = D.shape[1]
    G = D.conj().T @ D
    cx = D.conj().T @ x
    Gd = np.real(np.diag(G)).copy()
    dead = Gd <= 0  # zero atoms can never activate
    Gd[dead] = 1.0
    beta = (np.zeros(K, np.complex128) if beta0 is None
            else np.asarray(beta0, np.complex128).copy())
    c = cx - G @ beta
    scale = float(np.abs(cx).max()) or 1.0
    for _ in range(max_iter):
        for j in range(K):
            if dead[j]:
                continue
            zj = beta[j] + c[j] / Gd[j]
            bj = _complex_soft_threshold(zj, alpha / Gd[j])
            d = bj - beta[j]
            if d != 0.0:
                beta[j] = bj
                c -= G[:, j] * d
        # KKT residual (the honest convergence check)
        act = beta != 0
        r_in = max(np.abs(c[~act]).max() - alpha, 0.0) if (~act).any() else 0.0
        r_ac = (np.abs(c[act] - alpha * beta[act] / np.abs(beta[act])).max()
                if act.any() else 0.0)
        if max(r_in, r_ac) <= kkt_tol * scale:
            break
    return beta


def lars_lasso_path_complex_np(
    D: np.ndarray,
    x: np.ndarray,
    alpha_min: float = 0.0,
    max_steps: Optional[int] = None,
    rho: float = 0.85,
    kkt_tol: float = 1e-10,
    event_rtol: float = 1e-4,
) -> Tuple[np.ndarray, np.ndarray]:
    """TRUE complex LASSO homotopy: the path of
    min 0.5||x - D beta||^2 + alpha sum_j |beta_j| over decreasing alpha
    with the ROTATION-INVARIANT modulus penalty — one complex atom is
    one path variable (no half-atom supports), and the whole path
    commutes with a global phase ``x -> e^{i phi} x`` (the real-stacking
    reduction :func:`lars_weighted_path_complex` does not).

    Unlike the real case the complex path is only piecewise SMOOTH (the
    active phases evolve nonlinearly), so exact breakpoints are not
    polynomial-solvable; the homotopy is predictor-corrector: geometric
    continuation ``alpha -> rho * alpha`` with warm-started coordinate
    descent (:func:`complex_lasso_cd`) as the corrector, and support-
    change events located by bisection to ``event_rtol`` so the returned
    breakpoints carry LARS-like just-after-the-event solutions.

    Returns ``(coefs (K, P) complex, alphas (P,))`` with ``coefs[:, 0]
    = 0`` at ``alpha = max |D^H x|``; every column solves the complex
    LASSO at its alpha to ``kkt_tol`` (oracle-tested against FISTA).
    Reference semantics being generalized: inverse_problems/lars.py
    real paths; its spams complex backend never existed."""
    D = np.asarray(D, np.complex128)
    x = np.asarray(x, np.complex128).reshape(-1)
    m, K = D.shape
    if max_steps is None:
        max_steps = 8 * min(m, K)

    lam0 = float(np.abs(D.conj().T @ x).max())
    beta = np.zeros(K, np.complex128)
    coefs = [beta.copy()]
    alphas = [lam0]
    if lam0 <= alpha_min or lam0 == 0.0:
        return np.stack(coefs, axis=1), np.asarray(alphas)

    floor = max(alpha_min, lam0 * 1e-12)
    lam = lam0
    while len(alphas) < max_steps + 1 and lam > floor * (1 + 1e-12):
        target = max(lam * rho, floor)
        beta_t = complex_lasso_cd(D, x, target, beta0=beta,
                                  kkt_tol=kkt_tol)
        sup_old = beta != 0
        sup_new = beta_t != 0
        if (sup_old != sup_new).any():
            # bisect the FIRST support change in (target, lam) so the
            # path records a just-after-the-event point
            hi, lo = lam, target
            beta_lo = beta_t
            while hi - lo > event_rtol * hi:
                mid = 0.5 * (hi + lo)
                beta_m = complex_lasso_cd(D, x, mid, beta0=beta,
                                          kkt_tol=kkt_tol)
                if ((beta_m != 0) == sup_old).all():
                    hi = mid
                else:
                    lo, beta_lo = mid, beta_m
            if lo > target * (1 + 1e-12) and len(alphas) < max_steps:
                coefs.append(beta_lo.copy())
                alphas.append(lo)
        beta = beta_t
        coefs.append(beta.copy())
        alphas.append(target)
        lam = target
    return np.stack(coefs, axis=1), np.asarray(alphas)


def lars_weighted_path_group(
    D, x, alpha: float = 0.0, weights=None, scale: float = 1e3,
    ols: bool = True, return_path: bool = True, max_steps=None, **kwargs,
):
    """Weighted/rescaled wrapper around the TRUE complex homotopy —
    :func:`lars_weighted_path` semantics (weights divide the columns,
    ``scale`` lengthens the path, per-point complex OLS debias) with the
    rotation-invariant modulus penalty."""
    D = np.asarray(D, np.complex128)
    x = np.asarray(x, np.complex128)
    K = D.shape[1]
    w = np.ones(K) if weights is None else np.asarray(weights, np.float64)
    D_ = D / w
    x_ = x * scale
    alpha_ = alpha * scale / K
    path_, alphas_ = lars_lasso_path_complex_np(
        D_, x_, alpha_min=alpha_, max_steps=max_steps, **kwargs)
    if ols:
        path_ = _ols_debias(D_, x_, path_)
    path = path_ / w.reshape(-1, 1) / scale
    alphas = alphas_ / scale
    if return_path:
        return path[:, 1:], alphas[1:]
    return path[:, -1:], alphas[-1:]


# ---------------------------------------------------------------------------
# device paths (fixed shapes, masked active sets, batched over columns)
# ---------------------------------------------------------------------------


def _batched(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(x as a (B, m) batch, whether it was one vector)."""
    return (x[None], True) if x.dim() == 1 else (x, False)


def _masked_solve(D: torch.Tensor, maskf: torch.Tensor, rhs: torch.Tensor,
                  rcond: float) -> torch.Tensor:
    """pinv(Gm) rhs for each row of ``maskf`` (B, K) and ``rhs`` (B, K),
    zero where the mask is: Gm = D^T D on the masked rows and columns,
    the identity elsewhere (the JAX package's masked solve). Its
    eigenvalues of modulus at most ``rcond`` times the largest are dropped,
    which for this symmetric positive semidefinite matrix is its SVD
    pseudo-inverse with the same cutoff.

    Gm is not formed: with the QR (D diag(mask))^T = Q R, the masked block
    is Q (R R^T) Q^T, so its eigenpairs are those of the small R R^T
    (min(m, K) square) with eigenvectors Q U, and the identity block adds
    eigenvalues 1 (to the largest) with eigenvectors where rhs is 0."""
    Dm_t = D.T[None] * maskf[:, :, None]                 # (B, K, m)
    Q, R = torch.linalg.qr(Dm_t)                          # (B, K, r), (B, r, m)
    # the eigendecomposition in float64 whatever D's dtype: LAPACK's float32
    # eigh fails to converge on masked Grams of an ill-conditioned
    # dictionary (the demo's, at grid 64 on the CPU)
    RRt = R @ R.transpose(-1, -2)
    lam, U = torch.linalg.eigh(RRt.to(torch.promote_types(RRt.dtype, torch.float64)))
    lam, U = lam.to(RRt.dtype), U.to(RRt.dtype)
    largest = lam.abs().amax(dim=-1)
    largest = torch.where((maskf < 1).any(dim=-1), torch.clamp(largest, min=1.0), largest)
    keep = lam.abs() > rcond * largest[:, None]
    inv = torch.where(keep, 1.0 / torch.where(keep, lam, torch.ones_like(lam)),
                      torch.zeros_like(lam))
    y = (U.transpose(-1, -2) @ (Q.transpose(-1, -2) @ rhs[..., None]))[..., 0]
    return (Q @ (U @ (inv * y)[..., None]))[..., 0]


def lars_lasso_jax(D, x, alpha_min: float = 0.0, max_steps: int = 32
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape LASSO-LARS of each column: returns (path (max_steps + 1,
    K), alphas (max_steps + 1,), n_steps) for x (m,), with a leading batch
    dimension for x (B, m). Steps after a column has converged repeat its
    last point.

    Tolerances follow the dtype: the step guard max(1e-12, 100 eps), the
    entering threshold max(1e-9, 50 eps) (relative to max(lam, 1)), and the
    masked solve's pseudo-inverse cutoff max(1e-12, 10 eps) of the largest
    eigenvalue (:func:`_masked_solve`), as the JAX package's."""
    D = torch.as_tensor(D)
    x, single = _batched(torch.as_tensor(x).to(D))
    m, K = D.shape
    B = x.shape[0]
    dt, dev = D.dtype, D.device
    eps = torch.finfo(dt).eps
    tol = max(1e-12, 100 * eps)
    enter_tol = max(1e-9, 50 * eps)
    rcond = max(1e-12, 10 * eps)
    INF = torch.finfo(dt).max / 4
    Dt = D.T

    c0 = x @ D                       # (B, K): D^T x of each column
    lam = c0.abs().amax(dim=1)
    path = torch.zeros((B, max_steps + 1, K), dtype=dt, device=dev)
    alphas = lam[:, None].repeat(1, max_steps + 1)
    steps = torch.zeros(B, dtype=torch.long, device=dev)
    # the loop's state, one row per column still running (``cols``)
    cols = torch.arange(B, device=dev)
    beta = torch.zeros((B, K), dtype=dt, device=dev)
    signs = torch.zeros_like(beta)
    mask = torch.zeros((B, K), dtype=torch.bool, device=dev)
    step = torch.zeros(B, dtype=torch.long, device=dev)
    just_dropped = torch.zeros(B, dtype=torch.bool, device=dev)

    def pick(t, j):
        return t.gather(1, j[:, None])[:, 0]

    for it in range(max_steps):
        active = (lam > alpha_min + tol) & (step < max_steps)
        if it % _CHECK_EVERY == 0:
            # the host drops the finished columns from the loop's state
            keep = active.nonzero()[:, 0]
            if keep.numel() == 0:
                break
            if keep.numel() < active.numel():
                cols, x, lam, beta, signs, mask, step, just_dropped, active = (
                    t[keep] for t in (cols, x, lam, beta, signs, mask, step,
                                      just_dropped, active))
        c = (x - beta @ Dt) @ D
        # add the most correlated inactive variable, unless one was just
        # dropped (the lasso modification)
        c_in = torch.where(mask, -INF, c.abs())
        j_new = c_in.argmax(dim=1)
        do_add = ((pick(c_in, j_new) >= lam - enter_tol * torch.clamp(lam, min=1.0))
                  & ~just_dropped)
        add = torch.nn.functional.one_hot(j_new, K).bool() & do_add[:, None]
        mask_n = mask | add
        signs_n = torch.where(add, torch.sign(c), signs)

        # G[mask, mask] w = signs[mask], identity rows elsewhere (w = 0 there)
        maskf = mask_n.to(dt)
        w = _masked_solve(D, maskf, signs_n * maskf, rcond)
        a = (w @ Dt) @ D

        gamma_max = lam - alpha_min
        lam_ = lam[:, None]
        g1 = torch.where((1 - a) > tol, (lam_ - c) / (1 - a), INF)
        g2 = torch.where((1 + a) > tol, (lam_ + c) / (1 + a), INF)
        g_in = torch.where(mask_n, INF, torch.minimum(torch.where(g1 > tol, g1, INF),
                                                      torch.where(g2 > tol, g2, INF)))
        gamma_in = g_in.amin(dim=1)
        g_d = torch.where(mask_n & (w.abs() > tol), -beta / w, INF)
        g_d = torch.where(g_d > tol, g_d, INF)
        gamma_drop = g_d.amin(dim=1)
        j_drop = g_d.argmin(dim=1)

        gamma = torch.minimum(torch.minimum(gamma_in, gamma_drop), gamma_max)
        # the support invariant, exactly: the pseudo-inverse leaves ~eps in
        # inactive coordinates of w, which would widen the OLS support
        beta_n = torch.where(mask_n, beta + gamma[:, None] * w, 0.0)
        lam_n = lam - gamma
        dropped = (gamma == gamma_drop) & (gamma < gamma_max)
        drop = torch.nn.functional.one_hot(j_drop, K).bool() & dropped[:, None]
        beta_n = torch.where(drop, 0.0, beta_n)
        mask_n = mask_n & ~drop
        signs_n = torch.where(drop, 0.0, signs_n)

        # a column that finished within the last _CHECK_EVERY steps keeps
        # its state, as a finished lane of the vmapped loop does
        act = active[:, None]
        beta = torch.where(act, beta_n, beta)
        signs = torch.where(act, signs_n, signs)
        mask = torch.where(act, mask_n, mask)
        lam = torch.where(active, lam_n, lam)
        just_dropped = torch.where(active, dropped, just_dropped)
        step = step + active.long()
        path[cols, step] = beta
        alphas[cols, step] = lam
        steps[cols] = step

    idx = torch.minimum(torch.arange(max_steps + 1, device=dev)[None], steps[:, None])
    path = path.gather(1, idx[:, :, None].expand(-1, -1, K))
    alphas = alphas.gather(1, idx)
    if single:
        return path[0], alphas[0], steps[0]
    return path, alphas, steps


def _ols_debias_jax(D, x, path, steps=None):
    """OLS re-fit of each path point on its support, for x (m,) and path
    (P, K), or x (B, m) and path (B, P, K): the min-norm least-squares
    solution on the column-masked D itself (an SVD through
    :func:`~rla4mor_tpu_torch.core.solvers.svd_thin`, cutoff eps max(m, K)
    of the largest singular value, numpy's lstsq convention), not on the
    normal equations, which square the conditioning. Masked columns get
    exactly 0.

    ``steps`` (the homotopy steps of each column, as ``lars_lasso_jax``
    returns them) says that the points after a column's last step repeat
    it: only each column's first ``steps + 1`` points are re-fitted, all
    in one batch, and the rest repeat their column's last re-fit."""
    D = torch.as_tensor(D)
    path = torch.as_tensor(path)
    if steps is not None:
        # re-fit the distinct points only, one batch of them all
        P, K = path.shape[-2:]
        steps = torch.as_tensor(steps, device=path.device).reshape(-1)
        paths = path.reshape(-1, P, K)
        xs = torch.as_tensor(x).to(path.device).reshape(paths.shape[0], -1)
        b, p = (torch.arange(P, device=path.device)[None] <= steps[:, None]).nonzero(
            as_tuple=True)
        fitted = _ols_debias_jax(D, xs[b], paths[b, p][:, None, :])[:, 0]
        idx = torch.minimum(torch.arange(P, device=path.device)[None], steps[:, None])
        out = fitted.new_zeros(paths.shape)
        out[b, p] = fitted
        return out.gather(1, idx[..., None].expand(-1, -1, K)).reshape(path.shape)
    x = torch.as_tensor(x).to(path.dtype if path.is_complex() else D.dtype)
    Dc = D.to(torch.promote_types(D.dtype, path.dtype))
    eps = torch.finfo(Dc.real.dtype if Dc.is_complex() else Dc.dtype).eps
    maskf = (path != 0).to(Dc.dtype)                       # (..., P, K)
    Dm = Dc * maskf[..., None, :]                          # (..., P, m, K)
    U, s, Vh = svd_thin(Dm)
    cut = eps * max(D.shape) * s.amax(dim=-1, keepdim=True)
    keep = s > cut
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    Utx = (U.conj().transpose(-1, -2) @ x.to(Dc.dtype)[..., None, :, None])[..., 0]
    sol = (Vh.conj().transpose(-1, -2) @ (s_inv.to(Dc.dtype) * Utx)[..., None])[..., 0]
    return maskf * sol


def _weights(weights, K: int, D: torch.Tensor) -> torch.Tensor:
    if weights is None:
        return torch.ones(K, dtype=D.real.dtype if D.is_complex() else D.dtype,
                          device=D.device)
    return torch.as_tensor(weights).to(D.device)


def lars_weighted_path_jax(D, x, alpha: float = 0.0, weights=None, scale: float = 1e3,
                           ols: bool = True, max_steps: int = 64):
    """Device version of :func:`lars_weighted_path`: returns (path (K,
    max_steps), alphas (max_steps,), n_steps) after dropping the zero
    point, with a leading batch dimension for x (B, m). Converged steps
    repeat the final point."""
    D = torch.as_tensor(D)
    x = torch.as_tensor(x).to(D)
    K = D.shape[1]
    w = _weights(weights, K, D).to(D.dtype)
    D_ = D / w[None, :]
    x_ = x * scale
    path, alphas, steps = lars_lasso_jax(D_, x_, alpha * scale / K, max_steps)
    if ols:
        path = _ols_debias_jax(D_, x_, path, steps)
    path = (path / w / scale).transpose(-1, -2)           # (..., K, max_steps + 1)
    return path[..., 1:], (alphas / scale)[..., 1:], steps


def _stack_complex(D: torch.Tensor, x: torch.Tensor):
    """[[Re D, -Im D], [Im D, Re D]] and [Re x; Im x] (x (..., m))."""
    Dr, Di = torch.real(D), (torch.imag(D) if D.is_complex() else torch.zeros_like(D))
    Ds = torch.cat([torch.cat([Dr, -Di], dim=1), torch.cat([Di, Dr], dim=1)], dim=0)
    xi = torch.imag(x) if x.is_complex() else torch.zeros_like(x)
    return Ds, torch.cat([torch.real(x), xi], dim=-1)


def lars_weighted_path_complex_jax(D, x, alpha: float = 0.0, weights=None,
                                   scale: float = 1e3, ols: bool = True,
                                   max_steps: int = 64):
    """Device version of :func:`lars_weighted_path_complex` (real stacking,
    the same half-atom caveat), batched as :func:`lars_weighted_path_jax`."""
    D = torch.as_tensor(D)
    x = torch.as_tensor(x).to(D.device)
    K = D.shape[1]
    Ds, xs = _stack_complex(D, x)
    w2 = None if weights is None else torch.cat([torch.as_tensor(weights)] * 2)
    path_s, alphas, steps = lars_weighted_path_jax(Ds, xs, alpha, w2, scale, ols,
                                                   max_steps)
    return torch.complex(path_s[..., :K, :], path_s[..., K:, :]), alphas, steps


def complex_lasso_path_jax(D, x, alpha_min: float = 0.0, max_steps: int = 64,
                           iters: int = 300) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device complex-LASSO path: warm-started FISTA (``iters`` steps) on
    each point of the geometric alpha grid ``max|D^H x| -> max(alpha_min,
    1e-6 max|D^H x|)`` of ``max_steps + 1`` points. The rotation-invariant
    modulus penalty of :func:`lars_lasso_path_complex_np`, sampled on the
    grid rather than at the events. Returns ``(path (max_steps + 1, K)
    complex, alphas)``, with a leading batch dimension for x (B, m)."""
    D = torch.as_tensor(D)
    x = torch.as_tensor(x)
    cdtype = torch.promote_types(D.dtype, x.dtype)
    if not cdtype.is_complex:
        raise TypeError("complex_lasso_path_jax needs a complex problem "
                        "(use lars_lasso_jax)")
    D = D.to(cdtype)
    x, single = _batched(x.to(D))
    K = D.shape[1]
    Dh = D.conj().T
    G = Dh @ D
    cx = x @ Dh.T                                          # (B, K): D^H x
    L = max(float(torch.linalg.eigvalsh(G)[-1]), 1e-30)
    rdt = G.real.dtype
    lam0 = cx.abs().amax(dim=1)
    floor = torch.clamp(1e-6 * lam0, min=alpha_min)
    r = (floor / torch.clamp(lam0, min=1e-300)) ** (1.0 / max(max_steps, 1))
    alphas = lam0[:, None] * r[:, None] ** torch.arange(max_steps + 1, dtype=rdt,
                                                        device=D.device)[None]

    def prox(z, t):
        a = z.abs()
        shrink = torch.clamp(1.0 - t / torch.where(a > 0, a, torch.ones_like(a)), min=0.0)
        return torch.where(a > t, shrink * z, torch.zeros_like(z))

    Gt = G.T
    beta = torch.zeros_like(cx)
    path = []
    for p in range(max_steps + 1):
        t_step = (alphas[:, p] / L)[:, None]
        b, y, t = beta, beta, 1.0
        for _ in range(iters):
            b_new = prox(y - (y @ Gt - cx) / L, t_step)
            t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
            y = b_new + ((t - 1.0) / t_new) * (b_new - b)
            b, t = b_new, t_new
        beta = b
        path.append(beta)
    path = torch.stack(path, dim=1)
    if single:
        return path[0], alphas[0]
    return path, alphas


def lars_weighted_path_group_jax(D, x, alpha: float = 0.0, weights=None,
                                 scale: float = 1e3, ols: bool = True,
                                 max_steps: int = 64, iters: int = 300):
    """Device version of :func:`lars_weighted_path_group` (the FISTA grid
    path): returns ``(path (K, max_steps), alphas (max_steps,), n_steps)``
    as :func:`lars_weighted_path_jax` does (the grid is always used in
    full, so ``n_steps == max_steps``), batched the same way."""
    D = torch.as_tensor(D)
    x = torch.as_tensor(x).to(D.device)
    K = D.shape[1]
    w = _weights(weights, K, D).to(D.dtype)
    D_ = D / w[None, :]
    x_ = x * scale
    path, alphas = complex_lasso_path_jax(D_, x_, alpha_min=alpha * scale / K,
                                          max_steps=max_steps, iters=iters)
    if ols:
        path = _ols_debias_jax(D_, x_, path)
    path = (path / w.to(path.dtype) / scale).transpose(-1, -2)
    return path[..., 1:], (alphas / scale)[..., 1:], torch.tensor(max_steps)
