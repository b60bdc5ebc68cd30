"""Matrix-free SCM: certified stability constants of the stencil families.

Counterpart of ``rla4mor_tpu/mor/scm_matfree.py``. ``mor/scm.py`` builds
every term dense; the stencil families run at millions of DoF, where only
applies exist. This module keeps the SCM's semantics (the LP over term
boxes and anchors, its greedy fit: ``mor/scm.py::ScmHermitian``) and
replaces the two dense eigensolve sites by a matrix-free one:

* :func:`lobpcg_gen`, a generalized block LOBPCG for the smallest
  eigenpairs of a Hermitian pencil ``(T, R)`` given its applies
  ``U -> T U``, ``U -> R U`` on (n, b) column blocks and a preconditioner
  ``U ~ R^-1 U``. The (n, .) applies and basis updates run on the block's
  device; the small (<= 3b) Gram problems on the host in float64 / complex128
  with scipy, as in the JAX package.
* Bauer-Fike enclosures: a Ritz pair (theta, u) carries the radius
  ``rho = ||T u - theta R u||_{R^-1} / ||u||_R``, and some eigenvalue lies
  in [theta - rho, theta + rho]. Boxes are widened by rho outward and
  anchor constraints lowered by rho, so every LP ingredient errs on the safe
  side. The enclosure certifies the eigenvalue nearest theta; whether that
  is the extreme one is defended at run time (:func:`lobpcg_gen_checked`:
  independent restarts must agree beyond their radii; ``gap_margin``).
* The upper bound stays rigorous unconditionally: the anchors' Rayleigh
  coordinates ``u^H T_q u / u^H R u`` lie in the constraint set for any u.

Ported as intended, not as written (ROADMAP.md queue 3): the restarts'
``informative`` test is floored by the pencil's scale where the solved
quantity is a box edge (:func:`spectral_interval`); each run names its stop
(``GenEigResult.stop``: a 10x grace band no longer passes silently for a
met tolerance); the inf-sup boxes' absolute tolerance falls back to the
class's own ``tol``. The TPU workarounds are not carried over: there is no
scoped x64 (torch always has float64: the two-stage solve is a plain
float32 run and a float64 polish), no host-transfer chokepoint for complex
arrays, no chunked inner solves and no ``nojit``. On a mesh (``lobpcg_gen(mesh=)``,
``MatrixFreeScmHermitian(mesh=)``, ``MatrixFreeScmCoercivity(mesh=)``) each
rank holds its rows of the iterates, and every Gram product, column norm and
inner product is all-reduced over the ``"dof"`` group (in float64 where the
host solves it) before the small host problems, which every rank solves
alike.

Online, the bounds are the inherited host LP per parameter.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.linalg as sla
import torch

from rla4mor_tpu_torch.core.parameters import Mu
from rla4mor_tpu_torch.core.solvers import ColumnCG, cg
from rla4mor_tpu_torch.mor.scm import ScmHermitian, _coefficients_host
from rla4mor_tpu_torch.ops.seeding import generator
from rla4mor_tpu_torch.utils.config import resolve_device
from rla4mor_tpu_torch.utils.logger import get_logger

Apply = Callable[[torch.Tensor], torch.Tensor]  # (n, b) -> (n, b), linear



# ---------------------------------------------------------------------------
# Keys: an int seed or a tuple path of ints, drawn through ops/seeding.py
# ---------------------------------------------------------------------------


def _key(key) -> tuple:
    return tuple(int(k) for k in key) if isinstance(key, (tuple, list)) else (int(key),)


def fold_in(key, i: int) -> tuple:
    """The stream ``i`` under ``key`` (``jax.random.fold_in``'s role)."""
    return _key(key) + (int(i),)


def _randn(key, shape, dtype, device) -> torch.Tensor:
    """Standard normal block of stream ``key`` (complex: E|z|^2 = 1), drawn
    on the CPU and moved to ``device``, so it does not depend on the device."""
    return torch.randn(shape, generator=generator(*_key(key)), dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# Generalized LOBPCG (smallest eigenpairs of a Hermitian pencil)
# ---------------------------------------------------------------------------


@dataclass
class GenEigResult:
    values: np.ndarray      # (k,) Ritz values, ascending
    vectors: torch.Tensor   # (n, k) R-orthonormal Ritz vectors
    radii: np.ndarray       # (k,) Bauer-Fike radii ||r||_{R^-1} / ||x||_R
    iterations: int
    converged: bool
    # (theta_{k+1} - rho_{k+1}) - (theta_k + rho_k): > 0 means the wanted
    # enclosures are disjoint from the next Ritz pair's; <= 0 flags a cluster
    gap_margin: float = float("nan")
    # lobpcg_gen_checked: the largest relative disagreement of the restarts
    # beyond their combined radii (NaN when no restart ran)
    restart_disagreement: float = float("nan")
    # bare lobpcg_gen: == converged; lobpcg_gen_checked: converged, every run
    # informative and the restarts in agreement. The SCM classes AND it in
    certified: bool = True
    # why the iteration ended: 'tol' (the tolerance met); 'grace' (a plateau,
    # span or iteration-cap exit inside the 10x grace band: converged all
    # the same, as in the JAX package); 'plateau', 'span', 'iters' (that exit
    # outside the band: not converged)
    stop: str = "tol"
    # lobpcg_gen_checked: the largest radius / max(|theta|, floor) over the
    # runs (the informative test holds it to restart_radius_rtol)
    restart_radius_ratio: float = float("nan")
    # lobpcg_gen_checked: recheck(floor) re-decides the verdict with a scale
    # floor taken from the pencil (spectral_interval's other box edge)
    recheck: Optional[Callable[[float], None]] = field(default=None, repr=False)
    # each LOBPCG stage of this run as (dtype, iterations, stop): one for
    # lobpcg_gen, the float32 warm start and the polish for the two-stage
    stages: tuple = ()
    # lobpcg_gen_checked: every run's theta, radius, converged and stages
    runs: tuple = ()


def _host(x: torch.Tensor) -> np.ndarray:
    """A small device tensor on the host in float64 / complex128."""
    x = x.detach().cpu()
    return x.to(torch.complex128 if x.is_complex() else torch.float64).numpy()


def _herm(a: np.ndarray) -> np.ndarray:
    return 0.5 * (a + a.conj().T)


def lobpcg_gen(
    apply_T: Apply,
    apply_R: Apply,
    n: int,
    k: int = 1,
    block: int = 4,
    precond: Optional[Apply] = None,
    iters: int = 200,
    tol: float = 1e-9,
    key=0,
    dtype=torch.float64,
    x0: Optional[torch.Tensor] = None,
    rsolve_tol: float = 1e-12,
    rsolve_maxiter: int = 2000,
    project: Optional[Apply] = None,
    identity_R: bool = False,
    eig_relative_tol: bool = False,
    plateau: int = 0,
    device=None,
    mesh=None,
    mesh_axis: str = "dof",
) -> GenEigResult:
    """Smallest ``k`` eigenpairs of the Hermitian pencil ``(T, R)``.

    Locally optimal block preconditioned CG (Knyazev 2001), Rayleigh-Ritz
    over [X, W, P] each iteration. ``precond`` approximates R^-1 (a V-cycle,
    Jacobi, an inner CG; the identity when None). Convergence is declared on
    the proxy ``||T x - theta R x||_2 / ||R x||_2 <= tol`` (times
    ``|theta_i|`` with ``eig_relative_tol``, which a pencil whose smallest
    eigenvalue lies orders below ``||T||`` needs: an absolute tol there
    "converges" with a radius larger than the eigenvalue) for the first k
    pairs; the returned radii are the Bauer-Fike radii, one preconditioned
    CG solve with R a pair at the end (``identity_R``: R = I on the
    iteration subspace, no solve). An R-solve that does not reach
    ``rsolve_tol`` raises: an inexact z ~ R^-1 r makes sqrt(r . z) a lower
    bound of ||r||_{R^-1}, an invalid enclosure.

    ``project``: orthogonal projector onto the admissible subspace, applied
    to the start block and each preconditioned residual (the stencil pencils
    are singular on the masked Dirichlet ring). ``plateau`` > 0 stops once
    the residual has not fallen by 2% for that many iterations. The plateau,
    span(X) and iteration-cap exits set ``converged`` inside a 10x grace
    band of the tolerance, as the JAX package does; ``stop`` says which exit
    ended the run. The start block is ``x0`` or a normal block of
    stream ``key`` on ``device`` (default: ``x0``'s, else the current card).

    ``mesh``: the iterates are row-sharded over ``mesh_axis`` (rank i holds
    rows ``[i n / p, (i + 1) n / p)``; ``x0`` then is the rank's rows, and
    the drawn start block the rank's rows of the one-device one), the
    applies act on the rank's rows (exchanging what they need), and every
    reduction over the rows is all-reduced: the run equals the unsharded
    one up to the order of the sums.
    """
    from rla4mor_tpu_torch.parallel import mesh as pm

    b = max(int(block), int(k))
    group = None if mesh is None else pm.axis_group(mesh, mesh_axis)
    r0, r1 = (0, n) if mesh is None else pm.row_range(n, mesh, mesh_axis)
    if x0 is None:
        X = _randn(key, (n, b), dtype, resolve_device(device))[r0:r1]
    else:
        X = torch.as_tensor(x0).to(dtype=dtype)
        if tuple(X.shape) != (r1 - r0, b):
            raise ValueError(f"x0 has shape {tuple(X.shape)}, not ({r1 - r0}, {b})")

    def gram(A, *Bs):
        """A^H B for each B on the host in float64 / complex128, summed over
        the ranks in one reduction."""
        Gs = [A.mH @ B for B in Bs]
        if group is not None:
            G = torch.stack(Gs)
            G = pm.all_reduce(G.to(torch.complex128 if G.is_complex() else torch.float64),
                              group)
            Gs = list(G.unbind(0))
        out = [_host(G) for G in Gs]
        return out[0] if len(out) == 1 else out

    def dev_gram(A, B) -> torch.Tensor:
        G = A.mH @ B
        return G if group is None else pm.all_reduce(G, group)

    def colnorms(*blocks) -> np.ndarray:
        if group is None:
            return _host(torch.stack([torch.linalg.vector_norm(B, dim=0) for B in blocks]))
        sq = torch.stack([(B.abs() ** 2).sum(dim=0) for B in blocks]).to(torch.float64)
        return np.sqrt(_host(pm.all_reduce(sq, group)))

    def vdot(a, c) -> float:
        d = torch.vdot(a, c)
        return float((d if group is None else pm.all_reduce(d, group)).real)
    if project is not None:
        X = project(X)
    M0 = precond if precond is not None else (lambda U: U)
    M = M0 if project is None else (lambda U: project(M0(U)))
    real = X.real.dtype

    P = None
    it = 0
    converged = False
    stop = "iters"
    drop_tol = 1e-12  # whitening rank cutoff (relative)
    best_rel = np.inf  # plateau detector state
    last_improve = 0
    rel = thresh = None

    for it in range(1, iters + 1):
        bx = X.shape[1]
        TX = apply_T(X)
        RX = apply_R(X)
        H, G = gram(X, TX, RX)
        theta = np.sort(np.real(sla.eigvalsh(_herm(H), _herm(G))))[:bx]
        # after Rayleigh-Ritz the columns of X are Ritz vectors, ascending
        Res = TX - RX * torch.as_tensor(theta, dtype=real, device=X.device)[None, :]
        nums = colnorms(Res, RX)
        rel = nums[0] / np.maximum(nums[1], 1e-300)
        if eig_relative_tol:
            thresh = tol * np.maximum(np.abs(theta), 1e-300)
        else:
            thresh = np.full(bx, tol)
        if np.all(rel[:k] <= thresh[:k]) and it > 1:
            converged, stop = True, "tol"
            break
        # plateau stop (opt-in): the residual has stayed flat (within 2%)
        # for `plateau` iterations; a slow but steady converger keeps going
        cur = float(np.max(rel[:k] / np.maximum(thresh[:k], 1e-300)))
        if cur < 0.98 * best_rel:
            best_rel = cur
            last_improve = it
        elif plateau and it - last_improve >= plateau:
            converged = bool(np.all(rel[:k] <= 10 * thresh[:k]))
            stop = "grace" if converged else "plateau"
            break

        W = M(Res)
        # R-orthonormalise W against X (R-orthonormal after the first
        # Rayleigh-Ritz) and within itself: without it the Gram of [X, W, P]
        # degenerates as W -> 0 and the whitening puts a sqrt(eps) floor on
        # the Ritz vectors
        W = W - X @ dev_gram(RX, W)
        RW = apply_R(W)
        ww, Vw = sla.eigh(_herm(gram(W, RW)))
        keep_w = ww > 1e-10 * max(float(ww[-1]), 1e-300)
        if not keep_w.any():  # the residual is numerically in span(X)
            converged = bool(np.all(rel[:k] <= 10 * thresh[:k]))
            stop = "grace" if converged else "span"
            break
        W = W @ torch.as_tensor(Vw[:, keep_w] / np.sqrt(ww[keep_w]), dtype=W.dtype,
                                device=W.device)
        S = torch.cat([X, W] if P is None else [X, W, P], dim=1)
        RS = apply_R(S)
        TS = apply_T(S)
        G, Hm = (_herm(a) for a in gram(S, RS, TS))
        # whiten in the R inner product, dropping near-dependent directions
        w, V = sla.eigh(G)
        keep = w > drop_tol * max(float(w[-1]), 1e-300)
        Wh = V[:, keep] / np.sqrt(w[keep])
        vals, C = sla.eigh(_herm(Wh.conj().T @ Hm @ Wh))
        bb = min(b, C.shape[1])
        Cx = Wh @ C[:, :bb]                     # (m, bb) in S coordinates
        X_new = S @ torch.as_tensor(Cx, dtype=S.dtype, device=S.device)
        Cp = Cx.copy()
        Cp[:bx, :] = 0.0                        # P: the update outside old X
        P = S @ torch.as_tensor(Cp, dtype=S.dtype, device=S.device)
        X = X_new
    else:
        # the iteration cap: the same 10x grace band as the other exits (the
        # radii below are exact either way; converged is only the claim
        # that theta is extreme)
        if it:
            converged = bool(np.all(rel[:k] <= 10 * thresh[:k]))
            stop = "grace" if converged else "iters"

    # final Ritz data and the Bauer-Fike radii
    TX = apply_T(X)
    RX = apply_R(X)
    H, G = gram(X, TX, RX)
    vals, C = sla.eigh(_herm(H), _herm(G))
    C_dev = torch.as_tensor(C, dtype=X.dtype, device=X.device)
    Xr, TXr, RXr = X @ C_dev, TX @ C_dev, RX @ C_dev
    # one extra pair (k + 1) for the gap diagnostic only
    k_ext = min(k + 1, Xr.shape[1])
    radii = np.zeros(k_ext)
    for i in range(k_ext):
        r = TXr[:, i] - float(vals[i]) * RXr[:, i]
        if identity_R:
            z = r  # ||r||_{R^-1} = ||r||_2 exactly
        else:
            sol = cg(lambda v: apply_R(v[:, None])[:, 0], r,
                     precond=lambda v: M(v[:, None])[:, 0], tol=rsolve_tol,
                     maxiter=rsolve_maxiter, group=group)
            z = sol.x
            rn = float(sol.residual_norm)
            bn = (float(torch.linalg.vector_norm(r)) if group is None
                  else math.sqrt(max(vdot(r, r), 0.0)))
            if rn > 10 * rsolve_tol * max(bn, 1e-300):
                if i >= k:  # the diagnostic pair: its gap evidence is void
                    radii[i] = float("inf")
                    continue
                raise ValueError(
                    "lobpcg_gen: the Bauer-Fike R-solve did not converge (rel residual "
                    f"{rn / max(bn, 1e-300):.1e} > {rsolve_tol:.0e}); raise "
                    "rsolve_maxiter, or pass identity_R=True when R is the identity on "
                    "the iteration subspace.")
        num = math.sqrt(max(vdot(r, z), 0.0))
        den = math.sqrt(max(vdot(Xr[:, i], RXr[:, i]), 1e-300))
        radii[i] = num / den
    gap_margin = float("nan")
    if k_ext > k:
        gap_margin = float((np.real(vals[k]) - radii[k])
                           - (np.real(vals[k - 1]) + radii[k - 1]))
    return GenEigResult(values=np.real(vals[:k]), vectors=Xr[:, :k], radii=radii[:k],
                        iterations=it, converged=converged, gap_margin=gap_margin,
                        certified=bool(converged), stop=stop,
                        stages=((str(X.dtype).replace("torch.", ""), it, stop),))


def lobpcg_gen_two_stage(
    apply_T: Apply,
    apply_R: Apply,
    n: int,
    k: int = 1,
    block: int = 4,
    precond: Optional[Apply] = None,
    iters: int = 200,
    tol: float = 1e-8,
    key=0,
    x0: Optional[torch.Tensor] = None,
    f32_tol: float = 3e-6,
    f32_iters: int = 100,
    **kw,
) -> GenEigResult:
    """A float32 LOBPCG to a loose tolerance, then a float64 polish started
    from its Ritz vectors: float32 stalls at a rounding floor where the
    float64-evaluated radius is a large fraction of the eigenvalue, and the
    polish shrinks it to a certificate. ``dtype=torch.complex128`` runs
    complex64 then complex128 (the damped Helmholtz pencils). The applies
    and ``precond`` follow their operand's dtype.

    The polish block is the k warm vectors filled up to ``max(k + 1,
    block)`` with normal columns: a k-column polish stalls on clustered
    extremes."""
    req = kw.pop("dtype", torch.float64)
    d32, d64 = ((torch.complex64, torch.complex128) if req.is_complex
                else (torch.float32, torch.float64))
    k1, k2 = fold_in(key, 1), fold_in(key, 2)
    warm = lobpcg_gen(apply_T, apply_R, n, k=k, block=block, precond=precond,
                      iters=f32_iters, tol=f32_tol, key=k1, dtype=d32,
                      x0=None if x0 is None else torch.as_tensor(x0).to(d32), **kw)
    b2 = max(k + 1, int(block))
    dev = warm.vectors.device
    fresh = _randn(k2, (n, b2 - k), d64, dev)
    if kw.get("mesh") is not None:  # the rank's rows of the one-device block
        from rla4mor_tpu_torch.parallel.mesh import row_range

        r0, r1 = row_range(n, kw["mesh"], kw.get("mesh_axis", "dof"))
        fresh = fresh[r0:r1]
    x64 = torch.cat([warm.vectors[:, :k].to(d64), fresh], dim=1)
    project = kw.get("project")
    if project is not None:
        x64 = project(x64)
    res = lobpcg_gen(apply_T, apply_R, n, k=k, block=b2, precond=precond, iters=iters,
                     tol=tol, key=k2, dtype=d64, x0=x64, **kw)
    res.stages = warm.stages + res.stages
    return res


def _restart_verdict(runs: list, k: int, floor: float) -> tuple[float, list]:
    """(the restarts' disagreement, each wanted pair's radius ratio) with the
    scale ``max(|theta|, floor)`` in both denominators."""
    dis = 0.0
    for a in range(len(runs)):
        for bi in range(a + 1, len(runs)):
            ra, rb = runs[a], runs[bi]
            for i in range(k):
                ta, tb = float(ra.values[i]), float(rb.values[i])
                excess = max(abs(ta - tb) - float(ra.radii[i]) - float(rb.radii[i]), 0.0)
                dis = max(dis, excess / max(abs(ta), abs(tb), floor, 1e-300))
    ratios = [float(r.radii[i]) / max(abs(float(r.values[i])), floor, 1e-300)
              for r in runs for i in range(k)]
    return dis, ratios


def lobpcg_gen_checked(
    apply_T: Apply,
    apply_R: Apply,
    n: int,
    k: int = 1,
    restarts: int = 1,
    agree_rtol: float = 1e-4,
    restart_radius_rtol: float = 0.1,
    base_solver: Callable = lobpcg_gen,
    precond: Optional[Apply] = None,
    key=0,
    x0: Optional[torch.Tensor] = None,
    **kw,
) -> GenEigResult:
    """The defended extreme eigensolve. A Bauer-Fike enclosure certifies
    that some eigenvalue lies in [theta - rho, theta + rho]; if the
    iteration converged to an interior eigenvalue, theta_min - rho can
    exceed the true extreme and a "certified" bound built on it is wrong.
    This runs the primary solve and ``restarts`` independent ones (streams
    ``fold_in(key, j)``: fresh start blocks) and checks that the wanted Ritz
    values agree beyond their combined radii,

        dis = max_pairs (|theta_a - theta_b| - rho_a - rho_b)_+ / scale,

    and that every run is informative, ``rho_i <= restart_radius_rtol *
    scale`` (a wide-radius restart would agree with anything), with
    ``scale = max(|theta_a|, |theta_b|)`` / ``|theta_i|``. ``certified``:
    the returned run (the one with the smallest theta_1) converged, every
    run is informative and ``dis <= agree_rtol``.

    Ported as intended: ``result.recheck(floor, atol)`` re-decides the
    verdict with ``scale`` floored at ``max(floor, atol /
    restart_radius_rtol)``. :func:`spectral_interval` floors a box edge's
    check by the pencil's own scale, the larger magnitude of its two edges
    (the pencil's spectral radius, from below): a PSD term's lower edge sits
    at 0, where a purely |theta|-relative test can never pass, while what
    the LP needs of an edge is accuracy against the box's width. A term that
    vanishes to rounding has no scale (the damped Helmholtz pencils' Im
    cross term i (KM - MK): K and M commute on the uniform grid): there
    ``atol``, the absolute tolerance the box solve was asked for, is the
    accuracy wanted, and a radius within it is informative. An anchor keeps
    the |theta|-relative check: its value is the bound itself, and there a
    floor would let a wide-radius restart mask an interior convergence.
    ``restart_radius_ratio`` reports the largest radius / scale, so a reader
    sees how close a run came to ``restart_radius_rtol``."""
    if x0 is not None:  # the restarts draw their starts on x0's device
        kw.setdefault("device", torch.as_tensor(x0).device)
    runs = []
    for j in range(restarts + 1):
        runs.append(base_solver(apply_T, apply_R, n, k=k, precond=precond, key=fold_in(key, j),
                                x0=x0 if j == 0 else None, **kw))
    best = min(runs, key=lambda r: float(r.values[0]))
    best.runs = tuple(dict(theta=float(r.values[0]), radius=float(r.radii[0]),
                           converged=bool(r.converged), stages=r.stages) for r in runs)

    def recheck(floor: float = 0.0, atol: float = 0.0) -> None:
        floor = max(float(floor), float(atol) / restart_radius_rtol)
        dis, ratios = _restart_verdict(runs, k, floor)
        informative = all(r <= restart_radius_rtol for r in ratios)
        best.restart_disagreement = dis
        best.restart_radius_ratio = float(np.max(ratios)) if ratios else float("nan")
        best.certified = bool(best.converged and informative and dis <= agree_rtol)

    recheck(0.0)
    best.recheck = recheck
    return best


def spectral_interval(
    apply_T: Apply,
    apply_R: Apply,
    n: int,
    precond: Optional[Apply] = None,
    solver: Callable = lobpcg_gen,
    precond_hi="same",
    **kw,
) -> tuple[float, float, GenEigResult, GenEigResult]:
    """Safe outer enclosure [lo, hi] of the spectrum of (T, R):
    ``lo = theta_min - rho_min``, ``hi = theta_max + rho_max``.

    ``precond_hi``: the preconditioner of the max side (the -T solve);
    ``'same'`` reuses ``precond``. An inverse-iteration preconditioner tuned
    for lambda_min damps exactly the modes the max side needs: pass None
    there when ``precond ~ A^-1`` (``l2_interior_scm`` does). A defended
    solver's two verdicts are floored by max(|theta_min|, |theta_max|) and
    by the absolute ``tol`` the solves ran to (:func:`lobpcg_gen_checked`)."""
    key = kw.pop("key", 0)
    p_hi = precond if precond_hi == "same" else precond_hi
    lo_res = solver(apply_T, apply_R, n, precond=precond, key=fold_in(key, 1), **kw)
    hi_res = solver(lambda U: -apply_T(U), apply_R, n, precond=p_hi, key=fold_in(key, 2),
                    **kw)
    scale = max(abs(float(lo_res.values[0])), abs(float(hi_res.values[0])))
    atol = 0.0 if kw.get("eig_relative_tol") else float(kw.get("tol", 0.0))
    for res in (lo_res, hi_res):
        if res.recheck is not None:
            res.recheck(scale, atol)
    lo = float(lo_res.values[0] - lo_res.radii[0])
    hi = float(-hi_res.values[0] + hi_res.radii[0])
    return lo, hi, lo_res, hi_res


# ---------------------------------------------------------------------------
# Matrix-free SCM engine (ScmHermitian's LP, anchors and greedy fit)
# ---------------------------------------------------------------------------


class MatrixFreeScmHermitian(ScmHermitian):
    """SCM for alpha(mu) = lambda_min(sum_q c_q(mu) T_q, R) with the
    Hermitian terms given as applies on (n, b) blocks.

    The LP, the upper bound and the greedy fit are
    :class:`~rla4mor_tpu_torch.mor.scm.ScmHermitian`'s; the two eigensolve
    sites (the term boxes and the anchors' ``alpha_exact``) run the LOBPCG.
    An anchor's constraint value is the safe side theta_min - rho of its
    enclosure. ``boxes``: rigorous a-priori term boxes (the stencil families'
    ``term_box_bounds``), which skip the 2 n_terms box eigensolves; a looser
    box only enlarges the LP's feasible set. ``restarts`` > 0 runs every site
    through :func:`lobpcg_gen_checked`, and ``certified`` ANDs their
    verdicts. ``box_tol``: an absolute tolerance for the box solves (near-zero
    edges never meet a |theta|-relative one). The iterates live on
    ``device`` (default: the current card)."""

    def __init__(
        self,
        term_applies: Sequence[Apply],
        theta_fn: Callable[[Mu], np.ndarray],
        apply_R: Apply,
        n: int,
        precond: Optional[Apply] = None,
        block: int = 4,
        iters: int = 300,
        tol: float = 1e-9,
        key=0,
        dtype=torch.float64,
        log_level: int = 20,
        project: Optional[Apply] = None,
        two_stage: bool = False,
        rsolve_tol: float = 1e-12,
        rsolve_maxiter: int = 2000,
        identity_R: bool = False,
        f32_tol: float = 3e-6,
        f32_iters: int = 100,
        restarts: int = 0,
        agree_rtol: float = 1e-4,
        precond_hi="same",
        box_tol: Optional[float] = None,
        eig_relative_tol: bool = False,
        boxes: Optional[Sequence[tuple]] = None,
        plateau: int = 0,
        device=None,
        mesh=None,
        mesh_axis: str = "dof",
    ):
        # ScmHermitian.__init__ builds dense terms: its state is set here
        self.device = resolve_device(device)
        self.terms = list(term_applies)
        self.theta_fn = theta_fn
        self.apply_R = apply_R
        self.n = int(n)
        self.precond = precond
        base_solver = lobpcg_gen_two_stage if two_stage else lobpcg_gen
        if restarts > 0:
            def solver(*args, **kws):
                return lobpcg_gen_checked(*args, restarts=restarts, agree_rtol=agree_rtol,
                                          base_solver=base_solver, **kws)

            self._solver = solver
        else:
            self._solver = base_solver
        self._eig_kw = dict(block=block, iters=iters, tol=tol, dtype=dtype, project=project,
                            rsolve_tol=rsolve_tol, rsolve_maxiter=rsolve_maxiter,
                            identity_R=identity_R, eig_relative_tol=eig_relative_tol,
                            plateau=plateau, device=self.device)
        if two_stage:
            self._eig_kw.update(f32_tol=f32_tol, f32_iters=f32_iters)
        self._group = None
        if mesh is not None:
            # the iterates row-sharded over the mesh: every eigensolve, its
            # applies and its Bauer-Fike CG run on the rank's rows
            from rla4mor_tpu_torch.parallel.mesh import axis_group

            self._eig_kw.update(mesh=mesh, mesh_axis=mesh_axis)
            self._group = axis_group(mesh, mesh_axis)
        self.certified = True
        self.anchor_diagnostics: list[dict] = []
        self.box_diagnostics: list[dict] = []
        self._logger = get_logger("mor.scm_matfree", log_level)
        self._key = _key(key)
        self.anchor_mus: list = []
        self.anchor_thetas = np.zeros((0, len(self.terms)))
        self.anchor_alphas = np.zeros((0,))
        self.anchor_ystars = np.zeros((0, len(self.terms)))

        if boxes is not None:
            self.box = [(float(lo), float(hi)) for lo, hi in boxes]
            if len(self.box) != len(self.terms):
                raise ValueError(f"boxes: got {len(self.box)} for {len(self.terms)} terms")
            self.box_radii = [(0.0, 0.0)] * len(self.box)
            for q, (lo, hi) in enumerate(self.box):
                self._logger.info("term %d box: [%.6e, %.6e] (analytic)", q, lo, hi)
            return

        box_kw = dict(self._eig_kw)
        if box_tol is not None:
            box_kw.update(tol=float(box_tol), eig_relative_tol=False)
        self.box, self.box_radii = [], []
        for q, Tq in enumerate(self.terms):
            lo, hi, lo_res, hi_res = spectral_interval(
                Tq, apply_R, self.n, precond=precond, solver=self._solver,
                key=fold_in(self._key, q), precond_hi=precond_hi, **box_kw)
            self._logger.info(
                "term %d box: [%.6e, %.6e] (radii %.1e/%.1e, iters %d/%d, stop %s/%s, "
                "gap %.1e/%.1e, certified=%s/%s)", q, lo, hi, lo_res.radii[0],
                hi_res.radii[0], lo_res.iterations, hi_res.iterations, lo_res.stop,
                hi_res.stop, lo_res.gap_margin, hi_res.gap_margin, lo_res.certified,
                hi_res.certified)
            self.box.append((lo, hi))
            self.box_radii.append((float(lo_res.radii[0]), float(hi_res.radii[0])))
            self.box_diagnostics.append({side: _diagnostics(res) for side, res
                                         in (("lo", lo_res), ("hi", hi_res))})
            self.certified &= bool(lo_res.certified and hi_res.certified)

    def _assemble(self, theta):  # pragma: no cover - the dense path is gone
        raise NotImplementedError("MatrixFreeScmHermitian never assembles dense operators")

    def alpha_exact(self, mu: Mu):
        """(safe alpha(mu), y*) by the LOBPCG on sum_q theta_q T_q: alpha is
        theta_min - rho, the enclosure's lower edge; y* the Rayleigh
        coordinates of the Ritz vector, a member of Y whether or not the
        iteration converged."""
        th = [float(c) for c in self._theta(mu)]
        terms = self.terms

        def apply_A(U):
            out = None
            for c, Tq in zip(th, terms):
                if c == 0.0:
                    continue
                y = c * Tq(U)
                out = y if out is None else out + y
            return torch.zeros_like(U) if out is None else out

        res = self._solver(apply_A, self.apply_R, self.n, precond=self.precond,
                           key=fold_in(self._key, 1 + len(self.anchor_mus)), **self._eig_kw)
        u = res.vectors[:, :1]

        def dot(a, c) -> float:  # over the ranks' rows on a mesh
            d = torch.vdot(a, c)
            if self._group is not None:
                from rla4mor_tpu_torch.parallel.mesh import all_reduce

                d = all_reduce(d, self._group)
            return float(d.real)

        den = max(dot(u[:, 0], self.apply_R(u)[:, 0]), 1e-300)
        ystar = np.array([dot(u[:, 0], Tq(u)[:, 0]) / den for Tq in terms])
        alpha_safe = float(res.values[0] - res.radii[0])
        diag = _diagnostics(res)
        self._logger.info(
            "anchor: alpha ~ %.6e (radius %.1e, iters %d, stop %s, converged=%s, gap %.1e, "
            "restart_dis %.1e, radius ratio %.1e, certified=%s)", diag["theta"],
            diag["radius"], res.iterations, res.stop, res.converged, res.gap_margin,
            res.restart_disagreement, res.restart_radius_ratio, res.certified)
        self.certified &= bool(res.certified)
        self.anchor_diagnostics.append(diag)
        return alpha_safe, ystar


def _diagnostics(res: GenEigResult) -> dict:
    return dict(theta=float(res.values[0]), radius=float(res.radii[0]),
                gap_margin=float(res.gap_margin),
                restart_disagreement=float(res.restart_disagreement),
                restart_radius_ratio=float(res.restart_radius_ratio),
                certified=bool(res.certified), converged=bool(res.converged),
                iterations=int(res.iterations), stop=res.stop, stages=res.stages,
                runs=res.runs)


def _flat_cols(grid_fn: Callable, grid_shape) -> Apply:
    """A grid -> grid linear map (leading batch dimensions allowed, as every
    stencil apply of the port) lifted to flattened (n,) vectors and (n, b)
    column blocks: the b columns go through as one batch of grids."""
    shape = tuple(grid_shape)

    def apply(U):
        if U.dim() == 1:
            return grid_fn(U.reshape(shape)).reshape(-1)
        b = U.shape[1]
        return grid_fn(U.T.reshape(b, *shape)).reshape(b, -1).T

    return apply


def _vcycle_cols(kappa: torch.Tensor, grid_shape) -> Apply:
    """One V-cycle on ``kappa`` (``models/multigrid.py``) on column blocks,
    in the operand's dtype (built once per dtype: the float32 stage and the
    float64 polish each precondition in their own)."""
    from rla4mor_tpu_torch.models.multigrid import make_vcycle

    cycles: dict = {}

    def grid_fn(g):
        if g.dtype not in cycles:
            cycles[g.dtype] = make_vcycle(kappa.to(g.real.dtype))
        return cycles[g.dtype](g)

    return _flat_cols(grid_fn, grid_shape)


def mg_flat_precond(fom) -> Apply:
    """Geometric multigrid ~R^-1 on column blocks for the 2-D stencil
    families (R the kappa = 1 stiffness); power-of-two ``num_intervals``."""
    N = fom.num_intervals
    return _vcycle_cols(torch.ones((N, N), dtype=torch.float64, device=fom.device),
                        fom.solution_shape)


def _interior_project(solution_shape, device) -> Optional[Apply]:
    """Orthogonal projector onto the interior subspace (the masked Dirichlet
    ring is the stencil pencils' common kernel)."""
    if len(solution_shape) == 2:
        from rla4mor_tpu_torch.models.stencil import interior_mask

        m = interior_mask(solution_shape[0], torch.float64, device).reshape(-1)
    elif len(solution_shape) == 3:
        from rla4mor_tpu_torch.models.stencil3d import interior_mask3

        m = interior_mask3(solution_shape[0], torch.float64, device).reshape(-1)
    else:  # pragma: no cover - no such family
        return None
    masks: dict = {}

    def project(U):
        if U.dtype not in masks:
            masks[U.dtype] = m.to(U.dtype)
        mask = masks[U.dtype]
        return U * (mask[:, None] if U.dim() == 2 else mask)

    return project


def _jacobi_cg_cols(matvec: Apply, diag: torch.Tensor, tol: float, maxiter: int) -> Apply:
    """U -> Jacobi-CG solution of the columns of U (``ColumnCG``, one solver
    a dtype, each replaying its chunks from a CUDA graph on the card)."""
    solvers: dict = {}

    def solve(U):
        if U.dtype not in solvers:
            d = diag.to(U.real.dtype)[:, None]
            solvers[U.dtype] = ColumnCG(matvec, precond=lambda r: r / d, tol=tol,
                                        maxiter=maxiter)
        return solvers[U.dtype](U).x

    return solve


def _unit_stiffness_diag(fom) -> torch.Tensor:
    """Flattened diagonal of the kappa = 1 stiffness, 1 on the ring (Jacobi
    of the h1_0 product)."""
    from rla4mor_tpu_torch.models.stencil import stiffness_diag_raw

    N = fom.solution_shape[0] - 1
    d = stiffness_diag_raw(torch.ones((N, N), dtype=torch.float64, device=fom.device))
    return torch.where(d > 0, d, torch.ones_like(d)).reshape(-1)


class MatrixFreeScmInfSup:
    """l2 matrix-free inf-sup SCM over the stencil protocol:
    beta_l2(mu)^2 = lambda_min(A(mu)^H A(mu), I | interior), the certified
    stability constant of the indefinite and complex families
    (``models/stencil_helmholtz.py``), where no coercivity constant exists
    and the dense :class:`~rla4mor_tpu_torch.mor.scm.ScmInfSup` cannot build
    the operator.

    The squared operator's pair expansion of the dense class, A^H A =
    sum_{q<=q'} eta_qq'(mu) G_qq', with the pair terms as composed applies
    G_qq' U = A_q^H (A_q' U) + A_q'^H (A_q U); complex coefficients
    (``fom.is_complex``, or ``complex_coeffs=``) add the Hermitian
    i (A_q^H A_q' - A_q'^H A_q) terms (the Re / Im split of ``mor/scm.py``)
    and run the LOBPCG in complex arithmetic.

    Certified bound: ||u - u_r||_2 <= ||A(mu) (u - u_r)||_2 / beta(mu) <=
    residual / lower(mu). ``precond='k2'`` preconditions the squared pencils
    with two nested Jacobi-CG solves on ``fom.product_apply`` (~ (K^2)^-1),
    each over the block's columns at once (``core/solvers.py::ColumnCG``).
    ``analytic_boxes``: pair boxes from ``fom.term_norm_bounds()`` (diagonal
    [0, N_q^2], cross [-2 N_q N_q', 2 N_q N_q']) instead of eigensolved ones.
    The iteration's defaults: ``identity_R``, ``precond_hi=None``,
    ``eig_relative_tol`` for the anchors and, for the boxes, the absolute
    ``box_tol`` = ``tol`` (:class:`MatrixFreeScmHermitian`'s default 1e-9
    when none is passed)."""

    def __init__(self, fom, precond="k2", cg_tol: float = 1e-2, cg_maxiter: int = 400,
                 complex_coeffs: Optional[bool] = None, analytic_boxes: bool = False,
                 **kw):
        self._fom = fom
        aff = fom.affine_operator()
        base_coeffs = tuple(aff.coefficients)
        self._base_coeffs = base_coeffs
        terms = list(aff.terms)
        T = len(terms)
        n = aff.source_dim
        is_cx = bool(getattr(fom, "is_complex", False) if complex_coeffs is None
                     else complex_coeffs)
        self._is_complex = is_cx

        def pair_apply(q: int, qp: int, part: str) -> Apply:
            tq, tqp = terms[q], terms[qp]
            if q == qp:
                return lambda U: tq.apply_adjoint(tq.apply(U))
            if part == "re":
                return lambda U: tq.apply_adjoint(tqp.apply(U)) + tqp.apply_adjoint(tq.apply(U))
            # i (A_q^H A_q' - A_q'^H A_q): Hermitian, complex entries
            return lambda U: 1j * (tq.apply_adjoint(tqp.apply(U))
                                   - tqp.apply_adjoint(tq.apply(U)))

        pair_applies, pairs = [], []
        for q in range(T):
            for qp in range(q, T):
                pair_applies.append(pair_apply(q, qp, "re"))
                pairs.append((q, qp, "re"))
                if is_cx and qp > q:
                    pair_applies.append(pair_apply(q, qp, "im"))
                    pairs.append((q, qp, "im"))
        self._pairs = pairs

        if analytic_boxes and kw.get("boxes") is None:
            if not hasattr(fom, "term_norm_bounds"):
                raise ValueError("analytic_boxes=True needs fom.term_norm_bounds()")
            Nn = [float(v) for v in fom.term_norm_bounds()]
            kw["boxes"] = [(0.0, Nn[q] * Nn[q]) if q == qp
                           else (-2.0 * Nn[q] * Nn[qp], 2.0 * Nn[q] * Nn[qp])
                           for q, qp, _ in pairs]

        def theta_fn(mu):
            th = _coefficients_host(base_coeffs, mu)
            if np.iscomplexobj(th) and not is_cx:
                if not np.allclose(th.imag, 0):
                    raise ValueError("complex coefficients need complex_coeffs=True (or "
                                     "fom.is_complex) for the Re / Im pair expansion")
                th = th.real
            out = np.empty(len(pairs))
            for i, (q, qp, part) in enumerate(pairs):
                z = np.conj(th[q]) * th[qp]
                out[i] = float(np.real(z) if part == "re" else np.imag(z))
            return out

        shape = fom.solution_shape
        if precond == "k2":
            if len(shape) != 2:
                raise ValueError("precond='k2' needs a 2-D stencil family; pass a callable "
                                 "preconditioner otherwise")
            solve_R = _jacobi_cg_cols(_flat_cols(fom.product_apply, shape),
                                      _unit_stiffness_diag(fom), cg_tol, cg_maxiter)

            def precond(U):  # ~ (K^2)^-1 on column blocks
                one = U.dim() == 1
                z = solve_R(solve_R(U[:, None] if one else U))
                return z[:, 0] if one else z
        elif precond in (None, "none"):
            precond = None

        kw.setdefault("project", _interior_project(shape, fom.device))
        kw.setdefault("identity_R", True)
        # the (K^2)^-1 preconditioner targets the smallest pair eigenvalues;
        # the sigma_max box sides run plain
        kw.setdefault("precond_hi", None)
        # lambda_min(A^H A) lies orders below ||A^H A|| at fine h: the anchors
        # converge |theta|-relative, the boxes absolute (a near-zero edge of
        # an indefinite cross pair never meets a relative threshold)
        kw.setdefault("eig_relative_tol", True)
        if kw["eig_relative_tol"]:
            kw.setdefault("box_tol", float(kw.get("tol", _MF_DEFAULT_TOL)))
        if is_cx:
            kw.setdefault("dtype", torch.complex128)
        kw.setdefault("device", fom.device)
        self.scm = MatrixFreeScmHermitian(pair_applies, theta_fn, lambda U: U, n,
                                          precond=precond, **kw)

    def fit(self, training_mus, tol: float = 0.1, max_anchors: int = 30) -> dict:
        return self.scm.fit(training_mus, tol=tol, max_anchors=max_anchors)

    def add_anchor(self, mu: Mu) -> float:
        return self.scm.add_anchor(mu)

    # -- the Weyl bound ----------------------------------------------------
    def _weyl_parts(self):
        """(betas, gammas): sqrt of the anchors' safe alphas, and sqrt of the
        upper box edge of each diagonal pair (q, q), sigma_max(A_q)^2's safe
        side."""
        betas = np.sqrt(np.maximum(self.scm.anchor_alphas, 0.0))
        diag = {q: i for i, (q, qp, part) in enumerate(self._pairs)
                if q == qp and part == "re"}
        gammas = np.sqrt([max(self.scm.box[diag[q]][1], 0.0) for q in sorted(diag)])
        return betas, gammas

    def _weyl_host(self, mus) -> np.ndarray:
        """The Weyl bound at each mu, unclamped (may be negative):
        max_j beta_j - sum_q |theta_q(mu) - theta_q(mu_j)| gamma_q."""
        mus = list(mus)
        if not self.scm.anchor_mus:
            return np.full(len(mus), -np.inf)
        betas, gammas = self._weyl_parts()
        th_ref = np.stack([_coefficients_host(self._base_coeffs, m)
                           for m in self.scm.anchor_mus])  # (J, T)
        out = np.empty(len(mus))
        for i, mu in enumerate(mus):
            th = _coefficients_host(self._base_coeffs, mu)
            out[i] = float(np.max(betas - np.abs(th[None, :] - th_ref) @ gammas))
        return out

    def fit_weyl_positive(self, sample_mus: Sequence[Mu], max_anchors: int = 30,
                          margin: float = 0.0) -> dict:
        """Anchor the sample where the Weyl bound is most negative until its
        minimum over ``sample_mus`` exceeds ``margin`` or ``max_anchors`` is
        reached. Returns ``{'positive', 'n_anchors', 'min_weyl': [per
        round], 'flagged'}``; ``flagged`` when the budget ran out with the
        bound still nonpositive somewhere (its certificates are inf there)."""
        mus = list(sample_mus)
        history = {"min_weyl": [], "n_anchors": 0, "positive": False, "flagged": False}
        if not self.scm.anchor_mus:
            self.add_anchor(mus[0])
        while True:
            wb = self._weyl_host(mus)
            worst = int(np.argmin(wb))
            history["min_weyl"].append(float(wb[worst]))
            if wb[worst] > margin:
                history["positive"] = True
                break
            if len(self.scm.anchor_mus) >= max_anchors:
                history["flagged"] = True
                self.scm._logger.warning(
                    "fit_weyl_positive: budget %d exhausted with min Weyl bound %.3e <= "
                    "%.3e: certificates are inf at such mu", max_anchors, wb[worst], margin)
                break
            self.add_anchor(mus[worst])
        history["n_anchors"] = len(self.scm.anchor_mus)
        return history

    def weyl_gap_report(self, mus: Sequence[Mu]) -> dict:
        """How much looser the Weyl bound is than the LP over ``mus``:
        per-mu ``weyl`` (raw), ``lp`` (beta units) and ``rel_gap = 1 -
        weyl / lp`` where lp > 0 (NaN elsewhere), ``max_rel_gap``,
        ``n_nonpositive``."""
        mus = list(mus)
        wb = self._weyl_host(mus)
        lp = self.tabulate(mus)
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = np.where(lp > 0, 1.0 - np.maximum(wb, 0.0) / lp, np.nan)
        return {"weyl": wb, "lp": lp, "rel_gap": rel,
                "max_rel_gap": (float(np.nanmax(rel)) if np.isfinite(rel).any()
                                else float("nan")),
                "n_nonpositive": int((wb <= 0).sum())}

    def weyl_bound(self):
        """beta_LB(mu) from the fit's own offline quantities, as a plain
        function of tensors (one Mu or a batched one): the Weyl perturbation
        bound :class:`~rla4mor_tpu_torch.mor.bounds.InfSupLowerBound` around
        the anchors, with beta_j the sqrt of the anchors' safe alphas and
        gamma_q the sqrt of the diagonal pairs' upper box edges. A
        nonpositive value maps to 0 (a downstream eta / beta is then inf,
        never a wrong finite certificate). ``.infsup`` is the raw bound,
        ``.certified`` the fit's verdict."""
        from rla4mor_tpu_torch.mor.bounds import InfSupLowerBound

        if not self.scm.anchor_mus:
            raise ValueError("weyl_bound needs at least one anchor: run fit() / "
                             "add_anchor() first")
        betas, gammas = self._weyl_parts()
        bound = InfSupLowerBound(self._fom, self.scm.anchor_mus, betas=betas, gammas=gammas)

        def beta_safe(mu):
            b = bound(mu)
            return torch.where(b > 0, b, torch.zeros_like(b))

        beta_safe.infsup = bound
        beta_safe.certified = bool(self.scm.certified)
        return beta_safe

    def lower(self, mu: Mu) -> float:
        return float(np.sqrt(max(self.scm.lower(mu), 0.0)))

    def upper(self, mu: Mu) -> float:
        ub = self.scm.upper(mu)
        if not np.isfinite(ub):
            return float("inf")
        return float(np.sqrt(max(ub, 0.0)))

    __call__ = lower

    def tabulate(self, mus) -> np.ndarray:
        return np.array([self.lower(mu) for mu in mus])

    @property
    def box(self):
        return self.scm.box

    @property
    def box_radii(self):
        return self.scm.box_radii

    @property
    def certified(self) -> bool:
        """Every offline eigensolve defense passed (:func:`lobpcg_gen_checked`;
        True when ``restarts=0`` left them off)."""
        return bool(self.scm.certified)

    @property
    def anchor_diagnostics(self):
        return self.scm.anchor_diagnostics


_MF_DEFAULT_TOL = 1e-9  # MatrixFreeScmHermitian's tol default


def l2_interior_scm(fom, mu_precond: Mu, cg_tol: float = 1e-2, cg_maxiter: int = 600,
                    precond_type: str = "cg", analytic_boxes: bool = True,
                    **kw) -> "MatrixFreeScmCoercivity":
    """The l2 SCM of a stencil FOM, the certificate of the sharded greedy's
    ROMs: their sketch is an unweighted l2 embedding, so ``estimate_error``
    approximates ||A(mu) U y - b||_2 and the matching stability constant is
    alpha_l2(mu) = lambda_min(sym A(mu), I) over the interior subspace. This
    builds :class:`MatrixFreeScmCoercivity` with R = I and an
    inverse-iteration preconditioner ~ A(mu_precond)^-1 (plain Jacobi
    cannot converge lambda_min(K, I) at millions of DoF: kappa ~ h^-2).
    Certified bound at mu: residual / ``lower(mu)``.

    ``precond_type``: ``'mg'``, one V-cycle on A(mu_precond)'s element field
    (the family's 2-D ``kappa()``; power-of-two element counts), spectrally
    equivalent to A^-1 at a fraction of an inner CG's cost; or ``'cg'``,
    Jacobi-CG on A(mu_precond) to ``cg_tol`` within ``cg_maxiter``, every
    column of the block at once (``ColumnCG``). ``analytic_boxes``: the
    family's ``term_box_bounds()`` instead of 2 n_terms box eigensolves (the
    lower edges are exact, a looser upper edge only enlarges the LP's
    feasible set)."""
    if analytic_boxes and hasattr(fom, "term_box_bounds"):
        kw.setdefault("boxes", fom.term_box_bounds())
    shape = fom.solution_shape
    if precond_type == "mg":
        precond = _vcycle_cols(fom.kappa(mu_precond, dtype=torch.float64), shape)
    elif precond_type == "cg":
        diag = fom.jacobi_diag(mu_precond).reshape(-1).to(torch.float64)
        solve = _jacobi_cg_cols(_flat_cols(lambda g: fom.apply(mu_precond, g), shape),
                                torch.where(diag != 0, diag, torch.ones_like(diag)),
                                cg_tol, cg_maxiter)

        def precond(U):
            one = U.dim() == 1
            sol = solve(U[:, None] if one else U)
            return sol[:, 0] if one else sol
    else:
        raise ValueError(f"precond_type must be 'cg' or 'mg': {precond_type!r}")
    # R = I: the radii need no inner solve; the inverse-iteration
    # preconditioner damps what the lambda_max side needs: that side runs plain
    kw.setdefault("identity_R", True)
    kw.setdefault("precond_hi", None)
    return MatrixFreeScmCoercivity(fom, apply_R=lambda U: U, precond=precond, **kw)


class MatrixFreeScmCoercivity(MatrixFreeScmHermitian):
    """Matrix-free SCM coercivity bound over the stencil-FOM protocol:
    alpha_LB(mu) <= lambda_min(sym A(mu), R), real coefficients
    (:class:`~rla4mor_tpu_torch.mor.scm.ScmCoercivity`'s semantics).

    ``fom`` needs ``affine_operator()`` (LinOp terms with ``apply`` /
    ``apply_adjoint`` on flattened columns: the 2-D and 3-D stencil
    families) and ``product_apply`` unless ``apply_R`` is given.
    ``precond``: ``'auto'`` (the V-cycle of R for a 2-D family with a
    power-of-two element count of at least 256, else Jacobi of R), ``'mg'``,
    None, or a callable on column blocks."""

    def __init__(self, fom, apply_R: Optional[Apply] = None, precond="auto", **kw):
        aff = fom.affine_operator()
        coeffs = tuple(aff.coefficients)

        def sym_apply(term):
            return lambda U: 0.5 * (term.apply(U) + term.apply_adjoint(U))

        shape = fom.solution_shape
        mesh = kw.get("mesh")
        if mesh is not None:
            # the rank's row slab: the terms, R and the projector on its rows;
            # Jacobi of R (the V-cycle runs on one device)
            if (not getattr(fom, "is_spd", False) or not hasattr(fom, "slab")
                    or len(shape) != 2):
                raise NotImplementedError(f"{type(fom).__name__}: the sharded SCM takes "
                                          "the symmetric 2-D families with a slab form")
            if precond not in ("auto", None, "none"):
                raise ValueError("on a mesh the preconditioner is Jacobi of R ('auto')")
            slab = fom.slab(mesh, kw.get("mesh_axis", "dof"))
            local = slab.local_shape
            terms = [_flat_cols(lambda g, q=q: slab.apply_term(q, g), local)
                     for q in range(slab.n_terms)]
            if apply_R is None:
                apply_R = _flat_cols(slab.product_apply, local)
            mask = slab.slab.mask(torch.float64, fom.device).reshape(-1)
            kw.setdefault("project", lambda U: U * mask.to(U.real.dtype)[:, None])
            d = _unit_stiffness_diag(fom).reshape(shape)[slab.slab.r0:slab.slab.r1].reshape(-1)
            precond = (lambda U: U / d.to(U.real.dtype)[:, None]) if precond == "auto" else None
        else:
            terms = [sym_apply(t) for t in aff.terms]
        if apply_R is None:
            apply_R = _flat_cols(fom.product_apply, shape)
        kw.setdefault("project", _interior_project(shape, fom.device))
        if mesh is None and precond == "auto":
            precond = None
            # MG pays once R's conditioning (~h^-2) dominates; below, the
            # cycle's depth costs more than the iterations it saves
            N = getattr(fom, "num_intervals", 0)
            if len(shape) == 2 and N and N & (N - 1) == 0 and N >= 256:
                precond = mg_flat_precond(fom)
            elif len(shape) == 2 and hasattr(fom, "jacobi_diag"):
                d = _unit_stiffness_diag(fom)

                def precond(U):
                    return U / d.to(U.real.dtype)[:, None]
        elif mesh is None and precond == "mg":
            precond = mg_flat_precond(fom)
        elif precond in (None, "none"):
            precond = None

        def theta_fn(mu):
            th = _coefficients_host(coeffs, mu)
            if np.iscomplexobj(th):
                if not np.allclose(th.imag, 0):
                    raise ValueError("MatrixFreeScmCoercivity needs real coefficients")
                th = th.real
            return np.asarray(th, np.float64)

        kw.setdefault("device", fom.device)
        super().__init__(terms, theta_fn, apply_R, aff.source_dim, precond=precond, **kw)
