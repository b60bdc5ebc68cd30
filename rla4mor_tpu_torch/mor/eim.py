"""Empirical interpolation (EIM / DEIM / MDEIM) for non-affine coefficients.

Counterpart of ``rla4mor_tpu/mor/eim.py``. The EIM greedy builds magic
points and a basis so that a non-affine parametric field is

    kappa(mu, .) ~= sum_q theta_q(mu) xi_q(.),   theta(mu) = T^-1 kappa(mu, points),

an affine surrogate whose coefficients need M point evaluations of the field
and one (M, M) unit-lower-triangular solve. DEIM (a POD basis with greedy
points, a dense solve) and MDEIM (the EIM greedy on the nonzeros of sparse
operator snapshots with one sparsity pattern) are the same interpolant.

The greedies run on the residual matrix R (n, m) of all training snapshots:
each step reads the column of largest sup norm, its largest entry p, and
updates R in place by the exact rank-1 recursion ``R -= b R[p, :]``, so
the sup norms of the columns are one reduction and the update one pass
over R with a bounded temporary. ``eim_greedy`` reads the two argmax
indices on the host each step (two syncs); ``eim_greedy_device`` keeps them
on the device and reads the chunk's sup history once a chunk. At float64
both select the same points and snapshots.

The online pieces (``coefficients``, ``error_indicator``, ``interpolate``)
take one field vector (M,) or a block of columns (M, b): the columns stand
in for the JAX package's ``vmap`` over parameters.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class EimInterpolant:
    """Magic-point interpolant ``g ~= basis @ coefficients(g[points])``.

    ``triangular`` marks the EIM construction (``interp_matrix`` is unit
    lower triangular: a triangular solve); DEIM uses a dense solve.
    ``sup_errors`` is the greedy's sup-norm error history (EIM) or the POD
    singular values (DEIM).

    The last ``n_reserve`` terms are certification only: interpolation uses
    the first M = ``n_terms``; the reserve points feed ``error_indicator``
    (the interpolation error at the next greedy points, a lower bound on
    the sup error)."""

    # (n, M + n_reserve); the greedies store it column-major (each basis
    # vector contiguous), so the (M, n) fields are a view
    basis: torch.Tensor
    points: torch.Tensor         # (M + n_reserve,) int64 flat field indices
    interp_matrix: torch.Tensor  # (M + R, M + R) = basis[points, :]
    triangular: bool
    sup_errors: Tuple[float, ...] = ()
    n_reserve: int = 0
    # training-snapshot column picked at each greedy step (EIM greedy only;
    # () for DEIM and rebuilt interpolants): feeds two-grid rebuilds
    snapshot_ids: Tuple[int, ...] = ()

    @property
    def n_terms(self) -> int:
        """Number of active interpolation terms (reserve excluded)."""
        return int(self.basis.shape[1]) - self.n_reserve

    @property
    def active_points(self) -> torch.Tensor:
        return self.points[: self.n_terms]

    @property
    def reserve_points(self) -> torch.Tensor:
        return self.points[self.n_terms:]

    def to(self, device=None, dtype=None) -> "EimInterpolant":
        """The same interpolant (points, basis, history) on ``device`` with
        its basis and matrix in ``dtype``: a float32 fit cast to float64 is
        the same surrogate evaluated in float64, where a float64 refit would
        pick other points."""
        return replace(self, basis=self.basis.to(device=device, dtype=dtype),
                       points=self.points.to(device=device),
                       interp_matrix=self.interp_matrix.to(device=device, dtype=dtype))

    def coefficients(self, g_at_points: torch.Tensor) -> torch.Tensor:
        """theta (M,) or (M, b) from the field's values at the active magic
        points ((M,) or (M, b))."""
        M = self.n_terms
        T = self.interp_matrix[:M, :M]
        g = torch.as_tensor(g_at_points).to(T)
        rhs = g[:, None] if g.dim() == 1 else g
        if self.triangular:
            out = torch.linalg.solve_triangular(T, rhs, upper=False, unitriangular=True)
        else:
            out = torch.linalg.solve(T, rhs)
        return out[:, 0] if g.dim() == 1 else out

    def error_indicator(self, g_at_all_points: torch.Tensor) -> torch.Tensor:
        """``max_j |g(p_{M+j}) - I_M[g](p_{M+j})|`` over the reserve points,
        from the field's values at all M + n_reserve magic points ((M+R,) or
        (M+R, b)): a lower bound on the sup-norm error; scalar or (b,)."""
        if self.n_reserve <= 0:
            raise ValueError("error_indicator: the interpolant has no reserve terms")
        M = self.n_terms
        g = torch.as_tensor(g_at_all_points).to(self.interp_matrix)
        theta = self.coefficients(g[:M])
        pred = self.interp_matrix[M:, :M] @ theta
        return (g[M:] - pred).abs().amax(dim=0)

    def truncate(self, n_terms: int, n_reserve: int = 0) -> "EimInterpolant":
        """The first ``n_terms`` active terms and the next ``n_reserve`` as
        reserve: for the EIM greedy, the greedy rerun with
        ``max_terms=n_terms`` (it is hierarchical)."""
        tot = n_terms + n_reserve
        if tot > self.basis.shape[1]:
            raise ValueError(f"truncate: {tot} terms of {self.basis.shape[1]}")
        return EimInterpolant(
            basis=self.basis[:, :tot], points=self.points[:tot],
            interp_matrix=self.interp_matrix[:tot, :tot], triangular=self.triangular,
            sup_errors=self.sup_errors[: tot + 1], n_reserve=n_reserve,
            snapshot_ids=self.snapshot_ids[:tot])

    def interpolate(self, g: torch.Tensor) -> torch.Tensor:
        """Interpolate full field snapshots g (n,) or (n, b)."""
        return self.reconstruct(self.coefficients(g[self.active_points]))

    def reconstruct(self, theta: torch.Tensor) -> torch.Tensor:
        return self.basis[:, : self.n_terms] @ theta.to(self.basis)


def _sups(R: torch.Tensor) -> torch.Tensor:
    """Sup norm of each column of R, without an |R| temporary."""
    return torch.linalg.vector_norm(R, ord=float("inf"), dim=0)


# the residual update's temporary: at most this many entries (256 MB in float32)
_UPDATE_ELEMS = 1 << 26


def _eim_step(R: torch.Tensor, j, p) -> torch.Tensor:
    """One greedy step on the residuals R, in place: column j's residual
    normalised at its entry p is the new basis vector b, and every column
    loses b times its row-p entry (b vanishes at the earlier magic points,
    so R stays zero there). ``j`` and ``p`` are ints or 0-d device tensors;
    a zero pivot (past an exactly-zero residual) gives a zero column.

    The update rounds the product before the subtraction, as the JAX
    package does (a fused ``addr_`` rounds once): mirrored entries of a
    symmetric family tie in their residuals, and the argmax then follows
    the last bit. It runs a block of columns at a time, so its temporary
    stays under ``_UPDATE_ELEMS`` entries."""
    r = R[:, j]
    rp = r[p]
    b = r / torch.where(rp == 0, torch.ones_like(rp), rp)
    row = R[p].clone()  # the row is overwritten by the update
    width = max(1, _UPDATE_ELEMS // R.shape[0])
    for c0 in range(0, R.shape[1], width):
        R[:, c0:c0 + width].sub_(b[:, None] * row[c0:c0 + width])
    return b


def _zero_interpolant(n: int, dtype, device, sup: float) -> EimInterpolant:
    """The zero field's interpolant: one arbitrary point, a zero basis."""
    return EimInterpolant(
        basis=torch.zeros((n, 1), dtype=dtype, device=device),
        points=torch.zeros((1,), dtype=torch.int64, device=device),
        interp_matrix=torch.zeros((1, 1), dtype=dtype, device=device),
        triangular=True, sup_errors=(sup,), snapshot_ids=(0,))


def _from_columns(B: torch.Tensor, pts, history, n_reserve: int,
                  snapshot_ids=()) -> EimInterpolant:
    points = torch.as_tensor(pts, dtype=torch.int64, device=B.device)
    return EimInterpolant(basis=B, points=points, interp_matrix=B[points, :],
                          triangular=True, sup_errors=tuple(float(s) for s in history),
                          n_reserve=n_reserve, snapshot_ids=tuple(int(j) for j in snapshot_ids))


def eim_greedy(G, tol: float = 1e-8, max_terms: Optional[int] = None,
               relative: bool = True, reserve: int = 0,
               inplace: bool = False) -> EimInterpolant:
    """EIM greedy over the training snapshots G (n, m_train), a host loop.

    Stops when the worst training snapshot's sup-norm interpolation error
    is at most ``tol`` (times the largest snapshot entry when
    ``relative``) or at ``max_terms``; ``reserve`` more steps give the
    reserve points of :meth:`EimInterpolant.error_indicator`. The basis is
    residual-normalised (1 at its own magic point), so ``interp_matrix`` is
    unit lower triangular. ``sup_errors`` logs the error before each term
    and after the last. ``inplace`` lets the greedy overwrite G with its
    residuals (no copy of G's size)."""
    G = torch.as_tensor(G)
    n, m = G.shape
    hard_cap = min(n, m)
    max_terms = hard_cap if max_terms is None else min(max_terms, hard_cap)
    scale = float(torch.linalg.vector_norm(G, ord=float("inf"))) if relative else 1.0
    scale = scale if scale > 0 else 1.0

    R = G if inplace else G.clone()
    cols, points, snap_ids, history = [], [], [], []
    n_active = None
    while True:
        err = _sups(R)
        j = int(torch.argmax(err))
        sup = float(err[j])
        history.append(sup)
        if n_active is None and (sup <= tol * scale or len(points) >= max_terms):
            n_active = len(points)
        # sup == 0: the residual is exactly zero, no point can grow
        if n_active is not None and (len(points) >= n_active + reserve or sup == 0.0
                                     or len(points) >= hard_cap):
            break
        p = int(torch.argmax(R[:, j].abs()))
        cols.append(_eim_step(R, j, p))
        points.append(p)
        snap_ids.append(j)
    if not points:
        return _zero_interpolant(n, G.dtype, G.device, history[0])
    return _from_columns(torch.stack(cols).T, points, history,
                         len(points) - n_active, snap_ids)


def eim_greedy_scan(G, n_steps: int, inplace: bool = False):
    """Exactly ``n_steps`` greedy steps with the argmax indices kept on the
    device (no host sync). Returns ``(basis (n, K), points (K,),
    snapshot_ids (K,), sups (K,), R (n, m))``: ``sups[k]`` is the training
    sup error before term k + 1 and ``R`` the final residuals, which a
    further call continues from. Steps past an exactly-zero residual give
    zero columns with ``sups == 0``. ``inplace`` overwrites G with R."""
    G = torch.as_tensor(G)
    R = G if inplace else G.clone()
    B = torch.empty((n_steps, G.shape[0]), dtype=G.dtype, device=G.device)
    pts, ids, sups = [], [], []
    for k in range(n_steps):
        err = _sups(R)
        j = torch.argmax(err)
        p = torch.argmax(R[:, j].abs())
        B[k] = _eim_step(R, j, p)
        pts.append(p)
        ids.append(j)
        sups.append(err[j])
    return B.T, torch.stack(pts), torch.stack(ids), torch.stack(sups), R


def eim_greedy_device(G, tol: float = 1e-8, max_terms: Optional[int] = None,
                      relative: bool = True, reserve: int = 0, chunk: int = 32,
                      inplace: bool = False) -> EimInterpolant:
    """:func:`eim_greedy`'s semantics in ``chunk``-step runs of
    :func:`eim_greedy_scan`, with one host read of the chunk's sup history,
    points and snapshots between chunks to stop early (at most ``chunk - 1``
    steps past the host loop's stop). The same truncation as the host loop
    (tol, ``reserve``, ``max_terms``, the zero field); at float64 the same
    points and snapshots. At float32 a late argmax can flip, and both
    remain valid greedies."""
    G = torch.as_tensor(G)
    n, m = G.shape
    hard_cap = min(n, m)
    max_terms = hard_cap if max_terms is None else min(max_terms, hard_cap)
    budget = min(max_terms + reserve, hard_cap)
    chunk = max(1, min(chunk, budget))

    Bs, pts_l, ids_l, sups_l = [], [], [], []
    R, done, scale = G, 0, None
    while done < budget:
        steps = min(chunk, budget - done)
        B, pts, ids, sups, R = eim_greedy_scan(R, steps, inplace=inplace or done > 0)
        host = torch.stack([sups.double(), pts.double(), ids.double()]).cpu().numpy()
        Bs.append(B)
        sups_l.append(host[0])
        pts_l.append(host[1].astype(np.int64))
        ids_l.append(host[2].astype(np.int64))
        done += steps
        if scale is None:  # the residual at step 0 is G: sups[0] = max|G|
            scale = float(host[0][0]) if relative else 1.0
            scale = scale if scale > 0 else 1.0
        # stop once tol is met with the reserve steps in hand, or at an
        # exactly-zero residual
        below = np.nonzero(np.concatenate(sups_l) <= tol * scale)[0]
        if below.size and done >= min(int(below[0]) + reserve, budget):
            break
        if host[0][-1] == 0.0:
            break

    sups_h = np.concatenate(sups_l)
    pts, ids = np.concatenate(pts_l), np.concatenate(ids_l)
    if not np.any(np.abs(sups_h) > 0):  # zero field
        return _zero_interpolant(n, G.dtype, G.device, 0.0)
    below = np.nonzero(sups_h <= tol * scale)[0]
    n_active = min(int(below[0]) if below.size else max_terms, max_terms)
    # reserve steps must carry real (nonzero-residual) information
    last_real = int(np.nonzero(sups_h > 0)[0][-1]) + 1
    total = min(n_active + reserve, budget, last_real)
    if total == 0:  # tol met before any term: the host loop's zero fallback
        return _zero_interpolant(n, G.dtype, G.device, float(sups_h[0]))
    # the host loop's history also logs the error after the last term
    if total < len(sups_h):
        tail = float(sups_h[total])
    else:
        tail = float(torch.linalg.vector_norm(R, ord=float("inf")))
    B = torch.cat([b.T for b in Bs]).T[:, :total] if len(Bs) > 1 else Bs[0][:, :total]
    return _from_columns(B, pts[:total], list(sups_h[:total]) + [tail],
                         total - n_active, ids[:total])


def eim_rebuild(G_sel, n_reserve: int = 0) -> EimInterpolant:
    """EIM with a prescribed snapshot sequence (two-grid EIM): column k of
    ``G_sel`` (n, K) is the snapshot selected at step k, and its magic
    point the argmax of its current residual. ``sup_errors`` holds each
    selected snapshot's residual sup (a diagnostic of the selected subset,
    not a certified training error). The last ``n_reserve`` columns become
    reserve terms."""
    G_sel = torch.as_tensor(G_sel)
    n, K = G_sel.shape
    if not 0 <= n_reserve < K:
        raise ValueError(f"eim_rebuild: n_reserve {n_reserve} of {K} columns")
    R = G_sel.clone()
    cols, points, history = [], [], []
    for k in range(K):
        p = int(torch.argmax(R[:, k].abs()))
        sup = abs(float(R[p, k]))
        history.append(sup)
        if sup == 0:
            raise ValueError(f"two-grid rebuild: selected snapshot {k} is exactly "
                             "interpolated by its predecessors on the fine grid; drop it")
        cols.append(_eim_step(R, k, p))
        points.append(p)
    return _from_columns(torch.stack(cols).T, points, history, n_reserve)


def theta_coefficients(interpolant: EimInterpolant, entries_fn, name: str = "eim_theta"):
    """Tuple of ``VectorEntryCoefficient`` theta_q(mu) for the affine
    surrogate of ``interpolant``: ``entries_fn(mu)`` gives the quantity at
    the active magic points, (M,) for one Mu or (B, M) for a batched one.
    All M coefficients share one solve per Mu object (keyed on the identity
    of its leaves, held strongly, so a new Mu always misses)."""
    from rla4mor_tpu_torch.core.parameters import VectorEntryCoefficient

    cache: dict = {}

    def theta_full(mu):
        key = tuple(id(v) for v in mu.values())
        if cache.get("key") != key:
            g = torch.as_tensor(entries_fn(mu))
            if g.dim() == 1:
                theta = interpolant.coefficients(g)
            else:  # (B, M): the batch as columns
                theta = interpolant.coefficients(g.mT).mT
            cache.update(key=key, refs=tuple(mu.values()), theta=theta)
        return cache["theta"]

    return tuple(VectorEntryCoefficient(theta_full, q, name=f"{name}[{q}]")
                 for q in range(interpolant.n_terms))


class MdeimOperator:
    """Matrix-DEIM: the affine surrogate ``A(mu) ~= sum_q theta_q(mu) A_q``
    of a non-affine sparse operator, from the EIM greedy on the nonzeros
    (one shared CSR pattern) of operator snapshots; theta from the M active
    magic entries ``magic_rows[:n_terms]`` / ``magic_cols[:n_terms]``. A
    host object (scipy sparse, the interpolant on the CPU in float64); the
    online thetas are tensors."""

    def __init__(self, interpolant: EimInterpolant, indices, indptr, shape):
        self.interpolant = interpolant
        self.indices = np.asarray(indices)
        self.indptr = np.asarray(indptr)
        self.shape = tuple(shape)
        pts = interpolant.points.cpu().numpy()
        self.magic_cols = self.indices[pts]
        self.magic_rows = (np.searchsorted(self.indptr, pts, side="right") - 1
                           ).astype(self.magic_cols.dtype)

    @property
    def n_terms(self) -> int:
        return self.interpolant.n_terms

    def term_matrix(self, q: int):
        """Sparse term A_q (csr): the shared pattern with the q-th basis
        vector as data."""
        import scipy.sparse as sps

        data = self.interpolant.basis[:, q].cpu().numpy()
        return sps.csr_matrix((data, self.indices, self.indptr), shape=self.shape)

    def entries_from_matrix(self, A) -> np.ndarray:
        """A(mu)'s values at all magic positions (active and reserve); A
        carries the shared pattern."""
        return np.asarray(_canonical_csr(A).data)[self.interpolant.points.cpu().numpy()]

    def theta_from_matrix(self, A) -> torch.Tensor:
        e = self.entries_from_matrix(A)[: self.n_terms]
        return self.interpolant.coefficients(torch.as_tensor(e))

    def indicator_from_matrix(self, A) -> float:
        """Estimate of ``max_nnz |A(mu) - A_MDEIM(mu)|`` (the reserve
        entries' interpolation error; a lower bound)."""
        e = torch.as_tensor(self.entries_from_matrix(A))
        return float(self.interpolant.error_indicator(e))

    def assemble(self, theta):
        """A_MDEIM = sum_q theta_q A_q as one csr."""
        import scipy.sparse as sps

        data = self.interpolant.reconstruct(torch.as_tensor(theta)).cpu().numpy()
        return sps.csr_matrix((data, self.indices, self.indptr), shape=self.shape)

    def affine_op(self, entries_fn, device=None, dtype=None):
        """``AffineOp`` over ``HostSparseOp`` terms (results on ``device``)
        with shared-solve theta coefficients, solved on ``device``;
        ``entries_fn(mu)`` gives the active magic entries, (M,) or (B, M).
        Cached per ``entries_fn``."""
        cached = getattr(self, "_affine_cache", None)
        if cached is not None and cached[0] is entries_fn:
            return cached[1]
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.linops import HostSparseOp
        from rla4mor_tpu_torch.utils.config import resolve_device

        # the magic-point solve on the terms' device, where entries_fn's
        # values are expected
        interpolant = self.interpolant.to(device=resolve_device(device))
        op = AffineOp(
            tuple(HostSparseOp(self.term_matrix(q), device=device, dtype=dtype)
                  for q in range(self.n_terms)),
            theta_coefficients(interpolant, entries_fn, name="mdeim_theta"))
        self._affine_cache = (entries_fn, op)
        return op


def _canonical_csr(A):
    """CSR with sorted indices, without mutating the caller's matrix
    (``tocsr()`` returns A itself when it is CSR already)."""
    Ac = A.tocsr()
    if not Ac.has_sorted_indices:
        Ac = Ac.copy()
        Ac.sort_indices()
    return Ac


def mdeim(mats, tol: float = 1e-8, max_terms: Optional[int] = None,
          reserve: int = 0) -> MdeimOperator:
    """:class:`MdeimOperator` from operator snapshots ``mats`` (scipy
    sparse, all on one sparsity pattern)."""
    base = _canonical_csr(mats[0])
    datas = []
    for A in mats:
        Ac = _canonical_csr(A)
        if not (Ac.shape == base.shape and np.array_equal(Ac.indices, base.indices)
                and np.array_equal(Ac.indptr, base.indptr)):
            raise ValueError("mdeim: operator snapshots must share one sparsity pattern")
        datas.append(np.asarray(Ac.data))
    G = torch.as_tensor(np.stack(datas, axis=1))
    interp = eim_greedy(G, tol=tol, max_terms=max_terms, reserve=reserve, inplace=True)
    return MdeimOperator(interp, base.indices, base.indptr, base.shape)


def deim_points(U) -> torch.Tensor:
    """DEIM greedy points of a basis U (n, M): point l is the argmax of the
    l-th vector's interpolation residual on the first l vectors and
    points."""
    U = torch.as_tensor(U)
    M = U.shape[1]
    pts = [int(torch.argmax(U[:, 0].abs()))]
    for l in range(1, M):
        pl = torch.as_tensor(pts, dtype=torch.int64, device=U.device)
        c = torch.linalg.solve(U[pl, :l], U[pl, l])
        r = U[:, l] - U[:, :l] @ c
        pts.append(int(torch.argmax(r.abs())))
    return torch.as_tensor(pts, dtype=torch.int64, device=U.device)


def deim(G, modes: Optional[int] = None, rtol: Optional[float] = 1e-7) -> EimInterpolant:
    """DEIM interpolant of the snapshots G (n, m_train): the POD basis
    (method of snapshots, ``core.orthonormalize.pod``) and greedy points.
    ``rtol`` cuts the POD at ``rtol * s_0``, above its sqrt(eps) noise
    floor; an explicit ``modes`` count disables the cut."""
    from rla4mor_tpu_torch.core.orthonormalize import pod

    if modes is not None:
        rtol = None
    U, svals = pod(torch.as_tensor(G), modes=modes, rtol=rtol)
    if U.shape[1] == 0:
        raise ValueError("deim: the snapshots have zero numerical rank")
    pts = deim_points(U)
    return EimInterpolant(basis=U, points=pts, interp_matrix=U[pts, :], triangular=False,
                          sup_errors=tuple(svals.tolist()))
