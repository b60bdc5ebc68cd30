"""Device iterative solvers: preconditioned CG and BiCGStab.

Counterpart of ``rla4mor_tpu/core/solvers.py`` (``CGResult``, ``cg``,
``bicgstab``, ``solve_dense``, ``lstsq_dense``, ``bounded_lstsq``). The JAX package runs them
as one ``lax.while_loop``; here they are eager PyTorch loops on the
operand's device. The stopping rules are the JAX package's, evaluated in
the operand's dtype, and the residual test is read on the host once an
iteration, so the iteration counts equal the JAX ones.

Given a process ``group`` (the ``"dof"`` axis of a mesh, whose ranks each
hold their rows of the operands), ``cg`` and ``bicgstab`` sum their inner
products over it with ``all_reduce`` (``parallel/mesh.py``); the JAX
package's compiler inserts the same reductions where it shards the
iteration.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual_norm: torch.Tensor


def _vdot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    """sum(conj(a) * b) over all entries (``jnp.vdot`` flattens), summed over
    ``group``'s ranks when given."""
    return group_sum(torch.vdot(a.reshape(-1), b.reshape(-1)), group)


def group_norm(a: torch.Tensor, group=None) -> torch.Tensor:
    """||a||_2 of the ranks' rows of ``a``, summed over ``group`` (every rank
    gets it); the norm of ``a`` without a group."""
    if group is None:
        return torch.linalg.vector_norm(a)
    return torch.sqrt(_vdot(a, a, group).real)


def group_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks (``parallel/mesh.py::all_reduce`` of
    a copy); ``t`` itself without a group."""
    if group is None:
        return t
    from rla4mor_tpu_torch.parallel.mesh import all_reduce

    return all_reduce(t.clone(), group)


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    group=None,
) -> CGResult:
    """Preconditioned conjugate gradients for an SPD ``matvec``.

    Iterates while ``||r|| > tol * max(||b||, 1e-30)`` and ``k < maxiter``.
    ``group``: the process group over which the ranks hold their rows of
    ``b`` (and ``matvec`` exchanges what it needs itself); the sharded
    iteration reduces r.z and ||r||^2 together, and p.Ap, two reductions an
    iteration."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = precond if precond is not None else (lambda r: r)

    def rz_rnorm(r, z):  # r.z and ||r||, one reduction over the group
        if group is None:
            return _vdot(r, z).real, group_norm(r)
        rz, rr = group_sum(torch.stack([_vdot(r, z).real, _vdot(r, r).real]),
                           group).unbind(0)
        return rz, torch.sqrt(rr)

    bnorm = group_norm(b, group)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz, rnorm = rz_rnorm(r, z)
    # dtype-aware breakdown floor: 1e-300 would underflow to zero in float32
    tiny = torch.finfo(r.real.dtype).tiny
    thresh = tol * torch.clamp(bnorm, min=1e-30)
    k = 0
    while k < maxiter and bool(rnorm > thresh):
        Ap = matvec(p)
        alpha = rz / torch.clamp(_vdot(p, Ap, group).real, min=tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new, rnorm = rz_rnorm(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x, k, rnorm)


def _colnorm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=0)


def _coldot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.conj() * b).sum(dim=0).real


class ColumnCG:
    """:func:`cg` on each column of an (n, m) block at once, each column with
    its own stop: the counterpart of ``jax.vmap(cg)`` over columns.
    ``matvec`` and ``precond`` map (n, m) blocks column by column.

    A column stops once ``||r_j|| <= tol * max(||b_j||, 1e-30)`` or at
    ``maxiter``; a stopped column is frozen by a mask on the device (its x,
    r, p and rz keep their values, as the vmapped while loop keeps them), so
    every column ends at the iteration the JAX loop ends it. The iterations
    run in chunks of ``check_every`` (default 8 on a CUDA block, where a
    host read waits for the device, and 1 elsewhere), masked on the device
    past ``maxiter`` too, and the host reads the all-stopped flag once a
    chunk: the iterations after every column stopped are masked no-ops, and
    the results equal those of a check at every iteration.

    On a CUDA block a chunk is captured once per block shape and dtype in a
    CUDA graph and replayed (one launch a chunk, the same kernels: the
    values are the eager chunk's); ``matvec`` and ``precond`` must then be
    fixed functions without host synchronisation. One instance serves many
    solves of one operator (an inner solve of a preconditioner)."""

    def __init__(self, matvec: Callable, precond: Optional[Callable] = None,
                 tol: float = 1e-8, maxiter: int = 1000,
                 check_every: Optional[int] = None, graph: bool = True):
        self.matvec = matvec
        self.precond = precond if precond is not None else (lambda r: r)
        self.tol, self.maxiter = float(tol), int(maxiter)
        self.check_every = check_every
        self.graph = graph
        self._graphs: dict = {}

    def _chunk(self, st: dict, steps: int) -> None:
        """``steps`` masked iterations, the state tensors updated in place (a
        CUDA graph replays this on fixed buffers)."""
        X, R, P, rz, active, iters, k = (st[key] for key in
                                        ("X", "R", "P", "rz", "active", "iters", "k"))
        tiny = torch.finfo(R.real.dtype).tiny
        for _ in range(steps):
            live = active & (k < self.maxiter)
            AP = self.matvec(P)
            alpha = rz / torch.clamp(_coldot(P, AP), min=tiny)
            X = torch.where(live, X + alpha * P, X)
            R = torch.where(live, R - alpha * AP, R)
            Z = self.precond(R)
            rz_new = _coldot(R, Z)
            beta = rz_new / torch.clamp(rz, min=tiny)
            P = torch.where(live, Z + beta * P, P)
            rz = torch.where(live, rz_new, rz)
            iters = iters + live
            active = active & ~(live & (_colnorm(R) <= st["thresh"]))
            k = k + 1
        for key, v in (("X", X), ("R", R), ("P", P), ("rz", rz), ("active", active),
                       ("iters", iters), ("k", k)):
            st[key].copy_(v)

    def _replay(self, st: dict, steps: int):
        """The chunk for ``st``'s shapes: a graph replay on CUDA, else eager."""
        if not self.graph or st["X"].device.type != "cuda":
            return lambda: self._chunk(st, steps)
        key = (tuple(st["X"].shape), st["X"].dtype, st["X"].device, steps)
        if key not in self._graphs:
            buf = {name: v.clone() for name, v in st.items()}
            side = torch.cuda.Stream(buf["X"].device)
            side.wait_stream(torch.cuda.current_stream(buf["X"].device))
            with torch.cuda.stream(side):
                self._chunk(buf, steps)  # warm-up: allocations outside the graph's pool
            torch.cuda.current_stream(buf["X"].device).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                self._chunk(buf, steps)
            self._graphs[key] = (g, buf)
        g, buf = self._graphs[key]
        for name, v in st.items():
            buf[name].copy_(v)
        st.update(buf)
        return g.replay

    def __call__(self, B: torch.Tensor, x0: Optional[torch.Tensor] = None) -> CGResult:
        """Solve the columns of ``B``: ``iters`` is an (m,) tensor of
        per-column counts, ``residual_norm`` the (m,) final residual norms."""
        X = torch.zeros_like(B) if x0 is None else x0.clone()
        R = B - self.matvec(X)
        Z = self.precond(R)
        thresh = self.tol * torch.clamp(_colnorm(B), min=1e-30)
        st = {"X": X, "R": R, "P": Z.clone(), "rz": _coldot(R, Z),  # P updates in place
              "active": _colnorm(R) > thresh,
              "iters": torch.zeros(B.shape[1], dtype=torch.int64, device=B.device),
              "k": torch.zeros((), dtype=torch.int64, device=B.device), "thresh": thresh}
        steps = self.check_every or (8 if B.device.type == "cuda" else 1)
        step = self._replay(st, max(1, int(steps)))
        for _ in range(0, self.maxiter, max(1, int(steps))):
            if not bool(st["active"].any()):
                break
            step()
        return CGResult(st["X"].clone(), st["iters"].clone(), _colnorm(st["R"]))


def cg_columns(
    matvec: Callable,
    B: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    check_every: Optional[int] = None,
) -> CGResult:
    """One :class:`ColumnCG` solve of the columns of ``B`` (n, m), eager
    (a one-off solve gains nothing from a captured graph)."""
    return ColumnCG(matvec, precond, tol, maxiter, check_every, graph=False)(B, x0)


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    group=None,
) -> CGResult:
    """Preconditioned BiCGStab (van der Vorst) for a nonsymmetric ``matvec``,
    with the JAX package's breakdown guards: on a non-finite scalar or
    residual the last finite iterate is kept and the loop ends (the count
    then reads ``maxiter``, as there). ``group``: as :func:`cg`'s; the
    sharded iteration reduces (t.s, t.t) together and ||r||^2 with the next
    rhat.r, three reductions an iteration."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = precond if precond is not None else (lambda r: r)

    bnorm = group_norm(b, group)
    r = b - matvec(x)
    rhat = r  # fixed shadow residual
    tiny = torch.finfo(r.real.dtype).tiny

    def safe(d):
        return torch.where(d.abs() > tiny, d, torch.full_like(d, tiny))

    def dots(*pairs):  # the inner products of the pairs, one reduction a call
        d = [_vdot(a, c) for a, c in pairs]
        return d if group is None else group_sum(torch.stack(d), group).unbind(0)

    one = torch.ones((), dtype=r.dtype, device=r.device)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = one
    if group is None:
        rnorm = group_norm(r)
    else:  # ||r|| and the next rhat.r in one reduction
        rr, rho_next = dots((r, r), (rhat, r))
        rnorm = torch.sqrt(rr.real)
    thresh = tol * torch.clamp(bnorm, min=tiny)
    k = 0
    while k < maxiter and bool(rnorm > thresh):
        rho_new = _vdot(rhat, r) if group is None else rho_next
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p_new = r + beta * (p - omega * v)
        ph = M(p_new)
        v_new = matvec(ph)
        alpha_new = rho_new / safe(dots((rhat, v_new))[0])
        s = r - alpha_new * v_new
        sh = M(s)
        t = matvec(sh)
        ts, tt = dots((t, s), (t, t))
        omega_new = ts / safe(tt)
        x_new = x + alpha_new * ph + omega_new * sh
        r_new = s - omega_new * t
        if group is None:
            rnorm_new = group_norm(r_new)
        else:
            rr, rho_next = dots((r_new, r_new), (rhat, r_new))
            rnorm_new = torch.sqrt(rr.real)
        ok = torch.stack([torch.isfinite(q).all() for q in
                          (rnorm_new, rho_new, beta, alpha_new, omega_new)]).all()
        if not bool(ok):
            k = maxiter
            break
        x, r, p, v = x_new, r_new, p_new, v_new
        rho, alpha, omega, rnorm = rho_new, alpha_new, omega_new, rnorm_new
        k += 1
    return CGResult(x, k, rnorm)


def solve_dense(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense solve (batched over leading dimensions)."""
    return torch.linalg.solve(A, b)


def svd_thin(A: torch.Tensor):
    """Thin SVD ``A = U diag(s) Vh`` of (..., m, n) matrices, the same
    factorisation as ``torch.linalg.svd(A, full_matrices=False)`` to
    rounding. cuSOLVER takes a batch of SVDs in one call up to 32 x 32 and
    loops over the batch above, so a larger A goes through a QR of its tall
    side first, A = Q R (or A^H = Q R), then the SVD of the small square R
    (Householder QR is backward stable)."""
    m, n = A.shape[-2:]
    if max(m, n) <= 32:
        return torch.linalg.svd(A, full_matrices=False)
    if m < n:
        U, s, Vh = svd_thin(A.conj().transpose(-1, -2))
        return Vh.conj().transpose(-1, -2), s, U.conj().transpose(-1, -2)
    Q, R = torch.linalg.qr(A)
    Ur, s, Vh = torch.linalg.svd(R)
    return Q @ Ur, s, Vh


def lstsq_dense(A: torch.Tensor, b: torch.Tensor, rcond: Optional[float] = None
                ) -> torch.Tensor:
    """Minimum-norm least squares through an economic SVD
    (:func:`svd_thin`), batched over leading dimensions; ``b`` is (..., m)
    or (..., m, q).

    ``rcond=None`` is ``jnp.linalg.lstsq``'s default cutoff, singular values
    kept where ``s > 0`` and ``s >= eps * max(m, n) * s_max``; a number
    keeps ``s > rcond * s_max`` as the JAX package's ``lstsq_dense``. An
    explicit SVD, since ``torch.linalg.lstsq`` on CUDA offers only the
    full-rank ``gels`` driver, and the masked minres systems are
    rank-deficient."""
    U, s, Vh = svd_thin(A)
    smax = s[..., :1]
    if rcond is None:
        cut = torch.finfo(s.dtype).eps * max(A.shape[-2:])
        keep = (s > 0) & (s >= cut * smax)
    else:
        keep = s > rcond * smax
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    vec = b.dim() == A.dim() - 1
    B = b[..., None] if vec else b
    x = Vh.conj().transpose(-1, -2) @ (s_inv[..., None].to(U.dtype)
                                       * (U.conj().transpose(-1, -2) @ B))
    return x[..., 0] if vec else x


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product: (..., k, p) @ (..., p) -> (..., k)."""
    return (A @ x[..., None])[..., 0]


def bounded_lstsq(G: torch.Tensor, g: torch.Tensor, lb, ub,
                  iters: int = 200) -> torch.Tensor:
    """Bound-constrained least squares min ||G x - g||, lb <= x <= ub, for
    G (..., k, p) and g (..., k): one problem, or a batch of them along the
    leading dimensions, solved together.

    Projected gradient with Nesterov momentum and the step 1 / L, L =
    ||G||_2^2 from 20 power iterations, started at the clipped least-squares
    solution (SVD cutoff 1e-12); ``iters`` fixed steps, as the JAX
    package's two ``lax.scan`` loops."""
    Gt = G.conj().transpose(-1, -2)
    lb = torch.as_tensor(lb, dtype=G.dtype, device=G.device)
    ub = torch.as_tensor(ub, dtype=G.dtype, device=G.device)
    v = torch.ones(G.shape[:-2] + G.shape[-1:], dtype=G.dtype, device=G.device)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(20):  # power iteration for the Lipschitz constant
        w = _mv(Gt, _mv(G, v))
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-30)
    L = torch.clamp(torch.linalg.vector_norm(_mv(G, v), dim=-1, keepdim=True) ** 2,
                    min=1e-30)
    x = torch.clamp(lstsq_dense(G, g, rcond=1e-12), lb, ub)
    y, t = x, 1.0
    for _ in range(iters):
        grad = _mv(Gt, _mv(G, y) - g)
        x_new = torch.clamp(y - grad / L, lb, ub)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = x_new + ((t - 1.0) / t_new) * (x_new - x)
        x, t = x_new, t_new
    return x
