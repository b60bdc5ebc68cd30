"""Device iterative solvers: preconditioned CG and BiCGStab.

Counterpart of ``rla4mor_tpu/core/solvers.py`` (``CGResult``, ``cg``,
``bicgstab``, ``solve_dense``, ``lstsq_dense``, ``bounded_lstsq``). The JAX package runs them
as one ``lax.while_loop``; here they are eager PyTorch loops on the
operand's device. The stopping rules are the JAX package's, evaluated in
the operand's dtype, and the residual test is read on the host once an
iteration, so the iteration counts equal the JAX ones.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual_norm: torch.Tensor


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(conj(a) * b) over all entries (``jnp.vdot`` flattens)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a)


def cg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
) -> CGResult:
    """Preconditioned conjugate gradients for an SPD ``matvec``.

    Iterates while ``||r|| > tol * max(||b||, 1e-30)`` and ``k < maxiter``."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = precond if precond is not None else (lambda r: r)

    bnorm = _norm(b)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = _vdot(r, z).real
    # dtype-aware breakdown floor: 1e-300 would underflow to zero in float32
    tiny = torch.finfo(r.dtype).tiny
    thresh = tol * torch.clamp(bnorm, min=1e-30)
    k = 0
    while k < maxiter and bool(_norm(r) > thresh):
        Ap = matvec(p)
        alpha = rz / torch.clamp(_vdot(p, Ap).real, min=tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _vdot(r, z).real
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x, k, _norm(r))


def bicgstab(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
) -> CGResult:
    """Preconditioned BiCGStab (van der Vorst) for a nonsymmetric ``matvec``,
    with the JAX package's breakdown guards: on a non-finite scalar or
    residual the last finite iterate is kept and the loop ends (the count
    then reads ``maxiter``, as there)."""
    x = torch.zeros_like(b) if x0 is None else x0
    M = precond if precond is not None else (lambda r: r)

    bnorm = _norm(b)
    r = b - matvec(x)
    rhat = r  # fixed shadow residual
    tiny = torch.finfo(r.real.dtype).tiny

    def safe(d):
        return torch.where(d.abs() > tiny, d, torch.full_like(d, tiny))

    one = torch.ones((), dtype=r.dtype, device=r.device)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = one
    rnorm = _norm(r)
    thresh = tol * torch.clamp(bnorm, min=tiny)
    k = 0
    while k < maxiter and bool(rnorm > thresh):
        rho_new = _vdot(rhat, r)
        beta = (rho_new / safe(rho)) * (alpha / safe(omega))
        p_new = r + beta * (p - omega * v)
        ph = M(p_new)
        v_new = matvec(ph)
        alpha_new = rho_new / safe(_vdot(rhat, v_new))
        s = r - alpha_new * v_new
        sh = M(s)
        t = matvec(sh)
        omega_new = _vdot(t, s) / safe(_vdot(t, t))
        x_new = x + alpha_new * ph + omega_new * sh
        r_new = s - omega_new * t
        rnorm_new = _norm(r_new)
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
