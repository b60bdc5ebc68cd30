"""Linear operators.

Counterpart of ``rla4mor_tpu/core/linops.py``. Vectors are columns: a batch
of b vectors of dimension n is an ``(n, b)`` tensor (or ``(n,)``).

Two worlds, as in the JAX package:

* device ops (``DenseOp``, embeddings, chains of them) hold tensors on an
  explicit device and take their input to that device;
* host ops (:class:`HostOp`: ``HostSparseOp``, ``HostLUInverse``,
  ``SparseCholeskyOp``) wrap scipy matrices and factorisations. They compute
  in float64 numpy on the host and hand back a tensor on their ``device`` in
  its working dtype (``utils.config.default_dtype``). ``apply_host`` keeps
  the result in numpy, so a :class:`ChainOp` of several host ops (R^-1 A,
  then the sqrt factor inside an embedding) moves a vector to the device
  once, not after every factor.

The device inverses (:class:`CGInverseOp`, :class:`DeviceCholeskyInverse`,
:class:`RecycledCGInverseOp`) are preconditioner directions A(mu_i)^-1
solved on the operator's device.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from rla4mor_tpu_torch.core.solvers import cg
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device


def to_numpy(U) -> np.ndarray:
    """Host float64 (or complex128) numpy copy of a tensor or array."""
    if isinstance(U, torch.Tensor):
        U = U.detach().cpu().numpy()
    U = np.asarray(U)
    return U.astype(np.complex128 if np.iscomplexobj(U) else np.float64,
                    copy=False)


def matmul(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``A @ X`` with the real operand promoted to the other's complex dtype,
    as the JAX package's products promote (torch refuses mixed dtypes)."""
    if A.dtype != X.dtype:
        dt = torch.promote_types(A.dtype, X.dtype)
        A, X = A.to(dt), X.to(dt)
    return A @ X


class LinOp:
    """Abstract linear operator: y = A x with x (source_dim, b)."""

    source_dim: int
    range_dim: int

    def apply(self, U, mu=None):
        raise NotImplementedError

    def apply_adjoint(self, V, mu=None):
        raise NotImplementedError

    @property
    def H(self) -> "LinOp":
        return AdjointOp(self)

    def matrix(self) -> torch.Tensor:
        """Dense matrix of the operator (small ops only)."""
        return torch.as_tensor(
            self.apply(torch.eye(self.source_dim, dtype=torch.float64)))


def _as_2d(U):
    """(U as a matrix, whether it was a vector)."""
    U = torch.as_tensor(U)
    return (U[:, None], True) if U.dim() == 1 else (U, False)


class IdentityOp(LinOp):
    def __init__(self, dim: int):
        self.source_dim = self.range_dim = dim

    def apply(self, U, mu=None):
        return U

    def apply_adjoint(self, V, mu=None):
        return V

    @property
    def H(self):
        return self

    def matrix(self):
        return torch.eye(self.source_dim, dtype=torch.float64)


class DenseOp(LinOp):
    """Dense matrix operator on ``device`` (working dtype by default)."""

    def __init__(self, A, device=None, dtype=None):
        self.A = as_tensor(A, device, dtype)
        if self.A.dim() != 2:
            raise ValueError(f"DenseOp needs a matrix, got {tuple(self.A.shape)}")
        self.range_dim, self.source_dim = self.A.shape

    def _in(self, U):
        return as_tensor(U, self.A.device, self.A.dtype)

    def apply(self, U, mu=None):
        return matmul(self.A, self._in(U))

    def apply_adjoint(self, V, mu=None):
        return matmul(self.A.conj().T, self._in(V))

    @property
    def H(self):
        return DenseOp(self.A.conj().T, self.A.device, self.A.dtype)

    def matrix(self):
        return self.A


class DiagonalOp(LinOp):
    """diag(d) on ``device`` (working dtype by default)."""

    def __init__(self, d, device=None, dtype=None):
        self.d = as_tensor(d, device, dtype)
        self.source_dim = self.range_dim = self.d.shape[0]

    def _scale(self, d, U):
        U, single = _as_2d(U)
        out = d[:, None] * as_tensor(U, self.d.device, self.d.dtype)
        return out[:, 0] if single else out

    def apply(self, U, mu=None):
        return self._scale(self.d, U)

    def apply_adjoint(self, V, mu=None):
        return self._scale(self.d.conj(), V)

    def matrix(self):
        return torch.diag(self.d)


class AdjointOp(LinOp):
    """The adjoint of ``op``: ``apply`` is its ``apply_adjoint``."""

    def __init__(self, op: LinOp):
        self.op = op
        self.source_dim = op.range_dim
        self.range_dim = op.source_dim

    def apply(self, U, mu=None):
        return self.op.apply_adjoint(U, mu)

    def apply_adjoint(self, V, mu=None):
        return self.op.apply(V, mu)

    @property
    def H(self):
        return self.op

    def matrix(self):
        return torch.as_tensor(self.op.matrix()).conj().T


class ScaledOp(LinOp):
    """alpha * op for a scalar alpha."""

    def __init__(self, op: LinOp, alpha: float):
        self.op, self.alpha = op, alpha
        self.source_dim, self.range_dim = op.source_dim, op.range_dim

    def apply(self, U, mu=None):
        return self.alpha * torch.as_tensor(self.op.apply(U, mu))

    def apply_adjoint(self, V, mu=None):
        return np.conj(self.alpha) * torch.as_tensor(self.op.apply_adjoint(V, mu))

    def matrix(self):
        return self.alpha * torch.as_tensor(self.op.matrix())


class ZeroOp(LinOp):
    """The zero map from ``source_dim`` to ``range_dim``."""

    def __init__(self, range_dim: int, source_dim: int):
        self.range_dim, self.source_dim = range_dim, source_dim

    def _zeros(self, dim, U):
        U, single = _as_2d(U)
        out = U.new_zeros((dim, U.shape[1]))
        return out[:, 0] if single else out

    def apply(self, U, mu=None):
        return self._zeros(self.range_dim, U)

    def apply_adjoint(self, V, mu=None):
        return self._zeros(self.source_dim, V)

    def matrix(self):
        return torch.zeros((self.range_dim, self.source_dim), dtype=torch.float64)


class CastInputOp(LinOp):
    """Apply ``op`` to its input cast to ``in_dtype`` and emit ``out_dtype``
    (default ``promote_types(in_dtype, float32)``): the bf16 offline mode,
    ``CastInputOp(S, torch.bfloat16)`` sketches bf16 snapshots, half the
    bytes the sketch reads, with float32 sums.

    For an embedding (``apply_random`` and ``_apply_q``) only the input of
    the random sketch is cast, after the sqrt factor Q (a host op that stays
    in its dtype), and an embedding whose ``emits_out_dtype`` is set (the
    SRHT) is asked for ``out_dtype`` directly, so its float32 sums are not
    rounded to bf16 and back. Complex input is left uncast when
    ``in_dtype`` is real, and its result keeps the complex dtype."""

    def __init__(self, op: LinOp, in_dtype: torch.dtype, out_dtype=None):
        self.op = op
        self.in_dtype = in_dtype
        self.out_dtype = (out_dtype if out_dtype is not None
                          else torch.promote_types(in_dtype, torch.float32))
        self.source_dim, self.range_dim = op.source_dim, op.range_dim

    def _cast_in(self, U) -> torch.Tensor:
        U = torch.as_tensor(U)
        if U.is_complex() and not self.in_dtype.is_complex:
            return U
        return U.to(self.in_dtype)

    def _cast_out(self, out) -> torch.Tensor:
        out = torch.as_tensor(out)
        if out.is_complex():
            return out.to(torch.promote_types(self.out_dtype, out.dtype))
        return out.to(self.out_dtype)

    def apply(self, U, mu=None):
        op = self.op
        if hasattr(op, "apply_random") and hasattr(op, "_apply_q"):
            x = self._cast_in(op._apply_q(U))
            if getattr(op, "emits_out_dtype", False):
                return self._cast_out(op.apply_random(x, out_dtype=self.out_dtype))
            return self._cast_out(op.apply_random(x))
        return self._cast_out(op.apply(self._cast_in(U), mu))

    def apply_adjoint(self, V, mu=None):
        return self._cast_out(self.op.apply_adjoint(self._cast_in(V), mu))


class ChainOp(LinOp):
    """Composition ``ops[0] @ ops[1] @ ... @ ops[-1]`` (applied right-first).

    Consecutive host ops pass numpy between them; the first device op (or
    the end of the chain) moves the result to the device once."""

    def __init__(self, ops: Sequence[LinOp]):
        flat = []
        for op in ops:
            flat.extend(op.ops if isinstance(op, ChainOp) else (op,))
        self.ops = tuple(flat)
        for a, b in zip(self.ops[:-1], self.ops[1:]):
            if a.source_dim != b.range_dim:
                raise ValueError(f"ChainOp: dims {a.source_dim} != {b.range_dim}")
        self.source_dim = self.ops[-1].source_dim
        self.range_dim = self.ops[0].range_dim

    @staticmethod
    def _run(ops, U, mu, adjoint: bool):
        last_host = None
        for op in ops:
            if isinstance(op, HostOp):
                U = op.apply_host(U, adjoint=adjoint)
                last_host = op
            else:
                U = op.apply_adjoint(U, mu) if adjoint else op.apply(U, mu)
        if isinstance(U, np.ndarray):
            U = torch.as_tensor(U) if last_host is None else last_host.to_device(U)
        return U

    def apply(self, U, mu=None):
        return self._run(reversed(self.ops), U, mu, adjoint=False)

    def apply_adjoint(self, V, mu=None):
        return self._run(self.ops, V, mu, adjoint=True)

    @property
    def H(self):
        return ChainOp(tuple(op.H for op in reversed(self.ops)))


# ---------------------------------------------------------------------------
# Host (CPU / scipy) operators
# ---------------------------------------------------------------------------


class HostOp(LinOp):
    """A LinOp computed by scipy on the host, returning tensors on
    ``device`` in its working dtype."""

    def __init__(self, dim_range: int, dim_source: int, device=None, dtype=None):
        self.range_dim, self.source_dim = dim_range, dim_source
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype

    def _host(self, U: np.ndarray, adjoint: bool) -> np.ndarray:
        raise NotImplementedError

    def apply_host(self, U, adjoint: bool = False) -> np.ndarray:
        """numpy result of the op (or its adjoint) on a tensor or array."""
        return self._host(to_numpy(U), adjoint)

    def to_device(self, X: np.ndarray) -> torch.Tensor:
        return as_tensor(X, self.device, self.dtype)

    def apply(self, U, mu=None):
        return self.to_device(self.apply_host(U))

    def apply_adjoint(self, V, mu=None):
        return self.to_device(self.apply_host(V, adjoint=True))

    def matrix(self):
        return self.to_device(self.apply_host(np.eye(self.source_dim)))


class HostSparseOp(HostOp):
    """scipy sparse matrix as a LinOp (host execution, f64)."""

    def __init__(self, S, device=None, dtype=None):
        self.S = sps.csr_matrix(S)
        super().__init__(*self.S.shape, device=device, dtype=dtype)

    def _host(self, U, adjoint):
        return (self.S.conj().T @ U) if adjoint else (self.S @ U)


class HostLUInverse(HostOp):
    """Implicit inverse of a sparse matrix via a SuperLU factorisation."""

    def __init__(self, S, symmetric: bool = False, device=None, dtype=None,
                 **splu_kwargs):
        S = sps.csc_matrix(S)
        if symmetric:
            self.factorization = spla.splu(
                S, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0,
                options={"SymmetricMode": True},
            )
        else:
            self.factorization = spla.splu(S, **splu_kwargs)
        super().__init__(S.shape[0], S.shape[0], device=device, dtype=dtype)

    def _host(self, U, adjoint):
        trans = "H" if adjoint else "N"
        if np.iscomplexobj(U) and not np.iscomplexobj(self.factorization.U):
            # a real factorisation solves complex right-hand sides by
            # real-linearity (scipy refuses the complex->f64 cast)
            return (self.factorization.solve(np.ascontiguousarray(U.real), trans=trans)
                    + 1j * self.factorization.solve(
                        np.ascontiguousarray(U.imag), trans=trans))
        return self.factorization.solve(U, trans=trans)


class SparseCholeskyOp(HostOp):
    """Sparse Cholesky square root Q = G^H P with Q^H Q = S (G lower
    triangular from the symmetric-mode SuperLU factorisation):

    * ``apply(u)         = G^T (P u)``
    * ``apply_adjoint(v) = P^T (G v)``
    * ``apply_inverse(v) = P^T solve_Lt(v)``
    * ``apply_inverse_adjoint(u) = solve_L(P u)``
    """

    def __init__(self, S, device=None, dtype=None):
        S = sps.csc_matrix(S)
        factor = spla.splu(
            S, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0,
            options={"SymmetricMode": True},
        )
        dsq = np.sqrt(factor.U.diagonal())
        self._G = sps.csr_matrix(factor.L @ sps.diags(dsq))   # lower
        self._GT = sps.csr_matrix(self._G.T)                   # upper
        self._perm = factor.perm_r  # row permutation: (P u) = u[perm]
        super().__init__(S.shape[0], S.shape[0], device=device, dtype=dtype)

    def _scatter(self, U):  # P u  with P[perm[j], j] = 1
        out = np.empty_like(U)
        out[self._perm] = U
        return out

    def _host(self, U, adjoint):
        if adjoint:
            return (self._G @ U)[self._perm]
        return self._GT @ self._scatter(U)

    def apply_inverse(self, V, mu=None):
        """x with Q x = v: solve G^T y = v (upper), x = P^T y."""
        y = spla.spsolve_triangular(self._GT, to_numpy(V), lower=False)
        return self.to_device(y[self._perm])

    def apply_inverse_adjoint(self, U, mu=None):
        """x with Q^H x = u: solve G x = P u (lower)."""
        return self.to_device(spla.spsolve_triangular(
            self._G, self._scatter(to_numpy(U)), lower=True))


def sparse_cholesky(S) -> sps.csc_matrix:
    """Sparse factor Q with ``Q^H Q = S`` for an SPD sparse S: the
    symmetric-mode SuperLU factorisation ``S = P^T L U`` with
    ``U = D L^T P`` up to scaling gives ``Q = (P^T L D^{1/2})^H``."""
    S = sps.csc_matrix(S)
    factor = spla.splu(
        S, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0,
        options={"SymmetricMode": True},
    )
    n = S.shape[0]
    P = sps.csc_matrix((np.ones(n), (factor.perm_r, np.arange(n))), shape=(n, n))
    D = sps.diags(np.sqrt(factor.U.diagonal()))
    return sps.csc_matrix((P.T @ factor.L @ D).conj().T)


# ---------------------------------------------------------------------------
# Device inverses: preconditioner directions P_i = A(mu_i)^-1 that never
# leave the device
# ---------------------------------------------------------------------------


class CGInverseOp(LinOp):
    """Implicit inverse of an SPD matrix-free operator by device CG.

    ``matvec`` (a closure on (n,) vectors, e.g. a stencil apply) and an
    optional ``precond`` closure, solved to ``tol`` by
    :func:`~rla4mor_tpu_torch.core.solvers.cg`. The JAX package vmaps its CG
    over the columns of a block; here the columns are solved one after the
    other, each to its own iteration count, which is what the vmapped loop
    computes too."""

    def __init__(self, matvec, dim: int, precond=None, tol: float = 1e-10,
                 maxiter: int = 1000):
        self.matvec = matvec
        self.precond = precond
        self.tol = tol
        self.maxiter = maxiter
        self.source_dim = self.range_dim = dim

    def _solve_one(self, b: torch.Tensor) -> torch.Tensor:
        return cg(self.matvec, b, precond=self.precond, tol=self.tol,
                  maxiter=self.maxiter).x

    def apply(self, U, mu=None):
        U = torch.as_tensor(U)
        if U.dim() == 1:
            return self._solve_one(U)
        return torch.stack([self._solve_one(U[:, j]) for j in range(U.shape[1])], dim=1)

    # SPD: the adjoint solve is the same solve
    apply_adjoint = apply

    def apply_inverse(self, U, mu=None):
        U = torch.as_tensor(U)
        if U.dim() == 1:
            return self.matvec(U)
        return torch.stack([self.matvec(U[:, j]) for j in range(U.shape[1])], dim=1)


class DeviceCholeskyInverse(LinOp):
    """Dense SPD inverse by a Cholesky factor computed once on the matrix's
    device; every apply is ``torch.cholesky_solve`` with it."""

    def __init__(self, A_dense):
        A = torch.as_tensor(A_dense)
        if A.dim() != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"DeviceCholeskyInverse needs a square matrix, "
                             f"got {tuple(A.shape)}")
        self.A = A
        self.chol = torch.linalg.cholesky(A)
        self.source_dim = self.range_dim = A.shape[0]

    def apply(self, U, mu=None):
        U = torch.as_tensor(U).to(self.A)
        single = U.dim() == 1
        X = torch.cholesky_solve(U[:, None] if single else U, self.chol)
        return X[:, 0] if single else X

    # SPD: the adjoint solve is the same solve
    apply_adjoint = apply

    def apply_inverse(self, U, mu=None):
        return matmul(self.A, torch.as_tensor(U).to(self.A.device))


class RecycledCGInverseOp(LinOp):
    """Device CG inverse whose solves start from recycled earlier solutions.

    Keeps up to ``m_max`` A-orthonormal columns W (W^H A W = I), a ring
    filled from past solutions. Each solve starts CG at the Galerkin
    projection x0 = W W^H b of its right-hand side, so repeated or nearby
    right-hand sides take a few iterations instead of a cold start. A
    solution that took more than 2 iterations is A-orthogonalised against W
    (two passes) and, if anything is left, written into the next slot of the
    ring. ``last_iters`` is the CG iteration count of the latest solve,
    ``solves`` the number of solves so far. Columns of a block are solved one
    after the other, since each solve updates the ring the next one starts
    from."""

    def __init__(self, matvec, dim: int, precond=None, tol: float = 1e-10,
                 maxiter: int = 1000, m_max: int = 16, dtype=None, device=None):
        self.matvec = matvec
        self.precond = precond
        self.tol = tol
        self.maxiter = maxiter
        self.m_max = m_max
        self.source_dim = self.range_dim = dim
        device = resolve_device(device)
        self._W = torch.zeros((dim, m_max), dtype=dtype or default_dtype(device),
                              device=device)
        self._count = 0
        self.last_iters = 0
        self.solves = 0

    def _solve_one(self, b: torch.Tensor) -> torch.Tensor:
        W = self._W
        b = b.to(W)
        x0 = W @ (W.conj().T @ b)  # W^H A W = I: the Galerkin coefficients
        res = cg(self.matvec, b, x0=x0, precond=self.precond, tol=self.tol,
                 maxiter=self.maxiter)
        self.last_iters = int(res.iters)
        self.solves += 1
        self._recycle(res.x)
        return res.x

    def _recycle(self, x: torch.Tensor) -> None:
        if self.last_iters <= 2:
            # the deflated start already solved it: x lies (numerically) in
            # span(W), and inserting it again would only cost 3 matvecs
            return
        W = self._W
        w = x.to(W)
        Aw = self.matvec(w).to(W)
        for _ in range(2):  # A-orthogonalise, then one re-orthogonalisation
            w = w - W @ (W.conj().T @ Aw)
            Aw = self.matvec(w).to(W)
        nrm2 = float(torch.vdot(w, Aw).real)
        if nrm2 > 1e-28:
            self._W[:, self._count % self.m_max] = w / math.sqrt(nrm2)
            self._count += 1

    def apply(self, U, mu=None):
        U = torch.as_tensor(U)
        if U.dim() == 1:
            return self._solve_one(U)
        return torch.stack([self._solve_one(U[:, j]) for j in range(U.shape[1])], dim=1)

    # SPD: the adjoint solve is the same solve
    apply_adjoint = apply

    def apply_inverse(self, U, mu=None):
        U = torch.as_tensor(U)
        if U.dim() == 1:
            return self.matvec(U)
        return torch.stack([self.matvec(U[:, j]) for j in range(U.shape[1])], dim=1)


class ScipyLinearOperator(spla.LinearOperator):
    """A LinOp as a scipy ``LinearOperator`` (for scipy's iterative
    solvers, e.g. ``gmres(..., M=ScipyLinearOperator(P))``): numpy vectors
    in and out."""

    def __init__(self, op: LinOp, dtype=np.float64):
        self.op = op
        super().__init__(dtype=np.dtype(dtype), shape=(op.range_dim, op.source_dim))

    def _matvec(self, x):
        return np.array(to_numpy(self.op.apply(torch.as_tensor(np.asarray(x).reshape(-1)))))

    def _rmatvec(self, x):
        return np.array(to_numpy(self.op.apply_adjoint(torch.as_tensor(np.asarray(x).reshape(-1)))))


def to_matrix(op, dtype=None) -> torch.Tensor:
    """Dense matrix of a LinOp, or an array or tensor as a tensor."""
    m = torch.as_tensor(op.matrix() if isinstance(op, LinOp) else op)
    return m.to(dtype) if dtype is not None else m
