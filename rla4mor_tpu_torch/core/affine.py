"""Affine-parametric operator calculus.

Counterpart of ``rla4mor_tpu/core/affine.py``:

* :class:`AffineOp` — offline container: ``terms`` are arbitrary LinOps
  (host-sparse, or lazy chains like ``Theta o R^-1 o A_j``), one
  :class:`~rla4mor_tpu_torch.core.parameters.Coefficient` per term;
* :class:`AffineDense` — a term-stacked dense tensor ``(T, k, m)`` plus a
  coefficient tuple. Everything downstream of sketching lives here. Where the
  JAX package vmaps over parameter batches, ``assemble`` takes a batched Mu
  and returns ``(B, k, m)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from rla4mor_tpu_torch.core.linops import ChainOp, DenseOp, LinOp
from rla4mor_tpu_torch.core.parameters import (
    ONE,
    Coefficient,
    Mu,
    as_coefficient,
    conj_coefficient,
    eval_coefficients,
)


def _theta(coefficients, mu, stack: torch.Tensor) -> torch.Tensor:
    """Coefficient values cast for contraction with ``stack``: the stack's
    precision, promoted to complex (never truncated) for complex values."""
    theta = eval_coefficients(coefficients, mu, device=stack.device)
    dt = stack.dtype
    if theta.is_complex() and not dt.is_complex:
        dt = torch.promote_types(dt, torch.complex64)
    return theta.to(dt)


class AffineOp:
    """sum_i theta_i(mu) * A_i with LinOp terms (general, offline)."""

    def __init__(
        self,
        terms: Sequence[LinOp],
        coefficients: Optional[Sequence[Union[Coefficient, float]]] = None,
    ):
        self.terms = tuple(terms)
        if coefficients is None:
            coefficients = (ONE,) * len(self.terms)
        self.coefficients = tuple(as_coefficient(c) for c in coefficients)
        if len(self.terms) != len(self.coefficients):
            raise ValueError("AffineOp: one coefficient per term")
        t0 = self.terms[0]
        if any(t.source_dim != t0.source_dim or t.range_dim != t0.range_dim
               for t in self.terms):
            raise ValueError("AffineOp: terms of different shapes")
        self.source_dim = t0.source_dim
        self.range_dim = t0.range_dim

    @property
    def H(self) -> "AffineOp":
        """The adjoint: adjoint terms, conjugated coefficients."""
        return AffineOp(tuple(t.H for t in self.terms),
                        tuple(conj_coefficient(c) for c in self.coefficients))

    def assemble_dense(self, mu: Mu | None = None) -> np.ndarray:
        """Host float64 dense matrix at one parameter."""
        theta = eval_coefficients(self.coefficients, mu, device="cpu").numpy()
        out = None
        for t, term in enumerate(self.terms):
            m = np.asarray(torch.as_tensor(term.matrix()).cpu()) * theta[t]
            out = m if out is None else out + m
        return out


class AffineDense:
    """Affine operator with a dense term stack ``(T, k, m)``."""

    def __init__(self, stack, coefficients: Sequence[Coefficient]):
        self.stack = torch.as_tensor(stack)
        if self.stack.dim() != 3:
            raise ValueError(f"AffineDense stack must be 3-D, got {tuple(self.stack.shape)}")
        self.coefficients = tuple(as_coefficient(c) for c in coefficients)
        if self.stack.shape[0] != len(self.coefficients):
            raise ValueError("AffineDense: one coefficient per term")

    @property
    def range_dim(self) -> int:
        return self.stack.shape[1]

    @property
    def source_dim(self) -> int:
        return self.stack.shape[2]

    def assemble(self, mu: Mu | None = None) -> torch.Tensor:
        """(k, m) matrix at one Mu, (B, k, m) at a batched Mu."""
        theta = _theta(self.coefficients, mu, self.stack)
        return torch.einsum("...t,tkm->...km", theta, self.stack.to(theta.dtype))

    def assemble_vec(self, mu: Mu | None = None) -> torch.Tensor:
        """(..., k) vector of an m == 1 operator (rhs, functionals)."""
        return self.assemble(mu)[..., 0]

    def apply(self, U, mu: Mu | None = None) -> torch.Tensor:
        """A(mu) U. U is (m,) or (m, b) for one Mu; (B, m) — one vector per
        parameter — for a batched Mu."""
        A = self.assemble(mu)
        U = torch.as_tensor(U).to(A)
        if U.dim() == A.dim() - 1:
            return (A @ U[..., None])[..., 0]
        return A @ U

    @property
    def H(self) -> "AffineDense":
        """The adjoint: conjugate-transposed terms, conjugated coefficients."""
        return AffineDense(self.stack.transpose(1, 2).conj(),
                           tuple(conj_coefficient(c) for c in self.coefficients))

    def _promoted(self, M):
        """(stack, M) on the stack's device in their promoted dtype, as the
        JAX package's products promote."""
        M = torch.as_tensor(M).to(self.stack.device)
        dt = torch.promote_types(self.stack.dtype, M.dtype)
        return self.stack.to(dt), M.to(dt)

    def lmul(self, M) -> "AffineDense":
        """M @ self, term-wise (M dense (p, k))."""
        stack, M = self._promoted(M)
        return AffineDense(torch.einsum("pk,tkm->tpm", M, stack), self.coefficients)

    def rmul(self, M) -> "AffineDense":
        """self @ M, term-wise (M dense (m, q))."""
        stack, M = self._promoted(M)
        return AffineDense(torch.einsum("tkm,mq->tkq", stack, M), self.coefficients)

    def add(self, other: "AffineDense") -> "AffineDense":
        """Affine sum: the union of the term lists (T1 + T2 terms)."""
        if (self.range_dim, self.source_dim) != (other.range_dim, other.source_dim):
            raise ValueError("AffineDense.add: terms of different shapes")
        stack, other_stack = self._promoted(other.stack)
        return AffineDense(torch.cat([stack, other_stack], dim=0),
                           self.coefficients + other.coefficients)

    def scale(self, c: Union[Coefficient, float]) -> "AffineDense":
        """c(mu) times the operator: every coefficient multiplied by c."""
        c = as_coefficient(c)
        return AffineDense(self.stack, tuple(c * ci for ci in self.coefficients))

    def astype(self, dtype) -> "AffineDense":
        return AffineDense(self.stack.to(dtype), self.coefficients)

    def map_terms(self, fn: Callable) -> "AffineDense":
        """terms'_t = fn(terms_t), as one call on the (k, T*m) matrix."""
        T, k, m = self.stack.shape
        flat = self.stack.movedim(0, 1).reshape(k, T * m)
        out = torch.as_tensor(fn(flat))
        return AffineDense(out.reshape(out.shape[0], T, m).movedim(1, 0),
                           self.coefficients)


AnyOp = Union[AffineOp, AffineDense, LinOp]


def as_affine(op: AnyOp) -> Union[AffineOp, AffineDense]:
    if isinstance(op, (AffineOp, AffineDense)):
        return op
    return AffineOp((op,), (ONE,))


def compose(left: LinOp, op: AnyOp) -> Union[AffineOp, AffineDense]:
    """left o op, distributed over the affine terms."""
    op = as_affine(op)
    if isinstance(op, AffineDense):
        if isinstance(left, DenseOp):
            return op.lmul(left.A)
        return op.map_terms(lambda X: left.apply(X))
    return AffineOp(tuple(ChainOp((left, t)) for t in op.terms), op.coefficients)


def project(op: AnyOp, V, W, product: Optional[LinOp] = None) -> AffineDense:
    """Petrov-Galerkin projection ``V^H [R] op W``, term-wise.

    ``V`` (n, kv) and/or ``W`` (m, kw) are dense bases or ``None`` (keep that
    side full); with ``W=None`` the terms are evaluated through
    ``apply_adjoint`` on ``V``."""
    op = as_affine(op)
    if product is not None and V is not None:
        V = product.apply(V)

    if isinstance(op, AffineDense):
        out = op
        if W is not None:
            out = out.rmul(W)
        if V is not None:
            out = out.lmul(torch.as_tensor(V).conj().T)
        return out

    if V is None and W is None:
        raise ValueError("project: give V or W")
    mats = []
    for term in op.terms:
        if W is not None:
            Y = torch.as_tensor(term.apply(W))
            if V is not None:
                Y = torch.as_tensor(V).to(Y).conj().T @ Y
        else:
            Y = torch.as_tensor(term.apply_adjoint(V)).conj().T
        mats.append(Y)
    return AffineDense(torch.stack(mats), op.coefficients)


def apply2(op: AnyOp, V, W, mu: Mu | None = None, product=None) -> torch.Tensor:
    """V^H [R] op(mu) W as a dense matrix."""
    return project(op, V, W, product=product).assemble(mu)


def materialize(op: AnyOp) -> AffineDense:
    """AffineDense with each term materialised (small-source ops only)."""
    op = as_affine(op)
    if isinstance(op, AffineDense):
        return op
    return AffineDense(torch.stack([torch.as_tensor(t.matrix()) for t in op.terms]),
                       op.coefficients)


def concat_affine(ops: Sequence[Union[AffineDense, AffineOp]],
                  axis: int) -> AffineDense:
    """Concatenate affine operators term-wise along ``axis`` (1 = source
    columns, 0 = range rows). All operands share one coefficient tuple."""
    dense = [materialize(op) for op in ops]
    coeffs = dense[0].coefficients
    if any(d.coefficients != coeffs for d in dense):
        raise ValueError("concat_affine requires identical coefficient tuples")
    return AffineDense(torch.cat([d.stack for d in dense], dim=1 + axis), coeffs)


def project_block(op: AnyOp, V, W, product=None,
                  max_block_size: Optional[int] = None) -> AffineDense:
    """:func:`project` with the source basis W (or, without W, the range
    basis V) split into blocks of at most ``max_block_size`` columns,
    projected one after the other and concatenated term-wise: the peak
    memory of a wide basis is that of one block."""
    if max_block_size is None or (V is None and W is None):
        return project(op, V, W, product=product)
    # the product goes on the test basis once, before any split
    if product is not None and V is not None:
        V = torch.as_tensor(product.apply(V))
        product = None
    if W is not None:
        W = torch.as_tensor(W)
        parts = [project(op, V, W[:, i:i + max_block_size])
                 for i in range(0, W.shape[1], max_block_size)]
        return concat_affine(parts, axis=1)
    # range-side blocks through the adjoint
    return project_block(as_affine(op).H, None, V, max_block_size=max_block_size).H
