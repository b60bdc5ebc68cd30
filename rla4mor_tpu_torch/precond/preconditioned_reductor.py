"""Sketched-Hilbert-Schmidt-norm parametric preconditioner selection.

Counterpart of ``rla4mor_tpu/precond/preconditioned_reductor.py``. For a
family of directions P_i (typically A(mu_i)^-1), the online preconditioner
P(mu) = sum_i y_i P_i is chosen by minimising a sketched Hilbert-Schmidt
norm of (P A(mu) - I) measured between (source, range) space pairs
("keys"). Each key contributes a small least-squares system
min_y || W(mu) y - h ||. For key (Vs, Vr) the sketched error matrix is

    M(mu) = RangeMap( (P A(mu) - I) SourceCols ),  vec-sketched by Gamma,

with

* Vs None:  SourceCols = R^-1 Sigma^H (n, k_sigma); Vs given: Vs Sigma^H;
* Vr None:  RangeMap(X) = Omega(X); Vr given: Omega (Vr^H R X).

W(mu)[:, i] = Gamma vec(RangeMap(P_i A(mu) SourceCols)) is affine in mu
with the FOM's coefficients, assembled from per-direction stacks by one
einsum; h = Gamma vec(RangeMap(SourceCols)).

The online stage over a parameter batch (:meth:`PreconditionedReductor.solve_batch`)
is batched tensor code, where the JAX package jits a vmap: one einsum
assembles every W, one batched SVD least-squares solve selects every y,
one batched ``torch.linalg.solve`` solves every ROM.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from rla4mor_tpu_torch.core.linops import LinOp, matmul
from rla4mor_tpu_torch.core.parameters import Mu, eval_coefficients
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.core.solvers import lstsq_dense
from rla4mor_tpu_torch.models.stationary import StationaryFOM
from rla4mor_tpu_torch.ops.embeddings import (
    Embedding,
    IdentityEmbedding,
    VectorizedEmbedding,
)
from rla4mor_tpu_torch.precond.preconditioned_rom import PreconditionedRom
from rla4mor_tpu_torch.utils.logger import get_logger

KeySpec = Union[str, Sequence[Tuple[str, float]]]


class PreconditionedReductor:
    """Sketched preconditioner selector and preconditioned Galerkin ROM."""

    def __init__(
        self,
        fom: StationaryFOM,
        reduced_basis,
        source_bases: Dict[str, Optional[torch.Tensor]],
        range_bases: Dict[str, Optional[torch.Tensor]],
        source_embeddings: Dict[str, Embedding],
        range_embeddings: Dict[str, Embedding],
        vec_embeddings: Dict[str, VectorizedEmbedding],
        residual_embedding: Embedding,
        intermediate_bases: Optional[dict] = None,
        product: Optional[Product] = None,
        stable_galerkin: bool = True,
        log_level: int = 20,
    ):
        if source_bases.keys() != range_bases.keys():
            raise ValueError("source_bases and range_bases need the same keys")
        self.fom = fom
        self.reduced_basis = torch.as_tensor(reduced_basis)
        self.product = (product if product is not None
                        else Product.identity(fom.solution_dim))
        self.vec_embeddings = vec_embeddings
        self.logger = get_logger("precond.reductor", log_level)
        self.mu_added: list = []

        self.prom = PreconditionedRom(
            fom, self.reduced_basis, residual_embedding,
            intermediate_bases=intermediate_bases, product=self.product,
            stable_galerkin=stable_galerkin, log_level=log_level)

        self._source_cols: Dict[str, torch.Tensor] = {}
        self._range_cols: Dict[str, Optional[torch.Tensor]] = {}
        self._range_emb: Dict[str, Embedding] = {}
        self.hs_estimators_lhs: Dict[str, list] = {k: [] for k in source_bases}
        self.hs_estimators_rhs: Dict[str, torch.Tensor] = {}

        for key in source_bases:
            Vs, S = source_bases[key], source_embeddings[key]
            if Vs is None:  # R^-1 Sigma^H
                cols = self.product.inv.apply(S.source_array())
            elif isinstance(S, IdentityEmbedding):
                cols = Vs
            else:  # Vs Sigma^H, the adjoint convention of the Vs = None branch
                cols = _matmul(Vs, torch.as_tensor(S.matrix()).conj().T)
            self._source_cols[key] = torch.as_tensor(cols)

            Vr, Om = range_bases[key], range_embeddings[key]
            self._range_emb[key] = Om
            if Vr is None:
                self._range_cols[key] = None
            else:
                rc = Vr if isinstance(Om, IdentityEmbedding) else _matmul(
                    Vr, torch.as_tensor(Om.matrix()).conj().T)
                # R-weighted columns: RangeMap(X) = rc^H R X
                self._range_cols[key] = torch.as_tensor(self.product.op.apply(rc))

            # h: the sketch of the identity
            ident = self._range_map(key, self._source_cols[key])
            self.hs_estimators_rhs[key] = torch.as_tensor(
                vec_embeddings[key].apply_matrix(ident))

    def _range_map(self, key: str, X) -> torch.Tensor:
        rc = self._range_cols[key]
        if rc is None:
            return torch.as_tensor(self._range_emb[key].apply(X))
        return _matmul(rc.conj().T, torch.as_tensor(X))

    def sketch_preconditioner(self, P: LinOp, key: str) -> torch.Tensor:
        """(T, k_Gamma) stack: row j = Gamma vec(RangeMap(P A_j SourceCols))."""
        cols = self._source_cols[key]
        out = []
        for term in self.fom.operator.terms:
            Y = torch.as_tensor(P.apply(term.apply(cols)))
            Z = self._range_map(key, Y)
            out.append(torch.as_tensor(self.vec_embeddings[key].apply_matrix(Z)))
        return torch.stack(out)

    def add_preconditioner(self, P: LinOp, mu: Optional[Mu] = None) -> None:
        """Add direction P to every HS estimator and to the Galerkin ROM."""
        self.logger.info("adding preconditioner at %s", mu)
        for key in self.hs_estimators_lhs:
            self.hs_estimators_lhs[key].append(self.sketch_preconditioner(P, key))
        self.prom.add_preconditioner(P, mu)
        self.mu_added.append(mu)

    @property
    def n_directions(self) -> int:
        return len(self.mu_added)

    def _keys(self, key: KeySpec):
        return [(key, 1.0)] if isinstance(key, str) else list(key)

    def assemble_hs_estimator(self, mu: Mu, key: KeySpec):
        """(W (k, p), h (k,)) with min_y ||W y - h|| selecting the
        preconditioner; (B, k, p) and (B, k) for a batched Mu. ``key`` may
        be a list of (key, weight) pairs, stacked with their weights."""
        Ws, hs = [], []
        for k, weight in self._keys(key):
            lst = self.hs_estimators_lhs[k]
            if not lst:
                raise ValueError("no preconditioner directions added yet")
            G = torch.stack(lst)  # (p, T, k)
            theta = eval_coefficients(self.fom.operator.coefficients, mu,
                                      device=G.device).to(G.dtype)
            W = torch.einsum("ptk,...t->...kp", G, theta)
            h = self.hs_estimators_rhs[k].to(W).expand(*W.shape[:-1])
            Ws.append(weight * W)
            hs.append(weight * h)
        return torch.cat(Ws, dim=-2), torch.cat(hs, dim=-1)

    def minimize_hs_estimator(self, mu: Mu, key: KeySpec):
        """(mu with ``mu['precond'] = y``, ||W y - h||) for the least-squares
        optimal y; batched along a batched Mu."""
        W, h = self.assemble_hs_estimator(mu, key)
        y = lstsq_dense(W, h)
        mu_p = dict(mu)
        mu_p["precond"] = y
        return mu_p, torch.linalg.vector_norm(_mv(W, y) - h, dim=-1)

    def _estimate_hs(self, mu_p: Mu, key: KeySpec) -> torch.Tensor:
        """Sketched HS norm of (P(y) A(mu) - I) at mu_p."""
        W, h = self.assemble_hs_estimator(mu_p, key)
        return torch.linalg.vector_norm(_mv(W, torch.as_tensor(mu_p["precond"])) - h,
                                        dim=-1)

    def assemble_rom_system(self, mu_p: Mu):
        """(r, r) lhs and (r,) rhs of the preconditioned Galerkin system."""
        rom = self.prom.rom
        if hasattr(rom, "assemble"):
            return rom.assemble(mu_p)
        return rom.lhs.assemble(mu_p), rom.rhs.assemble_vec(mu_p)

    def estimate_quasi_optimality(self, mu_p: Mu) -> torch.Tensor:
        """1 + Delta_2 / (1 - Delta_3), Delta_2 the ``u_ur`` HS estimate and
        Delta_3 = sigma_max(A_rom - I); ``inf`` where Delta_3 >= 1 (the bound
        is undefined there, and must not read as a perfect one)."""
        delta_2 = self._estimate_hs(mu_p, "u_ur")
        A, _ = self.assemble_rom_system(mu_p)
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        delta_3 = torch.linalg.svdvals(A - eye).max()
        if float(delta_3) >= 1.0:
            self.logger.warning("quasi-optimality bound not defined")
            return torch.tensor(float("inf"), dtype=delta_2.dtype, device=delta_2.device)
        return 1.0 + delta_2 / (1.0 - delta_3)

    def solve(self, mu: Mu, key: KeySpec):
        """Select P(y) by HS minimisation, then solve the preconditioned
        Galerkin ROM: (reduced coefficients, mu with its ``precond``)."""
        mu_p, _ = self.minimize_hs_estimator(mu, key)
        return self.prom.rom.solve(mu_p), mu_p

    def solve_batch(self, mus_batched: Mu, key: KeySpec):
        """The online stage over a batched Mu (``core.parameters.mu_stack``):
        assemble every HS estimator, select every y by least squares, solve
        every ROM, each step one batched call. Returns ``(us (s, r), ys (s,
        p), rnorms (s,))``: the reduced coefficients, the selected
        preconditioner coefficients and the sketched-HS residual norms."""
        mu_p, rnorms = self.minimize_hs_estimator(mus_batched, key)
        return self.prom.rom.solve(mu_p), mu_p["precond"], rnorms


def _matmul(A, B) -> torch.Tensor:
    """A @ B on A's device, the real operand promoted to a complex other's."""
    A = torch.as_tensor(A)
    return matmul(A, torch.as_tensor(B).to(A.device))


def _mv(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """A (..., k, p) times y (..., p)."""
    return (A @ y.to(A)[..., None])[..., 0]
