"""Sketched reduced-basis reductor.

Counterpart of ``rla4mor_tpu/mor/sketched_reductor.py``:

* state = sketched basis ``srb = Theta U`` (k x r), optional full basis
  ``rb``, affine sketched residual ``Theta R^-1 A U`` (terms, k x r) and rhs
  ``Theta R^-1 b``, projected output functional — all tensors on the
  primal embedding's device;
* ``extend_basis`` appends snapshots and concatenates affine terms
  column-wise;
* orthonormalisation happens in sketch space: Gram-Schmidt on ``srb``,
  T = pinv(R) applied to rb, residual and output;
* ``reduce`` emits a Galerkin or minimal-residual :class:`StationaryROM`
  whose error estimator is the online-sketched residual norm (on an empty
  basis: the classical reductor's exact estimator);
* ``reduce_adaptive`` doubles the online sketch until two independent
  online sketches agree on a parameter batch.

The FOM-side applies (A_j, R^-1 and the sqrt factor Q inside the
embedding) run on the host; each snapshot reaches the device once, where
the embedding sketches it (the one-pass SRHT kernel for n >= 2^16, the
in-kernel Gaussian for ``HwPrngGaussianEmbedding``). With
``offline_dtype=torch.bfloat16`` every primal sketch reads bf16 through
:class:`~rla4mor_tpu_torch.core.linops.CastInputOp` (the kernel's bf16
instance) and ``rb`` is stored in bf16, while the sketched state stays
float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rla4mor_tpu_torch.core.affine import (
    AffineDense,
    compose,
    concat_affine,
    materialize,
    project,
)
from rla4mor_tpu_torch.core.linops import CastInputOp, ChainOp, LinOp
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt
from rla4mor_tpu_torch.core.parameters import Mu
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import (
    ResidualErrorEstimator,
    StationaryFOM,
    StationaryROM,
)
from rla4mor_tpu_torch.mor.classical_reductor import ClassicalReductor
from rla4mor_tpu_torch.ops.embeddings import Embedding, IdentityEmbedding
from rla4mor_tpu_torch.utils.logger import get_logger


def _pinv(R: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse with the JAX package's cutoff, 10 * max(shape) * eps
    relative (torch's default is max(shape) * eps)."""
    rtol = 10 * max(R.shape) * torch.finfo(R.dtype).eps
    return torch.linalg.pinv(R, rtol=rtol)


def _adaptive_rel_dev(rom: StationaryROM, est2: ResidualErrorEstimator,
                      mus: Mu) -> float:
    """Max relative deviation between the ROM's estimator and an independent
    check estimator over a batched Mu."""
    u = rom.solve(mus)
    e1 = rom.error_estimator.estimate_error(u, mus)
    e2 = est2.estimate_error(u, mus)
    tiny = torch.finfo(e1.dtype).tiny
    return float(((e1 - e2).abs() / torch.clamp(torch.maximum(e1, e2), min=tiny)).max())


class SketchedReductor:
    """Online-efficient sketched RB with Galerkin / minres projection."""

    def __init__(
        self,
        fom: StationaryFOM,
        embedding_primal: Optional[Embedding] = None,
        embedding_online: Optional[Embedding] = None,
        product: Optional[Product] = None,
        save_rb: bool = True,
        orthonormalize: bool = True,
        projection: str = "galerkin",
        log_level: int = 20,
        offline_dtype: Optional[torch.dtype] = None,
        truncation_rtol: float = 0.0,
    ):
        """``offline_dtype`` (e.g. ``torch.bfloat16``): store snapshots and
        feed every primal-embedding sketch at that dtype, half the bytes the
        sketches read, while the sketched quantities (srb, residual stacks)
        are float32. bf16 perturbs snapshots by about 2^-9 relative, so the
        error estimates carry an O(1e-3) relative floor. Complex snapshots
        are left uncast.

        ``truncation_rtol`` > 0 drops basis columns whose orthogonalised
        sketch keeps less than rtol of their norm (pyMOR's vector removal);
        0 keeps every column."""
        if projection not in ("galerkin", "minres"):
            raise ValueError(f"unknown projection {projection!r}")
        self.fom = fom
        self.offline_dtype = offline_dtype
        self.truncation_rtol = float(truncation_rtol)
        n = fom.solution_dim
        self.product = product if product is not None else Product.identity(n)
        self.embedding_primal = (
            embedding_primal if embedding_primal is not None
            else IdentityEmbedding(n, device=fom.device)
        )
        emb = self.embedding_primal
        self.embedding_online = (
            embedding_online if embedding_online is not None
            else IdentityEmbedding(emb.range_dim, device=emb.device, dtype=emb.dtype)
        )
        self.save_rb = save_rb
        self.orthonormalize = orthonormalize
        self.projection = projection
        self.logger = get_logger("mor.sketched_reductor", log_level)

        k = emb.range_dim
        self.device, self.dtype = emb.device, emb.dtype
        self.mu_basis: list = []
        self.srb = torch.zeros((k, 0), dtype=self.dtype, device=self.device)
        self.rb = torch.zeros((n, 0), dtype=self.dtype, device=self.device)
        self.residual_lhs: Optional[AffineDense] = None  # (T, k, r)
        self.residual_rhs: Optional[AffineDense] = None  # (Tb, k, 1)
        self.output_functional: Optional[AffineDense] = None  # (To, q, r)
        # Theta o R^-1, reused for every residual sketch; in the offline
        # mode the embedding reads offline_dtype and emits float32
        self._sketch_embedding: LinOp = (
            emb if offline_dtype is None else CastInputOp(emb, offline_dtype))
        self._sketch_map = ChainOp((self._sketch_embedding, self.product.inv))

    @property
    def basis_size(self) -> int:
        return self.srb.shape[1]

    def extend_basis(self, U, mu=None) -> None:
        """Append snapshot columns U (n, m) or (n,) to the sketched state."""
        U = torch.as_tensor(U).to(self.device)
        if U.dim() == 1:
            U = U[:, None]
        if mu is not None:
            self.mu_basis.extend([mu] * U.shape[1])

        if self.save_rb:
            Ustore = U
            if self.offline_dtype is not None and not U.is_complex():
                Ustore = U.to(self.offline_dtype)
            self.rb = torch.cat([self.rb.to(Ustore.dtype), Ustore], dim=1)

        if self.fom.output_functional is not None:
            out_proj = project(self.fom.output_functional, None, U)
            if self.output_functional is not None:
                out_proj = concat_affine((self.output_functional, out_proj), axis=1)
            self.output_functional = out_proj

        self.logger.info("sketch the basis")
        su = self._sketch_embedding.apply(U)
        self.srb = torch.cat([self.srb.to(su.dtype), su], dim=1)

        self.logger.info("sketch the residual")
        sop = project(compose(self._sketch_map, self.fom.operator), None, U)
        if self.residual_lhs is None:
            self.residual_lhs = sop
            self.residual_rhs = materialize(compose(self._sketch_map, self.fom.rhs))
        else:
            self.residual_lhs = concat_affine((self.residual_lhs, sop), axis=1)

        if self.orthonormalize:
            self.orthonormalize_basis(offset=self.basis_size - U.shape[1])

    def orthonormalize_basis(self, offset: int = 0, T=None,
                             truncation_rtol: Optional[float] = None) -> torch.Tensor:
        """Orthonormalise ``srb`` (l2, sketch space) and push the change of
        basis T = pinv(R) through rb, residual and output (or apply a given
        T). Returns T.

        ``truncation_rtol`` (default: the reductor's) > 0 also drops the
        columns past ``offset`` whose orthogonalised direction fell below
        rtol times the column's norm; T is then (r_old, r_kept)."""
        if T is None:
            Q, R = gram_schmidt(self.srb, offset=offset, return_R=True)
            T = _pinv(R)
            rtol = (self.truncation_rtol if truncation_rtol is None
                    else float(truncation_rtol))
            if rtol > 0.0 and self.basis_size > offset:
                col = torch.linalg.vector_norm(R, dim=0)
                keep = R.diagonal().abs() > rtol * torch.clamp(
                    col, min=torch.finfo(col.dtype).tiny)
                keep[:offset] = True
                if not bool(keep.all()):
                    self.logger.info("truncating %d near-dependent basis column(s) "
                                     "(rtol=%.1e)", int((~keep).sum()), rtol)
                    Q, T = Q[:, keep], T[:, keep]
                    if len(self.mu_basis) == keep.numel():
                        self.mu_basis = [m for m, k in zip(self.mu_basis, keep.tolist())
                                         if k]
        else:
            Q = self.srb @ T
        self.srb = Q
        if self.save_rb and self.rb.shape[1]:
            # a bf16 rb is combined in the promoted dtype and stored back
            dt = torch.promote_types(self.rb.dtype, T.dtype)
            self.rb = (self.rb.to(dt) @ T.to(dt)).to(self.rb.dtype)
        if self.residual_lhs is not None:
            self.residual_lhs = self.residual_lhs.rmul(T)
        if self.output_functional is not None:
            self.output_functional = self.output_functional.rmul(T)
        return T

    def truncate_basis(self, r: int) -> None:
        """Keep only the FIRST ``r`` basis columns (no-op if r >= size);
        needs an orthonormalised sketched basis."""
        if r < 0:
            raise ValueError(f"truncate_basis: negative rank {r}")
        if r >= self.basis_size:
            return
        T = torch.eye(self.basis_size, r, dtype=self.srb.dtype, device=self.device)
        self.orthonormalize_basis(T=T)
        self.mu_basis = self.mu_basis[:r]

    def _sketch_residual(self, embedding: Embedding) -> Tuple[AffineDense, AffineDense]:
        return (compose(embedding, self.residual_lhs),
                compose(embedding, self.residual_rhs))

    def reduce(self, embedding=None, seed=None, ls_rcond: float = 1e-13) -> StationaryROM:
        """Emit the online ROM, drawing a fresh online sketch (Galerkin: one
        embedding; minres: one for the system, one for the estimator)."""
        if self.basis_size == 0:
            # classical fallback: the exact Riesz residual estimator of the
            # empty basis instead of an error
            self.logger.info("empty basis: classical residual reduction")
            return ClassicalReductor(self.fom, product=self.product).reduce()
        if self.projection == "galerkin":
            if embedding is None:
                embedding = self.embedding_online.with_seed(seed)
            est_lhs, est_rhs = self._sketch_residual(embedding)
            return StationaryROM(
                self.residual_lhs.lmul(self.srb.conj().T),
                self.residual_rhs.lmul(self.srb.conj().T),
                output_functional=self.output_functional,
                error_estimator=ResidualErrorEstimator(est_lhs, est_rhs),
                ls=False,
            )
        if not isinstance(seed, (tuple, list)):
            seed = (seed, None if seed is None else seed + 1)
        if embedding is None:
            embedding = (self.embedding_online.with_seed(seed[0]),
                         self.embedding_online.with_seed(seed[1]))
        sys_lhs, sys_rhs = self._sketch_residual(embedding[0])
        est_lhs, est_rhs = self._sketch_residual(embedding[1])
        return StationaryROM(
            sys_lhs, sys_rhs,
            output_functional=self.output_functional,
            error_estimator=ResidualErrorEstimator(est_lhs, est_rhs),
            ls=True, ls_rcond=ls_rcond,
        )

    def reduce_adaptive(self, mus_batched: Mu, seed=None, tol: float = 0.2,
                        max_rounds: int = 3, ls_rcond: float = 1e-13):
        """Emit the ROM, cross-check its error estimator against an
        independent online sketch over the batched Mu ``mus_batched``, and
        double the online sketch size until the two agree to relative
        ``tol`` (or the online size reaches the primal sketch size). The
        accepted size stays in ``embedding_online``, so later ``reduce``
        calls keep it.

        Returns ``(rom, info)`` with ``info = {"online_dim", "max_rel_dev",
        "rounds", "certified"}``."""
        if self.basis_size == 0:
            raise ValueError("adaptive reduce needs a nonempty basis")
        mus = {k: torch.as_tensor(v).to(self.device) for k, v in mus_batched.items()}
        base_seed = 0 if seed is None else int(seed)
        k_max = self.embedding_primal.range_dim
        for rnd in range(max_rounds + 1):
            rom = self.reduce(seed=base_seed + 2 * rnd, ls_rcond=ls_rcond)
            # the check sketch comes from a disjoint seed stream (minres
            # reduce() uses (s, s + 1) itself)
            est2 = ResidualErrorEstimator(*self._sketch_residual(
                self.embedding_online.with_seed(base_seed + 100003 + rnd)))
            dev = _adaptive_rel_dev(rom, est2, mus)
            k_now = self.embedding_online.range_dim
            info = {"online_dim": k_now, "max_rel_dev": dev, "rounds": rnd + 1,
                    "certified": dev <= tol}
            self.logger.info("adaptive online sketch: k_online=%d max_rel_dev=%.3e",
                             k_now, dev)
            if dev <= tol or k_now >= k_max:
                if dev > tol:
                    self.logger.warning(
                        "online sketch at primal size %d still deviates %.2e > "
                        "tol %.2e", k_now, dev, tol)
                return rom, info
            if rnd == max_rounds:
                # rounds exhausted: keep embedding_online at the size that
                # produced the returned (uncertified) ROM
                self.logger.warning(
                    "adaptive online sketch: rounds exhausted at k_online=%d "
                    "with max_rel_dev=%.2e > tol %.2e", k_now, dev, tol)
                return rom, info
            self.embedding_online = self.embedding_online.with_range_dim(
                min(2 * k_now, k_max))
        raise AssertionError("unreachable")

    def extend_basis_blocked(self, U, max_block_size: int = 64, mu=None) -> None:
        """Extend by the columns of U in blocks of at most ``max_block_size``:
        the host applies and sketches never hold more columns at once."""
        U = torch.as_tensor(U)
        if U.dim() == 1:
            U = U[:, None]
        for i in range(0, U.shape[1], max_block_size):
            self.extend_basis(U[:, i:i + max_block_size], mu=mu)

    def extend_basis_streamed(self, blocks, mu=None) -> None:
        """Extend by each column block an iterator yields: the snapshot
        matrix never has to exist whole."""
        for block in blocks:
            self.extend_basis(block, mu=mu)

    def reconstruct(self, u_reduced) -> torch.Tensor:
        """Lift reduced coefficients to the full space (needs save_rb)."""
        if not self.save_rb:
            raise ValueError("reconstruct requires save_rb=True")
        u = torch.as_tensor(u_reduced).to(self.device)
        dt = torch.promote_types(self.rb.dtype, u.dtype)
        return self.rb.to(dt) @ u.to(dt)
