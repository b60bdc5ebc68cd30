"""The sketched reductor with its state padded to ``r_max`` columns.

Counterpart of ``rla4mor_tpu/mor/padded_reductor.py``. Every offline tensor
is allocated at ``r_max`` columns with a fill counter on the device, so
every step of a greedy run sees the same shapes (what a CUDA graph of the
step needs; on the TPU it was what kept the step to one compile):

* ``extend_basis`` appends one column at a time by the masked incremental
  CGS-2 of :func:`~rla4mor_tpu_torch.core.orthonormalize.masked_append`,
  the update the greedy driver (``parallel/driver.py``) runs too, applied
  to the sketched basis, the sketched residual stack, the projected output
  and the saved basis; a column already in the basis is skipped;
* ``sweep`` is the masked ROM solve and sketched error estimate over a
  parameter batch (:func:`build_masked_sweep`, also used by
  ``mor.greedy.rb_greedy_padded``);
* ``reduce`` cuts the live columns and emits the ROM through
  :class:`~rla4mor_tpu_torch.mor.sketched_reductor.SketchedReductor`.

Its results equal ``SketchedReductor(orthonormalize=True)`` extended one
column at a time.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import torch

from rla4mor_tpu_torch.core.affine import AffineDense, compose, materialize, project
from rla4mor_tpu_torch.core.linops import ChainOp
from rla4mor_tpu_torch.core.orthonormalize import masked_append
from rla4mor_tpu_torch.core.parameters import Mu, eval_coefficients, mu_stack
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import StationaryFOM, StationaryROM
from rla4mor_tpu_torch.ops.embeddings import Embedding, IdentityEmbedding
from rla4mor_tpu_torch.utils.logger import get_logger


class _PaddedState(NamedTuple):
    srb: torch.Tensor      # (k, r_max) sketched basis, zero-padded
    res_lhs: torch.Tensor  # (T, k, r_max) sketched residual columns
    out: torch.Tensor      # (To, q, r_max) projected output (To = 0 if none)
    rb: torch.Tensor       # (n, r_max) saved basis ((0, r_max) if not saved)
    ncols: torch.Tensor    # () int32 fill counter, on the device


def _append_column(state: _PaddedState, su, sres, out_col, u_col) -> _PaddedState:
    """The masked CGS-2 append of one snapshot's sketch ``su`` (k,), its
    sketched residual terms ``sres`` (T, k), output ``out_col`` (To, q) and
    the snapshot ``u_col`` (n,) (or (0,)) to ``state``; a column that keeps
    less than 100 eps of its sketch norm is skipped, ``ncols`` unchanged."""
    srb, (res_lhs, out, rb), ncols = masked_append(
        state.srb, state.ncols, su,
        [(state.res_lhs, sres, 2), (state.out, out_col, 2), (state.rb, u_col, 1)])
    return _PaddedState(srb, res_lhs, out, rb, ncols)


def build_masked_sweep(r_max: int, minres: bool, op_coeffs, rhs_coeffs):
    """The masked (ROM solve + Phi-sketched estimate) sweep over a batched
    Mu, at ``r_max`` columns masked by the live count.

    ``minres`` solves the Phi1-sketched system by masked minimum-norm least
    squares (the zeroed pad columns get zero coefficients under the SVD
    pseudo-inverse, cutoff ``max(1e-13, 100 eps) * s_max``); galerkin
    solves the square masked system with ones on the dead diagonal. Shared
    by :meth:`PaddedSketchedReductor.sweep` and
    ``mor.greedy.rb_greedy_padded``."""

    def sweep(srb, res_lhs, rhs_stack, phi1, phi2, ncols, mus) -> torch.Tensor:
        dt = srb.dtype
        col_mask = (torch.arange(r_max, device=srb.device) < ncols).to(dt)
        theta = eval_coefficients(op_coeffs, mus, device=srb.device).to(dt)       # (B, T)
        theta_b = eval_coefficients(rhs_coeffs, mus, device=srb.device).to(dt)    # (B, Tb)
        res = torch.einsum("bt,tkr->bkr", theta, res_lhs) * col_mask
        rhs = torch.einsum("bt,tk->bk", theta_b, rhs_stack)
        if minres:
            U, s, Vh = torch.linalg.svd(phi1 @ res, full_matrices=False)
            rcond = max(1e-13, 100 * torch.finfo(s.dtype).eps)
            s_inv = torch.where(s > rcond * s.amax(dim=-1, keepdim=True), 1.0 / s,
                                torch.zeros_like(s))
            Ub = (U.conj().transpose(-1, -2) @ (phi1 @ rhs[..., None]))[..., 0]
            y = (Vh.conj().transpose(-1, -2) @ (s_inv * Ub)[..., None])[..., 0]
        else:
            srb_h = srb.conj().T
            A = (srb_h @ res) * col_mask[:, None] + torch.diag(1.0 - col_mask)
            b = (srb_h @ rhs[..., None])[..., 0] * col_mask
            y = torch.linalg.solve(A, b)
        r = (res @ y[..., None])[..., 0] - rhs
        return torch.linalg.vector_norm((phi2 @ r[..., None])[..., 0], dim=-1)

    return sweep


class PaddedSketchedReductor:
    """Sketched RB reductor with preallocated ``r_max``-column state."""

    def __init__(
        self,
        fom: StationaryFOM,
        embedding_primal: Optional[Embedding] = None,
        embedding_online: Optional[Embedding] = None,
        product: Optional[Product] = None,
        r_max: int = 20,
        save_rb: bool = True,
        projection: str = "galerkin",
        log_level: int = 20,
    ):
        if projection not in ("galerkin", "minres"):
            raise ValueError(f"unknown projection {projection!r}")
        self.fom = fom
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
        self.r_max = int(r_max)
        self.save_rb = save_rb
        self.projection = projection
        self.logger = get_logger("mor.padded_reductor", log_level)
        self.mu_basis: list = []
        self.device = emb.device

        k = emb.range_dim
        T = len(fom.operator.terms)
        self._sketch_map = ChainOp((emb, self.product.inv))
        self.residual_rhs = materialize(compose(self._sketch_map, fom.rhs))  # (Tb, k, 1)
        dt = self.residual_rhs.stack.dtype
        of = fom.output_functional
        To, q = (len(of.coefficients), of.range_dim) if of is not None else (0, 0)
        zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=self.device)  # noqa: E731
        self.state = _PaddedState(
            srb=zeros(k, self.r_max),
            res_lhs=zeros(T, k, self.r_max),
            out=zeros(To, q, self.r_max),
            rb=zeros(n if save_rb else 0, self.r_max),
            ncols=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        self._sweep_fn = None

    @property
    def basis_size(self) -> int:
        return int(self.state.ncols)

    def extend_basis(self, U, mu=None) -> None:
        """Append snapshot columns, one masked append each."""
        U = torch.as_tensor(U).to(self.device)
        if U.dim() == 1:
            U = U[:, None]
        if self.basis_size + U.shape[1] > self.r_max:
            raise ValueError(f"r_max={self.r_max} exceeded")
        if mu is not None:
            self.mu_basis.extend([mu] * U.shape[1])
        dt = self.state.srb.dtype
        for j in range(U.shape[1]):
            u = U[:, j].to(dt)
            # the plain reductor's sketches, one column at a time
            su = torch.as_tensor(self.embedding_primal.apply(u)).to(dt)
            sop = project(compose(self._sketch_map, self.fom.operator), None, u[:, None])
            sres = sop.stack[:, :, 0].to(dt)                                  # (T, k)
            if self.fom.output_functional is not None:
                out_col = project(self.fom.output_functional, None,
                                  u[:, None]).stack[:, :, 0].to(dt)           # (To, q)
            else:
                out_col = self.state.out[:, :, 0]
            u_col = u if self.save_rb else self.state.rb[:, 0]
            self.state = _append_column(self.state, su, sres, out_col, u_col)

    def sweep(self, mus_batched: Mu, seed: int) -> torch.Tensor:
        """Masked ROM solve + sketched-error estimate over a batched Mu, with
        a fresh online sketch of ``seed`` (minres: ``seed`` and ``seed + 1``)."""
        if self._sweep_fn is None:
            self._sweep_fn = build_masked_sweep(
                self.r_max, self.projection == "minres",
                self.fom.operator.coefficients, self.residual_rhs.coefficients)
        dt = self.state.srb.dtype
        phi1 = self.embedding_online.with_seed(seed).matrix().to(dt)
        phi2 = (self.embedding_online.with_seed(seed + 1).matrix().to(dt)
                if self.projection == "minres" else phi1)
        return self._sweep_fn(self.state.srb, self.state.res_lhs,
                              self.residual_rhs.stack[:, :, 0], phi1, phi2,
                              self.state.ncols, mus_batched)

    def to_sketched_reductor(self):
        """The live columns as a :class:`SketchedReductor` (the ROM
        emission is shared)."""
        from rla4mor_tpu_torch.mor.sketched_reductor import SketchedReductor

        red = SketchedReductor(self.fom, embedding_primal=self.embedding_primal,
                               embedding_online=self.embedding_online,
                               product=self.product, save_rb=self.save_rb,
                               orthonormalize=False, projection=self.projection)
        r = self.basis_size
        red.mu_basis = list(self.mu_basis)
        red.srb = self.state.srb[:, :r]
        if self.save_rb:
            red.rb = self.state.rb[:, :r]
        red.residual_lhs = AffineDense(self.state.res_lhs[:, :, :r],
                                       self.fom.operator.coefficients)
        red.residual_rhs = self.residual_rhs
        if self.fom.output_functional is not None:
            red.output_functional = AffineDense(self.state.out[:, :, :r],
                                                self.fom.output_functional.coefficients)
        return red

    def reduce(self, embedding=None, seed=None, **kw) -> StationaryROM:
        return self.to_sketched_reductor().reduce(embedding=embedding, seed=seed, **kw)

    def reconstruct(self, u_reduced) -> torch.Tensor:
        if not self.save_rb:
            raise ValueError("reconstruct requires save_rb=True")
        rb = self.state.rb[:, :self.basis_size]
        u = torch.as_tensor(u_reduced).to(self.device)
        dt = torch.promote_types(rb.dtype, u.dtype)
        return rb.to(dt) @ u.to(dt)


def rb_greedy_no_retrace(
    fom,
    reductor: PaddedSketchedReductor,
    training_set: Sequence[Mu],
    max_extensions: Optional[int] = None,
    atol: float = 0.0,
    rtol: float = 0.0,
    online_seed: int = 0,
    log_level: int = 20,
):
    """Weak greedy on the padded reductor: every extension and sweep at
    the same shapes. Same seed schedule and selection rule as
    ``mor.greedy.rb_greedy``, and as there a reductor that already holds a
    basis (restored by ``load_padded_reductor_state``) is resumed at its
    basis size."""
    from rla4mor_tpu_torch.mor.greedy import GreedyResult, _bootstrap

    logger = get_logger("mor.greedy", log_level)
    result = GreedyResult(rom=None)
    mus_batched = {key: v.to(reductor.device)
                   for key, v in mu_stack(list(training_set)).items()}
    max_extensions = reductor.r_max if max_extensions is None else max_extensions
    if max_extensions > reductor.r_max:
        raise ValueError(f"max_extensions={max_extensions} > r_max={reductor.r_max}")
    _bootstrap(fom, reductor, training_set[0], result)

    first_max = None
    for it in range(reductor.basis_size, max_extensions):
        estimates = reductor.sweep(mus_batched, online_seed + it)
        imax = int(torch.argmax(estimates))
        emax = float(estimates[imax])
        result.max_estimates.append(emax)
        if first_max is None:
            first_max = emax
        logger.info("greedy(no-retrace) it=%d basis=%d max_est=%.3e", it,
                    reductor.basis_size, emax)
        if emax <= atol or (rtol and emax <= rtol * first_max):
            break
        mu = training_set[imax]
        t0 = time.perf_counter()
        reductor.extend_basis(fom.solve(mu), mu=mu)
        result.extension_times.append(time.perf_counter() - t0)
        result.selected_mus.append(mu)

    result.rom = reductor.reduce(seed=online_seed + max_extensions)
    result.iterations = len(result.selected_mus)
    return result
