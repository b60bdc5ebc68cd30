"""The padded sketched-greedy step on one device, and its ROM.

Counterpart of ``rla4mor_tpu/parallel/driver.py`` without the mesh. One
greedy iteration of the sketched RB method on a matrix-free stencil FOM:

* the FOM solve is device CG (BiCGStab for non-SPD families),
  preconditioned by Jacobi or the multigrid V-cycle;
* the snapshot and its T affine residual terms are stacked row-wise into
  one (1 + T, n) block and sketched in one call through its (n, 1 + T)
  transposed view (the one-pass SRHT kernel reads it in its rows layout);
* masked incremental Gram-Schmidt extends the padded sketch-space state;
* the error sweep solves the sketched Galerkin (or minres) ROM for a
  parameter batch at once (a batch dimension where the JAX package vmaps).

The state is padded to ``r_max`` columns with a fill counter, as in the
JAX package. ``step(state, mu, mu_batch) -> (state, estimates, u)`` is a
plain function on tensors; it keeps the CG / BiCGStab result of its last
solve as ``step.last_solve``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rla4mor_tpu_torch.core.orthonormalize import masked_append
from rla4mor_tpu_torch.core.solvers import bicgstab, cg, lstsq_dense
from rla4mor_tpu_torch.parallel.sharded_sketch import gaussian_sketch_sharded


class GreedyState(NamedTuple):
    srb: torch.Tensor        # (k, r_max) sketched basis (zero-padded)
    res_lhs: torch.Tensor    # (T, k, r_max) sketched residual columns
    res_rhs: torch.Tensor    # (k,) sketched rhs
    ncols: torch.Tensor      # () int32 fill counter, on the device
    # (r_max, *grid) basis grids, kept only for score="exact"
    # (invariant: srb[:, j] == sketch(U[j]))
    U: Optional[torch.Tensor] = None
    # constant FOM arrays of the non-affine families (not ported yet)
    aux: Optional[dict] = None
    # (n_out, r_max) reduced output columns out[:, j] = l(U[j]), tracked
    # through the same Gram-Schmidt combination as srb (l is linear)
    out: Optional[torch.Tensor] = None


def init_state(k: int, r_max: int, n_terms: int, res_rhs: torch.Tensor,
               U0=None, aux=None, out0=None) -> GreedyState:
    dt, dev = res_rhs.dtype, res_rhs.device
    return GreedyState(
        srb=torch.zeros((k, r_max), dtype=dt, device=dev),
        res_lhs=torch.zeros((n_terms, k, r_max), dtype=dt, device=dev),
        res_rhs=res_rhs,
        ncols=torch.zeros((), dtype=torch.int32, device=dev),
        U=U0,
        aux=aux,
        out=out0,
    )


def _batch_rows(mu_batch) -> list:
    """The rows of a batched Mu as single Mus."""
    count = next(iter(mu_batch.values())).shape[0]
    return [{key: v[i] for key, v in mu_batch.items()} for i in range(count)]


def make_sharded_greedy_step(
    fom,
    seed: int = 0,
    k: int = 32,
    r_max: int = 8,
    cg_tol: float = 1e-6,
    cg_maxiter: int = 500,
    cg_precond: str = "jacobi",
    sketch: str = "gaussian",
    score: str = "sketched",
    exact_dtype=torch.float64,
    projection: str = "galerkin",
    model_error=None,
    embedding=None,
):
    """Build ``(state0, step)`` for the padded greedy on ``fom``'s device.

    ``fom`` follows the stencil protocol (``models/stencil.py``):
    ``n_terms``, ``solution_shape``, ``dtype``, ``device``,
    ``theta_vector(mu)``, ``apply(mu, u)``, ``apply_term(t, u)``,
    ``rhs(dtype=None)``, ``jacobi_diag(mu)``, ``is_spd``; ``kappa(mu)`` for
    ``cg_precond="mg"``; ``output(u)`` for the ROM's output columns.

    ``sketch``: ``"gaussian"`` (the canonical Omega of ``seed``, generated in
    column chunks) or ``"srht"`` (``SrhtEmbedding(k, n, seed)``, the one-pass
    kernel for n >= 2^16). ``embedding``: an embedding of (k, n) used in
    place of the seeded one (a carried ``GaussianEmbedding.from_matrix`` or
    ``SrhtEmbedding.from_plan``). ``cg_precond="mg"`` is the port's V-cycle,
    whose coarse right-hand side is P^T r where the JAX package's is
    P^T r / 4 (``models/multigrid.py``).

    ``projection``: ``"galerkin"`` (sketched Galerkin system) or
    ``"minres"`` (sketched least squares by an SVD, the minimum-norm
    solution for the masked columns).

    ``score``: ``"sketched"`` estimates each candidate by its sketched
    residual; ``"exact"`` keeps the Gram-Schmidt-combined basis grids and
    scores by the true residual ``||A(mu) U y - b||_2`` in ``exact_dtype``.
    ``model_error`` (``score="exact"`` only): ``(mu, u_grid) -> scalar``
    added to each exact estimate."""
    if cg_precond == "mg" and not hasattr(fom, "kappa"):
        raise ValueError("cg_precond='mg' needs a kappa(mu) grid (SPD stencil "
                         "thermal block); use 'jacobi' for this FOM")
    if projection not in ("galerkin", "minres"):
        raise ValueError(f"unknown projection mode {projection!r}")
    if model_error is not None and score != "exact":
        raise ValueError("model_error needs the candidate's reconstructed grid, "
                         "which only score='exact' keeps")
    if score not in ("sketched", "exact"):
        raise ValueError(f"unknown score mode {score!r}")
    if hasattr(fom, "const_arrays"):
        raise NotImplementedError(
            "FOMs with constant array leaves (const_arrays / bind: the non-affine "
            "EIM families) are not ported yet: ROADMAP.md queue 1, item 8")
    n = math.prod(fom.solution_shape)
    T = fom.n_terms

    if embedding is not None:
        if (embedding.range_dim, embedding.l2_dim) != (k, n):
            raise ValueError(f"embedding is ({embedding.range_dim}, "
                             f"{embedding.l2_dim}), the step needs ({k}, {n})")
        sketch_fn = embedding.apply_random
    elif sketch == "srht":
        from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

        sketch_fn = SrhtEmbedding(k, n, seed=seed, device=fom.device,
                                  dtype=fom.dtype).apply_random
    elif sketch == "gaussian":
        def sketch_fn(X):
            return gaussian_sketch_sharded(seed, k, X)
    else:
        raise ValueError(f"unknown sketch {sketch!r}")

    res_rhs = sketch_fn(fom.rhs().reshape(-1))
    U0 = None
    if score == "exact":
        U0 = torch.zeros((r_max, *fom.solution_shape), dtype=fom.dtype,
                         device=fom.device)
    out0 = None
    if hasattr(fom, "output"):
        zero = torch.zeros(fom.solution_shape, dtype=fom.dtype, device=fom.device)
        n_out = torch.atleast_1d(fom.output(zero)).shape[0]
        out0 = torch.zeros((n_out, r_max), dtype=fom.dtype, device=fom.device)
    state0 = init_state(k, r_max, T, res_rhs, U0=U0, out0=out0)
    columns = torch.arange(r_max, device=res_rhs.device)

    def rom_solve_and_estimate(state: GreedyState, mu):
        """(y, estimate) at one Mu, or (B, r_max) and (B,) at a batched Mu."""
        theta = fom.theta_vector(mu).to(state.srb.dtype)
        # mask unused columns: identity rows keep the system solvable
        col_mask = (columns < state.ncols).to(state.srb.dtype)
        res = torch.einsum("...t,tkr->...kr", theta, state.res_lhs) * col_mask
        if projection == "minres":
            # sketched least squares; zero (masked) columns get y = 0 from
            # the minimum-norm SVD solution
            y = lstsq_dense(res, state.res_rhs.expand(*res.shape[:-1]))
        else:
            srb_h = state.srb.conj().T
            A = srb_h @ res
            A = A * col_mask[:, None] + torch.diag(1.0 - col_mask)
            b = (srb_h @ state.res_rhs) * col_mask
            y = torch.linalg.solve(A, b.expand(*A.shape[:-1]))
        est = torch.linalg.vector_norm((res @ y[..., None])[..., 0] - state.res_rhs,
                                       dim=-1)
        return y, est

    def exact_estimate(state: GreedyState, mu, rhs_e):
        """True residual norm ||A(mu) (U y) - b||_2 of the sketched-ROM
        solution, in ``exact_dtype``: one stencil pass per candidate."""
        y, _ = rom_solve_and_estimate(state, mu)
        y = torch.where(columns < state.ncols, y, torch.zeros_like(y)).to(exact_dtype)
        u_rom = torch.zeros(fom.solution_shape, dtype=exact_dtype, device=fom.device)
        for r in range(int(state.ncols)):
            # a column at a time: the basis is never held in exact_dtype
            u_rom = u_rom + y[r] * state.U[r].to(exact_dtype)
        est = torch.linalg.vector_norm(fom.apply(mu, u_rom) - rhs_e)
        if model_error is not None:
            est = est + torch.as_tensor(model_error(mu, u_rom)).to(est)
        return est

    def step(state: GreedyState, mu, mu_batch):
        # 1) FOM solve
        b = fom.rhs()
        if cg_precond == "mg":
            from rla4mor_tpu_torch.models.multigrid import make_vcycle

            M = make_vcycle(fom.kappa(mu))
        else:
            diag = fom.jacobi_diag(mu)
            M = lambda r: r / diag  # noqa: E731
        solver = cg if getattr(fom, "is_spd", True) else bicgstab
        result = solver(lambda v: fom.apply(mu, v), b, precond=M, tol=cg_tol,
                        maxiter=cg_maxiter)
        step.last_solve = result
        u = result.x

        # 2) the snapshot and its residual terms, row-wise, one sketch
        if hasattr(fom, "apply_terms"):
            terms = fom.apply_terms(u)
        else:
            terms = torch.stack([fom.apply_term(t, u) for t in range(T)])
        X = torch.cat([u.reshape(1, n), terms.reshape(T, n)])  # (1 + T, n)
        SX = sketch_fn(X.T)                                     # (k, 1 + T)
        su, s_terms = SX[:, 0], SX[:, 1:]

        # 3) masked incremental Gram-Schmidt in sketch space, the same
        # combination applied to the residual columns, the output columns
        # and (score="exact") the basis grids. The append saturates at r_max
        # (the JAX package's out-of-bounds scatter would be dropped silently)
        # and refuses a degenerate snapshot: non-finite (a diverged solve
        # would poison the state for good) or sketch-dependent (a zero solve
        # or a duplicate leaves only round-off, which would make the masked
        # system singular)
        appended = [(state.res_lhs, s_terms.T, 2)]
        if state.out is not None:
            appended.append((state.out, torch.atleast_1d(fom.output(u)).to(su.dtype), 1))
        if score == "exact":
            appended.append((state.U, u, 0))
        finite = torch.isfinite(su).all() & torch.isfinite(s_terms).all()
        srb, stacks, ncols = masked_append(state.srb, state.ncols, su, appended, ok=finite)
        stacks = iter(stacks)
        res_lhs = next(stacks)
        new_out = next(stacks) if state.out is not None else None
        new_U = next(stacks) if score == "exact" else state.U
        state = state._replace(srb=srb, res_lhs=res_lhs, ncols=ncols, U=new_U, out=new_out)

        # 4) error sweep over the parameter batch
        if score == "exact":
            # one candidate at a time: one n-sized exact_dtype grid at once
            rhs_e = fom.rhs(dtype=exact_dtype)
            estimates = torch.stack([exact_estimate(state, m, rhs_e)
                                     for m in _batch_rows(mu_batch)])
        else:
            _, estimates = rom_solve_and_estimate(state, mu_batch)
        return state, estimates, u

    step.last_solve = None
    return state0, step


def state_to_rom(fom, state: GreedyState, projection: str = "galerkin"):
    """Ship the trained greedy state as a
    :class:`~rla4mor_tpu_torch.models.stationary.StationaryROM`: the same
    sketch-space system the greedy's sweep evaluated, cut to the ``ncols``
    live columns. ``projection='galerkin'`` exports the square sketched
    Galerkin system, ``'minres'`` the sketched least-squares one
    (``ls=True``); the estimator approximates the l2 residual norm
    ``||A(mu) U y - b||_2``. The output functional is ``state.out`` where the
    FOM declares ``output(u)``."""
    from rla4mor_tpu_torch.core.affine import AffineDense
    from rla4mor_tpu_torch.core.parameters import ONE
    from rla4mor_tpu_torch.models.stationary import (
        ResidualErrorEstimator,
        StationaryROM,
    )

    r = int(state.ncols)
    if r == 0:
        raise ValueError("empty greedy state (ncols == 0): run step first")
    if projection not in ("galerkin", "minres"):
        raise ValueError(f"unknown projection mode {projection!r}")
    srb = state.srb[:, :r]               # (k, r)
    res_lhs = state.res_lhs[:, :, :r]    # (T, k, r)
    res_rhs = state.res_rhs[:, None]     # (k, 1)
    coeffs = tuple(fom.affine_operator().coefficients)
    estimator = ResidualErrorEstimator(AffineDense(res_lhs, coeffs),
                                       AffineDense(res_rhs[None], (ONE,)))
    if projection == "minres":
        lhs = AffineDense(res_lhs, coeffs)
        rhs = AffineDense(res_rhs[None], (ONE,))
    else:
        lhs = AffineDense(torch.einsum("kr,tks->trs", srb.conj(), res_lhs), coeffs)
        rhs = AffineDense((srb.conj().T @ res_rhs)[None], (ONE,))
    out_fn = None
    if state.out is not None:
        out_fn = AffineDense(state.out[None, :, :r], (ONE,))
    return StationaryROM(lhs, rhs, output_functional=out_fn, error_estimator=estimator,
                         ls=projection == "minres")
