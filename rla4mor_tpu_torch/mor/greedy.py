"""Greedy reduced-basis construction.

Counterpart of ``rla4mor_tpu/mor/greedy.py``: the weak greedy ``rb_greedy``
driven by the sketched estimator (each iteration solves the current ROM and
evaluates the estimator for the whole training set as one batched call),
``rb_greedy_padded`` (the same selection through the fixed-shape masked
sweep of ``mor/padded_reductor.py``) and the strong greedy
``rb_greedy_strong`` (selection by the true error against precomputed
snapshots).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Sequence

import torch

from rla4mor_tpu_torch.core.parameters import Mu, mu_stack
from rla4mor_tpu_torch.mor.sketched_reductor import SketchedReductor
from rla4mor_tpu_torch.utils.logger import get_logger


@dataclass
class GreedyResult:
    rom: object
    selected_mus: List[Mu] = field(default_factory=list)
    max_estimates: List[float] = field(default_factory=list)
    extension_times: List[float] = field(default_factory=list)
    iterations: int = 0


def _bootstrap(fom, reductor, mu0: Mu, result: GreedyResult) -> None:
    """First column of an empty reductor: the FOM solution at the first
    training parameter (all thetas are equal for a mu-independent rhs).
    A reductor with a basis (a resumed run) keeps it; its basis parameters
    head ``result.selected_mus``."""
    if reductor.basis_size:
        result.selected_mus.extend(reductor.mu_basis)
        return
    t0 = time.perf_counter()
    reductor.extend_basis(fom.solve(mu0), mu=mu0)
    result.extension_times.append(time.perf_counter() - t0)
    result.selected_mus.append(mu0)


def rb_greedy(
    fom,
    reductor: SketchedReductor,
    training_set: Sequence[Mu],
    max_extensions: int = 20,
    atol: float = 0.0,
    rtol: float = 0.0,
    online_seed: int = 0,
    log_level: int = 20,
) -> GreedyResult:
    """Weak greedy: extend with the FOM solution at the worst-estimated mu.

    A reductor that already holds a basis (e.g. restored by
    ``load_reductor_state``) is resumed: no bootstrap, iteration ``it``
    continues at its basis size with the seed ``online_seed + it``, so a run
    stopped after r extensions and resumed makes the uninterrupted run's
    choices (``rtol`` then measures from the resumed run's first estimate)."""
    logger = get_logger("mor.greedy", log_level)
    result = GreedyResult(rom=None)
    mus_batched = {k: v.to(reductor.device)
                   for k, v in mu_stack(list(training_set)).items()}
    _bootstrap(fom, reductor, training_set[0], result)

    first_max = None
    for it in range(reductor.basis_size, max_extensions):
        rom = reductor.reduce(seed=online_seed + it)
        _, estimates = rom.solve_and_estimate_batch(mus_batched)
        imax = int(torch.argmax(estimates))
        emax = float(estimates[imax])
        result.max_estimates.append(emax)
        if first_max is None:
            first_max = emax
        logger.info("greedy it=%d basis=%d max_est=%.3e", it,
                    reductor.basis_size, emax)
        if emax <= atol or (rtol and emax <= rtol * first_max):
            logger.info("greedy converged")
            result.rom = rom
            result.iterations = it
            return result
        mu = training_set[imax]
        t0 = time.perf_counter()
        reductor.extend_basis(fom.solve(mu), mu=mu)
        result.extension_times.append(time.perf_counter() - t0)
        result.selected_mus.append(mu)

    result.rom = reductor.reduce(seed=online_seed + max_extensions)
    result.iterations = max_extensions
    return result


def rb_greedy_strong(
    fom,
    reductor: SketchedReductor,
    training_set: Sequence[Mu],
    max_extensions: int = 20,
    atol: float = 0.0,
    rtol: float = 0.0,
    relative: bool = False,
    online_seed: int = 0,
    log_level: int = 20,
    snapshots=None,
) -> GreedyResult:
    """Strong greedy: select by the TRUE model error against the training
    snapshots, ``snapshots`` (n, len(training_set)) or solved up front.

    Each iteration solves the ROM for the whole training batch at once,
    lifts the solutions through the stored basis and takes their errors in
    the reductor's product norm (relative to the snapshots' norms where
    ``relative``); the selected snapshot is reused for the extension. Needs
    ``save_rb=True``. ``max_estimates`` holds the max errors."""
    if not reductor.save_rb:
        raise ValueError("strong greedy lifts errors: needs save_rb=True")
    logger = get_logger("mor.greedy", log_level)
    result = GreedyResult(rom=None)
    mus_batched = {k: v.to(reductor.device)
                   for k, v in mu_stack(list(training_set)).items()}
    product = reductor.product

    if snapshots is None:
        snapshots = fom.solve_many(list(training_set))
    U = torch.as_tensor(snapshots).to(reductor.device)
    if U.shape[1] != len(training_set):
        raise ValueError(f"{U.shape[1]} snapshots for {len(training_set)} parameters")
    if relative:
        norms = product.norm(U)
        denom = torch.clamp(norms, min=torch.finfo(norms.dtype).tiny)
    else:
        denom = 1.0

    mu0 = training_set[0]
    t0 = time.perf_counter()
    reductor.extend_basis(U[:, 0], mu=mu0)
    result.extension_times.append(time.perf_counter() - t0)
    result.selected_mus.append(mu0)

    first_max = None
    for it in range(1, max_extensions):
        rom = reductor.reduce(seed=online_seed + it)
        lifted = reductor.reconstruct(rom.solve(mus_batched).T)         # (n, M)
        errors = product.norm(U - lifted.to(U)) / denom
        imax = int(torch.argmax(errors))
        emax = float(errors[imax])
        result.max_estimates.append(emax)
        if first_max is None:
            first_max = emax
        logger.info("greedy(strong) it=%d basis=%d max_err=%.3e", it,
                    reductor.basis_size, emax)
        if emax <= atol or (rtol and emax <= rtol * first_max):
            logger.info("greedy converged")
            result.rom = rom
            result.iterations = it
            return result
        mu = training_set[imax]
        t0 = time.perf_counter()
        reductor.extend_basis(U[:, imax], mu=mu)
        result.extension_times.append(time.perf_counter() - t0)
        result.selected_mus.append(mu)

    result.rom = reductor.reduce(seed=online_seed + max_extensions)
    result.iterations = max_extensions
    return result


def rb_greedy_padded(
    fom,
    reductor: SketchedReductor,
    training_set: Sequence[Mu],
    max_extensions: int = 20,
    atol: float = 0.0,
    rtol: float = 0.0,
    online_seed: int = 0,
    log_level: int = 20,
) -> GreedyResult:
    """Weak greedy whose error sweep runs at fixed shapes: the reductor's
    sketched state is padded to ``max_extensions`` columns and masked by
    its size, so every iteration's sweep has the same shapes. Galerkin
    (masked square solve) or minres (masked minimum-norm least squares).
    Same seed schedule as :func:`rb_greedy`: galerkin draws one online
    sketch an iteration, minres the pair (seed, seed + 1)."""
    from rla4mor_tpu_torch.mor.padded_reductor import build_masked_sweep

    minres = reductor.projection == "minres"
    logger = get_logger("mor.greedy", log_level)
    result = GreedyResult(rom=None)
    mus_batched = {k: v.to(reductor.device)
                   for k, v in mu_stack(list(training_set)).items()}
    r_max = max_extensions

    def padded(t: torch.Tensor) -> torch.Tensor:
        """``t`` with its last (basis) axis zero-padded to r_max."""
        out = t.new_zeros((*t.shape[:-1], r_max))
        out[..., :t.shape[-1]] = t
        return out

    mu0 = training_set[0]
    t0 = time.perf_counter()
    reductor.extend_basis(fom.solve(mu0), mu=mu0)
    result.extension_times.append(time.perf_counter() - t0)
    result.selected_mus.append(mu0)

    # residual_rhs exists only after the first extension
    sweep = build_masked_sweep(r_max, minres, reductor.fom.operator.coefficients,
                               reductor.residual_rhs.coefficients)
    first_max = None
    for it in range(1, max_extensions):
        srb_pad = padded(reductor.srb)
        lhs_pad = padded(reductor.residual_lhs.stack)
        seed = online_seed + it
        phi1 = reductor.embedding_online.with_seed(seed).matrix().to(srb_pad.dtype)
        phi2 = (reductor.embedding_online.with_seed(seed + 1).matrix().to(srb_pad.dtype)
                if minres else phi1)
        ncols = torch.tensor(reductor.basis_size, dtype=torch.int32, device=reductor.device)
        estimates = sweep(srb_pad, lhs_pad, reductor.residual_rhs.stack[:, :, 0], phi1, phi2,
                          ncols, mus_batched)
        imax = int(torch.argmax(estimates))
        emax = float(estimates[imax])
        result.max_estimates.append(emax)
        if first_max is None:
            first_max = emax
        logger.info("greedy(padded) it=%d basis=%d max_est=%.3e", it,
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
