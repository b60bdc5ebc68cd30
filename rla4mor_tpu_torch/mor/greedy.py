"""Weak greedy reduced-basis construction driven by the sketched estimator.

Counterpart of ``rb_greedy`` in ``rla4mor_tpu/mor/greedy.py``. Each
iteration solves the current ROM and evaluates the sketched error estimator
for the whole training set as one batched call.
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
    """Weak greedy: extend with the FOM solution at the worst-estimated mu."""
    logger = get_logger("mor.greedy", log_level)
    result = GreedyResult(rom=None)
    mus_batched = {k: v.to(reductor.device)
                   for k, v in mu_stack(list(training_set)).items()}

    # bootstrap: all thetas are equal for a mu-independent rhs, so simply
    # take the first sample
    mu0 = training_set[0]
    t0 = time.perf_counter()
    reductor.extend_basis(fom.solve(mu0), mu=mu0)
    result.extension_times.append(time.perf_counter() - t0)
    result.selected_mus.append(mu0)

    first_max = None
    for it in range(1, max_extensions):
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
