"""Batched online serving of shipped stationary ROMs.

Counterpart of ``evaluate``, ``evaluate_batch``, ``serve_batch`` and
``pad_batch`` in ``rla4mor_tpu/serve.py``. A request batch is a batched Mu
(leading batch axis on every leaf); the ROM solves, estimates and outputs
for all rows at once (batched ``torch.linalg.solve``). The ROM is an
argument, so a refreshed ROM of the same reduced dimensions is served by the
same code path.

Typical serving loop::

    rom = load_rom("model.npz", device="cuda")
    mus, n = pad_batch(request_mus, accepted_batch_size)
    out = serve_batch(rom, mus)
    results = {k: v[:n] for k, v in out.items()}
"""

from __future__ import annotations

from typing import Tuple

import torch


def evaluate(rom, mu) -> dict:
    """Online stage of a stationary ROM -> ``{"u"}`` plus ``"estimate"`` /
    ``"output"`` when the ROM has them. ``mu`` may be one Mu or a batch."""
    u = rom.solve(mu)
    res = {"u": u}
    if getattr(rom, "error_estimator", None) is not None:
        res["estimate"] = rom.error_estimator.estimate_error(u, mu)
    if getattr(rom, "output_functional", None) is not None:
        res["output"] = rom.output(u, mu)
    return res


def evaluate_batch(rom, mus_batched) -> dict:
    """:func:`evaluate` over a batched Mu."""
    return evaluate(rom, mus_batched)


@torch.no_grad()
def serve_batch(rom, mus_batched) -> dict:
    """The serving entry point: :func:`evaluate_batch` without autograd."""
    return evaluate_batch(rom, mus_batched)


def pad_batch(mus_batched, batch_size: int) -> Tuple[dict, int]:
    """Pad a batched Mu up to ``batch_size`` rows -> (padded, n_valid).

    Pads by repeating the LAST request, so padding rows stay inside the
    parameter domain and are dropped by ``x[:n_valid]`` on the way out."""
    if not mus_batched:
        raise ValueError("pad_batch: empty parameter batch")
    n = int(next(iter(mus_batched.values())).shape[0])
    if n > batch_size:
        raise ValueError(
            f"pad_batch: {n} requests exceed batch_size={batch_size}; "
            "split the batch (or pick a larger accepted size)")
    if n == batch_size:
        return mus_batched, n
    pad = batch_size - n
    padded = {k: torch.cat([v, v[-1:].expand(pad, *v.shape[1:])], dim=0)
              for k, v in mus_batched.items()}
    return padded, n
