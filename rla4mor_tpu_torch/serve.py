"""Batched online serving of shipped ROMs.

Counterpart of ``evaluate``, ``evaluate_batch``, ``serve_batch`` and
``pad_batch`` in ``rla4mor_tpu/serve.py``. A request batch is a batched Mu
(leading batch axis on every leaf); the ROM solves, estimates and outputs
for all rows at once: a batched ``torch.linalg.solve`` for a stationary ROM,
one time loop of batched LU solves for an instationary or a wave
(Newmark) one, the primal and the backward dual loop for a
corrected-output composite. The ROM is an
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
    """Online stage of a shippable ROM -> dict; ``mu`` may be one Mu or a
    batch. Dispatch on the ROM's kind, as the JAX package's:

    * corrected-output composites -> ``{"output", "estimate"}`` from
      ``output_corrected`` (their primal trajectory stays internal);
    * time-dependent ROMs (an ``est_lhs`` slot: ``InstationaryROM``,
      ``WaveROM``) -> ``{"u"}`` (the reduced trajectory) plus
      ``"estimate"`` when reduced with an embedding and ``"output"`` when
      the family defines one;
    * stationary ROMs -> ``{"u"}`` plus ``"estimate"`` / ``"output"`` when
      the ROM has them."""
    if hasattr(rom, "output_corrected"):
        s, eta = rom.output_corrected(mu)
        return {"output": s, "estimate": eta}
    if hasattr(rom, "est_lhs"):
        if rom.est_lhs is not None:
            u, eta = rom.solve(mu, return_estimate=True)
            res = {"u": u, "estimate": eta}
        else:
            res = {"u": rom.solve(mu)}
        if rom.output_functional is not None:
            res["output"] = rom.output(res["u"], mu)
        return res
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
