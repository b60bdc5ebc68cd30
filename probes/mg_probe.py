#!/usr/bin/env python3
"""How the V-cycle's coarse right-hand side sets MG-CG's iterations, and
what the large slice does with each.

    python probes/mg_probe.py --iters [--cpu] [--grids 32 64 128 256 512]
    python probes/mg_probe.py --large [--grids 512] [--reference-cycle]
                              [--steps 4] [--select random]

The port's ``make_vcycle`` hands the coarse level P^T r, 4 times the
full-weighting restriction of the residual; the JAX package's hands it the
full weighting alone, P^T r / 4. The probe reproduces the JAX package's
cycle by scaling the port's ``restrict_full_weighting`` by 1/4 (the tests
hold that cycle equal to the JAX one).

``--iters`` prints, for each grid N (``StencilThermalBlock((2, 2), N)``,
diffusion (0.5, 1.0, 2.0, 0.7)) and each of float64 (tol 1e-10) and
float32 (tol 1e-7), the MG-CG iterations (at most 500) and the true
relative residual (float64) with the port's cycle and with the JAX
package's.

``--large`` runs the large-scale demo (``examples/large_scale_demo.run``,
MG-CG, SRHT k = 256) at each grid with the given step count and parameter
choice, with the port's cycle or, with ``--reference-cycle``, the JAX
package's, then ``chip_smoke.py``'s held-out comparison: the ROM's output
against a float64 solve, its estimate against the exact l2 residual.

Needs the repository; imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MU = (0.5, 1.0, 2.0, 0.7)


@contextlib.contextmanager
def reference_cycle():
    """Within the block, ``make_vcycle`` is the JAX package's cycle: the
    coarse level gets the full weighting, P^T r / 4."""
    from rla4mor_tpu_torch.models import multigrid

    port = multigrid.restrict_full_weighting
    multigrid.restrict_full_weighting = lambda r: 0.25 * port(r)
    try:
        yield
    finally:
        multigrid.restrict_full_weighting = port


def iterations(grids, device) -> None:
    from rla4mor_tpu_torch.core.solvers import cg
    from rla4mor_tpu_torch.models.multigrid import make_vcycle
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock, stencil_apply

    mu = {"diffusion": torch.tensor(MU)}
    for N in grids:
        for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 1e-7)):
            st = StencilThermalBlock((2, 2), N, dtype=dtype, device=device)
            kappa, b = st.kappa(mu), st.rhs()
            b64 = st.rhs(torch.float64)
            row = {}
            for name, ctx in (("port", contextlib.nullcontext), ("jax", reference_cycle)):
                with ctx():
                    res = cg(lambda u: stencil_apply(u, kappa), b,
                             precond=make_vcycle(kappa), tol=tol, maxiter=500)
                true = torch.linalg.vector_norm(st.apply(mu, res.x.double()) - b64)
                row[name] = (res.iters, float(true / torch.linalg.vector_norm(b64)))
            print(f"[iters] N={N} dtype={str(dtype)[6:]} tol={tol:g} "
                  f"port={row['port'][0]} true_res={row['port'][1]:.3e} "
                  f"jax={row['jax'][0]} true_res={row['jax'][1]:.3e}", flush=True)


def large(grids, reference: bool, steps: int, select: str) -> None:
    import chip_smoke as cs
    from rla4mor_tpu_torch.examples import large_scale_demo as demo
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device("cuda:0")
    for N in grids:
        label = f"probe N={N} {'jax' if reference else 'port'} cycle steps={steps} {select}"
        with reference_cycle() if reference else contextlib.nullcontext():
            res = demo.run(grid=N, steps=steps, k=cs.LARGE_K, precond="mg", sketch="srht",
                           device=device, select=select,
                           log=lambda line: print(f"[{label}] {line}", flush=True))
        cs.large_held_out(res, device, label)  # its float64 solves: the port's cycle
        del res
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--grids", type=int, nargs="+", default=[32, 64, 128, 256, 512])
    ap.add_argument("--reference-cycle", action="store_true",
                    help="--large with the JAX package's V-cycle")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--select", choices=["random", "greedy"], default="random")
    args = ap.parse_args(argv)
    if args.iters:
        iterations(args.grids, "cpu" if args.cpu else None)
    if args.large:
        large(args.grids, args.reference_cycle, args.steps, args.select)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
