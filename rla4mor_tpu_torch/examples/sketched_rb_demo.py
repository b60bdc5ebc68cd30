"""Sketched reduced basis: greedy construction and an online study.

The port's counterpart of ``examples/sketched_rb_demo.py``: the thermal
block, an SRHT primal sketch over the h1_0 square root and a Gaussian online
sketch, the weak greedy driven by the sketched estimator over 100 training
parameters, then one batched solve and estimate of 200 test parameters and
the true relative errors of 5 of them beside their estimates. On the card
the flow runs in float32, on the CPU in float64 (the JAX demo's choice).

    python -m rla4mor_tpu_torch.examples.sketched_rb_demo
    python -m rla4mor_tpu_torch.examples.sketched_rb_demo --cpu
"""

from __future__ import annotations

import argparse
import time

from rla4mor_tpu_torch.utils.config import resolve_device, sync


def run(grid: int = 32, blocks: int = 2, sketch_dim: int = 300, extensions: int = 15,
        training: int = 100, test: int = 200, device=None, log=print) -> dict:
    """The demo's flow; returns its readings."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding, SrhtEmbedding

    dev = resolve_device(device)
    fom = ThermalBlockFOM((blocks, blocks), grid, device=dev)
    kw = dict(device=dev, dtype=fom.dtype)
    Ru = fom.h1_0_product
    log(f"FOM: {fom.name}, n = {fom.solution_dim}, {fom.dtype}, {dev}")
    theta = SrhtEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt, range_dim=sketch_dim,
                               seed=0, **kw)
    phi = GaussianEmbedding.make(sketch_dim, range_dim=150, seed=1, **kw)
    red = SketchedReductor(fom, embedding_primal=theta, embedding_online=phi, product=Ru,
                           projection="galerkin", log_level=30)
    train = fom.parameter_space.sample_randomly(training, seed=2, **kw)
    t0 = time.perf_counter()
    result = rb_greedy(fom, red, train, max_extensions=extensions, log_level=30)
    greedy_s = time.perf_counter() - t0
    log(f"greedy: {red.basis_size} basis vectors in {greedy_s:.1f}s")
    log("max estimates: " + " ".join(f"{e:.2e}" for e in result.max_estimates))

    # online study: batched solves + estimates on a test set
    rom = result.rom
    mus = fom.parameter_space.sample_randomly(test, seed=3, **kw)
    rom.solve_and_estimate_batch(mu_stack(mus[:1]))  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    ys, ests = rom.solve_and_estimate_batch(mu_stack(mus))
    sync(dev)
    online_s = time.perf_counter() - t0
    log(f"online: {test} solves+estimates in {online_s * 1e3:.1f} ms "
        f"({online_s / test * 1e6:.0f} us each)")
    errs = []
    for i in range(5):
        u = fom.solve(mus[i])
        errs.append(float(Ru.norm(u - red.rb @ ys[i].to(red.rb.dtype)) / Ru.norm(u)))
    log("true relative errors (5 samples): " + " ".join(f"{e:.2e}" for e in errs))
    log("estimates for the same: " + " ".join(f"{float(ests[i]):.2e}" for i in range(5)))
    return {"n_dof": fom.solution_dim, "basis": red.basis_size, "greedy_s": greedy_s,
            "max_estimates": result.max_estimates, "online_ms": online_s * 1e3,
            "rel_errors": errs, "estimates": [float(ests[i]) for i in range(5)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--sketch-dim", type=int, default=300)
    ap.add_argument("--extensions", type=int, default=15)
    args = ap.parse_args(argv)
    run(grid=args.grid, blocks=args.blocks, sketch_dim=args.sketch_dim,
        extensions=args.extensions, device="cpu" if args.cpu else None)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
