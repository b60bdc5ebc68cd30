"""Certified ROM-based parameter optimisation (``mor/optimize.py``).

The port's counterpart of ``examples/optimize_demo.py``: minimise the mean
temperature of the 3x3 thermal block over its 9-dimensional box.

1. Multi-start projected gradient on the reduced model, all starts one
   batched tensor, gradients by autograd through the reduced solve;
2. the candidate certified by ``||l||_{R^-1} eta(mu) / alpha_LB(mu)``;
3. where the certificate is looser than ``tol``, one FOM solve at the
   candidate enriches the basis, and the loop repeats.

Then trust-region RB against enrich-at-the-optimum on the non-affine
Gaussian-bump family (MDEIM surrogate, exact reductor, tol 1e-10), and
maximisation and target tracking on the certified ROM. Its checks: the
certificate holds the FOM output at mu* (up to the float64 rounding of the
two outputs, 1e-12 of s); both bump runs converge; the trust
region spends no more FOM solves than enrich-at-the-optimum. The flow runs
in float64 on ``device`` (the card unless named): tol 1e-6 and 1e-10 are
below float32's reach.

    python -m rla4mor_tpu_torch.examples.optimize_demo
    python -m rla4mor_tpu_torch.examples.optimize_demo --cpu --intervals 16
"""

from __future__ import annotations

import argparse
import time

import torch

from rla4mor_tpu_torch.utils.config import resolve_device, sync

DTYPE = torch.float64  # tol 1e-6 and 1e-10 are below float32's reach
BUMP_TOL = 1e-10  # the bump family's certificate tolerance
ROUNDING = 1e-12  # relative rounding floor of a float64 FOM or ROM output


def run(intervals: int = 40, tol: float = 1e-6, k: int = 300, k_online: int = 150,
        starts: int = 8, iters: int = 120, bump_nx: int = 16, device=None,
        log=print) -> dict:
    """The demo's flow at the JAX demo's widths; returns its readings."""
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.models.bump_host import bump_coercivity, bump_host_fom
    from rla4mor_tpu_torch.mor import (
        MinThetaCoercivity,
        SketchedReductor,
        certified_minimize,
        minimize_output,
        trust_region_minimize,
    )
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding, IdentityEmbedding

    dev = resolve_device(device)
    kw = dict(device=dev, dtype=DTYPE)
    fom = ThermalBlockFOM((3, 3), intervals, **kw)
    space, Ru = fom.parameter_space, fom.h1_0_product
    log(f"FOM: n={fom.solution_dim}, parameters={space.dim()}, {DTYPE}, {dev}")
    theta = GaussianEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt, range_dim=k,
                                   seed=0, **kw)
    phi = GaussianEmbedding.make(k, range_dim=k_online, seed=100, **kw)
    red = SketchedReductor(fom, embedding_primal=theta, embedding_online=phi, product=Ru,
                           orthonormalize=True, log_level=30)
    alpha = MinThetaCoercivity(fom, {"diffusion": torch.ones(space.dim(), **kw)})

    t0 = time.perf_counter()
    opt = certified_minimize(fom, red, alpha, tol=tol, n_starts=starts, iters=iters, seed=0,
                             log_level=30)
    sync(dev)
    opt_s = time.perf_counter() - t0
    log(f"certified minimize: J*={opt.value:.8f} +- {opt.bound:.2e} (tol {tol:g}), "
        f"converged={opt.converged}, {opt.n_enrichments} enrichments (basis "
        f"{opt.history[-1]['basis_size']}), {opt_s:.1f}s")
    for h in opt.history:
        log(f"  round {h['round']}: r={h['basis_size']:2d} J={h['value']:.8f} "
            f"bound={h['bound']:.2e} stat={h['stationarity']:.1e}")
    s_fom = float(fom.output(fom.solve(opt.mu), opt.mu).reshape(-1)[0])
    log(f"FOM output at mu*: {s_fom:.8f} (|diff| {abs(s_fom - opt.value):.2e} <= bound "
        f"{opt.bound:.2e})")
    # the bound is exact-arithmetic; the two float64 outputs carry rounding
    # (where the basis spans the optimum the bound itself is at that level)
    if not abs(s_fom - opt.value) <= opt.bound + ROUNDING * abs(s_fom):
        raise RuntimeError(f"certificate failed at mu*: |{s_fom} - {opt.value}| > "
                           f"{opt.bound}")

    # trust-region RB vs enrich-at-the-optimum: FOM-solve economy on the
    # non-affine bump family (MDEIM surrogate)
    def exact_reductor(f):
        Ru_b = f.h1_0_product
        th = IdentityEmbedding(f.solution_dim, sqrt_product=Ru_b.sqrt, **kw)
        return SketchedReductor(f, embedding_primal=th,
                                embedding_online=IdentityEmbedding(th.range_dim, **kw),
                                product=Ru_b, orthonormalize=True, log_level=30)

    bump = bump_host_fom(nx=bump_nx, **kw)
    alpha_b = bump_coercivity(bump)
    log(f"non-affine bump family: n={bump.solution_dim}, MDEIM terms="
        f"{bump.mdeim_op.n_terms}, tol={BUMP_TOL:g}")
    t0 = time.perf_counter()
    trr = trust_region_minimize(bump, exact_reductor(bump), alpha_b, tol=BUMP_TOL, seed=0,
                                log_level=30)
    t_tr = time.perf_counter() - t0
    t0 = time.perf_counter()
    cm = certified_minimize(bump, exact_reductor(bump), alpha_b, tol=BUMP_TOL, n_starts=4,
                            iters=60, seed=0, log_level=30)
    t_cm = time.perf_counter() - t0
    cm_solves = cm.n_enrichments + 1  # + the midpoint seed
    log(f"  {'method':<24} {'J*':>14} {'bound':>10} {'FOM solves':>10} {'time':>7}")
    log(f"  {'trust-region RB':<24} {trr.value:>14.8f} {trr.bound:>10.2e} "
        f"{trr.n_fom_solves:>10d} {t_tr:>6.1f}s")
    log(f"  {'enrich-at-the-optimum':<24} {cm.value:>14.8f} {cm.bound:>10.2e} "
        f"{cm_solves:>10d} {t_cm:>6.1f}s")
    if not (trr.converged and cm.converged):
        raise RuntimeError(f"bump: converged trust region {trr.converged}, "
                           f"enrich-at-the-optimum {cm.converged}")
    if trr.n_fom_solves > cm_solves:
        raise RuntimeError(f"bump: the trust region took {trr.n_fom_solves} FOM solves, "
                           f"enrich-at-the-optimum {cm_solves}")

    # maximisation and target tracking on the certified ROM
    rom = red.reduce(seed=1)
    t0 = time.perf_counter()
    mx = minimize_output(rom, space, objective=lambda s, mu: -s[..., 0].real,
                         n_starts=starts, iters=iters, key=4)
    target = 0.5 * (opt.value - mx.value)
    trk = minimize_output(rom, space, objective=lambda s, mu: (s[..., 0].real - target) ** 2,
                          n_starts=starts, iters=iters, key=5)
    sync(dev)
    both_s = time.perf_counter() - t0
    log(f"range of the output over the box: [{opt.value:.6f}, {-mx.value:.6f}]")
    log(f"target tracking J={target:.6f}: residual^2={trk.value:.2e}, "
        f"stationarity={trk.stationarity:.1e} ({both_s:.1f}s both)")
    return {"n_dof": fom.solution_dim, "value": opt.value, "bound": opt.bound,
            "converged": opt.converged, "n_enrichments": opt.n_enrichments,
            "history": opt.history, "s_fom": s_fom, "s": opt_s,
            "bump": {"n_dof": bump.solution_dim, "terms": bump.mdeim_op.n_terms,
                     "tr": {"value": trr.value, "bound": trr.bound,
                            "fom_solves": trr.n_fom_solves, "steps": trr.n_steps,
                            "converged": trr.converged, "s": t_tr},
                     "cm": {"value": cm.value, "bound": cm.bound, "fom_solves": cm_solves,
                            "converged": cm.converged, "s": t_cm}},
            "range": (opt.value, -mx.value), "target": target,
            "tracking_residual": trk.value, "tracking_stationarity": trk.stationarity,
            "range_s": both_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--intervals", type=int, default=40)
    ap.add_argument("--tol", type=float, default=1e-6)
    args = ap.parse_args(argv)
    run(intervals=args.intervals, tol=args.tol, device="cpu" if args.cpu else None)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
