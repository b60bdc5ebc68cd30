"""Certified UQ (``mor/uq.py``): output statistics over the parameter box.

The port's counterpart of ``examples/uq_demo.py`` (``run``) and of the
JAX package's greedy-shipped 3-D stencil composition (``run_thermal3d``, the
``uq_thermal3d`` recipe of ``benchmarks/apps_tpu.py``).

``run``: the mean and variance of the 3x3 thermal block's mean temperature
under uniform mu, by Monte Carlo and by scrambled Halton QMC, each sample a
batched reduced solve with its rigorous output certificate; the Sobol
indices of the ROM output; a certified bracket for P[s > mean + std]; then
the same over a time-dependent output: the goal-oriented parabolic composite
(implicit Euler, a localized output), every sample a reduced primal and dual
time loop certified by eta_pr eta_du / alpha. Its checks: every bias bound
finite and nonnegative; at ``check`` sampled parameters the host FOM output
within s_rom +- eta_s (the parabolic one at ``parabolic_check`` parameters,
at the final time); p_lo <= p_nominal <= p_hi. The host flow runs in float64
on ``device`` (the card unless named): its tolerances are below float32's
reach.

``run_thermal3d``: ``StencilThermalBlock3D((2, 2, 2), grid)`` in the
working dtype (float32 on the card; 65^3 = 274,625 nodes at grid 64),
``steps`` greedy steps of the padded sketched greedy (Jacobi-CG to 1e-6,
SRHT k = 256: the one-pass kernel sketches each step's snapshot and its 8
terms) over a batch of 8 candidates,
``state_to_rom``; the rigorous l2 anchor lambda_min(A(1)) on the interior by
the matrix-free SCM (``l2_interior_scm`` with its Jacobi-CG inverse
iteration, two-stage LOBPCG, one restart), min-theta coercivity from the
anchor's certified lower value, the exact l2 dual norm h^3 sqrt(n) of the
mean-value output; certified Halton moments and the exceedance bracket. Its
checks: the anchor certified with alpha_ref > 0; at ``check`` sampled
parameters the float64 FOM output (Jacobi-CG to 1e-10) within s +- eta_s.

    python -m rla4mor_tpu_torch.examples.uq_demo
    python -m rla4mor_tpu_torch.examples.uq_demo --thermal3d
    python -m rla4mor_tpu_torch.examples.uq_demo --cpu --intervals 16 --n 2048
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from rla4mor_tpu_torch.utils.config import resolve_device, sync

DTYPE = torch.float64  # the host flow: its tolerances are below float32's reach
CANDIDATES = 8  # run_thermal3d: the greedy's candidate batch, the recipe's

def _fom_bracket(s_fom, s_rom, eta, label: str) -> float:
    """max |s_fom - s_rom| / eta_s; raises where the certificate fails."""
    err = np.abs(np.asarray(s_fom) - s_rom)
    bad = np.flatnonzero(err > eta * (1 + 1e-9) + 1e-14)
    if bad.size:
        raise RuntimeError(f"{label}: |s_fom - s_rom| above eta_s at samples {bad.tolist()}: "
                           f"{err[bad].tolist()} > {eta[bad].tolist()}")
    return float((err / np.maximum(eta, 1e-300)).max())


def _check_moments(res, label: str) -> None:
    for name in ("bias_bound", "var_bias_bound"):
        v = getattr(res, name)
        if not (math.isfinite(v) and v >= 0.0):
            raise RuntimeError(f"{label}: {name} = {v}")


def _check_bracket(exc, label: str) -> None:
    if not exc.p_lo <= exc.p_nominal <= exc.p_hi:
        raise RuntimeError(f"{label}: bracket [{exc.p_lo}, {exc.p_hi}] misses the nominal "
                           f"{exc.p_nominal}")


def run(intervals: int = 40, n: int = 20000, snapshots: int = 30, k: int = 400,
        k_online: int = 200, batch: int = 4096, sobol_n: int = 2048, check: int = 64,
        parabolic_grid: int = 16, parabolic_nt: int = 30, parabolic_extensions: int = 4,
        parabolic_modes: int = 3, parabolic_k: int = 150, parabolic_check: int = 8,
        device=None, log=print) -> dict:
    """The demo's flow at the JAX demo's widths; returns its readings."""
    from rla4mor_tpu_torch.core import ONE, AffineDense, mu_unstack
    from rla4mor_tpu_torch.models import (
        InstationaryPrimalDualReductor,
        ThermalBlockFOM,
        instationary_thermal_block,
    )
    from rla4mor_tpu_torch.mor import (
        MinThetaCoercivity,
        OutputDualNorm,
        SketchedReductor,
        certified_moments,
        exceedance_probability,
        make_objective,
        sobol_indices,
    )
    from rla4mor_tpu_torch.mor.uq import _batched_output_and_bound, sample_mu_batched
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding

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
    t0 = time.perf_counter()
    red.extend_basis(fom.solve_many(space.sample_randomly(snapshots, seed=7, **kw)))
    rom = red.reduce(seed=1)
    offline_s = time.perf_counter() - t0
    log(f"offline: {snapshots} snapshots -> r={red.basis_size} ({offline_s:.1f}s)")
    alpha = MinThetaCoercivity(fom, {"diffusion": torch.ones(space.dim(), **kw)})
    dual = OutputDualNorm(fom, product=Ru)

    out = {"n_dof": fom.solution_dim, "r": red.basis_size, "offline_s": offline_s,
           "moments": {}}
    for method in ("mc", "halton"):
        # one batch first: the timed run starts warm (the first batched solve
        # on the card, scipy's Halton import)
        certified_moments(rom, space, alpha, dual, n=batch, key=5, method=method,
                          batch=batch)
        sync(dev)
        t0 = time.perf_counter()
        res = certified_moments(rom, space, alpha, dual, n=n, key=5, method=method,
                                batch=batch)
        sync(dev)
        dt = time.perf_counter() - t0
        _check_moments(res, f"moments ({method})")
        log(f"{method:6s}: E[s]={res.mean:.6f} (bias<= {res.bias_bound:.1e}, mc "
            f"+-{res.mc_stderr:.1e})  std={res.std:.6f} (var bias<= "
            f"{res.var_bias_bound:.1e})  [{res.n} samples, {dt:.2f}s = {res.n / dt:.0f} "
            "certified solves/s]")
        out["moments"][method] = {"mean": res.mean, "bias_bound": res.bias_bound,
                                  "mc_stderr": res.mc_stderr, "std": res.std,
                                  "var_bias_bound": res.var_bias_bound, "n": res.n,
                                  "s": dt, "solves_per_s": res.n / dt}

    # the certificate against the host FOM at the first MC samples
    mus = sample_mu_batched(space, check, key=5, **kw)
    s_rom, eta = _batched_output_and_bound(rom, alpha, dual, 0)(mus)
    s_fom = [float(fom.output(fom.solve(mu), mu).reshape(-1)[0]) for mu in mu_unstack(mus)]
    out["fom_check"] = {"samples": check, "max_err_over_eta": _fom_bracket(
        s_fom, s_rom, eta, "stationary"), "max_eta": float(eta.max())}
    log(f"host FOM at {check} samples: max |s_fom - s_rom| / eta_s = "
        f"{out['fom_check']['max_err_over_eta']:.3e} (<= 1)")

    t0 = time.perf_counter()
    sob = sobol_indices(make_objective(rom, space), space, n=sobol_n, key=8,
                        method="halton", batch=batch, **kw)
    sobol_s = time.perf_counter() - t0
    order = sorted(range(space.dim()), key=lambda i: -sob.total[i])[:3]
    log(f"Sobol sensitivities (top 3 of {space.dim()}): " + ", ".join(
        f"{sob.names[i]}: S={sob.first[i]:.3f} T={sob.total[i]:.3f}" for i in order)
        + f" [{sobol_n * (space.dim() + 2)} evals, {sobol_s:.2f}s]")
    out["sobol"] = {"top": [(sob.names[i], float(sob.first[i]), float(sob.total[i]))
                            for i in order], "s": sobol_s, "variance": sob.variance}

    c = res.mean + res.std
    t0 = time.perf_counter()
    exc = exceedance_probability(rom, space, alpha, dual, threshold=c, n=n, key=6,
                                 batch=batch)
    exc_s = time.perf_counter() - t0
    _check_bracket(exc, "exceedance")
    log(f"P[s > {c:.4f}] in [{exc.p_lo:.4f}, {exc.p_hi:.4f}] (nominal {exc.p_nominal:.4f} "
        f"+-{exc.mc_stderr:.1e}; certificate gap {exc.p_hi - exc.p_lo:.1e}) "
        f"[{exc_s:.2f}s]")
    out["exceedance"] = {"threshold": c, "p_lo": exc.p_lo, "p_hi": exc.p_hi,
                         "p_nominal": exc.p_nominal, "s": exc_s}

    # the parabolic composition: every sample a reduced primal + dual time loop
    nx = parabolic_grid
    pfom = instationary_thermal_block((2, 2), nx, T=0.5, nt=parabolic_nt, **kw)
    w = np.zeros((nx - 1, nx - 1))
    w[: nx // 3, : nx // 3] = 1.0  # localized (non-compliant) output
    pfom.output_functional = AffineDense(
        torch.as_tensor(w.reshape(1, 1, -1) / w.sum()).to(dev, DTYPE), (ONE,))
    Ru_p = pfom.products["h1_0"]
    emb_p = GaussianEmbedding.make(pfom.solution_dim, sqrt_product=Ru_p.sqrt,
                                   range_dim=parabolic_k, seed=2, **kw)
    pred = InstationaryPrimalDualReductor(pfom, embedding=emb_p, product=Ru_p, log_level=30)
    pspace = pfom.parameter_space
    t0 = time.perf_counter()
    for m in pspace.sample_randomly(parabolic_extensions, seed=1, **kw):
        pred.extend(m, modes_per_extension=parabolic_modes)
    prom = pred.reduce()
    p_offline_s = time.perf_counter() - t0
    alpha_p = MinThetaCoercivity(pfom, {"diffusion": torch.ones(4, **kw)}, product=Ru_p)
    certified_moments(prom, pspace, alpha_p, None, n=batch, key=5, batch=batch)
    sync(dev)
    t0 = time.perf_counter()
    pres = certified_moments(prom, pspace, alpha_p, None, n=n, key=5, batch=batch)
    sync(dev)
    dt = time.perf_counter() - t0
    _check_moments(pres, "parabolic moments")
    log(f"parabolic final-time output (n={pfom.solution_dim}, nt={parabolic_nt}, "
        f"dual-corrected): E[s(T)]={pres.mean:.6f} (bias<= {pres.bias_bound:.1e})  "
        f"std={pres.std:.6f} [{pres.n} samples, {dt:.2f}s = {pres.n / dt:.0f} certified "
        "time-loops/s]")
    c_p = pres.mean + pres.std
    t0 = time.perf_counter()
    pexc = exceedance_probability(prom, pspace, alpha_p, None, threshold=c_p, n=n, key=6,
                                  batch=batch)
    pexc_s = time.perf_counter() - t0
    _check_bracket(pexc, "parabolic exceedance")
    log(f"P[s(T) > {c_p:.4f}] in [{pexc.p_lo:.4f}, {pexc.p_hi:.4f}] (nominal "
        f"{pexc.p_nominal:.4f}; certificate gap {pexc.p_hi - pexc.p_lo:.1e}) [{pexc_s:.2f}s]")
    mus = sample_mu_batched(pspace, parabolic_check, key=5, **kw)
    s_c, eta = _batched_output_and_bound(prom, alpha_p, None, 0)(mus)
    s_fom = [float(pfom.output_functional.apply(pfom.solve(mu), mu)[0, -1])
             for mu in mu_unstack(mus)]
    ratio = _fom_bracket(s_fom, s_c, eta, "parabolic")
    log(f"host FOM at {parabolic_check} samples: max |s_fom(T) - s_c| / eta_s = "
        f"{ratio:.3e} (<= 1)")
    out["parabolic"] = {
        "n_dof": pfom.solution_dim, "nt": parabolic_nt, "offline_s": p_offline_s,
        "bases": (pred.primal.basis_size, pred.dual_basis_size), "mean": pres.mean,
        "bias_bound": pres.bias_bound, "std": pres.std, "s": dt, "loops_per_s": pres.n / dt,
        "threshold": c_p, "p_lo": pexc.p_lo, "p_hi": pexc.p_hi,
        "p_nominal": pexc.p_nominal, "fom_check_samples": parabolic_check,
        "max_err_over_eta": ratio}
    return out


def run_thermal3d(grid: int = 64, k: int = 256, steps: int = 8, n: int = 20480,
                  batch: int = 4096, check: int = 4, device=None, log=print) -> dict:
    """The greedy-shipped 3-D stencil ROM with its rigorous l2 certificate,
    then certified UQ over it; returns the readings, the ROM (``"rom"``)
    and the SCM (``"scm"``)."""
    from rla4mor_tpu_torch.core import ParameterSpace, mu_stack
    from rla4mor_tpu_torch.examples.large_scale_demo import L2_SCM, run_stages
    from rla4mor_tpu_torch.models import StencilThermalBlock3D
    from rla4mor_tpu_torch.mor import (
        ConstantDualNorm,
        MinThetaCoercivity,
        certified_moments,
        exceedance_probability,
    )
    from rla4mor_tpu_torch.mor.scm_matfree import l2_interior_scm
    from rla4mor_tpu_torch.mor.uq import _batched_output_and_bound, sample_mu_batched
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom

    fom = StencilThermalBlock3D((2, 2, 2), grid, device=device)
    dev, n_dof = fom.device, fom.n_dof
    log(f"FOM: StencilThermalBlock3D((2, 2, 2), {grid}), n = {n_dof}, {fom.dtype}, {dev}")
    state, step = make_sharded_greedy_step(fom, seed=0, k=k, r_max=steps, cg_tol=1e-6,
                                           cg_maxiter=3000, cg_precond="jacobi",
                                           sketch="srht")
    cand = mu_stack(fom.sample_parameters(CANDIDATES, key=1))
    step_s, iters, medians = [], [], []
    t_greedy = time.perf_counter()
    for it in range(steps):
        t0 = time.perf_counter()
        mu = fom.sample_parameters(1, key=10 + it)[0]
        state, est, _ = step(state, mu, cand)
        medians.append(float(est.median()))
        step_s.append(time.perf_counter() - t0)
        iters.append(int(step.last_solve.iters))
        log(f"step {it}: {step_s[-1]:.3f}s, CG {iters[-1]} iterations, median estimate "
            f"{medians[-1]:.3e}")
    greedy_s = time.perf_counter() - t_greedy
    rom = state_to_rom(fom, state)
    r = int(state.ncols)

    # the l2 anchor: lambda_min(A(1)) over the interior, certified
    mu_ref = {"diffusion": torch.ones(fom.n_terms, dtype=fom.dtype, device=dev)}
    t0 = time.perf_counter()
    scm = l2_interior_scm(fom, mu_ref, precond_type="cg", log_level=30, **L2_SCM)
    scm.add_anchor(mu_ref)
    sync(dev)
    anchor_s = time.perf_counter() - t0
    diag = scm.anchor_diagnostics[-1]
    alpha_ref = float(scm.anchor_alphas[0])
    log(f"l2 anchor: lambda ~ {diag['theta']:.6e}, radius {diag['radius']:.1e}, "
        f"alpha_ref {alpha_ref:.6e}, certified={scm.certified}, runs {run_stages(diag)} "
        f"({anchor_s:.1f}s)")
    if not (scm.certified and alpha_ref > 0):
        raise RuntimeError(f"thermal3d anchor: alpha_ref {alpha_ref:.3e}, "
                           f"certified={scm.certified}")
    alpha = MinThetaCoercivity(fom, mu_ref, alpha_ref=alpha_ref)
    alpha.certified = bool(scm.certified)
    dual = ConstantDualNorm(fom.h ** 3 * math.sqrt(n_dof))
    space = ParameterSpace.make({"diffusion": fom.n_terms}, 0.1, 1.0)

    kw = dict(key=5, method="halton", batch=batch)
    certified_moments(rom, space, alpha, dual, n=batch, **kw)  # the first call's set-up
    sync(dev)
    t0 = time.perf_counter()
    res = certified_moments(rom, space, alpha, dual, n=n, **kw)
    sync(dev)
    uq_s = time.perf_counter() - t0
    _check_moments(res, "thermal3d moments")
    log(f"halton: E[s]={res.mean:.6e} (bias<= {res.bias_bound:.1e})  std={res.std:.6e} "
        f"(var bias<= {res.var_bias_bound:.1e}) [{res.n} samples, {uq_s:.3f}s = "
        f"{res.n / uq_s:.0f} certified samples/s at batch {batch}], "
        f"stability_certified={res.stability_certified}")
    c = res.mean + res.std
    exc = exceedance_probability(rom, space, alpha, dual, threshold=c, n=n, key=6,
                                 batch=batch)
    _check_bracket(exc, "thermal3d exceedance")
    log(f"P[s > {c:.6e}] in [{exc.p_lo:.4f}, {exc.p_hi:.4f}] (nominal {exc.p_nominal:.4f})")

    # the certificate against the float64 FOM at the first Halton samples
    fom64 = StencilThermalBlock3D((2, 2, 2), grid, dtype=torch.float64, device=dev)
    mus = sample_mu_batched(space, check, key=5, method="halton", device=dev,
                            dtype=fom.dtype)
    s_rom, eta = _batched_output_and_bound(rom, alpha, dual, 0)(mus)
    s_fom = []
    for i in range(check):
        mu = {"diffusion": mus["diffusion"][i].to(torch.float64)}
        s_fom.append(float(fom64.output(fom64.solve_cg(mu, tol=1e-10, maxiter=20000))))
    ratio = _fom_bracket(s_fom, s_rom, eta, "thermal3d")
    log(f"float64 FOM at {check} samples: max |s_fom - s_rom| / eta_s = {ratio:.3e} (<= 1)")
    return {"n_dof": n_dof, "r": r, "k": k, "step_s": step_s, "cg_iters": iters,
            "median_estimates": medians, "greedy_s": greedy_s, "anchor_s": anchor_s,
            "lambda": diag["theta"], "radius": diag["radius"], "alpha_ref": alpha_ref,
            "certified": bool(scm.certified), "anchor_runs": run_stages(diag),
            "mean": res.mean, "std": res.std, "bias_bound": res.bias_bound,
            "var_bias_bound": res.var_bias_bound, "uq_s": uq_s,
            "samples_per_s": res.n / uq_s, "batch": batch, "samples": res.n,
            "stability_certified": res.stability_certified, "threshold": c,
            "p_lo": exc.p_lo, "p_hi": exc.p_hi, "p_nominal": exc.p_nominal,
            "fom_check_samples": check, "max_err_over_eta": ratio,
            "s_fom": s_fom, "s_rom": s_rom.tolist(), "eta_s": eta.tolist(),
            "rom": rom, "scm": scm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--thermal3d", action="store_true",
                    help="the greedy-shipped 3-D stencil ROM (run_thermal3d)")
    ap.add_argument("--intervals", type=int, default=40)
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--snapshots", type=int, default=30)
    ap.add_argument("--grid", type=int, default=64, help="--thermal3d: intervals a side")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.thermal3d:
        run_thermal3d(grid=args.grid, n=args.n, device=device)
    else:
        run(intervals=args.intervals, n=args.n, snapshots=args.snapshots, device=device)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
