"""Large-scale sketched greedy on a matrix-free stencil FOM, one device.

The port's counterpart of ``examples/large_scale_demo.py`` (BASELINE config
5). ``--family`` picks the FOM, as in the JAX demo:

* ``thermal``: ``StencilThermalBlock((2, 2), N)``, about 4.2M DoF at grid
  2047 (rounded up to 2048 for multigrid), device CG;
* ``advection``: ``StencilAdvectionDiffusion(N)``, non-SPD, device BiCGStab,
  sketched minres projection;
* ``helmholtz``: ``StencilHelmholtz(N)``, indefinite K - ksq M (ksq between
  the first two resonances), BiCGStab, minres;
* ``thermal3d``: ``StencilThermalBlock3D((2, 2, 2), N)``, trilinear 3-D
  (grid 255: 256^3 = 16.8M DoF), Jacobi-CG (the V-cycle is 2-D).

Solves are preconditioned by Jacobi or the V-cycle (``--precond mg``, the
2-D families: on the thermal block's field, on the advection family's
diffusion part, on the Helmholtz family's K). The snapshot and its
residual terms are sketched by the Gaussian Omega or the SRHT (the one-pass
kernel), through the padded greedy step of ``parallel/driver.py``; then
``state_to_rom`` and one served batch padded to 256 requests.

    python -m rla4mor_tpu_torch.examples.large_scale_demo --precond mg --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_demo --family thermal3d --grid 255 --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_demo --cpu --grid 16 --steps 2

The defaults are the JAX demo's (thermal, Jacobi, Gaussian, k = 256, 4
steps). The seeded Gaussian Omega is drawn on the host a chunk at a time,
so at millions of DoF ``--sketch srht`` is the fast route. Each step prints
its time (the first includes any kernel build), the solver's iterations,
the recursive and the true relative residual (recomputed in float64) and
the median sketched estimate over a batch of 8 candidates.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

# the JAX demo's families that need modules the port does not have yet
NOT_PORTED = {
    "nonaffine": "EIM and const_arrays / bind in parallel/driver.py (ROADMAP.md queue 1, "
                 "item 8)",
    "lossy": "its bounds-only flow through the matrix-free SCM (ROADMAP.md queue 1, "
             "item 10)",
}
FAMILIES = ("thermal", "advection", "helmholtz", "thermal3d", *NOT_PORTED)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def true_residual(fom, mu, u: torch.Tensor) -> float:
    """||A(mu) u - b|| / ||b||, recomputed in float64."""
    b = fom.rhs(dtype=torch.float64)
    r = fom.apply(mu, u.to(torch.float64)) - b
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def make_fom(family: str, num_intervals: int, device, dtype=None):
    """The demo's FOM of ``family`` at ``num_intervals`` elements an axis."""
    from rla4mor_tpu_torch import models

    if family == "thermal":
        return models.StencilThermalBlock((2, 2), num_intervals, dtype=dtype, device=device)
    if family == "advection":
        return models.StencilAdvectionDiffusion(num_intervals, dtype=dtype, device=device)
    if family == "helmholtz":
        return models.StencilHelmholtz(num_intervals, dtype=dtype, device=device)
    if family == "thermal3d":
        return models.StencilThermalBlock3D((2, 2, 2), num_intervals, dtype=dtype,
                                            device=device)
    raise ValueError(f"no FOM for family {family!r}")


def run(grid: int = 2047, steps: int = 4, k: int = 256, precond: str = "jacobi",
        sketch: str = "gaussian", score: str = "sketched", device=None, dtype=None,
        batch: int = 8, requests: int = 200, serve_size: int = 256, seed: int = 0,
        select: str = "random", family: str = "thermal", log=print) -> dict:
    """Build the FOM, run ``steps`` greedy steps, ship the ROM and serve one
    padded batch; returns what was built and measured.

    ``select``: how each step's parameter is chosen. ``"random"`` draws it
    (the JAX demo's choice: it times the step); ``"greedy"`` draws the
    first and then takes the batch candidate with the largest estimate of
    the step before among those not taken yet (the weak greedy; at most
    ``batch`` + 1 steps). ``precond="mg"`` applies to the 2-D
    families only; the 3-D one runs Jacobi (with a note)."""
    if family in NOT_PORTED:
        raise NotImplementedError(f"--family {family} needs {NOT_PORTED[family]}")
    if select not in ("random", "greedy"):
        raise ValueError(f"unknown select {select!r}")
    if select == "greedy" and steps > batch + 1:
        raise ValueError(f"select='greedy' takes each of the {batch} candidates once: "
                         f"at most {batch + 1} steps")
    from rla4mor_tpu_torch.core import ParameterSpace, mu_stack
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device(device)
    use_mg = precond == "mg" and family != "thermal3d"
    if precond == "mg" and not use_mg:
        log("NOTE: --precond mg ignored (multigrid needs a 2-D kappa-field family); "
            "using jacobi: at >= 1e7 DoF expect slow CG snapshots")
    N = grid
    if use_mg:  # multigrid needs power-of-two element counts
        while N & (N - 1):
            N += 1
    fom = make_fom(family, N, device, dtype)
    n = math.prod(fom.solution_shape)
    projection = "galerkin" if fom.is_spd else "minres"
    solver = "cg" if fom.is_spd else "bicgstab"
    cg_maxiter = 300 if use_mg else 6000
    dims = "x".join(str(d) for d in fom.solution_shape)
    log(f"device={device} {family} grid {dims}, n = {n} DoF, sketch {sketch} k = {k}, "
        f"precond {'mg' if use_mg else 'jacobi'} ({solver}), {projection}, "
        f"score {score}, {fom.dtype}")

    t0 = time.perf_counter()
    state, step = make_sharded_greedy_step(
        fom, seed=seed, k=k, r_max=steps, cg_tol=1e-7, cg_maxiter=cg_maxiter,
        cg_precond="mg" if use_mg else "jacobi", sketch=sketch, score=score,
        projection=projection)
    _sync(device)
    setup_s = time.perf_counter() - t0
    if family == "thermal":
        space = ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)

        def sample(count, seed):
            return space.sample_randomly(count, seed=seed, device=device)
    else:
        sample = fom.sample_parameters
    mu_batch = mu_stack(sample(batch, 1))
    drawn = [sample(1, 10 + it)[0] for it in range(steps)]

    out = {"fom": fom, "family": family, "n": n, "grid": N, "sample": sample,
           "mu_batch": mu_batch, "projection": projection, "cg_maxiter": cg_maxiter,
           "mus": [], "setup_s": setup_s, "step_s": [], "cg_iters": [],
           "rec_res": [], "true_res": [], "median_est": [], "estimates": [],
           "snapshots": [], "step": step}
    bnorm = float(torch.linalg.vector_norm(fom.rhs()))
    taken = torch.zeros(batch, dtype=torch.bool)
    mu = drawn[0]
    for it in range(steps):
        if it and select == "greedy":
            # candidates already taken are out: at the float32 estimate floor
            # (PERF.md) the largest estimate can be an in-basis parameter,
            # whose snapshot the append then refuses as a duplicate
            pick = int(est.masked_fill(taken, -torch.inf).argmax())
            taken[pick] = True
            mu = {key: v[pick] for key, v in mu_batch.items()}
        elif it:
            mu = drawn[it]
        out["mus"].append(mu)
        t0 = time.perf_counter()
        state, est, u = step(state, mu, mu_batch)
        est = est.cpu()  # the transfer waits for the step
        dt = time.perf_counter() - t0
        solve = step.last_solve
        out["step_s"].append(dt)
        out["cg_iters"].append(solve.iters)
        out["rec_res"].append(float(solve.residual_norm) / bnorm)
        out["true_res"].append(true_residual(fom, mu, u))
        out["median_est"].append(float(est.median()))
        out["estimates"].append(est)
        out["snapshots"].append(u)
        log(f"it {it}: step {dt:.4f}s {solver}_iters={solve.iters} "
            f"rec_res={out['rec_res'][-1]:.3e} true_res={out['true_res'][-1]:.3e} "
            f"basis={int(state.ncols)} median est {out['median_est'][-1]:.3e}")
    out["state"] = state

    t0 = time.perf_counter()
    rom = state_to_rom(fom, state, projection=projection)
    pool = mu_stack(sample(requests, 2))
    padded, valid = pad_batch(pool, serve_size)
    serve_batch(rom, padded)  # warm-up
    _sync(device)
    rom_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = serve_batch(rom, padded)
    _sync(device)
    serve_s = time.perf_counter() - t0
    served = {key: v[:valid] for key, v in served.items()}
    out.update(rom=rom, rom_s=rom_s, served=served, requests=valid, serve_s=serve_s,
               requests_per_s=valid / serve_s)
    log(f"rom r={int(state.ncols)} built in {rom_s:.4f}s; served {valid} requests "
        f"(padded to {serve_size}) in {serve_s:.6f}s ({valid / serve_s:.0f}/s)")
    return out


def profile_step(step, state, mu, mu_batch, top: int = 8) -> dict:
    """One more step under ``torch.profiler``: its wall time, the device's
    busy time (the union of its kernels, copies and sets), its idle share
    over the step, and the ``top`` operators by the device time of the
    kernels each launched. Without device events (the CPU) busy time and
    idle share are None and ``top`` ranks operators by host self time."""
    from torch.profiler import ProfilerActivity, profile

    device = state.srb.device
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        est = step(state, mu, mu_batch)[1].cpu()
        wall_s = time.perf_counter() - t0
    del est
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    res = {"wall_s": wall_s, "device_events": len(kernels), "busy_s": None,
           "idle_share": None}
    if kernels:
        spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
        busy, end = 0.0, float("-inf")
        for a, b in spans:  # union of the intervals, in us
            if b > end:
                busy += b - max(a, end)
                end = b
        res["busy_s"] = busy * 1e-6
        res["idle_share"] = max(0.0, 1.0 - res["busy_s"] / wall_s)

    def device_us(e):  # the device time of the kernels an operator launched itself
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    key = device_us if kernels else (lambda e: e.self_cpu_time_total)
    rows = sorted((e for e in prof.key_averages() if not e.key.startswith("void ")
                   and key(e) > 0), key=lambda e: -key(e))[:top]
    res["top"] = [{"name": e.key[:80], "ms": key(e) * 1e-3, "calls": e.count}
                  for e in rows]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--grid", type=int, default=2047,
                    help="elements an axis (thermal3d: --grid 255 -> 256^3 = 16.8M DoF)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--precond", choices=["jacobi", "mg"], default="jacobi")
    ap.add_argument("--sketch", choices=["gaussian", "srht"], default="gaussian")
    ap.add_argument("--score", choices=["sketched", "exact"], default="sketched")
    ap.add_argument("--select", choices=["random", "greedy"], default="random",
                    help="each step's parameter: drawn (the JAX demo), or the "
                    "batch candidate with the largest estimate")
    ap.add_argument("--family", choices=FAMILIES, default="thermal",
                    help="advection: non-SPD, BiCGStab, minres; helmholtz: indefinite "
                    "K - ksq M, BiCGStab, minres; thermal3d: trilinear 3-D block, "
                    "Jacobi-CG (nonaffine and lossy are not ported)")
    ap.add_argument("--bounds", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step and print its top device operations")
    args = ap.parse_args(argv)
    if args.bounds:
        raise NotImplementedError(
            "--bounds: the matrix-free SCM is not ported (ROADMAP.md queue 1, item 10)")
    res = run(args.grid, args.steps, args.k, args.precond, args.sketch, args.score,
              device="cpu" if args.cpu else None, select=args.select, family=args.family)
    if args.profile:
        prof = profile_step(res["step"], res["state"], res["mus"][-1], res["mu_batch"])
        print(f"profiled step {prof['wall_s']:.4f}s, device busy {prof['busy_s']}s, "
              f"idle share {prof['idle_share']}")
        for row in prof["top"]:
            print(f"  {row['ms']:10.4f} ms {row['calls']:6d}x {row['name']}")
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
