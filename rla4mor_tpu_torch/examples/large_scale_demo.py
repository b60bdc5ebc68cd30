"""Large-scale sketched greedy on the matrix-free thermal block, one device.

The port's counterpart of ``examples/large_scale_demo.py`` (BASELINE config
5), thermal family: ``StencilThermalBlock((2, 2), N)`` at about 4.2M DoF
(grid 2047, rounded up to 2048 for multigrid), device CG preconditioned by
Jacobi or the V-cycle, the snapshot and its residual terms sketched by the
Gaussian Omega or the SRHT (the one-pass kernel), the padded greedy step of
``parallel/driver.py``, then ``state_to_rom`` and one served batch padded
to 256 requests.

    python -m rla4mor_tpu_torch.examples.large_scale_demo --precond mg --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_demo --cpu --grid 16 --steps 2

The defaults are the JAX demo's (Jacobi, Gaussian, k = 256, 4 steps). The
seeded Gaussian Omega is drawn on the host a chunk at a time, so at
millions of DoF ``--sketch srht`` is the fast route. Each step prints its
time (the first includes any kernel build), the CG iterations, the
recursive and the true relative residual (recomputed in float64) and the
median sketched estimate over a batch of 8 candidates.
"""

from __future__ import annotations

import argparse
import time

import torch

FAMILIES = ("thermal", "advection", "helmholtz", "thermal3d", "nonaffine", "lossy")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def true_residual(fom, mu, u: torch.Tensor) -> float:
    """||A(mu) u - b|| / ||b||, recomputed in float64."""
    b = fom.rhs(dtype=torch.float64)
    r = fom.apply(mu, u.to(torch.float64)) - b
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def run(grid: int = 2047, steps: int = 4, k: int = 256, precond: str = "jacobi",
        sketch: str = "gaussian", score: str = "sketched", device=None, dtype=None,
        batch: int = 8, requests: int = 200, serve_size: int = 256, seed: int = 0,
        select: str = "random", log=print) -> dict:
    """Build the FOM, run ``steps`` greedy steps, ship the ROM and serve one
    padded batch; returns what was built and measured.

    ``select``: how each step's parameter is chosen. ``"random"`` draws it
    (the JAX demo's choice: it times the step); ``"greedy"`` draws the
    first and then takes the batch candidate with the largest estimate of
    the step before (the weak greedy)."""
    if select not in ("random", "greedy"):
        raise ValueError(f"unknown select {select!r}")
    from rla4mor_tpu_torch.core import ParameterSpace, mu_stack
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device(device)
    use_mg = precond == "mg"
    N = grid
    if use_mg:  # multigrid needs power-of-two element counts
        while N & (N - 1):
            N += 1
    fom = StencilThermalBlock((2, 2), N, dtype=dtype, device=device)
    n = fom.n_nodes ** 2
    log(f"device={device} thermal grid {fom.n_nodes}x{fom.n_nodes}, n = {n} DoF, "
        f"sketch {sketch} k = {k}, precond {precond}, score {score}, {fom.dtype}")

    t0 = time.perf_counter()
    state, step = make_sharded_greedy_step(
        fom, seed=seed, k=k, r_max=steps, cg_tol=1e-7,
        cg_maxiter=300 if use_mg else 6000, cg_precond=precond, sketch=sketch,
        score=score, projection="galerkin")
    _sync(device)
    setup_s = time.perf_counter() - t0
    space = ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)
    mu_batch = mu_stack(space.sample_randomly(batch, seed=1, device=device))
    drawn = [space.sample_randomly(1, seed=10 + it, device=device)[0] for it in range(steps)]

    out = {"fom": fom, "n": n, "grid": N, "space": space, "mu_batch": mu_batch,
           "mus": [], "setup_s": setup_s, "step_s": [], "cg_iters": [],
           "rec_res": [], "true_res": [], "median_est": [], "estimates": [],
           "snapshots": [], "step": step}
    bnorm = float(torch.linalg.vector_norm(fom.rhs()))
    mu = drawn[0]
    for it in range(steps):
        if it and select == "greedy":
            mu = {key: v[int(est.argmax())] for key, v in mu_batch.items()}
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
        log(f"it {it}: step {dt:.4f}s cg_iters={solve.iters} "
            f"rec_res={out['rec_res'][-1]:.3e} true_res={out['true_res'][-1]:.3e} "
            f"basis={int(state.ncols)} median est {out['median_est'][-1]:.3e}")
    out["state"] = state

    t0 = time.perf_counter()
    rom = state_to_rom(fom, state, projection="galerkin")
    pool = mu_stack(space.sample_randomly(requests, seed=2, device=device))
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
    ap.add_argument("--grid", type=int, default=2047)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--precond", choices=["jacobi", "mg"], default="jacobi")
    ap.add_argument("--sketch", choices=["gaussian", "srht"], default="gaussian")
    ap.add_argument("--score", choices=["sketched", "exact"], default="sketched")
    ap.add_argument("--select", choices=["random", "greedy"], default="random",
                    help="each step's parameter: drawn (the JAX demo), or the "
                    "batch candidate with the largest estimate")
    ap.add_argument("--family", choices=FAMILIES, default="thermal")
    ap.add_argument("--bounds", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step and print its top device operations")
    args = ap.parse_args(argv)
    if args.family != "thermal":
        raise NotImplementedError(
            f"--family {args.family}: only the thermal family is ported "
            "(ROADMAP.md queue 1, item 8)")
    if args.bounds:
        raise NotImplementedError(
            "--bounds: the matrix-free SCM is not ported (ROADMAP.md queue 1, item 10)")
    res = run(args.grid, args.steps, args.k, args.precond, args.sketch, args.score,
              device="cpu" if args.cpu else None, select=args.select)
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
