"""Wave-equation MOR: Newmark-beta FOM, POD-greedy ROM and the sketched
space-time residual indicator.

The port's counterpart of ``examples/wave_demo.py``: the host flow
(``wave_thermal_block``: the thermal-block geometry with a standing-wave
displacement bump, host ``splu`` trajectories, h1_0 product, Gaussian k =
120 over its sqrt factor) or, with ``--stencil``, the matrix-free
``WaveStencilFOM`` over ``StencilThermalBlock((2, 2), grid)`` (the membrane
rung up from rest by f = 1; warm-started CG acceleration solves, Jacobi or
the mass-shifted V-cycle replayed from a CUDA graph; l2 product). Both run
``pod_greedy`` with 3 modes an extension over 12 training parameters, then
the held-out trajectories (their error, the indicator, and the exact space-
time residual it sketches, in float64) and one served request batch.

On the card the sketch of the stencil flow can be the one-pass SRHT kernel
(``--sketch srht`` / ``run(embedding=...)``): one launch a ``reduce()``, the
block [M V | A_1 V .. A_4 V | b].

    python -m rla4mor_tpu_torch.examples.wave_demo --cpu
    python -m rla4mor_tpu_torch.examples.wave_demo --stencil --grid 1024 --sketch srht
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

# the JAX demo's sizes: 12 training and 3 held-out draws, 3 POD modes an
# extension, Gaussian k = 120; the served batch: 200 requests padded to 256
N_TRAIN, N_TEST, MODES, K = 12, 3, 3, 120
REQUESTS, SERVE_SIZE = 200, 256


def stencil_residual(dev, mu, U: torch.Tensor, Acc: torch.Tensor) -> float:
    """sqrt(dt sum_{k>=1} ||M a_k + A(mu) u_k - b||_2^2) in float64 of full
    displacements U and accelerations Acc (n, nt+1) of a ``WaveStencilFOM``:
    the exact l2 residual that the sketched indicator approximates."""
    shape = tuple(dev.solution_shape)
    A, _ = dev._make_stiff(mu)  # the stencils apply the field at their input's dtype
    b = dev.stencil.rhs(dtype=torch.float64)
    total = 0.0
    for j in range(1, U.shape[1]):
        u = U[:, j].to(torch.float64).reshape(shape)
        a = Acc[:, j].to(torch.float64).reshape(shape)
        total += float(torch.linalg.vector_norm(dev._mass_apply(a) + A(u) - b)) ** 2
    return (dev.dt * total) ** 0.5


def host_residual(fom, mu, U: torch.Tensor, Acc: torch.Tensor, product) -> float:
    """The same for a host ``WaveFOM``, in the dual norm of ``product``
    (||r||_{R^-1}, one host factorisation of R)."""
    A = fom.assemble_sparse(mu)
    M = sps.csc_matrix(fom.mass.S)
    b = np.asarray(fom.assemble_rhs(mu), np.float64)
    lu = spla.splu(sps.csc_matrix(product.op.S, dtype=np.float64))
    Un, An = (x.detach().cpu().numpy().astype(np.float64) for x in (U, Acc))
    total = 0.0
    for j in range(1, Un.shape[1]):
        r = M @ An[:, j] + A @ Un[:, j] - b
        total += float(r @ lu.solve(r))
    return (fom.dt * total) ** 0.5


def solver_stats(dev, tol: float) -> dict:
    """Acceleration-solve readings over every trajectory the stencil FOM
    solved: iterations of the first step, median and max over all steps,
    the steps above ``tol`` (or not finite) and the mass solves'."""
    iters = [it for log in dev.solve_log for it in log["iters"]]
    rel = [r for log in dev.solve_log for r in log["rel_res"]]
    return {"steps": len(iters), "iters_first": [log["iters"][0] for log in dev.solve_log],
            "iters_median": statistics.median(iters), "iters_max": max(iters),
            "rel_res_max": max(rel), "breakdowns": sum(not (r <= tol * (1 + 1e-5))
                                                      for r in rel),
            "mass_iters": [log["mass_iters"] for log in dev.solve_log],
            "seconds": [log["seconds"] for log in dev.solve_log]}


def run(grid: int = 16, nt: int = 60, extensions: int = 6, k: int = K,
        stencil: bool = False, precond: str = "auto", tol: float | None = None,
        maxiter: int | None = None, embedding=None, train=None, test=None, device=None,
        profile_steps: int = 0, log=print) -> dict:
    """Build the FOM, run POD-greedy, check the held-out trajectories, serve
    one padded batch; returns what was built and measured.

    ``embedding``: None (a Gaussian at seed 0, over the h1_0 sqrt factor on
    the host flow) or a factory ``(n, k) -> Embedding``. ``train`` /
    ``test``: lists of Mu (default 12 draws of seed 1, 3 of seed 2).
    ``tol`` / ``maxiter`` of the stencil solves default to the JAX demo's
    1e-7 / 500. ``profile_steps`` > 0 runs that many Newmark steps of the
    first held-out parameter once more under ``torch.profiler`` (stencil
    flow). ``out["stage_s"]`` holds the seconds of each stage."""
    from rla4mor_tpu_torch import models
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch
    from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device, sync

    device = resolve_device(device)
    dtype = default_dtype(device)
    t_setup = time.perf_counter()
    dev = product = None
    tol = 1e-7 if tol is None else tol
    maxiter = 500 if maxiter is None else maxiter
    if stencil:
        if precond == "auto":  # the V-cycle needs power-of-two element counts
            precond = "mg" if grid & (grid - 1) == 0 else "jacobi"
        st = models.StencilThermalBlock((2, 2), grid, dtype=dtype, device=device)
        dev = models.WaveStencilFOM(st, T=1.0, nt=nt)
        fom = dev.as_reductor_fom(tol=tol, maxiter=maxiter, precond=precond)
        log(f"stencil wave FOM: grid {grid}x{grid}, n = {fom.solution_dim:,}, nt = {nt}, "
            f"{precond}-CG tol {tol:g} maxiter {maxiter}, {dtype}, {device}")
    else:
        fom = models.wave_thermal_block((2, 2), grid, T=1.0, nt=nt, device=device,
                                        dtype=dtype)
        product = fom.products["h1_0"]
        log(f"wave FOM: n = {fom.solution_dim:,}, nt = {nt}, standing-wave u0, {dtype}, "
            f"{device}")
    n = fom.solution_dim
    if embedding is not None:
        theta = embedding(n, k)
    else:
        theta = GaussianEmbedding.make(n, sqrt_product=None if product is None
                                       else product.sqrt, range_dim=k, seed=0,
                                       device=device, dtype=dtype)
    red = models.WaveReductor(fom, embedding=theta, product=product, log_level=30)
    space = fom.parameter_space
    if train is None:
        train = space.sample_randomly(N_TRAIN, seed=1, device=device, dtype=dtype)
    if test is None:
        test = space.sample_randomly(N_TEST, seed=2, device=device, dtype=dtype)
    stage_s = {"setup": time.perf_counter() - t_setup}

    t0 = time.perf_counter()
    rom, hist = models.pod_greedy(fom, red, train, max_extensions=extensions,
                                  modes_per_extension=MODES, log_level=30)
    greedy_s = stage_s["greedy"] = time.perf_counter() - t0
    log(f"POD-greedy: basis {red.basis_size} in {greedy_s:.1f}s, {red.reduce_calls} "
        "reduce() calls")
    log("seconds per FOM trajectory: " + " ".join(f"{s:.2f}" for s in hist["fom_s"]))
    log("max estimates: " + " ".join(f"{e:.3e}" for e in hist["max_estimates"]))

    t0 = time.perf_counter()
    traj_r, eta, acc_r = rom.solve(mu_stack(test), return_estimate=True,
                                   return_acceleration=True)
    held = []
    for i, mu in enumerate(test):
        truth = fom.solve(mu)
        rec = red.reconstruct(traj_r[i])
        rel = float(torch.linalg.vector_norm((rec - truth).to(torch.float64))
                    / torch.linalg.vector_norm(truth.to(torch.float64)))
        acc = red.reconstruct(acc_r[i])
        exact = (stencil_residual(dev, mu, rec, acc) if stencil
                 else host_residual(fom, mu, rec, acc, product))
        held.append({"rel_err": rel, "estimate": float(eta[i]), "exact_residual": exact,
                     "est_over_exact": float(eta[i]) / max(exact, 1e-300)})
        log(f"held-out {i}: rel trajectory err {rel:.3e}, indicator {float(eta[i]):.3e}, "
            f"exact residual {exact:.3e} (ratio {held[-1]['est_over_exact']:.3f})")
        del truth, rec, acc
    stage_s["held_out"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reqs = space.sample_randomly(REQUESTS, seed=7, device=device, dtype=dtype)
    batch, n_valid = pad_batch(mu_stack(reqs), SERVE_SIZE)
    serve_batch(rom, batch)  # warm-up
    sync(device)
    t1 = time.perf_counter()
    served = serve_batch(rom, batch)
    sync(device)
    serve_s = time.perf_counter() - t1
    one = [rom.solve(m, return_estimate=True) for m in reqs[:8]]
    serve_dev = max(
        max(float((served["u"][i] - u).abs().max() / u.abs().max().clamp(min=1e-30)),
            float((served["estimate"][i] - e).abs() / e.abs().clamp(min=1e-30)))
        for i, (u, e) in enumerate(one))
    log(f"served {n_valid} requests padded to {SERVE_SIZE} in {serve_s * 1e3:.1f} ms; vs "
        f"per-parameter solve {serve_dev:.2e}")
    stage_s["serving"] = time.perf_counter() - t0

    prof = stats = None
    if stencil:
        if profile_steps:
            from rla4mor_tpu_torch.examples.large_scale_demo import profile_call

            t0 = time.perf_counter()
            head = models.WaveStencilFOM(dev.stencil, T=dev.dt * profile_steps,
                                         nt=profile_steps)
            prof = profile_call(lambda: head.solve(test[0], tol=tol, maxiter=maxiter,
                                                   precond=precond), device)
            stage_s["profile"] = time.perf_counter() - t0
            log(f"profiled {profile_steps} Newmark steps: wall {prof['wall_s']:.3f}s, busy "
                f"{prof['busy_s']}, idle share {prof['idle_share']}")
        stats = solver_stats(dev, tol)
        log(f"CG iterations per acceleration solve: first {stats['iters_first']}, median "
            f"{stats['iters_median']}, max {stats['iters_max']}; breakdowns "
            f"{stats['breakdowns']} of {stats['steps']} steps")
    log("seconds by stage: " + " ".join(f"{key}={v:.2f}" for key, v in stage_s.items()))
    return {
        "stencil": stencil, "grid": grid, "n": n, "nt": nt, "k": k, "dtype": str(dtype),
        "precond": precond if stencil else None, "tol": tol, "maxiter": maxiter,
        "basis": red.basis_size, "reduce_calls": red.reduce_calls, "stage_s": stage_s,
        "greedy_s": greedy_s, "fom_s": hist["fom_s"], "extension_s": hist["extension_s"],
        "max_estimates": hist["max_estimates"], "selected_mus": hist["selected_mus"],
        "held_out": held, "served": served, "n_valid": n_valid, "serve_s": serve_s,
        "serve_dev": serve_dev, "solver": stats, "profile": prof, "rom": rom,
        "reductor": red, "fom": fom, "stencil_fom": dev, "train": train, "test": test,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--stencil", action="store_true",
                    help="the matrix-free Newmark FOM (big n) instead of host splu")
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--nt", type=int, default=60)
    ap.add_argument("--extensions", type=int, default=6)
    ap.add_argument("--precond", choices=["auto", "jacobi", "mg"], default="auto")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--maxiter", type=int, default=None)
    ap.add_argument("--sketch", choices=["gaussian", "srht"], default="gaussian",
                    help="the JAX demo's Gaussian, or the one-pass SRHT kernel (stencil)")
    ap.add_argument("--profile-steps", type=int, default=0)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    embedding = None
    if args.sketch == "srht":
        if not args.stencil:
            ap.error("--sketch srht sketches the stencil flow's l2 residual: add --stencil")
        from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

        def embedding(n, k):
            return SrhtEmbedding(k, n, seed=0, device=device)
    run(grid=args.grid, nt=args.nt, extensions=args.extensions, stencil=args.stencil,
        precond=args.precond, tol=args.tol, maxiter=args.maxiter, embedding=embedding,
        device=device, profile_steps=args.profile_steps)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
