"""Instationary (parabolic) sketched MOR on the thermal block: POD-greedy,
certified bounds and the goal-oriented corrected output.

The port's counterpart of ``examples/instationary_demo.py``, the same flow:

1. the parabolic thermal block (2x2 blocks, ``grid`` intervals, T = 0.5,
   ``nt`` theta steps), host ``splu`` trajectories;
2. POD-greedy over 20 training parameters, driven by the sketched
   space-time residual estimate (a Gaussian embedding of ``sketch_dim``
   over the h1_0 square root);
3. the held-out trajectory errors and estimates at 5 parameters (one
   batched ROM time loop), the JAX demo's check max error < 0.2;
4. the certified final-time bounds (min-theta coercivity at mu_ref = 0.55,
   ``mor.bounds.parabolic_error_bound``) beside the measured final-time
   M-norm errors;
5. a localized output (the mean over the lower-left third), the
   goal-oriented POD-greedy (``pd_extensions`` = 5 extensions of 2 modes
   over 10 parameters)
   and the corrected output against the plain one at a held-out parameter.

The FOM runs on the host; the reductor, ROMs, sketches and bounds on
``device`` (the card unless named).

    python -m rla4mor_tpu_torch.examples.instationary_demo
    python -m rla4mor_tpu_torch.examples.instationary_demo --cpu --theta 0.5
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def run(grid: int = 16, nt: int = 30, extensions: int = 8, sketch_dim: int = 100,
        theta: float = 1.0, device=None, dtype=None, train=None, test=None,
        embedding=None, pd_extensions: int = 5, log=print) -> dict:
    """The demo's flow; returns its readings and the models it built.
    ``pd_extensions``: the output greedy's extensions (2 modes each, over
    the first 10 training parameters).

    ``embedding``: None (``GaussianEmbedding.make`` over the h1_0 square root
    at seed 0, the dual at seed 77) or a factory ``(n, k, sqrt_product,
    seed) -> Embedding`` called with those seeds. ``train`` / ``test``: lists
    of Mu (default: 20 draws of seed 1, 5 of seed 2)."""
    from rla4mor_tpu_torch.core import ONE, AffineDense, mu_stack
    from rla4mor_tpu_torch.models import (
        InstationaryPrimalDualReductor,
        InstationaryReductor,
        instationary_thermal_block,
        output_pod_greedy,
        pod_greedy,
    )
    from rla4mor_tpu_torch.mor import MinThetaCoercivity, parabolic_error_bound
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding

    pfom = instationary_thermal_block((2, 2), grid, T=0.5, nt=nt, time_theta=theta,
                                      device=device, dtype=dtype)
    device, dtype = pfom.device, pfom.dtype
    Ru = pfom.products["h1_0"]
    n = pfom.solution_dim
    log(f"FOM: n = {n}, nt = {pfom.nt}, dt = {pfom.dt:.3g}, theta = {theta}, {dtype}, "
        f"{device}")

    def make_embedding(seed):
        if embedding is not None:
            return embedding(n, sketch_dim, Ru.sqrt, seed)
        return GaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=sketch_dim,
                                      seed=seed, device=device, dtype=dtype)

    emb = make_embedding(0)
    red = InstationaryReductor(pfom, embedding=emb, product=Ru, log_level=30)
    space = pfom.parameter_space
    if train is None:
        train = space.sample_randomly(20, seed=1, device=device, dtype=dtype)
    if test is None:
        test = space.sample_randomly(5, seed=2, device=device, dtype=dtype)

    t0 = time.perf_counter()
    rom, hist = pod_greedy(pfom, red, train, max_extensions=extensions, log_level=30)
    greedy_s = time.perf_counter() - t0
    log(f"POD-greedy: basis {red.basis_size} in {greedy_s:.1f}s")
    log("max estimates: " + " ".join(f"{e:.2e}" for e in hist["max_estimates"]))

    # online: the held-out trajectories and estimates in one batched loop
    batch = mu_stack(test)
    traj_r, eta = rom.solve(batch, return_estimate=True)
    M = pfom.mass.S
    rels, final_errors = [], []
    for i, mu in enumerate(test):
        rec = red.reconstruct(traj_r[i]).to(torch.float64).cpu().numpy()
        tr = pfom.solve_host(mu)
        rels.append(float(np.linalg.norm(rec - tr) / np.linalg.norm(tr)))
        e = rec[:, -1] - tr[:, -1]
        final_errors.append(float(np.sqrt(e @ (M @ e))))
    estimates = eta.tolist()
    log("true trajectory rel errors: " + " ".join(f"{e:.2e}" for e in rels))
    log("space-time residual estimates: " + " ".join(f"{e:.2e}" for e in estimates))
    if not max(rels) < 0.2:
        raise RuntimeError(f"held-out trajectory error {max(rels):.3e} >= 0.2")

    # certified final-time bounds from the min-theta coercivity
    mu_ref = {"diffusion": torch.full((4,), 0.55, dtype=torch.float64)}
    coer = MinThetaCoercivity(pfom, mu_ref, product=Ru)
    bounds = parabolic_error_bound(rom, batch, coer).tolist()
    log("certified final-time bounds: " + " ".join(f"{b:.2e}" for b in bounds))
    log("measured final-time M-norm errors: " + " ".join(f"{e:.2e}" for e in final_errors))

    # goal-oriented: the discrete-adjoint corrected output of a localized
    # (non-compliant) functional, trained by the output greedy
    w = np.zeros((grid - 1, grid - 1))
    w[: grid // 3, : grid // 3] = 1.0
    pfom.output_functional = AffineDense(
        torch.as_tensor(w.reshape(1, 1, -1) / w.sum()).to(device, dtype), (ONE,))
    red_pd = InstationaryPrimalDualReductor(pfom, embedding=emb,
                                            embedding_dual=make_embedding(77), product=Ru,
                                            log_level=30)
    t0 = time.perf_counter()
    rom_pd, hist_pd = output_pod_greedy(pfom, red_pd, train[:10],
                                        max_extensions=pd_extensions,
                                        modes_per_extension=2, log_level=30)
    pd_s = time.perf_counter() - t0
    log(f"output-greedy: bases {red_pd.primal.basis_size}/{red_pd.dual_basis_size} in "
        f"{pd_s:.1f}s; indicators: "
        + " ".join(f"{e:.2e}" for e in hist_pd["max_indicators"]))
    mu_t = test[0]
    s_true = float(pfom.output_functional.apply(pfom.solve(mu_t), mu_t)[0, -1])
    s_plain = float(rom_pd.output_plain(mu_t))
    s_c, eta_s = rom_pd.output_corrected(mu_t)
    err_plain, err_corr = abs(s_plain - s_true), abs(float(s_c) - s_true)
    log(f"output at held-out mu: true {s_true:.6g}, plain err {err_plain:.2e}, corrected "
        f"err {err_corr:.2e}, indicator {float(eta_s):.2e}")
    return {
        "n": n, "nt": nt, "theta": theta, "basis": red.basis_size, "greedy_s": greedy_s,
        "max_estimates": hist["max_estimates"], "selected_mus": hist["selected_mus"],
        "rel_errors": rels, "estimates": estimates, "bounds": bounds,
        "final_errors": final_errors, "max_indicators": hist_pd["max_indicators"],
        "pd_selected_mus": hist_pd["selected_mus"], "pd_s": pd_s,
        "pd_bases": (red_pd.primal.basis_size, red_pd.dual_basis_size),
        "s_true": s_true, "s_plain": s_plain, "s_corrected": float(s_c),
        "indicator": float(eta_s), "err_plain": err_plain, "err_corrected": err_corr,
        "rom": rom, "rom_pd": rom_pd, "reductor": red, "fom": pfom,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--theta", type=float, default=1.0,
                    help="time scheme: 1 = implicit Euler, 0.5 = Crank-Nicolson")
    ap.add_argument("--grid", type=int, default=16)
    ap.add_argument("--nt", type=int, default=30)
    ap.add_argument("--extensions", type=int, default=8)
    ap.add_argument("--sketch-dim", type=int, default=100)
    args = ap.parse_args(argv)
    run(grid=args.grid, nt=args.nt, extensions=args.extensions, sketch_dim=args.sketch_dim,
        theta=args.theta, device="cpu" if args.cpu else None)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
