"""Semilinear (nonlinear-in-state) MOR: POD-DEIM with a certified monotone
error bound.

The port's counterpart of ``examples/semilinear_demo.py``: the monotone
reaction-diffusion thermal block A(mu) u + c(mu) M_L g(u) = f (g cubic by
default) solved by Newton-CG, reduced by POD and the DEIM of the reaction
(one nodal evaluation a magic point), the residual compressed exactly
(Gram) or through an SRHT sketch. Strong monotonicity makes
||u - u_r|| <= ||residual|| / alpha_LB(mu) a bound with the linear family's
coercivity (min-theta, anchored at a dense lambda_min of A(1) at this
size). ``run`` is the JAX demo's flow: the certified strong greedy, one
batched online solve over the test set, containment of the true errors in
the bounds, and with ``parabolic`` the IMEX composition.

``scale`` is the large mode at the widths of the JAX package's
``benchmarks/semilinear_tpu.py``: 2049^2 = 4,198,401 DoF in float32, MG-CG
Newton, a POD-DEIM fit of 4 snapshots with the SRHT k = 256 (one kernel
launch: the residual block [f | A_1 V .. A_4 V | M_L U S]) and one batched
online solve of 4096 parameters.

    python -m rla4mor_tpu_torch.examples.semilinear_demo --cpu --parabolic
    python -m rla4mor_tpu_torch.examples.semilinear_demo --scale
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def dense_anchor(fom) -> float:
    """lambda_min(sym A(mu = 1)) on the interior nodes: a dense eigensolve
    (the JAX demo's anchor; the matrix-free LOBPCG one is for larger n)."""
    n = fom.n_dof
    eye = torch.eye(n, dtype=fom.dtype, device=fom.device)
    A_ref = sum(torch.as_tensor(fom.linear.term_linop(b).apply(eye))
                for b in range(fom.linear.n_terms))
    mask = fom.mass_lumped_diag().reshape(-1) > 0
    Ai = A_ref[mask][:, mask].to(torch.float64)
    return float(torch.linalg.eigvalsh(0.5 * (Ai + Ai.T))[0])


def run(grid: int = 48, train: int = 24, test: int = 32, greedy_steps: int = 8,
        reaction_scale: float = 100.0, nonlinearity: str = "cubic", sketch_dim: int = 0,
        parabolic: bool = False, nt: int = 24, mus_train=None, mus_test=None, device=None,
        dtype=None, log=print) -> dict:
    """The JAX demo's flow; returns what was built and measured.

    ``sketch_dim`` > 0: the SRHT-sketched residual estimator (seed 7).
    ``mus_train`` / ``mus_test``: lists of Mu (default ``train`` draws of
    seed 1, ``test`` of seed 2). ``dtype`` defaults to the device's working
    dtype."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models.semilinear import (
        SemilinearInstationaryFOM,
        SemilinearStencilFOM,
    )
    from rla4mor_tpu_torch.mor.bounds import MinThetaCoercivity
    from rla4mor_tpu_torch.mor.semilinear_reductor import SemilinearReductor
    from rla4mor_tpu_torch.utils.config import sync

    fom = SemilinearStencilFOM((2, 2), grid, dtype=dtype, nonlinearity=nonlinearity,
                               reaction_scale=reaction_scale, device=device)
    device = fom.device
    log(f"FOM: {fom.n_dof} DoF, g={nonlinearity}, c scale {reaction_scale}, {fom.dtype}, "
        f"{device}")
    emb = None
    if sketch_dim > 0:
        from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

        emb = SrhtEmbedding(sketch_dim, fom.n_dof, seed=7, device=device, dtype=fom.dtype)
        log(f"sketched residual estimator: SRHT k={sketch_dim}")
    if mus_train is None:
        mus_train = fom.sample_parameters(train, seed=1)
    if mus_test is None:
        mus_test = fom.sample_parameters(test, seed=2)
    n_test = len(mus_test)

    # certified l2 coercivity: min-theta over the linear family, anchored at
    # lambda_min(sym A(mu_ref = 1))
    mu_ref = {k: torch.ones_like(v) for k, v in mus_train[0].items()}
    alpha_ref = dense_anchor(fom)
    coerc = MinThetaCoercivity(fom, mu_ref, alpha_ref=alpha_ref)
    log(f"l2 anchor lambda_min(A(1)) = {alpha_ref:.4e}")

    red = SemilinearReductor(fom, embedding=emb)
    t0 = time.perf_counter()
    rom, hist = red.greedy(mus_train, n_steps=greedy_steps, coercivity=coerc, n_reserve=2,
                           verbose=True, log=log)
    greedy_s = time.perf_counter() - t0
    log(f"greedy: {len(hist)} steps in {greedy_s:.1f}s -> r={rom.dim}, m_deim={rom.n_deim}")

    batched = mu_stack(mus_test)
    sync(device)
    t0 = time.perf_counter()
    a_b, est_b = rom.solve_and_estimate_batch(batched)
    sync(device)
    online_s = time.perf_counter() - t0
    alpha_b = coerc(batched).to(est_b)
    bounds = est_b / alpha_b
    log(f"online: {n_test} certified solves in {online_s:.3f}s (one batched call)")

    n_check = min(8, n_test)
    V = red.last_basis
    errors, ok = [], []
    log("containment check (FOM Newton truth against the bound):")
    for i in range(n_check):
        u = fom.solve_newton(mus_test[i]).reshape(-1)
        err = float(torch.linalg.vector_norm(u - V @ a_b[i]))
        b_i = float(bounds[i])
        errors.append(err)
        ok.append(err <= b_i * (1 + 1e-8))
        log(f"  mu {i:2d}: err {err:.4e} <= bound {b_i:.4e}  eff "
            f"{b_i / max(err, 1e-300):7.1f}  {'OK' if ok[-1] else 'VIOLATED'}")
    violations = ok.count(False)
    log("all contained" if violations == 0 else f"{violations} VIOLATIONS")
    out = {"n": fom.n_dof, "fom": fom, "reductor": red, "rom": rom, "history": hist,
           "picked": list(red.last_picked), "alpha_ref": alpha_ref, "greedy_s": greedy_s,
           "online_s": online_s, "a": a_b, "estimates": est_b, "alphas": alpha_b,
           "bounds": bounds, "errors": errors, "violations": violations,
           "mus_train": mus_train, "mus_test": mus_test}

    if parabolic:
        log("-- IMEX parabolic composition --")
        ifom = SemilinearInstationaryFOM(fom, T=0.5, nt=nt)
        red_p = SemilinearReductor(fom, embedding=emb)
        t0 = time.perf_counter()
        prom = red_p.fit_instationary(ifom, mus_train[: max(4, len(mus_train) // 4)],
                                      pod_rtol=1e-8, deim_rtol=1e-8, n_reserve=2)
        fit_s = time.perf_counter() - t0
        log(f"parabolic POD-DEIM offline: {fit_s:.1f}s -> r={prom.dim}, "
            f"m_deim={prom.W.shape[1]}")
        Vp = red_p.last_basis
        rels, inds = [], []
        for i in range(min(4, n_test)):
            mu = mus_test[i]
            rec = Vp @ prom.solve(mu)
            truth = ifom.solve_flat(mu)
            rels.append(float(torch.linalg.vector_norm(rec - truth)
                              / torch.linalg.vector_norm(truth).clamp(min=1e-300)))
            inds.append(float(prom.estimate_error(mu)))
            log(f"  mu {i}: traj rel err {rels[-1]:.3e}  space-time indicator "
                f"{inds[-1]:.3e}")
        out["parabolic"] = {"rom": prom, "reductor": red_p, "ifom": ifom, "fit_s": fit_s,
                            "rel_errors": rels, "indicators": inds}
    return out


# benchmarks/semilinear_tpu.py's widths: 2049^2 nodes, 6 parameters, 4
# snapshots, SRHT k = 256, a batch of 4096 (its Newton: MG-CG, tol 1e-6,
# 200 inner iterations)
SCALE_GRID, SCALE_PARAMS, SCALE_SNAPSHOTS, SCALE_K, SCALE_BATCH = 2048, 6, 4, 256, 4096
SCALE_NEWTON = {"newton_tol": 1e-6, "cg_tol": 1e-6, "cg_maxiter": 200, "cg_precond": "mg"}


def numpy_mus(fom, count: int, seed: int) -> list:
    """``count`` parameters drawn with numpy in the FOM's box (diffusion
    first), on the FOM's device and dtype."""
    ps = fom.parameter_space
    rows = np.random.RandomState(seed).uniform(ps.low, ps.high, size=(count, ps.dim()))
    nd = fom.linear.n_terms
    return [{"diffusion": torch.as_tensor(r[:nd]).to(fom.device, fom.dtype),
             "reaction": torch.as_tensor(r[nd:]).to(fom.device, fom.dtype)} for r in rows]


def scale(grid: int = SCALE_GRID, batch: int = SCALE_BATCH, device=None,
          log=print) -> dict:
    """The large mode in the device's working dtype: ``SCALE_PARAMS``
    numpy-drawn parameters (seed 0) at ``grid``^2 elements, Newton solves
    (``SCALE_NEWTON``) at the first ``SCALE_SNAPSHOTS`` (the snapshots) and
    the rest (held out), the fit with the SRHT (k = ``SCALE_K``, seed 7) and
    the exact-Gram fit of the same basis and interpolant in float64, then
    one batched online solve of ``batch`` parameters (after one of another
    batch, the warm-up) and its per-parameter check over 8."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models.semilinear import SemilinearStencilFOM
    from rla4mor_tpu_torch.mor.semilinear_reductor import SemilinearReductor
    from rla4mor_tpu_torch.utils.config import sync

    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

    fom = SemilinearStencilFOM((2, 2), grid, reaction_scale=100.0, device=device)
    device = fom.device
    log(f"FOM: {fom.n_dof:,} DoF, cubic, c scale 100, {fom.dtype}, {device}; Newton "
        f"{SCALE_NEWTON}")
    mus = numpy_mus(fom, SCALE_PARAMS, 0)
    f64 = torch.linalg.vector_norm(fom.rhs(torch.float64))
    solves = []
    for i, mu in enumerate(mus):
        u, info = fom.solve_newton(mu, return_info=True, **SCALE_NEWTON)
        mu64 = {key: v.to(torch.float64) for key, v in mu.items()}
        info["rel_res_f64"] = float(torch.linalg.vector_norm(
            fom.residual(mu64, u.to(torch.float64))) / f64)
        info["finite"] = bool(torch.isfinite(u).all())
        solves.append((u, info))
        log(f"Newton {i}: {info['reason']} after {info['iters']} steps in "
            f"{info['seconds']:.2f}s, CG iterations {info['cg_iters']}, relative residual "
            f"{info['rel_res']:.3e} ({fom.dtype}) {info['rel_res_f64']:.3e} (float64)")
    S = torch.stack([u.reshape(-1) for u, _ in solves[:SCALE_SNAPSHOTS]], dim=1)

    red = SemilinearReductor(fom, embedding=SrhtEmbedding(SCALE_K, fom.n_dof, seed=7,
                                                          device=device, dtype=fom.dtype))
    sync(device)
    t0 = time.perf_counter()
    rom = red.fit(None, snapshots=S, pod_rtol=1e-8, deim_rtol=1e-8, n_reserve=1)
    sync(device)
    fit_s = time.perf_counter() - t0
    log(f"fit (sketched, k = {SCALE_K}): {fit_s:.3f}s -> r={rom.dim}, m_deim={rom.n_deim}, "
        f"residual block {1 + fom.linear.n_terms * rom.dim + rom.n_deim} columns")

    # the exact-Gram estimator of the same basis and interpolant, float64
    fom64 = SemilinearStencilFOM((2, 2), grid, dtype=torch.float64, reaction_scale=100.0,
                                 device=device)
    rom64 = SemilinearReductor(fom64)._assemble_rom(
        red.last_basis.to(torch.float64), red.last_interpolant.to(dtype=torch.float64))
    held = []
    V = red.last_basis.to(torch.float64)
    for (u, _), mu in zip(solves[SCALE_SNAPSHOTS:], mus[SCALE_SNAPSHOTS:]):
        a = rom.solve(mu)
        e_s = float(rom.estimate_error(mu, a))
        mu64 = {key: v.to(torch.float64) for key, v in mu.items()}
        e_g = float(rom64.estimate_error(mu64))
        u64 = u.reshape(-1).to(torch.float64)
        err = float(torch.linalg.vector_norm(u64 - V @ a.to(torch.float64))
                    / torch.linalg.vector_norm(u64))
        held.append({"rel_err": err, "estimate": e_s, "estimate_exact": e_g,
                     "sketched_over_exact": e_s / max(e_g, 1e-300)})
        log(f"held-out: rel error {err:.3e}, sketched estimate {e_s:.3e}, exact-Gram "
            f"(float64) {e_g:.3e}, ratio {held[-1]['sketched_over_exact']:.3f}")
    del rom64, fom64

    def draw(seed_b):
        return mu_stack(numpy_mus(fom, batch, seed_b))

    rom.solve_and_estimate_batch(draw(1))  # warm-up
    mub = draw(2)
    sync(device)
    t0 = time.perf_counter()
    a_b, eta_b = rom.solve_and_estimate_batch(mub)
    sync(device)
    online_s = time.perf_counter() - t0
    loop = [(rom.solve(m), rom.estimate_error(m)) for m in
            [{key: v[i] for key, v in mub.items()} for i in range(8)]]
    batch_dev = max(
        max(float((a_b[i] - a).abs().max() / a.abs().max().clamp(min=1e-30)),
            float((eta_b[i] - e).abs() / e.abs().clamp(min=1e-30)))
        for i, (a, e) in enumerate(loop))
    log(f"online: {batch} samples in {online_s * 1e3:.1f} ms ({batch / online_s:,.0f} "
        f"samples/s); batch vs per-parameter {batch_dev:.2e}")
    return {"n": fom.n_dof, "dtype": str(fom.dtype), "solves": [info for _, info in solves],
            "fit_s": fit_s, "r": rom.dim, "m_deim": rom.n_deim,
            "block": 1 + fom.linear.n_terms * rom.dim + rom.n_deim, "k": SCALE_K,
            "held_out": held,
            "batch": batch, "online_s": online_s, "samples_per_s": batch / online_s,
            "batch_vs_loop": batch_dev, "eta_finite": bool(torch.isfinite(eta_b).all()),
            "rom": rom}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--grid", type=int, default=None,
                    help="elements an axis (default 48; 2048 with --scale)")
    ap.add_argument("--train", type=int, default=24)
    ap.add_argument("--test", type=int, default=32)
    ap.add_argument("--greedy-steps", type=int, default=8)
    ap.add_argument("--reaction-scale", type=float, default=100.0)
    ap.add_argument("--nonlinearity", default="cubic", choices=("cubic", "expm1", "arctan"))
    ap.add_argument("--sketch-dim", type=int, default=0,
                    help=">0: SRHT-sketched residual estimator")
    ap.add_argument("--parabolic", action="store_true",
                    help="also run the IMEX time-dependent composition")
    ap.add_argument("--nt", type=int, default=24)
    ap.add_argument("--scale", action="store_true",
                    help="the large mode (benchmarks/semilinear_tpu.py's widths)")
    ap.add_argument("--batch", type=int, default=SCALE_BATCH)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if args.scale:
        scale(grid=args.grid or SCALE_GRID, batch=args.batch, device=device)
        return 0
    res = run(grid=args.grid or 48, train=args.train, test=args.test,
              greedy_steps=args.greedy_steps, reaction_scale=args.reaction_scale,
              nonlinearity=args.nonlinearity, sketch_dim=args.sketch_dim,
              parabolic=args.parabolic, nt=args.nt, device=device,
              dtype=torch.float64)
    return 0 if res["violations"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
