"""Big-n parabolic MOR on one device: POD-greedy over the matrix-free
implicit-Euler stencil FOM, no host factorisation anywhere.

The port's counterpart of ``examples/large_scale_parabolic_demo.py``:
``InstationaryStencilFOM`` over the thermal block (``--family thermal``,
grid 1024: n = 1,050,625 nodes; MG-CG when the element count is a power of
two, else Jacobi-CG) or its 3-D form (``thermal3d``, Jacobi-CG), nt = 50
implicit-Euler steps (every ``store_every``-th kept as a snapshot), the
sketched space-time residual estimator, 5 POD-greedy extensions over 12
training parameters with ``pad_to`` = 5, then the held-out trajectory and
one served request batch padded to 256.

The sketch is the JAX demo's ``StreamedGaussianEmbedding`` (its strips are
drawn on the host: seconds an apply at a million DoF), or, with
``--sketch srht`` / ``run(embedding=...)``, the one-pass SRHT kernel: one
launch a ``reduce()``, which sketches [M V | A_1 V ... A_4 V | b] as one
block.

    python -m rla4mor_tpu_torch.examples.large_scale_parabolic_demo --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_parabolic_demo --cpu --grid 16 --nt 10
    python -m rla4mor_tpu_torch.examples.large_scale_parabolic_demo --cpu --ranks 2 \
        --backend gloo --grid 31 --greedy-grid 15

The last runs :func:`run_sharded` (the time loop and POD-greedy on the
ranks' DoF slabs, held against one device) on 2 gloo ranks.

It prints the seconds of each extension and FOM trajectory, the CG
iterations of the implicit steps, the max estimates, the held-out
trajectory error at the stored steps, the estimate against the exact l2
space-time residual of the reconstructed trajectory (float64), and the
served batch against per-parameter solves. ``--bounds`` adds the certified
final-time bound: the l2 coercivity anchor lambda_min(A(1), I | interior)
by ``mor/scm_matfree.py::l2_interior_scm`` (two-stage LOBPCG, the V-cycle
on A(1) as its preconditioner when the V-cycle runs the trajectories),
``MinThetaCoercivity`` on it and ``parabolic_error_bound``, against the
measured final-time M-norm error of each held-out trajectory.
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

FAMILIES = ("thermal", "thermal3d")
# the JAX demo's training set; the served batch: 200 requests padded to 256
N_TRAIN, REQUESTS, SERVE_SIZE = 12, 200, 256
# run_sharded: (a) the first SHARDED_STEPS implicit steps of the JAX demo's
# TPU setting (grid 1023, dt = 1/50, Jacobi-CG 1e-6 / 1,500); (b) POD-greedy
# in float64 at GREEDY_GRID (T = 1, GREEDY_NT steps, SRHT of GREEDY_K rows,
# GREEDY_TRAINING parameters, GREEDY_EXTENSIONS, Jacobi-CG GREEDY_TOL)
SHARDED_GRID, SHARDED_NT, SHARDED_STEPS = 1023, 50, 2
SHARDED_TOL, SHARDED_MAXITER = 1e-6, 1500
GREEDY_GRID, GREEDY_NT, GREEDY_K = 127, 10, 128
GREEDY_TRAINING, GREEDY_EXTENSIONS, GREEDY_TOL = 16, 2, 1e-8


def spacetime_residual(fom, mu, U: torch.Tensor) -> float:
    """sqrt(dt sum_k ||M (u_k - u_{k-1}) / dt + A u_th,k - b||_2^2) of a
    full trajectory U (n, nt+1) of an ``InstationaryStencilFOM``, in float64
    with the stencil (u_th,k = theta u_k + (1 - theta) u_{k-1}): the exact
    l2 residual that the sketched estimate approximates."""
    shape = tuple(fom.solution_shape)
    A, _ = fom._make_stiff(mu)  # the stencils apply the field at their input's dtype
    b = fom.stencil.rhs(dtype=torch.float64)
    th, dt = fom.time_theta, fom.dt
    total = 0.0
    prev = U[:, 0].to(torch.float64).reshape(shape)
    for j in range(1, U.shape[1]):
        cur = U[:, j].to(torch.float64).reshape(shape)
        r = fom._mass_apply(cur - prev) / dt + A(th * cur + (1.0 - th) * prev) - b
        total += float(torch.linalg.vector_norm(r)) ** 2
        prev = cur
    return (dt * total) ** 0.5


def solver_stats(fom, tol: float) -> dict:
    """CG readings over every implicit step of every trajectory the FOM
    solved: iterations of the first step (the cold one) and over all steps,
    and the steps that did not reach ``tol`` (or are not finite)."""
    iters = [it for log in fom.solve_log for it in log["iters"]]
    first = [log["iters"][0] for log in fom.solve_log]
    rel = [r for log in fom.solve_log for r in log["rel_res"]]
    bad = sum(not (r <= tol * (1 + 1e-5)) for r in rel)
    return {"steps": len(iters), "iters_first": first, "iters_median": statistics.median(iters),
            "iters_max": max(iters), "rel_res_max": max(rel), "breakdowns": bad}


def run(grid: int = 1024, nt: int = 50, ext: int = 5, k: int = 128, family: str = "thermal",
        precond: str = "auto", embedding=None, train=None, test=None, device=None,
        bounds: bool = False, profile_steps: int = 0, log=print) -> dict:
    """Build the FOM, run POD-greedy, check the held-out trajectory, serve
    one padded batch; returns what was built and measured.

    ``embedding``: None (the streamed Gaussian at seed 0) or a factory
    ``(n, k) -> Embedding``. ``train`` / ``test``: lists of Mu (default: 12
    training draws of seed 1, one held-out draw of seed 5). The device's
    working dtype throughout (float32 on the card, float64 on the CPU).
    ``profile_steps`` > 0 runs the first that many implicit steps of the
    held-out trajectory once more under ``torch.profiler`` (a whole
    trajectory is about 800k device events at grid 1024, whose processing
    takes minutes). ``bounds`` (the JAX demo's ``--bounds``): the certified
    final-time M-norm bound at each held-out parameter (``held_out[i]``'s
    ``bound`` and ``error_M``; the anchor's readings in ``out["bounds"]``).
    ``out["stage_s"]`` holds the seconds of each stage."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    from rla4mor_tpu_torch import models
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.ops.embeddings import StreamedGaussianEmbedding
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch
    from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device, sync

    device = resolve_device(device)
    dtype = default_dtype(device)
    t_setup = time.perf_counter()
    if family == "thermal3d":
        if precond == "mg":
            raise ValueError("precond 'mg' is 2-D only; thermal3d uses jacobi")
        precond = "jacobi"
        st = models.StencilThermalBlock3D((2, 2, 2), grid, dtype=dtype, device=device)
        desc = f"grid {grid}^3 elements"
    else:
        if precond == "auto":  # the V-cycle needs power-of-two element counts
            precond = "mg" if grid & (grid - 1) == 0 else "jacobi"
        st = models.StencilThermalBlock((2, 2), grid, dtype=dtype, device=device)
        desc = f"grid {grid}x{grid} elements"
    fom = models.InstationaryStencilFOM(st, T=1.0, nt=nt)
    n = st.n_nodes ** len(st.solution_shape)
    store_every = max(1, nt // 10)
    while nt % store_every:
        store_every -= 1
    # the V-cycle is mesh-independent; Jacobi-CG's cold first step needs
    # O(sqrt(cond)) iterations (later steps are warm-started)
    tol, maxiter = 1e-6, (60 if precond == "mg" else 1500)
    log(f"{desc}, n = {n:,} nodes, nt = {nt}, sketch k = {k}, {dtype}, {device}")
    log(f"FOM solver: {precond}-CG, tol {tol:g}, maxiter {maxiter}, store_every {store_every}")
    view = fom.as_reductor_fom(tol=tol, maxiter=maxiter, precond=precond,
                               store_every=store_every)
    theta = (embedding(n, k) if embedding is not None
             else StreamedGaussianEmbedding.make(n, range_dim=k, seed=0, device=device,
                                                 dtype=dtype))
    red = models.InstationaryReductor(view, embedding=theta, log_level=30)
    space = view.parameter_space
    if train is None:
        train = space.sample_randomly(N_TRAIN, seed=1, device=device, dtype=dtype)
    if test is None:
        test = space.sample_randomly(1, seed=5, device=device, dtype=dtype)
    stage_s = {"setup": time.perf_counter() - t_setup}

    t0 = time.perf_counter()
    rom, hist = models.pod_greedy(view, red, train, max_extensions=ext, pad_to=ext,
                                  log_level=30)
    greedy_s = stage_s["greedy"] = time.perf_counter() - t0
    log(f"POD-greedy: basis {red.basis_size} in {greedy_s:.1f}s, "
        f"{red.reduce_calls} reduce() calls")
    log("seconds per extension: " + " ".join(f"{s:.2f}" for s in hist["extension_s"]))
    log("seconds per FOM trajectory: " + " ".join(f"{s:.2f}" for s in hist["fom_s"]))
    log("max estimates: " + " ".join(f"{e:.3e}" for e in hist["max_estimates"]))

    certificate = None
    if bounds:
        t0 = time.perf_counter()
        certificate = anchor_coercivity(st, view, precond, log)
        stage_s["bounds_fit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    mus_t = mu_stack(test)
    traj_r, eta = rom.solve(mus_t, return_estimate=True)
    held = []
    for i, mu in enumerate(test):
        truth = view.solve(mu)
        full = red.reconstruct(traj_r[i])
        rec = full[:, ::store_every]  # the ROM steps every step: compare at the stored ones
        rel = float(torch.linalg.vector_norm((rec - truth).to(torch.float64))
                    / torch.linalg.vector_norm(truth.to(torch.float64)))
        exact = spacetime_residual(fom, mu, full)
        held.append({"rel_err": rel, "estimate": float(eta[i]), "exact_residual": exact,
                     "est_over_exact": float(eta[i]) / max(exact, 1e-300),
                     "fom_s": fom.solve_log[-1]["seconds"]})
        log(f"held-out {i}: trajectory rel error {rel:.3e}, space-time estimate "
            f"{float(eta[i]):.3e}, exact l2 residual {exact:.3e} (ratio "
            f"{float(eta[i]) / max(exact, 1e-300):.3f})")
        if certificate is not None:
            from rla4mor_tpu_torch.mor import parabolic_error_bound

            bound = float(parabolic_error_bound(rom, mu, certificate["coercivity"],
                                                kind="final"))
            eT = (rec[:, -1] - truth[:, -1]).to(torch.float64).reshape(st.solution_shape)
            err_M = float(torch.vdot(eT.reshape(-1), fom._mass_apply(eT).reshape(-1)).real
                          ) ** 0.5
            held[-1].update(bound=bound, error_M=err_M,
                            effectivity=bound / max(err_M, 1e-300))
            log(f"certified final-time M-norm bound {bound:.3e} (measured {err_M:.3e}, "
                f"effectivity {bound / max(err_M, 1e-300):.1f}x): rigorous up to sketch "
                "distortion")
        del truth, full, rec
    stage_s["held_out"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reqs = space.sample_randomly(REQUESTS, seed=7, device=device, dtype=dtype)
    batch, n_valid = pad_batch(mu_stack(reqs), SERVE_SIZE)
    rom_solve = lambda: serve_batch(rom, batch)  # noqa: E731
    rom_solve()  # warm-up
    sync(device)
    t0 = time.perf_counter()
    served = rom_solve()
    sync(device)
    serve_s = time.perf_counter() - t0
    one = [rom.solve(m, return_estimate=True) for m in reqs[:8]]
    serve_dev = max(
        max(float((served["u"][i] - u).abs().max() / u.abs().max().clamp(min=1e-30)),
            float((served["estimate"][i] - e).abs() / e.abs().clamp(min=1e-30)))
        for i, (u, e) in enumerate(one))
    log(f"served {n_valid} requests padded to {SERVE_SIZE} in {serve_s * 1e3:.1f} ms; "
        f"vs per-parameter solve {serve_dev:.2e}")
    stage_s["serving"] = time.perf_counter() - t0

    prof = None
    if profile_steps:
        from rla4mor_tpu_torch.examples.large_scale_demo import profile_call

        t0 = time.perf_counter()
        head = models.InstationaryStencilFOM(st, T=fom.dt * profile_steps, nt=profile_steps)
        prof = profile_call(lambda: head.solve(test[0], tol=tol, maxiter=maxiter,
                                               precond=precond), device)
        stage_s["profile"] = time.perf_counter() - t0
        log(f"profiled {profile_steps} implicit steps: wall {prof['wall_s']:.3f}s, busy "
            f"{prof['busy_s']}, idle share {prof['idle_share']}")
    stats = solver_stats(fom, tol)
    log(f"CG iterations per implicit step: first {stats['iters_first']}, median "
        f"{stats['iters_median']}, max {stats['iters_max']}; breakdowns "
        f"{stats['breakdowns']} of {stats['steps']} steps")
    log("seconds by stage: " + " ".join(f"{k}={v:.2f}" for k, v in stage_s.items()))
    return {
        "family": family, "grid": grid, "n": n, "nt": nt, "k": k, "dtype": str(dtype),
        "precond": precond, "tol": tol, "maxiter": maxiter, "store_every": store_every,
        "basis": red.basis_size, "reduce_calls": red.reduce_calls, "stage_s": stage_s,
        "greedy_s": greedy_s, "extension_s": hist["extension_s"], "fom_s": hist["fom_s"],
        "max_estimates": hist["max_estimates"], "selected_mus": hist["selected_mus"],
        "held_out": held, "served": served, "n_valid": n_valid, "serve_s": serve_s,
        "serve_dev": serve_dev, "solver": stats, "profile": prof, "rom": rom,
        "reductor": red, "view": view, "fom": fom, "train": train, "test": test,
        "bounds": certificate,
    }


def run_sharded(mesh, device, log=print, grid: int = SHARDED_GRID, nt: int = SHARDED_NT,
                k: int = GREEDY_K, greedy_grid: int = GREEDY_GRID) -> dict:
    """The parabolic tier on this rank's DoF slab of ``mesh`` (axes ``("dof",
    "mu")``, the ranks started by ``parallel/launch.py``); every rank calls it.

    ``"steps"``: the first ``SHARDED_STEPS`` implicit-Euler steps of the
    thermal block at ``grid`` (dt = 1 / ``nt``, the demo's T = 1), in the
    device's working dtype, Jacobi-CG to ``SHARDED_TOL`` / ``SHARDED_MAXITER``
    on the slabs: each step's host seconds and CG iterations, the
    collectives by kind and their share of the steps' seconds
    (``parallel.mesh.COMM``, counted from 0 at the first step), the outputs
    at the stored steps (summed over ``"dof"``). ``"greedy"``: POD-greedy in
    float64 on the slabs at ``greedy_grid`` (T = 1, ``GREEDY_NT`` steps,
    Jacobi-CG ``GREEDY_TOL`` / ``SHARDED_MAXITER``), sketched by a
    ``ShardedSrhtEmbedding`` of ``k`` rows (the one-pass kernel on the
    rank's rows of each ``reduce()`` block, with their block offset),
    ``GREEDY_TRAINING`` parameters (seed 1, the demo's),
    ``GREEDY_EXTENSIONS``; the sweep split over ``"mu"``. ``srht_launches``
    counts the kernel's launches from 0 just before the greedy to just
    after it.

    Each rank then runs both on one device at the same settings and seeds
    and holds its rows against them (``diff_max`` / ``ref_max``, the
    selected parameters and max estimates, the basis rows up to each
    column's sign)."""
    from rla4mor_tpu_torch import models
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
    from rla4mor_tpu_torch.parallel import ShardedSrhtEmbedding
    from rla4mor_tpu_torch.parallel import mesh as pm
    from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device, sync

    device = resolve_device(device)
    dtype = default_dtype(device)
    out = {}

    # (a) the first implicit steps at full width
    st = models.StencilThermalBlock((2, 2), grid, dtype=dtype, device=device)
    steps, tol, maxiter = SHARDED_STEPS, SHARDED_TOL, SHARDED_MAXITER
    fom = models.InstationaryStencilFOM(st, T=steps / nt, nt=steps)
    mu = fom.parameter_space.sample_randomly(1, seed=5, device=device, dtype=dtype)[0]
    sl = fom.slab(mesh)
    pm.reset_comm()
    traj = fom.solve(mu, tol=tol, maxiter=maxiter, mesh=mesh)
    sync(device)
    rec = fom.solve_log[-1]
    comm = {"calls": dict(pm.COMM["calls"]), "seconds": pm.COMM["seconds"],
            "host_copies": pm.COMM["host_copies"]}
    a = {"grid": grid, "n": st.n_nodes ** 2, "rows": sl.slab.rows, "dtype": str(dtype),
         "steps": steps, "dt": fom.dt, "step_s": rec["step_s"], "iters": rec["iters"],
         "rel_res": rec["rel_res"], "comm": comm,
         "comm_share": comm["seconds"] / sum(rec["step_s"]),
         "outputs": [float(sl.output(traj[..., j])) for j in range(traj.shape[-1])]}
    log(f"{steps} implicit steps at grid {grid} ({a['n']:,} DoF, {sl.slab.rows} node rows a "
        f"rank, {dtype}): s/step {[round(x, 3) for x in rec['step_s']]}, CG iterations "
        f"{rec['iters']}, collectives {comm['calls']} ({comm['seconds']:.2f}s, share "
        f"{a['comm_share']:.2f})")
    one = models.InstationaryStencilFOM(st, T=steps / nt, nt=steps)
    ref = one.solve(mu, tol=tol, maxiter=maxiter)[sl.slab.r0:sl.slab.r1]
    a.update(diff_max=float((traj - ref).abs().max()), ref_max=float(ref.abs().max()),
             one_device_step_s=one.solve_log[-1]["step_s"],
             one_device_iters=one.solve_log[-1]["iters"])
    del ref
    out["steps"] = a
    del traj

    # (b) POD-greedy on the slabs, float64, the SRHT kernel at the rank's rows
    st64 = models.StencilThermalBlock((2, 2), greedy_grid, dtype=torch.float64,
                                      device=device)
    pfom = models.InstationaryStencilFOM(st64, T=1.0, nt=GREEDY_NT)
    view = pfom.as_reductor_fom(mesh=mesh, tol=GREEDY_TOL, maxiter=maxiter)
    emb = ShardedSrhtEmbedding(k, view.solution_dim, mesh, seed=0).to(device)
    red = models.InstationaryReductor(view, embedding=emb, log_level=30)
    train = view.parameter_space.sample_randomly(GREEDY_TRAINING, seed=1, device=device,
                                                 dtype=torch.float64)
    srht_cuda.srht_onepass.launches = 0
    t0 = time.perf_counter()
    rom, hist = models.pod_greedy(view, red, train, max_extensions=GREEDY_EXTENSIONS,
                                  log_level=30, mesh=mesh)
    sync(device)
    greedy_s = time.perf_counter() - t0
    launches = srht_cuda.srht_onepass.launches
    b = {"grid": greedy_grid, "n": view.solution_dim, "nt": GREEDY_NT, "k": k,
         "training": GREEDY_TRAINING, "extensions": GREEDY_EXTENSIONS, "greedy_s": greedy_s,
         "extension_s": hist["extension_s"], "fom_s": hist["fom_s"],
         "cg_iters": [log_["iters"] for log_ in pfom.solve_log],
         "reduce_calls": red.reduce_calls, "srht_launches": launches,
         "selected": [m["diffusion"].cpu() for m in hist["selected_mus"]],
         "max_estimates": hist["max_estimates"], "mass_r": rom.mass_r.cpu(),
         "lhs": rom.lhs.stack.cpu(), "row_offset": view.row_offset,
         "local_rows": view.local_dim}
    log(f"POD-greedy on the slabs at grid {greedy_grid} (float64, nt {GREEDY_NT}, k {k}): "
        f"s/extension {[round(x, 2) for x in hist['extension_s']]}, SRHT launches {launches} "
        f"for {red.reduce_calls} reduce() calls, max estimates {hist['max_estimates']}")
    view1 = pfom.as_reductor_fom(tol=GREEDY_TOL, maxiter=maxiter)
    signs, sampling = emb.plan
    red1 = models.InstationaryReductor(view1, embedding=SrhtEmbedding.from_plan(
        view1.solution_dim, k, signs.cpu(), sampling.cpu(), device=device,
        dtype=torch.float64), log_level=30)
    t0 = time.perf_counter()
    _, hist1 = models.pod_greedy(view1, red1, train, max_extensions=GREEDY_EXTENSIONS,
                                 log_level=30)
    rows = red1.rb[view.row_offset:view.row_offset + view.local_dim]
    sign = torch.sign((rows * red.rb).sum(dim=0))
    b.update(one_device_s=time.perf_counter() - t0,
             one_device_selected=[m["diffusion"].cpu() for m in hist1["selected_mus"]],
             one_device_max_estimates=hist1["max_estimates"],
             basis_diff=float((red.rb * sign - rows).abs().max()))
    out["greedy"] = b
    return out


def _sharded_rank(rank: int, ranks: int, kw: dict) -> dict:
    from rla4mor_tpu_torch.parallel import launch, make_mesh

    device = launch.rank_device()
    mesh = make_mesh(("dof", "mu"), (ranks, 1), device=device)
    return run_sharded(mesh, device, log=print if rank == 0 else (lambda line: None), **kw)


def anchor_coercivity(st, view, precond: str, log=print) -> dict:
    """The l2 coercivity anchor of the stencil operator at mu_ref = 1 (the
    estimator's metric: the reductor's embedding is an unweighted l2 one)
    by the matrix-free LOBPCG (the JAX demo's settings: two-stage, 200
    float64 iterations, absolute tol 1e-8; the safe side theta - rho of the
    enclosure), and ``MinThetaCoercivity`` on it. The inverse-iteration
    preconditioner is the V-cycle on A(1) when the trajectories run it, else
    the Jacobi-CG of the JAX demo (the same anchor:
    tests/test_torch_scm_matfree.py)."""
    from rla4mor_tpu_torch.mor import MinThetaCoercivity
    from rla4mor_tpu_torch.mor.scm_matfree import l2_interior_scm

    mu_ref = {"diffusion": torch.ones(st.n_terms, dtype=st.dtype, device=st.device)}
    t0 = time.perf_counter()
    scm = l2_interior_scm(st, mu_ref, two_stage=True, iters=200, tol=1e-8, cg_maxiter=1200,
                          precond_type="mg" if precond == "mg" else "cg")
    alpha_ref, _ = scm.alpha_exact(mu_ref)
    fit_s = time.perf_counter() - t0
    if not alpha_ref > 0:
        raise RuntimeError(f"l2 anchor {alpha_ref}: A(mu_ref) not certified coercive")
    diag = scm.anchor_diagnostics[0]
    log(f"l2 anchor lambda_min(A(1), I | interior) = {alpha_ref:.6e} ({fit_s:.1f}s, "
        f"matrix-free LOBPCG two-stage: rho {diag['radius']:.1e}, {diag['iterations']} "
        f"float64 iterations, stop {diag['stop']}, certified={scm.certified})")
    return {"alpha_ref": alpha_ref, "fit_s": fit_s, "certified": bool(scm.certified),
            "diagnostics": diag, "scm": scm,
            "coercivity": MinThetaCoercivity(view, mu_ref, alpha_ref=alpha_ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--grid", type=int, default=None,
                    help="elements an axis (default 1024 for thermal, 255 for thermal3d)")
    ap.add_argument("--precond", choices=["auto", "jacobi", "mg"], default="auto")
    ap.add_argument("--nt", type=int, default=50)
    ap.add_argument("--ext", type=int, default=5)
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--family", choices=FAMILIES, default="thermal")
    ap.add_argument("--sketch", choices=["streamed", "srht"], default="streamed",
                    help="the JAX demo's streamed Gaussian, or the one-pass SRHT kernel")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="the first N implicit steps of the held-out trajectory once "
                    "more under torch.profiler")
    ap.add_argument("--bounds", action="store_true",
                    help="the certified final-time bound at the held-out parameter "
                    "(the l2 anchor by the matrix-free SCM)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="run_sharded on this many ranks (a (ranks, 1) mesh; --grid "
                    "elements, 2 steps, then POD-greedy at --greedy-grid)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="with --ranks: gloo (the CPU, or ranks sharing one card) or nccl")
    ap.add_argument("--greedy-grid", type=int, default=GREEDY_GRID)
    args = ap.parse_args(argv)
    grid = args.grid if args.grid is not None else (255 if args.family == "thermal3d" else 1024)
    device = "cpu" if args.cpu else None
    if args.ranks:
        from rla4mor_tpu_torch.parallel.launch import spawn

        if args.backend is None:
            ap.error("--ranks needs --backend")
        kw = dict(grid=args.grid if args.grid is not None else SHARDED_GRID, nt=args.nt,
                  k=args.k, greedy_grid=args.greedy_grid)
        spawn(_sharded_rank, args.ranks, args.backend,
              device or ("cuda:0" if args.backend == "gloo" else "cuda"),
              args=(args.ranks, kw))
        print("done")
        return 0
    embedding = None
    if args.sketch == "srht":
        from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

        def embedding(n, k):
            return SrhtEmbedding(k, n, seed=0, device=device)
    run(grid=grid, nt=args.nt, ext=args.ext, k=args.k, family=args.family,
        precond=args.precond, embedding=embedding, device=device, bounds=args.bounds,
        profile_steps=args.profile_steps)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
