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
  (grid 255: 256^3 = 16.8M DoF), Jacobi-CG (the V-cycle is 2-D);
* ``nonaffine``: the Gaussian-bump conductivity (``gaussian_bump_fom(N)``),
  made affine by an offline EIM greedy over a 5^3 training grid (tol 1e-3,
  4 reserve points; ``--eim-grid G`` trains on a G-interval grid and
  rebuilds on the fine one, ``--eim-scan`` runs the greedy with the argmax
  indices on the device), device CG on the surrogate. It prints the EIM
  fit, and the kappa indicator and ellipticity margin over the batch
  (parameters at which the surrogate is not elliptic are screened out and
  listed: ``screen_elliptic``);
  ``--score exact`` adds the EIM model-error bound to each estimate.

* ``lossy``: ``StencilHelmholtzDamped(N)``, the complex damped family
  K + (-ksq + i gamma) M, a bounds-only flow (no greedy): the complex
  matrix-free inf-sup SCM fit and the Weyl auto-fit over 8 draws, then at
  each draw a BiCGStab solve (Jacobi; the V-cycle on K with ``--precond
  mg``) and its certified error bound ||A u - f||_2 / beta_LB.

``--bounds`` (``run(bounds=True)``) certifies the greedy's ROM after it is
served, by the matrix-free SCM of ``mor/scm_matfree.py`` at the same DoF
count (the JAX demo's settings: two-stage LOBPCG, 50 float32 and up to 400
float64 iterations, block 2, one restart at every eigensolve site): the
coercive families by ``l2_interior_scm`` (analytic term boxes, one anchor
at mu_ref, the V-cycle on A(mu_ref) as its preconditioner where the grid
allows), the Helmholtz family by ``MatrixFreeScmInfSup`` (analytic pair
boxes, the greedy fit over the batch, the Weyl bound fit to positivity and
its gap to the LP; beta_LB is the larger of the two certified bounds), the
non-affine family by the unit-stiffness enclosure of
a 1x1 block and ``EimStencilFOM.total_error_bound``. It prints the fit's
seconds, every eigensolve's iterations, stop and defenses, ``certified``,
the stability constant over the batch of 8 and the bounds (median, max).

Solves are preconditioned by Jacobi or the V-cycle (``--precond mg``, the
2-D families: on the thermal block's field, on the advection family's
diffusion part, on the Helmholtz family's K). The snapshot and its
residual terms are sketched by the Gaussian Omega or the SRHT (the one-pass
kernel), through the padded greedy step of ``parallel/driver.py``; then
``state_to_rom`` and one served batch padded to 256 requests.

    python -m rla4mor_tpu_torch.examples.large_scale_demo --precond mg --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_demo --family thermal3d --grid 255 --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_demo --family nonaffine --precond mg --sketch srht
    python -m rla4mor_tpu_torch.examples.large_scale_demo --family lossy --grid 127 --precond mg
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

from rla4mor_tpu_torch.utils.config import sync

# the JAX demo's families that need modules the port does not have yet
NOT_PORTED: dict = {}
FAMILIES = ("thermal", "advection", "helmholtz", "thermal3d", "nonaffine", "lossy",
            *NOT_PORTED)
# the JAX demo's EIM fit: a 5^3 tensor grid of training bumps, tol 1e-3
EIM_TRAIN_PER_DIM, EIM_TOL, EIM_RESERVE = 5, 1e-3, 4
# the JAX demo's matrix-free SCM settings (examples/large_scale_demo.py,
# --bounds and --family lossy): two-stage LOBPCG, 50 float32 and up to 400
# float64 iterations, block 2, one independent restart at every site. The
# coercive anchors converge to 1e-2 of |theta| (a 1% radius loosens a bound
# by 1%); the inf-sup anchors to 1e-3 of |theta|, with a plateau stop of 60
L2_SCM = dict(two_stage=True, iters=400, tol=1e-2, eig_relative_tol=True, block=2,
              f32_iters=50, box_tol=1e-5, cg_maxiter=1200, restarts=1)
INFSUP_SCM = dict(two_stage=True, iters=400, tol=1e-3, analytic_boxes=True, block=2,
                  f32_iters=50, plateau=60, cg_maxiter=400, restarts=1)
INFSUP_FIT_TOL, INFSUP_MAX_ANCHORS, WEYL_MAX_ANCHORS = 0.5, 6, 10
# check_one_device: solver iterations held against one device
SLAB_CHECK_ITERS = 100


def true_residual(fom, mu, u: torch.Tensor, group=None) -> float:
    """||A(mu) u - b|| / ||b||, recomputed in float64 (on a mesh: ``fom`` the
    rank's slab view, ``u`` its slab, the norms summed over ``group``)."""
    b = fom.rhs(dtype=torch.float64)
    r = fom.apply(mu, u.to(torch.float64)) - b
    if group is None:
        return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))
    from rla4mor_tpu_torch.parallel.mesh import all_reduce

    rr = all_reduce(torch.stack([torch.vdot(r.reshape(-1), r.reshape(-1)),
                                 torch.vdot(b.reshape(-1), b.reshape(-1))]), group)
    return math.sqrt(float(rr[0]) / float(rr[1]))


def screen_elliptic(fom, count: int, seed: int):
    """``count`` parameters of the EIM family's stream ``seed`` at which the
    surrogate is elliptic, and the (draw index, margin, surrogate minimum)
    of those screened out. The surrogate is held positive on its training
    set only; elsewhere a narrow bump between training points can leave it
    indefinite, and its solves and estimates describe another operator (CG
    on it breaks down). A draw is kept where both the ellipticity margin
    (the exact FOM's kappa_lower less the reserve-point indicator, an O(M)
    estimate of how far the surrogate may dip below the exact field) and
    the surrogate field's minimum over the elements are positive. Draw i of
    a stream does not depend on the count, so the kept draws are the
    stream's first elliptic ones."""
    from rla4mor_tpu_torch.core import mu_stack

    kept, screened, drawn = [], [], 0
    while len(kept) < count:
        more = 2 * (count - len(kept))
        mus = fom.sample_parameters(drawn + more, seed)[drawn:]
        batch = mu_stack(mus)
        margins = fom.ellipticity_margin(batch).tolist()
        minima = fom.kappa_min(batch).tolist()
        for i, (mu, margin, low) in enumerate(zip(mus, margins, minima)):
            if len(kept) == count:
                break
            if margin > 0 and low > 0:
                kept.append(mu)
            else:
                screened.append((drawn + i, margin, low))
        drawn += more
    return kept, screened


def make_fom(family: str, num_intervals: int, device, dtype=None, eim_grid=None,
             eim_scan: bool = False):
    """The demo's FOM of ``family`` at ``num_intervals`` elements an axis
    (``nonaffine``: the EIM surrogate, fit here; ``eim_grid`` its two-grid
    training grid, ``eim_scan`` the device greedy)."""
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
    if family == "nonaffine":
        exact = models.gaussian_bump_fom(num_intervals, dtype=dtype, device=device)
        train = exact.parameter_space.sample_uniformly(EIM_TRAIN_PER_DIM, device=exact.device,
                                                       dtype=exact.dtype)
        return models.EimStencilFOM.from_training(
            exact, train, tol=EIM_TOL, reserve=EIM_RESERVE, training_intervals=eim_grid,
            device_scan=eim_scan)
    raise ValueError(f"no FOM for family {family!r}")


def run(grid: int = 2047, steps: int = 4, k: int = 256, precond: str = "jacobi",
        sketch: str = "gaussian", score: str = "sketched", device=None, dtype=None,
        batch: int = 8, requests: int = 200, serve_size: int = 256, seed: int = 0,
        select: str = "random", family: str = "thermal", eim_grid=None,
        eim_scan: bool = False, bounds: bool = False, log=print, ranks: int = 1,
        backend=None, mesh=None, check_one_device: bool = False, also=None) -> dict:
    """Build the FOM, run ``steps`` greedy steps, ship the ROM and serve one
    padded batch; returns what was built and measured (``out["step_kw"]``:
    the step's settings, ``make_sharded_greedy_step(out["fom"], **step_kw)``).

    ``select``: how each step's parameter is chosen. ``"random"`` draws it
    (the JAX demo's choice: it times the step); ``"greedy"`` draws the
    first and then takes the batch candidate with the largest estimate of
    the step before among those not taken yet (the weak greedy; at most
    ``batch`` + 1 steps). ``precond="mg"`` applies to the 2-D
    families only; the 3-D one runs Jacobi (with a note). ``eim_grid`` /
    ``eim_scan``: the nonaffine family's EIM fit (``make_fom``); its
    readings are ``out["eim"]``, and its parameters are screened by their
    ellipticity margin (``screen_elliptic``). ``bounds``: certify the ROM
    after serving (:func:`certify`); its readings are ``out["bounds"]``.
    ``family="lossy"`` runs the bounds-only flow (:func:`run_lossy`) and
    returns its readings.

    ``ranks`` > 1 (or a named ``backend``): the run is DoF-sharded over that
    many ranks of a ``torch.distributed`` group of ``backend`` (``"gloo"``:
    the CPU, or ranks sharing ``device``, a card; ``"nccl"``: a card a rank,
    ``device="cuda"``), started by :func:`run_ranks`; it returns ``{rank:
    readings}`` (:func:`rank_summary`). As the JAX demo, n_dof is the
    largest power of two at most ``ranks``, the grid grows until the node
    rows split evenly, and a sharded solve is Jacobi-CG (the V-cycle runs on
    one device; a NOTE says so). ``mesh``: run as one rank of an existing
    ``("dof", "mu")`` mesh. ``check_one_device``: after the first step, hold
    the sharded sketch of the step's block against the one-device sketch of
    the gathered block (``out["sketch_check"]``; its kernel launches are not
    the path's), and the slab apply and a fixed number of solver iterations
    against the one-device ones (``out["slab_check"]``, :func:`slab_check`).
    ``also``: a dict of callables ``fn(mesh, device, log) -> dict`` by name
    (e.g. ``multichip_dryrun.dryrun``), run in each rank after the demo in
    its order, their readings under ``"also"`` by name."""
    if mesh is None and (ranks > 1 or backend is not None):
        return run_ranks(ranks, backend, device, also=also, grid=grid, steps=steps, k=k,
                         precond=precond, sketch=sketch, score=score, dtype=dtype,
                         batch=batch, requests=requests, serve_size=serve_size, seed=seed,
                         select=select, family=family, bounds=bounds,
                         check_one_device=check_one_device, log=log)
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

    from rla4mor_tpu_torch.parallel import mesh as pm

    device = resolve_device(device)
    n_dof = pm.axis_size(mesh, "dof")
    use_mg = precond == "mg" and family != "thermal3d" and n_dof == 1
    if precond == "mg" and not use_mg:
        log("NOTE: --precond mg ignored (multigrid needs a 2-D kappa-field family on "
            "one device); using jacobi: at >= 1e7 DoF expect slow CG snapshots")
    if mesh is not None and (bounds or family not in ("thermal", "advection")):
        raise NotImplementedError("on a mesh the demo runs the thermal and advection "
                                  "greedies without --bounds (ROADMAP.md)")
    N = grid
    if use_mg:  # multigrid needs power-of-two element counts
        while N & (N - 1):
            N += 1
    while (N + 1) % n_dof:  # the node rows split evenly over "dof"
        N += 1
    if family == "lossy":
        return run_lossy(N, device, dtype, batch=batch, precond="mg" if use_mg else "jacobi",
                         log=log)
    t0 = time.perf_counter()
    fom = make_fom(family, N, device, dtype, eim_grid=eim_grid, eim_scan=eim_scan)
    sync(device)
    eim = None
    if family == "nonaffine":
        # direct: sup_errors[n_terms] is the training sup error of the M active
        # terms; two-grid: the rebuild's history holds the selected snapshots'
        # fine residuals only (the certified history is the coarse greedy's)
        hist = fom.interpolant.sup_errors
        eim = {"terms": fom.n_terms, "reserve": fom.interpolant.n_reserve,
               "sup_err": hist[min(fom.n_terms, len(hist) - 1)],
               "label": ("training sup err" if eim_grid is None
                         else "selected-snapshot fine residual"),
               "kappa_floor": fom.kappa_floor, "fit_s": time.perf_counter() - t0,
               **{f"{part}_s": s for part, s in fom.fit_s.items()}}
        log(f"EIM offline: {eim['terms']} terms / magic points (+{eim['reserve']} reserve) "
            f"in {eim['fit_s']:.2f}s (fields {eim['fields_s']:.2f}s, greedy "
            f"{eim['greedy_s']:.2f}s) ({eim['label']} {eim['sup_err']:.2e}, kappa floor "
            f"{eim['kappa_floor']:.4f})")
    n = math.prod(fom.solution_shape)
    projection = "galerkin" if fom.is_spd else "minres"
    solver = "cg" if fom.is_spd else "bicgstab"
    cg_maxiter = 300 if use_mg else 6000
    dims = "x".join(str(d) for d in fom.solution_shape)
    where = f"device={device}" if mesh is None else (
        f"device={device} mesh {pm.describe(mesh)} ({torch.distributed.get_backend()})")
    log(f"{where} {family} grid {dims}, n = {n} DoF, sketch {sketch} k = {k}, "
        f"precond {'mg' if use_mg else 'jacobi'} ({solver}), {projection}, "
        f"score {score}, {fom.dtype}")

    t0 = time.perf_counter()
    step_kw = dict(
        seed=seed, k=k, r_max=steps, cg_tol=1e-7, cg_maxiter=cg_maxiter,
        cg_precond="mg" if use_mg else "jacobi", sketch=sketch, score=score,
        projection=projection,
        # nonaffine with the exact score: each estimate adds the candidate's
        # EIM model-error bound (the RB residual is against the surrogate)
        model_error=(fom.model_error_bound if family == "nonaffine" and score == "exact"
                     else None), mesh=mesh)
    state, step = make_sharded_greedy_step(fom, **step_kw)
    sync(device)
    setup_s = time.perf_counter() - t0
    # the FOM the step runs: on a mesh, the rank's slab view (its rows)
    sfom = step.fom
    group = None if mesh is None else sfom.group
    if family == "thermal":
        space = ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)

        def sample(count, seed):
            return space.sample_randomly(count, seed=seed, device=device)
    elif family == "nonaffine":
        eim["screened"] = []

        def sample(count, seed):
            mus, screened = screen_elliptic(fom, count, seed)
            eim["screened"] += [(seed, *row) for row in screened]
            return mus
    else:
        sample = fom.sample_parameters
    mu_batch = mu_stack(sample(batch, 1))
    drawn = [sample(1, 10 + it)[0] for it in range(steps)]

    if eim is not None:
        # the sketched estimates measure the RB error against the surrogate;
        # the kappa indicator estimates the EIM model error over the batch
        eim["kappa_indicator_max"] = float(fom.kappa_error_indicator(mu_batch).max())
        eim["margin_min"] = float(fom.ellipticity_margin(mu_batch).min())
        eim["kappa_min"] = float(fom.kappa_min(mu_batch).min())
        log(f"EIM kappa indicator over the mu batch: max {eim['kappa_indicator_max']:.2e} "
            f"(ellipticity margin min {eim['margin_min']:.3f}, surrogate min "
            f"{eim['kappa_min']:.3f}; draws screened out, (seed, draw, margin, surrogate "
            f"min): {eim['screened']})")
    out = {"fom": fom, "family": family, "n": n, "grid": N, "sample": sample, "eim": eim,
           "mu_batch": mu_batch, "projection": projection, "cg_maxiter": cg_maxiter,
           "mus": [], "setup_s": setup_s, "step_s": [], "cg_iters": [],
           "rec_res": [], "true_res": [], "median_est": [], "estimates": [],
           "snapshots": [], "step": step, "step_kw": step_kw, "mesh": mesh, "comm_s": []}
    rhs = sfom.rhs()
    bnorm = float(torch.linalg.vector_norm(rhs)) if group is None else math.sqrt(
        float(pm.all_reduce(torch.vdot(rhs.reshape(-1), rhs.reshape(-1)), group)))
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
        comm0 = pm.COMM["seconds"]
        t0 = time.perf_counter()
        state, est, u = step(state, mu, mu_batch)
        est = est.cpu()  # the transfer waits for the step
        dt = time.perf_counter() - t0
        solve = step.last_solve
        out["step_s"].append(dt)
        out["comm_s"].append(pm.COMM["seconds"] - comm0)
        out["cg_iters"].append(solve.iters)
        out["rec_res"].append(float(solve.residual_norm) / bnorm)
        out["true_res"].append(true_residual(sfom, mu, u, group))
        if check_one_device and it == 0 and mesh is not None:
            out["sketch_check"] = sketch_check(step, sfom, seed, k, sketch)
            out["slab_check"] = slab_check(fom, sfom, mu, seed, SLAB_CHECK_ITERS)
        out["median_est"].append(float(est.median()))
        out["estimates"].append(est)
        out["snapshots"].append(u)
        log(f"it {it}: step {dt:.4f}s {solver}_iters={solve.iters} "
            f"rec_res={out['rec_res'][-1]:.3e} true_res={out['true_res'][-1]:.3e} "
            f"basis={int(state.ncols)} median est {out['median_est'][-1]:.3e} "
            f"max {float(est.max()):.3e}")
    out["state"] = state

    t0 = time.perf_counter()
    rom = state_to_rom(fom, state, projection=projection)
    pool = mu_stack(sample(requests, 2))
    padded, valid = pad_batch(pool, serve_size)
    if mesh is not None:
        from rla4mor_tpu_torch.serve import serve_batch_sharded

        def serve_batch(rom, mus):  # noqa: F811 - the request batch split over "mu"
            return serve_batch_sharded(rom, mus, mesh)
    serve_batch(rom, padded)  # warm-up
    sync(device)
    rom_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = serve_batch(rom, padded)
    sync(device)
    serve_s = time.perf_counter() - t0
    served = {key: v[:valid] for key, v in served.items()}
    out.update(rom=rom, rom_s=rom_s, served=served, requests=valid, serve_s=serve_s,
               requests_per_s=valid / serve_s)
    log(f"rom r={int(state.ncols)} built in {rom_s:.4f}s; served {valid} requests "
        f"(padded to {serve_size}) in {serve_s:.6f}s ({valid / serve_s:.0f}/s)")
    if bounds:
        out["bounds"] = certify(out, use_mg, log)
    return out


def sketch_check(step, sfom, seed: int, k: int, sketch: str) -> dict:
    """The step's last sharded sketch against the one-device sketch of its
    whole (1 + T, n) block, gathered from the ranks: max |difference| over
    max |one-device sketch|, and the kernel launches the check made."""
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.parallel import mesh as pm
    from rla4mor_tpu_torch.parallel.sharded_sketch import gaussian_sketch_sharded

    launches = srht_cuda.srht_onepass.launches
    block = pm.all_gather_rows(step.last_block, sfom.group, dim=1)  # (1 + T, n)
    emb = step.embedding
    one = (gaussian_sketch_sharded(seed, k, block.T) if emb is None
           else emb.apply_blocked(block.T))
    err = float((step.last_sketch - one).abs().max() / one.abs().max())
    return {"rel_err": err, "launches": srht_cuda.srht_onepass.launches - launches}


def slab_check(fom, sfom, mu, seed: int, iters: int) -> dict:
    """The rank's slab apply of a seeded random grid, and ``iters`` Jacobi
    preconditioned solver iterations from zero on the slabs (no stopping
    test: CG, or BiCGStab for a non-SPD family), against the apply and the
    same iterations on the whole grid (each rank runs both): max
    |difference| over max |one device| on the rank's rows."""
    from rla4mor_tpu_torch.core.solvers import bicgstab, cg
    from rla4mor_tpu_torch.models.stencil import preconditioner

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    gen = torch.Generator(device=fom.device).manual_seed(seed)
    g = torch.randn(fom.solution_shape, generator=gen, dtype=fom.dtype, device=fom.device)
    local = sfom.slab.local
    apply_err = rel(sfom.apply(mu, local(g)), local(fom.apply(mu, g)))
    solver = cg if getattr(fom, "is_spd", True) else bicgstab
    one = solver(lambda v: fom.apply(mu, v), fom.rhs(),
                 precond=preconditioner(fom, mu, "jacobi"), tol=0.0, maxiter=iters)
    sharded = solver(lambda v: sfom.apply(mu, v), sfom.rhs(),
                     precond=preconditioner(sfom, mu, "jacobi"), tol=0.0, maxiter=iters,
                     group=sfom.group)
    return {"apply_rel_err": apply_err, "solve_rel_err": rel(sharded.x, local(one.x)),
            "iters": (one.iters, sharded.iters)}


def rank_summary(res: dict) -> dict:
    """The readings of one rank's run as plain values and CPU tensors."""
    state = res["state"]
    keep = ("family", "n", "grid", "projection", "cg_maxiter", "setup_s", "step_s",
            "comm_s", "cg_iters", "rec_res", "true_res", "median_est", "rom_s", "requests",
            "serve_s", "requests_per_s", "sketch_check", "slab_check", "srht_launches", "comm",
            "also")
    out = {key: res[key] for key in keep if key in res}
    out["estimates"] = [e.cpu() for e in res["estimates"]]
    out["state"] = {key: getattr(state, key).cpu() for key in ("srb", "res_lhs", "res_rhs",
                                                                "ncols", "out")}
    out["served"] = {key: v.cpu() for key, v in res["served"].items()}
    out["mus"] = [{key: v.cpu() for key, v in mu.items()} for mu in res["mus"]]
    return out


def _demo_rank(rank: int, n_dof: int, kw: dict, also) -> dict:
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.parallel import launch, make_mesh
    from rla4mor_tpu_torch.parallel import mesh as pm

    device = launch.rank_device()
    mesh = make_mesh(("dof", "mu"), (n_dof, 1), device=device)
    log = kw.pop("log", print)
    if rank:
        def log(line):  # one rank speaks
            return None
    srht_cuda.srht_onepass.launches = 0
    pm.reset_comm()
    res = run(**kw, device=device, mesh=mesh, log=log)
    check = res.get("sketch_check", {}).get("launches", 0)
    res["srht_launches"] = srht_cuda.srht_onepass.launches - check
    res["comm"] = {"calls": dict(pm.COMM["calls"]), "seconds": pm.COMM["seconds"],
                   "host_copies": pm.COMM["host_copies"]}
    out = rank_summary(res)
    if also is not None:
        out["also"] = {name: fn(mesh, device, log=log) for name, fn in also.items()}
    return out


def run_ranks(ranks: int, backend, device, also=None, log=print, **kw) -> dict:
    """:func:`run` DoF-sharded over the largest power of two n_dof <= ``ranks``
    ranks (a ``("dof", "mu")`` mesh of shape (n_dof, 1)) of a ``backend``
    group on ``device``; ``{rank: rank_summary}``."""
    from rla4mor_tpu_torch.parallel.launch import spawn

    if backend is None:
        raise ValueError("a sharded run needs its backend named: 'gloo' (CPU, or ranks "
                         "sharing one card) or 'nccl' (a card a rank)")
    n_dof = 1
    while n_dof * 2 <= ranks:
        n_dof *= 2
    if n_dof < ranks:
        log(f"NOTE: {ranks} ranks: the dof axis takes {n_dof} (a power of two)")
    if device is None:
        device = "cuda:0" if backend == "gloo" else "cuda"
    return spawn(_demo_rank, n_dof, backend, device, args=(n_dof, dict(kw, log=log), also))


def run_stages(d: dict) -> str:
    """A site's runs as 'iterations/stop' per stage (float32 warm start,
    float64 polish), runs separated by '|'."""
    runs = d["runs"] or ({"stages": d["stages"]},)
    return "|".join(",".join(f"{it}/{stop}" for _, it, stop in run["stages"])
                    for run in runs)


def defenses(diags) -> str:
    """One line of the eigensolves' readings: value, radius, each run's
    iterations and stop by stage, gap margin, restart disagreement, radius /
    |theta| and verdict."""
    return "; ".join(
        f"theta={d['theta']:.4e} rho={d['radius']:.1e} runs={run_stages(d)} "
        f"gap={d['gap_margin']:.1e} restart_dis={d['restart_disagreement']:.1e} "
        f"rho/theta={d['restart_radius_ratio']:.1e} cert={d['certified']}" for d in diags)


def _mu_ref(fom, family: str) -> dict:
    """The coercive families' anchor: eps = 1 without advection, or every
    diffusion coefficient 1."""
    kw = dict(dtype=fom.dtype, device=fom.device)
    if family == "advection":
        return {"eps": torch.ones(1, **kw), "velocity": torch.zeros(2, **kw)}
    return {"diffusion": torch.ones(fom.n_terms, **kw)}


def certify(res: dict, use_mg: bool, log=print) -> dict:
    """Certified l2 state-error bounds of ``run``'s ROM over its batch of
    candidates: the last step's sketched estimates over the matrix-free SCM's
    stability constant (rigorous up to the sketch's distortion). Returns the
    fit's seconds, ``certified``, the sites' diagnostics, the constants and
    the bounds, and the SCM itself (``"scm"``)."""
    import numpy as np

    from rla4mor_tpu_torch.core import mu_unstack
    from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmInfSup, l2_interior_scm

    fom, family = res["fom"], res["family"]
    mus = mu_unstack(res["mu_batch"])  # the batch's own draw
    est = res["estimates"][-1].to(torch.float64).numpy()
    out = {"family": family}
    t0 = time.perf_counter()
    if family == "helmholtz":
        scm = MatrixFreeScmInfSup(fom, **INFSUP_SCM)
        hist = scm.fit(mus, tol=INFSUP_FIT_TOL, max_anchors=INFSUP_MAX_ANCHORS)
        out["fit_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out.update(_weyl_fit(scm, mus, t1, log), fit_history=hist, const="beta_LB",
                   kind="inf-sup")
        desc = f"{len(scm.box)} pair boxes + {len(scm.scm.anchor_mus)} anchors, inf-sup"
    elif family == "nonaffine":
        return _certify_nonaffine(res, est, mus, log)
    else:
        mu_ref = _mu_ref(fom, family)
        scm = l2_interior_scm(fom, mu_ref, precond_type="mg" if use_mg else "cg", **L2_SCM)
        scm.add_anchor(mu_ref)
        out.update(fit_s=time.perf_counter() - t0, const="alpha_LB", kind="coercivity")
        desc = f"{len(scm.box)} term boxes + 1 anchor, coercivity"
    radii = ", ".join(f"{lo:.0e}/{hi:.0e}" for lo, hi in scm.box_radii)
    log(f"matrix-free SCM offline fit ({desc}, l2 metric): {out['fit_s']:.1f}s  "
        f"enclosure radii [{radii}]")
    log(f"LOBPCG defenses: certified={scm.certified}  anchors: "
        f"{defenses(scm.anchor_diagnostics)}")
    lbs = np.array([float(scm.lower(m)) for m in mus])
    if "weyl_values" in out:  # two certified lower bounds: the larger holds
        out["lp_lower"] = lbs
        lbs = np.maximum(lbs, out["weyl_values"])
    with np.errstate(divide="ignore"):
        bound = np.where(lbs > 0, est / np.where(lbs > 0, lbs, 1.0), np.inf)
    log(f"certified l2 state-error bounds over the mu batch (rigorous up to sketch "
        f"distortion): median {np.median(bound):.3e}  max {bound.max():.3e}  "
        f"({out['const']} in [{lbs.min():.3e}, {lbs.max():.3e}])")
    out.update(scm=scm, certified=bool(scm.certified),
               diagnostics=list(scm.anchor_diagnostics), box=list(scm.box),
               lower=lbs, estimates=est, bounds=bound, median=float(np.median(bound)),
               max=float(bound.max()))
    return out


def _weyl_fit(scm, mus, t0: float, log) -> dict:
    """``fit_weyl_positive`` over ``mus`` (at most ``WEYL_MAX_ANCHORS``) and
    the Weyl bound's readings there: the bound per mu (``weyl_values``, the
    clamped one of ``weyl_bound``), its minimum and its gap to the LP. The
    flows take beta_LB = max(LP, Weyl) at each mu: both are certified lower
    bounds of beta, and with analytic boxes the LP can fall to 0 between
    anchors where the Weyl bound stays positive."""
    import numpy as np

    weyl = scm.fit_weyl_positive(mus, max_anchors=WEYL_MAX_ANCHORS)
    rep = scm.weyl_gap_report(mus)
    values = np.maximum(rep["weyl"], 0.0)
    out = dict(weyl_fit_s=time.perf_counter() - t0, weyl=weyl, weyl_min=float(values.min()),
               weyl_values=values, weyl_max_rel_gap=rep["max_rel_gap"],
               lp_nonpositive=int((rep["lp"] <= 0).sum()))
    log(f"weyl auto-fit: positive={weyl['positive']} (anchors {weyl['n_anchors']}, "
        f"flagged={weyl['flagged']}) in {out['weyl_fit_s']:.1f}s; min over the batch "
        f"{out['weyl_min']:.3e}; weyl-vs-LP max rel gap {rep['max_rel_gap']:.2f}; LP "
        f"nonpositive at {out['lp_nonpositive']} of {len(values)}")
    return out


def _certify_nonaffine(res: dict, est, mus, log) -> dict:
    """The total bound against the exact bump operator: the surrogate
    residual and the EIM model term over the exact family's l2 coercivity
    kappa_lower lambda_min(K_1), with lambda_min(K_1) enclosed by the l2 SCM
    of a 1x1 thermal block (its one term is the unit stiffness K_1)."""
    import numpy as np

    from rla4mor_tpu_torch.core.solvers import lstsq_dense
    from rla4mor_tpu_torch.models import StencilThermalBlock
    from rla4mor_tpu_torch.mor.scm_matfree import l2_interior_scm

    fom, state, rom = res["fom"], res["state"], res["rom"]
    N = res["grid"]
    t0 = time.perf_counter()
    unit = StencilThermalBlock((1, 1), N, dtype=fom.dtype, device=fom.device)
    mu1 = {"diffusion": torch.ones(1, dtype=fom.dtype, device=fom.device)}
    uscm = l2_interior_scm(unit, mu1, precond_type="mg" if N & (N - 1) == 0 else "cg",
                           **L2_SCM)
    uscm.add_anchor(mu1)
    lam = (uscm.lower(mu1), uscm.box[0][1])
    fit_s = time.perf_counter() - t0
    log(f"unit-stiffness enclosure: lam in [{lam[0]:.4e}, {lam[1]:.4e}] ({fit_s:.1f}s, "
        f"certified={uscm.certified}; {defenses(uscm.anchor_diagnostics)})")
    # the basis: the snapshots in the combination the state's sketched
    # Gram-Schmidt made of them, recovered from their sketch
    r = int(state.ncols)
    snaps = torch.stack(res["snapshots"]).reshape(len(res["snapshots"]), -1).T
    comb = lstsq_dense(res["step"].sketch(snaps).to(torch.float64),
                       state.srb[:, :r].to(torch.float64))
    basis = snaps.to(torch.float64) @ comb                      # (n, r)
    bounds = []
    for mu in mus:
        y = rom.solve(mu)
        u_r = (basis @ y.to(torch.float64)).reshape(fom.solution_shape).to(fom.dtype)
        bounds.append(float(fom.total_error_bound(mu, u_r, rom.estimate_error(mu, y), lam)))
    bounds = np.array(bounds)
    log("TOTAL certified bounds vs the EXACT non-affine operator (surrogate residual + EIM "
        "model term, rigorous up to sketch distortion + the reserve-point indicator): "
        f"median {np.median(bounds):.3e}  max {bounds.max():.3e}")
    return {"family": "nonaffine", "kind": "unit stiffness", "scm": uscm,
            "fit_s": fit_s, "certified": bool(uscm.certified), "lam": lam,
            "diagnostics": list(uscm.anchor_diagnostics), "box": list(uscm.box),
            "bounds": bounds, "median": float(np.median(bounds)),
            "max": float(bounds.max())}


def run_lossy(grid: int = 255, device=None, dtype=None, batch: int = 8,
              precond: str = "jacobi", log=print) -> dict:
    """The bounds-only flow of the damped complex family: the complex
    matrix-free inf-sup SCM fit over ``batch`` draws (seed 1) and the Weyl
    auto-fit (:func:`_weyl_fit`), then at each draw a BiCGStab solve (tol
    1e-6, ``precond`` 'jacobi' as the JAX demo, or 'mg', the V-cycle on K)
    and its certified l2 error bound ||A u - f||_2 / beta_LB, the residual in
    complex128 (valid for any approximate solve: no reduced basis needed)."""
    import numpy as np

    from rla4mor_tpu_torch import models
    from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmInfSup
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device(device)
    fom = models.StencilHelmholtzDamped(grid, dtype=dtype, device=device)
    n = math.prod(fom.solution_shape)
    log(f"device={device} lossy grid {grid + 1}x{grid + 1}, n = {n} DoF, {fom.complex_dtype}, "
        f"{precond}-BiCGStab")
    mus = fom.sample_parameters(batch, 1)
    t0 = time.perf_counter()
    scm = MatrixFreeScmInfSup(fom, **INFSUP_SCM)
    hist = scm.fit(mus, tol=INFSUP_FIT_TOL, max_anchors=INFSUP_MAX_ANCHORS)
    fit_s = time.perf_counter() - t0
    weyl = _weyl_fit(scm, mus, time.perf_counter(), log)
    log(f"complex inf-sup SCM offline fit: {fit_s:.1f}s ({len(scm.box)} pair boxes, "
        f"{len(scm.scm.anchor_mus)} anchors, certified={scm.certified})")
    log(f"LOBPCG defenses: {defenses(scm.anchor_diagnostics)}")
    f = fom.rhs(dtype=torch.float64).to(torch.complex128)
    rows = []
    for i, mu in enumerate(mus):
        t0 = time.perf_counter()
        solve = fom.solve_bicgstab_result(mu, tol=1e-6, maxiter=4000, precond=precond)
        resid = float(torch.linalg.vector_norm(
            fom.apply(mu, solve.x.to(torch.complex128)) - f))
        lb = max(float(scm.lower(mu)), float(weyl["weyl_values"][i]))
        rows.append({"lower": lb, "residual": resid, "iters": solve.iters,
                     "bound": resid / lb if lb > 0 else float("inf"),
                     "solve_s": time.perf_counter() - t0})
    bnds = np.array([row["bound"] for row in rows])
    lbs = np.array([row["lower"] for row in rows])
    log(f"BiCGStab solves: iterations {[row['iters'] for row in rows]}, residuals "
        f"{min(row['residual'] for row in rows):.3e}-{max(row['residual'] for row in rows):.3e}")
    log("certified l2 solve-error bounds over the mu batch (||A u - f||_2 / beta_LB, "
        f"rigorous): median {np.median(bnds):.3e}  max {bnds.max():.3e}  (beta_LB in "
        f"[{lbs.min():.3e}, {lbs.max():.3e}])")
    return {"fom": fom, "family": "lossy", "n": n, "grid": grid, "mus": mus, "scm": scm,
            "fit_s": fit_s, "fit_history": hist, "certified": bool(scm.certified), **weyl,
            "diagnostics": list(scm.anchor_diagnostics), "box": list(scm.box),
            "rows": rows, "lower": lbs, "bounds": bnds,
            "median": float(np.median(bnds)), "max": float(bnds.max())}


def profile_step(step, state, mu, mu_batch, top: int = 8) -> dict:
    """One more step under ``torch.profiler`` (:func:`profile_call`)."""
    return profile_call(lambda: step(state, mu, mu_batch)[1].cpu(), state.srb.device, top)


def profile_call(fn, device, top: int = 8) -> dict:
    """``fn()`` once under ``torch.profiler``: its wall time, the device's
    busy time (the union of its kernels, copies and sets), its idle share
    over the call, and the ``top`` operators by the device time of the
    kernels each launched. Without device events (the CPU) busy time and
    idle share are None and ``top`` ranks operators by host self time."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall_s = time.perf_counter() - t0
    del out
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
                    "Jacobi-CG; nonaffine: Gaussian-bump conductivity made affine by "
                    "an offline EIM greedy; lossy: the complex damped family's "
                    "bounds-only flow")
    ap.add_argument("--eim-grid", type=int, default=None,
                    help="nonaffine: two-grid EIM, the greedy on this interval count "
                    "and the selected snapshots rebuilt on the fine grid")
    ap.add_argument("--eim-scan", action="store_true",
                    help="nonaffine: the EIM greedy with its argmax indices on the "
                    "device, one host read a chunk")
    ap.add_argument("--bounds", action="store_true",
                    help="after serving: certified l2 error bounds of the ROM by the "
                    "matrix-free SCM (mor/scm_matfree.py)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more step and print its top device operations")
    ap.add_argument("--ranks", type=int, default=1,
                    help="DoF-shard the greedy over this many ranks (Jacobi-CG; thermal "
                    "and advection); also under torchrun")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="the ranks' backend, named with --ranks > 1: gloo (the CPU with "
                    "--cpu, or all ranks on one card) or nccl (a card a rank)")
    ap.add_argument("--device", default=None,
                    help="cuda:0 (ranks share it; gloo) or cuda (a card a rank; nccl)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device
    backend = args.backend
    if args.ranks > 1 and backend is None:
        ap.error("--ranks > 1 needs --backend gloo or nccl")
    res = run(args.grid, args.steps, args.k, args.precond, args.sketch, args.score,
              device=device, select=args.select, family=args.family,
              eim_grid=args.eim_grid, eim_scan=args.eim_scan, bounds=args.bounds,
              ranks=args.ranks, backend=backend)
    if backend is not None:
        print("done")
        return 0
    if args.profile and args.family != "lossy":
        prof = profile_step(res["step"], res["state"], res["mus"][-1], res["mu_batch"])
        print(f"profiled step {prof['wall_s']:.4f}s, device busy {prof['busy_s']}s, "
              f"idle share {prof['idle_share']}")
        for row in prof["top"]:
            print(f"  {row['ms']:10.4f} ms {row['calls']:6d}x {row['name']}")
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
