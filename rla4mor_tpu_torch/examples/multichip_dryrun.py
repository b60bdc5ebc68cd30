"""A sharded training step on a ("dof", "mu") mesh of ranks, end to end.

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``, at its
widths: with p ranks the mesh is (p / 2, 2) for an even p > 2, else (p, 1),
and the grid has N + 1 = 4 max(n_dof, 2) node rows. Each rank runs:

* the thermal block's sharded greedy step twice (Gaussian sketch, k = 32,
  r_max = 4, Jacobi-CG 1e-5 / 200), the error sweep's batch split over
  ``"mu"``;
* the ROM shipped from the state and served mu-sharded
  (``serve_batch_sharded``);
* one row-sharded LOBPCG anchor of A(1) (k = 1, block 2, 30 iterations, tol
  1e-3, R = I on the interior);
* the advection family's step: sharded BiCGStab, minres projection, the
  exact score (k = 16, r_max = 2, 1e-4 / 300);
* the time loops on the DoF slabs (T = 0.1, nt = 2): the parabolic 2-D,
  3-D (``StencilThermalBlock3D((2, 2, 2), N)``, z-plane slabs) and
  advection (BiCGStab) loops, the Newmark wave loop;
* the semilinear tier: 3 DoF-sharded Newton snapshots (reaction scale 10,
  1e-6), gathered and fitted replicated (POD-DEIM, Gaussian k = 24), the
  batched online stage split over ``"mu"``, the IMEX loop;
* POD-greedy on the mesh (``_dryrun_pod_greedy_2d``): the CG time loop on
  the slabs, the estimate sweep split over ``"mu"``, a sharded Gaussian
  sketch (k = 16), 2 extensions over 2 n_mu parameters. The JAX dryrun
  runs it on a mesh with a ``"mu"`` axis of more than one rank only; here
  it runs on every mesh.

Every finite and shape check of the JAX dryrun is made, and ``run`` checks
that the ranks agree.

    python -m rla4mor_tpu_torch.examples.multichip_dryrun --ranks 4 --cpu --backend gloo
    python -m rla4mor_tpu_torch.examples.multichip_dryrun --ranks 2 --device cuda:0 --backend gloo
    torchrun --nproc-per-node 4 -m rla4mor_tpu_torch.examples.multichip_dryrun --ranks 4 --device cuda --backend nccl

The backend is always named (``parallel/launch.py``): gloo on the CPU or for
ranks sharing one card, NCCL for a card a rank (``--device cuda``).
"""

from __future__ import annotations

import argparse
import math
import time

import torch


def mesh_shape(ranks: int) -> tuple[int, int]:
    """(dof, mu) of the JAX dryrun's mesh for ``ranks`` devices."""
    return (ranks // 2, 2) if ranks % 2 == 0 and ranks > 2 else (ranks, 1)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"multichip dryrun: {what}")


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t).all())


def dryrun(mesh, device, dtype=None, log=print) -> dict:
    """The dryrun's flows on ``mesh`` (axes ``("dof", "mu")``), this rank's
    part of them; returns the rank's readings (its state, estimates, served
    values, the anchor's eigenvalue)."""
    from rla4mor_tpu_torch.core import ParameterSpace, mu_stack
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.models.stencil_advection import StencilAdvectionDiffusion
    from rla4mor_tpu_torch.mor.scm_matfree import _flat_cols, lobpcg_gen
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom
    from rla4mor_tpu_torch.parallel import mesh as pm
    from rla4mor_tpu_torch.serve import serve_batch_sharded
    from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device

    device = resolve_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    n_dof, n_mu = pm.axis_size(mesh, "dof"), pm.axis_size(mesh, "mu")
    N = 4 * max(n_dof, 2) - 1
    out = {"mesh": pm.describe(mesh), "grid": N}
    t0 = time.perf_counter()

    fom = StencilThermalBlock((2, 2), N, dtype=dtype, device=device)
    state, step = make_sharded_greedy_step(fom, seed=0, k=32, r_max=4, cg_tol=1e-5,
                                           cg_maxiter=200, mesh=mesh)
    space = ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)
    batch = mu_stack(space.sample_randomly(2 * n_mu * 2, seed=2, device=device, dtype=dtype))
    for seed in (1, 3):  # a second step extends the state
        mu = space.sample_randomly(1, seed=seed, device=device, dtype=dtype)[0]
        state, est, u = step(state, mu, batch)
    _check(int(state.ncols) == 2, f"ncols {int(state.ncols)} after 2 steps")
    _check(_finite(est) and est.shape == (2 * n_mu * 2,), "thermal estimates")
    out.update(state={key: getattr(state, key).cpu() for key in ("srb", "res_lhs", "res_rhs",
                                                                  "out")},
               estimates=est.cpu(), u_local=u.cpu())

    rom = state_to_rom(fom, state)
    gmus = mu_stack(space.sample_randomly(4 * n_mu, seed=31, device=device, dtype=dtype))
    served = serve_batch_sharded(rom, gmus, mesh)
    for key, v in served.items():
        _check(_finite(v) and v.shape[0] == 4 * n_mu, f"served {key}")
    out["served"] = {key: v.cpu() for key, v in served.items()}

    # the certified-bounds offline stage on the mesh: one row-sharded anchor
    slab = fom.slab(mesh)
    mu_a = {"diffusion": torch.ones(4, dtype=dtype, device=device)}
    mask = slab.slab.mask(dtype, device).reshape(-1)
    eig = lobpcg_gen(_flat_cols(lambda g: slab.apply(mu_a, g), slab.local_shape),
                     lambda U: U, math.prod(fom.solution_shape), k=1, block=2, iters=30,
                     tol=1e-3, dtype=dtype, identity_R=True,
                     project=lambda U: U * mask.to(U.dtype)[:, None], mesh=mesh,
                     device=device)
    _check(math.isfinite(float(eig.values[0])), "LOBPCG anchor")
    out.update(anchor=float(eig.values[0]), anchor_radius=float(eig.radii[0]),
               anchor_iters=eig.iterations)

    # the non-SPD family: sharded BiCGStab, minres, the exact score
    afom = StencilAdvectionDiffusion(N, dtype=dtype, device=device)
    astate, astep = make_sharded_greedy_step(afom, seed=0, k=16, r_max=2, cg_tol=1e-4,
                                             cg_maxiter=300, projection="minres",
                                             score="exact", exact_dtype=dtype, mesh=mesh)
    amu = afom.sample_parameters(1, 4)[0]
    abatch = mu_stack(afom.sample_parameters(4, 5))
    astate, aest, _ = astep(astate, amu, abatch)
    _check(int(astate.ncols) == 1, f"advection ncols {int(astate.ncols)}")
    _check(_finite(aest), "advection estimates")
    out.update(advection_estimates=aest.cpu(), bicgstab_iters=astep.last_solve.iters)

    out["time_outputs"] = _time_loops(mesh, fom, mu, afom, amu, N, device, dtype)
    out["semilinear"] = _semilinear(mesh, N, device, dtype)
    out["pod_greedy"] = _pod_greedy_2d(mesh, fom, device, dtype)
    out["seconds"] = time.perf_counter() - t0
    log(f"[rank {pm.axis_index(mesh, 'dof')},{pm.axis_index(mesh, 'mu')}] {out['mesh']} grid "
        f"{N}: thermal ncols 2, median est {float(est.median()):.3e}; served "
        f"{4 * n_mu}; anchor {out['anchor']:.6e} (radius {out['anchor_radius']:.1e}); "
        f"advection bicgstab {out['bicgstab_iters']} iters; final outputs "
        + ", ".join(f"{k} {v:.4e}" for k, v in out["time_outputs"].items())
        + f"; pod-greedy max est {out['pod_greedy']['max_estimates']}; "
        f"{out['seconds']:.2f}s")
    return out


def _time_loops(mesh, fom, mu, afom, amu, N: int, device, dtype) -> dict:
    """The sharded time loops (T = 0.1, nt = 2); returns each one's output at
    the final step (summed over ``"dof"``: the same on every rank)."""
    from rla4mor_tpu_torch.models.instationary_stencil import InstationaryStencilFOM
    from rla4mor_tpu_torch.models.stencil3d import StencilThermalBlock3D
    from rla4mor_tpu_torch.models.wave_stencil import WaveStencilFOM

    fom3 = StencilThermalBlock3D((2, 2, 2), N, dtype=dtype, device=device)
    mu3 = fom3.sample_parameters(1, key=6)[0]
    runs = {
        "parabolic": (InstationaryStencilFOM(fom, T=0.1, nt=2), mu, 40),
        "parabolic3d": (InstationaryStencilFOM(fom3, T=0.1, nt=2), mu3, 40),
        "advection": (InstationaryStencilFOM(afom, T=0.1, nt=2), amu, 80),
        "wave": (WaveStencilFOM(fom, T=0.1, nt=2), mu, 60),
    }
    outputs = {}
    for name, (pfom, m, maxiter) in runs.items():
        traj = pfom.solve(m, tol=1e-4, maxiter=maxiter, mesh=mesh)
        sl = pfom.slab(mesh)
        _check(tuple(traj.shape) == (*sl.local_shape, 3) and _finite(traj),
               f"{name} trajectory {tuple(traj.shape)}")
        outputs[name] = float(sl.output(traj[..., -1]))
    return outputs


def _semilinear(mesh, N: int, device, dtype) -> dict:
    """DoF-sharded Newton snapshots, the replicated POD-DEIM fit on their
    gathered columns, the batched online stage split over ``"mu"``, the
    IMEX loop on the slabs."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models.semilinear import (
        SemilinearInstationaryFOM,
        SemilinearStencilFOM,
    )
    from rla4mor_tpu_torch.mor.semilinear_reductor import SemilinearReductor
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding
    from rla4mor_tpu_torch.parallel import mesh as pm

    slfom = SemilinearStencilFOM((2, 2), N, dtype=dtype, reaction_scale=10.0, device=device)
    slmus = slfom.sample_parameters(3, seed=14)
    group = pm.axis_group(mesh, "dof")
    # the fit on whole snapshots: each rank gathers the (small) columns
    snaps = torch.stack([
        pm.all_gather_rows(slfom.solve_newton(m, newton_tol=1e-6, cg_tol=1e-6,
                                              cg_maxiter=200, mesh=mesh), group).reshape(-1)
        for m in slmus], dim=1)
    _check(_finite(snaps), "semilinear snapshots")
    red = SemilinearReductor(slfom, embedding=GaussianEmbedding.make(
        slfom.n_dof, range_dim=24, seed=15, device=device, dtype=dtype))
    rom = red.fit(None, snapshots=snaps, pod_rtol=1e-8, deim_rtol=1e-8, n_reserve=1)
    batch = mu_stack(slfom.sample_parameters(4 * pm.axis_size(mesh, "mu"), seed=16))
    a, eta = rom.solve_and_estimate_batch(batch, mesh=mesh)
    _check(_finite(a) and _finite(eta) and eta.shape == (4 * pm.axis_size(mesh, "mu"),),
           "semilinear batched online stage")
    traj = SemilinearInstationaryFOM(slfom, T=0.1, nt=2).solve(slmus[0], tol=1e-5,
                                                               maxiter=60, mesh=mesh)
    _check(_finite(traj), "semilinear IMEX trajectory")
    return {"snapshots": snaps.cpu(), "a": a.cpu(), "eta": eta.cpu(),
            "imex_sum": float(slfom.linear.slab(mesh).slab.sum(traj[..., -1].sum()))}


def _pod_greedy_2d(mesh, fom, device, dtype) -> dict:
    """POD-greedy with the CG time loop on the DoF slabs and the estimate
    sweep split over ``"mu"`` (the JAX dryrun's ``_dryrun_pod_greedy_2d``)."""
    from rla4mor_tpu_torch.core import ParameterSpace
    from rla4mor_tpu_torch.models.instationary import InstationaryReductor, pod_greedy
    from rla4mor_tpu_torch.models.instationary_stencil import InstationaryStencilFOM
    from rla4mor_tpu_torch.parallel import ShardedGaussianEmbedding
    from rla4mor_tpu_torch.parallel import mesh as pm

    view = InstationaryStencilFOM(fom, T=0.1, nt=2).as_reductor_fom(mesh=mesh, tol=1e-5,
                                                                     maxiter=100)
    red = InstationaryReductor(view, embedding=ShardedGaussianEmbedding(
        16, view.solution_dim, mesh, seed=21), log_level=30)
    space = ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)
    mus = space.sample_randomly(2 * pm.axis_size(mesh, "mu"), seed=13, device=device,
                                dtype=dtype)
    _, hist = pod_greedy(view, red, mus, max_extensions=2, log_level=30, mesh=mesh)
    _check(red.basis_size >= 2 and all(e == e for e in hist["max_estimates"]),
           f"pod-greedy basis {red.basis_size}, estimates {hist['max_estimates']}")
    return {"selected": [m["diffusion"].cpu() for m in hist["selected_mus"]],
            "max_estimates": hist["max_estimates"]}


def _rank(rank: int, ranks: int, dtype) -> dict:
    from rla4mor_tpu_torch.parallel import launch, make_mesh

    device = launch.rank_device()
    mesh = make_mesh(("dof", "mu"), mesh_shape(ranks), device=device)
    return dryrun(mesh, device, dtype, log=print if rank == 0 else (lambda line: None))


def run(ranks: int, backend: str, device, dtype=None) -> dict:
    """The dryrun on ``ranks`` ranks of ``backend`` (``"gloo"`` or ``"nccl"``,
    named by the caller) on ``device``; returns ``{rank: readings}`` after
    checking that the ranks' replicated results agree."""
    from rla4mor_tpu_torch.parallel.launch import spawn

    if backend is None:
        raise ValueError("the dryrun needs its backend named: 'gloo' (CPU, or ranks "
                         "sharing one card) or 'nccl' (a card a rank)")
    res = spawn(_rank, ranks, backend, device, args=(ranks, dtype))
    first = res[min(res)]
    for r, other in res.items():
        for key in ("srb", "res_lhs", "res_rhs", "out"):
            _check(torch.equal(other["state"][key], first["state"][key]),
                   f"rank {r}'s state {key} differs from rank {min(res)}'s")
        _check(torch.equal(other["estimates"], first["estimates"]), f"rank {r}'s estimates")
        _check(other["anchor"] == first["anchor"], f"rank {r}'s anchor")
        _check(other["time_outputs"] == first["time_outputs"], f"rank {r}'s time loops")
        for key in ("snapshots", "a", "eta"):
            _check(torch.equal(other["semilinear"][key], first["semilinear"][key]),
                   f"rank {r}'s semilinear {key}")
        _check(other["semilinear"]["imex_sum"] == first["semilinear"]["imex_sum"],
               f"rank {r}'s IMEX trajectory")
        pg, pg0 = other["pod_greedy"], first["pod_greedy"]
        _check(pg["max_estimates"] == pg0["max_estimates"]
               and all(torch.equal(a, b) for a, b in zip(pg["selected"], pg0["selected"])),
               f"rank {r}'s POD-greedy")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU (float64)")
    ap.add_argument("--device", default=None,
                    help="cuda:0 (ranks share the card) or cuda (a card a rank)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], required=True,
                    help="gloo: the CPU, or ranks sharing one card; nccl: a card a rank")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else (args.device or "cuda:0")
    run(args.ranks, args.backend, device)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
