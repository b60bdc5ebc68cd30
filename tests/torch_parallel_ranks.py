"""The rank side of ``tests/test_torch_parallel.py``: every sharded case of
the port, run by each of 4 gloo ranks on the CPU in float64, returning CPU
tensors. It imports no JAX (the ranks are fresh processes that import this
module); the test holds the results against the JAX package and the port's
one-device paths."""

import numpy as np
import torch

GRID = 7           # node rows 8: 2 a rank on ("dof", 4), 4 on ("dof", 2)
K, R_MAX, STEPS = 32, 4, 2
LOBPCG_TOL = 1e-7  # 9 iterations on the test's pencil, each a dozen collectives
DT = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a))


def sketches(mesh, inp: dict) -> dict:
    from rla4mor_tpu_torch.parallel import flat_shard_rows
    from rla4mor_tpu_torch.parallel import mesh as pm
    from rla4mor_tpu_torch.parallel.embeddings import (
        ShardedGaussianEmbedding,
        ShardedSrhtEmbedding,
    )

    rank = pm.axis_index(mesh, "dof")
    out = {}
    x = _t(inp["gauss_x"])
    n = x.shape[0]
    emb = ShardedGaussianEmbedding(inp["gauss_k"], n, mesh, seed=5)
    nl = emb.n_local
    out["gauss"] = emb.apply(x[rank * nl:(rank + 1) * nl])
    out["gauss_single"] = emb.apply(x[rank * nl:(rank + 1) * nl, 0])
    out["gauss_adjoint"] = emb.apply_adjoint(_t(inp["gauss_v"]))
    for n, (x, signs, sampling) in inp["srht"].items():
        x = _t(x)
        n_phys, _ = flat_shard_rows(n, mesh)
        xp = torch.cat([x, x.new_zeros(n_phys - n, x.shape[1])])
        nl = n_phys // pm.axis_size(mesh, "dof")
        for variant in ("flat", "butterfly"):
            e = ShardedSrhtEmbedding.from_plan(signs, sampling, mesh, variant=variant)
            out[f"srht_{variant}_{n}"] = e.apply(xp[rank * nl:(rank + 1) * nl])
    out["flat_shard_rows"] = {m: flat_shard_rows(m, mesh) for m in inp["layout_ns"]}
    return out


def solves(mesh, inp: dict) -> dict:
    from rla4mor_tpu_torch.core.solvers import bicgstab, cg
    from rla4mor_tpu_torch.examples.large_scale_demo import slab_check
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.models.stencil_advection import StencilAdvectionDiffusion

    g = _t(inp["grid"])
    out = {}
    for name, fom, mu in (
            ("thermal", StencilThermalBlock((2, 2), GRID, dtype=DT, device="cpu"),
             {"diffusion": _t(inp["mu_thermal"])}),
            ("advection", StencilAdvectionDiffusion(GRID, dtype=DT, device="cpu"),
             {"eps": _t(inp["eps"]), "velocity": _t(inp["velocity"])})):
        s = fom.slab(mesh)
        loc = s.slab.local(g)
        out[f"apply_{name}"] = s.apply(mu, loc)
        out[f"terms_{name}"] = s.apply_terms(loc)
        out[f"diag_{name}"] = s.jacobi_diag(mu)
        out[f"output_{name}"] = s.output(loc)
        solver = cg if fom.is_spd else bicgstab
        diag = s.jacobi_diag(mu)
        res = solver(lambda v: s.apply(mu, v), s.rhs(), precond=lambda r: r / diag,
                     tol=1e-10, maxiter=400, group=s.group)
        out[f"solve_{name}"] = (res.x, res.iters)
        out[f"slab_check_{name}"] = slab_check(fom, s, mu, seed=0, iters=5)
    return out


def greedy(mesh, inp: dict) -> dict:
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom
    from rla4mor_tpu_torch.parallel.embeddings import ShardedSrhtEmbedding
    from rla4mor_tpu_torch.serve import serve_batch, serve_batch_sharded

    fom = StencilThermalBlock((2, 2), GRID, dtype=DT, device="cpu")
    emb = ShardedSrhtEmbedding.from_plan(inp["plan_signs"], inp["plan_sampling"], mesh)
    state, step = make_sharded_greedy_step(
        fom, k=K, r_max=R_MAX, cg_tol=1e-10, cg_maxiter=800, sketch="srht",
        embedding=emb, mesh=mesh)
    batch = {"diffusion": _t(inp["batch"])}
    ests, us = [], []
    for row in inp["mus"]:
        state, est, u = step(state, {"diffusion": _t(row)}, batch)
        ests.append(est)
        us.append(u)
    out = {"state": {key: getattr(state, key) for key in ("srb", "res_lhs", "res_rhs",
                                                          "ncols", "out")},
           "estimates": ests, "u": us}
    rom = state_to_rom(fom, state)
    axis = "mu" if "mu" in mesh.mesh_dim_names else "dof"  # data-parallel serving
    out["served"] = serve_batch_sharded(rom, batch, mesh, axis)
    out["served_direct"] = serve_batch(rom, batch)
    try:
        serve_batch_sharded(rom, mu_stack([{"diffusion": _t(r)} for r in inp["batch"][:3]]),
                            mesh, axis)
        out["refused"] = None
    except ValueError as exc:
        out["refused"] = str(exc)
    return out


def lobpcg(mesh, inp: dict) -> dict:
    from rla4mor_tpu_torch.mor.scm_matfree import lobpcg_gen
    from rla4mor_tpu_torch.parallel import mesh as pm

    T, R = _t(inp["T"]), _t(inp["R"])
    n = T.shape[0]
    r0, r1 = pm.row_range(n, mesh)
    group = pm.axis_group(mesh, "dof")

    def rows_of(A):  # the rank's rows of A @ U, U row-sharded
        return lambda U: A[r0:r1] @ pm.all_gather_rows(U, group)

    res = lobpcg_gen(rows_of(T), rows_of(R), n, k=1, block=2, iters=40, tol=LOBPCG_TOL,
                     key=3, device="cpu", mesh=mesh)
    return {"values": res.values, "radii": res.radii, "iterations": res.iterations,
            "vectors": res.vectors}


def scm_fom():
    """The SCM case's FOM: a 1 x 1 block, one term (one halo exchange an
    apply of A(mu))."""
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock

    return StencilThermalBlock((1, 1), GRID, dtype=DT, device="cpu")


def scm_anchor(mesh, inp: dict) -> dict:
    """One anchor of ``MatrixFreeScmCoercivity``, its LOBPCG row-sharded (the
    analytic term boxes: no box eigensolves)."""
    from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmCoercivity

    fom = scm_fom()
    scm = MatrixFreeScmCoercivity(fom, mesh=mesh, boxes=fom.term_box_bounds(), **SCM_KW)
    alpha, ystar = scm.alpha_exact({"diffusion": _t(inp["mu_thermal"][:1])})
    return {"alpha": alpha, "ystar": ystar, "theta": scm.anchor_diagnostics[0]["theta"],
            "iterations": scm.anchor_diagnostics[0]["iterations"]}


# the anchor's LOBPCG: every iteration is a few dozen collectives
SCM_KW = dict(block=2, iters=40, tol=1e-6, device="cpu", log_level=30)

# the time loops at the JAX tests' sizes (tests/test_parallel.py): grid 31 (32
# node rows, 8 a rank), the 3-D block at grid 15 (16 z-planes, 4 a rank)
TIME_GRID, TIME_GRID_3D = 31, 15
TIME_KW = dict(tol=1e-12, maxiter=400)
# POD-greedy on the (2, 2) mesh: grid 15 (8 node rows a rank), T 0.1, nt 3
GREEDY_GRID, GREEDY_EXT, GREEDY_K = 15, 3, 64
GREEDY_VIEW_KW = dict(tol=1e-10, maxiter=300)


def time_foms():
    """{case: (the port's one-device FOM, its solve, the case's Mu keys)} of
    the sharded time loops; ``solve(fom, mu, **kw)`` runs one."""
    from rla4mor_tpu_torch.models.instationary_stencil import InstationaryStencilFOM
    from rla4mor_tpu_torch.models.semilinear import (
        SemilinearInstationaryFOM,
        SemilinearStencilFOM,
    )
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.models.stencil3d import StencilThermalBlock3D
    from rla4mor_tpu_torch.models.stencil_advection import StencilAdvectionDiffusion
    from rla4mor_tpu_torch.models.wave_stencil import WaveStencilFOM

    st = StencilThermalBlock((2, 2), TIME_GRID, dtype=DT, device="cpu")
    semi = SemilinearStencilFOM((2, 2), TIME_GRID, dtype=DT, reaction_scale=50.0,
                                device="cpu")
    return {
        "parabolic": InstationaryStencilFOM(st, T=0.5, nt=6),
        "parabolic3d": InstationaryStencilFOM(
            StencilThermalBlock3D((2, 2, 2), TIME_GRID_3D, dtype=DT, device="cpu"),
            T=0.25, nt=4),
        "advection": InstationaryStencilFOM(
            StencilAdvectionDiffusion(TIME_GRID, dtype=DT, device="cpu"), T=0.25, nt=4),
        "wave": WaveStencilFOM(st, T=0.25, nt=5),
        "newton": semi,
        "imex": SemilinearInstationaryFOM(semi, T=0.25, nt=4),
    }


def time_solve(case: str, fom, mu: dict, **kw):
    """One run of a time-loop case (Newton: the solve to 1e-11)."""
    if case == "newton":
        return fom.solve_newton(mu, newton_tol=1e-11, **kw)
    return fom.solve(mu, **TIME_KW, **kw)


def time_loops(mesh, inp: dict) -> dict:
    """Each time loop on the rank's slab (its slab of the result), the
    refusal of the V-cycle on a mesh and of the reductor's slab view off
    the 2-D thermal block."""
    out = {}
    foms = time_foms()
    for case, fom in foms.items():
        mu = {key: _t(v) for key, v in inp["time_mus"][case].items()}
        out[case] = time_solve(case, fom, mu, mesh=mesh)
    out["gathered"] = foms["parabolic"].gather(out["parabolic"], mesh)
    try:
        foms["parabolic"].solve({key: _t(v) for key, v in inp["time_mus"]["parabolic"].items()},
                                precond="mg", mesh=mesh)
        out["mg_refused"] = None
    except ValueError as exc:
        out["mg_refused"] = str(exc)
    for case in ("parabolic3d", "advection"):
        try:
            foms[case].as_reductor_fom(mesh=mesh)
            out[f"view_refused_{case}"] = None
        except ValueError as exc:
            out[f"view_refused_{case}"] = str(exc)
    return out


def factorisations(mesh, inp: dict) -> dict:
    """``gram_schmidt`` / ``pod`` with ``group=`` on the rank's rows."""
    from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt, pod
    from rla4mor_tpu_torch.parallel import mesh as pm

    U = _t(inp["factor_U"])
    r0, r1 = pm.row_range(U.shape[0], mesh)
    group = pm.axis_group(mesh, "dof")
    Q, R = gram_schmidt(U[r0:r1], return_R=True, group=group)
    modes, svals = pod(U[r0:r1], modes=4, rtol=None, group=group)
    return {"Q": Q, "R": R, "modes": modes, "svals": svals}


def pod_greedy_mesh(mesh, inp: dict) -> dict:
    """POD-greedy with the trajectories on the DoF slabs, the sweep split over
    ``"mu"`` and the JAX SRHT plan carried in."""
    from rla4mor_tpu_torch.models.instationary import InstationaryReductor, pod_greedy
    from rla4mor_tpu_torch.models.instationary_stencil import InstationaryStencilFOM
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.parallel.embeddings import ShardedSrhtEmbedding

    st = StencilThermalBlock((2, 2), GREEDY_GRID, dtype=DT, device="cpu")
    view = InstationaryStencilFOM(st, T=0.1, nt=3).as_reductor_fom(mesh=mesh,
                                                                   **GREEDY_VIEW_KW)
    emb = ShardedSrhtEmbedding.from_plan(inp["greedy_signs"], inp["greedy_sampling"], mesh)
    red = InstationaryReductor(view, embedding=emb, log_level=30)
    train = [{"diffusion": _t(row)} for row in inp["greedy_train"]]
    rom, hist = pod_greedy(view, red, train, max_extensions=GREEDY_EXT, log_level=30,
                           mesh=mesh)
    return {"rb": red.rb, "selected": [m["diffusion"] for m in hist["selected_mus"]],
            "max_estimates": hist["max_estimates"], "reduce_calls": red.reduce_calls,
            "mass_r": rom.mass_r}


def run_cases(rank: int, inp: dict) -> dict:
    torch.set_num_threads(1)
    from rla4mor_tpu_torch.examples.multichip_dryrun import dryrun, mesh_shape
    from rla4mor_tpu_torch.parallel import make_mesh

    dof = make_mesh(("dof",), device="cpu")
    dof_mu = make_mesh(("dof", "mu"), mesh_shape(4), device="cpu")  # (2, 2)
    out = {"rank": rank}
    out.update(sketches(dof, inp))
    out.update(solves(dof, inp))
    out["greedy_dof4"] = greedy(dof, inp)
    out["greedy_dof2_mu2"] = greedy(dof_mu, inp)
    out["lobpcg"] = lobpcg(dof, inp)
    out["scm"] = scm_anchor(dof, inp)
    out["time_loops"] = time_loops(dof, inp)
    out["factorisations"] = factorisations(dof, inp)
    out["pod_greedy"] = pod_greedy_mesh(dof_mu, inp)
    out["dryrun"] = dryrun(dof_mu, "cpu", log=lambda line: None)
    out["mesh_rows"] = (dof_mu.get_local_rank("dof"), dof_mu.get_local_rank("mu"))
    return out
