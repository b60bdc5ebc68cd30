"""The slice as a whole for the advection, Helmholtz and 3-D families: the
port's padded greedy step, ``state_to_rom`` and the large-scale demo held
against the JAX package (f64, CPU).

The JAX step runs jitted on a one-device ('dof', 'mu') mesh; the port's
step takes the same SRHT plan (of ``fold_in(key, 0)``), carried across
through its ``embedding=`` argument. Advection and Helmholtz: grid 15,
Jacobi-BiCGStab, sketched minres; 3-D: grid 7 (8^3 nodes), Jacobi-CG,
Galerkin. k = 32, r_max = 4, 3 steps, parameters drawn with numpy from a
seed. Snapshots and states (srb, res_lhs, res_rhs, ncols, out) agree to
1e-10 relative; so do the shipped minres ROM's solve and output. An
estimate is the norm of the difference of two vectors of the size of the
sketched rhs S b, so it is held to 1e-10 of ||S b||: by the third
Helmholtz step it is 1.9e-4 of ||S b||, and the two packages' 5e-14 of
||S b|| apart is 2.8e-10 of the estimate itself.

Run as a script (``python tests/test_torch_families.py [--grid2d 64]
[--grid3d 31]``) it prints what the JAX package reaches at a small grid
on the CPU in float64 with the steps ``chip_smoke.py`` runs each family
(advection 8, Helmholtz 4, 3-D 4): the ROM output error at 4 held-out
parameters against its own float64 solve (``reach``).
"""

import argparse
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from rla4mor_tpu import models as jmodels  # noqa: E402
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan  # noqa: E402
from rla4mor_tpu.parallel import make_sharded_greedy_step as jax_make_step  # noqa: E402
from rla4mor_tpu.parallel import state_to_rom as jax_state_to_rom  # noqa: E402

from rla4mor_tpu_torch import models as tmodels  # noqa: E402
from rla4mor_tpu_torch.core import mu_stack  # noqa: E402
from rla4mor_tpu_torch.models.multigrid import make_vcycle  # noqa: E402
from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding  # noqa: E402
from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom  # noqa: E402
from rla4mor_tpu_torch.serve import pad_batch, serve_batch  # noqa: E402

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

K, R_MAX, STEPS = 32, 4, 3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rows(family, count, seed):
    """{name: (count, size) numpy draws} within the family's ranges."""
    rng = np.random.RandomState(seed)
    if family == "advection":
        return {"eps": rng.uniform(0.05, 1.0, size=(count, 1)),
                "velocity": rng.uniform(-1.0, 1.0, size=(count, 2))}
    if family == "helmholtz":
        return {"ksq": rng.uniform(22.0, 46.0, size=(count, 1))}
    return {"diffusion": rng.uniform(0.1, 1.0, size=(count, 8))}


def _mus(family, count, seed):
    rows = _rows(family, count, seed)
    return ([{k: jnp.asarray(v[i]) for k, v in rows.items()} for i in range(count)],
            [{k: torch.tensor(v[i]) for k, v in rows.items()} for i in range(count)])


def _batch(family, count, seed):
    rows = _rows(family, count, seed)
    return ({k: jnp.asarray(v) for k, v in rows.items()},
            {k: torch.tensor(v) for k, v in rows.items()})


FAMILIES = {  # family: (JAX FOM, the port's FOM, projection)
    "advection": (lambda: jmodels.StencilAdvectionDiffusion(15, dtype=jnp.float64),
                  lambda: tmodels.StencilAdvectionDiffusion(15, dtype=torch.float64,
                                                            device="cpu"), "minres"),
    "helmholtz": (lambda: jmodels.StencilHelmholtz(15, dtype=jnp.float64),
                  lambda: tmodels.StencilHelmholtz(15, dtype=torch.float64, device="cpu"),
                  "minres"),
    "thermal3d": (lambda: jmodels.StencilThermalBlock3D((2, 2, 2), 7, dtype=jnp.float64),
                  lambda: tmodels.StencilThermalBlock3D((2, 2, 2), 7, dtype=torch.float64,
                                                        device="cpu"), "galerkin"),
}


def assert_states_equal(ts, js):
    assert int(ts.ncols) == int(js.ncols)
    for name in ("srb", "res_lhs", "res_rhs", "out"):
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-10, name


def assert_estimates_equal(test, jest, js):
    """Within 1e-10 of ||S b|| (see the module docstring)."""
    diff = np.abs(np.asarray(test) - np.asarray(jest)).max()
    assert diff < 1e-10 * float(np.linalg.norm(np.asarray(js.res_rhs))), diff


_RUNS = {}


def _run(family):
    """Three steps of both packages (cached for the module): the FOMs, the
    final states and each step's estimates."""
    if family not in _RUNS:
        jmake, tmake, projection = FAMILIES[family]
        jfom, tfom = jmake(), tmake()
        key = jax.random.key(0)
        kw = dict(k=K, r_max=R_MAX, cg_tol=1e-10, cg_maxiter=4000, cg_precond="jacobi",
                  sketch="srht", projection=projection)
        mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dof", "mu"))
        js, jstep = jax_make_step(jfom, mesh, key, **kw)
        js = jax.device_put(js, NamedSharding(mesh, PartitionSpec()))
        n = int(np.prod(tfom.solution_shape))
        signs, sampling, _ = jax_srht_plan(jax.random.fold_in(key, 0), n, K)
        emb = SrhtEmbedding.from_plan(n, K, np.array(signs), np.array(sampling), device="cpu")
        ts, tstep = make_sharded_greedy_step(tfom, embedding=emb, **kw)
        with mesh:
            jit_step = jax.jit(jstep)
        (jb, tb), (jm, tm) = _batch(family, 6, 2), _mus(family, STEPS, 1)
        ests, snaps = [], []
        for i in range(STEPS):
            with mesh:
                js, jest, ju = jit_step(js, jm[i], jb)
            ts, test, tu = tstep(ts, tm[i], tb)
            snaps.append((tu, ju, tstep.last_solve))
            ests.append((test, jest))
        _RUNS[family] = (jfom, tfom, js, ts, ests, snaps)
    return _RUNS[family]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_greedy_steps_match_jax(family):
    """Three steps: each snapshot and the final state to 1e-10, each step's
    estimates within 1e-10 of ||S b||; the solver converged, the basis grew, the median estimate
    dropped. Over 5 s: the JAX side builds its step (an eager shard_map
    sketch of the rhs) and jit-compiles it (a BiCGStab or CG while-loop
    around the family's stencils): 3-8 s a family."""
    _, tfom, js, ts, ests, snaps = _run(family)
    for tu, ju, solve in snaps:
        assert rel(tu, ju) < 1e-10
        assert solve.iters < 4000
    assert_states_equal(ts, js)
    assert int(ts.ncols) == STEPS
    for test, jest in ests:
        assert torch.isfinite(test).all()
        assert_estimates_equal(test, jest, js)
    assert float(ests[-1][0].median()) < float(ests[0][0].median())


@pytest.mark.parametrize("family", ["advection", "helmholtz"])
def test_minres_state_to_rom_matches_jax(family):
    """The shipped sketched minres ROM (``ls=True``): its solve and output
    at held-out parameters equal the JAX ROM's to 1e-10, its estimate to
    1e-10 of ||S b||, and ``serve_batch`` serves it (the Helmholtz
    coefficient -ksq is an ``ExpressionCoefficient`` evaluated on the
    batch)."""
    jfom, tfom, js, ts, _, _ = _run(family)
    jrom = jax_state_to_rom(jfom, js, projection="minres")
    trom = state_to_rom(tfom, ts, projection="minres")
    assert trom.ls
    jm, tm = _mus(family, 3, 7)
    for jmu, tmu in zip(jm, tm):
        y, jy = trom.solve(tmu), jrom.solve(jmu)
        assert rel(y, jy) < 1e-10
        assert rel(trom.output(y, tmu), jrom.output(jy, jmu)) < 1e-10
        assert_estimates_equal(trom.estimate_error(tmu), jrom.estimate_error(jmu), js)
    padded, valid = pad_batch(mu_stack(tm), 8)
    out = serve_batch(trom, padded)
    assert valid == 3 and out["u"].shape == (8, STEPS)
    for i, tmu in enumerate(tm):
        assert rel(out["u"][i], trom.solve(tmu)) < 1e-12
        assert rel(out["estimate"][i], trom.estimate_error(tmu)) < 1e-12


@pytest.mark.parametrize("family,grid", [("advection", "16"), ("helmholtz", "15"),
                                         ("thermal3d", "7")])
def test_large_scale_demo_runs_each_family_on_the_cpu(family, grid, capsys):
    """``--family`` with ``--cpu``, 2 steps, Jacobi, the SRHT: the step lines
    name the family's solver, the ROM is built and serves, ``done``; with
    ``--precond mg`` the 3-D family prints the NOTE and runs Jacobi-CG."""
    from rla4mor_tpu_torch.examples import large_scale_demo

    args = ["--cpu", "--family", family, "--grid", grid, "--steps", "2", "--sketch", "srht"]
    if family == "thermal3d":
        args += ["--precond", "mg"]
    assert large_scale_demo.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    solver = "cg" if family == "thermal3d" else "bicgstab"
    assert any(ln.startswith("device=cpu " + family) for ln in lines)
    steps = [ln for ln in lines if ln.startswith("it ")]
    assert len(steps) == 2 and all(f"{solver}_iters=" in ln and "true_res=" in ln
                                   for ln in steps)
    assert any(ln.startswith("rom r=2") and "served 200 requests" in ln for ln in lines)
    assert (family == "thermal3d") == any(ln.startswith("NOTE: --precond mg ignored")
                                          for ln in lines)
    assert lines[-1] == "done"


def test_vcycle_refuses_a_3d_field():
    with pytest.raises(ValueError, match="2-D"):
        make_vcycle(torch.ones((8, 8, 8), dtype=torch.float64))


def test_greedy_select_takes_each_candidate_once():
    """``select='greedy'`` takes the candidate with the largest estimate
    among those not taken yet: at the float32 estimate floor the largest
    can be an in-basis parameter, whose duplicate snapshot the append
    refuses (an H100 run of the advection family at grid 2048 re-took one
    candidate for its last 4 steps). Here (Helmholtz, float64, grid 16,
    4 candidates, 5 steps) every greedy step takes a different candidate,
    and more steps than candidates + 1 are refused."""
    from rla4mor_tpu_torch.examples import large_scale_demo

    kw = dict(k=32, precond="mg", sketch="srht", device="cpu", batch=4, select="greedy",
              family="helmholtz", requests=8, serve_size=8, log=lambda line: None)
    res = large_scale_demo.run(16, 5, **kw)
    rows = res["mu_batch"]["ksq"][:, 0].tolist()
    picked = [rows.index(float(m["ksq"][0])) for m in res["mus"][1:]]
    assert sorted(picked) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="at most 5 steps"):
        large_scale_demo.run(16, 6, **kw)


REACH_STEPS = {"advection": 8, "helmholtz": 4, "thermal3d": 4}  # chip_smoke.py's


def reach(family, grid, steps, k=256, batch=8):
    """The JAX package's greedy as the port's demo runs it (SRHT k, Jacobi
    solves to 1e-10, the first parameter drawn, then the candidate of
    ``batch`` with the largest estimate not taken yet), ``state_to_rom``,
    and the ROM's relative output error at 4 held-out parameters against
    the FOM solved to 1e-12 (float64, CPU)."""
    if family == "advection":
        fom = jmodels.StencilAdvectionDiffusion(grid, dtype=jnp.float64)
    elif family == "helmholtz":
        fom = jmodels.StencilHelmholtz(grid, dtype=jnp.float64)
    else:
        fom = jmodels.StencilThermalBlock3D((2, 2, 2), grid, dtype=jnp.float64)
    projection = "galerkin" if fom.is_spd else "minres"
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dof", "mu"))
    state, step = jax_make_step(fom, mesh, jax.random.key(0), k=k, r_max=steps,
                                cg_tol=1e-10, cg_maxiter=20000, cg_precond="jacobi",
                                sketch="srht", projection=projection)
    with mesh:
        jit_step = jax.jit(step)
    (jb, _), (jm, _) = _batch(family, batch, 2), _mus(family, 1, 1)
    mu, taken = jm[0], np.zeros(batch, bool)
    for it in range(steps):
        if it:
            pick = int(np.argmax(np.where(taken, -np.inf, np.asarray(est))))
            taken[pick] = True
            mu = {key: v[pick] for key, v in jb.items()}
        with mesh:
            state, est, _ = jit_step(state, mu, jb)
    rom = jax_state_to_rom(fom, state, projection=projection)
    errors = []
    for mu in _mus(family, 4, 3)[0]:
        if fom.is_spd:
            u = fom.solve_cg(mu, tol=1e-12, maxiter=20000)
        else:
            u = fom.solve_bicgstab(mu, tol=1e-12, maxiter=20000)
        s_fom = float(fom.output(u))
        errors.append(abs(float(rom.output(rom.solve(mu), mu)[0]) - s_fom) / abs(s_fom))
    return int(state.ncols), errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the JAX package's ROM output error per family")
    ap.add_argument("--grid2d", type=int, default=64)
    ap.add_argument("--grid3d", type=int, default=31)
    args = ap.parse_args(argv)
    for family, steps in REACH_STEPS.items():
        grid = args.grid3d if family == "thermal3d" else args.grid2d
        ncols, errors = reach(family, grid, steps)
        print(f"[reach] family={family} grid={grid} steps={steps} ncols={ncols} "
              f"out_rel_err={[float(f'{e:.3e}') for e in errors]} max={max(errors):.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
