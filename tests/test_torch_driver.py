"""The port's padded greedy driver, ``state_to_rom`` and the large-scale
demo held against the JAX package (f64, CPU).

The JAX step runs jitted on a one-device ('dof', 'mu') mesh; the port's
step takes the same random operator, carried across through its
``embedding=`` argument: the SRHT plan of ``fold_in(key, 0)`` or the
Gaussian Omega ``gaussian_cols(fold_in(key, 0), k, 0, n)``. Grid 15 runs
Jacobi-CG, grid 16 MG-CG (the JAX V-cycle with its restriction scaled by
4, as the port's); k = 32, r_max = 4, 3 steps, parameters drawn with
numpy from a seed. The states (srb, res_lhs, res_rhs, ncols, out, U)
and the estimates agree to 1e-10 relative; the shipped ROMs' solve,
output and estimate too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from rla4mor_tpu.models import multigrid as jmg
from rla4mor_tpu.models.stencil import StencilThermalBlock as JaxStencil
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan
from rla4mor_tpu.ops.seeding import gaussian_cols as jax_gaussian_cols
from rla4mor_tpu.parallel import make_sharded_greedy_step as jax_make_step
from rla4mor_tpu.parallel import state_to_rom as jax_state_to_rom

from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding, SrhtEmbedding
from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom
from rla4mor_tpu_torch.serve import pad_batch, serve_batch

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

K, R_MAX, STEPS = 32, 4, 3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _batch(count, seed):
    jm, tm = _mus(count, seed)
    return {"diffusion": jnp.stack([m["diffusion"] for m in jm])}, mu_stack(tm)


def _pair(grid, sketch, projection="galerkin", score="sketched"):
    """(jitted JAX step, its state0, the port's step, its state0)."""
    precond = "mg" if grid & (grid - 1) == 0 else "jacobi"
    key = jax.random.key(0)
    kw = dict(k=K, r_max=R_MAX, cg_tol=1e-10, cg_maxiter=800, cg_precond=precond,
              sketch=sketch, score=score, projection=projection)
    jfom = JaxStencil((2, 2), grid, dtype=jnp.float64)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dof", "mu"))
    jstate, jstep = jax_make_step(jfom, mesh, key, **kw)
    # the state as the jitted step returns it, so the second step reuses the
    # first step's compilation
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    n = (grid + 1) ** 2
    key_theta = jax.random.fold_in(key, 0)
    if sketch == "srht":
        signs, sampling, _ = jax_srht_plan(key_theta, n, K)
        emb = SrhtEmbedding.from_plan(n, K, np.array(signs), np.array(sampling),
                                      device="cpu")
    else:
        emb = GaussianEmbedding.from_matrix(
            np.asarray(jax_gaussian_cols(key_theta, K, 0, n, jnp.float64)), device="cpu")
    tfom = StencilThermalBlock((2, 2), grid, dtype=torch.float64, device="cpu")
    tstate, tstep = make_sharded_greedy_step(tfom, embedding=emb, **kw)
    with mesh:
        jit_step = jax.jit(jstep)
    jax_restrict = jmg.restrict_full_weighting

    def run_jax(state, mu, batch):
        # the port's V-cycle hands its coarse level P^T r, the JAX one P^T r / 4
        # (ROADMAP.md queue 3): the JAX step is traced with its restriction
        # scaled by 4, so the cycle the port runs is the one compared
        with mesh, pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmg, "restrict_full_weighting", lambda r: 4.0 * jax_restrict(r))
            return jit_step(state, mu, batch)

    return jfom, tfom, jstate, run_jax, tstate, tstep


def assert_states_equal(ts, js):
    assert int(ts.ncols) == int(js.ncols)
    for name in ("srb", "res_lhs", "res_rhs", "out"):
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-10, name
    if js.U is not None:
        assert rel(ts.U, js.U) < 1e-10


_RUNS = {}


def _run(grid, sketch, projection="galerkin", score="sketched"):
    """Three steps of both packages (cached for the module): the final
    states, each step's estimates, and the pair."""
    cfg = (grid, sketch, projection, score)
    if cfg not in _RUNS:
        pair = _pair(*cfg)
        jfom, tfom, js, jstep, ts, tstep = pair
        (jb, tb), (jm, tm) = _batch(6, 2), _mus(STEPS, 1)
        ests = []
        for i in range(STEPS):
            js, jest, ju = jstep(js, jm[i], jb)
            ts, test, tu = tstep(ts, tm[i], tb)
            assert rel(tu, ju) < 1e-10
            assert_states_equal(ts, js)
            ests.append((test, jest))
        _RUNS[cfg] = (pair, js, ts, ests)
    return _RUNS[cfg]


CASES = [  # sketch x projection; grid 16 runs the (slower to compile) MG step
    (16, "gaussian", "galerkin"),
    (15, "gaussian", "minres"),
    (15, "srht", "galerkin"),
    (15, "srht", "minres"),
]


@pytest.mark.parametrize("grid,sketch,projection", CASES)
def test_greedy_step_matches_jax(grid, sketch, projection):
    """Three steps of each sketch x projection: states and estimates to
    1e-10. Over 5 s: the JAX side builds its step (an eager shard_map sketch
    of the rhs) and jit-compiles it (the CG while-loop with, at grid 16, the
    V-cycle unrolled inside): 4-12 s a configuration. The port's three
    steps take under 1 s."""
    _, js, ts, ests = _run(grid, sketch, projection)
    assert int(ts.ncols) == STEPS
    for test, jest in ests:
        assert torch.isfinite(test).all()
        assert rel(test, jest) < 1e-10
    assert float(ests[-1][0].median()) < float(ests[0][0].median())


def test_exact_score_matches_jax():
    """score='exact': the basis grids, their Gram-Schmidt invariant and the
    true-residual estimates in float64 equal the JAX package's. Over 5 s
    for the JAX step's build and compile, as above."""
    (_, tfom, *_), js, ts, ests = _run(15, "srht", "galerkin", "exact")
    for test, jest in ests:
        assert rel(test, jest) < 1e-10
    assert ts.U.shape == (R_MAX, 16, 16)


@pytest.mark.parametrize("grid,sketch,projection", [CASES[0], CASES[3]])
def test_state_to_rom_matches_jax(grid, sketch, projection):
    """The shipped ROM's solve, output and estimate equal the JAX ROM's at
    held-out parameters, and ``serve_batch`` serves it."""
    (jfom, tfom, *_), js, ts, _ = _run(grid, sketch, projection)
    jrom = jax_state_to_rom(jfom, js, projection=projection)
    trom = state_to_rom(tfom, ts, projection=projection)
    jm, tm = _mus(3, 7)
    for jmu, tmu in zip(jm, tm):
        y = trom.solve(tmu)
        assert rel(y, jrom.solve(jmu)) < 1e-10
        assert rel(trom.output(y, tmu), jrom.output(jrom.solve(jmu), jmu)) < 1e-10
        assert rel(trom.estimate_error(tmu), jrom.estimate_error(jmu)) < 1e-10
    padded, valid = pad_batch(mu_stack(tm), 8)
    out = serve_batch(trom, padded)
    assert valid == 3 and out["u"].shape == (8, STEPS)
    for i, tmu in enumerate(tm):
        assert rel(out["u"][i], trom.solve(tmu)) < 1e-12
        assert rel(out["estimate"][i], trom.estimate_error(tmu)) < 1e-12
        assert rel(out["output"][i], trom.output(trom.solve(tmu), tmu)) < 1e-12


def test_step_skips_a_nonfinite_snapshot():
    """Mirrors ``tests/test_parallel.py::test_sharded_step_skips_nonfinite_snapshot``:
    a NaN parameter's solve is not written into the state (ncols stays
    put, estimates stay finite), a later good step extends it, and the
    states equal the JAX package's throughout."""
    (_, tfom, js, jstep, ts, tstep), *_ = _run(*CASES[0])  # its compiled steps
    (jb, tb), (jm, tm) = _batch(6, 2), _mus(2, 1)
    jbad = {"diffusion": jm[0]["diffusion"] * jnp.nan}
    tbad = {"diffusion": tm[0]["diffusion"] * float("nan")}
    for jmu, tmu in ((jm[0], tm[0]), (jbad, tbad), (jm[1], tm[1])):
        js, jest, _ = jstep(js, jmu, jb)
        ts, test, _ = tstep(ts, tmu, tb)
        assert torch.isfinite(test).all()
        assert rel(test, jest) < 1e-10
        assert_states_equal(ts, js)
    assert int(ts.ncols) == 2
    assert torch.isfinite(ts.srb).all() and torch.isfinite(ts.res_lhs).all()


def test_step_saturates_at_r_max():
    """Past r_max the state keeps its columns (the clamp of the write index
    and the ok select), as the JAX package's."""
    tfom = StencilThermalBlock((2, 2), 15, dtype=torch.float64, device="cpu")
    ts, tstep = make_sharded_greedy_step(tfom, seed=3, k=K, r_max=2, cg_tol=1e-10,
                                         sketch="srht")
    _, tb = _batch(4, 2)
    _, tm = _mus(3, 1)
    ts, _, _ = tstep(ts, tm[0], tb)
    full, _, _ = tstep(ts, tm[1], tb)
    after, est, _ = tstep(full, tm[2], tb)
    assert int(after.ncols) == 2 and torch.isfinite(est).all()
    for name in ("srb", "res_lhs", "out"):
        assert torch.equal(getattr(after, name), getattr(full, name))


def test_one_device_sketches_match_jax():
    """The blocked and chunked Gaussian sketches are the canonical Omega of
    the seed, column block by column block (1e-12 against
    ``GaussianEmbedding(k, n, seed).random_matrix() @ x``); the flat SRHT's
    row layout is the JAX package's on a one-device mesh."""
    from rla4mor_tpu.parallel import flat_shard_rows as jax_flat_shard_rows

    from rla4mor_tpu_torch.parallel import (
        flat_shard_rows,
        gaussian_sketch_blocked,
        gaussian_sketch_sharded,
    )

    n, k = 8192, 24
    x = torch.tensor(np.random.RandomState(8).normal(size=(n, 3)))
    want = GaussianEmbedding(k, n, seed=5, device="cpu").random_matrix() @ x
    assert rel(gaussian_sketch_sharded(5, k, x), want) < 1e-12
    assert rel(gaussian_sketch_sharded(5, k, x, max_omega_elems=2048 * k), want) < 1e-12
    assert rel(gaussian_sketch_blocked(5, k, x, 4), want) < 1e-12
    assert rel(gaussian_sketch_sharded(5, k, x[:, 0]), want[:, 0]) < 1e-12
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1), ("dof",))
    for m in (1, 289, 2048, 2049, 4198401):
        assert flat_shard_rows(m) == jax_flat_shard_rows(m, mesh)


def test_driver_rejects_what_is_not_ported():
    tfom = StencilThermalBlock((2, 2), 15, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="model_error"):
        make_sharded_greedy_step(tfom, model_error=lambda mu, u: 0.0)
    with pytest.raises(ValueError, match="projection"):
        make_sharded_greedy_step(tfom, projection="petrov")

    class WithAux(StencilThermalBlock):
        def const_arrays(self):
            return {}

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_greedy_step(WithAux((2, 2), 15, dtype=torch.float64, device="cpu"))


def test_large_scale_demo_runs_on_the_cpu(capsys):
    """The entry point with ``--cpu`` at grid 16, 2 steps, MG-CG and the
    SRHT: it prints each step's time, CG iterations, recursive and true
    residuals and median estimate, then the ROM and the served batch."""
    from rla4mor_tpu_torch.examples import large_scale_demo

    assert large_scale_demo.main(["--cpu", "--grid", "16", "--steps", "2",
                                  "--precond", "mg", "--sketch", "srht"]) == 0
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("it ")]
    assert len(steps) == 2 and all("cg_iters=" in ln and "true_res=" in ln for ln in steps)
    assert any(ln.startswith("rom r=2") and "served 200 requests" in ln for ln in lines)
    assert lines[-1] == "done"
    res = large_scale_demo.run(16, 2, 32, "mg", "srht", device="cpu", log=lambda s: None)
    assert res["grid"] == 16 and res["n"] == 289 and len(res["cg_iters"]) == 2
    assert all(t < 1e-6 for t in res["true_res"])
    assert torch.isfinite(res["served"]["output"]).all()
    for flag in (["--family", "nonaffine"], ["--family", "lossy"], ["--bounds"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            large_scale_demo.main(["--cpu", "--grid", "16", *flag])
