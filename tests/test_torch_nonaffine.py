"""The non-affine stencil family (``models/stencil_nonaffine.py``), its EIM
surrogate, the padded greedy driver on it and the large-scale demo's
``nonaffine`` family, held against the JAX package (f64, CPU).

Grid 16 (17^2 nodes), the JAX demo's EIM fit (125 training bumps on a 5^3
grid, tol 1e-3, 4 reserve points). The greedy picks by argmax, and mirrored
training bumps tie to the last bit: at some grids the tie follows rounding
(XLA's ``exp`` and torch's differ in the last bit of some field values), and
the two packages pick different mirrors. At grid 16 they pick alike. The
two-grid fit is held as the composition of the coarse greedy and the fine
rebuild, at a coarse grid of 10 (a coarse grid 8 has 64 elements, fewer
than the fit's terms: its greedy runs out of points).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from rla4mor_tpu.models import stencil_nonaffine as jna
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan
from rla4mor_tpu.parallel import make_sharded_greedy_step as jax_make_step
from rla4mor_tpu.parallel import driver as jax_driver, sharded_sketch as jax_sharded_sketch

from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.core.solvers import cg
from rla4mor_tpu_torch.models import stencil_nonaffine as tna
from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

GRID, K, R_MAX, STEPS = 16, 32, 4, 3


@pytest.fixture(scope="module", autouse=True)
def jitted_jax_rhs_sketch():
    """The JAX step sketches the rhs while it is built, through an eager
    shard_map whose primitives compile one by one (3-9 s a build): the same
    functions jitted here, compiled once a shape. Their values are the
    eager ones up to rounding."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sharded_sketch, "srht_sketch_sharded_flat", jax.jit(
            jax_sharded_sketch.srht_sketch_sharded_flat,
            static_argnames=("k", "mesh", "axis", "block", "n")))
        mp.setattr(jax_driver, "gaussian_sketch_sharded", jax.jit(
            jax_sharded_sketch.gaussian_sketch_sharded,
            static_argnames=("k", "mesh", "axis", "max_omega_elems")))
        yield


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rows(count, seed, dim=3):
    return np.random.RandomState(seed).uniform(0.0, 1.0, size=(count, dim))


def _mus(count, seed, dim=3):
    rows = _rows(count, seed, dim)
    return ([{"bump": jnp.asarray(r)} for r in rows],
            [{"bump": torch.tensor(r)} for r in rows])


def _fit(grid=GRID, **kw):
    """The JAX and the port's EIM fit of the 2-D bump family at ``grid``."""
    jexact = jna.gaussian_bump_fom(grid, dtype=jnp.float64)
    texact = tna.gaussian_bump_fom(grid, dtype=torch.float64, device="cpu")
    jtrain = jexact.parameter_space.sample_uniformly(5)
    ttrain = texact.parameter_space.sample_uniformly(5, device="cpu", dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a short reserve is what the tests read
        return (jna.EimStencilFOM.from_training(jexact, jtrain, tol=1e-3, **kw),
                tna.EimStencilFOM.from_training(texact, ttrain, tol=1e-3, **kw))


@pytest.fixture(scope="module")
def fit16():
    """The demo's fit at grid 16 in both packages. About 3 s: the JAX
    greedy's host loop, 90 eager steps."""
    return _fit()


def assert_same_fit(t, j):
    ti, ji = t.interpolant, j.interpolant
    assert (t.n_terms, ti.n_reserve) == (j.n_terms, ji.n_reserve)
    assert ti.snapshot_ids == tuple(ji.snapshot_ids)
    np.testing.assert_array_equal(ti.points.numpy(), np.asarray(ji.points))
    assert rel(ti.basis, ji.basis) < 1e-12
    assert rel(ti.sup_errors, np.asarray(ji.sup_errors)) < 1e-12
    assert abs(t.kappa_floor - j.kappa_floor) < 1e-12


def test_nonaffine_fom_matches_jax():
    """The exact family: kappa (one parameter and a batch), apply, rhs,
    jacobi_diag and output to 1e-12; ``with_num_intervals`` keeps it."""
    jf = jna.gaussian_bump_fom(GRID, dtype=jnp.float64)
    tf = tna.gaussian_bump_fom(GRID, dtype=torch.float64, device="cpu")
    jm, tm = _mus(3, 0)
    u = np.random.RandomState(1).standard_normal(tf.solution_shape)
    for jmu, tmu in zip(jm, tm):
        assert rel(tf.kappa(tmu), jf.kappa(jmu)) < 1e-12
        assert rel(tf.apply(tmu, torch.tensor(u)), jf.apply(jmu, jnp.asarray(u))) < 1e-12
        assert rel(tf.jacobi_diag(tmu), jf.jacobi_diag(jmu)) < 1e-12
    batched = tf.kappa(mu_stack(tm))
    assert rel(batched, np.stack([jf.kappa(m) for m in jm])) < 1e-12
    assert rel(tf.rhs(), jf.rhs()) == 0.0
    assert rel(tf.output(torch.tensor(u)), jf.output(jnp.asarray(u))) < 1e-12
    coarse = tf.with_num_intervals(8)
    assert coarse.solution_shape == (9, 9) and coarse.kappa_lower == tf.kappa_lower == 1.0


def test_from_training_matches_jax(fit16):
    """The demo's fit: the same terms, points, snapshots and floor, basis
    and history to 1e-12; at held-out parameters theta, kappa, apply and
    jacobi_diag to 1e-12, the reserve-point indicator and the margin to
    1e-9 (a difference of O(1) field values); a batched Mu gives one row
    each; ``apply_terms`` is the stacked ``apply_term``, and apply is
    sum_q theta_q apply_term(q); the device greedy fits the same."""
    j, t = fit16
    assert_same_fit(t, j)
    jm, tm = _mus(3, 2)
    u = torch.tensor(np.random.RandomState(3).standard_normal(t.solution_shape))
    uj = jnp.asarray(u.numpy())
    for jmu, tmu in zip(jm, tm):
        assert rel(t.theta_vector(tmu), j.theta_vector(jmu)) < 1e-12
        assert rel(t.kappa(tmu), j.kappa(jmu)) < 1e-12
        assert rel(t.apply(tmu, u), j.apply(jmu, uj)) < 1e-12
        assert rel(t.jacobi_diag(tmu), j.jacobi_diag(jmu)) < 1e-12
        assert rel(t.kappa_error_indicator(tmu), j.kappa_error_indicator(jmu)) < 1e-9
        assert rel(t.ellipticity_margin(tmu), j.ellipticity_margin(jmu)) < 1e-9
    batch = mu_stack(tm)
    assert rel(t.theta_vector(batch), np.stack([j.theta_vector(m) for m in jm])) < 1e-12
    assert rel(t.ellipticity_margin(batch), np.stack([j.ellipticity_margin(m) for m in jm])) < 1e-9
    terms = t.apply_terms(u)
    assert torch.equal(terms, torch.stack([t.apply_term(q, u) for q in range(t.n_terms)]))
    assert rel(terms[5], j.apply_term(5, uj)) < 1e-12
    theta = t.theta_vector(tm[0])
    assert rel(torch.tensordot(theta, terms, dims=1), t.apply(tm[0], u)) < 1e-12
    scan = tna.EimStencilFOM.from_training(t.exact, t.exact.parameter_space.sample_uniformly(
        5, device="cpu", dtype=torch.float64), tol=1e-3, device_scan=True)
    assert scan.interpolant.snapshot_ids == t.interpolant.snapshot_ids
    assert torch.equal(scan.interpolant.points, t.interpolant.points)


def test_two_grid_fit_is_the_coarse_greedy_rebuilt_fine():
    """The two-grid fit (the greedy on 10 x 10 elements, the selected
    snapshots rebuilt at grid 16) is ``eim_greedy`` on the coarse fields and
    ``eim_rebuild`` of the fine fields of its picks, each held to the JAX
    package in ``tests/test_torch_eim.py`` (port only: the JAX package's
    two eager greedies would cost 5-9 s here); the floor is the rebuilt
    interpolant's minimum over those fine fields."""
    from rla4mor_tpu_torch.mor.eim import eim_greedy, eim_rebuild

    exact = tna.gaussian_bump_fom(GRID, dtype=torch.float64, device="cpu")
    train = exact.parameter_space.sample_uniformly(5, device="cpu", dtype=torch.float64)
    t = tna.EimStencilFOM.from_training(exact, train, tol=1e-3, training_intervals=10)
    assert t.fit_s.keys() == {"fields", "greedy", "rebuild"}
    coarse = eim_greedy(exact.with_num_intervals(10).kappa(mu_stack(train)).reshape(125, -1).T,
                        tol=1e-3, reserve=4)
    fine = exact.kappa(mu_stack([train[j] for j in coarse.snapshot_ids])).reshape(
        len(coarse.snapshot_ids), -1).T
    ref = eim_rebuild(fine, n_reserve=coarse.n_reserve)
    assert (t.n_terms, t.interpolant.n_reserve) == (ref.n_terms, 4)
    assert torch.equal(t.interpolant.points, ref.points)
    assert torch.equal(t.interpolant.basis, ref.basis)
    assert t.interpolant.sup_errors == ref.sup_errors
    assert t.kappa_floor == float(ref.interpolate(fine).min()) > 0


def test_error_bounds_match_jax(fit16):
    """``model_error_bound`` (the indicator's eps and a given one) and
    ``total_error_bound`` equal the JAX package's; the latter refuses an
    exact FOM without ``kappa_lower``."""
    j, t = fit16
    jm, tm = _mus(2, 5)
    u = np.random.RandomState(6).standard_normal(t.solution_shape)
    lam = (0.02, 5.0)
    for jmu, tmu in zip(jm, tm):
        ut, uj = torch.tensor(u), jnp.asarray(u)
        assert rel(t.model_error_bound(tmu, ut), j.model_error_bound(jmu, uj)) < 1e-9
        # eps and est as float64 arrays: the JAX package takes a Python
        # float as a weakly typed scalar
        eps, est = np.float64(0.01), np.float64(0.3)
        te, je = torch.tensor(eps), jnp.asarray(eps)
        assert rel(t.model_error_bound(tmu, ut, eps=te), j.model_error_bound(jmu, uj, eps=je)) < 1e-12
        assert rel(t.total_error_bound(tmu, ut, torch.tensor(est), lam, eps=te),
                   j.total_error_bound(jmu, uj, jnp.asarray(est), lam, eps=je)) < 1e-12
        assert rel(t.total_error_bound(tmu, ut, torch.tensor(est), lam),
                   j.total_error_bound(jmu, uj, jnp.asarray(est), lam)) < 1e-9
    no_floor = tna.EimStencilFOM(tna.NonAffineStencilFOM(
        tna.gaussian_bump_field(), GRID, t.parameter_space, dtype=torch.float64, device="cpu"),
        t.interpolant, t.kappa_floor)
    with pytest.raises(ValueError, match="kappa_lower"):
        no_floor.total_error_bound(tm[0], torch.tensor(u), 0.3, lam)


def test_total_error_bound_contains_the_true_error():
    """With the certified eps (the sup of |kappa - kappa_EIM| over the
    element grid) and dense ``eigh`` bounds of the unit stiffness, the
    total bound contains ||u_exact - u_s||_2 for a converged surrogate
    solve and a rough one (``tests/test_eim.py:637``, grid 12)."""
    exact = tna.gaussian_bump_fom(12, dtype=torch.float64, device="cpu")
    fom = tna.EimStencilFOM.from_training(exact, exact.parameter_space.sample_uniformly(
        5, device="cpu", dtype=torch.float64), tol=1e-3, reserve=2)
    n = exact.n_dof
    ones = torch.ones(exact.element_shape, dtype=torch.float64)
    K1 = exact.apply_field(ones, torch.eye(n, dtype=torch.float64).reshape(
        n, *exact.solution_shape)).reshape(n, n)
    interior = torch.nonzero(exact.rhs().reshape(-1) > 0)[:, 0]
    K1 = K1[interior][:, interior]
    lam = torch.linalg.eigvalsh(0.5 * (K1 + K1.T))
    lam_bounds = (float(lam[0]) * (1 - 1e-12), float(lam[-1]) * (1 + 1e-12))
    f = exact.rhs()
    for mu in exact.sample_parameters(3, key=5):
        eps = float((exact.kappa(mu) - fom.kappa(mu)).abs().max())
        u_e = exact.solve_cg(mu, tol=1e-13, maxiter=20000)
        for maxiter in (4000, 15):
            u_s = cg(lambda v: fom.apply(mu, v), f, precond=lambda r: r / fom.jacobi_diag(mu),
                     tol=1e-13, maxiter=maxiter).x
            est = torch.linalg.vector_norm(fom.apply(mu, u_s) - f)
            err = float(torch.linalg.vector_norm(u_e - u_s))
            bound = float(fom.total_error_bound(mu, u_s, est, lam_bounds, eps=eps))
            assert err <= bound * (1 + 1e-9), (maxiter, err, bound)
            assert bound <= 1e5 * max(err, 1e-14)


def test_3d_family_matches_jax():
    """The 3-D family at grid 6 (``tests/test_eim.py``'s ranges, 3^4 = 81
    training bumps, tol 1e-2: 44 terms, 2 reserve points): field, fit,
    theta, surrogate apply and terms as in 2-D; the lumped-mass hooks
    forward. About 5 s: the JAX greedy's 46 eager steps and its 3-D
    stencil's first compile."""
    kw = dict(center_range=(0.4, 0.6), width_range=(0.2, 0.35))
    jexact = jna.gaussian_bump_fom3d(6, dtype=jnp.float64, **kw)
    texact = tna.gaussian_bump_fom3d(6, dtype=torch.float64, device="cpu", **kw)
    j = jna.EimStencilFOM.from_training(jexact, jexact.parameter_space.sample_uniformly(3),
                                        tol=1e-2, reserve=2)
    t = tna.EimStencilFOM.from_training(texact, texact.parameter_space.sample_uniformly(
        3, device="cpu", dtype=torch.float64), tol=1e-2, reserve=2)
    assert_same_fit(t, j)
    (jmu,), (tmu,) = _mus(1, 8, dim=4)
    u = np.random.RandomState(9).standard_normal(t.solution_shape)
    ut, uj = torch.tensor(u), jnp.asarray(u)
    assert rel(texact.kappa(tmu), jexact.kappa(jmu)) < 1e-12
    assert rel(t.theta_vector(tmu), j.theta_vector(jmu)) < 1e-12
    assert rel(t.apply(tmu, ut), j.apply(jmu, uj)) < 1e-12
    assert rel(t.apply_terms(ut)[-1], j.apply_term(t.n_terms - 1, uj)) < 1e-12
    assert rel(t.mass_apply_grid(ut), j.mass_apply_grid(uj)) < 1e-12
    assert rel(t.mass_diag_grid(), j.mass_diag_grid()) < 1e-12
    assert rel(t.output(ut), j.output(uj)) < 1e-12


@pytest.fixture(scope="module")
def driver_runs(fit16):
    """Three greedy steps on the grid-16 fit's first 12 terms (+4 reserve:
    the greedy is hierarchical, and the JAX step unrolls 12 term applies,
    not 86), Jacobi-CG, Galerkin, the SRHT plan of ``fold_in(key, 0)``
    carried into the port's steps: the JAX step and the port's with
    ``score='exact'`` and the EIM model-error bound, and the port's with
    ``score='sketched'``. Over 5 s: the JAX step's build (its rhs sketch
    compiled) and its compile."""
    j, t = (type(f)(f.exact, f.interpolant.truncate(12, 4), f.kappa_floor) for f in fit16)
    key = jax.random.key(0)
    kw = dict(k=K, r_max=R_MAX, cg_tol=1e-10, cg_maxiter=800, cg_precond="jacobi",
              sketch="srht")
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dof", "mu"))
    js, jstep = jax_make_step(j, mesh, key, score="exact", model_error=j.model_error_bound,
                              **kw)
    replicated = NamedSharding(mesh, PartitionSpec())
    js = jax.device_put(js, replicated)
    n = t.exact.n_dof
    signs, sampling, _ = jax_srht_plan(jax.random.fold_in(key, 0), n, K)
    emb = SrhtEmbedding.from_plan(n, K, np.array(signs), np.array(sampling), device="cpu")
    ts, tstep = make_sharded_greedy_step(t, embedding=emb, score="exact",
                                         model_error=t.model_error_bound, **kw)
    ss, sstep = make_sharded_greedy_step(t, embedding=emb, score="sketched", **kw)
    with mesh:
        jit_step = jax.jit(jstep)
    jm, tm = _mus(STEPS, 1)
    rows = _rows(6, 2)
    jb, tb = {"bump": jnp.asarray(rows)}, {"bump": torch.tensor(rows)}
    ests = []
    for i in range(STEPS):
        with mesh:
            js, jest, ju = jit_step(js, jm[i], jb)
        # the state as the first call took it: the returned one (its basis
        # fields threaded as ``aux``) would compile the step anew
        js = jax.device_put(js, replicated)
        ts, test, tu = tstep(ts, tm[i], tb)
        ss, sest, su = sstep(ss, tm[i], tb)
        assert rel(tu, ju) < 1e-10 and torch.equal(su, tu)
        ests.append((test, jest, sest))
    return t, tb, js, ts, ss, ests


def test_greedy_step_on_the_surrogate_matches_jax(driver_runs):
    """``score='exact'`` with the model-error bound (each estimate the true
    surrogate residual plus the EIM bound of the candidate's grid), three
    steps on the EIM FOM: snapshots and the final state to 1e-10, the
    estimates to 1e-9 relative of the JAX package's; the basis grew and the
    median estimate dropped."""
    _, _, js, ts, _, ests = driver_runs
    assert int(ts.ncols) == int(js.ncols) == STEPS
    for name in ("srb", "res_lhs", "res_rhs", "out", "U"):
        assert rel(getattr(ts, name), getattr(js, name)) < 1e-10, name
    for test, jest, _ in ests:
        assert torch.isfinite(test).all()
        assert rel(test, jest) < 1e-9
    assert float(ests[-1][0].median()) < float(ests[0][0].median())


def test_sketched_score_on_the_surrogate_is_its_roms_estimate(driver_runs):
    """``score='sketched'`` on the same steps (port only; the state is the
    exact run's, held to the JAX package above): each step's estimates are
    the sketched residual norms of the ROM that ``state_to_rom`` ships at
    that basis size, whose coefficients are the shared magic-point solve,
    to 1e-10; the median drops."""
    fom, tb, _, ts, ss, ests = driver_runs
    for name in ("srb", "res_lhs", "res_rhs", "out"):
        assert rel(getattr(ss, name), getattr(ts, name)) < 1e-12, name
    rom = state_to_rom(fom, ss)
    assert rel(rom.estimate_error(tb, rom.solve(tb)), ests[-1][2]) < 1e-10
    assert float(ests[-1][2].median()) < float(ests[0][2].median())


def test_large_scale_demo_nonaffine_on_the_cpu(capsys):
    """``run(family='nonaffine')`` at grid 16 on the CPU: the EIM line, the
    indicator and margin over the batch (every candidate kept has a
    positive margin and surrogate minimum; the screened draws are listed),
    2 steps, the ROM
    served; the readings in ``out['eim']``. Its certificate (``--bounds``:
    ``certify``): the unit-stiffness enclosure's lower edge the dense
    lambda_min(K_1 | interior) on its safe side, certified, and finite
    positive total bounds; without a card, a call that names no device
    raises."""
    from rla4mor_tpu_torch.examples import large_scale_demo as demo

    res = demo.run(grid=GRID, steps=2, k=K, precond="mg", sketch="srht", device="cpu",
                   family="nonaffine", requests=8, serve_size=8, select="greedy")
    eim = res["eim"]
    assert eim["terms"] == 86 and eim["reserve"] == 4 and eim["kappa_floor"] > 0
    assert eim["label"] == "training sup err" and {"fields_s", "greedy_s"} <= eim.keys()
    assert eim["margin_min"] > 0 and eim["kappa_min"] > 0
    assert float(res["fom"].ellipticity_margin(res["mu_batch"]).min()) > 0
    assert float(res["fom"].kappa_min(res["mu_batch"]).min()) > 0
    assert eim["screened"]  # grid 16 has candidates outside the surrogate's elliptic set
    for seed, draw, margin, low in eim["screened"]:
        assert margin <= 0 or low <= 0
        mu = res["fom"].sample_parameters(draw + 1, seed)[draw]
        assert abs(float(res["fom"].kappa_min(mu)) - low) < 1e-12
    assert int(res["state"].ncols) == 2 and res["cg_iters"][-1] < 300
    out = capsys.readouterr().out
    assert "EIM offline: 86 terms" in out and "EIM kappa indicator over the mu batch" in out
    b = demo.certify(res, True, log=lambda line: None)
    from rla4mor_tpu_torch.models import StencilThermalBlock

    K1 = StencilThermalBlock((1, 1), GRID, dtype=torch.float64, device="cpu")
    n = (GRID + 1) ** 2
    A = K1.apply_term(0, torch.eye(n, dtype=torch.float64).reshape(n, GRID + 1, GRID + 1))
    inner = K1.rhs().reshape(-1) > 0
    lam = float(torch.linalg.eigvalsh(A.reshape(n, n)[inner][:, inner])[0])
    assert b["certified"] and 0 < b["lam"][0] <= lam and lam - b["lam"][0] < 1e-2 * lam
    assert bool(np.isfinite(b["bounds"]).all() and (b["bounds"] > 0).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            demo.run(grid=GRID, steps=1, family="nonaffine")
