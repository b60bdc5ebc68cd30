"""The port's certified UQ (``mor/uq.py``) held against the JAX package
(float64, CPU), and its oracles on the port alone.

Both packages serve the same ROM: the JAX reductor (``IdentityEmbedding``,
so every certificate is a theorem) on snapshots at parameters drawn with
numpy, carried into the port by the JAX ``save_rom`` and the port's
``load_rom``. Halton designs are scipy's sequence under the same integer
key in both packages, so the samples, the per-sample certificates, the
moments, the Sobol indices and the exceedance brackets agree to 1e-10. The
port's Monte-Carlo stream is its own (Philox by global sample index): its
tests hold batch invariance and the FOM truth on the port's samples.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.models as jm
import rla4mor_tpu.mor as jmor
import rla4mor_tpu.mor.uq as juq
from rla4mor_tpu.core.affine import AffineDense as JaxAffineDense
from rla4mor_tpu.core.parameters import ONE as JONE
from rla4mor_tpu.mor.serialization import save_rom as jax_save_rom
from rla4mor_tpu.ops import IdentityEmbedding as JaxIdentity

import rla4mor_tpu_torch.models as tm
import rla4mor_tpu_torch.mor as tmor
import rla4mor_tpu_torch.mor.uq as tuq
from rla4mor_tpu_torch.core import ONE, AffineDense, mu_unstack
from rla4mor_tpu_torch.mor.optimize import make_objective
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)
CPU = dict(device="cpu")
TOL = 1e-10


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _mus(count, seed, d=4):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, d))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


@pytest.fixture(scope="module")
def stationary(thermal_fom, tmp_path_factory):
    """The JAX exact-sketch ROM on 8 snapshots (thermal block 2x2, grid 16)
    and its port copy, with each package's min-theta coercivity and output
    dual norm."""
    jf = thermal_fom
    tf = tm.ThermalBlockFOM((2, 2), 16, **CPU)
    jRu = jf.h1_0_product
    theta = JaxIdentity(jf.solution_dim, sqrt_product=jRu.sqrt)
    jred = jmor.SketchedReductor(jf, embedding_primal=theta,
                                 embedding_online=JaxIdentity(theta.range_dim),
                                 product=jRu, orthonormalize=True, log_level=30)
    jmus, _ = _mus(8, 3)
    jred.extend_basis(jf.solve_many(jmus))
    jrom = jred.reduce()
    path = tmp_path_factory.mktemp("uq") / "rom.npz"
    jax_save_rom(jrom, path)
    trom = tmor.load_rom(path, **CPU)
    jalpha = jmor.MinThetaCoercivity(jf, {"diffusion": jnp.ones(4)})
    talpha = tmor.MinThetaCoercivity(tf, {"diffusion": torch.ones(4, dtype=torch.float64)})
    jdual = jmor.OutputDualNorm(jf, product=jRu)
    tdual = tmor.OutputDualNorm(tf, product=tf.h1_0_product)
    return {"jf": jf, "tf": tf, "jrom": jrom, "trom": trom, "jalpha": jalpha,
            "talpha": talpha, "jdual": jdual, "tdual": tdual}


def _both(st):
    return ((st["jrom"], st["jf"].parameter_space, st["jalpha"], st["jdual"]),
            (st["trom"], st["tf"].parameter_space, st["talpha"], st["tdual"]))


def test_halton_samples_match_jax(thermal_fom):
    """Halton points with an integer key, offset into the same sequence, are
    the JAX package's; MC draws are in the box, deterministic, and sample
    ``offset + i`` does not depend on the batching."""
    jspace = thermal_fom.parameter_space
    tspace = tm.ThermalBlockFOM((2, 2), 4, **CPU).parameter_space
    for offset in (0, 8):
        j = juq.sample_mu_batched(jspace, 16, key=7, method="halton", offset=offset)
        t = tuq.sample_mu_batched(tspace, 16, key=7, method="halton", offset=offset, **CPU)
        assert t["diffusion"].shape == (16, 4) and t["diffusion"].dtype == torch.float64
        assert rel(t["diffusion"], j["diffusion"]) <= TOL
    a = tuq.sample_mu_batched(tspace, 16, key=5, **CPU)["diffusion"]
    assert torch.equal(a, tuq.sample_mu_batched(tspace, 16, key=5, **CPU)["diffusion"])
    assert float(a.min()) >= tspace.low and float(a.max()) <= tspace.high
    tail = tuq.sample_mu_batched(tspace, 8, key=5, offset=8, **CPU)["diffusion"]
    assert torch.equal(a[8:], tail)
    other = tuq.sample_mu_batched(tspace, 16, key=6, **CPU)["diffusion"]
    assert not torch.equal(a, other)
    # a wide draw looks uniform: mean 0.55, std 0.9 / sqrt(12) a coordinate
    big = tuq.sample_mu_batched(tspace, 20000, key=1, **CPU)["diffusion"]
    assert abs(float(big.mean()) - 0.55) < 5e-3
    assert abs(float(big.std()) - 0.9 / math.sqrt(12)) < 5e-3


def test_stationary_output_and_bound_match_jax(stationary):
    """Per sample (s, eta_s) of the stationary dispatch on one Halton batch,
    and the output dual norm itself, to 1e-10."""
    (jrom, jspace, jalpha, jdual), (trom, tspace, talpha, tdual) = _both(stationary)
    jmus = juq.sample_mu_batched(jspace, 64, key=3, method="halton")
    tmus = tuq.sample_mu_batched(tspace, 64, key=3, method="halton", **CPU)
    js, je = juq._batched_output_and_bound(jrom, jalpha, jdual, 0)(jmus)
    ts, te = tuq._batched_output_and_bound(trom, talpha, tdual, 0)(tmus)
    assert rel(ts, js) <= TOL and rel(te, je) <= TOL
    jrows = [{"diffusion": row} for row in jmus["diffusion"]]
    assert rel(tdual(tmus), np.array([float(jdual(m)) for m in jrows])) <= TOL


def test_certified_moments_match_jax(stationary):
    """certified_moments by Halton: mean, std, bias and variance bounds to
    1e-10 (two batches of 48); with ``output_range`` the total interval of
    unreplicated QMC stays NaN in both, and the empirical-Bernstein term is
    the JAX package's formula."""
    (jrom, jspace, jalpha, jdual), (trom, tspace, talpha, tdual) = _both(stationary)
    kw = dict(n=96, key=11, method="halton", batch=48)
    j = jmor.certified_moments(jrom, jspace, jalpha, jdual, **kw)
    t = tmor.certified_moments(trom, tspace, talpha, tdual, **kw)
    for f in ("mean", "std", "bias_bound", "var_bias_bound", "mean_eta"):
        assert rel(getattr(t, f), getattr(j, f)) <= TOL, f
    assert t.n == j.n == 96 and math.isnan(t.mc_stderr) and t.stability_certified
    rng = (j.mean - 10 * j.std, j.mean + 10 * j.std)
    j = jmor.certified_moments(jrom, jspace, jalpha, jdual, output_range=rng, **kw)
    t = tmor.certified_moments(trom, tspace, talpha, tdual, output_range=rng, **kw)
    np.testing.assert_allclose([t.total_lo, t.total_hi, t.conf_term],
                               [j.total_lo, j.total_hi, j.conf_term], rtol=TOL)
    assert math.isnan(t.total_lo)
    for args in ((2.5e-3, 64, 0.3, 0.05), (0.0, 5, 1.0, 0.01), (1.0, 1, 1.0, 0.05)):
        assert tuq._empirical_bernstein(*args) == juq._empirical_bernstein(*args)


def test_sobol_indices_match_jax(stationary):
    """Plain Sobol indices of the ROM output on the same Halton design, and
    the certified brackets, to 1e-10."""
    (jrom, jspace, jalpha, jdual), (trom, tspace, talpha, tdual) = _both(stationary)
    jA, jB = juq._pick_freeze_points(jspace, 64, 4, "halton")
    tA, tB = tuq._pick_freeze_points(tspace, 64, 4, "halton")
    assert rel(tA, jA) <= TOL and rel(tB, jB) <= TOL
    j = jmor.sobol_indices(jmor.make_objective(jrom, jspace), jspace, n=256, key=3)
    t = tmor.sobol_indices(make_objective(trom, tspace), tspace, n=256, key=3, batch=100,
                           **CPU)
    assert t.names == j.names
    for f in ("first", "total", "variance"):
        assert rel(getattr(t, f), getattr(j, f)) <= TOL, f
    j = jmor.certified_sobol_indices(jrom, jspace, jalpha, jdual, n=48, key=21)
    t = tmor.certified_sobol_indices(trom, tspace, talpha, tdual, n=48, key=21, batch=40)
    assert t.certified == j.certified
    for f in ("first", "total", "first_lo", "first_hi", "total_lo", "total_hi",
              "variance", "var_lo", "var_hi", "center"):
        assert rel(getattr(t, f), getattr(j, f)) <= TOL, f


def test_exceedance_matches_jax(stationary):
    """The Halton exceedance bracket: p_lo, p_hi and p_nominal are the JAX
    package's (counts of the same samples)."""
    (jrom, jspace, jalpha, jdual), (trom, tspace, talpha, tdual) = _both(stationary)
    c = jmor.certified_moments(jrom, jspace, jalpha, jdual, n=64, key=4).mean
    kw = dict(threshold=c, n=80, key=13, method="halton", batch=32)
    j = jmor.exceedance_probability(jrom, jspace, jalpha, jdual, **kw)
    t = tmor.exceedance_probability(trom, tspace, talpha, tdual, **kw)
    assert (t.p_lo, t.p_hi, t.p_nominal, t.n) == (j.p_lo, j.p_hi, j.p_nominal, j.n)
    assert 0.0 <= t.p_lo < t.p_hi <= 1.0
    assert math.isnan(t.conf_term) and math.isnan(t.p_lo_total)


def _fom_outputs(tf, mus):
    return np.array([float(tf.output(tf.solve(mu), mu).reshape(-1)[0])
                     for mu in mu_unstack(mus)])


def test_mc_moments_batch_invariant_and_bracket_the_fom(stationary):
    """The port's MC stream: batching changes nothing; the FOM Monte-Carlo
    mean and variance of the same samples lie in the certified brackets; the
    FOM exceedance probability lies in the bracket; the Hoeffding total
    bracket is finite."""
    st = stationary
    trom, tf, talpha, tdual = st["trom"], st["tf"], st["talpha"], st["tdual"]
    space = tf.parameter_space
    a = tmor.certified_moments(trom, space, talpha, tdual, n=48, key=2, batch=48)
    b = tmor.certified_moments(trom, space, talpha, tdual, n=48, key=2, batch=16)
    assert abs(a.mean - b.mean) <= 1e-12 * max(1.0, abs(a.mean))
    assert abs(a.std - b.std) <= 1e-12 and abs(a.bias_bound - b.bias_bound) <= 1e-14

    n = 64
    res = tmor.certified_moments(trom, space, talpha, tdual, n=n, key=11, batch=32)
    assert res.n == n and res.method == "mc" and res.mc_stderr > 0
    s_fom = _fom_outputs(tf, tuq.sample_mu_batched(space, n, key=11, **CPU))
    assert abs(s_fom.mean() - res.mean) <= res.bias_bound + 1e-12
    assert abs(s_fom.var(ddof=1) - res.std ** 2) <= res.var_bias_bound + 1e-12

    c = float(np.median(s_fom))
    exc = tmor.exceedance_probability(trom, space, talpha, tdual, threshold=c, n=n,
                                      key=11, batch=32)
    assert 0.0 <= exc.p_lo <= exc.p_nominal <= exc.p_hi <= 1.0
    p_fom = float((s_fom > c).mean())
    assert exc.p_lo - 1e-12 <= p_fom <= exc.p_hi + 1e-12
    assert 0.0 <= exc.p_lo_total <= exc.p_lo and exc.p_hi <= exc.p_hi_total <= 1.0

    # an a-priori range: the MC total interval holds the FOM mean; a range
    # the samples escape raises
    rng = (res.mean - 10 * res.std, res.mean + 10 * res.std)
    tot = tmor.certified_moments(trom, space, talpha, tdual, n=n, key=11,
                                 output_range=rng)
    assert tot.total_lo <= s_fom.mean() <= tot.total_hi
    rq = tmor.certified_moments(trom, space, talpha, tdual, n=64, key=11,
                                method="halton", replicates=4, output_range=rng)
    assert math.isfinite(rq.conf_term) and math.isfinite(rq.replicate_stderr)
    with pytest.raises(ValueError, match="output_range"):
        tmor.certified_moments(trom, space, talpha, tdual, n=16, key=5,
                               output_range=(0.0, 1e-300))


def test_stability_certified_propagates():
    """A coercivity callable carrying ``certified = False`` surfaces as
    ``stability_certified = False`` in every UQ result; a plain callable
    gives True (the port of the JAX package's
    ``test_stability_certified_propagates_to_uq``, whose ROM is a Gaussian
    sketch of 3 snapshots)."""
    fom = tm.ThermalBlockFOM((2, 2), 8, **CPU)
    space = fom.parameter_space
    emb = GaussianEmbedding(40, fom.solution_dim, seed=0, **CPU)
    red = tmor.SketchedReductor(fom, embedding_primal=emb, log_level=30)
    red.extend_basis(fom.solve_many(space.sample_randomly(3, seed=0, **CPU)))
    rom = red.reduce()
    dual = tmor.ConstantDualNorm(1.0)

    def coercivity(mu):
        return torch.tensor(0.1, dtype=torch.float64)

    kw = dict(n=8, batch=8)
    assert tmor.certified_moments(rom, space, coercivity, dual, **kw).stability_certified
    coercivity.certified = False
    assert not tmor.certified_moments(rom, space, coercivity, dual, **kw).stability_certified
    assert not tmor.exceedance_probability(rom, space, coercivity, dual, threshold=0.0,
                                           **kw).stability_certified
    assert not tmor.certified_sobol_indices(rom, space, coercivity, dual, n=8,
                                            batch=8).stability_certified


NX, NT = 8, 10


def _localized(fom, port: bool):
    """The mean over the lower-left 3x3 interior patch (non-compliant)."""
    w = np.zeros((NX - 1, NX - 1))
    w[:3, :3] = 1.0
    stack = w.reshape(1, 1, -1) / w.sum()
    fom.output_functional = (AffineDense(torch.tensor(stack), (ONE,)) if port
                             else JaxAffineDense(jnp.asarray(stack), (JONE,)))
    return fom


@pytest.fixture(scope="module")
def parabolic(tmp_path_factory):
    """``tests/test_uq.py``'s parabolic setup (grid 8, nt 10, implicit Euler,
    the localized output, the exact identity estimator, 3 extensions of 2
    modes at numpy parameters): the JAX goal-oriented composite and its port
    copy, with each package's min-theta coercivity in the h1_0 norm."""
    jf = _localized(jm.instationary_thermal_block((2, 2), NX, T=0.5, nt=NT), port=False)
    tf = _localized(tm.instationary_thermal_block((2, 2), NX, T=0.5, nt=NT, **CPU), port=True)
    jRu = jf.products["h1_0"]
    emb = JaxIdentity(jf.solution_dim, sqrt_product=jRu.sqrt)
    red = jm.InstationaryPrimalDualReductor(jf, embedding=emb, product=jRu, log_level=30)
    for mu in _mus(3, 1)[0]:
        red.extend(mu, modes_per_extension=2)
    jrom = red.reduce()
    path = tmp_path_factory.mktemp("uq") / "parabolic.npz"
    jax_save_rom(jrom, path)
    trom = tmor.load_rom(path, **CPU)
    jalpha = jmor.MinThetaCoercivity(jf, {"diffusion": jnp.ones(4)}, product=jRu)
    talpha = tmor.MinThetaCoercivity(tf, {"diffusion": torch.ones(4, dtype=torch.float64)},
                                     product=tf.products["h1_0"])
    return {"jf": jf, "tf": tf, "jrom": jrom, "trom": trom, "jalpha": jalpha,
            "talpha": talpha}


def test_parabolic_output_and_bound_match_jax(parabolic):
    """The parabolic corrected-output dispatch: per sample (s_c, eta_s) on
    one Halton batch to 1e-10, and the certified moments and exceedance
    bracket with ``dual_norm=None``."""
    p = parabolic
    jspace, tspace = p["jf"].parameter_space, p["tf"].parameter_space
    jmus = juq.sample_mu_batched(jspace, 24, key=5, method="halton")
    tmus = tuq.sample_mu_batched(tspace, 24, key=5, method="halton", **CPU)
    js, je = juq._batched_output_and_bound(p["jrom"], p["jalpha"], None, 0)(jmus)
    ts, te = tuq._batched_output_and_bound(p["trom"], p["talpha"], None, 0)(tmus)
    assert rel(ts, js) <= TOL and rel(te, je) <= TOL
    kw = dict(n=24, key=5, method="halton", batch=12)
    j = jmor.certified_moments(p["jrom"], jspace, p["jalpha"], None, **kw)
    t = tmor.certified_moments(p["trom"], tspace, p["talpha"], None, **kw)
    for f in ("mean", "std", "bias_bound", "var_bias_bound"):
        assert rel(getattr(t, f), getattr(j, f)) <= TOL, f
    j = jmor.exceedance_probability(p["jrom"], jspace, p["jalpha"], None,
                                    threshold=j.mean, **kw)
    t = tmor.exceedance_probability(p["trom"], tspace, p["talpha"], None,
                                    threshold=j.threshold, **kw)
    assert (t.p_lo, t.p_hi, t.p_nominal) == (j.p_lo, j.p_hi, j.p_nominal)


def test_parabolic_fom_inside_the_certificates(parabolic):
    """The port alone: at 8 MC samples the FOM's final-time output lies
    within s_c +- eta_s (exact estimator: a theorem), the certified bias
    bound holds the FOM mean of the same samples, and the exceedance bracket
    holds the FOM probability."""
    p = parabolic
    tf, trom, talpha = p["tf"], p["trom"], p["talpha"]
    space = tf.parameter_space
    mus = tuq.sample_mu_batched(space, 8, key=11, **CPU)
    s_fom = np.array([float(tf.output_functional.apply(tf.solve(mu), mu)[0, -1])
                      for mu in mu_unstack(mus)])
    s_c, eta = tuq._batched_output_and_bound(trom, talpha, None, 0)(mus)
    assert np.all(eta > 0)  # coarse basis: the certificate is live
    assert np.all(np.abs(s_fom - s_c) <= eta * (1 + 1e-12))
    res = tmor.certified_moments(trom, space, talpha, None, n=8, key=11, batch=8)
    assert abs(s_fom.mean() - res.mean) <= res.bias_bound * (1 + 1e-12)
    exc = tmor.exceedance_probability(trom, space, talpha, None, threshold=res.mean, n=8,
                                      key=11, batch=8)
    p_fom = float((s_fom > res.mean).mean())
    assert exc.p_lo - 1e-12 <= p_fom <= exc.p_hi + 1e-12 and exc.p_hi - exc.p_lo < 1.0


def test_certified_uq_on_the_indefinite_family():
    """Certified UQ on the indefinite class (the port of the JAX package's
    ``test_certified_uq_on_indefinite_family``, there at grid 32): the minres
    ROM shipped by the sketched greedy, the Weyl beta_LB of the matrix-free
    inf-sup SCM (``weyl_bound``, analytic pair boxes) and the exact l2
    output dual norm h^2 sqrt(n). The certified mean-bias bracket holds the
    FOM Monte-Carlo mean of the same samples, and stays informative.
    Grid 16 keeps the wavenumber box between the same resonances; the
    LOBPCG runs in float64 alone (the two-stage float32 start costs 6 of
    this test's 7 s here)."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models import StencilHelmholtz
    from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmInfSup
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom

    fom = StencilHelmholtz(num_intervals=16, dtype=torch.float64, **CPU)
    state, step = make_sharded_greedy_step(fom, seed=0, k=96, r_max=6, cg_tol=1e-10,
                                           cg_maxiter=8000, sketch="gaussian",
                                           projection="minres")
    batch = mu_stack(fom.sample_parameters(6, key=1))
    for it in range(4):
        state, _, _ = step(state, fom.sample_parameters(1, key=20 + it)[0], batch)
    rom = state_to_rom(fom, state, projection="minres")

    scm = MatrixFreeScmInfSup(fom, tol=1e-9, iters=600, log_level=30, analytic_boxes=True)
    scm.fit([{"ksq": torch.tensor([v], dtype=torch.float64)}
             for v in (23.0, 28.0, 33.0, 38.0, 43.0)], tol=0.5, max_anchors=8)
    beta = scm.weyl_bound()
    dual = tmor.ConstantDualNorm(fom.h ** 2 * math.sqrt(math.prod(fom.solution_shape)))
    space = fom.parameter_space
    n_mc = 24
    res = tmor.certified_moments(rom, space, beta, dual, n=n_mc, key=11, batch=12)
    assert math.isfinite(res.bias_bound) and res.stability_certified == scm.certified
    mus = tuq.sample_mu_batched(space, n_mc, key=11, **CPU)
    s_fom = np.array([float(fom.output(fom.solve_bicgstab(mu, tol=1e-12, maxiter=20000)))
                      for mu in mu_unstack(mus)])
    assert abs(s_fom.mean() - res.mean) <= res.bias_bound * (1 + 1e-6)
    assert res.bias_bound < 10 * max(abs(res.mean), 1e-12)


def test_uq_demo_runs_with_its_checks():
    """``uq_demo.run`` at a small size (3x3 block at grid 12, the parabolic
    block at grid 8): its own checks (finite nonnegative bias bounds, the host
    FOM inside s +- eta_s, p_lo <= p_nominal <= p_hi) pass."""
    from rla4mor_tpu_torch.examples import uq_demo

    res = uq_demo.run(intervals=12, n=512, snapshots=10, k=100, k_online=60, batch=200,
                      sobol_n=128, check=16, parabolic_grid=8, parabolic_nt=10,
                      parabolic_extensions=2, parabolic_modes=2, parabolic_k=60,
                      parabolic_check=4, log=lambda line: None, **CPU)
    assert set(res["moments"]) == {"mc", "halton"} and res["r"] == 10
    assert res["fom_check"]["max_err_over_eta"] <= 1.0
    assert res["parabolic"]["max_err_over_eta"] <= 1.0
    assert len(res["sobol"]["top"]) == 3
    assert res["exceedance"]["p_lo"] <= res["exceedance"]["p_hi"]


def test_uq_demo_thermal3d_runs_with_its_checks():
    """``uq_demo.run_thermal3d`` at grid 8 (729 nodes): the greedy-shipped 3-D
    ROM, the certified l2 anchor (against a dense eigensolve of the interior
    operator), ``stability_certified`` carried into the UQ result, and the
    float64 FOM inside s +- eta_s."""
    from rla4mor_tpu_torch.examples import uq_demo
    from rla4mor_tpu_torch.models import StencilThermalBlock3D
    from rla4mor_tpu_torch.models.stencil3d import interior_mask3

    res = uq_demo.run_thermal3d(grid=8, k=64, steps=4, n=1024, batch=256, check=2,
                                log=lambda line: None, **CPU)
    assert res["certified"] and res["stability_certified"] and res["r"] == 4
    assert res["max_err_over_eta"] <= 1.0
    fom = StencilThermalBlock3D((2, 2, 2), 8, dtype=torch.float64, **CPU)
    mu = {"diffusion": torch.ones(8, dtype=torch.float64)}
    inner = interior_mask3(fom.n_nodes, torch.float64, "cpu").reshape(-1).bool()
    cols = torch.eye(fom.n_dof, dtype=torch.float64)[:, inner]
    A = torch.stack([fom.apply(mu, c.reshape(fom.solution_shape)).reshape(-1)
                     for c in cols.T], dim=1)[inner]
    lam = float(torch.linalg.eigvalsh(0.5 * (A + A.T))[0])
    assert res["alpha_ref"] <= lam <= res["alpha_ref"] + 2 * res["radius"] + 1e-12


def test_certified_uq_over_the_semilinear_rom():
    """The hyperreduced semilinear dispatch (``n_deim``): the certified bias
    bound holds the FOM Newton outputs' mean on the same Halton samples and
    is not vacuous (the port of ``tests/test_semilinear.py::
    test_certified_uq_over_semilinear_rom`` at grid 12: min-theta against a
    dense l2 anchor at diffusion 1, the exact l2 dual norm h^2 sqrt(n))."""
    from rla4mor_tpu_torch.models.semilinear import SemilinearStencilFOM
    from rla4mor_tpu_torch.mor import SemilinearReductor

    fom = SemilinearStencilFOM((2, 2), 12, dtype=torch.float64, reaction_scale=100.0,
                               **CPU)
    rows = np.random.RandomState(4).uniform(0.1, 1.0, size=(5, 5))
    snaps = torch.stack([fom.solve_newton({"diffusion": torch.tensor(r[:4]),
                                           "reaction": torch.tensor(r[4:])}).reshape(-1)
                         for r in rows], dim=1)
    rom = SemilinearReductor(fom).fit(None, snapshots=snaps, modes=3, deim_modes=4,
                                      n_reserve=2)
    n = fom.n_dof
    eye = torch.eye(n, dtype=torch.float64)
    A1 = sum(fom.linear.term_linop(b).apply(eye) for b in range(4)).numpy()
    mask = fom.mass_lumped_diag().reshape(-1).numpy() > 0
    alpha1 = float(np.linalg.eigvalsh(0.5 * (A1 + A1.T)[np.ix_(mask, mask)])[0])

    def coercivity(mu):
        return mu["diffusion"].amin(dim=-1) * alpha1

    dual = tmor.ConstantDualNorm(fom.h * fom.h * math.sqrt(n))
    n_s = 24
    res = tmor.certified_moments(rom, fom.parameter_space, coercivity, dual, n=n_s,
                                 method="halton", batch=n_s, key=0)
    mus = tuq.sample_mu_batched(fom.parameter_space, n_s, key=0, method="halton", **CPU)
    s_fom = [float(fom.output(fom.solve_newton(mu))) for mu in mu_unstack(mus)]
    assert abs(res.mean - float(np.mean(s_fom))) <= res.bias_bound * (1 + 1e-9)
    assert 0 < res.bias_bound <= 1.0


def test_sketch_refresh_wiring():
    """A deliberately tiny online sketch (k_online = 2) passed with
    ``reductor=`` is refreshed by ``reduce_adaptive`` (online_dim grows) or
    the result says ``certified=False``, never a silent trust; without a
    reductor nothing is reported (the port of ``tests/test_uq.py::
    test_sketch_refresh_wiring``)."""
    fom = tm.ThermalBlockFOM((2, 2), 8, **CPU)
    Ru = fom.h1_0_product
    theta = GaussianEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt, range_dim=40,
                                   seed=0, **CPU)
    red = tmor.SketchedReductor(fom, embedding_primal=theta,
                                embedding_online=GaussianEmbedding.make(40, range_dim=2,
                                                                        seed=1, **CPU),
                                product=Ru, orthonormalize=True, log_level=40)
    red.extend_basis(fom.solve_many(fom.parameter_space.sample_randomly(5, seed=3, **CPU)))
    rom = red.reduce()
    alpha = tmor.MinThetaCoercivity(fom, {"diffusion": torch.ones(4, dtype=torch.float64)})
    dual = tmor.OutputDualNorm(fom, product=Ru)
    res = tmor.certified_moments(rom, fom.parameter_space, alpha, dual, n=32, key=7,
                                 batch=32, reductor=red)
    info = res.sketch_info
    assert info is not None and (info["online_dim"] > 2 or not info["certified"])
    assert tmor.certified_moments(rom, fom.parameter_space, alpha, dual, n=8, key=7,
                                  batch=8).sketch_info is None
