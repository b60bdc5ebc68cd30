"""The port's certified optimisation (``mor/optimize.py``) held against the
JAX package (float64, CPU), and its oracles on the port alone.

The JAX exact-sketch ROM (``IdentityEmbedding``) on snapshots at numpy
parameters is carried into the port by the JAX ``save_rom`` and the port's
``load_rom``. The multi-start PGD runs from the same ``x0`` rows in both
packages (their random starts come from different generators), so every
start's final iterate and value agree; the enrich-at-the-optimum and
trust-region loops on the exact reductor draw nothing and take the same
steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.mor as jmor
from rla4mor_tpu.mor.serialization import save_rom as jax_save_rom
from rla4mor_tpu.ops import IdentityEmbedding as JaxIdentity

import rla4mor_tpu_torch.models as tm
import rla4mor_tpu_torch.mor as tmor
from rla4mor_tpu_torch.ops.embeddings import IdentityEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)
CPU = dict(device="cpu")
F64 = dict(dtype=torch.float64, device="cpu")
X0 = np.array([[0.2, 0.2, 0.2, 0.2], [0.9, 0.3, 0.6, 0.4], [0.5, 0.5, 0.5, 0.5]])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_exact(fom):
    Ru = fom.h1_0_product
    theta = JaxIdentity(fom.solution_dim, sqrt_product=Ru.sqrt)
    return jmor.SketchedReductor(fom, embedding_primal=theta,
                                 embedding_online=JaxIdentity(theta.range_dim),
                                 product=Ru, orthonormalize=True, log_level=30)


def _port_exact(fom):
    Ru = fom.h1_0_product
    theta = IdentityEmbedding(fom.solution_dim, sqrt_product=Ru.sqrt, **CPU)
    return tmor.SketchedReductor(fom, embedding_primal=theta,
                                 embedding_online=IdentityEmbedding(theta.range_dim, **CPU),
                                 product=Ru, orthonormalize=True, log_level=30)


@pytest.fixture(scope="module")
def block(thermal_fom, tmp_path_factory):
    """Both thermal blocks (2x2, grid 16), the JAX exact ROM on 6 snapshots
    at numpy parameters and its port copy, and each package's coercivity."""
    jf = thermal_fom
    tf = tm.ThermalBlockFOM((2, 2), 16, **CPU)
    rows = np.random.RandomState(7).uniform(0.1, 1.0, size=(6, 4))
    red = _jax_exact(jf)
    red.extend_basis(jf.solve_many([{"diffusion": jnp.asarray(r)} for r in rows]))
    jrom = red.reduce()
    path = tmp_path_factory.mktemp("opt") / "rom.npz"
    jax_save_rom(jrom, path)
    return {"jf": jf, "tf": tf, "jrom": jrom, "trom": tmor.load_rom(path, **CPU),
            "jalpha": jmor.MinThetaCoercivity(jf, {"diffusion": jnp.ones(4)}),
            "talpha": tmor.MinThetaCoercivity(tf, {"diffusion": torch.ones(4, **F64)})}


def test_parse_flat_and_batched(thermal_fom):
    """``ParameterSpace.parse``: a vector becomes a Mu, rows a batched Mu, the
    leaves views of the input (gradients flow back)."""
    space = tm.ThermalBlockFOM((2, 2), 4, **CPU).parameter_space
    x = torch.arange(4.0, dtype=torch.float64)
    assert torch.equal(space.parse(x)["diffusion"], x)
    X = torch.rand(5, 4, dtype=torch.float64, requires_grad=True)
    mu = space.parse(X)
    assert mu["diffusion"].shape == (5, 4)
    mu["diffusion"].sum().backward()
    assert torch.equal(X.grad, torch.ones_like(X))
    jmu = thermal_fom.parameter_space.parse(jnp.arange(4.0))
    assert np.array_equal(np.asarray(jmu["diffusion"]), _np(space.parse(x)["diffusion"]))


def test_output_gradient_matches_jax(block):
    """Value and gradient of the reduced output by autograd equal the JAX
    package's ``value_and_grad`` to 1e-10, for one vector and for rows."""
    jvg = jmor.output_gradient(block["jrom"], block["jf"].parameter_space)
    tvg = tmor.output_gradient(block["trom"], block["tf"].parameter_space)
    for x in X0:
        jv, jg = jvg(jnp.asarray(x))
        tv, tg = tvg(torch.tensor(x))
        assert abs(float(tv) - float(jv)) <= 1e-10 * abs(float(jv))
        np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-10, atol=1e-14)
    tv, tg = tvg(torch.tensor(X0))
    assert tv.shape == (3,) and tg.shape == (3, 4)
    np.testing.assert_allclose(_np(tg[1]), np.asarray(jvg(jnp.asarray(X0[1]))[1]),
                               rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("target", [None, "track"])
def test_minimize_scalar_matches_jax(block, target):
    """The batched multi-start PGD from the same x0 rows: every start's final
    iterate and value equal the JAX ``vmap(scan)`` program's to 1e-8, for the
    output (minimum on the box corner) and a tracking objective (interior
    minima)."""
    jspace, tspace = block["jf"].parameter_space, block["tf"].parameter_space
    jobj = tobj = None
    if target == "track":
        c = 0.06
        jobj = lambda s, mu: (jnp.real(jnp.asarray(s).reshape(-1)[0]) - c) ** 2  # noqa: E731
        tobj = lambda s, mu: (s[..., 0].real - c) ** 2  # noqa: E731
    j = jmor.minimize_output(block["jrom"], jspace, objective=jobj, x0=jnp.asarray(X0),
                             iters=40)
    t = tmor.minimize_output(block["trom"], tspace, objective=tobj, x0=torch.tensor(X0),
                             iters=40)
    np.testing.assert_allclose(_np(t.xs), np.asarray(j.xs), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(t.values), np.asarray(j.values), rtol=1e-8, atol=1e-16)
    assert abs(t.value - j.value) <= 1e-8 * max(abs(j.value), 1e-12)
    assert abs(t.stationarity - j.stationarity) <= 1e-8
    assert t.xs.shape == (3, 4) and t.value == float(t.values.min())


def test_minimize_scalar_quadratic_and_nan_lanes():
    """The engine on a plain box-constrained quadratic: interior target hit,
    exterior target projected; a lane that ends at NaN never wins; all NaN
    raises."""
    space = tm.ThermalBlockFOM((2, 2), 4, **CPU).parameter_space
    for target in ([0.3, 0.8, 0.5, 0.2], [-1.0, 2.0, 0.4, 3.0]):
        tgt = torch.tensor(target, dtype=torch.float64)
        res = tmor.minimize_scalar(lambda x, t=tgt: ((x - t) ** 2).sum(-1), space,
                                   n_starts=3, iters=60, key=9, **CPU)
        assert float((res.x - tgt.clamp(space.low, space.high)).abs().max()) <= 1e-8
        assert res.stationarity <= 1e-8

    def nan_first(x):
        f = ((x - 0.5) ** 2).sum(-1)
        return torch.where(x[..., 0] < 0.3, torch.full_like(f, float("nan")), f)

    res = tmor.minimize_scalar(nan_first, space, x0=torch.tensor(X0), iters=10)
    assert torch.isnan(res.values[0]) and res.value <= 1e-12
    with pytest.raises(FloatingPointError):
        tmor.minimize_scalar(lambda x: x.sum(-1) * float("nan"), space, n_starts=2,
                             iters=2, **CPU)


def test_certified_minimize_matches_jax(block):
    """Enrich-at-the-optimum from one snapshot off the uniform line (exact
    reductors, carried x0): the same rounds (basis sizes, enrichments), each
    round's J to 1e-8 and its bound to 1e-6 where it is above rounding
    (1e-12 of J), and the certificate holds the FOM output at mu*."""
    jf, tf = block["jf"], block["tf"]
    mu0 = [0.15, 0.9, 0.3, 0.7]
    jred, tred = _jax_exact(jf), _port_exact(tf)
    jmu0, tmu0 = {"diffusion": jnp.asarray(mu0)}, {"diffusion": torch.tensor(mu0, **F64)}
    jred.extend_basis(jf.solve(jmu0), mu=jmu0)
    tred.extend_basis(tf.solve(tmu0), mu=tmu0)
    kw = dict(tol=1e-12, iters=60, seed=2, log_level=30)
    j = jmor.certified_minimize(jf, jred, block["jalpha"], x0=jnp.asarray(X0), **kw)
    t = tmor.certified_minimize(tf, tred, block["talpha"], x0=torch.tensor(X0), **kw)
    assert t.converged and j.converged and t.n_enrichments >= 1
    assert t.n_enrichments == j.n_enrichments
    assert [h["basis_size"] for h in t.history] == [h["basis_size"] for h in j.history]
    for th, jh in zip(t.history, j.history):
        assert abs(th["value"] - jh["value"]) <= 1e-8 * abs(jh["value"])
        if jh["bound"] > 1e-12 * abs(jh["value"]):
            assert abs(th["bound"] - jh["bound"]) <= 1e-6 * jh["bound"]
    assert abs(t.value - j.value) <= 1e-8 * abs(j.value) and t.bound <= 1e-12
    s_fom = float(tf.output(tf.solve(t.mu), t.mu).reshape(-1)[0])
    assert abs(s_fom - t.value) <= max(t.bound, 1e-15) * (1 + 1e-12)
    assert t.stability_certified


def test_trust_region_matches_jax(block):
    """Trust-region RB on the thermal block with the exact reductor (nothing
    drawn): J*, the FOM-solve and step counts and the bound (to 1e-6 where
    the JAX one is above 1e-12 |J*|, else both below it) equal the JAX
    package's; the optimum is the all-high corner and the certificate holds
    the FOM output there."""
    jf, tf = block["jf"], block["tf"]
    j = jmor.trust_region_minimize(jf, _jax_exact(jf), block["jalpha"], tol=1e-8,
                                   log_level=30)
    t = tmor.trust_region_minimize(tf, _port_exact(tf), block["talpha"], tol=1e-8,
                                   log_level=30)
    assert t.converged and j.converged
    assert (t.n_fom_solves, t.n_steps) == (j.n_fom_solves, j.n_steps)
    assert abs(t.value - j.value) <= 1e-8 * abs(j.value)
    # the bound relatively where it is above rounding, else the port's at
    # rounding level too (the exact basis spans the optimum)
    if j.bound > 1e-12 * abs(j.value):
        assert abs(t.bound - j.bound) <= 1e-6 * j.bound
    else:
        assert t.bound <= 1e-12 * abs(j.value)
    assert bool((t.x >= tf.parameter_space.high - 1e-6).all())
    s_fom = float(tf.output(tf.solve(t.mu), t.mu).reshape(-1)[0])
    assert abs(s_fom - t.value) <= max(t.bound, 1e-15) * (1 + 1e-12)


def test_output_dual_norm_and_bound_are_rigorous(block):
    """theta^H G theta equals the dense ``c R^-1 c^H``; with the exact
    estimator |s_fom - s_rom| <= ||l|| eta / alpha at every sampled mu, and
    the bound is the dual norm times the state bound."""
    tf = block["tf"]
    Ru = tf.h1_0_product
    dual = tmor.OutputDualNorm(tf, product=Ru)
    c = _np(tf.output_functional.stack[0, 0])
    expected = float(np.sqrt(c @ Ru.inv.apply_host(c)))
    mus = tf.parameter_space.sample_randomly(3, seed=21, **CPU)
    rom = block["trom"]
    for mu in mus:
        assert abs(float(dual(mu)) - expected) <= 1e-12 * expected
        u_r = rom.solve(mu)
        bound = float(tmor.output_error_bound(rom, mu, block["talpha"], dual, u_r=u_r))
        state = float(tmor.error_bound(rom, mu, block["talpha"], u_r=u_r))
        assert abs(bound - expected * state) <= 1e-12 * bound
        err = abs(float(tf.output(tf.solve(mu), mu)[0]) - float(rom.output(u_r, mu)[0]))
        assert err <= bound * (1 + 1e-12)
    const = tmor.ConstantDualNorm(2.0)
    batch = {"diffusion": torch.rand(5, 4, **F64)}
    assert const(batch).shape == (5,) and float(const(mus[0])) == 2.0


def test_trust_region_gate_choked_enriches():
    """A tiny initial radius and a basis seeded off the uniform line choke the
    first subproblem: the loop spends a FOM solve at the iterate (never
    converging off a choked subproblem) and still converges (the port of the
    JAX package's oracle)."""
    tf = tm.ThermalBlockFOM((2, 2), 8, **CPU)
    red = _port_exact(tf)
    mu0 = {"diffusion": torch.tensor([0.15, 0.9, 0.3, 0.7], dtype=torch.float64)}
    red.extend_basis(tf.solve(mu0), mu=mu0)
    alpha = tmor.MinThetaCoercivity(tf, {"diffusion": torch.ones(4, **F64)})
    res = tmor.trust_region_minimize(tf, red, alpha, tol=1e-10, delta0=1e-8, seed=1,
                                     log_level=30)
    assert res.converged and res.bound <= 1e-10
    assert "enrich_at_iterate" in [h.get("action") for h in res.history]
    s_fom = float(tf.output(tf.solve(res.mu), res.mu).reshape(-1)[0])
    assert abs(s_fom - res.value) <= max(res.bound, 1e-15) * (1 + 1e-12)


def test_trust_region_fewer_fom_solves_on_the_bump_family():
    """On the non-affine bump family (MDEIM surrogate, exact reductor) the
    trust region reaches the certified optimum of enrich-at-the-optimum with
    strictly fewer FOM solves (the port of the JAX package's
    ``test_trust_region_fewer_fom_solves_than_certified_minimize``, at its
    grid 12)."""
    from rla4mor_tpu_torch.models.bump_host import bump_coercivity, bump_host_fom

    fom = bump_host_fom(nx=12, **CPU)
    alpha = bump_coercivity(fom)
    tol = 1e-10
    tr = tmor.trust_region_minimize(fom, _port_exact(fom), alpha, tol=tol, log_level=30)
    cm = tmor.certified_minimize(fom, _port_exact(fom), alpha, tol=tol, n_starts=4,
                                 iters=60, log_level=30)
    assert tr.converged and cm.converged and tr.bound <= tol and cm.bound <= tol
    assert tr.n_fom_solves < cm.n_enrichments + 1  # + the midpoint seed
    assert abs(tr.value - cm.value) <= 1e-8 * max(abs(cm.value), 1e-30)
    s_fom = float(fom.output(fom.solve(tr.mu), tr.mu).reshape(-1)[0])
    assert abs(s_fom - tr.value) <= max(tr.bound, 1e-15) * (1 + 1e-12)


def test_optimize_demo_runs_with_its_checks():
    """``optimize_demo.run`` at a small size (3x3 block at grid 12, the bump
    family at grid 8): its own checks (the certificate at mu*, both bump runs
    converged, the trust region's FOM solves at most enrich-at-the-optimum's)
    pass, and the output range is ordered."""
    from rla4mor_tpu_torch.examples import optimize_demo

    res = optimize_demo.run(intervals=12, k=100, k_online=60, starts=4, iters=40,
                            bump_nx=8, log=lambda line: None, **CPU)
    assert res["converged"] and res["bump"]["tr"]["converged"]
    assert res["range"][0] < res["range"][1] and res["tracking_residual"] <= 1e-12


def test_serving_and_sketched_rb_demos_run():
    """``online_serving_demo.run`` (grid 24, r = 6: served = per-parameter
    solves at batch 16, the hot swap keeps the shapes) and
    ``sketched_rb_demo.run`` (grid 16, 6 extensions: the max estimate falls)
    complete."""
    from rla4mor_tpu_torch.examples import online_serving_demo, sketched_rb_demo

    res = online_serving_demo.run(grid=24, snapshots=12, r=6, k=80, batches=(1, 16, 256),
                                  log=lambda line: None, **CPU)
    assert [row["batch"] for row in res["rows"]] == [1, 16, 256]
    assert res["check_dev"] <= 1e-4
    rb = sketched_rb_demo.run(grid=16, sketch_dim=100, extensions=6, training=30, test=40,
                              log=lambda line: None, **CPU)
    assert rb["basis"] == 6 and rb["max_estimates"][-1] < rb["max_estimates"][0]
