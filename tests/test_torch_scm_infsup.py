"""The port's matrix-free inf-sup SCM (``mor/scm_matfree.py::
MatrixFreeScmInfSup``), the damped Helmholtz stencil family and the inf-sup
bounds flows, held against dense oracles and the JAX package (float64 /
complex128, CPU).

* ``StencilHelmholtzDamped`` (grid 16): apply, theta and Jacobi diagonal
  against the densified terms and the JAX family; its complex BiCGStab
  against a dense solve.
* The complex Re / Im pair expansion: ``alpha_exact`` equals the dense
  lambda_min(A^H A) on its safe side; after a fit the bounds bracket the
  dense sigma_min at held-out parameters; the defended fit (``restarts=1``,
  eigensolved boxes) is certified and its ``weyl_bound`` equals the JAX
  ``InfSupLowerBound`` at the same anchors: the port's counterpart of the
  JAX package's red ``test_complex_weyl_bound_jittable``.
* The real Helmholtz family: analytic pair boxes contain the dense pair
  spectra and the fitted bounds bracket sigma_min; ``fit_weyl_positive``
  turns an inf-producing anchor set into a positive Weyl bound, and
  ``weyl_gap_report`` measures it against the LP.
* ``large_scale_demo.run`` with ``family="helmholtz", bounds=True`` and
  ``family="lossy"`` end to end at grid 16 over 2 candidates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from rla4mor_tpu.models.stencil_helmholtz import StencilHelmholtzDamped as JaxDamped
from rla4mor_tpu.mor.bounds import InfSupLowerBound as JaxInfSup

from rla4mor_tpu_torch.models import StencilHelmholtz, StencilHelmholtzDamped
from rla4mor_tpu_torch.models.stencil import interior_mask
from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmInfSup

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)
GRID = 16


def _densify(fom):
    """K and M on the interior nodes, from the port's term applies."""
    n = fom.n_nodes ** 2
    eye = torch.eye(n, dtype=torch.float64).reshape(n, *fom.solution_shape)
    inner = np.flatnonzero(interior_mask(fom.n_nodes, torch.float64, "cpu").reshape(-1).numpy())
    ix = np.ix_(inner, inner)
    return [fom.apply_term(t, eye).reshape(n, n).T.numpy()[ix] for t in (0, 1)]


@pytest.fixture(scope="module")
def damped():
    fom = StencilHelmholtzDamped(GRID, dtype=torch.float64, device="cpu")
    K, M = _densify(fom)
    return fom, K, M


def _z(mu):
    return -float(mu["ksq"][0]) + 1j * float(mu["gamma"][0])


def _smin2(K, M, z):
    A = K + z * M
    return float(sla.eigvalsh(A.conj().T @ A)[0])


def test_damped_family_matches_dense_and_jax(damped):
    """A complex grid through ``apply`` equals (K + z M) u on the interior
    (z = -30 + 2i) and the JAX family's apply to 1e-12; ``theta_vector`` and
    ``jacobi_diag`` equal the JAX ones; the parameters can be carried in
    (``values``) and are drawn within the ranges; the complex Jacobi
    BiCGStab equals the dense solve to 1e-8."""
    fom, K, M = damped
    jfom = JaxDamped(GRID, dtype=jnp.float64)
    rng = np.random.RandomState(1)
    u = rng.standard_normal(fom.solution_shape) + 1j * rng.standard_normal(fom.solution_shape)
    u[0, :] = u[-1, :] = u[:, 0] = u[:, -1] = 0.0
    (tmu,) = fom.sample_parameters(1, values=[[30.0, 2.0]])
    jmu = {"ksq": jnp.asarray([30.0]), "gamma": jnp.asarray([2.0])}
    got = fom.apply(tmu, torch.tensor(u))
    inner = interior_mask(fom.n_nodes, torch.float64, "cpu").reshape(-1).numpy() > 0
    want = (K + (-30.0 + 2.0j) * M) @ u.reshape(-1)[inner]
    assert got.dtype == torch.complex128
    assert np.abs(got.numpy().reshape(-1)[inner] - want).max() <= 1e-12
    # jitted: the JAX family's eager stencil compiles each of its primitives
    japply, jtheta, jdiag = (jax.jit(lambda m, v: jfom.apply(m, v)),
                             jax.jit(jfom.theta_vector), jax.jit(jfom.jacobi_diag))
    assert np.abs(got.numpy() - np.asarray(japply(jmu, jnp.asarray(u)))).max() <= 1e-12
    assert np.abs(fom.theta_vector(tmu).numpy() - np.asarray(jtheta(jmu))).max() == 0
    assert np.abs(fom.jacobi_diag(tmu).numpy() - np.asarray(jdiag(jmu))).max() <= 1e-14
    for mu in fom.sample_parameters(16, key=3):
        assert 22.0 <= float(mu["ksq"][0]) < 46.0 and 0.5 <= float(mu["gamma"][0]) < 4.0
    b = fom.rhs().reshape(-1).numpy()[inner]
    x = sla.solve(K + (-30.0 + 2.0j) * M, b)
    res = fom.solve_bicgstab_result(tmu, tol=1e-10, maxiter=2000)
    assert np.abs(res.x.numpy().reshape(-1)[inner] - x).max() <= 1e-8 * np.abs(x).max()


def test_complex_alpha_exact_and_bounds(damped):
    """Four pairs (2 diagonal, the Re and the Im cross term); the complex
    LOBPCG's safe alpha equals the dense lambda_min(A^H A) to 1e-5 of it and
    lies below it at 2 draws; a fit on 4 draws brackets the dense sigma_min
    at 2 held-out ones, and is positive at the fitted ones (gap <= 0.5)."""
    fom, K, M = damped
    scm = MatrixFreeScmInfSup(fom, tol=1e-9, iters=800, log_level=30, analytic_boxes=True)
    assert scm._is_complex and [p[2] for p in scm._pairs] == ["re", "re", "im", "re"]
    mus = fom.sample_parameters(6, key=5)
    for mu in mus[:2]:
        truth = _smin2(K, M, _z(mu))
        a, ystar = scm.scm.alpha_exact(mu)
        assert a <= truth + 1e-10 and abs(a - truth) < 1e-5 * truth
        assert scm.scm._theta(mu) @ ystar >= truth - 1e-8
    hist = scm.fit(mus[:4], tol=0.5, max_anchors=4)
    for mu in mus[4:]:
        truth = np.sqrt(_smin2(K, M, _z(mu)))
        assert scm.lower(mu) <= truth * (1 + 1e-8) + 1e-12
        assert scm.upper(mu) >= truth * (1 - 1e-8) - 1e-12
    if hist["max_gap"][-1] <= 0.5:
        for mu in mus[:4]:
            assert 0 < scm.lower(mu) <= np.sqrt(_smin2(K, M, _z(mu))) * (1 + 1e-8)


def test_complex_weyl_bound_certified_matches_jax():
    """``restarts=1`` with eigensolved pair boxes is certified: the JAX
    package's red case, whose purely |theta|-relative restart check never
    passes at a near-zero box edge (the Im cross term i (KM - MK) vanishes
    to rounding: K and M commute on the uniform grid). Its Weyl bound at 4
    draws (one batched call) is positive near the anchors, below the dense
    sigma_min, and equals the JAX ``InfSupLowerBound`` with the same
    anchors, betas and gammas to 1e-12. At grid 8 with box_tol 1e-7: the
    k2 preconditioner suits M^H M's lower edge badly (575 iterations to an
    absolute 1e-9, 14 s; 61 to 1e-7, 3 s)."""
    fom = StencilHelmholtzDamped(8, dtype=torch.float64, device="cpu")
    K, M = _densify(fom)
    scm = MatrixFreeScmInfSup(fom, tol=1e-9, iters=800, log_level=30, restarts=1,
                              box_tol=1e-7)
    assert scm.certified and all(d["lo"]["certified"] and d["hi"]["certified"]
                                 for d in scm.scm.box_diagnostics)
    assert max(abs(lo) + abs(hi) for lo, hi in scm.box[2:3]) < 1e-15  # the Im term
    mus = fom.sample_parameters(4, key=7)
    for mu in mus[:2]:
        scm.add_anchor(mu)
    assert scm.certified and all(d["certified"] for d in scm.anchor_diagnostics)
    beta = scm.weyl_bound()
    assert beta.certified
    from rla4mor_tpu_torch.core import mu_stack

    vals = beta(mu_stack(mus)).numpy()
    assert 0 < vals[0] <= np.sqrt(_smin2(K, M, _z(mus[0]))) * (1 + 1e-8)
    jfom = JaxDamped(8, dtype=jnp.float64)
    jmus = [{k: jnp.asarray(v.numpy()) for k, v in mu.items()} for mu in mus]
    jb = JaxInfSup(jfom, jmus[:2], betas=beta.infsup.betas.numpy(),
                   gammas=beta.infsup.gammas.numpy())
    want = np.array([float(jb(m)) for m in jmus])
    assert np.abs(beta.infsup(mu_stack(mus)).numpy() - want).max() <= 1e-12
    assert np.array_equal(vals, np.maximum(want, 0.0)) or np.abs(
        vals - np.maximum(want, 0.0)).max() <= 1e-12


@pytest.fixture(scope="module")
def helm():
    fom = StencilHelmholtz(GRID, dtype=torch.float64, device="cpu")
    K, M = _densify(fom)
    return fom, K, M


def _ksq(v):
    return {"ksq": torch.tensor([float(v)], dtype=torch.float64)}


def test_real_infsup_analytic_boxes_bracket_sigma_min(helm):
    """Analytic pair boxes from ``term_norm_bounds`` contain the dense pair
    spectra (K^2, KM + MK, M^2); after a fit on 3 wavenumbers the bounds
    bracket the dense sigma_min there and are positive."""
    fom, K, M = helm
    scm = MatrixFreeScmInfSup(fom, tol=1e-9, iters=500, log_level=30, analytic_boxes=True)
    for pair, box in zip([K @ K, K @ M + M @ K, M @ M], scm.box):
        lam = np.linalg.eigvalsh(pair)
        assert box[0] <= lam[0] + 1e-14 and box[1] >= lam[-1] - 1e-14
    mus = [_ksq(v) for v in (24.0, 33.0, 44.0)]
    scm.fit(mus, tol=0.5, max_anchors=5)
    for mu in mus:
        sig = np.linalg.svd(K - float(mu["ksq"][0]) * M, compute_uv=False)[-1]
        lb, ub = scm.lower(mu), scm.upper(mu)
        assert 0 < lb <= sig * (1 + 1e-7) and ub >= sig * (1 - 1e-7)


def test_fit_weyl_positive_turns_inf_into_finite(helm):
    """One anchor leaves the Weyl bound nonpositive over 9 wavenumbers (its
    certificates would be inf; ``weyl_bound`` clamps it to 0);
    ``fit_weyl_positive`` anchors the worst until it is positive everywhere,
    within 8 anchors, and the LP is at least as tight; a budget of 1 is
    flagged."""
    fom, K, M = helm
    mus = [_ksq(v) for v in np.linspace(23.0, 43.0, 9)]
    kw = dict(tol=1e-9, iters=600, log_level=40, analytic_boxes=True)
    scm = MatrixFreeScmInfSup(fom, **kw)
    scm.add_anchor(mus[0])
    wb0 = scm._weyl_host(mus)
    assert wb0.min() <= 0.0
    assert float(scm.weyl_bound()(mus[int(np.argmin(wb0))])) == 0.0
    hist = scm.fit_weyl_positive(mus, max_anchors=8)
    assert hist["positive"] and not hist["flagged"] and hist["min_weyl"][-1] > 0
    vals = np.array([float(scm.weyl_bound()(m)) for m in mus])
    assert np.all(vals > 0)
    for v, mu in zip(vals, mus):
        assert v <= np.linalg.svd(K - float(mu["ksq"][0]) * M, compute_uv=False)[-1] * (1 + 1e-8)
    rep = scm.weyl_gap_report(mus)
    assert rep["n_nonpositive"] == 0 and 0.0 <= rep["max_rel_gap"] <= 1.0
    assert np.all(rep["lp"] >= np.maximum(rep["weyl"], 0.0) - 1e-12)
    one = MatrixFreeScmInfSup(fom, **kw)
    one.scm.anchor_mus, one.scm.anchor_thetas = scm.scm.anchor_mus[:1], scm.scm.anchor_thetas[:1]
    one.scm.anchor_alphas, one.scm.anchor_ystars = (scm.scm.anchor_alphas[:1],
                                                    scm.scm.anchor_ystars[:1])
    flagged = one.fit_weyl_positive(mus, max_anchors=1)
    assert flagged["flagged"] and not flagged["positive"] and flagged["n_anchors"] == 1


def test_infsup_flows_run_at_grid_16():
    """``large_scale_demo.run`` end to end at grid 16 on the CPU over 2
    candidates: the Helmholtz greedy with ``bounds=True`` (the inf-sup fit,
    the Weyl auto-fit, finite bounds where beta_LB > 0, certified) and the
    bounds-only ``lossy`` flow (certified, a residual bound at each draw,
    beta_LB below the dense sigma_min). (About 10 s: two defended inf-sup
    fits: a defended inf-sup anchor takes about 2.3 s at this size on the
    CPU, hence 2 candidates, not the demo's 8.)"""
    from rla4mor_tpu_torch.examples import large_scale_demo as demo

    quiet = dict(device="cpu", log=lambda line: None, batch=2)
    res = demo.run(grid=GRID, steps=2, k=64, precond="mg", sketch="srht", family="helmholtz",
                   bounds=True, **quiet)
    b = res["bounds"]
    assert b["certified"] and b["kind"] == "inf-sup" and b["weyl"]["positive"]
    assert b["weyl_min"] > 0 and np.all(b["lower"] > 0) and np.all(np.isfinite(b["bounds"]))

    out = demo.run(grid=GRID, family="lossy", **quiet)
    K, M = _densify(out["fom"])
    assert out["certified"] and len(out["rows"]) == 2
    for mu, row in zip(out["mus"], out["rows"]):
        assert row["lower"] <= np.sqrt(_smin2(K, M, _z(mu))) * (1 + 1e-8)
        assert row["residual"] > 0 and row["bound"] > 0
