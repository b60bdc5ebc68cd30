"""The port's matrix-free SCM (``mor/scm_matfree.py``), its column-batched
CG and the coercive bounds flows, held against the JAX package and dense
oracles (float64, CPU).

* ``lobpcg_gen`` on the random pencil of ``tests/test_scm_matfree.py``
  (n = 120, ``RandomState(0)``), both packages started from the same block
  through ``x0``: values and radii to 1e-10, iterations within 1; the
  two-stage solve, the spectral interval, the defenses (restart agreement,
  the adversarial start, clusters), the stops (``GenEigResult.stop``), the
  relative tolerance and the R-solve guard against dense ``eigh``.
* ``MatrixFreeScmCoercivity`` on the 2x2 stencil block: its boxes against
  the port's dense ``ScmHermitian`` on the interior densification, its
  anchor, lower and upper bounds against that and against the JAX engine
  ``MatrixFreeScmHermitian`` on the same dense pencil fed the same boxes (the
  JAX class on the stencils takes 29 s at grid 8: one JIT compile a
  solve), to 1e-8. The defended fit (``restarts=1``) is
  certified: the port's counterpart of the JAX package's red
  ``test_matrixfree_scm_defended_matches_dense``.
* ``l2_interior_scm``: MG and CG preconditioners give one anchor; analytic
  boxes give the eigensolved boxes' bounds; ``term_box_bounds`` contain the
  dense spectra.
* ``cg_columns`` against per-column ``cg`` and the JAX ``vmap(cg)``,
  columns that stop early included.
* ``large_scale_demo.run(bounds=True)`` (advection, non-affine) and
  ``large_scale_parabolic_demo.run(bounds=True)`` end to end at grid 16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from rla4mor_tpu.core.solvers import cg as jax_cg
from rla4mor_tpu.mor import scm_matfree as J

from rla4mor_tpu_torch.core.parameters import eval_coefficients
from rla4mor_tpu_torch.core.solvers import cg, cg_columns
from rla4mor_tpu_torch.models import (
    StencilAdvectionDiffusion,
    StencilThermalBlock,
    StencilThermalBlock3D,
)
from rla4mor_tpu_torch.models.stencil import interior_mask
from rla4mor_tpu_torch.mor.scm import ScmHermitian
from rla4mor_tpu_torch.mor.scm_matfree import (
    MatrixFreeScmCoercivity,
    l2_interior_scm,
    lobpcg_gen,
    lobpcg_gen_checked,
    lobpcg_gen_two_stage,
    spectral_interval,
)

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def pencil():
    """The JAX test's random pencil (T, R) and its dense spectrum."""
    rng = np.random.RandomState(0)
    n = 120
    Q = sla.qr(rng.standard_normal((n, n)))[0]
    R = Q @ np.diag(rng.uniform(0.5, 50, n)) @ Q.T
    T = rng.standard_normal((n, n))
    T = 0.5 * (T + T.T)
    Tt, Rt = torch.tensor(T), torch.tensor(R)
    dinv = 1.0 / torch.diag(Rt)
    return dict(n=n, T=T, R=R, truth=sla.eigh(T, R, eigvals_only=True),
                apply_T=lambda U: Tt.to(U.dtype) @ U, apply_R=lambda U: Rt.to(U.dtype) @ U,
                precond=lambda U: U * dinv.to(U.dtype)[:, None])


def test_lobpcg_gen_matches_jax_and_dense(pencil):
    """The smallest 2 pairs from the same start block: values and radii equal
    the JAX package's to 1e-10, iterations within 1; the values the dense
    ``eigh`` to 1e-9, the enclosure on the safe side, the Ritz vectors
    eigenvectors; the stop is the tolerance."""
    n, truth = pencil["n"], pencil["truth"]
    x0 = np.random.RandomState(1).standard_normal((n, 4))
    kw = dict(k=2, block=4, iters=400, tol=1e-10)
    Tj, Rj = jnp.asarray(pencil["T"]), jnp.asarray(pencil["R"])
    dj = 1.0 / jnp.diag(Rj)
    want = J.lobpcg_gen(lambda U: Tj @ U, lambda U: Rj @ U, n, x0=jnp.asarray(x0),
                        precond=lambda U: U * dj[:, None], **kw)
    res = lobpcg_gen(pencil["apply_T"], pencil["apply_R"], n, x0=torch.tensor(x0),
                     precond=pencil["precond"], **kw)
    assert res.converged and res.certified and res.stop == "tol"
    assert np.abs(res.values - want.values).max() <= 1e-10
    assert np.abs(res.radii - want.radii).max() <= 1e-10
    assert abs(res.iterations - want.iterations) <= 1
    assert abs(res.gap_margin - want.gap_margin) <= 1e-10
    np.testing.assert_allclose(res.values, truth[:2], rtol=1e-9, atol=1e-11)
    assert np.all(res.radii < 1e-7) and res.values[0] - res.radii[0] <= truth[0] + 1e-12
    X = res.vectors.numpy()
    r = pencil["T"] @ X - pencil["R"] @ X * res.values[None, :]
    assert np.linalg.norm(r, axis=0).max() < 1e-7


def test_spectral_interval_and_two_stage(pencil):
    """``spectral_interval`` encloses the dense spectrum to 1e-8;
    ``lobpcg_gen_two_stage`` (float32, then the float64 polish) reaches the
    dense smallest eigenvalue with a float64 radius."""
    n, truth = pencil["n"], pencil["truth"]
    args = (pencil["apply_T"], pencil["apply_R"], n)
    lo, hi, lo_res, hi_res = spectral_interval(*args, block=4, precond=pencil["precond"],
                                               iters=400, tol=1e-10, **CPU)
    assert lo <= truth[0] <= truth[-1] <= hi
    assert abs(lo - truth[0]) < 1e-8 and abs(hi - truth[-1]) < 1e-8
    res = lobpcg_gen_two_stage(*args, k=1, block=4, precond=pencil["precond"], iters=400,
                               tol=1e-10, f32_iters=60, **CPU)
    assert res.converged and res.vectors.dtype == torch.float64
    np.testing.assert_allclose(res.values, truth[:1], rtol=1e-9, atol=1e-11)
    assert res.radii[0] < 1e-7 and res.values[0] - res.radii[0] <= truth[0] + 1e-12


def test_checked_restart_agreement_certifies(pencil):
    """Honest random starts: the restarts agree beyond their radii, the
    result is certified, equals the dense eigenvalue and has a positive gap
    margin (the lowest eigenvalues are simple)."""
    res = lobpcg_gen_checked(pencil["apply_T"], pencil["apply_R"], pencil["n"], k=1,
                             restarts=2, precond=pencil["precond"], iters=400, tol=1e-10,
                             **CPU)
    assert res.converged and res.certified and res.restart_disagreement <= 1e-6
    assert res.restart_radius_ratio <= 1e-6
    np.testing.assert_allclose(res.values[0], pencil["truth"][0], rtol=1e-9)
    assert np.isfinite(res.gap_margin) and res.gap_margin > 0


def _diagonal(d):
    dt = torch.tensor(d, dtype=torch.float64)
    return (lambda U: U * dt[:, None]), (lambda U: U)


def test_interior_convergence_caught():
    """The adversarial start: a block orthogonal to e_1 on T = diag(1..40)
    converges cleanly to the interior eigenvalue 2 with a tiny, valid
    enclosure (theta - rho > lambda_min = 1); the independent restart finds
    1, the values disagree far beyond the radii, and certification fails
    (no floor applies to an anchor-type solve)."""
    n = 40
    apply_T, apply_R = _diagonal(np.arange(1.0, n + 1.0))
    x0 = np.random.RandomState(3).standard_normal((n, 4))
    x0[0, :] = 0.0
    kw = dict(k=1, x0=torch.tensor(x0), iters=300, tol=1e-12, identity_R=True)
    bare = lobpcg_gen(apply_T, apply_R, n, **kw)
    assert bare.converged and bare.certified
    assert abs(bare.values[0] - 2.0) < 1e-9 and bare.values[0] - bare.radii[0] > 1.5
    res = lobpcg_gen_checked(apply_T, apply_R, n, restarts=1, **kw)
    assert not res.certified and res.restart_disagreement > 0.1
    assert abs(res.values[0] - 1.0) < 1e-9  # the returned run is the honest one


def test_gap_margin_flags_clusters():
    """A doubled smallest eigenvalue: the first two enclosures overlap
    (gap_margin <= 0, recorded), and the restarts still certify the value."""
    d = np.arange(1.0, 31.0)
    d[1] = 1.0
    apply_T, apply_R = _diagonal(d)
    res = lobpcg_gen_checked(apply_T, apply_R, 30, k=1, restarts=1, iters=300, tol=1e-11,
                             identity_R=True, **CPU)
    assert res.certified
    np.testing.assert_allclose(res.values[0], 1.0, atol=1e-9)
    assert res.gap_margin <= 1e-6


def test_stops_and_relative_tolerance():
    """float32 floors above the tolerance: the plateau stop fires early and
    names itself ('plateau' outside the 10x grace band, 'grace' inside it,
    converged only then), the iteration cap 'iters'. A smallest eigenvalue
    of 1e-9 beside O(1) ones: an absolute tol "converges" with a radius
    larger than it (theta - rho < 0), ``eig_relative_tol`` gives a positive
    safe edge."""
    rng = np.random.RandomState(5)
    n = 120
    Q = sla.qr(rng.standard_normal((n, n)))[0]
    lam = np.sort(rng.uniform(0.1, 4.0, n))
    T = torch.tensor(Q @ np.diag(lam) @ Q.T, dtype=torch.float32)
    kw = dict(k=1, block=4, dtype=torch.float32, identity_R=True, key=1, **CPU)
    for tol, stop in ((1e-14, "plateau"), (1e-7, "grace")):
        res = lobpcg_gen(lambda U: T @ U, lambda U: U, n, iters=4000, tol=tol, plateau=40,
                         **kw)
        assert res.iterations < 1000 and res.stop == stop
        assert res.converged == (stop == "grace") == res.certified
        np.testing.assert_allclose(res.values[0], lam[0], rtol=1e-4)
    res = lobpcg_gen(lambda U: T @ U, lambda U: U, n, iters=3, tol=1e-12, **kw)
    assert res.stop == "iters" and not res.converged and res.iterations == 3

    rng = np.random.RandomState(2)
    n = 100
    Q = sla.qr(rng.standard_normal((n, n)))[0]
    T = torch.tensor(Q @ np.diag(np.concatenate([[1e-9], rng.uniform(0.5, 2.0, n - 1)]))
                     @ Q.T)
    kw = dict(k=1, block=4, iters=300, identity_R=True, key=3, tol=1e-5, **CPU)
    loose = lobpcg_gen(lambda U: T @ U, lambda U: U, n, **kw)
    assert loose.converged and loose.values[0] - loose.radii[0] < 0
    tight = lobpcg_gen(lambda U: T @ U, lambda U: U, n, eig_relative_tol=True, **kw)
    assert tight.converged and 0 < tight.values[0] - tight.radii[0] <= 1e-9 * (1 + 1e-4)
    np.testing.assert_allclose(tight.values[0], 1e-9, rtol=1e-5)


def test_radius_rsolve_guard_refuses_unconverged():
    """An inexact Bauer-Fike R-solve would under-estimate ||r||_{R^-1}: with
    one CG iteration on an ill-conditioned R the solve raises; with R = I
    (``identity_R``) the radii need no solve."""
    rng = np.random.RandomState(3)
    n = 60
    Q = sla.qr(rng.standard_normal((n, n)))[0]
    R = torch.tensor(Q @ np.diag(np.geomspace(1e-6, 1.0, n)) @ Q.T)
    T = rng.standard_normal((n, n))
    T = torch.tensor(0.5 * (T + T.T))
    with pytest.raises(ValueError, match="Bauer-Fike R-solve"):
        lobpcg_gen(lambda U: T @ U, lambda U: R @ U, n, iters=3, tol=1e-10,
                   rsolve_maxiter=1, **CPU)
    res = lobpcg_gen(lambda U: T @ U, lambda U: U, n, iters=300, tol=1e-10, identity_R=True,
                     rsolve_maxiter=0, **CPU)
    np.testing.assert_allclose(res.values, sla.eigvalsh(T.numpy())[:1], rtol=1e-9, atol=1e-10)
    assert res.radii[0] < 1e-7


def _dense_terms(fom):
    """(symmetric parts of the affine terms, the product R) on the interior
    nodes, from the port's applies (the stencil-oracle mapping)."""
    aff = fom.affine_operator()
    n = aff.source_dim
    eye = torch.eye(n, dtype=torch.float64)
    inner = np.flatnonzero(interior_mask(fom.n_nodes, torch.float64, "cpu").reshape(-1).numpy())
    ix = np.ix_(inner, inner)
    terms = [(0.5 * (t.apply(eye) + t.apply_adjoint(eye))).numpy()[ix] for t in aff.terms]
    R = fom.product_apply(eye.T.reshape(n, *fom.solution_shape)).reshape(n, n).T.numpy()
    return terms, R[ix], tuple(aff.coefficients)


@pytest.fixture(scope="module")
def block8():
    """The port's matrix-free SCM on the 2x2 block at grid 8 (tol 1e-10),
    the dense ScmHermitian of its interior densification, the JAX engine
    ``MatrixFreeScmHermitian`` on that dense pencil (its applies dense
    products: the stencil applies would cost the JAX side a JIT compile a
    solve), and 6 parameters."""
    fom = StencilThermalBlock((2, 2), 8, dtype=torch.float64, **CPU)
    terms, R, coeffs = _dense_terms(fom)

    def theta_fn(mu):
        return eval_coefficients(coeffs, {k: torch.tensor(np.array(v))
                                          for k, v in mu.items()}, device="cpu").numpy()

    dense = ScmHermitian(terms, theta_fn, R, **CPU)
    mf = MatrixFreeScmCoercivity(fom, tol=1e-10, iters=500, log_level=30)
    Rj, dj = jnp.asarray(R), jnp.asarray(1.0 / np.diag(R))
    jmf = J.MatrixFreeScmHermitian([lambda U, T=jnp.asarray(T): T @ U for T in terms],
                                   theta_fn, lambda U: Rj @ U, R.shape[0],
                                   precond=lambda U: U * dj[:, None], tol=1e-10, iters=500,
                                   log_level=30, boxes=mf.box)
    rng = np.random.RandomState(7)
    mus = rng.uniform(0.1, 1.0, size=(6, 4))
    return mf, dense, jmf, mus


def test_matrixfree_coercivity_matches_dense_and_jax(block8):
    """Boxes equal the dense ones to 1e-8 on their safe side; one anchor's
    safe alpha, the lower and upper bounds at 5 other parameters equal the
    dense SCM's and those of the JAX engine given the same boxes (one JAX
    anchor solve) to 1e-8; the dense truth lies between the bounds."""
    mf, dense, jmf, mus = block8
    for (mlo, mhi), (dlo, dhi) in zip(mf.box, dense.box):
        assert abs(mlo - dlo) < 1e-8 and abs(mhi - dhi) < 1e-8
        assert mlo <= dlo + 1e-12 and mhi >= dhi - 1e-12
    t_mu = [{"diffusion": torch.tensor(m)} for m in mus]
    j_mu = [{"diffusion": jnp.asarray(m)} for m in mus]
    for s, mu in ((mf, t_mu[0]), (dense, t_mu[0]), (jmf, j_mu[0])):
        s.add_anchor(mu)
    a_d = dense.anchor_alphas[0]
    assert abs(mf.anchor_alphas[0] - a_d) < 1e-8 and mf.anchor_alphas[0] <= a_d + 1e-12
    assert abs(mf.anchor_alphas[0] - jmf.anchor_alphas[0]) < 1e-8
    th = dense._theta(t_mu[0])
    assert th @ mf.anchor_ystars[0] >= a_d - 1e-10
    for tm, jm in zip(t_mu[1:], j_mu[1:]):
        lb, ub = mf.lower(tm), mf.upper(tm)
        assert abs(lb - dense.lower(tm)) < 1e-8 and abs(ub - dense.upper(tm)) < 1e-8
        assert abs(lb - jmf.lower(jm)) < 1e-8 and abs(ub - jmf.upper(jm)) < 1e-8
        a_true, _ = dense.alpha_exact(tm)
        assert lb <= a_true + 1e-9 and ub >= a_true - 1e-9


def test_defended_fit_certifies_psd_edges():
    """``restarts=1`` at every site on the 2x2 block (grid 8): the fit is
    certified, every anchor's restarts agree, and the bounds stay below the
    truth. The lower box edges of the PSD terms sit at 0, where the JAX
    package's purely |theta|-relative informative test fails
    (``recheck(0.0)``); floored by the pencil's scale they pass."""
    fom = StencilThermalBlock((2, 2), 8, dtype=torch.float64, **CPU)
    mf = MatrixFreeScmCoercivity(fom, tol=1e-10, iters=500, log_level=30, restarts=1)
    assert mf.certified
    lo_ratios = [d["lo"]["restart_radius_ratio"] for d in mf.box_diagnostics]
    assert max(lo_ratios) <= 0.1
    assert all(d["lo"]["theta"] < 1e-6 and d["lo"]["stop"] == "tol"
               for d in mf.box_diagnostics)
    rng = np.random.RandomState(7)
    mus = [{"diffusion": torch.tensor(rng.uniform(0.1, 1.0, 4))} for _ in range(4)]
    for mu in mus[:2]:
        mf.add_anchor(mu)
    assert mf.certified and len(mf.anchor_diagnostics) == 2
    for d in mf.anchor_diagnostics:
        assert d["certified"] and d["restart_disagreement"] <= 1e-4
    terms, R, coeffs = _dense_terms(fom)
    dense = ScmHermitian(terms, lambda mu: eval_coefficients(coeffs, mu, device="cpu").numpy(),
                         R, **CPU)
    for mu in mus[2:]:
        assert mf.lower(mu) <= dense.alpha_exact(mu)[0] + 1e-9
    # the JAX check on the same solve: a zero edge is never |theta|-informative
    A0 = fom.affine_operator().terms[0]
    res = lobpcg_gen_checked(lambda U: 0.5 * (A0.apply(U) + A0.apply_adjoint(U)),
                             mf.apply_R, mf.n, restarts=1, precond=mf.precond,
                             **mf._eig_kw)
    res.recheck(0.0)
    assert res.converged and not res.certified and res.restart_radius_ratio > 0.1
    res.recheck(mf.box[0][1])
    assert res.certified


def test_l2_interior_scm_mg_cg_and_boxes():
    """``l2_interior_scm`` at grid 16: the V-cycle and the column-batched
    Jacobi-CG preconditioners give the same anchor (1e-8 relative) and lower
    bounds (1e-6); analytic boxes [0, 16/3] contain the eigensolved ones
    (grid 8) and give the same lower bounds (1e-7)."""
    fom = StencilThermalBlock((2, 2), 16, dtype=torch.float64, **CPU)
    mu_ref = {"diffusion": torch.ones(4, dtype=torch.float64)}
    kw = dict(two_stage=True, tol=1e-9, iters=400, log_level=30)
    scm_cg = l2_interior_scm(fom, mu_ref, **kw)
    scm_mg = l2_interior_scm(fom, mu_ref, precond_type="mg", **kw)
    a_cg, a_mg = scm_cg.add_anchor(mu_ref), scm_mg.add_anchor(mu_ref)
    assert abs(a_cg - a_mg) <= 1e-8 * a_cg and scm_cg.certified and scm_mg.certified
    rng = np.random.RandomState(0)
    mus = [{"diffusion": torch.tensor(rng.uniform(0.1, 1.0, 4))} for _ in range(2)]
    for mu in mus:
        lb_c, lb_m = scm_cg.lower(mu), scm_mg.lower(mu)
        assert lb_m > 0 and abs(lb_c - lb_m) < 1e-6 * lb_c
    with pytest.raises(ValueError, match="precond_type"):
        l2_interior_scm(fom, mu_ref, precond_type="bogus")

    fom = StencilThermalBlock((2, 2), 8, dtype=torch.float64, **CPU)
    scm_a = l2_interior_scm(fom, mu_ref, **kw)
    scm_e = l2_interior_scm(fom, mu_ref, analytic_boxes=False, **kw)
    assert scm_a.box_radii == [(0.0, 0.0)] * 4
    for (lo_a, hi_a), (lo_e, hi_e) in zip(scm_a.box, scm_e.box):
        assert lo_a == 0.0 and hi_a == 16.0 / 3.0
        assert lo_a <= lo_e + 1e-8 and hi_a >= hi_e - 1e-8
    scm_a.add_anchor(mu_ref)
    scm_e.add_anchor(mu_ref)
    for mu in mus:
        lb_a, lb_e = scm_a.lower(mu), scm_e.lower(mu)
        assert lb_a > 0 and lb_a >= lb_e - 1e-12 and abs(lb_a - lb_e) < 1e-7 * lb_e


def test_l2_interior_scm_advection_is_sharp():
    """Advection-diffusion at grid 16: the symmetrised advection terms
    vanish (boxes [0, 0]), so alpha_l2(mu) = eps lambda_min(K | interior);
    the two-stage anchor at eps = 1 certifies it on the safe side and sharp
    to 1e-7 at three eps."""
    fom = StencilAdvectionDiffusion(16, dtype=torch.float64, **CPU)
    mu_ref = {"eps": torch.tensor([1.0], dtype=torch.float64),
              "velocity": torch.zeros(2, dtype=torch.float64)}
    scm = l2_interior_scm(fom, mu_ref, two_stage=True, tol=1e-9, iters=400, log_level=30)
    assert scm.box[1:] == [(0.0, 0.0), (0.0, 0.0)]
    scm.add_anchor(mu_ref)
    terms, _, _ = _dense_terms(fom)
    lam = sla.eigvalsh(terms[0])[0]
    for eps in (0.05, 0.4, 1.0):
        lb = scm.lower({"eps": torch.tensor([eps], dtype=torch.float64),
                        "velocity": torch.tensor([0.7, -0.3], dtype=torch.float64)})
        assert 0 < lb <= eps * lam + 1e-10 and abs(lb - eps * lam) < 1e-7 * lam


def test_term_box_bounds_contain_dense_spectra():
    """The analytic boxes hold against the dense spectra of every term: the
    2-D block (the method this PR adds), advection-diffusion and the 3-D
    block."""
    for fom in (StencilThermalBlock((2, 2), 8, dtype=torch.float64, **CPU),
                StencilAdvectionDiffusion(8, dtype=torch.float64, **CPU),
                StencilThermalBlock3D((2, 2, 2), 4, dtype=torch.float64, **CPU)):
        shape = fom.solution_shape
        n = int(np.prod(shape))
        eye = torch.eye(n, dtype=torch.float64).reshape(n, *shape)
        for t, (lo, hi) in enumerate(fom.term_box_bounds()):
            A = fom.apply_term(t, eye).reshape(n, n).numpy()
            lam = np.linalg.eigvalsh(0.5 * (A + A.T))
            assert lo <= lam[0] + 1e-12 and hi >= lam[-1] - 1e-12, (type(fom).__name__, t)


def test_cg_columns_matches_cg_and_jax_vmap():
    """Five right-hand sides of an SPD matrix (n = 60, condition 20): a zero
    one (0 iterations), a sum of 3 eigenvectors (3 unpreconditioned
    iterations) and three random ones, with and without Jacobi, stopped by
    the tolerance (1e-8) or by ``maxiter`` (12): ``cg_columns`` (host check
    every 8 iterations, or every one: bit-equal) equals the JAX
    ``vmap(cg)`` and per-column ``cg``, the counts exactly, the solutions to
    1e-10 of their largest entry (dense products in another order)."""
    rng = np.random.RandomState(0)
    n = 60
    Q = sla.qr(rng.standard_normal((n, n)))[0]
    A = Q @ np.diag(np.geomspace(0.05, 1.0, n)) @ Q.T
    B = rng.standard_normal((n, 5))
    B[:, 1] = 0.0
    B[:, 2] = Q[:, :3] @ np.array([1.0, 2.0, 3.0])
    At, dt = torch.tensor(A), torch.tensor(np.diag(A))
    Aj, dj = jnp.asarray(A), jnp.asarray(np.diag(A))
    seen = set()
    for maxiter in (200, 12):
        for jacobi in (False, True):
            kw = dict(tol=1e-8, maxiter=maxiter)
            pre = (lambda R: R / dt[:, None]) if jacobi else None
            res, every = (cg_columns(lambda U: At @ U, torch.tensor(B), precond=pre,
                                     check_every=j, **kw) for j in (8, 1))
            assert torch.equal(res.x, every.x) and torch.equal(res.iters, every.iters)
            jpre = (lambda r: r / dj) if jacobi else None
            jres = jax.vmap(lambda b: jax_cg(lambda v: Aj @ v, b, precond=jpre, **kw),
                            in_axes=1)(jnp.asarray(B))
            iters = res.iters.numpy()
            assert np.array_equal(iters, np.asarray(jres.iters))
            scale = float(res.x.abs().max())
            assert np.abs(res.x.numpy() - np.asarray(jres.x).T).max() <= 1e-10 * scale
            for j in range(5):
                one = cg(lambda v: At @ v, torch.tensor(B[:, j]),
                         precond=(lambda r: r / dt) if jacobi else None, **kw)
                assert one.iters == iters[j]
                assert float((one.x - res.x[:, j]).abs().max()) <= 1e-10 * scale
            seen.update(iters.tolist())
    assert {0, 3, 12} <= seen and max(seen) > 12


def test_coercive_bounds_flows_run_at_grid_16():
    """``large_scale_demo.run(bounds=True)`` end to end at grid 16 on the
    CPU: advection (MG, the slice's flow) certifies alpha_LB = eps
    lambda_min(K) below the dense truth at every candidate, with finite
    bounds; the non-affine family's unit-stiffness enclosure contains the
    dense lambda_min(K_1), its total bounds finite and positive. Then
    ``large_scale_parabolic_demo.run(bounds=True)`` (nt 10, 2 extensions):
    the certified final-time bound is at least the measured M-norm error.
    (About 8 s: two small greedies, a POD-greedy and three anchors.)"""
    from rla4mor_tpu_torch.examples import large_scale_demo as demo
    from rla4mor_tpu_torch.examples import large_scale_parabolic_demo as para

    quiet = dict(device="cpu", log=lambda line: None)
    res = demo.run(grid=16, steps=2, k=64, precond="mg", sketch="srht", family="advection",
                   bounds=True, **quiet)
    b = res["bounds"]
    terms, _, _ = _dense_terms(res["fom"])
    lam = sla.eigvalsh(terms[0])[0]
    eps = res["mu_batch"]["eps"][:, 0].numpy()
    assert b["certified"] and b["kind"] == "coercivity"
    assert np.all(b["lower"] > 0) and np.all(b["lower"] <= eps * lam * (1 + 1e-12))
    assert np.all(np.isfinite(b["bounds"])) and b["diagnostics"][0]["stop"] in ("tol", "grace")

    res = demo.run(grid=16, steps=2, k=64, precond="mg", sketch="srht", family="nonaffine",
                   bounds=True, **quiet)
    b = res["bounds"]
    assert b["certified"] and 0 < b["lam"][0] <= lam * (1 + 1e-12) and b["lam"][1] == 16 / 3
    assert np.all(np.isfinite(b["bounds"])) and np.all(b["bounds"] > 0)

    out = para.run(grid=16, nt=10, ext=2, k=64, bounds=True, **quiet)
    assert out["bounds"]["certified"] and out["bounds"]["alpha_ref"] > 0
    for row in out["held_out"]:
        assert row["bound"] >= row["error_M"] > 0
