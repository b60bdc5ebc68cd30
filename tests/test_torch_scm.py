"""The port's certified bounds (``mor/scm.py``, ``mor/bounds.py``) held
against the JAX package (float64 / complex128, CPU).

* ``ScmCoercivity`` on the 2x2 thermal block at 8 intervals (n = 49) and
  ``ScmInfSup`` on the damped Helmholtz family at 11 (n = 100): the
  spectral boxes, the greedy's anchors (parameters, alphas, Rayleigh
  coordinates) and the lower / upper bounds at 41 parameters, to 1e-8. The
  port reduces each pencil by a Cholesky factor of R and calls
  ``torch.linalg.eigh``; the JAX package calls scipy's ``eigh(T, R)``.
* ``MinThetaCoercivity`` (with its host ``eigsh``) and ``InfSupLowerBound``
  (dense SVDs) to 1e-10, one and a batch of parameters; ``error_bound`` and
  ``inf_sup_error_bound`` are the estimate over the lower bound, ``inf``
  where the inf-sup lower bound is not positive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.mor as jmor
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.models import helmholtz_fom as jax_helmholtz_fom

import rla4mor_tpu_torch.mor as tmor
from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.models import ThermalBlockFOM, helmholtz_fom

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _mus(key, values):
    """The same parameters for both packages: (JAX mus, port mus)."""
    return ([{key: jnp.asarray(v)} for v in values],
            [{key: torch.tensor(v, dtype=torch.float64)} for v in values])


def _check_scm(jscm, tscm, jmus, tmus, tol=1e-8):
    """Boxes, anchors and bounds of two ScmHermitian engines."""
    assert np.abs(np.array(jscm.box) - np.array(tscm.box)).max() <= tol
    assert len(tscm.anchor_mus) == len(jscm.anchor_mus)
    for a, b in zip(tscm.anchor_mus, jscm.anchor_mus):
        key = next(iter(b))
        assert np.array_equal(a[key].numpy(), np.asarray(b[key]))
    scale = np.abs(jscm.anchor_alphas).max()
    assert np.abs(tscm.anchor_alphas - jscm.anchor_alphas).max() <= tol * scale
    assert np.abs(tscm.anchor_ystars - jscm.anchor_ystars).max() <= tol * np.abs(
        jscm.anchor_ystars).max()
    lo = np.array([tscm.lower(m) for m in tmus]), np.array([jscm.lower(m) for m in jmus])
    up = np.array([tscm.upper(m) for m in tmus]), np.array([jscm.upper(m) for m in jmus])
    for p, j in (lo, up):
        assert np.abs(p - j).max() <= tol * np.abs(j).max()
    assert (lo[0] <= up[0] + tol * np.abs(up[0]).max()).all()


def test_scm_coercivity_on_the_thermal_block():
    """SCM coercivity of the 2x2 thermal block in the h1_0 norm: the same
    anchors as the JAX package (tol 0.05, at most 10) and bounds to 1e-8;
    each exact alpha lies between the bounds."""
    jfom, tfom = JaxFOM((2, 2), 8), ThermalBlockFOM((2, 2), 8, device="cpu")
    rng = np.random.RandomState(0)
    jtrain, ttrain = _mus("diffusion", rng.uniform(0.1, 1.0, size=(20, 4)))
    jscm = jmor.ScmCoercivity(jfom, product=jfom.h1_0_product)
    tscm = tmor.ScmCoercivity(tfom, product=tfom.h1_0_product, device="cpu")
    jfit = jscm.fit(jtrain, tol=0.05, max_anchors=10)
    tfit = tscm.fit(ttrain, tol=0.05, max_anchors=10)
    assert tfit["n_anchors"] == jfit["n_anchors"] >= 2
    jtest, ttest = _mus("diffusion", rng.uniform(0.1, 1.0, size=(41, 4)))
    _check_scm(jscm, tscm, jtest, ttest)
    for mu in ttest[:5]:
        alpha, _ = tscm.alpha_exact(mu)
        assert tscm.lower(mu) <= alpha * (1 + 1e-10) and alpha <= tscm.upper(mu) * (1 + 1e-10)


@pytest.fixture(scope="module")
def helmholtz():
    """Both packages' Helmholtz FOM at 11 intervals, ScmInfSup fit over 40
    wavenumbers (gap 0.2, up to 40 anchors; over 5 s: the JAX side
    evaluates the coefficients by JAX for each of its LPs)."""
    jfom = jax_helmholtz_fom(11, (2.0, 8.0), 0.5)
    tfom = helmholtz_fom(11, (2.0, 8.0), 0.5, device="cpu")
    jtrain, ttrain = _mus("wavenumber", np.linspace(2.0, 8.0, 40)[:, None])
    jscm = jmor.ScmInfSup(jfom, product=jfom.h1_0_product)
    tscm = tmor.ScmInfSup(tfom, product=tfom.h1_0_product, device="cpu")
    jfit = jscm.fit(jtrain, tol=0.2, max_anchors=40)
    tfit = tscm.fit(ttrain, tol=0.2, max_anchors=40)
    return jfom, tfom, jscm, tscm, jfit, tfit


def test_scm_inf_sup_on_helmholtz(helmholtz):
    """The Re / Im pair expansion of A^H R^-1 A (4 Hermitian terms, complex
    coefficients), its boxes, anchors and the beta bounds at 41 wavenumbers
    equal the JAX package's to 1e-8; the fit's gaps by iteration too."""
    jfom, tfom, jscm, tscm, jfit, tfit = helmholtz
    assert tscm._pairs == jscm._pairs and len(tscm.scm.terms) == 4
    assert tfit["n_anchors"] == jfit["n_anchors"]
    g_t, g_j = np.array(tfit["max_gap"]), np.array(jfit["max_gap"])
    fin = np.isfinite(g_j)
    assert np.array_equal(np.isfinite(g_t), fin) and np.abs(g_t[fin] - g_j[fin]).max() <= 1e-8
    jtest, ttest = _mus("wavenumber", np.linspace(2.0, 8.0, 41)[:, None])
    _check_scm(jscm.scm, tscm.scm, jtest, ttest)
    lo = np.array([tscm(m) for m in ttest])
    assert np.abs(lo - np.array([jscm(m) for m in jtest])).max() <= 1e-8


def test_inf_sup_lower_bound_and_error_bound(helmholtz):
    """``InfSupLowerBound`` (Weyl) from 3 references: its betas and gammas and
    beta_LB at 41 wavenumbers (one call on the batch) equal the JAX
    package's to 1e-10; ``inf_sup_error_bound`` is estimate / beta_LB where
    that is positive and inf elsewhere."""
    jfom, tfom, *_ = helmholtz
    jrefs, trefs = _mus("wavenumber", np.array([[3.0], [5.0], [7.0]]))
    jlb = jmor.InfSupLowerBound(jfom, jrefs, product=jfom.h1_0_product)
    tlb = tmor.InfSupLowerBound(tfom, trefs, product=tfom.h1_0_product)
    assert np.abs(tlb.betas.numpy() - np.asarray(jlb.betas)).max() <= 1e-10
    assert np.abs(tlb.gammas.numpy() - np.asarray(jlb.gammas)).max() <= 1e-10 * float(
        np.abs(np.asarray(jlb.gammas)).max())
    jtest, ttest = _mus("wavenumber", np.linspace(2.0, 8.0, 41)[:, None])
    beta = tlb(mu_stack(ttest)).numpy()
    want = np.array([float(jlb(m)) for m in jtest])
    assert np.abs(beta - want).max() <= 1e-10
    assert (beta > 0).any() and (beta <= 0).any()

    class Rom:  # an estimate of 1e-3 at every parameter
        class error_estimator:
            @staticmethod
            def estimate_error(u, mu):
                return torch.full(mu["wavenumber"].shape[:-1], 1e-3, dtype=torch.float64)

    bounds = np.array([float(tmor.inf_sup_error_bound(Rom, m, tlb, u_r=0.0)) for m in ttest])
    pos = beta > 0
    assert np.allclose(bounds[pos], 1e-3 / beta[pos], rtol=1e-14)
    assert np.isinf(bounds[~pos]).all()
    batched = tmor.inf_sup_error_bound(Rom, mu_stack(ttest), tlb, u_r=0.0).numpy()
    assert np.array_equal(batched, bounds)


def test_min_theta_coercivity_and_error_bound():
    """``MinThetaCoercivity`` of the 2x2 thermal block in the h1_0 norm (the
    host ``eigsh`` of (sym A(mu_ref), R)) equals the JAX package's to 1e-10
    at one and a batch of parameters; ``error_bound`` divides the estimate
    by it; a non-positive reference coefficient is refused."""
    jfom, tfom = JaxFOM((2, 2), 8), ThermalBlockFOM((2, 2), 8, device="cpu")
    ref = np.array([0.5, 0.3, 0.8, 0.6])
    jc = jmor.MinThetaCoercivity(jfom, {"diffusion": jnp.asarray(ref)},
                                 product=jfom.h1_0_product)
    tc = tmor.MinThetaCoercivity(tfom, {"diffusion": torch.tensor(ref)},
                                 product=tfom.h1_0_product)
    assert abs(tc.alpha_ref - jc.alpha_ref) <= 1e-10 * jc.alpha_ref
    rng = np.random.RandomState(4)
    jmus, tmus = _mus("diffusion", rng.uniform(0.1, 1.0, size=(8, 4)))
    got = tc(mu_stack(tmus)).numpy()
    assert np.abs(got - np.array([float(jc(m)) for m in jmus])).max() <= 1e-10 * got.max()

    class Rom:
        class error_estimator:
            @staticmethod
            def estimate_error(u, mu):
                return torch.full(mu["diffusion"].shape[:-1], 2.0, dtype=torch.float64)

    assert torch.allclose(tmor.error_bound(Rom, mu_stack(tmus), tc, u_r=0.0),
                          2.0 / torch.tensor(got), rtol=1e-14)
    assert tmor.MinThetaCoercivity(tfom, {"diffusion": torch.tensor(ref)}).alpha_ref == 1.0
    with pytest.raises(ValueError, match="positive"):
        tmor.MinThetaCoercivity(tfom, {"diffusion": torch.tensor([0.5, -0.1, 0.8, 0.6])})
