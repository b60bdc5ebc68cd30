"""The port's randomised range finder, SVD and POD (``core/rsvd.py``) held
against the JAX package (f64, CPU).

The Gaussian test matrices are the JAX package's own draws
(``rla4mor_tpu.core.rsvd._test_matrix`` under its keys), carried into the
port through ``omega``; with them every output equals the JAX one to 1e-10
relative, singular vectors up to the sign of each column. The oracles of
``tests/test_rsvd.py`` run on the port alone, with its own
``torch.Generator`` draws, at smaller sizes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM

from rla4mor_tpu_torch.models import ThermalBlockFOM

# the modules (each package's core/__init__ binds ``rsvd`` to the function)
jrsvd = importlib.import_module("rla4mor_tpu.core.rsvd")
trsvd = importlib.import_module("rla4mor_tpu_torch.core.rsvd")

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _decaying(n, m, decay=0.5, seed=0, complex_=False):
    """Matrix with a geometrically decaying spectrum (known exact SVD)."""
    rng = np.random.default_rng(seed)
    r = min(n, m)

    def orth(rows):
        Z = rng.standard_normal((rows, r))
        if complex_:
            Z = Z + 1j * rng.standard_normal((rows, r))
        return np.linalg.qr(Z)[0]

    U, V = orth(n), orth(m)
    s = decay ** np.arange(r)
    return (U * s) @ V.conj().T, s


def _signed_close(a, b, tol):
    """Columns of a equal those of b up to a unit factor each (a sign, or a
    phase for complex data), to ``tol`` of max|b|."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    phase = np.sum(a.conj() * b, axis=0)
    phase = phase / np.abs(phase)
    assert np.abs(a * phase - b).max() <= tol * np.abs(b).max()


def _omega(seed, m, l, dtype=jnp.float64):
    return np.asarray(jrsvd._test_matrix(jax.random.key(seed), m, l, dtype))


@pytest.fixture(scope="module")
def products():
    """The h1_0 product of a 2x2 block at 16 intervals (n = 225), both packages."""
    return (JaxFOM((2, 2), 16).h1_0_product,
            ThermalBlockFOM((2, 2), 16, device="cpu").h1_0_product)


@pytest.mark.parametrize("power_iters,weighted", [(0, False), (2, False), (1, True)],
                         ids=["plain", "power2", "h1_0_power1"])
def test_range_finder_matches_jax(products, power_iters, weighted):
    X, _ = _decaying(225, 20, decay=0.5, seed=1)
    jP, tP = products if weighted else (None, None)
    Q = trsvd.range_finder(torch.tensor(X), 6, power_iters=power_iters, product=tP,
                           omega=_omega(5, 20, 6))
    jQ = jrsvd.range_finder(jnp.asarray(X), 6, power_iters=power_iters, product=jP,
                            seed=5)
    _signed_close(Q.numpy(), jQ, 1e-10)


@pytest.mark.parametrize("complex_,weighted", [(False, False), (True, False), (False, True)],
                         ids=["real", "complex", "h1_0"])
def test_rsvd_and_pod_randomized_match_jax(products, complex_, weighted):
    X, _ = _decaying(225, 16, decay=0.5, seed=2, complex_=complex_)
    jP, tP = products if weighted else (None, None)
    dt = jnp.complex128 if complex_ else jnp.float64
    om = _omega(7, 16, 7, dt)
    U, s, V = trsvd.rsvd(torch.tensor(X), 4, oversample=3, power_iters=1, product=tP,
                         omega=om)
    jU, js, jV = jrsvd.rsvd(jnp.asarray(X), 4, oversample=3, power_iters=1, product=jP,
                            seed=7)
    assert np.abs(s.numpy() - np.asarray(js)).max() <= 1e-10 * float(js[0])
    _signed_close(U.numpy(), jU, 1e-10)
    _signed_close(V.numpy(), jV, 1e-10)
    om = _omega(9, 16, 8, dt)
    M, sm = trsvd.pod_randomized(torch.tensor(X), product=tP, modes=5, rtol=0.1,
                                 oversample=3, power_iters=1, omega=om)
    jM, jsm = jrsvd.pod_randomized(jnp.asarray(X), product=jP, modes=5, rtol=0.1,
                                   oversample=3, power_iters=1, seed=9)
    assert sm.shape == jsm.shape
    assert np.abs(sm.numpy() - np.asarray(jsm)).max() <= 1e-10 * float(jsm[0])
    _signed_close(M.numpy(), jM, 1e-10)


@pytest.mark.parametrize("max_rank,tol", [(None, 1e-4), (10, 1e-14)], ids=["tol", "max_rank"])
def test_range_finder_adaptive_matches_jax(max_rank, tol):
    """The same blocks in the same order: the same basis size, the same
    approximation Q Q^H X and certified bound, to 1e-10 of ||X||_2 = 1 (the
    last columns of Q resolve directions of X at 1e-8 of its norm, where
    rounding sets their digits, and at ``tol`` so does it the bound's)."""
    X, _ = _decaying(100, 30, decay=0.5, seed=3)
    seed, block, n_probes = 11, 6, 10
    kp, kb = jax.random.split(jax.random.key(seed))
    widths = [block] * 5 if max_rank is None else [6, 4]
    omegas = [np.asarray(jrsvd._test_matrix(kp, 30, n_probes, jnp.float64))]
    omegas += [np.asarray(jrsvd._test_matrix(jax.random.fold_in(kb, it), 30, w, jnp.float64))
               for it, w in enumerate(widths)]
    Q, bound = trsvd.range_finder_adaptive(torch.tensor(X), tol, block=block,
                                           n_probes=n_probes, max_rank=max_rank,
                                           omega=omegas)
    jQ, jbound = jrsvd.range_finder_adaptive(jnp.asarray(X), tol, block=block,
                                             n_probes=n_probes, max_rank=max_rank,
                                             seed=seed)
    assert Q.shape == jQ.shape
    assert abs(bound - jbound) <= 1e-10
    Q, jQ = Q.numpy(), np.asarray(jQ)
    assert np.abs(Q @ (Q.T @ X) - jQ @ (jQ.T @ X)).max() <= 1e-10


# ---------------------------------------------------------------------------
# tests/test_rsvd.py's oracles on the port alone (its own generator)


@pytest.mark.parametrize("complex_", [False, True], ids=["real", "complex"])
def test_rsvd_matches_exact_svd(complex_):
    X, s_true = _decaying(120, 40, seed=4, complex_=complex_)
    U, s, V = trsvd.rsvd(torch.tensor(X), 8, power_iters=2, seed=3)
    assert U.dtype == V.dtype == torch.tensor(X).dtype
    np.testing.assert_allclose(s.numpy(), s_true[:8], rtol=1e-9)
    np.testing.assert_allclose((U.conj().T @ U).numpy(), np.eye(8), atol=1e-12)
    np.testing.assert_allclose((V.conj().T @ V).numpy(), np.eye(8), atol=1e-12)
    err = np.linalg.norm(X - (U.numpy() * s.numpy()) @ V.numpy().conj().T, 2)
    assert err <= 1.05 * s_true[8] + 1e-12


def test_pod_randomized_matches_pod_and_product(products):
    """On an exact rank-5 matrix the randomised POD and the method of
    snapshots give the same singular values and subspace; with the h1_0
    product the modes are R-orthonormal."""
    from rla4mor_tpu_torch.core import pod

    rng = np.random.default_rng(7)
    X = torch.tensor(rng.standard_normal((225, 5)) @ rng.standard_normal((5, 30)))
    Mr, sr = trsvd.pod_randomized(X, modes=10, rtol=1e-8, seed=4)
    Mp, sp = pod(X, modes=10, rtol=1e-6)
    assert Mr.shape[1] == 5 == Mp.shape[1]
    np.testing.assert_allclose(sr.numpy(), sp.numpy(), rtol=1e-6)
    assert torch.linalg.matrix_norm(Mr @ Mr.T - Mp @ Mp.T, ord=2) < 1e-8
    R = products[1]
    Mw, _ = trsvd.pod_randomized(X, product=R, modes=4, rtol=None, seed=5)
    np.testing.assert_allclose(R.inner(Mw).numpy(), np.eye(4), atol=1e-10)


def test_range_finder_adaptive_certifies_and_stops():
    X, _ = _decaying(150, 80, decay=0.6, seed=13)
    Q, bound = trsvd.range_finder_adaptive(torch.tensor(X), 1e-6, block=6, seed=17)
    assert bound <= 1e-6 and Q.shape[1] <= 48
    true = np.linalg.norm(X - Q.numpy() @ (Q.numpy().T @ X), 2)
    assert true <= bound
    X, _ = _decaying(60, 30, decay=0.95, seed=19)  # slow decay: stops at max_rank
    Q, _ = trsvd.range_finder_adaptive(torch.tensor(X), 1e-14, block=8, max_rank=16, seed=23)
    assert Q.shape[1] == 16
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(16), atol=1e-10)
