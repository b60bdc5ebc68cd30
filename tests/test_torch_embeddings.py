"""The port's embeddings held against the JAX package (f64, CPU).

Gaussian (Omega carried from JAX), identity and SRHT (plan carried from
JAX) embeddings over the thermal block's h1_0 sqrt factor: ``apply`` equals
``matrix() @ U`` and equals the JAX package, to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.ops.embeddings as jemb
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.ops import dims as jdims
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.ops import dims as tdims
from rla4mor_tpu_torch.ops import seeding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def sqrts():
    return (JaxFOM((2, 2), 16).h1_0_product.sqrt,
            ThermalBlockFOM((2, 2), 16, device="cpu").h1_0_product.sqrt)


def _pair(kind, sqrts, use_sqrt):
    jq, tq = sqrts if use_sqrt else (None, None)
    n, k = 225, 40
    if kind == "gaussian":
        je = jemb.GaussianEmbedding.make(n, sqrt_product=jq, range_dim=k, seed=2)
        te = temb.GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                                sqrt_product=tq, device="cpu")
    elif kind == "identity":
        je = jemb.IdentityEmbedding(n, sqrt_product=jq)
        te = temb.IdentityEmbedding(n, sqrt_product=tq, device="cpu")
    else:
        je = jemb.SrhtEmbedding.make(n, sqrt_product=jq, range_dim=k, seed=2)
        signs, sampling, _ = jax_srht_plan(je.key, n, k)
        te = temb.SrhtEmbedding.from_plan(n, k, np.array(signs), np.array(sampling),
                                          sqrt_product=tq, device="cpu")
    return je, te


@pytest.mark.parametrize("use_sqrt", [False, True], ids=["l2", "h1_0"])
@pytest.mark.parametrize("kind", ["gaussian", "identity", "srht", "srht_onepass"])
def test_apply_equals_matrix_and_jax(sqrts, kind, use_sqrt, monkeypatch):
    if kind == "srht_onepass":
        monkeypatch.setattr(jemb.SrhtEmbedding, "_ONEPASS_MIN_DIM", 1)
        monkeypatch.setattr(temb.SrhtEmbedding, "_ONEPASS_MIN_DIM", 1)
    je, te = _pair(kind.split("_")[0], sqrts, use_sqrt)
    U = np.random.RandomState(0).normal(size=(225, 6))
    tout = te.apply(torch.tensor(U))
    assert rel(tout, te.matrix() @ torch.tensor(U)) < 1e-12
    assert rel(tout, je.apply(jnp.asarray(U))) < 1e-12
    assert rel(te.matrix(), je.matrix()) < 1e-12
    assert rel(te.apply(torch.tensor(U[:, 0])), je.apply(jnp.asarray(U[:, 0]))) < 1e-12
    V = np.random.RandomState(1).normal(size=(te.range_dim, 2))
    assert rel(te.apply_adjoint(torch.tensor(V)), je.apply_adjoint(jnp.asarray(V))) < 1e-12


def test_seeded_gaussian_is_one_operator_on_every_layout():
    """Row blocks and column strips are slices of the same tile grid."""
    k, n = 150, 5000
    full = seeding.gaussian_matrix(7, k, n, device="cpu")
    assert full.shape == (k, n)
    assert torch.equal(seeding.gaussian_rows(7, n, 100, 150) / k**0.5, full[100:150])
    assert torch.allclose(seeding.gaussian_cols(7, k, 4000, 700), full[:, 4000:4700],
                          rtol=0, atol=1e-15)
    assert not torch.equal(seeding.gaussian_matrix(8, k, n, device="cpu"), full)
    assert abs(float(full.std()) * k**0.5 - 1.0) < 0.02


def test_seeded_embeddings_apply_equals_matrix():
    g = temb.GaussianEmbedding.make(300, range_dim=20, seed=4, device="cpu")
    s = temb.SrhtEmbedding.make(300, range_dim=20, seed=4, device="cpu")
    U = torch.tensor(np.random.RandomState(2).normal(size=(300, 3)))
    for e in (g, s, g.with_seed(5), s.with_seed(5)):
        assert rel(e.apply(U), e.matrix() @ U) < 1e-12
    assert not torch.equal(g.matrix(), g.with_seed(5).matrix())
    assert temb.IdentityEmbedding(300, device="cpu").with_seed(9).range_dim == 300


@pytest.mark.parametrize("args", [(0.5, 0.1, 5, 10000), (0.3, 0.01, 20, 4225)])
def test_dims_match_jax(args):
    eps, delta, d, n = args
    assert tdims.gaussian_dim(eps, delta, d) == jdims.gaussian_dim(eps, delta, d)
    assert tdims.srht_dim(eps, delta, d, n) == jdims.srht_dim(eps, delta, d, n)
    assert tdims.resolve_dim("srht", n, None, eps, delta, d) == \
        jdims.resolve_dim("srht", n, None, eps, delta, d)


@pytest.mark.parametrize("kind", ["gaussian", "srht"])
def test_complex_data_through_a_real_embedding(kind):
    """Mirrors ``tests/test_complex.py::test_complex_embedding_apply``: a
    real Omega applied to complex data (and its adjoint to complex sketches)
    promotes to complex128 and equals the JAX package, to 1e-12."""
    rng = np.random.RandomState(2)
    n, k = 64, 20
    if kind == "gaussian":
        je = jemb.GaussianEmbedding.make(n, range_dim=k, seed=4)
        te = temb.GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                                device="cpu")
    else:
        je = jemb.SrhtEmbedding.make(n, range_dim=k, seed=4)
        signs, sampling, _ = jax_srht_plan(je.key, n, k)
        te = temb.SrhtEmbedding.from_plan(n, k, np.array(signs), np.array(sampling),
                                          device="cpu")
    x = rng.normal(size=(n, 3)) + 1j * rng.normal(size=(n, 3))
    y = te.apply(torch.tensor(x))
    assert y.dtype == torch.complex128
    assert rel(y, je.apply(jnp.asarray(x))) < 1e-12
    assert rel(y, te.matrix().numpy() @ x) < 1e-12
    v = rng.normal(size=(k, 2)) + 1j * rng.normal(size=(k, 2))
    w = te.apply_adjoint(torch.tensor(v))
    assert w.dtype == torch.complex128
    assert rel(w, je.apply_adjoint(jnp.asarray(v))) < 1e-12
