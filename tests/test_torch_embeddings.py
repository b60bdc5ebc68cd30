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


# --- the embedding zoo: Rademacher, sparse-sign, block and streamed Gaussian,
# complex Omegas (JAX operators carried across: from_matrix / from_plan) ----

def _zoo_pair(kind, sqrts, use_sqrt, n=225, k=40, block_cols=4096):
    """(JAX embedding, port embedding with the JAX operator carried in)."""
    jq, tq = sqrts if use_sqrt else (None, None)
    cx = kind.endswith("_c")
    base = kind.removesuffix("_c")
    if base == "sparse":
        je = jemb.SparseSignEmbedding.make(n, sqrt_product=jq, range_dim=k, seed=3, s=4)
        rows, signs = je._plan()
        te = temb.SparseSignEmbedding.from_plan(np.asarray(rows), np.asarray(signs), k,
                                                sqrt_product=tq, device="cpu")
        return je, te
    jcls, tcls, extra = {
        "gaussian": (jemb.GaussianEmbedding, temb.GaussianEmbedding, {}),
        "rademacher": (jemb.RademacherEmbedding, temb.RademacherEmbedding, {}),
        "block": (jemb.BlockGaussianEmbedding, temb.BlockGaussianEmbedding,
                  {"max_block_size": 16}),
        "streamed": (jemb.StreamedGaussianEmbedding, temb.StreamedGaussianEmbedding,
                     {"block_cols": block_cols}),
    }[base]
    je = jcls.make(n, sqrt_product=jq, range_dim=k, seed=3, complex_dtype=cx, **extra)
    te = tcls.from_matrix(np.asarray(je.random_matrix()), sqrt_product=tq, seed=3,
                          device="cpu", **extra)
    assert te.complex_dtype == cx
    return je, te


ZOO = ["gaussian_c", "rademacher", "rademacher_c", "sparse", "block", "block_c",
       "streamed", "streamed_c"]


@pytest.mark.parametrize("use_sqrt", [False, True], ids=["l2", "h1_0"])
@pytest.mark.parametrize("kind", ZOO)
def test_zoo_matches_jax(sqrts, kind, use_sqrt):
    """apply / apply_adjoint / matrix / source_array of each embedding equal
    the JAX package's with its operator carried in, to 1e-12 (float64;
    complex128 for a complex Omega, whose data are complex)."""
    je, te = _zoo_pair(kind, sqrts, use_sqrt)
    rng = np.random.RandomState(0)
    U = rng.normal(size=(225, 5))
    if kind.endswith("_c"):
        U = U + 1j * rng.normal(size=(225, 5))
    tout = te.apply(torch.tensor(U))
    assert rel(tout, je.apply(jnp.asarray(U))) < 1e-12
    assert rel(tout, te.matrix() @ torch.tensor(U).to(te.matrix().dtype)) < 1e-12
    assert rel(te.matrix(), je.matrix()) < 1e-12
    assert rel(te.source_array(), je.source_array()) < 1e-12
    V = rng.normal(size=(te.range_dim, 2)) + 1j * rng.normal(size=(te.range_dim, 2))
    assert rel(te.apply_adjoint(torch.tensor(V)), je.apply_adjoint(jnp.asarray(V))) < 1e-12
    if kind.startswith("block"):
        for b in range(te.n_blocks):
            assert rel(te.block_source_array(b), je.block_source_array(b)) < 1e-12


@pytest.mark.parametrize("cx", [False, True], ids=["real", "complex"])
def test_streamed_strips_match_jax(cx):
    """The streamed sketch over several strips (n = 2 TILE_N + 100, block_cols
    = TILE_N) equals the JAX package's streamed scan, to 1e-12."""
    n = 2 * seeding.TILE_N + 100
    je, te = _zoo_pair("streamed_c" if cx else "streamed", None, False, n=n, k=24,
                       block_cols=seeding.TILE_N)
    rng = np.random.RandomState(1)
    U = rng.normal(size=(n, 3)) + (1j * rng.normal(size=(n, 3)) if cx else 0)
    assert rel(te.apply(torch.tensor(U)), je.apply(jnp.asarray(U))) < 1e-12


@pytest.mark.parametrize("cx", [False, True], ids=["real", "complex"])
def test_block_and_streamed_are_the_gaussian(cx):
    """At one seed, Block rows and Streamed strips are the Gaussian's Omega
    bit for bit (several row blocks, strips and tiles: n = 9000, k = 200),
    and their sketches equal its sketch to 1e-13."""
    n, k = 9000, 200
    kw = dict(range_dim=k, seed=5, device="cpu", complex_dtype=cx)
    g = temb.GaussianEmbedding.make(n, **kw)
    b = temb.BlockGaussianEmbedding.make(n, max_block_size=70, **kw)
    s = temb.StreamedGaussianEmbedding.make(n, block_cols=seeding.TILE_N, **kw)
    M = g.random_matrix()
    assert M.dtype == (torch.complex128 if cx else torch.float64)
    assert torch.equal(b.random_matrix(), M) and torch.equal(s.random_matrix(), M)
    assert torch.equal(b.random_block(2), M[140:210])
    gen = torch.Generator().manual_seed(0)
    X = torch.randn(n, 3, generator=gen, dtype=torch.float64)
    if cx:
        X = torch.complex(X, torch.randn(n, 3, generator=gen, dtype=torch.float64))
    y = g.apply(X)
    assert rel(b.apply(X), y) < 1e-13 and rel(s.apply(X), y) < 1e-13
    if cx:  # E|w|^2 = 1/k, real and imaginary parts each 1/(2k)
        assert abs(float((M.abs() ** 2).mean()) * k - 1) < 0.01
        assert abs(float((M.real ** 2).mean()) * 2 * k - 1) < 0.01


def test_rademacher_and_sparse_sign_operators():
    """Rademacher entries are +-1/sqrt(k), or (s1 + i s2)/sqrt(2k) of modulus
    1/sqrt(k); the sparse-sign sketch (a scatter-add) equals its matrix
    (each column s entries +-1/sqrt(s), repeats added) to 1e-13, complex data
    too; redrawn seeds give other operators of the same family."""
    n, k = 5000, 64
    r = temb.RademacherEmbedding.make(n, range_dim=k, seed=6, device="cpu")
    assert torch.equal(r.random_matrix().abs(), torch.full((k, n), 1 / k**0.5,
                                                           dtype=torch.float64))
    rc = temb.RademacherEmbedding.make(n, range_dim=k, seed=6, device="cpu",
                                       complex_dtype=True)
    assert torch.allclose(rc.random_matrix().abs(), torch.tensor(1 / k**0.5,
                                                                 dtype=torch.float64))
    s = temb.SparseSignEmbedding.make(n, range_dim=k, seed=1, s=8, device="cpu")
    M = s.random_matrix()
    rows, signs = (t.numpy() for t in s.plan)
    want = np.zeros((k, n))
    np.add.at(want, (rows, np.arange(n)[:, None].repeat(8, axis=1)), signs / 8**0.5)
    assert np.abs(M.numpy() - want).max() <= 1e-15
    assert set(np.unique(signs)) == {-1, 1} and 0 <= rows.min() and rows.max() < k
    gen = torch.Generator().manual_seed(2)
    X = torch.complex(torch.randn(n, 3, generator=gen, dtype=torch.float64),
                      torch.randn(n, 3, generator=gen, dtype=torch.float64))
    assert rel(s.apply(X), M.to(X.dtype) @ X) < 1e-13
    assert rel(s.apply(X.real), M @ X.real) < 1e-13
    for e in (r, rc, s):
        e2 = e.with_seed(9)
        assert type(e2) is type(e) and e2.fields() == {**e.fields(), "seed": 9}
        assert not torch.equal(e2.random_matrix(), e.random_matrix())
        assert e.with_range_dim(32).fields() == {**e.fields(), "range_dim": 32}


@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "block", "streamed", "srht",
                                  "sparse", "hwprng"])
def test_complex_dtype_accepted_and_refused_as_in_jax(kind):
    """``complex_dtype=True`` is accepted where the JAX package accepts it,
    with its a = 2 dimension formula, and refused by the sparse-sign and
    hardware-PRNG embeddings, whose Omegas are real."""
    jcls, tcls = {
        "gaussian": (jemb.GaussianEmbedding, temb.GaussianEmbedding),
        "rademacher": (jemb.RademacherEmbedding, temb.RademacherEmbedding),
        "block": (jemb.BlockGaussianEmbedding, temb.BlockGaussianEmbedding),
        "streamed": (jemb.StreamedGaussianEmbedding, temb.StreamedGaussianEmbedding),
        "srht": (jemb.SrhtEmbedding, temb.SrhtEmbedding),
        "sparse": (jemb.SparseSignEmbedding, temb.SparseSignEmbedding),
        "hwprng": (jemb.HwPrngGaussianEmbedding, temb.HwPrngGaussianEmbedding),
    }[kind]
    args = dict(epsilon=0.5, delta=0.1, oblivious_dim=5)
    if kind in ("sparse", "hwprng"):
        with pytest.raises(AssertionError):
            jcls.make(10000, complex_dtype=True, **args)
        with pytest.raises((ValueError, TypeError)):
            tcls.make(10000, complex_dtype=True, device="cpu", **args)
        return
    je = jcls.make(10000, complex_dtype=True, **args)
    te = tcls.make(10000, complex_dtype=True, device="cpu", **args)
    assert te.range_dim == je.range_dim > jcls.make(10000, **args).range_dim
    assert te.complex_dtype
    want = torch.float64 if kind == "srht" else torch.complex128
    assert te.with_seed(1).with_range_dim(50).random_matrix().dtype == want
