"""The port's classical reductor, the sketched reductor's empty-basis
fallback and ``reduce_adaptive``, held against the JAX package (f64, CPU).

Thermal block 2x2, 16 intervals (n = 225). The Gaussian embeddings are
carried from the JAX side: every embedding the adaptive loop asks for
(``with_seed``, ``with_range_dim``) is the JAX package's Omega for the same
(range_dim, seed). Tolerance 1e-10 relative (f64, different summation
orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.ops.embeddings as jemb
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.mor import ClassicalReductor as JaxClassical
from rla4mor_tpu.mor import SketchedReductor as JaxReductor
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.mor import ClassicalReductor, SketchedReductor

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

N = 225


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def foms():
    return JaxFOM((2, 2), 16), ThermalBlockFOM((2, 2), 16, device="cpu")


def _mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _batched(count, seed):
    jm, tm = _mus(count, seed)
    return {"diffusion": jnp.stack([m["diffusion"] for m in jm])}, mu_stack(tm)


class _Carried(temb.GaussianEmbedding):
    """Port Gaussian whose redraws carry the JAX package's Omega for the
    same (range_dim, seed): one ``from_matrix`` per embedding asked for."""

    made: dict = {}
    sqrt = None

    @classmethod
    def carried(cls, k, n, seed, jsqrt=None, tsqrt=None):
        key = (k, n, seed, jsqrt is not None)
        if key not in cls.made:
            je = jemb.GaussianEmbedding(k, n, seed, sqrt_product=jsqrt)
            emb = cls.from_matrix(np.asarray(je.random_matrix()), sqrt_product=tsqrt,
                                  seed=seed, device="cpu")
            emb.sqrt = (jsqrt, tsqrt)
            cls.made[key] = emb
        return cls.made[key]

    def _again(self, k, seed):
        jsqrt, tsqrt = self.sqrt or (None, None)
        return self.carried(k, self.source_dim, seed, jsqrt, tsqrt)

    def with_seed(self, seed):
        return self._again(self.range_dim, seed)

    def with_range_dim(self, range_dim):
        return self._again(range_dim, self.seed)


# ---------------------------------------------------------------------------
# classical reductor


@pytest.mark.parametrize("orthonormalize", [True, False])
def test_classical_reductor_matches_jax(foms, orthonormalize):
    jfom, tfom = foms
    jred = JaxClassical(jfom, product=jfom.h1_0_product, orthonormalize=orthonormalize)
    tred = ClassicalReductor(tfom, product=tfom.h1_0_product,
                             orthonormalize=orthonormalize)
    jm, tm = _mus(5, 1)
    jred.extend_basis(jfom.solve_many(jm[:3]))
    tred.extend_basis(tfom.solve_many(tm[:3]))
    jred.extend_basis(jfom.solve(jm[3]), mu=jm[3])
    tred.extend_basis(tfom.solve(tm[3]), mu=tm[3])
    assert tred.basis_size == jred.basis_size == 4
    assert rel(tred.rb, jred.rb) < 1e-10
    jrom, trom = jred.reduce(), tred.reduce()
    assert rel(trom.lhs.stack, jrom.lhs.stack) < 1e-10
    assert rel(trom.rhs.stack, jrom.rhs.stack) < 1e-10
    assert rel(trom.output_functional.stack, jrom.output_functional.stack) < 1e-10
    assert rel(trom.error_estimator.gram, jrom.error_estimator.gram) < 1e-10
    jb, tb = _batched(6, 2)
    ju, jest = jrom.solve_and_estimate_batch(jb)
    tu, test_ = trom.solve_and_estimate_batch(tb)
    assert rel(tu, ju) < 1e-10
    assert rel(test_, jest) < 1e-10
    # one Mu, and (r, b) columns at one Mu, agree with the batch
    one = {"diffusion": tb["diffusion"][2]}
    assert rel(trom.estimate_error(one), np.asarray(test_)[2]) < 1e-12
    cols = trom.error_estimator.estimate_error(tu[:3].T, one)
    assert rel(cols[2], np.asarray(test_)[2]) < 1e-12
    assert rel(tred.reconstruct(tu[0]), jred.reconstruct(ju[0])) < 1e-10


def test_classical_estimator_is_the_exact_residual(foms):
    """The JAX package's oracle: the estimate is ||A(mu) u - b(mu)||_{R^-1}."""
    _, tfom = foms
    Ru = tfom.h1_0_product
    red = ClassicalReductor(tfom, product=Ru)
    _, tm = _mus(7, 5)
    red.extend_basis(tfom.solve_many(tm[:6]))
    rom = red.reduce()
    mu = tm[6]
    u = red.reconstruct(rom.solve(mu)).numpy()
    r = tfom.assemble_sparse(mu) @ u - tfom.assemble_rhs(mu)
    want = float(np.sqrt(r @ Ru.inv.apply_host(r)))
    assert abs(float(rom.estimate_error(mu)) - want) < 1e-9 * max(1.0, want)


def _primal_pair(foms, primal):
    """The same primal embedding in both packages: a Gaussian carried from
    the JAX side, or an SRHT over the sqrt factor with the JAX plan."""
    jfom, tfom = foms
    if primal == "gaussian":
        return (jemb.GaussianEmbedding.make(N, range_dim=40, seed=1),
                _Carried.carried(40, N, 1))
    je = jemb.SrhtEmbedding.make(N, sqrt_product=jfom.h1_0_product.sqrt,
                                 range_dim=60, seed=3)
    signs, sampling, _ = jax_srht_plan(je.key, N, 60)
    te = temb.SrhtEmbedding.from_plan(N, 60, np.asarray(signs), np.asarray(sampling),
                                      sqrt_product=tfom.h1_0_product.sqrt,
                                      device="cpu")
    return je, te


@pytest.mark.parametrize("primal", ["gaussian", "srht"])
@pytest.mark.parametrize("projection", ["galerkin", "minres"])
def test_empty_basis_reduce_matches_jax(foms, projection, primal):
    """Both packages fall back to the classical reductor on an empty basis,
    whatever the primal sketch."""
    jfom, tfom = foms
    je, te = _primal_pair(foms, primal)
    jred = JaxReductor(jfom, embedding_primal=je, product=jfom.h1_0_product,
                       projection=projection, log_level=30)
    tred = SketchedReductor(tfom, embedding_primal=te, product=tfom.h1_0_product,
                            projection=projection, log_level=30)
    jrom, trom = jred.reduce(seed=3), tred.reduce(seed=3)
    assert trom.lhs.stack.shape == tuple(jrom.lhs.stack.shape) == (4, 0, 0)
    jb, tb = _batched(5, 6)
    jest = jax.vmap(lambda mu: jrom.estimate_error(mu))(jb)
    test_ = trom.estimate_error(tb)
    assert test_.shape == (5,)
    assert rel(test_, jest) < 1e-10
    assert rel(trom.error_estimator.gram, jrom.error_estimator.gram) < 1e-10


# ---------------------------------------------------------------------------
# reduce_adaptive


def _adaptive_pair(foms, k, k_online, projection="galerkin"):
    jfom, tfom = foms
    jq, tq = jfom.h1_0_product.sqrt, tfom.h1_0_product.sqrt
    jred = JaxReductor(
        jfom, embedding_primal=jemb.GaussianEmbedding(k, N, 2, sqrt_product=jq),
        embedding_online=jemb.GaussianEmbedding(k_online, k, 9),
        product=jfom.h1_0_product, projection=projection, log_level=40)
    tred = SketchedReductor(
        tfom, embedding_primal=_Carried.carried(k, N, 2, jq, tq),
        embedding_online=_Carried.carried(k_online, k, 9),
        product=tfom.h1_0_product, projection=projection, log_level=40)
    jm, tm = _mus(5, 8)
    jred.extend_basis(jfom.solve_many(jm))
    tred.extend_basis(tfom.solve_many(tm))
    return jred, tred


ADAPTIVE = [  # (primal k, online k, tol, max_rounds, projection)
    (160, 4, 0.15, 6, "galerkin"),   # doubles until certified
    (16, 4, 1e-12, 6, "galerkin"),   # doubles up to the primal k, uncertified
    (160, 4, 1e-12, 2, "minres"),    # rounds exhausted, uncertified
    (160, 150, 0.15, 6, "galerkin"),  # certified in one round
]


@pytest.mark.parametrize("k,k_online,tol,max_rounds,projection", ADAPTIVE,
                         ids=["doubles", "stops_at_primal", "rounds_exhausted",
                              "one_round"])
def test_reduce_adaptive_matches_jax(foms, k, k_online, tol, max_rounds, projection):
    jred, tred = _adaptive_pair(foms, k, k_online, projection)
    jb, tb = _batched(20, 77)
    jrom, jinfo = jred.reduce_adaptive(jb, seed=5, tol=tol, max_rounds=max_rounds)
    trom, tinfo = tred.reduce_adaptive(tb, seed=5, tol=tol, max_rounds=max_rounds)
    assert (tinfo["online_dim"], tinfo["rounds"], tinfo["certified"]) == \
        (jinfo["online_dim"], jinfo["rounds"], jinfo["certified"])
    assert abs(tinfo["max_rel_dev"] - jinfo["max_rel_dev"]) < 1e-10 * max(
        1.0, jinfo["max_rel_dev"])
    assert tred.embedding_online.range_dim == jred.embedding_online.range_dim \
        == tinfo["online_dim"]
    assert rel(trom.error_estimator.lhs.stack, jrom.error_estimator.lhs.stack) < 1e-10
    ju, jest = jrom.solve_and_estimate_batch(jb)
    tu, test_ = trom.solve_and_estimate_batch(tb)
    assert rel(test_, jest) < 1e-10
    expect = {"doubles": lambda i: i["certified"] and i["online_dim"] > 4,
              "stops_at_primal": lambda i: i["online_dim"] == 16 and not i["certified"],
              "rounds_exhausted": lambda i: i["rounds"] == 3 and not i["certified"],
              "one_round": lambda i: i["rounds"] == 1 and i["certified"]}
    case = ["doubles", "stops_at_primal", "rounds_exhausted", "one_round"][
        ADAPTIVE.index((k, k_online, tol, max_rounds, projection))]
    assert expect[case](tinfo), tinfo


def test_reduce_adaptive_needs_a_basis(foms):
    _, tfom = foms
    red = SketchedReductor(tfom, embedding_primal=_Carried.carried(40, N, 1),
                           product=tfom.h1_0_product, log_level=40)
    with pytest.raises(ValueError):
        red.reduce_adaptive(mu_stack(_mus(3, 0)[1]))


def test_with_range_dim(foms):
    _, tfom = foms
    q = tfom.h1_0_product.sqrt
    for e in (temb.GaussianEmbedding(20, N, 3, q, device="cpu"),
              temb.SrhtEmbedding(20, N, 3, q, device="cpu")):
        e2 = e.with_range_dim(40)
        assert type(e2) is type(e) and e2.range_dim == 40 and e2.seed == 3
        assert e2.sqrt_product is q and e2.apply(torch.ones(N)).shape == (40,)
    ident = temb.IdentityEmbedding(N, device="cpu")
    assert ident.with_range_dim(N) is ident
    with pytest.raises(ValueError):
        ident.with_range_dim(2 * N)
