"""The port's reductor options, strong greedy and padded (fixed-shape)
reductor held against the JAX package (f64, CPU).

Mirrors of ``tests/test_sketched_reductor.py``'s tests of
``extend_basis_blocked`` / ``_streamed``, ``rb_greedy_strong``,
``truncation_rtol``, ``rb_greedy_padded`` and the padded append, plus
``PaddedSketchedReductor`` with ``rb_greedy_no_retrace`` and
``StationaryFOM.residual_norm`` against the JAX package. Thermal block 2x2
at 16 intervals (n = 225; the append test at 8, as its JAX original);
Gaussian Omegas carried from the JAX side, parameters drawn with numpy,
snapshots solved once by the JAX FOM. The JAX side runs once per shape
(its greedies compile an extension) and is shared through module fixtures.

Tolerances: 1e-10 relative to max for states and solutions (f64, other
summation orders), 1e-8 for greedy estimates (as the JAX tests hold the
padded greedy to the plain one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.ops.embeddings as jemb
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.mor import PaddedSketchedReductor as JaxPadded
from rla4mor_tpu.mor import SketchedReductor as JaxReductor
from rla4mor_tpu.mor import rb_greedy_no_retrace as jax_no_retrace
from rla4mor_tpu.mor import rb_greedy_padded as jax_greedy_padded
from rla4mor_tpu.mor import rb_greedy_strong as jax_greedy_strong

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.mor import (
    PaddedSketchedReductor,
    SketchedReductor,
    rb_greedy,
    rb_greedy_no_retrace,
    rb_greedy_padded,
    rb_greedy_strong,
)

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Carried(temb.GaussianEmbedding):
    """Port Gaussian whose redraws carry the JAX package's Omega for the
    same (range_dim, source_dim, seed)."""

    made: dict = {}

    @classmethod
    def of(cls, k, n, seed):
        if (k, n, seed) not in cls.made:
            omega = np.asarray(jemb.GaussianEmbedding(k, n, seed).random_matrix())
            cls.made[k, n, seed] = cls.from_matrix(omega, seed=seed, device="cpu")
        return cls.made[k, n, seed]

    def with_seed(self, seed):
        return self.of(self.range_dim, self.source_dim, seed)

    def with_range_dim(self, range_dim):
        return self.of(range_dim, self.source_dim, self.seed)


@pytest.fixture(scope="module")
def foms():
    return JaxFOM((2, 2), 16), ThermalBlockFOM((2, 2), 16, device="cpu")


def _mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _primal(foms, k, seed):
    """Gaussian k over the h1_0 sqrt factor, the JAX Omega carried."""
    jfom, tfom = foms
    jsqrt, tsqrt = jfom.h1_0_product.sqrt, tfom.h1_0_product.sqrt
    je = jemb.GaussianEmbedding(k, jfom.solution_dim, seed, sqrt_product=jsqrt)
    te = temb.GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                            sqrt_product=tsqrt, seed=seed, device="cpu")
    return je, te


def _setup(foms, k=150, seed=1, orthonormalize=True, projection="galerkin",
           k_online=60, padded_r_max=None, jax_side=True):
    """The JAX test's ``_setup`` on both sides (Gaussian primal k, online
    Gaussian k_online of seed + 100); a padded reductor where
    ``padded_r_max``."""
    jfom, tfom = foms
    je, te = _primal(foms, k, seed)
    jphi = jemb.GaussianEmbedding.make(k, range_dim=k_online, seed=seed + 100)
    tphi = Carried.of(k_online, k, seed + 100)
    if padded_r_max:
        kw = dict(product=None, r_max=padded_r_max, projection=projection, log_level=30)
        jred = JaxPadded(jfom, embedding_primal=je, embedding_online=jphi,
                         **{**kw, "product": jfom.h1_0_product})
        tred = PaddedSketchedReductor(tfom, embedding_primal=te, embedding_online=tphi,
                                      **{**kw, "product": tfom.h1_0_product})
        return jred, tred
    kw = dict(orthonormalize=orthonormalize, projection=projection, log_level=30)
    jred = (JaxReductor(jfom, embedding_primal=je, embedding_online=jphi,
                        product=jfom.h1_0_product, **kw) if jax_side else None)
    tred = SketchedReductor(tfom, embedding_primal=te, embedding_online=tphi,
                            product=tfom.h1_0_product, **kw)
    return jred, tred


@pytest.fixture(scope="module")
def six(foms):
    """6 parameters and their snapshots (JAX FOM, numpy), and the JAX
    reductor extended by all six at once."""
    jfom, _ = foms
    jm, tm = _mus(6, 0)
    U = np.asarray(jfom.solve_many(jm))
    jred, _ = _setup(foms)
    jred.extend_basis(jnp.asarray(U))
    return tm, U, jred


def _same_mus(jmus, tmus):
    return [tuple(np.asarray(m["diffusion"])) for m in jmus] == \
        [tuple(m["diffusion"].numpy()) for m in tmus]


# ---------------------------------------------------------------------------
# reductor options


def test_extend_basis_blocked(foms, six):
    """Blocks of 2 give the ROM of one batch extension (1e-8, as the JAX
    test), and the JAX package's state (1e-10)."""
    _, U, jred = six
    _, red_a = _setup(foms, jax_side=False)
    _, red_b = _setup(foms, jax_side=False)
    red_a.extend_basis(torch.tensor(U))
    red_b.extend_basis_blocked(torch.tensor(U), max_block_size=2)
    _, mu = _mus(1, 50)
    ua = red_a.rb @ red_a.reduce(seed=1).solve(mu[0])
    ub = red_b.rb @ red_b.reduce(seed=1).solve(mu[0])
    assert torch.allclose(ua, ub, atol=1e-8)
    assert rel(red_b.srb, np.asarray(jred.srb)) < 1e-10
    assert rel(red_b.rb, np.asarray(jred.rb)) < 1e-10
    assert rel(red_b.residual_lhs.stack, np.asarray(jred.residual_lhs.stack)) < 1e-10


def test_extend_basis_streamed_matches_batch(foms, six):
    """An iterator of column blocks gives the state of the same blocks one
    by one (1e-12, as the JAX test) and the JAX package's (1e-10)."""
    _, U, jred = six
    _, red_a = _setup(foms, jax_side=False)
    _, red_b = _setup(foms, jax_side=False)
    red_a.extend_basis_streamed(torch.tensor(U[:, i:i + 2]) for i in range(0, 6, 2))
    for i in range(0, 6, 2):
        red_b.extend_basis(torch.tensor(U[:, i:i + 2]))
    assert (red_a.srb - red_b.srb).abs().max() < 1e-12
    _, mu = _mus(1, 22)
    assert torch.allclose(red_a.reduce(seed=9).solve(mu[0]), red_b.reduce(seed=9).solve(mu[0]))
    assert rel(red_a.srb, np.asarray(jred.srb)) < 1e-10


def test_truncation_rtol_drops_dependent_columns(foms, six):
    """truncation_rtol > 0 drops duplicated snapshots from every container
    and keeps Galerkin exact at a training parameter; 0 keeps them all.
    The kept state is the JAX package's (1e-10)."""
    tm, U, jred = six
    jfom, tfom = foms
    Udup = np.concatenate([U[:, :5], U[:, :3]], axis=1)
    mus_dup = tm[:5] + tm[:3]
    _, red = _setup(foms, orthonormalize=False, jax_side=False)
    red.orthonormalize, red.truncation_rtol = True, 1e-8
    for j, mu in enumerate(mus_dup):
        red.extend_basis(torch.tensor(Udup[:, j]), mu=mu)
    assert red.basis_size == 5 and len(red.mu_basis) == 5
    assert red.rb.shape[1] == 5 and red.residual_lhs.stack.shape[-1] == 5
    assert torch.allclose(red.srb.T @ red.srb, torch.eye(5, dtype=torch.float64), atol=1e-10)
    rom = red.reduce(seed=7)
    u_rom = red.rb @ rom.solve(tm[0])
    u_ref = tfom.solve(tm[0])
    assert float(torch.linalg.norm(u_rom - u_ref) / torch.linalg.norm(u_ref)) < 1e-8
    assert np.isfinite(float(rom.estimate_error(tm[0])))

    # the kept columns are the Gram-Schmidt of the first five snapshots:
    # the JAX package's batch extension by six, cut to five
    _, red1 = _setup(foms, jax_side=False)
    red1.truncation_rtol = 1e-8
    red1.extend_basis(torch.tensor(Udup))
    assert red1.basis_size == 5
    assert rel(red1.srb, np.asarray(jred.srb)[:, :5]) < 1e-10
    assert rel(red1.rb, np.asarray(jred.rb)[:, :5]) < 1e-10

    _, red0 = _setup(foms, jax_side=False)
    red0.extend_basis(torch.tensor(Udup))
    assert red0.basis_size == 8


def test_residual_norm_matches_jax(foms, six):
    """||A(mu) u - b||, l2 and in the h1_0 norm, of one vector and of
    columns: 1e-10 against the JAX package."""
    tm, U, _ = six
    jfom, tfom = foms
    jm = [{"diffusion": jnp.asarray(m["diffusion"].numpy())} for m in tm]
    V = U[:, :3] + 1e-3 * np.random.RandomState(4).normal(size=(U.shape[0], 3))
    for prod_j, prod_t in ((None, None), (jfom.h1_0_product, tfom.h1_0_product)):
        assert rel(tfom.residual_norm(torch.tensor(V), tm[1], prod_t),
                   jfom.residual_norm(jnp.asarray(V), jm[1], prod_j)) < 1e-10
        assert rel(tfom.residual_norm(torch.tensor(V[:, 0]), tm[1], prod_t),
                   jfom.residual_norm(jnp.asarray(V[:, 0]), jm[1], prod_j)) < 1e-10
    assert float(tfom.residual_norm(torch.tensor(U[:, 2]), tm[2])) < 1e-10


# ---------------------------------------------------------------------------
# strong greedy


def test_greedy_strong(foms):
    """The strong greedy drives the true training error down, its last
    recorded max bounds the final ROM's training error (1.5x), the same
    trajectory comes when it solves the snapshots itself, and it selects
    the JAX package's first parameters with its error (1e-8; 2 extensions
    on the JAX side, whose greedy compiles an extension)."""
    jfom, tfom = foms
    jm, tm = _mus(20, 11)
    U = np.asarray(jfom.solve_many(jm))
    _, red = _setup(foms, k=200, jax_side=False)
    result = rb_greedy_strong(tfom, red, tm, max_extensions=6, snapshots=torch.tensor(U),
                              log_level=30)
    assert red.basis_size == 6
    assert result.max_estimates[-1] < result.max_estimates[0]
    Ru = tfom.h1_0_product
    errs = [float(Ru.norm(torch.tensor(U[:, i]) - red.rb @ result.rom.solve(mu)))
            for i, mu in enumerate(tm)]
    assert max(errs) <= result.max_estimates[-1] * 1.5

    _, red2 = _setup(foms, k=200, jax_side=False)
    result2 = rb_greedy_strong(tfom, red2, tm, max_extensions=6, log_level=30)
    assert [tuple(m["diffusion"].numpy()) for m in result2.selected_mus] == \
        [tuple(m["diffusion"].numpy()) for m in result.selected_mus]
    assert np.allclose(result2.max_estimates, result.max_estimates)

    jred, _ = _setup(foms, k=200)
    jres = jax_greedy_strong(jfom, jred, jm, max_extensions=2, snapshots=jnp.asarray(U),
                             log_level=30)
    assert _same_mus(jres.selected_mus, result.selected_mus[:2])
    assert np.allclose(result.max_estimates[:1], jres.max_estimates, rtol=1e-8)


# ---------------------------------------------------------------------------
# padded greedy and padded reductor


@pytest.mark.parametrize("projection", ["galerkin", "minres"])
def test_padded_greedy_matches_plain(foms, projection):
    """rb_greedy_padded (the fixed-shape masked sweep) selects the
    parameters of rb_greedy with its estimates (rtol 1e-8 galerkin, 1e-7
    minres, as the JAX tests), and the JAX package's rb_greedy_padded
    selects the same first 3 with the same estimates (galerkin, 1e-8; the
    JAX greedy pays an extension's compiles)."""
    jfom, tfom = foms
    minres = projection == "minres"
    jm, tm = _mus(15 if minres else 20, 7 if minres else 6)
    ext, seed, k_on = (5, 60, 90) if minres else (6, 40, 60)
    _, red_a = _setup(foms, projection=projection, k_online=k_on, jax_side=False)
    res_a = rb_greedy(tfom, red_a, tm, max_extensions=ext, online_seed=seed, log_level=30)
    jred, red_b = _setup(foms, projection=projection, k_online=k_on, jax_side=not minres)
    res_b = rb_greedy_padded(tfom, red_b, tm, max_extensions=ext, online_seed=seed,
                             log_level=30)
    assert [tuple(m["diffusion"].numpy()) for m in res_a.selected_mus] == \
        [tuple(m["diffusion"].numpy()) for m in res_b.selected_mus]
    assert np.allclose(res_a.max_estimates, res_b.max_estimates, rtol=1e-7 if minres else 1e-8)
    if not minres:
        jres = jax_greedy_padded(jfom, jred, jm, max_extensions=3, online_seed=seed,
                                 log_level=30)
        assert _same_mus(jres.selected_mus, res_b.selected_mus[:3])
        assert np.allclose(res_b.max_estimates[:2], jres.max_estimates, rtol=1e-8)


def test_no_retrace_greedy_matches_jax(foms):
    """PaddedSketchedReductor + rb_greedy_no_retrace against the JAX
    package's: the same parameters and estimates (1e-8), the same padded
    state and ROM (1e-10), every tensor at r_max columns throughout."""
    jfom, tfom = foms
    jm, tm = _mus(20, 8)
    jred, tred = _setup(foms, padded_r_max=4)
    shapes = [tuple(t.shape) for t in tred.state[:4]]
    tres = rb_greedy_no_retrace(tfom, tred, tm, online_seed=3, log_level=30)
    jres = jax_no_retrace(jfom, jred, jm, online_seed=3, log_level=30)
    assert [tuple(t.shape) for t in tred.state[:4]] == shapes
    assert tred.basis_size == jred.basis_size == 4
    assert _same_mus(jres.selected_mus, tres.selected_mus)
    assert np.allclose(tres.max_estimates, jres.max_estimates, rtol=1e-8)
    for name in ("srb", "res_lhs", "out", "rb"):
        assert rel(getattr(tred.state, name), np.asarray(getattr(jred.state, name))) < 1e-10
    jrom, trom = jres.rom, tres.rom
    assert rel(trom.lhs.stack, np.asarray(jrom.lhs.stack)) < 1e-10
    y = trom.solve(tm[3])
    assert rel(tred.reconstruct(y), np.asarray(jred.reconstruct(jrom.solve(jm[3])))) < 1e-10


def test_padded_append_skips_dependent_columns():
    """A snapshot already (numerically) in the basis is skipped: ncols stays,
    the state is untouched, the masked systems stay nonsingular; a new
    direction still appends (grid 8, as the JAX test)."""
    jfom, tfom = JaxFOM((2, 2), 8), ThermalBlockFOM((2, 2), 8, device="cpu")
    _, theta = _primal((jfom, tfom), 60, 0)
    red = PaddedSketchedReductor(tfom, embedding_primal=theta, product=tfom.h1_0_product,
                                 r_max=4, log_level=30)
    _, (mu, mu2) = _mus(2, 0)
    u = tfom.solve(mu)
    red.extend_basis(u, mu=mu)
    srb1 = red.state.srb.clone()
    assert red.basis_size == 1
    red.extend_basis(u, mu=mu)           # exact duplicate
    assert red.basis_size == 1
    assert torch.equal(red.state.srb, srb1)
    red.extend_basis(1.0000001 * u)      # numerically dependent
    assert red.basis_size == 1
    red.extend_basis(tfom.solve(mu2), mu=mu2)
    assert red.basis_size == 2
    assert all(t.shape[-1] == 4 for t in red.state[:4])
    assert torch.isfinite(red.reduce(seed=3).estimate_error(mu))
