"""The PyTorch port's main path held against the JAX package, end to end.

Thermal block (2x2 blocks, 16 intervals: n = 225), f64 on the CPU. Both
packages get the same inputs: the SRHT plan and the online Gaussian are
carried from the JAX side, training parameters are drawn with numpy.
``_ONEPASS_MIN_DIM`` is patched to 1 in both packages, so the small slice
takes the one-pass SRHT branch (the kernel's plain version here, the XLA
one-pass twins on the JAX side).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.ops.embeddings as jemb
import rla4mor_tpu.serve as jserve
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.mor import SketchedReductor as JaxReductor
from rla4mor_tpu.mor import rb_greedy as jax_rb_greedy
from rla4mor_tpu.mor.serialization import save_rom as jax_save_rom
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch import serve as tserve
from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.mor import SketchedReductor, load_rom, rb_greedy, save_rom

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

K = 60


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def foms():
    return JaxFOM((2, 2), 16), ThermalBlockFOM((2, 2), 16, device="cpu")


@pytest.fixture
def onepass(monkeypatch):
    """Both packages take the one-pass SRHT branch at n = 225; counts the
    port's one-pass calls."""
    monkeypatch.setattr(jemb.SrhtEmbedding, "_ONEPASS_MIN_DIM", 1)
    monkeypatch.setattr(temb.SrhtEmbedding, "_ONEPASS_MIN_DIM", 1)
    calls = []
    orig = temb.srht_onepass

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return orig(*args, **kwargs)

    monkeypatch.setattr(temb, "srht_onepass", counted)
    return calls


def _embeddings(foms, seed=3):
    jfom, tfom = foms
    n = jfom.solution_dim
    je = jemb.SrhtEmbedding.make(n, sqrt_product=jfom.h1_0_product.sqrt,
                                 range_dim=K, seed=seed)
    signs, sampling, _ = jax_srht_plan(je.key, n, K)
    te = temb.SrhtEmbedding.from_plan(n, K, np.asarray(signs), np.asarray(sampling),
                                      sqrt_product=tfom.h1_0_product.sqrt,
                                      device="cpu")
    return je, te


def _mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _reductors(foms, projection="galerkin"):
    jfom, tfom = foms
    je, te = _embeddings(foms)
    jred = JaxReductor(jfom, embedding_primal=je, product=jfom.h1_0_product,
                       projection=projection, log_level=30)
    tred = SketchedReductor(tfom, embedding_primal=te, product=tfom.h1_0_product,
                            projection=projection, log_level=30)
    return jred, tred


def _extend(foms, jred, tred, count=4):
    jfom, tfom = foms
    jmus, tmus = _mus(count, 11)
    jred.extend_basis(jfom.solve(jmus[0]), mu=jmus[0])
    tred.extend_basis(tfom.solve(tmus[0]), mu=tmus[0])
    jred.extend_basis(jfom.solve_many(jmus[1:]))
    tred.extend_basis(tfom.solve_many(tmus[1:]))


def _assert_rom_equal(jrom, trom, tol):
    assert rel(trom.lhs.stack, jrom.lhs.stack) < tol
    assert rel(trom.rhs.stack, jrom.rhs.stack) < tol
    assert rel(trom.output_functional.stack, jrom.output_functional.stack) < tol
    assert rel(trom.error_estimator.lhs.stack, jrom.error_estimator.lhs.stack) < tol
    assert rel(trom.error_estimator.rhs.stack, jrom.error_estimator.rhs.stack) < tol
    assert trom.ls == jrom.ls


def test_fom_solve_matches(foms):
    jfom, tfom = foms
    jmus, tmus = _mus(2, 0)
    for jm, tm in zip(jmus, tmus):
        assert rel(tfom.solve(tm), jfom.solve(jm)) < 1e-12
    assert tfom.solution_dim == jfom.solution_dim == 225


def test_extend_basis_state(foms, onepass):
    jred, tred = _reductors(foms)
    _extend(foms, jred, tred)
    assert onepass, "the port did not take the one-pass SRHT branch"
    assert tred.basis_size == jred.basis_size == 4
    assert rel(tred.srb, jred.srb) < 1e-12
    assert rel(tred.rb, jred.rb) < 1e-12
    assert rel(tred.residual_lhs.stack, jred.residual_lhs.stack) < 1e-12
    assert rel(tred.residual_rhs.stack, jred.residual_rhs.stack) < 1e-12
    assert rel(tred.output_functional.stack, jred.output_functional.stack) < 1e-12
    assert [(c.key, c.index) for c in tred.residual_lhs.coefficients] == \
        [(c.key, c.index) for c in jred.residual_lhs.coefficients]


@pytest.mark.parametrize("projection", ["galerkin", "minres"])
def test_reduce_with_carried_online_gaussian(foms, onepass, projection):
    jred, tred = _reductors(foms, projection)
    _extend(foms, jred, tred)
    pairs = []
    for seed in (5, 6):
        je = jemb.GaussianEmbedding.make(K, range_dim=30, seed=seed)
        te = temb.GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                                device="cpu")
        pairs.append((je, te))
    if projection == "galerkin":
        jrom = jred.reduce(embedding=pairs[0][0])
        trom = tred.reduce(embedding=pairs[0][1])
    else:
        jrom = jred.reduce(embedding=(pairs[0][0], pairs[1][0]))
        trom = tred.reduce(embedding=(pairs[0][1], pairs[1][1]))
    _assert_rom_equal(jrom, trom, 1e-12)
    jmus, tmus = _mus(6, 2)
    ju, jest = jrom.solve_and_estimate_batch(
        {"diffusion": jnp.stack([m["diffusion"] for m in jmus])})
    tu, test_ = trom.solve_and_estimate_batch(mu_stack(tmus))
    assert rel(tu, ju) < 1e-10
    assert rel(test_, jest) < 1e-10
    # one Mu at a time gives the same as the batch
    assert rel(trom.solve(tmus[3]), np.asarray(tu)[3]) < 1e-12


def test_truncate_basis_matches(foms, onepass):
    jred, tred = _reductors(foms)
    _extend(foms, jred, tred)
    jred.truncate_basis(2)
    tred.truncate_basis(2)
    assert tred.basis_size == jred.basis_size == 2
    assert len(tred.mu_basis) == len(jred.mu_basis)
    assert rel(tred.srb, jred.srb) < 1e-12
    assert rel(tred.rb, jred.rb) < 1e-12
    assert rel(tred.residual_lhs.stack, jred.residual_lhs.stack) < 1e-12
    assert rel(tred.output_functional.stack, jred.output_functional.stack) < 1e-12
    u_r = torch.tensor([0.3, -1.2], dtype=torch.float64)
    assert rel(tred.reconstruct(u_r), jred.reconstruct(jnp.asarray(u_r.numpy()))) < 1e-12


def test_rb_greedy_matches(foms, onepass):
    jfom, tfom = foms
    jred, tred = _reductors(foms)
    jmus, tmus = _mus(20, 7)
    jres = jax_rb_greedy(jfom, jred, jmus, max_extensions=5, log_level=30)
    tres = rb_greedy(tfom, tred, tmus, max_extensions=5, log_level=30)

    def index(mu, mus):
        return next(i for i, m in enumerate(mus)
                    if np.array_equal(np.asarray(m["diffusion"]),
                                      np.asarray(mu["diffusion"])))

    assert [index(m, tmus) for m in tres.selected_mus] == \
        [index(m, jmus) for m in jres.selected_mus]
    assert rel(tres.max_estimates, jres.max_estimates) < 1e-10
    _assert_rom_equal(jres.rom, tres.rom, 1e-10)
    assert tres.iterations == jres.iterations == 5


def test_serve_loads_jax_rom_file(foms, onepass, tmp_path):
    jred, tred = _reductors(foms)
    _extend(foms, jred, tred)
    jrom = jred.reduce(seed=1)
    path = tmp_path / "rom.npz"
    jax_save_rom(jrom, path)
    trom = load_rom(path, device="cpu")
    jmus, tmus = _mus(7, 4)
    jout = jserve.serve_batch(jrom, {"diffusion": jnp.stack([m["diffusion"] for m in jmus])})
    tout = tserve.serve_batch(trom, mu_stack(tmus))
    assert set(tout) == set(jout) == {"u", "estimate", "output"}
    for key in tout:
        assert rel(tout[key], jout[key]) < 1e-12
    # and the port's own file round-trips
    save_rom(trom, tmp_path / "rom2.npz")
    again = load_rom(tmp_path / "rom2.npz", device="cpu")
    _assert_rom_equal(jrom, again, 1e-15)


def test_pad_batch_matches():
    jmus, tmus = _mus(5, 9)
    jb = {"diffusion": jnp.stack([m["diffusion"] for m in jmus])}
    jpad, jn = jserve.pad_batch(jb, 8)
    tpad, tn = tserve.pad_batch(mu_stack(tmus), 8)
    assert tn == jn == 5
    assert np.array_equal(np.asarray(tpad["diffusion"]), np.asarray(jpad["diffusion"]))
    same, n = tserve.pad_batch(mu_stack(tmus), 5)
    assert n == 5 and same["diffusion"].shape == (5, 4)
    with pytest.raises(ValueError):
        tserve.pad_batch(mu_stack(tmus), 4)
