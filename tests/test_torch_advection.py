"""The port's advection-diffusion family held against the JAX package (f64,
CPU): the matrix-free stencil FOM (``models/stencil_advection.py``), its
BiCGStab solves, and the host-assembled ``AdvectionDiffusionFOM`` with the
sketched minres reductor.

Grids 15 and 16, inputs drawn with numpy from a seed. Tolerances: the
stencil operators, the host matrices, products and solves to 1e-12
(relative to the largest entry); BiCGStab iterates and the minres ROM to
1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rla4mor_tpu.core.solvers import bicgstab as jax_bicgstab
from rla4mor_tpu.models import AdvectionDiffusionFOM as JaxHost
from rla4mor_tpu.models import StencilAdvectionDiffusion as JaxStencil
from rla4mor_tpu.models.stencil_advection import advection_apply as jax_advection_apply
from rla4mor_tpu.mor import SketchedReductor as JaxReductor
from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian

from rla4mor_tpu_torch.core.solvers import bicgstab
from rla4mor_tpu_torch.models import AdvectionDiffusionFOM, StencilAdvectionDiffusion
from rla4mor_tpu_torch.models.stencil import preconditioner
from rla4mor_tpu_torch.models.stencil_advection import AdvectionTermOp, advection_apply
from rla4mor_tpu_torch.mor import SketchedReductor
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mus(count, seed):
    """(JAX Mus, the port's Mus): eps in [0.05, 1], velocity in [-1, 1]^2."""
    rng = np.random.RandomState(seed)
    eps = rng.uniform(0.05, 1.0, size=(count, 1))
    vel = rng.uniform(-1.0, 1.0, size=(count, 2))
    return ([{"eps": jnp.asarray(e), "velocity": jnp.asarray(v)} for e, v in zip(eps, vel)],
            [{"eps": torch.tensor(e), "velocity": torch.tensor(v)} for e, v in zip(eps, vel)])


def _pair(grid):
    return (JaxStencil(grid, dtype=jnp.float64),
            StencilAdvectionDiffusion(grid, dtype=torch.float64, device="cpu"))


def _grid(grid, seed, batch=()):
    return np.random.RandomState(seed).normal(size=(*batch, grid + 1, grid + 1))


@pytest.mark.parametrize("grid", [15, 16])
def test_stencil_operators_match_jax(grid):
    """advection_apply on both axes (also on a batch of grids), apply at
    three parameters, every term, the product, rhs, kappa, jacobi_diag and
    the output: 1e-12."""
    jfom, tfom = _pair(grid)
    u = _grid(grid, grid)
    ju, tu = jnp.asarray(u), torch.tensor(u)
    h = 1.0 / grid
    batch = _grid(grid, 1, batch=(3,))
    for axis in (0, 1):
        assert rel(advection_apply(tu, h, axis), jax_advection_apply(ju, h, axis)) < 1e-12
        got = advection_apply(torch.tensor(batch), h, axis)
        for i in range(3):
            assert rel(got[i], jax_advection_apply(jnp.asarray(batch[i]), h, axis)) < 1e-12
    for t in range(3):
        assert rel(tfom.apply_term(t, tu), jfom.apply_term(t, ju)) < 1e-12
    assert rel(tfom.product_apply(tu), jfom.product_apply(ju)) < 1e-12
    assert rel(tfom.rhs(), jfom.rhs()) < 1e-12
    for jmu, tmu in zip(*_mus(3, grid)):
        assert rel(tfom.apply(tmu, tu), jfom.apply(jmu, ju)) < 1e-12
        assert rel(tfom.kappa(tmu), jfom.kappa(jmu)) < 1e-12
        assert rel(tfom.jacobi_diag(tmu), jfom.jacobi_diag(jmu)) < 1e-12
        assert rel(tfom.theta_vector(tmu), jfom.theta_vector(jmu)) < 1e-12
    assert rel(tfom.output(tu), jfom.output(ju)) < 1e-12
    assert tfom.term_box_bounds() == jfom.term_box_bounds()
    assert not tfom.is_spd and tfom.n_terms == 3 and not tfom.kappa_is_full_operator


def test_term_linops_and_adjoints_match_jax():
    """AdvectionTermOp.apply / apply_adjoint / H on (n, m) columns and on one
    vector: 1e-12; the advection terms are anti-symmetric (H = -A), the
    stiffness symmetric; the affine operator assembles A(mu)."""
    jfom, tfom = _pair(15)
    n = 16 * 16
    X = np.random.RandomState(4).normal(size=(n, 3))
    jop, top = jfom.affine_operator(), tfom.affine_operator()
    for t in range(3):
        jt, tt = jop.terms[t], top.terms[t]
        assert isinstance(tt, AdvectionTermOp)
        assert rel(tt.apply(torch.tensor(X)), jt.apply(jnp.asarray(X))) < 1e-12
        assert rel(tt.apply_adjoint(torch.tensor(X)),
                   jt.apply_adjoint(jnp.asarray(X))) < 1e-12
        assert rel(tt.H.apply(torch.tensor(X[:, 0])), jt.H.apply(jnp.asarray(X[:, 0]))) < 1e-12
        sign = 1.0 if t == 0 else -1.0
        assert rel(tt.apply_adjoint(torch.tensor(X)), sign * tt.apply(torch.tensor(X))) < 1e-12
    assert [(c.key, c.index) for c in top.coefficients] == \
        [(c.key, c.index) for c in jop.coefficients]
    (jmu,), (tmu,) = _mus(1, 3)
    A = top.assemble_dense(tmu)
    u = np.random.RandomState(5).normal(size=(16, 16))
    assert rel(A @ u.reshape(-1), tfom.apply(tmu, torch.tensor(u)).reshape(-1)) < 1e-12


def test_stencil_matches_the_ports_host_fom():
    """The stencil family equals the port's own host-assembled FOM on
    interior nodes, term by term and at sampled parameters (as
    ``tests/test_stencil_advection.py`` holds the JAX pair): 1e-12."""
    nx = 12
    host = AdvectionDiffusionFOM(nx, device="cpu")
    dev = StencilAdvectionDiffusion(nx, dtype=torch.float64, device="cpu")
    u = np.zeros((nx + 1, nx + 1))
    u[1:-1, 1:-1] = np.random.RandomState(0).standard_normal((nx - 1, nx - 1))
    ui = u.reshape(-1)[host.interior]
    for t in range(3):
        want = host.operator.terms[t].S @ ui
        got = dev.apply_term(t, torch.tensor(u)).reshape(-1)[host.interior]
        assert np.abs(got.numpy() - want).max() < 1e-12, t
    for mu in host.sample_parameters(3, key=5):
        got = dev.apply(mu, torch.tensor(u))
        assert got[0].abs().max() == 0 and got[:, -1].abs().max() == 0
        want = host.assemble_sparse(mu) @ ui
        assert np.abs(got.reshape(-1)[host.interior].numpy() - want).max() < 1e-12
    rhs = dev.rhs().reshape(-1)[host.interior].numpy()
    assert np.abs(rhs - host.assemble_rhs(host.sample_parameters(1)[0])).max() < 1e-14


def test_host_fom_matches_jax():
    """Assembled terms, A(mu), rhs, solves, output and both products: 1e-12.
    The advection terms are skew-symmetric on interior nodes."""
    jh, th = JaxHost(16), AdvectionDiffusionFOM(16, device="cpu")
    assert th.solution_dim == jh.solution_dim == 15 * 15
    assert np.array_equal(th.interior, jh.interior)
    for tt, jt in zip(th.operator.terms, jh.operator.terms):
        assert rel(tt.S.toarray(), jt.S.toarray()) < 1e-12
    for t in (1, 2):
        C = th.operator.terms[t].S.toarray()
        assert np.abs(C + C.T).max() < 1e-12
    for name in ("h1_0", "l2"):
        assert rel(th.products[name].op.S.toarray(), jh.products[name].op.S.toarray()) < 1e-12
    X = np.random.RandomState(2).normal(size=(th.solution_dim, 2))
    assert rel(th.h1_0_product.inv.apply(torch.tensor(X)),
               jh.h1_0_product.inv.apply(jnp.asarray(X))) < 1e-12
    for jmu, tmu in zip(*_mus(2, 6)):
        assert rel(th.assemble_sparse(tmu).toarray(), jh.assemble_sparse(jmu).toarray()) < 1e-12
        assert rel(th.assemble_rhs(tmu), np.asarray(jh.assemble_rhs(jmu)).reshape(-1)) < 1e-12
        tu, ju = th.solve(tmu), jh.solve(jmu)
        assert rel(tu, ju) < 1e-12
        assert rel(th.output(tu, tmu), jh.output(ju, jmu)) < 1e-12
        assert float(th.residual_norm(tu, tmu)) < 1e-12


def test_sketched_minres_reductor_matches_jax():
    """``tests/test_advection_diffusion.py::test_sketched_minres_on_nonsymmetric``
    at fewer parameters: a carried Gaussian primal sketch (k = 120 over the
    h1_0 Cholesky factor) and two carried online sketches (k = 60); the
    reductor's state, the minres ROM and its solves and estimates at held-out
    parameters equal the JAX package's to 1e-10. 4-7 s: most of it the JAX
    reductor's first calls, which compile its sketches and projections."""
    jfom, tfom = JaxHost(16), AdvectionDiffusionFOM(16, device="cpu")
    jtheta = JaxGaussian.make(jfom.solution_dim, sqrt_product=jfom.h1_0_product.sqrt,
                              range_dim=120, seed=2)
    ttheta = GaussianEmbedding.from_matrix(np.asarray(jtheta.random_matrix()),
                                           sqrt_product=tfom.h1_0_product.sqrt, device="cpu")
    jred = JaxReductor(jfom, embedding_primal=jtheta, product=jfom.h1_0_product,
                       projection="minres", log_level=30)
    tred = SketchedReductor(tfom, embedding_primal=ttheta, product=tfom.h1_0_product,
                            projection="minres", log_level=30)
    jmus, tmus = _mus(8, 0)
    jred.extend_basis(jfom.solve_many(jmus))
    tred.extend_basis(tfom.solve_many(tmus))
    assert rel(tred.srb, jred.srb) < 1e-10
    assert rel(tred.residual_lhs.stack, jred.residual_lhs.stack) < 1e-10
    online = []
    for seed in (5, 6):
        je = JaxGaussian.make(120, range_dim=60, seed=seed)
        online.append((je, GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                                         device="cpu")))
    jrom = jred.reduce(embedding=(online[0][0], online[1][0]))
    trom = tred.reduce(embedding=(online[0][1], online[1][1]))
    assert trom.ls and jrom.ls
    assert rel(trom.lhs.stack, jrom.lhs.stack) < 1e-10
    assert rel(trom.error_estimator.lhs.stack, jrom.error_estimator.lhs.stack) < 1e-10
    for jmu, tmu in zip(*_mus(3, 1)):
        ty, jy = trom.solve(tmu), jrom.solve(jmu)
        assert rel(ty, jy) < 1e-10
        assert rel(trom.estimate_error(tmu), jrom.estimate_error(jmu)) < 1e-10
        # the ROM answers the FOM to 1e-1 in the h1_0 norm, as the JAX test
        err = tfom.solve(tmu) - tred.rb @ ty
        ref = tfom.solve(tmu)
        assert float(tfom.h1_0_product.norm(err)) < 1e-1 * float(
            tfom.h1_0_product.norm(ref))


def test_bicgstab_with_jacobi_matches_jax():
    """Jacobi-BiCGStab on the stencil operator at grid 15, tol 1e-10: the
    same iteration count as the JAX solver, the iterate within 1e-10."""
    jfom, tfom = _pair(15)
    for jmu, tmu in zip(*_mus(2, 8)):
        jdiag = jfom.jacobi_diag(jmu)
        jres = jax_bicgstab(lambda u: jfom.apply(jmu, u), jfom.rhs(),
                            precond=lambda r: r / jdiag, tol=1e-10, maxiter=2000)
        tres = tfom.solve_bicgstab_result(tmu, tol=1e-10, maxiter=2000)
        assert tres.iters == int(jres.iters) < 2000
        assert rel(tres.x, jres.x) < 1e-10
        assert rel(tfom.solve_bicgstab(tmu, tol=1e-10, maxiter=2000), jres.x) < 1e-10


# the V-cycle on eps K: the port's cycle is not the JAX one (ROADMAP.md queue
# 3), so its counts are held to a bound. Measured on the CPU in float64 to
# tol 1e-10 at grids 16-256: 32-34 iterations at eps 0.05 with |b| = sqrt(2),
# 9 at eps 0.2, 4 at eps 1, the same at every grid
MG_BICGSTAB_MAX_ITERS = 40


@pytest.mark.parametrize("grid", [16, 32])
def test_bicgstab_with_the_vcycle_converges_fast(grid):
    """BiCGStab preconditioned by the V-cycle on the diffusion part, at the
    parameter range's corners (smallest eps, largest velocity): at most
    ``MG_BICGSTAB_MAX_ITERS`` iterations to tol 1e-10, and the true residual
    agrees."""
    tfom = StencilAdvectionDiffusion(grid, dtype=torch.float64, device="cpu")
    b = tfom.rhs()
    for eps, vel in ((0.05, (1.0, -1.0)), (1.0, (0.3, 0.2))):
        mu = {"eps": torch.tensor([eps]), "velocity": torch.tensor(vel)}
        res = bicgstab(lambda u: tfom.apply(mu, u), b,
                       precond=preconditioner(tfom, mu, "mg"), tol=1e-10, maxiter=200)
        assert res.iters <= MG_BICGSTAB_MAX_ITERS, res.iters
        r = tfom.apply(mu, res.x) - b
        assert float(torch.linalg.vector_norm(r)) < 1e-9 * float(torch.linalg.vector_norm(b))


def test_samplers_respect_the_ranges_and_the_seed():
    """Both FOMs' samplers: the names and shapes of the JAX ones, within the
    ranges, equal for a seed, different across seeds, sample i independent
    of the count."""
    for fom in (StencilAdvectionDiffusion(8, device="cpu"), AdvectionDiffusionFOM(8, device="cpu")):
        a, b = fom.sample_parameters(20, key=3), fom.sample_parameters(20, key=3)
        for m, m2 in zip(a, b):
            assert set(m) == {"eps", "velocity"}
            assert m["eps"].shape == (1,) and m["velocity"].shape == (2,)
            assert 0.05 <= float(m["eps"]) <= 1.0
            assert bool((m["velocity"].abs() <= 1.0).all())
            assert torch.equal(m["eps"], m2["eps"]) and torch.equal(m["velocity"], m2["velocity"])
        assert torch.equal(fom.sample_parameters(3, key=3)[2]["eps"], a[2]["eps"])
        assert not torch.equal(fom.sample_parameters(1, key=4)[0]["eps"], a[0]["eps"])
    stencil = StencilAdvectionDiffusion(8, device="cpu").sample_parameters(4, key=1)
    host = AdvectionDiffusionFOM(8, device="cpu").sample_parameters(4, key=1)
    assert all(torch.equal(s["velocity"], h["velocity"]) for s, h in zip(stencil, host))
