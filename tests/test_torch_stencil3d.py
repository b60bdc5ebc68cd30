"""The port's 3-D stencil thermal block (``models/stencil3d.py``) held
against the JAX package (f64, CPU).

Grids 7 and 15 (8^3 and 16^3 nodes), inputs drawn with numpy from a seed.
Tolerances: operators, diagonals and functionals to 1e-12 relative to the
largest entry; Jacobi-CG iterates to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rla4mor_tpu.core.solvers import cg as jax_cg
from rla4mor_tpu.models import StencilThermalBlock3D as JaxBlock3D
from rla4mor_tpu.models import stencil3d as j3

from rla4mor_tpu_torch.models import StencilThermalBlock3D
from rla4mor_tpu_torch.models import stencil3d as t3
from rla4mor_tpu_torch.parallel import make_sharded_greedy_step


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(grid):
    return (JaxBlock3D((2, 2, 2), grid, dtype=jnp.float64),
            StencilThermalBlock3D((2, 2, 2), grid, dtype=torch.float64, device="cpu"))


def _mus(count, seed, terms=8):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, terms))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


@pytest.mark.parametrize("grid", [7, 15])
def test_stencil3d_apply_and_helpers_match_jax(grid):
    """``stencil3d_apply`` with a random element field (also on a batch of
    grids against a batch of fields), the element stiffness, the masks, the
    block map, the lumped mass and the stiffness diagonal: 1e-12."""
    rng = np.random.RandomState(grid)
    M, h = grid + 1, 1.0 / grid
    u = rng.normal(size=(M, M, M))
    kap = rng.uniform(0.1, 2.0, size=(grid,) * 3)
    assert np.array_equal(np.array(t3.k_el_3d()), np.array(j3.k_el_3d()))
    assert rel(t3.stencil3d_apply(torch.tensor(u), torch.tensor(kap), h),
               j3.stencil3d_apply(jnp.asarray(u), jnp.asarray(kap), h)) < 1e-12
    ub, kb = rng.normal(size=(2, M, M, M)), rng.uniform(0.1, 2.0, size=(2, grid, grid, grid))
    got = t3.stencil3d_apply(torch.tensor(ub), torch.tensor(kb), h)
    for i in range(2):
        assert rel(got[i], j3.stencil3d_apply(jnp.asarray(ub[i]), jnp.asarray(kb[i]), h)) < 1e-12
    mask = t3.interior_mask3(M, device="cpu")
    assert np.array_equal(mask.numpy(), np.asarray(j3.interior_mask3(M, jnp.float64)))
    assert mask is t3.interior_mask3(M, torch.float64, "cpu")  # cached
    assert np.array_equal(t3.block_index_map3(grid, (2, 2, 2), "cpu").numpy(),
                          np.asarray(j3.block_index_map3(grid, (2, 2, 2))))
    assert np.array_equal(t3.block_index_map3(grid, (3, 1, 2), "cpu").numpy(),
                          np.asarray(j3.block_index_map3(grid, (3, 1, 2))))
    assert rel(t3.lumped_mass3_apply(torch.tensor(u), h),
               j3.lumped_mass3_apply(jnp.asarray(u), h)) < 1e-12
    assert rel(t3.lumped_mass3_diag(M, h, device="cpu"),
               j3.lumped_mass3_diag(M, h, jnp.float64)) < 1e-12
    assert rel(t3.stiffness3d_diag_raw(torch.tensor(kap), h),
               j3.stiffness3d_diag_raw(jnp.asarray(kap), h)) < 1e-12


@pytest.mark.parametrize("grid", [7, 15])
def test_block_fom_matches_jax(grid):
    """apply, every term, the product, rhs, jacobi_diag, kappa, output, the
    parabolic hooks and the box bounds at two parameters: 1e-12."""
    jfom, tfom = _pair(grid)
    u = np.random.RandomState(1).normal(size=(grid + 1,) * 3)
    ju, tu = jnp.asarray(u), torch.tensor(u)
    for b in range(8):
        assert rel(tfom.apply_term(b, tu), jfom.apply_term(b, ju)) < 1e-12
    assert rel(tfom.product_apply(tu), jfom.product_apply(ju)) < 1e-12
    assert rel(tfom.rhs(), jfom.rhs()) < 1e-12
    assert rel(tfom.output(tu), jfom.output(ju)) < 1e-12
    assert rel(tfom.mass_apply_grid(tu), jfom.mass_apply_grid(ju)) < 1e-12
    assert rel(tfom.mass_diag_grid(), jfom.mass_diag_grid()) < 1e-12
    assert rel(tfom.term_box_bounds(), jfom.term_box_bounds()) < 1e-12
    for jmu, tmu in zip(*_mus(2, grid)):
        assert rel(tfom.apply(tmu, tu), jfom.apply(jmu, ju)) < 1e-12
        assert rel(tfom.kappa(tmu), jfom.kappa(jmu)) < 1e-12
        assert rel(tfom.jacobi_diag(tmu), jfom.jacobi_diag(jmu)) < 1e-12
        assert rel(tfom.apply_field(tfom.kappa(tmu), tu), jfom.apply(jmu, ju)) < 1e-12
    assert tfom.n_terms == 8 and tfom.n_dof == (grid + 1) ** 3 and tfom.is_spd


def test_terms_sum_to_the_operator_and_are_symmetric():
    """sum_b mu_b A_b u = A(mu) u (1e-12), each term and the product are
    symmetric on interior-masked vectors (u^T A v = v^T A u to 1e-12), and
    the Dirichlet shell of every output is zero."""
    _, tfom = _pair(7)
    rng = np.random.RandomState(2)
    u, v = (torch.tensor(rng.normal(size=(8, 8, 8))) for _ in range(2))
    (tmu,) = _mus(1, 4)[1]
    total = sum(tmu["diffusion"][b] * tfom.apply_term(b, u) for b in range(8))
    Au = tfom.apply(tmu, u)
    assert rel(total, Au) < 1e-12
    mask = t3.interior_mask3(8, device="cpu")
    for op in [lambda w, b=b: tfom.apply_term(b, w) for b in range(8)] + [tfom.product_apply]:
        a, c = float((v * mask * op(u)).sum()), float((u * mask * op(v)).sum())
        assert abs(a - c) <= 1e-12 * max(abs(a), 1.0)
    assert float(Au[0].abs().max()) == 0 and float(Au[:, :, -1].abs().max()) == 0


def test_term_linops_match_jax():
    """``Stencil3DTermOp`` (rank-generic ``FlatGridOp``) on (n, m) columns and
    one vector, its adjoint and the affine operator's coefficients: 1e-12."""
    jfom, tfom = _pair(7)
    X = np.random.RandomState(3).normal(size=(512, 3))
    jop, top = jfom.affine_operator(), tfom.affine_operator()
    for b in (0, 5):
        jt, tt = jop.terms[b], top.terms[b]
        assert isinstance(tt, t3.Stencil3DTermOp) and tt.H is tt
        assert tt.grid_shape == (8, 8, 8) and tt.source_dim == tt.range_dim == 512
        assert rel(tt.apply(torch.tensor(X)), jt.apply(jnp.asarray(X))) < 1e-12
        assert rel(tt.apply_adjoint(torch.tensor(X[:, 1])), jt.apply(jnp.asarray(X[:, 1]))) < 1e-12
    unit, junit = t3.Stencil3DTermOp(tfom, None), j3.Stencil3DTermOp(jfom, None)
    assert rel(unit.apply(torch.tensor(X)), junit.apply(jnp.asarray(X))) < 1e-12
    assert [(c.key, c.index) for c in top.coefficients] == \
        [(c.key, c.index) for c in jop.coefficients]


def test_jacobi_cg_matches_jax():
    """Jacobi-CG at grid 7, tol 1e-10: the JAX iteration count, the iterate
    within 1e-10."""
    jfom, tfom = _pair(7)
    (jmu,), (tmu,) = _mus(1, 5)
    jdiag = jfom.jacobi_diag(jmu)
    jres = jax_cg(lambda u: jfom.apply(jmu, u), jfom.rhs(), precond=lambda r: r / jdiag,
                  tol=1e-10, maxiter=500)
    tres = tfom.solve_cg_result(tmu, tol=1e-10, maxiter=500)
    assert tres.iters == int(jres.iters) < 500
    assert rel(tres.x, jres.x) < 1e-10
    assert rel(tfom.solve_cg(tmu, tol=1e-10, maxiter=500), jres.x) < 1e-10


def test_sampler_and_the_2d_vcycle_refused():
    """The sampler draws 8 diffusion values in [0.1, 1], reproducibly; the
    driver refuses the 2-D V-cycle for the 3-D grid before it builds
    anything."""
    fom = StencilThermalBlock3D((2, 2, 2), 7, device="cpu")
    a, b = fom.sample_parameters(10, key=4), fom.sample_parameters(10, key=4)
    for m, m2 in zip(a, b):
        assert set(m) == {"diffusion"} and m["diffusion"].shape == (8,)
        assert bool(((m["diffusion"] >= 0.1) & (m["diffusion"] <= 1.0)).all())
        assert torch.equal(m["diffusion"], m2["diffusion"])
    assert not torch.equal(fom.sample_parameters(1, key=5)[0]["diffusion"], a[0]["diffusion"])
    with pytest.raises(ValueError, match="2-D"):
        make_sharded_greedy_step(fom, cg_precond="mg", sketch="srht")
