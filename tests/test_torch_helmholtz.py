"""The port's indefinite Helmholtz stencil family and ``ExpressionCoefficient``
held against the JAX package (f64, CPU).

Grids 15 and 16, inputs drawn with numpy from a seed. Tolerances: the
operators, diagonals and bounds to 1e-12 relative to the largest entry;
BiCGStab iterates to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rla4mor_tpu.core.parameters import ExpressionCoefficient as JaxExpression
from rla4mor_tpu.core.solvers import bicgstab as jax_bicgstab
from rla4mor_tpu.models import StencilHelmholtz as JaxHelmholtz

from rla4mor_tpu_torch.core import ExpressionCoefficient, eval_coefficients
from rla4mor_tpu_torch.core.solvers import bicgstab
from rla4mor_tpu_torch.models import StencilHelmholtz
from rla4mor_tpu_torch.models.stencil import preconditioner
from rla4mor_tpu_torch.models.stencil_helmholtz import _NEG_KSQ, HelmholtzTermOp


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(grid):
    return (JaxHelmholtz(grid, dtype=jnp.float64),
            StencilHelmholtz(grid, dtype=torch.float64, device="cpu"))


def _ksq(values):
    return ([{"ksq": jnp.asarray([v])} for v in values],
            [{"ksq": torch.tensor([v], dtype=torch.float64)} for v in values])


def _cube(mu):
    return mu["x"][..., 0] ** 3 - 2.0 * mu["x"][..., 1]


def test_expression_coefficient():
    """It evaluates as the JAX one (one Mu and, in the port, a batched Mu);
    equality and hash go by the function's identity, never by the name."""
    x = np.array([0.7, -1.3])
    port = ExpressionCoefficient(_cube, "x0^3 - 2 x1")
    assert abs(float(port({"x": torch.tensor(x)}))
               - float(JaxExpression(_cube)({"x": jnp.asarray(x)}))) < 1e-15
    batch = {"x": torch.tensor(np.random.RandomState(0).normal(size=(5, 2)))}
    vals = eval_coefficients((port, _NEG_KSQ), {**batch, "ksq": torch.arange(5.0)[:, None]})
    assert vals.shape == (5, 2)
    assert torch.allclose(vals[:, 0], _cube(batch), rtol=1e-15, atol=0)
    assert torch.equal(vals[:, 1], -torch.arange(5.0, dtype=vals.dtype))
    same = ExpressionCoefficient(_cube, "another name")
    assert port == same and hash(port) == hash(same)
    other = ExpressionCoefficient(lambda mu: _cube(mu), "x0^3 - 2 x1")
    assert port != other
    assert _NEG_KSQ.name == "-ksq"


@pytest.mark.parametrize("grid", [15, 16])
def test_operators_match_jax(grid):
    """apply at three ksq, both terms (also on a batch of grids), the
    product, rhs, kappa, theta and the output: 1e-12."""
    jfom, tfom = _pair(grid)
    u = np.random.RandomState(grid).normal(size=(grid + 1, grid + 1))
    ju, tu = jnp.asarray(u), torch.tensor(u)
    batch = np.random.RandomState(1).normal(size=(2, grid + 1, grid + 1))
    for t in range(2):
        assert rel(tfom.apply_term(t, tu), jfom.apply_term(t, ju)) < 1e-12
        got = tfom.apply_term(t, torch.tensor(batch))
        for i in range(2):
            assert rel(got[i], jfom.apply_term(t, jnp.asarray(batch[i]))) < 1e-12
    assert rel(tfom.product_apply(tu), jfom.product_apply(ju)) < 1e-12
    assert rel(tfom.rhs(), jfom.rhs()) < 1e-12
    for jmu, tmu in zip(*_ksq([22.0, 31.7, 46.0])):
        assert rel(tfom.apply(tmu, tu), jfom.apply(jmu, ju)) < 1e-12
        assert rel(tfom.kappa(tmu), jfom.kappa(jmu)) < 1e-12
        assert rel(tfom.theta_vector(tmu), jfom.theta_vector(jmu)) < 1e-12
    assert rel(tfom.output(tu), jfom.output(ju)) < 1e-12
    assert rel(tfom.term_norm_bounds(), jfom.term_norm_bounds()) < 1e-12
    assert not tfom.is_spd and tfom.n_terms == 2 and not tfom.kappa_is_full_operator


def test_jacobi_diag_matches_jax_across_the_floor():
    """At grid 4 (h = 1/4) diag K - ksq diag M = 8/3 - ksq / 36 crosses the
    0.1 x 8/3 floor between ksq = 86.4 and 105.6 and turns negative beyond
    96: ksq in {20, 90, 95, 98, 100, 200} covers above, under (either sign)
    and below it. Equal to JAX to 1e-12, and every interior entry's magnitude is
    at least the floor."""
    jfom, tfom = _pair(4)
    floor = 0.1 * 8.0 / 3.0
    for jmu, tmu in zip(*_ksq([20.0, 90.0, 95.0, 98.0, 100.0, 200.0])):
        d = tfom.jacobi_diag(tmu)
        assert rel(d, jfom.jacobi_diag(jmu)) < 1e-12
        assert bool((d[1:-1, 1:-1].abs() >= floor - 1e-15).all())
        assert bool((d[0] == 1).all())
    assert float(tfom.jacobi_diag(tmu)[2, 2]) < 0  # ksq = 200: negative kept


def test_affine_operator_and_term_linops_match_jax():
    """The term LinOps on (n, m) columns, their adjoints (both symmetric) and
    A(mu) assembled from (ONE, -ksq) equal the JAX ones to 1e-12."""
    jfom, tfom = _pair(15)
    X = np.random.RandomState(3).normal(size=(16 * 16, 3))
    jop, top = jfom.affine_operator(), tfom.affine_operator()
    assert top.coefficients[1] is _NEG_KSQ
    for t in range(2):
        jt, tt = jop.terms[t], top.terms[t]
        assert isinstance(tt, HelmholtzTermOp) and tt.H is tt
        assert rel(tt.apply(torch.tensor(X)), jt.apply(jnp.asarray(X))) < 1e-12
        assert rel(tt.apply_adjoint(torch.tensor(X)), jt.apply_adjoint(jnp.asarray(X))) < 1e-12
    (jmu,), (tmu,) = _ksq([33.0])
    eye = jnp.eye(16 * 16)
    jA = sum(float(c(jmu)) * np.asarray(t.apply(eye))
             for c, t in zip(jop.coefficients, jop.terms))
    assert rel(top.assemble_dense(tmu), jA) < 1e-12


def test_bicgstab_with_jacobi_matches_jax():
    """Jacobi-BiCGStab on K - ksq M at grid 15, tol 1e-10: the iteration
    count of the JAX solver, the iterate within 1e-10."""
    jfom, tfom = _pair(15)
    for jmu, tmu in zip(*_ksq([23.5, 44.0])):
        jdiag = jfom.jacobi_diag(jmu)
        jres = jax_bicgstab(lambda u: jfom.apply(jmu, u), jfom.rhs(),
                            precond=lambda r: r / jdiag, tol=1e-10, maxiter=4000)
        tres = tfom.solve_bicgstab_result(tmu, tol=1e-10, maxiter=4000)
        assert tres.iters == int(jres.iters) < 4000
        assert rel(tres.x, jres.x) < 1e-10


# the V-cycle on K (the port's cycle, not the JAX one: ROADMAP.md queue 3).
# Measured on the CPU in float64 to tol 1e-10 at grids 16-256: 6-8
# iterations over ksq in {22, 30, 40, 46}, the same at every grid
MG_BICGSTAB_MAX_ITERS = 12


@pytest.mark.parametrize("grid", [16, 32])
def test_bicgstab_with_the_vcycle_converges_fast(grid):
    """BiCGStab preconditioned by the V-cycle on K at both ends of the ksq
    range (next to each resonance): at most ``MG_BICGSTAB_MAX_ITERS``
    iterations to tol 1e-10, the true residual agreeing."""
    tfom = StencilHelmholtz(grid, dtype=torch.float64, device="cpu")
    b = tfom.rhs()
    for ksq in (22.0, 46.0):
        mu = {"ksq": torch.tensor([ksq], dtype=torch.float64)}
        res = bicgstab(lambda u: tfom.apply(mu, u), b,
                       precond=preconditioner(tfom, mu, "mg"), tol=1e-10, maxiter=200)
        assert res.iters <= MG_BICGSTAB_MAX_ITERS, res.iters
        r = tfom.apply(mu, res.x) - b
        assert float(torch.linalg.vector_norm(r)) < 1e-9 * float(torch.linalg.vector_norm(b))


def test_sampler_respects_the_range_and_the_seed():
    fom = StencilHelmholtz(8, device="cpu")
    a, b = fom.sample_parameters(30, key=2), fom.sample_parameters(30, key=2)
    for m, m2 in zip(a, b):
        assert set(m) == {"ksq"} and m["ksq"].shape == (1,)
        assert 22.0 <= float(m["ksq"]) <= 46.0
        assert torch.equal(m["ksq"], m2["ksq"])
    assert torch.equal(fom.sample_parameters(5, key=2)[4]["ksq"], a[4]["ksq"])
    assert not torch.equal(fom.sample_parameters(1, key=3)[0]["ksq"], a[0]["ksq"])
    assert fom.parameter_space.low == 22.0 and fom.parameter_space.high == 46.0
