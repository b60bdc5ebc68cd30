"""The port's matrix-free stencil thermal block, multigrid V-cycle and
device solvers held against the JAX package (f64, CPU).

Inputs are drawn with numpy from a seed and go through both packages.
Tolerances: 1e-12 relative for the stencil, the transfers' strided form
against the JAX package's dense 1-D matrices 1e-14, the V-cycle 1e-12;
CG and BiCGStab take the same number of iterations and agree to 1e-10.

The port's V-cycle hands its coarse level P^T r, 4 times the JAX
package's full weighting (ROADMAP.md queue 3: the JAX cycle is not
mesh-independent). Where a test holds it against the JAX cycle, the JAX
restriction is scaled by 4 (``jax_cycle_as_the_port``), so the cycle the
port runs is the one compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rla4mor_tpu.core.solvers import bicgstab as jax_bicgstab
from rla4mor_tpu.core.solvers import cg as jax_cg
from rla4mor_tpu.models import multigrid as jmg
from rla4mor_tpu.models import stencil as jst

from rla4mor_tpu_torch.core import ProjectionCoefficient
from rla4mor_tpu_torch.core.solvers import bicgstab, cg, lstsq_dense
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.models import multigrid as tmg
from rla4mor_tpu_torch.models import stencil as tst

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _blocks(nx):
    return (jst.StencilThermalBlock((2, 2), nx, dtype=jnp.float64),
            tst.StencilThermalBlock((2, 2), nx, dtype=torch.float64, device="cpu"))


MU = np.array([0.3, 1.4, 0.8, 2.2])


def jax_cycle_as_the_port(monkeypatch):
    """Scale the JAX package's ``restrict_full_weighting`` by 4 (P^T r), as
    the port's ``make_vcycle`` does, for every JAX V-cycle traced after."""
    jax_restrict = jmg.restrict_full_weighting
    monkeypatch.setattr(jmg, "restrict_full_weighting", lambda r: 4.0 * jax_restrict(r))


def port_cycle_as_the_jax(monkeypatch):
    """Scale the port's ``restrict_full_weighting`` by 1/4: the JAX
    package's cycle, for every port V-cycle called after."""
    port_restrict = tmg.restrict_full_weighting
    monkeypatch.setattr(tmg, "restrict_full_weighting", lambda r: 0.25 * port_restrict(r))


@pytest.mark.parametrize("nx", [12, 16])
def test_stencil_block_matches_jax(nx):
    """Every apply of the block, its rhs, diagonal, output and flattened
    LinOp views equal the JAX package's to 1e-12 (the JAX side in one
    jitted program: eagerly, each of its primitives compiles at each grid)."""
    js, ts = _blocks(nx)
    rs = np.random.RandomState(nx)
    u = rs.normal(size=(nx + 1, nx + 1))
    kap = rs.uniform(0.1, 2.0, size=(nx, nx))
    jmu, tmu = {"diffusion": jnp.asarray(MU)}, {"diffusion": torch.tensor(MU)}
    tu = torch.tensor(u)
    U = rs.normal(size=((nx + 1) ** 2, 3))
    jaff, taff = js.affine_operator(), ts.affine_operator()

    @jax.jit
    def jax_side(ju, jkap, jU):
        out = {"stencil": jst.stencil_apply(ju, jkap), "mass": jst.mass_apply(ju, 1 / nx),
               "kappa": js.kappa(jmu), "apply": js.apply(jmu, ju),
               "terms": [js.apply_term(t, ju) for t in range(4)],
               "product": js.product_apply(ju), "rhs": js.rhs(),
               "diag": js.jacobi_diag(jmu), "output": js.output(ju),
               "linops": [jt.apply(jU) for jt in jaff.terms]}
        if nx == 12:  # the rest once
            out.update(one=jaff.terms[-1].apply(jU[:, 0]),
                       product_linop=js.product_linop().apply(jU),
                       mass_diag=jst.mass_diag(nx + 1, 1 / nx, jnp.float64),
                       masks=jst.block_masks(nx, (2, 2), jnp.float64))
        return out

    want = jax_side(jnp.asarray(u), jnp.asarray(kap), jnp.asarray(U))
    assert rel(tst.stencil_apply(tu, torch.tensor(kap)), want["stencil"]) < 1e-12
    assert rel(tst.mass_apply(tu, 1 / nx), want["mass"]) < 1e-12
    assert np.array_equal(ts.kappa(tmu).numpy(), np.asarray(want["kappa"]))
    assert rel(ts.apply(tmu, tu), want["apply"]) < 1e-12
    terms = ts.apply_terms(tu)
    for t in range(4):
        assert rel(ts.apply_term(t, tu), want["terms"][t]) < 1e-12
        assert rel(terms[t], want["terms"][t]) < 1e-12
    assert rel(ts.product_apply(tu), want["product"]) < 1e-12
    assert rel(ts.rhs(), want["rhs"]) < 1e-12
    assert rel(ts.jacobi_diag(tmu), want["diag"]) < 1e-12
    assert rel(ts.output(tu), want["output"]) < 1e-12
    # the flattened LinOp views on (n, m) columns: one batched call
    assert taff.coefficients == tuple(ProjectionCoefficient("diffusion", b)
                                      for b in range(4))
    for jt_out, tt in zip(want["linops"], taff.terms):
        assert rel(tt.apply(torch.tensor(U)), jt_out) < 1e-12
    if nx == 12:
        assert rel(taff.terms[-1].apply(torch.tensor(U[:, 0])), want["one"]) < 1e-12
        assert rel(ts.product_linop().apply(torch.tensor(U)), want["product_linop"]) < 1e-12
        assert rel(tst.mass_diag(nx + 1, 1 / nx, device="cpu"), want["mass_diag"]) < 1e-12
        assert np.array_equal(tst.block_masks(nx, (2, 2), device="cpu").numpy(),
                              np.asarray(want["masks"]))


def test_stencil_matches_assembled():
    """Mirrors ``tests/test_parallel.py::test_stencil_matches_assembled``:
    the port's stencil terms, operator and load equal the port's
    scipy-assembled ThermalBlockFOM on the interior nodes."""
    nx = 12
    fom = ThermalBlockFOM((2, 2), nx, device="cpu")
    _, st = _blocks(nx)
    u_int = np.random.RandomState(0).normal(size=fom.solution_dim)
    grid = np.zeros((nx + 1) * (nx + 1))
    grid[fom.interior] = u_int
    grid = torch.tensor(grid.reshape(nx + 1, nx + 1))
    for t in range(4):
        want = fom.operator.terms[t].S @ u_int
        got = st.apply_term(t, grid).reshape(-1).numpy()[fom.interior]
        assert np.allclose(got, want, atol=1e-12)
    mu = {"diffusion": torch.tensor(MU)}
    got = st.apply(mu, grid).reshape(-1).numpy()[fom.interior]
    assert np.allclose(got, fom.assemble_sparse(mu) @ u_int, atol=1e-12)
    rhs = st.rhs().reshape(-1).numpy()[fom.interior]
    assert np.allclose(rhs, fom.assemble_rhs(mu), atol=1e-12)


@pytest.mark.parametrize("n_fine", [5, 9, 17, 33])
def test_transfers_equal_the_numpy_oracles(n_fine):
    """The strided transfers equal the JAX package's dense 1-D transfer
    matrices, R r R^T and P e P^T (masked), to 1e-14; and restriction is
    prolongation's adjoint over 4."""
    assert np.array_equal(tmg._restrict_1d_np(n_fine, "float64"),
                          jmg._restrict_1d_np(n_fine, "float64"))
    assert np.array_equal(tmg._prolong_1d_np(n_fine, "float64"),
                          jmg._prolong_1d_np(n_fine, "float64"))
    R = tmg._restrict_1d_np(n_fine, "float64")
    P = tmg._prolong_1d_np(n_fine, "float64")
    nc = R.shape[0]
    rs = np.random.RandomState(n_fine)
    r = rs.normal(size=(2, n_fine, n_fine))
    e = rs.normal(size=(nc, nc))
    mc = np.asarray(jst.interior_mask(nc, jnp.float64))
    mf = np.asarray(jst.interior_mask(n_fine, jnp.float64))
    got = tmg.restrict_full_weighting(torch.tensor(r)).numpy()
    for i in range(2):  # a leading batch dimension
        assert rel(got[i], (R @ r[i] @ R.T) * mc) < 1e-14
    pro = tmg.prolong_bilinear(torch.tensor(e), n_fine).numpy()
    assert rel(pro, (P @ e @ P.T) * mf) < 1e-14
    rm, em = r[0] * mf, e * mc
    lhs = np.vdot(tmg.restrict_full_weighting(torch.tensor(rm)).numpy(), em)
    rhs = np.vdot(rm, tmg.prolong_bilinear(torch.tensor(em), n_fine).numpy()) / 4
    assert np.isclose(lhs, rhs, rtol=1e-12)


def test_coarsen_kappa_matches_jax():
    k = np.random.RandomState(1).uniform(0.1, 2.0, size=(16, 16))
    got = tmg.coarsen_kappa(torch.tensor(k))
    assert got.shape == (8, 8)
    assert rel(got, jmg.coarsen_kappa(jnp.asarray(k))) < 1e-14
    assert np.isclose(float(tmg.coarsen_kappa(torch.arange(16.0).reshape(4, 4))[0, 0]),
                      np.mean([0, 1, 4, 5]))


@pytest.mark.parametrize("mass_dt", [None, 0.01], ids=["elliptic", "mass_dt"])
@pytest.mark.parametrize("nx", [16, 32])
def test_vcycle_matches_jax(nx, mass_dt):
    """The port's cycle equals the JAX cycle with its restriction scaled by
    4; the JAX cycle as it stands equals the port's with its restriction
    scaled by 1/4."""
    rs = np.random.RandomState(nx)
    kap = rs.uniform(0.1, 2.0, size=(nx, nx))
    b = rs.normal(size=(nx + 1, nx + 1)) * np.asarray(jst.interior_mask(nx + 1, jnp.float64))
    jkap, jb, tkap, tb = jnp.asarray(kap), jnp.asarray(b), torch.tensor(kap), torch.tensor(b)
    jax_own = jmg.make_vcycle(jkap, mass_dt=mass_dt)(jb)
    port = tmg.make_vcycle(tkap, mass_dt=mass_dt)(tb)
    with pytest.MonkeyPatch.context() as mp:
        jax_cycle_as_the_port(mp)
        assert rel(port, jmg.make_vcycle(jkap, mass_dt=mass_dt)(jb)) < 1e-12
    with pytest.MonkeyPatch.context() as mp:
        port_cycle_as_the_jax(mp)
        assert rel(tmg.make_vcycle(tkap, mass_dt=mass_dt)(tb), jax_own) < 1e-12


@pytest.mark.parametrize("mass_dt", [None, 0.01], ids=["elliptic", "mass_dt"])
def test_vcycle_is_mesh_independent(mass_dt, monkeypatch):
    """The port's V-cycle (the coarse right-hand side P^T r) takes the same
    few MG-CG iterations at N = 16, 32 and 64; the JAX package's cycle (the
    port's with its restriction scaled by 1/4, held equal to the JAX one
    above) takes more at every N and over 1.5 times as many for each
    doubling of N."""
    mu = {"diffusion": torch.tensor([0.5, 1.0, 2.0, 0.7])}
    iters = {"port": [], "jax": []}
    for nx in (16, 32, 64):
        st = tst.StencilThermalBlock((2, 2), nx, dtype=torch.float64, device="cpu")
        kap = st.kappa(mu)
        if mass_dt is None:
            def op(u):
                return tst.stencil_apply(u, kap)
        else:
            def op(u):
                return tst.mass_apply(u, 1 / nx) + mass_dt * tst.stencil_apply(u, kap)
        for cycle in iters:
            with pytest.MonkeyPatch.context() as mp:
                if cycle == "jax":
                    port_cycle_as_the_jax(mp)
                M = tmg.make_vcycle(kap, mass_dt=mass_dt)
                res = cg(op, st.rhs(), precond=M, tol=1e-10, maxiter=1000)
            assert float(res.residual_norm) <= 1e-10 * float(
                torch.linalg.vector_norm(st.rhs()))
            iters[cycle].append(res.iters)
    port, ref = iters["port"], iters["jax"]
    assert max(port) <= 10 and max(port) - min(port) <= 2, iters
    assert all(a > b for a, b in zip(ref, port)), iters
    if mass_dt is None:
        assert ref[2] > 1.5 * ref[1] and ref[1] > 1.5 * ref[0], iters


@pytest.fixture(scope="module")
def cg_problem():
    nx = 16
    js, ts = _blocks(nx)
    mu = np.array([0.5, 1.0, 2.0, 0.7])
    return js, ts, {"diffusion": jnp.asarray(mu)}, {"diffusion": torch.tensor(mu)}


@pytest.mark.parametrize("precond", ["jacobi", "mg"])
def test_cg_matches_jax(cg_problem, precond, monkeypatch):
    """Mirrors ``tests/test_multigrid.py::test_mg_cg_correct_and_faster`` at
    grid 16: with the same preconditioner (for MG, the JAX cycle with its
    restriction scaled as the port's), the same iteration count and x to
    1e-10; the FOM's own solve is that solve, and MG needs under half
    Jacobi's iterations."""
    js, ts, jmu, tmu = cg_problem
    if precond == "mg":
        jax_cycle_as_the_port(monkeypatch)
        jM = jmg.make_vcycle(js.kappa(jmu))
        tM = tmg.make_vcycle(ts.kappa(tmu))
    else:
        jd, td = js.jacobi_diag(jmu), ts.jacobi_diag(tmu)
        jM, tM = (lambda r: r / jd), (lambda r: r / td)
    want = jax_cg(lambda u: js.apply(jmu, u), js.rhs(), precond=jM, tol=1e-11,
                  maxiter=2000)
    got = cg(lambda u: ts.apply(tmu, u), ts.rhs(), precond=tM, tol=1e-11, maxiter=2000)
    assert got.iters == int(want.iters)
    assert rel(got.x, want.x) < 1e-10
    assert abs(float(got.residual_norm) - float(want.residual_norm)) < 1e-10 * float(
        torch.linalg.vector_norm(ts.rhs()))
    own = ts.solve_cg_result(tmu, tol=1e-11, maxiter=2000, precond=precond)
    assert own.iters == got.iters
    assert rel(own.x, want.x) < 1e-10
    if precond == "mg":
        jac = ts.solve_cg_result(tmu, tol=1e-11, maxiter=2000, precond="jacobi")
        assert got.iters < jac.iters / 2


def test_cg_stops_at_maxiter_and_at_zero_rhs(cg_problem):
    js, ts, jmu, tmu = cg_problem
    got = cg(lambda u: ts.apply(tmu, u), ts.rhs(), tol=1e-14, maxiter=3)
    want = jax_cg(lambda u: js.apply(jmu, u), js.rhs(), tol=1e-14, maxiter=3)
    assert got.iters == int(want.iters) == 3
    assert rel(got.x, want.x) < 1e-12
    zero = cg(lambda u: ts.apply(tmu, u), torch.zeros_like(ts.rhs()))
    assert zero.iters == 0 and float(zero.x.abs().max()) == 0.0


def test_bicgstab_matches_jax():
    """A nonsymmetric matvec made from a seed, Jacobi-preconditioned: the
    same iteration count and x to 1e-10."""
    rs = np.random.RandomState(5)
    n = 60
    A = np.eye(n) * 4.0 + rs.normal(size=(n, n)) * 0.3
    A[np.arange(n - 1), np.arange(1, n)] += 1.5  # a strong one-sided drift
    b = rs.normal(size=n)
    d = np.diag(A)
    jA, tA = jnp.asarray(A), torch.tensor(A)
    want = jax_bicgstab(lambda v: jA @ v, jnp.asarray(b), precond=lambda r: r / d,
                        tol=1e-12, maxiter=200)
    got = bicgstab(lambda v: tA @ v, torch.tensor(b), precond=lambda r: r / torch.tensor(d),
                   tol=1e-12, maxiter=200)
    assert got.iters == int(want.iters) > 3
    assert rel(got.x, want.x) < 1e-10
    assert rel(got.x, np.linalg.solve(A, b)) < 1e-10


def test_lstsq_dense_min_norm_on_masked_columns():
    """The rank-deficient masked minres system: zero columns get y = 0 and
    the rest is the least-squares solution, as ``jnp.linalg.lstsq``."""
    rs = np.random.RandomState(6)
    A = rs.normal(size=(3, 12, 4))
    A[..., 2:] = 0.0
    b = rs.normal(size=(3, 12))
    got = lstsq_dense(torch.tensor(A), torch.tensor(b))
    for i in range(3):
        want = np.asarray(jnp.linalg.lstsq(jnp.asarray(A[i]), jnp.asarray(b[i]))[0])
        assert rel(got[i], want) < 1e-12
        assert np.all(got[i, 2:].numpy() == 0.0)
