"""The port's core algebra held against the JAX package (f64, CPU):
parameters and coefficients, affine projection / composition /
concatenation, Gram-Schmidt, sparse products and the ROM solves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.core as jcore
import rla4mor_tpu.core.parameters as jparams
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.models.stationary import StationaryROM as JaxROM

import rla4mor_tpu_torch.core as tcore
import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.models.stationary import StationaryROM
from rla4mor_tpu_torch.utils.config import resolve_device

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def foms():
    return JaxFOM((2, 2), 16), ThermalBlockFOM((2, 2), 16, device="cpu")


def test_coefficients_single_and_batched():
    coeffs = (tcore.ONE, tcore.ProjectionCoefficient("a", 1),
              tcore.ProjectionCoefficient("a", 0) * tcore.ProjectionCoefficient("b", 0),
              tcore.ConstantCoefficient(2.0) * 3.0)
    mus = [{"a": torch.tensor([0.5, 2.0]), "b": torch.tensor([3.0])},
           {"a": torch.tensor([1.5, 4.0]), "b": torch.tensor([-1.0])}]
    single = tcore.eval_coefficients(coeffs, mus[0])
    assert torch.equal(single, torch.tensor([1.0, 2.0, 1.5, 6.0], dtype=torch.float64))
    batched = tcore.eval_coefficients(coeffs, tcore.mu_stack(mus))
    assert batched.shape == (2, 4)
    assert torch.equal(batched[1], tcore.eval_coefficients(coeffs, mus[1]))
    jv = jcore.eval_coefficients(
        (jcore.ONE, jcore.ProjectionCoefficient("a", 1),
         jcore.ProjectionCoefficient("a", 0) * jcore.ProjectionCoefficient("b", 0),
         jcore.ConstantCoefficient(6.0)),
        {"a": jnp.asarray([0.5, 2.0]), "b": jnp.asarray([3.0])})
    assert np.array_equal(np.asarray(jv), single.numpy())
    assert torch.equal(tcore.mu_stack(mus)["a"], torch.tensor([[0.5, 2.0], [1.5, 4.0]]))


def test_parameter_space_sampling():
    space = tcore.ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)
    a = space.sample_randomly(5, seed=3, device="cpu")
    b = space.sample_randomly(8, seed=3, device="cpu")
    for x, y in zip(a, b):  # sample i does not depend on the count
        assert torch.equal(x["diffusion"], y["diffusion"])
    vals = torch.stack([m["diffusion"] for m in b])
    assert vals.dtype == torch.float64 and vals.min() >= 0.1 and vals.max() <= 1.0
    assert space.names == ("diffusion",) and space.dim() == 4


def test_affine_dense_batched_assemble_and_apply():
    rs = np.random.RandomState(0)
    stack = torch.tensor(rs.normal(size=(3, 5, 4)))
    coeffs = (tcore.ONE, tcore.ProjectionCoefficient("p", 0),
              tcore.ProjectionCoefficient("p", 1))
    A = tcore.AffineDense(stack, coeffs)
    mus = [{"p": torch.tensor(rs.uniform(size=2))} for _ in range(3)]
    batched = A.assemble(tcore.mu_stack(mus))
    U = torch.tensor(rs.normal(size=(3, 4)))
    applied = A.apply(U, tcore.mu_stack(mus))
    jA = jcore.AffineDense(jnp.asarray(stack.numpy()),
                           (jcore.ONE, jcore.ProjectionCoefficient("p", 0),
                            jcore.ProjectionCoefficient("p", 1)))
    for i, mu in enumerate(mus):
        jmu = {"p": jnp.asarray(mu["p"].numpy())}
        assert rel(batched[i], jA.assemble(jmu)) < 1e-14
        assert rel(applied[i], jA.apply(jnp.asarray(U[i].numpy()), jmu)) < 1e-14


def test_project_compose_concat_match_jax(foms):
    jfom, tfom = foms
    rs = np.random.RandomState(1)
    W = rs.normal(size=(225, 3))
    V = rs.normal(size=(225, 2))
    jp = jcore.project(jfom.operator, jnp.asarray(V), jnp.asarray(W))
    tp = tcore.project(tfom.operator, torch.tensor(V), torch.tensor(W))
    assert rel(tp.stack, jp.stack) < 1e-12
    # W only: the range side stays full
    jw = jcore.project(jfom.operator, None, jnp.asarray(W))
    tw = tcore.project(tfom.operator, None, torch.tensor(W))
    assert rel(tw.stack, jw.stack) < 1e-12
    # V only: through apply_adjoint
    jv = jcore.project(jfom.operator, jnp.asarray(V), None)
    tv = tcore.project(tfom.operator, torch.tensor(V), None)
    assert rel(tv.stack, jv.stack) < 1e-12
    # compose with R^-1 (a host chain) and with a dense left factor
    jc = jcore.project(jcore.compose(jfom.h1_0_product.inv, jfom.operator), None,
                       jnp.asarray(W))
    tc = tcore.project(tcore.compose(tfom.h1_0_product.inv, tfom.operator), None,
                       torch.tensor(W))
    assert rel(tc.stack, jc.stack) < 1e-12
    M = rs.normal(size=(4, 225))
    jd = jcore.compose(jcore.DenseOp(jnp.asarray(M)), jw)
    td = tcore.compose(tcore.DenseOp(M, device="cpu"), tw)
    assert rel(td.stack, jd.stack) < 1e-12
    # concatenation along the source and the range axis
    for axis in (0, 1):
        jcat = jcore.concat_affine((jw, jw.rmul(jnp.eye(3))), axis=axis)
        tcat = tcore.concat_affine((tw, tw.rmul(torch.eye(3, dtype=torch.float64))),
                                   axis=axis)
        assert rel(tcat.stack, jcat.stack) < 1e-12
    # materialize of the rhs chain R^-1 b
    jm = jcore.materialize(jcore.compose(jfom.h1_0_product.inv, jfom.rhs))
    tm = tcore.materialize(tcore.compose(tfom.h1_0_product.inv, tfom.rhs))
    assert rel(tm.stack, jm.stack) < 1e-12


@pytest.mark.parametrize("offset", [0, 2])
def test_gram_schmidt_matches_jax(offset):
    rs = np.random.RandomState(offset)
    U = rs.normal(size=(30, 6))
    if offset:
        U[:, :offset] = np.linalg.qr(U[:, :offset])[0]
    U[:, 4] = U[:, 1] + U[:, 2]  # dependent: becomes a zero column under atol
    jQ, jR = jcore.gram_schmidt(jnp.asarray(U), offset=offset, return_R=True,
                                atol=1e-10)
    tQ, tR = tcore.gram_schmidt(torch.tensor(U), offset=offset, return_R=True,
                                atol=1e-10)
    assert np.abs(np.asarray(tQ) - np.asarray(jQ)).max() < 1e-12
    assert np.abs(np.asarray(tR) - np.asarray(jR)).max() < 1e-12
    assert float(tQ[:, 4].abs().max()) == 0.0
    keep = [0, 1, 2, 3, 5]
    G = tQ[:, keep].T @ tQ[:, keep]
    assert torch.allclose(G, torch.eye(5, dtype=torch.float64), atol=1e-12)


def test_product_from_sparse_matches_jax(foms):
    jfom, tfom = foms
    jP, tP = jfom.h1_0_product, tfom.h1_0_product
    S = tP.op.S.toarray()
    rs = np.random.RandomState(3)
    U = rs.normal(size=(225, 2))
    ju, tu = jnp.asarray(U), torch.tensor(U)
    assert rel(tP.inv.apply(tu), jP.inv.apply(ju)) < 1e-12
    for name in ("apply", "apply_adjoint", "apply_inverse", "apply_inverse_adjoint"):
        assert rel(getattr(tP.sqrt, name)(tu), getattr(jP.sqrt, name)(ju)) < 1e-12
    Q = tP.sqrt.matrix().numpy()
    assert np.abs(Q.T @ Q - S).max() < 1e-12 * np.abs(S).max()
    assert rel(tP.norm(tu), jP.norm(ju)) < 1e-12
    assert rel(tP.inner(tu), jP.inner(ju)) < 1e-12
    # a chain of host ops stays on the host until its end
    chain = tcore.ChainOp((tP.sqrt, tP.inv))
    assert rel(chain.apply(tu), jP.sqrt.apply(jP.inv.apply(ju))) < 1e-12


@pytest.mark.parametrize("ls", [False, True], ids=["galerkin", "lstsq"])
def test_rom_solve_matches_jax(ls):
    rs = np.random.RandomState(4)
    k, r = (12, 4) if ls else (4, 4)
    lhs = rs.normal(size=(3, k, r))
    if ls:
        lhs[:, :, 3] = lhs[:, :, 0]  # rank deficient: the SVD cutoff drops it
    rhs = rs.normal(size=(1, k, 1))
    out = rs.normal(size=(1, 1, r))
    tcoef = (tcore.ONE, tcore.ProjectionCoefficient("p", 0),
             tcore.ProjectionCoefficient("p", 1))
    jcoef = (jcore.ONE, jcore.ProjectionCoefficient("p", 0),
             jcore.ProjectionCoefficient("p", 1))
    trom = StationaryROM(tcore.AffineDense(torch.tensor(lhs), tcoef),
                         tcore.AffineDense(torch.tensor(rhs), (tcore.ONE,)),
                         tcore.AffineDense(torch.tensor(out), (tcore.ONE,)), ls=ls)
    jrom = JaxROM(jcore.AffineDense(jnp.asarray(lhs), jcoef),
                  jcore.AffineDense(jnp.asarray(rhs), (jcore.ONE,)),
                  jcore.AffineDense(jnp.asarray(out), (jcore.ONE,)), ls=ls)
    P = rs.uniform(0.5, 1.0, size=(5, 2))
    tu = trom.solve({"p": torch.tensor(P)})
    ju = jax.vmap(jrom.solve)({"p": jnp.asarray(P)})
    assert rel(tu, ju) < 1e-10
    assert rel(trom.solve({"p": torch.tensor(P[2])}), ju[2]) < 1e-10
    assert rel(trom.output(tu, {"p": torch.tensor(P)}),
               jax.vmap(jrom.output)(ju, {"p": jnp.asarray(P)})) < 1e-10


# ---------------------------------------------------------------------------
# default device: the card, never a quiet CPU fallback

DEFAULT_DEVICE_CTORS = {
    "thermal_block": lambda: ThermalBlockFOM((2, 2), 8),
    "gaussian_embedding": lambda: temb.GaussianEmbedding.make(50, range_dim=5),
    "hwprng_embedding": lambda: temb.HwPrngGaussianEmbedding.make(50, range_dim=5),
    "parameter_sample": lambda: tcore.ParameterSpace.make(
        {"diffusion": 4}, 0.1, 1.0).sample_randomly(3),
    "resolve_device": lambda: resolve_device(None),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CTORS))
def test_no_device_without_cuda_raises(monkeypatch, name):
    """Without a card, an entry point given no device raises and names the
    CPU opt-in; naming the CPU works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DEFAULT_DEVICE_CTORS[name]()
    assert resolve_device("cpu") == torch.device("cpu")
    assert ThermalBlockFOM((2, 2), 8, device="cpu").device.type == "cpu"


def test_dense_op_promotes_complex_data():
    """A real DenseOp applied to complex data (and its adjoint) promotes to
    complex128, as the JAX package's DenseOp does, to 1e-14."""
    rng = np.random.RandomState(3)
    A = rng.normal(size=(7, 5))
    op, jop = tcore.DenseOp(torch.tensor(A), device="cpu"), jcore.DenseOp(jnp.asarray(A))
    x = rng.normal(size=(5, 2)) + 1j * rng.normal(size=(5, 2))
    v = rng.normal(size=(7,)) + 1j * rng.normal(size=(7,))
    got, adj = op.apply(torch.tensor(x)), op.apply_adjoint(torch.tensor(v))
    assert got.dtype == adj.dtype == torch.complex128
    assert rel(got, jop.apply(jnp.asarray(x))) < 1e-14
    assert rel(adj, jop.apply_adjoint(jnp.asarray(v))) < 1e-14


def _complex_foms(n=80, seed=0):
    """The complex Hermitian FOM of ``tests/test_complex.py::_complex_fom``
    in both packages: A(mu) = mu_0 A0 + mu_1 A1, complex rhs."""
    import scipy.sparse as sps

    from rla4mor_tpu.models import StationaryFOM as JaxStationaryFOM
    from rla4mor_tpu_torch.models import StationaryFOM

    rng = np.random.RandomState(seed)

    def hpd(scale):
        M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
        return sps.csr_matrix(M @ M.conj().T / n + scale * np.eye(n))

    A0, A1 = hpd(3.0), hpd(1.0)
    b = rng.normal(size=(n, 1)) + 1j * rng.normal(size=(n, 1))
    jfom = JaxStationaryFOM(
        jcore.AffineOp((jcore.HostSparseOp(A0), jcore.HostSparseOp(A1)),
                       (jcore.ProjectionCoefficient("p", 0),
                        jcore.ProjectionCoefficient("p", 1))),
        jcore.AffineOp((jcore.DenseOp(jnp.asarray(b)),)),
        parameter_space=jcore.ParameterSpace.make({"p": 2}, 0.5, 2.0))
    tfom = StationaryFOM(
        tcore.AffineOp((tcore.HostSparseOp(A0, device="cpu"),
                        tcore.HostSparseOp(A1, device="cpu")),
                       (tcore.ProjectionCoefficient("p", 0),
                        tcore.ProjectionCoefficient("p", 1))),
        tcore.AffineOp((tcore.DenseOp(torch.tensor(b), device="cpu"),)),
        parameter_space=tcore.ParameterSpace.make({"p": 2}, 0.5, 2.0), device="cpu")
    return jfom, tfom


def test_complex_sketched_reductor_matches_jax():
    """Mirrors ``tests/test_complex.py::test_complex_sketched_reductor``:
    complex snapshots through a real Gaussian Omega (carried from JAX); the
    ROM's solve equals the JAX package's to 1e-10, its estimate to 1e-10 of
    ||b|| (the residual estimate is a difference of O(||b||) sketches)."""
    from rla4mor_tpu.mor import SketchedReductor as JaxReductor
    from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian
    from rla4mor_tpu_torch.mor import SketchedReductor

    jfom, tfom = _complex_foms()
    n = tfom.solution_dim
    jtheta = JaxGaussian.make(n, range_dim=60, seed=5)
    ttheta = temb.GaussianEmbedding.from_matrix(np.asarray(jtheta.random_matrix()),
                                                device="cpu")
    rows = np.random.RandomState(4).uniform(0.5, 2.0, size=(7, 2))
    jred = JaxReductor(jfom, embedding_primal=jtheta, orthonormalize=True)
    tred = SketchedReductor(tfom, embedding_primal=ttheta, orthonormalize=True,
                            log_level=30)
    jred.extend_basis(jfom.solve_many([{"p": jnp.asarray(r)} for r in rows[:6]]))
    tred.extend_basis(tfom.solve_many([{"p": torch.tensor(r)} for r in rows[:6]]))
    jrom, trom = jred.reduce(seed=6), tred.reduce(seed=6)
    jmu, tmu = {"p": jnp.asarray(rows[6])}, {"p": torch.tensor(rows[6])}
    y = trom.solve(tmu)
    assert y.dtype == torch.complex128
    assert rel(y, jrom.solve(jmu)) < 1e-10
    est, jest = float(trom.estimate_error(tmu)), float(jrom.estimate_error(jmu))
    assert abs(est - jest) < 1e-10 * np.linalg.norm(tfom.assemble_rhs(tmu))
    u_rom = tred.rb.numpy() @ y.numpy()
    u_fom = tfom.solve(tmu).numpy()
    assert np.linalg.norm(u_rom - u_fom) / np.linalg.norm(u_fom) < 5e-2


# ---------------------------------------------------------------------------
# the rest of core/: parameters, operators, affine helpers, bounded least
# squares and POD


def test_mu_helpers_and_conjugate_coefficients():
    """``mu_unstack`` / ``mu_flat`` give the JAX package's values, and
    ``conj_coefficient`` simplifies as it does (projections and real
    constants are their own conjugates, conj of conj unwraps)."""
    rs = np.random.RandomState(7)
    leaves = {"a": rs.normal(size=(3, 2)), "b": rs.normal(size=(3, 1))}
    tmus = tcore.mu_unstack({k: torch.tensor(v) for k, v in leaves.items()})
    jmus = jcore.mu_unstack({k: jnp.asarray(v) for k, v in leaves.items()})
    assert len(tmus) == len(jmus) == 3
    for tm, jm in zip(tmus, jmus):
        for k in leaves:
            assert np.array_equal(tm[k].numpy(), np.asarray(jm[k]))
        assert np.array_equal(tcore.mu_flat(tm, ("b", "a")).numpy(),
                              np.asarray(jparams.mu_flat(jm, ("b", "a"))))
    tproj = tcore.ProjectionCoefficient("a", 1)
    assert tcore.conj_coefficient(tproj) is tproj
    assert tcore.conj_coefficient(tcore.ConstantCoefficient(2.0)) == tcore.ConstantCoefficient(2.0)
    tconst = tcore.conj_coefficient(tcore.ConstantCoefficient(1 + 2j))
    jconst = jparams.conj_coefficient(jcore.ConstantCoefficient(1 + 2j))
    assert tconst.value == jconst.value == 1 - 2j
    expr = tcore.ExpressionCoefficient(lambda mu: mu["a"][..., 0] * 1j, name="i a0")
    conj = tcore.conj_coefficient(expr)
    assert isinstance(conj, tcore.ConjugateCoefficient)
    assert tcore.conj_coefficient(conj) is expr
    prod = tcore.conj_coefficient(tproj * expr)
    assert isinstance(prod, tcore.ProductCoefficient) and prod.factors[0] is tproj
    jexpr = jcore.ExpressionCoefficient(lambda mu: mu["a"][0] * 1j, name="i a0")
    assert complex(conj(tmus[1])) == complex(jparams.conj_coefficient(jexpr)(jmus[1]))


def _ops(rs):
    """The same small operators in both packages: diagonal, adjoint, scaled,
    zero and a chain's adjoint."""
    A = rs.normal(size=(6, 4))
    d = rs.normal(size=6)
    tA, jA = tcore.DenseOp(A, device="cpu"), jcore.DenseOp(jnp.asarray(A))
    tD, jD = tcore.DiagonalOp(d, device="cpu"), jcore.DiagonalOp(jnp.asarray(d))
    return {
        "diagonal": (tD, jD),
        "adjoint": (tcore.AdjointOp(tA), jcore.AdjointOp(jA)),
        "scaled": (tcore.ScaledOp(tA, -2.5), jcore.ScaledOp(jA, -2.5)),
        "zero": (tcore.ZeroOp(3, 6), jcore.ZeroOp(3, 6)),
        "chain_adjoint": (tcore.ChainOp((tD, tA)).H, jcore.ChainOp((jD, jA)).H),
    }


@pytest.mark.parametrize("name", ["diagonal", "adjoint", "scaled", "zero", "chain_adjoint"])
def test_new_operators_match_jax(name):
    """apply / apply_adjoint on a vector and a block, ``.H`` and
    ``to_matrix`` equal the JAX package's to 1e-12 relative."""
    rs = np.random.RandomState(8)
    top, jop = _ops(rs)[name]
    for cols in (None, 3):
        shape = (top.source_dim,) if cols is None else (top.source_dim, cols)
        x = rs.normal(size=shape)
        got, ref = top.apply(torch.tensor(x)), np.asarray(jop.apply(jnp.asarray(x)))
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)
        shape = (top.range_dim,) if cols is None else (top.range_dim, cols)
        y = rs.normal(size=shape)
        got = top.apply_adjoint(torch.tensor(y))
        ref = np.asarray(jop.apply_adjoint(jnp.asarray(y)))
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)
    M, jM = tcore.to_matrix(top), np.asarray(jcore.to_matrix(jop))
    assert np.abs(M.numpy() - jM).max() <= 1e-12 * max(np.abs(jM).max(), 1.0)
    assert np.abs(tcore.to_matrix(top.H).numpy() - jM.T).max() <= 1e-12 * max(np.abs(jM).max(), 1.0)
    assert tcore.to_matrix(M, torch.float32).dtype == torch.float32


def test_sparse_cholesky_and_scipy_adapter(foms):
    """``sparse_cholesky`` gives the JAX package's factor (Q^H Q = S), and
    ``ScipyLinearOperator`` hands a port operator to scipy's GMRES as a
    preconditioner: the same solution as with the JAX one, to 1e-12."""
    import scipy.sparse.linalg as spla

    jfom, tfom = foms
    S = tfom.h1_0_product.op.S
    Q, jQ = tcore.sparse_cholesky(S), jcore.sparse_cholesky(S)
    assert abs(Q - jQ).max() == 0.0
    assert abs(Q.T @ Q - S).max() < 1e-12 * abs(S).max()
    b = np.random.RandomState(9).normal(size=S.shape[0])
    tM = tcore.ScipyLinearOperator(tfom.h1_0_product.inv)
    jM = jcore.ScipyLinearOperator(jfom.h1_0_product.inv)
    x = tM.matvec(b)
    assert rel(x, jM.matvec(b)) < 1e-12 and rel(tM.rmatvec(b), jM.rmatvec(b)) < 1e-12
    A = tfom.assemble_sparse({"diffusion": torch.full((4,), 0.5)})
    tx, info = spla.gmres(A, b, M=tM, rtol=1e-12, atol=0.0)
    jx, jinfo = spla.gmres(A, b, M=jM, rtol=1e-12, atol=0.0)
    assert info == jinfo == 0 and rel(tx, jx) < 1e-12


@pytest.mark.parametrize("block", [None, 2], ids=["whole", "blocks_of_2"])
def test_apply2_and_project_block_match_jax(foms, block):
    """``apply2`` at one Mu and a batch, and ``project_block`` on the source
    side and (through the adjoint) the range side, equal the JAX package's
    to 1e-12 relative."""
    jfom, tfom = foms
    rs = np.random.RandomState(10)
    V, W = rs.normal(size=(225, 3)), rs.normal(size=(225, 5))
    P = rs.uniform(0.1, 1.0, size=(4, 4))
    tP, jP = tfom.h1_0_product.op, jfom.h1_0_product.op
    tb = tcore.apply2(tfom.operator, torch.tensor(V), torch.tensor(W),
                      {"diffusion": torch.tensor(P)}, product=tP)
    for i in range(4):
        ref = jcore.apply2(jfom.operator, jnp.asarray(V), jnp.asarray(W),
                           {"diffusion": jnp.asarray(P[i])}, product=jP)
        assert rel(tb[i], ref) < 1e-12
    for v, w in ((V, W), (V, None)):
        tv, tw = torch.tensor(v), None if w is None else torch.tensor(w)
        jv, jw = jnp.asarray(v), None if w is None else jnp.asarray(w)
        got = tcore.project_block(tfom.operator, tv, tw, product=tP, max_block_size=block)
        ref = jcore.project_block(jfom.operator, jv, jw, product=jP, max_block_size=block)
        assert rel(got.stack, ref.stack) < 1e-12
        assert got.coefficients == tuple(tcore.conj_coefficient(c) for c in got.coefficients)


@pytest.fixture(scope="module")
def bounded_problems():
    """A (2, 3) batch of bound-constrained problems and the JAX package's
    solution of each (300 steps), computed once."""
    from rla4mor_tpu.core.solvers import bounded_lstsq as jax_bounded

    rs = np.random.RandomState(11)
    G = rs.normal(size=(2, 3, 12, 4))
    g = rs.normal(size=(2, 3, 12)) * 3.0
    lb, ub = np.full(4, -0.2), np.full(4, 0.3)
    solve = jax.jit(jax.vmap(jax.vmap(lambda A, b: jax_bounded(
        A, b, jnp.asarray(lb), jnp.asarray(ub), iters=300))))
    return G, g, lb, ub, np.asarray(solve(jnp.asarray(G), jnp.asarray(g)))


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_bounded_lstsq_matches_jax(bounded_problems, batched):
    """``bounded_lstsq`` (Nesterov projected gradient, 300 steps) equals the
    JAX package's to 1e-12 relative, on problems whose minimiser has active
    bounds; batched over leading dimensions it equals its single calls."""
    G, g, lb, ub, refs = bounded_problems
    assert ((refs == lb) | (refs == ub)).any()  # some bounds are active
    if batched:
        got = tcore.bounded_lstsq(torch.tensor(G), torch.tensor(g), torch.tensor(lb),
                                  torch.tensor(ub), iters=300).numpy()
    else:
        got = np.stack([[tcore.bounded_lstsq(torch.tensor(G[i, j]), torch.tensor(g[i, j]),
                                             lb, ub, iters=300).numpy()
                         for j in range(3)] for i in range(2)])
    assert np.abs(got - refs).max() <= 1e-12 * np.abs(refs).max()


@pytest.mark.parametrize("product", [False, True], ids=["l2", "h1_0"])
def test_pod_matches_jax(foms, product):
    """``pod`` (method of snapshots): singular values to 1e-10 relative,
    modes up to the sign of each column to 1e-8, at the default ``rtol``
    and with ``rtol=None``."""
    jfom, tfom = foms
    rs = np.random.RandomState(12)
    U = rs.normal(size=(225, 9)) * 0.5 ** np.arange(9)  # spectrum over 2.5 decades
    tP = tfom.h1_0_product if product else None
    jP = jfom.h1_0_product if product else None
    for kw in ({}, {"modes": 6, "rtol": None}):
        tm, ts = tcore.pod(torch.tensor(U), product=tP, **kw)
        jm, js = jcore.pod(jnp.asarray(U), product=jP, **kw)
        jm, js = np.asarray(jm), np.asarray(js)
        assert ts.shape == js.shape and rel(ts, js) < 1e-10
        signs = np.sign(np.sum(tm.numpy() * jm, axis=0))
        assert np.abs(tm.numpy() * signs - jm).max() < 1e-8 * np.abs(jm).max()


@pytest.mark.parametrize("package", ["core", "estim"])
def test_exports_cover_the_jax_package(package):
    """The port's ``core`` and ``estim`` export every name the JAX
    package's do."""
    import importlib

    jax_pkg = importlib.import_module(f"rla4mor_tpu.{package}")
    port = importlib.import_module(f"rla4mor_tpu_torch.{package}")
    assert not set(jax_pkg.__all__) - set(port.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
