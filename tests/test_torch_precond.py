"""The port's sketched preconditioner selector (``precond/``), its device
inverses, ``estimate_image``, ``source_array`` / ``range_array`` and
``VectorizedEmbedding`` held against the JAX package on the CPU in float64.

Each test feeds the same numpy inputs to both packages; the random
operators (Gaussian Omegas, BlockGaussian ones as their matrices, SRHT
plans) are carried from the JAX side (``GaussianEmbedding.from_matrix``,
``SrhtEmbedding.from_plan``). The reductor tests use ``tests/test_precond.py``'s
setup (thermal block 2x2 at 12 intervals, ``HostLUInverse`` directions at 3
parameters, keys ``u_u`` / ``u_ur`` / ``ur_ur``), built once per module on
each side. Tolerances: 1e-12 for the embeddings, 1e-10 for the inverses and
the reductor's quantities, 1e-8 for the demo's ROM coefficients (its CG
solves stop at 1e-7, with equal iteration counts on both sides).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.models.stencil as jst
from rla4mor_tpu.core import AffineOp as JaxAffineOp
from rla4mor_tpu.core import CGInverseOp as JaxCGInverse
from rla4mor_tpu.core import DenseOp as JaxDenseOp
from rla4mor_tpu.core import DeviceCholeskyInverse as JaxCholesky
from rla4mor_tpu.core import HostLUInverse as JaxLU
from rla4mor_tpu.core import RecycledCGInverseOp as JaxRecycled
from rla4mor_tpu.core import estimate_image as jax_estimate_image
from rla4mor_tpu.core import gram_schmidt as jax_gram_schmidt
from rla4mor_tpu.core import mu_stack as jax_mu_stack
from rla4mor_tpu.core.parameters import ONE as JAX_ONE
from rla4mor_tpu.core.parameters import ParameterSpace as JaxSpace
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.models.stationary import StationaryFOM as JaxStationaryFOM
from rla4mor_tpu.ops import BlockGaussianEmbedding as JaxBlockGaussian
from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian
from rla4mor_tpu.ops import SrhtEmbedding as JaxSrht
from rla4mor_tpu.ops import VectorizedEmbedding as JaxVectorized
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan
from rla4mor_tpu.precond import PreconditionedReductor as JaxReductor

from rla4mor_tpu_torch.core import (
    CGInverseOp,
    DeviceCholeskyInverse,
    HostLUInverse,
    RecycledCGInverseOp,
    estimate_image,
    mu_stack,
)
from rla4mor_tpu_torch.examples import preconditioned_large_demo as demo
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.ops import (
    EmbeddingVectorized,
    GaussianEmbedding,
    SrhtEmbedding,
    VectorizedEmbedding,
)
from rla4mor_tpu_torch.precond import FactoredROM, PreconditionedReductor

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

K = 10  # range of the HS-estimator embeddings, as in tests/test_precond.py


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def tmu(mu):
    """A JAX Mu as the port's (float64 CPU tensors)."""
    return {k: torch.tensor(np.asarray(v)) for k, v in mu.items()}


# ---------------------------------------------------------------------------
# device inverses


@pytest.fixture(scope="module")
def spd():
    """The assembled thermal block at one parameter (n = 121), dense, and
    right-hand sides from numpy."""
    fom = JaxFOM((2, 2), 12)
    mu = fom.parameter_space.sample_randomly(1, key=4)[0]
    A = fom.assemble_sparse(mu).toarray()
    rs = np.random.RandomState(2)
    b = rs.normal(size=A.shape[0])
    return {"A": A, "b": b, "b2": b + 0.05 * rs.normal(size=A.shape[0]),
            "X": rs.normal(size=(A.shape[0], 3))}


def _jacobi(A, xp):
    d = xp.asarray(np.diag(A).copy())
    return lambda r: r / d


def test_cg_and_cholesky_inverses_match_jax(spd):
    A, X = spd["A"], spd["X"]
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jcg = JaxCGInverse(lambda v: jA @ v, A.shape[0], precond=_jacobi(A, jnp),
                       tol=1e-12, maxiter=3000)
    tcg = CGInverseOp(lambda v: tA @ v, A.shape[0], precond=_jacobi(A, torch),
                      tol=1e-12, maxiter=3000)
    want = np.asarray(jcg.apply(jnp.asarray(X)))
    assert rel(tcg.apply(torch.tensor(X)), want) < 1e-10
    assert rel(tcg.apply_adjoint(torch.tensor(X[:, 0])), want[:, 0]) < 1e-10
    assert rel(tcg.apply_inverse(torch.tensor(X)), A @ X) < 1e-12

    jch, tch = JaxCholesky(jA), DeviceCholeskyInverse(tA)
    want = np.asarray(jch.apply(jnp.asarray(X)))
    assert rel(tch.apply(torch.tensor(X)), want) < 1e-10
    assert rel(tch.apply_adjoint(torch.tensor(X[:, 1])), want[:, 1]) < 1e-10
    assert rel(tch.apply(torch.tensor(X)), np.linalg.solve(A, X)) < 1e-10
    assert rel(tch.apply_inverse(torch.tensor(X)), A @ X) < 1e-12


def test_recycled_cg_matches_jax(spd):
    """The same sequence of solves (a cold one, the same right-hand side
    again, a nearby one, a block) gives the same solutions and the same CG
    iteration counts: the recycled ring evolves alike in both packages."""
    A = spd["A"]
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jop = JaxRecycled(lambda v: jA @ v, A.shape[0], precond=_jacobi(A, jnp),
                      tol=1e-12, maxiter=3000, m_max=8)
    top = RecycledCGInverseOp(lambda v: tA @ v, A.shape[0], precond=_jacobi(A, torch),
                              tol=1e-12, maxiter=3000, m_max=8, device="cpu")
    iters = []
    for rhs in (spd["b"], spd["b"], spd["b2"], spd["X"]):
        want = np.asarray(jop.apply(jnp.asarray(rhs)))
        got = top.apply(torch.tensor(rhs))
        assert rel(got, want) < 1e-10
        assert top.last_iters == jop.last_iters
        iters.append(top.last_iters)
    assert iters[1] <= 2 < iters[0] and iters[2] < iters[0]
    assert top.solves == 6
    assert rel(top.apply_inverse(torch.tensor(spd["X"])), A @ spd["X"]) < 1e-12


# ---------------------------------------------------------------------------
# embeddings


def test_source_range_arrays_and_vectorized_embedding_match_jax():
    jfom, tfom = JaxFOM((2, 2), 12), ThermalBlockFOM((2, 2), 12, device="cpu")
    n = jfom.solution_dim
    je = JaxGaussian.make(n, sqrt_product=jfom.h1_0_product.sqrt, range_dim=K, seed=10)
    te = GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                       sqrt_product=tfom.h1_0_product.sqrt, device="cpu")
    assert rel(te.source_array(), je.source_array()) < 1e-12
    assert rel(te.range_array(), je.range_array()) < 1e-12
    assert te.source_array().shape == (n, K)

    inner = JaxBlockGaussian.make(K * 6, range_dim=8, seed=30, max_block_size=3)
    jv = JaxVectorized(embedding=inner, rows=K, cols=6)
    tv = VectorizedEmbedding(GaussianEmbedding.from_matrix(np.asarray(inner.random_matrix()),
                                                           device="cpu"), K, 6)
    assert EmbeddingVectorized is VectorizedEmbedding
    assert (tv.source_dim, tv.range_dim) == (jv.source_dim, jv.range_dim)
    M = np.random.RandomState(5).normal(size=(K, 6))
    assert rel(tv.apply_matrix(torch.tensor(M)), jv.apply_matrix(jnp.asarray(M))) < 1e-12
    assert rel(tv.apply(torch.tensor(M.reshape(-1))), jv.apply(jnp.asarray(M.reshape(-1)))) < 1e-12
    with pytest.raises(ValueError):
        tv.apply_matrix(torch.tensor(M.T))


# ---------------------------------------------------------------------------
# the reductor, on tests/test_precond.py's setup


class _Pair:
    """tests/test_precond.py's Setup built in both packages: the JAX one
    draws, the port takes its basis, parameters and random matrices."""

    def __init__(self):
        jfom = JaxFOM((2, 2), 12)
        tfom = ThermalBlockFOM((2, 2), 12, device="cpu")
        n = jfom.solution_dim
        jQ, tQ = jfom.h1_0_product.sqrt, tfom.h1_0_product.sqrt
        space = jfom.parameter_space
        U = np.asarray(jax_gram_schmidt(jfom.solve_many(space.sample_randomly(10, key=0)),
                                        product=jfom.h1_0_product))
        r = U.shape[1]
        self.jfom, self.tfom, self.U, self.space = jfom, tfom, U, space
        self.mu_precond = space.sample_randomly(3, key=1)

        def vec(k_omega, k_sigma, seed):
            inner = JaxBlockGaussian.make(k_omega * k_sigma, range_dim=K, seed=seed,
                                          max_block_size=32)
            return (JaxVectorized(embedding=inner, rows=k_omega, cols=k_sigma),
                    VectorizedEmbedding(GaussianEmbedding.from_matrix(
                        np.asarray(inner.random_matrix()), device="cpu"), k_omega, k_sigma))

        def gauss(jemb, sqrt):
            return jemb, GaussianEmbedding.from_matrix(
                np.asarray(jemb.random_matrix()), sqrt_product=sqrt, device="cpu")

        self.sigma = {
            "u_u": gauss(JaxGaussian.make(n, sqrt_product=jQ, range_dim=K, seed=10), tQ),
            "u_ur": gauss(JaxGaussian.make(n, sqrt_product=jQ, range_dim=K, seed=11), tQ),
            "ur_ur": gauss(JaxGaussian.make(r, range_dim=K, seed=12), None),
        }
        self.omega = {
            "u_u": gauss(JaxBlockGaussian.make(n, sqrt_product=jQ, range_dim=K, seed=20,
                                               max_block_size=2), tQ),
            "u_ur": gauss(JaxGaussian.make(r, range_dim=K, seed=21), None),
            "ur_ur": gauss(JaxGaussian.make(r, range_dim=K, seed=22), None),
        }
        self.gamma = {"u_u": vec(K, K, 30), "u_ur": vec(K, K, 31), "ur_ur": vec(K, K, 32)}
        self.theta = gauss(JaxGaussian.make(n, sqrt_product=jQ, range_dim=200, seed=40), tQ)
        self.inter_jax = {
            "lhs": estimate_image_jax(jfom.operator, U, jfom.h1_0_product),
            "rhs": jax_estimate_image((), (jfom.rhs,), None, product=jfom.h1_0_product),
        }
        self.inter_port = {
            "lhs": estimate_image((tfom.operator,), (), torch.tensor(U),
                                  product=tfom.h1_0_product),
            "rhs": estimate_image((), (tfom.rhs,), None, product=tfom.h1_0_product),
        }

    def reductors(self, stable):
        out = []
        port_lu = functools.partial(HostLUInverse, device="cpu")
        for i, (cls, fom, lu) in enumerate(((JaxReductor, self.jfom, JaxLU),
                                            (PreconditionedReductor, self.tfom, port_lu))):
            pick = {k: v[i] for k, v in self.sigma.items()}
            U = jnp.asarray(self.U) if i == 0 else torch.tensor(self.U)
            inter = self.inter_jax if i == 0 else self.inter_port
            red = cls(
                fom=fom, reduced_basis=U,
                source_bases={"u_ur": None, "ur_ur": U, "u_u": None},
                range_bases={"u_ur": U, "ur_ur": U, "u_u": None},
                source_embeddings=pick,
                range_embeddings={k: v[i] for k, v in self.omega.items()},
                vec_embeddings={k: v[i] for k, v in self.gamma.items()},
                residual_embedding=self.theta[i],
                intermediate_bases=inter if stable else None,
                product=fom.h1_0_product, stable_galerkin=stable, log_level=40)
            for mu in self.mu_precond:
                m = mu if i == 0 else tmu(mu)
                red.add_preconditioner(lu(fom.assemble_sparse(m)), mu=m)
            out.append(red)
        return out

    def mu_p(self, key_mu, key_y):
        mu = self.space.sample_randomly(1, key=key_mu)[0]
        y = np.random.RandomState(key_y).normal(size=3)
        return {**mu, "precond": jnp.asarray(y)}


def estimate_image_jax(operator, U, product):
    return jax_estimate_image((operator,), (), jnp.asarray(U), product=product)


@pytest.fixture(scope="module")
def pair():
    return _Pair()


@pytest.fixture(scope="module")
def reductors(pair):
    return {stable: pair.reductors(stable) for stable in (False, True)}


def test_estimate_image_matches_jax(pair):
    """The same number of columns, R-orthonormal, spanning the image that
    the JAX package's columns span. The 40 image vectors R^-1 A_j u are
    nearly dependent, so past the leading columns Gram-Schmidt's rounding is
    amplified differently in each package (the 20th columns differ by
    1e-2); the stable ROM reads only the span. Its module fixture (about
    9 s) builds both packages' setups, the JAX side's solves and Gram-Schmidt
    compiling, for every reductor test here."""
    R = pair.tfom.h1_0_product.op.matrix().numpy()
    for key, ops, vecs, basis in (("lhs", (pair.jfom.operator,), (), jnp.asarray(pair.U)),
                                  ("rhs", (), (pair.jfom.rhs,), None)):
        got, want = pair.inter_port[key].numpy(), np.asarray(pair.inter_jax[key])
        assert got.shape == want.shape
        assert np.abs(got.T @ R @ got - np.eye(got.shape[1])).max() < 1e-12
        assert rel(got[:, :5], want[:, :5]) < 1e-12
        X = np.asarray(jax_estimate_image(ops, vecs, basis, product=pair.jfom.h1_0_product,
                                          orthonormalize=False))
        assert rel(got @ (got.T @ (R @ X)), X) < 1e-10


@pytest.mark.parametrize("stable", [False, True], ids=["naive", "stable"])
def test_reductor_matches_jax(pair, reductors, stable):
    jred, tred = reductors[stable]
    assert isinstance(tred.prom.rom, FactoredROM) == stable
    for key in ("u_u", "u_ur", "ur_ur"):
        assert rel(tred.hs_estimators_rhs[key], jred.hs_estimators_rhs[key]) < 1e-10
        for got, want in zip(tred.hs_estimators_lhs[key], jred.hs_estimators_lhs[key]):
            assert rel(got, want) < 1e-10
    jmu_p = pair.mu_p(key_mu=9, key_y=10)
    mu_p = tmu(jmu_p)
    for key in ("u_u", [("u_ur", 1.0), ("ur_ur", 0.5)]):
        Wt, ht = tred.assemble_hs_estimator(mu_p, key)
        Wj, hj = jred.assemble_hs_estimator(jmu_p, key)
        assert rel(Wt, Wj) < 1e-10 and rel(ht, hj) < 1e-10
        assert rel(tred._estimate_hs(mu_p, key), jred._estimate_hs(jmu_p, key)) < 1e-10
        mu = {"diffusion": mu_p["diffusion"]}
        (tmu_p, trn), (jmu_sel, jrn) = (tred.minimize_hs_estimator(mu, key),
                                        jred.minimize_hs_estimator({"diffusion": jmu_p["diffusion"]}, key))
        assert rel(tmu_p["precond"], jmu_sel["precond"]) < 1e-10
        assert rel(trn, jrn) < 1e-10
        (tu, _), (ju, _) = tred.solve(mu, key), jred.solve({"diffusion": jmu_p["diffusion"]}, key)
        assert rel(tu, ju) < 1e-10
    A, b = tred.assemble_rom_system(mu_p)
    Aj, bj = jred.assemble_rom_system(jmu_p)
    assert rel(A, Aj) < 1e-10 and rel(b, bj) < 1e-10
    assert rel(tred.prom.rom.solve(mu_p), jred.prom.rom.solve(jmu_p)) < 1e-10
    assert rel(tred.prom.rom.estimate_error(mu_p), jred.prom.rom.estimate_error(jmu_p)) < 1e-10
    q = tred.estimate_quasi_optimality(mu_p)
    qj = jred.estimate_quasi_optimality(jmu_p)
    assert (np.isinf(float(q)) and np.isinf(float(qj))) or rel(q, qj) < 1e-10


@pytest.mark.parametrize("stable", [False, True], ids=["naive", "stable"])
def test_solve_batch_matches_solve_and_jax(pair, reductors, stable):
    """The batched online stage equals the per-parameter one, and the JAX
    package's jitted vmap."""
    jred, tred = reductors[stable]
    jmus = pair.space.sample_randomly(5, key=77)
    mus = [tmu(m) for m in jmus]
    for key in ("u_u", [("u_ur", 1.0), ("ur_ur", 0.5)]):
        us, ys, rnorms = tred.solve_batch(mu_stack(mus), key)
        jus, jys, jrn = jred.solve_batch(jax_mu_stack(jmus), key)
        assert us.shape == (5, pair.U.shape[1]) and ys.shape == (5, 3)
        assert rel(us, jus) < 1e-10 and rel(ys, jys) < 1e-10 and rel(rnorms, jrn) < 1e-10
        for i, mu in enumerate(mus):
            mu_p, rn = tred.minimize_hs_estimator(mu, key)
            u, _ = tred.solve(mu, key)
            assert rel(ys[i], mu_p["precond"]) < 1e-10
            assert rel(rnorms[i], rn) < 1e-10
            assert rel(us[i], u) < 1e-10
        est = tred.prom.rom.estimate_error({**mu_stack(mus), "precond": ys}, us)
        for i, mu in enumerate(mus):
            one = tred.prom.rom.estimate_error({**mu, "precond": ys[i]}, us[i])
            assert rel(est[i], one) < 1e-10


def test_minimize_hs_at_a_direction_parameter(pair, reductors):
    """At mu_i the selector picks e_i: P_i = A(mu_i)^-1 exactly."""
    tred = reductors[False][1]
    mu_p, rnorm = tred.minimize_hs_estimator(tmu(pair.mu_precond[0]), "u_u")
    y = mu_p["precond"].numpy()
    assert abs(y[0] - 1.0) < 1e-6 and np.abs(y[1:]).max() < 1e-6
    assert float(rnorm) < 1e-8


# ---------------------------------------------------------------------------
# the demo at grid 16


def _jax_demo(grid, mus, emb):
    """examples/preconditioned_large_demo.py's pipeline in the JAX package,
    Jacobi-preconditioned, its directions applied to the interior as the
    port's are (the JAX demo's directions meet right-hand sides with
    Dirichlet-ring entries, on which its CG fails)."""
    import jax

    from rla4mor_tpu.core.linops import LinOp as JaxLinOp

    st = jst.StencilThermalBlock((2, 2), grid, dtype=jnp.float64)
    N1 = st.n_nodes
    n = N1 * N1
    space = JaxSpace.make({"diffusion": st.n_terms}, 0.1, 1.0)
    fom = JaxStationaryFOM(st.affine_operator(),
                           JaxAffineOp((JaxDenseOp(st.rhs().reshape(-1, 1)),), (JAX_ONE,)),
                           parameter_space=space)
    snapshot = jax.jit(lambda d: st.solve_cg({"diffusion": d}, tol=1e-7, maxiter=400,
                                             precond="jacobi").reshape(-1))
    U = jax_gram_schmidt(jnp.stack([snapshot(m["diffusion"]) for m in mus["rb"]], axis=1))
    red = JaxReductor(
        fom=fom, reduced_basis=U, source_bases={"ur_ur": U}, range_bases={"ur_ur": U},
        source_embeddings={"ur_ur": emb["sigma"]}, range_embeddings={"ur_ur": emb["omega"]},
        vec_embeddings={"ur_ur": emb["vec"]}, residual_embedding=emb["residual"],
        stable_galerkin=True, log_level=40)
    mask = jst.interior_mask(N1, jnp.float64).reshape(-1)

    class Interior(JaxLinOp):
        def __init__(self, inv):
            self.inv, self.source_dim, self.range_dim = inv, n, n

        def apply(self, X, mu=None):
            X = jnp.asarray(X)
            return self.inv.apply(X * (mask if X.ndim == 1 else mask[:, None]))

        apply_adjoint = apply

    iters = []
    for mu in mus["dir"]:
        diag = st.jacobi_diag(mu).reshape(-1)
        P = JaxRecycled(lambda v, mu=mu: st.apply(mu, v.reshape(N1, N1)).reshape(-1), n,
                        precond=lambda r, diag=diag: r / diag,
                        tol=1e-7, maxiter=300, dtype=jnp.float64)
        red.add_preconditioner(Interior(P), mu)
        iters.append(P.last_iters)
    us, ys, rn = red.solve_batch(jax_mu_stack(mus["online"]), "ur_ur")
    return {"U": U, "red": red, "iters": iters, "us": us, "ys": ys, "rnorms": rn}


def test_demo_matches_jax_at_grid_16():
    """The port's demo (``run(device="cpu", precond="jacobi")``) against the
    JAX package's pieces at grid 16, Jacobi-preconditioned in both (the
    V-cycles are held to each other in tests/test_torch_stencil.py), the
    embeddings and the parameters carried over. About 12 s, most of it the
    JAX side's compilations (one CG per direction)."""
    grid, r, k_res = 16, 4, 40
    n = (grid + 1) ** 2
    rs = np.random.RandomState(16)
    draw = {name: [{"diffusion": rs.uniform(0.1, 1.0, size=4)} for _ in range(count)]
            for name, count in (("rb", r), ("dir", 2), ("online", 6))}
    jemb = {
        "sigma": JaxGaussian.make(r, range_dim=2 * r, seed=10),
        "omega": JaxGaussian.make(r, range_dim=2 * r, seed=11),
        "vec": JaxVectorized(embedding=JaxGaussian.make(4 * r * r, range_dim=4 * r, seed=12),
                             rows=2 * r, cols=2 * r),
        "residual": JaxSrht.make(n, range_dim=k_res, seed=13),
    }
    signs, sampling, _ = jax_srht_plan(jemb["residual"].key, n, k_res)

    def carry(e):
        return GaussianEmbedding.from_matrix(np.asarray(e.random_matrix()), device="cpu")

    temb = {"sigma": carry(jemb["sigma"]), "omega": carry(jemb["omega"]),
            "vec": VectorizedEmbedding(carry(jemb["vec"].embedding), 2 * r, 2 * r),
            "residual": SrhtEmbedding.from_plan(n, k_res, np.asarray(signs),
                                                np.asarray(sampling), device="cpu")}
    want = _jax_demo(grid, {k: [{"diffusion": jnp.asarray(m["diffusion"])} for m in v]
                            for k, v in draw.items()}, jemb)
    got = demo.run(grid, nrb=r, ndir=2, nmu=6, k_res=k_res, device="cpu", precond="jacobi",
                   embeddings=temb, log=lambda *a: None,
                   mus={k: [{"diffusion": torch.tensor(m["diffusion"])} for m in v]
                        for k, v in draw.items()})
    assert rel(got["U"], want["U"]) < 1e-10
    assert [P.last_iters for P in got["directions"]] == want["iters"]
    assert all(P.solves == 4 * 2 * r + r + k_res for P in got["directions"])
    assert all(2 < it < 300 for it in want["iters"])
    assert rel(got["us"], want["us"]) < 1e-8
    assert rel(got["ys"], want["ys"]) < 1e-8
    assert rel(got["rnorms"], want["rnorms"]) < 1e-8
    # the residual estimates are finite and agree too
    jest = np.array([want["red"].prom.rom.estimate_error(
        {"diffusion": jnp.asarray(m["diffusion"]), "precond": y}, u)
        for m, y, u in zip(draw["online"], want["ys"], want["us"])])
    test = got["reductor"].prom.rom.estimate_error(
        {**mu_stack(got["mus"]["online"]), "precond": got["ys"]}, got["us"])
    assert np.isfinite(jest).all() and rel(test, jest) < 1e-8
    assert all(np.isfinite(got["errors"]))
