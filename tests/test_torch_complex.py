"""The port's complex path held against the JAX package (complex128, CPU):
the damped Helmholtz FOM (``models/helmholtz.py``), the complex SRHT input
in one call, and ``examples/helmholtz_demo.py::run`` against the JAX
demo's flow (``examples/helmholtz_demo.py`` without its plot).

The demo comparison runs both at grid 9 (n = 64) with 5 greedy extensions
(the last ROM is the demo's r <= 5 one), the JAX package's complex Gaussian
Omegas carried into the port (``from_matrix``; the online sketch redrawn
for each seed from the JAX draw) and its test and background wavenumbers
passed in. Tolerances: the same greedy picks and SCM anchors; greedy
errors and estimates to 1e-8 of their largest, sweep errors and estimates
to 1e-12 of the state's norm (the float64 floor), bounds to 1e-6 (an LP's
optimum); recovery errors to 1e-6 relative, or 1e-9 absolute where both are
at the float64 floor (PBDW's 8 background states resolve the grid-9
manifold to 1e-15-1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.examples import helmholtz_demo
from rla4mor_tpu_torch.models import helmholtz_fom
from rla4mor_tpu_torch.ops import srht_cuda
from rla4mor_tpu_torch.ops.fwht import _srht_plan

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

GRID, EXTENSIONS = 9, 5


def _jax_demo_flow(grid, extensions):
    """``examples/helmholtz_demo.py``'s main() without the plot, with the
    ROM's estimates, the sweep's solves and the recovery batched over the
    parameters (the JAX package's batched calls)."""
    from rla4mor_tpu.core import ChainOp, compose, materialize, project
    from rla4mor_tpu.core.orthonormalize import gram_schmidt
    from rla4mor_tpu.core.parameters import mu_stack
    from rla4mor_tpu.estim import DicRecoveryMap, PbdwRecoveryMap, ResidualDistanceDiscrete
    from rla4mor_tpu.models import helmholtz_fom as jax_helmholtz_fom
    from rla4mor_tpu.mor import ScmInfSup, SketchedReductor
    from rla4mor_tpu.ops import GaussianEmbedding

    fom = jax_helmholtz_fom(num_intervals=grid, wavenumber_range=(2.0, 8.0), damping=0.5)
    Ru = fom.h1_0_product
    n = fom.solution_dim
    theta = GaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=220, seed=2,
                                   complex_dtype=True)
    phi = GaussianEmbedding.make(220, range_dim=120, seed=33)
    red = SketchedReductor(fom, embedding_primal=theta, embedding_online=phi, product=Ru,
                           orthonormalize=True, projection="minres", log_level=30)
    train = [{"wavenumber": jnp.asarray([w])} for w in np.linspace(2.0, 8.0, 40)]
    test = fom.parameter_space.sample_randomly(12, key=8)
    train_b, test_b = mu_stack(train), mu_stack(test)
    u_test = np.asarray(fom.solve_many(test))
    nrm_test = np.asarray(Ru.norm(jnp.asarray(u_test)))
    hist = {"r": [], "err": [], "est": [], "picks": [0]}
    red.extend_basis(jnp.asarray(fom.solve(train[0])).reshape(-1, 1))
    for it in range(1, extensions + 1):
        rom = red.reduce(seed=100 + it)
        if red.basis_size <= 5:
            rom_mid, rb_mid = rom, np.asarray(red.rb).copy()
        # one compiled program a basis size (eagerly, each of the batched
        # solve's primitives compiles anew at each size)
        batched = jax.jit(rom.solve_and_estimate_batch)
        ests = np.asarray(batched(train_b)[1])
        y_t, est_t = batched(test_b)
        rel = np.asarray(Ru.norm(jnp.asarray(u_test - np.asarray(red.rb) @ np.asarray(y_t).T)))
        hist["r"].append(red.basis_size)
        hist["err"].append(float(np.median(rel / nrm_test)))
        hist["est"].append(float(np.median(np.asarray(est_t))))
        for j in np.argsort(-ests):
            if int(j) not in hist["picks"]:
                hist["picks"].append(int(j))
                red.extend_basis(jnp.asarray(fom.solve(train[j])).reshape(-1, 1))
                break
    scm = ScmInfSup(fom, product=Ru)
    # the fit evaluates the coefficients of the same 40 training parameters
    # by eager JAX at every LP of every round: memoized by wavenumber (the
    # same values, each computed once)
    theta_fn, memo = scm.scm.theta_fn, {}

    def memo_theta(mu):
        w = float(mu["wavenumber"][0])
        if w not in memo:
            memo[w] = theta_fn(mu)
        return memo[w]

    scm.scm.theta_fn = memo_theta
    fit = scm.fit(train, tol=0.2, max_anchors=len(train))
    sweep = [{"wavenumber": jnp.asarray([w])} for w in np.linspace(2.0, 8.0, 41)]
    y, est = rom_mid.solve_and_estimate_batch(mu_stack(sweep))
    U = np.asarray(fom.solve_many(sweep))
    err = np.asarray(Ru.norm(jnp.asarray(U - rb_mid @ np.asarray(y).T)))
    beta = np.array([scm(mu) for mu in sweep])
    est = np.asarray(est)
    bound = np.where(beta > 0, est / np.maximum(beta, 1e-300), np.inf)

    rows = np.random.RandomState(7).choice(n, size=min(30, n), replace=False)
    Wd = np.zeros((n, rows.size))
    Wd[rows, np.arange(rows.size)] = 1.0
    W = gram_schmidt(jnp.asarray(np.asarray(Ru.inv.apply(jnp.asarray(Wd)))), product=Ru)
    background = fom.parameter_space.sample_randomly(8, key=1)
    V = gram_schmidt(fom.solve_many(background), product=Ru)
    pbdw = PbdwRecoveryMap(V, W, product=Ru, log_level=30)
    mus_dic = [{"wavenumber": jnp.asarray([w])} for w in np.linspace(2, 8, 24)]
    u_dic = fom.solve_many(mus_dic)
    V_dic = np.asarray(u_dic) / np.asarray(Ru.norm(u_dic))[None, :]
    S = GaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=96, seed=11,
                               complex_dtype=True)
    chain = ChainOp((S, Ru.inv))
    X = jnp.concatenate([jnp.asarray(V_dic), W], axis=1)
    mdist = ResidualDistanceDiscrete(project(compose(chain, fom.operator), None, X),
                                     materialize(compose(chain, fom.rhs)), mus_dic)
    dic = DicRecoveryMap(jnp.asarray(V_dic), W, product=Ru, manifold_distance=mdist,
                         log_level=30)
    u_t = fom.solve_many([{"wavenumber": jnp.asarray([w])} for w in np.linspace(2.2, 7.8, 9)])
    obs = Ru.inner(W, u_t)
    nt = np.asarray(Ru.norm(u_t))
    wavenumbers = lambda mus: np.array([float(m["wavenumber"][0]) for m in mus])  # noqa: E731
    return {
        "omegas": {"theta": np.asarray(theta.random_matrix()),
                   "sketch": np.asarray(S.random_matrix())},
        "phi": phi, "test": wavenumbers(test), "background": wavenumbers(background),
        "greedy": hist,
        "scm": {"n_anchors": fit["n_anchors"], "max_gap": fit["max_gap"],
                "anchors": list(wavenumbers(scm.scm.anchor_mus))},
        "sweep": {"err": err, "est": est, "bound": bound},
        "recovery": {"pbdw": np.asarray(Ru.norm(u_t - jnp.asarray(pbdw.solve(obs)))) / nt,
                     "dic": np.asarray(Ru.norm(u_t - jnp.asarray(dic.solve(obs)))) / nt},
    }


@pytest.fixture(scope="module")
def demos():
    """The JAX demo flow and the port's ``run`` on the same operators: the
    file's only part over 5 s, nearly all of it the JAX flow (its eager
    greedy compiles its programs anew at each basis size, its SCM
    evaluates the coefficients by JAX for every LP, its recovery compiles
    the batched homotopy)."""
    ref = _jax_demo_flow(GRID, EXTENSIONS)
    jphi = ref["phi"]

    class CarriedOnline(temb.GaussianEmbedding):
        """The JAX online embedding: each seed's Omega drawn by the JAX
        package and carried in."""

        def with_seed(self, seed):
            omega = np.asarray(jphi.with_seed(seed).random_matrix())
            return CarriedOnline.from_matrix(omega, seed=seed, device="cpu")

    sqrt = helmholtz_fom(GRID, (2.0, 8.0), 0.5, device="cpu").h1_0_product.sqrt
    port = helmholtz_demo.run(
        GRID, EXTENSIONS, device="cpu", test=ref["test"], background=ref["background"],
        theta=temb.GaussianEmbedding.from_matrix(ref["omegas"]["theta"], sqrt_product=sqrt,
                                                 device="cpu"),
        phi=CarriedOnline.from_matrix(np.asarray(jphi.random_matrix()), seed=jphi.seed,
                                      device="cpu"),
        sketch=temb.GaussianEmbedding.from_matrix(ref["omegas"]["sketch"], sqrt_product=sqrt,
                                                  device="cpu"),
        log=lambda line: None)
    return ref, port


def close(a, b, tol):
    """|a - b| <= tol of the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() <= tol * np.abs(b).max()


def test_helmholtz_fom_matches_jax():
    """The FOM's terms, rhs, output and products equal the JAX package's; the
    complex coefficient -k^2 + i c k is not truncated (one and a batch of
    wavenumbers); complex128 solves agree to 1e-10 relative and solve the
    assembled system to 1e-10."""
    from rla4mor_tpu.models import helmholtz_fom as jax_helmholtz_fom

    jfom = jax_helmholtz_fom(16, (2.0, 10.0), 0.5)
    tfom = helmholtz_fom(16, (2.0, 10.0), 0.5, device="cpu")
    for jt, tt in zip(jfom.operator.terms, tfom.operator.terms):
        assert (jt.S != tt.S).nnz == 0
    assert (jfom.h1_0_product.op.S != tfom.h1_0_product.op.S).nnz == 0
    assert np.array_equal(np.asarray(jfom.output_functional.stack),
                          tfom.output_functional.stack.numpy())
    ws = torch.tensor([[2.5], [7.3], [9.9]], dtype=torch.float64)
    from rla4mor_tpu_torch.core import eval_coefficients

    theta = eval_coefficients(tfom.operator.coefficients, {"wavenumber": ws})
    k = ws[:, 0]
    assert torch.allclose(theta[:, 1], -(k ** 2) + 0.5j * k, rtol=0, atol=1e-14)
    for w in ws[:, 0].tolist():
        A = tfom.assemble_sparse({"wavenumber": torch.tensor([w], dtype=torch.float64)})
        jA = jfom.assemble_sparse({"wavenumber": jnp.asarray([w])})
        assert abs(A - jA).max() <= 1e-14 * abs(jA).max()
        u = tfom.solve({"wavenumber": torch.tensor([w], dtype=torch.float64)})
        assert u.dtype == torch.complex128
        ju = np.asarray(jfom.solve({"wavenumber": jnp.asarray([w])}))
        assert np.abs(u.numpy() - ju).max() <= 1e-10 * np.abs(ju).max()
        b = tfom.assemble_rhs({"wavenumber": torch.tensor([w], dtype=torch.float64)})
        assert np.linalg.norm(A @ u.numpy() - b) <= 1e-10 * np.linalg.norm(b)


def test_complex_srht_is_one_call_on_the_real_view():
    """A complex (n, m) input is sketched as its (n, 2m) real view in one
    call: equal to sketching the real and imaginary parts apart, bit for bit
    (the plain version; the card's kernel is held to it in
    ``tests/test_torch_cuda.py``), strided input too."""
    n, k = 5000, 64
    signs, sampling, _ = _srht_plan(1, n, k)
    gen = torch.Generator().manual_seed(3)
    x = torch.complex(torch.randn(n, 3, generator=gen, dtype=torch.float64),
                      torch.randn(n, 3, generator=gen, dtype=torch.float64))
    parts = torch.complex(
        srht_cuda.srht_onepass_plain(x.real.contiguous(), k, signs, sampling),
        srht_cuda.srht_onepass_plain(x.imag.contiguous(), k, signs, sampling))
    for xin in (x, x.T.contiguous().T):
        y = srht_cuda.srht_onepass(xin, k, signs, sampling)
        assert y.dtype == torch.complex128 and torch.equal(y, parts)
    assert srht_cuda.srht_onepass(x, k, signs, sampling, torch.float64).dtype == \
        torch.complex128


def test_demo_greedy_matches_jax(demos):
    """The complex sketched minres greedy picks the JAX flow's parameters;
    its median test errors and estimates agree to 1e-8 of the largest."""
    ref, port = demos
    assert port["greedy"]["picks"] == ref["greedy"]["picks"]
    assert port["greedy"]["r"] == ref["greedy"]["r"]
    assert close(port["greedy"]["err"], ref["greedy"]["err"], 1e-8)
    assert close(port["greedy"]["est"], ref["greedy"]["est"], 1e-8)
    assert port["greedy"]["err"][-1] < 1e-3 * port["greedy"]["err"][0]


def test_demo_scm_matches_jax(demos):
    """The SCM fit anchors the JAX flow's wavenumbers in its order; its gaps
    by iteration agree to 1e-8 where finite."""
    ref, port = demos
    assert port["scm"]["anchors"] == ref["scm"]["anchors"]
    assert port["scm"]["n_anchors"] == ref["scm"]["n_anchors"]
    g_p, g_j = np.asarray(port["scm"]["max_gap"]), np.asarray(ref["scm"]["max_gap"])
    fin = np.isfinite(g_j)
    assert np.array_equal(np.isfinite(g_p), fin)
    assert np.abs(g_p[fin] - g_j[fin]).max() <= 1e-8


def test_demo_sweep_matches_jax(demos):
    """At the 41 sweep wavenumbers the r <= 5 ROM's true errors and
    estimates agree with the JAX flow's to 1e-12 of the state's norm (the
    float64 floor: these errors are 1e-8-1e-6 of it, and the two packages'
    sparse LU orderings round differently); where the error is above that
    floor (``certified``) the certified bounds agree to 1e-6 of the largest
    (beta_LB is an LP's optimum, solved by HiGHS to its feasibility
    tolerance of 1e-7: the optima differ by up to 2e-8 relative at grid 9)
    and the bound is above the true error; the bounds are finite at the
    same wavenumbers."""
    ref, port = demos
    sw = port["sweep"]
    assert sw["r"] == 5
    held = helmholtz_demo.certified(sw)
    assert np.array_equal(np.isfinite(sw["bound"]), np.isfinite(ref["sweep"]["bound"]))
    for key in ("err", "est"):
        assert (np.abs(sw[key] - ref["sweep"][key]) <= 1e-12 * sw["norm"]).all(), key
    assert close(sw["bound"][held], ref["sweep"]["bound"][held], 1e-6)
    assert held.sum() >= 30 and (sw["bound"][held] >= sw["err"][held]).all()


def test_demo_recovery_matches_jax(demos):
    """PBDW and dictionary recovery (the complex group LARS homotopy and the
    discrete manifold distance of the complex sketch) of the 9 complex
    states: relative errors equal to the JAX flow's to 1e-6."""
    ref, port = demos
    for key in ("pbdw", "dic"):
        p, j = port["recovery"][key], ref["recovery"][key]
        assert np.all(np.abs(p - j) <= 1e-6 * j + 1e-9), (key, p, j)
    assert np.median(port["recovery"]["dic"]) < 0.05


def test_demo_without_a_card_raises(monkeypatch):
    """``run()`` given no device needs a card: without one it raises and
    names the CPU opt-in, before any solve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        helmholtz_demo.run(GRID, 1)
