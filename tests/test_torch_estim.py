"""The port's state-estimation stack (``estim/``: LARS, manifold distances,
PBDW and dictionary recovery) and ``examples/inverse_problems_demo.py``
held against the JAX package (f64, CPU).

Inputs are drawn with numpy from seeds; the Gaussian residual sketch is the
JAX package's Omega, carried into the port (``GaussianEmbedding.from_matrix``).

* Host paths (numpy in both packages): equal to 1e-12.
* Device paths: the port's batched call over B columns against the JAX
  function on each column, and against the port's own single calls: the
  same active set at every path point, path and alphas to 1e-9 of their
  largest. Where K > m the homotopy ends when lambda cancels to rounding
  noise (an absolute 1e-12 test in both packages), so the last step is
  decided by the last digits of the arithmetic; there the paths are held
  together while alpha stays above 1e-9 of its first value.
* Recovery maps and manifold distances on a 3x3 thermal block at 12
  intervals (n = 121): 12 observations, 30 atoms, k = 40: to 1e-9.
* The demo at grid 12 against the JAX demo's flow built the same way: the
  same selected path point, errors to 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.estim as jest
import rla4mor_tpu.estim.lars as jlars
from rla4mor_tpu.core import ChainOp as JChainOp
from rla4mor_tpu.core import compose as jcompose
from rla4mor_tpu.core import gram_schmidt as jgram_schmidt
from rla4mor_tpu.core import materialize as jmaterialize
from rla4mor_tpu.core import pod as jpod
from rla4mor_tpu.core import project as jproject
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian

import rla4mor_tpu_torch.estim as pest
import rla4mor_tpu_torch.estim.lars as plars
from rla4mor_tpu_torch.core import ChainOp, compose, gram_schmidt, materialize, project
from rla4mor_tpu_torch.examples import inverse_problems_demo as demo
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.ops import GaussianEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def np_(t):
    return t.resolve_conj().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# host paths


def _complex_dict(seed=0, m=12, K=5):
    rng = np.random.RandomState(seed)
    D = rng.randn(m, K) + 1j * rng.randn(m, K)
    beta = np.zeros(K, complex)
    beta[[1, 3]] = [2 + 1j, -1 + 0.5j]
    return D, D @ beta + 0.01 * (rng.randn(m) + 1j * rng.randn(m))


def _host_case(name):
    rng = np.random.RandomState(1)
    D, x = rng.normal(size=(12, 20)), rng.normal(size=12)
    w = rng.uniform(0.5, 2.0, size=20)
    Dc, xc = _complex_dict()
    return {
        "lasso_np": lambda m: m.lars_lasso_path_np(D, x),
        "weighted": lambda m: m.lars_weighted_path(D, x, alpha=0.01, weights=w),
        "weighted_last": lambda m: m.lars_weighted_path(D, x, ols=False, return_path=False),
        "complex_stacked": lambda m: m.lars_weighted_path_complex(Dc, xc, max_steps=24),
        "complex_cd": lambda m: (m.complex_lasso_cd(Dc, xc, 0.5),),
        "complex_np": lambda m: m.lars_lasso_path_complex_np(Dc, xc, max_steps=12),
        "group": lambda m: m.lars_weighted_path_group(Dc, xc, max_steps=12),
    }[name]


@pytest.mark.parametrize("name", ["lasso_np", "weighted", "weighted_last", "complex_stacked",
                                  "complex_cd", "complex_np", "group"])
def test_host_paths_match_jax(name):
    case = _host_case(name)
    for got, ref in zip(case(pest), case(jest)):
        assert rel(got, ref) <= 1e-12


# ---------------------------------------------------------------------------
# device paths


def _hold(path, alphas, jpath, jalphas, tail_from_alpha=None, floor=0.0):
    """Same active set at every path point, path and alphas to 1e-9; with
    ``tail_from_alpha`` only the points whose JAX alpha is above it. An
    entry is active where it exceeds ``floor`` times the largest: 0 for the
    LARS paths, whose inactive entries are exact zeros; 1e-12 for the FISTA
    grid, where an unconverged entry within rounding of its threshold may
    be shrunk to 0 in one package and to 1e-17 in the other."""
    path, alphas, jpath, jalphas = map(np_, (path, alphas, jpath, jalphas))
    keep = slice(None) if tail_from_alpha is None else jalphas > tail_from_alpha
    p, jp = path[..., keep], jpath[..., keep]
    cut = floor * np.abs(jp).max()
    assert np.array_equal(np.abs(p) > cut, np.abs(jp) > cut)
    assert rel(p, jp) <= 1e-9
    assert rel(alphas[keep], jalphas[keep]) <= 1e-9


@pytest.mark.parametrize("m,K", [(14, 8), (10, 25)], ids=["K<m", "K>m"])
def test_lars_lasso_batched_matches_jax(m, K):
    """``lars_lasso_jax`` on 3 columns at once: each column's path equals
    the JAX path (K > m: while alpha > 1e-9 alpha_0) and the port's own
    single call on that column."""
    rng = np.random.RandomState(m)
    D, X = rng.normal(size=(m, K)), rng.normal(size=(3, m))
    path, alphas, steps = pest.lars_lasso_jax(torch.tensor(D), torch.tensor(X), max_steps=60)
    assert path.shape == (3, 61, K)
    for i in range(3):
        jp, ja, js = jest.lars_lasso_jax(jnp.asarray(D), jnp.asarray(X[i]), max_steps=60)
        if K < m:
            assert int(steps[i]) == int(js)
            _hold(path[i].T, alphas[i], jp.T, ja)
        else:
            _hold(path[i].T, alphas[i], jp.T, ja, 1e-9 * float(ja[0]))
        sp, sa, ss = pest.lars_lasso_jax(torch.tensor(D), torch.tensor(X[i]), max_steps=60)
        assert int(ss) == int(steps[i])
        assert rel(sp, path[i]) <= 1e-12 and rel(sa, alphas[i]) <= 1e-12


@pytest.mark.parametrize("variant", ["weighted", "stacked", "group"])
def test_weighted_paths_batched_match_jax(variant):
    """The weighted / rescaled device paths with the OLS debias, on 2
    columns at once: real (weights, alpha > 0), complex by real stacking,
    and the complex group path (FISTA grid)."""
    rng = np.random.RandomState(5)
    if variant == "weighted":
        D, X = rng.normal(size=(12, 9)), rng.normal(size=(2, 12))
        kw = dict(alpha=0.02, weights=rng.uniform(0.5, 2.0, size=9), max_steps=40)
        tfn, jfn = plars.lars_weighted_path_jax, jlars.lars_weighted_path_jax
    else:
        D = rng.normal(size=(10, 4)) + 1j * rng.normal(size=(10, 4))
        X = rng.normal(size=(2, 10)) + 1j * rng.normal(size=(2, 10))
        if variant == "stacked":
            kw = dict(max_steps=30)
            tfn, jfn = pest.lars_weighted_path_complex_jax, jest.lars_weighted_path_complex_jax
        else:
            kw = dict(max_steps=6, iters=60)
            tfn, jfn = pest.lars_weighted_path_group_jax, jest.lars_weighted_path_group_jax
    tkw = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    v, alphas, steps = tfn(torch.tensor(D), torch.tensor(X), **tkw)
    for i in range(2):
        jv, ja, js = jfn(jnp.asarray(D), jnp.asarray(X[i]), **jkw)
        assert int(np.asarray(steps).reshape(-1)[min(i, steps.numel() - 1)]) == int(js)
        _hold(v[i], alphas[i], jv, ja, floor=1e-12 if variant == "group" else 0.0)
        sv, sa, _ = tfn(torch.tensor(D), torch.tensor(X[i]), **tkw)
        assert rel(np_(sv), np_(v[i])) <= 1e-12 and rel(sa, alphas[i]) <= 1e-12


def test_complex_lasso_path_matches_jax():
    """The FISTA grid path itself (no weights, no debias), 2 columns."""
    D, x = _complex_dict(seed=2)
    X = np.stack([x, 1j * x[::-1]])
    path, alphas = pest.complex_lasso_path_jax(torch.tensor(D), torch.tensor(X),
                                               max_steps=8, iters=80)
    for i in range(2):
        jp, ja = jest.complex_lasso_path_jax(jnp.asarray(D), jnp.asarray(X[i]),
                                             max_steps=8, iters=80)
        _hold(path[i].T, alphas[i], np.asarray(jp).T, ja, floor=1e-12)


# ---------------------------------------------------------------------------
# manifold distances and recovery maps: 3x3 block at 12 intervals


GRID, M_OBS, N_ATOMS, K_SKETCH = 12, 12, 30, 40


def _lift(n, m, seed):
    rows = np.random.RandomState(seed).choice(n, size=m, replace=False)
    Wd = np.zeros((n, m))
    Wd[rows, np.arange(m)] = 1.0
    return Wd


@pytest.fixture(scope="module")
def setup():
    """Both packages' FOM, observation basis, dictionary, Gaussian residual
    sketch (Omega carried) and test observations (about 5 s, most of it
    the JAX side's first compiles)."""
    jfom, tfom = JaxFOM((3, 3), GRID), ThermalBlockFOM((3, 3), GRID, device="cpu")
    jRu, tRu = jfom.h1_0_product, tfom.h1_0_product
    n = tfom.solution_dim
    rng = np.random.RandomState(3)
    P = rng.uniform(0.1, 1.0, size=(N_ATOMS + 3, 9))
    U = np.stack([tfom.solve_host({"diffusion": torch.tensor(p)}) for p in P], axis=1)
    lift = tRu.inv.apply_host(_lift(n, M_OBS, 4))
    jW = np.asarray(jgram_schmidt(jnp.asarray(lift), product=jRu))
    tW = gram_schmidt(torch.tensor(lift), product=tRu)
    assert rel(tW, jW) < 1e-12
    V = U[:, :N_ATOMS] / np.asarray(jRu.norm(jnp.asarray(U[:, :N_ATOMS])))[None, :]
    X = np.concatenate([V, jW], axis=1)
    jS = JaxGaussian.make(n, sqrt_product=jRu.sqrt, range_dim=K_SKETCH, seed=11)
    tS = GaussianEmbedding.from_matrix(np.asarray(jS.random_matrix()), sqrt_product=tRu.sqrt,
                                       device="cpu")
    jlhs = jproject(jcompose(JChainOp((jS, jRu.inv)), jfom.operator), None, jnp.asarray(X))
    jrhs = jmaterialize(jcompose(JChainOp((jS, jRu.inv)), jfom.rhs))
    tlhs = project(compose(ChainOp((tS, tRu.inv)), tfom.operator), None, torch.tensor(X))
    trhs = materialize(compose(ChainOp((tS, tRu.inv)), tfom.rhs))
    assert rel(tlhs.stack, jlhs.stack) < 1e-12 and rel(trhs.stack, jrhs.stack) < 1e-12
    obs = np.asarray(jRu.inner(jnp.asarray(jW), jnp.asarray(U[:, N_ATOMS:])))
    return dict(jfom=jfom, tfom=tfom, P=P, U=U, V=V, W=jW, X=X, jlhs=jlhs, jrhs=jrhs,
                tlhs=tlhs, trhs=trhs, obs=obs)


@pytest.fixture(scope="module")
def dic_maps(setup):
    """Both packages' DicRecoveryMap over ResidualDistanceAffine (100
    projected-gradient steps), and the JAX batched recovery of the test
    observations."""
    s = setup
    box = ([0.1] * 9, [1.0] * 9)
    jmd = jest.ResidualDistanceAffine(s["jlhs"], s["jrhs"], box, pg_iters=100)
    tmd = pest.ResidualDistanceAffine(s["tlhs"], s["trhs"], box, pg_iters=100)
    jrm = jest.DicRecoveryMap(jnp.asarray(s["V"]), jnp.asarray(s["W"]),
                              product=s["jfom"].h1_0_product, manifold_distance=jmd,
                              log_level=30)
    trm = pest.DicRecoveryMap(torch.tensor(s["V"]), torch.tensor(s["W"]),
                              product=s["tfom"].h1_0_product, manifold_distance=tmd,
                              log_level=30)
    return jrm, trm, np.asarray(jrm.compute_state(jnp.asarray(s["obs"])))


def test_residual_distance_discrete_matches_jax(setup):
    """evaluate (distances and minimising parameters) and the batched
    ``distances`` of a (2, n_dofs, 4) block, to 1e-9."""
    s = setup
    mus = [{"diffusion": p} for p in s["P"][:5]]
    jmd = jest.ResidualDistanceDiscrete(s["jlhs"], s["jrhs"],
                                        [{k: jnp.asarray(v) for k, v in m.items()} for m in mus])
    tmd = pest.ResidualDistanceDiscrete(s["tlhs"], s["trhs"],
                                        [{k: torch.tensor(v) for k, v in m.items()} for m in mus])
    C = np.random.RandomState(6).normal(size=(2, N_ATOMS + M_OBS, 4))
    C[0, :, 0] = 0.0
    C[0, 2, 0] = s["U"][0, 2] / s["V"][0, 2]  # the snapshot of mus[2]: distance ~0
    d, mu_min = tmd.evaluate(torch.tensor(C[0]))
    jd, jmu = jmd.evaluate(jnp.asarray(C[0]))
    assert rel(d, jd) <= 1e-9 and d[0] < 1e-10
    assert all(np.array_equal(np_(a["diffusion"]), np.asarray(b["diffusion"]))
               for a, b in zip(mu_min, jmu))
    batched = tmd.distances(torch.tensor(C))
    for i in range(2):
        assert rel(batched[i], jmd.distances(jnp.asarray(C[i]))) <= 1e-9
    sub = tmd.project(torch.arange(N_ATOMS))
    jsub = jmd.project(jnp.arange(N_ATOMS))
    assert rel(sub.distances(torch.tensor(C[1, :N_ATOMS])),
               jsub.distances(jnp.asarray(C[1, :N_ATOMS]))) <= 1e-9


def test_residual_distance_affine_matches_jax(setup, dic_maps):
    """The least-squares system, evaluate (distances and minimisers) and the
    batched ``distances`` of a (2, n_dofs, 3) block, to 1e-9."""
    s = setup
    jmd, tmd = dic_maps[0].manifold_distance, dic_maps[1].manifold_distance
    C = np.random.RandomState(7).normal(size=(2, N_ATOMS + M_OBS, 3))
    G, g = tmd._build_ls(torch.tensor(C[0].T))
    for j in range(3):
        jG, jg = jmd._build_ls(jnp.asarray(C[0, :, j]))
        assert rel(G[j], jG) <= 1e-12 and rel(g[j], jg) <= 1e-12
    d, mus = tmd.evaluate(torch.tensor(C[0]))
    jd, jmus = jmd.evaluate(jnp.asarray(C[0]))
    assert rel(d, jd) <= 1e-9
    assert rel(np.stack([np_(m["diffusion"]) for m in mus]),
               np.stack([np.asarray(m["diffusion"]) for m in jmus])) <= 1e-9
    batched = tmd.distances(torch.tensor(C))
    for i in range(2):
        assert rel(batched[i], jmd.distances(jnp.asarray(C[i]))) <= 1e-9


def test_pbdw_matches_jax(setup):
    """PBDW recovery, with the background and the observations restricted
    (about 5 s: the JAX side compiles each restriction's shapes)."""
    s = setup
    jRu, tRu = s["jfom"].h1_0_product, s["tfom"].h1_0_product
    V = s["V"][:, :8]
    jrm = jest.PbdwRecoveryMap(jnp.asarray(V), jnp.asarray(s["W"]), product=jRu, log_level=30)
    trm = pest.PbdwRecoveryMap(torch.tensor(V), torch.tensor(s["W"]), product=tRu, log_level=30)
    obs = s["obs"]
    assert rel(trm.solve(torch.tensor(obs)), jrm.solve(jnp.asarray(obs))) <= 1e-9
    assert rel(trm.solve(torch.tensor(obs[:, 0])), jrm.solve(jnp.asarray(obs[:, 0]))) <= 1e-9
    idx = np.array([0, 2, 5])
    assert rel(trm.project_background(torch.tensor(idx)).solve(torch.tensor(obs)),
               jrm.project_background(jnp.asarray(idx)).solve(jnp.asarray(obs))) <= 1e-9
    obs_idx = np.arange(10)
    assert rel(trm.project_observation(torch.tensor(obs_idx)).solve(torch.tensor(obs[:10])),
               jrm.project_observation(jnp.asarray(obs_idx)).solve(jnp.asarray(obs[:10]))
               ) <= 1e-9


def test_dictionary_recovery_batched_matches_jax(setup, dic_maps):
    """The batched recovery of 3 columns equals the JAX batched recovery
    and the port's per-column path (``_state_single``), to 1e-9."""
    jrm, trm, jv = dic_maps
    obs = torch.tensor(setup["obs"])
    v = trm.compute_state(obs)
    assert rel(v, jv) <= 1e-9
    assert int(trm.last_steps.max()) <= trm._resolve_max_steps(None)
    loop = torch.stack([trm._state_single(obs[:, i]) for i in range(obs.shape[1])], dim=1)
    assert rel(loop, v) <= 1e-9
    assert rel(trm.solve(obs), jrm.solve(jnp.asarray(setup["obs"]))) <= 1e-9


def test_dictionary_solve_path_matches_jax(setup, dic_maps):
    """``solve_path``: every recovery along the path and its manifold
    distance, to 1e-9 while alpha is above 1e-9 of its first value, and the
    same nearest point; the exact host path (``solver="np"``) too."""
    jrm, trm, _ = dic_maps
    w = setup["obs"][:, 1]
    _, jalphas = jrm.compute_state_path(jnp.asarray(w))
    keep = np.asarray(jalphas) > 1e-9 * float(jalphas[0])
    u, d = trm.solve_path(torch.tensor(w))
    ju, jd = jrm.solve_path(jnp.asarray(w))
    assert rel(np_(u)[:, keep], np.asarray(ju)[:, keep]) <= 1e-9
    assert rel(d[keep], np.asarray(jd)[keep]) <= 1e-9
    assert int(np.argmin(d)) == int(np.argmin(jd))
    v, a = trm.compute_state_path(torch.tensor(w), solver="np")
    jv, ja = jrm.compute_state_path(jnp.asarray(w), solver="np")
    assert rel(v, jv) <= 1e-12 and rel(a, ja) <= 1e-12


def test_dictionary_recovery_requires_orthonormal_W(setup):
    s = setup
    with pytest.raises(ValueError, match="orthonormal"):
        pest.DicRecoveryMap(torch.tensor(s["V"]), torch.tensor(s["X"][:, :5]),
                            product=s["tfom"].h1_0_product)


# ---------------------------------------------------------------------------
# the demo


DEMO = dict(grid=12, m=10, n_train=30, n_test=3, modes=7, k=48, pg_iters=200)


def _jax_demo(train, test):
    """The JAX demo's flow (``examples/inverse_problems_demo.py``) at
    ``DEMO``'s sizes and the given parameters."""
    c = DEMO
    fom = JaxFOM((3, 3), c["grid"])
    Ru = fom.h1_0_product
    n = fom.solution_dim
    Wd = _lift(n, c["m"], 0)
    W = jgram_schmidt(jnp.asarray(np.asarray(Ru.inv.apply(jnp.asarray(Wd)))), product=Ru)
    u_train = fom.solve_many([{"diffusion": jnp.asarray(p)} for p in train])
    rb, _ = jpod(u_train, product=Ru, modes=c["modes"])
    u_test = fom.solve_many([{"diffusion": jnp.asarray(p)} for p in test])
    obs = Ru.inner(W, u_test)
    rm_pbdw = jest.PbdwRecoveryMap(rb, W, product=Ru, log_level=30)
    pbdw = [float(np.mean(np.asarray(Ru.norm(
        rm_pbdw.project_background(jnp.arange(i)).solve(obs) - u_test))))
        for i in range(1, rb.shape[1] + 1, 3)]
    V_dic = np.asarray(u_train) / np.asarray(Ru.norm(u_train))[None, :]
    X = jnp.concatenate([jnp.asarray(V_dic), W], axis=1)
    S = JaxGaussian.make(n, sqrt_product=Ru.sqrt, range_dim=c["k"], seed=3)
    chain = JChainOp((S, Ru.inv))
    lhs = jproject(jcompose(chain, fom.operator), None, X)
    rhs = jmaterialize(jcompose(chain, fom.rhs))
    mdist = jest.ResidualDistanceAffine(lhs, rhs, ([0.1] * 9, [1.0] * 9),
                                        pg_iters=c["pg_iters"])
    rm = jest.DicRecoveryMap(jnp.asarray(V_dic), W, product=Ru, manifold_distance=mdist,
                             log_level=30)
    u_rec = rm.solve(obs)
    rel_err = np.asarray(Ru.norm(u_rec - u_test)) / np.asarray(Ru.norm(u_test))
    worst = int(np.argmax(rel_err))
    u_path, dist = rm.solve_path(np.asarray(obs)[:, worst])
    errs = np.asarray(Ru.norm(u_path - u_test[:, worst:worst + 1]))
    return dict(pbdw=pbdw, rel=rel_err, worst=worst, dist=np.asarray(dist), errs=errs,
                omega=np.asarray(S.random_matrix()))


def test_demo_matches_jax():
    """``run(device="cpu")`` at grid 12 (n = 121: 10 observations, 30
    training states, POD of 7, k = 48, 3 test states) against the JAX
    demo's flow on the same numpy-drawn parameters and the carried Omega:
    PBDW errors and dictionary recovery errors to 1e-8, the same worst
    state and the same path point nearest the manifold, whose recovery
    error matches to 1e-8. About 13 s alone, nearly all the JAX flow's
    compile (its batched recovery program, a vmapped while_loop with
    projected-gradient scans); the port's run takes 0.2 s."""
    rng = np.random.RandomState(8)
    train = rng.uniform(0.1, 1.0, size=(DEMO["n_train"], 9))
    test = rng.uniform(0.1, 1.0, size=(DEMO["n_test"], 9))
    ref = _jax_demo(train, test)

    def carried(n, sqrt_product=None, range_dim=None, seed=0, device=None, dtype=None):
        assert (range_dim, seed) == (DEMO["k"], 3)
        return GaussianEmbedding.from_matrix(ref["omega"], sqrt_product=sqrt_product,
                                             device=device, dtype=dtype)

    out = demo.run(embeddings={"gaussian": carried}, device="cpu", train=train, test=test,
                   log=lambda line: None, **{k: v for k, v in DEMO.items() if k != "n_train"})
    got = out["embeddings"]["gaussian"]
    assert [i for i, _ in out["pbdw"]] == list(range(1, DEMO["modes"] + 1, 3))
    assert rel([e for _, e in out["pbdw"]], ref["pbdw"]) <= 1e-8
    assert rel(got["rel"], ref["rel"]) <= 1e-8
    assert got["worst"] == ref["worst"]
    assert got["argmin_dist"] == int(np.argmin(ref["dist"]))
    i = got["argmin_dist"]
    assert abs(float(got["errs"][i]) - ref["errs"][i]) <= 1e-8 * ref["errs"][i]
    rec = out["prepared"]
    assert rec.steps.shape == (DEMO["n_test"],)
    assert int(rec.steps.max()) <= rec.rm._resolve_max_steps(None)


def test_demo_without_a_card_raises(monkeypatch):
    """``run()`` given no device needs a card: without one it raises and
    names the CPU opt-in, before any solve."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        demo.run(grid=4, n_test=1, log=lambda line: None)
