"""The nonlinear tier of the PyTorch port held against the JAX package (f64,
CPU): ``SemilinearStencilFOM`` (Newton-CG), ``SemilinearInstationaryFOM``
(IMEX), the POD-DEIM ``SemilinearReductor`` with its exact and sketched
estimators, the batched ROM Newton, the certified IMEX bound, the greedy,
the semilinear ROM files and ``semilinear_demo.run``.

Sizes are the JAX tests' (``tests/test_semilinear.py``: grid 12; grid 10 for
the nonlinearities, 32 for MG). Parameters are drawn with numpy; the SRHT
plan is carried from the JAX side (``SrhtEmbedding.from_plan``). The JAX
demo's flow runs once (greedy, online batch, containment, IMEX fit) in a
module fixture that the fit, greedy, IMEX, file and demo tests share: the
JAX reductor compiles its eager operations at every shape. Bases are
compared up to the signs of their columns. The port's Newton loop differs
from the JAX one where the JAX one does not do what it says (ROADMAP.md
queue 3): it keeps the better iterate on stagnation and reports why it
stopped; where the JAX loop converges the iterates are the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rla4mor_tpu.core.parameters import mu_stack as jax_mu_stack
from rla4mor_tpu.models.semilinear import (
    SemilinearInstationaryFOM as JaxIFOM,
    SemilinearStencilFOM as JaxFOM,
)
from rla4mor_tpu.mor.semilinear_reductor import SemilinearReductor as JaxReductor

from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.models.semilinear import (
    NONLINEARITIES,
    SemilinearInstationaryFOM,
    SemilinearStencilFOM,
)
from rla4mor_tpu_torch.mor.bounds import MinThetaCoercivity
from rla4mor_tpu_torch.mor.semilinear_reductor import SemilinearReductor

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

GRID, REACTION, N_TRAIN, N_TEST, STEPS, NT_P, K = 12, 100.0, 8, 4, 2, 6, 96


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rows(count, seed):
    return np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 5))


def _jmus(rows, dtype=jnp.float64):
    return [{"diffusion": jnp.asarray(r[:4], dtype), "reaction": jnp.asarray(r[4:], dtype)}
            for r in rows]


def _tmus(rows, dtype=torch.float64):
    return [{"diffusion": torch.tensor(r[:4], dtype=dtype),
             "reaction": torch.tensor(r[4:], dtype=dtype)} for r in rows]


def _fom(grid=GRID, reaction=REACTION, nl="cubic", dtype=torch.float64):
    return SemilinearStencilFOM((2, 2), grid, dtype=dtype, nonlinearity=nl,
                                reaction_scale=reaction, device="cpu")


def _signs(A, B):
    """Column signs s with A * s ~ B (bases equal up to sign)."""
    return np.sign(np.sum(np.asarray(A) * np.asarray(B), axis=0))


@pytest.fixture(scope="module")
def jax_flow(tmp_path_factory):
    """The JAX semilinear demo's flow at grid 12 (reaction scale 100, cubic):
    8 training and 4 test draws (numpy), the min-theta coercivity on the
    dense l2 anchor, the certified greedy (2 steps, 2 reserve points; the
    parameters it solves recorded), the online batch, the FOM truths, the
    SRHT-sketched fit (k = 96) of the greedy's final snapshots, the IMEX
    composition (nt 6, fit on 4 trajectories) with its trajectories,
    estimates and certified bounds, and both ROM files. About 25 s: the
    JAX reductor's eager operations compile at every shape: its stencil
    term applies are jitted here (the same function, one compile a term),
    and the JAX ``deim_points`` loop, which compiles at every point (25 s
    for the IMEX fit's 24), gives way to the port's, which
    ``tests/test_torch_eim.py::test_deim_matches_jax`` holds to it, on the
    JAX DEIM bases."""
    import rla4mor_tpu.models.stencil as jst
    import rla4mor_tpu.mor.eim as jeim
    from rla4mor_tpu.mor.bounds import MinThetaCoercivity as JaxMinTheta
    from rla4mor_tpu.mor.serialization import save_rom as jax_save_rom
    from rla4mor_tpu.ops.embeddings import SrhtEmbedding as JaxSrht
    from rla4mor_tpu.ops.fwht import _srht_plan

    from rla4mor_tpu_torch.mor.eim import deim_points

    monkeypatch = pytest.MonkeyPatch()
    monkeypatch.setattr(jeim, "deim_points", lambda U: jnp.asarray(
        deim_points(torch.tensor(np.asarray(U))).numpy(), jnp.int32))
    term_apply, jitted = jst.StencilTermOp.apply, {}

    def jitted_term_apply(op, U, mu=None):
        key = (id(op.st), op.term)
        if key not in jitted:
            jitted[key] = jax.jit(lambda X, op=op: term_apply(op, X))
        return jitted[key](jnp.asarray(U))

    monkeypatch.setattr(jst.StencilTermOp, "apply", jitted_term_apply)
    jf = JaxFOM((2, 2), GRID, dtype=jnp.float64, reaction_scale=REACTION)
    train, test = _rows(N_TRAIN, 1), _rows(N_TEST, 2)
    jtrain, jtest = _jmus(train), _jmus(test)
    n = jf.n_dof
    eye = jnp.eye(n, dtype=jnp.float64)
    A_ref = sum(np.asarray(jf.linear.term_linop(b).apply(eye)) for b in range(4))
    mask = np.asarray(jf.mass_lumped_diag().reshape(-1)) > 0
    Ai = A_ref[np.ix_(mask, mask)]
    alpha_ref = float(np.linalg.eigvalsh(0.5 * (Ai + Ai.T))[0])
    coerc = JaxMinTheta(jf, {k: jnp.ones_like(v) for k, v in jtrain[0].items()},
                        alpha_ref=alpha_ref)
    solved = []
    newton = jf.solve_newton

    def recording(mu, **kw):  # the greedy's Newton solves, in order
        u = newton(mu, **kw)
        solved.append((next(i for i, m in enumerate(jtrain) if m is mu), u))
        return u

    jf.solve_newton = recording
    red = JaxReductor(jf)
    rom, hist = red.greedy(jtrain, n_steps=STEPS, coercivity=coerc, n_reserve=2)
    del jf.solve_newton
    a_b, est_b = jax.jit(rom.solve_and_estimate_batch)(jax_mu_stack(jtest))
    alphas = np.asarray([float(coerc(m)) for m in jtest])
    V = np.asarray(red.last_basis)
    truths = [np.asarray(jf.solve_newton(m)).reshape(-1) for m in jtest]
    errors = [float(np.linalg.norm(u - V @ np.asarray(a))) for u, a in zip(truths, a_b)]

    S = jnp.stack([u.reshape(-1) for _, u in solved], axis=1)
    jemb = JaxSrht.make(n, range_dim=K, seed=4)
    signs, sampling, _ = _srht_plan(jemb.key, n, K)
    rom_s = JaxReductor(jf, embedding=jemb).fit(None, snapshots=S, pod_rtol=1e-10,
                                                n_reserve=2)
    _, est_s = jax.jit(rom_s.solve_and_estimate_batch)(jax_mu_stack(jtest))

    jif = JaxIFOM(jf, T=0.5, nt=NT_P)
    red_p = JaxReductor(jf)
    prom = red_p.fit_instationary(jif, jtrain[:4], pod_rtol=1e-8, deim_rtol=1e-8,
                                  n_reserve=2)
    held = jax_mu_stack(jtest[:2])
    ptraj = jax.jit(prom.solve_batch)(held)
    pest = jax.jit(jax.vmap(lambda m, t: prom.estimate_error(m, t)))(held, ptraj)
    bounds = {}
    for name, alpha in (("demo", None), ("strong", 1.0)):
        fn = (lambda m: coerc(m)) if alpha is None else (lambda m, a=alpha: jnp.asarray(a))
        b, info = jax.jit(jax.vmap(lambda m, t: prom.certified_error_bound(m, fn, traj=t)))(
            held, ptraj)
        bounds[name] = (np.asarray(b), {k: np.asarray(v) for k, v in info.items()})
    b, info = jax.jit(lambda m: prom.certified_error_bound(m, lambda _: jnp.asarray(1e-3),
                                                          margin=1e-14))(jtest[0])
    bounds["tiny_margin"] = (np.asarray(b), {k: np.asarray(v) for k, v in info.items()})
    monkeypatch.undo()
    files = tmp_path_factory.mktemp("semilinear")
    jax_save_rom(rom, files / "sl.npz")
    jax_save_rom(prom, files / "sl_inst.npz")
    return {
        "train": train, "test": test, "alpha_ref": alpha_ref, "rom": rom, "hist": hist,
        "picks": [i for i, _ in solved], "S": np.asarray(S), "V": V,
        "points": np.asarray(red.last_interpolant.points), "a": np.asarray(a_b),
        "est": np.asarray(est_b), "alphas": alphas, "errors": errors,
        "est_sketched": np.asarray(est_s), "plan": (np.asarray(signs), np.asarray(sampling)),
        "ifom_truth": [np.asarray(jif.solve_flat(m)) for m in jtest[:2]],
        "prom": prom, "V_p": np.asarray(red_p.last_basis), "ptraj": np.asarray(ptraj),
        "pest": np.asarray(pest), "bounds": bounds, "files": files,
        "truths": truths,
    }


@pytest.mark.parametrize("nl", sorted(NONLINEARITIES))
def test_newton_matches_jax(nl):
    """Newton-CG (Jacobi) at grid 10, reaction scale 30, for each
    nonlinearity: the iterate equals the JAX one to 1e-9, in as many steps,
    stopping ``converged`` with ||F|| <= 1e-8 ||f||; one residual
    evaluation a step (the JAX body evaluates it twice); the nonlinearity
    matters (the solution is not the linear one)."""
    row = _rows(1, 5)[0]
    jf = JaxFOM((2, 2), 10, dtype=jnp.float64, nonlinearity=nl, reaction_scale=30.0)
    ju, jit = jf.solve_newton(_jmus([row])[0], return_iters=True)
    tf = _fom(10, 30.0, nl)
    calls = []
    residual = tf.residual
    tf.residual = lambda mu, u: calls.append(1) or residual(mu, u)
    mu = _tmus([row])[0]
    u, info = tf.solve_newton(mu, return_info=True)
    assert rel(u, ju) < 1e-9
    assert info["reason"] == "converged" and info["iters"] == int(jit)
    assert len(calls) == info["iters"] + 1 and info["rel_res"] <= 1e-8
    assert len(info["residuals"]) == info["iters"] + 1 and tf.solve_log[-1] is info
    u_lin = tf.linear.solve_cg(mu, tol=1e-12, maxiter=4000)
    assert float((u - u_lin).norm()) > 1e-4 * float(u_lin.norm())


def test_newton_mg_matches_jax_jacobi():
    """``cg_precond='mg'`` (the port's V-cycle of A(mu), P^T r) at grid 32
    equals the JAX package's Jacobi-CG Newton (1e-10 of the scale; the JAX
    cycle restricts by P^T r / 4, so its MG iterations are not the
    reference) with a few inner iterations a step; an unknown
    preconditioner raises."""
    row = _rows(2, 3)[1]
    jf = JaxFOM((2, 2), 32, dtype=jnp.float64, reaction_scale=50.0)
    ju = np.asarray(jf.solve_newton(_jmus([row])[0], newton_tol=1e-10, cg_tol=1e-12,
                                    cg_maxiter=4000))
    tf = _fom(32, 50.0)
    mu = _tmus([row])[0]
    u, info = tf.solve_newton(mu, newton_tol=1e-10, cg_tol=1e-12, cg_maxiter=200,
                              cg_precond="mg", return_info=True)
    assert np.abs(u.numpy() - ju).max() < 1e-10 * np.abs(ju).max()
    assert info["reason"] == "converged" and info["rel_res"] < 1e-10
    assert max(info["cg_iters"]) < 25
    with pytest.raises(ValueError, match="cg_precond"):
        tf.solve_newton(mu, cg_precond="bogus")


def test_newton_stagnation_stop():
    """float32 at grid 12 with an unreachable tolerance (1e-14) and a budget
    of 500 (``tests/test_semilinear.py``'s case): the port stops
    ``stagnated`` within one step of the JAX loop (the float32 rounding of
    the two CG codes decides whether the step after the floor still cuts
    the residual by 10%: here the port's fifth step cuts it by 14.5% and the
    JAX one's raises it) and at most 20, returns the better of its last two
    iterates, and its error to the float64 solution is below the JAX
    iterate's (the last one, better or not) and 1e-5."""
    row = _rows(3, 3)[2]
    u64, info64 = _fom(reaction=50.0).solve_newton(_tmus([row])[0], newton_tol=1e-10,
                                                   return_info=True)
    assert info64["reason"] == "converged" and info64["iters"] <= 12
    jf = JaxFOM((2, 2), GRID, dtype=jnp.float32, reaction_scale=50.0)
    kw = dict(newton_tol=1e-14, max_newton=500, cg_tol=1e-7, cg_maxiter=2000)
    j32, jit = jf.solve_newton(_jmus([row], jnp.float32)[0], return_iters=True, **kw)
    tf = _fom(reaction=50.0, dtype=torch.float32)
    u32, info = tf.solve_newton(_tmus([row], torch.float32)[0], return_info=True, **kw)
    assert info["reason"] == "stagnated" and info["iters"] <= min(int(jit) + 1, 20)
    res = info["residuals"]
    assert info["rel_res"] == min(res[-2:])  # the better of the last two

    def err(u):
        return float(np.linalg.norm(np.asarray(u, np.float64) - u64.numpy())
                     / np.linalg.norm(u64.numpy()))

    assert err(u32) < err(j32) and err(u32) < 1e-5, (err(u32), err(j32))


def _port_fit(jax_flow, embedding=None):
    fom = _fom()
    red = SemilinearReductor(fom, embedding=embedding)
    rom = red.fit(None, snapshots=torch.tensor(jax_flow["S"]), pod_rtol=1e-10, n_reserve=2)
    return fom, red, rom


def test_fit_matches_jax(jax_flow):
    """The greedy's final fit on the JAX snapshots: the DEIM points are the
    JAX ones, the basis equals it up to column signs (1e-10), and so do the
    reduced stacks, W, P V and the exact Gram (its columns [f | A_b V |
    M_L U S] carry V's signs); the sketched path through the carried SRHT
    plan gives Theta C up to the same signs and the JAX sketched estimates
    (1e-10)."""
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

    fom, red, rom = _port_fit(jax_flow)
    jrom = jax_flow["rom"]
    V = red.last_basis.numpy()
    s = _signs(V, jax_flow["V"])
    assert np.abs(V * s - jax_flow["V"]).max() < 1e-10
    assert np.array_equal(red.last_interpolant.points.numpy(), jax_flow["points"])
    S2 = s[:, None] * s[None, :]
    assert rel(rom.lhs.stack.numpy() * S2, np.asarray(jrom.lhs.stack)) < 1e-10
    assert rel(rom.W.numpy() * s[:, None], np.asarray(jrom.W)) < 1e-10
    assert rel(rom.Pv.numpy() * s, np.asarray(jrom.Pv)) < 1e-10
    assert rel(rom.rhs_hat.numpy() * s, np.asarray(jrom.rhs_hat)) < 1e-10
    cols = np.concatenate([[1.0], np.tile(s, 4), np.ones(rom.n_deim)])
    gram = rom.error_estimator.gram.numpy()
    assert rel(gram * cols[:, None] * cols[None, :], np.asarray(jrom.error_estimator.gram)) \
        < 1e-10
    signs, sampling = jax_flow["plan"]
    emb = SrhtEmbedding.from_plan(fom.n_dof, K, signs, sampling, device="cpu")
    _, red_s, rom_s = _port_fit(jax_flow, emb)
    assert rom_s.error_estimator.sketched and rom_s.error_estimator.gram.shape[0] == K
    _, est_s = rom_s.solve_and_estimate_batch(mu_stack(_tmus(jax_flow["test"])))
    assert rel(est_s, jax_flow["est_sketched"]) < 1e-10


def test_rom_batched_newton_matches_jax_vmap(jax_flow):
    """One batched dense Newton over the test set (a per-row convergence
    mask, one batched solve a step) equals the JAX ``vmap`` of its
    ``while_loop``: the lifted solutions V a and the estimates to 1e-10; and
    the batch equals the per-parameter calls; outputs are h^2 sum(V a)."""
    _, red, rom = _port_fit(jax_flow)
    test = _tmus(jax_flow["test"])
    a, est = rom.solve_and_estimate_batch(mu_stack(test))
    V = red.last_basis
    assert rel(a @ V.T, jax_flow["a"] @ jax_flow["V"].T) < 1e-10
    assert rel(est, jax_flow["est"]) < 1e-10
    for i, mu in enumerate(test):
        assert rel(rom.solve(mu), a[i]) < 1e-12
        assert abs(float(rom.estimate_error(mu)) - float(est[i])) < 1e-12 * float(est[i])
    h2 = 1.0 / GRID ** 2
    assert rel(rom.output(a), h2 * (a @ V.T).sum(dim=1)) < 1e-12
    assert float(rom.estimate_error(test[0], include_deim=False)) <= float(est[0])


def test_greedy_matches_jax(jax_flow):
    """The certified strong greedy (min-theta on the dense anchor): the JAX
    run's parameters and history (1e-8), each sweep one batched
    solve-and-estimate over the stacked training set."""
    fom = _fom()
    train = _tmus(jax_flow["train"])
    coerc = MinThetaCoercivity(fom, {k: torch.ones_like(v) for k, v in train[0].items()},
                               alpha_ref=jax_flow["alpha_ref"])
    red = SemilinearReductor(fom)
    rom, hist = red.greedy(train, n_steps=STEPS, coercivity=coerc, n_reserve=2)
    assert red.last_picked == jax_flow["picks"]
    assert rel(hist, jax_flow["hist"]) < 1e-8
    assert rom.dim == red.last_basis.shape[1]


def test_imex_fom_and_rom_match_jax(jax_flow):
    """IMEX: the FOM trajectories equal the JAX ones (1e-10); the parabolic
    fit's lifted trajectories (1e-8: the demo's pod_rtol = 1e-8 keeps modes
    whose singular values are 1e-8 of the largest, and rounding moves such
    a mode by about eps / 1e-8) and space-time estimates (1e-7: the Gram
    path's sqrt(w^T C^T C w) of a residual far below ||C|| ||w|| loses the
    digits that cancel) equal them, batched and per parameter;
    ``v_row_sup``, the largest row norm of a basis whose last modes sit at
    the 1e-8 cut, equals the JAX one to 1e-4 (rounding moves it by about
    1e-5); at the JAX one, ``certified_error_bound`` gives the JAX flags
    and coercivity (1e-12) and bound, margin, L and U_r (1e-5: U_r is the
    largest coefficient norm of the trajectory, and the method of snapshots
    leaves modes at the 1e-8 cut orthonormal to about 1e-8 relative to
    their size, which moves it by about 1e-6) with the demo's coercivity
    and a strong one, the same as one parameter at a time, and inf / uncertified with a
    window too small; it refuses a ROM without ``v_row_sup``."""
    from rla4mor_tpu_torch.mor.semilinear_reductor import SemilinearInstationaryROM

    fom = _fom()
    ifom = SemilinearInstationaryFOM(fom, T=0.5, nt=NT_P)
    test = _tmus(jax_flow["test"])
    for mu, want in zip(test[:2], jax_flow["ifom_truth"]):
        assert rel(ifom.solve_flat(mu), want) < 1e-10
    red = SemilinearReductor(fom)
    train = _tmus(jax_flow["train"])
    prom = red.fit_instationary(ifom, train[:4], pod_rtol=1e-8, deim_rtol=1e-8,
                                n_reserve=2)
    V = red.last_basis
    held = mu_stack(test[:2])
    traj = prom.solve_batch(held)
    assert rel(V @ traj, jax_flow["V_p"] @ jax_flow["ptraj"]) < 1e-8
    est = prom.estimate_error(held, traj)
    assert rel(est, jax_flow["pest"]) < 1e-7
    assert abs(float(prom.estimate_error(test[1])) - float(est[1])) < 1e-12 * float(est[1])
    coerc = MinThetaCoercivity(fom, {k: torch.ones_like(v) for k, v in train[0].items()},
                               alpha_ref=jax_flow["alpha_ref"])
    v_sup = jax_flow["prom"].v_row_sup
    assert abs(prom.v_row_sup - v_sup) < 1e-4 * v_sup
    for name, fn in (("demo", coerc), ("strong", lambda m: torch.tensor(1.0))):
        b, info = prom.certified_error_bound(held, fn, traj=traj, v_row_sup=v_sup)
        jb, jinfo = jax_flow["bounds"][name]
        assert np.array_equal(info["certified"].numpy(), jinfo["certified"])
        fin = np.isfinite(jb)
        assert np.array_equal(np.isfinite(b.numpy()), fin)
        if fin.any():
            assert rel(b.numpy()[fin], jb[fin]) < 1e-5
        for key in ("margin", "L", "U_r"):
            assert rel(info[key], jinfo[key]) < 1e-5, key
        assert rel(info["alpha"], jinfo["alpha"]) < 1e-12
        b0, _ = prom.certified_error_bound(test[0], fn, v_row_sup=v_sup)
        assert (float(b0) == float(b[0])) or abs(float(b0) - float(b[0])) < 1e-12 * float(b0)
    b, info = prom.certified_error_bound(test[0], lambda m: torch.tensor(1e-3), margin=1e-14)
    jb, jinfo = jax_flow["bounds"]["tiny_margin"]
    assert not bool(info["certified"]) and not bool(jinfo["certified"])
    assert np.isinf(float(b)) and np.isinf(float(jb))
    legacy = SemilinearInstationaryROM(prom.lhs, prom.M_hat, prom.rhs_hat, prom.W, prom.Pv,
                                       prom.output_row, prom.error_estimator,
                                       prom.nonlinearity, prom.reaction_scale, prom.nt,
                                       prom.dt)
    with pytest.raises(ValueError, match="v_row_sup"):
        legacy.certified_error_bound(test[0], coerc)
    b_o, _ = legacy.certified_error_bound(test[0], coerc, v_row_sup=prom.v_row_sup)
    assert float(b_o) == float(prom.certified_error_bound(test[0], coerc)[0]) or \
        np.isinf(float(b_o))
    outs = prom.output_trajectory(prom.solve(test[0]))
    want = ifom.output_trajectory(ifom.solve(test[0]))
    assert outs.shape == (NT_P + 1,) and rel(outs, want) < 0.1


def test_certified_parabolic_bound_contains_error():
    """The monotone IMEX composition's bound (``tests/test_semilinear.py``'s
    case, reaction scale 2, 14 modes and 10 DEIM terms over the JAX test's 8
    training draws): certified, at least the true final-time error of a
    dense IMEX oracle, and within 1e4 of it, at the JAX test's 2 held-out
    draws (one batched call)."""
    jf = JaxFOM((2, 2), GRID, dtype=jnp.float64, reaction_scale=2.0)

    def draws(count, key):
        return [{k: torch.tensor(np.asarray(v)) for k, v in m.items()}
                for m in jf.sample_parameters(count, key=key)]

    fom = _fom(reaction=2.0)
    ifom = SemilinearInstationaryFOM(fom, T=0.5, nt=12)
    red = SemilinearReductor(fom)
    rom = red.fit_instationary(ifom, draws(8, 3), modes=14, deim_modes=10, n_reserve=2)
    assert np.isfinite(rom.v_row_sup) and rom.v_row_sup > 0
    V = red.last_basis.numpy()
    n = fom.n_dof
    eye = torch.eye(n, dtype=torch.float64)
    terms = np.stack([fom.linear.term_linop(b).apply(eye).numpy() for b in range(4)])
    M = ifom._mass_apply(eye.T.reshape(n, *fom.solution_shape)).reshape(n, n).numpy().T
    ml = fom.mass_lumped_diag().reshape(-1).numpy()
    mask = ml > 0
    f = fom.rhs().reshape(-1).numpy()
    held = draws(2, 11)
    alphas, errs = [], []
    for mu in held:
        Ai = np.tensordot(mu["diffusion"].numpy(), terms, axes=1)[np.ix_(mask, mask)]
        alphas.append(float(np.linalg.eigvalsh(0.5 * (Ai + Ai.T))[0]))
        c = float(fom.reaction(mu))
        B = M[np.ix_(mask, mask)] + ifom.dt * Ai
        u = np.zeros(n)
        for _ in range(ifom.nt):
            rhs = M[np.ix_(mask, mask)] @ u[mask] + ifom.dt * (f[mask] - c * ml[mask]
                                                                 * u[mask] ** 3)
            u = np.zeros(n)
            u[mask] = np.linalg.solve(B, rhs)
        traj = rom.solve(mu)
        errs.append(np.linalg.norm(u - V @ traj[:, -1].numpy()))
    table = dict(zip((0, 1), alphas))
    bound, info = rom.certified_error_bound(
        mu_stack(held), lambda m: torch.tensor([table[0], table[1]]))
    assert bool(info["certified"].all()), info
    for e, b in zip(errs, bound.tolist()):
        assert e <= b * (1 + 1e-8) and b <= 1e4 * max(e, 1e-12), (e, b)


def test_jax_semilinear_files(jax_flow, tmp_path):
    """The ``semilinear`` and ``semilinear_instationary`` files written by the
    JAX package load in the port: solutions, estimates, trajectories and the
    certified bound equal the JAX ones (1e-10, in the file's basis); the
    port's own files round-trip exactly; a file of the older format (no
    ``v_row_sup`` slot) loads with NaN and the bound then refuses."""
    from rla4mor_tpu_torch.mor.serialization import load_rom, save_rom

    rom = load_rom(jax_flow["files"] / "sl.npz", device="cpu")
    test = mu_stack(_tmus(jax_flow["test"]))
    a, est = rom.solve_and_estimate_batch(test)
    assert rel(a, jax_flow["a"]) < 1e-10 and rel(est, jax_flow["est"]) < 1e-10
    prom = load_rom(jax_flow["files"] / "sl_inst.npz", device="cpu")
    held = mu_stack(_tmus(jax_flow["test"][:2]))
    traj = prom.solve(held)
    assert rel(traj, jax_flow["ptraj"]) < 1e-10
    assert rel(prom.estimate_error(held, traj), jax_flow["pest"]) < 1e-10
    b, _ = prom.certified_error_bound(held, lambda m: torch.tensor(1.0), traj=traj)
    jb = jax_flow["bounds"]["strong"][0]
    assert np.array_equal(np.isfinite(b.numpy()), np.isfinite(jb))
    for r in (rom, prom):
        save_rom(r, tmp_path / "port.npz")
        back = load_rom(tmp_path / "port.npz", device="cpu")
        assert type(back) is type(r) and torch.equal(back.W, r.W)
        assert torch.equal(back.error_estimator.gram, r.error_estimator.gram)
    assert rel(back.solve(held), traj) == 0.0
    with np.load(jax_flow["files"] / "sl_inst.npz") as d:
        fields = {key: d[key] for key in d.files}
    fields["aux"] = fields["aux"][:3]
    np.savez(tmp_path / "old.npz", **fields)
    old = load_rom(tmp_path / "old.npz", device="cpu")
    assert np.isnan(old.v_row_sup)
    with pytest.raises(ValueError, match="v_row_sup"):
        old.certified_error_bound(held, lambda m: torch.tensor(1.0))


def test_semilinear_demo_matches_jax_flow(jax_flow):
    """``semilinear_demo.run`` at grid 12 (8 training, 4 test draws, 3
    greedy steps, the IMEX composition at nt 6) on the JAX flow's draws:
    the dense anchor, picks and history, estimates, coercivities, errors
    (1e-8) and 0 violations of the bounds (the demo's 1 + 1e-8 slack), the
    IMEX trajectory errors and indicators against the JAX ones (1e-7: the
    pod_rtol = 1e-8 modes, see ``test_imex_fom_and_rom_match_jax``)."""
    from rla4mor_tpu_torch.examples import semilinear_demo as demo

    res = demo.run(grid=GRID, greedy_steps=STEPS, parabolic=True, nt=NT_P,
                   mus_train=_tmus(jax_flow["train"]), mus_test=_tmus(jax_flow["test"]),
                   device="cpu", log=lambda line: None)
    assert abs(res["alpha_ref"] - jax_flow["alpha_ref"]) < 1e-12 * jax_flow["alpha_ref"]
    assert res["picked"] == jax_flow["picks"]
    assert rel(res["history"], jax_flow["hist"]) < 1e-8
    assert rel(res["estimates"], jax_flow["est"]) < 1e-8
    assert rel(res["alphas"], jax_flow["alphas"]) < 1e-12
    assert rel(res["errors"], jax_flow["errors"]) < 1e-8
    assert res["violations"] == 0
    par = res["parabolic"]
    V_p, trajs = jax_flow["V_p"], jax_flow["ptraj"]
    for i, want in enumerate(jax_flow["ifom_truth"]):
        jrel = np.linalg.norm(V_p @ trajs[i] - want) / np.linalg.norm(want)
        assert abs(par["rel_errors"][i] - jrel) < 1e-7 * jrel
        assert abs(par["indicators"][i] - float(jax_flow["pest"][i])) < 1e-7 * par[
            "indicators"][i]
