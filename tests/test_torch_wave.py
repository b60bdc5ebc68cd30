"""The wave tier of the PyTorch port held against the JAX package (f64, CPU):
``WaveFOM`` / ``WaveROM`` / ``WaveReductor`` with ``pod_greedy``, the
matrix-free ``WaveStencilFOM``, the wave ROM file and reductor checkpoint,
serving and ``wave_demo.run``.

Both packages get the same inputs at the JAX tests' sizes
(``tests/test_wave.py``: ``wave_thermal_block((2, 2), 10, nt=40)``): the
Gaussian Omega is carried from the JAX side (``from_matrix``), parameters
are drawn with numpy. The JAX greedy runs once, with ``pad_to`` and its
padding jitted (one compile a run), in a module fixture that the greedy,
the ROM file and the demo tests share. The JAX MG cycle restricts by
P^T r / 4 (ROADMAP.md queue 3), so the port's MG trajectories are held to
Jacobi and dense trajectories, never to the JAX MG iterations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import rla4mor_tpu.models as jm
from rla4mor_tpu.models.stencil import StencilThermalBlock as JaxStencil
from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian

import rla4mor_tpu_torch.models as tm
from rla4mor_tpu_torch.core import mu_stack, pod
from rla4mor_tpu_torch.models.stencil import StencilThermalBlock, interior_mask, mass_apply
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

GRID, NT, K, EXT, MODES, N_TRAIN = 10, 40, 120, 4, 3, 8


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rows(count, seed, dim=4):
    return np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, dim))


def _jmus(rows):
    return [{"diffusion": jnp.asarray(r)} for r in rows]


def _tmus(rows):
    return [{"diffusion": torch.tensor(r)} for r in rows]


@pytest.fixture(scope="module")
def foms():
    return (jm.wave_thermal_block((2, 2), GRID, T=1.0, nt=NT),
            tm.wave_thermal_block((2, 2), GRID, T=1.0, nt=NT, device="cpu"))


@pytest.fixture(scope="module")
def jax_flow(foms, tmp_path_factory):
    """The JAX wave demo's flow at the JAX tests' sizes: POD-greedy (4
    extensions of 3 modes over 8 numpy draws, Gaussian k = 120 at seed 2
    over the h1_0 sqrt factor, pad_to 12), the live-size ROM's held-out
    trajectories and indicators at 2 numpy draws (one jitted vmap), its ROM
    file and the Omega. About 10 s: the JAX reductor's eager operations
    compile at every basis size (its padding is jitted here, the same
    function in one compile)."""
    import rla4mor_tpu.models.instationary as jinst
    from rla4mor_tpu.core.parameters import mu_stack as jax_mu_stack
    from rla4mor_tpu.mor.serialization import save_rom as jax_save_rom

    jf, _ = foms
    Ru = jf.products["h1_0"]
    emb = JaxGaussian.make(jf.solution_dim, sqrt_product=Ru.sqrt, range_dim=K, seed=2)
    red = jm.WaveReductor(jf, embedding=emb, product=Ru, log_level=30)
    train, test = _rows(N_TRAIN, 3), _rows(2, 9)
    orig = jinst.pad_time_system
    jinst.pad_time_system = jax.jit(orig, static_argnums=(0, 1))
    try:
        rom, hist = jm.pod_greedy(jf, red, _jmus(train), max_extensions=EXT,
                                  modes_per_extension=MODES, pad_to=EXT * MODES, log_level=30)
    finally:
        jinst.pad_time_system = orig
    traj, eta = jax.jit(jax.vmap(lambda m: rom.solve(m, return_estimate=True)))(
        jax_mu_stack(_jmus(test)))
    path = tmp_path_factory.mktemp("wave") / "wave_rom.npz"
    jax_save_rom(rom, path)
    picks = [int(np.flatnonzero((train == np.asarray(m["diffusion"])).all(axis=1))[0])
             for m in hist["selected_mus"]]
    return {"train": train, "test": test, "rom": rom, "reductor": red, "hist": hist,
            "picks": picks, "traj": np.asarray(traj), "eta": np.asarray(eta),
            "rec": np.stack([np.asarray(red.reconstruct(t)) for t in traj]),
            "truth": np.stack([np.asarray(jf.solve(m)) for m in _jmus(test)]),
            "omega": np.asarray(emb.random_matrix()), "rom_file": path}


def _port_embedding(tf, omega):
    return GaussianEmbedding.from_matrix(omega, sqrt_product=tf.products["h1_0"].sqrt,
                                         device="cpu")


def test_host_newmark_matches_jax(foms):
    """Host Newmark (one splu a parameter, the mass LU cached): trajectory
    and velocity equal the JAX package's to 1e-10; with f = 0 the discrete
    energy (v^T M v + u^T A u) / 2 is conserved to 1e-12 (the scheme's
    defining property)."""
    jf, tf = foms
    row = _rows(1, 0)[0]
    jt, jv = jf.solve({"diffusion": jnp.asarray(row)}, return_velocity=True)
    tt, tv = tf.solve({"diffusion": torch.tensor(row)}, return_velocity=True)
    assert tt.shape == (tf.solution_dim, NT + 1)
    assert rel(tt, jt) < 1e-10 and rel(tv, jv) < 1e-10
    A = tf.assemble_sparse({"diffusion": torch.tensor(row)})
    M = sps.csc_matrix(tf.mass.S)
    u, v = tt.numpy(), tv.numpy()
    E = [0.5 * (v[:, k] @ (M @ v[:, k]) + u[:, k] @ (A @ u[:, k])) for k in range(NT + 1)]
    assert (max(E) - min(E)) / E[0] < 1e-12
    assert len(tf._lu_M) == 1  # the mass is factored once


def test_rom_on_carried_basis_matches_jax(foms, jax_flow):
    """The JAX greedy's final basis and Omega carried into a port reductor:
    the batched ROM's trajectories and indicators at the held-out draws
    equal the JAX ROM's to 1e-9; the padded ROM's dead coordinates stay
    exactly zero and its trajectory and indicator equal the live-size ones
    (1e-12); a trajectory's own POD basis reproduces it with an indicator
    below 1e-10; a ROM reduced without an embedding refuses to estimate."""
    _, tf = foms
    Ru = tf.products["h1_0"]
    red = tm.WaveReductor(tf, embedding=_port_embedding(tf, jax_flow["omega"]), product=Ru,
                          log_level=30)
    red.rb = torch.tensor(np.asarray(jax_flow["reductor"].rb))
    rom = red.reduce()
    test = mu_stack(_tmus(jax_flow["test"]))
    traj, eta = rom.solve(test, return_estimate=True)
    assert traj.shape == (2, rom.dim, NT + 1)
    assert rel(traj, jax_flow["traj"]) < 1e-9 and rel(eta, jax_flow["eta"]) < 1e-9
    r = rom.dim
    t_p, e_p = red.reduce(pad_to=r + 4).solve(test, return_estimate=True)
    assert float(t_p[:, r:].abs().max()) == 0.0
    assert rel(t_p[:, :r], traj) < 1e-12 and rel(e_p, eta) < 1e-12
    with pytest.raises(ValueError, match="pad_to"):
        red.reduce(pad_to=r - 1)
    mu = _tmus(jax_flow["test"])[0]
    truth = tf.solve(mu)
    own = tm.WaveReductor(tf, embedding=red.embedding, product=Ru, log_level=30)
    own.extend_basis(pod(truth, product=Ru, rtol=1e-12)[0])
    t_own, e_own = own.reduce().solve(mu, return_estimate=True)
    assert rel(own.reconstruct(t_own), truth) < 1e-10 and float(e_own) < 1e-10
    bare = tm.WaveReductor(tf, product=Ru, log_level=30)
    bare.extend_basis(red.rb)
    with pytest.raises(ValueError, match="without an embedding"):
        bare.reduce().estimate_error(mu)


@pytest.mark.parametrize("pad_to", [None, EXT * MODES])
def test_pod_greedy_matches_jax(foms, jax_flow, pad_to):
    """``pod_greedy`` drives the wave reductor unchanged: the JAX run's
    picks and max estimates (1e-8), unpadded and padded, and the final
    ROM's held-out reconstructions (1e-9); the held-out error is the JAX
    test's (< 0.08 at this basis)."""
    _, tf = foms
    red = tm.WaveReductor(tf, embedding=_port_embedding(tf, jax_flow["omega"]),
                          product=tf.products["h1_0"], log_level=30)
    train = _tmus(jax_flow["train"])
    rom, hist = tm.pod_greedy(tf, red, train, max_extensions=EXT, modes_per_extension=MODES,
                              pad_to=pad_to, log_level=30)
    picks = [next(i for i, m in enumerate(train) if m is mu) for mu in hist["selected_mus"]]
    assert picks == jax_flow["picks"]
    assert rel(hist["max_estimates"], jax_flow["hist"]["max_estimates"]) < 1e-8
    assert rom.dim == red.basis_size == EXT * MODES
    rec = red.reconstruct(rom.solve(mu_stack(_tmus(jax_flow["test"]))))
    assert rel(rec, jax_flow["rec"]) < 1e-9
    err = np.linalg.norm(rec[0].numpy() - jax_flow["truth"][0]) / np.linalg.norm(
        jax_flow["truth"][0])
    assert err < 0.08, err


def _dense(fn, shape, interior):
    """The interior block of a grid operator, column by column."""
    n = int(np.prod(shape))
    cols = []
    for j in interior:
        e = torch.zeros(n, dtype=torch.float64)
        e[j] = 1.0
        cols.append(fn(e.reshape(shape)).reshape(-1).numpy()[interior])
    return np.stack(cols, 1)


def _dense_newmark(M, A, b, dt, nt, beta=0.25, gamma=0.5):
    u = np.zeros(b.size)
    v = np.zeros_like(u)
    a = np.linalg.solve(M, b - A @ u)
    S = M + beta * dt * dt * A
    us = [u]
    for _ in range(nt):
        u_star = u + dt * v + dt * dt * (0.5 - beta) * a
        v_star = v + dt * (1.0 - gamma) * a
        a = np.linalg.solve(S, b - A @ u_star)
        u = u_star + beta * dt * dt * a
        v = v_star + gamma * dt * a
        us.append(u)
    return np.stack(us, 1)


def test_stencil_newmark_matches_jax_and_dense():
    """``WaveStencilFOM`` at grid 8 (nt 12, T 0.5): Jacobi-CG equals the JAX
    Jacobi trajectory (1e-10 of the scale) and a dense Newmark oracle on
    the interior; the port's MG-CG (the mass-shifted V-cycle with
    mass_dt = beta dt^2) equals both (1e-10); ``store_every`` subsamples;
    the flat view drives ``pod_greedy`` to a held-out error below 0.05 with
    the last max estimate below half the first (the JAX test's checks)."""
    N, nt = 8, 12
    rows = _rows(1, 3)
    jd = jm.WaveStencilFOM(JaxStencil((2, 2), N, dtype=jnp.float64), T=0.5, nt=nt)
    jt = np.asarray(jd.solve(_jmus(rows)[0], tol=1e-13, maxiter=1000))
    st = StencilThermalBlock((2, 2), N, dtype=torch.float64, device="cpu")
    td = tm.WaveStencilFOM(st, T=0.5, nt=nt)
    mu = _tmus(rows)[0]
    tt = td.solve(mu, tol=1e-13, maxiter=1000)
    assert tt.shape == (N + 1, N + 1, nt + 1)
    scale = np.abs(jt).max()
    assert np.abs(tt.numpy() - jt).max() < 1e-10 * scale
    interior = np.flatnonzero(interior_mask(N + 1, device="cpu").reshape(-1).numpy())
    shape = st.solution_shape
    A = _dense(lambda g: st.apply(mu, g), shape, interior)
    M = _dense(lambda g: mass_apply(g, st.h), shape, interior)
    want = _dense_newmark(M, A, st.rhs().reshape(-1).numpy()[interior], td.dt, nt)
    assert np.abs(tt.reshape(-1, nt + 1).numpy()[interior] - want).max() < 1e-10 * scale
    t_mg = td.solve(mu, tol=1e-13, maxiter=200, precond="mg")
    assert np.abs(t_mg.numpy() - jt).max() < 1e-10 * scale
    assert max(td.solve_log[-1]["iters"]) < 20
    ts = td.solve(mu, tol=1e-13, maxiter=1000, store_every=3)
    assert ts.shape[-1] == nt // 3 + 1 and rel(ts[..., 1], tt[..., 3]) < 1e-12
    with pytest.raises(ValueError, match="store_every"):
        td.solve(mu, store_every=5)

    view = td.as_reductor_fom(tol=1e-11, maxiter=1000)
    assert not hasattr(view, "time_theta") and view.v0.shape == (view.solution_dim,)
    emb = GaussianEmbedding.make(view.solution_dim, range_dim=80, seed=2, device="cpu")
    red = tm.WaveReductor(view, embedding=emb, log_level=30)
    train = _tmus(_rows(8, 7))
    rom, hist = tm.pod_greedy(view, red, train, max_extensions=6, modes_per_extension=3,
                              log_level=30)
    est = hist["max_estimates"]
    assert est[-1] < 0.5 * est[0]
    mu_t = _tmus(_rows(1, 9))[0]
    truth = view.solve(mu_t)
    assert float((red.reconstruct(rom.solve(mu_t)) - truth).norm() / truth.norm()) < 0.05
    outs = view.output_functional.apply(truth, mu_t)[0]
    assert rel(outs, st.output(truth.T.reshape(-1, *shape))) < 1e-14


def test_wave_stencil_3d_and_nonspd():
    """The rank-generic backend carries over (the JAX test's cases): the 3-D
    block (lumped-mass hooks) at grid 4 equals a dense Newmark oracle
    (1e-9 of the scale) with a zero Dirichlet shell; the non-SPD
    advection-diffusion family runs its acceleration solves by BiCGStab to
    a finite, nonzero trajectory; MG is refused in 3-D."""
    from rla4mor_tpu_torch.models.stencil3d import interior_mask3

    st3 = tm.StencilThermalBlock3D((2, 2, 2), 4, dtype=torch.float64, device="cpu")
    dev3 = tm.WaveStencilFOM(st3, T=0.25, nt=6)
    mu3 = {"diffusion": torch.tensor(_rows(1, 3, dim=8)[0])}
    traj3 = dev3.solve(mu3, tol=1e-13, maxiter=500)
    assert traj3.shape == (*st3.solution_shape, 7)
    interior = np.flatnonzero(interior_mask3(st3.n_nodes, torch.float64, "cpu").reshape(-1).numpy())
    A = _dense(lambda g: st3.apply(mu3, g), st3.solution_shape, interior)
    M = st3.h ** 3 * np.eye(interior.size)  # lumped
    want = _dense_newmark(M, A, st3.rhs().reshape(-1).numpy()[interior], dev3.dt, dev3.nt)
    got = traj3.reshape(-1, dev3.nt + 1).numpy()
    assert np.abs(got[interior] - want).max() < 1e-9 * np.abs(want).max()
    boundary = np.setdiff1d(np.arange(st3.n_dof), interior)
    assert np.abs(got[boundary]).max() == 0.0
    with pytest.raises(ValueError, match="2-D"):
        dev3.solve(mu3, precond="mg")

    adv = tm.StencilAdvectionDiffusion(8, dtype=torch.float64, device="cpu")
    deva = tm.WaveStencilFOM(adv, T=0.25, nt=6)
    traja = deva.solve(adv.sample_parameters(1, key=3)[0], tol=1e-12, maxiter=2000)
    assert bool(torch.isfinite(traja).all()) and float(traja.abs().max()) > 0
    assert max(deva.solve_log[-1]["iters"]) < 2000


def test_jax_wave_rom_file_served(foms, jax_flow, tmp_path):
    """A ``WaveROM`` file written by the JAX package loads in the port and
    serves: ``serve_batch`` equals the JAX ROM's trajectories and
    indicators (1e-10) and the per-parameter solve; the port's own file
    round-trips exactly."""
    from rla4mor_tpu_torch.mor.serialization import load_rom, save_rom
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch

    rom = load_rom(jax_flow["rom_file"], device="cpu")
    assert isinstance(rom, tm.WaveROM) and rom.dim == EXT * MODES
    batch, n = pad_batch(mu_stack(_tmus(jax_flow["test"])), 4)
    out = serve_batch(rom, batch)
    assert set(out) == {"u", "estimate", "output"} and n == 2
    assert rel(out["u"][:n], jax_flow["traj"]) < 1e-10
    assert rel(out["estimate"][:n], jax_flow["eta"]) < 1e-10
    assert out["output"].shape == (4, 1, NT + 1)
    mu0 = _tmus(jax_flow["test"])[0]
    u0, e0 = rom.solve(mu0, return_estimate=True)
    assert rel(out["u"][0], u0) < 1e-12 and abs(float(out["estimate"][0] - e0)) < 1e-12
    save_rom(rom, tmp_path / "port.npz")
    back = load_rom(tmp_path / "port.npz", device="cpu")
    assert back.beta == rom.beta and back.gamma == rom.gamma and back.nt == NT
    assert rel(back.solve(mu0), u0) == 0.0


def test_wave_reductor_checkpoint_round_trip(foms, jax_flow, tmp_path):
    """``save_wave_reductor`` / ``load_wave_reductor_state``: the basis comes
    back and ``reduce()`` rebuilds the same ROM; another seed, another
    embedding and the JAX package's checkpoint (its seeds name other
    operators) are refused."""
    from rla4mor_tpu.mor.serialization import save_wave_reductor as jax_save

    from rla4mor_tpu_torch.mor import load_wave_reductor_state, save_wave_reductor

    _, tf = foms
    Ru = tf.products["h1_0"]
    emb = GaussianEmbedding.make(tf.solution_dim, sqrt_product=Ru.sqrt, range_dim=40, seed=5,
                                 device="cpu")
    red = tm.WaveReductor(tf, embedding=emb, product=Ru, log_level=30)
    red.rb = torch.tensor(np.asarray(jax_flow["reductor"].rb))
    save_wave_reductor(red, tmp_path / "red.npz")
    fresh = tm.WaveReductor(tf, embedding=emb, product=Ru, log_level=30)
    load_wave_reductor_state(fresh, tmp_path / "red.npz")
    assert torch.equal(fresh.rb, red.rb)
    mu = _tmus(jax_flow["test"])[:1]
    assert rel(fresh.reduce().solve(mu_stack(mu)), red.reduce().solve(mu_stack(mu))) == 0.0
    other = GaussianEmbedding.make(tf.solution_dim, sqrt_product=Ru.sqrt, range_dim=40,
                                   seed=6, device="cpu")
    with pytest.raises(ValueError, match="seed"):
        load_wave_reductor_state(tm.WaveReductor(tf, embedding=other, product=Ru,
                                                 log_level=30), tmp_path / "red.npz")
    jax_save(jax_flow["reductor"], tmp_path / "jax.npz")
    with pytest.raises(ValueError, match="seed derivation"):
        load_wave_reductor_state(fresh, tmp_path / "jax.npz")


def test_wave_demo_matches_jax_flow(foms, jax_flow):
    """``wave_demo.run`` at grid 10, nt 40 on the JAX flow's Omega and draws:
    its picks, max estimates, held-out errors and indicators equal the JAX
    run's (1e-8); the indicator lies within [0.5, 2] of the exact space-time
    residual in the h1_0 dual norm; the served batch equals per-parameter
    solves. The stencil flow at grid 8 (Jacobi, 3 extensions): one reduce()
    a extension and the final ROM, no solve above tol, indicators within
    [0.5, 2] of the exact l2 residual."""
    from rla4mor_tpu_torch.examples import wave_demo as demo

    _, tf = foms
    res = demo.run(grid=GRID, nt=NT, extensions=EXT, k=K,
                   embedding=lambda n, k: _port_embedding(tf, jax_flow["omega"]),
                   train=_tmus(jax_flow["train"]), test=_tmus(jax_flow["test"]),
                   device="cpu", log=lambda line: None)
    train = res["train"]
    picks = [next(i for i, m in enumerate(train) if m is mu) for mu in res["selected_mus"]]
    assert picks == jax_flow["picks"] and res["basis"] == EXT * MODES
    assert rel(res["max_estimates"], jax_flow["hist"]["max_estimates"]) < 1e-8
    truth, rec = jax_flow["truth"], jax_flow["rec"]
    for i, held in enumerate(res["held_out"]):
        want = np.linalg.norm(rec[i] - truth[i]) / np.linalg.norm(truth[i])
        assert abs(held["rel_err"] - want) < 1e-8 * want
        assert abs(held["estimate"] - float(jax_flow["eta"][i])) < 1e-8 * held["estimate"]
        assert 0.5 <= held["est_over_exact"] <= 2.0
    assert res["serve_dev"] < 1e-12

    res = demo.run(grid=8, nt=12, extensions=3, k=60, stencil=True, precond="jacobi",
                   tol=1e-10, maxiter=1000, device="cpu", log=lambda line: None)
    assert res["reduce_calls"] == 3 and res["solver"]["breakdowns"] == 0
    assert all(0.5 <= h["est_over_exact"] <= 2.0 for h in res["held_out"])
