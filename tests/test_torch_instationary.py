"""The parabolic tier of the PyTorch port held against the JAX package (f64,
CPU): ``InstationaryFOM`` / ``InstationaryROM`` / ``InstationaryReductor`` /
``pod_greedy``, the matrix-free ``InstationaryStencilFOM`` (2-D, 3-D, EIM
surrogates), the parabolic bounds and both demos' ``run()``.

Both packages get the same inputs: the Gaussian Omegas are carried from the
JAX side (``from_matrix``), parameters are drawn with numpy or carried from
the JAX draws. The JAX package's MG cycle restricts by P^T r / 4, the port's
by P^T r (``models/multigrid.py``), so the port's MG trajectories are held
to the JAX Jacobi trajectories at tol 1e-12, never to its MG iterations.
The JAX sweeps run with ``pad_to`` (one compile a run); the JAX-side
results are module fixtures shared by the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.models as jm
import rla4mor_tpu.mor as jmor
from rla4mor_tpu.models.stencil import StencilThermalBlock as JaxStencil
from rla4mor_tpu.models.stencil3d import StencilThermalBlock3D as JaxStencil3D
from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian

import rla4mor_tpu_torch.models as tm
import rla4mor_tpu_torch.mor as tmor
from rla4mor_tpu_torch.core import mu_stack, pod
from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
from rla4mor_tpu_torch.models.stencil3d import StencilThermalBlock3D
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding, StreamedGaussianEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

MU_REF = 0.55


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mus(count, seed, dim=4):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, dim))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _to_torch(mus):
    return [{k: torch.tensor(np.asarray(v)) for k, v in mu.items()} for mu in mus]


def _same_mus(tmus, jmus):
    return all(np.array_equal(t["diffusion"].numpy(), np.asarray(j["diffusion"]))
               for t, j in zip(tmus, jmus)) and len(tmus) == len(jmus)


# the JAX instationary demo's configuration (examples/instationary_demo.py) at
# grid 12, with 5 POD-greedy extensions and 1 output-greedy extension (8 and
# 5 in the demo: each JAX extension compiles anew, about 2 s; the output
# greedy's sweeps are held in tests/test_torch_primal_dual.py)
GRID, NT, K, EXT, PD_EXT = 12, 30, 100, 5, 1


@pytest.fixture(scope="module")
def pfoms():
    return (jm.instationary_thermal_block((2, 2), GRID, T=0.5, nt=NT),
            tm.instationary_thermal_block((2, 2), GRID, T=0.5, nt=NT, device="cpu"))


def _embeddings(pfoms, k=K, seed=0):
    jf, tf = pfoms
    je = JaxGaussian.make(jf.solution_dim, sqrt_product=jf.products["h1_0"].sqrt,
                          range_dim=k, seed=seed)
    te = GaussianEmbedding.from_matrix(np.asarray(je.random_matrix()),
                                       sqrt_product=tf.products["h1_0"].sqrt, device="cpu")
    return je, te


def _reductors(pfoms, k=K, seed=0):
    jf, tf = pfoms
    je, te = _embeddings(pfoms, k, seed)
    return (jm.InstationaryReductor(jf, embedding=je, product=jf.products["h1_0"],
                                    log_level=30),
            tm.InstationaryReductor(tf, embedding=te, product=tf.products["h1_0"],
                                    log_level=30))


def _jax_solve_batch(rom, mus):
    """A JAX ROM's trajectories and estimates over a list of Mu, one jitted
    vmap (an eager ``lax.scan`` would compile at every call)."""
    from rla4mor_tpu.core.parameters import mu_stack as jax_mu_stack

    traj, eta = jax.jit(jax.vmap(lambda m: rom.solve(m, return_estimate=True)))(
        jax_mu_stack(mus))
    return np.asarray(traj), np.asarray(eta)


@pytest.fixture(scope="module")
def jax_demo(pfoms):
    """The JAX instationary demo's flow (grid 12, nt 30, k = 100 at seed 0,
    20 training and 5 test draws of keys 1 and 2; pad_to, one compile of
    each sweep), which the port's ``pod_greedy``, bounds and
    ``instationary_demo.run`` are held to: the greedy, the test
    trajectories and estimates, the certified bounds, and the output greedy
    of the localized functional with its corrected output at test[0]. About
    20 s: the JAX reductors' eager operations compile at every basis
    size."""
    from rla4mor_tpu.core.affine import AffineDense as JaxAffineDense
    from rla4mor_tpu.core.parameters import ONE as JONE

    pf = jm.instationary_thermal_block((2, 2), GRID, T=0.5, nt=NT)
    Ru = pf.products["h1_0"]
    emb, _ = _embeddings(pfoms)
    space = pf.parameter_space
    train, test = space.sample_randomly(20, key=1), space.sample_randomly(5, key=2)
    red = jm.InstationaryReductor(pf, embedding=emb, product=Ru, log_level=30)
    rom, hist = jm.pod_greedy(pf, red, train, max_extensions=EXT, pad_to=EXT, log_level=30)
    coer = jmor.MinThetaCoercivity(pf, {"diffusion": jnp.full(4, MU_REF)}, product=Ru)

    def online(m):  # one jitted program: trajectories, estimates, both bounds
        return (*rom.solve(m, return_estimate=True),
                *(jmor.parabolic_error_bound(rom, m, coer, kind=kind)
                  for kind in ("final", "spacetime")))

    traj, eta, b_final, b_st = (np.asarray(x) for x in jax.jit(jax.vmap(online))(
        {"diffusion": jnp.stack([m["diffusion"] for m in test])}))
    out = {"train": train, "test": test, "reductor": red, "rom": rom, "hist": hist,
           "traj": traj, "eta": eta, "bounds": {"final": b_final, "spacetime": b_st},
           "omegas": {0: np.asarray(emb.random_matrix())}}
    w = np.zeros((GRID - 1, GRID - 1))
    w[: GRID // 3, : GRID // 3] = 1.0
    pf.output_functional = JaxAffineDense(jnp.asarray(w.reshape(1, 1, -1) / w.sum()),
                                          (JONE,))
    red_pd = jm.InstationaryPrimalDualReductor(pf, embedding=emb, product=Ru, log_level=30)
    rom_pd, hist_pd = jm.output_pod_greedy(pf, red_pd, train[:10], max_extensions=PD_EXT,
                                           modes_per_extension=2, pad_to=2 * PD_EXT,
                                           log_level=30)
    s_c, eta_s = jax.jit(rom_pd.output_corrected)(test[0])
    out.update(hist_pd=hist_pd, s_c=float(s_c), eta_s=float(eta_s))
    out["omegas"][77] = np.asarray(red_pd.embedding_dual.random_matrix())
    return out


def test_rom_trajectory_and_estimate(pfoms):
    """The batched ROM time loop equals the per-parameter one; the padded ROM
    equals the live-size one (dead coordinates exactly zero); a ROM reduced
    without an embedding refuses to estimate."""
    _, tf = pfoms
    _, te = _embeddings(pfoms)
    red = tm.InstationaryReductor(tf, embedding=te, product=tf.products["h1_0"],
                                  log_level=30)
    _, tmus = _mus(4, 9)
    for mu in tmus[:2]:
        red.extend_basis(pod(red.project_trajectory(tf.solve(mu)),
                             product=tf.products["h1_0"], modes=2)[0])
    r = red.basis_size
    rom = red.reduce()
    t1, e1 = rom.solve(tmus[2], return_estimate=True)
    tb, eb = rom.solve(mu_stack(tmus[2:]), return_estimate=True)
    assert tb.shape == (2, r, NT + 1) and eb.shape == (2,)
    assert rel(tb[0], t1) < 1e-12 and abs(float(eb[0]) - float(e1)) < 1e-12 * float(e1)
    assert rom.output(tb, mu_stack(tmus[2:])).shape == (2, 1, NT + 1)
    t2, e2 = red.reduce(pad_to=r + 5).solve(tmus[2], return_estimate=True)
    assert t2.shape[0] == r + 5
    assert float(t2[r:].abs().max()) == 0.0
    assert float((t2[:r] - t1).abs().max()) < 1e-12 * float(t1.abs().max())
    assert abs(float(e2) - float(e1)) < 1e-12 * float(e1)
    with pytest.raises(ValueError, match="pad_to"):
        red.reduce(pad_to=r - 1)
    bare = tm.InstationaryReductor(tf, product=tf.products["h1_0"], log_level=30)
    bare.extend_basis(red.rb)
    with pytest.raises(ValueError, match="without an embedding"):
        bare.reduce().estimate_error(tmus[0])


class _Table:
    """A coercivity with a host ``tabulate`` (the SCM's interface)."""

    def __init__(self, coercivity):
        self.coercivity = coercivity

    def tabulate(self, mus):
        return self.coercivity(mu_stack(mus)).numpy()


@pytest.mark.parametrize("name", ["snapshots", "padded", "randomized", "certified",
                                  "tabulated"])
def test_pod_greedy_matches(pfoms, jax_demo, name):
    """The JAX demo's POD-greedy on the port: the same selected parameters
    and max estimates (1e-8), unpadded and with ``pad_to``, and with the
    randomized POD (its leading modes are the snapshot method's to
    rounding); the final ROM's test trajectories and estimates to 1e-10
    (1e-8 after the randomized POD). Certified (``coercivity=`` a
    min-theta callable or a ``tabulate`` object): the scores are the
    estimates over sqrt(alpha_LB), and the bound dominates the true
    final-time M-norm error."""
    jf, tf = pfoms
    _, te = _embeddings(pfoms)
    red = tm.InstationaryReductor(tf, embedding=te, product=tf.products["h1_0"],
                                  log_level=30)
    train, test = _to_torch(jax_demo["train"]), _to_torch(jax_demo["test"])
    coer = tmor.MinThetaCoercivity(
        tf, {"diffusion": torch.full((4,), MU_REF, dtype=torch.float64)},
        product=tf.products["h1_0"])
    kw = {"padded": {"pad_to": EXT}, "randomized": {"pod_method": "randomized"},
          "certified": {"coercivity": coer},
          "tabulated": {"coercivity": _Table(coer)}}.get(name, {})
    rom, hist = tm.pod_greedy(tf, red, train, max_extensions=EXT, log_level=30, **kw)
    assert len(hist["fom_s"]) == len(hist["extension_s"]) == EXT
    assert rom.dim == red.basis_size == EXT
    jhist = jax_demo["hist"]
    if name in ("certified", "tabulated"):
        scores = hist["max_estimates"]
        assert len(scores) == EXT - 1 and all(np.isfinite(scores))
        for mu in train[:3]:
            e = (red.reconstruct(rom.solve(mu)).numpy() - tf.solve_host(mu))[:, -1]
            bound = float(tmor.parabolic_error_bound(rom, mu, coer))
            assert np.sqrt(e @ (tf.mass.S @ e)) <= bound * (1 + 1e-9)
        return
    assert _same_mus(hist["selected_mus"], jhist["selected_mus"])
    tol = 1e-8 if name == "randomized" else 1e-10
    assert rel(hist["max_estimates"], jhist["max_estimates"]) < 1e-8
    traj, eta = rom.solve(mu_stack(test), return_estimate=True)
    jred = jax_demo["reductor"]
    for i in range(len(test)):
        assert rel(red.reconstruct(traj[i]), jred.reconstruct(jax_demo["traj"][i])) < tol
    assert rel(eta, jax_demo["eta"]) < tol


def test_parabolic_error_bound_matches_jax(pfoms, jax_demo):
    """The final-time and space-time bounds of the demo's ROM equal the JAX
    package's to 1e-10 at the 5 test parameters (one batched call)."""
    _, tf = pfoms
    _, te = _embeddings(pfoms)
    red = tm.InstationaryReductor(tf, embedding=te, product=tf.products["h1_0"],
                                  log_level=30)
    rom, _ = tm.pod_greedy(tf, red, _to_torch(jax_demo["train"]), max_extensions=EXT,
                           pad_to=EXT, log_level=30)
    coer = tmor.MinThetaCoercivity(
        tf, {"diffusion": torch.full((4,), MU_REF, dtype=torch.float64)},
        product=tf.products["h1_0"])
    batch = mu_stack(_to_torch(jax_demo["test"]))
    for kind in ("final", "spacetime"):
        got = tmor.parabolic_error_bound(rom, batch, coer, kind=kind)
        assert rel(got, jax_demo["bounds"][kind]) < 1e-10


@pytest.mark.parametrize("theta", [1.0, 0.5])
def test_parabolic_error_bound_certified(theta):
    """Grepl-Patera bounds dominate the true final-time M-norm and
    space-time R-norm errors for implicit Euler and Crank-Nicolson at tight
    effectivity (as ``test_parabolic_error_bound_certified``, grid 10);
    theta < 1/2 and an unknown kind are refused."""
    tf = tm.instationary_thermal_block((2, 2), 10, T=0.5, nt=12, time_theta=theta,
                                       device="cpu")
    Ru = tf.products["h1_0"]
    emb = GaussianEmbedding.make(tf.solution_dim, sqrt_product=Ru.sqrt, range_dim=150,
                                 seed=3, device="cpu")
    red = tm.InstationaryReductor(tf, embedding=emb, product=Ru, log_level=30)
    _, tmus = _mus(3, 1)
    for mu in tmus[:2]:
        red.extend_basis(pod(tf.solve(mu), product=Ru, rtol=1e-6)[0][:, :4])
    rom = red.reduce()
    coer = tmor.MinThetaCoercivity(
        tf, {"diffusion": torch.full((4,), MU_REF, dtype=torch.float64)}, product=Ru)
    e = red.reconstruct(rom.solve(tmus[2])).numpy() - tf.solve_host(tmus[2])
    err_final = float(np.sqrt(e[:, -1] @ (tf.mass.S @ e[:, -1])))
    eth = theta * e[:, 1:] + (1 - theta) * e[:, :-1]
    err_st = float(np.sqrt(tf.dt * np.sum(Ru.norm(torch.tensor(eth)).numpy() ** 2)))
    for kind, err in (("final", err_final), ("spacetime", err_st)):
        bound = float(tmor.parabolic_error_bound(rom, tmus[2], coer, kind=kind))
        assert err <= bound <= 50 * err, (kind, err, bound)
    rom.time_theta = 0.25
    with pytest.raises(ValueError, match="time_theta"):
        tmor.parabolic_error_bound(rom, tmus[2], coer)
    rom.time_theta = theta
    with pytest.raises(ValueError, match="kind"):
        tmor.parabolic_error_bound(rom, tmus[2], coer, kind="l2")


def test_pod_greedy_rejects_nonpositive_coercivity(pfoms):
    """A coercivity lower bound that is not positive on the training set
    fails loudly (its sqrt would flow NaN into the argmax); theta < 1/2 is
    refused up front; a reductor without an embedding is refused."""
    _, tf = pfoms
    _, tred = _reductors(pfoms, k=40, seed=2)
    _, tmus = _mus(3, 2)

    def bad_alpha(mu):
        return mu["diffusion"].sum(dim=-1) * 0.0 - 1.0

    with pytest.raises(ValueError, match="not positive"):
        tm.pod_greedy(tf, tred, tmus, max_extensions=2, coercivity=bad_alpha, log_level=30)
    cn = tm.instationary_thermal_block((2, 2), 6, T=0.5, nt=4, time_theta=0.4,
                                       device="cpu")
    with pytest.raises(ValueError, match="time_theta"):
        tm.pod_greedy(cn, tm.InstationaryReductor(cn, embedding=GaussianEmbedding.make(
            cn.solution_dim, range_dim=10, device="cpu"), log_level=30), tmus,
            max_extensions=2, coercivity=bad_alpha, log_level=30)
    with pytest.raises(ValueError, match="embedding"):
        tm.pod_greedy(tf, tm.InstationaryReductor(tf, log_level=30), tmus, log_level=30)


def test_mean_value_output_rejects_nonuniform():
    """``_mean_value_output`` derives the affine row from output(ones); a
    non-uniform functional is caught by the one-hot probes, a homogeneous
    nonlinear one (sum(u^2) / n, which passes one one-hot check) by the
    homogeneity probe."""
    from rla4mor_tpu_torch.models.instationary_stencil import _mean_value_output

    class _St:
        dtype, device = torch.float64, torch.device("cpu")

        def output(self, u):
            return (torch.arange(1.0, 17.0, dtype=torch.float64).reshape(4, 4) * u).sum()

    class _StSq(_St):
        def output(self, u):
            return (u * u).sum() / 16.0

    for st in (_St(), _StSq()):
        fom = type("_Fom", (), {"stencil": st, "solution_shape": (4, 4)})()
        with pytest.raises(NotImplementedError, match="uniform-weight"):
            _mean_value_output(fom)


def _interior(nx):
    return jm.ThermalBlockFOM((2, 2), nx).interior


def test_stencil_fom_matches_jax_and_host():
    """2-D stencil FOM, Jacobi-CG and the port's MG-CG (tol 1e-12), against
    the JAX package's host LU trajectory (1e-8 of the scale; the JAX cycle
    is not the port's, so never against its MG iterations), implicit Euler
    and Crank-Nicolson; ``store_every`` subsamples; the flat view's output
    row is ``st.output``."""
    nx, nt = 16, 10
    jmus, tmus = _mus(1, 4)
    st = StencilThermalBlock((2, 2), nx, dtype=torch.float64, device="cpu")
    interior = _interior(nx)
    for theta in (1.0, 0.5):
        host = np.asarray(jm.instationary_thermal_block(
            (2, 2), nx, T=0.5, nt=nt, time_theta=theta).solve(jmus[0]))
        scale = np.abs(host).max()
        td = tm.InstationaryStencilFOM(st, T=0.5, nt=nt, time_theta=theta)
        for precond, maxiter in (("jacobi", 500), ("mg", 200)):
            tt = td.solve(tmus[0], tol=1e-12, maxiter=maxiter, precond=precond)
            assert np.abs(tt.reshape(-1, nt + 1).numpy()[interior] - host).max() \
                < 1e-8 * scale, (theta, precond)
        assert max(td.solve_log[-1]["iters"]) < 20  # the mesh-independent cycle
    td = tm.InstationaryStencilFOM(st, T=0.5, nt=nt)
    tt = td.solve(tmus[0], tol=1e-12, maxiter=500)
    ts = td.solve(tmus[0], tol=1e-12, maxiter=500, store_every=5)
    assert ts.shape[-1] == nt // 5 + 1
    assert float((ts[:, :, 1] - tt[:, :, 5]).abs().max()) < 1e-10 * float(tt.abs().max())
    with pytest.raises(ValueError, match="store_every"):
        td.solve(tmus[0], store_every=3)
    view = td.as_reductor_fom(tol=1e-12, maxiter=500, store_every=5)
    traj = view.solve(tmus[0])
    assert traj.shape == ((nx + 1) ** 2, 3)
    outs = view.output_functional.apply(traj, tmus[0])[0]
    assert rel(outs, st.output(traj.T.reshape(-1, *st.solution_shape))) < 1e-14


def test_stencil_fom_3d_matches_jax():
    """3-D stencil FOM (lumped-mass hooks, Jacobi-CG) at grid 7 against the
    JAX trajectory; the Dirichlet shell stays zero; MG is refused."""
    js = JaxStencil3D((2, 2, 2), 7, dtype=jnp.float64)
    ts = StencilThermalBlock3D((2, 2, 2), 7, dtype=torch.float64, device="cpu")
    jd, td = jm.InstationaryStencilFOM(js, T=0.25, nt=8), tm.InstationaryStencilFOM(
        ts, T=0.25, nt=8)
    rows = np.random.RandomState(3).uniform(0.1, 1.0, size=8)
    jt = np.asarray(jd.solve({"diffusion": jnp.asarray(rows)}, tol=1e-12, maxiter=500))
    tt = td.solve({"diffusion": torch.tensor(rows)}, tol=1e-12, maxiter=500)
    assert tt.shape == (8, 8, 8, 9)
    assert np.abs(tt.numpy() - jt).max() < 1e-8 * np.abs(jt).max()
    assert float(tt[0].abs().max()) == 0.0 and float(tt[:, :, -1].abs().max()) == 0.0
    with pytest.raises(ValueError, match="2-D"):
        td.solve({"diffusion": torch.tensor(rows)}, precond="mg")


@pytest.mark.parametrize("dim", [2, 3])
def test_eim_parabolic_composition_matches_jax(dim):
    """``InstationaryStencilFOM`` over the port's EIM surrogate (2-D grid 16,
    3-D grid 7, the lumped-mass hooks forwarded) against the JAX composition
    on the same interpolant (the port's fit, written by the port's saver and
    read by the JAX package's; Jacobi-CG tol 1e-11: 1e-8 of the scale); the
    surrogate tracks the exact non-affine parabolic FOM; POD-greedy runs on
    its flat view (the EIM coefficients' affine operator)."""
    import tempfile

    from rla4mor_tpu.models import stencil_nonaffine as jna
    from rla4mor_tpu.mor.serialization import load_eim_interpolant as jax_load_eim

    from rla4mor_tpu_torch.models import stencil_nonaffine as tna

    if dim == 2:
        jx = jna.gaussian_bump_fom(num_intervals=16, dtype=jnp.float64)
        tx = tna.gaussian_bump_fom(num_intervals=16, dtype=torch.float64, device="cpu")
        count, nt = 4, 8
    else:
        kw = {"center_range": (0.4, 0.6), "width_range": (0.25, 0.4)}
        jx = jna.gaussian_bump_fom3d(num_intervals=7, dtype=jnp.float64, **kw)
        tx = tna.gaussian_bump_fom3d(num_intervals=7, dtype=torch.float64, device="cpu",
                                     **kw)
        count, nt = 3, 6
    train = tx.parameter_space.sample_uniformly(count, device="cpu", dtype=torch.float64)
    te = tm.EimStencilFOM.from_training(tx, train, tol=1e-4, reserve=2)
    with tempfile.TemporaryDirectory() as td:
        tmor.save_eim_interpolant(te.interpolant, f"{td}/eim.npz")
        je = jm.EimStencilFOM(jx, jax_load_eim(f"{td}/eim.npz"), te.kappa_floor)
    assert hasattr(te, "mass_apply_grid") == (dim == 3)
    p_eim = tm.InstationaryStencilFOM(te, T=0.25, nt=nt)
    assert p_eim.parameter_space is tx.parameter_space
    row = np.random.RandomState(7).uniform(0.0, 1.0, size=dim + 1)
    jt = np.asarray(jm.InstationaryStencilFOM(je, T=0.25, nt=nt).solve(
        {"bump": jnp.asarray(row)}, tol=1e-11, maxiter=3000))
    mu = {"bump": torch.tensor(row)}
    tt = p_eim.solve(mu, tol=1e-11, maxiter=3000)
    assert np.abs(tt.numpy() - jt).max() < 1e-8 * np.abs(jt).max()
    exact = tm.InstationaryStencilFOM(tx, T=0.25, nt=nt).solve(mu, tol=1e-11, maxiter=3000)
    assert rel(tt, exact) < 8e-2
    view = p_eim.as_reductor_fom(tol=1e-10, maxiter=1000)
    red = tm.InstationaryReductor(view, embedding=GaussianEmbedding.make(
        view.solution_dim, range_dim=80, seed=2, device="cpu"), log_level=30)
    rom, hist = tm.pod_greedy(view, red, tx.sample_parameters(6, key=13), max_extensions=3,
                              modes_per_extension=2, log_level=30)
    assert hist["max_estimates"][-1] < hist["max_estimates"][0]
    assert torch.isfinite(rom.estimate_error(mu))


@pytest.fixture
def jitted_jax_projection(monkeypatch):
    """The JAX reductor projects the stencil view eagerly, one compile per
    operation and basis size: the same function jitted here, one compile a
    basis size. Its values are the eager ones up to rounding."""
    import rla4mor_tpu.models.instationary as jinst

    orig, cache = jinst.project_time_system, {}

    def projected(fom, V, product, embedding):
        key = (id(fom), id(product), id(embedding))
        if key not in cache:
            cache[key] = jax.jit(lambda V: orig(fom, V, product, embedding))
        return cache[key](V)

    monkeypatch.setattr(jinst, "project_time_system", projected)


def test_large_scale_parabolic_demo_matches_jax_flow(jitted_jax_projection):
    """``large_scale_parabolic_demo.run`` at grid 16, nt 10 (Jacobi-CG on
    both sides: the JAX MG cycle is not the port's; 2 extensions) against
    the JAX demo's flow on the same streamed Gaussian Omega and the JAX
    draws: the picks, max estimates to 1e-8, the held-out error and
    estimate to 1e-8; one block sketch a ``reduce()``; the estimate within
    [0.5, 2] of the exact l2 space-time residual; the served batch equals
    per-parameter solves. With ``bounds``: the l2 anchor (Jacobi-CG inverse
    iteration, as the JAX demo) equals the dense lambda_min(A(1) | interior)
    to 1e-7 on its safe side, certified, and the final-time bound is at
    least the measured M-norm error. About 10 s: the JAX stencil reductor
    compiles at every basis size."""
    from rla4mor_tpu.ops import StreamedGaussianEmbedding as JaxStreamed

    from rla4mor_tpu_torch.examples import large_scale_parabolic_demo as demo

    ext = 2
    dev = jm.InstationaryStencilFOM(JaxStencil((2, 2), 16, dtype=jnp.float64), T=1.0, nt=10)
    view = dev.as_reductor_fom(tol=1e-6, maxiter=1500, precond="jacobi", store_every=1)
    theta = JaxStreamed.make(view.solution_dim, range_dim=128, seed=0)
    red = jm.InstationaryReductor(view, embedding=theta, log_level=30)
    train = view.parameter_space.sample_randomly(12, key=1)
    rom, hist = jm.pod_greedy(view, red, train, max_extensions=ext, pad_to=ext, log_level=30)
    mu_t = view.parameter_space.sample_randomly(1, key=5)[0]
    traj_r, eta = _jax_solve_batch(rom, [mu_t])
    truth = np.asarray(view.solve(mu_t))
    jrel = np.linalg.norm(np.asarray(red.reconstruct(traj_r[0])) - truth) / np.linalg.norm(
        truth)

    omega = np.asarray(theta.random_matrix())
    res = demo.run(grid=16, nt=10, ext=ext, k=128, precond="jacobi",
                   embedding=lambda n, k: StreamedGaussianEmbedding.from_matrix(
                       omega, device="cpu"),
                   train=_to_torch(train), test=_to_torch([mu_t]), device="cpu",
                   bounds=True, log=lambda line: None)
    assert res["n"] == 289 and res["store_every"] == 1 and res["basis"] == ext
    assert res["reduce_calls"] == ext + 1
    assert _same_mus(res["selected_mus"], hist["selected_mus"])
    assert rel(res["max_estimates"], hist["max_estimates"]) < 1e-8
    held = res["held_out"][0]
    assert abs(held["rel_err"] - jrel) < 1e-8 * jrel
    assert abs(held["estimate"] - float(eta[0])) < 1e-8 * float(eta[0])
    assert 0.5 <= held["est_over_exact"] <= 2.0
    assert res["serve_dev"] < 1e-12 and res["solver"]["breakdowns"] == 0
    st = res["fom"].stencil
    n = st.n_nodes ** 2
    A = st.apply({"diffusion": torch.ones(4, dtype=torch.float64)},
                 torch.eye(n, dtype=torch.float64).reshape(n, *st.solution_shape))
    inner = st.rhs().reshape(-1) > 0
    lam = float(torch.linalg.eigvalsh(A.reshape(n, n)[inner][:, inner])[0])
    alpha = res["bounds"]["alpha_ref"]
    assert res["bounds"]["certified"] and alpha <= lam and lam - alpha < 1e-7 * lam
    assert held["bound"] >= held["error_M"] > 0


def test_instationary_demo_matches_jax_flow(jax_demo):
    """``instationary_demo.run`` at grid 12 against the JAX demo's flow on
    the same Omegas (seed 0 and its dual at seed 77) and the JAX draws: the
    POD-greedy estimates, held-out estimates and certified bounds, the
    output greedy's indicators and the corrected output (1e-8); each bound
    at least the measured final-time M-norm error; the corrected output
    beats the plain one."""
    from rla4mor_tpu_torch.examples import instationary_demo as demo

    omegas = jax_demo["omegas"]
    res = demo.run(grid=GRID, nt=NT, extensions=EXT, pd_extensions=PD_EXT, device="cpu",
                   train=_to_torch(jax_demo["train"]),
                   test=_to_torch(jax_demo["test"]), log=lambda line: None,
                   embedding=lambda n, k, sq, seed: GaussianEmbedding.from_matrix(
                       omegas[seed], sqrt_product=sq, device="cpu"))
    assert _same_mus(res["selected_mus"], jax_demo["hist"]["selected_mus"])
    assert rel(res["max_estimates"], jax_demo["hist"]["max_estimates"]) < 1e-8
    assert rel(res["estimates"], jax_demo["eta"]) < 1e-8
    assert rel(res["bounds"], jax_demo["bounds"]["final"]) < 1e-8
    assert all(e <= b for e, b in zip(res["final_errors"], res["bounds"]))
    assert max(res["rel_errors"]) < 0.2
    assert _same_mus(res["pd_selected_mus"], jax_demo["hist_pd"]["selected_mus"])
    np.testing.assert_allclose(res["max_indicators"], jax_demo["hist_pd"]["max_indicators"],
                               rtol=1e-8)
    assert abs(res["s_corrected"] - jax_demo["s_c"]) < 1e-8 * abs(jax_demo["s_c"])
    assert abs(res["indicator"] - jax_demo["eta_s"]) < 1e-8 * jax_demo["eta_s"]
    assert res["err_corrected"] <= res["err_plain"]
