"""The port's primal-dual layers held against the JAX package (f64, CPU):
the stationary corrected output (``mor/primal_dual.py``, on the
non-symmetric advection-diffusion FOM), the parabolic discrete-adjoint
corrected output (``models/instationary_primal_dual.py``, on the thermal
block with a localized output), serving's dispatch of every ROM kind, the
ROM files of the JAX package read by the port, and the time-dependent
reductors' checkpoints.

The Gaussian Omegas (primal and dual) are carried from the JAX side, the
parameters drawn with numpy. The online sketch is the identity on both
sides. The JAX sweeps run with ``pad_to`` and the JAX ROMs are evaluated by
jitted calls (an eager ``lax.scan`` compiles at every call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.models as jm
import rla4mor_tpu.mor as jmor
import rla4mor_tpu.serve as jserve
from rla4mor_tpu.core.affine import AffineDense as JaxAffineDense
from rla4mor_tpu.core.parameters import ONE as JONE
from rla4mor_tpu.mor.serialization import save_instationary_reductor as jax_save_red
from rla4mor_tpu.mor.serialization import save_rom as jax_save_rom
from rla4mor_tpu.ops import GaussianEmbedding as JaxGaussian

import rla4mor_tpu_torch.models as tm
import rla4mor_tpu_torch.mor as tmor
from rla4mor_tpu_torch import serve as tserve
from rla4mor_tpu_torch.core import ONE, AffineDense, mu_stack, pod
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

NX, NT, K = 8, 10, 120


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _carry(jemb, sqrt_product):
    return GaussianEmbedding.from_matrix(np.asarray(jemb.random_matrix()),
                                         sqrt_product=sqrt_product, device="cpu")


def _heat_mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _adv_mus(count, seed):
    rs = np.random.RandomState(seed)
    eps, vel = rs.uniform(0.05, 1.0, (count, 1)), rs.uniform(-1.0, 1.0, (count, 2))
    return ([{"eps": jnp.asarray(e), "velocity": jnp.asarray(v)} for e, v in zip(eps, vel)],
            [{"eps": torch.tensor(e), "velocity": torch.tensor(v)} for e, v in zip(eps, vel)])


def _localized(fom, device=None):
    """The mean over the lower-left 3x3 interior patch (non-compliant)."""
    w = np.zeros((NX - 1, NX - 1))
    w[:3, :3] = 1.0
    stack = w.reshape(1, 1, -1) / w.sum()
    if device is None:
        fom.output_functional = JaxAffineDense(jnp.asarray(stack), (JONE,))
    else:
        fom.output_functional = AffineDense(torch.tensor(stack), (ONE,))
    return fom


def _jax_batch(mus):
    return {k: jnp.stack([m[k] for m in mus]) for k in mus[0]}


@pytest.fixture(scope="module")
def heat():
    """Both packages' parabolic thermal block (grid 8, nt 10) with the
    localized output, the carried primal / dual Omegas, and the JAX output
    greedy (2 extensions of 2 modes, pad_to 4) with its reductor and final
    ROM."""
    jf = _localized(jm.instationary_thermal_block((2, 2), NX, T=0.5, nt=NT))
    tf = _localized(tm.instationary_thermal_block((2, 2), NX, T=0.5, nt=NT, device="cpu"),
                    device="cpu")
    jRu, tRu = jf.products["h1_0"], tf.products["h1_0"]
    je = JaxGaussian.make(jf.solution_dim, sqrt_product=jRu.sqrt, range_dim=K, seed=3)
    jdual = je.with_seed(80)
    te, tdual = _carry(je, tRu.sqrt), _carry(jdual, tRu.sqrt)
    jmus, tmus = _heat_mus(8, 1)
    jred = jm.InstationaryPrimalDualReductor(jf, embedding=je, product=jRu, log_level=30)
    jrom, jhist = jm.output_pod_greedy(jf, jred, jmus[:6], max_extensions=2,
                                       modes_per_extension=2, pad_to=4, log_level=30)
    return {"jf": jf, "tf": tf, "je": je, "te": te, "tdual": tdual, "jmus": jmus,
            "tmus": tmus, "jred": jred, "jrom": jrom, "jhist": jhist}


def _port_reductor(heat, kind="final"):
    tf = heat["tf"]
    return tm.InstationaryPrimalDualReductor(tf, embedding=heat["te"],
                                             embedding_dual=heat["tdual"],
                                             product=tf.products["h1_0"],
                                             output_kind=kind, log_level=30)


def test_discrete_adjoint_matches_jax(heat):
    """``solve_dual`` equals the JAX adjoint (1e-12), both kinds; with the
    zero ROM trajectory (u0 = 0) the summation-by-parts identity gives
    s = dt sum_k z_k^H b exactly."""
    jf, tf = heat["jf"], heat["tf"]
    jmu, tmu = heat["jmus"][7], heat["tmus"][7]
    for kind in ("final", "integral"):
        z = tm.solve_dual(tf, tmu, output_kind=kind)
        assert z.shape == (tf.solution_dim, NT)
        assert rel(z, jm.solve_dual(jf, jmu, output_kind=kind)) < 1e-12
    outs = tf.output_functional.apply(tf.solve(tmu), tmu)[0]
    z = tm.solve_dual(tf, tmu).numpy()
    s_dual = tf.dt * np.sum(z * tf.assemble_rhs(tmu)[:, None])
    assert abs(float(outs[-1]) - s_dual) < 1e-12 * abs(s_dual)
    with pytest.raises(ValueError, match="output_kind"):
        tm.solve_dual(tf, tmu, output_kind="mean")


def test_corrected_output_matches_jax(heat):
    """The goal-oriented POD-greedy picks the JAX parameters with the same
    indicators (1e-10), padded and unpadded; the final ROM's plain and
    corrected outputs and indicator equal the JAX ones (1e-10) at 3
    held-out parameters, one batched call; the correction beats the plain
    output; padded (primal and dual) equals live-size."""
    jhist = heat["jhist"]
    for pad_to in (4, None):
        red = _port_reductor(heat)
        rom, hist = tm.output_pod_greedy(heat["tf"], red, heat["tmus"][:6],
                                         max_extensions=2, modes_per_extension=2,
                                         pad_to=pad_to, log_level=30)
        assert [float(m["diffusion"][0]) for m in hist["selected_mus"]] == \
            [float(m["diffusion"][0]) for m in jhist["selected_mus"]]
        assert rel(hist["max_indicators"], jhist["max_indicators"]) < 1e-10
    assert (red.primal.basis_size, red.dual_basis_size) == (4, 4)
    jrom = heat["jrom"]
    batch = mu_stack(heat["tmus"][5:8])
    s_c, eta = rom.output_corrected(batch)
    js_c, jeta = jax.jit(jax.vmap(jrom.output_corrected))(_jax_batch(heat["jmus"][5:8]))
    assert rel(s_c, js_c) < 1e-10 and rel(eta, jeta) < 1e-10
    plain = rom.output_plain(batch)
    assert rel(plain, jax.jit(jax.vmap(jrom.output_plain))(
        _jax_batch(heat["jmus"][5:8]))) < 1e-10
    tf, tmu = heat["tf"], heat["tmus"][5]
    s = float(tf.output_functional.apply(tf.solve(tmu), tmu)[0, -1])
    assert abs(float(s_c[0]) - s) < 0.1 * abs(float(plain[0]) - s)
    rom_p = red.reduce(pad_to=7, pad_dual_to=6)
    sp, ep = rom_p.output_corrected(batch)
    assert rel(sp, s_c) < 1e-12 and rel(ep, eta) < 1e-10


@pytest.mark.parametrize("kind", ["final", "integral"])
def test_correction_exact_in_the_dual_limit(heat, kind):
    """With the exact adjoint trajectory in the dual basis the corrected
    output is exact (1e-12) and the dual indicator vanishes, whatever the
    coarse primal basis; with the primal trajectory spanned, exact too; the
    JAX output of the same bases agrees (1e-10)."""
    tf, tmu = heat["tf"], heat["tmus"][4]
    traj = tf.solve(tmu)
    outs = tf.output_functional.apply(traj, tmu)[0]
    s = float(tf.dt * outs[1:].sum()) if kind == "integral" else float(outs[-1])
    red = _port_reductor(heat, kind)
    red.extend_primal(pod(traj, product=tf.products["h1_0"], modes=2)[0])
    red.extend_dual(tm.solve_dual(tf, tmu, output_kind=kind))
    rom = red.reduce()
    s_c, eta = rom.output_corrected(tmu)
    assert abs(float(rom.output_plain(tmu)) - s) > 1e-8
    assert abs(float(s_c) - s) < 1e-12 * max(1.0, abs(s)) and float(eta) < 1e-10
    assert rom.output_kind == kind
    jf, jmu = heat["jf"], heat["jmus"][4]
    jred = jm.InstationaryPrimalDualReductor(jf, embedding=heat["je"],
                                             product=jf.products["h1_0"],
                                             output_kind=kind, log_level=30)
    jred.extend_primal(jnp.asarray(red.primal.rb.numpy()))
    jred.extend_dual(jm.solve_dual(jf, jmu, output_kind=kind))
    assert abs(float(jax.jit(jred.reduce().output_corrected)(jmu)[0]) - float(s_c)) \
        < 1e-10 * abs(s)
    red2 = _port_reductor(heat, kind)
    red2.extend_primal(traj[:, 1:])
    red2.extend_dual(pod(tm.solve_dual(tf, tmu, output_kind=kind),
                         product=tf.products["h1_0"], modes=2)[0])
    assert abs(float(red2.reduce().output_corrected(tmu)[0]) - s) < 1e-12 * max(1.0, abs(s))


def test_output_bound_and_refusals(heat):
    """The output bound of implicit Euler is eta_pr eta_du / alpha_LB and
    refuses Crank-Nicolson; a reductor without embeddings, a multi-output
    functional and an unknown kind are refused."""
    tf = heat["tf"]
    red = _port_reductor(heat)
    red.extend(heat["tmus"][0], modes_per_extension=2)
    rom = red.reduce()
    coer = tmor.MinThetaCoercivity(tf, {"diffusion": torch.full((4,), 0.55,
                                                                dtype=torch.float64)},
                                   product=tf.products["h1_0"])
    tmu = heat["tmus"][6]
    s_c, bound = tmor.parabolic_output_error_bound(rom, tmu, coer)
    s_c2, ind = rom.output_corrected(tmu)
    assert float(s_c) == float(s_c2) and abs(float(bound) - float(ind) / float(coer(tmu))) \
        < 1e-14 * float(bound)
    rom.rom_pr.time_theta = 0.5
    with pytest.raises(ValueError, match="implicit Euler"):
        tmor.parabolic_output_error_bound(rom, tmu, coer)
    bare = tm.InstationaryPrimalDualReductor(tf, product=tf.products["h1_0"], log_level=30)
    with pytest.raises(ValueError, match="embeddings"):
        tm.output_pod_greedy(tf, bare, heat["tmus"][:2], max_extensions=2, log_level=30)
    multi = tm.instationary_thermal_block((2, 2), 6, T=0.5, nt=4, device="cpu")
    multi.output_functional = AffineDense(torch.ones((1, 2, multi.solution_dim),
                                                     dtype=torch.float64), (ONE,))
    with pytest.raises(ValueError, match="single outputs"):
        tm.InstationaryPrimalDualReductor(multi, log_level=30)
    with pytest.raises(ValueError, match="output_kind"):
        _port_reductor(heat, "mean")


@pytest.fixture(scope="module")
def adv():
    """The stationary primal-dual layer on both sides: the advection-diffusion
    FOM (12 intervals), Gaussian k = 100 over the h1_0 square root (dual:
    seed 77), and the JAX output greedy (2 extensions over 8 parameters)
    with its final ROM."""
    jf = jm.AdvectionDiffusionFOM(num_intervals=12)
    tf = tm.AdvectionDiffusionFOM(num_intervals=12, device="cpu")
    je = JaxGaussian.make(jf.solution_dim, sqrt_product=jf.h1_0_product.sqrt, range_dim=100,
                          seed=0)
    jdual = je.with_seed(77)
    te, tdual = _carry(je, tf.h1_0_product.sqrt), _carry(jdual, tf.h1_0_product.sqrt)
    jmus, tmus = _adv_mus(10, 3)
    jred = jmor.PrimalDualReductor(jf, embedding_primal=je, product=jf.h1_0_product,
                                   log_level=30)
    jrom, jhist = jmor.output_greedy(jf, jred, jmus[:8], max_extensions=2, log_level=30)
    return {"jf": jf, "tf": tf, "te": te, "tdual": tdual, "jmus": jmus, "tmus": tmus,
            "jrom": jrom, "jhist": jhist}


def _port_stationary(adv):
    tf = adv["tf"]
    return tmor.PrimalDualReductor(tf, embedding_primal=adv["te"],
                                   embedding_dual=adv["tdual"], product=tf.h1_0_product,
                                   log_level=30)


def test_stationary_corrected_output_matches_jax(adv):
    """``dual_fom`` is the adjoint; ``output_greedy`` picks the JAX
    parameters with the same indicators (1e-10); the final corrected output
    and indicator equal the JAX ones (1e-10), batched; the online
    correction is the dense z_r^H (b - A V u_r)."""
    tf = adv["tf"]
    dual = tmor.dual_fom(tf)
    tmu = adv["tmus"][9]
    assert np.allclose(dual.assemble_sparse(tmu).toarray(),
                       tf.assemble_sparse(tmu).toarray().T, atol=1e-14)
    red = _port_stationary(adv)
    rom, hist = tmor.output_greedy(tf, red, adv["tmus"][:8], max_extensions=2,
                                   log_level=30)
    jhist = adv["jhist"]
    assert [float(m["eps"][0]) for m in hist["selected_mus"]] == \
        [float(m["eps"][0]) for m in jhist["selected_mus"]]
    assert rel(hist["max_indicators"], jhist["max_indicators"]) < 1e-10
    batch = mu_stack(adv["tmus"][7:10])
    s_c, eta = rom.output_corrected(batch)
    js_c, jeta = jax.jit(jax.vmap(adv["jrom"].output_corrected))(
        _jax_batch(adv["jmus"][7:10]))
    assert rel(s_c, js_c) < 1e-10 and rel(eta, jeta) < 1e-10
    u_r, z_r = rom.rom_pr.solve(tmu), rom.rom_du.solve(tmu)
    V, Z = red.primal.rb.numpy(), red.dual.rb.numpy()
    b = tf.assemble_rhs(tmu)
    dense = (Z @ z_r.numpy()) @ (b - tf.assemble_sparse(tmu) @ (V @ u_r.numpy()))
    assert abs(float(rom.output_corrected(tmu)[0] - rom.output_plain(tmu)) - dense) \
        < 1e-9 * abs(dense)


def test_serving_and_jax_rom_files(heat, adv, tmp_path):
    """Every ROM kind the JAX package ships (stationary, instationary, both
    corrected-output composites) is written by its ``save_rom``, read by the
    port's ``load_rom`` and served: ``evaluate_batch`` equals
    ``rla4mor_tpu.serve.serve_batch`` on the JAX ROM (1e-12); the port's own
    files round-trip."""
    jheat, jadv = heat["jrom"], adv["jrom"]
    roms = {"instationary_corrected_output": (jheat, heat["jmus"], heat["tmus"]),
            "instationary": (jheat.rom_pr, heat["jmus"], heat["tmus"]),
            "corrected_output": (jadv, adv["jmus"], adv["tmus"]),
            "stationary": (jadv.rom_pr, adv["jmus"], adv["tmus"])}
    for kind, (jrom, jmus, tmus) in roms.items():
        path = tmp_path / f"{kind}.npz"
        jax_save_rom(jrom, path)
        trom = tmor.load_rom(path, device="cpu")
        jout = jserve.serve_batch(jrom, _jax_batch(jmus[4:8]))
        tout = tserve.evaluate_batch(trom, mu_stack(tmus[4:8]))
        assert set(tout) == set(jout), kind
        for key in tout:
            assert rel(tout[key], jout[key]) < 1e-12, (kind, key)
        tmor.save_rom(trom, tmp_path / f"{kind}_port.npz")
        again = tserve.serve_batch(tmor.load_rom(tmp_path / f"{kind}_port.npz",
                                                 device="cpu"), mu_stack(tmus[4:8]))
        for key in tout:
            assert torch.equal(again[key], tout[key]), (kind, key)
    assert tserve.evaluate(tmor.load_rom(tmp_path / "instationary.npz", device="cpu"),
                           heat["tmus"][0])["u"].shape == (jheat.rom_pr.dim, NT + 1)


def test_reductor_checkpoints_round_trip_and_resume(heat, tmp_path):
    """``save_instationary_reductor`` / ``save_primal_dual_reductor``: a
    loaded reductor reduces to the same ROM and a POD-greedy run resumes
    from it; another seed, another output kind and the JAX package's
    checkpoint (its seeds name other operators) are refused."""
    tf = heat["tf"]
    red = tm.InstationaryReductor(tf, embedding=heat["te"], product=tf.products["h1_0"],
                                  log_level=30)
    rom, _ = tm.pod_greedy(tf, red, heat["tmus"][:6], max_extensions=2, log_level=30)
    tmor.save_instationary_reductor(red, tmp_path / "red.npz")
    again = tm.InstationaryReductor(tf, embedding=heat["te"], product=tf.products["h1_0"],
                                    log_level=30)
    tmor.load_instationary_reductor_state(again, tmp_path / "red.npz")
    mu = heat["tmus"][7]
    assert torch.equal(again.reduce().solve(mu), rom.solve(mu))
    rom2, hist = tm.pod_greedy(tf, again, heat["tmus"][:6], max_extensions=2, log_level=30)
    assert again.basis_size == 4 and hist["max_estimates"][0] < rom.estimate_error(
        mu_stack(heat["tmus"][:6])).max()
    other = tm.InstationaryReductor(tf, embedding=heat["te"].with_seed(5), log_level=30)
    with pytest.raises(ValueError, match="seed_embedding"):
        tmor.load_instationary_reductor_state(other, tmp_path / "red.npz")
    jax_save_red(heat["jred"].primal, tmp_path / "jax.npz")
    with pytest.raises(ValueError, match="seed derivation 'tile-v1'"):
        tmor.load_instationary_reductor_state(again, tmp_path / "jax.npz")

    pd = _port_reductor(heat)
    for m in heat["tmus"][:2]:
        pd.extend(m, modes_per_extension=2)
    tmor.save_primal_dual_reductor(pd, tmp_path / "pd.npz")
    pd2 = _port_reductor(heat)
    tmor.load_primal_dual_reductor_state(pd2, tmp_path / "pd.npz")
    assert torch.equal(pd2.reduce().output_corrected(mu)[0], pd.reduce().output_corrected(mu)[0])
    with pytest.raises(ValueError, match="output_kind"):
        tmor.load_primal_dual_reductor_state(_port_reductor(heat, "integral"),
                                             tmp_path / "pd.npz")
