"""The port's DoF-sharded path on 4 gloo ranks (CPU, float64), held against
the JAX package and the port's one-device paths.

One module-scoped spawn of 4 ranks runs every case
(``tests/torch_parallel_ranks.py``, which imports no JAX) while this process
builds the JAX references; the tests compare. Tolerances: 1e-12 relative for
the sketches (the shares' sums run in another order), 1e-13 for the slab
applies (the same operations on the same values), 1e-10 for the sharded
CG / BiCGStab iterates (all-reduced inner products round differently), 1e-9
for two greedy steps against the JAX step on a 4-device mesh and against
the port's mesh-less step (CG to 1e-10, then Gram-Schmidt and the sketched
solves amplify the iterates' rounding), 1e-9 for the sharded LOBPCG's Ritz
values and the SCM anchor against the unsharded runs. The time loops on the
DoF slabs (the parabolic 2-D, 3-D and advection loops, the Newmark loop,
Newton and IMEX) are held to 1e-9 of the JAX package's unsharded runs and
1e-10 of the port's one-device runs (solves to 1e-11 / 1e-12: the sharded
inner products round in another order), ``gram_schmidt`` / ``pod`` with
``group=`` to 1e-10 of the unsharded factors, and POD-greedy on the
("dof", "mu") = (2, 2) mesh picks the JAX unsharded run's parameters with
its basis within 1e-8 (each column up to its sign: the eigenvector
conventions of the two libraries' ``eigh`` differ).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from rla4mor_tpu.models.stencil import StencilThermalBlock as JaxStencil
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan
from rla4mor_tpu.parallel import flat_shard_rows as jax_flat_shard_rows
from rla4mor_tpu.parallel import make_sharded_greedy_step as jax_make_step
from rla4mor_tpu.parallel import sharded_sketch as jax_sharded_sketch
from rla4mor_tpu.parallel import srht_blocked as jax_srht_blocked

import torch_parallel_ranks as cases
from rla4mor_tpu.core.affine import AffineDense as JaxAffineDense
from rla4mor_tpu.models import InstationaryStencilFOM as JaxInstationaryStencil
from rla4mor_tpu.models import StencilAdvectionDiffusion as JaxAdvection
from rla4mor_tpu.models import WaveStencilFOM as JaxWave
from rla4mor_tpu.models import instationary as jax_instationary
from rla4mor_tpu.models.semilinear import SemilinearInstationaryFOM as JaxImex
from rla4mor_tpu.models.semilinear import SemilinearStencilFOM as JaxSemilinear
from rla4mor_tpu.models.stencil3d import StencilThermalBlock3D as JaxStencil3D
from rla4mor_tpu.ops import SrhtEmbedding as JaxSrht
from rla4mor_tpu_torch.core.solvers import bicgstab, cg
from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
from rla4mor_tpu_torch.models.stencil_advection import StencilAdvectionDiffusion
from rla4mor_tpu_torch.mor.scm_matfree import lobpcg_gen
from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding, SrhtEmbedding
from rla4mor_tpu_torch.ops.fwht import _srht_plan
from rla4mor_tpu_torch.ops.srht_cuda import srht_onepass, srht_onepass_plain
from rla4mor_tpu_torch.parallel import (
    ShardedGaussianEmbedding,
    ShardedSrhtEmbedding,
    gaussian_sketch_blocked,
    make_sharded_greedy_step,
    srht_blocked,
)
from rla4mor_tpu_torch.parallel.launch import _device_of, spawn
from rla4mor_tpu_torch.parallel.sharded_sketch import srht_partial

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

RANKS = 4
FACTOR_N, FACTOR_R = 1024, 7             # gram_schmidt / pod (tests/test_parallel.py)
GREEDY_SEED, GREEDY_TRAIN = 21, 8
GAUSS_N, GAUSS_K, SRHT_K = 512, 24, 32
SRHT_NS = (1024, 999)   # a power of two, and an odd n padded to the flat layout
LAYOUT_NS = (1, 289, 999, 2048, 2049, 4198401)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _inputs():
    rs = np.random.RandomState(0)
    key_theta = jax.random.fold_in(jax.random.key(0), 0)
    n = (cases.GRID + 1) ** 2
    signs, sampling, _ = jax_srht_plan(key_theta, n, cases.K)
    srht = {}
    for m in SRHT_NS:
        s, p, _ = jax_srht_plan(jax.random.key(m), m, SRHT_K)
        srht[m] = (rs.normal(size=(m, 3)), np.array(s), np.array(p))
    # a pencil whose two smallest eigenvalues stand apart (LOBPCG converges in
    # a few iterations: every iteration is a dozen collectives)
    q, _ = np.linalg.qr(rs.normal(size=(32, 32)))
    b = rs.normal(size=(32, 32))
    lam = np.concatenate([[0.5], np.linspace(5.0, 6.0, 31)])
    return {
        "gauss_x": rs.normal(size=(GAUSS_N, 3)), "gauss_k": GAUSS_K,
        "gauss_v": rs.normal(size=(GAUSS_K, 2)), "srht": srht, "layout_ns": LAYOUT_NS,
        "grid": rs.normal(size=(cases.GRID + 1,) * 2),
        "mu_thermal": rs.uniform(0.1, 1.0, size=4), "eps": np.array([0.3]),
        "velocity": np.array([0.5, -0.4]),
        "plan_signs": np.array(signs), "plan_sampling": np.array(sampling),
        "mus": rs.uniform(0.1, 1.0, size=(cases.STEPS, 4)),
        "batch": rs.uniform(0.1, 1.0, size=(8, 4)),
        "T": (q * lam) @ q.T, "R": 0.01 * (b @ b.T) + np.eye(32),
        **_time_inputs(),
    }


def _time_inputs() -> dict:
    """The time loops' parameters, the factorisations' block and the
    POD-greedy's training set and JAX SRHT plan (of its embedding's seed)."""
    rs = np.random.RandomState(20)
    semi = ("diffusion", 4), ("reaction", 1)
    mus = {
        "parabolic": {"diffusion": rs.uniform(0.1, 1.0, 4)},
        "parabolic3d": {"diffusion": rs.uniform(0.1, 1.0, 8)},
        "advection": {"eps": rs.uniform(0.05, 1.0, 1), "velocity": rs.uniform(-1.0, 1.0, 2)},
        "wave": {"diffusion": rs.uniform(0.1, 1.0, 4)},
        "newton": {key: rs.uniform(0.1, 1.0, d) for key, d in semi},
        "imex": {key: rs.uniform(0.1, 1.0, d) for key, d in semi},
    }
    n = (cases.GREEDY_GRID + 1) ** 2
    signs, sampling, _ = jax_srht_plan(jax.random.key(GREEDY_SEED), n, cases.GREEDY_K)
    return {"time_mus": mus, "factor_U": rs.normal(size=(FACTOR_N, FACTOR_R)),
            "greedy_train": rs.uniform(0.1, 1.0, size=(GREEDY_TRAIN, 4)),
            "greedy_signs": np.array(signs), "greedy_sampling": np.array(sampling)}


def _jax_time_loops(inp) -> dict:
    """The JAX package's unsharded runs of the time-loop cases."""
    st = JaxStencil((2, 2), cases.TIME_GRID, dtype=jnp.float64)
    semi = JaxSemilinear((2, 2), cases.TIME_GRID, dtype=jnp.float64, reaction_scale=50.0)
    foms = {
        "parabolic": JaxInstationaryStencil(st, T=0.5, nt=6),
        "parabolic3d": JaxInstationaryStencil(
            JaxStencil3D((2, 2, 2), cases.TIME_GRID_3D, dtype=jnp.float64), T=0.25, nt=4),
        "advection": JaxInstationaryStencil(JaxAdvection(cases.TIME_GRID, dtype=jnp.float64),
                                            T=0.25, nt=4),
        "wave": JaxWave(st, T=0.25, nt=5),
        "imex": JaxImex(semi, T=0.25, nt=4),
    }
    out = {}
    for case, mu in inp["time_mus"].items():
        mu = {key: jnp.asarray(v) for key, v in mu.items()}
        if case == "newton":
            out[case] = np.asarray(semi.solve_newton(mu, newton_tol=1e-11))
        else:
            out[case] = np.asarray(foms[case].solve(mu, **cases.TIME_KW))
    return out


def _jax_pod_greedy(inp):
    """The JAX package's unsharded POD-greedy on the stencil view with its
    SRHT. Its projection is jitted once (eagerly it compiles at every
    operation and basis size): the basis zero-padded to the final size, the
    projections cut back to the live columns (each column's projection and
    sketch is its own, so the values are the unpadded ones to rounding)."""
    st = JaxStencil((2, 2), cases.GREEDY_GRID, dtype=jnp.float64)
    view = JaxInstationaryStencil(st, T=0.1, nt=3).as_reductor_fom(**cases.GREEDY_VIEW_KW)
    emb = JaxSrht.make(view.solution_dim, range_dim=cases.GREEDY_K, seed=GREEDY_SEED)
    red = jax_instationary.InstationaryReductor(view, embedding=emb, log_level=30)
    orig = jax_instationary.project_time_system
    whole = jax.jit(lambda V: orig(view, V, red.product, emb))

    def projected(fom, V, product, embedding):
        r = V.shape[1]
        mass, lhs, rhs, e_mass, e_lhs, e_rhs = whole(
            jnp.pad(V, ((0, 0), (0, cases.GREEDY_EXT - r))))
        cut = (lambda a, idx: JaxAffineDense(a.stack[idx], a.coefficients))
        return (mass[:r, :r], cut(lhs, np.s_[:, :r, :r]), cut(rhs, np.s_[:, :r]),
                e_mass[:, :r], cut(e_lhs, np.s_[..., :r]), e_rhs)

    train = [{"diffusion": jnp.asarray(row)} for row in inp["greedy_train"]]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_instationary, "project_time_system", projected)
        _, hist = jax_instationary.pod_greedy(view, red, train,
                                              max_extensions=cases.GREEDY_EXT, log_level=30)
    return {"rb": np.asarray(red.rb), "max_estimates": hist["max_estimates"],
            "selected": [np.asarray(m["diffusion"]) for m in hist["selected_mus"]]}


def _jax_greedy(inp):
    """Two JAX steps on a ("dof", 4) x ("mu", 1) mesh of the conftest's
    CPU devices, its rhs sketch jitted (eagerly its shard_map compiles
    primitive by primitive)."""
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(RANKS, 1), ("dof", "mu"))
    fom = JaxStencil((2, 2), cases.GRID, dtype=jnp.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sharded_sketch, "srht_sketch_sharded_flat", jax.jit(
            jax_sharded_sketch.srht_sketch_sharded_flat,
            static_argnames=("k", "mesh", "axis", "block", "n")))
        state, step = jax_make_step(fom, mesh, jax.random.key(0), k=cases.K,
                                    r_max=cases.R_MAX, cg_tol=1e-10, cg_maxiter=800,
                                    sketch="srht")
    batch = {"diffusion": jnp.asarray(inp["batch"])}
    ests = []
    with mesh:
        jit_step = jax.jit(step)
        for row in inp["mus"]:
            state, est, _ = jit_step(state, {"diffusion": jnp.asarray(row)}, batch)
            ests.append(np.asarray(est))
    return state, ests


@pytest.fixture(scope="module")
def run():
    """(the ranks' results by rank, the inputs, the JAX greedy's state and
    estimates, the JAX time loops and POD-greedy): the ranks run while the
    JAX references compile."""
    inp = _inputs()
    got, errors = {}, []

    def ranks():
        try:
            got.update(spawn(cases.run_cases, RANKS, "gloo", "cpu", args=(inp,)))
        except Exception as exc:  # re-raised below, in the test's thread
            errors.append(exc)

    # one BLAS thread a rank (the ranks inherit the environment when they start)
    one = {name: "1" for name in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                  "MKL_NUM_THREADS")}
    with pytest.MonkeyPatch.context() as mp:
        for name, value in one.items():
            mp.setenv(name, value)
        thread = threading.Thread(target=ranks)
        thread.start()
        try:
            jax_ref = _jax_greedy(inp)
            jax_more = {"time": _jax_time_loops(inp), "pod_greedy": _jax_pod_greedy(inp)}
        finally:
            thread.join()
    if errors:
        raise errors[0]
    return got, inp, jax_ref, jax_more


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_sharded_gaussian_matches_blocked_and_embedding(run):
    got, inp, *_ = run
    x = _t(inp["gauss_x"])
    omega = GaussianEmbedding(GAUSS_K, GAUSS_N, seed=5, device="cpu").random_matrix()
    blocked = gaussian_sketch_blocked(5, GAUSS_K, x, RANKS)
    assert rel(blocked, omega @ x) < 1e-12
    for r in range(RANKS):
        assert rel(got[r]["gauss"], omega @ x) < 1e-12
        assert rel(got[r]["gauss"], blocked) < 1e-12
        assert rel(got[r]["gauss_single"], (omega @ x)[:, 0]) < 1e-12
    # apply_adjoint: each rank's rows of Omega^T V
    adj = torch.cat([got[r]["gauss_adjoint"] for r in range(RANKS)])
    assert rel(adj, omega.T @ _t(inp["gauss_v"])) < 1e-12
    assert rel(ShardedGaussianEmbedding(GAUSS_K, GAUSS_N, None, seed=5).matrix(), omega) < 1e-12


@pytest.mark.parametrize("variant", ["flat", "butterfly"])
@pytest.mark.parametrize("n", SRHT_NS)
def test_sharded_srht_matches_jax(run, variant, n):
    """The JAX plan carried; the odd n zero-padded to the flat layout (its
    plan's signs and rows are those of the padded power of two's)."""
    got, inp, *_ = run
    x, signs, sampling = inp["srht"][n]
    n_pad = 1 << (n - 1).bit_length()
    xp = np.concatenate([x, np.zeros((n_pad - n, 3))])
    want = np.asarray(jax_srht_blocked(jax.random.key(n), SRHT_K, jnp.asarray(xp), RANKS))
    for r in range(RANKS):
        assert rel(got[r][f"srht_{variant}_{n}"], want) < 1e-12
    one = SrhtEmbedding.from_plan(n, SRHT_K, signs, sampling, device="cpu").apply_random(_t(x))
    assert rel(one, want) < 1e-12
    # the port's one-device oracles: the FWHT on the padded power of two, the
    # embedding's whole-column path and its explicit operator
    padded_signs = torch.cat([_t(signs), torch.zeros(n_pad - n, dtype=torch.int8)])
    assert rel(srht_blocked(SRHT_K, _t(xp), padded_signs, _t(sampling)), want) < 1e-12
    emb = ShardedSrhtEmbedding.from_plan(signs, sampling, None, variant=variant)
    assert rel(emb.apply_blocked(_t(x)), want) < 1e-12
    assert rel(emb.matrix() @ _t(x), want) < 1e-12


def test_flat_shard_rows_matches_jax(run):
    got, *_ = run
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(RANKS), ("dof",))
    for m in LAYOUT_NS:
        assert got[0]["flat_shard_rows"][m] == jax_flat_shard_rows(m, mesh), m


@pytest.mark.parametrize("n", [999, 5000, 300000])
def test_block_offset_partials_sum_to_the_sketch(n):
    """Shares of the SRHT over consecutive row ranges, aligned to the
    kernel's 2^11-row blocks or not (a head launch zero-padded in front),
    add up to the whole sketch; ``block_offset`` moves H_B's columns."""
    k = 24
    signs, sampling, _ = _srht_plan(1, n, k)
    x = torch.tensor(np.random.RandomState(n).normal(size=(n, 3)))
    want = srht_onepass(x, k, signs, sampling)
    rs = np.random.RandomState(n + 1)
    cuts = sorted({0, n, *rs.randint(1, n, size=5).tolist(),
                   *([2048, 2051, 4096] if n > 4096 else [])})
    got = sum(srht_partial(x[a:b], k, signs[a:b], sampling, a)
              for a, b in zip(cuts[:-1], cuts[1:]))
    assert rel(got, want) < 1e-12
    if n > 2 * 2048:
        parts = (srht_onepass_plain(x[:2048], k, signs[:2048], sampling)
                 + srht_onepass_plain(x[2048:], k, signs[2048:], sampling,
                                      block_offset=1))
        assert rel(parts, want) < 1e-12


@pytest.mark.parametrize("family", ["thermal", "advection"])
def test_slab_apply_matches_one_device(run, family):
    got, inp, *_ = run
    g = _t(inp["grid"])
    if family == "thermal":
        fom = StencilThermalBlock((2, 2), cases.GRID, dtype=torch.float64, device="cpu")
        mu = {"diffusion": _t(inp["mu_thermal"])}
    else:
        fom = StencilAdvectionDiffusion(cases.GRID, dtype=torch.float64, device="cpu")
        mu = {"eps": _t(inp["eps"]), "velocity": _t(inp["velocity"])}
    terms = (fom.apply_terms(g) if hasattr(fom, "apply_terms")
             else torch.stack([fom.apply_term(t, g) for t in range(fom.n_terms)]))
    for key, want in (("apply", fom.apply(mu, g)), ("terms", terms),
                      ("diag", fom.jacobi_diag(mu))):
        cat = torch.cat([got[r][f"{key}_{family}"] for r in range(RANKS)], dim=-2)
        assert rel(cat, want) < 1e-13, key
    for r in range(RANKS):
        assert rel(got[r][f"output_{family}"], fom.output(g)) < 1e-13


@pytest.mark.parametrize("family", ["thermal", "advection"])
def test_sharded_solvers_match_one_device(run, family):
    """Sharded CG (thermal) and BiCGStab (advection) take the one-device
    iterates: the same count and x to 1e-10; so does the demo's one-device
    check (``large_scale_demo.slab_check``: the slab apply of a random grid
    and 5 iterations, each rank against the whole grid)."""
    got, inp, *_ = run
    if family == "thermal":
        fom = StencilThermalBlock((2, 2), cases.GRID, dtype=torch.float64, device="cpu")
        mu, solver = {"diffusion": _t(inp["mu_thermal"])}, cg
    else:
        fom = StencilAdvectionDiffusion(cases.GRID, dtype=torch.float64, device="cpu")
        mu, solver = {"eps": _t(inp["eps"]), "velocity": _t(inp["velocity"])}, bicgstab
    diag = fom.jacobi_diag(mu)
    want = solver(lambda v: fom.apply(mu, v), fom.rhs(), precond=lambda r: r / diag,
                  tol=1e-10, maxiter=400)
    x = torch.cat([got[r][f"solve_{family}"][0] for r in range(RANKS)])
    assert rel(x, want.x) < 1e-10
    assert {got[r][f"solve_{family}"][1] for r in range(RANKS)} == {want.iters}
    for r in range(RANKS):
        check = got[r][f"slab_check_{family}"]
        assert check["apply_rel_err"] < 1e-13 and check["solve_rel_err"] < 1e-10, check
        assert check["iters"] == (5, 5)


@pytest.mark.parametrize("mesh", ["greedy_dof4", "greedy_dof2_mu2"])
def test_sharded_greedy_step_matches_jax_and_meshless(run, mesh):
    got, inp, (jstate, jests), _ = run
    fom = StencilThermalBlock((2, 2), cases.GRID, dtype=torch.float64, device="cpu")
    n = fom.solution_shape[0] ** 2
    emb = SrhtEmbedding.from_plan(n, cases.K, inp["plan_signs"], inp["plan_sampling"],
                                  device="cpu")
    state, step = make_sharded_greedy_step(fom, k=cases.K, r_max=cases.R_MAX, cg_tol=1e-10,
                                           cg_maxiter=800, sketch="srht", embedding=emb)
    batch = {"diffusion": _t(inp["batch"])}
    ests = []
    for row in inp["mus"]:
        state, est, _ = step(state, {"diffusion": _t(row)}, batch)
        ests.append(est)
    for r in range(RANKS):
        g = got[r][mesh]
        assert int(g["state"]["ncols"]) == int(jstate.ncols) == cases.STEPS
        for key in ("srb", "res_lhs", "res_rhs", "out"):
            assert rel(g["state"][key], getattr(jstate, key)) < 1e-9, key
            assert rel(g["state"][key], getattr(state, key)) < 1e-9, key
            assert torch.equal(g["state"][key], got[0][mesh]["state"][key])
        for e, je, te in zip(g["estimates"], jests, ests):
            assert rel(e, je) < 1e-9 and rel(e, te) < 1e-9


@pytest.mark.parametrize("mesh", ["greedy_dof4", "greedy_dof2_mu2"])
def test_serve_batch_sharded(run, mesh):
    got, *_ = run
    for r in range(RANKS):
        g = got[r][mesh]
        for key, v in g["served_direct"].items():
            assert rel(g["served"][key], v) < 1e-14, key
    # the batch of 3 does not split over "mu" (2), nor over the 1-D mesh's "dof" (4)
    axis = "'mu' (2)" if mesh == "greedy_dof2_mu2" else "'dof' (4)"
    assert f"not a multiple of mesh axis {axis}" in got[0][mesh]["refused"]


def test_lobpcg_gen_on_a_mesh_matches_unsharded(run):
    got, inp, *_ = run
    T, R = _t(inp["T"]), _t(inp["R"])
    want = lobpcg_gen(lambda U: T @ U, lambda U: R @ U, 32, k=1, block=2, iters=40,
                      tol=cases.LOBPCG_TOL, key=3, device="cpu")
    assert want.converged
    for r in range(RANKS):
        g = got[r]["lobpcg"]
        assert rel(g["values"], want.values) < 1e-9
        assert g["iterations"] == want.iterations
        assert rel(g["radii"], want.radii) < 1e-3  # a residual norm: its cancellation
    V = torch.cat([got[r]["lobpcg"]["vectors"] for r in range(RANKS)])
    # Ritz vectors up to sign
    cos = (V * want.vectors).sum(0).abs() / (V.norm(dim=0) * want.vectors.norm(dim=0))
    assert float((1 - cos).abs().max()) < 1e-9


def test_matrixfree_scm_sharded_anchor_matches_unsharded(run):
    """``MatrixFreeScmCoercivity(mesh=)``: the slab's terms, R, interior
    projector and Jacobi of R; its anchor equals the one-device one (the
    counterpart of ``tests/test_scm_matfree.py::
    test_matrixfree_scm_sharded_anchor_equals_unsharded``)."""
    from rla4mor_tpu_torch.mor.scm_matfree import MatrixFreeScmCoercivity

    got, inp, *_ = run
    fom = cases.scm_fom()
    scm = MatrixFreeScmCoercivity(fom, boxes=fom.term_box_bounds(), **cases.SCM_KW)
    alpha, ystar = scm.alpha_exact({"diffusion": _t(inp["mu_thermal"][:1])})
    for r in range(RANKS):
        g = got[r]["scm"]
        assert g["iterations"] == scm.anchor_diagnostics[0]["iterations"]
        assert rel(g["theta"], scm.anchor_diagnostics[0]["theta"]) < 1e-9
        assert rel(g["alpha"], alpha) < 1e-9
        assert np.abs(g["ystar"] - ystar).max() < 1e-9


def _gathered(got, key, case, ranks=range(RANKS)):
    return torch.cat([got[r][key][case] for r in ranks], dim=0)


@pytest.mark.parametrize("case", ["parabolic", "parabolic3d", "advection", "wave", "newton",
                                  "imex"])
def test_time_loops_on_slabs_match_jax_and_one_device(run, case):
    """Each time loop on the 4-rank "dof" mesh (the rank's rows of the grid,
    or z-planes in 3-D), gathered: within 1e-9 of the JAX package's
    unsharded run and 1e-10 of the port's one-device run (the counterparts
    of tests/test_parallel.py's sharded parabolic, 3-D, wave, Newton and
    IMEX tests)."""
    got, inp, _, jax_more = run
    fom = cases.time_foms()[case]
    mu = {key: _t(v) for key, v in inp["time_mus"][case].items()}
    one = cases.time_solve(case, fom, mu)
    sharded = _gathered(got, "time_loops", case)
    for r in range(RANKS):  # the slabs stay on their ranks: a quarter each
        assert got[r]["time_loops"][case].shape[0] * RANKS == one.shape[0]
        if case == "parabolic":  # the helper that gathers a trajectory for checks
            assert torch.equal(got[r]["time_loops"]["gathered"], sharded)
    assert rel(sharded, jax_more["time"][case]) < 1e-9
    assert rel(sharded, one) < 1e-10


def test_multigrid_refused_on_a_mesh(run):
    """The V-cycle needs a power-of-two element count: its odd node-row
    count does not split over an even "dof" axis, so a mesh takes Jacobi."""
    got, *_ = run
    for r in range(RANKS):
        assert "slabs take Jacobi" in got[r]["time_loops"]["mg_refused"]


@pytest.mark.parametrize("case", ["parabolic3d", "advection"])
def test_reductor_slab_view_refused_off_the_thermal_block(run, case):
    """The reductor's slab view is the 2-D thermal block's: the 3-D block
    and the advection family on a mesh raise instead of giving a view."""
    got, *_ = run
    for r in range(RANKS):
        assert "not ported" in got[r]["time_loops"][f"view_refused_{case}"]


def test_gram_schmidt_and_pod_with_group_match_unsharded(run):
    """The counterpart of tests/test_parallel.py::
    test_gram_schmidt_and_pod_shard_over_dof: the n-axis contractions
    all-reduced, the factors within 1e-10 of the unsharded ones, the tall
    factors left in the ranks' rows."""
    from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt, pod

    got, inp, *_ = run
    U = _t(inp["factor_U"])
    Q, R = gram_schmidt(U, return_R=True)
    modes, svals = pod(U, modes=4, rtol=None)
    for r in range(RANKS):
        f = got[r]["factorisations"]
        assert f["Q"].shape == (FACTOR_N // RANKS, FACTOR_R)
        assert f["modes"].shape == (FACTOR_N // RANKS, 4)
        assert (f["R"] - R).abs().max() < 1e-10
        assert (f["svals"] - svals).abs().max() < 1e-10
    assert (_gathered(got, "factorisations", "Q") - Q).abs().max() < 1e-10
    assert (_gathered(got, "factorisations", "modes") - modes).abs().max() < 1e-10


def test_pod_greedy_on_the_mesh_matches_jax(run):
    """POD-greedy on the ("dof", "mu") = (2, 2) mesh with the JAX SRHT plan:
    the JAX unsharded run's parameters and max estimates (1e-8), the
    gathered basis within 1e-8 of its (each column up to its sign), every
    rank the same history; one sharded sketch a ``reduce()``. The
    counterpart of tests/test_parallel.py::test_pod_greedy_2d_mesh_matches_host."""
    got, _, _, jax_more = run
    jref = jax_more["pod_greedy"]
    first = got[0]["pod_greedy"]
    for r in range(RANKS):
        g = got[r]["pod_greedy"]
        assert len(g["selected"]) == cases.GREEDY_EXT == len(jref["selected"])
        for a, b in zip(g["selected"], jref["selected"]):
            assert np.array_equal(a.numpy(), b)
        assert rel(g["max_estimates"], jref["max_estimates"]) < 1e-8
        assert g["max_estimates"] == first["max_estimates"]
        assert torch.equal(g["mass_r"], first["mass_r"])
        assert g["reduce_calls"] == cases.GREEDY_EXT
    # mesh position (dof, mu) = (r // 2, r % 2): the mu = 0 ranks' rows
    rb = torch.cat([got[r]["pod_greedy"]["rb"] for r in (0, 2)]).numpy()
    assert torch.equal(got[1]["pod_greedy"]["rb"], got[0]["pod_greedy"]["rb"])
    signs = np.sign((rb * jref["rb"]).sum(axis=0))
    assert np.abs(rb * signs - jref["rb"]).max() < 1e-8


def test_multichip_dryrun_runs(run):
    got, *_ = run
    first = got[0]["dryrun"]
    assert first["mesh"] == "dof=2 x mu=2" and first["grid"] == 7
    for r in range(RANKS):
        d = got[r]["dryrun"]
        for key in ("srb", "res_lhs", "res_rhs", "out"):
            assert torch.equal(d["state"][key], first["state"][key])
        assert torch.isfinite(d["estimates"]).all() and d["estimates"].shape == (8,)
        assert d["served"]["u"].shape[0] == 8
        assert np.isfinite(d["anchor"]) and torch.isfinite(d["advection_estimates"]).all()
        assert set(d["time_outputs"]) == {"parabolic", "parabolic3d", "advection", "wave"}
        assert d["time_outputs"] == first["time_outputs"]
        assert all(np.isfinite(v) for v in d["time_outputs"].values())
        assert d["semilinear"]["snapshots"].shape == (64, 3)
        assert torch.equal(d["semilinear"]["eta"], first["semilinear"]["eta"])
        assert len(d["pod_greedy"]["selected"]) == 2
        assert d["pod_greedy"]["max_estimates"] == first["pod_greedy"]["max_estimates"]
    assert {got[r]["mesh_rows"] for r in range(RANKS)} == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_launch_names_backend_and_device():
    """No silent choice: a rank asked for a card that is not there raises;
    NCCL is refused on the CPU and for ranks sharing one card."""
    with pytest.raises(ValueError, match="gloo"):
        _device_of("cpu", 0, 2, "nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _device_of("cuda:0", 0, 2, "gloo")
    from rla4mor_tpu_torch.examples import large_scale_demo, multichip_dryrun

    with pytest.raises(ValueError, match="backend named"):
        large_scale_demo.run_ranks(2, None, "cpu")
    with pytest.raises(ValueError, match="backend named"):
        multichip_dryrun.run(2, None, "cpu")
    for main in (large_scale_demo.main, multichip_dryrun.main):
        with pytest.raises(SystemExit):  # argparse: --ranks 2 without --backend
            main(["--cpu", "--ranks", "2"])
