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
values and the SCM anchor against the unsharded runs.
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
    }


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
    estimates): the ranks run while the JAX step compiles."""
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
        finally:
            thread.join()
    if errors:
        raise errors[0]
    return got, inp, jax_ref


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_sharded_gaussian_matches_blocked_and_embedding(run):
    got, inp, _ = run
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
    got, inp, _ = run
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
    got, _, _ = run
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
    got, inp, _ = run
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
    got, inp, _ = run
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
    got, inp, (jstate, jests) = run
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
    got, _, _ = run
    for r in range(RANKS):
        g = got[r][mesh]
        for key, v in g["served_direct"].items():
            assert rel(g["served"][key], v) < 1e-14, key
    # the batch of 3 does not split over "mu" (2), nor over the 1-D mesh's "dof" (4)
    axis = "'mu' (2)" if mesh == "greedy_dof2_mu2" else "'dof' (4)"
    assert f"not a multiple of mesh axis {axis}" in got[0][mesh]["refused"]


def test_lobpcg_gen_on_a_mesh_matches_unsharded(run):
    got, inp, _ = run
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

    got, inp, _ = run
    fom = cases.scm_fom()
    scm = MatrixFreeScmCoercivity(fom, boxes=fom.term_box_bounds(), **cases.SCM_KW)
    alpha, ystar = scm.alpha_exact({"diffusion": _t(inp["mu_thermal"][:1])})
    for r in range(RANKS):
        g = got[r]["scm"]
        assert g["iterations"] == scm.anchor_diagnostics[0]["iterations"]
        assert rel(g["theta"], scm.anchor_diagnostics[0]["theta"]) < 1e-9
        assert rel(g["alpha"], alpha) < 1e-9
        assert np.abs(g["ystar"] - ystar).max() < 1e-9


def test_multichip_dryrun_runs(run):
    got, _, _ = run
    first = got[0]["dryrun"]
    assert first["mesh"] == "dof=2 x mu=2" and first["grid"] == 7
    for r in range(RANKS):
        d = got[r]["dryrun"]
        for key in ("srb", "res_lhs", "res_rhs", "out"):
            assert torch.equal(d["state"][key], first["state"][key])
        assert torch.isfinite(d["estimates"]).all() and d["estimates"].shape == (8,)
        assert d["served"]["u"].shape[0] == 8
        assert np.isfinite(d["anchor"]) and torch.isfinite(d["advection_estimates"]).all()
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
