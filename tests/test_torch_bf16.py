"""The port's bf16 offline mode held against the JAX package (CPU).

Mirrors ``tests/test_bf16_offline.py`` (its six tests of the mode; the
seventh is about TPU matrix-unit precision, which the port has no
counterpart of) and holds the port's bf16 SRHT (the kernel's plain version
and the small-n FWHT), ``CastInputOp`` and ``SketchedReductor(offline_dtype=
torch.bfloat16)`` against the JAX package on the same inputs. The SRHT
plans and the Gaussian Omegas are carried from the JAX side; inputs come
from numpy with a seed and are quantized to bf16 once on each side, and the
tests assert that the two hold the same bits. Thermal block 2x2 at 16
intervals (n = 225), snapshots solved once by the JAX FOM and handed to
both packages.

Tolerances: the bf16 bits are equal; results in float32 agree to 1e-5
relative to their max (float32 sums in other orders), estimates through a
reduced solve to 1e-4; a bf16 result (one more rounding) to 2^-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.ops.embeddings as jemb
import rla4mor_tpu.ops.srht_pallas as jsp
from rla4mor_tpu.core.linops import CastInputOp as JaxCast
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.mor import SketchedReductor as JaxReductor
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan
from rla4mor_tpu.ops.fwht import srht as jax_srht

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.core import CastInputOp, mu_stack
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy
from rla4mor_tpu_torch.ops import srht_cuda

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

BF16_EPS = 2.0 ** -7


def _wide(t) -> np.ndarray:
    """float64 (complex128) numpy copy of a tensor or array, bf16 included."""
    if isinstance(t, torch.Tensor):
        return t.to(torch.complex128 if t.is_complex() else torch.float64).numpy()
    t = np.asarray(t)
    return t.astype(np.complex128 if np.iscomplexobj(t) else np.float64)


def rel(a, b):
    a, b = _wide(a), _wide(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def bf16_pair(x: np.ndarray):
    """x quantized to bf16 once on each side; asserts the same bits."""
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.tensor(x).to(torch.bfloat16)
    assert np.array_equal(np.asarray(jx).view(np.uint16),
                          tx.view(torch.int16).numpy().view(np.uint16))
    return jx, tx


class Carried(temb.GaussianEmbedding):
    """Port Gaussian whose redraws carry the JAX package's Omega for the
    same (range_dim, source_dim, seed)."""

    made: dict = {}

    @classmethod
    def of(cls, k, n, seed):
        if (k, n, seed) not in cls.made:
            omega = np.asarray(jemb.GaussianEmbedding(k, n, seed).random_matrix())
            cls.made[k, n, seed] = cls.from_matrix(omega, seed=seed, device="cpu")
        return cls.made[k, n, seed]

    def with_seed(self, seed):
        return self.of(self.range_dim, self.source_dim, seed)

    def with_range_dim(self, range_dim):
        return self.of(range_dim, self.source_dim, self.seed)


def srht_pair(n, k, seed, jsqrt=None, tsqrt=None):
    je = jemb.SrhtEmbedding.make(n, sqrt_product=jsqrt, range_dim=k, seed=seed)
    signs, sampling, _ = jax_srht_plan(je.key, je.l2_dim, k)
    te = temb.SrhtEmbedding.from_plan(je.l2_dim, k, np.asarray(signs), np.asarray(sampling),
                                      sqrt_product=tsqrt, device="cpu")
    return je, te


@pytest.fixture(scope="module")
def foms():
    return JaxFOM((2, 2), 16), ThermalBlockFOM((2, 2), 16, device="cpu")


def _mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _reductors(foms, offline, k=150, seed=1):
    """The JAX test's ``_reductor`` on both sides: SRHT k over the h1_0
    sqrt factor (plan carried), online Gaussian 60 (Omegas carried)."""
    jfom, tfom = foms
    je, te = srht_pair(jfom.solution_dim, k, seed, jfom.h1_0_product.sqrt,
                       tfom.h1_0_product.sqrt)
    jphi = jemb.GaussianEmbedding.make(k, range_dim=60, seed=seed + 100)
    tphi = Carried.of(60, k, seed + 100)
    jred = JaxReductor(jfom, embedding_primal=je, embedding_online=jphi,
                       product=jfom.h1_0_product, orthonormalize=True,
                       offline_dtype=jnp.bfloat16 if offline else None, log_level=30)
    tred = SketchedReductor(tfom, embedding_primal=te, embedding_online=tphi,
                            product=tfom.h1_0_product, orthonormalize=True,
                            offline_dtype=torch.bfloat16 if offline else None, log_level=30)
    return jred, tred


@pytest.fixture(scope="module")
def snapshots(foms):
    """Six training parameters and their snapshots, solved by the JAX
    FOM, numpy float64."""
    jfom, _ = foms
    jm, tm = _mus(6, 0)
    return {"six": (jm, tm, np.asarray(jfom.solve_many(jm)))}


# ---------------------------------------------------------------------------
# the SRHT in bf16: plain version and small-n FWHT against the JAX package


@pytest.mark.parametrize("layout", ["flat_rows", "vec", "flat_cols"])
def test_plain_onepass_2byte_matches_jax(layout):
    """srht_onepass_plain on bf16 input, out_dtype float32, against the JAX
    XLA twin the embedding dispatches to, on the same bits: 1e-5 relative
    to max. The default output is bf16, within one rounding (2^-7 relative
    to max)."""
    n, m, k = (1 << 12, 3, 96) if layout == "flat_rows" else (5000, 2, 80)
    x = np.random.RandomState(n + m).normal(size=(n, m))
    key = jax.random.key(3)
    signs, sampling, _ = jax_srht_plan(key, n, k)
    signs, sampling = torch.tensor(np.asarray(signs)), torch.tensor(np.asarray(sampling))
    jx, tx = bf16_pair(x)
    if layout == "flat_rows":
        ref = jsp.srht_onepass_flat(jx.T, k, key, out_dtype=jnp.float32).T
    elif layout == "vec":
        ref = jsp.srht_onepass_vec(jx[:, 0], k, key, out_dtype=jnp.float32)[:, None]
        tx = tx[:, :1]
    else:
        ref = jsp.srht_onepass_flat_cols(jx, k, key, out_dtype=jnp.float32)
    out = srht_cuda.srht_onepass(tx, k, signs, sampling, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert rel(out, np.asarray(ref)) < 1e-5
    narrow = srht_cuda.srht_onepass(tx, k, signs, sampling)
    assert narrow.dtype == torch.bfloat16
    assert rel(narrow.float(), out) < BF16_EPS


def test_plain_onepass_f16_sums_in_float32():
    """float16 takes the bf16 path's semantics (``promote_types(f16, f32)``
    sums, as in JAX): the plain version equals the float32 sum of the same
    values (1e-6 relative to max), and its f16 output is within one f16
    rounding (2^-10)."""
    n, k = 5000, 80
    x = torch.tensor(np.random.RandomState(7).normal(size=(n, 3))).to(torch.float16)
    signs, sampling, _ = jax_srht_plan(jax.random.key(4), n, k)
    signs, sampling = torch.tensor(np.asarray(signs)), torch.tensor(np.asarray(sampling))
    out = srht_cuda.srht_onepass(x, k, signs, sampling, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert rel(out, srht_cuda.srht_onepass_plain(x.float(), k, signs, sampling)) < 1e-6
    narrow = srht_cuda.srht_onepass(x, k, signs, sampling)
    assert narrow.dtype == torch.float16
    assert rel(narrow.float(), out) < 2.0 ** -10


@pytest.fixture(scope="module")
def small_n():
    """n = 1000 < 2^16 (the Kronecker FWHT branch): the embeddings, bf16
    input (n, 5) and the JAX package's sketches of it, bf16 and float32."""
    je, te = srht_pair(1000, 50, 6)
    jx, tx = bf16_pair(np.random.RandomState(3).normal(size=(1000, 5)))
    return te, tx, (np.asarray(je.apply_random(jx), np.float32),
                    np.asarray(je.apply_random(jx, out_dtype=jnp.float32)))


@pytest.mark.parametrize("shape", [(1000,), (1000, 5)])
def test_small_n_fwht_in_bf16_matches_jax(small_n, shape):
    """n < 2^16: the Kronecker FWHT computes in bf16 when no wider
    out_dtype is asked, as the JAX package's does: 2^-7 relative to max.
    Asked for float32 it upcasts first: 1e-5 (float32 sums). A vector is
    the matrix's first column (the transform is columnwise)."""
    te, tx, (ref, ref_wide) = small_n
    if len(shape) == 1:
        tx, ref, ref_wide = tx[:, 0], ref[:, 0], ref_wide[:, 0]
    out = te.apply_random(tx)
    assert out.dtype == torch.bfloat16
    assert rel(out.float(), ref) < BF16_EPS
    wide = te.apply_random(tx, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    assert rel(wide, ref_wide) < 1e-5


def test_2byte_launch_plan():
    """The wrapper's plan for 2-byte input: the tile's shared memory (two
    bf16 stages and the float32 tile the transform writes) fits a CTA, its
    columns stay 16-byte aligned, and the columns layout takes at least
    two columns a tile (its copies move a tile row; cp.async has no 2-byte
    copy) and 4 columns a tile where the blocks allow, in both layouts."""
    R = 1 << srht_cuda._R_LOG
    for mt in (1, 2, 4):
        ld, smem = srht_cuda.tile(mt, 2)
        assert ld * 4 % 16 == 0 and (R + 8) * 2 % 16 == 0
        assert smem == 2 * (mt * (R + 8) * 2 + R) + mt * ld * 4 <= 232_448
    for m in (2, 3, 8, 56):
        assert srht_cuda.tile_width(261_121, m, False, 132, itemsize=2) >= 2
        assert srht_cuda.tile_width(261_121, m, True, 132, itemsize=2) == 1
    assert srht_cuda.tile_width(261_121, 1, False, 132, itemsize=2) == 1
    # the bench shape: 4 columns a tile in both layouts (float32 rows: 2)
    for rows in (True, False):
        assert srht_cuda.tile_width(1 << 24, 56, rows, 132, itemsize=2) == 4
    assert srht_cuda.tile_width(1 << 24, 56, True, 132) == 2
    assert srht_cuda.accumulator_dtype(torch.bfloat16) == torch.float32
    assert srht_cuda.accumulator_dtype(torch.float64) == torch.float64


# ---------------------------------------------------------------------------
# mirrors of tests/test_bf16_offline.py


def test_cast_input_op():
    """CastInputOp(Gaussian, bf16): float32 out, equal to the embedding of
    the quantized input and to the JAX package's (1e-6: float32 rounding of
    a float64 product); within 4 eps_bf16 of full precision; complex input
    passes uncast."""
    jg = jemb.GaussianEmbedding.make(64, range_dim=24, seed=3)
    tg = temb.GaussianEmbedding.from_matrix(np.asarray(jg.random_matrix()), device="cpu")
    op = CastInputOp(tg, torch.bfloat16)
    x = np.random.RandomState(0).normal(size=(64, 5))
    jx, tx = bf16_pair(x)
    y = op.apply(torch.tensor(x))
    assert y.dtype == torch.float32
    assert rel(y, tg.apply(tx).float()) < 1e-6
    assert rel(y, np.asarray(JaxCast(jg, jnp.bfloat16).apply(jnp.asarray(x)))) < 1e-6
    y_full = tg.apply(torch.tensor(x))
    assert torch.linalg.norm(y - y_full) / torch.linalg.norm(y_full) < 4 * BF16_EPS
    xc = torch.tensor(x * (1 + 0.5j))
    yc = op.apply(xc)
    assert yc.is_complex()
    assert rel(yc, tg.apply(xc)) < 1e-10


@pytest.fixture(scope="module")
def offline(foms, snapshots):
    """Full-precision and bf16-offline port reductors and the JAX package's
    bf16-offline reductor, each extended by the first three snapshots,
    and the ROMs of online seed 7."""
    _, _, U = snapshots["six"]
    (_, thi), (jlo, tlo) = _reductors(foms, False), _reductors(foms, True)
    jlo.extend_basis(jnp.asarray(U[:, :3]))
    for red in (thi, tlo):
        red.extend_basis(torch.tensor(U[:, :3]))
    return thi, tlo, jlo, (thi.reduce(seed=7), tlo.reduce(seed=7), jlo.reduce(seed=7))


def test_bf16_offline_estimator_envelope(offline):
    """Same plans, same snapshots: the bf16-offline estimates track the
    full-precision ones to 8 eps_bf16 where the ROM is unconverged, its
    state (srb, residual stacks) is float32 and rb bf16, and they equal the
    JAX package's bf16-offline estimates (1e-4)."""
    thi, tlo, jlo, (trom_hi, trom_lo, jrom_lo) = offline
    assert tlo.rb.dtype == torch.bfloat16
    assert tlo.srb.dtype == torch.float32
    assert tlo.residual_lhs.stack.dtype == torch.float32
    assert tlo.residual_rhs.stack.dtype == torch.float32
    assert rel(tlo.srb, np.asarray(jlo.srb)) < 1e-5
    jm, tm = _mus(12, 5)
    _, e_lo = trom_lo.solve_and_estimate_batch(mu_stack(tm))
    _, j_lo = jrom_lo.solve_and_estimate_batch(
        {"diffusion": jnp.stack([m["diffusion"] for m in jm])})
    assert rel(e_lo, np.asarray(j_lo)) < 1e-4
    _, e_hi = trom_hi.solve_and_estimate_batch(mu_stack(tm))
    unconverged = e_hi > 0.05
    assert bool(unconverged.any())
    dev = ((e_lo - e_hi).abs() / e_hi)[unconverged]
    assert float(dev.max()) < 8 * BF16_EPS, dev


def test_bf16_offline_noise_floor(foms, snapshots, offline):
    """A snapshot in the basis: full precision certifies about 0, bf16
    stops at its O(eps_bf16) floor, as on the JAX side (1e-3 relative: the
    floor is bf16 noise through a float32 solve)."""
    jm, tm, U = snapshots["six"]
    _, tfom = foms
    _, _, _, (trom_hi, trom_lo, jrom_lo) = offline
    u_norm = float(tfom.h1_0_product.norm(torch.tensor(U[:, 2])))
    e_hi = float(trom_hi.estimate_error(tm[2]))
    e_lo = float(trom_lo.estimate_error(tm[2]))
    assert e_hi < 1e-8 * u_norm
    assert e_lo < 30 * BF16_EPS * u_norm, (e_lo, u_norm)
    assert abs(e_lo - float(jrom_lo.estimate_error(jm[2]))) < 1e-3 * e_lo


def test_bf16_offline_greedy_decays(foms):
    """The weak greedy through the bf16 offline stage: the max estimate
    decays to the bf16 floor (below 0.2 of the first and 4 eps_bf16), and
    reconstruct lifts through the bf16 basis to 5e-2 of the FOM solution.
    Port only: the operators are the JAX test's, the JAX greedy costs a
    compile an extension; the state it builds is held against the JAX
    package in the two tests above."""
    _, tfom = foms
    _, red = _reductors(foms, True)
    _, train = _mus(40, 2)
    result = rb_greedy(tfom, red, train, max_extensions=8, online_seed=11, log_level=30)
    ests = np.asarray(result.max_estimates)
    assert ests[-1] < 0.2 * ests[0], ests
    assert ests[-1] < 4 * BF16_EPS, ests
    rom = red.reduce(seed=13)
    mu = train[0]
    u = tfom.solve(mu)
    u_rb = red.reconstruct(rom.solve(mu))
    assert u_rb.dtype == torch.float32
    assert float(torch.linalg.norm(u - u_rb) / torch.linalg.norm(u)) < 0.05


def test_srht_out_dtype_keeps_f32_accumulator():
    """apply_random(..., out_dtype=float32) emits the float32 sums: within
    1e-5 of the float64 oracle of the same quantized input, 16x closer than
    the bf16 result; the blocked (kernel) and small-n 2-D (FWHT) paths
    both, and equal to the JAX package's (1e-5). Complex input keeps its
    imaginary part."""
    n, m, k = 4096, 5, 96
    je, te = srht_pair(n, k, 3)
    x = np.random.RandomState(1).normal(size=(n, m))
    jx, tx = bf16_pair(x)
    Xb = te.to_blocked(tx)
    assert Xb.dtype == torch.bfloat16
    out_f32 = te.apply_random(Xb, out_dtype=torch.float32)
    out_bf = te.apply_random(Xb).float()
    assert out_f32.dtype == torch.float32
    oracle = np.asarray(jax_srht(jx.astype(jnp.float64).T, k, je.key).T)
    err_f32 = np.abs(out_f32.numpy() - oracle).max()
    err_bf = np.abs(out_bf.numpy() - oracle).max()
    assert err_f32 < 1e-5, err_f32
    assert err_bf > 16 * err_f32, (err_bf, err_f32)
    assert rel(out_f32, np.asarray(je.apply_random(je.to_blocked(jx),
                                                   out_dtype=jnp.float32))) < 1e-5
    out2 = te.apply_random(tx, out_dtype=torch.float32)
    assert out2.dtype == torch.float32
    assert np.abs(out2.numpy() - oracle).max() < 1e-5
    outc = te.apply_random(torch.tensor(x * (1 + 0.25j)), out_dtype=torch.float32)
    assert outc.is_complex()


def test_cast_input_op_requests_f32_output():
    """CastInputOp(SRHT, bf16) asks the embedding for float32: within 1e-5
    of the float64 oracle of the quantized input, and of the JAX
    package's."""
    n, k = 4096, 96
    je, te = srht_pair(n, k, 3)
    x = np.random.RandomState(2).normal(size=(n, 5))
    jx, _ = bf16_pair(x)
    y = CastInputOp(te, torch.bfloat16).apply(torch.tensor(x))
    assert y.dtype == torch.float32
    oracle = np.asarray(jax_srht(jx.astype(jnp.float64).T, k, je.key).T)
    assert np.abs(y.numpy() - oracle).max() < 1e-5
    assert rel(y, np.asarray(JaxCast(je, jnp.bfloat16).apply(jnp.asarray(x)))) < 1e-5
