"""The port's in-kernel Gaussian sketch (Philox contract, plain versions,
``HwPrngGaussianEmbedding``, the sketched greedy over it) held against the
JAX package's Pallas kernels.

The TPU kernels draw their bits from the TPU's hardware PRNG, which exists
nowhere else. Here the JAX kernels run in interpret mode with
``rla4mor_tpu.ops.gaussian_pallas.pltpu`` swapped for a namespace whose
``prng_seed`` / ``prng_random_bits`` give the port's Philox4x32-10 words
(written in ``jnp`` uint64 arithmetic, independently of the port's torch
version), so both packages draw the same Omega and everything after the bits
(the draw order, Box-Muller, the contraction, the padding) is compared.
Tolerances: Rademacher strips bit-equal; normal strips 1e-5 absolute (the
values are at most ~6; XLA's and torch's log1p/cos/sin differ by ulps);
sketches and float32 sketched-RB quantities 1e-5 relative.
"""

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import rla4mor_tpu.ops.embeddings as jemb
import rla4mor_tpu.ops.gaussian_pallas as jgp
from rla4mor_tpu.models import ThermalBlockFOM as JaxFOM
from rla4mor_tpu.mor import SketchedReductor as JaxReductor
from rla4mor_tpu.mor import rb_greedy as jax_rb_greedy

import rla4mor_tpu_torch.ops.embeddings as temb
from rla4mor_tpu_torch.core import mu_stack
from rla4mor_tpu_torch.models import ThermalBlockFOM
from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy
from rla4mor_tpu_torch.ops import gaussian_cuda as gcu
from rla4mor_tpu_torch.ops import philox

W = 256
M32 = 0xFFFFFFFF
ROOT = Path(__file__).resolve().parent.parent


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ---------------------------------------------------------------------------
# Philox4x32-10 known-answer vectors (Random123)

KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M32,) * 4, (M32, M32), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _jnp_philox(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 on uint64 arrays holding 32-bit words."""
    u, mask = jnp.uint64, jnp.uint64(M32)
    for i in range(10):
        if i:
            k0 = (k0 + u(0x9E3779B9)) & mask
            k1 = (k1 + u(0xBB67AE85)) & mask
        p0 = u(0xD2511F53) * c0
        p1 = u(0xCD9E8D57) * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & mask, (p0 >> 32) ^ c3 ^ k1, p0 & mask
    return c0, c1, c2, c3


@pytest.mark.parametrize("counter,key,want", KAT, ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, want):
    got = philox.philox4x32(counter, key)
    assert tuple(int(w) for w in got) == want
    words = _jnp_philox(*(jnp.uint64(c) for c in counter), *(jnp.uint64(k) for k in key))
    assert tuple(int(w) for w in words) == want


# ---------------------------------------------------------------------------
# the JAX kernels under the Philox contract


class _PhiloxPltpu(types.SimpleNamespace):
    """``pltpu`` with the hardware PRNG replaced by the port's Philox words:
    ``prng_seed(a, b)`` keys ``(a mod 2^32, b)`` and restarts the draw count;
    draw c of shape (rows, W) has entry (r, j) = word j % 4 of
    Philox(counter (j // 4, r, c, 0))."""

    def __init__(self):
        super().__init__(key=None, draw=0)

    def __getattr__(self, name):  # everything else is the real module
        return getattr(pltpu, name)

    def prng_seed(self, a, b):
        self.key = (a, b)
        self.draw = 0

    def prng_random_bits(self, shape):
        def word(v):
            v = jax.lax.bitcast_convert_type(jnp.asarray(v, jnp.int32), jnp.uint32)
            return v.astype(jnp.uint64)

        k0, k1 = (word(v) for v in self.key)
        r = jax.lax.broadcasted_iota(jnp.uint64, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.uint64, shape, 1)
        words = _jnp_philox(j // 4, r, jnp.uint64(self.draw), jnp.uint64(0), k0, k1)
        self.draw += 1
        sel = j % 4
        out = jnp.select([sel == 0, sel == 1, sel == 2], list(words[:3]), words[3])
        return out.astype(jnp.uint32)

    def bitcast(self, x, ty):
        if x.dtype == jnp.uint32 and jnp.dtype(ty) == jnp.uint32:
            return x
        return pltpu.bitcast(x, ty)


def _clear_jax_caches():
    for fn in (jgp.gaussian_sketch, jgp.gaussian_strip):
        fn.clear_cache()


@pytest.fixture
def philox_pallas(monkeypatch):
    """The JAX Gaussian kernels draw Philox words and run in interpret mode
    (also when the JAX embedding calls them without ``interpret``)."""
    _clear_jax_caches()
    monkeypatch.setattr(jgp, "pltpu", _PhiloxPltpu())
    orig = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jgp.pl, "pallas_call", interpreted)
    yield
    _clear_jax_caches()


STRIPS = [(256, "normal"), (100, "normal"), (300, "rademacher"), (128, "rademacher")]


@pytest.mark.parametrize("k,dist", STRIPS)
def test_strip_matches_jax_kernel(philox_pallas, k, dist):
    for seed, b in ((7, 0), (7, 3), (-5, 2)):
        ref = np.asarray(jgp.gaussian_strip(k, seed, b, block_rows=W, dist=dist,
                                            interpret=True))
        out = gcu.gaussian_strip(k, seed, b, W, dist, device="cpu")
        assert out.dtype == torch.float32 and out.shape == (k, W)
        if dist == "rademacher":
            assert np.array_equal(out.numpy(), ref)
        else:
            assert np.abs(out.numpy() - ref).max() <= 1e-5


SKETCHES = [(256, "normal", 3 * W + 37, 5), (100, "normal", 1000, 3),
            (300, "rademacher", 2 * W, 4), (256, "rademacher", 700, 1),
            # the tiled branch's widths: m = 9 (16 columns), m = 64
            (256, "normal", 3 * W + 37, 9), (128, "rademacher", 3 * W - 5, 64)]


@pytest.mark.parametrize("k,dist,n,m", SKETCHES)
def test_sketch_matches_jax_kernel(philox_pallas, k, dist, n, m):
    X = np.random.RandomState(n + m).normal(size=(n, m)).astype(np.float32)
    ref = np.asarray(jgp.gaussian_sketch(jnp.asarray(X), k, 11, block_rows=W,
                                         dist=dist, interpret=True))
    out = gcu.gaussian_sketch(torch.tensor(X), k, 11, W, dist)
    assert out.dtype == torch.float32
    assert rel(out, ref) < 1e-5
    # the plain version is the wrapper's CPU path, and the strips' sum
    assert torch.equal(out, gcu.gaussian_sketch_plain(torch.tensor(X), k, 11, W, dist))
    strips = [gcu.gaussian_strip_plain(k, 11, b, W, dist, device="cpu").double()
              for b in range(-(-n // W))]
    oracle = torch.cat(strips, dim=1)[:, :n] @ torch.tensor(X).double() / k**0.5
    assert rel(out, oracle) < 1e-5


def test_vector_input_and_dtypes(philox_pallas):
    x = np.random.RandomState(2).normal(size=(600,))
    ref = np.asarray(jgp.gaussian_sketch(jnp.asarray(x), 64, 3, block_rows=W,
                                         interpret=True))
    for xt in (torch.tensor(x), torch.tensor(x).to(torch.bfloat16)):
        out = gcu.gaussian_sketch(xt, 64, 3, W)
        assert out.shape == (64,) and out.dtype == torch.float32
        tol = 1e-5 if xt.dtype == torch.float64 else 1e-2
        assert rel(out, ref) < tol


def test_complex_input_raises_in_both(philox_pallas):
    x = np.ones((300, 2)) + 1j
    with pytest.raises(TypeError):
        jgp.gaussian_sketch(jnp.asarray(x), 64, 0, block_rows=W, interpret=True)
    with pytest.raises(TypeError):
        gcu.gaussian_sketch(torch.tensor(x), 64, 0, W)
    with pytest.raises(TypeError):
        temb.HwPrngGaussianEmbedding(64, 300, device="cpu", dtype=torch.complex128)


def test_unsupported_arguments_raise():
    with pytest.raises(ValueError):
        gcu.gaussian_strip(64, 0, 0, block_rows=254, device="cpu")
    with pytest.raises(ValueError):
        gcu.gaussian_sketch(torch.ones(10, 2), 64, 0, dist="uniform")
    with pytest.raises(ValueError):
        gcu.gaussian_sketch(torch.ones(10, 2, 2), 64, 0)


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
def test_strip_statistics_and_reproducibility(dist):
    """As the JAX package's on-TPU test (k = 256, W = 2048)."""
    def strip(seed, b):
        return gcu.gaussian_strip_plain(256, seed, b, 2048, dist, device="cpu").numpy()

    S0 = strip(7, 0)
    assert np.array_equal(S0, strip(7, 0))
    assert not np.allclose(S0, strip(7, 1))
    assert not np.allclose(S0, strip(8, 0))
    v = S0.ravel()
    assert abs(v.mean()) < 5e-3
    assert abs(v.std() - 1.0) < 5e-3
    if dist == "rademacher":
        assert set(np.unique(v)) == {-1.0, 1.0}
    else:
        assert v.min() < -3.5 and v.max() > 3.5


_STRIP_CHILD = r"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch

(jnp.ones(3) * 2.0).sum().block_until_ready()  # XLA is initialised
from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

two = [gcu.gaussian_strip_plain(256, 7, 0, 2048, "normal", device="cpu") for _ in range(2)]
np.save(sys.argv[1], torch.stack(two).numpy())
print(torch.get_num_threads())
"""


def _box_muller_f64(k: int, seed: int, b: int, width: int) -> np.ndarray:
    """Strip b in pairs mode (k % 128 == 0) by numpy: the float32 uniforms
    of the contract, Box-Muller in float64, rounded once to float32."""
    out = np.empty((k, width), np.float32)
    for p in range(k // 128):
        u1, u2 = (philox.bits_to_unit(philox.draw_bits(
            seed, torch.tensor([b]), 2 * p + j, 64, width))[0].double().numpy()
            for j in (0, 1))
        radius = np.sqrt(-2.0 * np.log1p(-u1))
        out[128 * p:128 * p + 64] = radius * np.cos(2.0 * np.pi * u2)
        out[128 * p + 64:128 * p + 128] = radius * np.sin(2.0 * np.pi * u2)
    return out


def test_plain_strip_is_deterministic_with_xla_initialised(philox_pallas, tmp_path):
    """The plain strip gives the same bits on every call in a process that
    initialised XLA, torch at its default thread count: a fresh process
    draws strip 0 twice (k = 256, W = 2048, a (64, 2048) draw is 4 of
    torch's intra-op grains). Both are within 1e-5 of the JAX kernel, and
    bit-equal to Box-Muller evaluated in float64 and rounded once, which
    torch's float32 log1p / sqrt / cos / sin are not. About 12 s: the
    process imports JAX and torch, and the JAX kernel draws in interpret
    mode."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")}
    env["PYTHONPATH"] = str(ROOT)
    out = tmp_path / "strips.npy"
    subprocess.run([sys.executable, "-c", _STRIP_CHILD, str(out)], cwd=ROOT, env=env,
                   capture_output=True, text=True, timeout=300, check=True)
    first, second = np.load(out)
    assert np.array_equal(first, second)
    ref = np.asarray(jgp.gaussian_strip(256, 7, 0, block_rows=2048, dist="normal",
                                        interpret=True))
    assert np.abs(first - ref).max() <= 1e-5
    assert np.array_equal(first, _box_muller_f64(256, 7, 0, 2048))


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
def test_hwprng_source_array_matches_jax(philox_pallas, dist):
    """``source_array()`` of the port's HwPrng embedding (the plain strips,
    on the CPU) is the JAX package's ``random_matrix()`` transposed: four
    strips, the last one cut at n, the cos-half draw order at k = 200."""
    n, k = 3 * W + 37, 200
    je = jemb.HwPrngGaussianEmbedding.make(n, range_dim=k, seed=5, block_rows=W, dist=dist)
    te = temb.HwPrngGaussianEmbedding.make(n, range_dim=k, seed=5, block_rows=W, dist=dist,
                                           device="cpu")
    launches = gcu.gaussian_strip.launches, gcu.gaussian_omega.launches
    got = te.source_array()
    assert got.shape == (n, k)
    assert (gcu.gaussian_strip.launches, gcu.gaussian_omega.launches) == launches
    assert rel(got, np.asarray(je.random_matrix()).T) < 1e-5
    assert torch.equal(te.range_array(), got)


# ---------------------------------------------------------------------------
# the embedding and the sketched greedy over it


@pytest.fixture(scope="module")
def foms():
    return JaxFOM((2, 2), 16), ThermalBlockFOM((2, 2), 16, device="cpu")


@pytest.fixture(scope="module")
def small_foms():
    """Grid 8 (n = 49) for the reductor and greedy tests: the interpret-mode
    JAX kernel's cost grows with the snapshots and extensions."""
    return JaxFOM((2, 2), 8), ThermalBlockFOM((2, 2), 8, device="cpu")


def _hw_pair(foms, k=256, seed=1, dist="normal", use_sqrt=True):
    jfom, tfom = foms
    n = jfom.solution_dim
    jq, tq = (jfom.h1_0_product.sqrt, tfom.h1_0_product.sqrt) if use_sqrt else (None, None)
    je = jemb.HwPrngGaussianEmbedding.make(n, sqrt_product=jq, range_dim=k, seed=seed,
                                           block_rows=W, dist=dist)
    te = temb.HwPrngGaussianEmbedding.make(n, sqrt_product=tq, range_dim=k, seed=seed,
                                           block_rows=W, dist=dist, device="cpu")
    return je, te


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
@pytest.mark.parametrize("use_sqrt", [False, True], ids=["l2", "h1_0"])
def test_embedding_matches_jax(philox_pallas, foms, dist, use_sqrt):
    je, te = _hw_pair(foms, k=100 if dist == "normal" else 256, dist=dist,
                      use_sqrt=use_sqrt)
    U = np.random.RandomState(0).normal(size=(225, 4))
    out = te.apply(torch.tensor(U))
    assert rel(out, je.apply(jnp.asarray(U))) < 1e-5
    assert rel(te.random_matrix(), je.random_matrix()) < 1e-5
    assert rel(out, te.matrix() @ torch.tensor(U)) < 1e-5
    assert rel(te.apply(torch.tensor(U[:, 1])), je.apply(jnp.asarray(U[:, 1]))) < 1e-5
    for e in (te.with_seed(3), te.with_range_dim(128)):
        assert (e.block_rows, e.dist) == (W, dist)
    assert te.with_range_dim(128).range_dim == 128 and te.with_seed(3).seed == 3


class _CarriedGaussian(temb.GaussianEmbedding):
    """A port Gaussian whose redraws (``with_seed``, ``with_range_dim``)
    carry the JAX package's Omega for the same (range_dim, seed)."""

    made: dict = {}

    @classmethod
    def carried(cls, k, n, seed):
        key = (k, n, seed)
        if key not in cls.made:
            omega = np.asarray(jemb.GaussianEmbedding(k, n, seed).random_matrix())
            cls.made[key] = cls.from_matrix(omega, seed=seed, device="cpu")
        return cls.made[key]

    def with_seed(self, seed):
        return self.carried(self.range_dim, self.source_dim, seed)

    def with_range_dim(self, range_dim):
        return self.carried(range_dim, self.source_dim, self.seed)


def _mus(count, seed):
    rows = np.random.RandomState(seed).uniform(0.1, 1.0, size=(count, 4))
    return ([{"diffusion": jnp.asarray(r)} for r in rows],
            [{"diffusion": torch.tensor(r)} for r in rows])


def _hw_reductors(foms, dist, k_online=128):
    jfom, tfom = foms
    je, te = _hw_pair(foms, dist=dist)
    jphi = jemb.GaussianEmbedding.make(256, range_dim=k_online, seed=7)
    tphi = _CarriedGaussian.carried(k_online, 256, 7)
    jred = JaxReductor(jfom, embedding_primal=je, embedding_online=jphi,
                       product=jfom.h1_0_product, log_level=30)
    tred = SketchedReductor(tfom, embedding_primal=te, embedding_online=tphi,
                            product=tfom.h1_0_product, log_level=30)
    return jred, tred


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
def test_hwprng_reductor_matches_jax(philox_pallas, small_foms, dist):
    """The JAX package's on-TPU integration test, in both packages. About 6 s
    for "normal" (the first of the file at k = 256): six sketch calls on
    each side, each drawing a (256, 256) Philox strip, the JAX kernel in
    interpret mode and compiled for each new shape; the grid does not set
    that cost."""
    jfom, tfom = small_foms
    jred, tred = _hw_reductors(small_foms, dist)
    jmus, tmus = _mus(3, 3)
    jred.extend_basis(jfom.solve_many(jmus))
    tred.extend_basis(tfom.solve_many(tmus))
    assert tred.srb.dtype == torch.float32  # the in-kernel sketch is float32
    assert rel(tred.srb, jred.srb) < 1e-5
    assert rel(tred.residual_lhs.stack, jred.residual_lhs.stack) < 1e-5
    jrom, trom = jred.reduce(seed=11), tred.reduce(seed=11)
    for t, j in ((trom.lhs, jrom.lhs), (trom.rhs, jrom.rhs),
                 (trom.error_estimator.lhs, jrom.error_estimator.lhs),
                 (trom.error_estimator.rhs, jrom.error_estimator.rhs)):
        assert rel(t.stack, j.stack) < 1e-5
    jt, tt = _mus(6, 4)
    ju, jest = jrom.solve_and_estimate_batch(
        {"diffusion": jnp.stack([m["diffusion"] for m in jt])})
    tu, test_ = trom.solve_and_estimate_batch(mu_stack(tt))
    assert rel(tu, ju) < 1e-5
    assert rel(test_, jest) < 1e-5
    # the estimator tracks the true Riesz residual of the lifted solution
    u = tred.reconstruct(tu[0]).numpy()
    r = tfom.assemble_sparse(tt[0]) @ u - tfom.assemble_rhs(tt[0])
    true = float(np.sqrt(r @ tfom.h1_0_product.inv.apply_host(r)))
    assert 0.3 * true < float(test_[0]) < 3.0 * true


def test_hwprng_greedy_selects_the_same_parameters(philox_pallas, small_foms):
    jfom, tfom = small_foms
    jred, tred = _hw_reductors(small_foms, "normal")
    jmus, tmus = _mus(20, 7)
    jres = jax_rb_greedy(jfom, jred, jmus, max_extensions=3, log_level=30)
    tres = rb_greedy(tfom, tred, tmus, max_extensions=3, log_level=30)

    def index(mu, mus):
        return next(i for i, m in enumerate(mus)
                    if np.array_equal(np.asarray(m["diffusion"]),
                                      np.asarray(mu["diffusion"])))

    assert [index(m, tmus) for m in tres.selected_mus] == \
        [index(m, jmus) for m in jres.selected_mus]
    assert rel(tres.max_estimates, jres.max_estimates) < 1e-5
    assert rel(tres.rom.lhs.stack, jres.rom.lhs.stack) < 1e-5
    assert rel(tres.rom.error_estimator.lhs.stack,
               jres.rom.error_estimator.lhs.stack) < 1e-5


# ---------------------------------------------------------------------------
# the small-m kernel's launch plan (ops/gaussian_cuda.py: slot_tiling,
# column_split): exact row count, and column ranges that cover [0, n) once.
# The kernel's own walk of its range is checked against the plain version by
# the cuda-marked SKETCH_CASES of test_torch_cuda.py.

SMALL_MAX_THREADS = 512  # the small kernel's launch bound (kSmallMaxThreads)


def _slot_rows(slot, k, dist):
    """Rows one slot fills: csrc/gaussian_sketch.cu ``slot_map``."""
    if dist == "rademacher":
        return [slot]
    if k % 128 == 0:
        row = 128 * (slot // 64) + slot % 64
        return [row, row + 64]
    return [slot]


SLOT_CASES = [(1, "normal"), (100, "normal"), (256, "normal"), (300, "normal"),
              (2048, "normal"), (1, "rademacher"), (300, "rademacher"), (1100, "rademacher")]


@pytest.mark.parametrize("k,dist", SLOT_CASES)
def test_small_slots_cover_exactly_k_rows(k, dist):
    slots, S, G = gcu.slot_tiling(k, dist, SMALL_MAX_THREADS)
    assert S % 32 == 0 and 32 <= S * G <= SMALL_MAX_THREADS
    tiles = -(-slots // S)
    assert (tiles - 1) * S < slots <= tiles * S  # no slot tile is idle
    rows = [r for s in range(slots) for r in _slot_rows(s, k, dist)]
    assert sorted(rows) == list(range(k))


PLAN_CASES = [
    (1, 256, "normal", 528),            # one column
    (2, 300, "normal", 1),              # one resident block
    (7, 300, "normal", 528),            # n % 4 != 0, fewer quads than blocks
    (8, 1, "rademacher", 1000),
    (1001, 100, "rademacher", 64),
    (4099, 1, "normal", 37),
    (5000, 300, "rademacher", 100),
    (65541, 256, "normal", 396),
    (261121, 256, "normal", 528),       # the HwPrng path's shape
    (261121, 300, "normal", 660),
    (1 << 23, 256, "normal", 528),      # the bench shape
]


@pytest.mark.parametrize("n,k,dist,resident", PLAN_CASES)
def test_small_plan_covers_every_column_once(n, k, dist, resident):
    slots, S, _ = gcu.slot_tiling(k, dist, SMALL_MAX_THREADS)
    tiles = -(-slots // S)
    n_split = gcu.column_split(n, tiles, resident)
    nq = -(-n // 4)
    # the grid fills the card's resident blocks, with no more ranges than quads
    assert 1 <= n_split <= nq
    assert n_split * tiles >= min(resident, nq * tiles)
    # the kernel's ranges: block z takes quads [z nq / n_split, (z + 1) nq / n_split)
    edges = [z * nq // n_split for z in range(n_split + 1)]
    assert edges[0] == 0 and edges[-1] == nq
    sizes = {b - a for a, b in zip(edges, edges[1:])}
    assert sizes <= {nq // n_split, nq // n_split + 1} and min(sizes) >= 1


# ---------------------------------------------------------------------------
# the tiled kernel (m > SMALL_M_MAX[dist]): its 3xTF32 product in plain torch,
# and its launch plan (ops/gaussian_cuda.py: tiled_instance, tiled_tiles,
# tiled_split). The kernel itself is held against the plain version by the
# cuda-marked TILED_CASES of test_torch_cuda.py.


def _tf32_reference(v):
    """Round-to-nearest, ties away from zero, to 10 mantissa bits, in
    float64 (finite, normal float32 values)."""
    v = np.asarray(v, dtype=np.float64)
    mant, exp = np.frexp(v)                      # v = mant 2^exp, |mant| in [0.5, 1)
    scaled = np.abs(mant) * 2.0 ** 11            # 11 significant bits
    return np.sign(v) * np.floor(scaled + 0.5) * 2.0 ** (exp - 11)


def test_tf32_round_is_cvt_rna():
    rs = np.random.RandomState(4)
    v = np.concatenate([rs.normal(size=4000) * 10.0 ** rs.uniform(-6, 6, size=4000),
                        [1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 3 * 2 ** -12,
                         2 ** -126, 3.0, 0.0]]).astype(np.float32)
    got = gcu.tf32_round(torch.tensor(v)).double().numpy()
    assert np.array_equal(got, _tf32_reference(v.astype(np.float64)))
    # ties go away from zero; 10 mantissa bits are kept
    assert got[-6] == 1 + 2 ** -10 and got[-5] == -(1 + 2 ** -10)
    assert bool(((gcu.tf32_round(torch.tensor(v)).view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("dist", ["normal", "rademacher"])
@pytest.mark.parametrize("m", [9, 64])
def test_3xtf32_product_matches_the_strip_oracle(dist, m):
    """The tiled kernel's 3-pass product (2 for Rademacher, whose strips are
    exact in TF32) of a (k, n) strip set with an (n, m) block is within 1e-5
    relative of the float64 product; one pass of plain TF32 is not."""
    k, n, Wd = 256, 3 * W + 37, W
    S = philox.strips(k, 11, torch.arange(-(-n // Wd)), Wd, dist)
    omega = S.permute(1, 0, 2).reshape(k, -1)[:, :n]
    X = torch.tensor(np.random.RandomState(m).normal(size=(n, m)).astype(np.float32))
    oracle = omega.double() @ X.double()
    passes = 3 if dist == "normal" else 2
    assert rel(gcu.product_3xtf32(omega, X, passes), oracle) < 1e-5
    if dist == "rademacher":
        assert torch.equal(gcu.tf32_round(omega), omega)
    assert rel(gcu.product_3xtf32(omega, X, 1), oracle) > 1e-4


TILED_PLANS = [
    (1, 9, 256, "normal", 2048, 132),        # one column: one tile
    (37, 12, 300, "normal", 100, 132),       # W not a multiple of 32
    (5003, 9, 128, "rademacher", 4, 132),    # W = 4: a tile per strip
    (65541, 40, 100, "normal", 2048, 132),
    (70001, 129, 256, "normal", 2048, 132),  # two column chunks
    (20011, 257, 256, "rademacher", 2048, 66),
    (261121, 12, 256, "normal", 2048, 132),  # [hwprng block]'s blocks
    (1 << 23, 128, 256, "normal", 2048, 132),  # the bench shape
]


@pytest.mark.parametrize("n,m,k,dist,W,resident", TILED_PLANS)
def test_tiled_plan_covers_every_tile_once(n, m, k, dist, W, resident):
    """Every (tile, k-tile, column chunk) is taken by exactly one (block,
    k-group), and the tiles cover every column of [0, n) once."""
    chunk = gcu.TILED_CHUNK
    ntw, kg = gcu.tiled_instance(m)
    assert 8 * ntw >= min(m, chunk) and (ntw == 1 or 4 * ntw < min(m, chunk))
    T = gcu.tiled_tiles(n, W)
    n_split = gcu.tiled_split(T, k, m, resident)
    k_tiles, chunks = -(-k // 128), -(-m // chunk)
    assert 1 <= n_split <= T
    assert n_split * k_tiles * chunks >= min(resident, T * k_tiles * chunks)
    # the kernel's ranges and the k-groups' round-robin, as it walks them
    taken = np.zeros(T, dtype=np.int64)
    for z in range(n_split):
        t0, t1 = z * T // n_split, (z + 1) * T // n_split
        for g in range(kg):
            tiles = np.arange(t0 + g, t1, kg)
            taken[tiles] += 1
    assert np.all(taken == 1)  # once per (k-tile, chunk): the grid's other two axes
    # tile t is columns [32 (t % tps), +32) of strip t // tps, cut at W and n
    tps = -(-W // 32)
    t = np.arange(T)
    start = (t // tps) * W + (t % tps) * 32
    stop = np.minimum((t // tps) * W + np.minimum((t % tps) * 32 + 32, W), n)
    assert np.all(stop > start) and start[0] == 0 and stop[-1] == n
    assert np.array_equal(start[1:], stop[:-1])  # no gap, no overlap


# ---------------------------------------------------------------------------
# the explicit Omega (ops/gaussian_cuda.py: gaussian_omega, its plain
# version and omega_plan). The kernel itself is held against the plain
# version by the cuda-marked OMEGA_CASES of test_torch_cuda.py.

OMEGA_CASES = [(k, dist, n, Wd)
               for k, dist in ((200, "normal"), (256, "normal"), (300, "rademacher"))
               for Wd, cols in ((100, (1036, 1037, 1039)), (2048, (2084, 2085, 2087)))
               for n in cols]


@functools.lru_cache(maxsize=None)
def _cut_scaled_strips(k, dist, Wd, n):
    """The plain strips side by side, cut at n and multiplied by the float32
    1/sqrt(k); the strips are drawn once per (k, dist, W) for the longest n
    of OMEGA_CASES (the plain Box-Muller is float64, seconds on a loaded
    CPU)."""
    longest = max(c[2] for c in OMEGA_CASES if c[0] == k and c[3] == Wd)
    return _strips_once(k, dist, Wd, -(-longest // Wd))[:, :n] * gcu.omega_scale(k)


@functools.lru_cache(maxsize=None)
def _strips_once(k, dist, Wd, n_strips):
    return torch.cat([gcu.gaussian_strip_plain(k, 9, b, Wd, dist, device="cpu")
                      for b in range(n_strips)], dim=1)


@pytest.mark.parametrize("k,dist,n,Wd", OMEGA_CASES)
def test_omega_plain_is_the_cut_scaled_strips(k, dist, n, Wd):
    """The Omega is the plain strips side by side, cut at n and multiplied
    by the float32 1/sqrt(k), bit for bit (n % 4 in {0, 1, 3}, n % W != 0;
    cos halves, pairs and Rademacher): on the CPU ``gaussian_omega`` is
    ``gaussian_omega_plain`` and launches nothing."""
    assert gcu.omega_scale(k) == np.float32(1.0 / np.sqrt(k))
    launches = gcu.gaussian_omega.launches
    got = gcu.gaussian_omega(k, n, 9, Wd, dist, device="cpu")
    assert gcu.gaussian_omega.launches == launches
    assert got.dtype == torch.float32 and got.shape == (k, n)
    assert torch.equal(got, _cut_scaled_strips(k, dist, Wd, n))
    if dist == "rademacher":
        assert set(torch.unique(got * np.sqrt(k)).tolist()) <= {-1.0, 1.0}


def test_omega_plain_takes_a_float32_scale():
    """``gaussian_omega_plain``'s ``scale`` is rounded to float32 and
    multiplies the cut strips (scale 1 gives the unscaled strips)."""
    strips = torch.cat([gcu.gaussian_strip_plain(64, 3, b, 8, "normal", device="cpu")
                        for b in range(3)], dim=1)[:, :21]
    assert torch.equal(gcu.gaussian_omega_plain(64, 21, 3, 8, "normal", "cpu", 1.0), strips)
    third = float(np.float32(1.0 / 3.0))
    assert torch.equal(gcu.gaussian_omega_plain(64, 21, 3, 8, "normal", "cpu", 1.0 / 3.0),
                       strips * third)


def _omega_walk(n_cols, k, dist, Wd, b0, ranges, blocks, warps_per_block, slots_per_warp):
    """The Omega kernel's walk (csrc/gaussian_sketch.cu
    ``gaussian_omega_kernel``) in Python: per warp its tasks (a group of
    slots and a quad range), per lane its quad and its place in the strips
    (advanced by 32 quads with the kernel's wrap), per warp store the
    staged columns. Returns how often each (row, column) is stored, and
    checks on the way that every stored value is the right quad's word."""
    qps = Wd // 4
    slots = k // 2 if dist == "normal" and k % 128 == 0 else k
    groups = -(-slots // slots_per_warp)
    nq = -(-n_cols // 4)
    stored = np.zeros((k, n_cols), dtype=np.int64)
    lanes = np.arange(32)
    # warp store i, lane l stores staged float 32 i + l: word (32 i + l) % 4
    # of lane (32 i + l) // 4's quad
    src, word = np.divmod(32 * np.arange(4)[:, None] + lanes, 4)        # (4, 32)
    warps = blocks * warps_per_block
    for w in range(warps):
        for t in range(w, groups * ranges, warps):
            # a slot past the last repeats the group's first (the same values
            # to the same places)
            first = t // ranges * slots_per_warp
            group = [s if s < slots else first for s in range(first, first + slots_per_warp)]
            rows = sorted({r for s in group for r in _slot_rows(s, k, dist)})
            z = t % ranges
            q_beg, q_end = z * nq // ranges, (z + 1) * nq // ranges
            c_beg, c_end = 4 * q_beg, min(4 * q_end, n_cols)
            iters, full = -(-(q_end - q_beg) // 32), (c_end - c_beg) // 128
            b, j4 = b0 + (q_beg + lanes) // qps, (q_beg + lanes) % qps
            for it in range(iters):
                q0 = q_beg + 32 * it
                # lane l's quad q0 + l lies at column j4 of strip b
                assert np.array_equal(b * qps + j4, b0 * qps + q0 + lanes)
                c = 4 * (q0 + src) + word   # the column each store writes
                assert np.array_equal(c, c_beg + 128 * it + 32 * np.arange(4)[:, None] + lanes)
                rest = 128 if it < full else c_end - c_beg - 128 * it
                c = c[32 * np.arange(4)[:, None] + lanes < rest]
                assert np.all(c < c_end)
                for r in rows:
                    stored[r, c] += 1
                j4 = j4 + 32
                while np.any(j4 >= qps):
                    wrap = j4 >= qps
                    j4, b = np.where(wrap, j4 - qps, j4), np.where(wrap, b + 1, b)
    return stored


OMEGA_PLANS = [
    # n_cols, k, dist, W, b0, resident blocks, warps a block, slots a warp
    (1, 200, "normal", 2048, 0, 528, 8, 2),        # one column
    (7, 128, "normal", 4, 3, 528, 8, 2),           # W = 4: 32 strips a step
    (1037, 200, "normal", 100, 0, 528, 8, 2),      # qps = 25 < 32, n % 4 = 1
    (1039, 256, "normal", 100, 2, 3, 8, 2),        # pairs; fewer warps than groups
    (2048, 300, "rademacher", 2048, 513, 528, 8, 2),  # one strip from b0
    (4133, 301, "rademacher", 2048, 0, 20, 4, 2),  # a short group; warps loop
    (6181, 64, "normal", 2048, 0, 132, 8, 2),      # (3 W + 37): ranges cross strips
    (4133, 199, "normal", 2048, 0, 132, 8, 3),     # 3 slots a warp, short group
    (1037, 200, "normal", 100, 0, 528, 8, 1),      # 1 slot a warp
]


@pytest.mark.parametrize("n_cols,k,dist,Wd,b0,resident,wpb,spw", OMEGA_PLANS)
def test_omega_walk_covers_every_entry_once(n_cols, k, dist, Wd, b0, resident, wpb, spw):
    """Every (row, column) of [0, k) x [0, n_cols) is stored exactly once by
    the kernel's persistent walk under ``omega_plan``, across strip
    boundaries, and every stored value is its column's word."""
    ranges, blocks = gcu.omega_plan(n_cols, k, dist, resident, wpb, spw)
    stored = _omega_walk(n_cols, k, dist, Wd, b0, ranges, blocks, wpb, spw)
    assert np.all(stored == 1)


@pytest.mark.parametrize("n_cols,k,dist", [
    (1_050_625, 200, "normal"),      # [precond hwprng]'s Omega
    (261_121, 256, "normal"), (261_121, 256, "rademacher"),
    (2048, 200, "normal"), (2048, 256, "normal"),   # one strip
    (5, 10_000, "normal"),
])
@pytest.mark.parametrize("resident", [132, 528, 1056])
def test_omega_plan_fills_the_card(n_cols, k, dist, resident):
    """At the path's shapes the plan gives one task to a warp, as many as
    the card holds at once, ranges of at least 32 quads (a quad a lane),
    and no more blocks than resident ones."""
    wpb, spw = 8, 2
    ranges, blocks = gcu.omega_plan(n_cols, k, dist, resident, wpb, spw)
    slots = k // 2 if dist == "normal" and k % 128 == 0 else k
    groups = -(-slots // spw)
    nq = -(-n_cols // 4)
    assert 1 <= ranges <= max(1, nq // 32) or ranges == 1
    assert 1 <= blocks <= resident
    tasks, warps = groups * ranges, blocks * wpb
    if groups <= resident * wpb:
        assert tasks <= warps < tasks + wpb  # one task a warp, no idle block
        # no more ranges would fit: either the card or the quads are used up
        assert groups * (ranges + 1) > resident * wpb or ranges == -(-nq // 32)
    else:
        assert ranges == 1 and blocks == resident
    edges = [z * nq // ranges for z in range(ranges + 1)]
    assert edges[0] == 0 and edges[-1] == nq
    assert min(b - a for a, b in zip(edges, edges[1:])) >= min(32, nq)
