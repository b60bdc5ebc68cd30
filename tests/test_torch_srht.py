"""The port's one-pass SRHT (kernel wrapper, plain version, embedding
dispatch) held against the JAX package.

Inputs come from numpy with a seed; the SRHT plan is carried from the JAX
package's ``_srht_plan``. Pallas kernels run in interpret mode, as their
own tests run them on the CPU. On the CPU the wrapper runs the kernel's
plain version; the kernel itself is compared with it on the card in
``test_torch_cuda.py``.
"""

import itertools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rla4mor_tpu.ops.srht_pallas as jsp
from rla4mor_tpu.ops.embeddings import SrhtEmbedding as JaxSrht
from rla4mor_tpu.ops.fwht import _srht_plan as jax_srht_plan
from rla4mor_tpu.ops.fwht import srht as jax_srht

from rla4mor_tpu_torch.ops import srht_cuda
from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
from rla4mor_tpu_torch.ops.fwht import _srht_plan, srht

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


def jax_plan(seed, n, k):
    signs, sampling, d = jax_srht_plan(jax.random.key(seed), n, k)
    return (torch.tensor(np.array(signs)), torch.tensor(np.array(sampling)), d)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jsp.pl, "pallas_call", patched)


@pytest.mark.parametrize("n", [1 << 10, (1 << 13) + 37, 65536 + 5])
def test_plain_onepass_matches_jax_srht(n):
    k, m = 96, 3
    x = np.random.RandomState(n).normal(size=(m, n))
    ref = np.asarray(jax_srht(jnp.asarray(x), k, jax.random.key(5)))   # (m, k)
    signs, sampling, d = jax_plan(5, n, k)
    out = srht_cuda.srht_onepass_plain(torch.tensor(x.T), k, signs, sampling)
    assert rel(out.T, ref) < 1e-12
    # the wrapper takes the plain version for a CPU tensor, from any strides
    wrapped = srht_cuda.srht_onepass(torch.tensor(x).T, k, signs, sampling)
    assert torch.equal(wrapped, out) or rel(wrapped, out) < 1e-14
    # the port's Kronecker FWHT SRHT carries the same plan
    assert rel(srht(torch.tensor(x), k, (signs, sampling, d)), ref) < 1e-12


@pytest.mark.parametrize("n", [1, (1 << 11) - 1, 1 << 11, (1 << 11) + 1])
def test_plain_onepass_matches_jax_srht_at_block_boundaries(n):
    """n on either side of the kernel's block length R = 2^11, on it, and
    n = 1; past 2^11 the plan samples rows with high bits (sigma >> 11 > 0),
    which take the +-1 recombination over blocks."""
    k, m = 64, 2
    x = np.random.RandomState(n).normal(size=(m, n))
    ref = np.asarray(jax_srht(jnp.asarray(x), k, jax.random.key(8)))
    signs, sampling, _ = jax_plan(8, n, k)
    if n > 1 << 11:
        assert int((sampling >> 11).max()) > 0
    out = srht_cuda.srht_onepass_plain(torch.tensor(x.T), k, signs, sampling)
    assert rel(out.T, ref) < 1e-12


@pytest.mark.parametrize("itemsize", [4, 8])
def test_launch_plan_covers_the_blocks_once(itemsize):
    """The wrapper's launch plan: a tile as wide as the columns allow, unless
    its blocks would give the SMs few each, that fits shared memory with aligned
    columns, and block ranges [z bpc, min(B, (z + 1) bpc)) that cover the
    B = ceil(n / R) blocks once, one wave where the tiles allow."""
    R = 1 << srht_cuda._R_LOG
    sms = 132
    for m, rows_layout in itertools.product((1, 2, 3, 8, 9, 56), (False, True)):
        widest = min(srht_cuda._MT_MAX[rows_layout], 1 << (m - 1).bit_length())
        fill = srht_cuda._FILL_BLOCKS_PER_SM * sms
        for n in (1, R - 1, R, R + 1, 261_121, 1 << 24):
            n_blocks = -(-n // R)
            mt = srht_cuda.tile_width(n, m, rows_layout, sms)
            assert mt & (mt - 1) == 0 and mt <= widest
            # as wide as it goes while the tiles give every SM enough blocks
            assert mt == widest or -(-m // (2 * mt)) * n_blocks < fill
            assert mt == 1 or -(-m // mt) * n_blocks >= fill or mt == widest
            ld, smem = srht_cuda.tile(mt, itemsize)
            assert ld >= R and ld * itemsize % 16 == 0
            assert smem <= 232_448  # a CTA's shared memory on the H100
            for k, resident in ((1, 132), (300, 1056), (1025, 132)):
                bpc, n_split = srht_cuda.block_split(n, m, k, mt, 1024, resident)
                covered = [b for z in range(n_split)
                           for b in range(z * bpc, min(n_blocks, (z + 1) * bpc))]
                assert covered == list(range(n_blocks))
                assert (n_split - 1) * bpc < n_blocks
                tiles = -(-m // mt) * -(-k // 1024)
                assert n_split * tiles <= max(resident, tiles)


def test_complex_input_sketches_real_and_imaginary_parts():
    n, k = 5000, 40
    rs = np.random.RandomState(1)
    x = rs.normal(size=(n, 2)) + 1j * rs.normal(size=(n, 2))
    ref = np.asarray(jax_srht(jnp.asarray(x.T), k, jax.random.key(2))).T
    signs, sampling, _ = jax_plan(2, n, k)
    out = srht_cuda.srht_onepass(torch.tensor(x), k, signs, sampling)
    assert out.is_complex()
    assert rel(out, ref) < 1e-12


@pytest.mark.parametrize("m,d,k", [(5, 10, 64), (3, 13, 200)])
def test_plain_matches_srht_pallas(interpret_pallas, m, d, k):
    x = np.random.RandomState(d).normal(size=(m, 1 << d)).astype(np.float32)
    ref = np.asarray(jsp.srht_pallas(jnp.asarray(x), k, jax.random.key(7),
                                     jax.lax.Precision.HIGHEST))
    signs, sampling, _ = jax_plan(7, 1 << d, k)
    out = srht_cuda.srht_onepass(torch.tensor(x).T, k, signs, sampling)
    assert out.dtype == torch.float32
    assert rel(out.T, ref) < 1e-5


def test_plain_matches_srht_pallas_packed(interpret_pallas):
    m, d, k = 4, 16, 64
    x = np.random.RandomState(d).normal(size=(m, 1 << d)).astype(np.float32)
    ref = np.asarray(jsp.srht_pallas_packed(
        jnp.asarray(x), k, jax.random.key(7), jax.lax.Precision.HIGHEST,
        block_rows=2))
    signs, sampling, _ = jax_plan(7, 1 << d, k)
    out = srht_cuda.srht_onepass(torch.tensor(x).T, k, signs, sampling)
    assert rel(out.T, ref) < 1e-5


N_BIG = 65536 + 5  # >= 2^16: both packages take the one-pass branch


@pytest.fixture(scope="module")
def big_pair():
    k, seed = 80, 4
    je = JaxSrht(k, N_BIG, seed)
    signs, sampling, _ = jax_srht_plan(je.key, N_BIG, k)
    te = SrhtEmbedding.from_plan(N_BIG, k, np.array(signs), np.array(sampling),
                                 device="cpu")
    return je, te


@pytest.mark.parametrize("shape", [(N_BIG,), (N_BIG, 3), (N_BIG, 130)],
                         ids=["vector", "cols_m3", "cols_m130"])
def test_embedding_apply_random_matches_jax(big_pair, shape, monkeypatch):
    je, te = big_pair
    calls = []
    orig = srht_cuda.srht_onepass

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    import rla4mor_tpu_torch.ops.embeddings as temb
    monkeypatch.setattr(temb, "srht_onepass", counted)
    x = np.random.RandomState(len(shape)).normal(size=shape)
    ref = np.asarray(je.apply_random(jnp.asarray(x)))
    out = te.apply_random(torch.tensor(x))
    assert calls, "n >= 2^16 must take the one-pass SRHT"
    assert rel(out, ref) < 1e-12


def test_embedding_blocked_input_matches_jax(big_pair):
    je, te = big_pair
    x = np.random.RandomState(9).normal(size=(N_BIG, 3))
    assert te.blocked_shape == je.blocked_shape
    jb = je.to_blocked(jnp.asarray(x))
    tb = te.to_blocked(torch.tensor(x))
    assert np.array_equal(np.asarray(tb), np.asarray(jb))
    assert rel(te.apply_random(tb), je.apply_random(jb)) < 1e-12
    assert rel(te.apply_random(tb), te.apply_random(torch.tensor(x))) < 1e-13


@pytest.mark.parametrize("shape", [(1000,), (1000, 5)])
def test_small_n_fwht_branch_matches_jax(shape):
    k = 50
    je = JaxSrht(k, 1000, 6)
    signs, sampling, _ = jax_srht_plan(je.key, 1000, k)
    te = SrhtEmbedding.from_plan(1000, k, np.array(signs), np.array(sampling),
                                 device="cpu")
    x = np.random.RandomState(3).normal(size=shape)
    assert rel(te.apply_random(torch.tensor(x)),
               je.apply_random(jnp.asarray(x))) < 1e-12


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """int32 and 3-D input raise; bf16, which the kernel takes, is sketched:
    on the CPU, the plain version of the input widened to float32 (1e-6
    relative to max, float32 sums; bf16 output within one rounding)."""
    signs, sampling, _ = _srht_plan(0, 100, 8)
    x = torch.tensor(np.random.RandomState(0).normal(size=(100, 2))).to(torch.bfloat16)
    out = srht_cuda.srht_onepass(x, 8, signs, sampling, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert rel(out, srht_cuda.srht_onepass_plain(x.float(), 8, signs, sampling)) < 1e-6
    narrow = srht_cuda.srht_onepass(x, 8, signs, sampling)
    assert narrow.dtype == torch.bfloat16
    assert rel(narrow.float(), out) < 2.0 ** -7
    with pytest.raises(TypeError):
        srht_cuda.srht_onepass(torch.ones(100, 2, dtype=torch.int32), 8,
                               signs, sampling)
    with pytest.raises(ValueError):
        srht_cuda.srht_onepass(torch.ones(100, 2, 1), 8, signs, sampling)


def test_plan_is_seeded_and_in_range():
    a = _srht_plan(3, 5000, 64)
    b = _srht_plan(3, 5000, 64)
    c = _srht_plan(4, 5000, 64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[2] == 13 and int(a[1].max()) < 1 << 13 and int(a[1].min()) >= 0
    assert set(a[0].tolist()) == {-1, 1}
