"""The one-pass SRHT kernel and the port's slice on an NVIDIA GPU.

Every test here needs the card (a CUDA kernel has no CPU mode) and skips
without one. The file imports no JAX, so it also runs where JAX is not
installed; there, skip the JAX-importing ``tests/conftest.py``:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each case compares the kernel with its plain PyTorch version on the same
CUDA tensor. Tolerances, relative to max|ref|: 1e-12 in float64, 1e-4 in
float32 (the two sum in different orders).
"""

import pytest
import torch

from rla4mor_tpu_torch.ops import srht_cuda
from rla4mor_tpu_torch.ops import embeddings as temb
from rla4mor_tpu_torch.ops.fwht import _srht_plan

# one intra-op thread: the tier-1 run has 6 pytest workers on 8 cores, and
# torch's default thread pool in each of them oversubscribes the CPU
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.float64: 1e-12}
# 2-byte input against the plain version, both emitting float32: the same
# float32 sums in other orders
TOL_2BYTE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def rel_err(out, ref):
    scale = ref.abs().max().clamp_min(torch.finfo(ref.dtype).tiny)
    return ((out - ref).abs().max() / scale).item()


def _input(n, m, layout, dtype, device):
    g = torch.Generator(device=device).manual_seed(n * 31 + m)
    if layout == "cols":
        return torch.randn((n, m), generator=g, device=device, dtype=dtype)
    if layout == "rows":
        return torch.randn((m, n), generator=g, device=device, dtype=dtype).T
    if layout == "every_other_row":
        return torch.randn((2 * n, m), generator=g, device=device, dtype=dtype)[::2]
    if layout == "column_slice":
        return torch.randn((n, m + 2), generator=g, device=device, dtype=dtype)[:, 1:-1]
    raise ValueError(layout)


CASES = [
    (1, 1, 1, "cols"),
    (7, 3, 129, "cols"),
    (256, 2, 300, "rows"),
    (257, 9, 64, "cols"),
    (4099, 4, 300, "every_other_row"),
    (65541, 1, 300, "rows"),
    (65541, 9, 129, "column_slice"),
    (261121, 1, 300, "cols"),
    (261121, 8, 300, "rows"),
    # either side of a block boundary of R = 2^11, and on it
    (2047, 3, 100, "cols"),
    (2048, 2, 100, "rows"),
    (2049, 5, 100, "every_other_row"),
    # one sampled row; more sampled rows than a CTA's threads
    (5000, 2, 1, "cols"),
    (70001, 3, 513, "rows"),
    # the bench width in both layouts
    (1 << 20, 56, 256, "rows"),
    (1 << 20, 56, 256, "cols"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,m,k,layout", CASES)
def test_kernel_matches_plain(cuda, n, m, k, layout, dtype):
    x = _input(n, m, layout, dtype, cuda)
    signs, sampling, _ = _srht_plan(n, n, k)
    before = srht_cuda.srht_onepass.launches
    out = srht_cuda.srht_onepass(x, k, signs, sampling)
    torch.cuda.synchronize()
    assert srht_cuda.srht_onepass.launches == before + 1
    assert out.shape == (k, m) and out.dtype == dtype and out.is_cuda
    ref = srht_cuda.srht_onepass_plain(x, k, signs, sampling)
    assert rel_err(out, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("n,m,k,layout", CASES)
def test_2byte_kernel_matches_plain(cuda, n, m, k, layout, dtype):
    """The 2-byte instance (float32 sums) against the plain version on the
    same CUDA tensor, float32 output (1e-4) and the input's dtype (one
    rounding: 8e-3 bf16, 1e-3 f16)."""
    x = _input(n, m, layout, dtype, cuda)
    signs, sampling, _ = _srht_plan(n, n, k)
    before = srht_cuda.srht_onepass.launches_by_dtype[dtype]
    out = srht_cuda.srht_onepass(x, k, signs, sampling, out_dtype=torch.float32)
    narrow = srht_cuda.srht_onepass(x, k, signs, sampling)
    torch.cuda.synchronize()
    assert srht_cuda.srht_onepass.launches_by_dtype[dtype] == before + 2
    assert out.dtype == torch.float32 and narrow.dtype == dtype
    ref = srht_cuda.srht_onepass_plain(x, k, signs, sampling, out_dtype=torch.float32)
    assert rel_err(out, ref) < TOL_2BYTE
    assert rel_err(narrow.float(), ref) < (8e-3 if dtype == torch.bfloat16 else 1e-3)


def test_bf16_columns_and_misaligned_views_launch_the_kernel(cuda):
    """bf16 in the columns layout (one copy a tile row), with an odd column
    count, and misaligned views (an offset of one element, rows and columns;
    the element path) all launch the kernel, not the plain version, and
    agree with it (1e-4, float32 output)."""
    n, k = 70001, 300
    signs, sampling, _ = _srht_plan(5, n, k)
    base = torch.randn((n + 1) * 9, device=cuda).to(torch.bfloat16)
    views = {
        "cols m=8": base[: n * 8].view(n, 8),
        "cols m=7": base[: n * 7].view(n, 7),
        "cols offset 1": base[1: 1 + n * 8].view(n, 8),
        "rows offset 1": base[1: 1 + n * 3].view(3, n).T,
        "rows m=1 offset 1": base[1: 1 + n].view(n, 1),
    }
    for label, x in views.items():
        before = srht_cuda.srht_onepass.launches_by_dtype[torch.bfloat16]
        out = srht_cuda.srht_onepass(x, k, signs, sampling, out_dtype=torch.float32)
        assert srht_cuda.srht_onepass.launches_by_dtype[torch.bfloat16] == before + 1, label
        ref = srht_cuda.srht_onepass_plain(x, k, signs, sampling, out_dtype=torch.float32)
        assert rel_err(out, ref) < TOL_2BYTE, label


@pytest.mark.parametrize("n,m,layout", [(261121, 8, "cols"), (1 << 20, 56, "rows")])
def test_kernel_is_deterministic(cuda, n, m, layout):
    x = _input(n, m, layout, torch.float32, cuda)
    signs, sampling, _ = _srht_plan(0, n, 300)
    a = srht_cuda.srht_onepass(x, 300, signs, sampling)
    b = srht_cuda.srht_onepass(x, 300, signs, sampling)
    assert torch.equal(a, b)


def test_kernel_is_right_whatever_ran_before(cuda):
    """Every call on a stream shares the kernel's scratch (counters and
    partial sums): a call of one shape after calls of others is right."""
    runs = [(261121, 8, 300, "cols", torch.float64), (1 << 20, 56, 256, "rows", torch.float32),
            (70001, 3, 513, "rows", torch.float32), (1 << 20, 56, 256, "rows", torch.float32)]
    for n, m, k, layout, dtype in runs:
        x = _input(n, m, layout, dtype, cuda)
        signs, sampling, _ = _srht_plan(n, n, k)
        out = srht_cuda.srht_onepass(x, k, signs, sampling)
        assert rel_err(out, srht_cuda.srht_onepass_plain(x, k, signs, sampling)) < TOL[dtype]


def test_complex_input_launches_twice(cuda):
    """Complex input is sketched in one launch now (the name is the test's
    history: it launched twice, on stride-2 views): the (n, 2m) real view,
    real and imaginary parts side by side, equal to the parts' plain
    sketches; complex64 and a transposed (copied) input too."""
    n, m, k = 70000, 2, 50
    x = torch.complex(_input(n, m, "cols", torch.float64, cuda),
                      _input(n, m, "rows", torch.float64, cuda))
    signs, sampling, _ = _srht_plan(1, n, k)
    for xin, tol in ((x, 1e-12), (x.to(torch.complex64), TOL[torch.float32]),
                     (x.T.contiguous().T, 1e-12)):
        before = srht_cuda.srht_onepass.launches
        out = srht_cuda.srht_onepass(xin, k, signs, sampling)
        assert srht_cuda.srht_onepass.launches == before + 1
        assert out.dtype == xin.dtype
        ref = torch.complex(srht_cuda.srht_onepass_plain(xin.real, k, signs, sampling),
                            srht_cuda.srht_onepass_plain(xin.imag, k, signs, sampling))
        assert rel_err(out, ref) < tol


def test_unsupported_input_raises_on_the_card(cuda):
    """A plan that does not fit raises; bf16, which the kernel takes, is
    sketched by the kernel, against the plain version on the same CUDA
    tensor (float32 output 1e-4, bf16 output 8e-3: one bf16 rounding)."""
    signs, sampling, _ = _srht_plan(0, 100, 8)
    x = torch.randn(100, 2, device=cuda).to(torch.bfloat16)
    before = srht_cuda.srht_onepass.launches_by_dtype[torch.bfloat16]
    for out_dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
        out = srht_cuda.srht_onepass(x, 8, signs, sampling, out_dtype=out_dtype)
        assert out.dtype == out_dtype and out.is_cuda
        ref = srht_cuda.srht_onepass_plain(x, 8, signs, sampling, out_dtype=torch.float32)
        assert rel_err(out.float(), ref) < tol
    assert srht_cuda.srht_onepass.launches_by_dtype[torch.bfloat16] == before + 2
    with pytest.raises(ValueError):
        srht_cuda.srht_onepass(torch.ones(100, 2, device=cuda), 8, signs[:50],
                               sampling)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_embedding_dispatches_to_the_kernel(cuda, dtype):
    """n >= 2^16: 1-D, (n, m) and blocked (m, B, R) input all launch the
    kernel and agree with the same sketch of the data on the CPU."""
    n, k = 65541, 200
    emb = temb.SrhtEmbedding(k, n, seed=3, device=cuda, dtype=dtype)
    cpu = temb.SrhtEmbedding(k, n, seed=3, device="cpu", dtype=torch.float64)
    x = _input(n, 5, "cols", dtype, cuda)
    for X, expect in ((x[:, 0], 1), (x, 1), (emb.to_blocked(x), 1)):
        before = srht_cuda.srht_onepass.launches
        out = emb.apply_random(X)
        assert srht_cuda.srht_onepass.launches == before + expect
        ref = cpu.apply_random(x[:, 0].double().cpu() if X.dim() == 1
                               else x.double().cpu())
        assert rel_err(out.double().cpu(), ref) < TOL[dtype]


# the stencil families' step blocks at their full width: the snapshot and its
# T residual terms stacked as (1 + T, n) rows and handed to the embedding as
# the (n, 1 + T) transposed view (parallel/driver.py). Advection (T = 3) and
# Helmholtz (T = 2) at grid 2048 (n odd, padded to 2^23); the 3-D block
# (T = 8) at 256^3 = 2^24 (no padding) and at 65^3 (odd, padded)
FAMILY_BLOCKS = [
    (4_198_401, 4),
    (4_198_401, 3),
    (1 << 24, 9),
    (65 ** 3, 9),
]


@pytest.mark.parametrize("n,m", FAMILY_BLOCKS)
def test_kernel_matches_plain_at_the_family_blocks(cuda, n, m):
    """``SrhtEmbedding(256, n).apply_random`` of the rows view launches the
    kernel once and agrees with the plain version (1e-4 relative)."""
    k = 256
    emb = temb.SrhtEmbedding(k, n, seed=0, device=cuda, dtype=torch.float32)
    signs, sampling, _ = emb.plan
    x = _input(n, m, "rows", torch.float32, cuda)
    assert x.stride() == (1, n)
    before = srht_cuda.srht_onepass.launches
    out = emb.apply_random(x)
    torch.cuda.synchronize()
    assert srht_cuda.srht_onepass.launches == before + 1
    assert out.shape == (k, m) and out.dtype == torch.float32
    ref = srht_cuda.srht_onepass_plain(x, k, signs, sampling)
    assert rel_err(out, ref) < TOL[torch.float32]


def test_slice_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The small slice (one-pass branch forced) on CUDA in float32 selects
    the same parameters as on the CPU in float64, with ROM outputs close."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy
    from rla4mor_tpu_torch.serve import serve_batch

    monkeypatch.setattr(temb.SrhtEmbedding, "_ONEPASS_MIN_DIM", 1)
    results = {}
    for dev in (torch.device("cpu"), cuda):
        fom = ThermalBlockFOM((2, 2), 32, device=dev)
        Ru = fom.h1_0_product
        theta = temb.SrhtEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt,
                                        range_dim=120, seed=0, device=dev)
        red = SketchedReductor(fom, embedding_primal=theta, product=Ru,
                               log_level=30)
        train = fom.parameter_space.sample_randomly(40, seed=0, device=dev)
        before = srht_cuda.srht_onepass.launches
        res = rb_greedy(fom, red, train, max_extensions=4, log_level=30)
        launched = srht_cuda.srht_onepass.launches - before
        out = serve_batch(res.rom, mu_stack(train[:16]))
        results[dev.type] = (res, out, launched)
    (rc, oc, lc), (rg, og, lg) = results["cpu"], results["cuda"]
    assert lc == 0 and lg > 0
    picked = [float(v) for m in rg.selected_mus for v in m["diffusion"]]
    assert picked == pytest.approx(
        [float(v) for m in rc.selected_mus for v in m["diffusion"]], rel=1e-6)
    assert rg.max_estimates == pytest.approx(rc.max_estimates, rel=1e-3)
    assert rel_err(og["output"].double().cpu(), oc["output"]) < 1e-4


# ---------------------------------------------------------------------------
# Gaussian / Rademacher sketch with Omega drawn in the kernel. Strips and
# the one-launch Omega: Rademacher bit-equal to the plain version, normals
# to 1e-5 absolute on the unscaled values (the plain Box-Muller is float64
# rounded once; the kernels' approximate log, sqrt and cos stay within
# ~1e-6 of it; the values are at most ~6). Sketches: 1e-4 relative (float32
# sums in different orders).

from rla4mor_tpu_torch.ops import gaussian_cuda as gcu  # noqa: E402

STRIP_CASES = [(256, 2048, "normal"), (300, 2048, "normal"), (100, 256, "normal"),
               (256, 2048, "rademacher"), (300, 100, "rademacher")]


@pytest.mark.parametrize("k,W,dist", STRIP_CASES)
def test_gaussian_strip_kernel_matches_plain(cuda, k, W, dist):
    before = gcu.gaussian_strip.launches
    out = gcu.gaussian_strip(k, 7, 3, W, dist, device=cuda)
    torch.cuda.synchronize()
    assert gcu.gaussian_strip.launches == before + 1
    assert out.shape == (k, W) and out.dtype == torch.float32 and out.is_cuda
    ref = gcu.gaussian_strip_plain(k, 7, 3, W, dist, device=cuda)
    if dist == "rademacher":
        assert torch.equal(out, ref)
    else:
        assert (out - ref).abs().max().item() <= 1e-5


# the whole scaled Omega in one launch: against its plain version
# (Rademacher bit-equal; normal to 1e-5 absolute on the unscaled values),
# at chip_smoke.py's shapes, n odd (rows not 16-byte aligned) and n % 4 == 0
OMEGA_CASES = [(200, 3 * 2048 + 37, 2048, "normal"), (200, 3 * 2048 + 37, 2048, "rademacher"),
               (256, (1 << 18) + 3, 2048, "normal"), (256, (1 << 18) + 3, 2048, "rademacher"),
               (300, 1001, 100, "normal"), (128, 4096, 256, "normal"), (100, 5, 4, "normal"),
               (64, 3, 2048, "rademacher")]


@pytest.mark.parametrize("k,n,W,dist", OMEGA_CASES)
def test_gaussian_omega_kernel_matches_plain(cuda, k, n, W, dist):
    o0, t0 = gcu.gaussian_omega.launches, gcu.gaussian_strip.launches
    out = gcu.gaussian_omega(k, n, 7, W, dist, device=cuda)
    torch.cuda.synchronize()
    assert (gcu.gaussian_omega.launches, gcu.gaussian_strip.launches) == (o0 + 1, t0)
    assert out.shape == (k, n) and out.dtype == torch.float32 and out.is_contiguous()
    ref = gcu.gaussian_omega_plain(k, n, 7, W, dist, device=cuda)
    if dist == "rademacher":
        assert torch.equal(out, ref)
    else:
        assert (out - ref).abs().max().item() / gcu.omega_scale(k) <= 1e-5


@pytest.mark.parametrize("k,n,W,dist", OMEGA_CASES[:4] + OMEGA_CASES[5:6])
def test_gaussian_omega_is_the_strip_kernels_strips(cuda, k, n, W, dist):
    """The one-launch Omega is the per-strip kernel's strips side by side,
    cut at n and scaled by the same float32, bit for bit; and a redraw is
    equal."""
    out = gcu.gaussian_omega(k, n, 7, W, dist, device=cuda)
    strips = [gcu.gaussian_strip(k, 7, b, W, dist, device=cuda) for b in range(-(-n // W))]
    assert torch.equal(out, torch.cat(strips, dim=1)[:, :n] * gcu.omega_scale(k))
    assert torch.equal(out, gcu.gaussian_omega(k, n, 7, W, dist, device=cuda))
    assert not torch.equal(out, gcu.gaussian_omega(k, n, 8, W, dist, device=cuda))


def _x32(n, m, layout, device):
    return _input(n, m, layout, torch.float32, device)


SKETCH_CASES = [
    (1, 1, 1, 2048, "normal", "cols"),
    (1000, 1, 300, 256, "normal", "cols"),
    (4099, 5, 256, 2048, "normal", "rows"),
    (4099, 9, 128, 100, "rademacher", "every_other_row"),
    (65541, 33, 100, 2048, "normal", "column_slice"),
    (65541, 40, 256, 2048, "rademacher", "rows"),
    (261121, 1, 256, 2048, "normal", "cols"),
    (261121, 5, 300, 2048, "normal", "cols"),
    # either side of SMALL_M_MAX["normal"] = 8 (registers below, tiles above)
    (70001, 8, 256, 2048, "normal", "cols"),
    (70001, 9, 256, 2048, "normal", "cols"),
    # m = 1: k = 1, 100, 300 (exact row count, cos halves), strided, W = 4
    (5003, 1, 1, 2048, "normal", "cols"),
    (5003, 1, 100, 100, "normal", "cols"),
    (261121, 1, 300, 2048, "normal", "cols"),
    (261121, 1, 256, 2048, "rademacher", "every_other_row"),
    (4097, 1, 128, 4, "normal", "column_slice"),
    # column ranges that cross strips of W = 100: the tiled branch for
    # Rademacher (SMALL_M_MAX["rademacher"] = 1), the small one for normal
    (1001, 3, 100, 100, "rademacher", "rows"),
    (1001, 3, 100, 100, "normal", "rows"),
]


@pytest.mark.parametrize("n,m,k,W,dist,layout", SKETCH_CASES)
def test_gaussian_sketch_kernel_matches_plain(cuda, n, m, k, W, dist, layout):
    x = _x32(n, m, layout, cuda)
    before = gcu.gaussian_sketch.launches
    out = gcu.gaussian_sketch(x, k, 11, W, dist)
    torch.cuda.synchronize()
    assert gcu.gaussian_sketch.launches == before + 1
    assert out.shape == (k, m) and out.dtype == torch.float32 and out.is_cuda
    ref = gcu.gaussian_sketch_plain(x, k, 11, W, dist)
    assert rel_err(out, ref) < 1e-4


# the tiled branch (m > SMALL_M_MAX[dist], 3xTF32 on the tensor cores): m padded to
# 8 only, one column chunk up to 128 and more chunks above, k = 300 (cos
# halves, a short last k-tile), row- and column-major x and strided views,
# W that is not a multiple of the 32-column tile
TILED_CASES = [
    (70001, 9, 256, 2048, "normal", "cols"),
    (70001, 16, 256, 2048, "rademacher", "cols"),
    (70001, 33, 256, 2048, "normal", "rows"),
    (70001, 64, 256, 2048, "rademacher", "rows"),
    (70001, 128, 256, 2048, "normal", "cols"),
    (70001, 129, 256, 2048, "normal", "cols"),
    (20011, 257, 256, 2048, "rademacher", "cols"),
    (70001, 12, 300, 2048, "normal", "cols"),
    (70001, 64, 300, 2048, "normal", "rows"),
    (70001, 20, 100, 100, "rademacher", "every_other_row"),
    (70001, 40, 256, 2048, "normal", "column_slice"),
    (5003, 9, 128, 4, "normal", "cols"),
    (1, 9, 256, 2048, "normal", "cols"),
    # long sums: 10^4 k-steps an accumulator, where a running sum kept in
    # the tensor cores' truncating accumulate drifts past 1e-4
    (1 << 22, 9, 256, 2048, "normal", "cols"),
    (1 << 22, 64, 256, 2048, "rademacher", "cols"),
]


@pytest.mark.parametrize("n,m,k,W,dist,layout", TILED_CASES)
def test_gaussian_tiled_kernel_matches_plain(cuda, n, m, k, W, dist, layout):
    x = _x32(n, m, layout, cuda)
    before = dict(gcu.gaussian_sketch.launches_by_branch)
    out = gcu.gaussian_sketch(x, k, 11, W, dist)
    torch.cuda.synchronize()
    after = gcu.gaussian_sketch.launches_by_branch
    assert after["tiled"] == before["tiled"] + 1 and after["small"] == before["small"]
    assert out.shape == (k, m) and out.dtype == torch.float32 and out.is_cuda
    ref = gcu.gaussian_sketch_plain(x, k, 11, W, dist)
    # 1e-5, the CPU mirror's limit (test_3xtf32_product_matches_the_strip_oracle):
    # one TF32 pass, or a normal product without its Omega_lo x_hi pass, is
    # 1.4-3e-4 off
    assert rel_err(out, ref) < 1e-5


@pytest.mark.parametrize("n,m,k,W,layout", [(1001, 3, 100, 100, "rows"),
                                              (261121, 8, 256, 2048, "cols")])
def test_gaussian_small_rademacher_instances_match_plain(cuda, n, m, k, W, layout):
    """The small kernel's Rademacher instances for m > 1, which the dispatch
    no longer picks (SMALL_M_MAX["rademacher"] = 1), forced."""
    x = _x32(n, m, layout, cuda)
    before = gcu.gaussian_sketch.launches_by_branch["small"]
    out = gcu._launch_sketch(x, k, 11, W, "rademacher", branch="small")
    torch.cuda.synchronize()
    assert gcu.gaussian_sketch.launches_by_branch["small"] == before + 1
    assert rel_err(out, gcu.gaussian_sketch_plain(x, k, 11, W, "rademacher")) < 1e-4


def test_gaussian_branches_are_counted(cuda):
    x = _x32(10007, 12, "cols", cuda)
    counts = gcu.gaussian_sketch.launches_by_branch
    total, small, tiled = gcu.gaussian_sketch.launches, counts["small"], counts["tiled"]
    gcu.gaussian_sketch(x[:, :gcu.SMALL_M_MAX["normal"]], 64, 1)
    gcu.gaussian_sketch(x, 64, 1)
    gcu.gaussian_sketch(x[:, 0], 64, 1)
    assert counts["small"] == small + 2 and counts["tiled"] == tiled + 1
    assert gcu.gaussian_sketch.launches == total + 3
    # either branch at m <= 8 draws the same Omega
    a = gcu._launch_sketch(x[:, :4].contiguous(), 256, 1, 2048, "normal", branch="small")
    b = gcu._launch_sketch(x[:, :4].contiguous(), 256, 1, 2048, "normal", branch="tiled")
    assert rel_err(b, a) < 1e-4


def test_gaussian_tiled_instance_mirror_matches_the_source(cuda):
    lib = gcu._lib()
    for m in (1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129, 257):
        assert lib.gaussian_sketch_tiled_groups(m) == gcu.tiled_instance(m)[1]
    assert lib.gaussian_sketch_tiled_groups(0) == 0


def test_gaussian_tiled_refusal_raises(cuda, monkeypatch):
    """A launch the C entry refuses (here n_split = 0) raises; nothing falls
    back to the plain version or to torch.matmul."""
    x = _x32(10007, 12, "cols", cuda)
    before = gcu.gaussian_sketch.launches_by_branch["tiled"]
    monkeypatch.setattr(gcu, "tiled_launch", lambda *args: 0)
    monkeypatch.setattr(gcu, "_sketch_plain", None)
    monkeypatch.setattr(torch, "matmul", None)
    with pytest.raises(RuntimeError, match="tiled"):
        gcu.gaussian_sketch(x, 256, 1)
    assert gcu.gaussian_sketch.launches_by_branch["tiled"] == before


def test_gaussian_sketch_vector_and_casts(cuda):
    x = _input(5000, 2, "cols", torch.float64, cuda)
    out = gcu.gaussian_sketch(x[:, 0], 64, 3, 256)
    assert out.shape == (64,) and out.dtype == torch.float32
    ref = gcu.gaussian_sketch_plain(x[:, 0].float(), 64, 3, 256)
    assert rel_err(out, ref) < 1e-4
    half = gcu.gaussian_sketch(x.to(torch.bfloat16), 64, 3, 256)
    assert rel_err(half, gcu.gaussian_sketch_plain(x.to(torch.bfloat16), 64, 3, 256)) < 1e-4


def test_gaussian_kernels_are_deterministic(cuda):
    for m in (1, 8, 9, 64, 129):
        x = _x32(261121, m, "cols", cuda)
        a = gcu.gaussian_sketch(x, 256, 1)
        b = gcu.gaussian_sketch(x, 256, 1)
        assert torch.equal(a, b)
        assert not torch.equal(a, gcu.gaussian_sketch(x, 256, 2))
    assert torch.equal(gcu.gaussian_strip(256, 1, 5, device=cuda),
                       gcu.gaussian_strip(256, 1, 5, device=cuda))


def test_gaussian_unsupported_input_raises_on_the_card(cuda):
    x = torch.ones(100, 2, device=cuda)
    with pytest.raises(TypeError):
        gcu.gaussian_sketch(torch.complex(x, x), 8, 0)
    with pytest.raises(ValueError):
        gcu.gaussian_sketch(x, 8, 0, block_rows=6)
    with pytest.raises(ValueError):
        gcu.gaussian_sketch(x, 8, 0, dist="uniform")
    with pytest.raises(ValueError):
        gcu.gaussian_strip(8, 0, 0, block_rows=10, device=cuda)
    with pytest.raises(ValueError):
        gcu.gaussian_omega(8, 0, 0, device=cuda)
    with pytest.raises(ValueError):
        gcu.gaussian_strip(8, 0, 1 << 32, device=cuda)


def test_hwprng_embedding_dispatches_to_the_kernels(cuda):
    n, k = 5000, 128
    emb = temb.HwPrngGaussianEmbedding.make(n, range_dim=k, seed=4, block_rows=1024,
                                            device=cuda)
    x = _x32(n, 3, "cols", cuda)
    s0, t0 = gcu.gaussian_sketch.launches, gcu.gaussian_strip.launches
    o0 = gcu.gaussian_omega.launches
    y = emb.apply(x)
    M = emb.random_matrix()
    assert gcu.gaussian_sketch.launches == s0 + 1
    # the whole Omega in one launch, no strip launch
    assert gcu.gaussian_omega.launches == o0 + 1
    assert gcu.gaussian_strip.launches == t0
    assert M.shape == (k, n) and M.is_cuda
    assert rel_err(y, M @ x) < 1e-4


def test_entry_points_default_to_the_card(cuda):
    """Given no device, the entry points land on the current card (cuda:0
    here), in float32 with TF32 off."""
    from rla4mor_tpu_torch.models import ThermalBlockFOM

    torch.backends.cuda.matmul.allow_tf32 = True
    fom = ThermalBlockFOM((2, 2), 8)
    assert fom.device == torch.device("cuda:0")
    assert not torch.backends.cuda.matmul.allow_tf32
    emb = temb.HwPrngGaussianEmbedding.make(fom.solution_dim, range_dim=8)
    assert emb.device == torch.device("cuda:0")
    mu = fom.parameter_space.sample_randomly(2)[0]
    assert mu["diffusion"].device == torch.device("cuda:0")
    assert emb.apply(torch.ones(fom.solution_dim, device=cuda)).is_cuda


# ---------------------------------------------------------------------------
# The large slice: the padded greedy driver on the card against the CPU.


def _driver_run(device, grid, projection, steps=3, cg_tol=1e-13):
    from rla4mor_tpu_torch.core import ParameterSpace, mu_stack
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
    from rla4mor_tpu_torch.parallel import make_sharded_greedy_step, state_to_rom

    fom = StencilThermalBlock((2, 2), grid, dtype=torch.float64, device=device)
    state, step = make_sharded_greedy_step(
        fom, seed=0, k=32, r_max=4, cg_tol=cg_tol, cg_maxiter=300, cg_precond="mg",
        sketch="srht", projection=projection)
    space = ParameterSpace.make({"diffusion": 4}, 0.1, 1.0)
    f64 = dict(device=device, dtype=torch.float64)  # the card's default is float32
    batch = mu_stack(space.sample_randomly(6, seed=2, **f64))
    ests = []
    for i in range(steps):
        mu = space.sample_randomly(1, seed=10 + i, **f64)[0]
        state, est, _ = step(state, mu, batch)
        ests.append(est)
    rom = state_to_rom(fom, state, projection=projection)
    held = mu_stack(space.sample_randomly(4, seed=3, **f64))
    return state, ests, rom.solve(held), rom.estimate_error(held)


@pytest.mark.parametrize("projection", ["galerkin", "minres"])
def test_driver_on_the_card_matches_the_cpu(cuda, projection):
    """Grid 16, float64, MG-CG, SRHT k = 32, 3 steps: the state, the
    estimates and the shipped ROM's solve and estimate equal the CPU run's
    to 1e-10 (minres solves its rank-deficient masked systems by an SVD:
    ``torch.linalg.lstsq`` on CUDA assumes full rank). CG runs to 1e-13,
    so that the two devices' solves, summed in different orders, agree to
    round-off and not only to the solver's tolerance."""
    cpu = _driver_run(torch.device("cpu"), 16, projection)
    card = _driver_run(cuda, 16, projection)
    assert int(card[0].ncols) == int(cpu[0].ncols) == 3
    for name in ("srb", "res_lhs", "res_rhs", "out"):
        assert rel_err(getattr(card[0], name).cpu(), getattr(cpu[0], name)) < 1e-10
    for a, b in zip(card[1], cpu[1]):
        assert rel_err(a.cpu(), b) < 1e-10
    assert rel_err(card[2].cpu(), cpu[2]) < 1e-10
    assert rel_err(card[3].cpu(), cpu[3]) < 1e-10


def test_driver_sketch_takes_the_kernel_in_the_rows_layout(cuda, monkeypatch):
    """At grid 256 (n = 66,049 >= 2^16) the driver's sketches launch the
    one-pass kernel: the rhs once (m = 1), then each step's (1 + T, n)
    block through its transposed (n, 1 + T) view, strides (1, n), the rows
    layout. Each launch equals the plain version on its input to 1e-12."""
    seen = []
    real = temb.srht_onepass

    def recording(x, k, signs, sampling, out_dtype=None):
        out = real(x, k, signs, sampling, out_dtype)
        if x.is_cuda:
            seen.append((tuple(x.shape), x.stride(), rel_err(
                out, srht_cuda.srht_onepass_plain(x, k, signs, sampling))))
        return out

    monkeypatch.setattr(temb, "srht_onepass", recording)
    before = srht_cuda.srht_onepass.launches
    _driver_run(cuda, 256, "galerkin", steps=2, cg_tol=1e-10)
    assert srht_cuda.srht_onepass.launches - before == 3
    n = 257 * 257
    assert [s[:2] for s in seen] == [((n, 1), (1, 1))] + [((n, 5), (1, n))] * 2
    assert all(s[2] < TOL[torch.float64] for s in seen), seen


def test_plain_strip_has_the_same_bits_on_the_card_and_the_cpu(cuda):
    """The plain Box-Muller uses only correctly rounded operations, so the
    card's plain strip is the CPU's, bit for bit."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    for k, dist in ((200, "normal"), (256, "normal"), (300, "rademacher")):
        on_card = gcu.gaussian_strip_plain(k, 21, 513, 2048, dist, device=cuda)
        assert torch.equal(on_card.cpu(), gcu.gaussian_strip_plain(k, 21, 513, 2048, dist,
                                                                    device="cpu"))


def test_precond_demo_on_the_card_matches_the_cpu(cuda):
    """The preconditioner selector's demo at grid 32 in float64 on the card
    (the RecycledCG directions, the reductor, the batched online stage)
    against the same run on the CPU."""
    from rla4mor_tpu_torch.examples import preconditioned_large_demo as demo

    kw = dict(grid=32, nmu=8, k_res=40, dtype=torch.float64, log=lambda *a: None)
    card, host = demo.run(device=cuda, **kw), demo.run(device="cpu", **kw)
    assert [P.last_iters for P in card["directions"]] == \
        [P.last_iters for P in host["directions"]]
    assert rel_err(card["us"].cpu(), host["us"]) < 1e-8
    assert rel_err(card["rnorms"].cpu(), host["rnorms"]) < 1e-8


@pytest.mark.parametrize("m,K", [(14, 8), (10, 25)], ids=["K<m", "K>m"])
def test_estim_lars_and_bounded_lstsq_on_the_card_match_the_cpu(cuda, m, K):
    """The batched device LARS (``lars_weighted_path_jax`` with the OLS
    debias, 4 columns) and a batch of ``bounded_lstsq`` problems, in float64
    on the card, equal the CPU port's output to 1e-9 (K > m: while alpha
    stays above 1e-9 of its first value, the tail being rounding noise)."""
    from rla4mor_tpu_torch.core import bounded_lstsq
    from rla4mor_tpu_torch.estim.lars import lars_weighted_path_jax

    g = torch.Generator().manual_seed(m * K)
    D = torch.randn((m, K), generator=g, dtype=torch.float64)
    X = torch.randn((4, m), generator=g, dtype=torch.float64)
    v, alphas, steps = lars_weighted_path_jax(D.to(cuda), X.to(cuda), max_steps=80)
    cv, calphas, csteps = lars_weighted_path_jax(D, X, max_steps=80)
    keep = calphas > 1e-9 * calphas[:, :1]
    if K < m:
        assert torch.equal(steps.cpu(), csteps)
        keep = torch.ones_like(keep)
    for i in range(4):
        k = keep[i]
        assert torch.equal(v[i].cpu()[:, k] != 0, cv[i][:, k] != 0)
        assert rel_err(v[i].cpu()[:, k], cv[i][:, k]) < 1e-9
        assert rel_err(alphas[i].cpu()[k], calphas[i][k]) < 1e-9
    G = torch.randn((3, 5, 40, 9), generator=g, dtype=torch.float64)
    rhs = 3.0 * torch.randn((3, 5, 40), generator=g, dtype=torch.float64)
    lb, ub = torch.full((9,), -0.2, dtype=torch.float64), torch.full((9,), 0.3, dtype=torch.float64)
    x = bounded_lstsq(G.to(cuda), rhs.to(cuda), lb.to(cuda), ub.to(cuda), iters=300)
    cx = bounded_lstsq(G, rhs, lb, ub, iters=300)
    assert rel_err(x.cpu(), cx) < 1e-9


@pytest.mark.parametrize("kind", ["rademacher", "rademacher_c", "sparse", "block", "block_c",
                                  "streamed", "streamed_c"])
def test_embedding_zoo_on_the_card_matches_the_cpu(cuda, kind):
    """Each new embedding at one seed on the card and on the CPU (the draws
    are device-independent): its sketch of the same float64 (complex128)
    columns agrees to 1e-12 relative, the sparse-sign scatter-add too (its
    atomics add in another order), and its Omega is the same matrix."""
    cx = kind.endswith("_c")
    cls, extra = {"rademacher": (temb.RademacherEmbedding, {}),
                  "sparse": (temb.SparseSignEmbedding, {"s": 8}),
                  "block": (temb.BlockGaussianEmbedding, {"max_block_size": 48}),
                  "streamed": (temb.StreamedGaussianEmbedding, {"block_cols": 8192}),
                  }[kind.removesuffix("_c")]
    if cx:
        extra["complex_dtype"] = True
    n, k = 3 * 8192 + 77, 100
    g = torch.Generator().manual_seed(5)
    X = torch.randn((n, 4), generator=g, dtype=torch.float64)
    if cx:
        X = torch.complex(X, torch.randn((n, 4), generator=g, dtype=torch.float64))
    e_gpu = cls.make(n, range_dim=k, seed=7, device=cuda, dtype=torch.float64, **extra)
    e_cpu = cls.make(n, range_dim=k, seed=7, device="cpu", dtype=torch.float64, **extra)
    assert rel_err(e_gpu.apply(X.to(cuda)).cpu(), e_cpu.apply(X)) < 1e-12
    assert torch.equal(e_gpu.random_matrix().cpu(), e_cpu.random_matrix())


def test_helmholtz_demo_on_the_card_matches_the_cpu(cuda):
    """``helmholtz_demo.run`` at grid 9 with 5 extensions in complex128 on the
    card (the SCM's Cholesky-reduced ``eigh`` by cuSOLVER) and on the CPU:
    the same picks and anchors, the greedy's errors and estimates to 1e-8
    of their largest, the sweep's to 1e-12 of the state's norm (the float64
    floor: these errors are 1e-8-1e-6 of it, so two devices' rounding
    shows at 1e-8 of the largest), the bounds where the error is above that
    floor to 1e-6, recovery errors to 1e-6 relative (or 1e-9 where both are
    at the float64 floor)."""
    import numpy as np

    from rla4mor_tpu_torch.examples import helmholtz_demo

    quiet = lambda line: None  # noqa: E731
    gpu = helmholtz_demo.run(9, 5, device=cuda, log=quiet)
    cpu = helmholtz_demo.run(9, 5, device="cpu", log=quiet)
    assert gpu["greedy"]["picks"] == cpu["greedy"]["picks"]
    assert gpu["scm"]["anchors"] == cpu["scm"]["anchors"]
    sw, ref = gpu["sweep"], cpu["sweep"]
    held = helmholtz_demo.certified(ref)
    assert np.array_equal(held, helmholtz_demo.certified(sw))
    for key in ("err", "est"):  # the float64 floor: 1e-12 of the state's norm
        diff = (np.abs(sw[key] - ref[key]) / ref["norm"]).max()
        assert diff <= 1e-12, (key, diff)
    diff = np.abs(sw["bound"][held] - ref["bound"][held]).max() / ref["bound"][held].max()
    assert diff <= 1e-6, ("bound", diff)
    for key in ("err", "est"):
        a, b = np.asarray(gpu["greedy"][key]), np.asarray(cpu["greedy"][key])
        assert np.abs(a - b).max() <= 1e-8 * np.abs(b).max(), key
    for key in ("pbdw", "dic"):
        a, b = gpu["recovery"][key], cpu["recovery"][key]
        assert np.all(np.abs(a - b) <= 1e-6 * b + 1e-9), (key, a, b)


def _bump_training_fields(grid: int):
    """The Gaussian-bump family's 5^3 training fields at ``grid`` on the CPU
    in float64, as the (n, 125) column-major block of ``from_training``."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models import gaussian_bump_fom

    exact = gaussian_bump_fom(grid, dtype=torch.float64, device="cpu")
    train = exact.parameter_space.sample_uniformly(5, device="cpu", dtype=torch.float64)
    return exact, train, exact.kappa(mu_stack(train)).reshape(len(train), -1).T


def test_eim_greedy_on_the_card_matches_the_cpu(cuda):
    """The EIM host loop and the device greedy (chunks 5 and 32) on the
    card pick the CPU host loop's points and snapshots from the same
    float64 training fields (grid 32), basis and history to 1e-12: the
    residual update rounds its product before subtracting on both."""
    from rla4mor_tpu_torch.mor.eim import eim_greedy, eim_greedy_device

    _, _, G = _bump_training_fields(32)
    cpu = eim_greedy(G, tol=1e-3, reserve=4)
    for card in (eim_greedy(G.to(cuda), tol=1e-3, reserve=4),
                 eim_greedy_device(G.to(cuda), tol=1e-3, reserve=4, chunk=5),
                 eim_greedy_device(G.to(cuda), tol=1e-3, reserve=4, chunk=32)):
        assert card.snapshot_ids == cpu.snapshot_ids and card.n_reserve == cpu.n_reserve == 4
        assert torch.equal(card.points.cpu(), cpu.points)
        assert rel_err(card.basis.cpu(), cpu.basis) < 1e-12
        assert max(abs(a - b) for a, b in zip(card.sup_errors, cpu.sup_errors)) < 1e-12


def test_eim_apply_terms_on_the_card_matches_the_cpu(cuda):
    """The surrogate of a CPU fit (grid 32) moved to the card: its batched
    term apply, theta over a batch, kappa and apply equal the CPU's to
    1e-12 in float64."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models import EimStencilFOM, gaussian_bump_fom

    exact, train, _ = _bump_training_fields(32)
    cpu = EimStencilFOM.from_training(exact, train, tol=1e-3)
    card = EimStencilFOM(gaussian_bump_fom(32, dtype=torch.float64, device=cuda),
                         cpu.interpolant.to(cuda), cpu.kappa_floor)
    g = torch.Generator().manual_seed(5)
    u = torch.randn(cpu.solution_shape, generator=g, dtype=torch.float64)
    assert rel_err(card.apply_terms(u.to(cuda)).cpu(), cpu.apply_terms(u)) < 1e-12
    mus = [{"bump": torch.rand(3, generator=g, dtype=torch.float64)} for _ in range(3)]
    batch = mu_stack(mus)
    assert rel_err(card.theta_vector({"bump": batch["bump"].to(cuda)}).cpu(),
                   cpu.theta_vector(batch)) < 1e-12
    mu = {"bump": mus[0]["bump"].to(cuda)}
    assert rel_err(card.kappa(mu).cpu(), cpu.kappa(mus[0])) < 1e-12
    assert rel_err(card.apply(mu, u.to(cuda)).cpu(), cpu.apply(mus[0], u)) < 1e-12


def test_instationary_rom_loop_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The batched ROM time loop (one LU of M_r + dt A_r for the whole batch,
    nt batched solves, the sketched space-time estimate) and the corrected
    output's backward loop on the card in float32 equal the CPU's float64
    to 1e-5: the ROMs of a CPU reduction, moved by ``save_rom`` /
    ``load_rom(device, dtype)``."""
    from rla4mor_tpu_torch.core import ONE, AffineDense, mu_stack
    from rla4mor_tpu_torch.models import (
        InstationaryPrimalDualReductor,
        instationary_thermal_block,
    )
    from rla4mor_tpu_torch.mor import load_rom, save_rom

    fom = instationary_thermal_block((2, 2), 12, T=0.5, nt=20, device="cpu")
    w = torch.zeros((11, 11), dtype=torch.float64)
    w[:4, :4] = 1.0
    fom.output_functional = AffineDense((w / w.sum()).reshape(1, 1, -1), (ONE,))
    Ru = fom.products["h1_0"]
    emb = temb.GaussianEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt, range_dim=80,
                                      seed=5, device="cpu")
    red = InstationaryPrimalDualReductor(fom, embedding=emb, product=Ru, log_level=30)
    train = fom.parameter_space.sample_randomly(3, seed=1, device="cpu")
    for mu in train:
        red.extend(mu, modes_per_extension=2)
    mus = mu_stack(fom.parameter_space.sample_randomly(16, seed=2, device="cpu"))
    card_mus = {k: v.to(cuda, torch.float32) for k, v in mus.items()}
    rom_pd = red.reduce()
    for rom, run in ((rom_pd.rom_pr, lambda r, m: r.solve(m, return_estimate=True)),
                     (rom_pd, lambda r, m: r.output_corrected(m))):
        save_rom(rom, tmp_path / "rom.npz")
        card = load_rom(tmp_path / "rom.npz", device=cuda, dtype=torch.float32)
        for got, want in zip(run(card, card_mus), run(rom, mus)):
            assert got.device.type == "cuda" and got.dtype == torch.float32
            assert rel_err(got.double().cpu(), want) < 1e-5


def test_graphed_vcycle_matches_the_eager_one(cuda):
    """The mass-shifted V-cycle replayed from a CUDA graph (``core/graphs.py``)
    equals the eager cycle on the card (the same kernels in the same order),
    call after call with other inputs; on a CPU tensor ``graphed`` returns
    the function itself."""
    from rla4mor_tpu_torch.core.graphs import graphed
    from rla4mor_tpu_torch.models.multigrid import make_vcycle
    from rla4mor_tpu_torch.models.stencil import StencilThermalBlock

    st = StencilThermalBlock((2, 2), 256, device=cuda)
    cycle = make_vcycle(st.kappa({"diffusion": torch.tensor([0.3, 0.9, 0.5, 0.7])}),
                        mass_dt=0.02)
    b = st.rhs()
    fast = graphed(cycle, b)
    g = torch.Generator(device=cuda).manual_seed(3)
    for _ in range(3):
        x = torch.randn(b.shape, generator=g, device=cuda)
        assert torch.equal(fast(x), cycle(x))
    assert graphed(abs, torch.zeros(2)) is abs


def _eager_graphs(monkeypatch):
    """``core.graphs.graphed`` as the identity: the eager cycles."""
    import rla4mor_tpu_torch.core.graphs as graphs

    monkeypatch.setattr(graphs, "graphed", lambda fn, example, warmup=2: fn)


def test_graphed_newmark_cycle_matches_the_eager_one(cuda, monkeypatch):
    """``WaveStencilFOM`` with MG (the V-cycle shifted by beta dt^2, replayed
    from a CUDA graph) at grid 128: the trajectory is bit-equal to the one
    with the eager cycle, with the same CG iterations a step."""
    from rla4mor_tpu_torch.models import StencilThermalBlock, WaveStencilFOM

    st = StencilThermalBlock((2, 2), 128, device=cuda)
    fom = WaveStencilFOM(st, T=1.0, nt=8)
    mu = {"diffusion": torch.tensor([0.3, 0.9, 0.5, 0.7], device=cuda)}
    graphed_traj = fom.solve(mu, tol=1e-6, maxiter=60, precond="mg")
    with monkeypatch.context() as m:
        _eager_graphs(m)
        eager_traj = fom.solve(mu, tol=1e-6, maxiter=60, precond="mg")
    assert torch.equal(graphed_traj, eager_traj)
    assert fom.solve_log[0]["iters"] == fom.solve_log[1]["iters"]


def test_graphed_stationary_cycle_in_newton_matches_the_eager_one(cuda, monkeypatch):
    """``SemilinearStencilFOM.solve_newton`` with MG (the V-cycle of A(mu),
    replayed from a CUDA graph) at grid 128 in float32: the iterate is
    bit-equal to the one with the eager cycle, with the same steps, stop
    and CG iterations."""
    from rla4mor_tpu_torch.models import SemilinearStencilFOM

    fom = SemilinearStencilFOM((2, 2), 128, device=cuda)
    mu = {"diffusion": torch.tensor([0.3, 0.9, 0.5, 0.7], device=cuda),
          "reaction": torch.tensor([0.6], device=cuda)}
    kw = dict(newton_tol=1e-6, cg_tol=1e-6, cg_maxiter=200, cg_precond="mg",
              return_info=True)
    u, info = fom.solve_newton(mu, **kw)
    with monkeypatch.context() as m:
        _eager_graphs(m)
        u_eager, info_eager = fom.solve_newton(mu, **kw)
    assert torch.equal(u, u_eager)
    for key in ("iters", "reason", "cg_iters", "residuals"):
        assert info[key] == info_eager[key], key
