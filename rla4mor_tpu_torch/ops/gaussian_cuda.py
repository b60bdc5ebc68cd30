"""Gaussian / Rademacher sketch with Omega drawn in the kernel: the
hand-written CUDA kernels, their plain versions and the wrappers that pick
between them.

Counterpart of ``rla4mor_tpu/ops/gaussian_pallas.py``. The kernels
(``csrc/gaussian_sketch.cu``) replace the TPU kernels ``gaussian_sketch``
and ``gaussian_strip``. Omega (k, n) is cut into (k, W) strips,
W = ``block_rows``; strip b is a pure function of ``(seed, b, k, W, dist)``
under the port's bitstream contract (``ops/philox.py``), so

    gaussian_sketch(X) = (1/sqrt(k)) * sum_b strip_b[:, :rows_b] @ X_b

over the rows i < n of X only (the zero-padding semantics of the TPU
kernel). The TPU kernel's hardware bits cannot be reproduced off the TPU;
everything else of its contract holds: a 1-D X returns 1-D, bf16 / f16 /
f64 input is cast to float32, complex input raises ``TypeError``, the
computation and the output are float32.

What bounds the kernel on an H100, and its design, are in the note at the
top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rla4mor_tpu_torch.ops import philox
from rla4mor_tpu_torch.utils import nvcc
from rla4mor_tpu_torch.utils.config import resolve_device, sm_count

SOURCE = "gaussian_sketch.cu"
DEFAULT_BLOCK_ROWS = 2048
CHUNK_K = philox.CHUNK_K
DISTS = ("normal", "rademacher")
# the plain sketch draws strips in groups of at most this many entries
_PLAIN_GROUP_ENTRIES = 1 << 26
# the small-m kernel (registers) takes m <= SMALL_M_MAX[dist], the tiled one
# the rest; from probes/gaussian_sketch_probe.py --tiled at n = 2^23, k = 256
# (PERF.md): for normal draws the small branch is faster up to m = 8,
# for Rademacher draws the tiled one from m = 2 (m = 1, the HwPrng path's
# width, stays on the small branch)
SMALL_M_MAX = {"normal": 8, "rademacher": 1}
# small kernel: threads a block aims at (the most it takes is the kernel's)
_SMALL_THREADS = 256
# the tiled kernel (csrc/gaussian_sketch.cu): a block owns 128 sketch rows
# and a column chunk of at most TILED_CHUNK columns of x (the source's
# kTiledN), and walks tiles of 32 strip columns
_TILED_K, _TILED_W = 128, 32
TILED_CHUNK = 128
BRANCHES = ("small", "tiled")
# draw order of the kernel (csrc/gaussian_sketch.cu ``Mode``)
_RADEMACHER, _NORMAL_PAIRS, _NORMAL_COS = 0, 1, 2


def _check(k: int, block_rows: int, dist: str) -> None:
    if k < 1:
        raise ValueError(f"range_dim must be positive, got {k}")
    if block_rows < 4 or block_rows % 4:
        raise ValueError(
            f"block_rows={block_rows} must be a positive multiple of 4 (one "
            "Philox call gives 4 adjacent columns of a strip)")
    if dist not in DISTS:
        raise ValueError(f"unknown dist {dist!r}; expected one of {DISTS}")


def _mode(k: int, dist: str) -> int:
    if dist == "rademacher":
        return _RADEMACHER
    return _NORMAL_PAIRS if k % (2 * CHUNK_K) == 0 else _NORMAL_COS


def _as_input(X) -> tuple[torch.Tensor, bool]:
    """(X as float32 (n, m), whether X was 1-D)."""
    X = torch.as_tensor(X)
    if X.is_complex():
        raise TypeError(
            "gaussian_sketch is real-only (the kernel draws real strips, and "
            "casting would drop the imaginary part); use GaussianEmbedding "
            "for complex data")
    if X.dim() not in (1, 2):
        raise ValueError(f"gaussian_sketch expects (n,) or (n, m), got {tuple(X.shape)}")
    single = X.dim() == 1
    X = X.to(torch.float32)
    return (X[:, None] if single else X), single


def gaussian_strip_plain(k: int, seed: int, b: int,
                         block_rows: int = DEFAULT_BLOCK_ROWS,
                         dist: str = "normal", device=None) -> torch.Tensor:
    """Plain PyTorch strip ``b`` of the unscaled Omega: (k, block_rows)
    float32 on ``device``."""
    _check(k, block_rows, dist)
    blocks = torch.tensor([int(b)], dtype=torch.int64, device=resolve_device(device))
    return philox.strips(k, seed, blocks, block_rows, dist)[0]


def _sketch_plain(Xm: torch.Tensor, k: int, seed: int, W: int,
                  dist: str) -> torch.Tensor:
    """(n, m) float32 -> (k, m): the strips drawn in groups, each group
    contracted with its rows of X in one product."""
    n, m = Xm.shape
    n_blocks = -(-n // W)
    group = max(1, _PLAIN_GROUP_ENTRIES // (k * W))
    acc = torch.zeros((k, m), dtype=torch.float32, device=Xm.device)
    for g0 in range(0, n_blocks, group):
        blocks = torch.arange(g0, min(n_blocks, g0 + group), device=Xm.device)
        S = philox.strips(k, seed, blocks, W, dist)              # (g, k, W)
        rows = Xm[g0 * W: (g0 + len(blocks)) * W]                 # i < n only
        flat = S.permute(1, 0, 2).reshape(k, len(blocks) * W)
        acc += flat[:, :rows.shape[0]] @ rows
    return acc / math.sqrt(k)


def gaussian_sketch_plain(X, k: int, seed: int,
                          block_rows: int = DEFAULT_BLOCK_ROWS,
                          dist: str = "normal") -> torch.Tensor:
    """Plain PyTorch sketch: (n, m) -> (k, m) or (n,) -> (k,), float32, on
    X's device."""
    _check(k, block_rows, dist)
    Xm, single = _as_input(X)
    out = _sketch_plain(Xm, k, seed, block_rows, dist)
    return out[:, 0] if single else out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    lib.gaussian_strip_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p]
    lib.gaussian_strip_f32.restype = ctypes.c_int
    lib.gaussian_sketch_small_max_threads.argtypes = []
    lib.gaussian_sketch_small_max_threads.restype = ctypes.c_int
    lib.gaussian_sketch_small_occupancy.argtypes = (
        [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)])
    lib.gaussian_sketch_small_occupancy.restype = ctypes.c_int
    lib.gaussian_sketch_small_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
        + [ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
           ctypes.c_double, ctypes.c_void_p])
    lib.gaussian_sketch_small_f32.restype = ctypes.c_int
    lib.gaussian_sketch_tiled_prepare.argtypes = []
    lib.gaussian_sketch_tiled_prepare.restype = ctypes.c_int
    lib.gaussian_sketch_tiled_groups.argtypes = [ctypes.c_int64]
    lib.gaussian_sketch_tiled_groups.restype = ctypes.c_int
    lib.gaussian_sketch_tiled_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
    lib.gaussian_sketch_tiled_occupancy.restype = ctypes.c_int
    lib.gaussian_sketch_tiled_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
        + [ctypes.c_uint32, ctypes.c_int, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p])
    lib.gaussian_sketch_tiled_f32.restype = ctypes.c_int
    return lib


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def slot_tiling(k: int, dist: str, max_threads: int) -> tuple[int, int, int]:
    """(slots, slots per block S, column groups G) of the small kernel,
    whose blocks take at most ``max_threads`` threads.

    A slot is what one thread generates for a column quad: in pairs mode
    the two rows (128 p + r, 128 p + 64 + r), otherwise one row, so the
    slots cover exactly k rows. Slots are spread evenly over as few blocks
    of at most ``max_threads`` as needed, rounded up to whole warps, and a
    block of fewer than 256 slots takes G = 256 // S column groups."""
    slots = k // 2 if _mode(k, dist) == _NORMAL_PAIRS else k
    tiles = -(-slots // max_threads)
    S = 32 * -(-(-(-slots // tiles)) // 32)
    return slots, S, max(1, _SMALL_THREADS // S)


def column_split(n: int, slot_tiles: int, resident_blocks: int) -> int:
    """Column ranges ``n_split`` of the small kernel: its grid is
    ``n_split`` x ``slot_tiles`` blocks, one per block the card holds at
    once, and no more ranges than the ceil(n / 4) column quads of [0, n).
    The kernel gives range z the quads [z nq / n_split, (z + 1) nq /
    n_split), nq = ceil(n / 4)."""
    return max(1, min(-(-n // 4), -(-resident_blocks // slot_tiles)))


@functools.cache
def _resident_blocks(dev_index: int, mode: int, m: int, S: int, G: int) -> int:
    """Blocks of the small kernel that device ``dev_index`` (current when
    called) holds at once, from the occupancy API, once per shape."""
    per_sm = ctypes.c_int(0)
    _raise_on(_lib().gaussian_sketch_small_occupancy(mode, m, S, G, ctypes.byref(per_sm)),
              "gaussian_sketch occupancy query")
    return sm_count(dev_index) * max(1, per_sm.value)


def small_launch(dev_index: int, n: int, m: int, k: int, dist: str) -> tuple[int, int, int]:
    """(S, G, n_split) of the small kernel for x (n, m) on CUDA device
    ``dev_index`` (current when called)."""
    slots, S, G = slot_tiling(k, dist, _lib().gaussian_sketch_small_max_threads())
    resident = _resident_blocks(dev_index, _mode(k, dist), m, S, G)
    return S, G, column_split(n, -(-slots // S), resident)


def tiled_tiles(n: int, W: int) -> int:
    """Tiles of the tiled kernel that meet [0, n): 32 strip columns each,
    ceil(W / 32) a strip, the last strip cut at n (``tiled_tiles`` of the
    CUDA source)."""
    tps = -(-W // _TILED_W)
    return n // W * tps + -(-(n % W) // _TILED_W)


def tiled_instance(m: int) -> tuple[int, int]:
    """(n-tiles a warp NTW, k-groups KG) of the tiled kernel's instance for x
    (., m): the fewest n-tiles of 8 columns (a power of 2) that hold one
    column chunk; 16 warps in 4 k-groups up to NTW = 4, 8 warps in 2
    k-groups from 8 (``tiled_ntw`` and ``gaussian_sketch_tiled_groups`` of
    the CUDA source)."""
    cols = -(-min(m, TILED_CHUNK) // 8)
    ntw = 1
    while ntw < cols:
        ntw *= 2
    return ntw, 4 if ntw <= 4 else 2


def tiled_split(n_tiles: int, k: int, m: int, resident_blocks: int) -> int:
    """Tile ranges ``n_split`` of the tiled kernel: its grid is n_split x
    ceil(k / 128) x ceil(m / TILED_CHUNK) blocks, one per block the card holds at
    once, and no more ranges than tiles. The kernel gives range z the tiles
    [z T / n_split, (z + 1) T / n_split), T = ``n_tiles``, and k-group kg
    of its KG the tiles kg, kg + KG, ... of that range."""
    per_range = -(-k // _TILED_K) * -(-m // TILED_CHUNK)
    return max(1, min(n_tiles, -(-resident_blocks // per_range)))


@functools.cache
def _resident_tiled(dev_index: int, mode: int, ntw: int) -> int:
    """Blocks of the tiled kernel's instance ``ntw`` that device
    ``dev_index`` (current when called) holds at once, the shared-memory
    attribute of every instance set first; once per device and instance."""
    lib = _lib()
    _raise_on(lib.gaussian_sketch_tiled_prepare(), "gaussian_sketch tiled setup")
    per_sm = ctypes.c_int(0)
    _raise_on(lib.gaussian_sketch_tiled_occupancy(mode, 8 * ntw, ctypes.byref(per_sm)),
              "gaussian_sketch tiled occupancy query")
    if per_sm.value < 1:
        raise RuntimeError("gaussian_sketch: no block of the tiled kernel fits on an SM")
    return sm_count(dev_index) * per_sm.value


def tiled_launch(dev_index: int, n: int, m: int, k: int, W: int, dist: str) -> int:
    """n_split of the tiled kernel for x (n, m) on CUDA device
    ``dev_index`` (current when called)."""
    ntw, _ = tiled_instance(m)
    resident = _resident_tiled(dev_index, _mode(k, dist), ntw)
    return tiled_split(tiled_tiles(n, W), k, m, resident)


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 (10 mantissa bits, to nearest, ties
    away from zero), as ``cvt.rna.tf32.f32`` does for finite values."""
    bits = v.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product_3xtf32(omega: torch.Tensor, x: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """The tiled kernel's product in plain torch: omega (k, n) @ x (n, m) as
    hi hi + hi lo + lo hi over the TF32 splits (``passes=2`` drops lo hi,
    the Rademacher form; 1 is plain TF32), float32 sums."""
    def split(v):
        hi = tf32_round(v)
        return hi, tf32_round(v.to(torch.float32) - hi)

    (oh, ol), (xh, xl) = split(omega), split(x)
    out = oh @ xh
    if passes >= 2:
        out = oh @ xl + out
    if passes >= 3:
        out = ol @ xh + out
    return out


def _launch_sketch(Xm: torch.Tensor, k: int, seed: int, W: int, dist: str,
                   branch: str | None = None) -> torch.Tensor:
    """Launch the sketch kernel: the small branch for m <= SMALL_M_MAX[dist],
    the tiled one above. ``branch`` forces one; the small branch has
    instances for m <= 8 only."""
    n, m = Xm.shape
    if min(Xm.stride()) < 0:
        raise ValueError(f"gaussian_sketch: negative strides {Xm.stride()}")
    if branch is None:
        branch = "small" if m <= SMALL_M_MAX[dist] else "tiled"
    if branch not in BRANCHES or (branch == "small" and m > 8):
        raise ValueError(f"gaussian_sketch: no {branch!r} branch for m = {m}")
    lib = _lib()
    dev = Xm.device
    # out is its own allocation: a view into the partial buffer would keep
    # the whole buffer alive as long as the caller holds the sketch
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if branch == "small":
            S, G, n_split = small_launch(dev.index, n, m, k, dist)
            partials = n_split
        else:
            n_split = tiled_launch(dev.index, n, m, k, W, dist)
            partials = n_split * tiled_instance(m)[1]  # a sum per k-group
        partial = torch.empty(k * m * partials, dtype=torch.float32, device=dev)
        args = (Xm.data_ptr(), partial.data_ptr(), out.data_ptr(), n, m, k,
                Xm.stride(0), Xm.stride(1), W, int(seed) & philox.MASK32, _mode(k, dist))
        scale, stream = 1.0 / math.sqrt(k), _stream(dev)
        if branch == "small":
            err = lib.gaussian_sketch_small_f32(*args, S, G, n_split, scale, stream)
        else:
            err = lib.gaussian_sketch_tiled_f32(*args, n_split, scale, stream)
    _raise_on(err, f"gaussian_sketch {branch} kernel launch")
    gaussian_sketch.launches += 1
    gaussian_sketch.launches_by_branch[branch] += 1
    return out


def gaussian_sketch(X, k: int, seed: int, block_rows: int = DEFAULT_BLOCK_ROWS,
                    dist: str = "normal") -> torch.Tensor:
    """Sketch of X: (n, m) -> (k, m), (n,) -> (k,), Omega ~ N(0, 1/k)
    (``dist="rademacher"``: +-1/sqrt(k)), float32.

    On a CUDA tensor this launches the hand-written kernel (built at first
    use) and raises if it cannot; on a CPU tensor it runs
    :func:`gaussian_sketch_plain`. ``gaussian_sketch.launches`` counts
    kernel launches, ``gaussian_sketch.launches_by_branch`` the launches of
    each branch (``"small"``, m <= ``SMALL_M_MAX[dist]``; ``"tiled"``)."""
    _check(k, block_rows, dist)
    Xm, single = _as_input(X)
    if Xm.device.type == "cpu":
        out = _sketch_plain(Xm, k, seed, block_rows, dist)
    elif Xm.device.type == "cuda":
        out = _launch_sketch(Xm, k, seed, block_rows, dist)
    else:
        raise ValueError(f"gaussian_sketch: unsupported device {Xm.device}")
    return out[:, 0] if single else out


gaussian_sketch.launches = 0
gaussian_sketch.launches_by_branch = dict.fromkeys(BRANCHES, 0)


def gaussian_strip(k: int, seed: int, b: int, block_rows: int = DEFAULT_BLOCK_ROWS,
                   dist: str = "normal", device=None) -> torch.Tensor:
    """Strip ``b`` of the unscaled Omega, (k, block_rows) float32: the values
    :func:`gaussian_sketch` contracts with rows ``[b W, (b + 1) W)``.

    On a CUDA ``device`` (the default) this launches the hand-written strip
    kernel and raises if it cannot; on the CPU it runs
    :func:`gaussian_strip_plain`. ``gaussian_strip.launches`` counts kernel
    launches."""
    _check(k, block_rows, dist)
    dev = resolve_device(device)
    if dev.type == "cpu":
        return gaussian_strip_plain(k, seed, b, block_rows, dist, dev)
    if dev.type != "cuda":
        raise ValueError(f"gaussian_strip: unsupported device {dev}")
    if not 0 <= int(b) <= philox.MASK32:
        raise ValueError(f"gaussian_strip: strip index {b} out of range")
    lib = _lib()
    out = torch.empty((k, block_rows), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gaussian_strip_f32(out.data_ptr(), k, block_rows,
                                     int(seed) & philox.MASK32, int(b),
                                     _mode(k, dist), _stream(dev))
    _raise_on(err, "gaussian_strip kernel launch")
    gaussian_strip.launches += 1
    return out


gaussian_strip.launches = 0
