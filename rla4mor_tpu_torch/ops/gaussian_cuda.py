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
# the small-m kernel (registers) takes m <= SMALL_M_MAX, the tiled one the rest
SMALL_M_MAX = 8
# small kernel: threads a block aims at (the most it takes is the kernel's)
_SMALL_THREADS = 256
# the tiled kernel's tile: kTileK sketch rows by kTileW strip columns, both 128
_TILE = 128
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
    lib.gaussian_sketch_tiled_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_uint32, ctypes.c_int]
        + [ctypes.c_int64] * 2 + [ctypes.c_double, ctypes.c_void_p])
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


@functools.cache
def _prepare_tiled(dev_index: int) -> None:
    """The tiled kernel's shared-memory attribute, once per device."""
    _raise_on(_lib().gaussian_sketch_tiled_prepare(), "gaussian_sketch tiled setup")


def _tiled_launch(dev_index: int, n: int, k: int, W: int) -> tuple[int, int, int]:
    """(tiles meeting [0, n), tiles per split, n_split) of the tiled kernel."""
    _prepare_tiled(dev_index)
    full, rem = divmod(n, W)
    n_tiles = full * -(-W // _TILE) + -(-rem // _TILE)
    # about four blocks per SM over the (split, k-tile) grid, >= 1 tile each
    n_split = max(1, min(n_tiles, -(-4 * sm_count(dev_index) // -(-k // _TILE))))
    per_split = -(-n_tiles // n_split)
    return n_tiles, per_split, -(-n_tiles // per_split)


def _launch_sketch(Xm: torch.Tensor, k: int, seed: int, W: int,
                   dist: str) -> torch.Tensor:
    n, m = Xm.shape
    if min(Xm.stride()) < 0:
        raise ValueError(f"gaussian_sketch: negative strides {Xm.stride()}")
    lib = _lib()
    dev = Xm.device
    # out is its own allocation: a view into the partial buffer would keep
    # the whole buffer alive as long as the caller holds the sketch
    out = torch.empty((k, m), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        small = m <= SMALL_M_MAX
        if small:
            S, G, n_split = small_launch(dev.index, n, m, k, dist)
        else:
            n_tiles, per_split, n_split = _tiled_launch(dev.index, n, k, W)
        partial = torch.empty(k * m * n_split, dtype=torch.float32, device=dev)
        args = (Xm.data_ptr(), partial.data_ptr(), out.data_ptr(), n, m, k,
                Xm.stride(0), Xm.stride(1), W, int(seed) & philox.MASK32, _mode(k, dist))
        scale, stream = 1.0 / math.sqrt(k), _stream(dev)
        if small:
            err = lib.gaussian_sketch_small_f32(*args, S, G, n_split, scale, stream)
        else:
            err = lib.gaussian_sketch_tiled_f32(*args, n_tiles, per_split, scale, stream)
    _raise_on(err, "gaussian_sketch kernel launch")
    gaussian_sketch.launches += 1
    return out


def gaussian_sketch(X, k: int, seed: int, block_rows: int = DEFAULT_BLOCK_ROWS,
                    dist: str = "normal") -> torch.Tensor:
    """Sketch of X: (n, m) -> (k, m), (n,) -> (k,), Omega ~ N(0, 1/k)
    (``dist="rademacher"``: +-1/sqrt(k)), float32.

    On a CUDA tensor this launches the hand-written kernel (built at first
    use) and raises if it cannot; on a CPU tensor it runs
    :func:`gaussian_sketch_plain`. ``gaussian_sketch.launches`` counts
    kernel launches."""
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
