"""One-pass sampled SRHT: the hand-written CUDA kernel, its plain version and
the wrapper that picks between them.

Counterpart of ``rla4mor_tpu/ops/srht_pallas.py``. The kernel
(``csrc/srht_onepass.cu``) replaces the TPU kernels ``srht_pallas`` and
``srht_pallas_packed`` and the XLA twins the JAX embedding dispatches to
(``srht_onepass_vec``, ``_flat_cols``, ``_cols_bmk``, ``_flat``): all of
them compute, for ``x`` of shape (n, m) and any n,

    out[s, j] = (1/sqrt(k)) * sum_{i < n} (-1)^popcount(sigma_s & i) d_i x[i, j]

with the plan ``(d, sigma)`` of ``ops/fwht.py`` (sigma in [0, 2^ceil(log2 n))).
Summing over i < n only is the zero-padding semantics of the SRHT.

The kernel uses the (B, R) factorisation of the plain version below: an
FWHT of length R = 2^11 of each block of ``d * x`` in registers and warp
shuffles, the gather of the k rows sigma mod R fused with the +-1 sum over
the blocks (H_B), on a persistent grid whose CTAs each take a contiguous
range of blocks of one column tile while the next block's tile arrives by
``cp.async``. The CTAs' partial sums are added in the same launch, in a
fixed order, by the last CTA of each group of CTAs and then of the tile
(counters in a per-stream scratch buffer, kept zero, pick them; no
atomics in the sums). That is log2 R + k / R adds per element, so the one read of x
bounds it at large n and the launch and its reduction at the slice's
n = 261,121. The design is in the note at the top of the CUDA source.

The launch plan is pure Python (:func:`tile_width`, :func:`tile`,
:func:`block_split`); the occupancy it needs is queried once per device
and tile, and the launch record built once per shape, so that the host's
work per call is small. The
plan the kernel reads, int8 signs and int32 sampled rows, is passed as it
is where it already has those types (``SrhtEmbedding`` holds it so);
anything else is converted on the call.

Sign packing (``srht_pallas_packed``) was a TPU traffic trick and is not
part of the semantics; bf16 input is later work too and raises here.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from rla4mor_tpu_torch.ops.fwht import ceil_log2, hadamard_sign
from rla4mor_tpu_torch.utils import nvcc
from rla4mor_tpu_torch.utils.config import sm_count

SOURCE = "srht_onepass.cu"
# the kernel's FWHT block length R = 2^11; the plain version's R = 2^min(11, d)
_R_LOG = 11


def srht_onepass_plain(x: torch.Tensor, k: int, signs: torch.Tensor,
                       sampling: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch one-pass SRHT of real ``x`` (n, m) -> (k, m).

    The flat (B, R) contraction of the JAX package's ``_flat_plan``: with
    N = 2^d = B_full * R and i = b * R + r, the Hadamard entry factors as
    H[sigma, i] = H_B[sigma >> log2 R, b] * H_R[sigma mod R, r], so the sum is
    one (K, R) @ (B, R, m) product and a +-1 recombination over the
    ceil(n / R) nonzero blocks (the zero tail of the last block is padded).
    """
    n, m = x.shape
    d = ceil_log2(n)
    R = 1 << min(_R_LOG, d)
    dr = R.bit_length() - 1
    B = -(-n // R)
    samp = sampling.to(device=x.device, dtype=torch.int64)
    gr = hadamard_sign(
        (samp[:, None] & (R - 1)) & torch.arange(R, device=x.device)[None, :]
    ).to(x.dtype)                                                  # (K, R)
    hb = hadamard_sign(
        (samp[:, None] >> dr) & torch.arange(B, device=x.device)[None, :]
    ).to(x.dtype)                                                  # (K, B)
    xd = x.new_zeros((B * R, m))
    torch.mul(x, signs.to(device=x.device, dtype=x.dtype)[:, None], out=xd[:n])
    w = torch.matmul(gr, xd.reshape(B, R, m))                     # (B, K, m)
    out = torch.einsum("bkm,kb->km", w, hb)
    return out / math.sqrt(k)


# the kernel's copy of the plan: its types, 16-byte aligned
_PLAN_ALIGN = 16
# Columns of a tile, most, by layout (the .cu has MT = 1, 2, 4), and the
# blocks an SM the tiles must give before a tile is as wide as that. The
# fastest widths on an H100 (probes/srht_probe.py --sweep, float32 and
# float64): at 56 columns of 2^24 (8,192 blocks) and of 2^20, MT 2 for the
# rows layout's 16-byte copies and 4 for the columns layout's element
# copies; at 8 columns of 2^20 and of 261,121 (a few blocks an SM), MT 1,
# whose tiles spread the reduction over more CTAs.
_MT_MAX = {True: 2, False: 4}
_FILL_BLOCKS_PER_SM = 32


class _Launch(ctypes.Structure):
    """``SrhtLaunch`` of ``csrc/srht_onepass.cu``, field for field."""

    _fields_ = ([(f, ctypes.c_int64) for f in
                 ("n", "m", "k", "stride_i", "stride_j", "blocks_per_cta", "n_split",
                  "group")]
                + [(f, ctypes.c_int32) for f in ("device", "log2_r", "mt", "ld", "smem")]
                + [("scale", ctypes.c_double)])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    launch = ctypes.POINTER(_Launch)
    for fn in (lib.srht_onepass_f32, lib.srht_onepass_f64):
        fn.argtypes = [launch] + [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
    lib.srht_onepass_scratch.argtypes = [launch] + [ctypes.POINTER(ctypes.c_int64)] * 2
    lib.srht_onepass_scratch.restype = None
    lib.srht_onepass_setup.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.srht_onepass_setup.restype = ctypes.c_int
    lib.srht_onepass_rows_per_cta.argtypes = []
    lib.srht_onepass_rows_per_cta.restype = ctypes.c_int
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: cudaError {err}")


def tile_width(n: int, m: int, rows_layout: bool, sms: int) -> int:
    """MT, the columns of the kernel's tile: the least power of two >= m up
    to ``_MT_MAX``, halved while the tiles' blocks (ceil(m / MT) ceil(n / R))
    come to fewer than ``_FILL_BLOCKS_PER_SM`` for each of the card's
    ``sms``: with few blocks a CTA, the tile's reduction weighs as much as
    its transform, and narrower tiles share it among more CTAs."""
    mt = min(_MT_MAX[rows_layout], 1 << (m - 1).bit_length())
    n_blocks = -(-n // (1 << _R_LOG))
    while mt > 1 and -(-m // mt) * n_blocks < _FILL_BLOCKS_PER_SM * sms:
        mt //= 2
    return mt


def tile(mt: int, itemsize: int) -> tuple[int, int]:
    """(ld, shared-memory bytes) of an MT-column tile of ``itemsize``
    values: each of the two stages holds MT columns of R values ld = R + 16
    bytes apart (16-byte copies stay aligned, element copies hit distinct
    banks) and the R int8 signs."""
    R = 1 << _R_LOG
    ld = R + 16 // itemsize
    return ld, 2 * (mt * ld * itemsize + R)


def block_split(n: int, m: int, k: int, mt: int, rows_per_cta: int,
                resident: int) -> tuple[int, int]:
    """(blocks per CTA, CTAs along the blocks) for the ceil(n / R) blocks:
    the card's ``resident`` CTAs shared by the column and sampled-row tiles,
    at least one block each. CTA z takes blocks [z bpc, min(B, (z + 1) bpc))."""
    n_blocks = -(-n // (1 << _R_LOG))
    tiles = -(-m // mt) * -(-k // rows_per_cta)
    per_tile = max(1, min(n_blocks, resident // tiles))
    bpc = -(-n_blocks // per_tile)
    return bpc, -(-n_blocks // bpc)


@functools.cache
def _resident(dev_index: int, itemsize: int, mt: int, smem: int) -> int:
    """CTAs of the (itemsize, MT) kernel that device ``dev_index`` holds at
    once at ``smem`` bytes each; lets it take all the shared memory a CTA
    may opt in to first."""
    per_sm = ctypes.c_int(0)
    _raise_on(_lib().srht_onepass_setup(dev_index, int(itemsize == 8), _R_LOG, mt, smem,
                                        ctypes.byref(per_sm)), "srht_onepass setup")
    return sm_count(dev_index) * max(1, per_sm.value)


@functools.lru_cache(maxsize=256)
def _launch_plan(dev_index: int, itemsize: int, n: int, m: int, k: int, stride_i: int,
                 stride_j: int) -> tuple[_Launch, int, int]:
    """(the kernel's launch record, its counters, its values of sums) for
    one device and shape."""
    if (1 << ceil_log2(n)) > 1 << 31:
        raise ValueError(f"srht_onepass: n={n} exceeds 2^31")
    lib = _lib()
    mt = tile_width(n, m, stride_i == 1, sm_count(dev_index))
    ld, smem = tile(mt, itemsize)
    bpc, n_split = block_split(n, m, k, mt, lib.srht_onepass_rows_per_cta(),
                               _resident(dev_index, itemsize, mt, smem))
    # the partial sums are added in groups of about sqrt(n_split) CTAs
    group = math.isqrt(n_split - 1) + 1
    rec = _Launch(n, m, k, stride_i, stride_j, bpc, n_split, group, dev_index, _R_LOG, mt,
                  ld, smem, 1.0 / math.sqrt(k))
    n_counters, n_sums = ctypes.c_int64(0), ctypes.c_int64(0)
    lib.srht_onepass_scratch(rec, ctypes.byref(n_counters), ctypes.byref(n_sums))
    return rec, n_counters.value, n_sums.value


# Per (device, stream, dtype): the kernel's scratch, its counters (zero
# between launches, and used for nothing else) and its partial sums.
# Launches on one stream run in order, so they can share them; each grows
# to the largest shape seen.
_SCRATCH: dict[tuple, torch.Tensor] = {}


def _scratch(index: int, stream: int, dtype: torch.dtype, numel: int) -> int:
    key = (index, stream, dtype)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < numel:
        buf = torch.zeros(numel, dtype=dtype, device=torch.device("cuda", index))
        _SCRATCH[key] = buf
    return buf.data_ptr()


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev_index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(dev_index)
    return torch.cuda.current_stream(dev_index).cuda_stream


def _plan_operand(t: torch.Tensor, dtype: torch.dtype, index: int) -> torch.Tensor:
    if (t.dtype is dtype and t.get_device() == index and t.is_contiguous()
            and t.data_ptr() % _PLAN_ALIGN == 0):
        return t
    return t.to(device=torch.device("cuda", index), dtype=dtype, copy=True).contiguous()


def _launch(x: torch.Tensor, k: int, signs: torch.Tensor,
            sampling: torch.Tensor) -> torch.Tensor:
    n, m = x.shape
    stride_i, stride_j = x.stride()
    if stride_i < 0 or stride_j < 0:
        raise ValueError(f"srht_onepass: negative strides {x.stride()}")
    if signs.shape != (n,) or sampling.shape != (k,):
        raise ValueError(
            f"srht_onepass: plan shapes {tuple(signs.shape)}, "
            f"{tuple(sampling.shape)} do not match n={n}, k={k}")
    index = x.get_device()
    f64 = x.dtype is torch.float64
    rec, n_counters, n_sums = _launch_plan(index, 8 if f64 else 4, n, m, k, stride_i,
                                           stride_j)
    d_signs = _plan_operand(signs, torch.int8, index)
    sigma = _plan_operand(sampling, torch.int32, index)
    stream = _stream(index)
    done = _scratch(index, stream, torch.int32, n_counters)
    sums = _scratch(index, stream, x.dtype, n_sums)
    out = x.new_empty((k, m))
    lib = _lib()
    fn = lib.srht_onepass_f64 if f64 else lib.srht_onepass_f32
    _raise_on(fn(rec, x.data_ptr(), d_signs.data_ptr(), sigma.data_ptr(), done, sums,
                 out.data_ptr(), stream), "srht_onepass kernel launch")
    srht_onepass.launches += 1
    return out


def srht_onepass(x: torch.Tensor, k: int, signs: torch.Tensor,
                 sampling: torch.Tensor) -> torch.Tensor:
    """One-pass sampled SRHT of ``x`` (n, m), any strides -> (k, m).

    On a CUDA tensor this launches the hand-written kernel (built at first
    use) and raises if it cannot; on a CPU tensor it runs
    :func:`srht_onepass_plain`. Complex input is sketched as its real and
    imaginary parts (``view_as_real``). float32 and float64 only.
    ``srht_onepass.launches`` counts kernel launches."""
    if x.is_cuda and x.dtype in _KERNEL_DTYPES and x.dim() == 2:
        return _launch(x, k, signs, sampling)
    if x.dim() != 2:
        raise ValueError(f"srht_onepass expects (n, m), got {tuple(x.shape)}")
    if x.is_complex():
        xr = torch.view_as_real(x)
        return torch.complex(srht_onepass(xr[..., 0], k, signs, sampling),
                             srht_onepass(xr[..., 1], k, signs, sampling))
    if x.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"srht_onepass: {x.dtype} input is not supported yet")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"srht_onepass: unsupported dtype {x.dtype}")
    if x.device.type == "cpu":
        return srht_onepass_plain(x, k, signs, sampling)
    if x.device.type != "cuda":
        raise ValueError(f"srht_onepass: unsupported device {x.device}")
    return _launch(x, k, signs, sampling)


srht_onepass.launches = 0
_KERNEL_DTYPES = (torch.float32, torch.float64)
