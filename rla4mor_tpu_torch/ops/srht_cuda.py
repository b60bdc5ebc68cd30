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

Input may be float32, float64, bfloat16 or float16. As in the JAX package,
the sums run in ``promote_types(x.dtype, float32)`` (float32 for the 2-byte
types, whose values the kernel widens on the way into its transform), and
the result is ``out_dtype``: the input's dtype unless asked otherwise. The
kernel writes the sums' dtype or the input's directly; any other
``out_dtype`` is a cast of the sums. Sign packing (``srht_pallas_packed``)
was a TPU traffic trick and is not part of the semantics.
"""

from __future__ import annotations

import collections
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


def accumulator_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the sums run in: ``promote_types(dtype, float32)``, as the
    JAX package's ``acc_dtype`` (float32 for bf16, f16 and f32 input)."""
    return torch.promote_types(dtype, torch.float32)


def srht_onepass_plain(x: torch.Tensor, k: int, signs: torch.Tensor,
                       sampling: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch one-pass SRHT of real ``x`` (n, m) -> (k, m).

    The flat (B, R) contraction of the JAX package's ``_flat_plan``: with
    N = 2^d = B_full * R and i = b * R + r, the Hadamard entry factors as
    H[sigma, i] = H_B[sigma >> log2 R, b] * H_R[sigma mod R, r], so the sum is
    one (K, R) @ (B, R, m) product and a +-1 recombination over the
    ceil(n / R) nonzero blocks (the zero tail of the last block is padded).
    A 2-byte ``x`` is multiplied by its signs in its own dtype (exact) and
    widened to float32, where the sums run; the result is ``out_dtype``
    (default: x's dtype).
    """
    n, m = x.shape
    acc = accumulator_dtype(x.dtype)
    d = ceil_log2(n)
    R = 1 << min(_R_LOG, d)
    dr = R.bit_length() - 1
    B = -(-n // R)
    samp = sampling.to(device=x.device, dtype=torch.int64)
    gr = hadamard_sign(
        (samp[:, None] & (R - 1)) & torch.arange(R, device=x.device)[None, :]
    ).to(acc)                                                      # (K, R)
    hb = hadamard_sign(
        (samp[:, None] >> dr) & torch.arange(B, device=x.device)[None, :]
    ).to(acc)                                                      # (K, B)
    xd = x.new_zeros((B * R, m), dtype=acc)
    s = signs.to(device=x.device, dtype=x.dtype)[:, None]
    if x.dtype == acc:
        torch.mul(x, s, out=xd[:n])
    else:
        xd[:n] = x * s
    w = torch.matmul(gr, xd.reshape(B, R, m))                     # (B, K, m)
    out = torch.einsum("bkm,kb->km", w, hb) / math.sqrt(k)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    return out if out.dtype == out_dtype else out.to(out_dtype)


# the kernel's copy of the plan: its types, 16-byte aligned
_PLAN_ALIGN = 16
# Columns of a tile, most, by layout (the .cu has MT = 1, 2, 4), and the
# blocks an SM the tiles must give before a tile is as wide as that. The
# fastest widths on an NVIDIA H100 80GB HBM3 at 700 W (probes/srht_probe.py
# --sweep): at 56 columns of
# 2^24 (8,192 blocks) and of 2^20, MT 2 for float32 and float64 in the rows
# layout's 16-byte copies and 4 for the columns layout's element copies; MT 4
# in both layouts for a 2-byte type (bf16 blocked 1.48 ms against 1.58 at
# MT 2); at 8 columns of 2^20 and of 261,121 (a few blocks an SM), MT 1,
# whose tiles spread the reduction over more CTAs. A 2-byte type in the
# columns layout takes at least MT 2: its copies move a tile's row of MT
# values, and cp.async has no 2-byte copy.
_MT_MAX = {True: 2, False: 4}
_FILL_BLOCKS_PER_SM = 32
# the kernel's dtype codes (``Dtype`` in the .cu)
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2, torch.float16: 3}
_KERNEL_DTYPES = tuple(_DTYPE_CODE)


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
    lib.srht_onepass.argtypes = ([launch, ctypes.c_int] + [ctypes.c_void_p] * 6
                                 + [ctypes.c_int, ctypes.c_void_p])
    lib.srht_onepass.restype = ctypes.c_int
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


def tile_width(n: int, m: int, rows_layout: bool, sms: int, itemsize: int = 4) -> int:
    """MT, the columns of the kernel's tile: the least power of two >= m up
    to ``_MT_MAX`` (4 for a 2-byte type), halved while the tiles' blocks
    (ceil(m / MT) ceil(n / R)) come to fewer than ``_FILL_BLOCKS_PER_SM``
    for each of the card's ``sms``, but not below 2 for a 2-byte type
    outside the rows layout: with few blocks a CTA, the tile's reduction
    weighs as much as its transform, and narrower tiles share it among more
    CTAs."""
    narrow = itemsize == 2
    mt = min(4 if narrow else _MT_MAX[rows_layout], 1 << (m - 1).bit_length())
    least = min(2 if narrow and not rows_layout else 1, mt)
    n_blocks = -(-n // (1 << _R_LOG))
    while mt > least and -(-m // mt) * n_blocks < _FILL_BLOCKS_PER_SM * sms:
        mt //= 2
    return mt


def tile(mt: int, itemsize: int) -> tuple[int, int]:
    """(ld, shared-memory bytes) of an MT-column tile of ``itemsize``
    values: each of the two stages holds MT columns of R values R + 16
    bytes apart (16-byte copies stay aligned, element copies hit distinct
    banks) and the R int8 signs; ld is the column stride of the tile the
    sums are read from. A 4- or 8-byte tile is transformed in place; a
    2-byte one is widened into a third, float32 tile of MT columns ld
    apart (``smem_bytes`` in the .cu)."""
    R = 1 << _R_LOG
    if itemsize >= 4:
        ld = R + 16 // itemsize
        return ld, 2 * (mt * ld * itemsize + R)
    ld = R + 16 // 4
    return ld, 2 * (mt * (R + 16 // itemsize) * itemsize + R) + mt * ld * 4


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
def _resident(dev_index: int, dtype: torch.dtype, mt: int, smem: int) -> int:
    """CTAs of the (dtype, MT) kernel that device ``dev_index`` holds at
    once at ``smem`` bytes each; lets it take all the shared memory a CTA
    may opt in to first."""
    per_sm = ctypes.c_int(0)
    _raise_on(_lib().srht_onepass_setup(dev_index, _DTYPE_CODE[dtype], _R_LOG, mt, smem,
                                        ctypes.byref(per_sm)), "srht_onepass setup")
    return sm_count(dev_index) * max(1, per_sm.value)


@functools.lru_cache(maxsize=256)
def _launch_plan(dev_index: int, dtype: torch.dtype, n: int, m: int, k: int,
                 stride_i: int, stride_j: int) -> tuple[_Launch, int, int]:
    """(the kernel's launch record, its counters, its values of sums) for
    one device, input dtype and shape."""
    if (1 << ceil_log2(n)) > 1 << 31:
        raise ValueError(f"srht_onepass: n={n} exceeds 2^31")
    lib = _lib()
    itemsize = dtype.itemsize
    mt = tile_width(n, m, stride_i == 1, sm_count(dev_index), itemsize)
    ld, smem = tile(mt, itemsize)
    bpc, n_split = block_split(n, m, k, mt, lib.srht_onepass_rows_per_cta(),
                               _resident(dev_index, dtype, mt, smem))
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


def _launch(x: torch.Tensor, k: int, signs: torch.Tensor, sampling: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    n, m = x.shape
    stride_i, stride_j = x.stride()
    if stride_i < 0 or stride_j < 0:
        raise ValueError(f"srht_onepass: negative strides {x.stride()}")
    if signs.shape != (n,) or sampling.shape != (k,):
        raise ValueError(
            f"srht_onepass: plan shapes {tuple(signs.shape)}, "
            f"{tuple(sampling.shape)} do not match n={n}, k={k}")
    index = x.get_device()
    acc = accumulator_dtype(x.dtype)
    # the kernel writes the sums' dtype or, for a 2-byte x, x's own
    narrow = out_dtype == x.dtype != acc
    rec, n_counters, n_sums = _launch_plan(index, x.dtype, n, m, k, stride_i, stride_j)
    d_signs = _plan_operand(signs, torch.int8, index)
    sigma = _plan_operand(sampling, torch.int32, index)
    stream = _stream(index)
    done = _scratch(index, stream, torch.int32, n_counters)
    sums = _scratch(index, stream, acc, n_sums)
    out = x.new_empty((k, m), dtype=x.dtype if narrow else acc)
    _raise_on(_lib().srht_onepass(rec, _DTYPE_CODE[x.dtype], x.data_ptr(), d_signs.data_ptr(),
                                  sigma.data_ptr(), done, sums, out.data_ptr(), int(narrow),
                                  stream), "srht_onepass kernel launch")
    srht_onepass.launches += 1
    srht_onepass.launches_by_dtype[x.dtype] += 1
    return out if out.dtype == out_dtype else out.to(out_dtype)


def srht_onepass(x: torch.Tensor, k: int, signs: torch.Tensor,
                 sampling: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """One-pass sampled SRHT of ``x`` (n, m), any strides -> (k, m).

    On a CUDA tensor this launches the hand-written kernel (built at first
    use) and raises if it cannot; on a CPU tensor it runs
    :func:`srht_onepass_plain`. float32, float64, bfloat16 and float16; the
    sums run in ``promote_types(x.dtype, float32)`` and the result is
    ``out_dtype`` (default: x's dtype). Complex input is sketched as its real
    and imaginary parts (``view_as_real``), ``out_dtype`` then names their
    dtype or the complex one. ``srht_onepass.launches`` counts kernel
    launches, ``srht_onepass.launches_by_dtype`` the same by input dtype."""
    if out_dtype is None:
        out_dtype = x.dtype
    if x.is_cuda and x.dtype in _KERNEL_DTYPES and x.dim() == 2:
        return _launch(x, k, signs, sampling, out_dtype)
    if x.dim() != 2:
        raise ValueError(f"srht_onepass expects (n, m), got {tuple(x.shape)}")
    if x.is_complex():
        xr = torch.view_as_real(x)
        part = out_dtype.to_real() if out_dtype.is_complex else out_dtype
        return torch.complex(srht_onepass(xr[..., 0], k, signs, sampling, part),
                             srht_onepass(xr[..., 1], k, signs, sampling, part))
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"srht_onepass: unsupported dtype {x.dtype}")
    if x.device.type == "cpu":
        return srht_onepass_plain(x, k, signs, sampling, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"srht_onepass: unsupported device {x.device}")
    return _launch(x, k, signs, sampling, out_dtype)


srht_onepass.launches = 0
srht_onepass.launches_by_dtype = collections.Counter()
