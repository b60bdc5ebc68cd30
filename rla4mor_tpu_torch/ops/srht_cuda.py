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

What bounds the kernel on an H100: it does n * k * m FMAs on the CUDA cores
(the +-1 Hadamard signs are built in registers with ``__popc``), so at the
bench shape (n = 2^24, k = 256, m = 56) it is compute-bound, far above the
one-read floor of its input. The design stages each chunk of ``d * x`` in
shared memory once for all sampled rows of a block, and splits the sum over
i deterministically (partial sums in a scratch buffer, then a reduction
kernel; no atomics). Moving the R-contraction onto tensor cores (the
H_B (x) H_R split with 3xTF32) is later work.

Sign packing (``srht_pallas_packed``) was a TPU traffic trick and is not
part of the semantics; bf16 input is later work too and raises here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from rla4mor_tpu_torch.ops.fwht import ceil_log2, hadamard_sign
from rla4mor_tpu_torch.utils import nvcc

SOURCE = "srht_onepass.cu"
_R_LOG = 11  # block length of the plain (B, R) contraction: R = 2^min(11, d)


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


def _lib() -> ctypes.CDLL:
    lib = nvcc.load(SOURCE)
    args = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7 + [
        ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    for fn in (lib.srht_onepass_f32, lib.srht_onepass_f64):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.srht_onepass_chunk_rows.argtypes = []
    lib.srht_onepass_chunk_rows.restype = ctypes.c_int
    return lib


def _split(n: int, blocks_per_split: int, device: torch.device,
           chunk: int) -> tuple[int, int]:
    """(n_split, rows_per_split): enough blocks for ~8 per SM, split
    boundaries on chunk multiples, at most 65535 splits."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = -(-n // chunk)
    want = max(1, -(-8 * sms // blocks_per_split))
    n_split = min(want, chunks, 65535)
    rows = -(-chunks // n_split) * chunk
    return -(-n // rows), rows


def _launch(x: torch.Tensor, k: int, signs: torch.Tensor,
            sampling: torch.Tensor) -> torch.Tensor:
    n, m = x.shape
    if min(x.stride()) < 0:
        raise ValueError(f"srht_onepass: negative strides {x.stride()}")
    if signs.shape != (n,) or sampling.shape != (k,):
        raise ValueError(
            f"srht_onepass: plan shapes {tuple(signs.shape)}, "
            f"{tuple(sampling.shape)} do not match n={n}, k={k}")
    if (1 << ceil_log2(n)) > 1 << 31:
        raise ValueError(f"srht_onepass: n={n} exceeds 2^31")
    lib = _lib()
    dev = x.device
    d_signs = signs.to(device=dev, dtype=torch.int8).contiguous()
    sigma = sampling.to(device=dev, dtype=torch.int32).contiguous()
    mt = 1 if m == 1 else 2 if m == 2 else 4 if m <= 4 else 8
    blocks = -(-m // mt) * -(-k // 128)
    n_split, rows = _split(n, blocks, dev, lib.srht_onepass_chunk_rows())
    partial = torch.empty((n_split, k, m), dtype=x.dtype, device=dev)
    out = torch.empty((k, m), dtype=x.dtype, device=dev)
    fn = lib.srht_onepass_f32 if x.dtype == torch.float32 else lib.srht_onepass_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), d_signs.data_ptr(), sigma.data_ptr(),
                 partial.data_ptr(), out.data_ptr(), n, m, k,
                 x.stride(0), x.stride(1), n_split, rows, mt,
                 1.0 / math.sqrt(k), stream)
    if err != 0:
        raise RuntimeError(f"srht_onepass kernel launch failed: cudaError {err}")
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
    if x.dim() != 2:
        raise ValueError(f"srht_onepass expects (n, m), got {tuple(x.shape)}")
    if x.is_complex():
        xr = torch.view_as_real(x)
        return torch.complex(srht_onepass(xr[..., 0], k, signs, sampling),
                             srht_onepass(xr[..., 1], k, signs, sampling))
    if x.dtype in (torch.bfloat16, torch.float16):
        raise NotImplementedError(
            f"srht_onepass: {x.dtype} input is not supported yet")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"srht_onepass: unsupported dtype {x.dtype}")
    if x.device.type == "cpu":
        return srht_onepass_plain(x, k, signs, sampling)
    if x.device.type != "cuda":
        raise ValueError(f"srht_onepass: unsupported device {x.device}")
    return _launch(x, k, signs, sampling)


srht_onepass.launches = 0
