"""DoF-blocked random sketching on one device.

Counterpart of the one-device parts of
``rla4mor_tpu/parallel/sharded_sketch.py``. The Gaussian Omega is generated
in column blocks of the canonical tile grid (``ops/seeding.py``) and never
held whole, so the blocked and chunked sketches equal
``GaussianEmbedding(k, n, seed).random_matrix() @ x`` column block for
column block. The SRHT needs nothing here: on one device the JAX package's
flat sharded SRHT is the canonical SRHT of the seed, which the port's
``SrhtEmbedding.apply_random`` computes (the one-pass kernel for
n >= 2^16). The mesh, ``shard_map`` and ``psum`` wait for the multi-device
port.
"""

from __future__ import annotations

import torch

from rla4mor_tpu_torch.ops.fwht import ceil_log2
from rla4mor_tpu_torch.ops.seeding import gaussian_cols

# the one-pass SRHT's block length, 2^min(11, d)
_R_LOG = 11


def gaussian_block(seed: int, k: int, block_size: int, block_index: int,
                   dtype=torch.float64, device=None) -> torch.Tensor:
    """(k, block_size) column block ``block_index`` of the canonical Omega,
    scaled 1/sqrt(k): drawn in float64 on the CPU (as
    ``GaussianEmbedding.random_matrix``), then cast and moved."""
    omega = gaussian_cols(seed, k, block_index * block_size, block_size, torch.float64)
    return omega.to(device=device, dtype=dtype)


def gaussian_sketch_blocked(seed: int, k: int, x: torch.Tensor,
                            n_blocks: int) -> torch.Tensor:
    """Omega @ x with Omega generated in ``n_blocks`` column blocks."""
    n = x.shape[0]
    if n % n_blocks:
        raise ValueError(f"gaussian_sketch_blocked: {n} rows in {n_blocks} blocks")
    bs = n // n_blocks
    out = x.new_zeros((k,) + tuple(x.shape[1:]))
    for b in range(n_blocks):
        out = out + gaussian_block(seed, k, bs, b, x.dtype, x.device) @ x[b * bs:(b + 1) * bs]
    return out


def gaussian_sketch_sharded(seed: int, k: int, x: torch.Tensor,
                            max_omega_elems: int = 1 << 26) -> torch.Tensor:
    """Omega @ x on one device, the Omega strip generated in column chunks
    of at most ``max_omega_elems`` entries (widths halved from n while
    even), accumulated chunk by chunk as the JAX package's shard does."""
    n = x.shape[0]
    width = n
    while width * k > max_omega_elems and width % 2 == 0:
        width //= 2
    acc = x.new_zeros((k,) + tuple(x.shape[1:]))
    for j in range(n // width):
        omega = gaussian_block(seed, k, width, j, x.dtype, x.device)
        acc = acc + omega @ x[j * width:(j + 1) * width]
    return acc


def flat_shard_rows(n: int, n_devices: int = 1, block: int | None = None
                    ) -> tuple[int, int]:
    """(n_phys, R) of the zero-padded whole-R-block row layout of the flat
    sharded SRHT for a true length ``n``: blocks of R = 2^min(11, d) rows,
    rounded up to a multiple of ``n_devices``. The port's SRHT kernel takes
    any n as it is, so one device needs no padding; this is the layout's
    arithmetic."""
    d = ceil_log2(max(n, 1))
    R = (1 << min(_R_LOG, d)) if block is None else block
    if R & (R - 1):
        raise ValueError(f"flat_shard_rows: block {R} is not a power of two")
    while R > 1 and -(-n // R) < n_devices:
        R //= 2
    b_total = -(-(-(-n // R)) // n_devices) * n_devices
    return b_total * R, R
