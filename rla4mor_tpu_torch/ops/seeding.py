"""Seeded derivation of random embedding entries with explicit generators.

Counterpart of ``rla4mor_tpu/ops/seeding.py``. One seed names one operator
on every layout: Gaussian entries are drawn in fixed ``(TILE_K, TILE_N)``
tiles,

    T[i, j] = randn(generator(seed, i, j), (TILE_K, TILE_N)),

and Rademacher sign vectors in fixed ``SIGN_BLOCK`` blocks, so a row block,
a column strip and the whole matrix are slices of the same array (the
layout later block and sharded embeddings rely on).

Every draw uses an explicit CPU ``torch.Generator`` whose seed is derived
from ``(seed, *path)`` by numpy's ``SeedSequence``; results are moved to the
device afterwards, so the operator does not depend on the device. The bits
differ from the JAX package's threefry draws: parity tests carry the JAX
operator across (``GaussianEmbedding.from_matrix``,
``SrhtEmbedding.from_plan``) instead of reproducing its generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rla4mor_tpu_torch.utils.config import resolve_device

TILE_K = 128
TILE_N = 4096
SIGN_BLOCK = 4096


def generator(seed: int, *path: int) -> torch.Generator:
    """CPU generator of the stream named by ``(seed, *path)``."""
    state = np.random.SeedSequence([int(seed), *(int(p) for p in path)])
    word = int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device="cpu").manual_seed(word)


def _tile(seed: int, i: int, j: int, dtype) -> torch.Tensor:
    """(TILE_K, TILE_N) unscaled Gaussian tile (i, j), on the CPU."""
    return torch.randn((TILE_K, TILE_N), generator=generator(seed, i, j),
                       dtype=dtype)


def gaussian_cols_unscaled(seed: int, k: int, c0: int, width: int,
                           dtype=torch.float64, r0: int = 0) -> torch.Tensor:
    """Rows ``[r0, r0 + k)`` x columns ``[c0, c0 + width)`` of the unscaled
    canonical Gaussian, assembled from the covering tiles (CPU)."""
    i0, i1 = r0 // TILE_K, -(-(r0 + k) // TILE_K)
    j0, j1 = c0 // TILE_N, -(-(c0 + width) // TILE_N)
    rows = [torch.cat([_tile(seed, i, j, dtype) for j in range(j0, j1)], dim=1)
            for i in range(i0, i1)]
    full = torch.cat(rows, dim=0)
    return full[r0 - i0 * TILE_K: r0 - i0 * TILE_K + k,
                c0 - j0 * TILE_N: c0 - j0 * TILE_N + width]


def gaussian_rows(seed: int, n: int, r0: int, r1: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Rows ``[r0, r1)`` x columns ``[0, n)`` of the unscaled Gaussian."""
    return gaussian_cols_unscaled(seed, r1 - r0, 0, n, dtype, r0=r0)


def gaussian_matrix(seed: int, k: int, n: int, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """The canonical (k, n) Gaussian Omega with iid N(0, 1/k) entries,
    drawn on the CPU and moved to ``device``."""
    omega = gaussian_rows(seed, n, 0, k, dtype) / math.sqrt(k)
    return omega.to(device=resolve_device(device))


def gaussian_cols(seed: int, k: int, c0: int, width: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Scaled (k, width) column strip of the canonical N(0, 1/k) Omega."""
    return gaussian_cols_unscaled(seed, k, c0, width, dtype) / math.sqrt(k)


def _sign_block(seed: int, stream: tuple, b: int) -> torch.Tensor:
    bits = torch.randint(0, 2, (SIGN_BLOCK,),
                         generator=generator(seed, *stream, b), dtype=torch.int8)
    return 1 - 2 * bits


def rademacher_slice(seed: int, c0: int, width: int,
                     stream: tuple = ()) -> torch.Tensor:
    """Entries ``[c0, c0 + width)`` of the canonical int8 +-1 vector of
    stream ``(seed, *stream)``; block b is drawn from ``(seed, *stream, b)``."""
    b0, b1 = c0 // SIGN_BLOCK, -(-(c0 + width) // SIGN_BLOCK)
    s = torch.cat([_sign_block(seed, stream, b) for b in range(b0, b1)])
    off = c0 - b0 * SIGN_BLOCK
    return s[off: off + width]


def rademacher_vector(seed: int, n: int, stream: tuple = ()) -> torch.Tensor:
    """Canonical (n,) int8 +-1 vector assembled from SIGN_BLOCK blocks."""
    return rademacher_slice(seed, 0, n, stream)
