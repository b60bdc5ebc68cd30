"""Seeded derivation of random embedding entries with explicit generators.

Counterpart of ``rla4mor_tpu/ops/seeding.py``. One seed names one operator
on every layout: Gaussian entries are drawn in fixed ``(TILE_K, TILE_N)``
tiles,

    T[i, j] = randn(generator(seed, i, j), (TILE_K, TILE_N)),

and Rademacher sign vectors in fixed ``SIGN_BLOCK`` blocks, so a row block,
a column strip and the whole matrix are slices of the same array (the
layout the block, streamed and sharded embeddings rely on).

Other operators on the same grid draw each tile from a stream of its own,
a tag after the tile's indices (``STREAM_*``): the complex Gaussian
(E|w|^2 = 1 as the JAX package's complex normal; real and imaginary parts
N(0, 1/2) from two generators), and the Rademacher matrix (real, or the
complex (s1 + i s2) / sqrt(2)). The tags are nonzero: numpy's
``SeedSequence`` pads short entropy with zeros, so ``(seed, i, j)`` and
``(seed, i, j, 0)`` name one stream.

Every draw uses an explicit CPU ``torch.Generator`` whose seed is derived
from ``(seed, *path)`` by numpy's ``SeedSequence``; results are moved to the
device afterwards, so the operator does not depend on the device. The bits
differ from the JAX package's threefry draws: parity tests carry the JAX
operator across (``GaussianEmbedding.from_matrix``,
``SrhtEmbedding.from_plan``) instead of reproducing its generator.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from rla4mor_tpu_torch.utils.config import resolve_device

TILE_K = 128
TILE_N = 4096
SIGN_BLOCK = 4096
# stream tags of the tile grid's other operators: (real part, imaginary part)
STREAM_COMPLEX_GAUSSIAN = (2, 3)
STREAM_RADEMACHER = (4, 5)


def generator(seed: int, *path: int) -> torch.Generator:
    """CPU generator of the stream named by ``(seed, *path)``."""
    state = np.random.SeedSequence([int(seed), *(int(p) for p in path)])
    word = int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device="cpu").manual_seed(word)


def _tile(seed: int, i: int, j: int, dtype) -> torch.Tensor:
    """(TILE_K, TILE_N) unscaled Gaussian tile (i, j), on the CPU; a complex
    ``dtype`` draws the complex tile (parts N(0, 1/2), own streams)."""
    if dtype.is_complex:
        part = dtype.to_real()
        re, im = (torch.randn((TILE_K, TILE_N), generator=generator(seed, i, j, tag),
                              dtype=part) for tag in STREAM_COMPLEX_GAUSSIAN)
        return torch.complex(re, im) / math.sqrt(2.0)
    return torch.randn((TILE_K, TILE_N), generator=generator(seed, i, j),
                       dtype=dtype)


def _sign_tile(seed: int, i: int, j: int, tag: int) -> torch.Tensor:
    """(TILE_K, TILE_N) int8 +-1 tile (i, j) of the Rademacher stream ``tag``."""
    bits = torch.randint(0, 2, (TILE_K, TILE_N), generator=generator(seed, i, j, tag),
                         dtype=torch.int8)
    return 1 - 2 * bits


def _assemble(tile, k: int, c0: int, width: int, r0: int) -> torch.Tensor:
    """Rows ``[r0, r0 + k)`` x columns ``[c0, c0 + width)`` of the grid whose
    tile (i, j) is ``tile(i, j)``, from the covering tiles. Each tile has a
    generator of its own, so many are drawn in a pool of threads (torch
    draws without the GIL) and the result does not depend on the order."""
    i0, i1 = r0 // TILE_K, -(-(r0 + k) // TILE_K)
    j0, j1 = c0 // TILE_N, -(-(c0 + width) // TILE_N)
    cells = [(i, j) for i in range(i0, i1) for j in range(j0, j1)]
    if len(cells) >= 8:
        with ThreadPoolExecutor(min(len(cells), os.cpu_count() or 1)) as pool:
            tiles = list(pool.map(lambda ij: tile(*ij), cells))
    else:
        tiles = [tile(i, j) for i, j in cells]
    nj = j1 - j0
    rows = [torch.cat(tiles[r * nj:(r + 1) * nj], dim=1) for r in range(i1 - i0)]
    full = torch.cat(rows, dim=0)
    return full[r0 - i0 * TILE_K: r0 - i0 * TILE_K + k,
                c0 - j0 * TILE_N: c0 - j0 * TILE_N + width]


def gaussian_cols_unscaled(seed: int, k: int, c0: int, width: int,
                           dtype=torch.float64, r0: int = 0) -> torch.Tensor:
    """Rows ``[r0, r0 + k)`` x columns ``[c0, c0 + width)`` of the unscaled
    canonical Gaussian (complex for a complex ``dtype``), assembled from the
    covering tiles (CPU)."""
    return _assemble(lambda i, j: _tile(seed, i, j, dtype), k, c0, width, r0)


def gaussian_rows(seed: int, n: int, r0: int, r1: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Rows ``[r0, r1)`` x columns ``[0, n)`` of the unscaled Gaussian."""
    return gaussian_cols_unscaled(seed, r1 - r0, 0, n, dtype, r0=r0)


def gaussian_matrix(seed: int, k: int, n: int, dtype=torch.float64,
                    device=None) -> torch.Tensor:
    """The canonical (k, n) Gaussian Omega with iid N(0, 1/k) entries
    (complex ones, E|w|^2 = 1/k, for a complex ``dtype``), drawn on the CPU
    and moved to ``device``."""
    omega = gaussian_rows(seed, n, 0, k, dtype) / math.sqrt(k)
    return omega.to(device=resolve_device(device))


def gaussian_cols(seed: int, k: int, c0: int, width: int,
                  dtype=torch.float64) -> torch.Tensor:
    """Scaled (k, width) column strip of the canonical N(0, 1/k) Omega."""
    return gaussian_cols_unscaled(seed, k, c0, width, dtype) / math.sqrt(k)


def rademacher_matrix(seed: int, k: int, n: int, complex_: bool = False) -> torch.Tensor:
    """The unscaled (k, n) Rademacher matrix on the tile grid (CPU): int8
    +-1 entries, or for ``complex_`` the pair (s1, s2) as an int8 (2, k, n)
    stack, s2 from its own stream."""
    tags = STREAM_RADEMACHER if complex_ else STREAM_RADEMACHER[:1]
    parts = [_assemble(lambda i, j: _sign_tile(seed, i, j, tag), k, 0, n, 0)
             for tag in tags]
    return torch.stack(parts) if complex_ else parts[0]


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


STREAM_SPARSE_SIGN = (6, 7)  # (rows, signs) of a sparse-sign plan


def sparse_sign_plan(seed: int, n: int, k: int, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (n, s) rows in [0, k) and int8 +-1 signs of a sparse-sign
    embedding: each block b of ``SIGN_BLOCK`` columns drawn from ``(seed,
    6, b)`` (rows) and ``(seed, 7, b)`` (signs), so the plan of a column does
    not depend on n (CPU)."""
    nb = -(-n // SIGN_BLOCK)
    rows = torch.cat([torch.randint(0, k, (SIGN_BLOCK, s), dtype=torch.int64,
                                    generator=generator(seed, STREAM_SPARSE_SIGN[0], b))
                      for b in range(nb)])
    bits = torch.cat([torch.randint(0, 2, (SIGN_BLOCK, s), dtype=torch.int8,
                                    generator=generator(seed, STREAM_SPARSE_SIGN[1], b))
                      for b in range(nb)])
    return rows[:n], (1 - 2 * bits)[:n]
