"""The port's bitstream contract for the Gaussian sketch kernels, in plain torch.

The TPU kernels of ``rla4mor_tpu/ops/gaussian_pallas.py`` draw Omega from the
TPU's hardware PRNG, whose bits exist nowhere else. The port keeps the TPU
kernels' draw order (``_fill_strip``) and their bits-to-values maps, and
replaces the generator by Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11; Random123's known-answer vectors hold):

* strip ``b`` under ``seed`` uses the key ``(seed mod 2^32, b)``;
* entry ``(r, j)`` of the strip's draw number ``c`` is word ``j mod 4`` of
  Philox(counter ``(j div 4, r, c, 0)``). ``c = 0, 1, ...`` counts the draws
  in ``_fill_strip``'s order, ``r`` is the row within that draw and ``j < W``
  the column within the strip (W a multiple of 4). An entry depends on
  ``(seed, b, c, r, j)`` only, never on n;
* bits to values: ``u = bitcast((bits >> 9) | 0x3F800000) - 1`` in float32,
  Box-Muller ``sqrt(-2 log1p(-u1))`` times ``cos``/``sin`` of ``2 pi u2``;
  Rademacher is the sign bit or'd into 1.0;
* row order: normal with ``k % 128 == 0``: pair p takes draws 2p and 2p+1 of
  shape (64, W), cos half to rows ``[128p, 128p+64)``, sin half to
  ``[128p+64, 128p+128)``; normal otherwise: chunk q takes draws 2q and 2q+1,
  cos half only, rows ``[64q, 64q+64)``, the last chunk short; Rademacher:
  chunk q is one draw of rows ``[256q, 256q+256)``.

``csrc/gaussian_sketch.cu`` implements the same contract; the functions here
are its plain version. Words are held in int64 tensors, and 32 x 32-bit
products are split in 16-bit halves so that nothing overflows (torch has no
full unsigned 64-bit multiply).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
PHILOX_M0 = 0xD2511F53  # multiplies counter word 0
PHILOX_M1 = 0xCD9E8D57  # multiplies counter word 2
PHILOX_W0 = 0x9E3779B9  # key bump of key word 0
PHILOX_W1 = 0xBB67AE85  # key bump of key word 1
ROUNDS = 10
CHUNK_K = 64  # rows of one normal draw (rademacher: 4 * CHUNK_K)
TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the 32-bit words ``b`` (int64 tensor), without overflowing int64."""
    p_lo = b * (a & 0xFFFF)            # < 2^48
    p_hi = b * (a >> 16)               # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & MASK32


def philox4x32(counter, key, rounds: int = ROUNDS):
    """Philox4x32-``rounds`` of ``counter`` (4 words) under ``key`` (2
    words) -> 4 words. A word is an int or an int64 tensor holding 32 bits;
    tensors broadcast together."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (k & MASK32 for k in key)
    for i in range(rounds):
        if i:
            k0, k1 = (k0 + PHILOX_W0) & MASK32, (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def draw_bits(seed: int, blocks: torch.Tensor, draw: int, rows: int,
              width: int) -> torch.Tensor:
    """The words of draw ``draw`` of shape (rows, width) for each strip in
    ``blocks`` (1-D int64) -> int64 (len(blocks), rows, width)."""
    if width % 4:
        raise ValueError(f"strip width {width} is not a multiple of 4")
    dev = blocks.device
    j4 = torch.arange(width // 4, dtype=torch.int64, device=dev)[None, None, :]
    r = torch.arange(rows, dtype=torch.int64, device=dev)[None, :, None]
    key1 = blocks.to(torch.int64)[:, None, None]
    words = philox4x32((j4, r, draw, 0), (int(seed), key1))
    grid = torch.broadcast_shapes(j4.shape, r.shape, key1.shape)
    return torch.stack([w.expand(grid) for w in words], dim=-1).reshape(
        len(blocks), rows, width)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> float32 uniforms in [0, 1)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def normal_pair(b1: torch.Tensor, b2: torch.Tensor):
    """Box-Muller from two word grids: (cos half, sin half), float32."""
    u1, u2 = bits_to_unit(b1), bits_to_unit(b2)
    radius = torch.sqrt(-2.0 * torch.log1p(-u1))
    t = TWO_PI_F32 * u2
    return radius * torch.cos(t), radius * torch.sin(t)


def rademacher(bits: torch.Tensor) -> torch.Tensor:
    """+-1.0 float32 from the sign bit of each word."""
    one = torch.ones((), dtype=torch.float32, device=bits.device)
    return torch.where((bits & 0x80000000) != 0, -one, one)


def strips(k: int, seed: int, blocks: torch.Tensor, width: int,
           dist: str) -> torch.Tensor:
    """Unscaled strips ``blocks`` (1-D int64) of Omega -> float32
    (len(blocks), k, width), in ``_fill_strip``'s draw order."""
    if dist not in ("normal", "rademacher"):
        raise ValueError(f"unknown dist {dist!r}")
    out = torch.empty((len(blocks), k, width), dtype=torch.float32,
                      device=blocks.device)
    if dist == "rademacher":
        for q, r0 in enumerate(range(0, k, 4 * CHUNK_K)):
            c = min(4 * CHUNK_K, k - r0)
            out[:, r0:r0 + c] = rademacher(draw_bits(seed, blocks, q, c, width))
        return out
    if k % (2 * CHUNK_K) == 0:
        for p, r0 in enumerate(range(0, k, 2 * CHUNK_K)):
            zc, zs = normal_pair(draw_bits(seed, blocks, 2 * p, CHUNK_K, width),
                                 draw_bits(seed, blocks, 2 * p + 1, CHUNK_K, width))
            out[:, r0:r0 + CHUNK_K] = zc
            out[:, r0 + CHUNK_K:r0 + 2 * CHUNK_K] = zs
        return out
    for q, r0 in enumerate(range(0, k, CHUNK_K)):  # cos half only
        c = min(CHUNK_K, k - r0)
        out[:, r0:r0 + c] = normal_pair(draw_bits(seed, blocks, 2 * q, c, width),
                                        draw_bits(seed, blocks, 2 * q + 1, c, width))[0]
    return out
