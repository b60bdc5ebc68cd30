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

The plain Box-Muller is evaluated in float64 from the float32 uniforms and
rounded once to float32, and it uses only additions, multiplications,
divisions, rounding to an integer and bit operations (:func:`_log`,
:func:`_sqrt`, :func:`_cos_sin_turns`). Each of those is correctly rounded,
so the strip has the same bits on every call, thread and device. PyTorch's
CPU ``log1p`` / ``sqrt`` / ``cos`` / ``sin`` are not: their float32 kernels
run a grain of 32768 entries per worker thread through a vectorised math
library, and in a process that had initialised XLA one worker's first
grain once came out about 1e-4 off (a whole grain, rows 48-63 of a
(64, 2048) draw).
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
# float64 constants of the plain Box-Muller
_LN2 = math.log(2.0)
_SQRT_HALF = math.sqrt(0.5)
_HALF_PI = math.pi / 2
_MANT = (1 << 52) - 1


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


def _frexp(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(m, e) with x = m 2^e, m in [0.5, 1), for positive normal float64 x,
    from the bits."""
    bits = x.view(torch.int64)
    m = ((bits & _MANT) | (1022 << 52)).view(torch.float64)
    return m, (bits >> 52) - 1022


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float64 for int64 e in the normal range, from the bits."""
    return ((e + 1023) << 52).view(torch.float64)


def _log(x: torch.Tensor) -> torch.Tensor:
    """ln x for positive normal float64 x: x = m 2^e with m in [sqrt(1/2),
    sqrt(2)), ln m = 2 atanh(s), s = (m - 1) / (m + 1), |s| < 0.172, by its
    series to s^23 (first omitted term below 1e-18)."""
    m, e = _frexp(x)
    low = m < _SQRT_HALF
    m = torch.where(low, m * 2.0, m)
    e = e - low.to(torch.int64)
    s = (m - 1.0) / (m + 1.0)
    z = s * s
    p = torch.full_like(z, 1.0 / 23.0)
    for j in range(21, 0, -2):
        p = p * z + 1.0 / j
    return e.to(torch.float64) * _LN2 + 2.0 * s * p


def _sqrt(y: torch.Tensor) -> torch.Tensor:
    """sqrt y for float64 y >= 0 (0 at 0): y = m 4^h with m in [0.25, 1), a
    linear first guess (6 bits) and five Newton steps."""
    pos = y > 0
    m, e = _frexp(torch.where(pos, y, torch.ones_like(y)))
    odd = (e & 1) != 0
    m = torch.where(odd, m * 0.5, m)
    h = (e + odd.to(torch.int64)) >> 1
    g = 0.41731 + 0.59016 * m
    for _ in range(5):
        g = 0.5 * (g + m / g)
    return torch.where(pos, g * _pow2(h), torch.zeros_like(y))


def _cos_sin_turns(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos 2 pi u, sin 2 pi u) for float64 u in [0, 1) of at most 50
    significant bits: 4u = q + f exactly, q an integer and |f| <= 1/2, and
    the Taylor series of r = f pi / 2 (|r| <= pi / 4) to r^18 (first omitted
    term below 1e-19) turned by q quarter turns."""
    q4 = 4.0 * u
    q = torch.round(q4)
    r = (q4 - q) * _HALF_PI
    z = r * r
    sn = torch.full_like(z, 1.0 / math.factorial(17))
    for j in range(15, 0, -2):
        sn = sn * z + (-1.0) ** (j // 2) / math.factorial(j)
    sn = sn * r
    cs = torch.full_like(z, -1.0 / math.factorial(18))
    for j in range(16, -1, -2):
        cs = cs * z + (-1.0) ** (j // 2) / math.factorial(j)
    quarter = q.to(torch.int64) & 3
    cos = torch.where(quarter == 0, cs, torch.where(quarter == 1, -sn,
                      torch.where(quarter == 2, -cs, sn)))
    sin = torch.where(quarter == 0, sn, torch.where(quarter == 1, cs,
                      torch.where(quarter == 2, -sn, -cs)))
    return cos, sin


def normal_pair(b1: torch.Tensor, b2: torch.Tensor):
    """Box-Muller from two word grids: (cos half, sin half), float32, each
    the float64 value rounded once."""
    u1 = bits_to_unit(b1).to(torch.float64)
    u2 = bits_to_unit(b2).to(torch.float64)
    radius = _sqrt(-2.0 * _log(1.0 - u1))  # 1 - u1 >= 2^-23 is exact
    cos, sin = _cos_sin_turns(u2)
    return (radius * cos).to(torch.float32), (radius * sin).to(torch.float32)


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
