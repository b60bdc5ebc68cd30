"""Fast Walsh-Hadamard transform and SRHT in PyTorch.

Counterpart of ``rla4mor_tpu/ops/fwht.py``. The transform is the Kronecker
factorisation ``H_{2^d} = H_{2^{d1}} (x) ... (x) H_{2^{dm}}``: a few batched
products with small dense Hadamard factors (``torch.einsum``), as in the
JAX package, where it is a plain product outside Pallas too.

SRHT semantics (same as the JAX package):

    y = sqrt(2^d / k) * P H D x

with D a seeded Rademacher diagonal on the n original entries, zero-padding
n -> 2^d, H the 2^(-d/2)-normalised Sylvester Hadamard transform, and P a
k-row sampler with replacement from the 2^d outputs. The ``plan`` of an SRHT
is the tuple ``(rademacher (n,) int8, sampling (k,) int64, d)`` (an
embedding holds the sampled rows as int32, the kernel's type).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import torch

from rla4mor_tpu_torch.ops.seeding import generator, rademacher_vector
from rla4mor_tpu_torch.utils.config import resolve_device

_MAX_FACTOR_LOG = 8

Plan = Tuple[torch.Tensor, torch.Tensor, int]


def ceil_log2(n: int) -> int:
    """d = ceil(log2 n) (0 for n <= 1)."""
    return max(int(n) - 1, 0).bit_length()


def hadamard_sign(a: torch.Tensor) -> torch.Tensor:
    """(-1)^popcount(a) elementwise, as int64 +-1 (a non-negative ints)."""
    p = a.to(torch.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        p = p ^ (p >> shift)
    return 1 - 2 * (p & 1)


@lru_cache(maxsize=None)
def _hadamard_cpu(log2n: int) -> torch.Tensor:
    i = torch.arange(1 << log2n)
    return hadamard_sign(i[:, None] & i[None, :]).to(torch.float64)


def hadamard_matrix(log2n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Sylvester-ordered Hadamard matrix H[i, j] = (-1)^popcount(i & j),
    built on the CPU once per size and moved to ``device``."""
    return _hadamard_cpu(log2n).to(device=resolve_device(device), dtype=dtype)


def _split_factors(d: int) -> Tuple[int, ...]:
    """Split d into near-equal chunks of at most _MAX_FACTOR_LOG."""
    if d == 0:
        return ()
    m = -(-d // _MAX_FACTOR_LOG)
    base, extra = divmod(d, m)
    return tuple(base + (1 if i < extra else 0) for i in range(m))


def fwht(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Walsh-Hadamard transform along the LAST axis (length 2^d)."""
    n = x.shape[-1]
    d = n.bit_length() - 1
    if 1 << d != n:
        raise ValueError(f"fwht: last axis {n} is not a power of two")
    batch = x.shape[:-1]
    factors = _split_factors(d)
    real = x.real.dtype if x.is_complex() else x.dtype
    for i, df in enumerate(factors):
        F = 1 << df
        P = 1 << sum(factors[:i])
        S = n // (P * F)
        H = hadamard_matrix(df, real, x.device).to(x.dtype)
        x = torch.einsum("...pfs,fg->...pgs", x.reshape(*batch, P, F, S), H)
    x = x.reshape(*batch, n)
    if normalize:
        x = x * (2.0 ** (-d / 2.0))
    return x


def _srht_plan(seed: int, n: int, k: int) -> Plan:
    """Seeded ``(rademacher (n,) int8, sampling (k,) int64, d)`` on the CPU.

    Signs come from the canonical SIGN_BLOCK derivation of stream
    ``(seed, 0)``; the k sampled rows of [0, 2^d) from stream ``(seed, 1)``.
    """
    d = ceil_log2(n)
    rademacher = rademacher_vector(seed, n, stream=(0,))
    sampling = torch.randint(0, 1 << d, (k,), generator=generator(seed, 1))
    return rademacher, sampling, d


def srht(x: torch.Tensor, k: int, plan: Plan) -> torch.Tensor:
    """SRHT sketch along the LAST axis: (..., n) -> (..., k)."""
    rademacher, sampling, d = plan
    n = x.shape[-1]
    y = x * rademacher.to(device=x.device, dtype=x.dtype)
    if (1 << d) > n:
        y = torch.nn.functional.pad(y, (0, (1 << d) - n))
    y = fwht(y, normalize=True)
    scale = math.sqrt((1 << d) / k)
    return scale * y[..., sampling.to(x.device)]


def srht_rows(
    plan: Plan, n: int, k: int, indices: Optional[torch.Tensor] = None,
    dtype=torch.float64, device=None,
) -> torch.Tensor:
    """Explicit rows of the (k, n) SRHT matrix: FWHT'ed one-hots at the
    sampled positions, truncated to n, sign-flipped, scaled sqrt(2^d/k).
    Built on the CPU and moved to ``device``."""
    rademacher, sampling, d = plan
    if indices is None:
        indices = torch.arange(k)
    sel = sampling.cpu().long()[indices.cpu()]
    onehot = torch.nn.functional.one_hot(sel, 1 << d).to(dtype)
    rows = fwht(onehot, normalize=True)[:, :n]
    rows = math.sqrt((1 << d) / k) * rows * rademacher.cpu().to(dtype)[None, :]
    return rows.to(device=resolve_device(device))
