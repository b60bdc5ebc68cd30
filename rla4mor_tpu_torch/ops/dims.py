"""A-priori oblivious-embedding dimension bounds.

Counterpart of ``rla4mor_tpu/ops/dims.py`` (same formulas):

* Gaussian:  k = ceil(7.87 eps^-2 (6.9 a d + ln(1/delta))), a = 2 if complex;
* SRHT: k = ceil( 2/(eps^2 - eps^3/3) * (sqrt(a d) + sqrt(8 ln(6 a n / delta)))^2
  * ln(3 a d / delta) ).
"""

from __future__ import annotations

import math


def gaussian_dim(epsilon: float, delta: float, oblivious_dim: int,
                 complex_dtype: bool = False) -> int:
    a = 2 if complex_dtype else 1
    k = 7.87 / epsilon**2 * (a * 6.9 * oblivious_dim + math.log(1.0 / delta))
    return int(math.ceil(k))


def srht_dim(epsilon: float, delta: float, oblivious_dim: int, source_dim: int,
             complex_dtype: bool = False) -> int:
    a = 2 if complex_dtype else 1
    d, n = oblivious_dim, source_dim
    k = 2.0 / (epsilon**2 - epsilon**3 / 3.0)
    k *= (math.sqrt(a * d) + math.sqrt(8.0 * math.log(6.0 * a * n / delta))) ** 2
    k *= math.log(3.0 * a * d / delta)
    return int(math.ceil(k))


def resolve_dim(
    kind: str,
    source_dim: int,
    range_dim: int | None = None,
    epsilon: float | None = None,
    delta: float | None = None,
    oblivious_dim: int | None = None,
    complex_dtype: bool = False,
) -> int:
    """range_dim if given, else the a-priori bound for the embedding kind."""
    if range_dim is not None:
        return int(range_dim)
    if epsilon is None or delta is None or oblivious_dim is None:
        raise ValueError("need either range_dim or (epsilon, delta, oblivious_dim)")
    if kind == "srht":
        return srht_dim(epsilon, delta, oblivious_dim, source_dim, complex_dtype)
    return gaussian_dim(epsilon, delta, oblivious_dim, complex_dtype)
