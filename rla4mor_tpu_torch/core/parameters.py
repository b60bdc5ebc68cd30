"""Parameters, parameter spaces and coefficient functionals.

Counterpart of ``rla4mor_tpu/core/parameters.py``. A parameter value ``Mu``
is a plain ``dict[str, Tensor]``. A *batched* Mu has a leading batch axis on
every leaf (:func:`mu_stack`); coefficients evaluate on either, so an affine
operator assembles for one parameter or for a whole batch at once (the
port's replacement for ``vmap``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce
from typing import Dict, Mapping, Sequence, Tuple, Union

import torch

from rla4mor_tpu_torch.ops.seeding import generator
from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device

# A parameter value: dict of 1-d tensors, e.g. {'diffusion': (4,) tensor};
# batched: dict of (B, size) tensors.
Mu = Dict[str, torch.Tensor]


def mu_stack(mus: Sequence[Mu]) -> Mu:
    """Stack a list of Mu into a batched Mu (leading batch axis per leaf)."""
    keys = mus[0].keys()
    return {k: torch.stack([torch.as_tensor(m[k]) for m in mus]) for k in keys}


@dataclass(frozen=True)
class ParameterSpace:
    """Box-constrained parameter space: ``shapes`` maps name -> size."""

    shapes: Tuple[Tuple[str, int], ...]
    low: float = 0.0
    high: float = 1.0

    @classmethod
    def make(cls, shapes: Mapping[str, int], low: float = 0.0, high: float = 1.0):
        return cls(tuple(sorted(shapes.items())), low, high)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(k for k, _ in self.shapes)

    def dim(self) -> int:
        return int(sum(s for _, s in self.shapes))

    def sample_randomly(self, count: int, seed: int = 0, device=None,
                        dtype=None) -> list[Mu]:
        """Uniform samples in the box. Sample i is drawn from the CPU
        generator of stream ``(seed, i)``, so it does not depend on
        ``count``; the result is moved to ``device``."""
        dev = resolve_device(device)
        dt = default_dtype(dev) if dtype is None else dtype
        out = []
        for i in range(count):
            g = generator(seed, i)
            mu: Mu = {}
            for name, size in self.shapes:
                u = torch.rand((size,), generator=g, dtype=torch.float64)
                mu[name] = (self.low + (self.high - self.low) * u).to(dev, dt)
            out.append(mu)
        return out


# ---------------------------------------------------------------------------
# Coefficient functionals
# ---------------------------------------------------------------------------


class Coefficient:
    """A scalar-valued function of Mu; on a batched Mu, one value per row."""

    def __call__(self, mu: Mu | None):
        raise NotImplementedError

    def __mul__(self, other: "Coefficient | float") -> "Coefficient":
        return simplify_product(self, as_coefficient(other))

    __rmul__ = __mul__


@dataclass(frozen=True)
class ConstantCoefficient(Coefficient):
    value: float = 1.0

    def __call__(self, mu=None):
        return self.value


ONE = ConstantCoefficient(1.0)


@dataclass(frozen=True)
class ProjectionCoefficient(Coefficient):
    """theta(mu) = mu[key][..., index]."""

    key: str
    index: int

    def __call__(self, mu):
        return torch.as_tensor(mu[self.key])[..., self.index]


@dataclass(frozen=True)
class ProductCoefficient(Coefficient):
    factors: Tuple[Coefficient, ...]

    def __call__(self, mu):
        return reduce(lambda a, f: a * f(mu), self.factors, 1.0)


def as_coefficient(c: Union[Coefficient, float, int]) -> Coefficient:
    if isinstance(c, Coefficient):
        return c
    return ConstantCoefficient(float(c))


def simplify_product(a: Coefficient, b: Coefficient) -> Coefficient:
    if isinstance(a, ConstantCoefficient) and a.value == 1.0:
        return b
    if isinstance(b, ConstantCoefficient) and b.value == 1.0:
        return a
    if isinstance(a, ConstantCoefficient) and isinstance(b, ConstantCoefficient):
        return ConstantCoefficient(a.value * b.value)
    fa = a.factors if isinstance(a, ProductCoefficient) else (a,)
    fb = b.factors if isinstance(b, ProductCoefficient) else (b,)
    return ProductCoefficient(fa + fb)


def eval_coefficients(coefficients: Sequence[Coefficient], mu: Mu | None,
                      dtype=None, device=None) -> torch.Tensor:
    """Coefficient values as a (..., T) tensor: (T,) for one Mu, (B, T)
    for a batched Mu (constants broadcast over the batch). dtype/device
    default to those of the Mu leaves; without any, float64 on
    :func:`~rla4mor_tpu_torch.utils.config.resolve_device` of ``device``."""
    leaf = None if not mu else torch.as_tensor(next(iter(mu.values())))
    if dtype is None:
        dtype = leaf.dtype if leaf is not None else torch.float64
    if device is None:
        device = leaf.device if leaf is not None else resolve_device(None)
    batch = () if leaf is None else leaf.shape[:-1]
    vals = [torch.as_tensor(c(mu), dtype=dtype, device=device).expand(batch)
            for c in coefficients]
    return torch.stack(vals, dim=-1)
