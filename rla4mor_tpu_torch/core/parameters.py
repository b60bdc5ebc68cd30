"""Parameters, parameter spaces and coefficient functionals.

Counterpart of ``rla4mor_tpu/core/parameters.py``. A parameter value ``Mu``
is a plain ``dict[str, Tensor]``. A *batched* Mu has a leading batch axis on
every leaf (:func:`mu_stack`); coefficients evaluate on either, so an affine
operator assembles for one parameter or for a whole batch at once (the
port's replacement for ``vmap``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import reduce
from typing import Callable, Dict, Mapping, Sequence, Tuple, Union

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


def mu_unstack(batched: Mu) -> list[Mu]:
    """The Mu of each row of a batched Mu (the inverse of :func:`mu_stack`)."""
    n = len(next(iter(batched.values())))
    return [{k: v[i] for k, v in batched.items()} for i in range(n)]


def mu_flat(mu: Mu, names: Sequence[str]) -> torch.Tensor:
    """The leaves ``names`` of one Mu, flattened and concatenated in order."""
    return torch.cat([torch.atleast_1d(torch.as_tensor(mu[n]).reshape(-1)) for n in names])


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
            out.append({name: uniform(g, size, self.low, self.high, dev, dt)
                        for name, size in self.shapes})
        return out


def uniform(g: torch.Generator, size: int, low: float, high: float, device,
            dtype) -> torch.Tensor:
    """(size,) uniform in [low, high) drawn from the CPU generator ``g`` in
    float64, then moved to ``device`` in ``dtype``."""
    u = torch.rand((size,), generator=g, dtype=torch.float64)
    return (low + (high - low) * u).to(device, dtype)


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


@dataclass(frozen=True)
class ExpressionCoefficient(Coefficient):
    """theta(mu) = fn(mu) for any fn of a Mu (one value, or one per row of a
    batched Mu).

    ``fn`` takes part in equality and hash by its identity: two
    coefficients holding different functions never compare equal (in the
    JAX package coefficient tuples key compiled programs, and a comparison
    blind to ``fn`` once served one coefficient's program to another).
    ``name`` is for display only."""

    fn: Callable[[Mu], torch.Tensor]
    name: str = field(default="expr", compare=False)

    def __call__(self, mu):
        return torch.as_tensor(self.fn(mu))


@dataclass(frozen=True)
class ConjugateCoefficient(Coefficient):
    """conj(inner(mu)): the coefficient of an adjoint term, so the adjoint
    conjugates complex-valued coefficients."""

    inner: Coefficient

    def __call__(self, mu):
        value = self.inner(mu)
        return value.conj() if isinstance(value, torch.Tensor) else complex(value).conjugate()


def conj_coefficient(c: Coefficient) -> Coefficient:
    """Conjugate of a coefficient, simplified where its value is known real:
    projections of the (real) box parameters are their own conjugates, and
    conj of conj unwraps, so an adjoint's adjoint keeps the original
    coefficient tuple."""
    if isinstance(c, ConjugateCoefficient):
        return c.inner
    if isinstance(c, ProjectionCoefficient):
        return c
    if isinstance(c, ConstantCoefficient):
        v = complex(c.value)
        return c if v.imag == 0 else ConstantCoefficient(v.conjugate())
    if isinstance(c, ProductCoefficient):
        return ProductCoefficient(tuple(conj_coefficient(f) for f in c.factors))
    return ConjugateCoefficient(c)


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
