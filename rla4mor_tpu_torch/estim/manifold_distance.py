"""Distance of a (reduced) vector to the parametric solution manifold.

Counterpart of ``rla4mor_tpu/estim/manifold_distance.py``: the distance of
coefficients ``u`` is the least parametric residual norm
min_mu || L(mu) u - b(mu) ||.

* :class:`ResidualDistanceDiscrete`: the minimum over a finite set of mu;
* :class:`ResidualDistanceAffine`: lhs and rhs affine in mu, mu in a box,
  so the minimum is a bound-constrained linear least-squares problem of
  each vector (:func:`~rla4mor_tpu_torch.core.solvers.bounded_lstsq`).

``distances`` takes U (n_dofs, cols) or a batch of such blocks (..., n_dofs,
cols) and evaluates every column in one batched call, where the JAX package
``jax.vmap``s over columns (and over path points).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from rla4mor_tpu_torch.core.affine import AffineDense
from rla4mor_tpu_torch.core.parameters import (
    ConstantCoefficient,
    Mu,
    ProjectionCoefficient,
    mu_stack,
)
from rla4mor_tpu_torch.core.solvers import bounded_lstsq
from rla4mor_tpu_torch.utils.logger import get_logger


def _columns(U, like: torch.Tensor) -> torch.Tensor:
    U = torch.as_tensor(U)
    U = U[:, None] if U.dim() == 1 else U
    return U.to(device=like.device, dtype=torch.promote_types(like.dtype, U.dtype))


class ManifoldDistance:
    """Base: ``evaluate(U)`` for coefficient columns U (dim, k)."""

    lhs: AffineDense

    def evaluate(self, U) -> Tuple[np.ndarray, List]:
        """Distances and minimising parameter values of each column."""
        raise NotImplementedError

    def distances(self, U) -> torch.Tensor:
        """Distances only, (..., n_dofs, cols) -> (..., cols), as one batched
        call (the batched recovery uses it)."""
        raise NotImplementedError

    def project(self, indices) -> "ManifoldDistance":
        """Restrict the source DoFs of lhs to ``indices``."""
        raise NotImplementedError


class ResidualDistanceDiscrete(ManifoldDistance):
    def __init__(self, lhs: AffineDense, rhs: AffineDense, mus: Sequence[Mu],
                 log_level: int = 30):
        self.lhs = lhs
        self.rhs = rhs
        self.mus = list(mus)
        self._mus_batched = mu_stack(self.mus)
        self.logger = get_logger("estim.mdist_discrete", log_level)

    def _residual_norms(self, U: torch.Tensor) -> torch.Tensor:
        """(..., n_dofs, cols) -> (..., cols, n_mus)."""
        A = self.lhs.assemble(self._mus_batched)           # (M, k, n)
        b = self.rhs.assemble_vec(self._mus_batched)       # (M, k)
        U = U.to(torch.promote_types(A.dtype, U.dtype))
        r = torch.einsum("Mkn,...nc->...cMk", A.to(U.dtype), U) - b.to(U.dtype)
        return torch.linalg.vector_norm(r, dim=-1)

    def evaluate(self, U):
        norms = self._residual_norms(_columns(U, self.lhs.stack)).cpu().numpy()
        idx = norms.argmin(axis=1)
        return norms[np.arange(len(idx)), idx], [self.mus[i] for i in idx]

    def distances(self, U):
        return self._residual_norms(_columns(U, self.lhs.stack)).amin(dim=-1)

    def project(self, indices):
        indices = torch.as_tensor(indices, device=self.lhs.stack.device)
        return ResidualDistanceDiscrete(
            AffineDense(self.lhs.stack[:, :, indices], self.lhs.coefficients),
            self.rhs, self.mus, self.logger.level)


class ResidualDistanceAffine(ManifoldDistance):
    """Residual affine in mu, parameters in a box.

    Each coefficient of lhs and rhs is a ``ProjectionCoefficient`` of
    ``parameter_key`` (a parametric column of the least-squares system) or
    a ``ConstantCoefficient`` (part of its fixed right-hand side)."""

    def __init__(self, lhs: AffineDense, rhs: AffineDense,
                 param_bounds: Tuple[Sequence[float], Sequence[float]],
                 parameter_key: str = "diffusion", pg_iters: int = 300,
                 log_level: int = 30):
        self.lhs = lhs
        self.rhs = rhs
        self.parameter_key = parameter_key
        dt, dev = lhs.stack.dtype, lhs.stack.device
        self.lb = torch.as_tensor(np.asarray(param_bounds[0], np.float64)).to(dev, dt)
        self.ub = torch.as_tensor(np.asarray(param_bounds[1], np.float64)).to(dev, dt)
        self.pg_iters = pg_iters
        self.logger = get_logger("estim.mdist_affine", log_level)
        self.n_params = self.lb.shape[0]

        def classify(coeffs):
            param_ids, const_ids = [], []
            for t, c in enumerate(coeffs):
                if isinstance(c, ProjectionCoefficient):
                    if c.key != parameter_key:
                        raise ValueError(f"coefficient of {c.key!r}, not {parameter_key!r}")
                    param_ids.append((t, c.index))
                elif isinstance(c, ConstantCoefficient):
                    const_ids.append((t, c.value))
                else:
                    raise TypeError(f"coefficient {c!r} is neither a projection nor "
                                    "a constant")
            return param_ids, const_ids

        self._lhs_param, self._lhs_const = classify(lhs.coefficients)
        self._rhs_param, self._rhs_const = classify(rhs.coefficients)

    def _build_ls(self, u: torch.Tensor):
        """G (..., k, p), g (..., k) of vectors u (..., n_dofs): residual =
        G mu - g."""
        stack = self.lhs.stack
        Lu = torch.einsum("tkm,...m->...tk", stack, u.to(stack.dtype))  # (..., T, k)
        b = self.rhs.stack[:, :, 0].to(stack.dtype)                     # (Tb, k)
        G = Lu.new_zeros(Lu.shape[:-2] + (Lu.shape[-1], self.n_params))
        g = Lu.new_zeros(Lu.shape[:-2] + Lu.shape[-1:])
        for t, p in self._lhs_param:
            G[..., p] += Lu[..., t, :]
        for t, p in self._rhs_param:
            G[..., p] -= b[t]
        for t, v in self._rhs_const:
            g = g + v * b[t]
        for t, v in self._lhs_const:
            g = g - v * Lu[..., t, :]
        return G, g

    def _evaluate(self, U: torch.Tensor):
        """(..., n_dofs, cols) -> distances (..., cols), minimisers (..., cols, p)."""
        G, g = self._build_ls(U.transpose(-1, -2))
        x = bounded_lstsq(G, g, self.lb, self.ub, iters=self.pg_iters)
        r = (G @ x[..., None])[..., 0] - g
        return torch.linalg.vector_norm(r, dim=-1), x

    def evaluate(self, U):
        dist, xs = self._evaluate(_columns(U, self.lhs.stack))
        return dist.cpu().numpy(), [{self.parameter_key: xs[i]} for i in range(xs.shape[0])]

    def distances(self, U):
        return self._evaluate(_columns(U, self.lhs.stack))[0]

    def project(self, indices):
        indices = torch.as_tensor(indices, device=self.lhs.stack.device)
        out = object.__new__(ResidualDistanceAffine)
        out.__dict__.update(self.__dict__)
        out.lhs = AffineDense(self.lhs.stack[:, :, indices], self.lhs.coefficients)
        return out
