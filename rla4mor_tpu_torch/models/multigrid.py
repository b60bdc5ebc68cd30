"""Geometric multigrid V-cycle for the stencil thermal block.

Counterpart of ``rla4mor_tpu/models/multigrid.py``: rediscretised element
coefficients on each level (2x2 averaging), damped-Jacobi smoothing,
full-weighting restriction and bilinear prolongation. CG preconditioned by
one V-cycle converges in a mesh-independent number of iterations.

One divergence from the JAX package: the coarse level gets 4 times the
full-weighting restriction of the residual (2^d in d = 2), which is P^T r,
the right-hand side that the rediscretised coarse operators expect (the Q1
stiffness is h-independent in 2-D and the Galerkin coarse mass P^T M_h P
is M_2h). The JAX package's ``make_vcycle`` passes the full weighting
alone, P^T r / 4, which under-corrects by 4: its MG-CG iterations grow
about linearly with N (27, 47, 82, 146, 267 at N = 32-512, float64, tol
1e-10) where this cycle takes 7-8 (``probes/mg_probe.py --iters``). The
tests hold this cycle against the JAX one with the JAX restriction scaled
by 4, and the JAX cycle itself against this one with the port's
restriction scaled by 1/4.

The transfers are strided slices and ``F.pad``, separable in y and x. The
JAX package writes them as dense products ``R f R^T`` with banded 1-D
matrices (``rla4mor_tpu/models/multigrid.py:26-33``): stride-2 access is a
physical re-tile on a TPU, which is not the case on a GPU, so the port
does not carry that workaround over. The numpy oracles of those 1-D
matrices are kept here (``_restrict_1d_np``, ``_prolong_1d_np``) to test
the strided form against.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from rla4mor_tpu_torch.models.stencil import (
    interior_mask,
    mass_apply,
    stencil_apply,
    stiffness_diag_raw,
)


@lru_cache(maxsize=32)
def _restrict_1d_np(n_fine: int, dtype_name: str) -> np.ndarray:
    """(nc, nf) full-weighting rows: [1/4, 1/2, 1/4] at stride 2 (test oracle)."""
    nc = (n_fine - 1) // 2 + 1
    R = np.zeros((nc, n_fine), np.dtype(dtype_name))
    for off, w in ((-1, 0.25), (0, 0.5), (1, 0.25)):
        i = np.arange(nc)
        j = 2 * i + off
        ok = (j >= 0) & (j < n_fine)
        R[i[ok], j[ok]] = w
    return R


@lru_cache(maxsize=32)
def _prolong_1d_np(n_fine: int, dtype_name: str) -> np.ndarray:
    """(nf, nc) bilinear columns: even rows copy, odd rows average (test oracle)."""
    nc = (n_fine - 1) // 2 + 1
    P = np.zeros((n_fine, nc), np.dtype(dtype_name))
    i = np.arange(nc)
    P[2 * i, i] = 1.0
    odd = 2 * i + 1 < n_fine
    P[2 * i[odd] + 1, i[odd]] = 0.5
    right = odd & (i + 1 < nc)
    P[2 * i[right] + 1, i[right] + 1] = 0.5
    return P


def coarsen_kappa(kappa: torch.Tensor) -> torch.Tensor:
    """(..., N, N) element coefficients -> (..., N/2, N/2) by 2x2 averaging."""
    N = kappa.shape[-1]
    return kappa.reshape(*kappa.shape[:-2], N // 2, 2, N // 2, 2).mean(dim=(-3, -1))


def _restrict_last(r: torch.Tensor) -> torch.Tensor:
    """[1/4, 1/2, 1/4] at stride 2 along the last dimension (nf = 2 nc - 1)."""
    nc = (r.shape[-1] - 1) // 2 + 1
    rp = F.pad(r, (1, 1))  # rp[j + 1] = r[j]; coarse i reads r[2i - 1 : 2i + 2]
    return (0.25 * rp[..., 0:2 * nc:2] + 0.5 * rp[..., 1:2 * nc:2]
            + 0.25 * rp[..., 2:2 * nc + 1:2])


def _prolong_last(e: torch.Tensor) -> torch.Tensor:
    """Even fine nodes copy, odd ones average, along the last dimension."""
    nc = e.shape[-1]
    out = e.new_empty((*e.shape[:-1], 2 * nc - 1))
    out[..., 0::2] = e
    out[..., 1::2] = 0.5 * (e[..., :-1] + e[..., 1:])
    return out


def restrict_full_weighting(r: torch.Tensor) -> torch.Tensor:
    """Node-grid full weighting, r (..., N+1, N+1) -> (..., N/2+1, N/2+1):
    coarse nodes are the even fine nodes, the 9-point [1/4, 1/2, 1/4] (x)
    [1/4, 1/2, 1/4] stencil, the coarse Dirichlet ring zeroed."""
    coarse = _restrict_last(_restrict_last(r).transpose(-1, -2)).transpose(-1, -2)
    return coarse * interior_mask(coarse.shape[-1], r.dtype, r.device)


def prolong_bilinear(e: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Bilinear interpolation from (..., N/2+1, N/2+1) coarse nodes to
    (..., N+1, N+1), the fine Dirichlet ring zeroed."""
    if 2 * e.shape[-1] - 1 != n_fine:
        raise ValueError(f"prolong_bilinear: {e.shape[-1]} coarse nodes do not "
                         f"refine to {n_fine}")
    out = _prolong_last(_prolong_last(e).transpose(-1, -2)).transpose(-1, -2)
    return out * interior_mask(n_fine, e.dtype, e.device)


def _jacobi_diag(kappa: torch.Tensor, dtype) -> torch.Tensor:
    d = stiffness_diag_raw(kappa).to(dtype)
    return torch.where(d > 0, d, torch.ones_like(d))


def make_vcycle(
    kappa: torch.Tensor,
    n_levels: int | None = None,
    nu_pre: int = 2,
    nu_post: int = 2,
    omega: float = 0.8,
    nu_coarse: int = 40,
    mass_dt: float | None = None,
):
    """Build ``vcycle(b) -> approximate B^-1 b`` for node grids b.

    ``mass_dt=None``: B = A = stencil(kappa) (elliptic solves).
    ``mass_dt=dt``:   B = M + dt A with M the consistent Q1 mass on each
    level's own grid (the implicit-Euler system).

    ``kappa``: (N, N) element coefficients, N a power of two. Levels coarsen
    down to 8x8 elements (or ``n_levels``). The coarse right-hand side is
    P^T r (see the module docstring). The returned closure is a fixed
    linear map (fixed sweep counts): a valid CG preconditioner."""
    if kappa.dim() != 2:
        raise ValueError(f"make_vcycle needs a 2-D (N, N) element field, got "
                         f"{tuple(kappa.shape)}")
    N = kappa.shape[-1]
    if N & (N - 1):
        raise ValueError("multigrid needs power-of-two element counts")
    kappas: List[torch.Tensor] = [kappa]
    while kappas[-1].shape[-1] > 8 and (n_levels is None or len(kappas) < n_levels):
        kappas.append(coarsen_kappa(kappas[-1]))
    hs = [1.0 / k.shape[-1] for k in kappas]
    if mass_dt is None:
        diags = [_jacobi_diag(k, kappa.dtype) for k in kappas]

        def op(level, u):
            return stencil_apply(u, kappas[level])

    else:
        dt = float(mass_dt)
        diags = []
        for k, h in zip(kappas, hs):
            dA = stiffness_diag_raw(k).to(kappa.dtype)
            dM = (16.0 * h * h / 36.0) * interior_mask(k.shape[-1] + 1, kappa.dtype,
                                                       kappa.device)
            d = dM + dt * dA
            diags.append(torch.where(d > 0, d, torch.ones_like(d)))

        def op(level, u):
            return mass_apply(u, hs[level]) + dt * stencil_apply(u, kappas[level])

    def smooth(level, u, b, steps):
        dia = diags[level]
        for _ in range(steps):
            r = b - op(level, u)
            u = u + omega * r / dia
        return u

    def cycle(level, b):
        u = smooth(level, torch.zeros_like(b), b, nu_pre)
        if level == len(kappas) - 1:
            return smooth(level, u, b, nu_coarse)
        r = b - op(level, u)
        e_c = cycle(level + 1, 4.0 * restrict_full_weighting(r))  # P^T r
        u = u + prolong_bilinear(e_c, b.shape[-1])
        return smooth(level, u, b, nu_post)

    def vcycle(b):
        return cycle(0, b)

    return vcycle
