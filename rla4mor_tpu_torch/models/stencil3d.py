"""Matrix-free 3-D Q1 thermal block (trilinear hexahedral elements), on the
device.

Counterpart of ``rla4mor_tpu/models/stencil3d.py``: the 3-D member of the
stencil families, where 1e7+ unknowns come from (256^3 = 16.8M nodes). The
affine stiffness terms are applied as gather-form 3-D stencils: each node
sums, over its 8 elements, that element's K-weighted combination of its 8
corners, read from 27 shifted views of the padded grid (no scatter).
Solves are Jacobi-CG (``core/solvers.py``): the port's V-cycle is 2-D.
Node grids are (N+1, N+1, N+1), leading batch dimensions allowed, the
Dirichlet shell masked; index order (z, y, x), x fastest.

The element stiffness is exact 2x2x2 Gauss quadrature of the trilinear
basis gradients over the unit cube, scaled by h (in 3-D K_el = h K_hat).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from rla4mor_tpu_torch.core.parameters import ParameterSpace
from rla4mor_tpu_torch.core.solvers import cg
from rla4mor_tpu_torch.models.stencil import FlatGridOp
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device


@lru_cache(maxsize=1)
def k_el_3d() -> tuple:
    """8x8 unit-cube trilinear element stiffness K_hat (without the h
    factor), corner order c = 4 cz + 2 cy + cx (x fastest), as nested
    tuples of floats. Exact: the integrand is quadratic along each axis, so
    2-point Gauss is exact."""
    g = np.array([0.5 - 0.5 / np.sqrt(3.0), 0.5 + 0.5 / np.sqrt(3.0)])

    def grad(c, x, y, z):
        cz, cy, cx = (c >> 2) & 1, (c >> 1) & 1, c & 1
        fx = x if cx else 1 - x
        fy = y if cy else 1 - y
        fz = z if cz else 1 - z
        dfx = 1.0 if cx else -1.0
        dfy = 1.0 if cy else -1.0
        dfz = 1.0 if cz else -1.0
        return np.array([dfx * fy * fz, fx * dfy * fz, fx * fy * dfz])

    K = np.zeros((8, 8))
    for x in g:
        for y in g:
            for z in g:
                G = np.stack([grad(c, x, y, z) for c in range(8)])
                K += (G @ G.T) / 8.0  # 8 Gauss points, weight 1/8 each
    return tuple(tuple(float(v) for v in row) for row in K)


def interior_mask3(n_nodes: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(n_nodes,) * 3: 1 on interior nodes, 0 on the Dirichlet shell. One
    tensor per (n_nodes, dtype, device), built on first use. Read-only."""
    return _interior_mask3(int(n_nodes), dtype, resolve_device(device))


@lru_cache(maxsize=16)
def _interior_mask3(n_nodes: int, dtype, device: torch.device) -> torch.Tensor:
    m = torch.zeros((n_nodes,) * 3, dtype=dtype, device=device)
    m[1:-1, 1:-1, 1:-1] = 1.0
    return m


def lumped_mass3_apply(u: torch.Tensor, h: float) -> torch.Tensor:
    """Lumped Q1 mass: h^3 at each interior node (8 adjacent elements x
    h^3 / 8), the Dirichlet shell masked."""
    return (h ** 3) * u * interior_mask3(u.shape[-1], u.dtype, u.device)


def lumped_mass3_diag(n_nodes: int, h: float, dtype=torch.float64, device=None
                      ) -> torch.Tensor:
    """Diagonal of the lumped Q1 mass on the full node grid, the shell
    included (only a Jacobi preconditioner reads it, and CG never leaves
    the interior)."""
    return torch.full((n_nodes,) * 3, h ** 3, dtype=dtype, device=resolve_device(device))


def block_index_map3(num_intervals: int, grid_shape: Tuple[int, int, int],
                     device=None) -> torch.Tensor:
    """(N, N, N) int64 block id of each element, x fastest. One tensor per
    (N, grid_shape, device), built on first use. Read-only."""
    return _block_index_map3(int(num_intervals), tuple(grid_shape), resolve_device(device))


@lru_cache(maxsize=16)
def _block_index_map3(N: int, grid_shape: Tuple[int, int, int],
                      device: torch.device) -> torch.Tensor:
    bx, by, bz = grid_shape
    e = torch.arange(N, device=device)
    ez, ey, ex = e[:, None, None], e[None, :, None], e[None, None, :]
    return ((ez * bz // N) * by + (ey * by // N)) * bx + (ex * bx // N)


def _pad3(x: torch.Tensor) -> torch.Tensor:
    """Zero shell of width 1 around the last three dimensions."""
    return F.pad(x, (1, 1, 1, 1, 1, 1))


def _view3(t: torch.Tensor, dz: int, dy: int, dx: int, M: int) -> torch.Tensor:
    return t[..., dz:dz + M, dy:dy + M, dx:dx + M]


def stencil3d_apply(u: torch.Tensor, kappa_el: torch.Tensor, h: float) -> torch.Tensor:
    """A(kappa) u for the 3-D Q1 Laplacian with a coefficient per element,
    in gather form. u: (..., M, M, M) node grids (M = N + 1, Dirichlet
    shell enforced on input and output); kappa_el: (..., N, N, N), broadcast
    against u's leading dimensions. For each corner a, the element for
    which the node is corner a multiplies sum_b K_hat[a][b] u(corner b)."""
    M = u.shape[-1]
    mask = interior_mask3(M, u.dtype, u.device)
    up = _pad3(u * mask)                 # (..., M+2, M+2, M+2)
    kp = _pad3(kappa_el.to(u.dtype))     # (..., M+1, M+1, M+1)
    K = k_el_3d()
    out = None
    for a in range(8):
        az, ay, ax = (a >> 2) & 1, (a >> 1) & 1, a & 1
        s = None
        for b in range(8):
            bz, by, bx = (b >> 2) & 1, (b >> 1) & 1, b & 1
            view = _view3(up, 1 - az + bz, 1 - ay + by, 1 - ax + bx, M)
            s = view * K[a][b] if s is None else s.add(view, alpha=K[a][b])
        term = _view3(kp, 1 - az, 1 - ay, 1 - ax, M) * s
        out = term if out is None else out + term
    return out * (h * mask)


def _eight_element_sum(kappa_el: torch.Tensor) -> torch.Tensor:
    """Per-node sum of the 8 adjacent elements' coefficients."""
    kp = _pad3(kappa_el)
    M = kappa_el.shape[-1] + 1
    return sum(_view3(kp, 1 - az, 1 - ay, 1 - ax, M)
               for az in (0, 1) for ay in (0, 1) for ax in (0, 1))


def stiffness3d_diag_raw(kappa_el: torch.Tensor, h: float) -> torch.Tensor:
    """Diagonal of A(kappa) on the node grid: each node's 8 adjacent
    elements times the corner self-coefficient (equal at every corner)."""
    return h * k_el_3d()[0][0] * _eight_element_sum(kappa_el)


class StencilThermalBlock3D:
    """Matrix-free 3-D affine thermal block A(mu) = sum_b mu_b A_b over a
    (bx, by, bz) partition, on ``device`` (the current card unless named),
    working dtype by default."""

    is_spd = True

    def __init__(self, grid_shape=(2, 2, 2), num_intervals=32, dtype=None, device=None):
        self.grid_shape = tuple(grid_shape)
        self.num_intervals = int(num_intervals)
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.n_terms = math.prod(self.grid_shape)
        self.n_nodes = self.num_intervals + 1
        self.h = 1.0 / self.num_intervals

    @property
    def solution_shape(self):
        return (self.n_nodes,) * 3

    @property
    def n_dof(self) -> int:
        return self.n_nodes ** 3

    def theta_vector(self, mu) -> torch.Tensor:
        """Affine coefficient vector: (T,), or (B, T) for a batched Mu."""
        return as_tensor(mu["diffusion"], self.device, self.dtype)

    def term_box_bounds(self) -> list:
        """l2 boxes of the terms: PSD masked stiffness, and x^T A_b x =
        h sum_e x_e^T K_hat x_e <= 8 h lam_max(K_hat) ||x||^2 (each node lies
        in at most 8 elements), with a 1e-12 float safety pad."""
        lam = float(np.linalg.eigvalsh(np.asarray(k_el_3d()))[-1])
        return [(0.0, 8.0 * self.h * lam * (1.0 + 1e-12))] * self.n_terms

    def _block_index(self) -> torch.Tensor:
        return block_index_map3(self.num_intervals, self.grid_shape, self.device)

    def kappa(self, mu, dtype=None) -> torch.Tensor:
        """(N, N, N) element coefficients at one Mu."""
        dt = self.dtype if dtype is None else dtype
        return as_tensor(mu["diffusion"], self.device, dt)[self._block_index()]

    def apply(self, mu, u: torch.Tensor) -> torch.Tensor:
        return stencil3d_apply(u, self.kappa(mu, dtype=u.dtype), self.h)

    def apply_term(self, b: int, u: torch.Tensor) -> torch.Tensor:
        return stencil3d_apply(u, (self._block_index() == b).to(u.dtype), self.h)

    def product_apply(self, u: torch.Tensor) -> torch.Tensor:
        N = self.num_intervals
        return stencil3d_apply(u, torch.ones((N,) * 3, dtype=u.dtype, device=u.device),
                               self.h)

    def rhs(self, dtype=None) -> torch.Tensor:
        """Lumped load for f = 1: h^3 at each interior node."""
        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.solution_shape, self.h ** 3, dtype=dt, device=self.device)
        return load * interior_mask3(self.n_nodes, dt, self.device)

    def jacobi_diag(self, mu) -> torch.Tensor:
        """Diagonal of A(mu) (1 on the Dirichlet shell)."""
        d = stiffness3d_diag_raw(self.kappa(mu), self.h)
        return torch.where(d > 0, d, torch.ones_like(d))

    def solve_cg_result(self, mu, tol=1e-8, maxiter=2000):
        """Matrix-free Jacobi-CG solve with its
        :class:`~rla4mor_tpu_torch.core.solvers.CGResult`."""
        diag = self.jacobi_diag(mu)
        return cg(lambda u: self.apply(mu, u), self.rhs(), precond=lambda r: r / diag,
                  tol=tol, maxiter=maxiter)

    def solve_cg(self, mu, tol=1e-8, maxiter=2000):
        return self.solve_cg_result(mu, tol, maxiter).x

    def output(self, u: torch.Tensor) -> torch.Tensor:
        """Mean-value functional (lumped integral), per grid of the leading
        dimensions."""
        return u.sum(dim=(-3, -2, -1)) * self.h ** 3

    # hooks of the time-dependent stencil FOMs (not ported yet)
    def mass_apply_grid(self, u: torch.Tensor) -> torch.Tensor:
        return lumped_mass3_apply(u, self.h)

    def mass_diag_grid(self) -> torch.Tensor:
        return lumped_mass3_diag(self.n_nodes, self.h, self.dtype, self.device)

    def apply_field(self, kappa_el: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """A(kappa) u for any element field."""
        return stencil3d_apply(u, kappa_el.to(u.dtype), self.h)

    def term_linop(self, b: int) -> "Stencil3DTermOp":
        return Stencil3DTermOp(self, b)

    def affine_operator(self):
        """AffineOp over flattened vectors (the 2-D thermal block's
        coefficient structure)."""
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.parameters import ProjectionCoefficient

        return AffineOp(
            tuple(self.term_linop(b) for b in range(self.n_terms)),
            tuple(ProjectionCoefficient("diffusion", b) for b in range(self.n_terms)),
        )

    def sample_parameters(self, count: int, key: int = 0) -> list:
        """Uniform diffusion in [0.1, 1]; sample i from the generator of
        stream ``(key, i)`` (``ParameterSpace.sample_randomly``)."""
        space = ParameterSpace.make({"diffusion": self.n_terms}, 0.1, 1.0)
        return space.sample_randomly(count, seed=key, device=self.device, dtype=self.dtype)


class Stencil3DTermOp(FlatGridOp):
    """LinOp view of one 3-D stencil term (``term=None``: the kappa = 1
    product) on flattened vectors."""

    def __init__(self, st: StencilThermalBlock3D, term):
        super().__init__(grid_shape=st.solution_shape)
        self.st = st
        self.term = term

    def _grid_apply(self, grid):
        if self.term is None:
            return self.st.product_apply(grid)
        return self.st.apply_term(self.term, grid)

    @property
    def H(self):
        return self
