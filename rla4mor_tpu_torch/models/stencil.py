"""Matrix-free Q1 thermal block on the node grid (device).

Counterpart of ``rla4mor_tpu/models/stencil.py``. The affine stiffness
terms are applied as 2-D stencils on the (N+1, N+1) node grid, in gather
form: each output node sums its four elements' corner combinations read
from shifted views of the padded inputs, with no scatter. Solves are
matrix-free CG (``core/solvers.py``), preconditioned by Jacobi or the
multigrid V-cycle (``models/multigrid.py``), instead of a host
factorisation. The homogeneous Dirichlet ring is masked, not eliminated.

Grids carry leading batch dimensions: ``stencil_apply`` on (..., M, M)
applies the operator to every grid in one call, which is how
``FlatGridOp.apply`` treats (n, m) columns.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import torch
import torch.nn.functional as F

from rla4mor_tpu_torch.core.linops import LinOp
from rla4mor_tpu_torch.core.solvers import cg
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device

# Q1 element stiffness, local corner order [SW, SE, NW, NE] (see
# models/thermal_block.py; h-independent in 2D).
_K_EL = (
    (4 / 6, -1 / 6, -1 / 6, -2 / 6),
    (-1 / 6, 4 / 6, -2 / 6, -1 / 6),
    (-1 / 6, -2 / 6, 4 / 6, -1 / 6),
    (-2 / 6, -1 / 6, -1 / 6, 4 / 6),
)
# the node is corner a of the element whose coefficient multiplies; that
# element's corner nodes in [SW, SE, NW, NE] order as (dy, dx) offsets into
# the node's 3x3 neighbourhood (view uv[dy][dx] = u[y - 1 + dy, x - 1 + dx])
_CORNER_NODES = (
    ((1, 1), (1, 2), (2, 1), (2, 2)),  # a = 0 (SW) of element (y, x)
    ((1, 0), (1, 1), (2, 0), (2, 1)),  # a = 1 (SE) of element (y, x - 1)
    ((0, 1), (0, 2), (1, 1), (1, 2)),  # a = 2 (NW) of element (y - 1, x)
    ((0, 0), (0, 1), (1, 0), (1, 1)),  # a = 3 (NE) of element (y - 1, x - 1)
)
# the same elements as offsets into the padded coefficient grid kp
_CORNER_ELEMENT = ((1, 1), (1, 0), (0, 1), (0, 0))


def interior_mask(n_nodes: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """(n_nodes, n_nodes): 1 on interior nodes, 0 on the Dirichlet ring.
    One tensor per (n_nodes, dtype, device), built on first use: every
    stencil, mass and transfer apply masks, so rebuilding it would add an
    allocation and two fills to each. Read-only."""
    return _interior_mask(int(n_nodes), dtype, resolve_device(device))


@lru_cache(maxsize=64)
def _interior_mask(n_nodes: int, dtype, device: torch.device) -> torch.Tensor:
    m = torch.zeros((n_nodes, n_nodes), dtype=dtype, device=device)
    m[1:-1, 1:-1] = 1.0
    return m


def block_index_map(num_intervals: int, grid_shape: Tuple[int, int],
                    device=None) -> torch.Tensor:
    """(N, N) int64 block id per element (x-fastest order, matching
    models/thermal_block.py)."""
    bx, by = grid_shape
    N = num_intervals
    e = torch.arange(N, device=resolve_device(device))
    return (e[:, None] * by // N) * bx + (e[None, :] * bx // N)


def block_masks(num_intervals: int, grid_shape: Tuple[int, int],
                dtype=torch.float64, device=None) -> torch.Tensor:
    """(B, N, N) element masks of the diffusion blocks."""
    blk = block_index_map(num_intervals, grid_shape, device)
    ids = torch.arange(grid_shape[0] * grid_shape[1], device=blk.device)
    return (blk[None] == ids[:, None, None]).to(dtype)


def _pad(x: torch.Tensor) -> torch.Tensor:
    """Zero ring of width 1 around the last two dimensions."""
    return F.pad(x, (1, 1, 1, 1))


def mass_apply(u: torch.Tensor, h: float) -> torch.Tensor:
    """Consistent Q1 mass apply, gather form: the 9-point kernel
    (h^2/36) [[1,4,1],[4,16,4],[1,4,1]] on interior nodes, the Dirichlet
    ring zeroed as in :func:`stencil_apply`."""
    M = u.shape[-1]
    mask = interior_mask(M, u.dtype, u.device)
    up = _pad(u * mask)
    w = ((1.0, 4.0, 1.0), (4.0, 16.0, 4.0), (1.0, 4.0, 1.0))
    out = torch.zeros_like(u)
    for dy in range(3):
        for dx in range(3):
            out = out.add(up[..., dy:dy + M, dx:dx + M], alpha=w[dy][dx])
    return out * (h * h / 36.0) * mask


def mass_diag(n_nodes: int, h: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """Diagonal of the consistent Q1 mass matrix: 16 h^2/36 on interior
    nodes, 1 on the Dirichlet ring (identity filler for Jacobi division)."""
    d = (16.0 * h * h / 36.0) * interior_mask(n_nodes, dtype, device)
    return torch.where(d > 0, d, torch.ones_like(d))


def _four_element_sum(kappa_el: torch.Tensor) -> torch.Tensor:
    """Per-node sum of the four adjacent elements' coefficients."""
    kp = _pad(kappa_el)
    return (kp[..., 1:, 1:] + kp[..., 1:, :-1]) + (kp[..., :-1, 1:] + kp[..., :-1, :-1])


def stiffness_diag_raw(kappa_el: torch.Tensor) -> torch.Tensor:
    """Raw diagonal of A(kappa): K[a, a] = 2/3 times the four adjacent
    elements' coefficient sum (zero on the Dirichlet ring)."""
    return (2.0 / 3.0) * _four_element_sum(kappa_el)


def stencil_apply(u: torch.Tensor, kappa_el: torch.Tensor) -> torch.Tensor:
    """A(kappa) u for the Q1 Laplacian with a coefficient per element.

    u: (..., N+1, N+1) node grids (Dirichlet ring enforced on input and
    output); kappa_el: (..., N, N) element coefficients, broadcast against
    u's leading dimensions. Row index = y, column = x. Gather form: out[y, x]
    sums the four surrounding elements' K-weighted corner combinations,
    read from shifted views of the padded inputs."""
    M = u.shape[-1]
    mask = interior_mask(M, u.dtype, u.device)
    up = _pad(u * mask)              # (..., M+2, M+2)
    kp = _pad(kappa_el.to(u.dtype))  # (..., M+1, M+1)
    out = None
    for a in range(4):
        s = None
        for b, (dy, dx) in enumerate(_CORNER_NODES[a]):
            view = up[..., dy:dy + M, dx:dx + M]
            s = view * _K_EL[a][b] if s is None else s.add(view, alpha=_K_EL[a][b])
        ey, ex = _CORNER_ELEMENT[a]
        term = kp[..., ey:ey + M, ex:ex + M] * s
        out = term if out is None else out + term
    return out * mask


def preconditioner(fom, mu, kind: str = "jacobi"):
    """``M(r)`` approximating A(mu)^-1 r for a stencil FOM: ``'jacobi'``
    divides by ``fom.jacobi_diag(mu)``; ``'mg'`` is the V-cycle
    (``models/multigrid.py``) on the 2-D element field ``fom.kappa(mu)``
    (the operator itself for the thermal block, its SPD part for the
    advection and Helmholtz families)."""
    if kind == "mg":
        from rla4mor_tpu_torch.models.multigrid import make_vcycle

        return make_vcycle(fom.kappa(mu))
    if kind != "jacobi":
        raise ValueError(f"unknown preconditioner {kind!r}")
    diag = fom.jacobi_diag(mu)
    return lambda r: r / diag


class StencilThermalBlock:
    """Matrix-free affine thermal block A(mu) = sum_b mu_b A_b (stencils) on
    ``device`` (the current card unless named), working dtype by default
    (float32 on a card, float64 on the CPU)."""

    is_spd = True

    def __init__(self, grid_shape=(2, 2), num_intervals=64, dtype=None, device=None):
        self.grid_shape = tuple(grid_shape)
        self.num_intervals = int(num_intervals)
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.n_terms = self.grid_shape[0] * self.grid_shape[1]
        self.n_nodes = self.num_intervals + 1
        self.h = 1.0 / self.num_intervals
        # built once on the FOM's device (the JAX package rebuilds it from
        # iota under trace only because of its TPU compile-request limits)
        self._blk = block_index_map(self.num_intervals, self.grid_shape, self.device)
        self._term_masks = None

    @property
    def solution_shape(self):
        return (self.n_nodes, self.n_nodes)

    @property
    def term_masks(self) -> torch.Tensor:
        """(T, N, N) element masks of the terms, in the working dtype."""
        if self._term_masks is None:
            self._term_masks = block_masks(self.num_intervals, self.grid_shape,
                                           self.dtype, self.device)
        return self._term_masks

    def theta_vector(self, mu) -> torch.Tensor:
        """Affine coefficient vector: (T,), or (B, T) for a batched Mu."""
        return as_tensor(mu["diffusion"], self.device, self.dtype)

    def kappa(self, mu, dtype=None) -> torch.Tensor:
        """(N, N) element coefficients at one Mu."""
        dt = self.dtype if dtype is None else dtype
        theta = as_tensor(mu["diffusion"], self.device, dt)
        return theta[self._blk]

    def apply(self, mu, u: torch.Tensor) -> torch.Tensor:
        # kappa at u's dtype: a float64 input gets a float64 apply (the
        # exact-score path), float32 callers are unchanged
        return stencil_apply(u, self.kappa(mu, dtype=u.dtype))

    def apply_term(self, b: int, u: torch.Tensor) -> torch.Tensor:
        return stencil_apply(u, self.term_masks[b])

    def apply_terms(self, u: torch.Tensor) -> torch.Tensor:
        """(T, M, M): every term applied to one grid u, in one batched call."""
        return stencil_apply(u, self.term_masks)

    def product_apply(self, u: torch.Tensor) -> torch.Tensor:
        """h1_0 product R = A(kappa = 1)."""
        N = self.num_intervals
        return stencil_apply(u, torch.ones((N, N), dtype=u.dtype, device=u.device))

    def rhs(self, dtype=None) -> torch.Tensor:
        """Load vector for f = 1 (interior nodes get h^2: four adjacent
        elements x h^2 / 4)."""
        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.solution_shape, self.h * self.h, dtype=dt,
                          device=self.device)
        return load * interior_mask(self.n_nodes, dt, self.device)

    def jacobi_diag(self, mu) -> torch.Tensor:
        """Diagonal of A(mu) (1 on the Dirichlet ring)."""
        d = stiffness_diag_raw(self.kappa(mu))
        return torch.where(d > 0, d, torch.ones_like(d))

    def solve_cg(self, mu, tol=1e-8, maxiter=2000, precond="jacobi"):
        """Matrix-free preconditioned CG solve; ``precond`` 'jacobi' or 'mg'
        (geometric V-cycle, power-of-two ``num_intervals``)."""
        return self.solve_cg_result(mu, tol, maxiter, precond).x

    def solve_cg_result(self, mu, tol=1e-8, maxiter=2000, precond="jacobi",
                        dtype=None):
        """:meth:`solve_cg` with its :class:`~rla4mor_tpu_torch.core.solvers.CGResult`
        (iterations, recursive residual), in ``dtype`` (default working)."""
        b = self.rhs(dtype)
        kappa = self.kappa(mu, dtype=b.dtype)
        if precond == "mg":
            from rla4mor_tpu_torch.models.multigrid import make_vcycle

            M = make_vcycle(kappa)
        else:
            d = stiffness_diag_raw(kappa)
            diag = torch.where(d > 0, d, torch.ones_like(d))
            M = lambda r: r / diag  # noqa: E731
        return cg(lambda u: stencil_apply(u, kappa), b, precond=M, tol=tol,
                  maxiter=maxiter)

    def output(self, u: torch.Tensor) -> torch.Tensor:
        """Mean-value functional: integral of u (lumped) = sum * h^2, per
        grid of the leading dimensions."""
        return u.sum(dim=(-2, -1)) * self.h * self.h

    # -- flattened-vector LinOp views (for the operator algebra) -----------
    def term_linop(self, b: int) -> "StencilTermOp":
        return StencilTermOp(self, b)

    def product_linop(self) -> "StencilTermOp":
        return StencilTermOp(self, None)

    def affine_operator(self):
        """AffineOp over flattened interior-masked vectors (the coefficient
        structure of ThermalBlockFOM)."""
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.parameters import ProjectionCoefficient

        return AffineOp(
            tuple(self.term_linop(b) for b in range(self.n_terms)),
            tuple(ProjectionCoefficient("diffusion", b) for b in range(self.n_terms)),
        )


class FlatGridOp(LinOp):
    """A symmetric operator on a node grid as a LinOp on flattened vectors:
    (n,) or (n, m) columns, all m grids in one batched ``_grid_apply``.
    Pass ``n_nodes`` for the square (n_nodes, n_nodes) grid or
    ``grid_shape`` for any rank (the 3-D family's (M, M, M))."""

    def __init__(self, n_nodes: int | None = None, grid_shape=None):
        if (n_nodes is None) == (grid_shape is None):
            raise TypeError("FlatGridOp: pass exactly one of n_nodes / grid_shape")
        if grid_shape is None:
            grid_shape = (n_nodes, n_nodes)
        self.grid_shape = tuple(int(d) for d in grid_shape)
        self.n_nodes = self.grid_shape[0]
        self.source_dim = self.range_dim = math.prod(self.grid_shape)

    def _grid_apply(self, grid: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, U, mu=None):
        U = torch.as_tensor(U)
        if U.dim() == 1:
            return self._grid_apply(U.reshape(self.grid_shape)).reshape(-1)
        grids = U.T.reshape(U.shape[1], *self.grid_shape)
        return self._grid_apply(grids).reshape(U.shape[1], -1).T

    # symmetric
    apply_adjoint = apply


class StencilTermOp(FlatGridOp):
    """LinOp view of one stencil term (or, for ``term=None``, the kappa = 1
    product)."""

    def __init__(self, st: StencilThermalBlock, term):
        super().__init__(st.n_nodes)
        self.st = st
        self.term = term

    def _grid_apply(self, grid):
        if self.term is None:
            return self.st.product_apply(grid)
        return stencil_apply(grid, self.st.term_masks[self.term])

    @property
    def H(self):
        return self
