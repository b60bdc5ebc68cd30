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


_MASS_W = ((1.0, 4.0, 1.0), (4.0, 16.0, 4.0), (1.0, 4.0, 1.0))


def _mass_gather(up: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The 9-point mass kernel's weighted sum on ``rows`` x ``cols`` nodes
    from their masked values with a ring of neighbours, unscaled, unmasked."""
    out = up.new_zeros((*up.shape[:-2], rows, cols))
    for dy in range(3):
        for dx in range(3):
            out = out.add(up[..., dy:dy + rows, dx:dx + cols], alpha=_MASS_W[dy][dx])
    return out


def mass_apply(u: torch.Tensor, h: float) -> torch.Tensor:
    """Consistent Q1 mass apply, gather form: the 9-point kernel
    (h^2/36) [[1,4,1],[4,16,4],[1,4,1]] on interior nodes, the Dirichlet
    ring zeroed as in :func:`stencil_apply`."""
    M = u.shape[-1]
    mask = interior_mask(M, u.dtype, u.device)
    return _mass_gather(_pad(u * mask), M, M) * (h * h / 36.0) * mask


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


def _gather_apply(up: torch.Tensor, kp: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The gather-form stencil sum on ``rows`` x ``cols`` nodes, unmasked:
    ``up`` (..., rows + 2, cols + 2) the masked node values with a ring of
    neighbours (zero outside the grid), ``kp`` (..., rows + 1, cols + 1)
    the element coefficients around them (zero outside the grid)."""
    out = None
    for a in range(4):
        s = None
        for b, (dy, dx) in enumerate(_CORNER_NODES[a]):
            view = up[..., dy:dy + rows, dx:dx + cols]
            s = view * _K_EL[a][b] if s is None else s.add(view, alpha=_K_EL[a][b])
        ey, ex = _CORNER_ELEMENT[a]
        term = kp[..., ey:ey + rows, ex:ex + cols] * s
        out = term if out is None else out + term
    return out


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
    return _gather_apply(up, kp, M, M) * mask


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

    def term_box_bounds(self) -> list:
        """l2 spectral boxes of the affine terms, for
        ``mor/scm_matfree.py::l2_interior_scm``: each term is a masked PSD Q1
        stiffness with kappa in {0, 1}, so 0 <= lambda <= 16/3. The lower
        edge is exact (the masked terms are singular); the upper one is the
        element Rayleigh bound x^T A x = sum_e x_e^T K_e x_e <= (4/3) 4 ||x||^2
        (each node lies in at most 4 elements; the unit Q1 element
        stiffness has eigenvalues 0, 2/3, 2/3, 4/3)."""
        return [(0.0, 16.0 / 3.0)] * self.n_terms

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

    def slab(self, mesh, axis: str = "dof") -> "ThermalSlab":
        """This rank's row slab of the FOM on ``mesh`` (:class:`ThermalSlab`)."""
        return ThermalSlab(self, mesh, axis)

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


# ---------------------------------------------------------------------------
# Row slabs: the node grid sharded over a mesh's "dof" axis
# ---------------------------------------------------------------------------


class Slab:
    """Node rows ``[r0, r1)`` of an (M, M) node grid, or node planes of an
    (M, M, M) one (``ndim=3``), this rank's equal share along ``axis`` of
    ``mesh`` (M must split evenly). A slab apply reads one halo row (plane)
    from each neighbour: :meth:`padded` gathers every rank's two edge rows
    with one ``all_gather`` of the axis's group (gloo takes CUDA tensors
    there, NCCL too), so an apply costs one collective. The Dirichlet ring
    is placed by global row index; rows outside the grid are zero, as the
    one-device apply's padding."""

    def __init__(self, n_nodes: int, mesh, axis: str = "dof", ndim: int = 2):
        from rla4mor_tpu_torch.parallel import mesh as pm

        self.n_nodes = int(n_nodes)
        self.ndim = int(ndim)
        self.r0, self.r1 = pm.row_range(self.n_nodes, mesh, axis)
        self.rows = self.r1 - self.r0
        self.rank, self.size = pm.axis_index(mesh, axis), pm.axis_size(mesh, axis)
        self.group = pm.axis_group(mesh, axis)
        self._masks: dict = {}

    @property
    def shape(self) -> tuple:
        return (self.rows,) + (self.n_nodes,) * (self.ndim - 1)

    def _grid_mask(self, dtype, device) -> torch.Tensor:
        if self.ndim == 2:
            return interior_mask(self.n_nodes, dtype, device)
        from rla4mor_tpu_torch.models.stencil3d import interior_mask3

        return interior_mask3(self.n_nodes, dtype, device)

    def mask(self, dtype, device) -> torch.Tensor:
        """The slab's rows of the interior mask."""
        return self._grid_mask(dtype, device)[self.r0:self.r1]

    def _ext_mask(self, dtype, device) -> torch.Tensor:
        """The interior mask on rows r0 - 1 .. r1 (zero off the grid)."""
        key = (dtype, torch.device(device))
        if key not in self._masks:
            rest = (self.n_nodes,) * (self.ndim - 1)
            m = torch.zeros((self.n_nodes + 2, *rest), dtype=dtype, device=device)
            m[1:-1] = self._grid_mask(dtype, device)
            self._masks[key] = m[self.r0:self.r1 + 2]
        return self._masks[key]

    def neighbours(self, got) -> tuple:
        """(the last row of the rank below, the first row of the rank above),
        None off the grid, from every rank's ``[first row, last row]``."""
        lo = got[self.rank - 1][1] if self.rank > 0 else None
        hi = got[self.rank + 1][0] if self.rank < self.size - 1 else None
        return lo, hi

    def padded(self, u: torch.Tensor) -> torch.Tensor:
        """(..., rows + 2, M + 2[, M + 2]): u's rows with the neighbours' halo
        rows, masked, and a zero ring in the other grid axes (``_pad`` of
        the one-device apply, cut to the slab)."""
        from rla4mor_tpu_torch.parallel import mesh as pm

        d = self.ndim
        got = pm.all_gather(torch.stack([u.select(-d, 0), u.select(-d, -1)]), self.group)
        lo, hi = self.neighbours(got)
        L, M = self.rows, self.n_nodes
        mask = self._ext_mask(u.dtype, u.device)
        up = u.new_zeros((*u.shape[:-d], L + 2) + (M + 2,) * (d - 1))
        inner = (slice(1, M + 1),) * (d - 1)
        torch.mul(u, mask[1:L + 1], out=up[(..., slice(1, L + 1)) + inner])
        if lo is not None:
            torch.mul(lo, mask[0], out=up[(..., 0) + inner])
        if hi is not None:
            torch.mul(hi, mask[L + 1], out=up[(..., L + 1) + inner])
        return up

    def element_rows(self, field: torch.Tensor) -> torch.Tensor:
        """(..., rows + 1, N + 2): element rows r0 - 1 .. r1 - 1 of an
        (..., N, N) field (zero off the grid), zero-padded in x."""
        full = F.pad(field, (1, 1, 1, 1))
        return full[..., self.r0:self.r1 + 1, :]

    def apply(self, u: torch.Tensor, kp: torch.Tensor) -> torch.Tensor:
        """A(kappa) u on the slab: ``kp`` the slab's padded element rows."""
        up = self.padded(u)
        return _gather_apply(up, kp.to(u.dtype), self.rows, self.n_nodes) * self.mask(
            u.dtype, u.device)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the axis (every rank gets the sum)."""
        from rla4mor_tpu_torch.parallel import mesh as pm

        return pm.all_reduce(t.clone(), self.group)

    def local(self, u: torch.Tensor) -> torch.Tensor:
        """The slab's rows of a whole (..., M, M[, M]) grid."""
        return u.narrow(u.dim() - self.ndim, self.r0, self.rows)


class SlabFOM:
    """What the slab views of the stencil families share: the protocol of
    ``models/stencil.py`` on this rank's rows (``local_shape``), with
    ``solution_shape`` the whole grid's; ``output`` and inner products are
    sums over the mesh axis. A family gives :meth:`padded_operator`, A(mu)
    on the slab's halo-padded rows; the time-dependent FOMs step with the
    mass and :meth:`shifted`, M + c A(mu) from one halo exchange."""

    def __init__(self, fom, mesh, axis: str = "dof"):
        self.fom = fom
        self.slab = Slab(fom.n_nodes, mesh, axis, ndim=len(fom.solution_shape))
        self.n_terms = fom.n_terms
        self.dtype, self.device = fom.dtype, fom.device
        self.h = fom.h
        self.num_intervals = fom.num_intervals
        self.n_nodes = fom.n_nodes

    @property
    def solution_shape(self):
        return self.fom.solution_shape

    @property
    def local_shape(self):
        return self.slab.shape

    @property
    def group(self):
        return self.slab.group

    @property
    def row_offset(self) -> int:
        """The global flat index of the slab's first node."""
        return self.slab.r0 * math.prod(self.solution_shape[1:])

    def theta_vector(self, mu) -> torch.Tensor:
        return self.fom.theta_vector(mu)

    def rhs(self, dtype=None) -> torch.Tensor:
        """The slab's rows of the load vector for f = 1."""
        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.local_shape, self.h * self.h, dtype=dt, device=self.device)
        return load * self.slab.mask(dt, self.device)

    def output(self, u: torch.Tensor) -> torch.Tensor:
        """Mean-value functional, summed over the ranks."""
        return self.slab.sum(u.sum(dim=(-2, -1))) * self.h * self.h

    def _diag(self, kp: torch.Tensor) -> torch.Tensor:
        """diag A(kappa) on the slab from its padded element rows (1 on the ring)."""
        d = (2.0 / 3.0) * ((kp[..., 1:, 1:] + kp[..., 1:, :-1])
                           + (kp[..., :-1, 1:] + kp[..., :-1, :-1]))
        return torch.where(d > 0, d, torch.ones_like(d))

    def _ones(self, dtype) -> torch.Tensor:
        N = self.num_intervals
        return self.slab.element_rows(torch.ones((N, N), dtype=dtype, device=self.device))

    def product_apply(self, u: torch.Tensor) -> torch.Tensor:
        """h1_0 product R = A(kappa = 1) on the slab."""
        return self.slab.apply(u, self._ones(u.dtype))

    # -- operators on the halo-padded slab ---------------------------------
    def padded_operator(self, mu, dtype):
        """``up -> A(mu) u`` on the slab from its halo-padded rows ``up``
        (:meth:`Slab.padded`), the coefficients evaluated once."""
        raise NotImplementedError

    def apply(self, mu, u: torch.Tensor) -> torch.Tensor:
        return self.padded_operator(mu, u.dtype)(self.slab.padded(u))

    def operator(self, mu):
        """``v -> A(mu) v`` on the slab, one halo exchange an apply."""
        A = self.padded_operator(mu, self.dtype)
        return lambda v: A(self.slab.padded(v))

    def _mass_padded(self, up: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The consistent Q1 mass on the slab from its padded rows."""
        L, M = self.local_shape
        return (_mass_gather(up, L, M) * (self.h * self.h / 36.0)
                * self.slab.mask(u.dtype, u.device))

    def mass_apply(self, u: torch.Tensor) -> torch.Tensor:
        """The FOM's mass on the slab (the consistent Q1 mass: one halo
        exchange)."""
        return self._mass_padded(self.slab.padded(u), u)

    def mass_diag(self) -> torch.Tensor:
        """The slab's rows of the mass diagonal (1 on the Dirichlet ring)."""
        return self.slab.local(mass_diag(self.n_nodes, self.h, self.dtype, self.device))

    def shifted(self, mu, c: float):
        """``v -> M v + c A(mu) v`` on the slab: the implicit side of a time
        step, one halo exchange an apply for both operators."""
        A = self.padded_operator(mu, self.dtype)

        def B(v):
            up = self.slab.padded(v)
            return self._mass_padded(up, v) + c * A(up)
        return B



class ThermalSlab(SlabFOM):
    """:class:`StencilThermalBlock` on this rank's row slab (``fom.slab(mesh)``):
    the same operators, each apply one halo exchange."""

    is_spd = True

    def __init__(self, fom: StencilThermalBlock, mesh, axis: str = "dof"):
        super().__init__(fom, mesh, axis)
        T = self.n_terms
        # block ids of the slab's element rows, T (a zero coefficient) off the grid
        blk = F.pad(fom._blk, (0, 0, 1, 1), value=T)[self.slab.r0:self.slab.r1 + 1]
        self._blk = blk
        ids = torch.arange(T, device=self.device)
        self._term_kp = {}
        self._term_masks = (blk[None] == ids[:, None, None])

    def term_kp(self, dtype) -> torch.Tensor:
        """(T, rows + 1, N + 2) padded element masks of the terms."""
        if dtype not in self._term_kp:
            self._term_kp[dtype] = F.pad(self._term_masks.to(dtype), (1, 1))
        return self._term_kp[dtype]

    def kappa_rows(self, mu, dtype=None) -> torch.Tensor:
        """(rows + 1, N + 2): the slab's padded element coefficients at one Mu."""
        dt = self.dtype if dtype is None else dtype
        theta = as_tensor(mu["diffusion"], self.device, dt)
        return F.pad(torch.cat([theta, theta.new_zeros(1)])[self._blk], (1, 1))

    def padded_operator(self, mu, dtype):
        kp = self.kappa_rows(mu, dtype)
        L, M = self.local_shape
        mask = self.slab.mask(dtype, self.device)
        return lambda up: _gather_apply(up, kp, L, M) * mask

    def apply_term(self, b: int, u: torch.Tensor) -> torch.Tensor:
        return self.slab.apply(u, self.term_kp(u.dtype)[b])

    def apply_terms(self, u: torch.Tensor) -> torch.Tensor:
        """(T, rows, M): every term on one slab, one halo exchange."""
        return self.slab.apply(u, self.term_kp(u.dtype))

    def jacobi_diag(self, mu) -> torch.Tensor:
        return self._diag(self.kappa_rows(mu))

    # -- flattened-vector LinOp views of the slab --------------------------
    def term_linop(self, b: int) -> "SlabTermOp":
        return SlabTermOp(self, b)

    def affine_operator(self):
        """The FOM's AffineOp on the slab's flattened rows (the same
        coefficients)."""
        from rla4mor_tpu_torch.core.affine import AffineOp

        return AffineOp(tuple(self.term_linop(b) for b in range(self.n_terms)),
                        self.fom.affine_operator().coefficients)


class SlabTermOp(FlatGridOp):
    """LinOp view of one (symmetric) thermal term on the slab's flattened
    rows, each apply one halo exchange."""

    def __init__(self, sfom: ThermalSlab, b: int):
        super().__init__(grid_shape=sfom.local_shape)
        self.sfom, self.b = sfom, b

    def _grid_apply(self, grid):
        return self.sfom.apply_term(self.b, grid)

    @property
    def H(self):
        return self
