"""Thermal-block model problem: Q1 finite elements on the unit square.

Counterpart of ``rla4mor_tpu/models/thermal_block.py``, with the same
numpy/scipy assembly (copied, since importing the JAX module would import
jax):

    -div( kappa(x, mu) grad u ) = 1  on (0,1)^2,   u = 0 on the boundary,

kappa piecewise constant on a BX x BY block partition, so
A(mu) = sum_b mu['diffusion'][b] * A_b. The FOM carries h1_0 and l2
products and a mean-value output functional. The sparse terms and products
stay on the host; the rhs and output functional are dense on ``device``, in
``dtype`` (the device's working dtype unless named).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sps

from rla4mor_tpu_torch.core.affine import AffineDense, AffineOp
from rla4mor_tpu_torch.core.linops import DenseOp, HostSparseOp
from rla4mor_tpu_torch.core.parameters import ONE, ParameterSpace, ProjectionCoefficient
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import StationaryFOM
from rla4mor_tpu_torch.utils.config import as_tensor

# Q1 element matrices, local node order [SW, SE, NW, NE] (tensor order).
# Laplace stiffness on a square element is h-independent in 2D.
_K_EL = (1.0 / 6.0) * np.array(
    [
        [4.0, -1.0, -1.0, -2.0],
        [-1.0, 4.0, -2.0, -1.0],
        [-1.0, -2.0, 4.0, -1.0],
        [-2.0, -1.0, -1.0, 4.0],
    ]
)
_M_EL = (1.0 / 36.0) * np.array(
    [
        [4.0, 2.0, 2.0, 1.0],
        [2.0, 4.0, 1.0, 2.0],
        [2.0, 1.0, 4.0, 2.0],
        [1.0, 2.0, 2.0, 4.0],
    ]
)


def _element_nodes(nx: int) -> np.ndarray:
    """(n_el, 4) global node ids per element, local order [SW,SE,NW,NE]."""
    ex, ey = np.meshgrid(np.arange(nx), np.arange(nx), indexing="xy")
    ex, ey = ex.ravel(), ey.ravel()
    sw = ey * (nx + 1) + ex
    return np.stack([sw, sw + 1, sw + (nx + 1), sw + (nx + 2)], axis=1)


def _assemble(el_nodes: np.ndarray, el_mat: np.ndarray, n_nodes: int,
              el_weights: Optional[np.ndarray] = None) -> sps.csr_matrix:
    n_el = el_nodes.shape[0]
    w = np.ones(n_el) if el_weights is None else el_weights
    rows = np.repeat(el_nodes, 4, axis=1).ravel()
    cols = np.tile(el_nodes, (1, 4)).ravel()
    vals = (w[:, None, None] * el_mat[None, :, :]).reshape(n_el, 16).ravel()
    A = sps.coo_matrix((vals, (rows, cols)), shape=(n_nodes, n_nodes))
    return A.tocsr()


class ThermalBlockFOM(StationaryFOM):
    """Affine thermal-block FOM. ``grid_shape=(BX, BY)``, ``num_intervals=nx``.

    ``mu['diffusion']`` has BX*BY entries, block index = by * BX + bx
    (x-fastest, bottom row first).
    """

    def __init__(
        self,
        grid_shape: Tuple[int, int] = (2, 2),
        num_intervals: int = 32,
        parameter_range: Tuple[float, float] = (0.1, 1.0),
        device=None,
        dtype=None,
    ):
        bx_n, by_n = grid_shape
        nx = num_intervals
        n_nodes = (nx + 1) ** 2
        el_nodes = _element_nodes(nx)
        n_el = el_nodes.shape[0]
        h = 1.0 / nx

        # element -> block
        ex = np.arange(n_el) % nx
        ey = np.arange(n_el) // nx
        blk = (ey * by_n // nx) * bx_n + (ex * bx_n // nx)

        # interior (non-Dirichlet) nodes
        ix, iy = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="xy")
        interior = (
            (ix.ravel() > 0) & (ix.ravel() < nx) & (iy.ravel() > 0) & (iy.ravel() < nx)
        )
        self.interior = np.where(interior)[0]
        n = self.interior.size
        restrict = sps.coo_matrix(
            (np.ones(n), (np.arange(n), self.interior)), shape=(n, n_nodes)
        ).tocsr()

        # affine stiffness terms (one per block)
        terms = []
        for b in range(bx_n * by_n):
            mask = (blk == b).astype(float)
            A_b = _assemble(el_nodes, _K_EL, n_nodes, mask)
            terms.append(HostSparseOp(restrict @ A_b @ restrict.T, device=device,
                                      dtype=dtype))
        coeffs = tuple(
            ProjectionCoefficient("diffusion", b) for b in range(bx_n * by_n)
        )
        operator = AffineOp(terms, coeffs)

        # rhs: f = 1 -> load vector h^2/4 per adjacent element corner
        load = np.zeros(n_nodes)
        np.add.at(load, el_nodes.ravel(), h * h / 4.0)
        rhs_vec = load[self.interior]
        rhs = AffineOp((DenseOp(rhs_vec.reshape(-1, 1), device=device, dtype=dtype),),
                       (ONE,))

        # products
        K_full = _assemble(el_nodes, _K_EL, n_nodes)
        M_full = _assemble(el_nodes, h * h * _M_EL, n_nodes)
        h1_0 = Product.from_sparse(restrict @ K_full @ restrict.T, device=device,
                                   dtype=dtype)
        l2 = Product.from_sparse(restrict @ M_full @ restrict.T, device=device,
                                 dtype=dtype)

        # output: mean value of u  (integral via lumped load / area)
        out = AffineDense(as_tensor(rhs_vec.reshape(1, 1, -1), device, dtype), (ONE,))

        space = ParameterSpace.make(
            {"diffusion": bx_n * by_n}, parameter_range[0], parameter_range[1]
        )
        super().__init__(
            operator,
            rhs,
            output_functional=out,
            products={"h1_0": h1_0, "l2": l2},
            parameter_space=space,
            name=f"thermal_block_{bx_n}x{by_n}_n{nx}",
            device=device,
            dtype=dtype,
        )
        self.grid_shape = grid_shape
        self.num_intervals = nx

    @property
    def h1_0_product(self) -> Product:
        return self.products["h1_0"]

    @property
    def l2_product(self) -> Product:
        return self.products["l2"]
