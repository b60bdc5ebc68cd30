"""Advection-diffusion model problem (non-symmetric affine FOM, host-assembled).

Counterpart of ``rla4mor_tpu/models/advection_diffusion.py``, with the
same numpy/scipy assembly: on the unit square,

    -eps div(grad u) + b(mu) . grad u = 1,    u = 0 on the boundary,

with constant velocity b(mu) = (mu_bx, mu_by) and diffusion eps = mu_eps.
Three affine terms (diffusion stiffness, x- and y-advection); the operator
is non-symmetric, the case for the sketched minimal-residual projection.
Q1 elements on a uniform grid; advection by central differences on the
node grid, lumped, boundary rows eliminated. The sparse terms and products
stay on the host; the rhs and output functional are dense on ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sps

from rla4mor_tpu_torch.core.affine import AffineDense, AffineOp
from rla4mor_tpu_torch.core.linops import DenseOp, HostSparseOp
from rla4mor_tpu_torch.core.parameters import (
    ONE,
    ParameterSpace,
    ProjectionCoefficient,
    uniform,
)
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import StationaryFOM
from rla4mor_tpu_torch.models.thermal_block import _K_EL, _M_EL, _assemble, _element_nodes
from rla4mor_tpu_torch.ops.seeding import generator
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype


class AdvectionDiffusionFOM(StationaryFOM):
    """mu = {'eps': (1,), 'velocity': (2,)}; A(mu) = eps K + bx Cx + by Cy."""

    def __init__(
        self,
        num_intervals: int = 32,
        eps_range: Tuple[float, float] = (0.05, 1.0),
        velocity_range: Tuple[float, float] = (-1.0, 1.0),
        device=None,
    ):
        nx = num_intervals
        n_nodes = (nx + 1) ** 2
        el_nodes = _element_nodes(nx)
        h = 1.0 / nx

        ix, iy = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="xy")
        interior = (
            (ix.ravel() > 0) & (ix.ravel() < nx) & (iy.ravel() > 0) & (iy.ravel() < nx)
        )
        self.interior = np.where(interior)[0]
        n = self.interior.size
        restrict = sps.coo_matrix(
            (np.ones(n), (np.arange(n), self.interior)), shape=(n, n_nodes)
        ).tocsr()

        K = restrict @ _assemble(el_nodes, _K_EL, n_nodes) @ restrict.T

        # central-difference advection with mass lumping: (C u)_i =
        # h^2 (u_{i+1} - u_{i-1}) / (2h) on the lumped node quadrature
        def advection(axis: int) -> sps.csr_matrix:
            stride = 1 if axis == 0 else nx + 1
            node = np.arange(n_nodes)
            xi = node % (nx + 1) if axis == 0 else node // (nx + 1)
            ok = (xi > 0) & (xi < nx)
            w = h * h / (2.0 * h)  # lumped volume x central difference
            count = int(ok.sum())
            rows = np.concatenate([node[ok], node[ok]])
            cols = np.concatenate([node[ok] + stride, node[ok] - stride])
            vals = np.concatenate([np.full(count, w), np.full(count, -w)])
            C = sps.coo_matrix((vals, (rows, cols)), shape=(n_nodes, n_nodes))
            return (restrict @ C.tocsr() @ restrict.T).tocsr()

        Cx, Cy = advection(0), advection(1)
        operator = AffineOp(
            (HostSparseOp(K, device=device), HostSparseOp(Cx, device=device),
             HostSparseOp(Cy, device=device)),
            (ProjectionCoefficient("eps", 0), ProjectionCoefficient("velocity", 0),
             ProjectionCoefficient("velocity", 1)),
        )

        load = np.zeros(n_nodes)
        np.add.at(load, el_nodes.ravel(), h * h / 4.0)
        rhs_vec = load[self.interior]
        rhs = AffineOp((DenseOp(rhs_vec.reshape(-1, 1), device=device),), (ONE,))

        M_full = _assemble(el_nodes, h * h * _M_EL, n_nodes)
        products = {
            "h1_0": Product.from_sparse(K.tocsc(), device=device),
            "l2": Product.from_sparse((restrict @ M_full @ restrict.T).tocsc(), device=device),
        }
        out = AffineDense(as_tensor(rhs_vec.reshape(1, 1, -1), device), (ONE,))

        self._eps_range = eps_range
        self._velocity_range = velocity_range
        super().__init__(
            operator, rhs, output_functional=out, products=products,
            parameter_space=ParameterSpace.make({"eps": 1, "velocity": 2}),
            name=f"advection_diffusion_n{nx}", device=device,
        )
        self.num_intervals = nx

    @property
    def h1_0_product(self) -> Product:
        return self.products["h1_0"]

    def sample_parameters(self, count: int, key: int = 0) -> list:
        """Uniform samples within the per-name ranges (eps > 0), on
        ``device`` in its working dtype (see :func:`sample_advection`)."""
        return sample_advection(count, key, self._eps_range, self._velocity_range,
                                self.device, default_dtype(self.device))


def sample_advection(count: int, key: int, eps_range, velocity_range, device,
                     dtype) -> list:
    """``count`` Mus {'eps': (1,), 'velocity': (2,)}, uniform in the ranges:
    sample i draws eps, then the velocity, from the generator of stream
    ``(key, i)``, so it does not depend on ``count``. (The JAX package draws
    with threefry; parity tests carry its draws across.)"""
    out = []
    for i in range(count):
        g = generator(key, i)
        out.append({"eps": uniform(g, 1, *eps_range, device, dtype),
                    "velocity": uniform(g, 2, *velocity_range, device, dtype)})
    return out
