"""Damped Helmholtz FOM: a family with a complex parametric coefficient.

Counterpart of ``rla4mor_tpu/models/helmholtz.py``:

    A(k) u = (K - k^2 M + i * damping * k * M) u = f

on the unit square (Q1 FEM, homogeneous Dirichlet), parameterised by the
wavenumber ``mu = {"wavenumber": (1,)}``. The stiffness K and mass M are
real host-sparse matrices of the thermal block; the coefficient of the
mass term, -k^2 + i c k, is complex, so assembly and the host ``splu``
solve run in complex128 and the solution comes back complex. The damping
keeps A(k) invertible through the real resonances of the wavenumber box.
"""

from __future__ import annotations

from typing import Tuple

from rla4mor_tpu_torch.core.affine import AffineOp
from rla4mor_tpu_torch.core.linops import HostSparseOp
from rla4mor_tpu_torch.core.parameters import ONE, ExpressionCoefficient, ParameterSpace
from rla4mor_tpu_torch.models.stationary import StationaryFOM
from rla4mor_tpu_torch.models.thermal_block import ThermalBlockFOM


def helmholtz_fom(num_intervals: int = 32,
                  wavenumber_range: Tuple[float, float] = (2.0, 12.0),
                  damping: float = 0.5, device=None, dtype=None) -> StationaryFOM:
    """The damped Helmholtz FOM on the thermal block's mesh, its products
    (``h1_0``, ``l2``) and mean-value output; ``h1_0_product`` is set as on
    the thermal block. ``device`` / ``dtype`` as :class:`ThermalBlockFOM`'s
    (the real working dtype: complex data takes its complex counterpart)."""
    tb = ThermalBlockFOM((1, 1), num_intervals, device=device, dtype=dtype)
    K = tb.operator.terms[0].S        # unit-coefficient stiffness
    M = tb.l2_product.op.S            # consistent mass
    c = float(damping)

    def theta_mass(mu):
        k = mu["wavenumber"][..., 0]
        return -(k ** 2) + 1j * c * k

    operator = AffineOp(
        (HostSparseOp(K, device=tb.device, dtype=tb.dtype),
         HostSparseOp(M, device=tb.device, dtype=tb.dtype)),
        (ONE, ExpressionCoefficient(theta_mass, name="-k^2+ick")),
    )
    space = ParameterSpace.make({"wavenumber": 1}, wavenumber_range[0], wavenumber_range[1])
    fom = StationaryFOM(operator, tb.rhs, output_functional=tb.output_functional,
                        products=tb.products, parameter_space=space,
                        name=f"helmholtz_n{num_intervals}_c{c}", device=tb.device,
                        dtype=tb.dtype)
    fom.h1_0_product = tb.h1_0_product
    return fom
