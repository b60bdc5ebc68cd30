from rla4mor_tpu_torch.models.stationary import (
    StationaryFOM,
    StationaryROM,
    ResidualErrorEstimator,
)
from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
from rla4mor_tpu_torch.models.stencil3d import StencilThermalBlock3D
from rla4mor_tpu_torch.models.stencil_advection import StencilAdvectionDiffusion
from rla4mor_tpu_torch.models.stencil_helmholtz import StencilHelmholtz
from rla4mor_tpu_torch.models.advection_diffusion import AdvectionDiffusionFOM
from rla4mor_tpu_torch.models.thermal_block import ThermalBlockFOM
from rla4mor_tpu_torch.models.helmholtz import helmholtz_fom
from rla4mor_tpu_torch.models.stencil_nonaffine import (
    EimStencilFOM,
    NonAffineStencilFOM,
    NonAffineStencilFOM3D,
    gaussian_bump_fom,
    gaussian_bump_fom3d,
)

__all__ = ["StationaryFOM", "StationaryROM", "ResidualErrorEstimator",
           "StencilThermalBlock", "StencilThermalBlock3D", "StencilAdvectionDiffusion",
           "StencilHelmholtz", "AdvectionDiffusionFOM", "ThermalBlockFOM",
           "helmholtz_fom", "NonAffineStencilFOM", "NonAffineStencilFOM3D", "EimStencilFOM",
           "gaussian_bump_fom", "gaussian_bump_fom3d"]
