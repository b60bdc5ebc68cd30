from rla4mor_tpu_torch.models.stationary import (
    StationaryFOM,
    StationaryROM,
    ResidualErrorEstimator,
)
from rla4mor_tpu_torch.models.stencil import StencilThermalBlock
from rla4mor_tpu_torch.models.thermal_block import ThermalBlockFOM

__all__ = ["StationaryFOM", "StationaryROM", "ResidualErrorEstimator",
           "StencilThermalBlock", "ThermalBlockFOM"]
