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

from rla4mor_tpu_torch.models.instationary import (
    InstationaryFOM,
    InstationaryReductor,
    InstationaryROM,
    instationary_thermal_block,
    pod_greedy,
)
from rla4mor_tpu_torch.models.instationary_stencil import InstationaryStencilFOM
from rla4mor_tpu_torch.models.instationary_primal_dual import (
    InstationaryCorrectedOutputROM,
    InstationaryPrimalDualReductor,
    output_pod_greedy,
    solve_dual,
)
from rla4mor_tpu_torch.models.wave import (
    WaveFOM,
    WaveReductor,
    WaveROM,
    wave_thermal_block,
)
from rla4mor_tpu_torch.models.wave_stencil import WaveStencilFOM
from rla4mor_tpu_torch.models.semilinear import (
    NONLINEARITIES,
    SemilinearInstationaryFOM,
    SemilinearStencilFOM,
)

__all__ = ["StationaryFOM", "StationaryROM", "ResidualErrorEstimator",
           "StencilThermalBlock", "StencilThermalBlock3D", "StencilAdvectionDiffusion",
           "StencilHelmholtz", "AdvectionDiffusionFOM", "ThermalBlockFOM",
           "helmholtz_fom", "NonAffineStencilFOM", "NonAffineStencilFOM3D", "EimStencilFOM",
           "gaussian_bump_fom", "gaussian_bump_fom3d", "InstationaryFOM",
           "InstationaryROM", "InstationaryReductor", "instationary_thermal_block",
           "pod_greedy", "InstationaryStencilFOM", "InstationaryCorrectedOutputROM",
           "InstationaryPrimalDualReductor", "output_pod_greedy", "solve_dual",
           "WaveFOM", "WaveROM", "WaveReductor", "wave_thermal_block", "WaveStencilFOM",
           "NONLINEARITIES", "SemilinearStencilFOM", "SemilinearInstationaryFOM"]
