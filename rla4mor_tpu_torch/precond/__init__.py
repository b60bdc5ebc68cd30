from rla4mor_tpu_torch.precond.preconditioned_reductor import PreconditionedReductor
from rla4mor_tpu_torch.precond.preconditioned_rom import (
    FactoredResidualEstimator,
    FactoredROM,
    PreconditionedRom,
)

__all__ = [
    "PreconditionedReductor",
    "PreconditionedRom",
    "FactoredROM",
    "FactoredResidualEstimator",
]
