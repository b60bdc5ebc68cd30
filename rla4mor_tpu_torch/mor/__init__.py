from rla4mor_tpu_torch.mor.classical_reductor import (
    ClassicalReductor,
    GramResidualEstimator,
)
from rla4mor_tpu_torch.mor.sketched_reductor import SketchedReductor
from rla4mor_tpu_torch.mor.greedy import GreedyResult, rb_greedy
from rla4mor_tpu_torch.mor.serialization import load_rom, save_rom

__all__ = ["ClassicalReductor", "GramResidualEstimator", "SketchedReductor",
           "GreedyResult", "rb_greedy", "load_rom", "save_rom"]
