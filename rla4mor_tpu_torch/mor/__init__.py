from rla4mor_tpu_torch.mor.classical_reductor import (
    ClassicalReductor,
    GramResidualEstimator,
)
from rla4mor_tpu_torch.mor.sketched_reductor import SketchedReductor
from rla4mor_tpu_torch.mor.greedy import (
    GreedyResult,
    rb_greedy,
    rb_greedy_padded,
    rb_greedy_strong,
)
from rla4mor_tpu_torch.mor.padded_reductor import (
    PaddedSketchedReductor,
    rb_greedy_no_retrace,
)
from rla4mor_tpu_torch.mor.serialization import load_rom, save_rom

__all__ = ["ClassicalReductor", "GramResidualEstimator", "SketchedReductor",
           "GreedyResult", "rb_greedy", "rb_greedy_padded", "rb_greedy_strong",
           "PaddedSketchedReductor", "rb_greedy_no_retrace", "load_rom", "save_rom"]
