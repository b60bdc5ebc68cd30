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
from rla4mor_tpu_torch.mor.serialization import (
    load_padded_reductor_state,
    load_reductor_state,
    load_rom,
    save_padded_reductor,
    save_reductor,
    save_rom,
)
from rla4mor_tpu_torch.mor.bounds import (
    InfSupLowerBound,
    MinThetaCoercivity,
    error_bound,
    inf_sup_error_bound,
)
from rla4mor_tpu_torch.mor.scm import ScmCoercivity, ScmHermitian, ScmInfSup

__all__ = ["ClassicalReductor", "GramResidualEstimator", "SketchedReductor",
           "GreedyResult", "rb_greedy", "rb_greedy_padded", "rb_greedy_strong",
           "PaddedSketchedReductor", "rb_greedy_no_retrace", "load_rom", "save_rom",
           "save_reductor", "load_reductor_state", "save_padded_reductor",
           "load_padded_reductor_state", "MinThetaCoercivity", "InfSupLowerBound",
           "error_bound", "inf_sup_error_bound", "ScmHermitian", "ScmCoercivity",
           "ScmInfSup"]
