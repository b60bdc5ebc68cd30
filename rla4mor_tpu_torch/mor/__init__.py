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
    load_eim_interpolant,
    load_instationary_reductor_state,
    load_mdeim_operator,
    load_padded_reductor_state,
    load_primal_dual_reductor_state,
    load_reductor_state,
    load_rom,
    save_eim_interpolant,
    save_instationary_reductor,
    save_mdeim_operator,
    save_padded_reductor,
    save_primal_dual_reductor,
    save_reductor,
    save_rom,
    load_wave_reductor_state,
    save_wave_reductor,
)
from rla4mor_tpu_torch.mor.bounds import (
    InfSupLowerBound,
    MinThetaCoercivity,
    error_bound,
    inf_sup_error_bound,
    parabolic_error_bound,
    parabolic_output_error_bound,
)
from rla4mor_tpu_torch.mor.primal_dual import (
    CorrectedOutputROM,
    PrimalDualReductor,
    dual_fom,
    output_greedy,
)
from rla4mor_tpu_torch.mor.scm import ScmCoercivity, ScmHermitian, ScmInfSup
from rla4mor_tpu_torch.mor.scm_matfree import (
    MatrixFreeScmCoercivity,
    MatrixFreeScmHermitian,
    MatrixFreeScmInfSup,
    l2_interior_scm,
    lobpcg_gen,
    lobpcg_gen_two_stage,
    spectral_interval,
)
from rla4mor_tpu_torch.mor.eim import (
    EimInterpolant,
    MdeimOperator,
    deim,
    deim_points,
    eim_greedy,
    eim_greedy_device,
    eim_greedy_scan,
    eim_rebuild,
    mdeim,
    theta_coefficients,
)
from rla4mor_tpu_torch.mor.optimize import (
    CertifiedOptimum,
    ConstantDualNorm,
    MinimizeResult,
    OutputDualNorm,
    TrustRegionResult,
    certified_minimize,
    make_objective,
    minimize_output,
    minimize_scalar,
    output_error_bound,
    output_gradient,
    trust_region_minimize,
)
from rla4mor_tpu_torch.mor.uq import (
    CertifiedSobolResult,
    ExceedanceResult,
    SobolResult,
    UqResult,
    certified_moments,
    certified_sobol_indices,
    exceedance_probability,
    sample_mu_batched,
    sobol_indices,
)
from rla4mor_tpu_torch.mor.semilinear_reductor import (
    SemilinearInstationaryROM,
    SemilinearReductor,
    SemilinearResidualEstimator,
    SemilinearROM,
)

__all__ = ["ClassicalReductor", "GramResidualEstimator", "SketchedReductor",
           "GreedyResult", "rb_greedy", "rb_greedy_padded", "rb_greedy_strong",
           "PaddedSketchedReductor", "rb_greedy_no_retrace", "load_rom", "save_rom",
           "save_reductor", "load_reductor_state", "save_padded_reductor",
           "load_padded_reductor_state", "MinThetaCoercivity", "InfSupLowerBound",
           "error_bound", "inf_sup_error_bound", "ScmHermitian", "ScmCoercivity",
           "ScmInfSup", "MatrixFreeScmCoercivity", "MatrixFreeScmHermitian",
           "MatrixFreeScmInfSup", "l2_interior_scm", "lobpcg_gen", "lobpcg_gen_two_stage",
           "spectral_interval", "EimInterpolant", "eim_greedy", "eim_greedy_device",
           "eim_greedy_scan", "eim_rebuild", "deim", "deim_points", "MdeimOperator", "mdeim",
           "theta_coefficients", "save_eim_interpolant", "load_eim_interpolant",
           "save_mdeim_operator", "load_mdeim_operator", "parabolic_error_bound",
           "parabolic_output_error_bound", "CorrectedOutputROM", "PrimalDualReductor",
           "dual_fom", "output_greedy", "save_instationary_reductor",
           "load_instationary_reductor_state", "save_primal_dual_reductor",
           "load_primal_dual_reductor_state", "save_wave_reductor",
           "load_wave_reductor_state", "SemilinearResidualEstimator", "SemilinearROM",
           "SemilinearInstationaryROM", "SemilinearReductor", "CertifiedOptimum",
           "ConstantDualNorm", "MinimizeResult", "OutputDualNorm", "TrustRegionResult",
           "certified_minimize", "make_objective", "minimize_output", "minimize_scalar",
           "output_error_bound", "output_gradient", "trust_region_minimize",
           "CertifiedSobolResult", "ExceedanceResult", "SobolResult", "UqResult",
           "certified_moments", "certified_sobol_indices", "exceedance_probability",
           "sample_mu_batched", "sobol_indices"]
