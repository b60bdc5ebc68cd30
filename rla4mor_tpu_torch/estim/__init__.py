from rla4mor_tpu_torch.estim.lars import (
    complex_lasso_cd,
    complex_lasso_path_jax,
    lars_lasso_path_complex_np,
    lars_lasso_path_np,
    lars_lasso_jax,
    lars_weighted_path,
    lars_weighted_path_complex,
    lars_weighted_path_complex_jax,
    lars_weighted_path_group,
    lars_weighted_path_group_jax,
)
from rla4mor_tpu_torch.estim.manifold_distance import (
    ManifoldDistance,
    ResidualDistanceDiscrete,
    ResidualDistanceAffine,
)
from rla4mor_tpu_torch.estim.recovery_map import (
    RecoveryMap,
    PbdwRecoveryMap,
    DicRecoveryMap,
)

__all__ = [
    "lars_lasso_path_np", "lars_lasso_jax", "lars_weighted_path",
    "lars_weighted_path_complex", "lars_weighted_path_complex_jax",
    "complex_lasso_cd", "complex_lasso_path_jax",
    "lars_lasso_path_complex_np", "lars_weighted_path_group",
    "lars_weighted_path_group_jax",
    "ManifoldDistance", "ResidualDistanceDiscrete", "ResidualDistanceAffine",
    "RecoveryMap", "PbdwRecoveryMap", "DicRecoveryMap",
]
