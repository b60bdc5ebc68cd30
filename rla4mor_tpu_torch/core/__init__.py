from rla4mor_tpu_torch.core.parameters import (
    Mu,
    ParameterSpace,
    Coefficient,
    ConstantCoefficient,
    ProjectionCoefficient,
    ProductCoefficient,
    ExpressionCoefficient,
    ConjugateCoefficient,
    ONE,
    conj_coefficient,
    eval_coefficients,
    mu_flat,
    mu_stack,
    mu_unstack,
)
from rla4mor_tpu_torch.core.linops import (
    LinOp,
    IdentityOp,
    DenseOp,
    DiagonalOp,
    AdjointOp,
    ChainOp,
    ScaledOp,
    ZeroOp,
    CastInputOp,
    HostOp,
    HostSparseOp,
    HostLUInverse,
    SparseCholeskyOp,
    CGInverseOp,
    DeviceCholeskyInverse,
    RecycledCGInverseOp,
    ScipyLinearOperator,
    sparse_cholesky,
    to_matrix,
)
from rla4mor_tpu_torch.core.affine import (
    AffineOp,
    AffineDense,
    as_affine,
    compose,
    project,
    project_block,
    apply2,
    materialize,
    concat_affine,
)
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt, pod
from rla4mor_tpu_torch.core.rsvd import (
    range_finder,
    range_finder_adaptive,
    rsvd,
    pod_randomized,
)
from rla4mor_tpu_torch.core.image import estimate_image
from rla4mor_tpu_torch.core.solvers import (
    cg,
    cg_columns,
    solve_dense,
    lstsq_dense,
    bounded_lstsq,
)

__all__ = [
    "Mu", "ParameterSpace", "Coefficient", "ConstantCoefficient",
    "ProjectionCoefficient", "ProductCoefficient", "ExpressionCoefficient",
    "ConjugateCoefficient", "ONE", "conj_coefficient", "eval_coefficients",
    "mu_flat", "mu_stack", "mu_unstack",
    "LinOp", "IdentityOp", "DenseOp", "DiagonalOp", "AdjointOp", "ChainOp",
    "ScaledOp", "ZeroOp", "CastInputOp", "HostOp", "HostSparseOp", "HostLUInverse",
    "SparseCholeskyOp", "CGInverseOp", "DeviceCholeskyInverse", "RecycledCGInverseOp",
    "ScipyLinearOperator", "sparse_cholesky", "to_matrix",
    "AffineOp", "AffineDense", "as_affine", "compose", "project",
    "project_block", "apply2", "materialize", "concat_affine",
    "Product", "gram_schmidt", "pod", "estimate_image",
    "range_finder", "range_finder_adaptive", "rsvd", "pod_randomized",
    "cg", "cg_columns", "solve_dense", "lstsq_dense", "bounded_lstsq",
]
