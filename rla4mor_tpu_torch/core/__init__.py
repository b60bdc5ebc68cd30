from rla4mor_tpu_torch.core.parameters import (
    Mu,
    ParameterSpace,
    Coefficient,
    ConstantCoefficient,
    ProjectionCoefficient,
    ProductCoefficient,
    ONE,
    eval_coefficients,
    mu_stack,
)
from rla4mor_tpu_torch.core.linops import (
    LinOp,
    IdentityOp,
    DenseOp,
    ChainOp,
    CastInputOp,
    HostOp,
    HostSparseOp,
    HostLUInverse,
    SparseCholeskyOp,
    CGInverseOp,
    DeviceCholeskyInverse,
    RecycledCGInverseOp,
)
from rla4mor_tpu_torch.core.affine import (
    AffineOp,
    AffineDense,
    as_affine,
    compose,
    project,
    materialize,
    concat_affine,
)
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt
from rla4mor_tpu_torch.core.image import estimate_image

__all__ = [
    "Mu", "ParameterSpace", "Coefficient", "ConstantCoefficient",
    "ProjectionCoefficient", "ProductCoefficient", "ONE",
    "eval_coefficients", "mu_stack",
    "LinOp", "IdentityOp", "DenseOp", "ChainOp", "CastInputOp", "HostOp", "HostSparseOp",
    "HostLUInverse", "SparseCholeskyOp", "CGInverseOp", "DeviceCholeskyInverse",
    "RecycledCGInverseOp",
    "AffineOp", "AffineDense", "as_affine", "compose", "project",
    "materialize", "concat_affine", "Product", "gram_schmidt", "estimate_image",
]
