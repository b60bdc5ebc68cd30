from rla4mor_tpu_torch.ops.fwht import fwht, srht, srht_rows, hadamard_matrix
from rla4mor_tpu_torch.ops.dims import gaussian_dim, srht_dim, resolve_dim
from rla4mor_tpu_torch.ops.srht_cuda import srht_onepass, srht_onepass_plain
from rla4mor_tpu_torch.ops.gaussian_cuda import (
    gaussian_omega,
    gaussian_omega_plain,
    gaussian_sketch,
    gaussian_sketch_plain,
    gaussian_strip,
    gaussian_strip_plain,
)
from rla4mor_tpu_torch.ops.embeddings import (
    BlockGaussianEmbedding,
    Embedding,
    GaussianEmbedding,
    HwPrngGaussianEmbedding,
    IdentityEmbedding,
    RademacherEmbedding,
    SparseSignEmbedding,
    SrhtEmbedding,
    StreamedGaussianEmbedding,
    VectorizedEmbedding,
    EmbeddingVectorized,
)

__all__ = [
    "fwht", "srht", "srht_rows", "hadamard_matrix",
    "gaussian_dim", "srht_dim", "resolve_dim",
    "srht_onepass", "srht_onepass_plain",
    "gaussian_omega", "gaussian_omega_plain",
    "gaussian_sketch", "gaussian_sketch_plain", "gaussian_strip",
    "gaussian_strip_plain",
    "Embedding", "GaussianEmbedding", "HwPrngGaussianEmbedding",
    "IdentityEmbedding", "SrhtEmbedding", "VectorizedEmbedding",
    "EmbeddingVectorized", "RademacherEmbedding", "SparseSignEmbedding",
    "BlockGaussianEmbedding", "StreamedGaussianEmbedding",
]
