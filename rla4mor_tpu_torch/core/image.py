"""Image-space estimation for affine operators.

Counterpart of ``rla4mor_tpu/core/image.py``: an (R-)orthonormal basis of
span{ R^-1 A_j u : terms j, basis columns u } (and right-hand-side
vectors), the intermediate bases of the stable preconditioned-Galerkin
assembly (``precond/preconditioned_rom.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from rla4mor_tpu_torch.core.affine import as_affine
from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt
from rla4mor_tpu_torch.core.products import Product


def estimate_image(
    operators: Sequence = (),
    vectors: Sequence = (),
    basis=None,
    product: Optional[Product] = None,
    riesz_representatives: bool = True,
    orthonormalize: bool = True,
) -> torch.Tensor:
    """Orthonormal basis of the affine image space.

    ``operators``: affine operators applied to the columns of ``basis``;
    ``vectors``: affine right-hand-side-like operators (source dimension 1)
    contributing their term vectors. With ``riesz_representatives`` the
    columns are mapped through R^-1 first. Columns that Gram-Schmidt zeroes
    (``R[j, j] == 0``, rank deficiency) are dropped."""
    cols = []
    for op in operators:
        for term in as_affine(op).terms:
            cols.append(torch.as_tensor(term.apply(basis)))
    for v in vectors:
        for term in as_affine(v).terms:
            m = torch.as_tensor(term.matrix())
            cols.append(m if m.dim() == 2 else m[:, None])
    X = torch.cat(cols, dim=1)
    if riesz_representatives and product is not None:
        X = torch.as_tensor(product.inv.apply(X))
    if not orthonormalize:
        return X
    Q, R = gram_schmidt(X, product=product, return_R=True)
    return Q[:, torch.diagonal(R).abs() > 0.0]
