"""Randomised range finder and randomised SVD (Halko-Martinsson-Tropp).

Counterpart of ``rla4mor_tpu/core/rsvd.py``:

* :func:`range_finder` / :func:`rsvd`: an oversampled Gaussian test matrix,
  optional power iterations (HMT Algs 4.3/4.4 and 5.1), the small SVD of
  ``Q^H R X`` (no Gram squaring);
* :func:`range_finder_adaptive`: the posterior-certified variant (HMT
  Alg 4.2), which grows the basis until the Gaussian-probe bound
  ``10 sqrt(2/pi) max_j ||(I - Q Q^H) X omega_j||`` is below ``tol``;
* :func:`pod_randomized`: the same return contract as
  :func:`~rla4mor_tpu_torch.core.orthonormalize.pod`.

With a ``product`` R the modes are R-orthonormal, through an R-orthonormal
range basis (``gram_schmidt(product=...)``).

The test matrices are drawn from an explicit CPU ``torch.Generator`` (seeded
by ``seed`` unless one is given) in float64 and moved to X's device and
dtype; a complex X takes ``normal + 1j normal``. ``omega`` carries given
test matrices instead (e.g. the JAX package's ``jax.random`` draws, for
parity): one (m, l) matrix, or for :func:`range_finder_adaptive` a sequence
whose first entry is the (m, n_probes) probe matrix and whose later entries
are the blocks, in the order they are used.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rla4mor_tpu_torch.core.orthonormalize import gram_schmidt
from rla4mor_tpu_torch.core.products import Product


def _generator(generator: Optional[torch.Generator], seed: int) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(int(seed))


def _test_matrix(gen: torch.Generator, m: int, l: int, like: torch.Tensor) -> torch.Tensor:
    """Gaussian test matrix (m, l) in X's dtype and device; complex when X is."""
    draw = torch.randn((m, l), generator=gen, dtype=torch.float64)
    if like.is_complex():
        draw = torch.complex(draw, torch.randn((m, l), generator=gen, dtype=torch.float64))
    return draw.to(device=like.device, dtype=like.dtype)


def _carried(omega, like: torch.Tensor) -> torch.Tensor:
    if not isinstance(omega, torch.Tensor):
        omega = torch.from_numpy(np.array(omega))
    return omega.to(device=like.device, dtype=like.dtype)


def _orth_l2(Y: torch.Tensor) -> torch.Tensor:
    """Thin-QR orthonormalisation (null columns come out as arbitrary
    orthonormal directions, harmless for a range basis)."""
    return torch.linalg.qr(Y, mode="reduced")[0]


def range_finder(X, l: int, generator: Optional[torch.Generator] = None,
                 power_iters: int = 0, product: Optional[Product] = None,
                 seed: int = 0, omega=None) -> torch.Tensor:
    """Randomised range basis Q (n, l) with Q^H R Q = I (HMT Alg 4.3/4.4):
    ``Y = X Omega``, then ``power_iters`` rounds of ``Y <- X (X^H R Y)``
    with re-orthonormalisation between them, then an orthonormalisation."""
    X = torch.as_tensor(X)
    n, m = X.shape
    Om = (_test_matrix(_generator(generator, seed), m, l, X) if omega is None
          else _carried(omega, X))
    Y = X @ Om

    def orth(Z):
        return _orth_l2(Z) if product is None else gram_schmidt(Z, product=product)

    def weigh(Z):
        return Z if product is None else torch.as_tensor(product.op.apply(Z)).to(Z)

    for _ in range(power_iters):
        Y = X @ (X.conj().T @ weigh(orth(Y)))
    return orth(Y)


def range_finder_adaptive(X, tol: float, generator: Optional[torch.Generator] = None,
                          block: int = 8, n_probes: int = 10,
                          max_rank: Optional[int] = None, seed: int = 0,
                          omega: Optional[Sequence] = None) -> Tuple[torch.Tensor, float]:
    """Adaptive randomised range finder (HMT Alg 4.2), l2 inner product.

    Grows Q by blocks of ``block`` columns until the probe bound certifies
    ``||X - Q Q^H X||_2 <= tol`` (with probability ``1 - 10^-n_probes``) or
    Q has ``max_rank`` columns. Returns ``(Q, bound)``. The loop's length
    depends on the data, so the host reads the bound once a block."""
    X = torch.as_tensor(X)
    n, m = X.shape
    max_rank = min(n, m) if max_rank is None else min(max_rank, n, m)
    factor = 10.0 * math.sqrt(2.0 / math.pi)
    gen = _generator(generator, seed)
    carried = iter(omega) if omega is not None else None

    def draw(width):
        if carried is not None:
            return _carried(next(carried), X)
        return _test_matrix(gen, m, width, X)

    probes = X @ draw(n_probes)  # X omega_j, deflated as Q grows
    Q = X.new_zeros((n, 0))
    while True:
        bound = factor * float(torch.linalg.vector_norm(probes, dim=0).max())
        if bound <= tol or Q.shape[1] >= max_rank:
            return Q, bound
        Y = X @ draw(min(block, max_rank - Q.shape[1]))
        for _ in range(2):  # CGS-2 against the current basis
            Y = Y - Q @ (Q.conj().T @ Y)
        Qb = _orth_l2(Y)
        Q = torch.cat([Q, Qb], dim=1)
        probes = probes - Qb @ (Qb.conj().T @ probes)


def rsvd(X, rank: int, oversample: int = 8, power_iters: int = 2,
         generator: Optional[torch.Generator] = None, product: Optional[Product] = None,
         seed: int = 0, omega=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomised truncated SVD ``X ~= U diag(s) V^H`` (HMT Alg 5.1): U (n,
    rank) with U^H R U = I, s (rank,) descending, V (m, rank) orthonormal.
    The small SVD is that of ``B = Q^H R X`` for the range basis Q of
    ``rank + oversample`` columns."""
    X = torch.as_tensor(X)
    n, m = X.shape
    l = min(rank + oversample, n, m)
    Q = range_finder(X, l, generator=generator, power_iters=power_iters,
                     product=product, seed=seed, omega=omega)
    RX = X if product is None else torch.as_tensor(product.op.apply(X)).to(X)
    W, s, Vh = torch.linalg.svd(Q.conj().T @ RX, full_matrices=False)
    rank = min(rank, l)
    return Q @ W[:, :rank], s[:rank], Vh[:rank].conj().T.resolve_conj()


def pod_randomized(U, product: Optional[Product] = None, modes: Optional[int] = None,
                   rtol: Optional[float] = 1e-12, oversample: int = 8,
                   power_iters: int = 2, generator: Optional[torch.Generator] = None,
                   seed: int = 0, omega=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomised POD: ``(modes (n, q), singular values (q,))`` with
    R-orthonormal modes, as :func:`~rla4mor_tpu_torch.core.orthonormalize.pod`.
    No Gram squaring, so the floor is about eps (hence ``rtol`` 1e-12);
    ``rtol=None`` keeps exactly ``modes``."""
    U = torch.as_tensor(U)
    m = U.shape[1]
    target = m if modes is None else min(modes, m)
    Um, s, _ = rsvd(U, target, oversample=oversample, power_iters=power_iters,
                    generator=generator, product=product, seed=seed, omega=omega)
    if rtol is None:
        if modes is None:
            raise ValueError("pod_randomized: rtol=None needs modes")
        return Um, s
    ref = float(s[0]) if s.shape[0] else 1.0
    keep = int((s > rtol * ref).sum())
    if modes is not None:
        keep = min(keep, modes)
    return Um[:, :keep], s[:keep]
