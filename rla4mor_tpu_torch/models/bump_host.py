"""Host FEM Gaussian-bump FOM: the oracle-scale non-affine family.

Counterpart of ``rla4mor_tpu/models/bump_host.py``. The device path is
``models/stencil_nonaffine.py`` (stencils and EIM); this is the same
Gaussian-bump diffusion problem on the host FEM path: the Q1 stiffness is
assembled per mu with the bump field, MDEIM (``mor/eim.py``) turns the
non-affine sparse family into an ``AffineOp``, and the result is a plain
:class:`~rla4mor_tpu_torch.models.stationary.StationaryFOM` that every
affine consumer runs on.

The field is bounded below by ``kappa0`` (the bump is nonnegative), so the
exact operator is coercive with ``alpha(mu) >= min_e kappa_e(mu)`` in the
kappa = 1 stiffness metric: :func:`bump_coercivity`.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import scipy.sparse as sps
import torch

from rla4mor_tpu_torch.core.affine import AffineDense, AffineOp
from rla4mor_tpu_torch.core.linops import DenseOp
from rla4mor_tpu_torch.core.parameters import ONE, Mu, ParameterSpace
from rla4mor_tpu_torch.core.products import Product
from rla4mor_tpu_torch.models.stationary import StationaryFOM
from rla4mor_tpu_torch.models.stencil_nonaffine import gaussian_bump_field
from rla4mor_tpu_torch.models.thermal_block import _K_EL, _assemble, _element_nodes
from rla4mor_tpu_torch.utils.config import as_tensor

# the JAX package's seed of the random half of the training set
TRAIN_SEED = 20240819


def bump_host_fom(nx: int = 12, n_train_per_dim: int = 6, n_train_random: int = 200,
                  mdeim_tol: float = 1e-8, reserve: int = 2, device=None, dtype=None,
                  **field_kw) -> StationaryFOM:
    """Gaussian-bump diffusion FOM on the host FEM path, through MDEIM.

    ``mu['bump'] = (cx, cy, w)`` in ``[0, 1]^3`` (mapped inside
    :func:`~rla4mor_tpu_torch.models.stencil_nonaffine.gaussian_bump_field`).
    The operator is the MDEIM surrogate fit on a ``n_train_per_dim^3``
    tensor grid and ``n_train_random`` random parameters (the grid alone
    misses narrow bumps between its points), with element-local magic-entry
    thetas: the exact entries, O(n_terms) a parameter. The random draws
    come from the port's sampler (stream ``TRAIN_SEED``), other draws than
    the JAX package's at the same seed. Attributes beyond StationaryFOM: ``kappa_field(mu)`` (per-element
    coefficients on the Mu's device, float64 or wider), ``exact_assemble(mu)``
    (the exact csr, on the host), ``num_intervals``, ``h1_0_product``,
    ``mdeim_op``. The thetas of a Mu are computed on its device (the field,
    the magic entries and the MDEIM solve), so an online loop on the card
    never waits for the host."""
    from rla4mor_tpu_torch.mor.eim import mdeim

    n_nodes = (nx + 1) ** 2
    el_nodes = _element_nodes(nx)
    field = gaussian_bump_field(**field_kw)
    h = 1.0 / nx
    c = torch.as_tensor((np.arange(nx) + 0.5) * h)
    X, Y = torch.meshgrid(c, c, indexing="xy")
    ix, iy = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="xy")
    interior = np.where((ix.ravel() > 0) & (ix.ravel() < nx)
                        & (iy.ravel() > 0) & (iy.ravel() < nx))[0]
    restrict = sps.coo_matrix((np.ones(interior.size), (np.arange(interior.size), interior)),
                              shape=(interior.size, n_nodes)).tocsr()

    centres = {}  # the element centres by device

    def kappa_field(mu: Mu) -> torch.Tensor:
        dev = torch.as_tensor(next(iter(mu.values()))).device
        if dev not in centres:
            centres[dev] = (X.to(dev), Y.to(dev))
        return field(mu, *centres[dev])

    def exact_assemble(mu: Mu) -> sps.csr_matrix:
        w = kappa_field(mu).cpu().numpy()
        A = _assemble(el_nodes, _K_EL, n_nodes, w.ravel())
        Ai = (restrict @ A @ restrict.T).tocsr()
        Ai.sort_indices()
        return Ai

    space = ParameterSpace.make({"bump": 3})
    train = space.sample_uniformly(n_train_per_dim, device="cpu", dtype=torch.float64)
    train += space.sample_randomly(n_train_random, seed=TRAIN_SEED, device="cpu",
                                   dtype=torch.float64)
    op = mdeim([exact_assemble(mu) for mu in train], tol=mdeim_tol, reserve=reserve)

    # O(M) magic-entry evaluation: each active magic position (r, c) of the
    # interior-restricted stiffness is a fixed sum of kappa_e K_EL[a, b] over
    # the <= 4 elements whose node pair (a, b) hits (r, c): (element id,
    # K_EL weight) tables built once, then entries(mu) is a gather and a
    # weighted sum
    P = op.n_terms
    rows_g = interior[op.magic_rows[:P]]
    cols_g = interior[op.magic_cols[:P]]
    contrib = defaultdict(list)
    for e in range(el_nodes.shape[0]):
        nd = el_nodes[e]
        for a in range(4):
            for b in range(4):
                contrib[(int(nd[a]), int(nd[b]))].append((e, _K_EL[a, b]))
    max_c = max(len(contrib[(int(r), int(c))]) for r, c in zip(rows_g, cols_g))
    elem_idx = np.zeros((P, max_c), np.int64)
    kel_w = np.zeros((P, max_c))
    for p, (r, c) in enumerate(zip(rows_g, cols_g)):
        for j, (e, k) in enumerate(contrib[(int(r), int(c))]):
            elem_idx[p, j] = e
            kel_w[p, j] = k
    tables = {}  # (element ids, weights) by device

    def entries(mu):
        kappa = kappa_field(mu)
        if kappa.device not in tables:
            tables[kappa.device] = (torch.as_tensor(elem_idx).to(kappa.device),
                                    torch.as_tensor(kel_w).to(kappa.device))
        idx, wgt = tables[kappa.device]
        kappa = kappa.reshape(kappa.shape[:-2] + (-1,))  # (..., n_el)
        return (kappa[..., idx] * wgt).sum(dim=-1)

    operator = op.affine_op(entries, device=device, dtype=dtype)

    load = np.zeros(n_nodes)
    np.add.at(load, el_nodes.ravel(), h * h / 4.0)
    rhs_vec = load[interior]
    rhs = AffineOp((DenseOp(rhs_vec.reshape(-1, 1), device=device, dtype=dtype),), (ONE,))
    out = AffineDense(as_tensor(rhs_vec.reshape(1, 1, -1), device, dtype), (ONE,))
    K1 = _assemble(el_nodes, _K_EL, n_nodes)
    h1_0 = Product.from_sparse(restrict @ K1 @ restrict.T, device=device, dtype=dtype)

    fom = StationaryFOM(operator, rhs, output_functional=out, products={"h1_0": h1_0},
                        parameter_space=space, name=f"bump_host_n{nx}", device=device,
                        dtype=dtype)
    fom.h1_0_product = h1_0
    fom.kappa_field = kappa_field
    fom.exact_assemble = exact_assemble
    fom.num_intervals = nx
    fom.mdeim_op = op
    return fom


def bump_coercivity(fom):
    """Coercivity lower bound of the bump family in the ``h1_0`` (kappa = 1
    stiffness) metric: ``alpha(mu) >= min_e kappa_e(mu)``, every Q1 element
    stiffness being PSD. Valid for the exact operator; the MDEIM surrogate
    inherits it up to the interpolation error. One value, or one per row of
    a batched Mu."""
    kappa_field = fom.kappa_field

    def alpha(mu: Mu) -> torch.Tensor:
        return kappa_field(mu).amin(dim=(-2, -1))

    return alpha
