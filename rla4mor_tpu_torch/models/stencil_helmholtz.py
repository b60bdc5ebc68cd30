"""Indefinite Helmholtz stencil family A(ksq) = K - ksq M, on the device.

Counterpart of ``rla4mor_tpu/models/stencil_helmholtz.py``: the real
family and its damped complex twin :class:`StencilHelmholtzDamped`. For
``ksq`` above the first Dirichlet eigenvalue of the unit square
(2 pi^2 ~ 19.74), A has negative eigenvalues: no coercivity constant
exists, and BiCGStab solves it. ``K`` is the unit-coefficient Q1 stiffness
(``stencil_apply``), ``M`` the consistent Q1 mass (``mass_apply``), both
zero on the Dirichlet ring, so the pencil's eigenvalues approximate the
continuum's pi^2 (m^2 + n^2). The default ``ksq_range = (22, 46)`` lies
between the first two resonances (2 pi^2 and 5 pi^2): A is indefinite on
the whole range yet uniformly invertible.
"""

from __future__ import annotations

import torch

from rla4mor_tpu_torch.core.parameters import (
    ExpressionCoefficient,
    ParameterSpace,
    uniform,
)
from rla4mor_tpu_torch.core.solvers import bicgstab
from rla4mor_tpu_torch.models.stencil import (
    FlatGridOp,
    interior_mask,
    mass_apply,
    mass_diag,
    preconditioner,
    stencil_apply,
    stiffness_diag_raw,
)
from rla4mor_tpu_torch.ops.seeding import generator
from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device


def _neg_ksq(mu):
    return -torch.as_tensor(mu["ksq"])[..., 0]


# one module-level coefficient: ExpressionCoefficient compares by the
# identity of its function, so a new lambda per call would compare unequal
_NEG_KSQ = ExpressionCoefficient(_neg_ksq, "-ksq")


class StencilHelmholtz:
    """Matrix-free indefinite affine FOM A(mu) = K - ksq M on ``device``
    (the current card unless named), working dtype by default."""

    is_spd = False
    n_terms = 2
    # kappa() is the unit diffusion field (the V-cycle on K), not the operator
    kappa_is_full_operator = False

    def __init__(self, num_intervals: int = 64, dtype=None,
                 ksq_range: tuple[float, float] = (22.0, 46.0), device=None):
        self.num_intervals = int(num_intervals)
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.n_nodes = self.num_intervals + 1
        self.h = 1.0 / self.num_intervals
        self.parameter_space = ParameterSpace.make({"ksq": 1}, *ksq_range)
        self._ksq_range = ksq_range

    @property
    def solution_shape(self):
        return (self.n_nodes, self.n_nodes)

    def _ones(self, dtype) -> torch.Tensor:
        N = self.num_intervals
        return torch.ones((N, N), dtype=dtype, device=self.device)

    def theta_vector(self, mu) -> torch.Tensor:
        """(1, -ksq): (2,), or (B, 2) for a batched Mu."""
        ksq = as_tensor(mu["ksq"], self.device, self.dtype)
        return torch.cat([torch.ones_like(ksq), -ksq], dim=-1)

    def apply(self, mu, u: torch.Tensor) -> torch.Tensor:
        theta = self.theta_vector(mu).to(u.dtype)
        return (theta[0] * stencil_apply(u, self._ones(u.dtype))
                + theta[1] * mass_apply(u, self.h))

    def apply_term(self, t: int, u: torch.Tensor) -> torch.Tensor:
        if t == 0:
            return stencil_apply(u, self._ones(u.dtype))
        return mass_apply(u, self.h)

    def product_apply(self, u: torch.Tensor) -> torch.Tensor:
        """h1_0 product R = K (unit-coefficient stiffness)."""
        return stencil_apply(u, self._ones(u.dtype))

    def term_norm_bounds(self) -> list:
        """l2 spectral-norm bounds of the terms [K, M]: lam_max(K) <= 16/3
        (element Rayleigh quotient, as the thermal block's boxes);
        lam_max(M) <= h^2 (each node lies in at most 4 elements, whose Q1
        mass has eigenvalues h^2/36 {9, 3, 3, 1}: 4 x 9 h^2/36 = h^2)."""
        return [16.0 / 3.0, self.h * self.h]

    def rhs(self, dtype=None) -> torch.Tensor:
        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.solution_shape, self.h * self.h, dtype=dt,
                          device=self.device)
        return load * interior_mask(self.n_nodes, dt, self.device)

    def kappa(self, mu, dtype=None) -> torch.Tensor:
        """Unit element diffusion field: the V-cycle on K preconditions
        BiCGStab on K - ksq M (K's spectrum spans h^-2 at fine h, while ksq
        stays O(10))."""
        return self._ones(self.dtype if dtype is None else dtype)

    def jacobi_diag(self, mu) -> torch.Tensor:
        """diag K - ksq diag M; 1 on the Dirichlet ring, and a magnitude
        floor of 0.1 x 8/3 (about diag K's scale): the diagonal crosses zero
        between resonances, and a signed division by a near-zero entry would
        blow the preconditioned residual up."""
        ksq = as_tensor(mu["ksq"], self.device, self.dtype).reshape(-1)[0]
        dk = stiffness_diag_raw(self._ones(self.dtype))
        dm = mass_diag(self.n_nodes, self.h, self.dtype, self.device)
        mask = interior_mask(self.n_nodes, self.dtype, self.device)
        d = (dk - ksq * torch.where(mask > 0, dm, torch.zeros_like(dm))) * mask
        floor = 0.1 * float(8.0 / 3.0)
        signed_floor = torch.where(d >= 0, torch.full_like(d, floor),
                                   torch.full_like(d, -floor))
        safe = torch.where(d.abs() > floor, d, signed_floor)
        return torch.where(mask > 0, safe, torch.ones_like(safe))

    def solve_bicgstab_result(self, mu, tol=1e-8, maxiter=6000, precond="jacobi"):
        """Matrix-free BiCGStab solve preconditioned by ``precond``
        ('jacobi' or 'mg', the V-cycle on K), with its
        :class:`~rla4mor_tpu_torch.core.solvers.CGResult`. Jacobi is slow on
        the indefinite systems: keep its grids moderate or raise maxiter."""
        return bicgstab(lambda u: self.apply(mu, u), self.rhs(),
                        precond=preconditioner(self, mu, precond), tol=tol,
                        maxiter=maxiter)

    def solve_bicgstab(self, mu, tol=1e-8, maxiter=6000, precond="jacobi"):
        return self.solve_bicgstab_result(mu, tol, maxiter, precond).x

    def output(self, u: torch.Tensor) -> torch.Tensor:
        """Mean-value functional (lumped integral), per grid of the leading
        dimensions."""
        return u.sum(dim=(-2, -1)) * self.h * self.h

    # -- flattened-vector LinOp views ---------------------------------------
    def term_linop(self, t: int) -> "HelmholtzTermOp":
        return HelmholtzTermOp(self, t)

    def affine_operator(self):
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.parameters import ONE

        return AffineOp((self.term_linop(0), self.term_linop(1)), (ONE, _NEG_KSQ))

    def sample_parameters(self, count: int, key: int = 0) -> list:
        """Uniform ksq in ``ksq_range``; sample i from the generator of
        stream ``(key, i)``."""
        lo, hi = self._ksq_range
        return [{"ksq": uniform(generator(key, i), 1, lo, hi, self.device, self.dtype)}
                for i in range(count)]


class HelmholtzTermOp(FlatGridOp):
    """LinOp view of K (t = 0) or M (t = 1) on flattened vectors; both are
    symmetric, so FlatGridOp's adjoint alias is exact."""

    def __init__(self, fom: StencilHelmholtz, t: int):
        super().__init__(fom.n_nodes)
        self.fom = fom
        self.t = t

    def _grid_apply(self, grid):
        return self.fom.apply_term(self.t, grid)

    @property
    def H(self):
        return self


def _m_coeff_damped(mu):
    """-ksq + i gamma: (), or (B,) for a batched Mu."""
    ksq = torch.as_tensor(mu["ksq"])[..., 0]
    gam = torch.as_tensor(mu["gamma"])[..., 0]
    return torch.complex(-ksq.to(torch.float64), gam.to(torch.float64))


_M_COEFF_DAMPED = ExpressionCoefficient(_m_coeff_damped, "-ksq+i*gamma")


class StencilHelmholtzDamped(StencilHelmholtz):
    """Helmholtz in lossy media, A(mu) = K + (-ksq + i gamma) M: the same
    real symmetric stencil terms with a complex coefficient on the mass
    (damping gamma > 0 models absorption). The family of the complex
    matrix-free inf-sup SCM (``mor/scm_matfree.py::MatrixFreeScmInfSup``,
    the Re / Im pair expansion). Solutions and solves are complex;
    ``dtype`` is the real storage dtype of the stencil fields, promoted to
    :attr:`complex_dtype` in :meth:`apply` and :meth:`solve_bicgstab`. The
    port's ``ParameterSpace`` is one scalar box, which cannot hold the two
    ranges: :meth:`sample_parameters` draws within them."""

    is_complex = True

    def __init__(self, num_intervals: int = 64, dtype=None,
                 ksq_range: tuple[float, float] = (22.0, 46.0),
                 gamma_range: tuple[float, float] = (0.5, 4.0), device=None):
        super().__init__(num_intervals, dtype, ksq_range, device)
        self.parameter_space = None
        self._gamma_range = gamma_range

    @property
    def complex_dtype(self):
        return torch.complex64 if self.dtype == torch.float32 else torch.complex128

    def theta_vector(self, mu) -> torch.Tensor:
        """(1, -ksq + i gamma) in :attr:`complex_dtype`: (2,), or (B, 2)."""
        z = _m_coeff_damped(mu).to(self.device, self.complex_dtype)[..., None]
        return torch.cat([torch.ones_like(z), z], dim=-1)

    def apply(self, mu, u: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(u.dtype, self.complex_dtype)
        u = u.to(dt)
        theta = self.theta_vector(mu).to(dt)
        return (theta[0] * stencil_apply(u, self._ones(dt))
                + theta[1] * mass_apply(u, self.h))

    def jacobi_diag(self, mu) -> torch.Tensor:
        """Complex diag K + (-ksq + i gamma) diag M (the damping keeps |diag|
        away from zero; entries under the 0.1 x 8/3 floor in magnitude take
        the floor), 1 on the Dirichlet ring."""
        z = _m_coeff_damped(mu).to(self.device, self.complex_dtype)
        dk = stiffness_diag_raw(self._ones(self.dtype))
        dm = mass_diag(self.n_nodes, self.h, self.dtype, self.device)
        mask = interior_mask(self.n_nodes, self.dtype, self.device)
        d = (dk + z * torch.where(mask > 0, dm, torch.zeros_like(dm))) * mask
        floor = 0.1 * float(8.0 / 3.0)
        safe = torch.where(d.abs() > floor, d, torch.full_like(d, floor))
        return torch.where(mask > 0, safe, torch.ones_like(safe))

    def solve_bicgstab_result(self, mu, tol=1e-8, maxiter=6000, precond="jacobi"):
        """Complex matrix-free BiCGStab preconditioned by ``precond`` ('jacobi',
        the complex diagonal, or 'mg', the V-cycle on K)."""
        return bicgstab(lambda u: self.apply(mu, u), self.rhs().to(self.complex_dtype),
                        precond=preconditioner(self, mu, precond), tol=tol,
                        maxiter=maxiter)

    def affine_operator(self):
        from rla4mor_tpu_torch.core.affine import AffineOp
        from rla4mor_tpu_torch.core.parameters import ONE

        return AffineOp((self.term_linop(0), self.term_linop(1)), (ONE, _M_COEFF_DAMPED))

    def sample_parameters(self, count: int, key: int = 0, values=None) -> list:
        """Uniform ksq and gamma in their ranges, sample i from the generator
        of stream ``(key, i)`` (ksq first); or, with ``values`` ((count, 2):
        ksq, gamma, as another sampler drew them), those values."""
        if values is not None:
            v = torch.as_tensor(values, dtype=torch.float64)
            return [{"ksq": v[i, :1].to(self.device, self.dtype),
                     "gamma": v[i, 1:2].to(self.device, self.dtype)} for i in range(count)]
        (klo, khi), (glo, ghi) = self._ksq_range, self._gamma_range
        out = []
        for i in range(count):
            g = generator(key, i)
            out.append({"ksq": uniform(g, 1, klo, khi, self.device, self.dtype),
                        "gamma": uniform(g, 1, glo, ghi, self.device, self.dtype)})
        return out
