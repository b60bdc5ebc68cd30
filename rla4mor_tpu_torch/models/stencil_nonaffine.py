"""Non-affine diffusion on the matrix-free Q1 stencil, made affine by EIM.

Counterpart of ``rla4mor_tpu/models/stencil_nonaffine.py``. The Gaussian-bump
conductivity

    kappa(mu, x) = kappa0 + amp * exp(-|x - c(mu)|^2 / (2 w(mu)^2))

depends on mu (the bump's centre and width) in no finite theta / term sum.
``EimStencilFOM`` closes it with the empirical interpolation method
(``mor/eim.py``): offline, an EIM greedy over training fields builds magic
element points and basis fields xi_q; online,

    A(mu) ~= sum_q theta_q(mu) A(xi_q),   theta(mu) = T^-1 kappa(mu, points),

which follows the stencil protocol of ``parallel/driver.py`` (``n_terms``,
``theta_vector``, ``apply_term``, ``apply_terms``, ``apply``, ``rhs``,
``jacobi_diag``, ``kappa``, ``is_spd``), so the padded sketched greedy, the
CG solves with Jacobi or the V-cycle, and the exact score run on it as on
the thermal block. theta(mu) costs M field evaluations and one (M, M)
triangular solve. Every apply is the gather stencil of ``models/stencil.py``
(``models/stencil3d.py`` for the 3-D family); the M terms of a snapshot are
one stencil apply batched over the (M, N, N) basis.

A parameter value may be batched (a leading dimension on ``mu["bump"]``):
``theta_vector``, ``kappa``, ``kappa_error_indicator`` and
``ellipticity_margin`` then return one row a parameter.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, Optional, Sequence

import torch

from rla4mor_tpu_torch.core.parameters import Mu, ParameterSpace, mu_stack
from rla4mor_tpu_torch.models.stencil import (
    FlatGridOp,
    interior_mask,
    stencil_apply,
    stiffness_diag_raw,
)
from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device, sync


class NonAffineStencilFOM:
    """Exact (non-affine) diffusion stencil FOM on ``device`` (the current
    card unless named), working dtype by default.

    ``field_fn(mu, X, Y) -> kappa`` is a function of tensors that works on
    the full (N, N) element-centre grids and on 1-d magic-point coordinate
    vectors, and broadcasts a batched mu over a leading dimension. This
    class is the ground truth the EIM surrogate is measured against."""

    is_spd = True

    def __init__(self, field_fn: Callable, num_intervals: int = 64,
                 parameter_space: Optional[ParameterSpace] = None, dtype=None,
                 device=None, kappa_lower: Optional[float] = None):
        self.field_fn = field_fn
        self.num_intervals = int(num_intervals)
        self.parameter_space = parameter_space
        self.device = resolve_device(device)
        self.dtype = default_dtype(self.device) if dtype is None else dtype
        self.kappa_lower = kappa_lower  # a provable inf over x and mu of kappa, if known
        self.n_nodes = self.num_intervals + 1
        self.h = 1.0 / self.num_intervals

    @property
    def solution_shape(self):
        return (self.n_nodes, self.n_nodes)

    @property
    def n_dof(self) -> int:
        return math.prod(self.solution_shape)

    @property
    def element_shape(self):
        return (self.num_intervals, self.num_intervals)

    def _centres_1d(self) -> torch.Tensor:
        N = self.num_intervals
        return (torch.arange(N, dtype=self.dtype, device=self.device) + 0.5) * self.h

    def element_centers(self):
        """(X, Y) element-centre coordinate grids (N, N), row = y."""
        c = self._centres_1d()
        return torch.meshgrid(c, c, indexing="xy")

    # -- field-generic backend (the EIM surrogate delegates here) ---------
    def apply_field(self, kappa: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """A(kappa) u for any element field (a leading batch on kappa
        applies each field to u)."""
        return stencil_apply(u, kappa.to(u.dtype))

    def diag_field(self, kappa: torch.Tensor) -> torch.Tensor:
        d = stiffness_diag_raw(kappa)
        return torch.where(d > 0, d, torch.ones_like(d))

    def kappa(self, mu: Mu, dtype=None) -> torch.Tensor:
        dt = self.dtype if dtype is None else dtype
        return self.field_fn(mu, *(c.to(dt) for c in self.element_centers()))

    def apply(self, mu: Mu, u: torch.Tensor) -> torch.Tensor:
        return self.apply_field(self.kappa(mu, dtype=u.dtype), u)

    def rhs(self, dtype=None) -> torch.Tensor:
        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.solution_shape, self.h * self.h, dtype=dt, device=self.device)
        return load * interior_mask(self.n_nodes, dt, self.device)

    def jacobi_diag(self, mu: Mu) -> torch.Tensor:
        return self.diag_field(self.kappa(mu))

    def solve_cg(self, mu: Mu, tol=1e-8, maxiter=2000) -> torch.Tensor:
        """Matrix-free Jacobi-CG solve."""
        from rla4mor_tpu_torch.core.solvers import cg

        diag = self.jacobi_diag(mu)
        return cg(lambda u: self.apply(mu, u), self.rhs(), precond=lambda r: r / diag,
                  tol=tol, maxiter=maxiter).x

    def output(self, u: torch.Tensor) -> torch.Tensor:
        """Mean-value functional, per grid of the leading dimensions."""
        return u.sum(dim=(-2, -1)) * self.h * self.h

    def sample_parameters(self, count: int, key: int = 0) -> list:
        """Uniform draws of the parameter space, stream ``(key, i)`` for
        sample i (``ParameterSpace.sample_randomly``)."""
        if self.parameter_space is None:
            raise ValueError("sample_parameters: no parameter space")
        return self.parameter_space.sample_randomly(count, seed=key, device=self.device,
                                                    dtype=self.dtype)

    def with_num_intervals(self, num_intervals: int):
        """The same family on another grid (two-grid EIM training)."""
        return type(self)(self.field_fn, num_intervals, parameter_space=self.parameter_space,
                          dtype=self.dtype, device=self.device,
                          kappa_lower=self.kappa_lower)


class NonAffineStencilFOM3D(NonAffineStencilFOM):
    """The 3-D family on the trilinear Q1 stencil (``models/stencil3d.py``):
    ``field_fn(mu, X, Y, Z)`` over (N, N, N) element centres, index order
    (z, y, x). Only the geometry differs, so :class:`EimStencilFOM` and the
    driver take it unchanged."""

    @property
    def solution_shape(self):
        return (self.n_nodes,) * 3

    @property
    def element_shape(self):
        return (self.num_intervals,) * 3

    def element_centers(self):
        c = self._centres_1d()
        Z, Y, X = torch.meshgrid(c, c, c, indexing="ij")
        return (X, Y, Z)

    def apply_field(self, kappa: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        from rla4mor_tpu_torch.models.stencil3d import stencil3d_apply

        return stencil3d_apply(u, kappa.to(u.dtype), self.h)

    def diag_field(self, kappa: torch.Tensor) -> torch.Tensor:
        from rla4mor_tpu_torch.models.stencil3d import stiffness3d_diag_raw

        d = stiffness3d_diag_raw(kappa, self.h)
        return torch.where(d > 0, d, torch.ones_like(d))

    def rhs(self, dtype=None) -> torch.Tensor:
        from rla4mor_tpu_torch.models.stencil3d import interior_mask3

        dt = self.dtype if dtype is None else dtype
        load = torch.full(self.solution_shape, self.h ** 3, dtype=dt, device=self.device)
        return load * interior_mask3(self.n_nodes, dt, self.device)

    def output(self, u: torch.Tensor) -> torch.Tensor:
        return u.sum(dim=(-3, -2, -1)) * self.h ** 3

    # lumped-mass hooks of the time-dependent stencil FOMs (models/stencil3d.py)
    def mass_apply_grid(self, u: torch.Tensor) -> torch.Tensor:
        from rla4mor_tpu_torch.models.stencil3d import lumped_mass3_apply

        return lumped_mass3_apply(u, self.h)

    def mass_diag_grid(self) -> torch.Tensor:
        from rla4mor_tpu_torch.models.stencil3d import lumped_mass3_diag

        return lumped_mass3_diag(self.n_nodes, self.h, self.dtype, self.device)


def _columns(g: torch.Tensor) -> torch.Tensor:
    """Field values at the points, (P,) or a batch (B, P), as the
    interpolant's (P,) or (P, B) columns."""
    return g if g.dim() == 1 else g.mT


class EimStencilFOM:
    """EIM-affine surrogate of a :class:`NonAffineStencilFOM`, on its
    device and in its dtype.

    ``is_spd`` holds while the EIM kappa stays positive: asserted over the
    training set in :meth:`from_training`; at other parameters check
    :meth:`ellipticity_margin` (a negative margin means the interpolation
    error may have made the operator indefinite, and CG would stall)."""

    is_spd = True

    def __init__(self, exact: NonAffineStencilFOM, interpolant, kappa_floor: float):
        from rla4mor_tpu_torch.mor.eim import EimInterpolant

        if not isinstance(interpolant, EimInterpolant):
            raise TypeError("EimStencilFOM needs an EimInterpolant")
        self.exact = exact
        self.interpolant = interpolant
        self.kappa_floor = kappa_floor  # min of the EIM kappa over the training set
        self.device = exact.device
        self.dtype = exact.dtype
        self.num_intervals = exact.num_intervals
        self.n_nodes = exact.n_nodes
        self.h = exact.h
        self.parameter_space = exact.parameter_space
        self.fit_s: dict = {}  # offline seconds by part (from_training)
        # (M, *element_shape) active basis fields and the coordinates of all
        # magic points (active, then reserve); any exact FOM with the
        # field-generic backend works, 2-D and 3-D alike
        M = interpolant.n_terms
        self.xi = interpolant.basis[:, :M].T.reshape((-1,) + tuple(exact.element_shape))
        pts = interpolant.points
        self._pcoords = tuple(c.reshape(-1)[pts] for c in exact.element_centers())
        self._affine_op = None
        # parabolic mass hooks, where the exact FOM has them (3-D lumped mass)
        if hasattr(exact, "mass_apply_grid"):
            self.mass_apply_grid = exact.mass_apply_grid
            self.mass_diag_grid = exact.mass_diag_grid

    @classmethod
    def from_training(cls, exact: NonAffineStencilFOM, training_mus: Sequence[Mu],
                      tol: float = 1e-6, max_terms: Optional[int] = None, reserve: int = 4,
                      training_intervals: Optional[int] = None,
                      device_scan: bool = False) -> "EimStencilFOM":
        """Offline EIM greedy over the training kappa fields.

        ``reserve`` more greedy steps give the online indicator
        (:meth:`kappa_error_indicator`, :meth:`model_error_bound`); a
        warning says when the training set ran out first.
        ``training_intervals``: two-grid training, the greedy on that
        coarser grid and the interpolant rebuilt on the fine grid from the
        selected snapshots only (``mor.eim.eim_rebuild``; its history holds
        the selected snapshots' fine residuals, not a certified training
        error). ``device_scan``: ``eim_greedy_device`` (one host read a
        chunk) in place of the host loop (two a step).

        The training fields are one (n, m) column-major block whose memory
        the greedy takes over for its residuals. ``fit_s`` records the
        seconds of the fields, the greedy and (two-grid) the rebuild."""
        from rla4mor_tpu_torch.mor.eim import eim_greedy, eim_greedy_device, eim_rebuild

        dev = exact.device
        two_grid = training_intervals is not None and training_intervals != exact.num_intervals
        trainer = exact.with_num_intervals(training_intervals) if two_grid else exact
        batch = mu_stack(training_mus)
        fit_s = {}
        t0 = time.perf_counter()
        G = trainer.kappa(batch).reshape(len(training_mus), -1).T  # (n, m) column-major
        sync(dev)
        fit_s["fields"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        greedy = eim_greedy_device if device_scan else eim_greedy
        interp = greedy(G, tol=tol, max_terms=max_terms, reserve=reserve, inplace=True)
        del G
        sync(dev)
        fit_s["greedy"] = time.perf_counter() - t0
        if interp.n_reserve < reserve:
            warnings.warn(f"EIM greedy exhausted the training set: n_reserve="
                          f"{interp.n_reserve} < {reserve}; kappa_error_indicator "
                          "unavailable: enlarge training_mus", stacklevel=2)
        if two_grid:
            t0 = time.perf_counter()
            # the greedy may select a training column more than once: each
            # unique fine field is evaluated once
            unique = sorted(set(interp.snapshot_ids))
            fine = exact.kappa(mu_stack([training_mus[j] for j in unique]))
            col = {j: i for i, j in enumerate(unique)}
            G_sel = fine.reshape(len(unique), -1)[[col[j] for j in interp.snapshot_ids]].T
            interp = eim_rebuild(G_sel, n_reserve=interp.n_reserve)
            # the positivity floor over the selected fine fields (the whole
            # training set was only ever built coarse)
            floor = float(interp.interpolate(G_sel).min())
            del fine, G_sel
            sync(dev)
            fit_s["rebuild"] = time.perf_counter() - t0
        fom = cls(exact, interp, kappa_floor=float("nan"))
        if not two_grid:
            floor = float(fom.kappa(batch).min())  # the surrogate at every training mu
        if not floor > 0:
            raise ValueError("EIM kappa surrogate loses positivity on the training set "
                             f"(min {floor:.3e}); tighten tol or enlarge training")
        fom.kappa_floor = floor
        fom.fit_s = fit_s
        return fom

    # -- stencil protocol ---------------------------------------------------
    @property
    def n_terms(self) -> int:
        return self.interpolant.n_terms

    @property
    def solution_shape(self):
        return self.exact.solution_shape

    @property
    def element_shape(self):
        return self.exact.element_shape

    def theta_vector(self, mu: Mu) -> torch.Tensor:
        """EIM coefficients (M,), or (B, M) for a batched Mu: M field
        evaluations at the magic points and one triangular solve."""
        M = self.n_terms
        g = self.exact.field_fn(mu, *(c[:M] for c in self._pcoords))
        theta = self.interpolant.coefficients(_columns(g.to(self.dtype)))
        return _columns(theta)

    def kappa_error_indicator(self, mu: Mu) -> torch.Tensor:
        """Estimate of ``sup_x |kappa(mu, x) - kappa_EIM(mu, x)|``: the
        interpolation error at the reserve points (a lower bound that
        tracks the sup closely on smooth families); scalar or (B,)."""
        g = self.exact.field_fn(mu, *self._pcoords)
        return self.interpolant.error_indicator(_columns(g.to(self.dtype)))

    def _k0(self) -> float:
        k0 = self.exact.kappa_lower
        return self.kappa_floor if k0 is None else k0

    def _h1(self, u_s: torch.Tensor) -> torch.Tensor:
        """|u_s|_H1 = sqrt(u^T A(1) u), the unit-conductivity stencil."""
        ones = torch.ones(tuple(self.exact.element_shape), dtype=u_s.dtype, device=u_s.device)
        sq = (u_s.conj() * self.exact.apply_field(ones, u_s)).real.sum()
        return torch.sqrt(torch.clamp(sq, min=0.0))

    def model_error_bound(self, mu: Mu, u_s: torch.Tensor,
                          eps: Optional[float] = None) -> torch.Tensor:
        """First-order bound on the EIM model error in the exact energy
        norm: with ``|kappa - kappa_EIM| <= eps`` pointwise and
        ``kappa >= k0 > 0``,

            ||u_exact - u_s||_{a(mu)}  <=  eps |u_s|_H1 / sqrt(k0).

        ``eps`` defaults to :meth:`kappa_error_indicator` (then an
        indicator, not a certificate); ``k0`` is the exact FOM's
        ``kappa_lower`` if declared, else the training floor."""
        if eps is None:
            eps = self.kappa_error_indicator(mu)
        eps = torch.as_tensor(eps).to(u_s.real.dtype)
        return eps * self._h1(u_s) / math.sqrt(self._k0())

    def total_error_bound(self, mu: Mu, u_s: torch.Tensor, est, lam_bounds: tuple,
                          eps: Optional[float] = None) -> torch.Tensor:
        """l2 bound on the state error against the exact operator:

            ||u_e - u_s||_2 <= (est + eps |u_s|_H1 sqrt(lam_hi))
                               / (kappa_lower * lam_lo),

        ``est`` the l2 residual norm of ``u_s`` against the surrogate,
        ``lam_bounds = (lam_lo, lam_hi)`` an enclosure of the spectrum of
        the unit-conductivity interior stiffness K_1, ``eps`` the pointwise
        field error (default :meth:`kappa_error_indicator`). Needs the exact
        FOM's ``kappa_lower``."""
        if self.exact.kappa_lower is None:
            raise ValueError("total_error_bound needs exact.kappa_lower (a provable "
                             "field infimum); the EIM training floor is heuristic")
        if eps is None:
            eps = self.kappa_error_indicator(mu)
        h1 = self._h1(u_s)
        lam_lo, lam_hi = lam_bounds
        num = torch.as_tensor(est).to(h1) + torch.as_tensor(eps).to(h1) * h1 * math.sqrt(lam_hi)
        return num / (self.exact.kappa_lower * lam_lo)

    def ellipticity_margin(self, mu: Mu) -> torch.Tensor:
        """Estimated lower bound on ``inf_x kappa_EIM(mu, x)``:
        ``k0 - kappa_error_indicator(mu)``; scalar or (B,). Gate CG on its
        staying positive at parameters outside the training set."""
        return self._k0() - self.kappa_error_indicator(mu)

    def kappa_min(self, mu: Mu, chunk: int = 16) -> torch.Tensor:
        """The surrogate field's minimum over the elements; scalar or (B,)
        (a batch ``chunk`` parameters at a time). Every element stiffness is
        PSD, so the surrogate operator is SPD exactly where this is positive:
        the check that :meth:`ellipticity_margin` estimates in O(M), at
        O(M n) a parameter."""
        b = next(iter(mu.values()))
        if torch.as_tensor(b).dim() == 1:
            return self.kappa(mu).amin()
        return torch.cat([self.kappa({k: v[i:i + chunk] for k, v in mu.items()})
                          .flatten(1).amin(dim=1) for i in range(0, len(b), chunk)])

    def kappa(self, mu: Mu, dtype=None) -> torch.Tensor:
        """The surrogate field sum_q theta_q xi_q: (N, N), or (B, N, N)."""
        dt = self.dtype if dtype is None else dtype
        return torch.tensordot(self.theta_vector(mu).to(dt), self.xi.to(dt), dims=1)

    def apply(self, mu: Mu, u: torch.Tensor) -> torch.Tensor:
        return self.exact.apply_field(self.kappa(mu, dtype=u.dtype), u)

    def apply_field(self, kappa_el: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """The exact FOM's field-generic apply (2-D and 3-D alike)."""
        return self.exact.apply_field(kappa_el, u)

    def apply_term(self, q: int, u: torch.Tensor) -> torch.Tensor:
        return self.exact.apply_field(self.xi[q], u)

    def apply_terms(self, u: torch.Tensor) -> torch.Tensor:
        """(M, *grid): every term applied to one grid u, one stencil apply
        batched over the basis fields."""
        return self.exact.apply_field(self.xi, u)

    def term_linop(self, q: int) -> "EimTermOp":
        return EimTermOp(self, q)

    def affine_operator(self):
        """``AffineOp`` over flattened vectors whose coefficients share one
        magic-point solve per Mu (``mor.eim.theta_coefficients``), the
        interface of ``StencilThermalBlock.affine_operator``. Cached."""
        if self._affine_op is None:
            from rla4mor_tpu_torch.core.affine import AffineOp
            from rla4mor_tpu_torch.mor.eim import theta_coefficients

            def entries(mu):
                M = self.n_terms
                return self.exact.field_fn(mu, *(c[:M] for c in self._pcoords)).to(self.dtype)

            self._affine_op = AffineOp(
                tuple(self.term_linop(q) for q in range(self.n_terms)),
                theta_coefficients(self.interpolant, entries, name="eim_theta"))
        return self._affine_op

    def rhs(self, dtype=None) -> torch.Tensor:
        return self.exact.rhs(dtype)

    def jacobi_diag(self, mu: Mu) -> torch.Tensor:
        return self.exact.diag_field(self.kappa(mu))

    def output(self, u: torch.Tensor) -> torch.Tensor:
        return self.exact.output(u)

    def sample_parameters(self, count: int, key: int = 0) -> list:
        return self.exact.sample_parameters(count, key=key)


class EimTermOp(FlatGridOp):
    """LinOp view of one EIM term A(xi_q) on flattened vectors (2-D and
    3-D grids)."""

    def __init__(self, fom: EimStencilFOM, q: int):
        super().__init__(grid_shape=fom.solution_shape)
        self.fom = fom
        self.q = q

    def _grid_apply(self, grid):
        return self.fom.apply_term(self.q, grid)

    @property
    def H(self):
        return self


def _bump(mu: Mu, coords, center_range, width_range, kappa0: float, amp: float):
    """kappa0 + amp exp(-|x - c|^2 / (2 w^2)) at ``coords`` (one tensor an
    axis), mu['bump'] = (c_1, ..., c_d, w) in [0, 1] mapped into the
    ranges; a batched mu broadcasts over a leading dimension."""
    x0 = coords[0]
    b = torch.as_tensor(mu["bump"]).to(device=x0.device, dtype=x0.dtype)
    lead = b.shape[:-1] + (1,) * x0.dim()
    c0, c1 = center_range
    w0, w1 = width_range
    w = (w0 + (w1 - w0) * b[..., len(coords)]).reshape(lead)
    r2 = None
    for axis, x in enumerate(coords):
        c = (c0 + (c1 - c0) * b[..., axis]).reshape(lead)
        r2 = (x - c) ** 2 if r2 is None else r2 + (x - c) ** 2
    return kappa0 + amp * torch.exp(-r2 / (2.0 * w * w))


def gaussian_bump_field(kappa0: float = 1.0, amp: float = 9.0, center_range=(0.25, 0.75),
                        width_range=(0.08, 0.25)) -> Callable:
    """Field factory: mu['bump'] = (cx, cy, w) in the [0, 1] box, mapped
    affinely into ``center_range`` / ``width_range``."""

    def field(mu: Mu, X, Y):
        return _bump(mu, (X, Y), center_range, width_range, kappa0, amp)

    return field


def gaussian_bump_fom(num_intervals: int = 64, dtype=None, device=None,
                      **field_kw) -> NonAffineStencilFOM:
    """The Gaussian-bump non-affine diffusion FOM, mu['bump'] in [0, 1]^3."""
    kappa0 = field_kw.get("kappa0", 1.0)
    amp = field_kw.get("amp", 9.0)
    return NonAffineStencilFOM(
        gaussian_bump_field(**field_kw), num_intervals,
        parameter_space=ParameterSpace.make({"bump": 3}), dtype=dtype, device=device,
        kappa_lower=kappa0 + min(0.0, amp))  # exp in (0, 1]


def gaussian_bump_field3d(kappa0: float = 1.0, amp: float = 9.0, center_range=(0.25, 0.75),
                          width_range=(0.1, 0.3)) -> Callable:
    """3-D field factory: mu['bump'] = (cx, cy, cz, w) in [0, 1]^4."""

    def field(mu: Mu, X, Y, Z):
        return _bump(mu, (X, Y, Z), center_range, width_range, kappa0, amp)

    return field


def gaussian_bump_fom3d(num_intervals: int = 32, dtype=None, device=None,
                        **field_kw) -> NonAffineStencilFOM3D:
    """The 3-D Gaussian-bump FOM, mu['bump'] in [0, 1]^4."""
    kappa0 = field_kw.get("kappa0", 1.0)
    amp = field_kw.get("amp", 9.0)
    return NonAffineStencilFOM3D(
        gaussian_bump_field3d(**field_kw), num_intervals,
        parameter_space=ParameterSpace.make({"bump": 4}), dtype=dtype, device=device,
        kappa_lower=kappa0 + min(0.0, amp))
