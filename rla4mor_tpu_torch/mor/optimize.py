"""Certified ROM-based parameter optimisation.

Counterpart of ``rla4mor_tpu/mor/optimize.py``: minimise an output
functional

    J(mu) = objective(s(u_r(mu)), mu),   A(mu) u = b(mu),  s = C(mu) u

over the box parameter space.

* **Gradients by autograd through the reduced solve.** ``torch.linalg.solve``
  differentiates through the discrete adjoint: one more r x r solve a
  gradient. The starts of a multi-start run are independent, so the
  gradient of ``J(X).sum()`` with respect to the (starts, d) rows ``X`` is
  each start's own gradient.
* **Batched multi-start.** All starts advance together as one (starts, d)
  tensor: one batched evaluation of J and its gradient an iteration. The
  Armijo backtracking is a masked loop: the starts that still fail
  sufficient decrease halve their own step, the others keep theirs.
* **Certification.** ``|J_fom - J_rom| <= ||l(mu)||_{R^-1} eta(mu) /
  alpha_LB(mu)``: the sketched residual estimator, a coercivity lower bound
  (:class:`~rla4mor_tpu_torch.mor.bounds.MinThetaCoercivity`) and the exact
  affine Gram of the output functional's Riesz representatives.
  :func:`certified_minimize` enriches the basis at the optimum;
  :func:`trust_region_minimize` gates each step by the certificate.

An objective is a torch callable on batches: ``J(X)`` maps (S, d) rows to
(S,) values (and a (d,) vector to a 0-d value); a custom ``objective(s, mu)``
maps the output (..., n_out) and the (batched) Mu to (...) values, e.g.
``lambda s, mu: -s[..., 0].real``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from rla4mor_tpu_torch.core.affine import AffineDense
from rla4mor_tpu_torch.core.linops import to_numpy
from rla4mor_tpu_torch.core.parameters import Mu, ParameterSpace, eval_coefficients
from rla4mor_tpu_torch.mor.bounds import error_bound
from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device
from rla4mor_tpu_torch.utils.logger import get_logger


def rom_device_dtype(rom) -> tuple[torch.device, torch.dtype]:
    """The device and real dtype of a ROM's reduced tensors: where and in
    what precision its parameters should live (the composites' primal ROM
    for a corrected-output ROM)."""
    for obj in (rom, getattr(rom, "rom_pr", None)):
        stack = getattr(getattr(obj, "lhs", None), "stack", None)
        if isinstance(stack, torch.Tensor):
            return stack.device, stack.real.dtype
    dev = resolve_device(None)
    return dev, default_dtype(dev)


def _generator(key) -> torch.Generator:
    """``key`` as a CPU generator: an int seeds a new one, a generator is used
    as it is."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


# ---------------------------------------------------------------------------
# Objective construction
# ---------------------------------------------------------------------------


def make_objective(rom, space: ParameterSpace, objective: Optional[Callable] = None,
                   component: int = 0) -> Callable:
    """``J(x)`` of the flat parameter vector (d,), or of rows (S, d) -> (S,).

    ``objective(s, mu)`` maps the output ``s = C(mu) u_r`` (..., n_out) and
    the Mu to real values; the default is ``Re s[..., component]``."""
    if objective is None:
        def objective(s, mu):  # noqa: ARG001 - uniform signature
            return torch.real(s[..., component])

    def J(x):
        mu = space.parse(x)
        u = rom.solve(mu)
        return objective(rom.output(u, mu), mu)

    return J


def _value_and_grad(J: Callable) -> Callable:
    """``x -> (J(x), dJ/dx)`` by autograd; on rows (S, d) the gradient of the
    sum, which is each row's own gradient (the rows are independent)."""
    def vg(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = J(x)
            (g,) = torch.autograd.grad(f.sum(), x)
        return f.detach(), g

    return vg


def output_gradient(rom, space: ParameterSpace, objective=None, component=0) -> Callable:
    """``x -> (value, grad)`` of the reduced output with respect to the flat
    parameter vector (or each of a batch of rows): autograd through the
    reduced solve (adjoint-exact)."""
    return _value_and_grad(make_objective(rom, space, objective, component))


def _box(space: ParameterSpace, device, dtype):
    lo = torch.full((space.dim(),), float(space.low), dtype=dtype, device=device)
    hi = torch.full((space.dim(),), float(space.high), dtype=dtype, device=device)
    return lo, hi


# ---------------------------------------------------------------------------
# Box-constrained multi-start projected gradient
# ---------------------------------------------------------------------------


@dataclass
class MinimizeResult:
    x: torch.Tensor          # (d,) best final iterate
    value: float             # J(x)
    stationarity: float      # ||x - P(x - grad)||_2 at the best iterate
    xs: torch.Tensor         # (S, d) all final iterates
    values: torch.Tensor     # (S,)
    iterations: int


def minimize_scalar(
    J: Callable,
    space: ParameterSpace,
    n_starts: int = 8,
    iters: int = 100,
    key: int | torch.Generator = 0,
    step0: float = 1.0,
    sigma: float = 1e-4,
    x0=None,
    device=None,
    dtype=None,
) -> MinimizeResult:
    """Minimise a batched scalar ``J`` of the flat parameter vector over the
    box ``[space.low, space.high]^d``.

    Projected gradient with Armijo backtracking (sufficient decrease
    ``J(x+) <= J(x) - (sigma/t) ||x - x+||^2``), the step doubled after each
    accepted iterate (at most ``1024 max(step0, 1)``). The starts are
    ``n_starts`` uniform draws from the CPU generator of ``key`` with the
    box midpoint first, or the rows of ``x0``; they live on ``device`` in
    ``dtype`` (default: ``x0``'s, else the current card in its working
    dtype) and advance together, one batched evaluation of J and its
    gradient an iteration. A start whose final value is NaN never wins; if
    every start ends at NaN or inf, it raises."""
    d = space.dim()
    if x0 is not None:
        starts = torch.atleast_2d(torch.as_tensor(x0))
        dev = starts.device if device is None else resolve_device(device)
        dt = dtype or (starts.dtype if starts.is_floating_point() else torch.float64)
        starts = starts.to(dev, dt)
        if starts.shape[1] != d:
            raise ValueError(f"x0 rows have {starts.shape[1]} coordinates, the space {d}")
    else:
        dev = resolve_device(device)
        dt = default_dtype(dev) if dtype is None else dtype
        u = torch.rand((max(int(n_starts), 1), d), generator=_generator(key),
                       dtype=torch.float64)
        starts = (space.low + (space.high - space.low) * u).to(dev, dt)
        starts[0] = 0.5 * (space.low + space.high)
    lo, hi = _box(space, dev, dt)

    def proj(z):
        return torch.clamp(z, lo, hi)

    vg = _value_and_grad(J)
    t_max = max(step0, 1.0) * 1024.0
    t_min = 1e-14

    x = starts
    t = torch.full(x.shape[:1], float(step0), dtype=dt, device=dev)
    with torch.no_grad():
        for _ in range(int(iters)):
            f0, g = vg(x)
            xn = proj(x - t[:, None] * g)
            fn = J(xn)
            while True:
                required = (sigma / t) * ((x - xn) ** 2).sum(dim=-1)
                need = ((f0 - fn) < required) & (t > t_min)
                if not bool(need.any()):
                    break
                t = torch.where(need, 0.5 * t, t)
                xt = proj(x - t[:, None] * g)
                ft = J(xt)
                xn = torch.where(need[:, None], xt, xn)
                fn = torch.where(need, ft, fn)
            accept = fn <= f0
            x = torch.where(accept[:, None], xn, x)
            t = torch.where(accept, torch.clamp(2.0 * t, max=t_max), t)
        values, g = vg(x)
        stats = torch.linalg.vector_norm(x - proj(x - g), dim=-1)
    # NaN lanes (e.g. a singular reduced system at some iterate) must not win
    # the argmin; if every start diverged, fail loudly
    finite = torch.where(torch.isnan(values), torch.full_like(values, float("inf")), values)
    if not bool(torch.isfinite(finite).any()):
        raise FloatingPointError(
            "minimize_scalar: the objective evaluated to NaN/inf at every start's "
            "final iterate: the model is singular over the box")
    best = int(torch.argmin(finite))
    return MinimizeResult(x=x[best], value=float(values[best]),
                          stationarity=float(stats[best]), xs=x, values=values,
                          iterations=int(iters))


def minimize_output(rom, space: ParameterSpace, objective: Optional[Callable] = None,
                    component: int = 0, **kwargs) -> MinimizeResult:
    """Minimise the reduced output over the box: :func:`minimize_scalar` on
    :func:`make_objective`, the starts on the ROM's device in its dtype
    unless ``device`` / ``dtype`` say otherwise."""
    dev, dt = rom_device_dtype(rom)
    kwargs.setdefault("device", dev)
    kwargs.setdefault("dtype", dt)
    return minimize_scalar(make_objective(rom, space, objective, component), space, **kwargs)


# ---------------------------------------------------------------------------
# Output error certification
# ---------------------------------------------------------------------------


class OutputDualNorm:
    """Exact ``||l(mu)||_{R^-1}`` for one row of an affine output functional.

    ``l(mu) = sum_t theta_t(mu) c_t`` (row ``component`` of each term of
    ``fom.output_functional``); the T x T Gram ``G_ts = c_t R^-1 c_s^H`` of
    the Riesz representatives is computed once on the host by the product's
    factorisation, so an evaluation is ``sqrt(theta^H G theta)``: one Mu, or
    one value per row of a batched Mu."""

    def __init__(self, fom, product, component: int = 0):
        of = fom.output_functional
        if of is None:
            raise ValueError("FOM has no output functional")
        if isinstance(of, AffineDense):
            rows = [to_numpy(of.stack[t])[component] for t in range(of.stack.shape[0])]
        else:  # AffineOp with host / dense terms
            rows = [to_numpy(term.matrix())[component] for term in of.terms]
        self.coefficients = tuple(of.coefficients)
        C = np.stack(rows, axis=0)                                  # (T, n)
        inv = product.inv
        if hasattr(inv, "apply_host"):  # the host factorisation, in float64
            Q = inv.apply_host(C.conj().T)                          # (n, T)
        else:
            Q = to_numpy(inv.apply(torch.as_tensor(C.conj().T)))
        self.G = torch.as_tensor(C @ Q)                             # Hermitian PSD
        self._on = {}

    def _gram(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._on:
            self._on[key] = self.G.to(device)
        return self._on[key]

    def __call__(self, mu: Mu) -> torch.Tensor:
        theta = eval_coefficients(self.coefficients, mu)
        G = self._gram(theta.device)
        theta = theta.to(torch.promote_types(G.dtype, theta.dtype))
        q = torch.einsum("...t,ts,...s->...", theta.conj(), G.to(theta.dtype), theta).real
        return torch.sqrt(torch.clamp(q, min=0.0))


class ConstantDualNorm:
    """A mu-independent ``||l||_{R^-1}``: for FOMs whose output functional is
    a fixed vector with a known dual norm (the stencil families' lumped
    mean-value output ``l = h^d 1`` has ``||l||_2 = h^d sqrt(n)``, and the
    greedy step's ROM estimates an l2 residual, so R = I). Stands in for
    :class:`OutputDualNorm` wherever only the call is used."""

    def __init__(self, value: float):
        self.value = float(value)
        if self.value < 0.0:
            raise ValueError("a dual norm is nonnegative")

    def __call__(self, mu: Mu) -> torch.Tensor:
        leaf = torch.as_tensor(next(iter(mu.values())))
        return torch.full(leaf.shape[:-1], self.value, dtype=torch.float64,
                          device=leaf.device)


def output_error_bound(rom, mu: Mu, coercivity, dual_norm, u_r=None) -> torch.Tensor:
    """Certified (up to the sketch's distortion) output error bound
    ``||l(mu)||_{R^-1} eta(mu) / alpha_LB(mu)``: one Mu or a batched one."""
    return dual_norm(mu) * error_bound(rom, mu, coercivity, u_r)


def _stability_certified(coercivity) -> bool:
    return bool(getattr(coercivity, "certified", True))


# ---------------------------------------------------------------------------
# Certified optimisation: optimise on the ROM, enrich at the optimum
# ---------------------------------------------------------------------------


@dataclass
class CertifiedOptimum:
    mu: Mu
    x: torch.Tensor
    value: float                 # reduced output at mu
    bound: float                 # certified |J_fom - value| bound at mu
    converged: bool
    n_enrichments: int
    history: List[dict] = field(default_factory=list)
    stability_certified: bool = True  # the coercivity's own offline verdict
                                      # (the matrix-free SCM's defenses)


def _midpoint(space: ParameterSpace, device, dtype) -> torch.Tensor:
    return torch.full((space.dim(),), 0.5 * (space.low + space.high), dtype=dtype,
                      device=device)


def _fom_device_dtype(fom):
    dev = getattr(fom, "device", None) or resolve_device(None)
    return dev, getattr(fom, "dtype", None) or default_dtype(dev)


def certified_minimize(
    fom,
    reductor,
    coercivity,
    tol: float,
    space: Optional[ParameterSpace] = None,
    objective: Optional[Callable] = None,
    component: int = 0,
    max_enrichments: int = 20,
    seed: int = 0,
    log_level: int = 20,
    **minimize_kwargs,
) -> CertifiedOptimum:
    """Minimise the reduced output; certify the FOM output at the result.

    The guarantee is local: on success ``|J_fom(mu*) - value| <= tol`` at the
    returned parameter (:func:`output_error_bound` there). Global optimality
    is heuristic. Loop: reduce, multi-start PGD on the ROM, certify the
    candidate; if the certificate exceeds ``tol``, one FOM solve there
    (``extend_basis``) and repeat. An empty basis is seeded by one FOM solve
    at the box midpoint. ``objective`` must be the default output component
    for the certificate to apply verbatim (the bound certifies the output
    component, not a composite)."""
    space = space or fom.parameter_space
    logger = get_logger("mor.optimize", log_level)
    dual = OutputDualNorm(fom, product=reductor.product, component=component)
    history: List[dict] = []

    if reductor.basis_size == 0:
        mu0 = space.parse(_midpoint(space, *_fom_device_dtype(fom)))
        logger.info("empty basis: seeding with one FOM solve at the midpoint")
        reductor.extend_basis(fom.solve(mu0), mu=mu0)

    n_enrich = 0
    for round_idx in range(max_enrichments + 1):
        rom = reductor.reduce(seed=seed + 17 * round_idx)
        res = minimize_output(rom, space, objective=objective, component=component,
                              key=seed + round_idx, **minimize_kwargs)
        mu = space.parse(res.x)
        with torch.no_grad():
            bound = float(output_error_bound(rom, mu, coercivity, dual))
        history.append({"round": round_idx, "basis_size": reductor.basis_size,
                        "value": res.value, "bound": bound,
                        "stationarity": res.stationarity})
        logger.info("round %d: r=%d J=%.6e bound=%.3e stat=%.2e", round_idx,
                    reductor.basis_size, res.value, bound, res.stationarity)
        if bound <= tol:
            return CertifiedOptimum(mu=mu, x=res.x, value=res.value, bound=bound,
                                    converged=True, n_enrichments=n_enrich,
                                    history=history,
                                    stability_certified=_stability_certified(coercivity))
        if round_idx == max_enrichments:
            break
        reductor.extend_basis(fom.solve(mu), mu=mu)
        n_enrich += 1

    return CertifiedOptimum(mu=mu, x=res.x, value=res.value, bound=bound, converged=False,
                            n_enrichments=n_enrich, history=history,
                            stability_certified=_stability_certified(coercivity))


# ---------------------------------------------------------------------------
# Trust-region RB optimisation: certificate-gated steps, radius management
# ---------------------------------------------------------------------------


@dataclass
class TrustRegionResult:
    mu: Mu
    x: torch.Tensor
    value: float                 # reduced output at mu
    bound: float                 # certified |J_fom(mu) - value| at mu
    converged: bool
    n_fom_solves: int            # FOM solves spent (== basis enrichments)
    n_steps: int                 # accepted TR steps
    history: List[dict] = field(default_factory=list)
    stability_certified: bool = True  # see CertifiedOptimum


def _tr_subproblem(rom, space, dual, coercivity, objective, component, j_floor,
                   iters: int = 40, sigma: float = 1e-4):
    """One TR subproblem: projected-gradient descent on the reduced objective,
    every step gated by the relative certificate ``eta_s(x) <= delta (|J(x)|
    + j_floor)`` (backtrack until inside the trust region; ``delta = inf``
    disables the gate). Returns ``(run, J, eta_s)``; ``run(x0, delta)`` takes
    one start (d,) or rows (S, d), each with its own masked backtracking, and
    returns ``(x, J(x), eta_s(x), stationarity, boundary_hit)``."""
    J = make_objective(rom, space, objective, component)

    def eta_s(x):
        with torch.no_grad():
            return output_error_bound(rom, space.parse(x), coercivity, dual)

    vg = _value_and_grad(J)
    t_min = 1e-14

    def rel(en, fn):
        return en / (fn.abs() + j_floor)

    def run(x0, delta):
        one = x0.dim() == 1
        x = torch.atleast_2d(x0)
        lo, hi = _box(space, x.device, x.dtype)

        def proj(z):
            return torch.clamp(z, lo, hi)

        with torch.no_grad():
            t = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device)
            f0 = J(x)
            for _ in range(int(iters)):
                _, g = vg(x)

                def trial(tt):
                    xn = proj(x - tt[:, None] * g)
                    return xn, J(xn), eta_s(xn)

                xn, fn, en = trial(t)
                while True:
                    decrease_ok = (f0 - fn) >= (sigma / t) * ((x - xn) ** 2).sum(dim=-1)
                    bad = (~decrease_ok | (rel(en, fn) > delta)) & (t > t_min)
                    if not bool(bad.any()):
                        break
                    t = torch.where(bad, 0.5 * t, t)
                    xt, ft, et = trial(t)
                    xn = torch.where(bad[:, None], xt, xn)
                    fn = torch.where(bad, ft, fn)
                    en = torch.where(bad, et.to(en.dtype), en)
                ok = (fn <= f0) & (rel(en, fn) <= delta)
                x = torch.where(ok[:, None], xn, x)
                f0 = torch.where(ok, fn, f0)
                t = torch.where(ok, 2.0 * t, t)
            e = eta_s(x)
            _, g = vg(x)
            stat = torch.linalg.vector_norm(x - proj(x - g), dim=-1)
            boundary = rel(e, f0) >= 0.75 * delta
        if one:
            return x[0], f0[0], e[0], stat[0], boundary[0]
        return x, f0, e, stat, boundary

    return run, J, eta_s


def trust_region_minimize(
    fom,
    reductor,
    coercivity,
    tol: float,
    space: Optional[ParameterSpace] = None,
    objective: Optional[Callable] = None,
    component: int = 0,
    max_fom_solves: int = 20,
    max_steps: int = 60,
    sub_iters: int = 40,
    delta0: float = 0.1,
    gtol: float = 1e-8,
    j_floor: Optional[float] = None,
    seed: int = 0,
    log_level: int = 20,
) -> TrustRegionResult:
    """Certified trust-region RB optimisation (Qian / Grepl / Veroy / Willcox):
    minimise the FOM output, spending a FOM solve only where a step cannot be
    certified from the ROM alone.

    The trust region is ``{x : eta_s(x) / (|J(x)| + j_floor) <= delta}``;
    each iteration solves the gated subproblem (:func:`_tr_subproblem`) from
    the iterate x_k and judges its trial point x_t:

    * certified decrease, ``J_rom(x_t) + eta_s(x_t) < J_rom(x_k) -
      eta_s(x_k)``: accept with no FOM work, double ``delta`` where the
      subproblem pressed the boundary;
    * no progress (gate-choked, or stationary with a loose certificate):
      one FOM solve at x_k, which collapses the certificate there, and
      retry; convergence is never declared off a choked subproblem;
    * otherwise one FOM solve at x_t: the actual-vs-predicted ratio rho
      decides (accept at rho >= 0.1; double delta at rho >= 0.75 on the
      boundary; halve it on a rejection) and the snapshot enriches the basis.

    Converges where x_k is ROM-stationary (``gtol``) and its absolute
    certificate is at most ``tol``: the same local guarantee as
    :func:`certified_minimize`. ``coercivity`` is a callable of Mu (e.g.
    :class:`~rla4mor_tpu_torch.mor.bounds.MinThetaCoercivity`); ``j_floor``
    regularises the relative certificate near J = 0 (default ``max(tol,
    1e-12 (1 + |J(x_0)|))``)."""
    space = space or fom.parameter_space
    logger = get_logger("mor.optimize.tr", log_level)
    dual = OutputDualNorm(fom, product=reductor.product, component=component)
    history: List[dict] = []
    n_fom = 0

    def enrich(mu):
        nonlocal n_fom
        u = fom.solve(mu)
        n_fom += 1
        reductor.extend_basis(u, mu=mu)
        s = fom.output_functional.apply(u, mu)
        if objective is None:
            return float(torch.real(s.reshape(-1)[component]))
        return float(objective(s, mu))

    x_k = _midpoint(space, *_fom_device_dtype(fom))
    if reductor.basis_size == 0:
        enrich(space.parse(x_k))

    def rebuild():
        rom = reductor.reduce(seed=seed + n_fom)
        return _tr_subproblem(rom, space, dual, coercivity, objective, component,
                              j_floor_, iters=sub_iters)

    # j_floor needs one J evaluation: the output scale at the midpoint on the
    # current ROM (an r x r solve)
    rom0 = reductor.reduce(seed=seed)
    with torch.no_grad():
        f_boot = float(make_objective(rom0, space, objective, component)(x_k))
    j_floor_ = (float(j_floor) if j_floor is not None
                else max(tol, 1e-12 * (1.0 + abs(f_boot))))

    def at(J, eta_fn, x):
        with torch.no_grad():
            return float(J(x)), float(eta_fn(x))

    sub, J, eta_fn = rebuild()
    f_k, e_k = at(J, eta_fn, x_k)
    delta = float(delta0)
    n_steps = 0
    pred_tiny = 1e-14

    for it in range(max_steps):
        x_t, f_t, e_t, stat, boundary = sub(x_k, delta)
        f_t, e_t, stat = float(f_t), float(e_t), float(stat)
        pred = f_k - f_t
        moved = float(torch.linalg.vector_norm(x_t - x_k)) > 0.0
        entry = {"it": it, "J": f_t, "eta": e_t, "delta": delta, "pred": pred,
                 "basis_size": reductor.basis_size}

        if not moved or pred <= pred_tiny * max(abs(f_k), 1.0):
            if stat <= gtol and e_k <= tol:
                history.append(entry)
                logger.info("converged: J=%.6e bound=%.3e fom_solves=%d steps=%d",
                            f_k, e_k, n_fom, n_steps)
                return TrustRegionResult(
                    mu=space.parse(x_k), x=x_k, value=f_k, bound=e_k, converged=True,
                    n_fom_solves=n_fom, n_steps=n_steps, history=history,
                    stability_certified=_stability_certified(coercivity))
            # choked, or ROM-stationary with a loose certificate: enrich at
            # x_k, which collapses eta there, and retry
            enrich(space.parse(x_k))
            sub, J, eta_fn = rebuild()
            f_k, e_k = at(J, eta_fn, x_k)
            entry.update({"action": "enrich_at_iterate", "fom_solves": n_fom})
            history.append(entry)
            logger.info("it %d: choked/stationary-but-loose -> FOM solve #%d at iterate, "
                        "J=%.6e eta=%.2e", it, n_fom, f_k, e_k)
            if n_fom >= max_fom_solves:
                break
            continue

        certified_dec = (f_t + e_t) < (f_k - e_k)
        entry["certified_step"] = bool(certified_dec)
        if certified_dec:
            x_k, f_k, e_k = x_t, f_t, e_t
            n_steps += 1
            if bool(boundary):
                delta = min(2.0 * delta, 1e6)
            entry["action"] = "certified_accept"
            logger.info("it %d: certified step J=%.6e eta=%.2e delta=%.2e", it, f_k, e_k,
                        delta)
        else:
            # uncertified decrease: one FOM solve at the trial point judges
            # the step (rho) and enriches the basis
            f_true = enrich(space.parse(x_t))
            rho = (f_k - f_true) / pred
            accept = rho >= 0.1
            if accept:
                x_k = x_t
                n_steps += 1
                if rho >= 0.75 and bool(boundary):
                    delta = min(2.0 * delta, 1e6)
            else:
                delta = 0.5 * delta
            sub, J, eta_fn = rebuild()
            f_k, e_k = at(J, eta_fn, x_k)
            entry.update({"action": "fom_judged", "rho": rho, "accepted": bool(accept),
                          "fom_solves": n_fom})
            logger.info("it %d: FOM solve #%d rho=%.2f %s J=%.6e eta=%.2e delta=%.2e", it,
                        n_fom, rho, "accept" if accept else "reject", f_k, e_k, delta)
            if n_fom >= max_fom_solves:
                history.append(entry)
                break
        history.append(entry)

    return TrustRegionResult(mu=space.parse(x_k), x=x_k, value=f_k, bound=e_k,
                             converged=e_k <= tol, n_fom_solves=n_fom, n_steps=n_steps,
                             history=history,
                             stability_certified=_stability_certified(coercivity))
