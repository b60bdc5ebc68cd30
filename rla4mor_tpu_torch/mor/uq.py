"""Certified uncertainty quantification over the parameter box.

Counterpart of ``rla4mor_tpu/mor/uq.py``: statistics of the output
``s(mu)`` under the uniform distribution on the parameter box, from the
certified reduced model.

* Every sample is a reduced solve, an output and a certificate, evaluated
  for a whole batch of parameters in one call (the ROMs' batched solve and
  estimate, as ``serve.py`` serves them).
* The ROM-vs-FOM bias is bounded rigorously up to the sketch's distortion
  (``reductor=`` cross-validates the online sketch first, through
  ``SketchedReductor.reduce_adaptive``) by the per-sample output certificate
  ``eta_s(mu) = ||l(mu)||_{R^-1} eta(mu) / alpha_LB(mu)``
  (:func:`~rla4mor_tpu_torch.mor.optimize.output_error_bound`):

  - mean:      |E s_fom - E s_rom|  <=  E eta_s,
  - variance:  |V s_fom - V s_rom|  <=  E[eta_s^2] + 2 sqrt(E[eta_s^2] V s_rom),
  - exceedance P[s_fom > c]: samples with s_rom - eta_s > c certainly
    exceed, samples with s_rom + eta_s <= c certainly do not: a
    deterministic bracket [p_lo, p_hi] up to sampling error only.

* Sampling is plain Monte Carlo (``method='mc'``: sample i of a key is drawn
  from the Philox4x32-10 block of its global index, so batching never
  changes it) or scrambled Halton QMC (``method='halton'``: scipy's
  sequence under the integer key, the JAX package's points exactly).

Sampling noise is reported apart from the deterministic bias bounds; with an
a-priori ``output_range`` an empirical-Bernstein term at level 1 - delta
gives a total interval for E s_fom (Maurer & Pontil 2009), and randomised
QMC replicates give the same for Halton.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from rla4mor_tpu_torch.core.parameters import Mu, ParameterSpace
from rla4mor_tpu_torch.mor.optimize import _stability_certified, rom_device_dtype
from rla4mor_tpu_torch.ops.philox import MASK32, philox4x32
from rla4mor_tpu_torch.utils.config import default_dtype, resolve_device

# Philox counter word 2 of each draw: the parameter samples, the Saltelli
# design's point set
_STREAM_SAMPLES, _STREAM_SALTELLI = 0, 1


def _seed(key) -> int:
    """An integer seed: ``key`` itself, or one drawn from a CPU generator."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=key))
    return int(key)


def _uniform(seed: int, index: torch.Tensor, d: int, stream: int) -> torch.Tensor:
    """(len(index), d) float64 uniforms in [0, 1): entry (i, j) takes 53 bits
    of the Philox4x32-10 block of counter (index_i mod 2^32, j, stream,
    index_i div 2^32) under the key (seed mod 2^32, seed div 2^32 mod 2^32)."""
    i = index.to(torch.int64)[:, None]
    j = torch.arange(d, dtype=torch.int64)[None, :]
    seed &= (1 << 64) - 1
    w0, w1, _, _ = philox4x32((i & MASK32, j, stream, i >> 32),
                              (seed & MASK32, (seed >> 32) & MASK32))
    bits = ((w0 >> 5) << 26) | (w1 >> 6)
    return bits.to(torch.float64) * 2.0 ** -53


def _halton(seed: int, d: int, n: int, offset: int = 0) -> np.ndarray:
    from scipy.stats import qmc

    h = qmc.Halton(d=d, scramble=True, seed=seed)
    if offset:
        h.fast_forward(offset)
    return h.random(n)


# ---------------------------------------------------------------------------
# Batched sampling of the parameter box
# ---------------------------------------------------------------------------


def sample_mu_batched(space: ParameterSpace, n: int, key: int | torch.Generator = 0,
                      method: str = "mc", offset: int = 0, device=None,
                      dtype=None) -> Mu:
    """A batched Mu (each leaf (n, size)) of box samples, on ``device`` in
    ``dtype`` (default: the current card in its working dtype).

    ``method='mc'``: iid uniform; sample ``offset + i`` depends on the key and
    that global index only, so streaming in batches reproduces the one-shot
    draw. ``method='halton'``: scrambled Halton points (scipy.stats.qmc
    seeded by the integer key); ``offset`` skips the first points of the same
    sequence, so batches over one sequence stay one QMC point set."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    seed, d = _seed(key), space.dim()
    if method == "mc":
        u = _uniform(seed, torch.arange(offset, offset + n), d, _STREAM_SAMPLES)
        x = space.low + (space.high - space.low) * u
    elif method == "halton":
        x = torch.as_tensor(space.low + (space.high - space.low)
                            * _halton(seed, d, n, offset))
    else:
        raise ValueError(f"method must be 'mc' or 'halton': {method!r}")
    return space.parse(x.to(dev, dt))


# ---------------------------------------------------------------------------
# Certified moments
# ---------------------------------------------------------------------------


@dataclass
class UqResult:
    mean: float              # MC / QMC estimate of E s_rom
    std: float               # sqrt of the (unbiased) sample variance
    mc_stderr: float         # sampling std error of `mean`; NaN for QMC
    bias_bound: float        # certified |E s_fom - E s_rom| bound
    var_bias_bound: float    # certified |V s_fom - V s_rom| bound
    mean_eta: float          # E eta_s (the certificate's own average)
    n: int
    method: str
    sketch_info: dict | None = None   # reduce_adaptive's report when a
                                      # reductor was passed
    stability_certified: bool = True  # the stability constant's own offline
                                      # defenses (the matrix-free SCM's
                                      # restart agreement); True for plain
                                      # callables
    conf_term: float = float("nan")   # 1 - delta empirical-Bernstein bound on
                                      # |E s_rom - mean|; NaN when not
                                      # computable (no output_range, or
                                      # unreplicated QMC)
    delta: float = float("nan")
    total_lo: float = float("nan")    # mean -+ (bias_bound + conf_term):
    total_hi: float = float("nan")    # E s_fom inside w.p. >= 1 - delta
    replicate_stderr: float = float("nan")  # RQMC: std error over the
                                            # replicate means


def _maybe_refresh_sketch(rom, reductor, space, key, sketch_tol: float,
                          sketch_samples: int):
    """``reduce_adaptive`` over ``sketch_samples`` draws, so that the
    certificates' own sketch is cross-validated before anything trusts them.
    Returns ``(rom, info)``: the refreshed ROM replaces the caller's when a
    reductor is given; ``info['certified']`` is the verdict."""
    if reductor is None:
        return rom, None
    dev, dt = rom_device_dtype(rom)
    mus = sample_mu_batched(space, sketch_samples, key=key, method="mc",
                            offset=1_000_003, device=dev, dtype=dt)
    return reductor.reduce_adaptive(mus, tol=sketch_tol)


def _batched_output_and_bound(rom, coercivity, dual_norm, component: int):
    """``mus -> (s, eta_s)`` over a batched Mu, in one batched call.
    Dispatch:

    * a goal-oriented parabolic composite (``output_corrected``): ``s = Re
      s_c`` and ``eta_s = eta_pr eta_du / alpha``
      (:func:`~rla4mor_tpu_torch.mor.bounds.parabolic_output_error_bound`,
      implicit Euler; pass ``dual_norm=None``);
    * a hyperreduced semilinear ROM (``n_deim``): ``||l|| eta / alpha`` with
      the linear family's alpha_LB (the monotone bound; R = l2, so an l2
      :class:`~rla4mor_tpu_torch.mor.optimize.ConstantDualNorm`);
    * a stationary ROM: ``s = Re output[component]``, ``eta_s = ||l|| eta /
      alpha``."""
    def component_of(out, batch):
        return torch.real(out.reshape(*batch, -1)[..., component])

    if hasattr(rom, "output_corrected"):
        from rla4mor_tpu_torch.mor.bounds import parabolic_output_error_bound

        def run(mus):
            s_c, eta_s = parabolic_output_error_bound(rom, mus, coercivity)
            return torch.real(s_c), eta_s
    elif hasattr(rom, "n_deim"):
        def run(mus):
            a = rom.solve(mus)
            s = component_of(rom.output(a, mus), a.shape[:-1])
            eta = rom.estimate_error(mus, a)
            return s, dual_norm(mus) * eta / torch.as_tensor(coercivity(mus)).to(eta)
    else:
        def run(mus):
            u = rom.solve(mus)
            s = component_of(rom.output(u, mus), u.shape[:-1])
            eta = rom.error_estimator.estimate_error(u, mus)
            return s, dual_norm(mus) * eta / torch.as_tensor(coercivity(mus)).to(eta)

    def host(mus):
        with torch.no_grad():
            s, eta = run(mus)
        return (s.to(torch.float64).cpu().numpy(), eta.to(torch.float64).cpu().numpy())

    return host


def _empirical_bernstein(var: float, n: int, width: float, delta: float) -> float:
    """Two-sided empirical-Bernstein deviation bound (Maurer & Pontil 2009,
    Thm 4 with delta/2 a side): with probability >= 1 - delta, ``|E Y -
    mean(Y_1..Y_n)| <= sqrt(2 V_n ln(4/delta) / n) + 7 width ln(4/delta) /
    (3 (n-1))`` for iid Y_i in an interval of length ``width``."""
    if n < 2:
        return float("inf")
    L = math.log(4.0 / delta)
    return math.sqrt(2.0 * max(var, 0.0) * L / n) + 7.0 * width * L / (3.0 * (n - 1))


def _replicate_seed(seed: int, j: int) -> int:
    """Replicate j's Halton seed under ``seed`` (the port's own derivation)."""
    return int(np.random.SeedSequence([seed & (2 ** 64 - 1), 7919 + j]).generate_state(1)[0])


def certified_moments(
    rom,
    space: ParameterSpace,
    coercivity,
    dual_norm,
    n: int = 4096,
    key: int | torch.Generator = 0,
    method: str = "mc",
    component: int = 0,
    batch: int = 4096,
    reductor=None,
    sketch_tol: float = 0.2,
    sketch_samples: int = 32,
    delta: float = 0.05,
    output_range: tuple[float, float] | None = None,
    replicates: int = 1,
) -> UqResult:
    """Mean and variance of the output over the box with the certified ROM
    bias. Samples stream in batches of ``batch`` on the ROM's device, so
    ``n`` is bounded by time, not memory; the sums are float64 on the host.

    ``dual_norm`` is the :class:`~rla4mor_tpu_torch.mor.optimize.OutputDualNorm`
    on the product R that the ROM's residual estimator sketches in.
    ``reductor=``: cross-validate (and if needed refresh) the online sketch
    first; the verdict lands in ``sketch_info``. A parabolic composite
    (``InstationaryCorrectedOutputROM``, implicit Euler) goes in as ``rom``
    with ``dual_norm=None``: every sample is a reduced primal and dual time
    loop, certified by ``eta_pr eta_du / alpha``.

    ``output_range=(lo, hi)``, an a-priori bound of the ROM output over the
    box, adds a distribution-free empirical-Bernstein term at level 1 -
    delta: ``[total_lo, total_hi]`` holds E s_fom with probability >= 1 -
    delta. Samples outside the declared range raise. ``method='halton'``
    needs ``replicates >= 2`` (independently scrambled sequences, whose
    means are iid) for that term; unreplicated QMC keeps the explicit NaN."""
    seed = _seed(key)
    rom, sketch_info = _maybe_refresh_sketch(rom, reductor, space, seed, sketch_tol,
                                             sketch_samples)
    run = _batched_output_and_bound(rom, coercivity, dual_norm, component)
    dev, dt = rom_device_dtype(rom)

    if method == "halton" and replicates > 1:
        n_rep = max(n // replicates, 1)
        plan = [(_replicate_seed(seed, j), n_rep) for j in range(replicates)]
    else:
        plan = [(seed, n)]
        replicates = 1

    tot = 0
    s_sum = s_sq = e_sum = e_sq = 0.0
    s_min, s_max = math.inf, -math.inf
    rep_means = []
    for rep_seed, n_j in plan:
        done = 0
        rep_sum = 0.0
        while done < n_j:
            b = min(batch, n_j - done)
            mus = sample_mu_batched(space, b, key=rep_seed, method=method, offset=done,
                                    device=dev, dtype=dt)
            s, eta = run(mus)
            rep_sum += float(s.sum())
            s_sq += float((s * s).sum())
            e_sum += float(eta.sum())
            e_sq += float((eta * eta).sum())
            s_min = min(s_min, float(s.min()))
            s_max = max(s_max, float(s.max()))
            done += b
        s_sum += rep_sum
        rep_means.append(rep_sum / n_j)
        tot += n_j

    mean = s_sum / tot
    var = max(s_sq / tot - mean * mean, 0.0) * (tot / max(tot - 1, 1))
    mean_eta = e_sum / tot
    mean_eta2 = e_sq / tot
    var_bias = mean_eta2 + 2.0 * math.sqrt(mean_eta2 * var)

    conf = float("nan")
    rep_stderr = float("nan")
    if output_range is not None:
        lo, hi = float(output_range[0]), float(output_range[1])
        tol = 1e-12 * max(abs(lo), abs(hi), 1.0)
        if s_min < lo - tol or s_max > hi + tol:
            raise ValueError(
                f"certified_moments: sampled ROM outputs [{s_min:.6g}, {s_max:.6g}] "
                f"violate the declared output_range [{lo:.6g}, {hi:.6g}]: the "
                "distribution-free bound would be invalid")
        if method == "mc":
            conf = _empirical_bernstein(var, tot, hi - lo, delta)
        elif replicates > 1:
            conf = _empirical_bernstein(float(np.var(rep_means, ddof=1)), replicates,
                                        hi - lo, delta)
    if replicates > 1:
        rep_stderr = float(np.std(rep_means, ddof=1) / math.sqrt(replicates))

    total_err = mean_eta + conf  # NaN when conf is
    return UqResult(
        mean=mean, std=math.sqrt(var),
        mc_stderr=math.sqrt(var / tot) if method == "mc" else float("nan"),
        bias_bound=mean_eta, var_bias_bound=var_bias, mean_eta=mean_eta, n=tot,
        method=method, sketch_info=sketch_info,
        stability_certified=_stability_certified(coercivity), conf_term=conf,
        delta=delta, total_lo=mean - total_err, total_hi=mean + total_err,
        replicate_stderr=rep_stderr)


# ---------------------------------------------------------------------------
# Variance-based global sensitivity (Sobol indices)
# ---------------------------------------------------------------------------


@dataclass
class SobolResult:
    first: np.ndarray     # (d,) first-order indices S_i
    total: np.ndarray     # (d,) total-effect indices T_i
    variance: float       # sample variance of the output
    n: int                # base sample count (total evals = n (d + 2))
    names: tuple          # flat-coordinate labels, e.g. ('diffusion[0]', ...)


def _names(space: ParameterSpace) -> tuple:
    return tuple(f"{name}[{j}]" for name, size in space.shapes for j in range(size))


def _pick_freeze_points(space: ParameterSpace, n: int, key, method: str):
    """The (A, B) pair of the Saltelli design, float64 numpy (n, d) each: one
    2d-dimensional uniform point set split into two d-dimensional halves
    (two chunks of one d-dimensional Halton sequence are correlated and bias
    the pick-freeze estimators)."""
    d, seed = space.dim(), _seed(key)
    if method == "mc":
        u = _uniform(seed, torch.arange(n), 2 * d, _STREAM_SALTELLI).numpy()
    elif method == "halton":
        u = _halton(seed, 2 * d, n)
    else:
        raise ValueError(f"method must be 'mc' or 'halton': {method!r}")
    x = space.low + (space.high - space.low) * u
    return x[:, :d], x[:, d:]


def _swap_column(A: np.ndarray, B: np.ndarray, i: int) -> np.ndarray:
    ABi = A.copy()
    ABi[:, i] = B[:, i]
    return ABi


def sobol_indices(J, space: ParameterSpace, n: int = 2048, key: int | torch.Generator = 0,
                  method: str = "halton", batch: int = 4096, device=None,
                  dtype=None) -> SobolResult:
    """First-order and total Sobol indices of ``J`` under uniform mu.

    Saltelli pick-freeze design with the Saltelli-2010 first-order and Jansen
    total-effect estimators: two independent point sets A, B and the d
    column-swapped hybrids, ``n (d + 2)`` evaluations of the batched ``J``
    (rows (b, d) -> (b,); build it with
    :func:`~rla4mor_tpu_torch.mor.optimize.make_objective`) in batches of
    ``batch`` on ``device`` in ``dtype``. Indices are per flat coordinate.
    They inherit the ROM's output error: trust them where the output
    certificate is small against ``sqrt(variance)``
    (:func:`certified_sobol_indices` brackets them)."""
    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    d = space.dim()
    A, B = _pick_freeze_points(space, n, key, method)

    def run(X):
        outs = []
        with torch.no_grad():
            for i in range(0, X.shape[0], batch):
                f = J(torch.as_tensor(X[i:i + batch]).to(dev, dt))
                outs.append(f.to(torch.float64).cpu().numpy())
        return np.concatenate(outs)

    fA = run(A)
    fB = run(B)
    center = 0.5 * (fA.mean() + fB.mean())
    fA_c = fA - center
    fB_c = fB - center
    var = float(np.concatenate([fA_c, fB_c]).var())
    scale = float(np.max(np.abs(np.concatenate([fA_c, fB_c]))) or 1.0)
    if var <= (1e-14 * scale) ** 2:
        # (near-)constant output: every index is 0/0; zeros with the variance
        # say why
        return SobolResult(first=np.zeros(d), total=np.zeros(d), variance=var, n=n,
                           names=_names(space))
    first = np.zeros(d)
    total = np.zeros(d)
    for i in range(d):
        fABi = run(_swap_column(A, B, i)) - center
        first[i] = float(np.mean(fB_c * (fABi - fA_c))) / var          # Saltelli 2010
        total[i] = 0.5 * float(np.mean((fA_c - fABi) ** 2)) / var      # Jansen 1999
    return SobolResult(first=first, total=total, variance=var, n=n, names=_names(space))


# ---------------------------------------------------------------------------
# Certified Sobol indices: interval-valued estimators
# ---------------------------------------------------------------------------


@dataclass
class CertifiedSobolResult:
    first: np.ndarray        # (d,) nominal S_i (ROM point estimate)
    total: np.ndarray        # (d,) nominal T_i
    first_lo: np.ndarray     # certified brackets: the same-design estimator
    first_hi: np.ndarray     # on FOM outputs lies inside
    total_lo: np.ndarray
    total_hi: np.ndarray
    variance: float          # nominal output variance (fixed centre)
    var_lo: float            # certified variance bracket
    var_hi: float
    n: int
    names: tuple
    certified: bool          # False when var_lo <= 0 (brackets vacuous)
    center: float = 0.0      # the fixed centring constant (part of the
                             # estimator: a FOM-side reference uses it too)
    sketch_info: dict | None = None
    stability_certified: bool = True  # see UqResult


def certified_sobol_indices(
    rom,
    space: ParameterSpace,
    coercivity,
    dual_norm,
    n: int = 2048,
    key: int | torch.Generator = 0,
    method: str = "halton",
    component: int = 0,
    batch: int = 4096,
    reductor=None,
    sketch_tol: float = 0.2,
    sketch_samples: int = 32,
) -> CertifiedSobolResult:
    """Sobol indices with certified interval brackets.

    Each pick-freeze evaluation carries ``|s_fom(x) - s_rom(x)| <=
    eta_s(x)``; the per-sample intervals go through the Saltelli-2010 and
    Jansen estimators (products and squares of intervals, then one interval
    division by the bracketed variance), so ``[S_i_lo, S_i_hi]`` and
    ``[T_i_lo, T_i_hi]`` contain the same estimators on FOM outputs. The
    estimators use a fixed centring constant (the ROM's A/B mean) and the
    uncentred variance form, so the FOM-side estimator is well defined.
    ``reductor=``: as in :func:`certified_moments`."""
    seed = _seed(key)
    rom, sketch_info = _maybe_refresh_sketch(rom, reductor, space, seed, sketch_tol,
                                             sketch_samples)
    d = space.dim()
    A, B = _pick_freeze_points(space, n, seed, method)
    run_se = _batched_output_and_bound(rom, coercivity, dual_norm, component)
    dev, dt = rom_device_dtype(rom)

    def run(X):
        ss, ee = [], []
        for i in range(0, X.shape[0], batch):
            s, e = run_se(space.parse(torch.as_tensor(X[i:i + batch]).to(dev, dt)))
            ss.append(s)
            ee.append(e)
        return np.concatenate(ss), np.concatenate(ee)

    fA, eA = run(A)
    fB, eB = run(B)
    c = 0.5 * (fA.mean() + fB.mean())
    gA, gB = fA - c, fB - c
    g_all = np.concatenate([gA, gB])
    e_all = np.concatenate([eA, eB])

    # variance bracket: V = mean(g^2) - mean(g)^2 over [A; B]
    q_lo = float(np.mean(np.maximum(np.abs(g_all) - e_all, 0.0) ** 2))
    q_hi = float(np.mean((np.abs(g_all) + e_all) ** 2))
    q_nom = float(np.mean(g_all ** 2))
    m_nom = float(np.mean(g_all))
    m_lo = m_nom - float(np.mean(e_all))
    m_hi = m_nom + float(np.mean(e_all))
    msq_hi = max(m_lo ** 2, m_hi ** 2)
    msq_lo = 0.0 if m_lo <= 0.0 <= m_hi else min(m_lo ** 2, m_hi ** 2)
    var = q_nom - m_nom ** 2
    var_lo = q_lo - msq_hi
    var_hi = q_hi - msq_lo

    first, total = np.zeros(d), np.zeros(d)
    n_lo, n_hi = np.zeros(d), np.zeros(d)
    t_lo, t_hi = np.zeros(d), np.zeros(d)
    for i in range(d):
        fABi, eABi = run(_swap_column(A, B, i))
        gABi = fABi - c
        # Saltelli numerator N_i = mean(gB (gABi - gA)); the FOM side's
        # per-sample error: |gB||dABi - dA| + |gABi - gA||dB| + |dB||dABi - dA|
        diff = gABi - gA
        ed = eABi + eA
        nom = gB * diff
        err = np.abs(gB) * ed + np.abs(diff) * eB + eB * ed
        first[i] = float(np.mean(nom))
        n_lo[i] = float(np.mean(nom - err))
        n_hi[i] = float(np.mean(nom + err))
        # Jansen total numerator VT_i = mean((gA - gABi)^2) / 2
        u = gA - gABi
        u_lo = np.maximum(np.abs(u) - ed, 0.0)
        u_hi = np.abs(u) + ed
        total[i] = 0.5 * float(np.mean(u ** 2))
        t_lo[i] = 0.5 * float(np.mean(u_lo ** 2))
        t_hi[i] = 0.5 * float(np.mean(u_hi ** 2))

    certified = var_lo > 0.0
    if certified:
        def div(lo, hi):
            # interval division by [var_lo, var_hi], var_lo > 0
            cand = np.stack([lo / var_lo, lo / var_hi, hi / var_lo, hi / var_hi])
            return cand.min(axis=0), cand.max(axis=0)

        S_lo, S_hi = div(n_lo, n_hi)
        T_lo, T_hi = div(t_lo, t_hi)
    else:
        S_lo = T_lo = np.full(d, -np.inf)
        S_hi = T_hi = np.full(d, np.inf)
    scale = var if var > 0 else 1.0
    return CertifiedSobolResult(
        first=first / scale, total=total / scale, first_lo=S_lo, first_hi=S_hi,
        total_lo=T_lo, total_hi=T_hi, variance=var, var_lo=var_lo, var_hi=var_hi,
        n=n, names=_names(space), certified=certified, center=float(c),
        sketch_info=sketch_info, stability_certified=_stability_certified(coercivity))


# ---------------------------------------------------------------------------
# Certified exceedance probability
# ---------------------------------------------------------------------------


@dataclass
class ExceedanceResult:
    p_lo: float         # fraction certainly above the threshold
    p_hi: float         # fraction possibly above (1 - certainly below)
    p_nominal: float    # plain ROM estimate P[s_rom > c]
    mc_stderr: float    # sampling std error of the nominal estimate
    n: int
    threshold: float
    sketch_info: dict | None = None
    stability_certified: bool = True  # see UqResult
    conf_term: float = float("nan")   # sqrt(ln(4/delta) / (2n)) a side (MC);
                                      # NaN for unreplicated QMC
    delta: float = float("nan")
    p_lo_total: float = float("nan")  # [p_lo - conf, p_hi + conf] clipped to
    p_hi_total: float = float("nan")  # [0, 1]: holds P[s_fom > c] w.p. >= 1 - delta


def exceedance_probability(
    rom,
    space: ParameterSpace,
    coercivity,
    dual_norm,
    threshold: float,
    n: int = 4096,
    key: int | torch.Generator = 0,
    method: str = "mc",
    component: int = 0,
    batch: int = 4096,
    reductor=None,
    sketch_tol: float = 0.2,
    sketch_samples: int = 32,
    delta: float = 0.05,
) -> ExceedanceResult:
    """Certified bracket for ``P[s_fom(mu) > threshold]``.

    ``p_lo <= P <= p_hi`` holds deterministically for the sampled empirical
    measure (the certificates decide each sample); ``p_hi - p_lo`` is the
    fraction whose certificate straddles the threshold, which shrinks as the
    basis is enriched, whatever n. For iid MC a Hoeffding term at level 1 -
    delta extends it to the true probability (``p_lo_total``,
    ``p_hi_total``); unreplicated QMC keeps the explicit NaN. ``reductor=``
    and the parabolic composition as in :func:`certified_moments`."""
    seed = _seed(key)
    rom, sketch_info = _maybe_refresh_sketch(rom, reductor, space, seed, sketch_tol,
                                             sketch_samples)
    run = _batched_output_and_bound(rom, coercivity, dual_norm, component)
    dev, dt = rom_device_dtype(rom)
    tot = n_sure = n_maybe = n_nom = 0
    while tot < n:
        b = min(batch, n - tot)
        mus = sample_mu_batched(space, b, key=seed, method=method, offset=tot,
                                device=dev, dtype=dt)
        s, eta = run(mus)
        n_sure += int((s - eta > threshold).sum())
        n_maybe += int((s + eta > threshold).sum())
        n_nom += int((s > threshold).sum())
        tot += b
    p_nom, p_lo, p_hi = n_nom / tot, n_sure / tot, n_maybe / tot
    # Hoeffding, one-sided at delta/2 each
    conf = math.sqrt(math.log(4.0 / delta) / (2.0 * tot)) if method == "mc" else float("nan")
    finite = math.isfinite(conf)
    return ExceedanceResult(
        p_lo=p_lo, p_hi=p_hi, p_nominal=p_nom,
        mc_stderr=(math.sqrt(max(p_nom * (1 - p_nom), 0.0) / tot) if method == "mc"
                   else float("nan")),
        n=tot, threshold=threshold, sketch_info=sketch_info,
        stability_certified=_stability_certified(coercivity), conf_term=conf, delta=delta,
        p_lo_total=max(p_lo - conf, 0.0) if finite else float("nan"),
        p_hi_total=min(p_hi + conf, 1.0) if finite else float("nan"))
