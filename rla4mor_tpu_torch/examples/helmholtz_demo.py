"""Damped-Helmholtz demo: complex sketched RB, SCM-certified bounds and
complex state estimation.

The port's counterpart of ``examples/helmholtz_demo.py``, without the plot,
on ``helmholtz_fom(grid, (2, 8), damping 0.5)`` with the h1_0 product R:

1. a weak greedy over 40 training wavenumbers with the sketched minres
   reductor: a complex Gaussian embedding (k = 220) over the sqrt factor of
   R, online Gaussian sketches (k = 120) drawn anew each iteration,
   selection by the estimator, the true error at 12 test parameters
   tracked; the last ROM with r <= 5 is kept;
2. the successive constraint method for the inf-sup constant
   (``ScmInfSup``, fit over the training set to gap 0.2, up to 40
   anchors) and the certified bound residual / beta_LB against the true
   error and the estimate of the r <= 5 ROM at 41 wavenumbers;
3. PBDW (background: 8 R-orthonormalised states) and dictionary recovery
   (24 normalised states, the rotation-invariant complex LARS homotopy,
   selection by the residual manifold distance of a complex Gaussian sketch
   k = 96) of complex states from 30 point observations, at 9 wavenumbers.

Every FOM solve is a host ``splu`` in complex128; the sketches, ROMs,
bounds' online parts and the recovery run on ``device`` in ``dtype``
(default float64, so complex128: an inf-sup bound near a resonance is not
meaningful in complex64); the SCM's eigensolves run there in complex128.
``run`` returns the readings of each part with its seconds.

    python -m rla4mor_tpu_torch.examples.helmholtz_demo
    python -m rla4mor_tpu_torch.examples.helmholtz_demo --cpu --grid 12
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from rla4mor_tpu_torch.utils.config import as_tensor

K_PRIMAL, K_ONLINE, K_DIC = 220, 120, 96
SEED_PRIMAL, SEED_ONLINE, SEED_DIC = 2, 33, 11
WAVENUMBERS = (2.0, 8.0)
DAMPING = 0.5
N_TRAIN, N_TEST, N_BACKGROUND, N_DIC, M_OBS = 40, 12, 8, 24, 30
SWEEP = np.linspace(2.0, 8.0, 41)
RECOVERY = np.linspace(2.2, 7.8, 9)
R_MID = 5  # the bound panel's ROM: the last with r <= R_MID


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mu(w: float, device, dtype) -> dict:
    return {"wavenumber": torch.tensor([float(w)], device=device, dtype=dtype)}


def solve_all(fom, ws) -> torch.Tensor:
    """FOM solves (host ``splu``, complex128) at the wavenumbers ``ws``, in a
    pool of threads -> (n, len(ws)) on the FOM's device."""
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        cols = list(pool.map(lambda w: fom.solve_host(_mu(w, "cpu", torch.float64)), ws))
    return as_tensor(np.stack(cols, axis=1), fom.device, fom.dtype)


def weak_greedy(fom, reductor, train_w, test_w, extensions: int, u_test=None) -> dict:
    """The demo's weak greedy from the first training wavenumber: each
    iteration reduces with the online seed 100 + it, estimates the error at
    every training wavenumber (one batched call), tracks the true relative
    R-norm error at the test wavenumbers (their host solves made once) and
    extends with the worst-estimated wavenumber not yet taken (each is
    taken once: past the estimate's floor a re-pick would add a dependent
    column). ``u_test`` (n, len(test_w)) are the test states if the caller
    has them. Returns basis sizes ``r``, median test errors ``err`` and
    estimates ``est`` by iteration, the ``picks`` (training indices) and
    the last ROM with r <= ``R_MID`` with its basis (``rom_mid``,
    ``rb_mid``)."""
    from rla4mor_tpu_torch.core import mu_stack

    dev, dt = reductor.device, fom.dtype
    Ru = reductor.product
    train = mu_stack([_mu(w, dev, dt) for w in train_w])
    test_b = mu_stack([_mu(w, dev, dt) for w in test_w])
    if u_test is None:
        u_test = solve_all(fom, test_w)
    u_test = u_test.to(dev)
    nrm_test = Ru.norm(u_test)
    out = {"r": [], "err": [], "est": [], "picks": [0], "rom_mid": None, "rb_mid": None}
    reductor.extend_basis(fom.solve(_mu(train_w[0], "cpu", torch.float64)))
    for it in range(1, extensions + 1):
        rom = reductor.reduce(seed=100 + it)
        if reductor.basis_size <= R_MID:  # the last r <= R_MID ROM
            out["rom_mid"], out["rb_mid"] = rom, reductor.rb.clone()
        ests = rom.estimate_error(train).cpu().numpy()
        u_r = reductor.rb @ rom.solve(test_b).T.to(reductor.rb.dtype)
        rel = (Ru.norm(u_test - u_r) / nrm_test).cpu().numpy()
        out["r"].append(reductor.basis_size)
        out["err"].append(float(np.median(rel)))
        out["est"].append(float(np.median(rom.estimate_error(test_b).cpu().numpy())))
        for j in np.argsort(-ests, kind="stable"):  # the worst not yet picked
            if int(j) not in out["picks"]:
                out["picks"].append(int(j))
                reductor.extend_basis(fom.solve(_mu(train_w[j], "cpu", torch.float64)))
                break
    _sync(dev)
    return out


def run(grid: int = 48, extensions: int = 10, device=None, dtype=torch.float64,
        test: Optional[np.ndarray] = None, background: Optional[np.ndarray] = None,
        theta=None, phi=None, sketch=None, log: Callable[[str], None] = print) -> dict:
    """The demo at ``grid`` intervals with ``extensions`` greedy extensions
    on ``device`` (default: the current card) in ``dtype``.

    ``test`` (12) and ``background`` (8) wavenumbers default to the
    parameter space's draws (seeds 8 and 1). ``theta`` (the primal
    embedding), ``phi`` (the online one, redrawn by ``with_seed``) and
    ``sketch`` (the dictionary's residual sketch) default to the Gaussian
    embeddings above; a caller may pass others over the same spaces (the
    parity tests carry the JAX package's operators in).

    Returns ``{"n", "greedy", "scm", "sweep", "recovery"}``: the greedy's
    basis sizes ``r``, median test errors ``err`` and estimates ``est`` by
    iteration, the picked training indices ``picks`` and ``seconds``; the
    SCM fit's ``n_anchors``, ``max_gap`` (by iteration), anchor wavenumbers
    ``anchors`` and ``seconds``; the sweep's ``wavenumbers``, true errors
    ``err``, estimates ``est``, bounds ``bound``, lower bounds ``beta_lb``,
    the ROM's size ``r`` and ``seconds``; the recovery's relative errors
    ``pbdw`` and ``dic`` at :data:`RECOVERY` and ``seconds``."""
    from rla4mor_tpu_torch.core import (
        ChainOp, compose, gram_schmidt, materialize, mu_stack, project,
    )
    from rla4mor_tpu_torch.estim import (
        DicRecoveryMap, PbdwRecoveryMap, ResidualDistanceDiscrete,
    )
    from rla4mor_tpu_torch.models import helmholtz_fom
    from rla4mor_tpu_torch.mor import ScmInfSup, SketchedReductor, inf_sup_error_bound
    from rla4mor_tpu_torch.ops import GaussianEmbedding
    from rla4mor_tpu_torch.utils.config import resolve_device

    dev = resolve_device(device)
    fom = helmholtz_fom(grid, WAVENUMBERS, DAMPING, device=dev, dtype=dtype)
    Ru = fom.h1_0_product
    n = fom.solution_dim
    space = fom.parameter_space
    log(f"FOM {fom.name}: n = {n}, coefficient -k^2 + {DAMPING}ik, {dtype} on {dev}")
    if test is None:
        test = np.array([float(m["wavenumber"][0])
                         for m in space.sample_randomly(N_TEST, seed=8, device="cpu")])
    if background is None:
        background = np.array([float(m["wavenumber"][0]) for m in space.sample_randomly(
            N_BACKGROUND, seed=1, device="cpu")])
    if theta is None:
        theta = GaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=K_PRIMAL,
                                       seed=SEED_PRIMAL, complex_dtype=True, device=dev,
                                       dtype=dtype)
    if phi is None:
        phi = GaussianEmbedding.make(K_PRIMAL, range_dim=K_ONLINE, seed=SEED_ONLINE,
                                     device=dev, dtype=dtype)
    if sketch is None:
        sketch = GaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=K_DIC,
                                        seed=SEED_DIC, complex_dtype=True, device=dev,
                                        dtype=dtype)

    # -- 1. weak greedy: estimator-driven, true error tracked -------------
    t0 = time.perf_counter()
    red = SketchedReductor(fom, embedding_primal=theta, embedding_online=phi, product=Ru,
                           orthonormalize=True, projection="minres", log_level=30)
    train_w = np.linspace(*WAVENUMBERS, N_TRAIN)
    greedy = weak_greedy(fom, red, train_w, test, extensions)
    rom_mid, rb_mid = greedy.pop("rom_mid"), greedy.pop("rb_mid")
    greedy["seconds"] = time.perf_counter() - t0
    log(f"greedy: r = {red.basis_size}, median rel err {greedy['err'][-1]:.2e} "
        f"({greedy['seconds']:.1f} s)")

    # -- 2. SCM-certified bounds over the wavenumber sweep ----------------
    t0 = time.perf_counter()
    scm = ScmInfSup(fom, product=Ru)
    fit = scm.fit([_mu(w, "cpu", torch.float64) for w in train_w], tol=0.2,
                  max_anchors=N_TRAIN)
    scm_s = time.perf_counter() - t0
    log(f"SCM: {fit['n_anchors']} anchors, final gap {fit['max_gap'][-1]:.3f} "
        f"({scm_s:.1f} s)")
    t0 = time.perf_counter()
    u_sweep = solve_all(fom, SWEEP).to(dev)
    sweep_b = mu_stack([_mu(w, dev, dtype) for w in SWEEP])
    y = rom_mid.solve(sweep_b)                                          # (41, r)
    sweep_err = Ru.norm(u_sweep - rb_mid @ y.T.to(rb_mid.dtype)).cpu().numpy()
    sweep_norm = Ru.norm(u_sweep).cpu().numpy()
    sweep_est = rom_mid.estimate_error(sweep_b, y).cpu().numpy()
    sweep_bnd, beta_lb = [], []
    for i, w in enumerate(SWEEP):
        mu = _mu(w, dev, dtype)
        sweep_bnd.append(float(inf_sup_error_bound(rom_mid, mu, scm, u_r=y[i])))
        beta_lb.append(scm.lower(mu))
    _sync(dev)
    sweep_s = time.perf_counter() - t0

    # -- 3. complex state estimation from pointwise observations ----------
    t0 = time.perf_counter()
    rows = np.random.RandomState(7).choice(n, size=min(M_OBS, n), replace=False)
    Wd = np.zeros((n, rows.size))
    Wd[rows, np.arange(rows.size)] = 1.0
    W = gram_schmidt(as_tensor(Ru.inv.apply_host(Wd), dev, dtype), product=Ru)
    V = gram_schmidt(solve_all(fom, background).to(dev), product=Ru)
    pbdw = PbdwRecoveryMap(V, W, product=Ru, log_level=30)
    dic_w = np.linspace(*WAVENUMBERS, N_DIC)
    u_dic = solve_all(fom, dic_w).to(dev)
    V_dic = u_dic / Ru.norm(u_dic)[None, :]
    chain = ChainOp((sketch, Ru.inv))
    X = torch.cat([V_dic, W.to(V_dic.dtype)], dim=1)
    mdist = ResidualDistanceDiscrete(project(compose(chain, fom.operator), None, X),
                                     materialize(compose(chain, fom.rhs)),
                                     [_mu(w, dev, dtype) for w in dic_w])
    dic = DicRecoveryMap(V_dic, W, product=Ru, manifold_distance=mdist, log_level=30)
    u_t = solve_all(fom, RECOVERY).to(dev)
    obs = Ru.inner(W, u_t)                                              # (m, 9)
    nt = Ru.norm(u_t)
    rel_pbdw = (Ru.norm(u_t - pbdw.solve(obs)) / nt).cpu().numpy()
    rel_dic = (Ru.norm(u_t - dic.solve(obs)) / nt).cpu().numpy()
    _sync(dev)
    recovery_s = time.perf_counter() - t0
    log(f"recovery: median rel err PBDW {np.median(rel_pbdw):.2e}, dictionary "
        f"{np.median(rel_dic):.2e} ({recovery_s:.1f} s)")

    return {
        "n": n,
        "greedy": greedy,
        "scm": {"n_anchors": fit["n_anchors"], "max_gap": fit["max_gap"],
                "anchors": [float(m["wavenumber"][0]) for m in scm.scm.anchor_mus],
                "seconds": scm_s},
        "sweep": {"wavenumbers": SWEEP, "err": sweep_err, "norm": sweep_norm, "est": sweep_est,
                  "bound": np.array(sweep_bnd), "beta_lb": np.array(beta_lb),
                  "r": rb_mid.shape[1], "seconds": sweep_s},
        "recovery": {"pbdw": rel_pbdw, "dic": rel_dic, "seconds": recovery_s},
    }


def certified(sweep: dict) -> np.ndarray:
    """The sweep points where the bound can be held to the true error: a
    finite bound, and an error above the float64 floor (1e-12 of the
    state's norm; at a wavenumber in the basis both are rounding)."""
    return np.isfinite(sweep["bound"]) & (sweep["err"] > 1e-12 * sweep["norm"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--extensions", type=int, default=10)
    args = ap.parse_args(argv)
    out = run(args.grid, args.extensions, device="cpu" if args.cpu else None)
    sw = out["sweep"]
    held = certified(sw)
    print(f"bound >= error at {int((sw['bound'][held] >= sw['err'][held]).sum())} "
          f"of {int(held.sum())} sweep points (r = {sw['r']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
