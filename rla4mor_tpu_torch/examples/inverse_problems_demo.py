"""PBDW and dictionary recovery of thermal-block states from pointwise
observations.

The port's counterpart of ``examples/inverse_problems_demo.py``, without
the plots: ``ThermalBlockFOM((3, 3), grid)`` with the h1_0 product R,

* m = 50 pointwise observations at random nodes, Riesz-lifted (R^-1) and
  R-orthonormalised into W;
* a POD background of 20 modes from 200 training snapshots, and the mean
  PBDW error of the test states against background dimension;
* dictionary recovery: the 200 R-normalised snapshots as atoms,
  ``ResidualDistanceAffine`` on the residual sketch ``S R^-1 (A(mu) X -
  b(mu))`` of the columns X = [atoms, W] (k = 256), the LARS path of every
  test column and the path point nearest the manifold;
* the path study of the worst test state: the recovery error and the
  manifold distance at every path point.

What does not depend on the embedding or the run's dtype is computed once,
by :func:`prepare`, and shared by every embedding asked for (``embeddings``)
and by a run at another dtype (``prepared=``): the FOM solves (training,
test, the Riesz lift of W; host ``splu`` in a pool of threads), the host part
of the residual sketch (Q R^-1 A_q X of each affine term: the JAX demo's
chain ``ChainOp((S, R^-1))`` up to the l2 sketch, Q the sqrt factor every
embedding is taken over), and the LARS paths of the test columns (the
cross-gramian's, not the sketch's). Each embedding then sketches those
terms (one l2 sketch of the 250 columns a term, in the run's dtype) and
selects each column's path point by its own manifold distance.

The dictionary recovery (its bases, LARS, OLS debias, corrections and
manifold distances) runs in float64 (``RECOVERY_DTYPE``) on the host's
float64 states, whatever the run's dtype; PBDW and the sketches run in the
run's dtype. The homotopy is ill-conditioned (the cross-gramian's spectrum
spans 2e7): in float32 its pseudo-inverses keep only singular values above
about 1e-3 of the largest and its paths stop 2-3x earlier, and the
recovery errors were 1.8-7.4x float64's, 0.68-1.65x with float64
arithmetic on the float32-rounded states (grid 64 on the CPU,
``probes/estim_precision_probe.py``). ``run`` returns the readings.

    python -m rla4mor_tpu_torch.examples.inverse_problems_demo
    python -m rla4mor_tpu_torch.examples.inverse_problems_demo --cpu --grid 18
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Mapping, Optional

import numpy as np
import torch

M_OBS, N_TRAIN, N_MODES, K_SKETCH, SEED_SKETCH, PG_ITERS = 50, 200, 20, 256, 3, 500
RECOVERY_DTYPE = torch.float64


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1)))


def embedding_makers() -> dict:
    """The residual sketches ``run`` takes by name: each is
    ``make(n, sqrt_product=..., range_dim=..., seed=..., device=..., dtype=...)``."""
    from rla4mor_tpu_torch.ops import GaussianEmbedding, HwPrngGaussianEmbedding, SrhtEmbedding

    return {"gaussian": GaussianEmbedding.make, "srht": SrhtEmbedding.make,
            "hwprng": HwPrngGaussianEmbedding.make}


@dataclass
class Prepared:
    """What a run computes once: the host float64 states (``u_train``,
    ``u_test``, columns) at the parameters ``train`` / ``test`` (rows), the
    Riesz lift ``lift`` of the point evaluations, and the dictionary
    recovery's float64 part on the device: the product ``Ru``, atoms ``V``,
    observation basis ``W``, test states ``u_test_r`` and observations
    ``obs``, the map ``rm`` (no manifold distance), the residual terms
    ``residual`` (:func:`residual_terms`), the LARS ``paths`` and ``steps``
    of the test columns, and the ``seconds`` of the FOM solves, the
    residual terms and the LARS paths."""

    train: np.ndarray
    test: np.ndarray
    u_train: np.ndarray
    u_test: np.ndarray
    lift: np.ndarray
    Ru: object
    V: torch.Tensor
    W: torch.Tensor
    u_test_r: torch.Tensor
    obs: torch.Tensor
    rm: object
    residual: tuple
    paths: torch.Tensor
    steps: torch.Tensor
    seconds: dict


def residual_terms(fom, X: np.ndarray):
    """The host part of the residual sketch, the same for every embedding
    over the h1_0 sqrt factor Q: Q R^-1 A_q X of each affine term of the
    operator (float64, (n, cols) each, in a pool of threads) and Q R^-1 b
    of the rhs (n, 1)."""
    Ru = fom.h1_0_product

    def lift(Y):
        return Ru.sqrt.apply_host(Ru.inv.apply_host(Y))

    with _pool() as pool:
        terms = list(pool.map(lambda A: lift(A.apply_host(X)), fom.operator.terms))
    return terms, lift(fom.rhs.assemble_dense())


def sketched_system(S, terms, rhs_term, fom):
    """lhs, rhs of the sketched residual: ``residual_terms``' output through
    the l2 sketch of the embedding S (over Q), one sketch of each term's
    columns."""
    from rla4mor_tpu_torch.core import AffineDense

    lhs = AffineDense(torch.stack([S.apply_random(Y) for Y in terms]),
                      fom.operator.coefficients)
    return lhs, AffineDense(S.apply_random(rhs_term)[None], fom.rhs.coefficients)


def prepare(fom, train: np.ndarray, test: np.ndarray, m: int = M_OBS,
            max_steps: Optional[int] = None, obs_seed: int = 0,
            log: Callable[[str], None] = print) -> Prepared:
    """The FOM solves at ``train`` / ``test`` (host ``splu``, float64, in a
    pool of threads), the m observations at nodes drawn by
    ``np.random.RandomState(obs_seed)``, the residual terms of X = [atoms,
    W] and the LARS paths of the test observations, in RECOVERY_DTYPE on
    ``fom``'s device."""
    from rla4mor_tpu_torch.core import Product, gram_schmidt
    from rla4mor_tpu_torch.core.linops import to_numpy
    from rla4mor_tpu_torch.estim import DicRecoveryMap
    from rla4mor_tpu_torch.utils.config import as_tensor

    dev, rdt, n = fom.device, RECOVERY_DTYPE, fom.solution_dim
    t0 = time.perf_counter()
    rows = np.random.RandomState(obs_seed).choice(n, size=m, replace=False)
    Wd = np.zeros((n, m))
    Wd[rows, np.arange(m)] = 1.0
    lift = fom.h1_0_product.inv.apply_host(Wd)
    params = np.concatenate([train, test])
    with _pool() as pool:
        states = list(pool.map(
            lambda p: fom.solve_host({"diffusion": torch.as_tensor(p)}), params))
    U = np.stack(states, axis=1)
    solve_s = time.perf_counter() - t0
    log(f"FOM {fom.name}: n = {n}, {len(train)} training and {len(test)} test solves "
        f"in {solve_s:.2f} s")

    Ru = (fom.h1_0_product if fom.dtype == rdt
          else Product.from_sparse(fom.h1_0_product.op.S, device=dev, dtype=rdt))
    W = gram_schmidt(as_tensor(lift, dev, rdt), product=Ru)
    u_train = as_tensor(U[:, :len(train)], dev, rdt)
    V = u_train / Ru.norm(u_train)[None, :]
    u_test = as_tensor(U[:, len(train):], dev, rdt)
    obs = Ru.inner(W, u_test)
    t0 = time.perf_counter()
    residual = residual_terms(fom, to_numpy(torch.cat([V, W], dim=1)))
    residual_s = time.perf_counter() - t0
    rm = DicRecoveryMap(V, W, product=Ru, log_level=30)
    t0 = time.perf_counter()
    paths, steps = rm.lars_paths(obs, max_steps=max_steps)
    _sync(dev)
    lars_s = time.perf_counter() - t0
    log(f"LARS paths of {obs.shape[1]} columns: {lars_s:.2f} s, homotopy steps "
        f"{int(steps.min())}-{int(steps.max())} of {rm._resolve_max_steps(max_steps)}")
    return Prepared(np.asarray(train), np.asarray(test), U[:, :len(train)],
                    U[:, len(train):], lift, Ru, V, W, u_test, obs, rm, residual, paths,
                    steps, {"solve": solve_s, "residual": residual_s, "lars": lars_s})


def run(grid: int = 192, embeddings: Optional[Mapping[str, Callable]] = None,
        n_test: int = 32, device=None, dtype=None, prepared: Optional[Prepared] = None,
        train: Optional[np.ndarray] = None, test: Optional[np.ndarray] = None,
        m: int = M_OBS, n_train: int = N_TRAIN, modes: int = N_MODES,
        k: int = K_SKETCH, pg_iters: int = PG_ITERS, max_steps: Optional[int] = None,
        log: Callable[[str], None] = print) -> dict:
    """The demo on ``ThermalBlockFOM((3, 3), grid)`` on ``device`` in
    ``dtype`` (the device's working dtype unless named).

    ``embeddings`` maps names to makers (default: :func:`embedding_makers`,
    all three). ``prepared`` reuses an earlier run's :func:`prepare` at the
    same grid and device (another dtype, say); else it is made here, at
    ``train`` / ``test`` parameters (rows of 9 diffusion values) or at
    ``n_train`` / ``n_test`` drawn by the parameter space (seeds 1 and 2).

    Returns a dict: ``prepared``, ``n``, ``fom``, ``pbdw`` ((dimension,
    mean error) pairs), ``pbdw_u`` (the PBDW recoveries at the full
    background), ``pbdw_s`` and ``embeddings``: for each name its recovery
    errors ``rel``, the selected coefficients ``v``, the worst column
    ``worst`` and its path study (``dist``, ``errs``, ``coefs`` [v; eta],
    their argmins) and the seconds of its ``sketch_s``, ``select_s`` and
    ``path_s``."""
    from rla4mor_tpu_torch.core import gram_schmidt, pod
    from rla4mor_tpu_torch.estim import (
        DicRecoveryMap, PbdwRecoveryMap, ResidualDistanceAffine,
    )
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.utils.config import as_tensor, default_dtype, resolve_device

    dev = resolve_device(device)
    dt = default_dtype(dev) if dtype is None else dtype
    makers = embedding_makers() if embeddings is None else dict(embeddings)
    fom = ThermalBlockFOM((3, 3), grid, device=dev, dtype=dt)
    Ru = fom.h1_0_product
    n = fom.solution_dim
    space = fom.parameter_space
    if prepared is None:
        if train is None:
            train = torch.stack([mu["diffusion"] for mu in space.sample_randomly(
                n_train, seed=1, device="cpu")]).numpy()
        if test is None:
            test = torch.stack([mu["diffusion"] for mu in space.sample_randomly(
                n_test, seed=2, device="cpu")]).numpy()
        prepared = prepare(fom, train, test, m, max_steps, log=log)
    rec = prepared

    # PBDW error against background dimension, in the run's dtype
    t0 = time.perf_counter()
    W = gram_schmidt(as_tensor(rec.lift, dev, dt), product=Ru)
    u_train = as_tensor(rec.u_train, dev, dt)
    u_test = as_tensor(rec.u_test, dev, dt)
    obs = Ru.inner(W, u_test)
    rb, svals = pod(u_train, product=Ru, modes=modes)
    rm_pbdw = PbdwRecoveryMap(rb, W, product=Ru, log_level=30)
    pbdw = []
    for i in range(1, rb.shape[1] + 1, 3):
        ui = rm_pbdw.project_background(torch.arange(i, device=dev)).solve(obs)
        pbdw.append((i, float(Ru.norm(ui - u_test).mean())))
    pbdw_u = rm_pbdw.solve(obs)
    _sync(dev)
    pbdw_s = time.perf_counter() - t0
    log(f"{dt}: POD svals (normalised): "
        + " ".join(f"{float(s / svals[0]):.1e}" for s in svals[:10]))
    log(f"{dt}: PBDW mean test error vs background dim: "
        + " ".join(f"{i}:{e:.3e}" for i, e in pbdw))

    out = {"prepared": rec, "n": n, "fom": fom, "pbdw": pbdw, "pbdw_u": pbdw_u,
           "pbdw_s": pbdw_s, "embeddings": {}}
    rdt, Ru_r = RECOVERY_DTYPE, rec.Ru
    test_norms = Ru_r.norm(rec.u_test_r)
    lo, hi, p = space.low, space.high, space.dim()
    for name, make in makers.items():
        t0 = time.perf_counter()
        S = make(n, sqrt_product=Ru.sqrt, range_dim=k, seed=SEED_SKETCH, device=dev, dtype=dt)
        lhs, rhs = sketched_system(S, *rec.residual, fom)
        _sync(dev)
        sketch_s = time.perf_counter() - t0
        mdist = ResidualDistanceAffine(lhs.astype(rdt), rhs.astype(rdt), ([lo] * p, [hi] * p),
                                       pg_iters=pg_iters)
        rm = DicRecoveryMap(rec.V, rec.W, gramian=rec.rm.gramian,
                            cross_gramian=rec.rm.cross_gramian, product=Ru_r,
                            manifold_distance=mdist, log_level=30)

        t0 = time.perf_counter()
        v = rm.select(rec.obs, rec.paths)
        u_rec = rec.V @ v + rec.W @ rm.compute_correction(rec.obs, v)
        rel = Ru_r.norm(u_rec - rec.u_test_r) / test_norms
        _sync(dev)
        select_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        worst = int(rel.argmax())
        u_path, dist = rm.solve_path(rec.obs[:, worst], path=rec.paths[worst])
        errs = Ru_r.norm(u_path - rec.u_test_r[:, worst:worst + 1])
        _sync(dev)
        path_s = time.perf_counter() - t0
        res = {"sketch": S, "mdist": mdist, "v": v, "rel": rel, "worst": worst,
               "dist": np.asarray(dist), "errs": errs, "coefs": rm.last_path_coefs,
               "argmin_dist": int(np.argmin(dist)), "argmin_err": int(errs.argmin()),
               "sketch_s": sketch_s, "select_s": select_s, "path_s": path_s}
        out["embeddings"][name] = res
        log(f"{dt} [{name}] sketch {sketch_s:.2f} s, selection {select_s:.2f} s, "
            f"path study {path_s:.2f} s")
        log(f"{dt} [{name}] dictionary recovery relative errors: "
            + " ".join(f"{float(e):.3e}" for e in rel))
        log(f"{dt} [{name}] LARS path of test state {worst} ({len(res['dist'])} points): "
            f"argmin distance = {res['argmin_dist']}, argmin error = {res['argmin_err']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (float64)")
    ap.add_argument("--grid", type=int, default=192, help="num_intervals")
    ap.add_argument("--test", type=int, default=32, help="test states")
    ap.add_argument("--embedding", choices=sorted(embedding_makers()), action="append",
                    help="residual sketch (repeatable; default: all three)")
    args = ap.parse_args(argv)
    makers = embedding_makers()
    chosen = None if not args.embedding else {e: makers[e] for e in args.embedding}
    run(args.grid, chosen, n_test=args.test, device="cpu" if args.cpu else None)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
