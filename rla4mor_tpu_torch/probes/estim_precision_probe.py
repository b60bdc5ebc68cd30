"""How the dictionary recovery of ``examples/inverse_problems_demo.py``
depends on its precision.

The demo's recovery (the 3x3 thermal block, 50 observations, 200 atoms,
a Gaussian residual sketch of k = 256) three ways, from the same host
float64 solves:

* ``float64``: data and arithmetic in float64 (the demo's recovery);
* ``float32``: snapshots, bases, sketch and the recovery's arithmetic all
  in float32 (the JAX package's float32 semantics, its dtype-aware
  tolerances included);
* ``float32 data``: the float32-rounded snapshots and bases, the recovery's
  arithmetic in float64.

For each it prints the recovery error of every test state, its ratio to
float64's and the homotopy steps of each column.

    python -m rla4mor_tpu_torch.probes.estim_precision_probe --cpu --grid 64
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def recover(fom64, fom, host, data_dtype, arith_dtype) -> tuple[np.ndarray, np.ndarray]:
    """Recovery errors (relative, h1_0) and homotopy steps of the test
    states, the data in ``data_dtype`` (``fom``'s) and the recovery's
    arithmetic in ``arith_dtype``."""
    from rla4mor_tpu_torch.core import ChainOp, compose, gram_schmidt, materialize, project
    from rla4mor_tpu_torch.estim import DicRecoveryMap, ResidualDistanceAffine
    from rla4mor_tpu_torch.examples.inverse_problems_demo import K_SKETCH, PG_ITERS, SEED_SKETCH
    from rla4mor_tpu_torch.ops import GaussianEmbedding
    from rla4mor_tpu_torch.utils.config import as_tensor

    dev, Ru, Ru64 = fom.device, fom.h1_0_product, fom64.h1_0_product
    W = gram_schmidt(as_tensor(host.lift, dev, data_dtype), product=Ru)
    u_train = as_tensor(host.u_train, dev, data_dtype)
    u_test = as_tensor(host.u_test, dev, data_dtype)
    V = u_train / Ru.norm(u_train)[None, :]
    S = GaussianEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt, range_dim=K_SKETCH,
                               seed=SEED_SKETCH, device=dev, dtype=data_dtype)
    chain = ChainOp((S, Ru.inv))
    lhs = project(compose(chain, fom.operator), None, torch.cat([V, W], dim=1))
    rhs = materialize(compose(chain, fom.rhs))
    if arith_dtype == data_dtype:
        prod, W_a, V_a, obs = Ru, W, V, Ru.inner(W, u_test)
    else:
        prod, V_a = Ru64, V.to(arith_dtype)
        W_a = gram_schmidt(W.to(arith_dtype), product=Ru64)
        obs = Ru64.inner(W_a, u_test.to(arith_dtype))
    md = ResidualDistanceAffine(lhs.astype(arith_dtype), rhs.astype(arith_dtype),
                                ([0.1] * 9, [1.0] * 9), pg_iters=PG_ITERS)
    rm = DicRecoveryMap(V_a, W_a, product=prod, manifold_distance=md, log_level=30)
    v = rm.compute_state(obs)
    u = V_a @ v + W_a @ rm.compute_correction(obs, v)
    truth = as_tensor(host.u_test, dev, torch.float64)
    err = Ru64.norm(u.double() - truth) / Ru64.norm(truth)
    return err.cpu().numpy(), rm.last_steps.cpu().numpy()


def main(argv=None) -> int:
    from rla4mor_tpu_torch.examples.inverse_problems_demo import prepare
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.utils.config import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--test", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    fom64 = ThermalBlockFOM((3, 3), args.grid, device=dev, dtype=torch.float64)
    fom32 = ThermalBlockFOM((3, 3), args.grid, device=dev, dtype=torch.float32)
    space = fom64.parameter_space

    def draw(count, seed):
        return torch.stack([mu["diffusion"] for mu in space.sample_randomly(
            count, seed=seed, device="cpu")]).numpy()

    host = prepare(fom64, draw(200, 1), draw(args.test, 2), log=print)
    ref, ref_steps = recover(fom64, fom64, host, torch.float64, torch.float64)
    print(f"float64       errors {np.array2string(ref, precision=3)} steps {ref_steps}")
    for label, data, arith in (("float32", torch.float32, torch.float32),
                               ("float32 data", torch.float32, torch.float64)):
        err, steps = recover(fom64, fom32, host, data, arith)
        print(f"{label:13s} errors {np.array2string(err, precision=3)} ratio "
              f"{np.array2string(err / ref, precision=2)} steps {steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
