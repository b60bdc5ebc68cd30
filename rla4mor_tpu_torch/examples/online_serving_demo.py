"""Online serving: ship a ROM file, serve batched requests, hot-swap a
model refresh.

The port's counterpart of ``examples/online_serving_demo.py``. Offline: the
sketched reductor on the thermal block (a Gaussian k over the h1_0 square
root, ``truncation_rtol`` 3e-4, the basis cut to the shipped ``r``) and
``save_rom``: one ``.npz``, no FOM or reductor state needed to serve.
Serving: ``load_rom`` in float32 and ``serve.serve_batch``, the whole online
stage (assembly, batched solve, error estimate and output of every request)
one call over the parameter batch, the requests padded onto accepted batch
sizes by ``pad_batch``. The hot swap loads a refreshed model of the same
reduced dimensions and serves it by the same call: the same shapes, so
nothing is built anew. Its checks: at batch 16 the served outputs equal
per-parameter solves (1e-4 relative); the swapped model's tensors have the
shipped one's shapes.

    python -m rla4mor_tpu_torch.examples.online_serving_demo
    python -m rla4mor_tpu_torch.examples.online_serving_demo --cpu --grid 32
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from rla4mor_tpu_torch.utils.config import resolve_device, sync

BATCHES = (1, 16, 256, 4096, 65536)
CHECK_BATCH = 16
TRUNCATION_RTOL = 3e-4


def _shapes(rom) -> list:
    """The shapes of a stationary ROM's tensors, in a fixed order."""
    parts = [rom.lhs, rom.rhs, rom.error_estimator.lhs, rom.error_estimator.rhs,
             rom.output_functional]
    return [tuple(p.stack.shape) for p in parts]


def run(grid: int = 64, snapshots: int = 20, r: int = 12, k: int = 200, batches=BATCHES,
        device=None, log=print) -> dict:
    """Train and ship (the ROM file in a temporary directory), serve each
    batch size, then hot-swap; returns the readings."""
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.mor import SketchedReductor, load_rom, save_rom
    from rla4mor_tpu_torch.mor.uq import sample_mu_batched
    from rla4mor_tpu_torch.ops.embeddings import GaussianEmbedding
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch

    dev = resolve_device(device)
    t0 = time.perf_counter()
    fom = ThermalBlockFOM((2, 2), grid, device=dev)
    Ru, space = fom.h1_0_product, fom.parameter_space

    def train(seed):
        theta = GaussianEmbedding.make(fom.solution_dim, sqrt_product=Ru.sqrt, range_dim=k,
                                       seed=seed, device=dev, dtype=fom.dtype)
        # truncate near-dependent snapshot directions at ~sqrt(eps_f32), and
        # pin the shipped dims: the hot swap serves both trainings by one call
        red = SketchedReductor(fom, embedding_primal=theta, product=Ru,
                               truncation_rtol=TRUNCATION_RTOL, log_level=30)
        red.extend_basis(fom.solve_many(space.sample_randomly(snapshots, seed=seed,
                                                              device=dev)))
        red.truncate_basis(r)
        if red.basis_size != r:
            raise RuntimeError(f"only {red.basis_size} independent directions at rtol "
                               f"{TRUNCATION_RTOL}: lower r or raise snapshots")
        return red.reduce(seed=seed + 1)

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serving_model.npz"
        save_rom(train(seed=0), path)
        offline_s = time.perf_counter() - t0
        size_kb = path.stat().st_size / 1e3
        log(f"offline: trained + shipped r={r} ROM ({size_kb:.0f} kB file) in "
            f"{offline_s:.1f}s")
        rom = load_rom(path, device=dev, dtype=torch.float32)

        def requests(count, key):
            return sample_mu_batched(space, count, key=key, device=dev, dtype=torch.float32)

        log(f"serving on {dev}: batched solve + error estimate + output per request")
        rows, dev_max = [], None
        for b in batches:
            mus, n_valid = pad_batch(requests(b, key=b), b)
            out = serve_batch(rom, mus)  # warm-up
            sync(dev)
            reps = 3 if b >= 4096 else 20
            t0 = time.perf_counter()
            for _ in range(reps):
                out = serve_batch(rom, mus)
            sync(dev)
            dt = (time.perf_counter() - t0) / reps
            med = float(out["estimate"].median())
            log(f"  batch {b:>6}: {dt * 1e3:8.3f} ms/batch -> {b / dt:12,.0f} mu/s   "
                f"(median estimate {med:.2e})")
            rows.append({"batch": b, "ms": dt * 1e3, "mu_per_s": b / dt,
                         "median_estimate": med})
            if b == CHECK_BATCH:
                dev_max = 0.0
                for i in range(b):
                    mu = {key: v[i] for key, v in mus.items()}
                    s = rom.output(rom.solve(mu), mu)
                    dev_max = max(dev_max, float(((out["output"][i] - s).abs()
                                                  / s.abs().clamp(min=1e-30)).max()))
                if not dev_max <= 1e-4:
                    raise RuntimeError(f"served outputs differ from per-parameter solves by "
                                       f"{dev_max:.3e}")
                log(f"  batch {b}: served = per-parameter solves within {dev_max:.2e}")

        # the hot swap: a refreshed model of the same reduced dimensions
        save_rom(train(seed=17), path)
        rom2 = load_rom(path, device=dev, dtype=torch.float32)
    if _shapes(rom2) != _shapes(rom):
        raise RuntimeError(f"hot swap changed the shapes: {_shapes(rom)} -> {_shapes(rom2)}")
    t0 = time.perf_counter()
    out2 = serve_batch(rom2, mus)
    sync(dev)
    swap_ms = (time.perf_counter() - t0) * 1e3
    if not bool(torch.isfinite(out2["output"]).all()):
        raise RuntimeError("hot swap: non-finite outputs")
    log(f"hot swap: refreshed model served in {swap_ms:.2f} ms (same shapes "
        f"{_shapes(rom2)[0]}, same call)")
    return {"n_dof": fom.solution_dim, "r": r, "offline_s": offline_s, "file_kb": size_kb,
            "rows": rows, "swap_ms": swap_ms, "check_dev": dev_max,
            "median_estimate_swap": float(np.median(out2["estimate"].cpu().numpy()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--grid", type=int, default=64,
                    help="thermal-block intervals (n = (grid - 1)^2)")
    ap.add_argument("--snapshots", type=int, default=20)
    ap.add_argument("--r", type=int, default=12, help="shipped reduced dimension")
    ap.add_argument("--k", type=int, default=200)
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    args = ap.parse_args(argv)
    run(grid=args.grid, snapshots=args.snapshots, r=args.r, k=args.k,
        batches=args.batches, device="cpu" if args.cpu else None)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
