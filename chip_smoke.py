#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rla4mor_tpu_torch``) on one NVIDIA GPU.

    python chip_smoke.py [--grid 512] [--extensions 8]

Phases, each printing one line (any failed check raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off;
2. build: compiles the one-pass SRHT kernel from ``rla4mor_tpu_torch/csrc``
   with nvcc and prints the build time;
3. kernel vs plain: the hand-written kernel against its plain PyTorch
   version on the same inputs on the card, float32 and float64, at the
   slice's shapes (n = 261,121, m = 1 and 8) and the bench shape
   (``SrhtEmbedding(k=256, n=2^24).apply_random`` on a (56, B, R) float32
   block and on (n, 56) columns). Tolerance relative to max|ref|: 1e-12 in
   float64, 1e-4 in float32 (sums of up to 1.7e7 terms); the plain float32
   version's own error against float64 is printed beside it. Times come
   from CUDA events;
4. the slice: thermal block 2x2 at ``--grid`` intervals (n = 261,121 at
   512, so every sketch takes the kernel), SRHT k = 300 over the h1_0
   sqrt factor, Galerkin reductor, weak greedy over 200 training
   parameters with ``--extensions`` extensions, then ``serve_batch`` on 4
   request batches padded to 256. Checks: finite outputs, the last max
   estimate below the first, ROM outputs within 5e-2 of the host FOM at 4
   held-out parameters, the sketched estimate within a factor 2 of the
   exact dual residual norm there, and SRHT kernel launches > 0;
5. the kernels' JSON line, then the result line.

Imports no JAX. Needs the repository (it imports ``rla4mor_tpu_torch``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SLICE_N = 261_121  # (512 - 1)^2 thermal-block unknowns
SLICE_K = 300
BENCH_LOG2N, BENCH_K, BENCH_M = 24, 256, 56
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {message}")


def phase(title: str, /, **fields) -> None:
    print(f"[{title}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (after a warm-up)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(label, x_cols, k, signs, sampling, reps, kernel):
    """``kernel()`` (a call that launches the kernel on ``x_cols``) against
    the plain version on the same input; returns the row of numbers."""
    from rla4mor_tpu_torch.ops import srht_cuda

    out = kernel()
    plain = srht_cuda.srht_onepass_plain(x_cols, k, signs, sampling)
    torch.cuda.synchronize()
    scale = plain.abs().max().item()
    err = (out - plain).abs().max().item()
    row = {"label": label, "dtype": str(x_cols.dtype).replace("torch.", ""),
           "max_abs_err": err, "rel_err": err / scale}
    if x_cols.dtype == torch.float32:
        ref = srht_cuda.srht_onepass_plain(x_cols.double(), k, signs, sampling)
        s64 = ref.abs().max().item()
        row["plain_f32_vs_f64"] = (plain.double() - ref).abs().max().item() / s64
        row["kernel_f32_vs_f64"] = (out.double() - ref).abs().max().item() / s64
        del ref
    del out, plain
    row["ms"] = cuda_ms(kernel, reps)
    row["plain_ms"] = cuda_ms(
        lambda: srht_cuda.srht_onepass_plain(x_cols, k, signs, sampling), reps)
    nbytes = x_cols.numel() * x_cols.element_size()
    row["GBps"] = nbytes / row["ms"] / 1e6
    row["plain_GBps"] = nbytes / row["plain_ms"] / 1e6
    phase("kernel", **row)
    check(row["rel_err"] <= TOL[x_cols.dtype],
          f"{label} {row['dtype']}: kernel vs plain {row['rel_err']:.3e} > "
          f"{TOL[x_cols.dtype]:.0e}")
    return row


def kernel_phase(device) -> list[dict]:
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
    from rla4mor_tpu_torch.ops.fwht import _srht_plan

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    signs, sampling, _ = _srht_plan(1, SLICE_N, SLICE_K)
    signs, sampling = signs.to(device), sampling.to(device)
    for m in (1, 8):
        for dt in (torch.float32, torch.float64):
            x = torch.randn((SLICE_N, m), generator=gen, device=device, dtype=dt)
            rows.append(compare(
                f"slice n={SLICE_N} m={m} k={SLICE_K}", x, SLICE_K, signs, sampling,
                reps=20, kernel=lambda x=x: srht_cuda.srht_onepass(
                    x, SLICE_K, signs, sampling)))
            del x

    n = 1 << BENCH_LOG2N
    for dt in (torch.float32, torch.float64):
        emb = SrhtEmbedding(BENCH_K, n, seed=0, device=device, dtype=dt)
        b_signs, b_samp, _ = emb.plan
        B, R = emb.blocked_shape
        rows_x = torch.randn((BENCH_M, n), generator=gen, device=device, dtype=dt)
        blocked = rows_x.view(BENCH_M, B, R)
        rows.append(compare(
            f"bench blocked (m,B,R)=({BENCH_M},{B},{R}) k={BENCH_K}", rows_x.T,
            BENCH_K, b_signs, b_samp, reps=3,
            kernel=lambda: emb.apply_random(blocked)))
        del blocked
        cols = rows_x.T.contiguous()
        del rows_x
        rows.append(compare(
            f"bench columns (n,m)=({n},{BENCH_M}) k={BENCH_K}", cols, BENCH_K,
            b_signs, b_samp, reps=3, kernel=lambda: emb.apply_random(cols)))
        del cols
        torch.cuda.empty_cache()
    return rows


def dual_residual_norm(fom, Ru, u: np.ndarray, mu) -> float:
    """||A(mu) u - b(mu)||_{R^-1} on the host, in float64."""
    r = fom.assemble_sparse(mu) @ u - fom.assemble_rhs(mu)
    v = Ru.inv.apply_host(r)
    return float(np.sqrt(max(r @ v, 0.0)))


def slice_phase(device, grid: int, extensions: int, training: int = 200,
                batch: int = 256, requests=(256, 200, 97, 256)) -> dict:
    """The main path once: FOM, SRHT-sketched greedy, checks, serving."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.models import ThermalBlockFOM
    from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy
    from rla4mor_tpu_torch.ops import SrhtEmbedding, srht_cuda
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    fom = ThermalBlockFOM((2, 2), grid, device=device)
    t_fom = time.perf_counter() - t0
    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = SrhtEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=SLICE_K,
                               seed=0, device=device)
    reductor = SketchedReductor(fom, embedding_primal=theta, product=Ru,
                                projection="galerkin", log_level=30)
    train = fom.parameter_space.sample_randomly(training, seed=0, device=device)

    host_solve = []
    solve = fom.solve

    def timed_solve(mu):
        t = time.perf_counter()
        u = solve(mu)
        host_solve.append(time.perf_counter() - t)
        return u

    fom.solve = timed_solve
    srht_cuda.srht_onepass.launches = 0
    t0 = time.perf_counter()
    result = rb_greedy(fom, reductor, train, max_extensions=extensions,
                       log_level=30)
    sync()
    t_greedy = time.perf_counter() - t0
    fom.solve = solve
    rom = result.rom
    est = result.max_estimates

    check(all(math.isfinite(e) for e in est), f"greedy estimates {est}")
    for name, op in (("lhs", rom.lhs), ("rhs", rom.rhs),
                     ("est_lhs", rom.error_estimator.lhs),
                     ("est_rhs", rom.error_estimator.rhs),
                     ("out", rom.output_functional)):
        check(bool(torch.isfinite(op.stack).all()), f"ROM {name} not finite")
    check(est[-1] < est[0], f"max estimate did not drop: {est[0]} -> {est[-1]}")

    held = fom.parameter_space.sample_randomly(4, seed=1, device=device)
    out_vec = fom.output_functional.stack[0, 0].double().cpu().numpy()
    rows = []
    for mu in held:
        u_fom = fom.solve_host(mu)
        u_r = rom.solve(mu)
        s_rom = float(rom.output(u_r, mu)[0])
        s_fom = float(out_vec @ u_fom)
        u = reductor.reconstruct(u_r).double().cpu().numpy()
        true = dual_residual_norm(fom, Ru, u, mu)
        est_mu = float(rom.estimate_error(mu, u_r))
        rows.append({"out_rel_err": abs(s_rom - s_fom) / abs(s_fom),
                     "est_over_true": est_mu / true})
    for r in rows:
        check(math.isfinite(r["out_rel_err"]) and r["out_rel_err"] <= 5e-2,
              f"ROM output error {r['out_rel_err']:.3e} > 5e-2")
        check(0.5 <= r["est_over_true"] <= 2.0,
              f"estimate / exact dual residual {r['est_over_true']:.3f} "
              "outside [0.5, 2]")

    pool = fom.parameter_space.sample_randomly(sum(requests), seed=2,
                                               device=device)
    serve_batch(rom, pad_batch(mu_stack(pool[:requests[0]]), batch)[0])  # warm-up
    sync()
    served, off = 0, 0
    t0 = time.perf_counter()
    outs = []
    for count in requests:
        mus, valid = pad_batch(mu_stack(pool[off: off + count]), batch)
        out = serve_batch(rom, mus)
        outs.append({k: v[:valid] for k, v in out.items()})
        off += count
        served += valid
    sync()
    t_serve = time.perf_counter() - t0
    for out in outs:
        for key, v in out.items():
            check(bool(torch.isfinite(v).all()), f"served {key} not finite")
    launches = srht_cuda.srht_onepass.launches

    ext = result.extension_times
    summary = {
        "n": n, "fom_build_s": t_fom, "greedy_s": t_greedy,
        "extensions": len(ext), "s_per_extension": sum(ext) / len(ext),
        "host_solve_s_per_extension": sum(host_solve) / len(host_solve),
        "max_est_first": est[0], "max_est_last": est[-1],
        "out_rel_err_max": max(r["out_rel_err"] for r in rows),
        "est_over_true": [round(r["est_over_true"], 4) for r in rows],
        "requests": served, "serve_s": t_serve,
        "requests_per_s": served / t_serve, "srht_launches": launches,
    }
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--extensions", type=int, default=8)
    args = ap.parse_args(argv)

    # 1. device
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device("cuda:0")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 still on")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0])

    # 2. build
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.utils import nvcc

    t0 = time.perf_counter()
    srht_cuda._lib()
    phase("build", source=srht_cuda.SOURCE,
          nvcc_s=nvcc.build_seconds(srht_cuda.SOURCE),
          load_s=time.perf_counter() - t0)

    # 3. kernel vs plain on the card
    rows = kernel_phase(device)

    # 4. the slice, through the entry points a user calls
    summary = slice_phase(device, args.grid, args.extensions)
    phase("slice", **summary)
    check(summary["srht_launches"] > 0, "the main path launched no SRHT kernel")

    # 5. result
    main_row = next(r for r in rows if r["label"].startswith("slice")
                    and r["dtype"] == "float32" and "m=1 " in r["label"])
    print(json.dumps({"kernels": [{
        "name": "srht_onepass",
        "route": "cuda",
        "source": "rla4mor_tpu_torch/csrc/srht_onepass.cu",
        "replaces": "rla4mor_tpu/ops/srht_pallas.py:580",
        "launches": summary["srht_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "shape": main_row["label"] + " float32",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
