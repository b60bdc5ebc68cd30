#!/usr/bin/env python3
"""Where the one-pass SRHT spends its time, on one NVIDIA GPU.

    python probes/srht_probe.py [--reps 50] [--sweep] [--dtype bfloat16]

At the SRHT slice's shapes (n = 261,121, k = 300, m = 1 and 8, float32
and float64) and the bench shape (56 columns of 2^24, k = 256, blocked
rows and columns, float32 and float64) it prints one line per shape with:

- ``event_ms``: CUDA events around back-to-back wrapper calls (what
  ``chip_smoke.py`` reports as the kernel's time);
- ``graph_ms``: the same calls captured in a CUDA graph and replayed, so no
  host work sits between the launches;
- ``host_us``: host time to enqueue one wrapper call;
- ``device_us``: device time of each kernel of one call, by name
  (``torch.profiler``);
- the launch plan the wrapper picks (MT, blocks per CTA, CTAs along the
  blocks, CTAs a group of the reduction);

and with ``--sweep`` the CUDA-graph time at each tile width MT the kernel
has (the plan's ``tile_width`` replaced by a constant), at those shapes
and at n = 2^20 with m = 8 and 56 in both layouts, float32. ``--dtype
bfloat16`` (or float16) runs the same shapes with 2-byte input (float32
output) in place of float32 and float64, and the bench columns once more
one element off their allocation (the kernel's element path).

Then, at the slice's m = 1 float32 shape, ``[host]`` lines split the
wrapper's host time into its steps, each timed alone over many calls.
Needs the repository and a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gaussian_sketch_probe import device_us, event_ms, graph_ms, host_us  # noqa: E402

SLICE_N, SLICE_K = 261_121, 300
BENCH_N, BENCH_K, BENCH_M = 1 << 24, 256, 56


def per_call_us(fn, reps: int = 2000) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def host_steps(x, k, signs, sampling) -> dict:
    """Host microseconds of each step of one wrapper call at x's shape."""
    from rla4mor_tpu_torch.ops import srht_cuda as sc

    index = x.get_device()
    n, m = x.shape
    acc = sc.accumulator_dtype(x.dtype)
    key = (index, x.dtype, n, m, k, *x.stride())
    rec, n_counters, n_sums = sc._launch_plan(*key)
    stream = sc._stream(index)
    done = sc._scratch(index, stream, torch.int32, n_counters)
    sums = sc._scratch(index, stream, acc, n_sums)
    out = x.new_empty((k, m), dtype=acc)
    fn = sc._lib().srht_onepass
    args = (rec, sc._DTYPE_CODE[x.dtype], x.data_ptr(), signs.data_ptr(), sampling.data_ptr(),
            done, sums, out.data_ptr(), 0, stream)
    steps = {
        "wrapper": lambda: sc.srht_onepass(x, k, signs, sampling),
        "launch_plan_cached": lambda: sc._launch_plan(*key),
        "plan_operands": lambda: (sc._plan_operand(signs, torch.int8, index),
                                  sc._plan_operand(sampling, torch.int32, index)),
        "stream": lambda: sc._stream(index),
        "scratch": lambda: (sc._scratch(index, stream, torch.int32, n_counters),
                            sc._scratch(index, stream, x.dtype, n_sums)),
        "new_empty": lambda: x.new_empty((k, m), dtype=acc),
        "data_ptrs": lambda: (x.data_ptr(), x.stride(), signs.data_ptr()),
        "launch_ctypes": lambda: fn(*args),
    }
    out_us = {name: per_call_us(f) for name, f in steps.items()}
    torch.cuda.synchronize()
    return out_us


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweep", action="store_true",
                    help="also time each shape at every tile width (MT)")
    ap.add_argument("--dtype", choices=("bfloat16", "float16"), default=None,
                    help="2-byte input (float32 output) in place of float32 and float64")
    args = ap.parse_args(argv)
    dtypes = ((torch.float32, torch.float64) if args.dtype is None
              else (getattr(torch, args.dtype),))
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from rla4mor_tpu_torch.ops import srht_cuda as sc
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
    from rla4mor_tpu_torch.ops.fwht import _srht_plan

    tile_width = sc.tile_width

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    signs, sampling, _ = _srht_plan(1, SLICE_N, SLICE_K)
    signs, sampling = signs.to(dev), sampling.to(dev, torch.int32)

    def row(label, x, k, call, reps):
        n, m = x.shape
        call()
        rec = sc._launch_plan(0, x.dtype, n, m, k, *x.stride())[0]
        if args.sweep:
            sweep(label, x, call, reps)
        r = {"shape": label, "dtype": str(x.dtype).replace("torch.", ""),
             "mt_bpc_nsplit_group": (rec.mt, rec.blocks_per_cta, rec.n_split, rec.group),
             "event_ms": event_ms(call, reps), "graph_ms": graph_ms(call, reps),
             "host_us": host_us(call, reps), "device_us": device_us(call, reps, "srht")}
        print(json.dumps(r), flush=True)

    def sweep(label, x, call, reps):  # device time at each tile width
        swept = {}
        for mt in (1, 2, 4):
            sc.tile_width = lambda *_, mt=mt, **__: mt
            sc._launch_plan.cache_clear()
            swept[f"mt={mt}"] = graph_ms(call, reps)
        sc.tile_width = tile_width
        sc._launch_plan.cache_clear()
        print(json.dumps({"shape": label, "dtype": str(x.dtype).replace("torch.", ""),
                          "stride": x.stride(), "graph_ms": swept}), flush=True)

    if args.sweep:
        for m in (8, 56):
            rows_x = torch.randn((m, 1 << 20), generator=gen, device=dev).to(dtypes[0])
            p_signs, p_samp, _ = _srht_plan(2, 1 << 20, 256)
            p_signs, p_samp = p_signs.to(dev), p_samp.to(dev, torch.int32)
            for x in (rows_x.T, rows_x.T.contiguous()):
                sweep(f"n=2^20 m={m} k=256", x,
                      lambda x=x: sc.srht_onepass(x, 256, p_signs, p_samp, torch.float32),
                      args.reps)
            del rows_x
    for m in (1, 8):
        for dt in dtypes:
            x = torch.randn((SLICE_N, m), generator=gen, device=dev).to(dt)
            row(f"slice n={SLICE_N} m={m} k={SLICE_K}", x, SLICE_K,
                lambda x=x: sc.srht_onepass(x, SLICE_K, signs, sampling,
                                            sc.accumulator_dtype(x.dtype)), args.reps)
            if m == 1 and dt == dtypes[0]:
                steps = host_steps(x, SLICE_K, signs, sampling)
                print("[host] " + json.dumps(steps), flush=True)
            del x
    for dt in dtypes:
        acc = sc.accumulator_dtype(dt)
        emb = SrhtEmbedding(BENCH_K, BENCH_N, seed=0, device=dev, dtype=acc)
        B, R = emb.blocked_shape
        rows_x = torch.randn((BENCH_M, BENCH_N), generator=gen, device=dev, dtype=acc).to(dt)
        blocked = rows_x.view(BENCH_M, B, R)
        row("bench blocked", rows_x.T, BENCH_K,
            lambda: emb.apply_random(blocked, out_dtype=acc), 10)
        del blocked
        cols = rows_x.T.contiguous()
        del rows_x
        row("bench columns", cols, BENCH_K, lambda: emb.apply_random(cols, out_dtype=acc), 10)
        if dt.itemsize == 2:  # a view one element off: the kernel's element path
            flat = torch.empty(BENCH_N * BENCH_M + 1, device=dev, dtype=dt)
            off = flat[1:].view(BENCH_N, BENCH_M)
            off.copy_(cols)
            row("bench columns, one element off", off, BENCH_K,
                lambda: emb.apply_random(off, out_dtype=acc), 10)
            del flat, off
        del cols
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
