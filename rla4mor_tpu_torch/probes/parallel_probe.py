"""The sharded path's pieces on the card, timed.

Prints the card (``nvidia-smi`` name and power limit) and one JSON line of
readings:

* ``collectives``: host microseconds an ``all_reduce`` of 2 values, an
  ``all_gather`` of two 2048-float rows and an ``exchange`` (the butterfly's
  pair transfer) of 2^16 floats take through ``parallel/mesh.py`` (CUDA
  tensors through host memory on gloo), on 2 gloo ranks sharing ``cuda:0``
  and on one NCCL rank (median of 200 after a warm-up);
* ``kernel``: the block-offset SRHT kernel against its plain version at
  n_local = 2^21, m = 5, k = 256 in float32 at offsets 0, 1,024 and 1,026
  blocks (max relative error, ms by events);
* ``demo``: ``large_scale_demo.run(ranks=2, backend="gloo")`` at ``--grid``
  (default 511) for ``--steps`` steps, Jacobi-CG 1e-7 / 6,000, SRHT k = 256:
  each step's seconds, CG iterations and the collectives' host seconds.

    python -m rla4mor_tpu_torch.probes.parallel_probe [--grid 511] [--steps 2]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch


def _lat(rank: int) -> dict:
    import torch.distributed as dist

    from rla4mor_tpu_torch.parallel import launch
    from rla4mor_tpu_torch.parallel import mesh as pm

    dev = launch.rank_device()
    group = dist.group.WORLD
    out = {}

    def med(fn, reps=200):
        for _ in range(10):
            fn()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) * 1e6

    s = torch.zeros(2, device=dev)
    rows = torch.zeros(2, 2048, device=dev)
    big = torch.zeros(1 << 16, device=dev)
    out["all_reduce_us"] = med(lambda: pm.all_reduce(s, group))
    out["all_gather_us"] = med(lambda: pm.all_gather(rows, group))
    world = dist.get_world_size()
    if world > 1:
        out["exchange_us"] = med(lambda: pm.exchange(big, rank ^ 1, group), reps=50)
    return out


def kernel_rows() -> list:
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.ops.fwht import _srht_plan

    n_local, m, k = 1 << 21, 5, 256
    signs, sampling, _ = _srht_plan(0, 4198401, k)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((m, n_local), generator=gen, device="cuda").T
    samp = sampling.to("cuda", torch.int32)
    rows = []
    for off in (0, 1024, 1026):
        r0 = off << 11
        sg = torch.zeros(n_local, dtype=torch.int8)
        part = signs[r0:r0 + n_local]
        sg[:part.numel()] = part
        sg = sg.cuda()
        out = srht_cuda.srht_onepass(x, k, sg, samp, block_offset=off)
        plain = srht_cuda.srht_onepass_plain(x, k, sg, samp, block_offset=off)
        err = float((out - plain).abs().max() / plain.abs().max())
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            srht_cuda.srht_onepass(x, k, sg, samp, block_offset=off)
        end.record()
        torch.cuda.synchronize()
        rows.append({"block_offset": off, "rel_err": err, "ms": start.elapsed_time(end) / 50})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=511)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    from rla4mor_tpu_torch.examples import large_scale_demo as demo
    from rla4mor_tpu_torch.parallel.launch import spawn

    res = {"card": smi, "torch": torch.__version__}
    res["kernel"] = kernel_rows()
    print(json.dumps(res["kernel"]), flush=True)
    t0 = time.perf_counter()
    res["collectives"] = {"gloo2": spawn(_lat, 2, "gloo", "cuda:0")[0]}
    res["spawn_gloo2_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["collectives"]["nccl1"] = spawn(_lat, 1, "nccl", "cuda:0")[0]
    res["spawn_nccl1_s"] = time.perf_counter() - t0
    print(json.dumps(res["collectives"]), flush=True)
    t0 = time.perf_counter()
    ranks = demo.run(grid=args.grid, steps=args.steps, k=256, sketch="srht", ranks=2,
                     backend="gloo", device="cuda:0", check_one_device=True)
    res["demo_wall_s"] = time.perf_counter() - t0
    res["demo"] = {r: {key: v[key] for key in ("step_s", "comm_s", "cg_iters", "median_est",
                                                "sketch_check", "slab_check", "srht_launches",
                                                "comm")}
                   for r, v in ranks.items()}
    print(json.dumps(res, default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
