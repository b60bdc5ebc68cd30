#!/usr/bin/env python3
"""Where the in-kernel Gaussian sketch spends its time, on one NVIDIA GPU.

    python probes/gaussian_sketch_probe.py [--out gaussian_probe_out] [--tiled]

At the HwPrng path's shapes (n = 261,121; m = 1 and 5; k = 256 and 300
normal, 256 Rademacher) and the bench shape at m = 8 (n = 2^23, k = 256,
both dists) it prints one line per shape with:

- ``event_ms``: CUDA events around back-to-back wrapper calls (what
  ``chip_smoke.py`` reports as the kernel's time);
- ``graph_ms``: the same calls captured in a CUDA graph and replayed, so no
  host work sits between the launches;
- ``host_us``: host time to enqueue one wrapper call;
- ``device_us``: device time of each kernel of one call, by name
  (``torch.profiler``);
- the launch plan the wrapper picks (slots per block, column groups,
  column ranges: SMs x resident blocks per SM).

It also writes the SASS of the sketch and strip kernels
(``cuobjdump -sass``) to ``--out`` and prints, for each small-m kernel at
m = 1, the count of each opcode, as a check on what the generation costs in
instructions; and it builds ``probes/int_rates.cu`` and prints the rate, per
SM and SM clock, of the integer multiplies Philox is made of and of a whole
Philox call in two forms (``int_rate`` lines).

``--tiled`` runs instead a sweep at the bench shape (n = 2^23, k = 256,
both dists) over m = 2 .. 256 and both branches: one ``[tiled]``
line per (dist, m, branch) with the CUDA-graph time, the device time of each
kernel (``torch.profiler``) and the library call (``torch.matmul`` with a
pre-drawn Omega, TF32 off). The small branch runs where it has instances
(m <= 8), and at m = 9 and 16 as two launches over column slices (8 + the
rest), what a small branch would cost there; then the tiled instances'
HMMA counts from their SASS. This sweep sets ``SMALL_M_MAX`` of
``ops/gaussian_cuda.py``; the tiled kernel's column chunk (``kTiledN`` of
the CUDA source) is a compile-time constant. Needs the repository and a
CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

N, W = 261_121, 2048
TILED_MS = (2, 3, 4, 6, 8, 9, 16, 32, 64, 128, 256)
SHAPES = [(N, 1, 256, "normal"), (N, 1, 300, "normal"), (N, 1, 256, "rademacher"),
          (N, 5, 256, "normal"), (N, 5, 300, "normal"), (N, 5, 256, "rademacher"),
          (1 << 23, 8, 256, "normal"), (1 << 23, 8, 256, "rademacher")]


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()  # warm-up on the capture stream
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def device_us(fn, reps: int, prefix: str = "gaussian") -> dict:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = e.cuda_time_total
        if total and prefix in e.key:
            name = re.sub(rf"^.*?({prefix}_\w+).*$", r"\1", e.key)
            out[name] = out.get(name, 0.0) + total / reps
    return out


def sass(lib_path: Path, out_dir: Path, filename: str = "gaussian_sketch.sass") -> dict:
    """Opcode counts of each kernel in the library -> {kernel: Counter}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    (out_dir / filename).write_text(text)
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            counts[name][m.group(2)] += 1
    return counts


RATE_KINDS = {0: ("IMAD.WIDE.U32", 8), 1: ("IMAD.HI.U32", 8), 2: ("IMAD", 8),
              3: ("philox call, 64-bit products", 2),
              4: ("philox call, umulhi + multiply", 2),
              # a warp's 8 products a step: per thread 8 / 32; rate in HMMAs
              5: ("HMMA.1688.F32.TF32 (warp instructions)", 0.25)}


def int_rates(out_dir: Path, iters: int = 4096) -> list[dict]:
    """Ops (or Philox calls) per SM per SM clock of each kind of
    ``probes/int_rates.cu``, all blocks resident (4 x 256 threads an SM)."""
    import ctypes

    from rla4mor_tpu_torch.utils import nvcc

    src = Path(__file__).resolve().parent / "int_rates.cu"
    lib_path = nvcc.BUILD_DIR / "int_rates.so"
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.int_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads = 4 * sms, 256
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    cycles = torch.empty(blocks, dtype=torch.int64, device="cuda")
    rows = []
    for kind, (name, per_step) in RATE_KINDS.items():
        for _ in range(2):  # the first launch warms up
            err = lib.int_rate(kind, out.data_ptr(), cycles.data_ptr(), blocks, threads,
                               iters, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            torch.cuda.synchronize()
        c = cycles.double().mean().item()
        rate = per_step * iters * threads * 4 / c  # 4 resident blocks an SM
        row = {"kind": name, "per_sm_per_clock": rate, "cycles": c}
        print("[int_rate] " + json.dumps(row), flush=True)
        rows.append(row)
    counts = sass(lib_path, out_dir, "int_rates.sass")
    for fn, cnt in counts.items():
        top = ", ".join(f"{op}:{n}" for op, n in cnt.most_common(8))
        print(f"[sass] {fn} {top}", flush=True)
    return rows


def tiled_sweep(out_dir: Path, reps: int) -> list[dict]:
    """Graph and device time of each branch at the bench shape (n = 2^23, k = 256), both dists, m in ``TILED_MS``."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu
    from rla4mor_tpu_torch.utils import nvcc

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(5)
    n, k, rows = 1 << 23, 256, []
    omega = torch.randn((k, n), generator=gen, device=dev)
    for dist in ("normal", "rademacher"):
        for m in TILED_MS:
            x = torch.randn((n, m), generator=gen, device=dev)
            calls = {}
            if m <= 8:
                calls["small"] = lambda x=x: gcu._launch_sketch(x, k, 3, W, dist, "small")
            elif m <= 16:  # two small launches: columns [0, 8) and [8, m)
                parts = (x[:, :8], x[:, 8:])
                calls["small x2"] = lambda parts=parts: [
                    gcu._launch_sketch(p, k, 3, W, dist, "small") for p in parts]
            calls["tiled"] = lambda x=x: gcu._launch_sketch(x, k, 3, W, dist, "tiled")
            library = event_ms(lambda x=x: torch.matmul(omega, x), reps)
            for branch, fn in calls.items():
                row = {"dist": dist, "m": m, "branch": branch,
                       "graph_ms": graph_ms(fn, reps), "device_us": device_us(fn, 2),
                       "library_ms": library}
                print("[tiled] " + json.dumps(row), flush=True)
                rows.append(row)
            del x
    del omega
    (out_dir / "tiled_rows.json").write_text(json.dumps(rows, indent=1))
    counts = sass(nvcc.library_path(gcu.SOURCE), out_dir)
    for fn, c in counts.items():
        if "tiled_kernel" in fn:
            mma = {op: cnt for op, cnt in c.items() if op.startswith(("HMMA", "HGMMA"))}
            print(f"[sass] {fn} total={sum(c.values())} mma={mma}", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="gaussian_probe_out")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rates-only", action="store_true",
                    help="only the int_rate lines")
    ap.add_argument("--tiled", action="store_true",
                    help="only the sweep over m and both branches")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu
    from rla4mor_tpu_torch.utils import nvcc

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    if args.tiled:
        gcu._lib()
        tiled_sweep(out_dir, min(args.reps, 10))
        return 0
    int_rates(out_dir)
    if args.rates_only:
        return 0
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for n, m, k, dist in SHAPES:
        x = torch.randn((n, m), generator=gen, device=dev)
        reps = args.reps if n == N else 5

        def call(x=x, k=k, dist=dist):
            return gcu.gaussian_sketch(x, k, 3, W, dist)

        call()
        plan = gcu.small_launch(0, n, m, k, dist) if m <= gcu.SMALL_M_MAX[dist] else None
        row = {"n": n, "m": m, "k": k, "dist": dist, "S_G_n_split": plan,
               "event_ms": event_ms(call, reps), "graph_ms": graph_ms(call, reps),
               "host_us": host_us(call, reps), "device_us": device_us(call, reps)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    (out_dir / "rows.json").write_text(json.dumps(rows, indent=1))

    counts = sass(nvcc.library_path(gcu.SOURCE), out_dir)
    for fn, c in counts.items():
        if re.search(r"small_kernelILi\dELi1EEE", fn):  # <mode, M = 1>
            top = ", ".join(f"{op}:{cnt}" for op, cnt in c.most_common(25))
            print(f"[sass] {fn} total={sum(c.values())} {top}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
