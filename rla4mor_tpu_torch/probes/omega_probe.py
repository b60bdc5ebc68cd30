"""Variants of the Omega kernel (``csrc/gaussian_sketch.cu``,
``gaussian_omega_kernel``), built side by side from the source in the
checkout and timed in one process on the card.

    python -m rla4mor_tpu_torch.probes.omega_probe [--out DIR] [--rounds 2]

Each variant is the source with one change made by text substitution:

* ``source``: as it stands;
* ``stores off``: the kernel draws and stages every value but stores none
  (the stores sit behind a test that no run passes), so its time is that
  of the draws alone;
* ``cospif``: the cosine (and, in pairs mode, sine) of 2 pi u2 by
  ``cospif`` / ``sincospif`` of 2 u2, as the kernels drew them before
  ``turn_cos_sin``;
* ``1 slot a warp``: every mode draws one slot a warp (cos halves draws 2);
* ``min blocks 3`` / ``min blocks 4``: the ``__launch_bounds__`` minimum of
  resident blocks (2) that caps the registers.

Per variant it prints the registers and spills of each instance
(``-Xptxas -v``); per variant and shape (``SHAPES``), in turns over
``--rounds`` rounds, the CUDA-event time of ``gaussian_omega`` over
back-to-back calls, the resident blocks, and the largest difference from
the source's output (none for ``stores off``, whose output is never
written). Then the instruction count of the source's cos-halves
instance's inner loop (its SASS, ``cuobjdump -sass``), with the opcodes
counted, and ``normal_`` and ``fill_`` of a (k, n) float32 tensor
as yardsticks of generate-and-store and of store alone. ``--out`` keeps the
SASS there. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from rla4mor_tpu_torch.ops import gaussian_cuda as gcu
from rla4mor_tpu_torch.utils import nvcc

SHAPES = [(200, 1_050_625, "normal"), (256, 261_121, "normal"), (256, 261_121, "rademacher")]
PROBE_DIR = nvcc.BUILD_DIR / "omega_probe"
SEED = 21

_STORES = "      if (it < full) {"
_COS_NEW = """    float cs, sn;
    turn_cos_sin(b2.w[i], &cs, &sn);
    va[i] = radius * cs;
    if (MODE == kNormalPairs) vb[i] = radius * sn;"""
_COS_OLD = """    const float t = 2.0f * bits_to_unit(b2.w[i]);  // exact
    if (MODE == kNormalPairs) {
      float sn, cs;
      sincospif(t, &sn, &cs);
      va[i] = radius * cs;
      vb[i] = radius * sn;
    } else {
      va[i] = radius * cospif(t);
    }"""
_SLOTS = "return mode == kNormalCos ? 2 : 1;"
_MIN_BLOCKS = "constexpr int kOmegaMinBlocks = 2;"


def _edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the source no longer holds {old!r} once")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    """The variants' sources by name."""
    return {
        "source": src,
        "stores off": _edit(src, _STORES, "      if (scale != 12345.0f) {\n      } else if (it < full) {"),
        "cospif": _edit(src, _COS_NEW, _COS_OLD),
        "1 slot a warp": _edit(src, _SLOTS, "return 1;"),
        "min blocks 3": _edit(src, _MIN_BLOCKS, "constexpr int kOmegaMinBlocks = 3;"),
        "min blocks 4": _edit(src, _MIN_BLOCKS, "constexpr int kOmegaMinBlocks = 4;"),
    }


def build(name: str, src: str) -> tuple[Path, list[str]]:
    """Compile one variant; returns its library and the ptxas lines of the
    Omega kernel's instances (registers, spills)."""
    stem = PROBE_DIR / name.replace(" ", "_")
    stem.with_suffix(".cu").write_text(src)
    lib = stem.with_suffix(".so")
    cmd = [nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(stem.with_suffix(".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr[-4000:]}")
    lines = (proc.stdout + proc.stderr).splitlines()
    info = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "gaussian_omega_kernel" in line:
            mode = re.search(r"gaussian_omega_kernelILi(\d)E", line).group(1)
            info.append(f"mode {mode}: {lines[i + 3].split(':', 1)[1].strip()}; "
                        f"{lines[i + 2].strip()}")
    return lib, info


@contextlib.contextmanager
def loaded(lib_path: Path):
    """``ops/gaussian_cuda.py`` on the variant's library for the duration."""
    saved = nvcc._LOADED.get(gcu.SOURCE)
    nvcc._LOADED[gcu.SOURCE] = ctypes.CDLL(str(lib_path))
    gcu._lib.cache_clear()
    gcu._resident_omega.cache_clear()
    try:
        yield
    finally:
        if saved is None:
            nvcc._LOADED.pop(gcu.SOURCE, None)
        else:
            nvcc._LOADED[gcu.SOURCE] = saved
        gcu._lib.cache_clear()
        gcu._resident_omega.cache_clear()


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main_loop_opcodes(lib_path: Path, out: Path | None) -> tuple[int, collections.Counter]:
    """Instructions of the cos-halves instance's inner loop (the shortest
    loop that holds the staging stores: one iteration of the walk, with its
    rarely taken branches), and their opcodes."""
    sass = subprocess.run([str(Path(nvcc._nvcc()).parent / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    if out is not None:
        (out / "omega_source.sass").write_text(sass)
    body = re.search(r"Function : \S*gaussian_omega_kernelILi2E\S*\n(.*?)(?=\n\s*Function :|\Z)",
                     sass, re.S).group(1)
    code = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            code.append((int(m.group(1), 16), m.group(2).strip()))
    staging = [addr for addr, text in code if text.startswith("STS")]
    loops = []
    for addr, text in code:
        m = re.search(r"BRA (0x[0-9a-f]+)", text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            if all(lo <= a <= addr for a in staging):
                loops.append((addr - lo, lo, addr))
    _, lo, hi = min(loops)
    ops = collections.Counter()
    for addr, text in code:
        if lo <= addr <= hi:
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            ops[op.split(".")[0]] += 1
    return sum(ops.values()), ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("omega_probe needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    srcs = variants((nvcc.CSRC_DIR / gcu.SOURCE).read_text())
    with ThreadPoolExecutor(len(srcs)) as pool:
        futures = {name: pool.submit(build, name, src) for name, src in srcs.items()}
        built = {name: f.result() for name, f in futures.items()}
    for name, (_, info) in built.items():
        print(f"[omega probe build] {name}: " + " | ".join(info), flush=True)

    dev = torch.device("cuda:0")
    ref = {}
    with loaded(built["source"][0]):
        for k, n, dist in SHAPES:
            ref[(k, n, dist)] = gcu.gaussian_omega(k, n, SEED, 2048, dist, device=dev)
    for rnd in range(args.rounds):
        for name, (lib_path, _) in built.items():
            with loaded(lib_path):
                for k, n, dist in SHAPES:
                    out = gcu.gaussian_omega(k, n, SEED, 2048, dist, device=dev)
                    diff = (None if name == "stores off" else
                            (out - ref[(k, n, dist)]).abs().max().item())
                    del out
                    ms = event_ms(lambda: gcu.gaussian_omega(k, n, SEED, 2048, dist,
                                                             device=dev), 20)
                    resident = gcu._resident_omega(0, gcu._mode(k, dist))
                    print(f"[omega probe] round={rnd} variant={name!r} k={k} n={n} "
                          f"dist={dist} ms={ms} resident_blocks={resident} "
                          f"max_diff_from_source={diff}", flush=True)
    count, ops = main_loop_opcodes(built["source"][0], args.out)
    print(f"[omega probe sass] cos-halves inner loop: {count} instructions (8 values an "
          f"iteration, rarely taken branches included): {dict(ops.most_common())}", flush=True)
    for k, n, _ in SHAPES[:2]:
        normal = event_ms(lambda: torch.empty((k, n), device=dev).normal_(), 20)
        fill = event_ms(lambda: torch.empty((k, n), device=dev).fill_(1.0), 20)
        print(f"[omega probe yardstick] k={k} n={n} normal_ms={normal} fill_ms={fill} "
              f"bytes_bound_ms={4.0 * k * n / 3.35e9}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
