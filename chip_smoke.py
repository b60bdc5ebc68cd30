#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``rla4mor_tpu_torch``) on one NVIDIA GPU.

    python chip_smoke.py [--grid 512] [--extensions 8]

Phases, each printing one line (any failed check raises and exits non-zero):

1. device: requires CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off;
2. build: compiles every kernel source of ``rla4mor_tpu_torch/csrc`` with
   nvcc, one process per source, all started together, and prints each
   build time; then the HMMA / HGMMA count of each tiled Gaussian instance
   in the built library's SASS (``cuobjdump -sass``; each must be > 0);
3. SRHT kernel vs plain: the one-pass SRHT kernel against its plain PyTorch
   version on the same inputs on the card, float32 and float64, at the
   slice's shapes (n = 261,121, m = 1 and 8) and the bench shape
   (``SrhtEmbedding(k=256, n=2^24).apply_random`` on a (56, B, R) block
   and on (n, 56) columns, ``BENCH_REPS`` launches each). Tolerance
   relative to max|ref|: 1e-12 in float64, 1e-4 in float32 (sums of up to
   1.7e7 terms); the plain float32 version's own error against float64 is
   printed beside it; ``[kernel bf16]``: the bf16 instance (float32 sums)
   at the slice's shapes, float32 and bf16 output, and at the bench shape
   (a (56, B, R) bf16 block and (n, 56) bf16 columns, float32 output), held
   to the plain version's float32 sums: 1e-4 for float32 output, 8e-3 for
   bf16 output (one bf16 rounding); its library call is the bf16 product
   with the explicit operator;
4. Gaussian kernels vs plain: the strip (the Omega kernel on one strip)
   against its plain version
   (Rademacher bit-equal, normal to 1e-5 absolute; seeds and strips differ,
   redraws are equal; mean, standard deviation and tails), and the sketch
   kernel against its plain version (1e-4 relative on the small branch,
   1e-5 on the tiled one) at the HwPrng path's
   shapes (n = 261,121, m = 1 and 5; k = 256 and 300 normal, 256
   Rademacher), at ``[hwprng block]``'s (m = ``BLOCK_SNAPSHOTS``) and at
   the bench shape (n = 2^23, k = 256, m = 8, 9, 16, 32, 64, 128, both
   dists; at m = 32 also k = 300 (cos halves) and a column-major x); each
   row names the branch it took (``SMALL_M_MAX[dist]``) and is held to
   that branch's bound; ``[gaussian omega]``: the whole scaled Omega in one
   launch against its plain version, in full at (200, 3 W + 37) and (256,
   2^18 + 3), normal and Rademacher, and on strips 0, middle and last (cut)
   at [precond hwprng]'s (200, 1,050,625, cos halves) and at (256, 261,121)
   in pairs and Rademacher mode (Rademacher bit-equal, normal within 1e-5
   absolute on the unscaled values); there its time by events and in a
   CUDA graph, its bound and share, beside the old composition (a strip
   launch a strip, ``torch.cat``, the slice and the scale) and a
   ``normal_`` fill of a (k, n) tensor (a yardstick of generate-and-store,
   not the same function), with the peak memory of each;
5. the SRHT slice: thermal block 2x2 at ``--grid`` intervals (n = 261,121
   at 512, so every sketch takes the kernel), SRHT k = 300 over the h1_0
   sqrt factor, Galerkin reductor, weak greedy over 200 training
   parameters with ``--extensions`` extensions, then ``serve_batch`` on 4
   request batches padded to 256;
6. the HwPrng path on the same FOM: ``HwPrngGaussianEmbedding`` k = 256
   over the sqrt factor, online Gaussian k = 64, Galerkin greedy with
   ``HW_EXTENSIONS`` extensions, ``reduce_adaptive`` over 64 held-out
   parameters (tol 0.2), ``serve_batch`` on one batch padded to 256, and
   ``apply == random_matrix() @ (Q U)`` on the final basis (1e-4 relative:
   the only Omega-kernel launch, one and no strip launch, counted apart
   from the path's);
   then a second ``reduce_adaptive`` from an online k = 32 at tol 0.05,
   which must double the online sketch at least once;
   ``[bf16]``: the bf16 offline mode on the same FOM,
   ``SketchedReductor(offline_dtype=torch.bfloat16)`` with the slice's SRHT,
   ``rb_greedy_padded`` for ``BF16_EXTENSIONS`` extensions over the slice's
   200 training parameters, one batch served; rb must be bf16, srb and the
   residual stacks float32, the bf16 instance launched (counts by input
   dtype); its estimates are held to the residual of the path's float32
   snapshots combined as its sketched basis, where that residual is above
   ``BF16_FLOOR`` of the dual norm of b (the count checked is printed);
   ``[padded]``: ``PaddedSketchedReductor`` (float32, r_max =
   ``PADDED_EXTENSIONS``) and ``rb_greedy_no_retrace``, the state's shapes
   fixed throughout; prints whether it selected the slice's first
   parameters (same seed schedule); ``[strong]``: ``STRONG_TRAINING``
   parameters solved once, ``extend_basis_blocked`` (blocks of 4) against
   single-column extensions (srb within 1e-5), ``rb_greedy_strong`` for
   ``STRONG_EXTENSIONS`` extensions, whose max true error must decay;
   ``[hwprng block]``: ``HwPrngGaussianEmbedding`` k = 256 over the sqrt
   factor fed [strong]'s snapshots and ``BLOCK_SNAPSHOTS`` - 6 more by
   ``extend_basis_blocked`` (one block, the tiled kernel: its launches
   by branch, counted just around extension and ``reduce()``, must show
   tiled ones) into a reductor with ``truncation_rtol`` =
   ``BLOCK_TRUNCATION_RTOL``, the ROM's held-out checks, and the sketched snapshots of
   blocked and single-column extensions (small branch) compared before
   orthonormalisation (srb and residual stacks within 1e-5).
   Checks of the paths: finite outputs, the last max estimate below the
   first, ROM outputs within 5e-2 of the host FOM at 4 held-out
   parameters, the sketched estimate within a factor 2 of the exact dual
   residual norm there, and each kernel of the path launched (counts set
   to 0 just before the path and read just after);
7. the large slice (``[large]``), through the entry point
   ``rla4mor_tpu_torch.examples.large_scale_demo.run``: the matrix-free
   ``StencilThermalBlock((2, 2), LARGE_GRID)`` in float32 (n = 4,198,401),
   MG-CG (tol 1e-7, at most 300 iterations), SRHT k = 256 of the snapshot
   and its 4 residual terms (one (1 + T, n) row-wise block a step, the
   kernel's rows layout), ``LARGE_STEPS`` greedy steps over a batch of 8
   candidates, ``state_to_rom`` and one batch padded to 256 served; then
   once more at grid ``LARGE_SMALL_GRID`` (n = 263,169). First the SRHT
   kernel against its plain version at that path's shapes (m = 1, the rhs;
   m = 5 in the rows layout, the step's block; 1e-4 relative). Each step
   prints its seconds (the first pays any build), CG iterations, recursive
   and true relative residual (float64). Checks: finite state and
   estimates, ``ncols == LARGE_STEPS``, the last median estimate below the
   first, the kernel launched on the path (count set to 0 just before, read
   just after), ROM outputs within 5e-2 of a float64 MG-CG solve on the
   card at 4 held-out parameters, and there the sketched estimate within
   [0.5, 2] of the exact l2 residual ||A(mu) U y - b||_2 in float64 wherever
   that residual is above 1e-3 ||b||_2 (below, the float32 sketched estimate
   is floored; the count checked is printed). U is rebuilt in float64 from
   the path's snapshots: the combination C with srb = S(snapshots) C, by
   least squares in sketch space. One more step under ``torch.profiler``
   prints the top device operations and the device's idle share.
   Then the other stencil families the same way (``FAMILY_PHASES``):
   ``[large advection]`` (``StencilAdvectionDiffusion`` at grid 2048,
   BiCGStab preconditioned by the V-cycle on eps K, minres, the (4, n)
   block), ``[large helmholtz]`` (``StencilHelmholtz`` at grid 2048,
   BiCGStab with the V-cycle on K, minres, (3, n)) and ``[large
   thermal3d]`` (``StencilThermalBlock3D((2, 2, 2), 255)``, 256^3 =
   16,777,216 nodes, Jacobi-CG at most ``FAMILY_CG_MAXITER`` iterations,
   Galerkin, (9, 2^24)): the kernel against its plain version at the
   family's block (the library product with the explicit operator, 17.2 GB
   at 2^24, built and freed), the path, SRHT launches equal to 1 (the rhs)
   plus 1 a step, solver iterations and residuals a step and the solves
   that reached maxiter with a finite iterate (BiCGStab breakdowns), the
   held-out checks against the family's own float64 solve (MG-BiCGStab or
   Jacobi-CG, tol 1e-10; the ROM output error reported, not held: these
   manifolds converge more slowly) and one profiled step;
8. the sketched preconditioner selector (``[precond]``), through the entry
   point ``rla4mor_tpu_torch.examples.preconditioned_large_demo.run`` at
   its defaults: ``StencilThermalBlock((2, 2), PRECOND_GRID)`` in float32
   (n = 1,050,625), 5 MG-CG snapshots, the ``ur_ur`` HS key, SRHT residual
   rows (k = ``PRECOND_K_RES``), 3 ``RecycledCGInverseOp`` directions, the
   batched online stage over ``PRECOND_NMU`` parameters beside a loop over
   8, the ROM against MG-CG at 3 of them. Checks: ``solve_batch`` equals
   the per-parameter ``solve`` (1e-4 relative), and at each direction's
   own parameter the HS residual is at most 1e-3 of ||h||. Then
   ``[precond hwprng]``: the same FOM, basis and first direction in a
   ``PreconditionedRom`` with a ``HwPrngGaussianEmbedding`` residual
   embedding, whose ``source_array`` is the Omega kernel's path (one
   launch for the whole (200, 1,050,625) Omega and no strip launch; counts
   set to 0 just before, read just after; its peak memory); its strips
   against the plain ones (1e-5), its transpose against the sketch kernel
   on 4 columns (1e-5 relative), and its residual estimate against the
   SRHT one at the first direction alone, within [0.5, 2] at 3 held-out
   parameters. Before them the strip kernel at that shape (k = 200, cos
   halves) against its plain version;
9. state estimation (``[estim]``), through the entry point
   ``rla4mor_tpu_torch.examples.inverse_problems_demo.run``:
   ``ThermalBlockFOM((3, 3), ESTIM_GRID)`` in float32 (n = 36,481), 200
   training and ``ESTIM_TEST`` = 32 test states (host ``splu`` in a pool
   of threads), m = 50 observations, PBDW with a 20-mode POD, dictionary
   recovery of the 32 columns over 200 atoms (the LARS paths once, in
   float64), each column's path point selected by the manifold distance
   of the residual sketch (k = 256, one sketch of the K + m = 250 columns
   a term) through the Gaussian, SRHT and HwPrng embeddings, and the path
   study of the worst column; then the Gaussian run in float64 from the
   same host solves. First the SRHT kernel (1e-4) and the tiled Gaussian
   branch (1e-5) against their plain versions at that sketch, (36,481,
   250), with the FWHT route's time beside the SRHT's. Checks: the SRHT
   kernel and the tiled branch launched on the path (counts set to 0 just
   before, read just after); along the worst column's path each sketched
   manifold distance within [0.5, 2] of the exact one (an
   ``IdentityEmbedding``) where that is above 1e-3 of its largest;
   float32 PBDW within 1e-4 of float64 in the R norm; each float32
   recovery error within a factor 2 of float64's (the columns whose
   selected atoms differ are counted). It prints the seconds of each part
   (FOM solves, the sketch's host part and each embedding's, PBDW, the
   LARS paths, each embedding's selection and path study), the homotopy
   steps, the errors and the card's name and power limit;
10. the kernels' JSON line (the bf16 instance a row of its own, with the
   ``[bf16]`` path's bf16-input launches; the SRHT at each stencil
   family's block a row, with that phase's launches; the tiled Gaussian branch a row
   of its own, with ``[hwprng block]``'s tiled launches at the bench m =
   128 shape; the Omega kernel at ``[precond hwprng]``'s shape with its
   launches, and at (256, 261,121) in pairs and Rademacher mode; its
   one-strip call at k = 200 and 256; the SRHT and the tiled Gaussian
   branch at [estim]'s sketch with that path's launches), the run's wall
   time, then the result line.

Times are CUDA-event means over back-to-back calls after a warm-up (the
wrapper's host time included where it is longer than the kernel's); an
SRHT kernel row also prints ``graph_ms``, the same calls captured in one
CUDA graph and replayed, which leaves the host's time out.
Every kernel row also times one library call on the same input
(``torch.matmul`` with the explicit
operator, TF32 off: the SRHT matrix built on the card, a pre-drawn Gaussian
Omega), a yardstick that the port never calls. Bounds: the larger of the bytes
the function must move (each input read once, each output written once)
at 3.35 TB/s and the operations the function needs at the card's peak for
their type (67 TFLOP/s float32 on the CUDA cores, 67 TFLOP/s float64 on
the tensor cores), from this run's shapes. For the SRHT that is the
cheapest of the direct product (2 k n flop per column), an FWHT of length
2^d (2^d d adds per column, n <= 2^d) and the blocked FWHT the kernel does
(B R log2 R + k B adds per column, B = ceil(n / R) blocks of R =
2^min(11, d)); for the Gaussian sketch 2 k n m flop, at 67 TFLOP/s on the
small branch and, on the tiled branch, 3 (Rademacher 2) TF32 passes of
them at the tensor cores' dense rate: 2048 TF32 flop a clock per SM
(``TF32_FLOP_PER_CLOCK_SM``, one mma.m16n8k8, which ``probes/int_rates.cu``
measures at 1.04 a clock per SM) at the card's SM count and maximum SM
clock, as the generation term below.
The Gaussian sketch, strip and Omega rows have a third term, the
generation: the Philox4x32-10 calls this run's shape needs (k ceil(n/4) in
pairs and Rademacher mode, 2 k ceil(n/4) in cos-halves mode; n = W for a strip;
once per column chunk of ``TILED_CHUNK`` on the tiled branch),
each at the 32 x 32 -> 64-bit multiplies (IMAD.WIDE.U32) that its own
counter needs, over 32 of them per clock per SM, the card's SM count and
its maximum SM clock (nvidia-smi clocks.max.sm). A call has 20 such
multiplies, but under the counter (j4, r, draw, 0) and the key (seed, b)
the first ones depend on fewer indices than the call: round 0 multiplies
j4 (one column quad) and draw, round 1 words of (draw, r) and of (j4, b),
round 2's first word one of (j4, b, draw): each is shared by every row of
a draw or every column. So a call needs 15 of its own (one in round 2,
two in each of rounds 3-9); its 17 three-input XORs run on another pipe
at 64 a clock and bound less. It is a lower bound: it leaves out that
shared work, the key schedule, Box-Muller and the contraction, and runs
every SM at its top clock. The
largest of the three terms is the bound; a row says
``bound_by=generation`` where that term wins, and the kernels' JSON line,
whose words are "bytes" and "operations", says "operations" for it.

Imports no JAX. Needs the repository (it imports ``rla4mor_tpu_torch``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SLICE_N = 261_121  # (512 - 1)^2 thermal-block unknowns
SLICE_K = 300
BENCH_LOG2N, BENCH_K, BENCH_M = 24, 256, 56
BENCH_REPS = 10
GAUSS_K, GAUSS_W = 256, 2048
HW_EXTENSIONS = 6  # the HwPrng greedy runs at full width
GAUSS_BENCH_LOG2N, GAUSS_BENCH_MS = 23, (8, 9, 16, 32, 64, 128)
LARGE_GRID, LARGE_SMALL_GRID = 2048, 512
# 8 weak-greedy steps over the batch of 8 candidates: 4 random ones leave
# the ROM's output 2-8% off at held-out parameters on an H100 at grid 512
# (exact Galerkin on 4 such snapshots is 1.5-5.9% off on the CPU), above
# the 5e-2 output check that the small slice is held to
LARGE_K, LARGE_STEPS = 256, 8
# the other stencil families at full width through large_scale_demo.run:
# advection and Helmholtz on grid 2048 (n = 4,198,401, MG-BiCGStab, minres),
# the 3-D block on 256^3 = 2^24 nodes (grid 255, Jacobi-CG, Galerkin); the
# block of a step is the snapshot and its T residual terms. Helmholtz takes
# 4 steps: its one-parameter manifold is resolved to the float32 floor by 4
# snapshots (the median estimate falls 100x over steps 0-3 and 1.5x over
# 4-7, CPU float32 at grid 512), and past it a snapshot adds only rounding
# noise, which the append refuses (the 8th there)
FAMILY_PHASES = (  # (family, grid, steps, 1 + T)
    ("advection", LARGE_GRID, LARGE_STEPS, 4),
    ("helmholtz", LARGE_GRID, 4, 3),
    ("thermal3d", 255, 4, 9),
)
FAMILY_CG_MAXITER = 6000  # the 3-D float64 reference solve (Jacobi-CG)
# the bf16 offline path: 6 greedy extensions; the padded path 6 (4 leave the
# ROM 8.1e-2 off at a held-out parameter, CPU float64 at grid 128, above the
# 5e-2 output check); the strong greedy 5 extensions over 6 solved parameters
BF16_EXTENSIONS, PADDED_EXTENSIONS = 6, 6
STRONG_TRAINING, STRONG_EXTENSIONS = 6, 5
# [hwprng block]: [strong]'s 6 snapshots and 6 more, one block of 12 (> 8:
# the tiled branch). Their sketch is conditioned at 1.1-1.4e5 (CPU, grids
# 32-512): past float32, the 12th direction is rounding noise, and a
# float32 reductor that keeps it (the JAX package's as much as the port's,
# tests/test_torch_block_float32.py) gives a ROM whose exact residual is
# up to 230 times b's (grid 512) and whose estimate is 0.004-0.07 of it.
# The JAX package's setting for a float32 offline stage, truncation_rtol
# about sqrt(eps) = 3.45e-4 (rla4mor_tpu/mor/sketched_reductor.py:93-99),
# drops it at grid 128, but at grid 512 that direction is 3.4e-4 of its
# column and stays (an H100 run: outputs 7.8e-2 off); 1e-3 drops it there
# too (the next smallest is 1.2e-3): 11 kept, every check holds
BLOCK_SNAPSHOTS, BLOCK_TRUNCATION_RTOL = 12, 1e-3
# below 4 x 2^-7 of the dual norm of b a bf16-offline estimate is at its
# floor (tests/test_bf16_offline.py)
BF16_FLOOR = 4 * 2.0 ** -7
# [precond]: examples/preconditioned_large_demo.py's defaults
PRECOND_GRID, PRECOND_K_RES, PRECOND_NMU = 1024, 200, 64
PRECOND_N = (PRECOND_GRID + 1) ** 2  # 1,050,625 stencil unknowns
PRECOND_HW_SEED = 21
# [estim]: examples/inverse_problems_demo.py's run() on ThermalBlockFOM((3, 3),
# 192), n = 191^2 = 36,481: 200 training and 32 test states, m = 50
# observations, 200 atoms, the residual sketch of the K + m = 250 columns at
# k = 256 through each embedding
ESTIM_GRID, ESTIM_TEST = 192, 32
ESTIM_N, ESTIM_COLS, ESTIM_K = (ESTIM_GRID - 1) ** 2, 250, 256
TOL = {torch.float64: 1e-12, torch.float32: 1e-4}
TOL_NARROW = 8e-3  # 2-byte output against the float32 sums: one bf16 rounding
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
TF32_FLOP_PER_CLOCK_SM = 2048  # dense TF32 on the tensor cores (the tiled Gaussian branch)
PHILOX_WIDE_MULS = 15  # per Philox4x32-10 call of an Omega (module docstring)
WIDE_MULS_PER_CLOCK_SM = 32  # IMAD.WIDE.U32 rate of compute capability 9.0


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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the launches back to back, no host work between."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, dtype, philox_calls: float = 0.0,
          wide_muls_per_s: float = 1.0, flops_per_s: float | None = None) -> tuple[float, str]:
    """(least time in ms, the term that sets it): bytes, operations
    (floating point, at ``flops_per_s``, default the dtype's peak) or
    generation (Philox's wide multiplies)."""
    rate = PEAK_FLOPS[dtype] if flops_per_s is None else flops_per_s
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / rate * 1e3,
             "generation": philox_calls * PHILOX_WIDE_MULS / wide_muls_per_s * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


def philox_calls(k: int, n: int, dist: str) -> int:
    """Philox calls a (k, n) Omega needs under the contract (columns < n
    only; a quad cut by n still takes its whole call)."""
    quads = -(-n // 4)
    if dist == "normal" and k % 128:
        return 2 * k * quads  # cos halves: 2 calls for 4 entries of one row
    return k * quads  # pairs: 2 calls for 8 entries; Rademacher: 1 for 4


def compare(label, x_cols, k, signs, sampling, reps, kernel, library=None, out_dtype=None,
            library_note=None):
    """``kernel()`` (a call that launches the kernel on ``x_cols``, emitting
    ``out_dtype``, default x's) against the plain version on the same input;
    returns the row of numbers. Output in the sums' dtype is held to
    ``TOL``, 2-byte output to ``TOL_NARROW`` against the plain version's
    float32 sums."""
    from rla4mor_tpu_torch.ops import srht_cuda

    out_dtype = x_cols.dtype if out_dtype is None else out_dtype
    acc = srht_cuda.accumulator_dtype(x_cols.dtype)
    out = kernel()
    plain = srht_cuda.srht_onepass_plain(x_cols, k, signs, sampling, acc)
    torch.cuda.synchronize()
    check(out.dtype == out_dtype, f"{label}: kernel emitted {out.dtype}, not {out_dtype}")
    scale = plain.abs().max().item()
    err = (out.to(acc) - plain).abs().max().item()
    row = {"label": label, "dtype": str(x_cols.dtype).replace("torch.", ""),
           "out": str(out_dtype).replace("torch.", ""),
           "max_abs_err": err, "rel_err": err / scale}
    if x_cols.dtype == torch.float32:
        ref = srht_cuda.srht_onepass_plain(x_cols.double(), k, signs, sampling)
        s64 = ref.abs().max().item()
        row["plain_f32_vs_f64"] = (plain.double() - ref).abs().max().item() / s64
        row["kernel_f32_vs_f64"] = (out.double() - ref).abs().max().item() / s64
        del ref
    del out, plain
    # back-to-back calls timed by events (the wrapper's host time where it
    # is the longer), and the kernel alone: the calls replayed from a graph
    row["ms"] = cuda_ms(kernel, reps)
    row["graph_ms"] = graph_ms(kernel, reps)
    row["plain_ms"] = cuda_ms(
        lambda: srht_cuda.srht_onepass_plain(x_cols, k, signs, sampling, out_dtype), reps)
    row["library_ms"] = None if library is None else cuda_ms(library, reps)
    if library_note:
        row["library"] = library_note
    n, m = x_cols.shape
    size = x_cols.element_size()
    nbytes = n * m * size
    row["GBps"] = nbytes / row["ms"] / 1e6
    row["plain_GBps"] = nbytes / row["plain_ms"] / 1e6
    # x, the int8 signs and int32 sampled rows read once, the output written;
    # the operations of the cheapest algorithm: the direct product, an FWHT
    # of length 2^d, or the blocked one (an FWHT of each of the B = ceil(n/R)
    # blocks, R = 2^min(11, d), then k adds a block), in the sums' dtype
    d = max(1, (n - 1).bit_length())
    r_log = min(11, d)
    blocks = -(-n // (1 << r_log))
    ops = m * min(2.0 * k * n, float(d << d),
                  float((blocks << r_log) * r_log + k * blocks))
    out_size = torch.empty((), dtype=out_dtype).element_size()
    row["bound_ms"], row["bound_by"] = bound(nbytes + n + 4 * k + k * m * out_size, ops, acc)
    row["share"] = row["bound_ms"] / row["ms"]
    phase("kernel bf16" if size == 2 else "kernel", **row)
    tol = TOL[acc] if out_dtype == acc else TOL_NARROW
    check(row["rel_err"] <= tol,
          f"{label} {row['dtype']} -> {row['out']}: kernel vs plain {row['rel_err']:.3e} > "
          f"{tol:.0e}")
    return row


def explicit_srht(signs, sampling, n: int, k: int, dtype, device,
                  chunk: int = 1 << 20) -> torch.Tensor:
    """The (k, n) SRHT matrix built on the card, column chunk by chunk:
    S[s, i] = signs[i] (-1)^popcount(sampling[s] & i) / sqrt(k) (the
    library yardstick's operand; the port never forms it)."""
    S = torch.empty((k, n), dtype=dtype, device=device)
    samp = sampling.to(device=device, dtype=torch.int64)[:, None]
    sg = signs.to(device=device, dtype=dtype)
    for c0 in range(0, n, chunk):
        c1 = min(n, c0 + chunk)
        a = samp & torch.arange(c0, c1, device=device, dtype=torch.int64)[None, :]
        for shift in (32, 16, 8, 4, 2, 1):  # parity folds into bit 0
            a ^= a >> shift
        S[:, c0:c1] = (1 - 2 * (a & 1)).to(dtype) * sg[c0:c1] / math.sqrt(k)
        del a
    return S


def kernel_phase(device) -> list[dict]:
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
    from rla4mor_tpu_torch.ops.fwht import _srht_plan, srht_rows

    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    plan = _srht_plan(1, SLICE_N, SLICE_K)
    # the plan in the kernel's types (int8 signs, int32 rows), as an
    # SrhtEmbedding holds it
    signs, sampling = plan[0].to(device), plan[1].to(device, torch.int32)
    # the library yardstick: one product with the explicit (k, n) SRHT matrix
    explicit = srht_rows(plan, SLICE_N, SLICE_K, device=device)
    built = explicit_srht(signs, sampling, SLICE_N, SLICE_K, torch.float64, device)
    check(torch.allclose(built, explicit, rtol=0, atol=1e-15),
          "explicit SRHT matrix built on the card differs from srht_rows")
    del built
    for m in (1, 8):
        for dt in (torch.float32, torch.float64):
            x = torch.randn((SLICE_N, m), generator=gen, device=device, dtype=dt)
            S = explicit.to(dt)
            rows.append(compare(
                f"slice n={SLICE_N} m={m} k={SLICE_K}", x, SLICE_K, signs, sampling,
                reps=100, kernel=lambda x=x: srht_cuda.srht_onepass(
                    x, SLICE_K, signs, sampling),
                library=lambda x=x, S=S: torch.matmul(S, x)))
            del x, S
    del explicit

    n = 1 << BENCH_LOG2N
    for dt in (torch.float32, torch.float64):
        emb = SrhtEmbedding(BENCH_K, n, seed=0, device=device, dtype=dt)
        b_signs, b_samp, _ = emb.plan
        B, R = emb.blocked_shape
        rows_x = torch.randn((BENCH_M, n), generator=gen, device=device, dtype=dt)
        blocked = rows_x.view(BENCH_M, B, R)
        S = explicit_srht(b_signs, b_samp, n, BENCH_K, dt, device)
        rows.append(compare(
            f"bench blocked (m,B,R)=({BENCH_M},{B},{R}) k={BENCH_K}", rows_x.T,
            BENCH_K, b_signs, b_samp, reps=BENCH_REPS,
            kernel=lambda: emb.apply_random(blocked),
            library=lambda: torch.matmul(S, rows_x.T)))
        del blocked
        cols = rows_x.T.contiguous()
        del rows_x
        rows.append(compare(
            f"bench columns (n,m)=({n},{BENCH_M}) k={BENCH_K}", cols, BENCH_K,
            b_signs, b_samp, reps=BENCH_REPS, kernel=lambda: emb.apply_random(cols),
            library=lambda: torch.matmul(S, cols)))
        del cols, S
        torch.cuda.empty_cache()
    return rows


def kernel_bf16_phase(device) -> list[dict]:
    """The bf16 instance against its plain version: the slice's shapes
    (m = 1 and 8, float32 and bf16 output) and the bench shape (a (56, B, R)
    bf16 block and (n, 56) bf16 columns, float32 output, the offline mode's
    request). Library: ``torch.matmul`` of the explicit operator in bf16
    (cuBLAS sums in float32 and rounds to bf16), TF32 off."""
    from rla4mor_tpu_torch.ops import srht_cuda
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
    from rla4mor_tpu_torch.ops.fwht import _srht_plan

    bf16, f32 = torch.bfloat16, torch.float32
    note = "torch.matmul bf16 (cuBLAS: float32 sums, bf16 out)"
    gen = torch.Generator(device=device).manual_seed(2)
    rows = []
    plan = _srht_plan(1, SLICE_N, SLICE_K)
    signs, sampling = plan[0].to(device), plan[1].to(device, torch.int32)
    S = explicit_srht(signs, sampling, SLICE_N, SLICE_K, bf16, device)
    for m in (1, 8):
        x = torch.randn((SLICE_N, m), generator=gen, device=device).to(bf16)
        for out_dtype in (f32, bf16):
            rows.append(compare(
                f"slice n={SLICE_N} m={m} k={SLICE_K}", x, SLICE_K, signs, sampling,
                reps=100, out_dtype=out_dtype, library_note=note,
                kernel=lambda x=x, o=out_dtype: srht_cuda.srht_onepass(
                    x, SLICE_K, signs, sampling, o),
                library=lambda x=x: torch.matmul(S, x)))
        del x
    del S

    n = 1 << BENCH_LOG2N
    emb = SrhtEmbedding(BENCH_K, n, seed=0, device=device, dtype=f32)
    b_signs, b_samp, _ = emb.plan
    B, R = emb.blocked_shape
    rows_x = torch.randn((BENCH_M, n), generator=gen, device=device).to(bf16)
    blocked = rows_x.view(BENCH_M, B, R)
    S = explicit_srht(b_signs, b_samp, n, BENCH_K, bf16, device)
    rows.append(compare(
        f"bench blocked (m,B,R)=({BENCH_M},{B},{R}) k={BENCH_K}", rows_x.T, BENCH_K,
        b_signs, b_samp, reps=BENCH_REPS, out_dtype=f32, library_note=note,
        kernel=lambda: emb.apply_random(blocked, out_dtype=f32),
        library=lambda: torch.matmul(S, rows_x.T)))
    del blocked
    cols = rows_x.T.contiguous()
    del rows_x
    rows.append(compare(
        f"bench columns (n,m)=({n},{BENCH_M}) k={BENCH_K}", cols, BENCH_K, b_signs, b_samp,
        reps=BENCH_REPS, out_dtype=f32, library_note=note,
        kernel=lambda: emb.apply_random(cols, out_dtype=f32),
        library=lambda: torch.matmul(S, cols)))
    del cols, S
    torch.cuda.empty_cache()
    return rows


def gaussian_strip_phase(device, wide_muls_per_s: float) -> dict:
    """The strip kernel against its plain version, and its statistics;
    returns the normal strip's row."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    rows = {}
    for dist in ("normal", "rademacher"):
        strips, errs = {}, []
        for k, seed, b in ((GAUSS_K, 7, 0), (GAUSS_K, 7, 1), (GAUSS_K, 8, 0), (300, 7, 5)):
            S = gcu.gaussian_strip(k, seed, b, GAUSS_W, dist, device=device)
            P = gcu.gaussian_strip_plain(k, seed, b, GAUSS_W, dist, device=device)
            errs.append((S - P).abs().max().item())
            if dist == "rademacher":
                check(torch.equal(S, P), f"rademacher strip {(k, seed, b)} not bit-equal")
            check(errs[-1] <= 1e-5, f"{dist} strip {(k, seed, b)}: |kernel - plain| "
                  f"{errs[-1]:.2e} > 1e-5")
            strips[(k, seed, b)] = S
        S0 = strips[(GAUSS_K, 7, 0)]
        check(torch.equal(S0, gcu.gaussian_strip(GAUSS_K, 7, 0, GAUSS_W, dist,
                                                 device=device)), "redraw differs")
        check(not torch.equal(S0, strips[(GAUSS_K, 7, 1)]), "strips 0 and 1 equal")
        check(not torch.equal(S0, strips[(GAUSS_K, 8, 0)]), "seeds 7 and 8 equal")
        v = S0.double().ravel()
        mean, std = v.mean().item(), v.std().item()
        check(abs(mean) < 5e-3 and abs(std - 1.0) < 5e-3, f"{dist} mean {mean} std {std}")
        if dist == "rademacher":
            check(set(torch.unique(v).tolist()) == {-1.0, 1.0}, "rademacher values")
        else:
            check(v.min().item() < -3.5 and v.max().item() > 3.5, "normal tails")
        row = {"dist": dist, "k": GAUSS_K, "W": GAUSS_W, "mean": mean, "std": std,
               "min": v.min().item(), "max": v.max().item(), "max_abs_err": max(errs)}
        row["ms"] = cuda_ms(lambda: gcu.gaussian_strip(
            GAUSS_K, 7, 0, GAUSS_W, dist, device=device), 50)
        row["plain_ms"] = cuda_ms(lambda: gcu.gaussian_strip_plain(
            GAUSS_K, 7, 0, GAUSS_W, dist, device=device), 10)
        # no input; the (k, W) float32 output written once; its generation
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * GAUSS_K * GAUSS_W, 0.0, torch.float32,
            philox_calls(GAUSS_K, GAUSS_W, dist), wide_muls_per_s)
        row["share"] = row["bound_ms"] / row["ms"]
        row["library_ms"] = None
        phase("gaussian strip", **row)
        rows[dist] = row
    return rows["normal"]


def gaussian_sketch_row(label, x, k, dist, reps, gen, rates: tuple[float, float]) -> dict:
    """The sketch kernel on ``x`` against its plain version (1e-4 relative
    on the small branch, 1e-5 on the tiled one) and the library product,
    with the bound of the branch it takes: the small branch's product at
    the CUDA cores' float32 rate, the tiled branch's 3 (Rademacher 2) TF32
    passes at the tensor cores' rate and its Omega drawn once per column
    chunk. ``rates`` is (IMAD.WIDE, dense TF32 flop) per second."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    n, m = x.shape
    wide_muls_per_s, tf32_flops_per_s = rates
    branch = "small" if m <= gcu.SMALL_M_MAX[dist] else "tiled"
    counts = gcu.gaussian_sketch.launches_by_branch
    before = counts[branch]
    out = gcu.gaussian_sketch(x, k, 3, GAUSS_W, dist)
    check(counts[branch] == before + 1, f"{label}: not the {branch} branch")
    plain = gcu.gaussian_sketch_plain(x, k, 3, GAUSS_W, dist)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    row = {"label": label, "dist": dist, "branch": branch,
           "layout": "rows" if x.stride(1) == 1 else "columns", "max_abs_err": err,
           "rel_err": err / plain.abs().max().item()}
    del out, plain
    row["ms"] = cuda_ms(lambda: gcu.gaussian_sketch(x, k, 3, GAUSS_W, dist), reps)
    row["plain_ms"] = cuda_ms(lambda: gcu.gaussian_sketch_plain(x, k, 3, GAUSS_W, dist),
                              max(1, reps // 5))
    omega = torch.randn((k, n), generator=gen, device=x.device) / math.sqrt(k)
    row["library_ms"] = cuda_ms(lambda: torch.matmul(omega, x), reps)
    del omega
    row["GBps"] = 4.0 * n * m / row["ms"] / 1e6
    if branch == "tiled":
        passes, chunks = (3 if dist == "normal" else 2), -(-m // gcu.TILED_CHUNK)
        row["bound_ms"], row["bound_by"] = bound(
            4.0 * (n * m + k * m), passes * 2.0 * k * n * m, torch.float32,
            chunks * philox_calls(k, n, dist), wide_muls_per_s, tf32_flops_per_s)
    else:
        row["bound_ms"], row["bound_by"] = bound(4.0 * (n * m + k * m), 2.0 * k * n * m,
                                                 torch.float32, philox_calls(k, n, dist),
                                                 wide_muls_per_s)
    row["share"] = row["bound_ms"] / row["ms"]
    phase("gaussian sketch", **row)
    # the tiled branch at 1e-5, the CPU mirror's limit: one TF32 pass, or a
    # normal product without its Omega_lo x_hi pass, is 1.4-3e-4 off
    tol = 1e-5 if branch == "tiled" else 1e-4
    check(row["rel_err"] <= tol, f"{label}: kernel vs plain {row['rel_err']:.3e} > {tol}")
    return row


def gaussian_kernel_phase(device, rates: tuple[float, float]) -> tuple[dict, list[dict]]:
    gen = torch.Generator(device=device).manual_seed(1)
    strip_row = gaussian_strip_phase(device, rates[0])
    rows = []
    for m in (1, 5):
        x = torch.randn((SLICE_N, m), generator=gen, device=device)
        for k, dist in ((GAUSS_K, "normal"), (300, "normal"), (GAUSS_K, "rademacher")):
            rows.append(gaussian_sketch_row(f"path n={SLICE_N} m={m} k={k}", x, k,
                                            dist, 20, gen, rates))
        del x
    # [hwprng block]'s shape: one block of BLOCK_SNAPSHOTS columns
    x = torch.randn((SLICE_N, BLOCK_SNAPSHOTS), generator=gen, device=device)
    rows.append(gaussian_sketch_row(f"block n={SLICE_N} m={BLOCK_SNAPSHOTS} k={GAUSS_K}", x,
                                    GAUSS_K, "normal", 20, gen, rates))
    del x
    n = 1 << GAUSS_BENCH_LOG2N
    for m in GAUSS_BENCH_MS:
        x = torch.randn((n, m), generator=gen, device=device)
        for dist in ("normal", "rademacher"):
            rows.append(gaussian_sketch_row(f"bench n={n} m={m} k={GAUSS_K}", x,
                                            GAUSS_K, dist, 5, gen, rates))
        if m == 32:  # cos halves (k % 128 != 0), and a column-major x
            rows.append(gaussian_sketch_row(f"bench n={n} m={m} k=300", x, 300, "normal",
                                            5, gen, rates))
            del x
            x = torch.randn((m, n), generator=gen, device=device).T
            rows.append(gaussian_sketch_row(f"bench n={n} m={m} k={GAUSS_K} column-major",
                                            x, GAUSS_K, "normal", 5, gen, rates))
        del x
        torch.cuda.empty_cache()
    return strip_row, rows


def tiled_sass() -> list[dict]:
    """HMMA / HGMMA instructions in each tiled instance of the built
    Gaussian library (``cuobjdump -sass``): the tensor cores are used."""
    import re
    import shutil

    from rla4mor_tpu_torch.ops import gaussian_cuda
    from rla4mor_tpu_torch.utils import nvcc

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(nvcc.library_path(gaussian_cuda.SOURCE))],
                          capture_output=True, text=True, check=True).stdout
    rows, name = [], None
    for line in text.splitlines():
        found = re.match(r"\s*Function : (\S+)", line)
        if found:
            name = found.group(1)
            if "tiled_kernel" in name:
                rows.append({"instance": re.sub(r"^.*tiled_kernelILi(\d)ELi(\d+)E.*$",
                                                r"mode\1_ntw\2", name), "mma": 0})
            continue
        if rows and "tiled_kernel" in name and re.search(r"\bHG?MMA\b", line):
            rows[-1]["mma"] += 1
    for row in rows:
        phase("sass tiled", **row)
    check(len(rows) == 15, f"tiled instances in the SASS: {len(rows)}, not 15")
    check(all(r["mma"] > 0 for r in rows), f"a tiled instance without HMMA / HGMMA: {rows}")
    return rows


def dual_residual_norm(fom, Ru, u: np.ndarray, mu) -> float:
    """||A(mu) u - b(mu)||_{R^-1} on the host, in float64."""
    r = fom.assemble_sparse(mu) @ u - fom.assemble_rhs(mu)
    v = Ru.inv.apply_host(r)
    return float(np.sqrt(max(r @ v, 0.0)))


def check_rom(fom, reductor, result, device, label, lift=None, floor=None) -> dict:
    """The checks the paths share: finite ROM, falling estimates, outputs
    and estimates against the host FOM at 4 held-out parameters. ``lift``
    maps reduced coefficients to the field whose exact dual residual the
    estimate is held to (default ``reductor.reconstruct``); with ``floor``,
    only where that residual is above floor x the dual norm of b."""
    rom, est = result.rom, result.max_estimates  # est None: no greedy ran
    check(est is None or all(math.isfinite(e) for e in est), f"{label}: greedy estimates {est}")
    for name, op in (("lhs", rom.lhs), ("rhs", rom.rhs),
                     ("est_lhs", rom.error_estimator.lhs),
                     ("est_rhs", rom.error_estimator.rhs),
                     ("out", rom.output_functional)):
        check(bool(torch.isfinite(op.stack).all()), f"{label}: ROM {name} not finite")
    if est is not None:
        check(est[-1] < est[0], f"{label}: max estimate did not drop: {est[0]} -> {est[-1]}")

    Ru = reductor.product
    lift = reductor.reconstruct if lift is None else lift
    held = fom.parameter_space.sample_randomly(4, seed=1, device=device)
    out_vec = fom.output_functional.stack[0, 0].double().cpu().numpy()
    zero = np.zeros(fom.solution_dim)
    rows = []
    for mu in held:
        u_fom = fom.solve_host(mu)
        u_r = rom.solve(mu)
        s_rom = float(rom.output(u_r, mu)[0])
        s_fom = float(out_vec @ u_fom)
        u = lift(u_r).double().cpu().numpy()
        true = dual_residual_norm(fom, Ru, u, mu)
        b_dual = dual_residual_norm(fom, Ru, zero, mu)
        est_mu = float(rom.estimate_error(mu, u_r))
        rows.append({"out_rel_err": abs(s_rom - s_fom) / abs(s_fom),
                     "est_over_true": est_mu / true,
                     "checked": floor is None or true > floor * b_dual,
                     "true_over_b": true / b_dual})
    for r in rows:
        check(math.isfinite(r["out_rel_err"]) and r["out_rel_err"] <= 5e-2,
              f"{label}: ROM output error {r['out_rel_err']:.3e} > 5e-2")
        if r["checked"]:
            check(0.5 <= r["est_over_true"] <= 2.0,
                  f"{label}: estimate / exact dual residual {r['est_over_true']:.3f} "
                  "outside [0.5, 2]")
    return {"max_est_first": None if est is None else est[0],
            "max_est_last": None if est is None else est[-1],
            "out_rel_err_max": max(r["out_rel_err"] for r in rows),
            "est_over_true": [round(r["est_over_true"], 4) for r in rows],
            "true_over_b": [float(f"{r['true_over_b']:.4e}") for r in rows],
            "estimates_checked": sum(r["checked"] for r in rows)}


def timed_greedy(fom, reductor, train, extensions, greedy=None):
    """A greedy (default ``rb_greedy``) with the host FOM solves timed and
    kept -> (result, s, solve s, the solved snapshots in order)."""
    from rla4mor_tpu_torch.mor import rb_greedy

    greedy = rb_greedy if greedy is None else greedy
    host_solve, snapshots = [], []
    solve = fom.solve

    def timed_solve(mu):
        t = time.perf_counter()
        u = solve(mu)
        host_solve.append(time.perf_counter() - t)
        snapshots.append(u)
        return u

    fom.solve = timed_solve
    t0 = time.perf_counter()
    try:
        result = greedy(fom, reductor, train, max_extensions=extensions, log_level=30)
        torch.cuda.synchronize()
    finally:
        fom.solve = solve
    return result, time.perf_counter() - t0, host_solve, snapshots


def slice_phase(fom, device, extensions: int, training: int = 200,
                batch: int = 256, requests=(256, 200, 97, 256)) -> dict:
    """The SRHT path once: SRHT-sketched greedy, checks, serving."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.mor import SketchedReductor
    from rla4mor_tpu_torch.ops import SrhtEmbedding, srht_cuda
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch

    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = SrhtEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=SLICE_K,
                               seed=0, device=device)
    reductor = SketchedReductor(fom, embedding_primal=theta, product=Ru,
                                projection="galerkin", log_level=30)
    train = fom.parameter_space.sample_randomly(training, seed=0, device=device)

    srht_cuda.srht_onepass.launches = 0
    result, t_greedy, host_solve, _ = timed_greedy(fom, reductor, train, extensions)
    checks = check_rom(fom, reductor, result, device, "srht")
    rom = result.rom

    pool = fom.parameter_space.sample_randomly(sum(requests), seed=2,
                                               device=device)
    serve_batch(rom, pad_batch(mu_stack(pool[:requests[0]]), batch)[0])  # warm-up
    torch.cuda.synchronize()
    served, off = 0, 0
    t0 = time.perf_counter()
    outs = []
    for count in requests:
        mus, valid = pad_batch(mu_stack(pool[off: off + count]), batch)
        out = serve_batch(rom, mus)
        outs.append({k: v[:valid] for k, v in out.items()})
        off += count
        served += valid
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = srht_cuda.srht_onepass.launches
    for out in outs:
        for key, v in out.items():
            check(bool(torch.isfinite(v).all()), f"served {key} not finite")

    return {
        "n": n, **path_summary(result, t_greedy, host_solve),
        **checks, "requests": served, "serve_s": t_serve,
        "requests_per_s": served / t_serve, "srht_launches": launches,
    }, result.selected_mus


def hwprng_phase(fom, device, extensions: int, training: int = 200,
                 batch: int = 256) -> dict:
    """The HwPrng path once: in-kernel Gaussian greedy, reduce_adaptive,
    serving, and the embedding's apply against its explicit matrix."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.mor import SketchedReductor
    from rla4mor_tpu_torch.ops import GaussianEmbedding, HwPrngGaussianEmbedding
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = HwPrngGaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=GAUSS_K,
                                         seed=1, dist="normal", device=device)
    phi = GaussianEmbedding.make(GAUSS_K, range_dim=64, seed=7, device=device)
    reductor = SketchedReductor(fom, embedding_primal=theta, embedding_online=phi,
                                product=Ru, projection="galerkin", log_level=30)
    train = fom.parameter_space.sample_randomly(training, seed=0, device=device)
    held = mu_stack(fom.parameter_space.sample_randomly(64, seed=3, device=device))

    gcu.gaussian_sketch.launches = 0
    gcu.gaussian_strip.launches = gcu.gaussian_omega.launches = 0
    result, t_greedy, host_solve, _ = timed_greedy(fom, reductor, train, extensions)
    greedy_sketches = gcu.gaussian_sketch.launches
    t0 = time.perf_counter()
    rom, info = reductor.reduce_adaptive(held, seed=0, tol=0.2)
    torch.cuda.synchronize()
    t_adaptive = time.perf_counter() - t0
    result.rom = rom  # the held-out checks use the ROM reduce_adaptive returns
    checks = check_rom(fom, reductor, result, device, "hwprng")

    # the online sketch above is accepted in its first round, so a second
    # call from k = 32 at a tighter tol drives the doubling branch
    reductor.embedding_online = GaussianEmbedding.make(GAUSS_K, range_dim=32, seed=11,
                                                       device=device)
    t0 = time.perf_counter()
    _, doubled = reductor.reduce_adaptive(held, seed=0, tol=0.05)
    torch.cuda.synchronize()
    t_doubling = time.perf_counter() - t0
    check(doubled["rounds"] >= 2 and doubled["online_dim"] > 32,
          f"reduce_adaptive from k_online=32 at tol 0.05 did not double: {doubled}")

    serving = serve_once(rom, fom, device, "hwprng", batch)
    # the path (greedy, reduce_adaptive, serving) never forms Omega: the
    # Omega kernel runs only in the random_matrix oracle check below
    path_omegas = gcu.gaussian_omega.launches + gcu.gaussian_strip.launches

    U = reductor.rb
    applied = theta.apply(U)
    explicit = theta.random_matrix() @ theta.sqrt_product.apply(U)
    matrix_rel = ((applied - explicit).abs().max() / explicit.abs().max()).item()
    del explicit
    sketch_launches = gcu.gaussian_sketch.launches
    oracle_omegas = gcu.gaussian_omega.launches - path_omegas
    check(matrix_rel <= 1e-4, f"hwprng apply vs random_matrix @ QU {matrix_rel:.2e}")
    check(sketch_launches > 0, "the HwPrng path launched no Gaussian sketch kernel")
    # the whole Omega in one launch, and no per-strip launch
    check(oracle_omegas == 1 and gcu.gaussian_strip.launches == 0,
          f"HwPrngGaussianEmbedding.random_matrix: {oracle_omegas} Omega launches and "
          f"{gcu.gaussian_strip.launches} strip launches, not 1 and 0")

    return {
        "n": n, "k": GAUSS_K, **path_summary(result, t_greedy, host_solve),
        "greedy_sketch_launches": greedy_sketches,
        "reduce_adaptive_s": t_adaptive, "online_dim": info["online_dim"],
        "certified": info["certified"], "max_rel_dev": info["max_rel_dev"],
        "rounds": info["rounds"], "doubling_s": t_doubling,
        "doubling_online_dim": doubled["online_dim"],
        "doubling_certified": doubled["certified"],
        "doubling_max_rel_dev": doubled["max_rel_dev"],
        "doubling_rounds": doubled["rounds"], **checks, **serving,
        "apply_vs_matrix_rel": matrix_rel,
        "sketch_launches": sketch_launches, "omega_launches_path": path_omegas,
        "omega_launches_oracle": oracle_omegas,
    }


def serve_once(rom, fom, device, label, batch: int = 256) -> dict:
    """``serve_batch`` on one batch of 200 requests padded to ``batch``,
    after a warm-up; checks the outputs are finite."""
    from rla4mor_tpu_torch.core import mu_stack
    from rla4mor_tpu_torch.serve import pad_batch, serve_batch

    mus, valid = pad_batch(mu_stack(fom.parameter_space.sample_randomly(
        200, seed=2, device=device)), batch)
    serve_batch(rom, mus)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = serve_batch(rom, mus)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    for key, v in out.items():
        check(bool(torch.isfinite(v[:valid]).all()), f"{label} served {key} not finite")
    return {"serve_s": t_serve, "requests_per_s": valid / t_serve}


def path_summary(result, t_greedy, host_solve) -> dict:
    ext = result.extension_times
    return {"greedy_s": t_greedy, "extensions": len(ext),
            "s_per_extension": sum(ext) / len(ext),
            "host_solve_s_per_extension": sum(host_solve) / len(host_solve),
            "host_solve_share": sum(host_solve) / sum(ext)}


def bf16_phase(fom, device, extensions: int = BF16_EXTENSIONS, training: int = 200) -> dict:
    """The bf16 offline path: ``SketchedReductor(offline_dtype=bfloat16)``
    with SRHT k = 300 over the sqrt factor, Galerkin, ``rb_greedy_padded``
    over the slice's 200 training parameters, then one batch served.

    Its held-out estimates are held to the exact dual residual of U y, U
    the path's float32 snapshots combined as its sketched basis (C with
    srb = S(snapshots) C, by least squares in sketch space, as the large
    slice does): rb is stored in bf16, and its rounding, which A amplifies,
    is a residual the estimator never sketched. Checked where that residual
    is above ``BF16_FLOOR`` of the dual norm of b."""
    from rla4mor_tpu_torch.core.solvers import lstsq_dense
    from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy_padded
    from rla4mor_tpu_torch.ops import SrhtEmbedding, srht_cuda

    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = SrhtEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=SLICE_K, seed=0,
                               device=device)
    reductor = SketchedReductor(fom, embedding_primal=theta, product=Ru,
                                projection="galerkin", offline_dtype=torch.bfloat16,
                                log_level=30)
    train = fom.parameter_space.sample_randomly(training, seed=0, device=device)

    counts = srht_cuda.srht_onepass.launches_by_dtype
    srht_cuda.srht_onepass.launches = 0
    counts.clear()
    result, t_greedy, host_solve, snaps = timed_greedy(fom, reductor, train, extensions,
                                                       greedy=rb_greedy_padded)
    serving = serve_once(result.rom, fom, device, "bf16")
    launches = {str(dt).replace("torch.", ""): c for dt, c in counts.items()}
    check(reductor.rb.dtype == torch.bfloat16, f"bf16: rb is {reductor.rb.dtype}")
    for name, t in (("srb", reductor.srb), ("residual_lhs", reductor.residual_lhs.stack),
                    ("residual_rhs", reductor.residual_rhs.stack)):
        check(t.dtype == torch.float32, f"bf16: {name} is {t.dtype}, not float32")
    check(launches.get("bfloat16", 0) > 0, f"bf16: no bf16-input SRHT launch: {launches}")

    S = torch.stack(snaps[:reductor.basis_size], dim=1)               # (n, r) float32
    C = lstsq_dense(theta.apply(S).double(), reductor.srb.double())
    checks = check_rom(fom, reductor, result, device, "bf16",
                       lift=lambda y: S.double() @ (C @ y.double()), floor=BF16_FLOOR)
    return {"n": n, "k": SLICE_K, **path_summary(result, t_greedy, host_solve), **checks,
            **serving, "launches_by_dtype": launches, "rb_dtype": "bfloat16",
            "selected": len(result.selected_mus)}


def padded_phase(fom, device, slice_mus, extensions: int = PADDED_EXTENSIONS,
                 training: int = 200) -> dict:
    """The padded path: ``PaddedSketchedReductor`` (float32, r_max =
    ``extensions``) and ``rb_greedy_no_retrace`` with the slice's embedding,
    training set and seed schedule; every state tensor keeps its shape."""
    from rla4mor_tpu_torch.mor import PaddedSketchedReductor, rb_greedy_no_retrace
    from rla4mor_tpu_torch.ops import SrhtEmbedding, srht_cuda

    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = SrhtEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=SLICE_K, seed=0,
                               device=device)
    reductor = PaddedSketchedReductor(fom, embedding_primal=theta, product=Ru,
                                      r_max=extensions, log_level=30)
    shapes = [tuple(t.shape) for t in reductor.state]
    train = fom.parameter_space.sample_randomly(training, seed=0, device=device)
    srht_cuda.srht_onepass.launches = 0
    result, t_greedy, host_solve, _ = timed_greedy(fom, reductor, train, extensions,
                                                   greedy=rb_greedy_no_retrace)
    launches = srht_cuda.srht_onepass.launches
    check(launches > 0, "padded: the path launched no SRHT kernel")
    check([tuple(t.shape) for t in reductor.state] == shapes, "padded: a state shape changed")
    check(reductor.basis_size == extensions, f"padded: ncols {reductor.basis_size}")
    checks = check_rom(fom, reductor, result, device, "padded")
    same = [m["diffusion"].tolist() for m in result.selected_mus] == \
        [m["diffusion"].tolist() for m in slice_mus[:extensions]]
    return {"n": n, "r_max": extensions, **path_summary(result, t_greedy, host_solve),
            **checks, **serve_once(result.rom, fom, device, "padded"),
            "srht_launches": launches, "selected_equal_slice_first": same}


def strong_phase(fom, device, training: int = STRONG_TRAINING,
                 extensions: int = STRONG_EXTENSIONS) -> dict:
    """The strong greedy: ``training`` parameters solved once on the host;
    ``extend_basis_blocked`` (blocks of 4) against single-column extensions
    (srb within 1e-5 relative: float32 sketches of other widths, summed in
    other orders); then ``rb_greedy_strong`` on those snapshots, whose max
    true error must decay."""
    from rla4mor_tpu_torch.mor import SketchedReductor, rb_greedy_strong
    from rla4mor_tpu_torch.ops import SrhtEmbedding, srht_cuda

    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = SrhtEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=SLICE_K, seed=0,
                               device=device)

    def reductor():
        return SketchedReductor(fom, embedding_primal=theta, product=Ru, log_level=30)

    mus = fom.parameter_space.sample_randomly(training, seed=4, device=device)
    t0 = time.perf_counter()
    U = fom.solve_many(mus)
    t_solve = time.perf_counter() - t0
    srht_cuda.srht_onepass.launches = 0
    t0 = time.perf_counter()
    blocked = reductor()
    blocked.extend_basis_blocked(U, max_block_size=4)
    t_blocked = time.perf_counter() - t0
    single = reductor()
    for j in range(U.shape[1]):
        single.extend_basis(U[:, j], mu=mus[j])
    srb_rel = ((blocked.srb - single.srb).abs().max() / single.srb.abs().max()).item()
    check(srb_rel <= 1e-5, f"strong: blocked vs single-column srb {srb_rel:.3e} > 1e-5")

    red = reductor()
    t0 = time.perf_counter()
    result = rb_greedy_strong(fom, red, mus, max_extensions=extensions, snapshots=U,
                              log_level=30)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    launches = srht_cuda.srht_onepass.launches
    errs = result.max_estimates
    check(all(math.isfinite(e) for e in errs), f"strong: errors {errs}")
    check(errs[-1] < errs[0], f"strong: max true error did not decay: {errs}")
    check(red.basis_size == extensions, f"strong: basis {red.basis_size}")
    check(launches > 0, "strong: the path launched no SRHT kernel")
    return {"n": n, "training": training, "host_solve_s": t_solve,
            "blocked_extend_s": t_blocked, "srb_blocked_vs_single_rel": srb_rel,
            "greedy_s": t_greedy, "extensions": extensions, "max_true_errors": errs,
            "srht_launches": launches}, U


def hwprng_block_phase(fom, device, U_strong) -> dict:
    """The HwPrng embedding fed blocks of snapshots: [strong]'s snapshots
    and BLOCK_SNAPSHOTS - 6 more solved here, sketched by
    ``extend_basis_blocked`` (blocks of 64: one block of m = BLOCK_SNAPSHOTS,
    the tiled branch) with ``truncation_rtol`` = BLOCK_TRUNCATION_RTOL, then
    ``reduce()`` and the held-out checks. Then the sketched snapshots of
    blocked and single-column extensions (the small branch, m = 1),
    compared before any orthonormalisation (srb and the residual stacks
    within 1e-5 relative): Gram-Schmidt in float32 of a basis conditioned
    at 1e5 would amplify two correct float32 sketches' 1e-7 differences
    to 5e-3 (CPU, grid 128)."""
    import types

    from rla4mor_tpu_torch.mor import SketchedReductor
    from rla4mor_tpu_torch.ops import HwPrngGaussianEmbedding
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    n = fom.solution_dim
    Ru = fom.h1_0_product
    theta = HwPrngGaussianEmbedding.make(n, sqrt_product=Ru.sqrt, range_dim=GAUSS_K,
                                         seed=1, dist="normal", device=device)

    def reductor(orthonormalize=True):
        return SketchedReductor(fom, embedding_primal=theta, product=Ru, log_level=30,
                                orthonormalize=orthonormalize,
                                truncation_rtol=BLOCK_TRUNCATION_RTOL)

    mus = fom.parameter_space.sample_randomly(BLOCK_SNAPSHOTS - U_strong.shape[1], seed=5,
                                              device=device)
    t0 = time.perf_counter()
    U = torch.cat([U_strong, fom.solve_many(mus)], dim=1)
    t_solve = time.perf_counter() - t0

    counts = gcu.gaussian_sketch.launches_by_branch
    gcu.gaussian_sketch.launches = 0
    for branch in counts:
        counts[branch] = 0
    t0 = time.perf_counter()
    red = reductor()
    red.extend_basis_blocked(U, max_block_size=64)
    rom = red.reduce()
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    path_counts = dict(counts)
    check(path_counts["tiled"] > 0, f"hwprng block: no tiled launch: {path_counts}")
    checks = check_rom(fom, red, types.SimpleNamespace(rom=rom, max_estimates=None), device,
                       "hwprng block")

    blocked = reductor(orthonormalize=False)
    blocked.extend_basis_blocked(U, max_block_size=64)
    single = reductor(orthonormalize=False)
    for j in range(U.shape[1]):
        single.extend_basis(U[:, j])
    rels = {}
    for name, a, b in (("srb", blocked.srb, single.srb),
                       ("residual_lhs", blocked.residual_lhs.stack,
                        single.residual_lhs.stack)):
        rels[name] = ((a - b).abs().max() / b.abs().max()).item()
        check(rels[name] <= 1e-5, f"hwprng block: blocked vs single-column {name} "
              f"{rels[name]:.3e} > 1e-5")
    return {"n": n, "k": GAUSS_K, "snapshots": U.shape[1], "host_solve_s": t_solve,
            "extend_reduce_s": t_path, "launches_by_branch": path_counts,
            "truncation_rtol": BLOCK_TRUNCATION_RTOL, "basis_size": red.basis_size, **checks,
            "srb_blocked_vs_single_rel": rels["srb"],
            "residual_lhs_blocked_vs_single_rel": rels["residual_lhs"]}


def large_kernel_rows(device, n: int, block: int, label: str = "large") -> list[dict]:
    """The SRHT kernel against its plain version at a large path's shapes:
    the rhs (m = 1) and the step's (1 + T, n) block (m = ``block``) in its
    transposed rows view, through the path's embedding (seed 0). The
    library yardstick is one product with the explicit (k, n) operator,
    built on the card and freed after (17.2 GB in float32 at n = 2^24)."""
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

    emb = SrhtEmbedding(LARGE_K, n, seed=0, device=device, dtype=torch.float32)
    signs, samp, _ = emb.plan
    gen = torch.Generator(device=device).manual_seed(n)
    S = explicit_srht(signs, samp, n, LARGE_K, torch.float32, device)
    rows = []
    for m in (1, block):
        x = torch.randn((m, n), generator=gen, device=device).T  # rows layout
        rows.append(compare(f"{label} n={n} m={m} k={LARGE_K} rows", x, LARGE_K, signs,
                            samp, reps=50, kernel=lambda x=x: emb.apply_random(x),
                            library=lambda x=x: torch.matmul(S, x)))
        del x
    del S
    torch.cuda.empty_cache()
    return rows


def reference_solve(fom64, mu, family: str):
    """The float64 solve the held-out checks compare with: MG-CG (thermal),
    MG-BiCGStab (advection, Helmholtz) or Jacobi-CG (3-D), tol 1e-10."""
    if family == "thermal":
        return fom64.solve_cg_result(mu, tol=1e-10, maxiter=300, precond="mg")
    if family == "thermal3d":
        return fom64.solve_cg_result(mu, tol=1e-10, maxiter=FAMILY_CG_MAXITER)
    return fom64.solve_bicgstab_result(mu, tol=1e-10, maxiter=300, precond="mg")


def large_held_out(res: dict, device, label: str) -> list[dict]:
    """At 4 held-out parameters of the family's own sampler, the ROM of
    ``large_scale_demo.run``'s result: its output against a float64 solve
    (``reference_solve``), and its sketched estimate against the exact l2
    residual of U y in float64, where U is the snapshots Gram-Schmidt-combined
    as the state's sketched basis is."""
    from rla4mor_tpu_torch.core.solvers import lstsq_dense
    from rla4mor_tpu_torch.examples.large_scale_demo import make_fom
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding

    state, rom, n, family = res["state"], res["rom"], res["n"], res["family"]
    r = int(state.ncols)
    fom64 = make_fom(family, res["grid"], device, torch.float64)
    b64 = fom64.rhs()
    bnorm = float(torch.linalg.vector_norm(b64))
    snaps = torch.stack(res["snapshots"][:r]).reshape(r, n)      # (r, n) float32
    emb = SrhtEmbedding(LARGE_K, n, seed=0, device=device, dtype=torch.float32)
    comb = lstsq_dense(emb.apply_random(snaps.T).double(), state.srb[:, :r].double())
    held, rows = res["sample"](4, 3), []
    for mu in held:
        solve = reference_solve(fom64, mu, family)
        s_fom = float(fom64.output(solve.x))
        y = rom.solve(mu)
        s_rom = float(rom.output(y, mu)[0])
        u_rom = (snaps.T.double() @ (comb @ y.double())).reshape(fom64.solution_shape)
        exact = float(torch.linalg.vector_norm(fom64.apply(mu, u_rom) - b64))
        est = float(rom.estimate_error(mu, y))
        rows.append({"out_rel_err": abs(s_rom - s_fom) / abs(s_fom), "est": est,
                     "exact_l2": exact, "exact_over_b": exact / bnorm,
                     "est_over_exact": est / exact, "checked": exact > 1e-3 * bnorm,
                     "f64_iters": solve.iters,
                     "f64_rel_res": float(solve.residual_norm) / bnorm})
        phase(f"{label} held-out", **rows[-1])
        del solve, u_rom
    del snaps, fom64
    torch.cuda.empty_cache()
    return rows


def large_phase(device, grid: int, label: str, family: str = "thermal",
                steps: int = LARGE_STEPS) -> dict:
    """A large path once through the entry point (``steps`` weak-greedy
    steps of ``family``), its checks and one profiled step. The thermal
    family's ROM output is held to 5e-2 at the held-out parameters; the
    other families' manifolds converge more slowly, and their output
    error is reported only."""
    from rla4mor_tpu_torch.examples import large_scale_demo as demo
    from rla4mor_tpu_torch.ops import srht_cuda

    precond = "jacobi" if family == "thermal3d" else "mg"
    srht_cuda.srht_onepass.launches = 0
    t0 = time.perf_counter()
    res = demo.run(grid=grid, steps=steps, k=LARGE_K, precond=precond, sketch="srht",
                   device=device, select="greedy", family=family,
                   log=lambda line: print(f"[{label}] {line}", flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = srht_cuda.srht_onepass.launches

    state = res["state"]
    for name in ("srb", "res_lhs", "res_rhs", "out"):
        check(bool(torch.isfinite(getattr(state, name)).all()), f"{label}: state {name}")
    for est in res["estimates"]:
        check(bool(torch.isfinite(est).all()), f"{label}: estimates {est}")
    for key, v in res["served"].items():
        check(bool(torch.isfinite(v).all()), f"{label}: served {key} not finite")
    check(int(state.ncols) == steps, f"{label}: ncols {int(state.ncols)}")
    med = res["median_est"]
    check(med[-1] < med[0], f"{label}: median estimate did not drop: {med}")
    # one sketch of the rhs when the step is built, then one block a step
    check(launches == 1 + steps, f"{label}: {launches} SRHT launches, not 1 + {steps}")
    # a solve that ran to maxiter with a finite iterate: BiCGStab broke down
    # (its guard keeps the last finite iterate) or CG did not converge
    breakdowns = sum(it == res["cg_maxiter"] and bool(torch.isfinite(u).all())
                     for it, u in zip(res["cg_iters"], res["snapshots"]))

    rows = large_held_out(res, device, label)
    for row in rows:
        check(math.isfinite(row["out_rel_err"]), f"{label}: ROM output not finite")
        if family == "thermal":
            check(row["out_rel_err"] <= 5e-2,
                  f"{label}: ROM output error {row['out_rel_err']:.3e} > 5e-2")
        if row["checked"]:
            check(0.5 <= row["est_over_exact"] <= 2.0,
                  f"{label}: estimate / exact l2 residual {row['est_over_exact']:.3f} "
                  "outside [0.5, 2]")

    prof = demo.profile_step(res["step"], state, res["mus"][-1], res["mu_batch"], top=10)
    phase(f"{label} profile", wall_s=prof["wall_s"], busy_s=prof["busy_s"],
          idle_share=prof["idle_share"], device_events=prof["device_events"])
    for row in prof["top"]:
        phase(f"{label} profile top", ms=row["ms"], calls=row["calls"],
              name=row["name"].replace(" ", "_"))
    step_s = res["step_s"]
    after_first = sum(step_s[1:]) / max(1, len(step_s) - 1)
    out = {
        "family": family, "n": res["n"], "grid": res["grid"], "k": LARGE_K,
        "projection": res["projection"], "steps": len(step_s), "wall_s": wall_s,
        "setup_s": res["setup_s"], "step_s": step_s, "s_per_step": sum(step_s) / len(step_s),
        "s_per_step_after_first": after_first,
        "solver_iters": res["cg_iters"], "solver_maxiter": res["cg_maxiter"],
        "breakdowns": breakdowns, "rec_res": res["rec_res"], "true_res": res["true_res"],
        "median_est": med, "srht_launches": launches, "rom_s": res["rom_s"],
        "requests_per_s": res["requests_per_s"],
        "out_rel_err": [row["out_rel_err"] for row in rows],
        "out_rel_err_max": max(row["out_rel_err"] for row in rows),
        "est_over_exact": [row["est_over_exact"] for row in rows],
        "estimates_checked": sum(row["checked"] for row in rows),
        "f64_iters": [row["f64_iters"] for row in rows],
        "profile_idle_share": prof["idle_share"], "profile_wall_s": prof["wall_s"],
        "profile_busy_s": prof["busy_s"], "profile_device_events": prof["device_events"],
        # the profiled step's device time over an unprofiled step's wall time
        "idle_share_unprofiled": (None if prof["busy_s"] is None
                                  else 1.0 - prof["busy_s"] / after_first),
    }
    del res, state
    torch.cuda.empty_cache()
    return out


def strip_path_row(device, k: int, wide_muls_per_s: float) -> dict:
    """The strip kernel at [precond hwprng]'s shape ((k, GAUSS_W), normal, cos
    halves) against its plain version (1e-5), with its times and bound."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    errs = []
    for seed, b in ((PRECOND_HW_SEED, 0), (PRECOND_HW_SEED, 513), (7, 3)):
        S = gcu.gaussian_strip(k, seed, b, GAUSS_W, "normal", device=device)
        P = gcu.gaussian_strip_plain(k, seed, b, GAUSS_W, "normal", device=device)
        errs.append((S - P).abs().max().item())
    check(max(errs) <= 1e-5, f"strip k={k}: |kernel - plain| {max(errs):.2e} > 1e-5")
    row = {"label": f"path k={k} W={GAUSS_W} normal", "k": k, "W": GAUSS_W,
           "max_abs_err": max(errs), "library_ms": None}
    row["ms"] = cuda_ms(lambda: gcu.gaussian_strip(k, 7, 0, GAUSS_W, "normal",
                                                   device=device), 50)
    row["plain_ms"] = cuda_ms(lambda: gcu.gaussian_strip_plain(
        k, 7, 0, GAUSS_W, "normal", device=device), 10)
    row["bound_ms"], row["bound_by"] = bound(
        4.0 * k * GAUSS_W, 0.0, torch.float32, philox_calls(k, GAUSS_W, "normal"),
        wide_muls_per_s)
    row["share"] = row["bound_ms"] / row["ms"]
    phase("gaussian strip", **row)
    return row


def omega_row(device, k: int, n: int, dist: str, wide_muls_per_s: float) -> dict:
    """The one-launch Omega at (k, n): strips 0, middle and last (cut)
    against the plain strips times the same float32 scale (Rademacher
    bit-equal, normal within 1e-5 absolute on the unscaled values); its
    times by events and in a CUDA graph, its bound, and beside it in the
    same run the old composition (a strip launch a strip, ``torch.cat``, the
    slice to n and the scale) and ``normal_`` on a (k, n) tensor, each with
    its peak memory above the start."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    W, seed, scale = GAUSS_W, PRECOND_HW_SEED, gcu.omega_scale(k)
    n_strips = -(-n // W)

    def omega():
        return gcu.gaussian_omega(k, n, seed, W, dist, device=device)

    def composition():
        strips = [gcu.gaussian_strip(k, seed, b, W, dist, device=device)
                  for b in range(n_strips)]
        return torch.cat(strips, dim=1)[:, :n] / math.sqrt(k)

    def peak_gb(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 1e9

    out = omega()
    torch.cuda.synchronize()
    check(tuple(out.shape) == (k, n) and out.is_contiguous(), f"omega {k}x{n}: {out.shape}")
    check(bool(torch.isfinite(out).all()), f"omega {k}x{n}: not finite")
    errs = []
    for b in (0, n_strips // 2, n_strips - 1):
        plain = gcu.gaussian_strip_plain(k, seed, b, W, dist, device=device) * scale
        got = out[:, b * W:(b + 1) * W]
        plain = plain[:, :got.shape[1]]
        if dist == "rademacher":
            check(torch.equal(got, plain), f"rademacher omega {k}x{n}: strip {b} not bit-equal")
        errs.append((got - plain).abs().max().item())
    check(max(errs) / scale <= 1e-5, f"omega {k}x{n} {dist}: |kernel - plain| / scale "
          f"{max(errs) / scale:.2e} > 1e-5")
    mode = ("rademacher" if dist == "rademacher" else
            "normal pairs" if k % 128 == 0 else "normal cos halves")
    row = {"label": f"omega k={k} n={n} {mode}", "k": k, "n": n, "dist": dist,
           "max_abs_err": max(errs), "unscaled_err": max(errs) / scale}
    del out, got, plain
    row["ms"] = cuda_ms(omega, 20)
    row["graph_ms"] = graph_ms(omega, 10)
    row["bound_ms"], row["bound_by"] = bound(4.0 * k * n, 0.0, torch.float32,
                                             philox_calls(k, n, dist), wide_muls_per_s)
    row["share"] = row["bound_ms"] / row["ms"]
    row["graph_share"] = row["bound_ms"] / row["graph_ms"]
    row["composition_ms"] = cuda_ms(composition, 3)
    row["composition_launches"] = n_strips
    gen = torch.Generator(device=device).manual_seed(5)
    # a yardstick of generate-and-store on this card, not the same function
    row["normal_fill_ms"] = cuda_ms(
        lambda: torch.empty((k, n), device=device).normal_(generator=gen), 20)
    row["peak_gb"], row["composition_peak_gb"] = peak_gb(omega), peak_gb(composition)
    row["plain_ms"] = cuda_ms(lambda: gcu.gaussian_omega_plain(k, n, seed, W, dist,
                                                                device=device), 1)
    row["library_ms"] = None  # no PyTorch call draws this Philox contract
    torch.cuda.empty_cache()
    phase("gaussian omega", **row)
    return row


def gaussian_omega_phase(device, wide_muls_per_s: float) -> dict:
    """[gaussian omega]: the one-launch Omega against its plain version in
    full at (200, 3 W + 37) and (256, 2^18 + 3), normal and Rademacher
    (Rademacher bit-equal, normal within 1e-5 absolute on the unscaled
    values), then ``omega_row`` at [precond hwprng]'s shape (k = 200, n =
    1,050,625, cos halves) and at (256, 261,121) in pairs and Rademacher
    mode. Returns the rows by name."""
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu

    for k, n in ((PRECOND_K_RES, 3 * GAUSS_W + 37), (GAUSS_K, (1 << 18) + 3)):
        for dist in ("normal", "rademacher"):
            out = gcu.gaussian_omega(k, n, 7, GAUSS_W, dist, device=device)
            ref = gcu.gaussian_omega_plain(k, n, 7, GAUSS_W, dist, device=device)
            err = (out - ref).abs().max().item() / gcu.omega_scale(k)
            if dist == "rademacher":
                check(torch.equal(out, ref), f"rademacher omega {k}x{n} not bit-equal")
            check(err <= 1e-5, f"omega {k}x{n} {dist}: unscaled |kernel - plain| {err:.2e}")
            phase("gaussian omega", label=f"full k={k} n={n} {dist}", unscaled_err=err)
    del out, ref
    return {"path": omega_row(device, PRECOND_K_RES, PRECOND_N, "normal", wide_muls_per_s),
            "pairs": omega_row(device, GAUSS_K, SLICE_N, "normal", wide_muls_per_s),
            "rademacher": omega_row(device, GAUSS_K, SLICE_N, "rademacher", wide_muls_per_s)}


def rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|."""
    return ((a - b).abs().max() / b.abs().max()).item()


def precond_phase(device) -> dict:
    """[precond]: ``examples/preconditioned_large_demo.py``'s ``run()`` at its
    defaults (grid 1024, float32), and its checks: the batched online stage
    equals the per-parameter one (1e-4 relative), and at each direction's
    own parameter the HS residual is at most 1e-3 of ||h||."""
    from rla4mor_tpu_torch.examples import preconditioned_large_demo as demo

    t0 = time.perf_counter()
    res = demo.run(grid=PRECOND_GRID, k_res=PRECOND_K_RES, nmu=PRECOND_NMU, device=device,
                   log=lambda line: print(f"[precond] {line}", flush=True))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    red, us = res["reductor"], res["us"]
    for name in ("us", "ys", "rnorms"):
        check(bool(torch.isfinite(res[name]).all()), f"precond: {name} not finite")
    batch_vs_solve = max(rel_max(us[i], red.solve(mu, "ur_ur")[0])
                         for i, mu in enumerate(res["mus"]["online"][:8]))
    check(batch_vs_solve <= 1e-4, f"precond: solve_batch vs solve {batch_vs_solve:.3e}")
    h_norm = float(torch.linalg.vector_norm(red.hs_estimators_rhs["ur_ur"]))
    hs_at_mu_i = [float(red.minimize_hs_estimator(mu, "ur_ur")[1]) / h_norm
                  for mu in res["mus"]["dir"]]
    check(max(hs_at_mu_i) <= 1e-3, f"precond: HS residual at mu_i / ||h|| {hs_at_mu_i}")
    check(all(math.isfinite(e) for e in res["errors"]), f"precond: errors {res['errors']}")
    res["summary"] = {
        "n": res["n"], "wall_s": wall_s, "snapshot_s": res["snapshot_s"],
        "reductor_s": res["reductor_s"], "add_s": res["add_s"],
        "solves": [P.solves for P in res["directions"]],
        "last_iters": [P.last_iters for P in res["directions"]],
        "batch_ms": res["batch_ms"], "loop_ms": res["loop_ms"], "nmu": PRECOND_NMU,
        "loop_n": 8, "rom_rel_err": res["errors"], "batch_vs_solve_rel": batch_vs_solve,
        "hs_at_mu_i_over_h": hs_at_mu_i,
        "residual_rows_gb": res["n"] * PRECOND_K_RES * 4 / 1e9,
    }
    return res


def precond_hwprng_phase(res, device) -> dict:
    """[precond hwprng]: [precond]'s FOM, basis and first direction in a
    ``PreconditionedRom`` whose residual embedding is
    ``HwPrngGaussianEmbedding`` (k = ``PRECOND_K_RES``): its ``source_array``
    draws Omega by one launch of the Omega kernel (the path's launches,
    counted just around the build and the direction's add; the peak memory
    allocated above the start across the build). Checks: one Omega launch
    and no strip launch, three
    strips of ``source_array`` against the plain strips (1e-5), its
    transpose times 4 random columns against the sketch kernel (1e-5
    relative), and the residual estimate against [precond]'s SRHT one at
    the direction alone (y = e_0) and the ROM's solution there, within
    [0.5, 2] at 3 held-out parameters."""
    from rla4mor_tpu_torch.ops import HwPrngGaussianEmbedding
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu
    from rla4mor_tpu_torch.precond import PreconditionedRom

    fom, U, n, k = res["fom"], res["U"], res["n"], PRECOND_K_RES
    P0, mu0 = res["directions"][0], res["mus"]["dir"][0]
    theta = HwPrngGaussianEmbedding.make(n, range_dim=k, seed=PRECOND_HW_SEED, device=device)
    solves0 = P0.solves
    gcu.gaussian_strip.launches = gcu.gaussian_omega.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    prom = PreconditionedRom(fom, U, theta, log_level=30)
    torch.cuda.synchronize()
    source_s = time.perf_counter() - t0
    source_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    prom.add_preconditioner(P0, mu0)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, strip_launches = gcu.gaussian_omega.launches, gcu.gaussian_strip.launches
    n_strips = -(-n // theta.block_rows)
    check(launches == 1 and strip_launches == 0, f"precond hwprng: {launches} Omega launches "
          f"and {strip_launches} strip launches, not 1 and 0")

    cols, W = prom._res_cols, theta.block_rows                  # (n, k) = Theta^H
    strip_errs = []
    for b in (0, n_strips // 2, n_strips - 1):
        plain = gcu.gaussian_strip_plain(k, PRECOND_HW_SEED, b, W, "normal",
                                         device=device)
        got = cols[b * W:(b + 1) * W].T * math.sqrt(k)
        strip_errs.append((got - plain[:, :got.shape[1]]).abs().max().item())
    check(max(strip_errs) <= 1e-5, f"precond hwprng: source_array strips {strip_errs}")
    X = torch.randn((n, 4), generator=torch.Generator(device=device).manual_seed(4),
                    device=device, dtype=cols.dtype)
    sketch_rel = rel_max(theta.apply(X), cols.T @ X)
    check(sketch_rel <= 1e-5, f"precond hwprng: source_array^T X vs sketch {sketch_rel:.2e}")

    srht_rom, ratios = res["reductor"].prom.rom, []
    p = len(res["directions"])
    for mu in res["mus"]["online"][:3]:
        e0 = torch.zeros(p, dtype=U.dtype, device=device)
        e0[0] = 1.0
        mu_p = {**mu, "precond": e0}
        u = srht_rom.solve(mu_p)
        est_srht = float(srht_rom.estimate_error(mu_p, u))
        est_hw = float(prom.rom.estimate_error({**mu, "precond": e0[:1]}, u))
        ratios.append(est_hw / est_srht)
    check(all(0.5 <= q <= 2.0 for q in ratios), f"precond hwprng: estimate ratios {ratios}")
    return {"n": n, "k": k, "omega_launches": launches, "strip_launches": strip_launches,
            "strips": n_strips, "source_array_s": source_s,
            "source_peak_gb": source_peak_gb, "omega_gb": 4.0 * k * n / 1e9,
            "wall_s": wall_s, "solves": P0.solves - solves0,
            "last_iters": P0.last_iters, "strip_err_max": max(strip_errs),
            "sketch_rel": sketch_rel, "est_hw_over_srht": ratios}


def estim_kernel_rows(device, rates) -> tuple[dict, dict]:
    """The two kernels at [estim]'s residual sketch, (ESTIM_N, ESTIM_COLS)
    columns to k = ESTIM_K, against their plain versions: the SRHT through
    the path's embedding (seed 3; 1e-4 relative), with the time of the
    three-pass FWHT route that ``SrhtEmbedding`` takes below
    ``_ONEPASS_MIN_DIM`` beside it (``fwht_ms``), and the tiled Gaussian
    branch (seed 3; 1e-5 relative); each with the library product."""
    from rla4mor_tpu_torch.ops.embeddings import SrhtEmbedding
    from rla4mor_tpu_torch.ops.fwht import srht

    n, m, k = ESTIM_N, ESTIM_COLS, ESTIM_K
    gen = torch.Generator(device=device).manual_seed(n)
    x = torch.randn((n, m), generator=gen, device=device)
    emb = SrhtEmbedding(k, n, seed=3, device=device, dtype=torch.float32)
    check(n >= emb._ONEPASS_MIN_DIM, "estim: the SRHT embedding would not take the kernel")
    signs, samp, _ = emb.plan
    S = explicit_srht(signs, samp, n, k, torch.float32, device)
    srht_row = compare(f"estim n={n} m={m} k={k} cols", x, k, signs, samp, reps=20,
                       kernel=lambda: emb.apply_random(x), library=lambda: torch.matmul(S, x))
    del S
    srht_row["fwht_ms"] = cuda_ms(lambda: srht(x.T, k, emb.plan), 20)
    phase("kernel", label=srht_row["label"], fwht_ms=srht_row["fwht_ms"], ms=srht_row["ms"])
    tiled_row = gaussian_sketch_row(f"estim n={n} m={m} k={k}", x, k, "normal", 20, gen, rates)
    check(tiled_row["branch"] == "tiled", "estim: the Gaussian sketch took the small branch")
    del x
    torch.cuda.empty_cache()
    return srht_row, tiled_row


def estim_phase(device) -> dict:
    """[estim]: ``examples/inverse_problems_demo.py``'s ``run()`` on the 3x3
    thermal block at ESTIM_GRID in float32 with the Gaussian, SRHT and
    HwPrng residual sketches (kernel counts set to 0 just before, read just
    after), then PBDW, the Gaussian sketch and the selection again in
    float64 from the same host solves and float64 LARS paths (the
    dictionary recovery is float64 in both: the demo's
    ``RECOVERY_DTYPE``). Checks: the SRHT kernel and the tiled Gaussian branch launched;
    along the worst test state's LARS path, each sketched manifold distance
    within [0.5, 2] of the exact one (an ``IdentityEmbedding`` over the
    same sqrt factor) wherever that is above 1e-3 of the path's largest;
    float32 PBDW recoveries within 1e-4 of float64's in the R norm; each
    float32 dictionary-recovery error within a factor 2 of float64's. The
    columns whose float32 selection has other atoms than float64's are
    counted, not held."""
    from rla4mor_tpu_torch.estim import ResidualDistanceAffine
    from rla4mor_tpu_torch.examples import inverse_problems_demo as demo
    from rla4mor_tpu_torch.ops import IdentityEmbedding
    from rla4mor_tpu_torch.ops import gaussian_cuda as gcu
    from rla4mor_tpu_torch.ops import srht_cuda

    def log(line):
        print(f"[estim] {line}", flush=True)

    gcu.gaussian_sketch.launches_by_branch.update(dict.fromkeys(gcu.BRANCHES, 0))
    srht_cuda.srht_onepass.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = demo.run(grid=ESTIM_GRID, n_test=ESTIM_TEST, device=device, log=log)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    srht_launches = srht_cuda.srht_onepass.launches
    tiled_launches = gcu.gaussian_sketch.launches_by_branch["tiled"]
    check(srht_launches > 0, "estim: the SRHT run launched no SRHT kernel")
    check(tiled_launches > 0, "estim: the HwPrng run launched no tiled Gaussian sketch")
    res = out["embeddings"]
    for name, r in res.items():
        check(bool(torch.isfinite(r["rel"]).all()), f"estim {name}: recovery errors not finite")

    # the exact manifold distance (no sketch) at each embedding's path points
    t1 = time.perf_counter()
    fom, n, rec = out["fom"], out["n"], out["prepared"]
    exact_S = IdentityEmbedding(n, sqrt_product=rec.Ru.sqrt, device=device,
                                dtype=demo.RECOVERY_DTYPE)
    space = fom.parameter_space
    exact = ResidualDistanceAffine(*demo.sketched_system(exact_S, *rec.residual, fom),
                                   ([space.low] * space.dim(), [space.high] * space.dim()),
                                   pg_iters=demo.PG_ITERS)
    ratios = {}
    for name, r in res.items():
        d_exact = np.concatenate([exact.evaluate(c)[0] for c in r["coefs"].split(128, dim=1)])
        held = d_exact > 1e-3 * d_exact.max()
        q = r["dist"][held] / d_exact[held]
        ratios[name] = (float(q.min()), float(q.max()), int(held.sum()), len(d_exact))
        check(0.5 <= q.min() and q.max() <= 2.0,
              f"estim {name}: sketched / exact manifold distance in [{q.min():.3f}, "
              f"{q.max():.3f}], not in [0.5, 2]")
    del exact
    torch.cuda.empty_cache()
    exact_s = time.perf_counter() - t1

    # float32 against float64: PBDW, the sketch and the selection again in
    # float64, from the same host solves (and the same float64 LARS paths)
    t1 = time.perf_counter()
    out64 = demo.run(grid=ESTIM_GRID, embeddings={"gaussian": demo.embedding_makers()["gaussian"]},
                     device=device, dtype=torch.float64, prepared=rec, log=log)
    f64_s = time.perf_counter() - t1
    Ru64, u64 = rec.Ru, out64["pbdw_u"]
    pbdw_rel = (Ru64.norm(out["pbdw_u"].double() - u64) / Ru64.norm(u64)).max().item()
    check(pbdw_rel <= 1e-4, f"estim: float32 PBDW vs float64 {pbdw_rel:.2e} > 1e-4")
    g32, g64 = res["gaussian"], out64["embeddings"]["gaussian"]
    err_ratio = (g32["rel"] / g64["rel"]).cpu()
    check(bool(((err_ratio >= 0.5) & (err_ratio <= 2.0)).all()),
          f"estim: float32 / float64 recovery errors in [{err_ratio.min():.3f}, "
          f"{err_ratio.max():.3f}], not within a factor 2")
    other_atoms = int(((g32["v"] != 0) != (g64["v"] != 0)).any(dim=0).sum())

    summary = {"n": n, "test": ESTIM_TEST, "wall_s": wall_s,
               "solve_s": rec.seconds["solve"], "residual_s": rec.seconds["residual"],
               "lars_s": rec.seconds["lars"], "pbdw_s": out["pbdw_s"],
               "exact_distance_s": exact_s, "float64_run_s": f64_s,
               "homotopy_steps": [int(rec.steps.min()), int(rec.steps.max())],
               "max_steps": rec.rm._resolve_max_steps(None), "srht_launches": srht_launches,
               "tiled_launches": tiled_launches, "pbdw_mean_err": out["pbdw"],
               "pbdw_f32_vs_f64_rel": pbdw_rel,
               "recovery_err_f32_over_f64": [float(err_ratio.min()), float(err_ratio.max())],
               "f32_columns_other_atoms": other_atoms}
    for name, r in res.items():
        summary[name] = {
            "sketch_s": r["sketch_s"], "select_s": r["select_s"], "path_s": r["path_s"],
            "recovery_err": [float(e) for e in r["rel"]],
            "argmin_distance": r["argmin_dist"], "argmin_error": r["argmin_err"],
            "distance_over_exact": ratios[name]}
    summary["float64"] = {
        "pbdw_s": out64["pbdw_s"], "sketch_s": g64["sketch_s"], "select_s": g64["select_s"],
        "path_s": g64["path_s"], "recovery_err": [float(e) for e in g64["rel"]],
        "argmin_distance": g64["argmin_dist"], "argmin_error": g64["argmin_err"]}
    return summary


def build_all(sources) -> dict:
    """nvcc of every source, all started together -> {source: seconds}."""
    from rla4mor_tpu_torch.utils import nvcc

    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(nvcc.build, sources)))
    return {src: seconds for src, (_, seconds) in built.items()}


def kernel_entry(name, source, replaces, launches, row, dtype="float32",
                 note=None) -> dict:
    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "dtype": dtype, "launches": launches, "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             # the generation term is integer operations
             "bound_by": "bytes" if row["bound_by"] == "bytes" else "operations",
             "library_ms": row["library_ms"],
             "shape": row.get("label", f"k={row.get('k')} W={row.get('W')}") + " " + dtype}
    if note:
        entry["note"] = note
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=512)
    ap.add_argument("--extensions", type=int, default=8)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    # 1. device
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = (WIDE_MULS_PER_CLOCK_SM * sms * max_sm_mhz * 1e6,
             TF32_FLOP_PER_CLOCK_SM * sms * max_sm_mhz * 1e6)
    from rla4mor_tpu_torch.utils.config import resolve_device

    device = resolve_device("cuda:0")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 still on")
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, python=sys.version.split()[0], sms=sms,
          max_sm_mhz=max_sm_mhz, tf32_tflops=rates[1] / 1e12)

    # 2. build
    from rla4mor_tpu_torch.ops import gaussian_cuda, srht_cuda

    t0 = time.perf_counter()
    seconds = build_all([srht_cuda.SOURCE, gaussian_cuda.SOURCE])
    srht_cuda._lib()
    gaussian_cuda._lib()
    phase("build", **{f"nvcc_s[{src}]": s for src, s in seconds.items()},
          wall_s=time.perf_counter() - t0)
    tiled_sass()

    # 3-4. kernels vs plain on the card
    rows = kernel_phase(device)
    bf16_rows = kernel_bf16_phase(device)
    strip_row, gauss_rows = gaussian_kernel_phase(device, rates)
    omega_rows = gaussian_omega_phase(device, rates[0])

    # 5-6. the paths, through the entry points a user calls
    from rla4mor_tpu_torch.models import ThermalBlockFOM

    t0 = time.perf_counter()
    fom = ThermalBlockFOM((2, 2), args.grid, device=device)
    phase("fom", n=fom.solution_dim, build_s=time.perf_counter() - t0)
    summary, slice_mus = slice_phase(fom, device, args.extensions)
    phase("slice", **summary)
    check(summary["srht_launches"] > 0, "the main path launched no SRHT kernel")
    hw = hwprng_phase(fom, device, HW_EXTENSIONS)
    phase("hwprng", **hw)
    bf16 = bf16_phase(fom, device)
    phase("bf16", **bf16)
    padded = padded_phase(fom, device, slice_mus)
    phase("padded", **padded)
    strong, U_strong = strong_phase(fom, device)
    phase("strong", **strong)
    block = hwprng_block_phase(fom, device, U_strong)
    phase("hwprng block", **block)
    del fom, U_strong

    # 7. the large slice at full width, then at grid LARGE_SMALL_GRID
    large_rows = large_kernel_rows(device, (LARGE_GRID + 1) ** 2, 5)
    large = large_phase(device, LARGE_GRID, "large")
    phase("large", **large)
    large_kernel_rows(device, (LARGE_SMALL_GRID + 1) ** 2, 5)
    small = large_phase(device, LARGE_SMALL_GRID, "large 512")
    phase("large 512", **small)
    torch.cuda.empty_cache()

    # the advection, Helmholtz and 3-D families at full width: the kernel at
    # each family's block against its plain version, then the path
    families = {}
    for family, grid, steps, width in FAMILY_PHASES:
        label = f"large {family}"
        n = (grid + 1) ** (3 if family == "thermal3d" else 2)
        kernel_row = next(r for r in large_kernel_rows(device, n, width, label)
                          if f" m={width} " in r["label"])
        families[family] = (kernel_row, large_phase(device, grid, label, family, steps))
        phase(label, **families[family][1])

    # 8. the sketched preconditioner selector at 1,050,625 DoF, then with
    # the HwPrng residual embedding (the Omega kernel's path)
    strip_path = strip_path_row(device, PRECOND_K_RES, rates[0])
    pre = precond_phase(device)
    phase("precond", **pre["summary"])
    pre_hw = precond_hwprng_phase(pre, device)
    phase("precond hwprng", **pre_hw)
    del pre
    torch.cuda.empty_cache()

    # 9. state estimation: the two kernels at the residual sketch's shape,
    # then the inverse-problems demo with the three embeddings
    estim_srht_row, estim_tiled_row = estim_kernel_rows(device, rates)
    estim = estim_phase(device)
    phase("estim", **estim, card=smi)
    torch.cuda.empty_cache()

    # 10. result
    main_row = next(r for r in rows if r["label"].startswith("slice")
                    and r["dtype"] == "float32" and "m=1 " in r["label"])
    gauss_row = next(r for r in gauss_rows if r["label"].startswith("path")
                     and "m=1 " in r["label"] and r["label"].endswith(f"k={GAUSS_K}")
                     and r["dist"] == "normal")
    large_row = next(r for r in large_rows if "m=5 " in r["label"])
    bf16_row = next(r for r in bf16_rows if r["label"].startswith("slice")
                    and "m=1 " in r["label"] and r["out"] == "float32")
    tiled_row = next(r for r in gauss_rows if r["label"] == f"bench n={1 << GAUSS_BENCH_LOG2N} "
                     f"m=128 k={GAUSS_K}" and r["dist"] == "normal")
    large_launches = large["srht_launches"] + small["srht_launches"]
    family_launches = sum(res["srht_launches"] for _, res in families.values())
    f32_launches = (summary["srht_launches"] + padded["srht_launches"]
                    + strong["srht_launches"] + large_launches + family_launches
                    + estim["srht_launches"])
    print(json.dumps({"kernels": [
        kernel_entry("srht_onepass", "rla4mor_tpu_torch/csrc/srht_onepass.cu",
                     "rla4mor_tpu/ops/srht_pallas.py:580", f32_launches, main_row),
        # the bf16 instance: the [bf16] path's bf16-input launches, at its
        # shape (m = 1, float32 output)
        kernel_entry("srht_onepass", "rla4mor_tpu_torch/csrc/srht_onepass.cu",
                     "rla4mor_tpu/ops/srht_pallas.py:580",
                     bf16["launches_by_dtype"].get("bfloat16", 0), bf16_row,
                     dtype="bfloat16"),
        # the same kernel at the large path's step shape (the packed TPU
        # kernel's B rows a step; its sign packing was a traffic trick)
        kernel_entry("srht_onepass", "rla4mor_tpu_torch/csrc/srht_onepass.cu",
                     "rla4mor_tpu/ops/srht_pallas.py:487", large_launches, large_row,
                     note="the large paths' launches, a subset of the first row's; "
                     "the JAX large path computes this SRHT through its XLA twin "
                     "srht_sketch_sharded_flat (rla4mor_tpu/parallel/"
                     "sharded_sketch.py:195), not a Pallas kernel"),
        # the same kernel at each stencil family's step block (1 + T rows)
        *(kernel_entry("srht_onepass", "rla4mor_tpu_torch/csrc/srht_onepass.cu",
                       "rla4mor_tpu/ops/srht_pallas.py:487", res["srht_launches"], row,
                       note=f"the [large {family}] path's launches, a subset of the "
                       "first row's")
          for family, (row, res) in families.items()),
        kernel_entry("gaussian_sketch", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:116", hw["sketch_launches"],
                     gauss_row),
        # the tiled branch (m > SMALL_M_MAX[dist], tensor cores): [hwprng
        # block]'s launches, at the bench shape m = 128
        kernel_entry("gaussian_sketch_tiled", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:116",
                     block["launches_by_branch"]["tiled"], tiled_row,
                     note="the tiled branch of the same kernel source: 3xTF32 mma.sync, "
                     "Omega drawn into each thread's A fragments"),
        # the Omega kernel at its path's shape: [precond hwprng]'s
        # source_array, k = PRECOND_K_RES (cos halves), the whole Omega
        kernel_entry("gaussian_omega", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:189", pre_hw["omega_launches"],
                     omega_rows["path"]),
        kernel_entry("gaussian_omega", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:189", hw["omega_launches_path"],
                     omega_rows["pairs"], note="pairs mode (k % 128 == 0), which no path "
                     "launches (the [hwprng] random_matrix check draws it once)"),
        kernel_entry("gaussian_omega", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:189", hw["omega_launches_path"],
                     omega_rows["rademacher"], note="Rademacher, which no path launches"),
        # the one-strip call of the same kernel (b0 = b, W columns, scale 1)
        kernel_entry("gaussian_strip", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:189", pre_hw["strip_launches"],
                     strip_path, note="the Omega kernel on one strip; no path launches it"),
        kernel_entry("gaussian_strip", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:189", pre_hw["strip_launches"],
                     strip_row, note="the Omega kernel on one strip, pairs mode "
                     "(k % 128 == 0); no path launches it"),
        # [estim]'s residual sketch: K + m = 250 columns of n = 36,481 to
        # k = 256, one launch a term, through the SRHT and HwPrng embeddings
        kernel_entry("srht_onepass", "rla4mor_tpu_torch/csrc/srht_onepass.cu",
                     "rla4mor_tpu/ops/srht_pallas.py:580", estim["srht_launches"],
                     estim_srht_row, note="the [estim] path's launches, a subset of "
                     "the first row's"),
        kernel_entry("gaussian_sketch_tiled", "rla4mor_tpu_torch/csrc/gaussian_sketch.cu",
                     "rla4mor_tpu/ops/gaussian_pallas.py:116", estim["tiled_launches"],
                     estim_tiled_row, note="the [estim] path's tiled launches"),
    ]}), flush=True)
    phase("wall", s=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
