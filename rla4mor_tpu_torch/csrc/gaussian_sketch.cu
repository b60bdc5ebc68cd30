// Gaussian / Rademacher sketch with Omega drawn inside the kernel, on Hopper
// (sm_90a), CUDA C++ with a plain C interface.
//
//   out[s, c] = (1 / sqrt(k)) * sum_{i < n} Omega[s, i] * x[i, c]
//
// Omega (k, n) is never stored: column i lies in strip b = i / W at column
// j = i % W, and its entries are drawn from (seed, b) by Philox4x32-10 under
// the port's bitstream contract (rla4mor_tpu_torch/ops/philox.py, which is
// also the plain version): entry (r, j) of draw number c of a strip is word
// j % 4 of Philox(counter (j / 4, r, c, 0), key (seed, b)); the draws fill
// the strip's rows in the TPU kernel's order (`_fill_strip`): normal pairs
// (cos half, sin half) of 64-row draws when k % 128 == 0, cos halves of
// 64-row draws otherwise, 256-row draws of sign bits for Rademacher.
//
// Replaces the TPU kernels `gaussian_sketch` and `gaussian_strip`
// (rla4mor_tpu/ops/gaussian_pallas.py), which drew each (k, W) strip with
// the TPU's hardware PRNG into VMEM and carried the sum over strips across a
// sequential grid.
//
// What bounds it on an H100. Three terms, the largest wins: the read of x
// and the write of the sketch (4 (n m + k m) bytes at 3.35 TB/s); the
// contraction, 2 k n m flop, at 67 TFLOP/s on the CUDA cores for the small
// branch and, for the tiled branch, times its passes (3 for normal, 2 for
// Rademacher: 3xTF32 below) at the 495 TFLOP/s dense TF32 rate of the tensor
// cores; and the generation, which no layout avoids: one Philox call per 4
// entries (pairs, Rademacher) or per 2 (cos halves, which draw 2 calls for 4
// entries of one row and keep no sine), drawn once per column chunk of 128
// in the tiled branch. A call is ten rounds of two
// 32 x 32 -> 64-bit multiplies (IMAD.WIDE.U32, 32 a clock per SM) and two
// three-input XORs, but the multiplies of round 0, round 1 and the first of
// round 2 take words that depend only on (draw, row) or on (column quad,
// strip, draw), shared by many calls (this kernel does round 0's once per
// thread and per quad): 15 a call are its own. At small m the generation is
// the bound (k n / 4 calls x 15 wide multiplies = 0.030 ms at n = 261,121,
// k = 256, on 132 SMs at 1.98 GHz), and Box-Muller costs more than Philox on
// top of it (probes/int_rates.cu measures the multiply's rate).
//
// Terms used below. A slot is the set of rows that one generation unit
// fills: in pairs mode the pair (row 128 p + r, row 128 p + 64 + r) of draws
// (2p, 2p + 1); in cos-halves mode row 64 q + r of draws (2q, 2q + 1); in
// Rademacher mode row 256 q + r of draw q. A column quad is 4 adjacent
// columns of one strip, the 4 words of one Philox call. Quads never straddle
// strips (W % 4 == 0), so quad g of [0, n) is columns [4 g, 4 g + 4) of strip
// g / (W / 4).
//
// Two branches, picked by the wrapper (ops/gaussian_cuda.py, SMALL_M_MAX,
// by dist):
//
// * m <= SMALL_M_MAX (8 normal), every launch of the HwPrng path (m = 1):
//   `small` kernel. Omega
//   lives in registers only. A thread owns one slot and a column group; for
//   each column quad of its block's range it makes the slot's Philox calls,
//   maps the bits to 4 (or 8) values and FMAs them straight into acc[rows][m]
//   (m is a template parameter, so no column is padded). All lanes of a warp
//   share the quad, so each read of x is a broadcast load through L1. No
//   shared memory and no barrier in the loop. The map of slots covers exactly
//   k rows (k = 300 draws 300 rows). The grid is persistent: blocks = SMs x
//   resident blocks per SM (the occupancy API, cached per device by the
//   wrapper), each block takes a contiguous range of the ceil(n / 4) quads,
//   which may cross strips; the round keys are warp-uniform and are
//   recomputed only where a range enters a new strip, and round 0's multiply
//   of the counter words that a slot fixes is done once per thread. x is
//   read as float4s where its rows are contiguous, with an L1 prefetch 16
//   iterations ahead (without it, m = 8 waited on memory). Threads of one slot in
//   the block's column groups add through shared memory once, at the end; the
//   block writes one partial sum per output, and a second kernel gives each
//   output a warp that sums the partials in a fixed order and a fixed
//   shuffle tree: deterministic, no atomics.
// * the rest: `tiled` kernel, on the tensor cores (mma.sync.m16n8k8, TF32).
//   A block owns 128 sketch rows (a pair of normal draws: pairs mode wastes
//   no sine) and a column chunk of up to 128 columns of x (kTiledN: a chunk
//   of 64 was never more than 2% faster and 1.3-3x slower from m = 128,
//   PERF.md); wider x takes more chunks, a grid dimension, each drawing
//   its Omega anew. The grid is persistent: n_split = the card's resident
//   blocks over (k-tiles x chunks) ranges of 32-column tiles that may cross
//   strips. Warps come in row groups (32 sketch rows, 2 m-tiles) and
//   k-groups, which share the block's tiles round-robin; a warp holds its
//   rows x the whole chunk in registers (m padded to a multiple of 8 only,
//   by instances of 1, 2, 4, 8 or 16 n-tiles: m = 9 pays for 16 columns),
//   and each k-group writes its own partial sum, all of them added by the
//   same warp reduction (fixed order, no atomics: two launches are
//   bit-equal).
//   Omega never touches memory: a thread draws, through `draw_quad` with
//   the small branch's savings (round keys once per strip, round 0 of a
//   slot's fixed words per slot), exactly the entries of its own A
//   fragments. The order of the k index inside a product is free, so a
//   k-step maps k = t, t + 4 of lane 4 g + t to the words of the column
//   quad that lane draws for rows g and g + 8 (below); the B fragments read
//   the same rows of x. Generation and product overlap in every warp: the
//   HMMAs of one k-step run on the tensor pipe while the warp splits the
//   next fragments and draws the next quads, and 16 (8 for 64-128 columns)
//   warps interleave. x arrives by cp.async into a k-group's ring of
//   swizzled tiles (16-byte copies of aligned contiguous rows, one dense
//   run for a contiguous x whose m is not a multiple of 4, 4-byte copies
//   otherwise), one named barrier a tile among the k-group's 4 warps.
//   The product is 3xTF32: Omega_hi x_hi + Omega_hi x_lo + Omega_lo x_hi in
//   float32 sums, hi the value rounded to TF32 (to nearest, ties away, as
//   cvt.rna.tf32.f32, here two integer operations: cvt.rna compiles to a
//   longer sequence) and lo the rest rounded the same way, so a product is
//   off by O(2^-22) of its size; Rademacher drops the Omega_lo pass (+-1 is
//   exact). The tensor cores' float32 accumulate truncates, so the
//   accumulators are moved into running sums in shared memory by IEEE adds
//   every 4 tiles (a sum kept in the accumulators drifted by 2.2e-4 of max
//   |out| at n = 2^23; a move every k-step cost 10-37%). One pass of plain TF32 is 2-3e-4 of max |out| off at these sums
//   (the plain mirror, ops/gaussian_cuda.py product_3xtf32), over the 1e-4
//   the kernel is held to; three are 4e-7.
//   Why mma.sync and not wgmma: wgmma reads B only from shared memory
//   through matrix descriptors (K-major for TF32), so x's hi and lo parts
//   would be written to shared memory in that layout (a shared split tile
//   measured slower than each warp splitting the B values it loads), and
//   the tensor pipe is not what bounds this kernel: mma.sync's TF32 rate
//   here is the card's full dense rate, 1.04 HMMA.1688 a clock per SM
//   (probes/int_rates.cu); the instruction count of the draws and of the
//   splits is.
//   Omega is not staged in shared memory: producer warps filling a ring for
//   consumer warps drew 2.7x slower than the small kernel (PERF.md).
//   The threshold SMALL_M_MAX is measured by `probes/gaussian_sketch_probe.py
//   --tiled` (PERF.md).
//
// Bits to values (one device function, `draw_quad`, for every kernel, so a
// strip equals the columns the sketch contracts): u = bitcast((bits >> 9) |
// 0x3F800000) - 1; radius = sqrt(-2 log(1 - u1)); cos / sin of 2 pi u2. The
// plain version computes these in precise float32 (log1p, sqrt, cos / sin
// of 2 pi rounded to float32 times u2); the kernels may differ by 1e-5
// absolute on a value (the strip check), and at the path's shape the
// precise functions were most of the kernel's instructions. What was
// weighed, and why each was kept or dropped:
// - log: log1pf(-u) and logf(1 - u) (precise, 1 - u is exact because u is a
//   multiple of 2^-23): dropped, about 20 instructions each. __logf alone
//   (MUFU.LG2): dropped, its absolute error (2^-22.6) is all of the value
//   where 1 - u is near 1 (log(1 - 2^-23) = -1.2e-7): radii near 5e-4 come
//   out wrong by about their own size, or NaN where the log comes out
//   positive. Kept: MUFU.LG2 for u >= 1/64, where the radius is at least
//   0.177 and moves by under 1e-6, and a four-term series below 1/64
//   (`minus_two_log1m`); about 8 instructions.
// - sqrt: sqrtf (IEEE, MUFU.RSQ and a Newton step with a slow-path branch):
//   dropped. Kept: sqrt.approx (MUFU.SQRT, relative error near 2^-23, 1e-6
//   at the largest radius 5.7), one instruction, exact 0 at 0.
// - cos / sin: sincosf(2 pi u) (range reduction): dropped. __sinf / __cosf
//   (MUFU.SIN / COS on 2 pi u, which the hardware scales back to turns):
//   dropped, two roundings of the angle and an absolute error near 2^-21
//   add up to about 6e-6 on the largest radius, too close to 1e-5. Kept:
//   sincospif(2 u) (cospif alone in cos-halves mode): no range reduction,
//   the exact angle, under 2e-6 from the plain version.
// Rademacher is the sign bit or'd into 1.0f, bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkK = 64;  // rows of one normal draw (Rademacher: 4 x)
constexpr int kSmallMaxThreads = 512;  // small kernel: slots per block x column groups
constexpr int kPrefetch = 16;  // small kernel: iterations its L1 prefetch of x runs ahead

enum Mode { kRademacher = 0, kNormalPairs = 1, kNormalCos = 2 };

struct Quad {
  uint32_t w[4];
};

// The round keys of key (seed, b) after round 0: k0[i] = seed + i W0 and
// k1[i] = b + i W1 for rounds i = 1..9 (index i - 1). Warp-uniform wherever
// b is; round 0's keys (seed, b) are folded into SlotState and draw_quad.
struct Keys {
  uint32_t k0[9], k1[9];
};

__device__ __forceinline__ Keys make_keys(uint32_t seed, uint32_t b) {
  Keys key;
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    key.k0[i - 1] = seed + (uint32_t)i * 0x9E3779B9u;
    key.k1[i - 1] = b + (uint32_t)i * 0xBB67AE85u;
  }
  return key;
}

// Philox4x32-10 from its state after round 0: rounds 1..9. Each multiply is
// one 32 x 32 -> 64-bit product (IMAD.WIDE.U32), the instruction that bounds
// Philox on this card (probes/int_rates.cu).
__device__ __forceinline__ Quad philox_rounds_1_9(uint32_t c0, uint32_t c1, uint32_t c2,
                                                  uint32_t c3, const Keys& key) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ key.k0[i];
    c1 = (uint32_t)p1;
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ key.k1[i];
    c3 = (uint32_t)p0;
  }
  Quad q;
  q.w[0] = c0;
  q.w[1] = c1;
  q.w[2] = c2;
  q.w[3] = c3;
  return q;
}

__device__ __forceinline__ float bits_to_unit(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// A slot's place in the contract: counter words r and draw of its (first)
// Philox call, and its (first) row of the strip.
struct Slot {
  uint32_t r, draw, row;
};

template <int MODE>
__device__ __forceinline__ Slot slot_map(uint32_t slot) {
  Slot s;
  if (MODE == kRademacher) {  // row 256 q + r of draw q
    s.r = slot % (4 * kChunkK);
    s.draw = slot / (4 * kChunkK);
    s.row = slot;
  } else if (MODE == kNormalPairs) {  // rows 128 p + r and 128 p + 64 + r of draws 2p, 2p+1
    s.r = slot % kChunkK;
    s.draw = 2u * (slot / kChunkK);
    s.row = 2u * kChunkK * (slot / kChunkK) + s.r;
  } else {  // row 64 q + r of draws 2q, 2q+1
    s.r = slot % kChunkK;
    s.draw = 2u * (slot / kChunkK);
    s.row = slot;
  }
  return s;
}

// Round 0 of a slot's Philox calls, for counter (j4, r, draw + j, 0) under
// key (seed, b): the words c0 = hi(M1 (draw + j)) ^ r ^ seed and c1 =
// lo(M1 (draw + j)) depend on neither the column quad nor the strip, so a
// thread computes them once; c2 and c3 come from j4 and b in draw_quad.
struct SlotState {
  uint32_t c0[2], c1[2];
};

template <int MODE>
__device__ __forceinline__ SlotState slot_state(const Slot& s, uint32_t seed) {
  SlotState st;
#pragma unroll
  for (int j = 0; j < (MODE == kRademacher ? 1 : 2); ++j) {
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * (s.draw + j);
    st.c0[j] = (uint32_t)(p1 >> 32) ^ s.r ^ seed;
    st.c1[j] = (uint32_t)p1;
  }
  return st;
}

// -2 log(1 - u) for u in [0, 1), a multiple of 2^-23 (so 1 - u is exact).
// Below 1/64 a series (first omitted term 2 u^5 / 5 < 4e-10); above it
// lg2.approx (MUFU.LG2), whose absolute error (2^-22.6 on [0.5, 2], relative
// below 0.5) moves the radius sqrt(y) >= 0.177 there by under 1e-6. The
// .ftz form skips __log2f's denormal fix-up: 1 - u >= 2^-23 is never one.
__device__ __forceinline__ float minus_two_log1m(float u) {
  const float series = 2.0f * u * fmaf(u, fmaf(u, fmaf(u, 0.25f, 1.0f / 3.0f), 0.5f), 1.0f);
  float lg2;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg2) : "f"(1.0f - u));
  return u < 0.015625f ? series : -1.38629436111989061883f * lg2;  // -2 ln 2 log2
}

// sqrt.approx (MUFU.SQRT): relative error near 2^-23, 0 at 0.
__device__ __forceinline__ float sqrt_approx(float y) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// The values of column quad j4 of a slot in strip b (keys `key`, state
// `st`), by the contract's bits-to-values map: va for row s.row, and in
// pairs mode vb for row s.row + 64 (the sine half). Every kernel draws
// through this function.
template <int MODE>
__device__ __forceinline__ void draw_quad(const Keys& key, uint32_t b, uint32_t j4,
                                          const SlotState& st, float* va, float* vb) {
  // round 0's multiply of c0 = j4, shared by the slot's calls (c3 = 0)
  const uint64_t p0 = (uint64_t)0xD2511F53u * j4;
  const uint32_t c2 = (uint32_t)(p0 >> 32) ^ b, c3 = (uint32_t)p0;
  if (MODE == kRademacher) {
    const Quad q = philox_rounds_1_9(st.c0[0], st.c1[0], c2, c3, key);
#pragma unroll
    for (int i = 0; i < 4; ++i) va[i] = __uint_as_float((q.w[i] & 0x80000000u) | 0x3F800000u);
    return;
  }
  const Quad b1 = philox_rounds_1_9(st.c0[0], st.c1[0], c2, c3, key);
  const Quad b2 = philox_rounds_1_9(st.c0[1], st.c1[1], c2, c3, key);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float radius = sqrt_approx(minus_two_log1m(bits_to_unit(b1.w[i])));
    const float t = 2.0f * bits_to_unit(b2.w[i]);  // exact
    if (MODE == kNormalPairs) {
      float sn, cs;
      sincospif(t, &sn, &cs);
      va[i] = radius * cs;
      vb[i] = radius * sn;
    } else {
      va[i] = radius * cospif(t);
    }
  }
}

// ---------------------------------------------------------------------------
// Strip kernel: the unscaled (k, W) strip b, row-major; one (slot, column
// quad) per thread, quads fastest so neighbouring threads store neighbouring
// float4s.

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gaussian_strip_kernel(float* __restrict__ out, int64_t k, uint32_t qps, uint32_t seed,
                      uint32_t b) {
  const int64_t n_slots = MODE == kNormalPairs ? k / 2 : k;
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= n_slots * qps) return;
  const uint32_t j4 = (uint32_t)(u % qps);
  const Slot s = slot_map<MODE>((uint32_t)(u / qps));
  float va[4], vb[4];
  draw_quad<MODE>(make_keys(seed, b), b, j4, slot_state<MODE>(s, seed), va, vb);
  const int64_t W = 4 * (int64_t)qps;
  *reinterpret_cast<float4*>(out + s.row * W + 4 * j4) = make_float4(va[0], va[1], va[2], va[3]);
  if (MODE == kNormalPairs) {
    *reinterpret_cast<float4*>(out + (s.row + kChunkK) * W + 4 * j4) =
        make_float4(vb[0], vb[1], vb[2], vb[3]);
  }
}

// ---------------------------------------------------------------------------
// Small-m kernel. Block (z, y): slots [S y, S y + S) x column groups [0, G),
// threads S G; block z takes quads [z nq / n_split, (z + 1) nq / n_split) of
// the nq = ceil(n / 4) quads of [0, n), and group g every G-th of them from
// the range's start + g. The wrapper picks S, G and n_split
// (ops/gaussian_cuda.py, slot_tiling and column_split).
// partial is (k, m, n_split): partial[(row m + c) n_split + z].

template <int MODE, int M>
__global__ void __launch_bounds__(kSmallMaxThreads)
gaussian_sketch_small_kernel(const float* __restrict__ x, float* __restrict__ partial,
                             int64_t n, int64_t k, int64_t stride_i, int64_t stride_j,
                             uint32_t qps, uint32_t seed, int S, int G, int64_t n_split) {
  constexpr int R = MODE == kNormalPairs ? 2 : 1;  // rows of a slot
  extern __shared__ float red[];                   // [G - 1][R M][S]
  const int tid = threadIdx.x;
  const int g = tid / S;  // column group: warp-uniform, S % 32 == 0
  const int sl = tid - g * S;
  const uint32_t slot = blockIdx.y * (uint32_t)S + sl;
  // a thread past the last slot draws slot 0's values and writes nothing
  const bool active = slot < (uint32_t)(MODE == kNormalPairs ? k / 2 : k);
  const Slot s = slot_map<MODE>(active ? slot : 0u);
  const SlotState st = slot_state<MODE>(s, seed);
  const int64_t z = blockIdx.x;
  const int64_t nq = (n + 3) / 4;
  const int64_t q_end = (z + 1) * nq / n_split;
  const int64_t q0 = z * nq / n_split + g;
  // this group's quads q0, q0 + G, ...; the last quad of [0, n) is cut
  // when n % 4 != 0, and is peeled off so the loop reads without masks
  const int iters = q0 < q_end ? (int)((q_end - 1 - q0) / G + 1) : 0;
  const bool cut = iters > 0 && n % 4 != 0 && q0 + (int64_t)(iters - 1) * G == nq - 1;
  // x's rows are 4 M floats apart and 16-byte aligned: one float4 per M floats
  const bool vec = (M == 1 || stride_j == 1) && stride_i == M &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;

  float acc[R][M];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < M; ++c) acc[a][c] = 0.0f;

  // position in the strips, once; then advanced by G quads with a wrap
  uint32_t b = (uint32_t)(q0 / qps), j4 = (uint32_t)(q0 % qps);
  Keys key = make_keys(seed, b);
  const float* xq = x + 4 * q0 * stride_i;
  const int64_t step = 4 * (int64_t)G * stride_i;

  auto contract = [&](const float (&xv)[4][M]) {
    float va[4], vb[4];
    draw_quad<MODE>(key, b, j4, st, va, vb);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < M; ++c) {
        acc[0][c] = fmaf(va[i], xv[i][c], acc[0][c]);
        if (R == 2) acc[R - 1][c] = fmaf(vb[i], xv[i][c], acc[R - 1][c]);
      }
    xq += step;
    j4 += G;
    if (j4 >= qps) {  // the next quad lies in a later strip
      do {
        j4 -= qps;
        ++b;
      } while (j4 >= qps);
      key = make_keys(seed, b);
    }
  };

  const int full = iters - (cut ? 1 : 0);
  if (vec) {
    for (int t = 0; t < full; ++t) {
      // at m = 8 each quad of x is a fresh 128-byte line, and the few
      // instructions of an iteration cannot cover its latency from memory:
      // ask for the line kPrefetch iterations ahead into L1
      if (t + kPrefetch < full) {
        asm volatile("prefetch.global.L1 [%0];" ::"l"(xq + kPrefetch * step));
      }
      float xv[4][M];
#pragma unroll
      for (int v = 0; v < M; ++v) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(xq) + v);
        const float e[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) xv[(4 * v + h) / M][(4 * v + h) % M] = e[h];
      }
      contract(xv);
    }
  } else {  // strided x: element loads, no prefetch
    for (int t = 0; t < full; ++t) {
      float xv[4][M];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < M; ++c) xv[i][c] = __ldg(xq + i * stride_i + c * stride_j);
      contract(xv);
    }
  }
  if (cut) {  // columns at i >= n are not read
    float xv[4][M];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < M; ++c)
        xv[i][c] = 4 * (nq - 1) + i < n ? __ldg(xq + i * stride_i + c * stride_j) : 0.0f;
    contract(xv);
  }

  if (G > 1) {  // the column groups of a slot add up once, in group order
    if (g > 0) {
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < M; ++c) red[((g - 1) * R * M + a * M + c) * S + sl] = acc[a][c];
    }
    __syncthreads();
    if (g > 0) return;
    for (int h = 1; h < G; ++h)
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < M; ++c) acc[a][c] += red[((h - 1) * R * M + a * M + c) * S + sl];
  }
  if (!active) return;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < M; ++c)
      partial[((int64_t)(s.row + a * kChunkK) * M + c) * n_split + z] = acc[a][c];
}

// out[e] = scale * sum_z partial[e * stride_e + z * stride_z], e < km, z <
// n_split: one warp per output, lane-strided sums in z order and a fixed
// xor tree, so the result is deterministic. Both sketch kernels end with it.
__global__ void gaussian_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int64_t km, int64_t n_split,
                                       int64_t stride_e, int64_t stride_z, float scale) {
  const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (e >= km) return;  // e is warp-uniform: whole warps leave
  const float* p = partial + e * stride_e;
  float sum = 0.0f;
  for (int64_t z = lane; z < n_split; z += 32) sum += p[z * stride_z];
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xFFFFFFFFu, sum, off);
  if (lane == 0) out[e] = sum * scale;
}

int launch_reduce(const float* partial, float* out, int64_t km, int64_t n_split,
                  int64_t stride_e, int64_t stride_z, double scale, cudaStream_t s) {
  constexpr int kWarps = 8;
  gaussian_reduce_kernel<<<(unsigned)((km + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>(
      partial, out, km, n_split, stride_e, stride_z, (float)scale);
  return (int)cudaGetLastError();
}

// The instances m = 1 .. 8, the small branch (the wrapper's SMALL_M_MAX);
// any other m has none and is refused.
template <int MODE>
const void* small_kernel_m(int m) {
  switch (m) {
    case 1: return (const void*)gaussian_sketch_small_kernel<MODE, 1>;
    case 2: return (const void*)gaussian_sketch_small_kernel<MODE, 2>;
    case 3: return (const void*)gaussian_sketch_small_kernel<MODE, 3>;
    case 4: return (const void*)gaussian_sketch_small_kernel<MODE, 4>;
    case 5: return (const void*)gaussian_sketch_small_kernel<MODE, 5>;
    case 6: return (const void*)gaussian_sketch_small_kernel<MODE, 6>;
    case 7: return (const void*)gaussian_sketch_small_kernel<MODE, 7>;
    case 8: return (const void*)gaussian_sketch_small_kernel<MODE, 8>;
    default: return nullptr;
  }
}

const void* small_kernel(int mode, int m) {
  switch (mode) {
    case kRademacher: return small_kernel_m<kRademacher>(m);
    case kNormalPairs: return small_kernel_m<kNormalPairs>(m);
    case kNormalCos: return small_kernel_m<kNormalCos>(m);
    default: return nullptr;
  }
}

int small_smem(int mode, int m, int S, int G) {
  return (G - 1) * (mode == kNormalPairs ? 2 : 1) * m * S * (int)sizeof(float);
}

bool small_shape_ok(int mode, int m, int S, int G) {
  return small_kernel(mode, m) != nullptr && S >= 32 && S % 32 == 0 && G >= 1 &&
         (int64_t)S * G <= kSmallMaxThreads;
}

// ---------------------------------------------------------------------------
// Tiled kernel (m > SMALL_M_MAX). Block (z, y, c): sketch rows [128 y,
// 128 y + 128) (k-tile y), columns [128 c, 128 c + 128) of x (column chunk
// c; at most the instance's 8 NTW of them are in x), and the tiles
// [z T / n_split, (z + 1) T / n_split) of the T tiles that meet [0, n); tile
// t is columns [32 (t % tps), +32) of strip t / tps, tps = ceil(W / 32), so
// a tile never straddles strips. Warp w = 4 kg + rg: row group rg (32 sketch
// rows, two m-tiles of 16) and k-group kg, which takes every KG-th tile of
// the block's range; a warp holds its rows x the whole chunk (NTW n-tiles)
// in registers, and each k-group writes its own partial sum (partial is
// (n_split KG, k, m): partial[((z KG + kg) k + row) m + col]).
//
// A thread draws its own A fragments. mma.m16n8k8 wants of lane 4 g + t the
// entries (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); the order
// of the k index within a product is free, so k-step (h, s) of a tile (h,
// s in {0, 1}) maps k = t to strip column 16 h + 4 t + 2 s and k = t + 4 to
// the column after it: words 2 s and 2 s + 1 of column quad 4 h + t, the
// quad the thread draws for its rows g and g + 8. The B fragment reads the
// same x rows from the staged tile. Every column of the tile is taken once.

constexpr int kTiledK = 128;  // sketch rows per block (one pair of normal draws)
constexpr int kTiledW = 32;   // strip columns (rows of x) per tile
constexpr int kTiledN = 128;  // most columns of x per block (a column chunk)
// tiles between the moves of the accumulators into the running sums: the
// tensor cores' float32 accumulate truncates, so a sum kept there drifts
// with the number of HMMAs added into it (2.2e-4 of max |out| after 10^4
// k-steps, n = 2^23, PERF.md); 4 tiles are 16 k-steps
constexpr int kFlushTiles = 4;
// how x is staged (the wrapper's strides and alignment pick it): 16-byte
// copies of aligned contiguous rows (kCopyRow16), or of a tile that is one
// contiguous run of memory (kCopyFlat16: x row-major and contiguous with m
// not a multiple of 4, one chunk, aligned; the tile is dense, row w at w
// m), or one copy an element, along a row of x (kCopyRow4) or down a column
// (kCopyCol4, x column-major)
enum Copy { kCopyRow4 = 0, kCopyRow16 = 1, kCopyCol4 = 2, kCopyFlat16 = 3 };

// An instance: NTW n-tiles of 8 columns a warp; 16 warps (4 k-groups) up to
// 32 columns, 8 warps (2 k-groups, up to 255 registers a thread: 64 and 128
// accumulators, no spills) for 64 and 128. A k-group stages x by cp.async into a ring of
// `stages` (32 x P) float tiles, element (w, c) at w P + (c ^ 8 ((w / 4) %
// 4)), so stages - 1 tiles are in flight while one is contracted: the
// swizzle keeps a 16-byte copy (4 columns) whole and makes the B-fragment
// loads (lanes on rows 4 t + const, columns g) free of bank conflicts. Each
// warp splits the B values it loads into hi and lo: splitting the tile once
// into a shared (hi, lo) tile, with the pass and the barrier that takes,
// was 15-22% slower at m = 48-128 (PERF.md). Ring depths 2, 3 and 4
// ran alike; 2 it is.
template <int NTW>
struct TiledShape {
  static constexpr int warps = NTW <= 4 ? 16 : 8;
  static constexpr int threads = 32 * warps;
  static constexpr int groups = warps / 4;  // k-groups KG
  static constexpr int cols = 8 * NTW;      // columns a block holds
  static constexpr int pitch = cols > 32 ? cols : 32;  // P
  static constexpr int stage = kTiledW * pitch;        // one staged tile, floats
  static constexpr int stages = 2;
  static constexpr int ring = groups * stages * stage;  // floats
  // the running sums, thread-private: value v of thread i at v threads + i
  static constexpr int sums = threads * 2 * NTW * 4;
  static constexpr int smem = (ring + sums) * (int)sizeof(float);
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ int swz(int w, int c) { return c ^ (((w >> 2) & 3) << 3); }

// cp.async of `bytes` (0 .. size) from global src into shared dst, the rest
// of the size zero-filled; src is not read when bytes == 0
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// v rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), as
// cvt.rna.tf32.f32 does for finite values: a half unit added to the
// magnitude's bits, the 13 low bits dropped. Two integer operations;
// cvt.rna itself compiles to a longer sequence on sm_90a.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo + O(2^-22 |v|): lo is the rest v - hi, rounded the same way
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a b on the tensor cores: A 16 x 8 (row), B 8 x 8 (col), TF32 in,
// float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The strip b and tile jt within it of a k-group's tiles, advanced by the
// k-group count at a time (no division in the loop).
struct TileWalk {
  int64_t b, jt, tps;
  __device__ __forceinline__ int64_t j0() const { return jt * kTiledW; }
  __device__ __forceinline__ void advance(int tiles) {
    jt += tiles;
    while (jt >= tps) {
      jt -= tps;
      ++b;
    }
  }
};

// cp.async of one x tile (rows b W + j0 + [0, 32), columns col0 + [0, cols))
// into a staged tile by the 128 threads of a k-group (warp rg, lane): rows
// past the strip or past n are zero-filled, so the product needs no masks;
// a column past the chunk reaches only output columns that are never
// written, so it is zero-filled only where that costs nothing.
template <int NTW>
__device__ __forceinline__ void stage_x(float* tile, const float* x, int64_t n, int64_t W,
                                        int64_t stride_i, int64_t stride_j, int64_t col0,
                                        int mc, const TileWalk& walk, int copy, int rg,
                                        int lane) {
  using S = TiledShape<NTW>;
  const int64_t i0 = walk.b * W + walk.j0();
  const int rows = (int)min64(kTiledW, min64(W - walk.j0(), n - i0));
  const float* xt = x + i0 * stride_i + col0 * stride_j;
  if (copy == kCopyFlat16) {  // rows * mc floats from xt on, zeros after them
    const int valid = rows * mc;
    for (int e = 4 * (32 * rg + lane); e < kTiledW * mc; e += 512) {
      const int bytes = 4 * max(0, min(4, valid - e));
      copy16(tile + e, bytes ? xt + e : x, bytes);
    }
  } else if (copy == kCopyRow16) {  // stride_j == 1, 16-byte aligned rows: 4 columns a copy
    const int quads = (mc + 3) / 4;  // copies a row; the columns after them are never read
    if (quads >= 32) {  // a warp a row
      const float* src = xt + rg * stride_i;
      for (int w = rg; w < kTiledW; w += 4, src += 4 * stride_i)
        for (int c = 4 * lane; c < 4 * quads; c += 128) {
          const int bytes = w < rows ? 4 * min(4, mc - c) : 0;
          copy16(tile + w * S::pitch + swz(w, c), bytes ? src + c : x, bytes);
        }
    } else {  // rows of fewer copies than lanes: the tile's copies spread evenly
      // e / quads as a multiply-high: exact for e < 2^10, 2 <= quads <= 32
      const uint32_t recip = 0xFFFFFFFFu / (uint32_t)quads + 1u;
      for (int e = 32 * rg + lane; e < kTiledW * quads; e += 128) {
        const int w = quads == 1 ? e : (int)__umulhi((uint32_t)e, recip);
        const int c = 4 * (e - w * quads);
        const int bytes = w < rows ? 4 * min(4, mc - c) : 0;
        copy16(tile + w * S::pitch + swz(w, c), bytes ? xt + w * stride_i + c : x, bytes);
      }
    }
  } else if (copy == kCopyCol4) {  // lanes down a column: coalesced reads
    for (int c = rg; c < S::cols; c += 4) {
      const int bytes = c < mc && lane < rows ? 4 : 0;
      copy4(tile + lane * S::pitch + swz(lane, c), bytes ? xt + lane * stride_i + c * stride_j : x,
            bytes);
    }
  } else {
    for (int w = rg; w < kTiledW; w += 4)
      for (int c = lane; c < S::cols; c += 32) {
        const int bytes = w < rows && c < mc ? 4 : 0;
        copy4(tile + w * S::pitch + swz(w, c), bytes ? xt + w * stride_i + c * stride_j : x,
              bytes);
      }
  }
}

template <int MODE, int NTW>
__global__ void __launch_bounds__(TiledShape<NTW>::threads, 1)
gaussian_sketch_tiled_kernel(const float* __restrict__ x, float* __restrict__ partial,
                             int64_t n, int64_t m, int64_t k, int64_t stride_i,
                             int64_t stride_j, int64_t W, uint32_t seed, int64_t n_tiles,
                             int copy) {
  using S = TiledShape<NTW>;
  constexpr int KG = S::groups;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % 4, kg = warp / 4;
  const int g = lane / 4, t = lane % 4;
  float* ring = smem + kg * S::stages * S::stage;  // this k-group's staged x tiles

  // this k-group's tiles: kg, kg + KG, ... of the block's range
  const int64_t z = blockIdx.x, n_split = gridDim.x;
  const int64_t t_begin = z * n_tiles / n_split;
  const int64_t count = (z + 1) * n_tiles / n_split - t_begin;
  const int64_t mine = count > kg ? (count - kg + KG - 1) / KG : 0;
  const int64_t tps = (W + kTiledW - 1) / kTiledW;
  TileWalk walk{(t_begin + kg) / tps, (t_begin + kg) % tps, tps};
  const int64_t col0 = (int64_t)blockIdx.z * kTiledN;
  const int mc = (int)min64(kTiledN, m - col0);  // columns of this chunk, <= S::cols
  // the staged tile's row pitch, and this lane's swizzle of a B-fragment
  // column (rows 16 h + 4 t + ..., so (w / 4) % 4 = t); columns past mc
  // hold zeros or the next row's values, which reach only output columns
  // that are never written
  const int pitch = copy == kCopyFlat16 ? mc : S::pitch;
  const int sw = copy == kCopyFlat16 ? 0 : t << 3;

  // this thread's slots: rows g and g + 8 of its two m-tiles. Pairs: slots
  // 16 rg + {g, g + 8} of the k-tile's 64, each giving m-tile 0 (cos, rows
  // 16 rg + ...) and m-tile 1 (sin, rows 64 + 16 rg + ...); otherwise slots
  // 32 rg + 16 mt + {g, g + 8} at rows equal to the slots
  constexpr int kSlotsPerTile = MODE == kNormalPairs ? kTiledK / 2 : kTiledK;
  constexpr int kDraws = MODE == kNormalPairs ? 2 : 4;  // draw_quad calls a quad
  const int64_t n_slots = MODE == kNormalPairs ? k / 2 : k;
  // the state of draw d's slot (a slot past k draws slot 0's values, never
  // written); cos halves hold 4 slots of 4 words, and recompute each at its
  // draw rather than hold them
  constexpr bool kHold = MODE != kNormalCos;
  auto state_of = [&](int d) -> SlotState {
    const int local = MODE == kNormalPairs ? 16 * rg + g + 8 * d
                                           : 32 * rg + 16 * (d / 2) + g + 8 * (d % 2);
    const int64_t slot = (int64_t)blockIdx.y * kSlotsPerTile + local;
    return slot_state<MODE>(slot_map<MODE>(slot < n_slots ? (uint32_t)slot : 0u), seed);
  };
  SlotState held[kHold ? kDraws : 1];
#pragma unroll
  for (int d = 0; d < (kHold ? kDraws : 0); ++d) held[d] = state_of(d);
  int64_t key_b = walk.b;
  Keys key = make_keys(seed, (uint32_t)key_b);

  float acc[2][NTW][4];
  float* sums = smem + S::ring + threadIdx.x;  // this thread's running sums
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][j][e] = 0.0f;
        sums[((mt * NTW + j) * 4 + e) * S::threads] = 0.0f;
      }
  // acc moved into the running sums by an IEEE add, and cleared
  auto flush = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sums[((mt * NTW + j) * 4 + e) * S::threads] += acc[mt][j][e];
          acc[mt][j][e] = 0.0f;
        }
  };

  // a copy group per tile, empty past the last, so that waiting for all but
  // the stages - 2 newest groups waits for tile i
  TileWalk ahead = walk;  // the tile whose copies start next
  for (int p = 0; p < S::stages - 1; ++p) {
    if (p < mine) {
      stage_x<NTW>(ring + p * S::stage, x, n, W, stride_i, stride_j, col0, mc, ahead, copy, rg,
                   lane);
      ahead.advance(KG);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int64_t i = 0; i < mine; ++i, walk.advance(KG)) {
    asm volatile("cp.async.wait_group %0;" ::"n"(S::stages - 2) : "memory");
    // every copy of tile i of this k-group landed, and its warps are done
    // with tile i - 1, whose stage the next copies take
    asm volatile("bar.sync %0, %1;" ::"r"(1 + kg), "r"(128) : "memory");
    if (i + S::stages - 1 < mine) {
      stage_x<NTW>(ring + ((i + S::stages - 1) % S::stages) * S::stage, x, n, W, stride_i,
                   stride_j, col0, mc, ahead, copy, rg, lane);
      ahead.advance(KG);
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
    if (walk.b != key_b) {  // round keys once per strip
      key_b = walk.b;
      key = make_keys(seed, (uint32_t)key_b);
    }
    const float* xt = ring + (i % S::stages) * S::stage;

    const uint32_t j4 = (uint32_t)(walk.j0() / 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // quad 4 h + t of each slot: va[d] (and vb[d], the sines, in pairs mode)
      float va[kDraws][4], vb[kDraws][4];
#pragma unroll
      for (int d = 0; d < kDraws; ++d)
        draw_quad<MODE>(key, (uint32_t)walk.b, j4 + 4 * h + t, kHold ? held[kHold ? d : 0] : state_of(d),
                        va[d], vb[d]);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        // A fragments of m-tiles 0 and 1, k-step (h, s): words 2 s, 2 s + 1
        uint32_t a_hi[2][4], a_lo[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* r0 = MODE == kNormalPairs ? (mt ? vb[0] : va[0]) : va[2 * mt];
          const float* r8 = MODE == kNormalPairs ? (mt ? vb[1] : va[1]) : va[2 * mt + 1];
          split_tf32(r0[2 * s], a_hi[mt][0], a_lo[mt][0]);
          split_tf32(r8[2 * s], a_hi[mt][1], a_lo[mt][1]);
          split_tf32(r0[2 * s + 1], a_hi[mt][2], a_lo[mt][2]);
          split_tf32(r8[2 * s + 1], a_hi[mt][3], a_lo[mt][3]);
        }
        // B fragment rows: x rows 16 h + 4 t + 2 s and the next, column g
        // (the swizzle is the same for both; a flat tile has none)
        const int w = 16 * h + 4 * t + 2 * s;
        const float* b0 = xt + w * pitch;
        const float* b1 = b0 + pitch;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
          const int c = (8 * j + g) ^ sw;
          uint32_t b_hi[2], b_lo[2];
          split_tf32(b0[c], b_hi[0], b_lo[0]);
          split_tf32(b1[c], b_hi[1], b_lo[1]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[mt][j], a_hi[mt], b_lo);
            if (MODE != kRademacher) mma_tf32(acc[mt][j], a_lo[mt], b_hi);  // +-1 is exact
            mma_tf32(acc[mt][j], a_hi[mt], b_hi);
          }
        }
      }
    }
    if (i % kFlushTiles == kFlushTiles - 1) flush();
  }
  flush();

  // C fragment: rows g, g + 8, columns 2 t, 2 t + 1 of each (m-tile, n-tile)
  float* part = partial + ((int64_t)blockIdx.x * KG + kg) * k * m;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int64_t row0 = (int64_t)blockIdx.y * kTiledK +
                         (MODE == kNormalPairs ? 64 * mt + 16 * rg : 32 * rg + 16 * mt) + g;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + 8 * h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;
          if (row < k && c < mc) {
            part[row * m + col0 + c] = sums[((mt * NTW + j) * 4 + 2 * h + e) * S::threads];
          }
        }
      }
  }
}

// The instances: NTW = 1, 2, 4, 8 (16 warps) and 16 (8 warps).
template <int MODE>
const void* tiled_kernel_ntw(int ntw) {
  switch (ntw) {
    case 1: return (const void*)gaussian_sketch_tiled_kernel<MODE, 1>;
    case 2: return (const void*)gaussian_sketch_tiled_kernel<MODE, 2>;
    case 4: return (const void*)gaussian_sketch_tiled_kernel<MODE, 4>;
    case 8: return (const void*)gaussian_sketch_tiled_kernel<MODE, 8>;
    case 16: return (const void*)gaussian_sketch_tiled_kernel<MODE, 16>;
    default: return nullptr;
  }
}

const void* tiled_kernel(int mode, int ntw) {
  switch (mode) {
    case kRademacher: return tiled_kernel_ntw<kRademacher>(ntw);
    case kNormalPairs: return tiled_kernel_ntw<kNormalPairs>(ntw);
    case kNormalCos: return tiled_kernel_ntw<kNormalCos>(ntw);
    default: return nullptr;
  }
}

int tiled_threads(int ntw) { return ntw <= 4 ? TiledShape<4>::threads : TiledShape<16>::threads; }

int tiled_smem(int ntw) {
  switch (ntw) {
    case 1: return TiledShape<1>::smem;
    case 2: return TiledShape<2>::smem;
    case 4: return TiledShape<4>::smem;
    case 8: return TiledShape<8>::smem;
    default: return TiledShape<16>::smem;
  }
}

// The instance for x (., m): the fewest n-tiles a warp that hold one column
// chunk (m padded to a multiple of 8 only).
int tiled_ntw(int64_t m) {
  const int64_t cols = (min64(m, kTiledN) + 7) / 8;
  int ntw = 1;
  while (ntw < cols) ntw *= 2;
  return ntw;
}

// Tiles of kTiledW strip columns that meet [0, n): whole strips, then the
// cut last one.
int64_t tiled_tiles(int64_t n, int64_t W) {
  const int64_t tps = (W + kTiledW - 1) / kTiledW;
  return n / W * tps + (n % W + kTiledW - 1) / kTiledW;
}

bool mode_ok(int mode, int64_t k) {
  return k >= 1 && mode >= 0 && mode <= 2 && !(mode == kNormalPairs && k % (2 * kChunkK));
}

}  // namespace

extern "C" {

// Strip b of the unscaled Omega into out (k, W) float32, row-major.
// Returns the cudaError_t of the launch (0 on success).
int gaussian_strip_f32(float* out, int64_t k, int64_t W, uint32_t seed, uint32_t b, int mode,
                       void* stream) {
  if (!mode_ok(mode, k) || W < 4 || W % 4 || W / 4 > 0xFFFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t units = (mode == kNormalPairs ? k / 2 : k) * (W / 4);
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const uint32_t qps = (uint32_t)(W / 4);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kRademacher:
      gaussian_strip_kernel<kRademacher><<<(unsigned)blocks, kThreads, 0, s>>>(out, k, qps, seed, b);
      break;
    case kNormalPairs:
      gaussian_strip_kernel<kNormalPairs><<<(unsigned)blocks, kThreads, 0, s>>>(out, k, qps, seed, b);
      break;
    default:
      gaussian_strip_kernel<kNormalCos><<<(unsigned)blocks, kThreads, 0, s>>>(out, k, qps, seed, b);
  }
  return (int)cudaGetLastError();
}

// The most threads (slots per block x column groups) a block of the small
// kernel takes: its launch bound.
int gaussian_sketch_small_max_threads(void) { return kSmallMaxThreads; }

// Resident blocks per SM of the small kernel for (mode, m) with S slots x G
// column groups a block, on the current device, into *blocks_per_sm.
int gaussian_sketch_small_occupancy(int mode, int m, int S, int G, int* blocks_per_sm) {
  if (mode < 0 || mode > 2 || !small_shape_ok(mode, m, S, G)) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, small_kernel(mode, m), S * G, (size_t)small_smem(mode, m, S, G));
}

// out (k, m) = (1/sqrt(k)) Omega x for x (n, m <= 8) float32 at (stride_i,
// stride_j), by the small kernel on a grid of n_split x ceil(slots / S)
// blocks of S x G threads and the warp reduction. partial is caller-allocated
// scratch of k * m * n_split floats. Returns the cudaError_t of the launches.
int gaussian_sketch_small_f32(const float* x, float* partial, float* out, int64_t n, int64_t m,
                              int64_t k, int64_t stride_i, int64_t stride_j, int64_t W,
                              uint32_t seed, int mode, int S, int G, int64_t n_split,
                              double scale, void* stream) {
  if (n < 1 || m < 1 || m > 0x7FFFFFFF || !mode_ok(mode, k) || W < 4 || W % 4 ||
      W / 4 > 0xFFFFFFFF || !small_shape_ok(mode, (int)m, S, G) || n_split < 1 || n_split > 0x7FFFFFFF ||
      k > 0xFFFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t slots = mode == kNormalPairs ? k / 2 : k;
  const int64_t slot_tiles = (slots + S - 1) / S;
  if (slot_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t qps = (uint32_t)(W / 4);
  const int smem = small_smem(mode, (int)m, S, G);
  void* args[] = {(void*)&x,        (void*)&partial, (void*)&n,    (void*)&k,
                  (void*)&stride_i, (void*)&stride_j, (void*)&qps, (void*)&seed,
                  (void*)&S,        (void*)&G,        (void*)&n_split};
  cudaError_t err = cudaLaunchKernel(small_kernel(mode, (int)m),
                                     dim3((unsigned)n_split, (unsigned)slot_tiles),
                                     dim3((unsigned)(S * G)), args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, out, k * m, n_split, n_split, 1, scale, s);
}

// The tiled kernel's shared memory (up to 192 KB a block, over the 48 KB
// default) on the current device, for every instance; once per device,
// before the first launch there.
int gaussian_sketch_tiled_prepare(void) {
  for (int ntw = 1; ntw <= 16; ntw *= 2)
    for (int mode = 0; mode <= 2; ++mode) {
      const cudaError_t err = cudaFuncSetAttribute(
          tiled_kernel(mode, ntw), cudaFuncAttributeMaxDynamicSharedMemorySize, tiled_smem(ntw));
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// The k-groups (partial sums a tile range) of the instance that takes x (.,
// m); 0 for m < 1.
int gaussian_sketch_tiled_groups(int64_t m) {
  if (m < 1) return 0;
  return tiled_threads(tiled_ntw(m)) / 128;
}

// Resident blocks per SM of that instance (mode) on the current device,
// into *blocks_per_sm; after gaussian_sketch_tiled_prepare.
int gaussian_sketch_tiled_occupancy(int mode, int64_t m, int* blocks_per_sm) {
  if (mode < 0 || mode > 2 || gaussian_sketch_tiled_groups(m) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int ntw = tiled_ntw(m);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, tiled_kernel(mode, ntw), tiled_threads(ntw), (size_t)tiled_smem(ntw));
}

// out (k, m) = (1/sqrt(k)) Omega x for x (n, m) float32 at (stride_i,
// stride_j) by the tiled kernel on a grid of n_split x ceil(k / 128) x
// ceil(m / 128) blocks, and the warp reduction; partial is caller-allocated scratch of
// n_split * KG * k * m floats (KG = gaussian_sketch_tiled_groups), 1 <=
// n_split <= the tiles that meet [0, n) (ceil(W / 32) a whole strip).
// Returns the cudaError_t of the launches (0 on success).
int gaussian_sketch_tiled_f32(const float* x, float* partial, float* out, int64_t n, int64_t m,
                              int64_t k, int64_t stride_i, int64_t stride_j, int64_t W,
                              uint32_t seed, int mode, int64_t n_split, double scale,
                              void* stream) {
  const int groups = gaussian_sketch_tiled_groups(m);
  if (n < 1 || !mode_ok(mode, k) || W < 4 || W % 4 || W / 4 > 0xFFFFFFFF || stride_i < 0 ||
      stride_j < 0 || groups == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_tiles = tiled_tiles(n, W);
  const int64_t k_tiles = (k + kTiledK - 1) / kTiledK;
  const int64_t chunks = (m + kTiledN - 1) / kTiledN;
  if (n_split < 1 || n_split > n_tiles || n_split * groups > 0x7FFFFFFF || k_tiles > 65535 ||
      chunks > 65535 || (n - 1) / W > 0xFFFFFFFF) {
    return (int)cudaErrorInvalidValue;
  }
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  int copy = kCopyRow4;
  if (stride_j == 1 && m > 1) {
    // rows of 4 k floats take the swizzled tile (conflict-free B loads);
    // other contiguous rows are copied as one dense run (a tile starts at
    // a row i0 = 0 mod 4, so it stays aligned)
    copy = aligned && stride_i % 4 == 0              ? kCopyRow16
           : aligned && stride_i == m && m <= kTiledN ? kCopyFlat16
                                                      : kCopyRow4;
  } else if (stride_i == 1) {
    copy = kCopyCol4;
  }
  const int ntw = tiled_ntw(m);
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {(void*)&x,    (void*)&partial, (void*)&n,    (void*)&m,
                  (void*)&k,    (void*)&stride_i, (void*)&stride_j, (void*)&W,
                  (void*)&seed, (void*)&n_tiles, (void*)&copy};
  cudaError_t err = cudaLaunchKernel(
      tiled_kernel(mode, ntw), dim3((unsigned)n_split, (unsigned)k_tiles, (unsigned)chunks),
      dim3(tiled_threads(ntw)), args, (size_t)tiled_smem(ntw), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t partials = n_split * groups;
  return launch_reduce(partial, out, k * m, partials, 1, k * m, scale, s);
}

}  // extern "C"
