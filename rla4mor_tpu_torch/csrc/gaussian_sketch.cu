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
// (4 n m bytes at 3.35 TB/s); the contraction, 2 k n m flop at 67 TFLOP/s on
// the CUDA cores; and the generation, which no layout avoids: one Philox call
// per 4 entries (pairs, Rademacher) or per 2 (cos halves, which draw 2 calls
// for 4 entries of one row and keep no sine). A call is ten rounds of two
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
// Two branches, picked by the wrapper (ops/gaussian_cuda.py, SMALL_M_MAX):
//
// * m <= 8, every launch of the HwPrng path (m = 1): `small` kernel. Omega
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
// * m > 8: `tiled` kernel: a block generates a (128 x 128)
//   tile of Omega once into shared memory and contracts it with chunks of 32
//   columns of x, so each entry is drawn once per launch whatever m is; a
//   split-K over tile runs, summed by the same warp reduction. It draws
//   through the same device functions as the other kernels. At m <= 8 it
//   multiplied each value by 8 columns of x, 7 of them padding at m = 1, and
//   ran 1.29 waves of 68 KB blocks; the small branch has neither cost. The
//   threshold 8 is where the small branch's registers run out (2 x m
//   accumulators and 4 x m values of x a thread in pairs mode: 110-127
//   registers at m = 7, 8); the bench rows at m = 8 and m = 9 in
//   chip_smoke.py measure the two sides of it (PERF.md).
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
constexpr int kTileK = 128;  // tiled kernel: sketch rows per tile (one pair of normal draws)
constexpr int kTileW = 128;  // tiled kernel: strip columns (rows of x) per tile
constexpr int kTiledMC = 32;  // tiled kernel: columns of x per chunk
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
// Tiled kernel (m > 8). Block (z, kt): sketch rows [128 kt, 128 kt + 128),
// tiles [z * tiles_per_split, (z + 1) * tiles_per_split) of the n_tiles
// tiles that meet [0, n); tile t is columns [128 (t % tps), +128) of strip
// t / tps, tps = ceil(W / 128). Thread (tx, ty) owns rows 128 kt + RT ty +
// [0, RT) and columns TX * jj + tx (jj < CT) of each MC-column chunk.

template <int MODE, int MC, int TX>
__global__ void __launch_bounds__(kThreads)
gaussian_sketch_tiled_kernel(const float* __restrict__ x, float* __restrict__ partial,
                             int64_t n, int64_t m, int64_t k, int64_t stride_i,
                             int64_t stride_j, int64_t W, uint32_t seed, int64_t n_tiles,
                             int64_t tiles_per_split) {
  constexpr int TY = kThreads / TX;
  constexpr int RT = kTileK / TY;
  constexpr int CT = MC / TX;
  static_assert(RT % 4 == 0 && TX * CT == MC, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* om = smem;                    // [kTileW][kTileK]: om[w * 128 + row]
  float* xs = smem + kTileW * kTileK;  // [kTileW][MC]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t row0 = (int64_t)blockIdx.y * kTileK;
  const int64_t z = blockIdx.x;
  const int64_t t_begin = z * tiles_per_split;
  const int64_t t_end = t_begin + tiles_per_split < n_tiles ? t_begin + tiles_per_split : n_tiles;
  const int64_t tps = (W + kTileW - 1) / kTileW;
  const int64_t n_chunks = (m + MC - 1) / MC;
  const bool i_fastest = stride_i == 1;
  float* part = partial + z * k * m;

  // generation units of a tile: (slot, column quad), slot fastest; a pairs
  // slot fills two rows of the tile
  const int slots = MODE == kNormalPairs ? kChunkK : kTileK;
  const int units = slots * (kTileW / 4);
  const int64_t slot0 = MODE == kNormalPairs ? row0 / 2 : row0;
  const int64_t n_slots = MODE == kNormalPairs ? k / 2 : k;

  float acc[RT][CT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[a][c] = 0.0f;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t b = t / tps;
    const int64_t j0 = (t % tps) * kTileW;  // first strip column of the tile
    const Keys key = make_keys(seed, (uint32_t)b);
    __syncthreads();  // the previous tile's reads are done
    for (int u = tid; u < units; u += kThreads) {
      const int sl = u % slots;
      const int q = u / slots;  // column quad within the tile
      const int64_t j = j0 + 4 * q;
      float va[4] = {0.f, 0.f, 0.f, 0.f}, vb[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < W && slot0 + sl < n_slots) {
        draw_quad<MODE>(key, (uint32_t)b, (uint32_t)(j / 4),
                        slot_state<MODE>(slot_map<MODE>((uint32_t)(slot0 + sl)), seed), va, vb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        om[(4 * q + i) * kTileK + sl] = va[i];
        if (MODE == kNormalPairs) om[(4 * q + i) * kTileK + sl + kChunkK] = vb[i];
      }
    }
    for (int64_t ch = 0; ch < n_chunks; ++ch) {
      const int64_t c0 = ch * MC;
      __syncthreads();  // om written; the previous chunk's reads of xs done
      for (int e = tid; e < kTileW * MC; e += kThreads) {
        const int w = i_fastest ? e % kTileW : e / MC;
        const int c = i_fastest ? e / kTileW : e % MC;
        const int64_t j = j0 + w;
        const int64_t i = b * W + j;
        float v = 0.0f;
        if (j < W && i < n && c0 + c < m) v = x[i * stride_i + (c0 + c) * stride_j];
        xs[w * MC + c] = v;
      }
      __syncthreads();
      if (n_chunks > 1) {  // partial sums of this chunk live in the buffer
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int64_t s = row0 + RT * ty + a, col = c0 + TX * c + tx;
            acc[a][c] = (t > t_begin && s < k && col < m) ? part[s * m + col] : 0.0f;
          }
      }
#pragma unroll 4
      for (int w = 0; w < kTileW; ++w) {
        float av[RT], bv[CT];
#pragma unroll
        for (int a = 0; a < RT; a += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(om + w * kTileK + RT * ty + a);
          av[a] = v4.x;
          av[a + 1] = v4.y;
          av[a + 2] = v4.z;
          av[a + 3] = v4.w;
        }
#pragma unroll
        for (int c = 0; c < CT; ++c) bv[c] = xs[w * MC + TX * c + tx];
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int c = 0; c < CT; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
      if (n_chunks > 1) {
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const int64_t s = row0 + RT * ty + a, col = c0 + TX * c + tx;
            if (s < k && col < m) part[s * m + col] = acc[a][c];
          }
      }
    }
  }
  if (n_chunks == 1) {
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int64_t s = row0 + RT * ty + a, col = TX * c + tx;
        if (s < k && col < m) part[s * m + col] = acc[a][c];
      }
  }
}

const void* tiled_kernel(int mode) {
  switch (mode) {
    case kRademacher:
      return (const void*)gaussian_sketch_tiled_kernel<kRademacher, kTiledMC, 16>;
    case kNormalPairs:
      return (const void*)gaussian_sketch_tiled_kernel<kNormalPairs, kTiledMC, 16>;
    case kNormalCos:
      return (const void*)gaussian_sketch_tiled_kernel<kNormalCos, kTiledMC, 16>;
    default: return nullptr;
  }
}

constexpr int kTiledSmem = (kTileW * kTileK + kTileW * kTiledMC) * (int)sizeof(float);

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

// The tiled kernel's shared memory (68 KB a block, over the 48 KB default)
// on the current device; once per device, before its first launch there.
int gaussian_sketch_tiled_prepare(void) {
  for (int mode = 0; mode <= 2; ++mode) {
    const cudaError_t err = cudaFuncSetAttribute(
        tiled_kernel(mode), cudaFuncAttributeMaxDynamicSharedMemorySize, kTiledSmem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// out (k, m) = (1/sqrt(k)) Omega x for x (n, m) float32 at (stride_i,
// stride_j) by the tiled kernel; partial is caller-allocated scratch of
// n_split * k * m floats, n_split = ceil(n_tiles / tiles_per_split).
// Returns the cudaError_t of the launches (0 on success).
int gaussian_sketch_tiled_f32(const float* x, float* partial, float* out, int64_t n, int64_t m,
                              int64_t k, int64_t stride_i, int64_t stride_j, int64_t W,
                              uint32_t seed, int mode, int64_t n_tiles,
                              int64_t tiles_per_split, double scale, void* stream) {
  if (n < 1 || m < 1 || !mode_ok(mode, k) || W < 4 || W % 4 || n_tiles < 1 ||
      tiles_per_split < 1 || (k + kTileK - 1) / kTileK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_split = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  if (n_split > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  void* args[] = {(void*)&x, (void*)&partial, (void*)&n,     (void*)&m,
                  (void*)&k, (void*)&stride_i, (void*)&stride_j, (void*)&W,
                  (void*)&seed, (void*)&n_tiles, (void*)&tiles_per_split};
  cudaError_t err = cudaLaunchKernel(
      tiled_kernel(mode), dim3((unsigned)n_split, (unsigned)((k + kTileK - 1) / kTileK)),
      dim3(kThreads), args, (size_t)kTiledSmem, s);
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, out, k * m, n_split, 1, k * m, scale, s);
}

}  // extern "C"
