// One-pass sampled SRHT on Hopper (sm_90a), CUDA C++ with a plain C interface.
//
//   out[s, j] = scale * sum_{i < n} (-1)^popcount(sigma[s] & i) * d[i] * x[i, j]
//
// with sigma the k sampled Hadamard rows in [0, 2^d), d = ceil(log2 n), d[i]
// the int8 Rademacher signs and scale = 1/sqrt(k). Summing over i < n only is
// the zero-padding semantics of the reference SRHT (rla4mor_tpu/ops/fwht.py
// `srht`, `_flat_plan` in rla4mor_tpu/ops/srht_pallas.py), so any n works.
//
// Replaces the TPU kernels `srht_pallas` and `srht_pallas_packed`
// (rla4mor_tpu/ops/srht_pallas.py) and their XLA twins, which all compute
// this function through the (P, Q, R) / (B, R) Hadamard factorisation, for
// float32 and bfloat16 input (and here float64 and float16 too). As there,
// the sums run in promote(input, float32): float32 for the 2- and 4-byte
// types, float64 for float64. 2-byte input is widened to float32 on its way
// from shared memory into registers (x * d[i] is exact in any of the types);
// the output is the accumulator's type or, when asked, the input's, written
// by the last reduction directly.
//
// The factorisation. With i = b R + r and sigma = sigma_hi R + sigma_lo
// (R = 2^log2_r, b < ceil(n / R)),
//
//   H[sigma, i] = H_B[sigma_hi, b] * H_R[sigma_lo, r],
//
// so the sketch is an unnormalised Walsh-Hadamard transform (FWHT) of
// length R of each block of d * x, a gather of the k rows sigma_lo, and a
// +-1 sum over the blocks with H_B[sigma_hi, b] = (-1)^popcount(sigma_hi & b).
// A launch may start at block b0 of a longer vector (`block_offset`, a
// rank's rows of the sharded SRHT): its block b is then column b0 + b of
// H_B, and the rest is unchanged.
// Any power-of-two R gives the same function (for n < R the one block is
// zero-padded); the instances here are for R = 2^11.
//
// What bounds it: log2 R + k / R adds per input element instead of the
// direct product's k FMAs, so the one read of x (bytes) is its floor. The
// per-element work is a shared-memory load, a sign select, log2 R
// butterflies (registers and warp shuffles) and a store back. On an H100
// (700 W) it reaches 68-72% of the bytes bound at 56 columns of 2^24 in
// the rows layout and 36-47% in the columns layout, whose element copies
// read 16 or 32 bytes of each row; more CTAs an SM moved it there and
// more cp.async stages did not, so the transform's issue rate or latency
// bounds the rows layout, not the loads. At the slice's n = 261,121, m = 1
// (128 blocks) the launch and the two-level reduction set its 0.01 ms.
// bf16 input halves the bytes and keeps the transform's work: on an NVIDIA
// H100 80GB HBM3 at 700 W, 1.49 ms at 56 columns of 2^24 in the rows layout
// (38% of its bytes bound, 1.1x faster than float32), 2.39 ms in the
// columns layout (23%), where the element path of a misaligned view takes
// 3.6 ms.
//
// Design.
// - Persistent grid (column tile, sampled-row tile, block range): one CTA
//   per resident slot (the wrapper sizes it with the occupancy API), each
//   taking a contiguous range of blocks of one MT-column tile.
// - Two cp.async stages: block b+1's (R, MT) tile of x and its R int8
//   signs are copied into shared memory while block b is transformed.
//   Rows >= n and columns >= m are zero-filled by the copy (src-size 0 or
//   short), never read. Ways in, by layout (the `mode` of a launch):
//   * rows layout (stride_i == 1, aligned): 16-byte copies along i into a
//     column-major tile, columns ld_in = R + 16 bytes apart;
//   * 4- and 8-byte types otherwise (the columns layout among them): one
//     cp.async per element, along the smaller stride of x (ld keeps those
//     copies on distinct banks);
//   * 2-byte types in the columns layout (stride_j == 1, aligned, MT >= 2):
//     cp.async copies only 4, 8 or 16 bytes, so a copy takes one row of the
//     tile, MT values (4 or 8 bytes), into a row-major tile;
//   * 2-byte types otherwise (a misaligned view, other strides): ld.global
//     into registers and st.shared, one element at a time, synchronous.
// - FWHT of each column with IEEE adds only (a +-1 FMA is an exact add):
//   a thread holds the values of kE rows (l + 32 e, l its lane) of one
//   column, so row bits 0-4 go through __shfl_xor_sync and the next
//   log2 kE bits through registers (R MT / 256 values a thread, MT <= 4).
//   The warps that share a column leave their top row bits to the gather.
//   4- and 8-byte types transform in place; 2-byte types are read from
//   their stage and written, widened, to one float32 tile (MT ld values)
//   that the gather reads.
// - Gather fused with the H_B recombination: a thread owns up to four
//   sampled rows of the CTA's row tile; per block it reads T[sigma_lo, j]
//   from shared memory (summing the parts of the warps that share the
//   column, with their +-1 signs), multiplies by H_B[sigma_hi, b] and adds
//   into a register accumulator that lives across the CTA's blocks. No
//   tensor cores: an FWHT costs log2 R adds per element against k MACs
//   for the +-1 product.
// - Deterministic reduction in the same launch: each CTA writes its
//   (rows, MT) partial sums; the last CTA to finish of each group of about
//   sqrt(n_split) CTAs sums the group's partials in a fixed order, and the
//   last group of the tile sums the group sums and applies the scale once
//   (counters the caller keeps zero pick those CTAs and reset themselves).
//   No atomics in the sums, and no long serial chains.
// - One launch a call; the launch record (SrhtLaunch) is built once per
//   shape by the wrapper, so the host's work per call is small.
// Input is read in place through (stride_i, stride_j), so (n, m) columns and
// (m, n) / (m, B, R) rows layouts need no copy. Offsets are int64.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// What a launch needs besides the pointers: built once per device and
// shape by the wrapper (ops/srht_cuda.py, ``_Launch``, same field order).
// ld is the column stride of the accumulator's tile.
struct SrhtLaunch {
  int64_t n, m, k, stride_i, stride_j;
  int64_t blocks_per_cta, n_split;  // block range of CTA z: [z bpc, (z + 1) bpc) cut at B
  int64_t group;                    // CTAs whose partial sums one of them adds first
  int32_t device, log2_r, mt, ld, smem;
  double scale;
};

namespace {

constexpr int kLogR = 11;  // the block length of the instances
constexpr int kR = 1 << kLogR;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;  // sampled rows a thread accumulates
constexpr int kRowsPerCta = kThreads * kRowsPerThread;

// the input dtypes of the C interface
enum Dtype : int { kF32 = 0, kF64 = 1, kBF16 = 2, kF16 = 3 };
// how a block's tile comes in (module note)
enum Mode : int { kVec16 = 0, kElemAsync = 1, kTileRows = 2, kElemSync = 3 };

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// the type the sums run in: promote(TIn, float32)
template <typename TIn> struct AccOf { using type = float; };
template <> struct AccOf<double> { using type = double; };
template <typename TIn> using Acc = typename AccOf<TIn>::type;

// column stride of the input stage: the accumulator's ld where the tile is
// transformed in place, else R + 16 bytes of TIn
template <typename TIn>
__host__ __device__ constexpr bool kInPlace() { return sizeof(TIn) == sizeof(Acc<TIn>); }
template <typename TIn>
__host__ __device__ int ld_in(int ld) { return kInPlace<TIn>() ? ld : kR + 16 / (int)sizeof(TIn); }

// dynamic shared memory of an (TIn, MT) CTA: two stages of (the input tile,
// R signs), then, for 2-byte types, the float32 tile the transform writes
template <typename TIn>
__host__ __device__ int64_t smem_bytes(int mt, int ld) {
  const int64_t stage = (int64_t)mt * ld_in<TIn>(ld) * sizeof(TIn) + kR;
  return 2 * stage + (kInPlace<TIn>() ? 0 : (int64_t)mt * ld * sizeof(Acc<TIn>));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename TIn> __device__ __forceinline__ TIn zero_of() { return TIn(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0);
}
template <> __device__ __forceinline__ __half zero_of<__half>() {
  return __ushort_as_half((unsigned short)0);
}

// the accumulator rounded to the input's type (the narrow output)
template <typename TIn> __device__ __forceinline__ TIn narrow(Acc<TIn> v) { return (TIn)v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes, of which the first src_bytes come from src and the
// rest are zeros (src is not read when src_bytes is 0).
__device__ __forceinline__ void copy16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// cp.async of BYTES = 4, 8 or 16 bytes through L1, zero-filled past src_bytes
template <int BYTES>
__device__ __forceinline__ void copy_small(void* dst, const void* src, int src_bytes) {
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "cp.async copies 4, 8 or 16 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(shared_addr(dst)),
               "l"(src), "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Geometry of the (T, MT) kernel's column-major tile: the kWarps warps
// split into MT groups of kWc, one group a column.
template <int MT>
struct Tile {
  static constexpr int kWc = kWarps / MT;        // warps per column
  static constexpr int kE = kR / (32 * kWc);     // rows a thread transforms
  static constexpr int kP = 32 * kE;             // rows a warp transforms
  static constexpr int kLogP = ilog2(kP);
};

// Start the loads of block b (rows [b R, b R + R)) of the tile's columns
// [j0, j0 + MT) into xs and its signs into sg (the caller commits), by
// `mode` (module note). The tile is column-major (columns ldi apart) but
// in kTileRows, where row ii holds its MT values at ii MT.
template <typename TIn, int MT>
__device__ __forceinline__ void load_block(TIn* xs, int8_t* sg, const TIn* __restrict__ x,
                                           const int8_t* __restrict__ signs, int64_t b,
                                           int64_t j0, int64_t n, int64_t m, int64_t stride_i,
                                           int64_t stride_j, int ldi, int mode) {
  constexpr int kV16 = 16 / sizeof(TIn);
  const int tid = threadIdx.x;
  const int64_t i0 = b * kR;
  if (mode == kVec16) {
    constexpr int kPerCol = kR / kV16;
#pragma unroll 4
    for (int c = tid; c < MT * kPerCol; c += kThreads) {
      const int jj = c / kPerCol;
      const int ii = (c % kPerCol) * kV16;
      const int64_t i = i0 + ii, j = j0 + jj;
      const TIn* src = x;
      int bytes = 0;
      if (j < m && i < n) {
        src = x + i + j * stride_j;
        bytes = (int)(min64(kV16, n - i) * sizeof(TIn));
      }
      copy16(xs + jj * ldi + ii, src, bytes);
    }
  } else if (mode == kTileRows) {
    if constexpr (sizeof(TIn) == 2 && MT >= 2) {  // one row of MT values a copy
      const int bytes_row = (int)(min64(MT, m - j0) * sizeof(TIn));
#pragma unroll 4
      for (int ii = tid; ii < kR; ii += kThreads) {
        const int64_t i = i0 + ii;
        const bool in = i < n;
        copy_small<MT * sizeof(TIn)>(xs + ii * MT, in ? x + i * stride_i + j0 : x,
                                     in ? bytes_row : 0);
      }
    }
  } else {  // one element at a time, along the smaller stride of x first
    const bool i_fast = stride_i <= stride_j;
#pragma unroll 4
    for (int e = tid; e < MT * kR; e += kThreads) {
      const int ii = i_fast ? e % kR : e / MT;
      const int jj = i_fast ? e / kR : e % MT;
      const int64_t i = i0 + ii, j = j0 + jj;
      const bool in = j < m && i < n;
      const TIn* src = in ? x + i * stride_i + j * stride_j : x;
      if constexpr (sizeof(TIn) >= 4) {  // kElemAsync
        copy_small<sizeof(TIn)>(xs + jj * ldi + ii, src, in ? (int)sizeof(TIn) : 0);
      } else {  // kElemSync: no 2-byte cp.async
        xs[jj * ldi + ii] = in ? *src : zero_of<TIn>();
      }
    }
  }
  if (tid < kR / 16) {  // the block's signs, 16 a copy; 0 past n
    const int64_t i = i0 + 16 * tid;
    const int8_t* src = signs;
    int bytes = 0;
    if (i < n) {
      src = signs + i;
      bytes = (int)min64(16, n - i);
    }
    copy16(sg + 16 * tid, src, bytes);
  }
}

// FWHT over row bits 0 .. kLogP - 1 of the rows this thread's warp owns in
// its column, with the signs applied on the way into registers: lane bits
// by shuffles, e bits in registers. Reads the input tile xin (column-major,
// columns ldi apart, or row-major where tile_rows), writes the column-major
// accumulator tile xt (columns ld apart); in place where they are one.
template <typename TIn, int MT>
__device__ __forceinline__ void transform_block(const TIn* xin, Acc<TIn>* xt, const int8_t* sg,
                                                int ldi, int ld, bool tile_rows) {
  using T = Acc<TIn>;
  using G = Tile<MT>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = warp / G::kWc;
  int step = 1;
  const TIn* col_in = xin + c * ldi;
  if constexpr (!kInPlace<TIn>()) {
    if (tile_rows) {
      step = MT;
      col_in = xin + c;
    }
  }
  T* col = xt + c * ld;
  const int base = (warp % G::kWc) * G::kP + lane;
  T v[G::kE];
#pragma unroll
  for (int e = 0; e < G::kE; ++e) {
    const int i = base + 32 * e;
    const T w = widen(col_in[i * step]);
    v[e] = sg[i] < 0 ? -w : w;
  }
#pragma unroll
  for (int h = 1; h < G::kE; h <<= 1) {
#pragma unroll
    for (int e = 0; e < G::kE; ++e) {
      if (!(e & h)) {
        const T a = v[e], b = v[e + h];
        v[e] = a + b;
        v[e + h] = a - b;
      }
    }
  }
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const T sign = (lane & h) ? T(-1) : T(1);
#pragma unroll
    for (int e = 0; e < G::kE; ++e) {
      const T other = __shfl_xor_sync(0xFFFFFFFFu, v[e], h);
      v[e] = fma_t(sign, v[e], other);  // other + v below the bit, other - v above
    }
  }
#pragma unroll
  for (int e = 0; e < G::kE; ++e) col[base + 32 * e] = v[e];
}

// sum_{z < count} p[z] in a fixed order: four running sums over z mod 4,
// added pairwise; 16 loads in flight at a time. Reads through L2, where the
// other CTAs' partial sums are.
template <typename T>
__device__ __forceinline__ T sum_in_order(const T* p, int64_t count) {
  constexpr int kBatch = 16;
  T part[4] = {T(0), T(0), T(0), T(0)};
  for (int64_t z0 = 0; z0 < count; z0 += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int w = 0; w < kBatch; ++w) v[w] = z0 + w < count ? __ldcg(p + z0 + w) : T(0);
#pragma unroll
    for (int w = 0; w < kBatch; ++w) part[w % 4] += v[w];
  }
  return (part[0] + part[1]) + (part[2] + part[3]);
}

struct KernelArgs {
  const void* x;
  const int8_t* signs;
  const uint32_t* sigma;
  unsigned int* done;  // per tile: a counter a group, then one; 0 between launches
  void* partial;       // (k m, n_split) accumulator values
  void* gpart;         // (k m, groups) accumulator values
  void* out;           // (k, m) of the accumulator's type, or the input's where narrow_out
  int64_t n, m, k, stride_i, stride_j, n_blocks, blocks_per_cta, group;
  int64_t block_offset;  // global index of x's first R-block (H_B's column)
  int ld, mode, narrow_out;
  double scale;
};

// CTAs an SM each (TIn, MT) instance is compiled for (the register cap of
// __launch_bounds__), from the register counts and times measured on an
// NVIDIA H100 80GB HBM3 at 700 W (probes/srht_probe.py): 3 for MT = 2 of the 2- and 4-byte types (80
// registers), 1 for MT = 4 in float64, 2 otherwise. Left to its own
// heuristic, ptxas gave float32 MT = 2 99 registers and float64 MT = 2 142
// under other minimums, an SM then holding one CTA fewer (8% and 45% slower
// at 56 columns of 2^24).
template <typename TIn, int MT>
constexpr int kMinCtas = (MT == 4 && sizeof(TIn) == 8) ? 1 : (MT == 2 && sizeof(TIn) <= 4) ? 3 : 2;

// Grid (column tiles, sampled-row tiles, block ranges), kThreads threads,
// dynamic shared memory of smem_bytes<TIn>(MT, ld).
// CTA (t, r, z) takes blocks [z bpc, min(B, (z + 1) bpc)) of columns
// [t MT, t MT + MT) for the sampled rows [r kRowsPerCta, ...) and writes
// partial[(s m + j) n_split + z]; the last CTA of a (t, r) tile to finish
// sums the tile's partials in z order into out, times the scale.
template <typename TIn, int MT>
__global__ void __launch_bounds__(kThreads, kMinCtas<TIn, MT>)
    srht_block_kernel(const KernelArgs a) {
  using T = Acc<TIn>;
  using G = Tile<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const TIn* __restrict__ x = static_cast<const TIn*>(a.x);
  T* __restrict__ partial = static_cast<T*>(a.partial);
  const int ld = a.ld, ldi = ld_in<TIn>(ld);
  // stage st: the input tile (MT ldi values) at st * stage, then R signs;
  // after the two stages, the accumulator's tile where it is not in place
  const int64_t x_bytes = (int64_t)MT * ldi * sizeof(TIn), stage = x_bytes + kR;
  auto xs = [&](int st) { return reinterpret_cast<TIn*>(smem + st * stage); };
  auto sg = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * stage + x_bytes); };
  auto xt = [&](int st) {
    if constexpr (kInPlace<TIn>()) return reinterpret_cast<T*>(smem + st * stage);
    else return reinterpret_cast<T*>(smem + 2 * stage);
  };

  const int tid = threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.x * MT;
  auto load = [&](int64_t b, int st) {
    load_block<TIn, MT>(xs(st), sg(st), x, a.signs, b, j0, a.n, a.m, a.stride_i, a.stride_j,
                        ldi, a.mode);
  };
  const int64_t s0 = (int64_t)blockIdx.y * kRowsPerCta;
  const int64_t z = blockIdx.z, n_split = gridDim.z, m = a.m;
  const int64_t b_begin = z * a.blocks_per_cta;
  const int64_t b_end = min64(a.n_blocks, b_begin + a.blocks_per_cta);
  const int rows = (int)min64(kRowsPerCta, a.k - s0);

  // sampled row s0 + tid + kThreads q: sigma_lo within a warp's rows (lo),
  // the warp part of sigma_lo (top) and sigma_hi
  uint32_t lo[kRowsPerThread], top[kRowsPerThread], hi[kRowsPerThread];
  T acc[kRowsPerThread][MT];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = tid + kThreads * q;
    const uint32_t sig = r < rows ? a.sigma[s0 + r] : 0u;
    lo[q] = sig & (G::kP - 1);
    top[q] = (sig >> G::kLogP) & (G::kWc - 1);
    hi[q] = sig >> kLogR;
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[q][j] = T(0);
  }

  // ping-pong: block b + 1 is in flight while block b is transformed
  load(b_begin, 0);
  copy_commit();
  for (int64_t b = b_begin; b < b_end; ++b) {
    const int st = (int)((b - b_begin) & 1);
    copy_wait_all();
    __syncthreads();  // block b has landed; every thread is done with block b - 1
    if (b + 1 < b_end) {
      load(b + 1, st ^ 1);
      copy_commit();
    }
    transform_block<TIn, MT>(xs(st), xt(st), sg(st), ldi, ld, a.mode == kTileRows);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      if (tid + kThreads * q < rows) {
        const bool neg = __popc(hi[q] & (uint32_t)(b + a.block_offset)) & 1;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          // the parts of rows lo + u kP (u < kWc), one a warp of the column
          const T* c = xt(st) + j * ld + lo[q];
          T v = c[0];
#pragma unroll
          for (int u = 1; u < G::kWc; ++u) {
            v = fma_t((__popc(top[q] & u) & 1) ? T(-1) : T(1), c[u * G::kP], v);
          }
          acc[q][j] += neg ? -v : v;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int r = tid + kThreads * q;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j0 + j < m) partial[((s0 + r) * m + j0 + j) * n_split + z] = acc[q][j];
      }
    }
  }

  // Two-level reduction in fixed order, so the result is deterministic:
  // the last CTA of each group of `group` consecutive z (a counter picks
  // it) sums the group's partials in z order, and the last group of the
  // tile sums the group sums in order, times the scale. Each counter is
  // reset by the CTA it picked.
  const int64_t group = a.group, n_groups = (n_split + group - 1) / group;
  const int64_t gz = z / group, members = min64(group, n_split - gz * group);
  unsigned int* done = a.done + (blockIdx.y * gridDim.x + blockIdx.x) * (n_groups + 1);
  __threadfence();
  __syncthreads();  // every thread's sums are out before the CTA counts itself done
  if (!__syncthreads_or(tid == 0 && atomicAdd(done + gz, 1u) == (unsigned int)(members - 1))) {
    return;
  }
  __threadfence();
  T* gpart = static_cast<T*>(a.gpart);
  for (int e = tid; e < rows * MT; e += kThreads) {
    const int64_t o = (s0 + e / MT) * m + j0 + e % MT;
    if (j0 + e % MT < m) {
      gpart[o * n_groups + gz] = sum_in_order(partial + o * n_split + gz * group, members);
    }
  }
  if (tid == 0) done[gz] = 0u;
  __threadfence();
  __syncthreads();
  if (!__syncthreads_or(tid == 0 &&
                        atomicAdd(done + n_groups, 1u) == (unsigned int)(n_groups - 1))) {
    return;
  }
  __threadfence();
  const T scale = (T)a.scale;
  for (int e = tid; e < rows * MT; e += kThreads) {
    const int64_t o = (s0 + e / MT) * m + j0 + e % MT;
    if (j0 + e % MT < m) {
      const T v = sum_in_order(gpart + o * n_groups, n_groups) * scale;
      if (a.narrow_out) {
        static_cast<TIn*>(a.out)[o] = narrow<TIn>(v);
      } else {
        static_cast<T*>(a.out)[o] = v;
      }
    }
  }
  if (tid == 0) done[n_groups] = 0u;  // ready for the next launch
}

// The block kernel of (TIn, log2_r, mt), or null where there is no
// instance: MT = 1, 2, 4 (the widest the wrapper takes).
template <typename TIn>
const void* block_kernel(int log2_r, int mt) {
  if (log2_r != kLogR) return nullptr;
  switch (mt) {
    case 1: return (const void*)srht_block_kernel<TIn, 1>;
    case 2: return (const void*)srht_block_kernel<TIn, 2>;
    case 4: return (const void*)srht_block_kernel<TIn, 4>;
    default: return nullptr;
  }
}

int64_t groups(const SrhtLaunch& p) { return (p.n_split + p.group - 1) / p.group; }

// Counters of a launch: per tile, one a group and then one.
int64_t counters(const SrhtLaunch& p) {
  const int64_t tiles = ((p.m + p.mt - 1) / p.mt) * ((p.k + kRowsPerCta - 1) / kRowsPerCta);
  return tiles * (groups(p) + 1);
}

// Runs the calls of one launch on p.device, as current device.
struct OnDevice {
  int prev = -1;
  explicit OnDevice(int device) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != device) cudaSetDevice(device);
  }
  ~OnDevice() {
    int now = -1;
    if (cudaGetDevice(&now) == cudaSuccess && now != prev && prev >= 0) cudaSetDevice(prev);
  }
};

template <typename TIn>
int launch(const SrhtLaunch& p, const void* xv, const int8_t* signs, const uint32_t* sigma,
           unsigned int* done, void* sums, void* out, int narrow_out, int64_t block_offset,
           cudaStream_t stream) {
  using T = Acc<TIn>;
  const int64_t size = sizeof(TIn);
  const TIn* x = static_cast<const TIn*>(xv);
  const int64_t n_blocks = (p.n + kR - 1) / kR;
  const int64_t col_tiles = (p.m + p.mt - 1) / p.mt;
  const int64_t row_tiles = (p.k + kRowsPerCta - 1) / kRowsPerCta;
  const void* kernel = block_kernel<TIn>(p.log2_r, p.mt);
  if (kernel == nullptr || p.n < 1 || p.n > (int64_t)1 << 31 || p.m < 1 || p.k < 1 ||
      p.stride_i < 0 || p.stride_j < 0 || p.ld < kR || (p.ld * sizeof(T)) % 16 ||
      (int64_t)p.smem < smem_bytes<TIn>(p.mt, p.ld) || p.blocks_per_cta < 1 ||
      p.n_split < 1 || p.n_split > 65535 || p.group < 1 || block_offset < 0 ||
      block_offset + n_blocks > ((int64_t)1 << (31 - kLogR)) ||
      p.n_split * p.blocks_per_cta < n_blocks ||
      (p.n_split - 1) * p.blocks_per_cta >= n_blocks || col_tiles > 0x7FFFFFFF ||
      row_tiles > 65535 || (uintptr_t)signs % 16 || done == nullptr || sums == nullptr ||
      (narrow_out && kInPlace<TIn>())) {
    return (int)cudaErrorInvalidValue;
  }
  KernelArgs a;
  a.x = x;
  a.signs = signs;
  a.sigma = sigma;
  a.done = done;
  a.partial = sums;
  a.gpart = static_cast<T*>(sums) + p.k * p.m * p.n_split;
  a.out = out;
  a.n = p.n;
  a.m = p.m;
  a.k = p.k;
  a.stride_i = p.stride_i;
  a.stride_j = p.stride_j;
  a.n_blocks = n_blocks;
  a.blocks_per_cta = p.blocks_per_cta;
  a.group = p.group;
  a.block_offset = block_offset;
  a.ld = p.ld;
  a.narrow_out = narrow_out ? 1 : 0;
  a.scale = p.scale;
  // 16-byte copies along i (the rows layout); for 2-byte types in the
  // columns layout, one copy a tile row; else one element at a time
  const uintptr_t addr = (uintptr_t)x;
  if (p.stride_i == 1 && addr % 16 == 0 && (p.m == 1 || (p.stride_j * size) % 16 == 0)) {
    a.mode = kVec16;
  } else if (size >= 4) {
    a.mode = kElemAsync;
  } else if (p.stride_j == 1 && p.mt >= 2 && p.stride_i % p.mt == 0 &&
             addr % (p.mt * size) == 0) {
    a.mode = kTileRows;
  } else {
    a.mode = kElemSync;
  }
  void* args[] = {(void*)&a};
  OnDevice on(p.device);
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)col_tiles, (unsigned)row_tiles,
                                            (unsigned)p.n_split),
                               dim3(kThreads), args, (size_t)p.smem, stream);
}

// Lets the kernel of (TIn, log2_r, mt) take all the shared memory a CTA may
// opt in to on `device` (so any smem the wrapper picks launches) and returns
// how many of its CTAs an SM holds at smem bytes.
template <typename TIn>
int setup(int device, int log2_r, int mt, int smem, int* ctas_per_sm) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = block_kernel<TIn>(log2_r, mt);
  if (kernel == nullptr || smem < 0 || smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, kThreads,
                                                            (size_t)smem);
}

}  // namespace

extern "C" {

// out (k, m) = scale * S x for x (n, m) at (stride_i, stride_j) of the type
// `dtype` (0 float32, 1 float64, 2 bfloat16, 3 float16): one launch of the
// block kernel on a grid of ceil(m / mt) x ceil(k / rows per CTA) x n_split
// CTAs, each over blocks_per_cta blocks of R = 2^log2_r rows. The sums run
// in float64 for float64 and in float32 otherwise; out is of that type, or
// of x's where narrow_out (2-byte types only). signs int8 (n,) 16-byte
// aligned, sigma (k,) in [0, 2^31). The scratch is the caller's, used by
// one stream at a time (srht_onepass_scratch gives its sizes): `done`
// counters that are zero (each launch leaves them zero again; so they hold
// nothing else), and `sums` (of the sums' type) for the partial and group
// sums. block_offset: the global index of x's first R-block, so that row i
// of x is row block_offset R + i of the transform (H_B's column b of x's
// block b is block_offset + b; a rank's rows of a sharded SRHT); 0 for a
// whole vector. Returns the cudaError_t of the launch.
int srht_onepass(const SrhtLaunch* p, int dtype, const void* x, const int8_t* signs,
                 const uint32_t* sigma, unsigned int* done, void* sums, void* out,
                 int narrow_out, int64_t block_offset, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t o = block_offset;
  switch (dtype) {
    case kF32: return launch<float>(*p, x, signs, sigma, done, sums, out, narrow_out, o, s);
    case kF64: return launch<double>(*p, x, signs, sigma, done, sums, out, narrow_out, o, s);
    case kBF16:
      return launch<__nv_bfloat16>(*p, x, signs, sigma, done, sums, out, narrow_out, o, s);
    case kF16: return launch<__half>(*p, x, signs, sigma, done, sums, out, narrow_out, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The counters and the values of `sums` a launch of p needs.
void srht_onepass_scratch(const SrhtLaunch* p, int64_t* n_counters, int64_t* n_sums) {
  *n_counters = counters(*p);
  *n_sums = p->k * p->m * (p->n_split + groups(*p));
}

// The shared-memory attribute of the (dtype, log2_r, mt) kernel on `device`
// (all a CTA may opt in to), and how many of its CTAs an SM holds at once
// at smem bytes, into *ctas_per_sm. Once per device, type and tile, before
// the first launch there.
int srht_onepass_setup(int device, int dtype, int log2_r, int mt, int smem, int* ctas_per_sm) {
  OnDevice on(device);
  switch (dtype) {
    case kF32: return setup<float>(device, log2_r, mt, smem, ctas_per_sm);
    case kF64: return setup<double>(device, log2_r, mt, smem, ctas_per_sm);
    case kBF16: return setup<__nv_bfloat16>(device, log2_r, mt, smem, ctas_per_sm);
    case kF16: return setup<__half>(device, log2_r, mt, smem, ctas_per_sm);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Sampled rows one CTA accumulates (its row tile).
int srht_onepass_rows_per_cta(void) { return kRowsPerCta; }

}  // extern "C"
