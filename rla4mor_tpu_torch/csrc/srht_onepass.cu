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
// this function through the (P, Q, R) / (B, R) Hadamard factorisation.
//
// The factorisation. With i = b R + r and sigma = sigma_hi R + sigma_lo
// (R = 2^log2_r, b < ceil(n / R)),
//
//   H[sigma, i] = H_B[sigma_hi, b] * H_R[sigma_lo, r],
//
// so the sketch is an unnormalised Walsh-Hadamard transform (FWHT) of
// length R of each block of d * x, a gather of the k rows sigma_lo, and a
// +-1 sum over the blocks with H_B[sigma_hi, b] = (-1)^popcount(sigma_hi & b).
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
//
// Design.
// - Persistent grid (column tile, sampled-row tile, block range): one CTA
//   per resident slot (the wrapper sizes it with the occupancy API), each
//   taking a contiguous range of blocks of one MT-column tile.
// - Two cp.async stages: block b+1's (R, MT) tile of x and its R int8
//   signs are copied into shared memory while block b is transformed.
//   Rows >= n and columns >= m are zero-filled by the copy (src-size 0),
//   never read. The tile is column-major, columns ld = R + 16 bytes apart.
//   Two ways in, by layout:
//   * rows layout (stride_i == 1, aligned): 16-byte copies along i;
//   * anything else (the columns layout among them): one 4- or 8-byte
//     copy per element, along the smaller stride of x (ld keeps those
//     copies on distinct banks).
// - FWHT of each column with IEEE adds only (a +-1 FMA is an exact add):
//   a thread holds the values of kE rows (l + 32 e, l its lane) of one
//   column, so row bits 0-4 go through __shfl_xor_sync and the next
//   log2 kE bits through registers (R MT / 256 values a thread, MT <= 4).
//   The warps that share a column leave their top row bits to the gather.
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
// (m, n) / (m, B, R) rows layouts need no copy. Offsets are int64. f32
// accumulates in f32, f64 in f64.

#include <cuda_runtime.h>
#include <stdint.h>

// What a launch needs besides the pointers: built once per device and
// shape by the wrapper (ops/srht_cuda.py, ``_Launch``, same field order).
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

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

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

template <int BYTES>
__device__ __forceinline__ void copy_elem(void* dst, const void* src, int src_bytes) {
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

// Issue the copies of block b (rows [b R, b R + R)) of the tile's columns
// [j0, j0 + MT) into xs and its signs into sg (the caller commits):
// 16-byte copies along i where vec (stride_i == 1, aligned), else one per
// element.
template <typename T, int MT>
__device__ __forceinline__ void load_block(T* xs, int8_t* sg, const T* __restrict__ x,
                                           const int8_t* __restrict__ signs, int64_t b,
                                           int64_t j0, int64_t n, int64_t m, int64_t stride_i,
                                           int64_t stride_j, int ld, bool vec) {
  constexpr int kV16 = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int64_t i0 = b * kR;
  if (vec) {
    constexpr int kPerCol = kR / kV16;
#pragma unroll 4
    for (int c = tid; c < MT * kPerCol; c += kThreads) {
      const int jj = c / kPerCol;
      const int ii = (c % kPerCol) * kV16;
      const int64_t i = i0 + ii, j = j0 + jj;
      const T* src = x;
      int bytes = 0;
      if (j < m && i < n) {
        src = x + i + j * stride_j;
        bytes = (int)(min64(kV16, n - i) * sizeof(T));
      }
      copy16(xs + jj * ld + ii, src, bytes);
    }
  } else {  // along the smaller stride of x first
    const bool i_fast = stride_i <= stride_j;
#pragma unroll 4
    for (int e = tid; e < MT * kR; e += kThreads) {
      const int ii = i_fast ? e % kR : e / MT;
      const int jj = i_fast ? e / kR : e % MT;
      const int64_t i = i0 + ii, j = j0 + jj;
      const T* src = x;
      int bytes = 0;
      if (j < m && i < n) {
        src = x + i * stride_i + j * stride_j;
        bytes = (int)sizeof(T);
      }
      copy_elem<sizeof(T)>(xs + jj * ld + ii, src, bytes);
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

// In-place FWHT over row bits 0 .. kLogP - 1 of the rows this thread's
// warp owns in its column, with the signs applied on the way into
// registers: lane bits by shuffles, e bits in registers.
template <typename T, int MT>
__device__ __forceinline__ void transform_block(T* xs, const int8_t* sg, int ld) {
  using G = Tile<MT>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  T* col = xs + (warp / G::kWc) * ld;
  const int base = (warp % G::kWc) * G::kP + lane;
  T v[G::kE];
#pragma unroll
  for (int e = 0; e < G::kE; ++e) {
    const int i = base + 32 * e;
    v[e] = sg[i] < 0 ? -col[i] : col[i];
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
  void* partial;       // (k m, n_split) values
  void* gpart;         // (k m, groups) values
  void* out;
  int64_t n, m, k, stride_i, stride_j, n_blocks, blocks_per_cta, group;
  int ld, vec;
  double scale;
};

// Grid (column tiles, sampled-row tiles, block ranges), kThreads threads,
// dynamic shared memory of two stages of (MT ld values, R signs).
// CTA (t, r, z) takes blocks [z bpc, min(B, (z + 1) bpc)) of columns
// [t MT, t MT + MT) for the sampled rows [r kRowsPerCta, ...) and writes
// partial[(s m + j) n_split + z]; the last CTA of a (t, r) tile to finish
// sums the tile's partials in z order into out, times the scale.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) srht_block_kernel(const KernelArgs a) {
  using G = Tile<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  const T* __restrict__ x = static_cast<const T*>(a.x);
  T* __restrict__ partial = static_cast<T*>(a.partial);
  const int ld = a.ld;
  // stage st: the tile (MT ld values) at st * stage, then R signs
  const int64_t x_bytes = (int64_t)MT * ld * sizeof(T), stage = x_bytes + kR;
  auto xs = [&](int st) { return reinterpret_cast<T*>(smem + st * stage); };
  auto sg = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * stage + x_bytes); };

  const int tid = threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.x * MT;
  auto load = [&](int64_t b, int st) {
    load_block<T, MT>(xs(st), sg(st), x, a.signs, b, j0, a.n, a.m, a.stride_i,
                           a.stride_j, ld, a.vec);
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
    transform_block<T, MT>(xs(st), sg(st), ld);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      if (tid + kThreads * q < rows) {
        const bool neg = __popc(hi[q] & (uint32_t)b) & 1;
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          // the parts of rows lo + u kP (u < kWc), one a warp of the column
          const T* c = xs(st) + j * ld + lo[q];
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
  T* out = static_cast<T*>(a.out);
  const T scale = (T)a.scale;
  for (int e = tid; e < rows * MT; e += kThreads) {
    const int64_t o = (s0 + e / MT) * m + j0 + e % MT;
    if (j0 + e % MT < m) out[o] = sum_in_order(gpart + o * n_groups, n_groups) * scale;
  }
  if (tid == 0) done[n_groups] = 0u;  // ready for the next launch
}

// The block kernel of (log2_r, mt), or null where there is no instance:
// MT = 1, 2, 4 (the widest the wrapper takes).
template <typename T>
const void* block_kernel(int log2_r, int mt) {
  if (log2_r != kLogR) return nullptr;
  switch (mt) {
    case 1: return (const void*)srht_block_kernel<T, 1>;
    case 2: return (const void*)srht_block_kernel<T, 2>;
    case 4: return (const void*)srht_block_kernel<T, 4>;
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

template <typename T>
int launch(const SrhtLaunch& p, const T* x, const int8_t* signs, const uint32_t* sigma,
           unsigned int* done, T* sums, T* out, cudaStream_t stream) {
  const int64_t size = sizeof(T);
  const int64_t n_blocks = (p.n + kR - 1) / kR;
  const int64_t col_tiles = (p.m + p.mt - 1) / p.mt;
  const int64_t row_tiles = (p.k + kRowsPerCta - 1) / kRowsPerCta;
  const void* kernel = block_kernel<T>(p.log2_r, p.mt);
  if (kernel == nullptr || p.n < 1 || p.n > (int64_t)1 << 31 || p.m < 1 || p.k < 1 ||
      p.stride_i < 0 || p.stride_j < 0 || p.ld < kR || (p.ld * size) % 16 ||
      (int64_t)p.smem < 2 * (p.mt * p.ld * size + kR) || p.blocks_per_cta < 1 ||
      p.n_split < 1 || p.n_split > 65535 || p.group < 1 ||
      p.n_split * p.blocks_per_cta < n_blocks ||
      (p.n_split - 1) * p.blocks_per_cta >= n_blocks || col_tiles > 0x7FFFFFFF ||
      row_tiles > 65535 || (uintptr_t)signs % 16 || done == nullptr || sums == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const bool aligned = (uintptr_t)x % 16 == 0;
  KernelArgs a;
  a.x = x;
  a.signs = signs;
  a.sigma = sigma;
  a.done = done;
  a.partial = sums;
  a.gpart = sums + p.k * p.m * p.n_split;
  a.out = out;
  a.n = p.n;
  a.m = p.m;
  a.k = p.k;
  a.stride_i = p.stride_i;
  a.stride_j = p.stride_j;
  a.n_blocks = n_blocks;
  a.blocks_per_cta = p.blocks_per_cta;
  a.group = p.group;
  a.ld = p.ld;
  a.scale = p.scale;
  // 16-byte copies along i (the rows layout), else one copy per element
  a.vec = p.stride_i == 1 && aligned && (p.m == 1 || (p.stride_j * size) % 16 == 0);
  void* args[] = {(void*)&a};
  OnDevice on(p.device);
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)col_tiles, (unsigned)row_tiles,
                                            (unsigned)p.n_split),
                               dim3(kThreads), args, (size_t)p.smem, stream);
}

// Lets the kernel of (log2_r, mt) take all the shared memory a CTA may opt
// in to on `device` (so any smem the wrapper picks launches) and returns
// how many of its CTAs an SM holds at smem bytes.
template <typename T>
int setup(int device, int log2_r, int mt, int smem, int* ctas_per_sm) {
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const void* kernel = block_kernel<T>(log2_r, mt);
  if (kernel == nullptr || smem < 0 || smem > optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, kThreads,
                                                            (size_t)smem);
}

}  // namespace

extern "C" {

// out (k, m) = scale * S x for x (n, m) at (stride_i, stride_j): one launch
// of the block kernel on a grid of ceil(m / mt) x ceil(k / rows per CTA) x
// n_split CTAs, each over blocks_per_cta blocks of R = 2^log2_r rows.
// signs int8 (n,) 16-byte aligned, sigma (k,) in [0, 2^31). The scratch
// is the caller's, used by one stream at a time (srht_onepass_scratch
// gives its sizes): `done` counters that are zero (each launch leaves them
// zero again; so they hold nothing else), and `sums` for the partial and
// group sums. Returns the cudaError_t of the launch.
int srht_onepass_f32(const SrhtLaunch* p, const float* x, const int8_t* signs,
                     const uint32_t* sigma, unsigned int* done, float* sums, float* out,
                     void* stream) {
  return launch<float>(*p, x, signs, sigma, done, sums, out, (cudaStream_t)stream);
}

int srht_onepass_f64(const SrhtLaunch* p, const double* x, const int8_t* signs,
                     const uint32_t* sigma, unsigned int* done, double* sums, double* out,
                     void* stream) {
  return launch<double>(*p, x, signs, sigma, done, sums, out, (cudaStream_t)stream);
}

// The counters and the values of `sums` a launch of p needs.
void srht_onepass_scratch(const SrhtLaunch* p, int64_t* n_counters, int64_t* n_sums) {
  *n_counters = counters(*p);
  *n_sums = p->k * p->m * (p->n_split + groups(*p));
}

// The shared-memory attribute of the (float64 or float32, log2_r, mt)
// kernels on `device` (all a CTA may opt in to), and how many of their
// CTAs an SM holds at once at smem bytes, into *ctas_per_sm. Once per
// device and tile, before the first launch there.
int srht_onepass_setup(int device, int f64, int log2_r, int mt, int smem, int* ctas_per_sm) {
  OnDevice on(device);
  return f64 ? setup<double>(device, log2_r, mt, smem, ctas_per_sm)
             : setup<float>(device, log2_r, mt, smem, ctas_per_sm);
}

// Sampled rows one CTA accumulates (its row tile).
int srht_onepass_rows_per_cta(void) { return kRowsPerCta; }

}  // extern "C"
