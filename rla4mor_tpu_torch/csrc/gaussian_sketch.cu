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
// What bounds it on an H100: the contraction is 2 * k * n * m flop, at
// 67 TFLOP/s in float32 on the CUDA cores, against one read of x at
// 3.35 TB/s: at k = 256 that is 128 flop per byte of x, above the card's
// ~20 flop/byte balance, so the bound is the flop. On top of it comes the
// generation, which the bound does not count: k * n entries, each a quarter
// of a Philox call (ten rounds of two 32-bit multiplies) and, for normals,
// half of a log1pf, sqrtf and sincosf (precise, no fast math). At small m
// the generation is most of the time.
//
// Design: a block owns a (128 x 128) tile of Omega (128 rows of the sketch,
// 128 columns of one strip), generates it once into shared memory and
// contracts it with the matching rows of x, read in place through two int64
// strides and masked at i >= n (no padded copy), in chunks of MC columns of
// x. Each Omega entry is drawn exactly once per launch, whatever m is. A
// block walks a contiguous run of tiles of its 128 sketch rows and keeps its
// (128 x MC) partial sums in registers when m <= MC; for wider m it adds each
// chunk into its own slice of the partial buffer (read-add-write by the
// thread that owns the element, no atomics). A second kernel sums the
// partial buffer over the runs in a fixed order and scales by 1/sqrt(k): the
// split-K pattern of srht_onepass.cu, deterministic. Accumulation is IEEE
// float32 FMA on the CUDA cores; tensor cores (TF32 or bf16 Omega), TMA and
// more than one tile in flight per block are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the wrapper (ops/gaussian_cuda.py, _TILE) counts tiles with these two
constexpr int kTileK = 128;  // sketch rows per tile: one pair of normal draws
constexpr int kTileW = 128;  // strip columns (rows of x) per tile
constexpr int kChunkK = 64;  // rows of one normal draw (Rademacher: 4 x)
constexpr float kTwoPi = 6.28318530717958647692f;

enum Mode { kRademacher = 0, kNormalPairs = 1, kNormalCos = 2 };

struct Quad {
  uint32_t w[4];
};

__device__ __forceinline__ Quad philox4x32_10(uint32_t c0, uint32_t c1, uint32_t c2,
                                              uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
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

// Box-Muller of four word pairs: cos halves into zc, sin halves into zs.
__device__ __forceinline__ void normal_quad(const Quad& b1, const Quad& b2, float* zc,
                                            float* zs) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float radius = sqrtf(-2.0f * log1pf(-bits_to_unit(b1.w[i])));
    float s, c;
    sincosf(kTwoPi * bits_to_unit(b2.w[i]), &s, &c);
    zc[i] = radius * c;
    zs[i] = radius * s;
  }
}

// One generation unit: strip columns [4 * j4, 4 * j4 + 4) of strip row
// `row` (the cos row of a pair in kNormalPairs mode). Writes va (row `row`)
// and, in kNormalPairs mode, vb (row `row + 64`, the sin half).
__device__ __forceinline__ void gen_unit(int mode, uint32_t seed, uint32_t b, uint32_t j4,
                                         uint32_t row, float* va, float* vb) {
  if (mode == kRademacher) {
    const Quad q = philox4x32_10(j4, row % (4 * kChunkK), row / (4 * kChunkK), 0u, seed, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) va[i] = (q.w[i] & 0x80000000u) ? -1.0f : 1.0f;
    return;
  }
  uint32_t r, draw;
  if (mode == kNormalPairs) {  // row = 128 p + r, r < 64
    r = row % (2 * kChunkK);
    draw = 2u * (row / (2 * kChunkK));
  } else {  // row = 64 q + r
    r = row % kChunkK;
    draw = 2u * (row / kChunkK);
  }
  const Quad b1 = philox4x32_10(j4, r, draw, 0u, seed, b);
  const Quad b2 = philox4x32_10(j4, r, draw + 1u, 0u, seed, b);
  normal_quad(b1, b2, va, vb);
}

// ---------------------------------------------------------------------------
// Strip kernel: the unscaled (k, W) strip b, row-major, one unit per thread.

__global__ void __launch_bounds__(kThreads)
gaussian_strip_kernel(float* __restrict__ out, int64_t k, int64_t W, uint32_t seed,
                      uint32_t b, int mode) {
  const int64_t quads = W / 4;
  const int64_t slots = mode == kNormalPairs ? k / 2 : k;
  const int64_t u = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (u >= slots * quads) return;
  const int64_t slot = u / quads;
  const int64_t j4 = u % quads;
  // kNormalPairs: slot (p, r) is row 128 p + r, with its sin row 64 below
  const int64_t row = mode == kNormalPairs ? (slot / kChunkK) * 2 * kChunkK + slot % kChunkK
                                           : slot;
  float va[4], vb[4];
  gen_unit(mode, seed, b, (uint32_t)j4, (uint32_t)row, va, vb);
  *reinterpret_cast<float4*>(out + row * W + 4 * j4) = make_float4(va[0], va[1], va[2], va[3]);
  if (mode == kNormalPairs) {
    *reinterpret_cast<float4*>(out + (row + kChunkK) * W + 4 * j4) =
        make_float4(vb[0], vb[1], vb[2], vb[3]);
  }
}

// ---------------------------------------------------------------------------
// Sketch kernel. Block (z, kt): sketch rows [128 kt, 128 kt + 128), tiles
// [z * tiles_per_split, (z + 1) * tiles_per_split) of the n_tiles tiles that
// meet [0, n); tile t is columns [128 (t % tps), +128) of strip t / tps,
// tps = ceil(W / 128). Thread (tx, ty) owns rows 128 kt + RT ty + [0, RT)
// and columns TX * jj + tx (jj < CT) of each MC-column chunk.

template <int MC, int TX>
__global__ void __launch_bounds__(kThreads)
gaussian_sketch_partial_kernel(const float* __restrict__ x, float* __restrict__ partial,
                               int64_t n, int64_t m, int64_t k, int64_t stride_i,
                               int64_t stride_j, int64_t W, uint32_t seed, int mode,
                               int64_t n_tiles, int64_t tiles_per_split) {
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

  // generation units of a tile: (row slot, column quad), slot fastest
  const int slots = mode == kNormalPairs ? kChunkK : kTileK;
  const int units = slots * (kTileW / 4);

  float acc[RT][CT];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int c = 0; c < CT; ++c) acc[a][c] = 0.0f;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t b = t / tps;
    const int64_t j0 = (t % tps) * kTileW;  // first strip column of the tile
    __syncthreads();                        // the previous tile's reads are done
    for (int u = tid; u < units; u += kThreads) {
      const int sl = u % slots;
      const int q = u / slots;  // column quad within the tile
      const int64_t j = j0 + 4 * q;
      float va[4] = {0.f, 0.f, 0.f, 0.f}, vb[4] = {0.f, 0.f, 0.f, 0.f};
      const int64_t row = row0 + sl;  // kNormalPairs: the cos row of the pair
      if (j < W && row < k) {
        gen_unit(mode, seed, (uint32_t)b, (uint32_t)(j / 4), (uint32_t)row, va, vb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        om[(4 * q + i) * kTileK + sl] = va[i];
        if (mode == kNormalPairs) om[(4 * q + i) * kTileK + sl + kChunkK] = vb[i];
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

// out[e] = scale * sum_z partial[z, e], z in order: deterministic split-K.
__global__ void gaussian_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int64_t km,
                                       int64_t n_split, float scale) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= km) return;
  float sum = 0.0f;
  for (int64_t z = 0; z < n_split; ++z) sum += partial[z * km + e];
  out[e] = sum * scale;
}

template <int MC, int TX>
int launch_partial(const float* x, float* partial, int64_t n, int64_t m, int64_t k,
                   int64_t stride_i, int64_t stride_j, int64_t W, uint32_t seed, int mode,
                   int64_t n_tiles, int64_t tiles_per_split, int64_t n_split,
                   cudaStream_t stream) {
  const int smem = (kTileW * kTileK + kTileW * MC) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gaussian_sketch_partial_kernel<MC, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_split, (unsigned)((k + kTileK - 1) / kTileK));
  gaussian_sketch_partial_kernel<MC, TX><<<grid, kThreads, smem, stream>>>(
      x, partial, n, m, k, stride_i, stride_j, W, seed, mode, n_tiles, tiles_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Strip b of the unscaled Omega into out (k, W) float32, row-major.
// Returns the cudaError_t of the launch (0 on success).
int gaussian_strip_f32(float* out, int64_t k, int64_t W, uint32_t seed, uint32_t b, int mode,
                       void* stream) {
  if (k < 1 || W < 4 || W % 4 || mode < 0 || mode > 2 ||
      (mode == kNormalPairs && k % (2 * kChunkK))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t units = (mode == kNormalPairs ? k / 2 : k) * (W / 4);
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  gaussian_strip_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      out, k, W, seed, b, mode);
  return (int)cudaGetLastError();
}

// out (k, m) = (1/sqrt(k)) Omega x for x (n, m) float32 at (stride_i,
// stride_j); partial is caller-allocated scratch of n_split * k * m floats,
// n_split = ceil(n_tiles / tiles_per_split). mc selects the column chunk
// (8 or 32). Returns the cudaError_t of the launches (0 on success).
int gaussian_sketch_f32(const float* x, float* partial, float* out, int64_t n, int64_t m,
                        int64_t k, int64_t stride_i, int64_t stride_j, int64_t W,
                        uint32_t seed, int mode, int64_t n_tiles, int64_t tiles_per_split,
                        int mc, double scale, void* stream) {
  if (n < 1 || m < 1 || k < 1 || W < 4 || W % 4 || mode < 0 || mode > 2 ||
      (mode == kNormalPairs && k % (2 * kChunkK)) || n_tiles < 1 || tiles_per_split < 1 ||
      (k + kTileK - 1) / kTileK > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_split = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  if (n_split > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (mc) {
    case 8:
      err = launch_partial<8, 8>(x, partial, n, m, k, stride_i, stride_j, W, seed, mode,
                                 n_tiles, tiles_per_split, n_split, s);
      break;
    case 32:
      err = launch_partial<32, 16>(x, partial, n, m, k, stride_i, stride_j, W, seed, mode,
                                   n_tiles, tiles_per_split, n_split, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const int64_t km = k * m;
  const int reduce_threads = 256;
  gaussian_reduce_kernel<<<(unsigned)((km + reduce_threads - 1) / reduce_threads),
                           reduce_threads, 0, s>>>(partial, out, km, n_split, (float)scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
