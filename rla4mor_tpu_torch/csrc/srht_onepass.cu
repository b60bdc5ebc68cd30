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
// What bounds it: the kernel does n * k * m FMAs on the CUDA cores, each
// with its +-1 sign built in registers from __popc (no plan matrix in
// memory). At the bench shape (n = 2^24, k = 256, m = 56) that is 2.4e11
// FMAs, far above the one-read floor of the 3.76 GB input, so the kernel is
// compute-bound. Moving the R-contraction onto tensor cores (H_B x H_R split,
// 3xTF32) is the known next step.
//
// Design: block (column tile, sampled-row tile, split) stages a chunk of
// d[i] * x[i, j] in shared memory once and every thread (one sampled row
// each) reuses it for all MT columns of the tile. Split-K over i is
// deterministic: each split writes its partial sums to a scratch buffer that
// the caller allocates, and a second kernel sums the splits in a fixed
// order. No atomics. Input is read in place through (stride_i, stride_j),
// so (n, m) columns and (m, n) / (m, B, R) rows layouts need no copy.
// Offsets are int64. f32 accumulates in f32 (IEEE FMA), f64 in f64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // sampled rows per block, one per thread
constexpr int kChunk = 256;    // input rows staged in shared memory per step

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
srht_partial_kernel(const T* __restrict__ x, const int8_t* __restrict__ signs,
                    const uint32_t* __restrict__ sigma, T* __restrict__ partial,
                    int64_t n, int64_t m, int64_t k, int64_t stride_i,
                    int64_t stride_j, int64_t rows_per_split) {
  __shared__ __align__(16) T xs[kChunk * MT];

  const int tid = threadIdx.x;
  const int64_t j0 = (int64_t)blockIdx.x * MT;
  const int64_t s = (int64_t)blockIdx.y * kThreads + tid;
  const int64_t split = blockIdx.z;
  const int64_t i_begin = split * rows_per_split;
  const int64_t i_end = min64(n, i_begin + rows_per_split);
  const uint32_t sig = s < k ? sigma[s] : 0u;
  // neighbouring threads load neighbouring addresses: along i for the rows
  // layout, along j for the columns layout
  const bool i_fastest = stride_i == 1;

  T acc[MT];
#pragma unroll
  for (int c = 0; c < MT; ++c) acc[c] = T(0);

  for (int64_t i0 = i_begin; i0 < i_end; i0 += kChunk) {
    for (int e = tid; e < kChunk * MT; e += kThreads) {
      const int ii = i_fastest ? e % kChunk : e / MT;
      const int jj = i_fastest ? e / kChunk : e % MT;
      const int64_t i = i0 + ii;
      const int64_t j = j0 + jj;
      T v = T(0);
      if (i < i_end && j < m) {
        v = x[i * stride_i + j * stride_j];
        if (signs[i] < 0) v = -v;
      }
      xs[ii * MT + jj] = v;
    }
    __syncthreads();

    const int len = (int)min64(kChunk, i_end - i0);
    for (int ii = 0; ii < len; ++ii) {
      const uint32_t i = (uint32_t)(i0 + ii);
      const T h = (__popc(sig & i) & 1) ? T(-1) : T(1);
#pragma unroll
      for (int c = 0; c < MT; ++c) acc[c] = fma_t(h, xs[ii * MT + c], acc[c]);
    }
    __syncthreads();
  }

  if (s < k) {
    T* out = partial + (split * k + s) * m;
#pragma unroll
    for (int c = 0; c < MT; ++c) {
      if (j0 + c < m) out[j0 + c] = acc[c];
    }
  }
}

// out[e] = scale * sum_z partial[z, e], z in order: deterministic split-K.
template <typename T>
__global__ void srht_reduce_kernel(const T* __restrict__ partial, T* __restrict__ out,
                                   int64_t km, int64_t n_split, T scale) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= km) return;
  T sum = T(0);
  for (int64_t z = 0; z < n_split; ++z) sum += partial[z * km + e];
  out[e] = sum * scale;
}

template <typename T>
int launch(const T* x, const int8_t* signs, const uint32_t* sigma, T* partial, T* out,
           int64_t n, int64_t m, int64_t k, int64_t stride_i, int64_t stride_j,
           int64_t n_split, int64_t rows_per_split, int mt, double scale,
           cudaStream_t stream) {
  if (n < 1 || m < 1 || k < 1 || n_split < 1 || n_split > 65535 ||
      (k + kThreads - 1) / kThreads > 65535 || rows_per_split < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(kThreads);
  const dim3 grid((unsigned)((m + mt - 1) / mt), (unsigned)((k + kThreads - 1) / kThreads),
                  (unsigned)n_split);
  switch (mt) {
    case 1:
      srht_partial_kernel<T, 1><<<grid, block, 0, stream>>>(
          x, signs, sigma, partial, n, m, k, stride_i, stride_j, rows_per_split);
      break;
    case 2:
      srht_partial_kernel<T, 2><<<grid, block, 0, stream>>>(
          x, signs, sigma, partial, n, m, k, stride_i, stride_j, rows_per_split);
      break;
    case 4:
      srht_partial_kernel<T, 4><<<grid, block, 0, stream>>>(
          x, signs, sigma, partial, n, m, k, stride_i, stride_j, rows_per_split);
      break;
    case 8:
      srht_partial_kernel<T, 8><<<grid, block, 0, stream>>>(
          x, signs, sigma, partial, n, m, k, stride_i, stride_j, rows_per_split);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t km = k * m;
  const int reduce_threads = 256;
  srht_reduce_kernel<T><<<(unsigned)((km + reduce_threads - 1) / reduce_threads),
                          reduce_threads, 0, stream>>>(partial, out, km, n_split,
                                                       (T)scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the two launches (0 on success).
int srht_onepass_f32(const float* x, const int8_t* signs, const uint32_t* sigma,
                     float* partial, float* out, int64_t n, int64_t m, int64_t k,
                     int64_t stride_i, int64_t stride_j, int64_t n_split,
                     int64_t rows_per_split, int mt, double scale, void* stream) {
  return launch<float>(x, signs, sigma, partial, out, n, m, k, stride_i, stride_j,
                       n_split, rows_per_split, mt, scale, (cudaStream_t)stream);
}

int srht_onepass_f64(const double* x, const int8_t* signs, const uint32_t* sigma,
                     double* partial, double* out, int64_t n, int64_t m, int64_t k,
                     int64_t stride_i, int64_t stride_j, int64_t n_split,
                     int64_t rows_per_split, int mt, double scale, void* stream) {
  return launch<double>(x, signs, sigma, partial, out, n, m, k, stride_i, stride_j,
                        n_split, rows_per_split, mt, scale, (cudaStream_t)stream);
}

// Rows per chunk, so that the caller can align its split boundaries.
int srht_onepass_chunk_rows(void) { return kChunk; }

}  // extern "C"
