// Issue rates of the integer multiplies that Philox4x32-10 is made of, and
// of a whole Philox call in two forms, on the card this is built for. Each
// thread runs 8 independent chains so that latency is hidden; thread 0 of
// each block records the SM clock around the loop.
//
//   kind 0: IMAD.WIDE.U32   a = hi(M a) ^ lo(M a)        (64-bit product)
//   kind 1: IMAD.HI.U32     a = umulhi(M, a) ^ K
//   kind 2: IMAD            a = M a + K
//   kind 3: Philox4x32-10, 64-bit products (the kernels' form), 2 calls a step
//   kind 4: Philox4x32-10, umulhi + 32-bit multiply, 2 calls a step
//   kind 5: mma.sync.m16n8k8 TF32 (HMMA.1688.F32.TF32), 8 independent
//           accumulators a warp, 8 products a step (the tiled Gaussian
//           sketch's instruction)
//
// Built and driven by probes/gaussian_sketch_probe.py (plain C interface).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;

template <bool WIDE>
__device__ __forceinline__ void philox(uint32_t& c0, uint32_t& c1, uint32_t& c2, uint32_t& c3,
                                       uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0, lo0, hi1, lo1;
    if (WIDE) {
      const uint64_t p0 = (uint64_t)kM0 * c0, p1 = (uint64_t)kM1 * c2;
      hi0 = (uint32_t)(p0 >> 32);
      lo0 = (uint32_t)p0;
      hi1 = (uint32_t)(p1 >> 32);
      lo1 = (uint32_t)p1;
    } else {
      hi0 = __umulhi(kM0, c0);
      lo0 = kM0 * c0;
      hi1 = __umulhi(kM1, c2);
      lo1 = kM1 * c2;
    }
    c0 = hi1 ^ c1 ^ (k0 + i * 0x9E3779B9u);
    c1 = lo1;
    c2 = hi0 ^ c3 ^ (k1 + i * 0xBB67AE85u);
    c3 = lo0;
  }
}

__global__ void hmma_kernel(uint32_t* out, long long* cycles, int iters, uint32_t seed) {
  float d[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.0f;
  const uint32_t a0 = seed + threadIdx.x, a1 = a0 * 3u, b0 = a0 ^ 0x3F800000u, b1 = a1 | 1u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a0), "r"(a1), "r"(a0), "r"(a1), "r"(b0), "r"(b1));
    }
  }
  const long long t1 = clock64();
  float x = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) x += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_uint(x);
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int KIND>
__global__ void rate_kernel(uint32_t* out, long long* cycles, int iters, uint32_t seed) {
  uint32_t a[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = seed + threadIdx.x * 8 + j;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (KIND <= 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (KIND == 0) {
          const uint64_t p = (uint64_t)kM0 * a[j];
          a[j] = (uint32_t)(p >> 32) ^ (uint32_t)p;
        } else if (KIND == 1) {
          a[j] = __umulhi(kM0, a[j]) ^ 0x1234567u;
        } else {
          a[j] = kM0 * a[j] + 0x1234567u;
        }
      }
    } else {
      uint32_t c[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        c[s][0] = a[4 * s] + it;
        c[s][1] = a[4 * s + 1];
        c[s][2] = a[4 * s + 2];
        c[s][3] = 0;
        philox<KIND == 3>(c[s][0], c[s][1], c[s][2], c[s][3], seed, a[4 * s + 3]);
        a[4 * s] ^= c[s][0];
        a[4 * s + 1] ^= c[s][1];
        a[4 * s + 2] ^= c[s][2];
        a[4 * s + 3] ^= c[s][3];
      }
    }
  }
  const long long t1 = clock64();
  uint32_t x = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) x ^= a[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" int int_rate(int kind, uint32_t* out, long long* cycles, int blocks, int threads,
                        int iters, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: rate_kernel<0><<<blocks, threads, 0, s>>>(out, cycles, iters, 7u); break;
    case 1: rate_kernel<1><<<blocks, threads, 0, s>>>(out, cycles, iters, 7u); break;
    case 2: rate_kernel<2><<<blocks, threads, 0, s>>>(out, cycles, iters, 7u); break;
    case 3: rate_kernel<3><<<blocks, threads, 0, s>>>(out, cycles, iters, 7u); break;
    case 4: rate_kernel<4><<<blocks, threads, 0, s>>>(out, cycles, iters, 7u); break;
    case 5: hmma_kernel<<<blocks, threads, 0, s>>>(out, cycles, iters, 7u); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
