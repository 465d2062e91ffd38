// Dropout for Hopper (sm_90a): a counter-based random mask generated and
// applied in one pass, y = keep ? x * scale : 0.
//
// Replaces: znicz_tpu/ops/pallas_kernels.py:_dropout_kernel (B3), reached
// through dropout_apply (the dropout units' Pallas path): mask generation
// and apply fused, no mask array in device memory, the backward
// regenerating the forward's mask from the same per-step seed.  The TPU
// kernel draws the TPU core's own random bits, which no other machine
// reproduces; only the distribution is owed.  Here the bits of element i
// are word 0 of Philox4x32-10 (Salmon et al., SC 2011) with counter
// (i mod 2^32, i div 2^32, 0, 0) and key (seed mod 2^32, seed div 2^32): a
// pure function of (seed, i), so the plain PyTorch version in
// ops/fused_kernels.py computes the same bits and the masks agree bit for
// bit.  An element is kept iff bits > threshold, threshold =
// ratio * (2^32 - 1) as the TPU kernel's (the wrapper passes -1 for ratio
// 0, so ratio 0 keeps every element); kept elements are x * scale in f32,
// stored in x's dtype.
//
// What bounds it on this card: bytes (one read and one write per
// element; the ten Philox rounds are ~60 integer ops, under the ridge).
// At AlexNet's (128, 4096) the call moves 2 MB in bf16, so a launch costs
// more than its bytes.  Design: a grid-stride loop, one element per thread
// per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// word 0 of Philox4x32-10 at counter (i_lo, i_hi, 0, 0), key (k0, k1)
__device__ __forceinline__ uint32_t philox_bits(unsigned long long i,
                                                uint32_t k0, uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(i);
  uint32_t c1 = static_cast<uint32_t>(i >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2);
    const uint32_t lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t k0, uint32_t k1, long long threshold,
                   float scale) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += stride) {
    const bool keep =
        static_cast<long long>(philox_bits(i, k0, k1)) > threshold;
    store(y + i, keep ? to_f(x[i]) * scale : 0.f);
  }
}

}  // namespace

// x and y: contiguous, n elements, dtype 0 = f32, 1 = bf16.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int znicz_dropout(const void* x, void* y, long long n,
                             unsigned long long seed, long long threshold,
                             float scale, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  const uint32_t k0 = static_cast<uint32_t>(seed);
  const uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dropout_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, k0, k1,
        threshold, scale);
  } else {
    dropout_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(y), n, k0, k1, threshold, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
