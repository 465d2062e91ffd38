// Dropout for Hopper (sm_90a): a counter-based random mask generated and
// applied in one pass, y = keep ? x * scale : 0.
//
// The seed is read from device memory (a 64-bit word the caller's step
// advances), not passed by value: a CUDA graph that captures the launch
// then draws a new mask on every replay, where a seed passed by value
// would be frozen into the graph and repeat one mask.
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
// What bounds it on this card: one read and one write per element against
// the ten Philox rounds (~100 integer operations, 40 of them 32-bit
// multiplies); at AlexNet's (128, 4096) the call moves 2 MB in bf16, so a
// launch costs more than either.  The design is about latency.
//
// The vector kernel (the route x and y on 16-byte boundaries take; the rule
// is dropout_route in ops/fused_kernels.py):
//   - A thread owns 8 consecutive elements, one 16-byte load and store in
//     bf16, two in f32, and evaluates their 8 Philox generators side by
//     side, so the multiplies of different counters overlap, each 32 x 32
//     -> 64-bit product one wide multiply (4 % faster on an H100 than the
//     high and low words apart).  The round keys are added once a round for
//     all 8, and the high counter word is common to them (an 8-aligned run
//     of indices never crosses a 2^32 boundary).
//   - The grid is sized to the work, at most one resident wave, each thread
//     walking runs a grid apart; the thread of the last, short run takes its
//     elements one by one.
// The general kernel takes a pointer off 16 bytes: a grid-stride loop, one
// element per thread per step.

#include "rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u, PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u, PHILOX_W1 = 0xBB67AE85u;

// one Philox4x32 round of the counter (c0, c1, c2, c3) with round key
// (k0, k1), each 32 x 32 -> 64-bit product one wide multiply
__device__ __forceinline__ void philox_round(uint32_t& c0, uint32_t& c1,
                                             uint32_t& c2, uint32_t& c3,
                                             uint32_t k0, uint32_t k1) {
  using u64 = unsigned long long;
  const u64 p0 = static_cast<u64>(PHILOX_M0) * c0;
  const u64 p1 = static_cast<u64>(PHILOX_M1) * c2;
  c0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ k0;
  c1 = static_cast<uint32_t>(p1);
  c2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ k1;
  c3 = static_cast<uint32_t>(p0);
}

// word 0 of Philox4x32-10 at counter (i_lo, i_hi, 0, 0), key (k0, k1)
__device__ __forceinline__ uint32_t philox_bits(unsigned long long i,
                                                uint32_t k0, uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(i);
  uint32_t c1 = static_cast<uint32_t>(i >> 32);
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    philox_round(c0, c1, c2, c3, k0, k1);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c0;
}

// philox_bits of the 8 indices i0 .. i0 + 7 (i0 % 8 == 0), side by side
__device__ __forceinline__ void philox_bits8(unsigned long long i0,
                                             uint32_t k0, uint32_t k1,
                                             uint32_t (&out)[8]) {
  const uint32_t lo = static_cast<uint32_t>(i0);
  const uint32_t hi = static_cast<uint32_t>(i0 >> 32);
  uint32_t c0[8], c1[8], c2[8], c3[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c0[j] = lo + j;
    c1[j] = hi;
    c2[j] = c3[j] = 0u;
  }
#pragma unroll
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      philox_round(c0[j], c1[j], c2[j], c3[j], k0, k1);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = c0[j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       long long n,
                       const unsigned long long* __restrict__ seed,
                       long long threshold, float scale) {
  const unsigned long long key = *seed;
  const uint32_t k0 = static_cast<uint32_t>(key);
  const uint32_t k1 = static_cast<uint32_t>(key >> 32);
  const long long runs = (n + 7) / 8;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long run = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
       run < runs; run += stride) {
    const long long i0 = run * 8;
    uint32_t bits[8];
    philox_bits8(static_cast<unsigned long long>(i0), k0, k1, bits);
    if (i0 + 8 <= n) {
      Raw8<T> raw;
      raw.load(x + i0);
      float v[8];
      raw.unpack(v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = static_cast<long long>(bits[j]) > threshold ? v[j] * scale
                                                           : 0.f;
      store8(y + i0, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i0 + j < n)
          y[i0 + j] = from_f32<T>(static_cast<long long>(bits[j]) > threshold
                                      ? to_f32(x[i0 + j]) * scale
                                      : 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   const unsigned long long* __restrict__ seed,
                   long long threshold, float scale) {
  const unsigned long long key = *seed;
  const uint32_t k0 = static_cast<uint32_t>(key);
  const uint32_t k1 = static_cast<uint32_t>(key >> 32);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += stride) {
    const bool keep =
        static_cast<long long>(philox_bits(i, k0, k1)) > threshold;
    y[i] = from_f32<T>(keep ? to_f32(x[i]) * scale : 0.f);
  }
}

template <typename T>
int launch_vec(const void* x, void* y, long long n, const void* seed,
               long long threshold, float scale, cudaStream_t s) {
  int resident = 0;
  const cudaError_t e =
      resident_blocks<dropout_vec_kernel<T>, THREADS>(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = ((n + 7) / 8 + THREADS - 1) / THREADS;
  const long long blocks = want < resident ? want : resident;
  dropout_vec_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n,
      static_cast<const unsigned long long*>(seed), threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, void* y, long long n, const void* seed,
           long long threshold, float scale, cudaStream_t s) {
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks =
      static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  dropout_kernel<T><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n,
      static_cast<const unsigned long long*>(seed), threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// The general route.  x and y: contiguous, n elements, dtype 0 = f32, 1 =
// bf16; seed: the device address of the 64-bit key (low word k0, high word
// k1).  Returns the launch's cudaError_t (0 on success).
extern "C" int znicz_dropout(const void* x, void* y, long long n,
                             const void* seed, long long threshold,
                             float scale, int dtype, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(x, y, n, seed, threshold, scale, s)
             : launch<__nv_bfloat16>(x, y, n, seed, threshold, scale, s);
}

// The vector route: the arguments of znicz_dropout, with x and y on 16-byte
// boundaries (cudaErrorInvalidValue otherwise).
extern "C" int znicz_dropout_vec(const void* x, void* y, long long n,
                                 const void* seed, long long threshold,
                                 float scale, int dtype, void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch_vec<float>(x, y, n, seed, threshold, scale, s)
             : launch_vec<__nv_bfloat16>(x, y, n, seed, threshold, scale, s);
}

// One block of 32 threads of an empty kernel: the least time a launch
// takes, which chip_smoke.py times beside the bounds of the kernels that
// take less than a launch.
extern "C" int znicz_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
