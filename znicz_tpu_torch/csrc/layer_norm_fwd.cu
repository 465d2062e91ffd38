// Layer-norm forward for Hopper (sm_90a): f32 statistics, output stored
// in the input dtype (f32 or bf16).
//
// Replaces: znicz_tpu/ops/pallas_kernels.py:_ln_fwd_kernel (the Pallas TPU
// kernel reached through layer_norm_forward).  Same function:
//   mu = mean(x); var = mean((x - mu)^2)   (f32, two passes)
//   y = (x - mu) * rsqrt(var + eps) * gamma + beta   (beta optional)
// over the last axis of an (M, D) row-major array.
//
// What bounds it on this card: it does ~10 operations per element and
// moves each element twice (read x, write y), ~2.5 operations per byte
// against the H100's ~295 FLOP/byte ridge, so device-memory bandwidth
// bounds it.  The design answers that by reading x from device memory
// once and writing y once: one warp per row, 16-byte vector loads where
// the row is aligned, and the second and third passes over the row
// served from L1 (a 512-wide bf16 row is 1 KB, a block of 8 rows 8 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row
constexpr int THREADS = ROWS_PER_BLOCK * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 8 consecutive elements <-> 8 floats through 16-byte accesses
__device__ __forceinline__ void load8(const float* p, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float out[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y,
                  long long m, int d, float eps) {
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float sum = 0.f;
  if (VEC) {
    for (int i = lane * 8; i < d; i += 32 * 8) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += v[j];
    }
  } else {
    for (int i = lane; i < d; i += 32) sum += to_f32(xr[i]);
  }
  const float mu = warp_sum(sum) / d;

  float sq = 0.f;
  if (VEC) {
    for (int i = lane * 8; i < d; i += 32 * 8) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float c = v[j] - mu;
        sq += c * c;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float c = to_f32(xr[i]) - mu;
      sq += c * c;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);

  if (VEC) {
    for (int i = lane * 8; i < d; i += 32 * 8) {
      float v[8];
      load8(xr + i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = (v[j] - mu) * rstd * gamma[i + j];
        if (beta != nullptr) v[j] += beta[i + j];
      }
      store8(yr + i, v);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float c = (to_f32(xr[i]) - mu) * rstd * gamma[i];
      if (beta != nullptr) c += beta[i];
      yr[i] = from_f32<T>(c);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* gamma, const float* beta,
                   void* y, long long m, int d, float eps, int vec,
                   cudaStream_t stream) {
  const long long blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (vec) {
    ln_fwd_kernel<T, true><<<static_cast<unsigned>(blocks), THREADS, 0,
                             stream>>>(static_cast<const T*>(x), gamma, beta,
                                       static_cast<T*>(y), m, d, eps);
  } else {
    ln_fwd_kernel<T, false><<<static_cast<unsigned>(blocks), THREADS, 0,
                              stream>>>(static_cast<const T*>(x), gamma, beta,
                                        static_cast<T*>(y), m, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x, y: (m, d) row-major; gamma, beta: (d,) f32, beta may be null.
// dtype: 0 = f32, 1 = bf16.  vec = 1 only when d % 8 == 0 and x, y,
// gamma, beta are 16-byte aligned.  Returns the launch's cudaError_t.
extern "C" int znicz_layer_norm_fwd(const void* x, const void* gamma,
                                    const void* beta, void* y, long long m,
                                    int d, float eps, int dtype, int vec,
                                    void* stream) {
  if (m <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(x, g, b, y, m, d, eps, vec, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, g, b, y, m, d, eps, vec, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
