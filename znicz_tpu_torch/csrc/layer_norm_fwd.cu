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
// bounds it, and the design is about keeping device memory busy.
//
// The register kernel (the route rows with D % 8 == 0 up to 1024, on
// 16-byte boundaries, take; the rule is layer_norm_route in
// ops/fused_kernels.py):
//   - A warp owns a row and holds it in registers: lane l takes the
//     8-element vectors l, l + 32, ... (16 elements a lane at D = 512), each
//     moved by 128-bit accesses.  x is read from device memory once and y
//     written once; both statistics come from the registers (two passes,
//     as the reference: the mean, then the centred variance).
//   - Each lane loads its gamma and beta columns once, for all its rows.
//   - The blocks are persistent (as many as the card holds at once), each
//     warp walking rows a grid of warps apart, and each warp starts the
//     loads of its next row before it computes the current one, so a load
//     stays in flight through the two warp reductions and the stores.
//     Every row's arithmetic is the same whichever warp takes it, so the
//     grid's size does not change the bits.
// The general kernel takes the rest (D not a multiple of 8 or over 1024, a
// pointer off 16 bytes): one warp per row, the second and third passes over
// the row served from L1 (a 512-wide bf16 row is 1 KB, a block of 8 rows
// 8 KB).

#include "rows.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // one warp per row
constexpr int THREADS = ROWS_PER_BLOCK * 32;
//: 8-element vectors a lane of the register kernel holds at most: rows of
//: up to 32 * 8 * REG_MAX_NV = 1024 elements
constexpr int REG_MAX_NV = 4;

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

// ---------------------------------------------------------------------
// the register kernel
// ---------------------------------------------------------------------

// One warp a row, NV vectors of 8 a lane (vector l + 32 k of the row for
// k < NV, those below d / 8); warps walk rows gridDim.x * ROWS_PER_BLOCK
// apart.  Within a row every sum runs in a fixed order: a lane adds its
// elements vector by vector, element by element, then warp_sum's
// butterfly.
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
    ln_fwd_reg_kernel(const T* __restrict__ x,
                      const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y,
                      long long m, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int vecs = d / 8;
  const bool has_beta = beta != nullptr;
  bool own[NV];
  float g[NV][8], b[NV][8];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    own[k] = lane + 32 * k < vecs;
#pragma unroll
    for (int j = 0; j < 8; ++j) g[k][j] = b[k][j] = 0.f;
    if (own[k]) {
      load8(gamma + (lane + 32 * k) * 8, g[k]);
      if (has_beta) load8(beta + (lane + 32 * k) * 8, b[k]);
    }
  }
  const long long stride =
      static_cast<long long>(gridDim.x) * ROWS_PER_BLOCK;
  long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / 32;
  Raw8<T> next[NV];
  if (row < m) {
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) next[k].load(x + row * d + (lane + 32 * k) * 8);
  }
  for (; row < m; row += stride) {
    float v[NV][8];
#pragma unroll
    for (int k = 0; k < NV; ++k) next[k].unpack(v[k]);
    if (row + stride < m) {
#pragma unroll
      for (int k = 0; k < NV; ++k)
        if (own[k]) next[k].load(x + (row + stride) * d + (lane + 32 * k) * 8);
    }
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[k][j];
      }
    const float mu = warp_sum(s) / d;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float c = v[k][j] - mu;
          sq += c * c;
        }
      }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) {
        float out[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          out[j] = (v[k][j] - mu) * rstd * g[k][j];
          if (has_beta) out[j] += b[k][j];
        }
        store8(y + row * d + (lane + 32 * k) * 8, out);
      }
  }
}

// a persistent grid: as many blocks as the card holds at once, at most
// one a warp's row
template <auto Kernel, typename T>
cudaError_t launch_reg(const void* x, const float* gamma, const float* beta,
                       void* y, long long m, int d, float eps,
                       cudaStream_t stream) {
  int resident = 0;
  const cudaError_t e = resident_blocks<Kernel, THREADS>(&resident);
  if (e != cudaSuccess) return e;
  long long blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  if (blocks > resident) blocks = resident;
  Kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), m, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_reg(const void* x, const float* gamma, const float* beta,
                       void* y, long long m, int d, float eps,
                       cudaStream_t stream) {
  switch ((d / 8 + 31) / 32) {
    case 1:
      return launch_reg<ln_fwd_reg_kernel<T, 1>, T>(x, gamma, beta, y, m, d,
                                                    eps, stream);
    case 2:
      return launch_reg<ln_fwd_reg_kernel<T, 2>, T>(x, gamma, beta, y, m, d,
                                                    eps, stream);
    case 3:
      return launch_reg<ln_fwd_reg_kernel<T, 3>, T>(x, gamma, beta, y, m, d,
                                                    eps, stream);
    default:
      return launch_reg<ln_fwd_reg_kernel<T, 4>, T>(x, gamma, beta, y, m, d,
                                                    eps, stream);
  }
}

bool reg_takes(int d, const void* x, const void* gamma, const void* beta,
               const void* y) {
  const auto off = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  return d >= 8 && d % 8 == 0 && d <= 32 * 8 * REG_MAX_NV && !off(x) &&
         !off(gamma) && !off(beta) && !off(y);
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

// The register kernel, the same operands as znicz_layer_norm_fwd: takes
// 8 <= d <= 1024 with d % 8 == 0 and every pointer on a 16-byte boundary,
// and returns cudaErrorInvalidValue for anything else.
extern "C" int znicz_layer_norm_fwd_reg(const void* x, const void* gamma,
                                        const void* beta, void* y,
                                        long long m, int d, float eps,
                                        int dtype, void* stream) {
  if (!reg_takes(d, x, gamma, beta, y))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_reg<float>(x, g, b, y, m, d, eps, s));
    case 1:
      return static_cast<int>(
          launch_reg<__nv_bfloat16>(x, g, b, y, m, d, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
