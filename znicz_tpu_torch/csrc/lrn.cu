// Cross-channel local response normalization for Hopper (sm_90a): the
// forward and its analytic backward over channels-last activations seen as
// a (rows, C) array.
//
// Replaces: znicz_tpu/ops/pallas_kernels.py:_lrn_fwd_kernel (B1) and
// :_lrn_bwd_kernel (B2), reached through lrn_forward / lrn_backward (the
// LRN units' Pallas path).  The same function:
//   forward   d_i = k + alpha * sum_{j = i - lo}^{i + n - 1 - lo} x_j^2,
//             lo = n / 2 (zero outside [0, C));   y_i = x_i * d_i^(-beta)
//   backward  t_i = err_i * x_i * d_i^(-beta - 1)
//             dx_j = err_j * d_j^(-beta)
//                    - 2 alpha beta x_j * sum over the ADJOINT window of t,
//             the same sliding sum with lo' = n - 1 - n / 2 (it differs
//             from the forward's window when n is even)
// with f32 math whatever the storage (f32 or bf16), y stored in x's dtype
// and dx in err's.  The window sums add in channel order, as the TPU
// kernel's shifted adds do; d is not rounded (the reference's XLA path
// rounds it to bf16 in bf16 mode, its Pallas kernel does not).
//
// What bounds it on this card: bytes.  Per element the forward reads x and
// writes y, the backward reads x and err and writes dx, and does about
// 2n + 20 flops: at AlexNet's shapes, (128*55*55, 96) and (128*27*27, 256)
// in bf16, 149 and 96 MB forward, far below the ridge.  The design keeps
// each element's traffic at one read and one write: a block of 256 threads
// owns a contiguous run of whole rows (up to 4096 values), stages it in
// shared memory as f32 with coalesced loads, and takes every window sum
// from shared memory.  The backward stages x and err, writes t and
// err * d^(-beta) back into shared memory, and after one barrier takes the
// adjoint sums from there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_VALUES = 4096;  // values a block stages (whole rows)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// d^(-beta): AlexNet's beta = 0.75 as rsqrt(d * sqrt(d)), as the
// reference's XLA path computes it; powf otherwise
__device__ __forceinline__ float pow_neg(float d, float beta) {
  return beta == 0.75f ? rsqrtf(d * sqrtf(d)) : powf(d, -beta);
}

// sum of s[row_base + j] over the window [ch - lo, ch + hi] cut to [0, c),
// in channel order; `square` sums s^2
template <bool square>
__device__ __forceinline__ float window_sum(const float* s, int row_base,
                                            int ch, int c, int lo, int hi) {
  const int a = ch - lo > 0 ? ch - lo : 0;
  const int z = ch + hi < c - 1 ? ch + hi : c - 1;
  float sum = 0.f;
  for (int j = a; j <= z; ++j) {
    const float v = s[row_base + j];
    sum += square ? v * v : v;
  }
  return sum;
}

struct Geometry {
  long long rows;
  int c, n, rows_per_block;
  float alpha, beta, k;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g) {
  extern __shared__ float s_x[];
  const long long row0 = static_cast<long long>(blockIdx.x) * g.rows_per_block;
  const long long left = g.rows - row0;
  const int rows = left < g.rows_per_block ? static_cast<int>(left)
                                           : g.rows_per_block;
  const long long base = row0 * g.c;
  const int count = rows * g.c;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    s_x[e] = to_f(x[base + e]);
  }
  __syncthreads();
  const int lo = g.n / 2;
  const int hi = g.n - 1 - lo;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    const int ch = e % g.c;
    const float d =
        g.k + g.alpha * window_sum<true>(s_x, e - ch, ch, g.c, lo, hi);
    y[base + e] = from_f<T>(s_x[e] * pow_neg(d, g.beta));
  }
}

template <typename TX, typename TE>
__global__ void __launch_bounds__(THREADS)
    lrn_bwd_kernel(const TX* __restrict__ x, const TE* __restrict__ err,
                   TE* __restrict__ dx, Geometry g) {
  extern __shared__ float smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * g.rows_per_block;
  const long long left = g.rows - row0;
  const int rows = left < g.rows_per_block ? static_cast<int>(left)
                                           : g.rows_per_block;
  const long long base = row0 * g.c;
  const int count = rows * g.c;
  float* s_x = smem;
  float* s_e = s_x + count;  // err, then err * d^(-beta)
  float* s_t = s_e + count;  // t = err * x * d^(-beta - 1)
  for (int e = threadIdx.x; e < count; e += THREADS) {
    s_x[e] = to_f(x[base + e]);
    s_e[e] = to_f(err[base + e]);
  }
  __syncthreads();
  const int lo = g.n / 2;
  const int hi = g.n - 1 - lo;
  for (int e = threadIdx.x; e < count; e += THREADS) {
    const int ch = e % g.c;
    const float d =
        g.k + g.alpha * window_sum<true>(s_x, e - ch, ch, g.c, lo, hi);
    const float p = pow_neg(d, g.beta);
    const float er = s_e[e];
    s_t[e] = er * s_x[e] * (p / d);
    s_e[e] = er * p;  // each thread rewrites only its own elements
  }
  __syncthreads();
  // the adjoint window: [ch - hi, ch + lo]
  for (int e = threadIdx.x; e < count; e += THREADS) {
    const int ch = e % g.c;
    const float adj = window_sum<false>(s_t, e - ch, ch, g.c, hi, lo);
    dx[base + e] =
        from_f<TE>(s_e[e] - 2.f * g.alpha * g.beta * s_x[e] * adj);
  }
}

Geometry make_geometry(long long rows, int c, int n, float alpha, float beta,
                       float k) {
  Geometry g;
  g.rows = rows;
  g.c = c;
  g.n = n;
  g.rows_per_block = TILE_VALUES / c > 0 ? TILE_VALUES / c : 1;
  g.alpha = alpha;
  g.beta = beta;
  g.k = k;
  return g;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int arrays, const Geometry& g,
                   cudaStream_t stream, Args... args) {
  const int smem =
      arrays * g.rows_per_block * g.c * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (g.rows + g.rows_per_block - 1) / g.rows_per_block;
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(args...,
                                                                   g);
  return cudaGetLastError();
}

}  // namespace

// x and y: contiguous (rows, c), dtype 0 = f32, 1 = bf16 (both the same).
// Returns the launch's cudaError_t (0 on success); the caller checks
// shapes, dtypes and c <= 16384 (the staged rows must fit shared memory).
extern "C" int znicz_lrn_fwd(const void* x, void* y, long long rows, int c,
                             int n, float alpha, float beta, float k,
                             int dtype, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  const Geometry g = make_geometry(rows, c, n, alpha, beta, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch(lrn_fwd_kernel<float>, 1, g, s,
                                   static_cast<const float*>(x),
                                   static_cast<float*>(y)));
  }
  return static_cast<int>(launch(lrn_fwd_kernel<__nv_bfloat16>, 1, g, s,
                                 static_cast<const __nv_bfloat16*>(x),
                                 static_cast<__nv_bfloat16*>(y)));
}

template <typename TX, typename TE>
static int bwd(const void* x, const void* err, void* dx, const Geometry& g,
               cudaStream_t s) {
  return static_cast<int>(launch(lrn_bwd_kernel<TX, TE>, 3, g, s,
                                 static_cast<const TX*>(x),
                                 static_cast<const TE*>(err),
                                 static_cast<TE*>(dx)));
}

// x, err and dx: contiguous (rows, c); x_dtype and err_dtype each 0 = f32,
// 1 = bf16; dx has err's dtype.
extern "C" int znicz_lrn_bwd(const void* x, const void* err, void* dx,
                             long long rows, int c, int n, float alpha,
                             float beta, float k, int x_dtype, int err_dtype,
                             void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  const Geometry g = make_geometry(rows, c, n, alpha, beta, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && err_dtype == 0) return bwd<float, float>(x, err, dx, g, s);
  if (x_dtype == 0) return bwd<float, __nv_bfloat16>(x, err, dx, g, s);
  if (err_dtype == 0) return bwd<__nv_bfloat16, float>(x, err, dx, g, s);
  return bwd<__nv_bfloat16, __nv_bfloat16>(x, err, dx, g, s);
}
