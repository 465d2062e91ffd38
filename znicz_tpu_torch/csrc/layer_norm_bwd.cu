// Layer-norm backward for Hopper (sm_90a): dx plus the cross-row gamma and
// beta gradient sums, f32 statistics, x and err in f32 or bf16.
//
// Replaces: znicz_tpu/ops/pallas_kernels.py:_ln_bwd_kernel (the Pallas TPU
// kernel reached through layer_norm_backward).  Same function, over the
// last axis of (M, D) row-major x and err:
//   mu = mean(x); var = mean((x - mu)^2); rstd = rsqrt(var + eps)
//   xhat = (x - mu) * rstd; dxhat = err * gamma
//   dx = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * rstd
//        stored in err's dtype
//   grad_gamma = sum_rows(err * xhat); grad_beta = sum_rows(err)   (f32)
//
// What bounds it on this card: ~25 operations per element against reading
// x and err and writing dx once each, ~4 operations per byte in bf16, far
// below the H100's ~295 FLOP/byte ridge: device-memory bandwidth bounds it.
// The design answers that by reading each row from device memory once:
// one warp per row, 16-byte vector loads where the row is aligned, and the
// second and third passes over the row served from L1, as the forward
// kernel does.
//
// The cross-row sums: the TPU kernel walks its row tiles in order and
// carries the sums in scratch memory.  Hopper blocks run in no order, so
// each block owns a fixed, contiguous range of rows.  Every warp adds its
// rows' terms into its own shared-memory row of partial sums (each column
// belongs to one lane, so no two threads touch one address); at the end
// the block folds its warps' rows in warp order and writes one row of an
// f32 workspace (n_blocks, D).  A second kernel folds the workspace over
// blocks in block order.  No atomics: a rerun gives the same bits.
//
// Rows past M are never read (the counterpart of the reference's tail-tile
// guard), and any row count and any D up to the shared memory one warp's
// partial sums fit in (51200, or 25600 with beta) are taken: the vector
// path needs D % 8 == 0 and 16-byte alignment, the scalar path takes the
// rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 8;
//: blocks are capped so the workspace stays small; the row range a block
//: owns depends on M and this constant only, never on the card
constexpr int MAX_BLOCKS = 1024;
constexpr int FOLD_THREADS = 256;

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
// 8 consecutive shared-memory floats += v (two 16-byte accesses)
__device__ __forceinline__ void add8(float* p, const float v[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  float4 a = q[0], b = q[1];
  a.x += v[0]; a.y += v[1]; a.z += v[2]; a.w += v[3];
  b.x += v[4]; b.y += v[5]; b.z += v[6]; b.w += v[7];
  q[0] = a;
  q[1] = b;
}

// One block: `warps` warps over rows [row0, row1), warp w taking rows
// row0 + w, row0 + w + warps, ...  Dynamic shared memory holds `warps`
// rows of D partial gamma sums, then (with beta) `warps` rows of partial
// beta sums.
template <typename TX, typename TE, bool VEC>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    ln_bwd_rows_kernel(const TX* __restrict__ x, const TE* __restrict__ err,
                       const float* __restrict__ gamma, TE* __restrict__ dx,
                       float* __restrict__ work_g, float* __restrict__ work_b,
                       long long m, int d, long long rows_per_block,
                       float eps) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_beta = work_b != nullptr;
  float* acc_g = smem + static_cast<long long>(warp) * d;
  float* acc_b = smem + static_cast<long long>(warps + warp) * d;

  for (int i = threadIdx.x; i < warps * d * (has_beta ? 2 : 1);
       i += blockDim.x) {
    smem[i] = 0.f;
  }
  __syncthreads();

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long row1 = row0 + rows_per_block;
  if (row1 > m) row1 = m;
  const float inv_d = 1.0f / static_cast<float>(d);

  for (long long row = row0 + warp; row < row1; row += warps) {
    const TX* xr = x + row * d;
    const TE* er = err + row * d;
    TE* dr = dx + row * d;

    // pass 1: mean of x
    float s = 0.f;
    if (VEC) {
      for (int i = lane * 8; i < d; i += 32 * 8) {
        float v[8];
        load8(xr + i, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[j];
      }
    } else {
      for (int i = lane; i < d; i += 32) s += to_f32(xr[i]);
    }
    const float mu = warp_sum(s) * inv_d;

    // pass 2: centred variance, mean(dxhat), sum(dxhat * (x - mu))
    float sq = 0.f, sd = 0.f, sdx = 0.f;
    if (VEC) {
      for (int i = lane * 8; i < d; i += 32 * 8) {
        float v[8], e[8];
        load8(xr + i, v);
        load8(er + i, e);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float c = v[j] - mu;
          const float g = e[j] * gamma[i + j];
          sq += c * c;
          sd += g;
          sdx += g * c;
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float c = to_f32(xr[i]) - mu;
        const float g = to_f32(er[i]) * gamma[i];
        sq += c * c;
        sd += g;
        sdx += g * c;
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    const float mean_dxhat = warp_sum(sd) * inv_d;
    // mean(dxhat * xhat) = rstd * mean(dxhat * (x - mu))
    const float mean_dxhat_xhat = warp_sum(sdx) * inv_d * rstd;

    // pass 3: dx, and this warp's column partials
    if (VEC) {
      for (int i = lane * 8; i < d; i += 32 * 8) {
        float v[8], e[8], out[8], tg[8];
        load8(xr + i, v);
        load8(er + i, e);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xhat = (v[j] - mu) * rstd;
          const float g = e[j] * gamma[i + j];
          out[j] = (g - mean_dxhat - xhat * mean_dxhat_xhat) * rstd;
          tg[j] = e[j] * xhat;
        }
        store8(dr + i, out);
        add8(acc_g + i, tg);
        if (has_beta) add8(acc_b + i, e);
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float e = to_f32(er[i]);
        const float xhat = (to_f32(xr[i]) - mu) * rstd;
        const float g = e * gamma[i];
        dr[i] = from_f32<TE>((g - mean_dxhat - xhat * mean_dxhat_xhat) * rstd);
        acc_g[i] += e * xhat;
        if (has_beta) acc_b[i] += e;
      }
    }
  }
  __syncthreads();

  // fold this block's warps in warp order into its workspace row
  float* wg = work_g + static_cast<long long>(blockIdx.x) * d;
  float* wb = has_beta ? work_b + static_cast<long long>(blockIdx.x) * d
                       : nullptr;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float g = 0.f, b = 0.f;
    for (int w = 0; w < warps; ++w) {
      g += smem[w * d + c];
      if (has_beta) b += smem[(warps + w) * d + c];
    }
    wg[c] = g;
    if (has_beta) wb[c] = b;
  }
}

// grad[c] = sum over blocks, in block order, of work[block][c]
__global__ void __launch_bounds__(FOLD_THREADS)
    ln_bwd_fold_kernel(const float* __restrict__ work_g,
                       const float* __restrict__ work_b,
                       float* __restrict__ grad_g, float* __restrict__ grad_b,
                       int n_blocks, int d) {
  const int c = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (c >= d) return;
  float g = 0.f, b = 0.f;
  for (int i = 0; i < n_blocks; ++i) {
    g += work_g[static_cast<long long>(i) * d + c];
    if (grad_b != nullptr) b += work_b[static_cast<long long>(i) * d + c];
  }
  grad_g[c] = g;
  if (grad_b != nullptr) grad_b[c] = b;
}

// warps per block such that the partial-sum rows fit the shared memory a
// block may use; 0 when even one warp's rows do not fit
int warps_for(int d, bool has_beta) {
  const long long per_warp = static_cast<long long>(d) * 4 * (has_beta ? 2 : 1);
  const long long limit = 200 * 1024;
  int warps = MAX_WARPS;
  while (warps > 0 && warps * per_warp > limit) warps /= 2;
  return warps;
}

template <typename TX, typename TE>
cudaError_t launch(const void* x, const void* err, const float* gamma,
                   void* dx, float* grad_g, float* grad_b, float* work,
                   long long m, int d, float eps, int vec,
                   cudaStream_t stream) {
  const bool has_beta = grad_b != nullptr;
  const int warps = warps_for(d, has_beta);
  if (warps == 0) return cudaErrorInvalidValue;
  long long n_blocks = 0;
  if (m > 0) {
    n_blocks = (m + warps - 1) / warps;
    if (n_blocks > MAX_BLOCKS) n_blocks = MAX_BLOCKS;
    const long long rows_per_block = (m + n_blocks - 1) / n_blocks;
    n_blocks = (m + rows_per_block - 1) / rows_per_block;
    float* work_g = work;
    float* work_b = has_beta ? work + n_blocks * d : nullptr;
    const int smem = warps * d * 4 * (has_beta ? 2 : 1);
    auto kernel = vec ? ln_bwd_rows_kernel<TX, TE, true>
                      : ln_bwd_rows_kernel<TX, TE, false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    kernel<<<static_cast<unsigned>(n_blocks), warps * 32, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TE*>(err), gamma,
        static_cast<TE*>(dx), work_g, work_b, m, d, rows_per_block, eps);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const float* work_b = has_beta ? work + n_blocks * d : nullptr;
  ln_bwd_fold_kernel<<<(d + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0,
                       stream>>>(work, work_b, grad_g, grad_b,
                                 static_cast<int>(n_blocks), d);
  return cudaGetLastError();
}

}  // namespace

// The number of workspace rows (blocks) the kernel uses for m rows of
// width d; the caller allocates a workspace of (rows * d * (1 + beta))
// floats.  -1 when d is too wide for the shared-memory partial sums.
extern "C" long long znicz_layer_norm_bwd_blocks(long long m, int d,
                                                 int has_beta) {
  const int warps = warps_for(d, has_beta != 0);
  if (warps == 0) return -1;
  if (m <= 0) return 0;
  long long n_blocks = (m + warps - 1) / warps;
  if (n_blocks > MAX_BLOCKS) n_blocks = MAX_BLOCKS;
  const long long rows_per_block = (m + n_blocks - 1) / n_blocks;
  return (m + rows_per_block - 1) / rows_per_block;
}

// x: (m, d) row-major in x_dtype; err, dx: (m, d) row-major in err_dtype;
// gamma, grad_gamma, grad_beta: (d,) f32, grad_beta null for a beta-less
// layer norm; work: the f32 workspace sized by znicz_layer_norm_bwd_blocks.
// dtypes: 0 = f32, 1 = bf16.  vec = 1 only when d % 8 == 0 and x, err, dx
// and gamma are 16-byte aligned.  Returns the launches' cudaError_t.
extern "C" int znicz_layer_norm_bwd(const void* x, const void* err,
                                    const void* gamma, void* dx,
                                    void* grad_gamma, void* grad_beta,
                                    void* work, long long m, int d, float eps,
                                    int x_dtype, int err_dtype, int vec,
                                    void* stream) {
  if (d <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* gg = static_cast<float*>(grad_gamma);
  float* gb = static_cast<float*>(grad_beta);
  float* w = static_cast<float*>(work);
  switch (x_dtype * 2 + err_dtype) {
    case 0:
      return static_cast<int>(
          launch<float, float>(x, err, g, dx, gg, gb, w, m, d, eps, vec, s));
    case 1:
      return static_cast<int>(launch<float, __nv_bfloat16>(
          x, err, g, dx, gg, gb, w, m, d, eps, vec, s));
    case 2:
      return static_cast<int>(launch<__nv_bfloat16, float>(
          x, err, g, dx, gg, gb, w, m, d, eps, vec, s));
    case 3:
      return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16>(
          x, err, g, dx, gg, gb, w, m, d, eps, vec, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
