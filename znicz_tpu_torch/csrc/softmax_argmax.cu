// Row softmax and argmax for Hopper (sm_90a) over (rows, C) f32 logits.
//
// Replaces: znicz_tpu/ops/pallas_kernels.py:_softmax_argmax_kernel (B4),
// reached through softmax_argmax, whose contract is All2AllSoftmax's: the
// stabilized softmax y = exp(v - max) / sum(exp(v - max)) in f32 and the
// int32 index of the row's maximum, the first one on ties (jnp.argmax; a
// NaN counts as the maximum, as there).
//
// What bounds it on this card: bytes, (rows * C * 4) read and as many plus
// rows * 4 written: at the AlexNet head's (128, 1000) about 1 MB, which
// the card moves in well under a launch's latency.  Design: one block of
// 256 threads per row.  Each thread keeps the best value and its index
// over a strided slice of the row, a warp shuffle and one shared-memory
// step reduce them, and two more strided passes (the sum of the
// exponentials, then the quotients) read the row again from the L1/L2
// caches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// (v, i) beats (bv, bi): larger, or equal and earlier; NaN beats numbers
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float block_sum(float v, float* s_sum) {
  for (int off = 16; off; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) s_sum[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < WARPS; ++w) total += s_sum[w];  // fixed order
  return total;
}

__global__ void __launch_bounds__(THREADS)
    softmax_argmax_kernel(const float* __restrict__ v, float* __restrict__ y,
                          int* __restrict__ idx, int c) {
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  __shared__ float s_sum[WARPS];
  const long long row = blockIdx.x;
  const float* vr = v + row * c;
  float bv = -INFINITY;
  int bi = c;
  for (int j = threadIdx.x; j < c; j += THREADS) {
    const float x = vr[j];
    if (better(x, j, bv, bi)) {
      bv = x;
      bi = j;
    }
  }
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    s_val[warp] = bv;
    s_idx[warp] = bi;
  }
  __syncthreads();
  bv = s_val[0];
  bi = s_idx[0];
  for (int w = 1; w < WARPS; ++w) {
    if (better(s_val[w], s_idx[w], bv, bi)) {
      bv = s_val[w];
      bi = s_idx[w];
    }
  }
  if (threadIdx.x == 0) idx[row] = bi;
  float part = 0.f;
  for (int j = threadIdx.x; j < c; j += THREADS) part += expf(vr[j] - bv);
  const float total = block_sum(part, s_sum);
  float* yr = y + row * c;
  for (int j = threadIdx.x; j < c; j += THREADS) {
    yr[j] = expf(vr[j] - bv) / total;
  }
}

}  // namespace

// v and y: contiguous (rows, c) f32; idx: (rows,) int32.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int znicz_softmax_argmax(const void* v, void* y, void* idx,
                                    long long rows, int c, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  softmax_argmax_kernel<<<static_cast<unsigned>(rows), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(y),
      static_cast<int*>(idx), c);
  return static_cast<int>(cudaGetLastError());
}
