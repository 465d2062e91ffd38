// Row softmax and argmax for Hopper (sm_90a) over (rows, C) f32 logits.
//
// Replaces: znicz_tpu/ops/pallas_kernels.py:_softmax_argmax_kernel (B4),
// reached through softmax_argmax, whose contract is All2AllSoftmax's: the
// stabilized softmax y = exp(v - max) / sum(exp(v - max)) in f32 and the
// int32 index of the row's maximum, the first one on ties (jnp.argmax; a
// NaN counts as the maximum, as there).
//
// What bounds it on this card: bytes, (rows * C * 4) read and as many plus
// rows * 4 written: at the AlexNet head's (128, 1000) about 1 MB, at the
// serving buckets' and the sequence stack's (<= 16, 8) 1 KB, both far less
// than one launch costs.  So the design is about latency: one pass over
// memory, few dependent steps a thread, and every thread owning work.
//
// The register kernel (the route rows of up to 1024 classes take; the rule
// is softmax_route in ops/fused_kernels.py):
//   - A group of G threads holds a row in registers, G a power of two up to
//     256: one element a thread up to 256 classes (at C = 8, 8 lanes a row,
//     four rows a warp), past that one 128-bit vector of 4 elements a
//     thread where C % 4 == 0 and the rows lie on 16-byte boundaries (at
//     C = 1000, 250 of 256 threads), else up to 4 elements a thread.
//     Thread t of a group takes the vectors t, t + G, ... of its row.  One
//     warp a row was the first design: at C = 1000 its 32 elements a lane
//     (compares, exponentials and divisions in one thread) took longer than
//     the block kernel on an H100.
//   - Each thread finds the best (value, index) of its elements, then a
//     shuffle tree over the warp's part of the group (xor distances 16 ..
//     1, within the group) and, for a group of several warps, the warps'
//     results in warp order from shared memory.  `better` is a total order
//     on (value, index) pairs, so any order of comparisons gives the first
//     maximum, a NaN if the row has one.  Padding is (-inf, C), which every
//     element of the row beats.
//   - exp(v - max) is computed once an element and kept in registers; the
//     row sum runs through the same trees in a fixed order (the xor
//     butterfly gives every lane the same bits), and each element is
//     written once as exp * (1 / sum): one reciprocal a thread, as a
//     division an element cost an H100 ~6 % more at C = 1000.
//   - Blocks of 256 threads, as many as the rows need.
// The block kernel takes rows past 1024 classes: a block of 256 threads a
// row, three strided passes (max and argmax, the sum, the quotients).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
//: the widest row the register kernel takes: 256 threads, 4 elements each
constexpr int REG_MAX_C = 1024;

// (v, i) beats (bv, bi): larger, or equal and earlier; NaN beats numbers
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// ---------------------------------------------------------------------
// the register kernel
// ---------------------------------------------------------------------

// A group of 1 << LOG_G threads a row; each thread NV vectors of VW
// elements (VW = 4: 128-bit accesses; 1: scalar).
template <int LOG_G, int VW, int NV>
__global__ void __launch_bounds__(THREADS)
    softmax_argmax_reg_kernel(const float* __restrict__ v,
                              float* __restrict__ y, int* __restrict__ idx,
                              long long rows, int c) {
  constexpr int G = 1 << LOG_G;
  constexpr int E = NV * VW;  // elements a thread
  constexpr int LANES = G < 32 ? G : 32;  // the group's lanes in a warp
  constexpr int GW = G / LANES;           // warps a group
  __shared__ float s_val[WARPS];
  __shared__ int s_idx[WARPS];
  __shared__ float s_sum[WARPS];
  const int sub = threadIdx.x & (G - 1);  // the thread's place in its group
  const long long row =
      (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) >> LOG_G;
  const bool live = row < rows;  // a whole group is live or not
  const float* vr = v + row * c;
  float val[E];
  int at[E];  // column, or c for padding
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int base = (sub + k * G) * VW;
    if constexpr (VW == 4) {
      float4 q = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (live && base < c)
        q = __ldg(reinterpret_cast<const float4*>(vr + base));
      val[k * 4] = q.x;
      val[k * 4 + 1] = q.y;
      val[k * 4 + 2] = q.z;
      val[k * 4 + 3] = q.w;
    } else {
      val[k] = live && base < c ? __ldg(vr + base) : -INFINITY;
    }
#pragma unroll
    for (int j = 0; j < VW; ++j) at[k * VW + j] = base + j < c ? base + j : c;
  }
  // the thread's best: a pairwise tree over its elements
  float bv[E];
  int bi[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    bv[e] = val[e];
    bi[e] = at[e];
  }
#pragma unroll
  for (int w = 1; w < E; w *= 2)
#pragma unroll
    for (int e = 0; e + w < E; e += 2 * w)
      if (better(bv[e + w], bi[e + w], bv[e], bi[e])) {
        bv[e] = bv[e + w];
        bi[e] = bi[e + w];
      }
  float best = bv[0];
  int best_i = bi[0];
#pragma unroll
  for (int off = LANES / 2; off; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best, best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  const int warp = threadIdx.x / 32;
  const int first = warp / GW * GW;  // the group's first warp
  if constexpr (GW > 1) {
    if (threadIdx.x % 32 == 0) {
      s_val[warp] = best;
      s_idx[warp] = best_i;
    }
    __syncthreads();
    best = s_val[first];
    best_i = s_idx[first];
#pragma unroll
    for (int w = 1; w < GW; ++w)
      if (better(s_val[first + w], s_idx[first + w], best, best_i)) {
        best = s_val[first + w];
        best_i = s_idx[first + w];
      }
  }
  // the exponentials, kept, and their sum: a pairwise tree, the shuffle
  // tree, then the group's warps in warp order
  float t[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    val[e] = at[e] < c ? expf(val[e] - best) : 0.f;
    t[e] = val[e];
  }
#pragma unroll
  for (int w = 1; w < E; w *= 2)
#pragma unroll
    for (int e = 0; e + w < E; e += 2 * w) t[e] += t[e + w];
  float sum = t[0];
#pragma unroll
  for (int off = LANES / 2; off; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if constexpr (GW > 1) {
    if (threadIdx.x % 32 == 0) s_sum[warp] = sum;
    __syncthreads();
    sum = s_sum[first];
#pragma unroll
    for (int w = 1; w < GW; ++w) sum += s_sum[first + w];
  }
  if (!live) return;
  const float inv = 1.f / sum;
  float* yr = y + row * c;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int base = (sub + k * G) * VW;
    if (base >= c) continue;
    if constexpr (VW == 4) {
      *reinterpret_cast<float4*>(yr + base) =
          make_float4(val[k * 4] * inv, val[k * 4 + 1] * inv,
                      val[k * 4 + 2] * inv, val[k * 4 + 3] * inv);
    } else {
      yr[base] = val[k] * inv;
    }
  }
  if (sub == 0) idx[row] = best_i;
}

template <int LOG_G, int VW, int NV>
cudaError_t launch_reg(const float* v, float* y, int* idx, long long rows,
                       int c, cudaStream_t stream) {
  constexpr long long ROWS_A_BLOCK = THREADS >> LOG_G;
  const long long blocks = (rows + ROWS_A_BLOCK - 1) / ROWS_A_BLOCK;
  softmax_argmax_reg_kernel<LOG_G, VW, NV>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(v, y, idx,
                                                             rows, c);
  return cudaGetLastError();
}

// the instantiation for c: one element a thread up to 256 classes (the
// group the power of two at or above c), past that 256 threads a row with
// a 128-bit vector each (vec) or up to 4 elements each
cudaError_t reg_route(const float* v, float* y, int* idx, long long rows,
                      int c, bool vec, cudaStream_t s) {
  if (c <= 1) return launch_reg<0, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 2) return launch_reg<1, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 4) return launch_reg<2, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 8) return launch_reg<3, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 16) return launch_reg<4, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 32) return launch_reg<5, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 64) return launch_reg<6, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 128) return launch_reg<7, 1, 1>(v, y, idx, rows, c, s);
  if (c <= 256) return launch_reg<8, 1, 1>(v, y, idx, rows, c, s);
  if (vec) return launch_reg<8, 4, 1>(v, y, idx, rows, c, s);
  if (c <= 512) return launch_reg<8, 1, 2>(v, y, idx, rows, c, s);
  return launch_reg<8, 1, 4>(v, y, idx, rows, c, s);
}

// ---------------------------------------------------------------------
// the block kernel
// ---------------------------------------------------------------------

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

// The block route.  v and y: contiguous (rows, c) f32; idx: (rows,) int32.
// Returns the launch's cudaError_t (0 on success).
extern "C" int znicz_softmax_argmax(const void* v, void* y, void* idx,
                                    long long rows, int c, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  softmax_argmax_kernel<<<static_cast<unsigned>(rows), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(y),
      static_cast<int*>(idx), c);
  return static_cast<int>(cudaGetLastError());
}

// The register route: the arguments of znicz_softmax_argmax, c up to 1024
// (cudaErrorInvalidValue past it).  Its 128-bit path runs where c > 256,
// c % 4 == 0 and v and y lie on 16-byte boundaries.
extern "C" int znicz_softmax_argmax_reg(const void* v, void* y, void* idx,
                                        long long rows, int c,
                                        void* stream) {
  if (c > REG_MAX_C) return cudaErrorInvalidValue;
  if (rows <= 0 || c <= 0) return cudaSuccess;
  const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return static_cast<int>(reg_route(static_cast<const float*>(v),
                                    static_cast<float*>(y),
                                    static_cast<int*>(idx), rows, c, vec,
                                    static_cast<cudaStream_t>(stream)));
}
