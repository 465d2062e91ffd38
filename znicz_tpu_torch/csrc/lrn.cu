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
// writes y (4 bytes in bf16), the backward reads x and err and writes dx
// (6 bytes), and either does about 2n + 20 flops: at AlexNet's shapes,
// (128*55*55, 96) and (128*27*27, 256) in bf16, the forward moves 149 and
// 96 MB, the backward 223 and 143 MB, far below the ridge.  So the design
// is about keeping device memory busy.
//
// The vector kernels (the route AlexNet's shapes take):
//   - A thread owns V = 8 consecutive channels of one row and moves them
//     with 128-bit accesses straight between device memory and registers
//     (one in bf16, two in f32), neighbouring threads on neighbouring 16
//     bytes.  A block of 256 threads holds whole rows (a tile: 21 rows of
//     96 channels, 8 of 256), so a tile is one contiguous run of device
//     memory and the thread-to-vector map is fixed: one division a thread.
//   - Only halos go through shared memory: each thread writes its V squares
//     there, planar ([element][vector], so a warp's accesses are free of
//     bank conflicts), and after one barrier reads the window's neighbours,
//     clamped to its row, and sums in channel order in registers.  The
//     backward keeps err * d^(-beta) in registers and exchanges t the same
//     way through a second buffer.  16 KB of shared memory a block.
//   - The blocks are persistent (as many as the SMs hold at once), each
//     walking tiles a grid apart, and each thread issues the loads of its
//     next tile before it computes the current one, so loads stay in
//     flight through the compute, the barriers and the stores.  (A ring of
//     cp.async copies three tiles ahead kept more bytes in flight and ran
//     2-8 % slower on an H100: in flight is not what limits these kernels.)
//   - AlexNet's n = 5 is a template argument, its halos in registers; any
//     other n slides a window of V terms through registers, one channel a
//     tap, reading each new term from the staged values.  Both add the
//     terms of the plain version's padded sliding sum in its order, so the
//     sums have its bits.  (On an H100, n = 5 through the sliding window
//     took 1.6-1.8x the template's time at AlexNet's shapes, so the
//     template stays.)
// The general kernels take what the vector kernels do not (C not a multiple
// of 8, C over 2048, a pointer off 16 bytes; the rule is lrn_route in
// ops/fused_kernels.py): a block stages a contiguous run of whole rows in
// shared memory as f32 and takes every window sum from there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_VALUES = 4096;  // values a general block stages
constexpr int V = 8;               // channels a vector-kernel thread owns
constexpr int VEC_MAX_C = V * THREADS;

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

// ---------------------------------------------------------------------
// the vector kernels
// ---------------------------------------------------------------------

// V values of T as they arrive from device memory: a load fills the
// registers and nothing waits on it until unpack
template <typename T>
struct Raw;
template <>
struct Raw<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void unpack(float (&v)[V]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&v)[V]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};
template <>
struct Raw<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void unpack(float (&v)[V]) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[V]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

struct VecGeometry {
  long long rows, tiles;
  int c, n, vectors, rows_per_tile;  // vectors: V-channel vectors a row
  int lo, hi;                        // the forward window [i - lo, i + hi]
  float alpha, beta, k, coef;        // coef = 2 alpha beta
};

// channel c0 + o of the thread's row from the tile's values in shared
// memory (element e of vector v at s[e * THREADS + v], the thread's vector
// vec holding c0 .. c0 + V - 1), or 0 outside [0, c); only the edge on o's
// side is checked, as c0 + o lies in [0, c) for o in [0, V)
__device__ __forceinline__ float staged(const float* s, int vec, int c0,
                                        int c, int o) {
  static_assert(V == 8, "vector and element of a channel by shift and mask");
  float v = 0.f;
  if (o < 0 ? c0 + o >= 0 : c0 + o < c)
    v = s[(o & 7) * THREADS + vec + (o >> 3)];
  return v;
}

// sum[i] = the sum over the window [c0 + i - LO, c0 + i + HI] in channel
// order, for the thread's V channels (their values in own, the halos
// staged).  Tap by tap, all V sums at once, so that a halo value lives from
// its first use to its last, a few taps apart.
template <int LO, int HI>
__device__ __forceinline__ void window_sums(float (&sum)[V],
                                            const float (&own)[V],
                                            const float* s, int vec, int c0,
                                            int c) {
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = 0.f;
#pragma unroll
  for (int j = -LO; j <= HI; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int o = i + j;
      sum[i] = __fadd_rn(sum[i], o >= 0 && o < V ? own[o]
                                                 : staged(s, vec, c0, c, o));
    }
}

// the same sums over any window [i - lo, i + hi]: the variant for the n
// that are no template argument.  w holds the V terms of tap j in
// registers; each tap slides it by one channel and reads the one new term
// from s, so a window of n taps reads V + n staged values, not V * n.
__device__ __forceinline__ void window_sums(float (&sum)[V], const float* s,
                                            int vec, int c0, int c, int lo,
                                            int hi) {
  float w[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sum[i] = 0.f;
    w[i] = staged(s, vec, c0, c, i - lo);
  }
  for (int j = -lo; j <= hi; ++j) {
#pragma unroll
    for (int i = 0; i < V; ++i) sum[i] = __fadd_rn(sum[i], w[i]);
#pragma unroll
    for (int i = 0; i < V - 1; ++i) w[i] = w[i + 1];
    w[V - 1] = staged(s, vec, c0, c, V + j);
  }
}

// the forward window's (adjoint's when ADJ) sums for variant N: its halos
// in registers for N = n, every term from s for N = 0 (any n)
template <int N, bool ADJ>
__device__ __forceinline__ void lrn_window(float (&sum)[V],
                                           const float (&own)[V],
                                           const float* s, int vec, int c0,
                                           const VecGeometry& g) {
  constexpr int LO = N / 2, HI = N ? N - 1 - N / 2 : 0;
  if constexpr (N == 0)
    window_sums(sum, s, vec, c0, g.c, ADJ ? g.hi : g.lo, ADJ ? g.lo : g.hi);
  else
    window_sums<ADJ ? HI : LO, ADJ ? LO : HI>(sum, own, s, vec, c0, g.c);
}

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
    lrn_fwd_vec_kernel(const T* __restrict__ x, T* __restrict__ y,
                       VecGeometry g) {
  __shared__ float s_sq[2][V * THREADS];  // two, so one barrier a tile
  const int vec = threadIdx.x;
  const int r = vec / g.vectors;  // the thread's row in every tile
  const int c0 = (vec - r * g.vectors) * V;
  const long long step = static_cast<long long>(g.rows_per_tile) * g.c;
  const long long own = static_cast<long long>(vec) * V;
  auto holds = [&](long long tile) {
    return r < g.rows_per_tile && tile < g.tiles &&
           tile * g.rows_per_tile + r < g.rows;
  };
  long long tile = blockIdx.x;
  Raw<T> next;
  bool next_ok = holds(tile);
  if (next_ok) next.load(x + tile * step + own);
  for (int buf = 0; tile < g.tiles; tile += gridDim.x, buf ^= 1) {
    const Raw<T> cur = next;
    const bool ok = next_ok;
    next_ok = holds(tile + gridDim.x);
    if (next_ok) next.load(x + (tile + gridDim.x) * step + own);
    float xv[V], sq[V];
    cur.unpack(xv);
    float* s = s_sq[buf];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sq[i] = __fmul_rn(xv[i], xv[i]);
      if (ok) s[i * THREADS + vec] = sq[i];
    }
    __syncthreads();
    if (!ok) continue;
    float sum[V];
    lrn_window<N, false>(sum, sq, s, vec, c0, g);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = __fadd_rn(g.k, __fmul_rn(g.alpha, sum[i]));
      sum[i] = __fmul_rn(xv[i], pow_neg(d, g.beta));
    }
    Raw<T>::store(y + tile * step + own, sum);
  }
}

template <typename TX, typename TE, int N>
__global__ void __launch_bounds__(THREADS)
    lrn_bwd_vec_kernel(const TX* __restrict__ x, const TE* __restrict__ err,
                       TE* __restrict__ dx, VecGeometry g) {
  __shared__ float s_sq[V * THREADS];
  __shared__ float s_t[V * THREADS];
  const int vec = threadIdx.x;
  const int r = vec / g.vectors;
  const int c0 = (vec - r * g.vectors) * V;
  const long long step = static_cast<long long>(g.rows_per_tile) * g.c;
  const long long own = static_cast<long long>(vec) * V;
  auto holds = [&](long long tile) {
    return r < g.rows_per_tile && tile < g.tiles &&
           tile * g.rows_per_tile + r < g.rows;
  };
  long long tile = blockIdx.x;
  Raw<TX> next_x;
  Raw<TE> next_e;
  bool next_ok = holds(tile);
  if (next_ok) {
    next_x.load(x + tile * step + own);
    next_e.load(err + tile * step + own);
  }
  for (; tile < g.tiles; tile += gridDim.x) {
    const Raw<TX> cur_x = next_x;
    const Raw<TE> cur_e = next_e;
    const bool ok = next_ok;
    next_ok = holds(tile + gridDim.x);
    if (next_ok) {
      next_x.load(x + (tile + gridDim.x) * step + own);
      next_e.load(err + (tile + gridDim.x) * step + own);
    }
    float xv[V], sq[V];
    cur_x.unpack(xv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sq[i] = __fmul_rn(xv[i], xv[i]);
      if (ok) s_sq[i * THREADS + vec] = sq[i];
    }
    __syncthreads();  // squares staged; the last tile's t all read
    float ev[V];
    if (ok) {
      cur_e.unpack(ev);
      float sum[V];
      lrn_window<N, false>(sum, sq, s_sq, vec, c0, g);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = __fadd_rn(g.k, __fmul_rn(g.alpha, sum[i]));
        const float p = pow_neg(d, g.beta);
        s_t[i * THREADS + vec] = __fmul_rn(__fmul_rn(ev[i], xv[i]), p / d);
        ev[i] = __fmul_rn(ev[i], p);  // err * d^(-beta), kept
      }
    }
    __syncthreads();  // t staged; the squares all read
    if (!ok) continue;
    // the thread's own t read back, not kept in registers over the barrier
    float t[V], adj[V];  // adj: the adjoint window [i - hi, i + lo]
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = s_t[i * THREADS + vec];
    lrn_window<N, true>(adj, t, s_t, vec, c0, g);
#pragma unroll
    for (int i = 0; i < V; ++i)
      adj[i] = __fsub_rn(ev[i], __fmul_rn(__fmul_rn(g.coef, xv[i]), adj[i]));
    Raw<TE>::store(dx + tile * step + own, adj);
  }
}

VecGeometry make_vec_geometry(long long rows, int c, int n, float alpha,
                              float beta, float k) {
  VecGeometry g;
  g.rows = rows;
  g.c = c;
  g.n = n;
  g.vectors = c / V;
  g.rows_per_tile = THREADS / g.vectors;
  g.tiles = (rows + g.rows_per_tile - 1) / g.rows_per_tile;
  g.lo = n / 2;
  g.hi = n - 1 - n / 2;
  g.alpha = alpha;
  g.beta = beta;
  g.k = k;
  g.coef = 2.f * alpha * beta;
  return g;
}

bool vec_takes(int c, int n, const void* a, const void* b, const void* z) {
  const auto off = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  return c % V == 0 && c <= VEC_MAX_C && n >= 1 &&
         !off(a) && !off(b) && !off(z);
}

// the blocks of Kernel that the current device holds at once; the runtime
// is asked once a device, as the answer never changes
template <auto Kernel>
cudaError_t resident_blocks(int* blocks) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::atomic<int>* slot = dev < kDevices ? &known[dev] : nullptr;
  if (slot && (*blocks = slot->load(std::memory_order_relaxed)) > 0)
    return cudaSuccess;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      THREADS, 0);
  if (e != cudaSuccess) return e;
  *blocks = sms * per_sm;
  if (slot) slot->store(*blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

// a persistent grid: as many blocks as the card holds at once, at most one
// a tile
template <auto Kernel, typename... Args>
cudaError_t launch_vec(const VecGeometry& g, cudaStream_t stream,
                       Args... args) {
  int resident = 0;
  const cudaError_t e = resident_blocks<Kernel>(&resident);
  if (e != cudaSuccess) return e;
  const long long blocks = g.tiles < resident ? g.tiles : resident;
  Kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(args..., g);
  return cudaGetLastError();
}

template <typename T>
int fwd_vec(const void* x, void* y, const VecGeometry& g, cudaStream_t s) {
  const T* px = static_cast<const T*>(x);
  T* py = static_cast<T*>(y);
  if (g.n == 5) return launch_vec<lrn_fwd_vec_kernel<T, 5>>(g, s, px, py);
  return launch_vec<lrn_fwd_vec_kernel<T, 0>>(g, s, px, py);
}

template <typename TX, typename TE>
int bwd_vec(const void* x, const void* err, void* dx, const VecGeometry& g,
            cudaStream_t s) {
  const TX* px = static_cast<const TX*>(x);
  const TE* pe = static_cast<const TE*>(err);
  TE* pd = static_cast<TE*>(dx);
  if (g.n == 5)
    return launch_vec<lrn_bwd_vec_kernel<TX, TE, 5>>(g, s, px, pe, pd);
  return launch_vec<lrn_bwd_vec_kernel<TX, TE, 0>>(g, s, px, pe, pd);
}

// ---------------------------------------------------------------------
// the general kernels
// ---------------------------------------------------------------------

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

template <typename TX, typename TE>
int bwd(const void* x, const void* err, void* dx, const Geometry& g,
        cudaStream_t s) {
  return static_cast<int>(launch(lrn_bwd_kernel<TX, TE>, 3, g, s,
                                 static_cast<const TX*>(x),
                                 static_cast<const TE*>(err),
                                 static_cast<TE*>(dx)));
}

}  // namespace

// The general route.  x and y: contiguous (rows, c), dtype 0 = f32, 1 =
// bf16 (both the same).  Returns the launch's cudaError_t (0 on success);
// the caller checks shapes, dtypes and c <= 16384 (the staged rows must fit
// shared memory).
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

// The general route.  x, err and dx: contiguous (rows, c); x_dtype and
// err_dtype each 0 = f32, 1 = bf16; dx has err's dtype.
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

// The vector route: the arguments of znicz_lrn_fwd, with c a multiple of 8
// up to 2048 and both pointers on 16-byte boundaries (cudaErrorInvalidValue
// otherwise).
extern "C" int znicz_lrn_fwd_vec(const void* x, void* y, long long rows,
                                 int c, int n, float alpha, float beta,
                                 float k, int dtype, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  if (!vec_takes(c, n, x, y, y)) return cudaErrorInvalidValue;
  const VecGeometry g = make_vec_geometry(rows, c, n, alpha, beta, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? fwd_vec<float>(x, y, g, s)
                    : fwd_vec<__nv_bfloat16>(x, y, g, s);
}

// The vector route: the arguments of znicz_lrn_bwd, with the conditions of
// znicz_lrn_fwd_vec on c and all three pointers.
extern "C" int znicz_lrn_bwd_vec(const void* x, const void* err, void* dx,
                                 long long rows, int c, int n, float alpha,
                                 float beta, float k, int x_dtype,
                                 int err_dtype, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  if (!vec_takes(c, n, x, err, dx)) return cudaErrorInvalidValue;
  const VecGeometry g = make_vec_geometry(rows, c, n, alpha, beta, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && err_dtype == 0)
    return bwd_vec<float, float>(x, err, dx, g, s);
  if (x_dtype == 0) return bwd_vec<float, __nv_bfloat16>(x, err, dx, g, s);
  if (err_dtype == 0) return bwd_vec<__nv_bfloat16, float>(x, err, dx, g, s);
  return bwd_vec<__nv_bfloat16, __nv_bfloat16>(x, err, dx, g, s);
}
