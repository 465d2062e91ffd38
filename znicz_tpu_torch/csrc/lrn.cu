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
// ops/fused_kernels.py), at any C and any n:
//   - The (rows, C) array is seen as one run of rows * C elements, and a
//     block owns the tile of GEN_TILE consecutive elements tile * GEN_TILE
//     on (4 a thread, neighbouring threads on neighbouring elements), which
//     may hold many short rows or a piece of a long one.
//   - An element's window is cut to its own row: it never wraps into the
//     next row and stops at both row ends.  The windows of a tile reach a
//     range of elements from lo before its first element to hi after its
//     last, cut to the rows of those two elements; the block stages that
//     range's squares in shared memory, GEN_STAGE values at a time, and
//     each thread adds the staged terms of its elements' windows in channel
//     order, chunk after chunk, so a halo of any width (n up to the row and
//     beyond) passes through a fixed 8 KB buffer.  With AlexNet's n a tile's
//     range is one chunk.
//   - The backward needs t over the adjoint windows of its tile, and each t
//     its own forward window: the block walks the adjoint range a chunk at a
//     time, stages the squares that chunk's forward windows reach (chunk by
//     chunk again), computes the chunk's t and d^(-beta) into shared memory,
//     and adds the chunk's terms to its elements' adjoint sums.
//   - Every sum adds the plain version's terms in its order, from 0: the
//     general kernels give the plain version's bits but for the card's
//     rsqrt/sqrt/pow.

#include "rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int V = 8;  // channels a vector-kernel thread owns
constexpr int VEC_MAX_C = V * THREADS;
constexpr int GEN_PER = 4;                   // elements a general thread owns
constexpr int GEN_TILE = GEN_PER * THREADS;  // elements a general block owns
constexpr int GEN_STAGE = 2048;              // values a staging buffer holds

// d^(-beta): AlexNet's beta = 0.75 as rsqrt(d * sqrt(d)), as the
// reference's XLA path computes it; powf otherwise
__device__ __forceinline__ float pow_neg(float d, float beta) {
  return beta == 0.75f ? rsqrtf(d * sqrtf(d)) : powf(d, -beta);
}

// ---------------------------------------------------------------------
// the vector kernels
// ---------------------------------------------------------------------

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
  Raw8<T> next;
  bool next_ok = holds(tile);
  if (next_ok) next.load(x + tile * step + own);
  for (int buf = 0; tile < g.tiles; tile += gridDim.x, buf ^= 1) {
    const Raw8<T> cur = next;
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
    store8(y + tile * step + own, sum);
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
  Raw8<TX> next_x;
  Raw8<TE> next_e;
  bool next_ok = holds(tile);
  if (next_ok) {
    next_x.load(x + tile * step + own);
    next_e.load(err + tile * step + own);
  }
  for (; tile < g.tiles; tile += gridDim.x) {
    const Raw8<TX> cur_x = next_x;
    const Raw8<TE> cur_e = next_e;
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
    store8(dx + tile * step + own, adj);
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

// a persistent grid: as many blocks as the card holds at once, at most one
// a tile
template <auto Kernel, typename... Args>
cudaError_t launch_vec(const VecGeometry& g, cudaStream_t stream,
                       Args... args) {
  int resident = 0;
  const cudaError_t e = resident_blocks<Kernel, THREADS>(&resident);
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

struct Geometry {
  long long count, tiles;  // rows * c elements, in tiles of GEN_TILE
  int c;
  long long lo, hi;        // the forward window [i - lo, i + hi]
  float alpha, beta, k, coef;
};

// [a, z]: the elements the windows [e - lo, e + hi] of the elements
// e0 <= e <= e1 reach, each cut to the row of its element
__device__ __forceinline__ void reach(long long e0, long long e1, int c,
                                      long long lo, long long hi,
                                      long long& a, long long& z) {
  const long long first = e0 / c * c, last = e1 / c * c + c - 1;
  a = e0 - lo > first ? e0 - lo : first;
  z = e1 + hi < last ? e1 + hi : last;
}

// sum += the staged terms s[j - base] of element e's window [e - lo,
// e + hi] cut to its row, j in channel order over the part of it in the
// chunk [base, base + len)
__device__ __forceinline__ void add_staged(float& sum, const float* s,
                                           long long base, int len,
                                           long long e, int c, long long lo,
                                           long long hi) {
  long long wa, wz;
  reach(e, e, c, lo, hi, wa, wz);
  const long long j0 = wa > base ? wa - base : 0;
  const long long j1 = wz < base + len - 1 ? wz - base : len - 1;
  for (long long j = j0; j <= j1; ++j) sum = __fadd_rn(sum, s[j]);
}

// stage the squares of x over [base, base + len) into s (len <= GEN_STAGE)
template <typename T>
__device__ __forceinline__ void stage_squares(float* s, const T* x,
                                              long long base, int len) {
  for (int i = threadIdx.x; i < len; i += THREADS) {
    const float v = to_f32(x[base + i]);
    s[i] = __fmul_rn(v, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, Geometry g) {
  __shared__ float s_sq[GEN_STAGE];
  const long long e0 = blockIdx.x * static_cast<long long>(GEN_TILE);
  const long long e1 =
      (e0 + GEN_TILE < g.count ? e0 + GEN_TILE : g.count) - 1;
  float sum[GEN_PER] = {};
  long long a, z;
  reach(e0, e1, g.c, g.lo, g.hi, a, z);
  for (long long base = a; base <= z; base += GEN_STAGE) {
    const int len = static_cast<int>(z - base + 1 < GEN_STAGE ? z - base + 1
                                                              : GEN_STAGE);
    __syncthreads();  // the last chunk is read
    stage_squares(s_sq, x, base, len);
    __syncthreads();
#pragma unroll
    for (int p = 0; p < GEN_PER; ++p) {
      const long long e = e0 + p * THREADS + threadIdx.x;
      if (e <= e1) add_staged(sum[p], s_sq, base, len, e, g.c, g.lo, g.hi);
    }
  }
#pragma unroll
  for (int p = 0; p < GEN_PER; ++p) {
    const long long e = e0 + p * THREADS + threadIdx.x;
    if (e > e1) continue;
    const float d = __fadd_rn(g.k, __fmul_rn(g.alpha, sum[p]));
    y[e] = from_f32<T>(__fmul_rn(to_f32(x[e]), pow_neg(d, g.beta)));
  }
}

//: adjoint-range elements a thread computes t for in one chunk
constexpr int GEN_T_PER = GEN_STAGE / THREADS;

template <typename TX, typename TE>
__global__ void __launch_bounds__(THREADS)
    lrn_bwd_kernel(const TX* __restrict__ x, const TE* __restrict__ err,
                   TE* __restrict__ dx, Geometry g) {
  __shared__ float s_sq[GEN_STAGE];  // squares of x, a chunk
  __shared__ float s_t[GEN_STAGE];   // t = err * x * d^(-beta - 1), a chunk
  __shared__ float s_p[GEN_STAGE];   // d^(-beta), the same chunk
  const long long e0 = blockIdx.x * static_cast<long long>(GEN_TILE);
  const long long e1 =
      (e0 + GEN_TILE < g.count ? e0 + GEN_TILE : g.count) - 1;
  // each element's adjoint sum, over [e - hi, e + lo], and its d^(-beta)
  float adj[GEN_PER] = {}, pv[GEN_PER] = {};
  long long ta, tz;
  reach(e0, e1, g.c, g.hi, g.lo, ta, tz);
  for (long long tb = ta; tb <= tz; tb += GEN_STAGE) {
    const int tlen = static_cast<int>(tz - tb + 1 < GEN_STAGE ? tz - tb + 1
                                                              : GEN_STAGE);
    // the forward sums of the chunk's elements j = tb + q * THREADS + tid
    float fs[GEN_T_PER] = {};
    long long a, z;
    reach(tb, tb + tlen - 1, g.c, g.lo, g.hi, a, z);
    for (long long base = a; base <= z; base += GEN_STAGE) {
      const int len = static_cast<int>(z - base + 1 < GEN_STAGE
                                           ? z - base + 1
                                           : GEN_STAGE);
      __syncthreads();  // the last chunk of squares, and of t, is read
      stage_squares(s_sq, x, base, len);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < GEN_T_PER; ++q) {
        const int i = q * THREADS + threadIdx.x;
        if (i < tlen)
          add_staged(fs[q], s_sq, base, len, tb + i, g.c, g.lo, g.hi);
      }
    }
#pragma unroll
    for (int q = 0; q < GEN_T_PER; ++q) {
      const int i = q * THREADS + threadIdx.x;
      if (i >= tlen) continue;
      const float xj = to_f32(x[tb + i]), ej = to_f32(err[tb + i]);
      const float d = __fadd_rn(g.k, __fmul_rn(g.alpha, fs[q]));
      const float p = pow_neg(d, g.beta);
      s_t[i] = __fmul_rn(__fmul_rn(ej, xj), p / d);
      s_p[i] = p;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < GEN_PER; ++p) {
      const long long e = e0 + p * THREADS + threadIdx.x;
      if (e > e1) continue;
      add_staged(adj[p], s_t, tb, tlen, e, g.c, g.hi, g.lo);
      if (e >= tb && e < tb + tlen) pv[p] = s_p[e - tb];
    }
  }
#pragma unroll
  for (int p = 0; p < GEN_PER; ++p) {
    const long long e = e0 + p * THREADS + threadIdx.x;
    if (e > e1) continue;
    const float xv = to_f32(x[e]), ev = to_f32(err[e]);
    dx[e] = from_f32<TE>(__fsub_rn(__fmul_rn(ev, pv[p]),
                                   __fmul_rn(__fmul_rn(g.coef, xv),
                                             adj[p])));
  }
}

Geometry make_geometry(long long rows, int c, int n, float alpha, float beta,
                       float k) {
  Geometry g;
  g.count = rows * c;
  g.tiles = (g.count + GEN_TILE - 1) / GEN_TILE;
  g.c = c;
  g.lo = n / 2;
  g.hi = n - 1 - n / 2;
  g.alpha = alpha;
  g.beta = beta;
  g.k = k;
  g.coef = 2.f * alpha * beta;
  return g;
}

// a block a tile
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Geometry& g, cudaStream_t stream,
           Args... args) {
  kernel<<<static_cast<unsigned>(g.tiles), THREADS, 0, stream>>>(args..., g);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TE>
int bwd(const void* x, const void* err, void* dx, const Geometry& g,
        cudaStream_t s) {
  return launch(lrn_bwd_kernel<TX, TE>, g, s, static_cast<const TX*>(x),
                static_cast<const TE*>(err), static_cast<TE*>(dx));
}

}  // namespace

// The general route.  x and y: contiguous (rows, c), dtype 0 = f32, 1 =
// bf16 (both the same); any c >= 1 and n >= 1.  Returns the launch's
// cudaError_t (0 on success); the caller checks shapes and dtypes.
extern "C" int znicz_lrn_fwd(const void* x, void* y, long long rows, int c,
                             int n, float alpha, float beta, float k,
                             int dtype, void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  if (n < 1) return cudaErrorInvalidValue;
  const Geometry g = make_geometry(rows, c, n, alpha, beta, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch(lrn_fwd_kernel<float>, g, s, static_cast<const float*>(x),
                  static_cast<float*>(y));
  }
  return launch(lrn_fwd_kernel<__nv_bfloat16>, g, s,
                static_cast<const __nv_bfloat16*>(x),
                static_cast<__nv_bfloat16*>(y));
}

// The general route.  x, err and dx: contiguous (rows, c); x_dtype and
// err_dtype each 0 = f32, 1 = bf16; dx has err's dtype.
extern "C" int znicz_lrn_bwd(const void* x, const void* err, void* dx,
                             long long rows, int c, int n, float alpha,
                             float beta, float k, int x_dtype, int err_dtype,
                             void* stream) {
  if (rows <= 0 || c <= 0) return cudaSuccess;
  if (n < 1) return cudaErrorInvalidValue;
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
