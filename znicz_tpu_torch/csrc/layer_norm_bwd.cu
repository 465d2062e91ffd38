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
// below the H100's ~295 FLOP/byte ridge: device-memory bandwidth bounds it,
// and the design is about keeping device memory busy.
//
// The cross-row sums: the TPU kernel walks its row tiles in order and
// carries the sums in scratch memory.  Hopper blocks run in no order, so
// each block owns a fixed, contiguous range of rows and writes one row of
// an f32 workspace (n_blocks, D) per sum; a second kernel folds the
// workspace over blocks.  The ranges depend on M and constants only, never
// on the card, and every sum runs in an order they fix; no atomics: a
// rerun gives the same bits.  Rows past M are never read (the counterpart
// of the reference's tail-tile guard).
//
// The register kernels (the route rows with D % 8 == 0 up to 1024, on
// 16-byte boundaries, take; the rule is layer_norm_route in
// ops/fused_kernels.py):
//   - A warp owns a row and holds it in registers: lane l takes the
//     8-element vectors l, l + 32, ... of x and err (16 elements of each a
//     lane at D = 512) through 128-bit loads.  The mean, the centred
//     variance, mean(dxhat) and mean(dxhat * (x - mu)) come from the
//     registers (two passes over them, as the reference), and dx leaves
//     through 128-bit stores: x and err are read once, dx written once.
//   - Each lane loads its gamma columns once, for all its rows.
//   - A lane owns the same columns in every row it takes, so it keeps their
//     err * xhat and err partial sums in registers across the rows.  They
//     touch shared memory once, at the end: each warp writes its row of
//     partials, and the block folds them in warp order into its workspace
//     row (gamma's sums, then beta's, through one 8-row buffer).
//   - 8 warps a block, warp w taking rows row0 + w, row0 + w + 8, ... of
//     its block's range, and each warp starts its next row's loads before
//     it computes the current one (where the registers hold two rows: every
//     width in bf16, up to 512 otherwise).  At most REG_BLOCKS = 264
//     blocks: one wave at the bf16 kernel's occupancy on an H100 (2 blocks
//     an SM at 126 registers), two at the f32 kernel's (1 at 149).
//   - The fold over blocks is parallel: a block a sum and 32 columns, its
//     32 warps each adding a fixed contiguous range of at most 9 workspace
//     rows in order (all their loads in flight at once), then the 32
//     results in warp order.
// The general kernels take the rest (D not a multiple of 8 or over 1024, a
// pointer off 16 bytes), any row count and any width: one warp per row.  A
// block takes its rows in groups of 32: the statistics of a group's rows
// (two passes over each row) go to shared memory, then the block walks the
// columns in chunks of 512, each warp computing dx of its rows over the
// chunk and adding their terms into its own shared row of partial sums; the
// block folds its warps' rows in warp order into its workspace row (written
// by the first group, added to by the later ones in group order), and the
// fold over blocks runs in block order, a thread a column.  So shared
// memory holds 32 KB whatever the width, and the block count (at most
// 1024, and at most 2^23 workspace floats) depends on M and D only.  Its
// vector path needs D % 8 == 0 and 16-byte alignment, its scalar path
// takes the rest.

#include "rows.cuh"

namespace {

constexpr int MAX_WARPS = 8;
constexpr int GEN_THREADS = MAX_WARPS * 32;
//: columns whose partial sums a block holds in shared memory at once
constexpr int GEN_CHUNK = 512;
//: rows whose statistics a block holds at once (4 a warp)
constexpr int GEN_GROUP = 32;
//: the most blocks, and the most workspace floats: the rows a block owns
//: depend on M, D and these constants only, never on the card
constexpr int MAX_BLOCKS = 1024;
constexpr long long GEN_WORK_FLOATS = 1LL << 23;
constexpr int FOLD_THREADS = 256;

// 8 consecutive shared-memory floats += v (two 16-byte accesses)
__device__ __forceinline__ void add8(float* p, const float v[8]) {
  float4* q = reinterpret_cast<float4*>(p);
  float4 a = q[0], b = q[1];
  a.x += v[0]; a.y += v[1]; a.z += v[2]; a.w += v[3];
  b.x += v[4]; b.y += v[5]; b.z += v[6]; b.w += v[7];
  q[0] = a;
  q[1] = b;
}

// One block: 8 warps over rows [row0, row1), in groups of GEN_GROUP rows.
// For each group: warp w computes the statistics of the group's rows w,
// w + 8, ... (passes 1 and 2 over the whole row) into shared memory; then,
// a chunk of GEN_CHUNK columns at a time, each warp computes dx of its
// rows over the chunk (pass 3) and adds their err * xhat and err terms
// into its own shared row of partial sums, row by row; the block folds its
// warps' rows in warp order and writes the chunk of its workspace row (the
// first group) or adds to it (the later ones, in group order).  Every
// column belongs to one lane of a warp, so no two threads touch one
// address between barriers.  The bound of 2 blocks an SM lets ptxas take
// the registers the kernel needs: without it, it held the vector path to
// 48 and spilled.
template <typename TX, typename TE, bool VEC>
__global__ void __launch_bounds__(GEN_THREADS, 2)
    ln_bwd_rows_kernel(const TX* __restrict__ x, const TE* __restrict__ err,
                       const float* __restrict__ gamma, TE* __restrict__ dx,
                       float* __restrict__ work_g, float* __restrict__ work_b,
                       long long m, int d, long long rows_per_block,
                       float eps) {
  __shared__ __align__(16) float acc[2][MAX_WARPS][GEN_CHUNK];
  // mu, rstd, mean(dxhat), mean(dxhat * xhat) of the group's rows
  __shared__ float4 stats[GEN_GROUP];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool has_beta = work_b != nullptr;
  float* acc_g = acc[0][warp];
  float* acc_b = acc[1][warp];
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long row1 = row0 + rows_per_block;
  if (row1 > m) row1 = m;
  const float inv_d = 1.0f / static_cast<float>(d);
  float* wg = work_g + static_cast<long long>(blockIdx.x) * d;
  float* wb = has_beta ? work_b + static_cast<long long>(blockIdx.x) * d
                       : nullptr;

  for (long long g0 = row0; g0 < row1; g0 += GEN_GROUP) {
    const int rows = static_cast<int>(
        row1 - g0 < GEN_GROUP ? row1 - g0 : GEN_GROUP);
    for (int r = warp; r < rows; r += MAX_WARPS) {
      const TX* xr = x + (g0 + r) * d;
      const TE* er = err + (g0 + r) * d;
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
      if (lane == 0)
        stats[r] = make_float4(mu, rstd, mean_dxhat, mean_dxhat_xhat);
    }
    __syncthreads();

    // pass 3, a chunk of columns at a time
    for (int c0 = 0; c0 < d; c0 += GEN_CHUNK) {
      const int cols = d - c0 < GEN_CHUNK ? d - c0 : GEN_CHUNK;
      if (VEC) {
        for (int i = lane * 8; i < cols; i += 32 * 8)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc_g[i + j] = acc_b[i + j] = 0.f;
      } else {
        for (int i = lane; i < cols; i += 32) acc_g[i] = acc_b[i] = 0.f;
      }
      for (int r = warp; r < rows; r += MAX_WARPS) {
        const float4 st = stats[r];  // mu, rstd, mean_dxhat, mean_dxhat_xhat
        const TX* xr = x + (g0 + r) * d + c0;
        const TE* er = err + (g0 + r) * d + c0;
        TE* dr = dx + (g0 + r) * d + c0;
        const float* gr = gamma + c0;
        if (VEC) {
          for (int i = lane * 8; i < cols; i += 32 * 8) {
            float v[8], e[8], out[8];
            load8(xr + i, v);
            load8(er + i, e);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              v[j] = (v[j] - st.x) * st.y;  // xhat
              out[j] = (e[j] * gr[i + j] - st.z - v[j] * st.w) * st.y;
            }
            store8(dr + i, out);
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = e[j] * v[j];  // err * xhat
            add8(acc_g + i, v);
            if (has_beta) add8(acc_b + i, e);
          }
        } else {
          for (int i = lane; i < cols; i += 32) {
            const float e = to_f32(er[i]);
            const float xhat = (to_f32(xr[i]) - st.x) * st.y;
            const float g = e * gr[i];
            dr[i] = from_f32<TE>((g - st.z - xhat * st.w) * st.y);
            acc_g[i] += e * xhat;
            if (has_beta) acc_b[i] += e;
          }
        }
      }
      __syncthreads();
      // fold this block's warps in warp order into its workspace row
      for (int c = threadIdx.x; c < cols; c += GEN_THREADS) {
        float g = 0.f, b = 0.f;
        for (int w = 0; w < MAX_WARPS; ++w) {
          g += acc[0][w][c];
          if (has_beta) b += acc[1][w][c];
        }
        if (g0 == row0) {
          wg[c0 + c] = g;
          if (has_beta) wb[c0 + c] = b;
        } else {
          wg[c0 + c] += g;
          if (has_beta) wb[c0 + c] += b;
        }
      }
      __syncthreads();  // the partial rows and the statistics are read
    }
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

// the general kernel's blocks (workspace rows) for m rows of width d, and
// the rows each owns: a warp's row or more a block, at most MAX_BLOCKS, and
// at most GEN_WORK_FLOATS floats of workspace
long long gen_blocks(long long m, int d, bool has_beta,
                     long long* rows_per_block) {
  *rows_per_block = 0;
  if (m <= 0 || d <= 0) return 0;
  long long n = (m + MAX_WARPS - 1) / MAX_WARPS;
  if (n > MAX_BLOCKS) n = MAX_BLOCKS;
  const long long fit = GEN_WORK_FLOATS / (static_cast<long long>(d) *
                                           (has_beta ? 2 : 1));
  if (n > fit) n = fit > 0 ? fit : 1;
  *rows_per_block = (m + n - 1) / n;
  return (m + *rows_per_block - 1) / *rows_per_block;
}

template <typename TX, typename TE>
cudaError_t launch(const void* x, const void* err, const float* gamma,
                   void* dx, float* grad_g, float* grad_b, float* work,
                   long long m, int d, float eps, int vec,
                   cudaStream_t stream) {
  const bool has_beta = grad_b != nullptr;
  long long rows_per_block = 0;
  const long long n_blocks = gen_blocks(m, d, has_beta, &rows_per_block);
  float* work_b = has_beta ? work + n_blocks * d : nullptr;
  if (n_blocks > 0) {
    auto kernel = vec ? ln_bwd_rows_kernel<TX, TE, true>
                      : ln_bwd_rows_kernel<TX, TE, false>;
    kernel<<<static_cast<unsigned>(n_blocks), GEN_THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TE*>(err), gamma,
        static_cast<TE*>(dx), work, work_b, m, d, rows_per_block, eps);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  ln_bwd_fold_kernel<<<(d + FOLD_THREADS - 1) / FOLD_THREADS, FOLD_THREADS, 0,
                       stream>>>(work, work_b, grad_g, grad_b,
                                 static_cast<int>(n_blocks), d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// the register kernels
// ---------------------------------------------------------------------

constexpr int REG_WARPS = 8;
constexpr int REG_THREADS = REG_WARPS * 32;
//: 8-element vectors a lane holds at most: rows of up to 32 * 8 *
//: REG_MAX_NV = 1024 elements
constexpr int REG_MAX_NV = 4;
//: the most blocks of the register kernel, so the most workspace rows: two
//: blocks on each of an H100's 132 SMs, one wave at the occupancy the bf16
//: kernel has, two at the f32 kernel's.  The rows a block owns depend on M
//: and this constant only, never on the card, so neither do the bits.
constexpr int REG_BLOCKS = 264;
//: the fold over blocks: 32 warps a block, each adding at most
//: ceil(REG_BLOCKS / FOLD_WARPS) = 9 workspace rows, all loads in flight
constexpr int FOLD_WARPS = 32;
constexpr int FOLD_BATCH = 16;

// Whether the registers hold a second row of x and err in flight: every
// width in bf16, up to 512 (NV = 2) with an f32 operand.
template <typename TX, typename TE, int NV>
__host__ __device__ constexpr bool reg_prefetch() {
  return NV * (sizeof(TX) + sizeof(TE)) <= 16;
}

// the three row sums of the backward over the warp, their butterflies
// interleaved (each the bits of warp_sum)
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ta = __shfl_xor_sync(0xffffffffu, a, off);
    const float tb = __shfl_xor_sync(0xffffffffu, b, off);
    const float tc = __shfl_xor_sync(0xffffffffu, c, off);
    a += ta;
    b += tb;
    c += tc;
  }
}

// start the loads of the lane's vectors of row r of x and err
template <typename TX, typename TE, int NV>
__device__ __forceinline__ void load_row(Raw8<TX> (&nx)[NV],
                                         Raw8<TE> (&ne)[NV],
                                         const bool (&own)[NV],
                                         const TX* x, const TE* err,
                                         long long r, int d, int lane) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (own[k]) {
      nx[k].load(x + r * d + (lane + 32 * k) * 8);
      ne[k].load(err + r * d + (lane + 32 * k) * 8);
    }
}

// One block: REG_WARPS warps over rows [row0, row1), warp w taking rows
// row0 + w, row0 + w + REG_WARPS, ...; lane l holds vectors l + 32 k
// (k < NV, those below d / 8) of each.  Every sum runs in a fixed order:
// within a row a lane adds vector by vector, element by element, then the
// butterfly; a column partial adds the warp's rows in order; the block
// adds its warps' partials in warp order.
template <typename TX, typename TE, int NV>
__global__ void __launch_bounds__(REG_THREADS)
    ln_bwd_reg_kernel(const TX* __restrict__ x, const TE* __restrict__ err,
                      const float* __restrict__ gamma, TE* __restrict__ dx,
                      float* __restrict__ work_g, float* __restrict__ work_b,
                      long long m, int d, long long rows_per_block,
                      float eps) {
  constexpr bool PREFETCH = reg_prefetch<TX, TE, NV>();
  __shared__ __align__(16) float part[REG_WARPS * 32 * 8 * NV];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int vecs = d / 8;
  bool own[NV];
  float g[NV][8], pg[NV][8], pb[NV][8];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    own[k] = lane + 32 * k < vecs;
#pragma unroll
    for (int j = 0; j < 8; ++j) g[k][j] = pg[k][j] = pb[k][j] = 0.f;
    if (own[k]) load8(gamma + (lane + 32 * k) * 8, g[k]);
  }

  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  long long row1 = row0 + rows_per_block;
  if (row1 > m) row1 = m;
  Raw8<TX> nx[NV];
  Raw8<TE> ne[NV];
  long long row = row0 + warp;
  if (PREFETCH && row < row1) load_row(nx, ne, own, x, err, row, d, lane);
  for (; row < row1; row += REG_WARPS) {
    if (!PREFETCH) load_row(nx, ne, own, x, err, row, d, lane);
    float v[NV][8], e[NV][8];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      nx[k].unpack(v[k]);
      ne[k].unpack(e[k]);
    }
    if (PREFETCH && row + REG_WARPS < row1)
      load_row(nx, ne, own, x, err, row + REG_WARPS, d, lane);

    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s += v[k][j];
      }
    const float mu = warp_sum(s) / d;
    // centred variance, mean(dxhat), sum(dxhat * (x - mu))
    float sq = 0.f, sd = 0.f, sdx = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float c = v[k][j] - mu;
          const float t = e[k][j] * g[k][j];
          sq += c * c;
          sd += t;
          sdx += t * c;
        }
      }
    warp_sum3(sq, sd, sdx);
    const float rstd = rsqrtf(sq / d + eps);
    const float mean_dxhat = sd / d;
    // mean(dxhat * xhat) = rstd * mean(dxhat * (x - mu))
    const float mean_dxhat_xhat = sdx / d * rstd;
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) {
        float out[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xhat = (v[k][j] - mu) * rstd;
          const float t = e[k][j] * g[k][j];
          out[j] = (t - mean_dxhat - xhat * mean_dxhat_xhat) * rstd;
          pg[k][j] += e[k][j] * xhat;
          pb[k][j] += e[k][j];
        }
        store8(dx + row * d + (lane + 32 * k) * 8, out);
      }
  }

  // fold the warps' partials in warp order into this block's workspace
  // rows: gamma's, then beta's, through one buffer of REG_WARPS rows
  const int pitch = 32 * 8 * NV;
  for (int sum = 0; sum < (work_b != nullptr ? 2 : 1); ++sum) {
    if (sum) __syncthreads();  // the gamma fold has read the buffer
#pragma unroll
    for (int k = 0; k < NV; ++k)
      if (own[k]) store8(part + warp * pitch + (lane + 32 * k) * 8,
                         sum ? pb[k] : pg[k]);
    __syncthreads();
    float* w = (sum ? work_b : work_g) + static_cast<long long>(blockIdx.x) * d;
    for (int c = threadIdx.x; c < d; c += REG_THREADS) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < REG_WARPS; ++i) a += part[i * pitch + c];
      w[c] = a;
    }
  }
}

// grad[c] = the sum of work[i][c] over the n_blocks workspace rows: warp w
// adds rows [w q, (w + 1) q) in order (q = ceil(n_blocks / FOLD_WARPS)),
// then the warps' sums are added in warp order.  blockIdx.x picks 32
// columns, blockIdx.y the sum (0: gamma, 1: beta, whose workspace follows
// gamma's).
__global__ void __launch_bounds__(FOLD_WARPS * 32)
    ln_bwd_reg_fold_kernel(const float* __restrict__ work,
                           float* __restrict__ grad_g,
                           float* __restrict__ grad_b, int n_blocks, int d) {
  __shared__ float part[FOLD_WARPS][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const float* w =
      work + static_cast<long long>(blockIdx.y) * n_blocks * d + c;
  const int q = (n_blocks + FOLD_WARPS - 1) / FOLD_WARPS;
  const int i0 = warp * q;
  const int i1 = i0 + q < n_blocks ? i0 + q : n_blocks;
  float a = 0.f;
  if (c < d) {
    // FOLD_BATCH loads in flight, then their adds in row order
    for (int i = i0; i < i1; i += FOLD_BATCH) {
      float t[FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        t[u] = i + u < i1 ? w[static_cast<long long>(i + u) * d] : 0.f;
#pragma unroll
      for (int u = 0; u < FOLD_BATCH; ++u)
        if (i + u < i1) a += t[u];
    }
  }
  part[warp][lane] = a;
  __syncthreads();
  if (warp == 0 && c < d) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < FOLD_WARPS; ++i) s += part[i][lane];
    (blockIdx.y ? grad_b : grad_g)[c] = s;
  }
}

// the register kernel's blocks (workspace rows) for m rows, and the rows
// each owns
long long reg_blocks(long long m, long long* rows_per_block) {
  *rows_per_block = 0;
  if (m <= 0) return 0;
  long long n = (m + REG_WARPS - 1) / REG_WARPS;
  if (n > REG_BLOCKS) n = REG_BLOCKS;
  *rows_per_block = (m + n - 1) / n;
  return (m + *rows_per_block - 1) / *rows_per_block;
}

template <typename TX, typename TE, int NV>
cudaError_t launch_reg_rows(const void* x, const void* err,
                            const float* gamma, void* dx, float* work_g,
                            float* work_b, long long m, int d,
                            long long n_blocks, long long rows_per_block,
                            float eps, cudaStream_t stream) {
  ln_bwd_reg_kernel<TX, TE, NV>
      <<<static_cast<unsigned>(n_blocks), REG_THREADS, 0, stream>>>(
          static_cast<const TX*>(x), static_cast<const TE*>(err), gamma,
          static_cast<TE*>(dx), work_g, work_b, m, d, rows_per_block, eps);
  return cudaGetLastError();
}

template <typename TX, typename TE>
cudaError_t launch_reg(const void* x, const void* err, const float* gamma,
                       void* dx, float* grad_g, float* grad_b, float* work,
                       long long m, int d, float eps, cudaStream_t stream) {
  long long rows_per_block = 0;
  const long long n_blocks = reg_blocks(m, &rows_per_block);
  float* work_b = grad_b != nullptr ? work + n_blocks * d : nullptr;
  if (n_blocks > 0) {
    cudaError_t e;
    switch ((d / 8 + 31) / 32) {
      case 1:
        e = launch_reg_rows<TX, TE, 1>(x, err, gamma, dx, work, work_b, m, d,
                                       n_blocks, rows_per_block, eps, stream);
        break;
      case 2:
        e = launch_reg_rows<TX, TE, 2>(x, err, gamma, dx, work, work_b, m, d,
                                       n_blocks, rows_per_block, eps, stream);
        break;
      case 3:
        e = launch_reg_rows<TX, TE, 3>(x, err, gamma, dx, work, work_b, m, d,
                                       n_blocks, rows_per_block, eps, stream);
        break;
      default:
        e = launch_reg_rows<TX, TE, 4>(x, err, gamma, dx, work, work_b, m, d,
                                       n_blocks, rows_per_block, eps, stream);
    }
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((d + 31) / 32, grad_b != nullptr ? 2 : 1);
  ln_bwd_reg_fold_kernel<<<grid, FOLD_WARPS * 32, 0, stream>>>(
      work, grad_g, grad_b, static_cast<int>(n_blocks), d);
  return cudaGetLastError();
}

bool reg_takes(int d, const void* x, const void* err, const void* gamma,
               const void* dx) {
  const auto off = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  return d >= 8 && d % 8 == 0 && d <= 32 * 8 * REG_MAX_NV && !off(x) &&
         !off(err) && !off(gamma) && !off(dx);
}

}  // namespace

// The number of workspace rows (blocks) the general kernels use for m rows
// of width d; the caller allocates a workspace of (rows * d * (1 + beta))
// floats, at most 2^23.
extern "C" long long znicz_layer_norm_bwd_blocks(long long m, int d,
                                                 int has_beta) {
  long long rows_per_block = 0;
  return gen_blocks(m, d, has_beta != 0, &rows_per_block);
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

// The register kernels' workspace rows (blocks) for m rows: the caller
// allocates a workspace of (rows * d * (1 + beta)) floats for
// znicz_layer_norm_bwd_reg.
extern "C" long long znicz_layer_norm_bwd_reg_blocks(long long m) {
  long long rows_per_block = 0;
  return reg_blocks(m, &rows_per_block);
}

// The register kernels, the same operands as znicz_layer_norm_bwd with the
// workspace sized by znicz_layer_norm_bwd_reg_blocks: takes 8 <= d <= 1024
// with d % 8 == 0 and x, err, gamma, dx on 16-byte boundaries, and returns
// cudaErrorInvalidValue for anything else.
extern "C" int znicz_layer_norm_bwd_reg(const void* x, const void* err,
                                        const void* gamma, void* dx,
                                        void* grad_gamma, void* grad_beta,
                                        void* work, long long m, int d,
                                        float eps, int x_dtype, int err_dtype,
                                        void* stream) {
  if (!reg_takes(d, x, err, gamma, dx))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  float* gg = static_cast<float*>(grad_gamma);
  float* gb = static_cast<float*>(grad_beta);
  float* w = static_cast<float*>(work);
  switch (x_dtype * 2 + err_dtype) {
    case 0:
      return static_cast<int>(
          launch_reg<float, float>(x, err, g, dx, gg, gb, w, m, d, eps, s));
    case 1:
      return static_cast<int>(launch_reg<float, __nv_bfloat16>(
          x, err, g, dx, gg, gb, w, m, d, eps, s));
    case 2:
      return static_cast<int>(launch_reg<__nv_bfloat16, float>(
          x, err, g, dx, gg, gb, w, m, d, eps, s));
    case 3:
      return static_cast<int>(launch_reg<__nv_bfloat16, __nv_bfloat16>(
          x, err, g, dx, gg, gb, w, m, d, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
