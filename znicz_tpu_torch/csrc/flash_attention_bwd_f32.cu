// Flash-attention backward for Hopper (sm_90a) with float32 operands: the
// dq kernel and the dk/dv kernel, one register-tiled SIMT kernel template
// with the roles of the operands exchanged.
//
// Replaces: znicz_tpu/ops/pallas_attention.py:_dq_kernel and :_dkv_kernel
// when they run on f32 operands (the reference trains in f32 by default).
// There every tile product runs at the input dtype with f32 accumulation;
// here every product is an f32 FMA on the CUDA cores (Hopper's tensor
// cores take no f32 operand, and TF32 would keep three digits).  The
// function, the recompute-from-lse form of flash_attention_bwd.cu with
// nothing rounded to bf16:
//   p  = exp(s * scale - lse) where visible, else 0
//   ds = p * (do . v^T - delta) * scale
//   dq = ds . k;   dv = p^T . do;   dk = ds^T . q
// exp is taken as exp2 of a pre-scaled score (log2 e folded into the
// scale and into lse) with ex2.approx.ftz: a relative error of ~2^-22,
// and only p < 2^-126 flushed to 0.
//
// What bounds it on this card: the products.  At the training shape
// (B = 16, H = 8, T = 2048, dh = 64) the dq kernel does 3 and the dk/dv
// kernel 4 products of 2*B*H*T^2*dh FLOP, ~1000 FLOP a byte of operands,
// so the f32 FMA rate (67 TFLOP/s on an H100 SXM) bounds both.
//
// One block of 256 threads (8 warps) owns 16 RT "own" rows X1, X2 and
// walks over 64-row tiles of the "other" operands Y1, Y2:
//   dq:    X = (q, do), Y = (k, v):  S = X1.Y1^T, dP = X2.Y2^T,
//          dq[:, chunk] += dS . Y1[:, chunk]
//   dk/dv: X = (k, v), Y = (q, do):  the transposed tiles S^T and dP^T,
//          dk[:, chunk] += dS^T . Y1[:, chunk],
//          dv[:, chunk] += P^T . Y2[:, chunk]
// What the design does about the limits of the first f32 kernels (a
// thread a quarter of a row, scalar loads through a padded pitch):
// 1. One shared load per FMA.  Each thread owns an RT x 4 block of both
//    score tiles and RT rows x 4 columns of every 64-column slice of its
//    accumulators (RT = 8 for dq up to a width of 128 and for dk/dv up
//    to 64, else 4).  A 4-column step of a score product reads the
//    thread's RT rows of X and 4 rows of Y as 128-bit loads and does
//    16 RT FMAs: 8 a load at RT = 4, 10.7 at RT = 8 (the first kernels
//    did 1); a step of a chunk product reads RT rows of dS or P and 4
//    rows of Y the same way.  A warp covers 4 RT x 32 of a tile as
//    4 x 8 threads, so each of its loads touches 4 or 8 distinct
//    16-byte words, which the XOR swizzle of the 16-byte column by the
//    row's low 3 bits puts in distinct banks (row-major tiles, no
//    padding, one wavefront a load).
//    On an H100 SXM, RT = 8 is 18 % faster than 4 for dq at dh 64, and
//    12-13 % for dk/dv at 64 and dq at 128 once their larger loop bodies
//    are only partly unrolled (BODY in the kernel); past those widths
//    its accumulators would not fit the registers.
// 2. Occupancy.  8 warps a block and one block a SM at every width (up
//    to 254 registers a thread, no spill).
// 3. Synchronous staging.  Everything a block reads passes through a
//    ring of STAGES slots filled by 16-byte cp.async (rows past T
//    zero-filled): the score products' 32-column slices of X1, X2, Y1 and
//    Y2, then the chunk products' 64-column slices of the right-hand
//    operands.  The slot STAGES - 1 items ahead is in flight while this
//    one's products run; one barrier an item.  dS and P pass from the
//    score stage to the chunk products through shared memory, written
//    once a tile.  Shared memory does not grow with the head dim: 112 KB
//    (dq) and 128 KB (dk/dv) at RT = 4, 176 and 208 KB at RT = 8; one
//    code path serves every width that is a multiple of 32.
// 4. Scores recomputed per output chunk.  Only where the accumulators do
//    not fit: the output is split into column chunks of DC past 256 for
//    dq (DC = 256, 64 accumulators a thread) and past 128 for dk/dv
//    (DC = 128, two sets of 32: a 256-wide chunk spills), each chunk
//    recomputing the scores over the whole head dim; on a grid of fewer
//    blocks than half the SMs the chunks are halved (down to 64) to fill
//    the card.
// 5. expf.  exp2 on the special-function unit, above.
//
// Geometry, the bf16 kernels': q, k, v, do, dq, dk and dv in the boundary
// layout (B, T, H, dh) through element strides (the last dim contiguous,
// rows 16-byte aligned); lse and delta contiguous (B, H, Tq) f32; any T;
// q_offset / k_offset place the call on a global axis for causal masking,
// and causal skips whole tiles that no row of the block can see.  A fully
// masked row gives 0.  Two kernels and no atomics: the bits are the same
// on a rerun.

#include <cuda_runtime.h>

#include "simt_f32.cuh"

namespace {

// widths up to these (dq, dk/dv) take 8 own rows a thread, wider ones 4:
// the taller tile does more FMAs a shared load, but past them its
// accumulators no longer fit the registers
constexpr int TALL_DQ = 128;
constexpr int TALL_DKV = 64;

// the shapes of a kernel whose threads own RT own rows each (4 or 8): a
// block owns 16 RT rows; a ring slot holds a score item (the slices of
// X1, X2, Y1 and Y2) or a chunk item (up to 2 x 64 x 64 floats)
template <int RT>
struct Shape {
  static constexpr int OWN = 16 * RT;         // own rows a block
  static constexpr int X_SLICE = OWN * SL;    // floats of an own slice
  static constexpr int Y_SLICE = TILE * SL;   // floats of an other slice
  static constexpr int SLOT = 2 * X_SLICE + 2 * Y_SLICE;
  static constexpr int W_TILE = OWN * TILE;   // floats of the P or dS tile
  static_assert(SLOT >= 2 * TILE * 64, "a chunk item fits a slot");
};

struct Params {
  Operand x1, x2, y1, y2;  // own (q, do or k, v), other (k, v or q, do)
  float* out0;             // dq, or dk
  float* out1;             // dv
  long long o0_sb, o0_st, o0_sh, o1_sb, o1_st, o1_sh;
  const float* lse;
  const float* delta;
  int heads, t_own, t_oth, width, chunks;
  float scale, scale_log2;
  int causal;
  long long q_offset, k_offset;
};

// DKV: the dk/dv kernel (else dq); DC: the output chunk's columns; RT:
// own rows a thread (a block owns 16 RT)
template <bool DKV, int DC, int RT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_f32_kernel(const Params p) {
  using S = Shape<RT>;
  constexpr int OWN = S::OWN;
  constexpr int CS = DC < 64 ? DC : 64;  // columns of a chunk slice
  constexpr int NSL = DC / CS;           // chunk slices
  constexpr int CG = CS / 4;             // column groups of a chunk slice
  constexpr int JS = 16 / CG;            // splits of a tile's rows (1, 2)
  constexpr int NW = DKV ? 2 : 1;        // P/dS tiles, chunk products
  constexpr int J4 = TILE / JS / 4;      // 4-row steps of a chunk product
  // the unrolled body's size (BODY_MAX): two score products, NW chunk
  // products
  constexpr int BODY = (2 * SL / 4 + NW * NSL * J4) * (17 * RT + 4);
  constexpr int U = BODY > BODY_MAX ? 4 : J4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* w_tile = smem + STAGES * S::SLOT;  // dS, then (dk/dv) P

  const int own0 = blockIdx.x * OWN;
  const int h = blockIdx.y / p.chunks;
  const int c0 = blockIdx.y % p.chunks * DC;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = lane / 8;  // a warp is 4 row groups x 8 column groups
  const int cg = lane % 8;

  // score tiles: warp (w / 2, w % 2) covers own rows 4 RT (w / 2) +
  // [0, 4 RT) and other rows 32 (w % 2) + [0, 32); a thread rows rg + 4 i
  // and columns cg + 8 m of that block
  int srow[RT], scol[4];
#pragma unroll
  for (int i = 0; i < RT; ++i) srow[i] = (warp >> 1) * 4 * RT + rg + 4 * i;
#pragma unroll
  for (int m = 0; m < 4; ++m) scol[m] = (warp & 1) * 32 + cg + 8 * m;
  // chunk products: rows as above, 16-byte column ccol of every slice,
  // and the tile rows [js * 64 / JS, (js + 1) * 64 / JS)
  const int cwr = JS == 1 ? warp >> 1 : warp & 3;
  const int ccol = (JS == 1 ? (warp & 1) * 8 : 0) + cg;
  const int js = JS == 1 ? 0 : warp >> 2;
  int crow[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) crow[i] = cwr * 4 * RT + rg + 4 * i;
  // swizzled offsets (swz) of the first rows and columns
  const int sxo0 = swz<SL>(srow[0], 0), sxo1 = swz<SL>(srow[1], 0);
  const int syo = swz<SL>(scol[0], 0);
  const int wo0 = swz<TILE>(crow[0], 0), wo1 = swz<TILE>(crow[1], 0);
  int yco[8];  // column ccol of a chunk slice's row r, by r & 7
#pragma unroll
  for (int r = 0; r < 8; ++r) yco[r] = (ccol ^ r) << 2;

  const auto base = [&](const Operand& o) {
    return o.p + b * o.sb + h * o.sh;
  };
  const float* x1 = base(p.x1) + own0 * p.x1.st;
  const float* x2 = base(p.x2) + own0 * p.x2.st;
  const float* y1 = base(p.y1);
  const float* y2 = base(p.y2);
  const long long stat = (static_cast<long long>(b) * p.heads + h) *
                         (DKV ? p.t_oth : p.t_own);

  // the other operand's tiles this block can see
  const int n_oth = (p.t_oth + TILE - 1) / TILE;
  int first = 0, last = n_oth;
  if (p.causal) {
    if (DKV) {  // queries q with q_offset + q >= k_offset + own0
      const long long lo = p.k_offset + own0 - p.q_offset;
      if (lo > 0) first = static_cast<int>(lo / TILE < n_oth ? lo / TILE
                                                               : n_oth);
    } else {  // keys k with k_offset + k <= q_offset + own0 + OWN - 1
      const long long hi = p.q_offset + own0 + OWN - 1 - p.k_offset;
      last = hi < 0 ? 0 : static_cast<int>(hi / TILE + 1 < n_oth
                                               ? hi / TILE + 1 : n_oth);
    }
  }
  const int n_score = p.width / SL;
  const int per_tile = n_score + NSL;
  const int items = (last > first ? last - first : 0) * per_tile;

  // item it: the score slice or chunk slice `it % per_tile` of tile
  // `first + it / per_tile`, staged into slot it % STAGES
  const auto fetch = [&](int it) {
    if (it < items) {
      const int oth0 = (first + it / per_tile) * TILE;
      const int sub = it % per_tile;
      float* slot = ring + it % STAGES * S::SLOT;
      const int own_valid = p.t_own - own0;
      const int oth_valid = p.t_oth - oth0;
      if (sub < n_score) {  // X1, X2, Y1, Y2
        const int col = sub * SL;
        float* ys = slot + 2 * S::X_SLICE;
        stage<OWN, SL>(slot, x1 + col, p.x1.st, own_valid);
        stage<OWN, SL>(slot + S::X_SLICE, x2 + col, p.x2.st, own_valid);
        stage<TILE, SL>(ys, y1 + oth0 * p.y1.st + col, p.y1.st, oth_valid);
        stage<TILE, SL>(ys + S::Y_SLICE, y2 + oth0 * p.y2.st + col, p.y2.st,
                        oth_valid);
      } else {
        // Y1 (k for dq, q for dk), then Y2 (do for dv)
        const int col = c0 + (sub - n_score) * CS;
        stage<TILE, CS>(slot, y1 + oth0 * p.y1.st + col, p.y1.st,
                        oth_valid);
        if (DKV) {
          stage<TILE, CS>(slot + TILE * CS, y2 + oth0 * p.y2.st + col,
                          p.y2.st, oth_valid);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
  // waits for item it, frees the slot of it - 1 for item it + STAGES - 1
  const auto advance = [&](int it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    fetch(it + STAGES - 1);
    return ring + it % STAGES * S::SLOT;
  };

  // dq: each thread's own rows' lse (times log2 e) and delta, once
  float lse_r[RT], delta_r[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = own0 + srow[i];
    const bool ok = !DKV && row < p.t_own;
    lse_r[i] = ok ? p.lse[stat + row] * LOG2E : 0.f;
    delta_r[i] = ok ? p.delta[stat + row] : 0.f;
  }

  float acc[NW][NSL][RT][4];
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int c = 0; c < NSL; ++c)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][c][i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  int it = 0;
  for (int tile = first; tile < last; ++tile) {
    const int oth0 = tile * TILE;
    // dk/dv: the tile's queries' lse (times log2 e) and delta
    float lse_c[4], delta_c[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = oth0 + scol[m];
      const bool ok = DKV && q < p.t_oth;
      lse_c[m] = ok ? p.lse[stat + q] * LOG2E : 0.f;
      delta_c[m] = ok ? p.delta[stat + q] : 0.f;
    }

    // the score products over the head dim, a 32-column slice an item
    float s[RT][4], dp[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) s[i][m] = dp[i][m] = 0.f;
    for (int sub = 0; sub < n_score; ++sub, ++it) {
      const float* slot = advance(it);
      const float* ys = slot + 2 * S::X_SLICE;
      slice_dots<RT, 4>(s, slot, ys, sxo0, sxo1, syo);
      slice_dots<RT, 4>(dp, slot + S::X_SLICE, ys + S::Y_SLICE, sxo0, sxo1,
                     syo);
    }

    // p and ds into the shared tile(s); every thread is past the last
    // reads of the previous tile's (a barrier of this tile's first item)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int own = own0 + srow[i];
        const int oth = oth0 + scol[m];
        const long long qpos = p.q_offset + (DKV ? oth : own);
        const long long kpos = p.k_offset + (DKV ? own : oth);
        const bool vis = own < p.t_own && oth < p.t_oth &&
                         (!p.causal || qpos >= kpos);
        const float lse2 = DKV ? lse_c[m] : lse_r[i];
        const float dl = DKV ? delta_c[m] : delta_r[i];
        const float pe =
            vis ? exp2_ftz(fmaf(s[i][m], p.scale_log2, -lse2)) : 0.f;
        const float ds = pe * (dp[i][m] - dl) * p.scale;
        const int at = swz<TILE>(srow[i], scol[m] >> 2) + (scol[m] & 3);
        w_tile[at] = ds;
        if (DKV) w_tile[S::W_TILE + at] = pe;
      }

    // the chunk products, a 64-column slice (32 at DC = 32) an item;
    // the item's barrier also publishes the P/dS tile
#pragma unroll
    for (int c = 0; c < NSL; ++c, ++it) {
      const float* slot = advance(it);
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const float* wt = w_tile + n * S::W_TILE;
        // this thread's rows of the tile: js * 64 / JS + [0, 64 / JS)
        const float* yc = slot + n * TILE * CS + js * (TILE / JS) * CS;
#pragma unroll 1
        for (int u = 0; u < J4; u += U) {
#pragma unroll
          for (int t = 0; t < U; ++t) {
            const int j4 = u + t;
            const int jk = js * J4 + j4;
            float4 wa[RT];
#pragma unroll
            for (int i = 0; i < RT; ++i)
              wa[i] = ld4(wt + (((i & 1) ? wo1 : wo0) ^ (jk << 2)) +
                          (i >> 1) * 8 * TILE);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              // row 4 j4 + e of the thread's rows; js * 64 / JS and 4 u
              // are multiples of 8, so its swizzle is that of 4 t + e
              const float4 y =
                  ld4(yc + (4 * j4 + e) * CS + yco[(4 * t + e) & 7]);
#pragma unroll
              for (int i = 0; i < RT; ++i) {
                const float w = e == 0 ? wa[i].x : e == 1 ? wa[i].y
                                : e == 2 ? wa[i].z : wa[i].w;
                float(&a)[4] = acc[n][c][i];
                a[0] = fmaf(w, y.x, a[0]);
                a[1] = fmaf(w, y.y, a[1]);
                a[2] = fmaf(w, y.z, a[2]);
                a[3] = fmaf(w, y.w, a[3]);
              }
            }
          }
        }
      }
    }
  }

  if (JS > 1) {  // the second half of the tile rows adds into the first
    cp_async_wait<0>();
    __syncthreads();
    constexpr int PER = NW * NSL * RT * 4;  // accumulators a thread
    float* red = smem + (threadIdx.x % 128) * PER;
    if (js == 1) {
#pragma unroll
      for (int n = 0; n < NW; ++n)
#pragma unroll
        for (int c = 0; c < NSL; ++c)
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((n * NSL + c) * RT + i) * 4 + e] = acc[n][c][i][e];
    }
    __syncthreads();
    if (js == 1) return;
#pragma unroll
    for (int n = 0; n < NW; ++n)
#pragma unroll
      for (int c = 0; c < NSL; ++c)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][c][i][e] += red[((n * NSL + c) * RT + i) * 4 + e];
  }

#pragma unroll
  for (int n = 0; n < NW; ++n) {
    float* out = n == 0 ? p.out0 + b * p.o0_sb + h * p.o0_sh
                        : p.out1 + b * p.o1_sb + h * p.o1_sh;
    const long long ost = n == 0 ? p.o0_st : p.o1_st;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int row = own0 + crow[i];
      if (row >= p.t_own) continue;
#pragma unroll
      for (int c = 0; c < NSL; ++c) {
        *reinterpret_cast<float4*>(out + row * ost + c0 + c * CS +
                                   4 * ccol) =
            make_float4(acc[n][c][i][0], acc[n][c][i][1], acc[n][c][i][2],
                        acc[n][c][i][3]);
      }
    }
  }
}

template <bool DKV, int DC, int RT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using S = Shape<RT>;
  constexpr int smem = (STAGES * S::SLOT + (DKV ? 2 : 1) * S::W_TILE) *
                       static_cast<int>(sizeof(float));
  const auto kernel = flash_bwd_f32_kernel<DKV, DC, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_own + S::OWN - 1) / S::OWN, p.heads * p.chunks,
                  batch);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// `which` 1 dq, 2 dk/dv; the head dim must be a multiple of 32 and every
// row 16-byte aligned
int dispatch(bool dkv, int width, Params p, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || width % SL != 0 || !rows_aligned(p.x1) ||
      !rows_aligned(p.x2) || !rows_aligned(p.y1) || !rows_aligned(p.y2) ||
      !aligned(p.out0) || p.o0_st % 4 != 0 || p.o0_sh % 4 != 0 ||
      p.o0_sb % 4 != 0 ||
      (dkv && (!aligned(p.out1) || p.o1_st % 4 != 0 || p.o1_sh % 4 != 0 ||
               p.o1_sb % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.width = width;
  const bool tall = width <= (dkv ? TALL_DKV : TALL_DQ);
  const int own = tall ? Shape<8>::OWN : Shape<4>::OWN;
  const long long blocks =
      static_cast<long long>((p.t_own + own - 1) / own) * p.heads * batch;
  const int dc = chunk_width(dkv ? 128 : 256, width, blocks);
  p.chunks = width / dc;
  cudaError_t err = cudaErrorInvalidValue;
  if (tall) {  // dc = width, or 64 on a small grid at 128
    err = dkv ? (dc == 32 ? launch<true, 32, 8>(p, batch, s)
                          : launch<true, 64, 8>(p, batch, s))
              : dc == 32 ? launch<false, 32, 8>(p, batch, s)
              : dc == 64 ? launch<false, 64, 8>(p, batch, s)
                         : launch<false, 128, 8>(p, batch, s);
  } else if (dkv) {
    switch (dc) {
      case 64: err = launch<true, 64, 4>(p, batch, s); break;
      case 128: err = launch<true, 128, 4>(p, batch, s); break;
      default: break;
    }
  } else {
    switch (dc) {
      case 64: err = launch<false, 64, 4>(p, batch, s); break;
      case 128: err = launch<false, 128, 4>(p, batch, s); break;
      case 256: err = launch<false, 256, 4>(p, batch, s); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}

Operand operand(const void* ptr, const long long* s) {
  return {static_cast<const float*>(ptr), s[0], s[1], s[2]};
}

void set_common(Params& p, const void* lse, const void* delta, int heads,
                int tq, int tk, float scale, int causal, long long q_offset,
                long long k_offset, bool dkv) {
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.heads = heads;
  p.t_own = dkv ? tk : tq;
  p.t_oth = dkv ? tq : tk;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
}

}  // namespace

// The C entry points take the arguments of their bf16 counterparts in
// flash_attention_bwd.cu, with f32 tensors zero-padded to a head dim that
// is a multiple of 32.  `strides` holds the (B, T, H) element strides of
// q, k, v and do, in that order.  Each returns the launch's cudaError_t
// (0 on success; cudaErrorInvalidValue for a head dim or a row alignment
// the kernel does not take).
extern "C" int znicz_flash_attention_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int heads,
    int tq, int tk, int head_dim, const long long* strides, long long dq_sb,
    long long dq_st, long long dq_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  Params p = {};
  p.x1 = operand(q, strides);
  p.x2 = operand(dout, strides + 9);
  p.y1 = operand(k, strides + 3);
  p.y2 = operand(v, strides + 6);
  set_common(p, lse, delta, heads, tq, tk, scale, causal, q_offset,
             k_offset, false);
  p.out0 = static_cast<float*>(dq);
  p.o0_sb = dq_sb;
  p.o0_st = dq_st;
  p.o0_sh = dq_sh;
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  return dispatch(false, head_dim, p, batch, stream);
}

extern "C" int znicz_flash_attention_dkv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int heads, int tq, int tk, int head_dim, const long long* strides,
    const long long* out_strides, float scale, int causal, long long q_offset,
    long long k_offset, void* stream) {
  Params p = {};
  p.x1 = operand(k, strides + 3);
  p.x2 = operand(v, strides + 6);
  p.y1 = operand(q, strides);
  p.y2 = operand(dout, strides + 9);
  set_common(p, lse, delta, heads, tq, tk, scale, causal, q_offset,
             k_offset, true);
  p.out0 = static_cast<float*>(dk);
  p.out1 = static_cast<float*>(dv);
  p.o0_sb = out_strides[0];
  p.o0_st = out_strides[1];
  p.o0_sh = out_strides[2];
  p.o1_sb = out_strides[3];
  p.o1_st = out_strides[4];
  p.o1_sh = out_strides[5];
  if (batch <= 0 || heads <= 0 || tk <= 0) return cudaSuccess;
  return dispatch(true, head_dim, p, batch, stream);
}
