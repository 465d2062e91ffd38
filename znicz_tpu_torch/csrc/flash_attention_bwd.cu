// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel, bf16 operands, f32 accumulators, TMA loads into an
// mbarrier ring and every product on wgmma.
//
// Replaces: znicz_tpu/ops/pallas_attention.py:_dq_kernel and :_dkv_kernel
// (the Pallas TPU backward reached through _flash_hop's custom_vjp).  Same
// function, the recompute-from-lse form: no (T, T) tensor is stored.  Per
// (batch, head), with p, dp and ds recomputed tile by tile in registers:
//   s  = (q . k) * scale           scale applied after the product
//   p  = exp(s - lse)  where visible, else 0 (a select, so a fully masked
//                      row, lse = -1e30, never overflows)
//   dp = do . v
//   ds = p * (dp - delta) * scale  delta = rowsum(do * o) - dlse, given
//   dq = bf16(ds) . k              (dq kernel)
//   dv = bf16(p)^T . do,  dk = bf16(ds)^T . q   (dk/dv kernel)
// with f32 accumulators stored in bf16 at the end, as the reference rounds
// p and ds to the operand dtype before their products.  exp is taken as
// exp2 with log2(e) folded into the scale and into lse.
//
// What bounds it on this card: at the training shape (B=16, H=8, T=2048,
// dh=64) the dq kernel does 3 and the dk/dv kernel 4 products of
// 2*B*H*T^2*dh FLOP each, ~2.1e11 and ~2.7e11 FLOP, against ~170 MB of
// q/k/v/do/lse/delta/dq/dk/dv traffic, well above the H100's ~295
// FLOP/byte ridge: the tensor cores bound both, and only wgmma reaches
// their full rate.
//
// One kernel template serves both, because they are the same loop with
// the roles of the operands exchanged.  A block owns 128 rows of "own"
// operands X1, X2 (two consumer warpgroups of 64 rows) and walks over
// 64-row tiles of the "other" operands Y1, Y2:
//   dq:    X = (q, do) of 128 queries, Y = (k, v) of 64 keys;
//          S = Q.K^T and dP = dO.V^T, then dQ += bf16(dS) . K[:, chunk]
//   dk/dv: X = (k, v) of 128 keys, Y = (q, do) of 64 queries; the
//          transposed tiles S^T = K.Q^T and dP^T = V.dO^T, then
//          dV += bf16(P^T) . dO[:, chunk] and dK += bf16(dS^T) . Q[:, chunk]
// So both score products run with both operands K-major in shared memory,
// P and dS are computed in the registers that hold S and dP and become
// the register A operands of the second products, and the right-hand Y
// tiles are read there as transposed (MN-major) B from the same
// TMA-written, 128-byte-swizzled tiles that the score products read
// K-major (what the forward does with V).  Warp 0 issues the TMA loads
// into an mbarrier ring ahead of what the block consumes, and stages the
// dk/dv kernel's lse and delta of the query tile beside it.
//
// Up to a head dim of 128 the loop is software-pipelined: the scores of
// tile m + 1 and the chunk products of tile m are issued together, and
// p and ds of m + 1 are computed while the products of m run.  With the
// elementwise pass on exp2 in its flush-to-zero form this took the pair
// from ~2.6 to ~1.9 ms at the training shape on an H100 SXM (700 W); the
// serial loop of the streamed widths is what remains to pipeline.
//
// Head dims: every multiple of 8.  The score products contract the head
// dim in 64-column slices.  Up to 128 (one or two slices) the block's own
// X tiles stay in shared memory and a ring stage holds a whole Y tile, so
// the chunk products read their columns from the same stage.  Past 128
// everything streams: a ring stage holds one slice of X1, X2, Y1 and Y2,
// S and dP accumulate over the slices, and the output chunk's Y columns
// come in a buffer of their own, so shared memory stays at 161 KB (dq) or
// 177 KB (dk/dv) at any width (X is read again from L2 for every tile).
// The outputs are split into column chunks of DC = 128 by a grid axis
// (64 up to a head dim of 64, and for dk/dv up to 128), each chunk
// recomputing the scores over the whole head dim.  The tensor maps carry
// the true head dim and TMA fills the columns past it with zeros, which
// change no score; a 32 or 40 wide head dim runs as one 64-column slice,
// with no padded copy, and up to 32 the score products take only the
// slice's first 32 columns.
//
// Geometry, the forward's: q, k, v, do, dq, dk and dv are read or written
// in the boundary layout (B, T, H, dh) through element strides (the last
// dim contiguous), each operand described to TMA as the 4-d tensor
// (dh, H, T, B), so q/k/v stay views into the packed QKV projection; lse
// and delta are contiguous (B, H, Tq) f32.  Any T: rows past T are
// zero-filled by TMA and masked.  q_offset / k_offset place the call on a
// global axis for causal masking; causal skips whole tiles that no row of
// the block can see.  Two kernels and no atomics: the bits are the same
// on a rerun.

#include "hopper.cuh"

namespace {

constexpr int OWN = 128;      // own rows a block: two warpgroups of 64
constexpr int TILE = 64;      // other rows a tile
constexpr int THREADS = 256;  // the two warpgroups; warp 0 also loads
constexpr int STAGES = 3;     // ring depth
constexpr int OWN_REGION = OWN * ATOM_BYTES;  // one 64-column slice
constexpr int TILE_REGION = TILE * ATOM_BYTES;
constexpr float LOG2E = 1.4426950408889634f;

// dynamic shared memory, plus 1 KB to align the base to 1024 bytes.
// RES > 0: the own slices X1 then X2, then STAGES of the Y1 then Y2
// slices.  RES = 0 (streamed): STAGES of one slice of X1, X2, Y1 and Y2,
// then the chunk buffer, the chunk's slices of Y1 (and of Y2 for dk/dv).
template <bool DKV, int RES, int DC>
constexpr int smem_bytes() {
  if constexpr (RES > 0) {
    return 2 * RES * OWN_REGION + STAGES * 2 * RES * TILE_REGION + 1024;
  } else {
    return STAGES * (2 * OWN_REGION + 2 * TILE_REGION) +
           (DKV ? 2 : 1) * (DC / ATOM) * TILE_REGION + 1024;
  }
}

struct Params {
  uint16_t* out0;  // dq, or dk
  uint16_t* out1;  // dv
  long long o0_sb, o0_st, o0_sh, o1_sb, o1_st, o1_sh;
  const float* lse;
  const float* delta;
  int heads, tq, tk, dh, slices, chunks;
  float scale;       // 1 / sqrt(dh)
  float scale_log2;  // scale * log2(e)
  int causal;
  long long q_offset, k_offset;
};

// 2^x on the special-function unit, subnormal results flushed to 0: a p
// under 2^-126 moves no product by more than 2^-126 of its other
// factor, far under the bf16 rounding of p and ds.  exp2f, which keeps
// subnormals, costs several instructions more, and the elementwise pass
// over the score tiles weighs more than the products in these kernels
// (this took 30 % off both at the training shape on an H100).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// DKV: the dk/dv kernel (else dq); RES: 64-column slices of the head dim
// held whole (1 or 2), or 0 to stream any width; DC: output chunk width;
// KS: 16-column steps of a held slice that the score products take (2
// for a head dim up to 32, whose other columns are TMA's zeros; a bound
// known at compile time keeps the wgmma chain unbroken).
// Eight warps and no warp of its own for the loads: a block of nine warps
// is allotted registers as one of twelve (168 a thread), which the two
// f32 accumulators and two score tiles of a thread overflow; with eight
// it may use 255.
template <bool DKV, int RES, int DC, int KS>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_x1,
                     const __grid_constant__ CUtensorMap tm_x2,
                     const __grid_constant__ CUtensorMap tm_y1,
                     const __grid_constant__ CUtensorMap tm_y2,
                     const Params p) {
  constexpr int CS = DC / ATOM;  // slices of an output chunk
  constexpr int STAGE = RES > 0 ? 2 * RES * TILE_REGION
                                : 2 * OWN_REGION + 2 * TILE_REGION;
  // the Y2 columns of the chunk, past its Y1 columns
  constexpr int Y2_OFF = (RES > 0 ? RES : CS) * TILE_REGION;
  // barriers: own tiles loaded; each ring stage loaded and released; the
  // streamed chunk buffer loaded and released
  __shared__ __align__(8) uint64_t bars[3 + 2 * STAGES];
  // dk/dv: lse * log2(e) and delta of the query tile, for each place a
  // tile's chunk columns live (ring stage, or the chunk buffer)
  __shared__ float s_stat[RES > 0 ? STAGES : 1][2][TILE];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s_own = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_ring = s_own + (RES > 0 ? 2 * RES * OWN_REGION : 0);
  const uint32_t s_chunk = s_ring + STAGES * STAGE;
  const uint32_t bar_own = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);  // + 8 * stage
  const uint32_t bar_free = smem_u32(&bars[1 + STAGES]);
  const uint32_t bar_cfull = smem_u32(&bars[1 + 2 * STAGES]);
  const uint32_t bar_cfree = smem_u32(&bars[2 + 2 * STAGES]);

  const int x0 = blockIdx.x * OWN;
  const int h = blockIdx.y / p.chunks;
  const int c0 = blockIdx.y % p.chunks * DC;  // this block's output columns
  const int b = blockIdx.z;
  const int slices = RES > 0 ? RES : p.slices;
  const int t_own = DKV ? p.tk : p.tq;
  const int t_oth = DKV ? p.tq : p.tk;
  // query iq sees key ik when shift + iq >= ik
  const long long shift = p.q_offset - p.k_offset;

  // the other operand's tiles the block visits: [first, n_end)
  int first = 0;
  int n_end = (t_oth + TILE - 1) / TILE;
  if (p.causal) {
    if (DKV) {
      // no query before `lo` sees any key of this block
      const long long lo = x0 - shift;
      if (lo > 0) first = static_cast<int>(lo / TILE < n_end ? lo / TILE
                                                             : n_end);
    } else {
      // no query of this block sees a key past `last`
      const long long last = shift + x0 + OWN - 1;
      if (last < 0) {
        n_end = 0;
      } else if (last / TILE + 1 < n_end) {
        n_end = static_cast<int>(last / TILE) + 1;
      }
    }
  }
  const long long stat0 = (static_cast<long long>(b) * p.heads + h) * p.tq;

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const bool loader = threadIdx.x < 32;  // warp 0 issues every load

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);              // every lane of warp 0
      mbar_init(bar_free + 8 * s, THREADS / 32);    // one arrival a warp
    }
    mbar_init(bar_cfull, 32);
    mbar_init(bar_cfree, THREADS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The loads, issued by warp 0 ahead of what the block consumes: lane 0
  // issues the TMA loads, every lane stages two of the dk/dv kernel's
  // query statistics and arrives on the full barrier of what it filled.
  auto stage_stats = [&](float (*st)[TILE], int y0) {
    if constexpr (DKV) {
      for (int i = lane; i < TILE; i += 32) {
        const bool ok = y0 + i < p.tq;
        st[0][i] = ok ? p.lse[stat0 + y0 + i] * LOG2E : 0.f;
        st[1][i] = ok ? p.delta[stat0 + y0 + i] : 0.f;
      }
    }
  };
  // ring items: a tile (RES > 0), or a slice of a tile (streamed)
  const int n_items = (n_end - first) * (RES > 0 ? 1 : slices);
  int issued = 0;
  auto issue_until = [&](int upto) {  // ring items [issued, upto)
    for (; issued < min(upto, n_items); ++issued) {
      const int m = issued;
      const int s = m % STAGES;
      const uint32_t dst = s_ring + s * STAGE;
      const uint32_t bar = bar_full + 8 * s;
      mbar_wait(bar_free + 8 * s, ((m / STAGES) & 1) ^ 1);
      if constexpr (RES > 0) {
        const int y0 = (first + m) * TILE;
        stage_stats(s_stat[s], y0);
        if (lane == 0) {
          mbar_expect_tx(bar, STAGE);
          for (int c = 0; c < RES; ++c) {
            tma_load(dst + c * TILE_REGION, &tm_y1, bar, c * ATOM, h, y0, b);
            tma_load(dst + (RES + c) * TILE_REGION, &tm_y2, bar, c * ATOM, h,
                     y0, b);
          }
        }
      } else {
        const int y0 = (first + m / slices) * TILE;
        const int c = m % slices;
        if (lane == 0) {
          mbar_expect_tx(bar, STAGE);
          tma_load(dst, &tm_x1, bar, c * ATOM, h, x0, b);
          tma_load(dst + OWN_REGION, &tm_x2, bar, c * ATOM, h, x0, b);
          tma_load(dst + 2 * OWN_REGION, &tm_y1, bar, c * ATOM, h, y0, b);
          tma_load(dst + 2 * OWN_REGION + TILE_REGION, &tm_y2, bar, c * ATOM,
                   h, y0, b);
        }
      }
      if (lane != 0) mbar_arrive(bar);
    }
  };
  // the streamed kernel's chunk of tile t, once tile t - 1 is done with it
  auto issue_chunk = [&](int t) {
    const int y0 = t * TILE;
    mbar_wait(bar_cfree, ((t - first) & 1) ^ 1);
    stage_stats(s_stat[0], y0);
    if (lane == 0) {
      // the chunk's slices that hold any column (a box wholly past dh is
      // not loaded; the columns it would fill are never stored)
      const int nc = min(CS, slices - c0 / ATOM);
      mbar_expect_tx(bar_cfull, (DKV ? 2 : 1) * nc * TILE_REGION);
      for (int r = 0; r < nc; ++r) {
        tma_load(s_chunk + r * TILE_REGION, &tm_y1, bar_cfull, c0 + r * ATOM,
                 h, y0, b);
        if (DKV) {
          tma_load(s_chunk + Y2_OFF + r * TILE_REGION, &tm_y2, bar_cfull,
                   c0 + r * ATOM, h, y0, b);
        }
      }
    } else {
      mbar_arrive(bar_cfull);
    }
  };
  if constexpr (RES > 0) {
    if (threadIdx.x == 0 && first < n_end) {
      mbar_expect_tx(bar_own, 2 * RES * OWN_REGION);
      for (int c = 0; c < RES; ++c) {
        tma_load(s_own + c * OWN_REGION, &tm_x1, bar_own, c * ATOM, h, x0, b);
        tma_load(s_own + (RES + c) * OWN_REGION, &tm_x2, bar_own, c * ATOM, h,
                 x0, b);
      }
    }
  }

  // warpgroup wg owns rows x0 + 64 wg ..; this thread the rows g and
  // g + 8 of its warp's 16, as the wgmma fragments lay them out
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = x0 + wg * 64 + warp * 16 + g;
  const uint32_t wg_rows = wg * 64 * ATOM_BYTES;  // into an own slice

  // dq: lse * log2(e) and delta of this thread's two query rows
  float lse_r[2] = {0.f, 0.f}, delta_r[2] = {0.f, 0.f};
  if constexpr (!DKV) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.tq) {
        lse_r[r] = p.lse[stat0 + row] * LOG2E;
        delta_r[r] = p.delta[stat0 + row];
      }
    }
  }

  float acc0[DC / 2];            // dq, or dk
  float acc1[DKV ? DC / 2 : 1];  // dv
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (DKV ? DC / 2 : 1); ++i) acc1[i] = 0.f;

  float sc[TILE / 2], dp[TILE / 2];     // S and dP, then p and ds
  uint32_t pa[DKV ? TILE / 16 : 1][4];  // bf16(p), dk/dv only
  uint32_t da[TILE / 16][4];            // bf16(ds)

  // p and ds of the tile at y0 in the registers of S and dP, masked where
  // the tile crosses the ragged ends or the causal diagonal, then rounded
  // to bf16 as the A operands of the chunk products
  const int wg0 = x0 + wg * 64;  // this warpgroup's first own row
  auto make_pds = [&](int y0, const float (*st)[TILE]) {
    bool masked = y0 + TILE > t_oth || wg0 + 64 > t_own;
    if (p.causal) {
      masked = masked || (DKV ? shift + y0 < wg0 + 63
                              : y0 + TILE - 1 > shift + wg0);
    }
#pragma unroll
    for (int i = 0; i < TILE / 2; ++i) {
      const int col = (i / 4) * 8 + t4 * 2 + (i & 1);  // in the tile
      const int r = (i >> 1) & 1;
      const float l2 = DKV ? st[0][col] : lse_r[r];
      const float dl = DKV ? st[1][col] : delta_r[r];
      bool vis = true;
      if (masked) {
        const int own = row0 + 8 * r;
        const int oth = y0 + col;
        vis = oth < t_oth && own < t_own;
        if (p.causal) vis = vis && (DKV ? shift + oth >= own
                                        : shift + own >= oth);
      }
      const float pe = vis ? exp2_ftz(sc[i] * p.scale_log2 - l2) : 0.f;
      sc[i] = pe;
      dp[i] = pe * (dp[i] - dl) * p.scale;
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kb = 0; kb < TILE / 16; ++kb) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (DKV) {
          pa[kb][j] = pack_bf16(sc[8 * kb + 2 * j], sc[8 * kb + 2 * j + 1]);
        }
        da[kb][j] = pack_bf16(dp[8 * kb + 2 * j], dp[8 * kb + 2 * j + 1]);
      }
    }
  };
  // dq += bf16(ds) . k[:, chunk]; or dv += bf16(p^T) . do[:, chunk] and
  // dk += bf16(ds^T) . q[:, chunk]: Y read MN-major, 16 rows a step
  auto issue_chunk_products = [&](uint32_t y_chunk) {
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < TILE / 16; ++kb) {
      const uint32_t off = kb * 16 * ATOM_BYTES;
      if constexpr (DKV) {
        wgmma_rs<DC>(acc1, pa[kb],
                     desc_sw128(y_chunk + Y2_OFF + off, TILE_REGION, 1024),
                     1);
      }
      wgmma_rs<DC>(acc0, da[kb],
                   desc_sw128(y_chunk + off, TILE_REGION, 1024), 1);
    }
    wgmma_commit();
  };
  auto fence_acc = [&]() {
    fence_regs<DC / 2>(acc0);
    if constexpr (DKV) fence_regs<DC / 2>(acc1);
  };

  if constexpr (RES > 0) {
    // Software-pipelined: while the chunk products of tile m run on the
    // tensor cores, the threads compute p and ds of tile m + 1.  Ring
    // item m is tile first + m; warp 0 keeps the loads STAGES - 2 items
    // ahead of the item whose scores are issued, so it only ever waits
    // for a stage that every warp has already released.
    const int n_tiles = n_end - first;
    auto issue_scores = [&](int m) {  // S and dP of item m into sc, dp
      if (loader) issue_until(m + STAGES - 1);
      const int s = m % STAGES;
      const uint32_t ys = s_ring + s * STAGE;
      mbar_wait(bar_full + 8 * s, (m / STAGES) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < RES * KS; ++kk) {
        const uint32_t off = (kk / 4) * OWN_REGION + wg_rows + (kk % 4) * 32;
        const uint32_t yoff = (kk / 4) * TILE_REGION + (kk % 4) * 32;
        wgmma_ss<TILE>(sc, desc_sw128(s_own + off, 16, 1024),
                       desc_sw128(ys + yoff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < RES * KS; ++kk) {
        const uint32_t off = (RES + kk / 4) * OWN_REGION + wg_rows +
                             (kk % 4) * 32;
        const uint32_t yoff = (RES + kk / 4) * TILE_REGION + (kk % 4) * 32;
        wgmma_ss<TILE>(dp, desc_sw128(s_own + off, 16, 1024),
                       desc_sw128(ys + yoff, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // item 0's scores, p and ds; then each iteration issues the scores of
    // m + 1 and the chunk products of m, and computes p and ds of m + 1
    // from the former while the latter run; the last item's products
    // after the loop.  (The loop body has no branch around a wgmma or a
    // wait, so ptxas can see which group each wait retires and keeps
    // the products asynchronous.)
    auto chunk_of = [&](int m) {
      return s_ring + (m % STAGES) * STAGE + (c0 / ATOM) * TILE_REGION;
    };
    if (n_tiles > 0) {
      mbar_wait(bar_own, 0);
      issue_scores(0);
      wgmma_wait_all();
      fence_regs<TILE / 2>(sc);
      fence_regs<TILE / 2>(dp);
      make_pds(first * TILE, s_stat[0]);
      pack();
      for (int m = 0; m + 1 < n_tiles; ++m) {
        issue_scores(m + 1);
        issue_chunk_products(chunk_of(m));
        wgmma_wait_one();  // the scores of m + 1; the products may run on
        fence_regs<TILE / 2>(sc);
        fence_regs<TILE / 2>(dp);
        make_pds((first + m + 1) * TILE, s_stat[(m + 1) % STAGES]);
        // the chunk products of m are done: its stage is free, and
        // pa/da may be written
        wgmma_wait_all();
        fence_acc();
        if (lane == 0) mbar_arrive(bar_free + 8 * (m % STAGES));
        pack();
      }
      issue_chunk_products(chunk_of(n_tiles - 1));
      wgmma_wait_all();
      fence_acc();
    }
  } else {
    int n = 0;  // ring items consumed so far
    for (int t = first; t < n_end; ++t) {
      // S = X1 . Y1^T and dP = X2 . Y2^T, one 64-column slice a ring
      // item, 16 columns a step, both operands K-major
      if (loader) issue_chunk(t);
      for (int c = 0; c < slices; ++c, ++n) {
        if (loader) issue_until(n + STAGES);
        const int s = n % STAGES;
        const uint32_t xs = s_ring + s * STAGE;
        mbar_wait(bar_full + 8 * s, (n / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<TILE>(sc, desc_sw128(xs + wg_rows + kk * 32, 16, 1024),
                         desc_sw128(xs + 2 * OWN_REGION + kk * 32, 16, 1024),
                         c > 0 || kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<TILE>(
              dp, desc_sw128(xs + OWN_REGION + wg_rows + kk * 32, 16, 1024),
              desc_sw128(xs + 2 * OWN_REGION + TILE_REGION + kk * 32, 16,
                         1024),
              c > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<TILE / 2>(sc);
        fence_regs<TILE / 2>(dp);
        if (lane == 0) mbar_arrive(bar_free + 8 * s);
      }
      mbar_wait(bar_cfull, (t - first) & 1);
      make_pds(t * TILE, s_stat[0]);
      pack();
      fence_acc();
      issue_chunk_products(s_chunk);
      wgmma_wait_all();
      fence_acc();
      // this warp is done with the chunk buffer
      if (lane == 0) mbar_arrive(bar_cfree);
    }
  }

  // store this thread's rows of the chunk, in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= t_own) continue;
    uint16_t* o0 = p.out0 + b * p.o0_sb + h * p.o0_sh + row * p.o0_st +
                   c0 + t4 * 2;
    uint16_t* o1 = p.out1 + b * p.o1_sb + h * p.o1_sh + row * p.o1_st +
                   c0 + t4 * 2;
#pragma unroll
    for (int c = 0; c < DC / 8; ++c) {
      if (c0 + c * 8 >= p.dh) continue;
      *reinterpret_cast<uint32_t*>(o0 + c * 8) =
          pack_bf16(acc0[4 * c + 2 * r], acc0[4 * c + 2 * r + 1]);
      if constexpr (DKV) {
        *reinterpret_cast<uint32_t*>(o1 + c * 8) =
            pack_bf16(acc1[4 * c + 2 * r], acc1[4 * c + 2 * r + 1]);
      }
    }
  }
}

// encodes the four maps (the own operands X in boxes of OWN rows, the
// other operands Y in boxes of TILE rows, both 64 columns wide, so the
// boxes and the expected bytes come from the same constants) and
// launches; a negative return is a CUresult of the encoding, negated and
// less one
template <bool DKV, int RES, int DC, int KS = 4>
int launch(const Operand& x1, const Operand& x2, const Operand& y1,
           const Operand& y2, Params p, int batch, cudaStream_t stream) {
  CUtensorMap maps[4];
  const Operand* ops[4] = {&x1, &x2, &y1, &y2};
  for (int i = 0; i < 4; ++i) {
    const CUresult res = encode(&maps[i], *ops[i], p.dh, p.heads, batch,
                                i < 2 ? OWN : TILE);
    if (res != CUDA_SUCCESS) return -static_cast<int>(res) - 1;
  }
  constexpr int smem = smem_bytes<DKV, RES, DC>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<DKV, RES, DC, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.slices = (p.dh + ATOM - 1) / ATOM;
  p.chunks = (p.dh + DC - 1) / DC;
  const int t_own = DKV ? p.tk : p.tq;
  const dim3 grid((t_own + OWN - 1) / OWN, p.heads * p.chunks, batch);
  flash_bwd_kernel<DKV, RES, DC, KS><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiation of a head dim: one or two slices held, else streamed
template <bool DKV>
int dispatch(const Operand& x1, const Operand& x2, const Operand& y1,
             const Operand& y2, const Params& p, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.dh <= 0 || p.dh % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (p.dh <= 32) return launch<DKV, 1, 64, 2>(x1, x2, y1, y2, p, batch, s);
  if (p.dh <= 64) return launch<DKV, 1, 64>(x1, x2, y1, y2, p, batch, s);
  // dk/dv holding two slices takes chunks of 64: two 128-wide f32
  // accumulators beside the pipelined score tiles spill
  if (p.dh <= 128) {
    return launch<DKV, 2, DKV ? 64 : 128>(x1, x2, y1, y2, p, batch, s);
  }
  return launch<DKV, 0, 128>(x1, x2, y1, y2, p, batch, s);
}

Params make_params(const void* lse, const void* delta, int heads, int tq,
                   int tk, int head_dim, float scale, int causal,
                   long long q_offset, long long k_offset) {
  Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.dh = head_dim;
  p.scale = scale;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  return p;
}

}  // namespace

// Operands q (B, Tq, H, dh), k and v (B, Tk, H, dh), do (B, Tq, H, dh),
// bf16 with the last dim contiguous, base and strides on 16-byte
// boundaries; `strides` holds the (batch, time, head) element strides of
// q, k, v and do in that order (12 values); lse and delta: contiguous
// (B, H, Tq) f32; head_dim the true dh, any multiple of 8.  dq:
// (B, Tq, H, dh) bf16 with (batch, time, head) strides dq_sb, dq_st,
// dq_sh.  Returns the launch's cudaError_t (0 on success), or a negative
// CUresult when a tensor map cannot be encoded; the caller checks shapes,
// dtypes and alignment beforehand.
extern "C" int znicz_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int heads,
    int tq, int tk, int head_dim, const long long* strides, long long dq_sb,
    long long dq_st, long long dq_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  Params p = make_params(lse, delta, heads, tq, tk, head_dim, scale, causal,
                         q_offset, k_offset);
  p.out0 = p.out1 = static_cast<uint16_t*>(dq);
  p.o0_sb = p.o1_sb = dq_sb;
  p.o0_st = p.o1_st = dq_st;
  p.o0_sh = p.o1_sh = dq_sh;
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  const Operand oq = {q, tq, strides[0], strides[1], strides[2]};
  const Operand ok = {k, tk, strides[3], strides[4], strides[5]};
  const Operand ov = {v, tk, strides[6], strides[7], strides[8]};
  const Operand od = {dout, tq, strides[9], strides[10], strides[11]};
  return dispatch<false>(oq, od, ok, ov, p, batch, stream);
}

// As znicz_flash_attention_dq, writing dk and dv: (B, Tk, H, dh) bf16
// with (batch, time, head) strides `out_strides` (dk's three, then dv's).
extern "C" int znicz_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int heads, int tq, int tk, int head_dim, const long long* strides,
    const long long* out_strides, float scale, int causal, long long q_offset,
    long long k_offset, void* stream) {
  Params p = make_params(lse, delta, heads, tq, tk, head_dim, scale, causal,
                         q_offset, k_offset);
  p.out0 = static_cast<uint16_t*>(dk);
  p.out1 = static_cast<uint16_t*>(dv);
  p.o0_sb = out_strides[0];
  p.o0_st = out_strides[1];
  p.o0_sh = out_strides[2];
  p.o1_sb = out_strides[3];
  p.o1_st = out_strides[4];
  p.o1_sh = out_strides[5];
  if (batch <= 0 || heads <= 0 || tk <= 0) return cudaSuccess;
  const Operand oq = {q, tq, strides[0], strides[1], strides[2]};
  const Operand ok = {k, tk, strides[3], strides[4], strides[5]};
  const Operand ov = {v, tk, strides[6], strides[7], strides[8]};
  const Operand od = {dout, tq, strides[9], strides[10], strides[11]};
  return dispatch<true>(ok, ov, oq, od, p, batch, stream);
}
