// Flash-attention forward for Hopper (sm_90a), bf16 operands, f32 state:
// TMA loads into an mbarrier ring, both tile products on wgmma.
//
// Replaces: znicz_tpu/ops/pallas_attention.py:_fwd_kernel (the Pallas TPU
// flash forward reached through flash_attention / ring_hop).  It computes
// the same function: per (batch, head), an online softmax over key tiles
// giving out = softmax(scale * q k^T [masked]) v in q's dtype and the row
// logsumexp lse in f32, with q_offset / k_offset placing the call on a
// global sequence axis for causal masking.
//
// What bounds it on this card: at the serving shape (B=16, H=8, T=2048,
// dh=64) it does 4*B*H*T^2*dh ~ 1.4e11 FLOP against ~134 MB of q/k/v/o
// traffic, ~1000 FLOP per byte, far above the H100's ~295 FLOP/byte
// ridge: the tensor cores bound it, and only wgmma reaches their full
// rate.  The design answers that:
// - every score tile stays in registers; no (T, T) tensor reaches device
//   memory;
// - one producer warp keeps TMA loads of the K and V tiles in flight into
//   a ring of STAGES stages of 128-byte-swizzled shared memory, each stage
//   completed on an mbarrier and released by the consumers on another, so
//   copies overlap the math and no thread spends registers on addresses;
// - two consumer warpgroups own 64 query rows each (a block owns 128) and
//   run S = Q.K^T with wgmma (Q and K from shared memory, K-major), then
//   O += P.V with wgmma (P from registers, already rounded to bf16, as the
//   A operand; V from shared memory as a transposed, MN-major B);
// - causal calls skip whole key tiles no row of the block can see, and
//   only tiles that straddle the diagonal or the ragged key end test the
//   mask element by element.
//
// Head dims: the kernel is built for widths 64, 128 and 256.  The tensor
// maps carry the true head dim, and TMA fills the columns past it with
// zeros, which leave every score unchanged: a head dim of 32 or 40 runs
// in the 64-wide kernel, 200 in the 256-wide one, with no padded copy.
// The output columns are split into chunks of at most 128 (a grid axis),
// so the O accumulator of a consumer thread never exceeds 64 registers;
// each chunk recomputes the scores over the full head dim, so at width
// 256 the score product is done twice (1.5x the FLOP of one pass).
//
// Head dims past 256 take the streamed instantiation (D = 0), whose
// shared memory does not grow with dh: the score operands pass through a
// ring of 64-column slices, one slice of Q and one of K a stage, and s
// sums over the slices before the softmax.  Q is read again (from L2)
// for every key tile; the output chunks, the V chunk and everything past
// s are the 256-wide kernel's.
//
// Numerics follow the reference kernel step for step, with exp2 and
// log2(e) folded into the scale:
//   s = (q . k) * scale            scale applied after the product
//   masked s = -1e30, masked p = 0 (causal, ragged key tail)
//   m_new = max(m, rowmax s); p = exp(s - m_new); corr = exp(m - m_new)
//   l = l * corr + rowsum(p)       f32 p
//   acc = acc * corr + bf16(p) v   f32 accumulator
//   out = bf16(acc / max(l, 1e-30)); lse = m + log(max(l, 1e-30))
// so a fully masked row gives out = 0 and lse = -1e30, not NaN.
//
// Layout: q, k, v are read in the boundary layout (B, T, H, dh) through
// element strides (the last dim contiguous), which lets the caller pass
// the q/k/v slices of one packed QKV projection without any copy: each
// is described to TMA as a 4-d tensor (dh, H, T, B) with those strides.
// out is (B, Tq, H, dh) through strides; lse is contiguous (B, H, Tq).
//
// cuTensorMapEncodeTiled is a driver function; it is fetched through
// cudaGetDriverEntryPoint, so the library links against the runtime
// alone.

#include "hopper.cuh"

namespace {

constexpr int BLOCK_M = 128;             // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 2;                // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// key tile BN and output column chunk DC of each instantiated width D.
// A consumer thread holds BN / 2 score and DC / 2 output accumulators
// and BN / 4 registers of bf16 p; with nine warps a block, ptxas allows
// about 168 registers a thread, which a 128 x 128 pair at width 128
// overflows (it spills), so that width takes 64 keys a tile.
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int BN = 128, DC = 64;
};
template <>
struct Tile<128> {
  static constexpr int BN = 64, DC = 128;
};
template <>
struct Tile<256> {
  static constexpr int BN = 64, DC = 128;
};
// the streamed kernel of head dims past 256 (D = 0): 256's tiles
template <>
struct Tile<0> {
  static constexpr int BN = 64, DC = 128;
};

// dynamic shared memory of width D: Q (BLOCK_M x D), then STAGES of K
// (BN x D) and of the V chunk (BN x DC), each stored as 64-column regions
// of 128-byte swizzled rows, plus 1 KB to align the base to 1024 bytes.
// The streamed kernel (D = 0) holds no whole Q: its STAGES of the score
// ring hold one 64-column slice of Q and of K each.
template <int D>
constexpr int smem_bytes() {
  if constexpr (D == 0) {
    return STAGES * ((BLOCK_M + Tile<0>::BN) * ATOM_BYTES +
                     Tile<0>::BN * Tile<0>::DC * 2) + 1024;
  } else {
    return BLOCK_M * D * 2 +
           STAGES * (Tile<D>::BN * D * 2 + Tile<D>::BN * Tile<D>::DC * 2) +
           1024;
  }
}

struct Params {
  uint16_t* o;
  float* lse;
  long long o_sb, o_st, o_sh;
  int heads, tq, tk, dh, chunks;
  int slices;        // 64-column slices of the head dim (streamed kernel)
  float scale_log2;  // scale * log2(e)
  int causal;
  long long q_offset, k_offset;
};


template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  // D = 0: head dims past 256, streamed.  The score ring's stages then
  // hold a 64-column slice of Q and of K each, s accumulates over the
  // slices, and Q is read again (from L2) for every key tile.
  constexpr bool WIDE = D == 0;
  constexpr int BN = Tile<D>::BN;
  constexpr int DC = Tile<D>::DC;
  constexpr int Q_REGION = BLOCK_M * ATOM_BYTES;  // one 64-column region
  constexpr int K_REGION = BN * ATOM_BYTES;
  constexpr int K_STAGE = WIDE ? Q_REGION + K_REGION : BN * D * 2;
  constexpr int V_STAGE = BN * DC * 2;
  // barriers: Q loaded; K and V of each stage loaded; each stage released;
  // the streamed kernel's score-ring stages released
  __shared__ __align__(8) uint64_t bars[1 + (WIDE ? 4 : 3) * STAGES];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + (WIDE ? 0 : BLOCK_M * D * 2);
  const uint32_t s_v = s_k + STAGES * K_STAGE;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);  // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[1 + STAGES]);
  const uint32_t bar_free = smem_u32(&bars[1 + 2 * STAGES]);
  const uint32_t bar_qk_free = smem_u32(&bars[1 + (WIDE ? 3 : 2) * STAGES]);

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y / p.chunks;
  const int chunk = blockIdx.y % p.chunks;
  const int c0 = chunk * DC;
  const int b = blockIdx.z;

  int n_tiles = (p.tk + BN - 1) / BN;
  if (p.causal) {
    // whole-tile skip: no row of this block sees a key past `last`
    const long long last = p.q_offset + q0 + BLOCK_M - 1 - p.k_offset;
    if (last < 0) {
      n_tiles = 0;
    } else if (last / BN + 1 < n_tiles) {
      n_tiles = static_cast<int>(last / BN) + 1;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_free + 8 * s, CONSUMERS / 32);  // one arrival a warp
      if (WIDE) mbar_init(bar_qk_free + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer: one thread issues every load of the block
    if (WIDE && threadIdx.x == CONSUMERS) {
      int n = 0;  // score-ring loads so far
      for (int j = 0; j < n_tiles; ++j) {
        for (int c = 0; c < p.slices; ++c, ++n) {
          const int s = n % STAGES;
          mbar_wait(bar_qk_free + 8 * s, ((n / STAGES) & 1) ^ 1);
          const uint32_t dst = s_k + s * K_STAGE;
          mbar_expect_tx(bar_k + 8 * s, K_STAGE);
          tma_load(dst, &tm_q, bar_k + 8 * s, c * ATOM, h, q0, b);
          tma_load(dst + Q_REGION, &tm_k, bar_k + 8 * s, c * ATOM, h, j * BN,
                   b);
        }
        const int s = j % STAGES;
        mbar_wait(bar_free + 8 * s, ((j / STAGES) & 1) ^ 1);
        // the chunk's slices that hold any column (a box wholly past dh is
        // not loaded; the columns it would fill are never stored)
        const int nv = min(DC / ATOM, p.slices - c0 / ATOM);
        mbar_expect_tx(bar_v + 8 * s, nv * K_REGION);
        for (int r = 0; r < nv; ++r) {
          tma_load(s_v + s * V_STAGE + r * K_REGION, &tm_v, bar_v + 8 * s,
                   c0 + r * ATOM, h, j * BN, b);
        }
      }
    } else if (!WIDE && threadIdx.x == CONSUMERS && n_tiles > 0) {
      mbar_expect_tx(bar_q, BLOCK_M * D * 2);
#pragma unroll
      for (int r = 0; r < D / ATOM; ++r) {
        tma_load(s_q + r * Q_REGION, &tm_q, bar_q, r * ATOM, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        // wait until the consumers released this stage's previous tile
        mbar_wait(bar_free + 8 * s, ((j / STAGES) & 1) ^ 1);
        const uint32_t k_dst = s_k + s * K_STAGE;
        mbar_expect_tx(bar_k + 8 * s, K_STAGE);
#pragma unroll
        for (int r = 0; r < D / ATOM; ++r) {
          tma_load(k_dst + r * K_REGION, &tm_k, bar_k + 8 * s, r * ATOM, h,
                   j * BN, b);
        }
        const uint32_t v_dst = s_v + s * V_STAGE;
        mbar_expect_tx(bar_v + 8 * s, V_STAGE);
#pragma unroll
        for (int r = 0; r < DC / ATOM; ++r) {
          tma_load(v_dst + r * K_REGION, &tm_v, bar_v + 8 * s,
                   c0 + r * ATOM, h, j * BN, b);
        }
      }
    }
    return;
  }

  // a consumer: warpgroup wg owns rows q0 + 64 wg ..; this thread the
  // rows g and g + 8 of its warp's 16, as the wgmma fragments lay them out
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  // causal: row r sees the keys up to index last_key[r] of this call (the
  // offsets folded in, clamped to 32 bits); the warpgroup's first row sees
  // up to wg_last, and a tile that ends there needs no mask
  const long long shift = p.q_offset - p.k_offset;
  int last_key[2], wg_last;
  {
    const long long lim[3] = {shift + row0, shift + row0 + 8,
                              shift + q0 + wg * 64};
    int clamped[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      clamped[i] = static_cast<int>(
          lim[i] < -1 ? -1 : lim[i] > p.tk ? p.tk : lim[i]);
    }
    last_key[0] = clamped[0];
    last_key[1] = clamped[1];
    wg_last = clamped[2];
  }
  const uint32_t q_rows = s_q + wg * 64 * ATOM_BYTES;

  float acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};  // running max, log2 units
  float l_i[2] = {0.f, 0.f};          // per-thread partial row sums

  if (!WIDE && n_tiles > 0) mbar_wait(bar_q, 0);
  int n = 0;  // the streamed kernel's score-ring stages consumed so far
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int k0 = j * BN;
    const uint32_t k_src = s_k + s * K_STAGE;
    const uint32_t v_src = s_v + s * V_STAGE;

    // s = q . k^T over the full head dim, 16 columns a step
    float sc[BN / 2];
    if constexpr (WIDE) {
      // one 64-column slice of q and k a ring stage, s summed over them
      for (int c = 0; c < p.slices; ++c, ++n) {
        const int sn = n % STAGES;
        const uint32_t qk = s_k + sn * K_STAGE;
        mbar_wait(bar_k + 8 * sn, (n / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < ATOM / 16; ++kk) {
          const uint32_t off = kk * 32;
          wgmma_ss<BN>(sc,
                       desc_sw128(qk + wg * 64 * ATOM_BYTES + off, 16, 1024),
                       desc_sw128(qk + Q_REGION + off, 16, 1024),
                       c > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<BN / 2>(sc);
        if (lane == 0) mbar_arrive(bar_qk_free + 8 * sn);
      }
    } else {
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes
        wgmma_ss<BN>(sc,
                     desc_sw128(q_rows + (kk / 4) * Q_REGION + off, 16, 1024),
                     desc_sw128(k_src + (kk / 4) * K_REGION + off, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BN / 2>(sc);
    }

    // scale (log2 units), mask where the tile straddles the diagonal or
    // the ragged end, tile row max
    const bool masked = k0 + BN > p.tk || (p.causal && k0 + BN - 1 > wg_last);
    float tile_max[2] = {NEG_INF, NEG_INF};
    if (masked) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + t4 * 2 + (i & 1);
        const int r = (i >> 1) & 1;
        bool vis = col < p.tk;
        if (p.causal) vis = vis && col <= last_key[r];
        sc[i] = vis ? sc[i] * p.scale_log2 : NEG_INF;
        tile_max[r] = fmaxf(tile_max[r], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] *= p.scale_log2;
        tile_max[(i >> 1) & 1] = fmaxf(tile_max[(i >> 1) & 1], sc[i]);
      }
    }
    float corr[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_i[r], tile_max[r]);
      corr[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
      // a row that has seen no key yet: every s is the -1e30 marker, and
      // exp2(s - 0) gives the masked p = 0
      m_use[r] = m_new == NEG_INF ? 0.f : m_new;
      l_i[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    // p = exp(s - m), rounded to bf16 as the A fragments of p . v, 16 keys
    // at a time so that the f32 scores die as their fragments are made
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      float* e = sc + 8 * kb;  // keys 16 kb .. + 7, then 16 kb + 8 .. + 15
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        e[i] = exp2f(e[i] - m_use[(i >> 1) & 1]);
        l_i[(i >> 1) & 1] += e[i];
      }
      pa[kb][0] = pack_bf16(e[0], e[1]);
      pa[kb][1] = pack_bf16(e[2], e[3]);
      pa[kb][2] = pack_bf16(e[4], e[5]);
      pa[kb][3] = pack_bf16(e[6], e[7]);
    }

    // acc += bf16(p) . v[:, chunk], 16 keys a step
    mbar_wait(bar_v + 8 * s, parity);
    fence_regs<DC / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < BN / 16; ++kb) {
      wgmma_rs<DC>(acc, pa[kb],
                   desc_sw128(v_src + kb * 16 * ATOM_BYTES, K_REGION, 1024),
                   1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DC / 2>(acc);
    // this warp is done with the stage
    if (lane == 0) mbar_arrive(bar_free + 8 * s);
  }

  // finish: full row sums across the 4 threads of a group, then store
  uint16_t* og = p.o + b * p.o_sb + h * p.o_sh;
  float* lg = p.lse + (static_cast<long long>(b) * p.heads + h) * p.tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row < p.tq) {
      uint16_t* orow = og + row * p.o_st + c0 + t4 * 2;
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        if (c0 + n * 8 < p.dh) {
          *reinterpret_cast<uint32_t*>(orow + n * 8) = pack_bf16(
              acc[4 * n + 2 * r] / l, acc[4 * n + 2 * r + 1] / l);
        }
      }
      if (chunk == 0 && t4 == 0) {
        lg[row] = (m_i[r] == NEG_INF ? NEG_INF : m_i[r] * LN2) + logf(l);
      }
    }
  }
}


// encodes the three maps with the boxes of width D (Q: BLOCK_M rows, K
// and V: the key tile) and launches; a negative return is a CUresult of
// the encoding, negated and less one
template <int D>
int launch(const Operand& q, const Operand& k, const Operand& v, Params p,
           int batch, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  CUresult res = encode(&tm_q, q, p.dh, p.heads, batch, BLOCK_M);
  if (res == CUDA_SUCCESS) {
    res = encode(&tm_k, k, p.dh, p.heads, batch, Tile<D>::BN);
  }
  if (res == CUDA_SUCCESS) {
    res = encode(&tm_v, v, p.dh, p.heads, batch, Tile<D>::BN);
  }
  if (res != CUDA_SUCCESS) return -static_cast<int>(res) - 1;
  constexpr int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  p.chunks = D == 0 ? (p.dh + Tile<0>::DC - 1) / Tile<0>::DC
                    : D / Tile<D>::DC;
  p.slices = (p.dh + ATOM - 1) / ATOM;
  const dim3 grid((p.tq + BLOCK_M - 1) / BLOCK_M, p.heads * p.chunks, batch);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated width a head dim runs at (0: the streamed kernel of
// head dims past 256; -1: none)
int kernel_width(int head_dim) {
  if (head_dim <= 0 || head_dim % 8) return -1;
  return head_dim <= 64 ? 64 : head_dim <= 128 ? 128 : head_dim <= 256 ? 256
                                                                         : 0;
}

}  // namespace

// Shared memory, in bytes, a call of head dim `head_dim` asks for (0 when
// no kernel takes it).
extern "C" int znicz_flash_attention_fwd_smem(int head_dim) {
  switch (kernel_width(head_dim)) {
    case 64:
      return smem_bytes<64>();
    case 128:
      return smem_bytes<128>();
    case 256:
      return smem_bytes<256>();
    case 0:
      return smem_bytes<0>();
    default:
      return 0;
  }
}

// q (B, Tq, H, dh), k and v (B, Tk, H, dh), out (B, Tq, H, dh): bf16, the
// last dim contiguous, base and (batch, time, head) strides (in elements)
// on 16-byte boundaries; head_dim the true dh, a multiple of 8.
// Returns the cudaError_t of the launch (0 on success), or a negative
// CUresult when a tensor map cannot be encoded; the caller checks shapes,
// dtypes and alignment beforehand.
extern "C" int znicz_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int tq, int tk, int head_dim, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  const int width = kernel_width(head_dim);
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  const Operand oq = {q, tq, q_sb, q_st, q_sh};
  const Operand ok = {k, tk, k_sb, k_st, k_sh};
  const Operand ov = {v, tk, v_sb, v_st, v_sh};
  Params p;
  p.o = static_cast<uint16_t*>(out);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.dh = head_dim;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return launch<64>(oq, ok, ov, p, batch, s);
    case 128:
      return launch<128>(oq, ok, ov, p, batch, s);
    case 256:
      return launch<256>(oq, ok, ov, p, batch, s);
    default:
      return launch<0>(oq, ok, ov, p, batch, s);
  }
}
