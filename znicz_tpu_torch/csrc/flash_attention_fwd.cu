// Flash-attention forward for Hopper (sm_90a), bf16 operands, f32 state.
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
// ridge: the tensor cores bound it.  The design answers that by keeping
// every score tile in registers (no (T, T) tensor reaches device memory)
// and running both tile products on the tensor cores through
// mma.sync.m16n8k16 with f32 accumulators.  This is the simple first
// version: one block of 4 warps per (b, h, 64 query rows), 64-row K/V
// tiles staged through padded shared memory without double buffering.
// wgmma + TMA pipelining is later work.
//
// Numerics follow the reference kernel step for step:
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
// the q/k/v slices of one packed QKV projection without any copy.  out
// is (B, Tq, H, dh) through strides; lse is contiguous (B, H, Tq).  Head
// dims 32, 64 and 128 are instantiated; the wrapper zero-pads any other
// multiple of 8 up to the next one, which leaves every score unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1e30f;

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  uint16_t* o;
  float* lse;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int heads, tq, tk;
  float scale;
  int causal;
  long long q_offset, k_offset;
};

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats -> one register of two bf16 (round to nearest even), the
// lower column in the low half as the mma fragments expect
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// rows x D bf16 from global (row stride in elements) into padded shared
// memory; rows at or past `valid` are zero-filled so masked keys never
// carry garbage (0 * NaN would poison the p.v product)
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src,
                                          long long row_stride, int rows,
                                          int valid) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) {
      val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 8;  // padded shared row: conflict-free fragments
  constexpr int KD = D / 16;  // k-steps of the q.k product
  constexpr int ND = D / 8;   // n-tiles of the p.v product
  constexpr int NS = BLOCK_N / 8;  // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* s_q = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* s_k = s_q + BLOCK_M * LD;
  uint16_t* s_v = s_k + BLOCK_N * LD;

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group
  const int wr = warp * 16;

  const uint16_t* qg = p.q + b * p.q_sb + h * p.q_sh;
  const uint16_t* kg = p.k + b * p.k_sb + h * p.k_sh;
  const uint16_t* vg = p.v + b * p.v_sb + h * p.v_sh;

  load_tile<D>(s_q, qg + q0 * p.q_st, p.q_st, BLOCK_M, p.tq - q0);
  __syncthreads();

  // this warp's 16 query rows as A fragments, held for the whole loop
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const uint16_t* base = s_q + (wr + g) * LD + kk * 16 + t4 * 2;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_i[2] = {NEG_INF, NEG_INF};
  float l_i[2] = {0.f, 0.f};  // per-thread partial row sums
  // global positions of this thread's two rows (g and g + 8)
  const long long row_pos[2] = {p.q_offset + q0 + wr + g,
                                p.q_offset + q0 + wr + g + 8};

  int n_tiles = (p.tk + BLOCK_N - 1) / BLOCK_N;
  if (p.causal) {
    // whole-tile skip: no row of this block sees a key past `last`
    const long long last = p.q_offset + q0 + BLOCK_M - 1 - p.k_offset;
    if (last < 0) {
      n_tiles = 0;
    } else if (last / BLOCK_N + 1 < n_tiles) {
      n_tiles = static_cast<int>(last / BLOCK_N) + 1;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BLOCK_N;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(s_k, kg + k0 * p.k_st, p.k_st, BLOCK_N, p.tk - k0);
    load_tile<D>(s_v, vg + k0 * p.v_st, p.v_st, BLOCK_N, p.tk - k0);
    __syncthreads();

    // s = q . k^T for 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const uint16_t* kb = s_k + (nt * 8 + g) * LD + kk * 16 + t4 * 2;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(kb),
                                *reinterpret_cast<const uint32_t*>(kb + 8)};
        mma_bf16_16816(s[nt], qf[kk], bf);
      }
    }

    // scale, mask, tile row max
    uint32_t visible = 0u;
    float tile_max[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        bool vis = col < p.tk;
        if (p.causal) vis = vis && row_pos[r] >= p.k_offset + col;
        const float val = vis ? s[nt][e] * p.scale : NEG_INF;
        s[nt][e] = val;
        if (vis) visible |= 1u << (nt * 4 + e);
        tile_max[r] = fmaxf(tile_max[r], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r],
                          __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      const float m_new = fmaxf(m_i[r], tile_max[r]);
      corr[r] = expf(m_i[r] - m_new);
      m_i[r] = m_new;
      l_i[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pe = (visible >> (nt * 4 + e)) & 1u
                             ? expf(s[nt][e] - m_i[r])
                             : 0.f;
        s[nt][e] = pe;
        l_i[r] += pe;
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += bf16(p) . v: the score accumulators are already laid out as
    // the A fragments of the next product
#pragma unroll
    for (int kb = 0; kb < BLOCK_N / 16; ++kb) {
      const uint32_t a[4] = {pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                             pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                             pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                             pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
      const uint16_t* vrow = s_v + (kb * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const uint16_t* vb = vrow + n * 8;
        const uint32_t bf[2] = {pack_raw(vb[0], vb[LD]),
                                pack_raw(vb[8 * LD], vb[9 * LD])};
        mma_bf16_16816(acc[n], a, bf);
      }
    }
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
    const int row = q0 + wr + g + 8 * r;
    if (row < p.tq) {
      uint16_t* orow = og + row * p.o_st + t4 * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
      }
      if (t4 == 0) lg[row] = m_i[r] + logf(l);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + BLOCK_M - 1) / BLOCK_M, p.heads, batch);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements.  Returns the cudaError_t of the launch (0 on
// success); the caller checks shapes, dtypes and alignment beforehand.
extern "C" int znicz_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int tq, int tk, int head_dim, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  Params p;
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.o = static_cast<uint16_t*>(out);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_st = k_st;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_st = v_st;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch<32>(p, batch, s));
    case 64:
      return static_cast<int>(launch<64>(p, batch, s));
    case 128:
      return static_cast<int>(launch<128>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
