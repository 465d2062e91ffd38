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

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 128;             // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 2;                // K/V ring depth
constexpr int ATOM = 64;                 // bf16 columns of a 128-byte row
constexpr int ATOM_BYTES = 128;
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

// dynamic shared memory of width D: Q (BLOCK_M x D), then STAGES of K
// (BN x D) and of the V chunk (BN x DC), each stored as 64-column regions
// of 128-byte swizzled rows, plus 1 KB to align the base to 1024 bytes
template <int D>
constexpr int smem_bytes() {
  return BLOCK_M * D * 2 +
         STAGES * (Tile<D>::BN * D * 2 + Tile<D>::BN * Tile<D>::DC * 2) + 1024;
}

struct Params {
  uint16_t* o;
  float* lse;
  long long o_sb, o_st, o_sh;
  int heads, tq, tk, dh, chunks;
  float scale_log2;  // scale * log2(e)
  int causal;
  long long q_offset, k_offset;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma registers across
// the fence, commit and wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[32] (+)= A . B, A (64 x 16) and B (16 x 64) both read from shared
// memory, K-major, through their descriptors: wgmma m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] (+)= A . B, A (64 x 16) and B (16 x 128) both read from shared
// memory, K-major, through their descriptors: wgmma m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] (+)= A . B, A (64 x 16) from registers (the mma A fragment
// layout, one per warp of 16 rows), B (16 x 64) from shared memory,
// MN-major (transposed): wgmma m64n64k16
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[64] (+)= A . B, A (64 x 16) from registers (the mma A fragment
// layout, one per warp of 16 rows), B (16 x 128) from shared memory,
// MN-major (transposed): wgmma m64n128k16
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, accumulate);
  } else {
    wgmma_rs_n128(d, a, b, accumulate);
  }
}

// two floats -> one register of two bf16 (round to nearest even), the
// lower column in the low half as the A fragments expect
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const Params p) {
  constexpr int BN = Tile<D>::BN;
  constexpr int DC = Tile<D>::DC;
  constexpr int Q_REGION = BLOCK_M * ATOM_BYTES;  // one 64-column region
  constexpr int K_REGION = BN * ATOM_BYTES;
  constexpr int K_STAGE = BN * D * 2;
  constexpr int V_STAGE = BN * DC * 2;
  // barriers: Q loaded; K and V of each stage loaded; each stage released
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + BLOCK_M * D * 2;
  const uint32_t s_v = s_k + STAGES * K_STAGE;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_k = smem_u32(&bars[1]);  // + 8 * stage
  const uint32_t bar_v = smem_u32(&bars[1 + STAGES]);
  const uint32_t bar_free = smem_u32(&bars[1 + 2 * STAGES]);

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
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer: one thread issues every load of the block
    if (threadIdx.x == CONSUMERS && n_tiles > 0) {
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

  if (n_tiles > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const int k0 = j * BN;
    const uint32_t k_src = s_k + s * K_STAGE;
    const uint32_t v_src = s_v + s * V_STAGE;

    // s = q . k^T over the full head dim, 16 columns a step
    float sc[BN / 2];
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

PFN_cuTensorMapEncodeTiled encode_fn() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(ptr);
    }
  }
  return fn;
}

// one (B, T, H, dh) bf16 operand: base, length and element strides
struct Operand {
  const void* ptr;
  int t;
  long long sb, st, sh;
};

// `a` as the 4-d tensor (dh, H, T, B), read in boxes of 64 columns x
// `rows` time steps of one head, swizzled by 128 bytes; columns and rows
// past the tensor are filled with zeros
CUresult encode(CUtensorMap* map, const Operand& a, int dh, int heads,
                int batch, int rows) {
  PFN_cuTensorMapEncodeTiled fn = encode_fn();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(a.t),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.sh) * 2,
                                 static_cast<cuuint64_t>(a.st) * 2,
                                 static_cast<cuuint64_t>(a.sb) * 2};
  const cuuint32_t box[4] = {ATOM, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(a.ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
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
  p.chunks = D / Tile<D>::DC;
  const dim3 grid((p.tq + BLOCK_M - 1) / BLOCK_M, p.heads * p.chunks, batch);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p);
  return static_cast<int>(cudaGetLastError());
}

// the instantiated width a head dim runs at (0: none)
int kernel_width(int head_dim) {
  if (head_dim <= 0 || head_dim % 8) return 0;
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
    default:
      return 0;
  }
}

// q (B, Tq, H, dh), k and v (B, Tk, H, dh), out (B, Tq, H, dh): bf16, the
// last dim contiguous, base and (batch, time, head) strides (in elements)
// on 16-byte boundaries; head_dim the true dh, a multiple of 8 up to 256.
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
  if (width == 0) return static_cast<int>(cudaErrorInvalidValue);
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
    default:
      return launch<256>(oq, ok, ov, p, batch, s);
  }
}
