// Flash-attention forward for Hopper (sm_90a) with float32 operands.
//
// Replaces: znicz_tpu/ops/pallas_attention.py:_fwd_kernel when it runs on
// f32 operands (the reference trains in f32 by default).  There every tile
// product runs at the input dtype with f32 accumulation, so an f32 call
// multiplies in f32; here every product is an f32 FMA on the CUDA cores
// (Hopper's tensor cores take no f32 operand, and TF32 would keep three
// digits), the function of the bf16 kernel of flash_attention_fwd.cu with
// nothing rounded to bf16:
//   s = (q . k) * scale, masked s = -1e30 and masked p = 0, online softmax
//   over key tiles, out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
//   (a fully masked row: out 0, lse -1e30 exactly)
// exp is taken as exp2 of a pre-scaled score (log2 e folded into the
// scale) with ex2.approx.ftz, and lse turned back to the natural log.
// The f32 backward (dq, dk/dv) is flash_attention_bwd_f32.cu; the pieces
// both share (swizzled tiles, the cp.async ring, the register-tiled score
// product) are in simt_f32.cuh.
//
// What bounds it on this card: the products.  At T = 2048 and dh = 64 a
// call does ~1000 FLOP per byte of q/k/v/o, and the f32 SIMT peak is
// 67 TFLOP/s, so the FMA rate bounds it.
//
// One block of 256 threads (8 warps) owns 16 RT query rows and walks over
// 64-key tiles: S = Q.K^T, an online softmax of S, P into shared memory,
// out[:, chunk] += P . V[:, chunk].  The dq kernel's shape with one score
// product instead of two.  What the design does about the limits of the
// first f32 forward (a thread a quarter of a row, scalar loads through a
// padded pitch, synchronous staging, the scores recomputed for every
// 128-column chunk of the output):
// 1. One shared load per FMA.  RT = 8 up to a width of 128, else 4 (the
//    accumulators of a 256-wide chunk would not fit at 8).  A thread owns
//    SR rows x SC keys of the score tile (SR SC = 4 RT) and RT rows x 4
//    columns of every 64-column slice of its output chunk.  A 4-column
//    step of the score product reads SR rows of Q and SC of K, a 4-key
//    step of the chunk product RT rows of P and 4 of V, as 128-bit loads:
//    16 RT FMAs for SR + SC or RT + 4 loads (10.7 FMAs a load at RT = 8,
//    8 at 4).  A warp's threads are 4 row groups x 8 key groups, so each
//    of its loads touches 4 or 8 distinct 16-byte words, in distinct
//    banks by the swizzle.
// 2. The online softmax.  A row's 64 keys lie in the 8 lanes of one row
//    group of PAIR warps.  At RT = 8 PAIR = 1 (SR = 4, SC = 8): a warp
//    owns whole rows, and a row's max and sum are three shuffles each.
//    At RT = 4 that layout would read 6.4 FMAs a load (SR = 2), so
//    PAIR = 2 (SR = 4, SC = 4): each half-row's max is three shuffles,
//    then the two warps exchange their halves through shared memory
//    behind a 64-thread named barrier, once a tile.  The sums stay
//    partial until the end.  On an H100 SXM the exchange ran 10-15 %
//    faster than whole rows at dh 256 and 512, and whole rows 1-8 %
//    faster than the exchange at dh 32, 64 and 128.  Each row's correction
//    factor for the tile reaches the chunk products through shared
//    memory with P.
// 3. Asynchronous staging.  Everything a block reads passes through a
//    ring of STAGES slots filled by 16-byte cp.async (rows past T
//    zero-filled): the score product's 32-column slices of Q and K, then
//    the chunk product's 64-column slices of V.  The slot STAGES - 1
//    items ahead is in flight while this one's products run; one barrier
//    an item.  Shared memory does not grow with the head dim (105 KB at
//    RT = 8, 65 KB at 4): one code path serves every width that is a
//    multiple of 32.
// 4. Scores recomputed per output chunk.  Only past 256: the output is
//    split into column chunks of DC = 256 (64 accumulators a thread),
//    each chunk recomputing the scores over the whole head dim; on a grid
//    of fewer blocks than half the SMs the chunks are halved (down to 64)
//    to fill the card.  The lse is written by the first chunk.
//
// Geometry, the bf16 kernel's: q, k, v and out in the boundary layout
// (B, T, H, dh) through element strides (the last dim contiguous, rows
// 16-byte aligned); lse contiguous (B, H, Tq) f32; any T; q_offset /
// k_offset place the call on a global axis for causal masking, and causal
// skips whole key tiles that no row of the block can see.

#include <cuda_runtime.h>

#include "simt_f32.cuh"

namespace {

// widths up to this take 8 query rows a thread, wider ones 4
constexpr int TALL = 128;
constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

// the shapes of a kernel whose threads own RT rows each (4 or 8): a
// block owns 16 RT query rows; a ring slot holds a score item (the slices
// of Q and K) or a chunk item (a 64 x 64 slice of V)
template <int RT>
struct Shape {
  static constexpr int PAIR = RT == 8 ? 1 : 2;  // warps that share a row
  static constexpr int OWN = 16 * RT;        // query rows a block
  static constexpr int Q_SLICE = OWN * SL;   // floats of a Q slice
  static constexpr int SCORE = Q_SLICE + TILE * SL;
  static constexpr int SLOT = SCORE > TILE * 64 ? SCORE : TILE * 64;
  static constexpr int P_TILE = OWN * TILE;  // floats of the P tile
};

struct Params {
  Operand q, k, v;
  float* o;
  long long o_sb, o_st, o_sh;
  float* lse;
  int heads, tq, tk, width, chunks;
  float scale_log2;
  int causal;
  long long q_offset, k_offset;
};

// waits for the 64 threads of warps 2 n and 2 n + 1, n = warp / 2
// (named barrier 1 + n; 0 is __syncthreads's)
__device__ __forceinline__ void pair_barrier(int warp) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (warp >> 1)) : "memory");
}

// DC: the output chunk's columns; RT: query rows a thread (a block owns
// 16 RT)
template <int DC, int RT>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_f32_kernel(const Params p) {
  using S = Shape<RT>;
  constexpr int OWN = S::OWN;
  constexpr int PAIR = S::PAIR;
  constexpr int SR = RT * PAIR / 2;      // score rows a thread
  constexpr int SC = 8 / PAIR;           // score keys a thread
  constexpr int CS = DC < 64 ? DC : 64;  // columns of a chunk slice
  constexpr int NSL = DC / CS;           // chunk slices
  constexpr int CG = CS / 4;             // column groups of a chunk slice
  constexpr int JS = 16 / CG;            // splits of a tile's keys (1, 2)
  constexpr int J4 = TILE / JS / 4;      // 4-key steps of a chunk product
  // the unrolled body's size (BODY_MAX): one score product, the chunk
  // products
  constexpr int BODY = (SL / 4 + NSL * J4) * (17 * RT + 4);
  constexpr int U = BODY > BODY_MAX ? 4 : J4;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* p_tile = smem + STAGES * S::SLOT;
  float* row_corr = p_tile + S::P_TILE;  // each row's factor for a tile
  float* parts = row_corr + OWN;  // PAIR a row: the parts' max, then sum

  const int q0 = blockIdx.x * OWN;
  const int h = blockIdx.y / p.chunks;
  const int c0 = blockIdx.y % p.chunks * DC;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = lane / 8;  // a warp is 4 row groups x 8 column groups
  const int cg = lane % 8;

  // score tile: warp (w / PAIR, w % PAIR) covers rows
  // 4 SR (w / PAIR) + [0, 4 SR) and keys 32 (w % PAIR) + [0, 64 / PAIR);
  // a thread rows rg + 4 i and keys cg + 8 m of that block, so the part
  // of a row a warp holds lies in the 8 lanes of a row group
  const int part = warp % PAIR;
  int srow[SR], scol[SC];
#pragma unroll
  for (int i = 0; i < SR; ++i)
    srow[i] = warp / PAIR * 4 * SR + rg + 4 * i;
#pragma unroll
  for (int m = 0; m < SC; ++m) scol[m] = part * 32 + cg + 8 * m;
  // chunk products: warp (w / 2, w % 2) covers rows 4 RT (w / 2) +
  // [0, 4 RT) and 16-byte columns 8 (w % 2) + [0, 8) of a 64-column
  // slice (JS = 1), or warp (w % 4) rows 4 RT (w % 4) + [0, 4 RT), all
  // 8 columns of a 32-column slice and the tile's keys
  // [32 (w / 4), 32 (w / 4) + 32) (JS = 2); a thread rows rg + 4 i and
  // 16-byte column ccol
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
  const float* qg = base(p.q) + q0 * p.q.st;
  const float* kg = base(p.k);
  const float* vg = base(p.v);

  // the key tiles this block can see: causal, keys k with
  // k_offset + k <= q_offset + q0 + OWN - 1
  const int n_keys = (p.tk + TILE - 1) / TILE;
  int last = n_keys;
  if (p.causal) {
    const long long hi = p.q_offset + q0 + OWN - 1 - p.k_offset;
    last = hi < 0 ? 0 : static_cast<int>(hi / TILE + 1 < n_keys
                                             ? hi / TILE + 1 : n_keys);
  }
  const int n_score = p.width / SL;
  const int per_tile = n_score + NSL;
  const int items = last * per_tile;

  // item it: the score slice or chunk slice `it % per_tile` of key tile
  // `it / per_tile`, staged into slot it % STAGES
  const auto fetch = [&](int it) {
    if (it < items) {
      const int k0 = it / per_tile * TILE;
      const int sub = it % per_tile;
      float* slot = ring + it % STAGES * S::SLOT;
      if (sub < n_score) {  // Q, K
        const int col = sub * SL;
        stage<OWN, SL>(slot, qg + col, p.q.st, p.tq - q0);
        stage<TILE, SL>(slot + S::Q_SLICE, kg + k0 * p.k.st + col, p.k.st,
                        p.tk - k0);
      } else {  // V
        const int col = c0 + (sub - n_score) * CS;
        stage<TILE, CS>(slot, vg + k0 * p.v.st + col, p.v.st, p.tk - k0);
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

  // each score row's running max (of the base-2 scores) and this
  // thread's part of its running sum
  float m_run[SR], l_run[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }
  float acc[NSL][RT][4];
#pragma unroll
  for (int c = 0; c < NSL; ++c)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][i][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  int it = 0;
  for (int tile = 0; tile < last; ++tile) {
    const int k0 = tile * TILE;
    // the score product over the head dim, a 32-column slice an item
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int m = 0; m < SC; ++m) s[i][m] = 0.f;
    for (int sub = 0; sub < n_score; ++sub, ++it) {
      const float* slot = advance(it);
      slice_dots<SR, SC>(s, slot, slot + S::Q_SLICE, sxo0, sxo1, syo);
    }

    // the online softmax in base 2: each part's max (PAIR = 2: exchanged
    // with the pair's other warp); then p and each row's correction into
    // shared memory (every thread is past the last reads of the previous
    // tile's: a barrier of this tile's first item)
    unsigned visible[SR];
    float mx[SR];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const long long qpos = p.q_offset + q0 + srow[i];
      visible[i] = 0u;
      mx[i] = NEG_INF;
#pragma unroll
      for (int m = 0; m < SC; ++m) {
        const int key = k0 + scol[m];
        const bool vis =
            key < p.tk && (!p.causal || qpos >= p.k_offset + key);
        s[i][m] = vis ? s[i][m] * p.scale_log2 : NEG_INF;
        if (vis) visible[i] |= 1u << m;
        mx[i] = fmaxf(mx[i], s[i][m]);
      }
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      if (PAIR > 1 && cg == 0) parts[PAIR * srow[i] + part] = mx[i];
    }
    if (PAIR > 1) pair_barrier(warp);
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      if (PAIR > 1) mx[i] = fmaxf(parts[2 * srow[i]], parts[2 * srow[i] + 1]);
      const float m_new = fmaxf(m_run[i], mx[i]);
      const float corr = exp2_ftz(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < SC; ++m) {
        const float pe =
            (visible[i] >> m) & 1u ? exp2_ftz(s[i][m] - m_new) : 0.f;
        sum += pe;
        p_tile[swz<TILE>(srow[i], scol[m] >> 2) + (scol[m] & 3)] = pe;
      }
      l_run[i] = l_run[i] * corr + sum;
      if (cg == 0 && part == 0) row_corr[srow[i]] = corr;
    }

    // the chunk products, a 64-column slice (32 at DC = 32) an item; the
    // first item's barrier also publishes P and the corrections
#pragma unroll
    for (int c = 0; c < NSL; ++c, ++it) {
      const float* slot = advance(it);
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float corr = row_corr[crow[i]];
#pragma unroll
          for (int n = 0; n < NSL; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][i][e] *= corr;
        }
      }
      // this thread's keys of the tile: js * 64 / JS + [0, 64 / JS)
      const float* yc = slot + js * (TILE / JS) * CS;
#pragma unroll 1
      for (int u = 0; u < J4; u += U) {
#pragma unroll
        for (int t = 0; t < U; ++t) {
          const int j4 = u + t;
          const int jk = js * J4 + j4;
          float4 wa[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i)
            wa[i] = ld4(p_tile + (((i & 1) ? wo1 : wo0) ^ (jk << 2)) +
                        (i >> 1) * 8 * TILE);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // key 4 j4 + e of the thread's keys; js * 64 / JS and 4 u are
            // multiples of 8, so its swizzle is that of 4 t + e
            const float4 y =
                ld4(yc + (4 * j4 + e) * CS + yco[(4 * t + e) & 7]);
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              const float w = e == 0 ? wa[i].x : e == 1 ? wa[i].y
                              : e == 2 ? wa[i].z : wa[i].w;
              float(&a)[4] = acc[c][i];
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

  // each part's sum (its 8 lanes) into shared memory; every thread is
  // past the last tile's reads of the maxima (its chunk items' barriers)
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    if (cg == 0) parts[PAIR * srow[i] + part] = l;
  }
  cp_async_wait<0>();
  __syncthreads();  // publishes the sums; the ring is free
  // a row's sum, floored
  const auto row_sum = [&](int r) {
    return fmaxf(PAIR > 1 ? parts[2 * r] + parts[2 * r + 1] : parts[r],
                 1e-30f);
  };
  // the lse, from the first chunk: exactly -1e30 where no key was visible
  if (c0 == 0 && cg == 0 && part == 0) {
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      const int row = q0 + srow[i];
      if (row < p.tq) {
        p.lse[(static_cast<long long>(b) * p.heads + h) * p.tq + row] =
            m_run[i] == NEG_INF
                ? NEG_INF
                : (m_run[i] + log2f(row_sum(srow[i]))) * LN2;
      }
    }
  }
  if (JS > 1) {  // the second half of the tile's keys adds into the first
    constexpr int PER = NSL * RT * 4;  // accumulators a thread
    float* red = smem + (threadIdx.x % 128) * PER;
    if (js == 1) {
#pragma unroll
      for (int c = 0; c < NSL; ++c)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[(c * RT + i) * 4 + e] = acc[c][i][e];
    }
    __syncthreads();
    if (js == 1) return;
#pragma unroll
    for (int c = 0; c < NSL; ++c)
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][i][e] += red[(c * RT + i) * 4 + e];
  }

  float* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + crow[i];
    if (row >= p.tq) continue;
    const float l = row_sum(crow[i]);
#pragma unroll
    for (int c = 0; c < NSL; ++c) {
      *reinterpret_cast<float4*>(out + row * p.o_st + c0 + c * CS +
                                 4 * ccol) =
          make_float4(acc[c][i][0] / l, acc[c][i][1] / l, acc[c][i][2] / l,
                      acc[c][i][3] / l);
    }
  }
}

template <int DC, int RT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using S = Shape<RT>;
  constexpr int smem =
      (STAGES * S::SLOT + S::P_TILE + (1 + S::PAIR) * S::OWN) *
                       static_cast<int>(sizeof(float));
  const auto kernel = flash_fwd_f32_kernel<DC, RT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + S::OWN - 1) / S::OWN, p.heads * p.chunks, batch);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// the head dim must be a multiple of 32 and every row 16-byte aligned
int dispatch(int width, Params p, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || width % SL != 0 || !rows_aligned(p.q) ||
      !rows_aligned(p.k) || !rows_aligned(p.v) || !aligned(p.o) ||
      p.o_sb % 4 != 0 || p.o_st % 4 != 0 || p.o_sh % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.width = width;
  const bool tall = width <= TALL;
  const int own = tall ? Shape<8>::OWN : Shape<4>::OWN;
  const long long blocks =
      static_cast<long long>((p.tq + own - 1) / own) * p.heads * batch;
  const int dc = chunk_width(256, width, blocks);
  p.chunks = width / dc;
  cudaError_t err = cudaErrorInvalidValue;
  if (tall) {  // dc = width, or 64 on a small grid at 128
    err = dc == 32   ? launch<32, 8>(p, batch, s)
          : dc == 64 ? launch<64, 8>(p, batch, s)
                     : launch<128, 8>(p, batch, s);
  } else {
    switch (dc) {
      case 64: err = launch<64, 4>(p, batch, s); break;
      case 128: err = launch<128, 4>(p, batch, s); break;
      case 256: err = launch<256, 4>(p, batch, s); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}

}  // namespace

// The C entry point takes the arguments of its bf16 counterpart in
// flash_attention_fwd.cu, with f32 tensors zero-padded to a head dim that
// is a multiple of 32.  Strides are in elements.  It returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for a head dim or a
// row alignment the kernel does not take).
extern "C" int znicz_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int tq, int tk, int head_dim, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  Params p = {};
  p.q = {static_cast<const float*>(q), q_sb, q_st, q_sh};
  p.k = {static_cast<const float*>(k), k_sb, k_st, k_sh};
  p.v = {static_cast<const float*>(v), v_sb, v_st, v_sh};
  p.o = static_cast<float*>(out);
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.o_sh = o_sh;
  p.lse = static_cast<float*>(lse);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  return dispatch(head_dim, p, batch, stream);
}
