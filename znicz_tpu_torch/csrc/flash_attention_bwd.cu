// Flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel, bf16 operands, f32 accumulators.
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
// p and ds to the operand dtype before their products.
//
// What bounds it on this card: at the training shape (B=16, H=8, T=2048,
// dh=64) the dq kernel does 3 and the dk/dv kernel 4 products of
// 2*B*H*T^2*dh FLOP each, ~2.1e11 and ~2.7e11 FLOP, against ~170 MB of
// q/k/v/do/lse/delta/dq/dk/dv traffic, well above the H100's ~295
// FLOP/byte ridge: the tensor cores bound both.  The design answers that
// as the forward kernel does: every score tile stays in registers, and
// all products run on the tensor cores through mma.sync.m16n8k16 with f32
// accumulators.  This is the simple first version: 4 warps a block, tiles
// staged through padded shared memory without double buffering.
//
// Structure: two kernels and no atomics, so both are deterministic.
// - dq: one block per (b, h, 64 query rows), each warp owning 16 rows,
//   looping over 64-key tiles.  s and dp are m16 x n64 accumulators whose
//   layout is already the A fragment of ds . k.
// - dk/dv: one block per (b, h, 64 keys), each warp owning 16 keys,
//   looping over query tiles.  It computes the transposed tiles s^T = k q^T
//   and dp^T = v do^T directly, so p^T and ds^T are A fragments in
//   registers.  The B operands of p^T . do and ds^T . q (do and q with
//   the query axis as the reduction) are read from shared memory with
//   ldmatrix.trans.  Two f32 accumulators of 16 keys x dh per warp cost
//   2*dh/4 registers a thread (64 at dh = 64, 128 at dh = 128), so at
//   dh = 128 the query tile is 32 wide and the k and v fragments are read
//   from shared memory at each use instead of being held.
//
// Geometry, the forward's: q, k, v, do, dq, dk and dv are read or written
// in the boundary layout (B, T, H, dh) through element strides (the last
// dim contiguous), so q/k/v stay views into the packed QKV projection; lse
// and delta are contiguous (B, H, Tq) f32.  Any T: rows past T are
// zero-filled when staged and masked.  q_offset / k_offset place the call
// on a global axis for causal masking; causal skips whole tiles that no
// row can see.  Head dims 32, 64, 128 and 256 are instantiated; the
// wrapper zero-pads any other multiple of 8 up to the next one.
//
// Head dims past 128: the outputs are split into column chunks of DC = 128
// by a grid axis, since each chunk needs only its own columns of the
// right-hand operand and the full score tiles:
//   dq[:, c] = ds . k[:, c],  dv[:, c] = p^T . do[:, c],
//   dk[:, c] = ds^T . q[:, c].
// So a block's accumulators stay at the 128-wide size (64 registers a
// thread for dq, 128 for dk and dv together), while the score products
// s = q . k^T and dp = do . v^T still sum over the whole head dim, their
// operands staged whole in shared memory and read 16 columns at a time.
// Every chunk recomputes the score tiles: at dh = 256 the two chunks do
// the two score products twice, 5/3 of the dq kernel's single-pass work
// (s, dp and ds . k) and 3/2 of the dk/dv kernel's (s, dp, p^T . do and
// ds^T . q).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_M = 64;  // dq: query rows per block, 16 per warp
constexpr int BLOCK_N = 64;  // dq: keys per tile; dk/dv: keys per block

struct Params {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const uint16_t* dout;
  const float* lse;
  const float* delta;
  uint16_t* dq;
  uint16_t* dk;
  uint16_t* dv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long do_sb, do_st, do_sh;
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_st, dk_sh;
  long long dv_sb, dv_st, dv_sh;
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

// rows x D bf16 from global (row stride in elements) into padded shared
// memory; rows at or past `valid` are zero-filled
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

// A fragment (16 rows x 16 of the reduction axis) from a row-major
// [row][k] shared tile: rows r0.., k-block kk
template <int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const uint16_t* s,
                                       int r0, int kk, int g, int t4) {
  const uint16_t* base = s + (r0 + g) * LD + kk * 16 + t4 * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
}

// B fragment (16 of the reduction axis x 8 columns) from a shared tile
// stored [column][k]: columns n0.., k-block kk
template <int LD>
__device__ __forceinline__ void load_b(uint32_t b[2], const uint16_t* s,
                                       int n0, int kk, int g, int t4) {
  const uint16_t* base = s + (n0 + g) * LD + kk * 16 + t4 * 2;
  b[0] = *reinterpret_cast<const uint32_t*>(base);
  b[1] = *reinterpret_cast<const uint32_t*>(base + 8);
}

// B fragments of two neighbouring 8-column tiles (j, j + 1) from a shared
// tile stored [k][column] (the reduction axis along rows), k-block kb:
// one ldmatrix.x4.trans; lane l addresses row (l & 7) of matrix l >> 3
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t b[2][2],
                                             const uint16_t* s, int kb, int j,
                                             int lane) {
  const int mat = lane >> 3;
  const uint16_t* p =
      s + (kb * 16 + (mat & 1) * 8 + (lane & 7)) * LD + (j + (mat >> 1)) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0][0]), "=r"(b[0][1]), "=r"(b[1][0]), "=r"(b[1][1])
      : "r"(addr));
}

// acc[n] += A . B over a 16-wide k-block whose A fragment is built from
// the m16 x n8 accumulators c[2kb], c[2kb + 1] rounded to bf16, and whose
// B is the [k][column] shared tile `s`
template <int ND, int LD>
__device__ __forceinline__ void acc_from_scores(float acc[][4],
                                                const float c0[4],
                                                const float c1[4],
                                                const uint16_t* s, int kb,
                                                int lane) {
  const uint32_t a[4] = {pack_bf16(c0[0], c0[1]), pack_bf16(c0[2], c0[3]),
                         pack_bf16(c1[0], c1[1]), pack_bf16(c1[2], c1[3])};
#pragma unroll
  for (int j = 0; j < ND; j += 2) {
    uint32_t bf[2][2];
    load_b_trans<LD>(bf, s, kb, j, lane);
    mma_bf16_16816(acc[j], a, bf[0]);
    mma_bf16_16816(acc[j + 1], a, bf[1]);
  }
}

// c[nt] = A(rows r0.. of sa) . B(columns of sb)^T over the whole head dim
template <int D, int NT>
__device__ __forceinline__ void tile_product(float c[][4], const uint16_t* sa,
                                             int r0, const uint16_t* sb,
                                             int g, int t4) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, sa, r0, kk, g, t4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bf[2];
      load_b<LD>(bf, sb, nt * 8, kk, g, t4);
      mma_bf16_16816(c[nt], a, bf);
    }
  }
}

template <int D, int DC>
__global__ void __launch_bounds__(THREADS)
    flash_dq_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int ND = DC / 8;        // n-tiles of this block's dq chunk
  constexpr int NS = BLOCK_N / 8;   // n-tiles of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* s_q = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* s_do = s_q + BLOCK_M * LD;
  uint16_t* s_k = s_do + BLOCK_M * LD;
  uint16_t* s_v = s_k + BLOCK_N * LD;

  const int q0 = blockIdx.x * BLOCK_M;
  const int h = blockIdx.y / (D / DC);
  const int c0 = blockIdx.y % (D / DC) * DC;  // this block's dq columns
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * 16;

  const uint16_t* kg = p.k + b * p.k_sb + h * p.k_sh;
  const uint16_t* vg = p.v + b * p.v_sb + h * p.v_sh;
  load_tile<D>(s_q, p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_st, p.q_st,
               BLOCK_M, p.tq - q0);
  load_tile<D>(s_do, p.dout + b * p.do_sb + h * p.do_sh + q0 * p.do_st,
               p.do_st, BLOCK_M, p.tq - q0);

  // this thread's two rows (g and g + 8): position, lse and delta
  const long long stat0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
  int row[2];
  long long row_pos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + wr + g + 8 * r;
    row_pos[r] = p.q_offset + row[r];
    const bool ok = row[r] < p.tq;
    lse_r[r] = ok ? p.lse[stat0 + row[r]] : 0.f;
    delta_r[r] = ok ? p.delta[stat0 + row[r]] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }

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

    // p = exp(q.k * scale - lse) where visible
    float s[NS][4];
    tile_product<D, NS>(s, s_q, wr, s_k, g, t4);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        bool vis = col < p.tk && row[r] < p.tq;
        if (p.causal) vis = vis && row_pos[r] >= p.k_offset + col;
        s[nt][e] = vis ? expf(s[nt][e] * p.scale - lse_r[r]) : 0.f;
      }
    }
    // ds = p * (do.v - delta) * scale, in place
    float dp[NS][4];
    tile_product<D, NS>(dp, s_do, wr, s_v, g, t4);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * (dp[nt][e] - delta_r[e >> 1]) * p.scale;
      }
    }
    // dq[:, c] += bf16(ds) . k[:, c]
#pragma unroll
    for (int kb = 0; kb < BLOCK_N / 16; ++kb) {
      acc_from_scores<ND, LD>(acc, s[2 * kb], s[2 * kb + 1], s_k + c0, kb,
                              lane);
    }
  }

  uint16_t* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] < p.tq) {
      uint16_t* out = dqg + row[r] * p.dq_st + c0 + t4 * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(out + n * 8) =
            pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

template <int D, int BQ, int DC>
__global__ void __launch_bounds__(THREADS)
    flash_dkv_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int ND = DC / 8;  // n-tiles of this block's dk and dv chunks
  constexpr int NQ = BQ / 8;  // n-tiles of the transposed score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* s_k = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* s_v = s_k + BLOCK_N * LD;
  uint16_t* s_q = s_v + BLOCK_N * LD;
  uint16_t* s_do = s_q + BQ * LD;
  float* s_lse = reinterpret_cast<float*>(s_do + BQ * LD);
  float* s_delta = s_lse + BQ;

  const int k0 = blockIdx.x * BLOCK_N;
  const int h = blockIdx.y / (D / DC);
  const int c0 = blockIdx.y % (D / DC) * DC;  // this block's dk/dv columns
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wr = warp * 16;

  const uint16_t* qg = p.q + b * p.q_sb + h * p.q_sh;
  const uint16_t* dog = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat0 = (static_cast<long long>(b) * p.heads + h) * p.tq;
  load_tile<D>(s_k, p.k + b * p.k_sb + h * p.k_sh + k0 * p.k_st, p.k_st,
               BLOCK_N, p.tk - k0);
  load_tile<D>(s_v, p.v + b * p.v_sb + h * p.v_sh + k0 * p.v_st, p.v_st,
               BLOCK_N, p.tk - k0);

  // this thread's two keys (g and g + 8)
  int key[2];
  long long key_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + wr + g + 8 * r;
    key_pos[r] = p.k_offset + key[r];
  }

  float acc_dk[ND][4], acc_dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
    acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;
  }

  const int nq = (p.tq + BQ - 1) / BQ;
  int first = 0;
  if (p.causal) {
    // whole-tile skip: no query before `lo` sees any key of this block
    const long long lo = p.k_offset + k0 - p.q_offset;
    if (lo > 0) first = static_cast<int>(lo / BQ < nq ? lo / BQ : nq);
  }

  for (int it = first; it < nq; ++it) {
    const int q0 = it * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(s_q, qg + q0 * p.q_st, p.q_st, BQ, p.tq - q0);
    load_tile<D>(s_do, dog + q0 * p.do_st, p.do_st, BQ, p.tq - q0);
    for (int i = threadIdx.x; i < BQ; i += THREADS) {
      const bool ok = q0 + i < p.tq;
      s_lse[i] = ok ? p.lse[stat0 + q0 + i] : 0.f;
      s_delta[i] = ok ? p.delta[stat0 + q0 + i] : 0.f;
    }
    __syncthreads();

    // p^T = exp(k.q * scale - lse) where visible
    float st[NQ][4];
    tile_product<D, NQ>(st, s_k, wr, s_q, g, t4);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + t4 * 2 + (e & 1);
        const int r = e >> 1;
        bool vis = q0 + qc < p.tq && key[r] < p.tk;
        if (p.causal) vis = vis && p.q_offset + q0 + qc >= key_pos[r];
        st[nt][e] = vis ? expf(st[nt][e] * p.scale - s_lse[qc]) : 0.f;
      }
    }
    // dv[:, c] += bf16(p^T) . do[:, c]
#pragma unroll
    for (int kb = 0; kb < BQ / 16; ++kb) {
      acc_from_scores<ND, LD>(acc_dv, st[2 * kb], st[2 * kb + 1], s_do + c0,
                              kb, lane);
    }
    // ds^T = p^T * (v.do - delta) * scale, in place
    float dpt[NQ][4];
    tile_product<D, NQ>(dpt, s_v, wr, s_do, g, t4);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nt * 8 + t4 * 2 + (e & 1);
        st[nt][e] = st[nt][e] * (dpt[nt][e] - s_delta[qc]) * p.scale;
      }
    }
    // dk[:, c] += bf16(ds^T) . q[:, c]
#pragma unroll
    for (int kb = 0; kb < BQ / 16; ++kb) {
      acc_from_scores<ND, LD>(acc_dk, st[2 * kb], st[2 * kb + 1], s_q + c0,
                              kb, lane);
    }
  }

  uint16_t* dkg = p.dk + b * p.dk_sb + h * p.dk_sh;
  uint16_t* dvg = p.dv + b * p.dv_sb + h * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] < p.tk) {
      uint16_t* ok = dkg + key[r] * p.dk_st + c0 + t4 * 2;
      uint16_t* ov = dvg + key[r] * p.dv_st + c0 + t4 * 2;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(ok + n * 8) =
            pack_bf16(acc_dk[n][2 * r], acc_dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ov + n * 8) =
            pack_bf16(acc_dv[n][2 * r], acc_dv[n][2 * r + 1]);
      }
    }
  }
}

// DC: the output column chunk of a block (D up to 128, else 128)
template <int D, int DC = (D < 128 ? D : 128)>
cudaError_t launch_dq(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (2 * BLOCK_M + 2 * BLOCK_N) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tq + BLOCK_M - 1) / BLOCK_M, p.heads * (D / DC), batch);
  flash_dq_kernel<D, DC><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, int BQ, int DC = (D < 128 ? D : 128)>
cudaError_t launch_dkv(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (2 * BLOCK_N + 2 * BQ) * (D + 8) * 2 + 2 * BQ * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<D, BQ, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.tk + BLOCK_N - 1) / BLOCK_N, p.heads * (D / DC), batch);
  flash_dkv_kernel<D, BQ, DC><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int heads, int tq, int tk, const long long* strides,
                   float scale, int causal, long long q_offset,
                   long long k_offset) {
  Params p = {};
  p.q = static_cast<const uint16_t*>(q);
  p.k = static_cast<const uint16_t*>(k);
  p.v = static_cast<const uint16_t*>(v);
  p.dout = static_cast<const uint16_t*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  long long* dst[] = {&p.q_sb, &p.q_st, &p.q_sh, &p.k_sb, &p.k_st, &p.k_sh,
                      &p.v_sb, &p.v_st, &p.v_sh, &p.do_sb, &p.do_st,
                      &p.do_sh};
  for (int i = 0; i < 12; ++i) *dst[i] = strides[i];
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
  return p;
}

}  // namespace

// Operands q (B, Tq, H, dh), k and v (B, Tk, H, dh), do (B, Tq, H, dh),
// bf16 with the last dim contiguous; `strides` holds the (batch, time,
// head) element strides of q, k, v and do in that order (12 values);
// lse and delta: contiguous (B, H, Tq) f32.  dq: (B, Tq, H, dh) bf16 with
// (batch, time, head) strides dq_sb, dq_st, dq_sh.  Returns the launch's
// cudaError_t (0 on success); the caller checks shapes, dtypes and
// alignment beforehand.
extern "C" int znicz_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int heads,
    int tq, int tk, int head_dim, const long long* strides, long long dq_sb,
    long long dq_st, long long dq_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, heads, tq, tk, strides,
                         scale, causal, q_offset, k_offset);
  p.dq = static_cast<uint16_t*>(dq);
  p.dq_sb = dq_sb;
  p.dq_st = dq_st;
  p.dq_sh = dq_sh;
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_dq<32>(p, batch, s));
    case 64:
      return static_cast<int>(launch_dq<64>(p, batch, s));
    case 128:
      return static_cast<int>(launch_dq<128>(p, batch, s));
    case 256:
      return static_cast<int>(launch_dq<256>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As znicz_flash_attention_dq, writing dk and dv: (B, Tk, H, dh) bf16
// with (batch, time, head) strides `out_strides` (dk's three, then dv's).
extern "C" int znicz_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int heads, int tq, int tk, int head_dim, const long long* strides,
    const long long* out_strides, float scale, int causal, long long q_offset,
    long long k_offset, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, heads, tq, tk, strides,
                         scale, causal, q_offset, k_offset);
  p.dk = static_cast<uint16_t*>(dk);
  p.dv = static_cast<uint16_t*>(dv);
  p.dk_sb = out_strides[0];
  p.dk_st = out_strides[1];
  p.dk_sh = out_strides[2];
  p.dv_sb = out_strides[3];
  p.dv_st = out_strides[4];
  p.dv_sh = out_strides[5];
  if (batch <= 0 || heads <= 0 || tk <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return static_cast<int>(launch_dkv<32, 64>(p, batch, s));
    case 64:
      return static_cast<int>(launch_dkv<64, 64>(p, batch, s));
    case 128:
      return static_cast<int>(launch_dkv<128, 32>(p, batch, s));
    case 256:
      return static_cast<int>(launch_dkv<256, 32>(p, batch, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
