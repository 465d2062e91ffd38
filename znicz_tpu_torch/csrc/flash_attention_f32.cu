// Flash-attention forward for Hopper (sm_90a) with float32 operands.
//
// Replaces: znicz_tpu/ops/pallas_attention.py:_fwd_kernel when it runs on
// f32 operands (the reference trains in f32 by default).  There every tile
// product runs at the input dtype with f32 accumulation, so an f32 call
// multiplies in f32; here every product is an f32 FMA on the CUDA cores
// (no tensor cores, no TF32), the same function as the bf16 kernel of
// flash_attention_fwd.cu with nothing rounded to bf16:
//   s = (q . k) * scale, masked s = -1e30 and masked p = 0, online softmax
//   over key tiles, out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
//   (a fully masked row: out 0, lse -1e30)
// The f32 backward (dq, dk/dv) is flash_attention_bwd_f32.cu.
//
// What bounds it on this card: the products.  At T = 2048 and dh = 64 a
// call does ~1000 FLOP per byte of q/k/v/o, and the f32 SIMT peak is
// 67 TFLOP/s, so the FMA rate bounds it.  This is the simple first
// version: a block of 128 threads owns 32 query rows; four neighbouring
// threads share a row, each holding a quarter of the head dim of its
// accumulators and computing a quarter of the row's 64 scores per tile;
// the k and v tiles of 64 rows are staged through shared memory with rows
// padded by one float, so the four threads of a row and the eight rows of
// a warp read distinct banks.  A row's scores go through shared memory to
// the second product; its four threads are one quarter-warp, so a warp
// barrier suffices there.
//
// Geometry, the bf16 kernel's: q, k, v and out in the boundary layout
// (B, T, H, dh) through element strides (the last dim contiguous); lse
// contiguous (B, H, Tq) f32; any T (rows past T are zero-filled when
// staged and masked); q_offset / k_offset place the call on a global axis
// for causal masking, and causal skips whole tiles that no row can see.
// Head dims 32, 64, 128 and 256 are instantiated; the wrapper zero-pads
// any other multiple of 8 up to the next one.
//
// Head dims past 128: the output is split into column chunks of DC = 128
// by a grid axis (out[:, c] = p . v[:, c]), so a thread's accumulators
// stay at the 128-wide size; the score product still sums over the whole
// head dim, staged whole in shared memory, and every chunk recomputes it
// (twice the score work at dh = 256).  The lse is written by the first
// chunk.
//
// Head dims past 256: the streamed instantiation (D = 0) takes any width
// that is a multiple of 128 (the wrapper zero-pads to one), given at run
// time.  Its staging loop gains an outer loop over 64-column slices of q
// and k, s summing over the slices, and the chunk's columns of v are
// staged after them, so shared memory does not grow with the head dim.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int ROWS = 32;        // rows a block owns
constexpr int TILE = 64;        // rows of the other operand per iteration
constexpr int SPLIT = 4;        // threads per row
constexpr int PER = TILE / SPLIT;  // scores of a tile per thread
constexpr int LP = TILE + 1;    // row pitch of the score tiles
constexpr int SL = 64;          // columns of a slice (streamed kernels)
constexpr float NEG_INF = -1e30f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
  int heads, tq, tk;
  int width;  // the padded head dim (streamed kernels)
  float scale;
  int causal;
  long long q_offset, k_offset;
};

// rows x D floats from global (row stride in elements) into shared memory
// with row pitch D + 1; rows at or past `valid` are zero-filled, so masked
// rows never carry garbage (0 * NaN would poison a product)
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row_stride, int rows,
                                          int valid) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    dst[r * (D + 1) + c] = r < valid ? src[r * row_stride + c] : 0.f;
  }
}

// adds the 16 dot products of one row `a` (pitch D + 1) with rows part,
// part + 4, ... of tile `t` to s
template <int D>
__device__ __forceinline__ void row_dots_add(float s[PER], const float* a,
                                             const float* t, int part) {
  for (int c = 0; c < D; ++c) {
    const float av = a[c];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      s[i] = fmaf(av, t[(part + SPLIT * i) * (D + 1) + c], s[i]);
    }
  }
}

// the 16 dot products of one row `a` (pitch D + 1) with rows part,
// part + 4, ... of tile `t`
template <int D>
__device__ __forceinline__ void row_dots(float s[PER], const float* a,
                                         const float* t, int part) {
#pragma unroll
  for (int i = 0; i < PER; ++i) s[i] = 0.f;
  row_dots_add<D>(s, a, t, part);
}

// the streamed kernel's score product: s summed over the 64-column
// slices of the head dim, each slice of the block's query rows (a, ROWS
// of them) and of the tile's key rows (ta, TILE of them) staged through
// shared memory; ends with every thread past its last read
__device__ __forceinline__ void sliced_dots(
    float s[PER], const Params& p, const float* a, long long a_st,
    int own_valid, const float* ta, long long ta_st, int oth_valid,
    float* s_a, float* s_ta, int r, int part) {
#pragma unroll
  for (int i = 0; i < PER; ++i) s[i] = 0.f;
  for (int c = 0; c < p.width; c += SL) {
    __syncthreads();  // every thread is done with the previous slice
    load_rows<SL>(s_a, a + c, a_st, ROWS, own_valid);
    load_rows<SL>(s_ta, ta + c, ta_st, TILE, oth_valid);
    __syncthreads();
    row_dots_add<SL>(s, s_a + r * (SL + 1), s_ta, part);
  }
  __syncthreads();
}

// acc[d] += sum_j w[j] * t[j][part + 4 d] over the tile's 64 rows, for
// the DC columns of a tile of pitch D + 1 that start at t
template <int D, int DC>
__device__ __forceinline__ void accumulate(float* acc, const float* w,
                                           const float* t, int part) {
  for (int j = 0; j < TILE; ++j) {
    const float wj = w[j];
#pragma unroll
    for (int d = 0; d < DC / SPLIT; ++d) {
      acc[d] = fmaf(wj, t[j * (D + 1) + part + SPLIT * d], acc[d]);
    }
  }
}

// tiles of 64 keys the block's rows [q0, q0 + ROWS) can see
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int n = (p.tk + TILE - 1) / TILE;
  if (p.causal) {
    const long long last = p.q_offset + q0 + ROWS - 1 - p.k_offset;
    if (last < 0) return 0;
    if (last / TILE + 1 < n) n = static_cast<int>(last / TILE) + 1;
  }
  return n;
}

// D = 0: the streamed instantiation (a head dim of p.width, past 256)
template <int D, int DC>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(Params p) {
  constexpr bool WIDE = D == 0;
  constexpr int QD = WIDE ? SL : D;  // columns of the staged q and k
  constexpr int VD = WIDE ? DC : D;  // columns of the staged v
  constexpr int DP = DC / SPLIT;
  extern __shared__ float smem[];
  float* s_q = smem;
  float* s_k = s_q + ROWS * (QD + 1);
  float* s_v = s_k + TILE * (QD + 1);
  float* s_p = s_v + TILE * (VD + 1);

  const int chunks = (WIDE ? p.width : D) / DC;
  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y / chunks;
  const int c0 = blockIdx.y % chunks * DC;  // this block's output columns
  const int b = blockIdx.z;
  const int r = threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_st;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  if (!WIDE) load_rows<QD>(s_q, qg, p.q_st, ROWS, p.tq - q0);

  float acc[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;
  float m = NEG_INF;
  float l = 0.f;  // this thread's partial row sum
  const long long row_pos = p.q_offset + q0 + r;

  const int n_tiles = key_tiles(p, q0);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * TILE;
    float s[PER];
    if constexpr (WIDE) {
      sliced_dots(s, p, qg, p.q_st, p.tq - q0, kg + k0 * p.k_st, p.k_st,
                  p.tk - k0, s_q, s_k, r, part);
      load_rows<VD>(s_v, vg + k0 * p.v_st + c0, p.v_st, TILE, p.tk - k0);
      __syncthreads();
    } else {
      __syncthreads();  // every thread is done with the previous tile
      load_rows<D>(s_k, kg + k0 * p.k_st, p.k_st, TILE, p.tk - k0);
      load_rows<D>(s_v, vg + k0 * p.v_st, p.v_st, TILE, p.tk - k0);
      __syncthreads();
      row_dots<D>(s, s_q + r * (D + 1), s_k, part);
    }

    unsigned visible = 0u;
    float tile_max = NEG_INF;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int col = k0 + part + SPLIT * i;
      bool vis = col < p.tk;
      if (p.causal) vis = vis && row_pos >= p.k_offset + col;
      s[i] = vis ? s[i] * p.scale : NEG_INF;
      if (vis) visible |= 1u << i;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float pe = (visible >> i) & 1u ? expf(s[i] - m) : 0.f;
      l += pe;
      s_p[r * LP + part + SPLIT * i] = pe;
    }
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] *= corr;
    __syncwarp();
    accumulate<VD, DC>(acc, s_p + r * LP, s_v + (WIDE ? 0 : c0), part);
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  l = fmaxf(l, 1e-30f);
  const int row = q0 + r;
  if (row < p.tq) {
    float* orow = p.o + b * p.o_sb + h * p.o_sh + row * p.o_st + c0;
#pragma unroll
    for (int d = 0; d < DP; ++d) orow[part + SPLIT * d] = acc[d] / l;
    if (part == 0 && c0 == 0) {
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.tq + row] =
          m + logf(l);
    }
  }
}

// the output column chunk of a block at head dim D (0: streamed)
template <int D>
constexpr int chunk() {
  return D == 0 || D >= 128 ? 128 : D;
}

// the staged width of the score operands: the head dim, or a slice
template <int D>
constexpr int staged() {
  return D == 0 ? SL : D;
}

// output chunks of a block row
template <int D>
int chunks(const Params& p) {
  return (D == 0 ? p.width : D) / chunk<D>();
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem_floats, int rows, int chunks,
                   const Params& p, int batch, cudaStream_t stream) {
  const int smem = smem_floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + ROWS - 1) / ROWS, p.heads * chunks, batch);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// shared memory in floats: the staged score operands, then (streamed
// kernels) the chunk's columns of the right-hand operands, then the score
// rows and statistics
template <int D>
cudaError_t launch_fwd(const Params& p, int batch, cudaStream_t s) {
  constexpr int VD = D == 0 ? chunk<D>() : D;
  return launch(flash_fwd_f32_kernel<D, chunk<D>()>,
                (ROWS + TILE) * (staged<D>() + 1) + TILE * (VD + 1) +
                    ROWS * LP,
                p.tq, chunks<D>(p), p, batch, s);
}

// head-dim dispatch; a head dim past 256 must be a multiple of 128 (the
// wrapper pads it)
int dispatch(int head_dim, Params p, int batch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  p.width = head_dim;
  if (head_dim > 256) {
    if (head_dim % 128 == 0) {
      err = launch_fwd<0>(p, batch, s);
    }
    return static_cast<int>(err);
  }
  switch (head_dim) {
    case 32:
      err = launch_fwd<32>(p, batch, s);
      break;
    case 64:
      err = launch_fwd<64>(p, batch, s);
      break;
    case 128:
      err = launch_fwd<128>(p, batch, s);
      break;
    case 256:
      err = launch_fwd<256>(p, batch, s);
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

void set_inputs(Params& p, const void* q, const void* k, const void* v,
                int heads, int tq, int tk, float scale, int causal,
                long long q_offset, long long k_offset) {
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  p.k_offset = k_offset;
}

}  // namespace

// The C entry point takes the arguments of its bf16 counterpart in
// flash_attention_fwd.cu, with f32 tensors.  Strides are in elements.  It
// returns the launch's cudaError_t (0 on success); the caller checks
// shapes, dtypes and alignment beforehand.
extern "C" int znicz_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int batch, int heads, int tq, int tk, int head_dim, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_st, long long o_sh, float scale, int causal,
    long long q_offset, long long k_offset, void* stream) {
  Params p = {};
  set_inputs(p, q, k, v, heads, tq, tk, scale, causal, q_offset, k_offset);
  p.o = static_cast<float*>(out);
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
  if (batch <= 0 || heads <= 0 || tq <= 0) return cudaSuccess;
  return dispatch(head_dim, p, batch, stream);
}
