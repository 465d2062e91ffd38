// Building blocks shared by the port's f32 SIMT flash kernels
// (flash_attention_f32.cu, the forward; flash_attention_bwd_f32.cu, dq
// and dk/dv): every product an f32 FMA on the CUDA cores, operands
// staged through a ring of shared-memory slots by 16-byte cp.async into
// row-major tiles whose 16-byte columns are XOR-swizzled by the row, and
// read back as 128-bit loads.
//
// A block has THREADS threads and walks over TILE-row tiles of the other
// operand; a score product runs over the head dim an SL-column slice at
// a time, one slice a ring item.  What the kernels rely on: a tile of
// PITCH floats a row (a multiple of 32) puts 16-byte column k of row r at
// swz<PITCH>(r, k); rows 8 apart share a swizzle, and so do the rows a
// thread owns in slice_dots (r0 + 4 i, c0 + 8 m).
//
// Each includer is its own shared library, so everything here has
// internal linkage.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;     // other rows a tile
constexpr int SL = 32;       // head-dim columns of a score slice
constexpr int STAGES = 3;    // ring slots
constexpr float LOG2E = 1.4426950408889634f;
// Fully unrolled, a kernel's product loops come to about BODY
// instructions (a 4-column step of a product issues RT + 4 loads and
// 16 RT FMAs).  Past ~6000 they ran 12-13 % slower on an H100 SXM (the
// f32 dk/dv at 64 and dq at 128 with 8 rows a thread; the instruction
// cache, by those measurements), so such a body unrolls its chunk
// products 4 steps at a time; smaller ones lose 5-8 % that way and
// unroll them whole.
constexpr int BODY_MAX = 6000;

struct Operand {
  const float* p;
  long long sb, st, sh;  // element strides of B, T, H
};

// float offset of 16-byte column k of `row` in a row-major tile of PITCH
// floats a row, the column XOR-swizzled by the row's low 3 bits.  PITCH
// is a multiple of 32, so swz(row, k) = swz(row, 0) ^ (k << 2): a loop
// over k costs one XOR an address, and rows 8 apart are 8 * PITCH apart.
template <int PITCH>
__device__ __forceinline__ int swz(int row, int k) {
  return row * PITCH + ((k ^ (row & 7)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// t[i][m] += the dot products, over one SL-column slice, of the thread's
// rows r0 + 4 i of xs with its rows c0 + 8 m of ys (rows r0 + 8 n share
// r0's swizzle, so xo0 = swz(r0, 0), xo1 = swz(r0 + 4, 0), yo = swz(c0, 0)
// locate them all): NX + NY 128-bit loads and 4 NX NY FMAs a 4-column
// step
template <int NX, int NY>
__device__ __forceinline__ void slice_dots(float (&t)[NX][NY],
                                           const float* xs, const float* ys,
                                           int xo0, int xo1, int yo) {
#pragma unroll
  for (int k = 0; k < SL / 4; ++k) {
    float4 xa[NX], yb[NY];
#pragma unroll
    for (int i = 0; i < NX; ++i)
      xa[i] = ld4(xs + (((i & 1) ? xo1 : xo0) ^ (k << 2)) + (i >> 1) * 8 * SL);
#pragma unroll
    for (int m = 0; m < NY; ++m)
      yb[m] = ld4(ys + (yo ^ (k << 2)) + m * 8 * SL);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int m = 0; m < NY; ++m) {
        t[i][m] = fmaf(xa[i].x, yb[m].x, t[i][m]);
        t[i][m] = fmaf(xa[i].y, yb[m].y, t[i][m]);
        t[i][m] = fmaf(xa[i].z, yb[m].z, t[i][m]);
        t[i][m] = fmaf(xa[i].w, yb[m].w, t[i][m]);
      }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit, subnormal results flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ROWS rows x COLS columns from `src` (row stride st) into a swizzled
// tile; rows at or past `valid` are zero-filled (0 * NaN would poison a
// product)
template <int ROWS, int COLS>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long st, int valid) {
  constexpr int KC = COLS / 4;
  static_assert(ROWS * KC % THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int n = 0; n < ROWS * KC / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    const int r = i / KC;
    const int k = i % KC;
    const bool ok = r < valid;
    cp_async16(dst + swz<COLS>(r, k), ok ? src + r * st + 4 * k : src, ok);
  }
}

// the output chunk: the widest power of two that divides the width, at
// most `widest`, halved down to 64 while the grid has fewer blocks than
// half the SMs
int chunk_width(int widest, int width, long long blocks_per_chunk) {
  int dc = widest;
  while (width % dc) dc /= 2;
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  while (dc > 64 && 2 * blocks_per_chunk * (width / dc) <= sms) dc /= 2;
  return dc;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
}

bool rows_aligned(const Operand& o) {
  return aligned(o.p) && o.sb % 4 == 0 && o.st % 4 == 0 && o.sh % 4 == 0;
}

}  // namespace
