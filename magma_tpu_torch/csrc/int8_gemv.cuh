// The int8 weight-only GEMV body shared by int8_matmul.cu (K2a, K2b, K4a at
// M <= 8) and fused_adapter.cu (both phases of K5).
//
// A block of GEMV_WARPS warps owns one GEMV_SLICE-column slice of W (K, N)
// and walks a range of its rows: each pair of lanes reads one 32-byte row
// piece (a full sector) with 16-byte loads, so a warp streams 16 rows per
// step and the block GEMV_ROWS_PER_STEP.  int8 becomes fp32 by a byte
// permute into a float's mantissa (exact, no slow I2F), and the
// (rows <= MT) x 16 accumulators of a thread stay in registers.  The sums
// over the rows close inside the block: shuffles over the lanes, then the
// warps in a fixed order, so the result is the same bits from run to run.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GEMV_THREADS = 256;  // 8 warps
constexpr int GEMV_WARPS = GEMV_THREADS / 32;
constexpr int GEMV_SLICE = 32;     // columns per block
constexpr int GEMV_ROWS_PER_STEP = GEMV_WARPS * 16;

// 4 signed bytes -> 4 floats, exactly: (b + 128) into the low mantissa bits
// of 2^23, minus 2^23 + 128
__device__ __forceinline__ void s8x4_to_f32(uint32_t v, float* f) {
  const uint32_t u = v ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440u | i)) - 8388736.f;
  }
}

// Column sums of x[:rows, k_lo:k_hi] @ w[k_lo:k_hi, slice] for up to MT rows
// of x (row stride ldx), left in red[warp][m][j] for warp_total to add over
// the warps.  w is (K, n) int8 with n a multiple of 16.  x is read with
// ordinary (coherent) loads, so it may have been written earlier in the
// same launch.  Every thread of the block must call it: it ends with
// __syncthreads().
template <int MT>
__device__ __forceinline__ void slice_gemv(const __nv_bfloat16* x, long long ldx, int rows,
                                           const int8_t* w, int n, int k_lo, int k_hi,
                                           int slice,
                                           float (&red)[GEMV_WARPS][MT][GEMV_SLICE]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = lane & 1;  // which 16 columns of the slice
  const int8_t* wcol = w + slice * GEMV_SLICE + half * 16;

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[m][j] = 0.f;

#pragma unroll 4
  for (int k = k_lo + warp * 16 + (lane >> 1); k < k_hi; k += GEMV_ROWS_PER_STEP) {
    const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wcol + (long long)k * n));
    float xv[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) xv[m] = m < rows ? __bfloat162float(x[m * ldx + k]) : 0.f;
    float wf[16];
    s8x4_to_f32(wv.x, wf);
    s8x4_to_f32(wv.y, wf + 4);
    s8x4_to_f32(wv.z, wf + 8);
    s8x4_to_f32(wv.w, wf + 12);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
  }

  // sum the 16 row lanes of each column half (lanes that differ in bits 1-4)
#pragma unroll
  for (int off = 2; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], off);
  if (lane < 2) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 16; ++j) red[warp][m][half * 16 + j] = acc[m][j];
  }
  __syncthreads();
}

// the warps' partial sums of (row m, column j), added in a fixed order
template <int MT>
__device__ __forceinline__ float warp_total(const float (&red)[GEMV_WARPS][MT][GEMV_SLICE],
                                            int m, int j) {
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < GEMV_WARPS; ++w) sum += red[w][m][j];
  return sum;
}

}  // namespace
