// The W4A8 device code shared by int4_matmul.cu (K3, K4b) and boundary.cu
// (K6): the arithmetic of magma_tpu/ops/quant.py's `_int4_matmul_stacked_kernel`,
// `_int4_dual_kernel` and `_boundary_kernel`.
//
// Layout (quant.py `quantize_int4`): a packed int8 weight byte of row r,
// column n holds row r of the original (K, N) matrix in its low nibble and
// row r + K/2 in its high nibble; group g of packed rows [256 g, 256 g + 256)
// has the scales s4[g] (low nibbles) and s4[K/512 + g] (high nibbles).
//
// Per group the TPU kernels compute, and so does every path here:
//   xlo, sxlo = quantize(x[:, 256 g : 256 g + 256])             (per row)
//   xhi, sxhi = quantize(x[:, K/2 + 256 g : K/2 + 256 g + 256])
//   acc += float(xlo . lo) * sxlo * slo + float(xhi . hi) * sxhi * shi
// with quantize = (rint(x / (max|x| / 127)), max|x| / 127), IEEE division
// and round-half-even (rintf), and the int8 dots exact in int32 (__dp4a or
// mma.sync s8).  The fp32 steps are written with __fmul_rn / __fadd_rn, so
// nvcc contracts none of them into an FMA, and the groups are added in
// order from 0: the result is the plain PyTorch version's
// (ops/quant.py `_w4a8`) bit for bit, and the same from run to run.  Built
// without --use_fast_math, which would change the division and the codes.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int W4_GROUP = 256;  // packed rows (and activation columns) per group
constexpr int W4_SLICE = 32;   // columns of one warp item

// the signed low nibble of each byte, as an int8 byte: (int8)(b << 4) >> 4
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t v) {
  return __vsub4((v & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// the signed high nibble of each byte: (int8)b >> 4
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t v) {
  return __vsub4(((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// four words of four bytes, w[i] = row i, columns 0..3 -> col[c] = the four
// rows of column c (row 0 in the lowest byte), as __dp4a wants them
__device__ __forceinline__ void transpose4x4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                             uint32_t (&col)[4]) {
  const uint32_t t01l = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t01h = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t23l = __byte_perm(w2, w3, 0x5140);
  const uint32_t t23h = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(t01l, t23l, 0x5410);
  col[1] = __byte_perm(t01l, t23l, 0x7632);
  col[2] = __byte_perm(t01h, t23h, 0x5410);
  col[3] = __byte_perm(t01h, t23h, 0x7632);
}

// the TPU kernels' `_quantize_act_block` for one row of 256 values, by one
// warp: each lane quantises 8 columns into codes[8 lane .. 8 lane + 8).
// Returns the row's scale (in every lane).  row == nullptr is a padding row:
// codes 0, scale 1.  COHERENT reads through L2 (data written earlier in the
// same launch); otherwise through the read-only path.
template <bool COHERENT>
__device__ __forceinline__ float warp_quantize_row(const __nv_bfloat16* row, int8_t* codes) {
  const int lane = threadIdx.x & 31;
  float v[8];
  if (row != nullptr) {
    const uint4* src = reinterpret_cast<const uint4*>(row + lane * 8);
    const uint4 raw = COHERENT ? __ldcg(src) : __ldg(src);
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
  }
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = static_cast<int>(rintf(__fdiv_rn(v[i], scale)));
    packed[i / 4] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>(codes + lane * 8) = make_uint2(packed[0], packed[1]);
  return scale;
}

// the fp32 step of one group, in the Pallas kernels' order, never contracted
__device__ __forceinline__ float w4a8_term(int plo, float sxlo, float slo, int phi, float sxhi,
                                           float shi) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(plo), sxlo), slo),
                   __fmul_rn(__fmul_rn(__int2float_rn(phi), sxhi), shi));
}

// One warp, one group: the int32 dots of the 256 packed rows of w (row
// stride n, starting at the slice's first column) with the low and high
// activation codes of MT rows (xlo[m], xhi[m], 256 codes each, in shared
// memory).  Lane l reads 4-byte pieces of columns 4 (l % 8) .. + 3 from
// rows 4 (l / 8) + 16 j, j = 0..15: eight lanes cover one 32-byte sector of
// a row.  On return lanes 0..7 hold the totals of their four columns.
template <int MT>
__device__ __forceinline__ void warp_group_dots(const int8_t* w, int n,
                                                const int8_t (*xlo)[W4_GROUP],
                                                const int8_t (*xhi)[W4_GROUP],
                                                int (&plo)[MT][4], int (&phi)[MT][4]) {
  const int lane = threadIdx.x & 31;
  const int8_t* wc = w + 4 * (lane & 7);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) plo[m][c] = phi[m][c] = 0;

#pragma unroll 4
  for (int r = 4 * (lane >> 3); r < W4_GROUP; r += 16) {
    const uint32_t w0 = __ldg(reinterpret_cast<const uint32_t*>(wc + (long long)(r + 0) * n));
    const uint32_t w1 = __ldg(reinterpret_cast<const uint32_t*>(wc + (long long)(r + 1) * n));
    const uint32_t w2 = __ldg(reinterpret_cast<const uint32_t*>(wc + (long long)(r + 2) * n));
    const uint32_t w3 = __ldg(reinterpret_cast<const uint32_t*>(wc + (long long)(r + 3) * n));
    uint32_t col[4];
    transpose4x4(w0, w1, w2, w3, col);
    int xl[MT], xh[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xl[m] = *reinterpret_cast<const int*>(&xlo[m][r]);
      xh[m] = *reinterpret_cast<const int*>(&xhi[m][r]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lo = static_cast<int>(lo_nibbles(col[c]));
      const int hi = static_cast<int>(hi_nibbles(col[c]));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        plo[m][c] = __dp4a(lo, xl[m], plo[m][c]);
        phi[m][c] = __dp4a(hi, xh[m], phi[m][c]);
      }
    }
  }
  // add the four row quarters (lanes that differ in bits 3-4): integers, exact
#pragma unroll
  for (int off = 8; off < 32; off <<= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        plo[m][c] += __shfl_xor_sync(0xffffffffu, plo[m][c], off);
        phi[m][c] += __shfl_xor_sync(0xffffffffu, phi[m][c], off);
      }
}

// One warp item: the fp32 term of group g for the 32 columns from col0 of
// one W4A8 product.  x: `rows` (<= MT) rows of 2 kp bf16 values, row stride
// ldx; q4 (kp, n) packed; s4 (2 kp / 256, n).  codes: this warp's
// [2][MT][256] shared buffer.  On return lanes 0..7 hold term[m][c] of
// columns col0 + 4 lane + c.
template <int MT, bool COHERENT>
__device__ __forceinline__ void w4a8_group_term(const __nv_bfloat16* x, long long ldx, int rows,
                                                int kp, const int8_t* q4, const float* s4, int n,
                                                int g, int col0,
                                                int8_t (*codes)[MT][W4_GROUP],
                                                float (&term)[MT][4]) {
  const int lane = threadIdx.x & 31;
  const int n_k = kp / W4_GROUP;
  float sxlo[MT], sxhi[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const __nv_bfloat16* row = m < rows ? x + (long long)m * ldx : nullptr;
    sxlo[m] = warp_quantize_row<COHERENT>(row ? row + g * W4_GROUP : nullptr, codes[0][m]);
    sxhi[m] = warp_quantize_row<COHERENT>(row ? row + kp + g * W4_GROUP : nullptr, codes[1][m]);
  }
  __syncwarp();
  int plo[MT][4], phi[MT][4];
  warp_group_dots<MT>(q4 + (long long)g * W4_GROUP * n + col0, n, codes[0], codes[1], plo, phi);
  const int c4 = col0 + 4 * (lane & 7);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float slo = __ldg(s4 + (long long)g * n + c4 + c);
    const float shi = __ldg(s4 + (long long)(n_k + g) * n + c4 + c);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      term[m][c] = w4a8_term(plo[m][c], sxlo[m], slo, phi[m][c], sxhi[m], shi);
    }
  }
  __syncwarp();  // the codes are read before the warp's next item overwrites them
}

}  // namespace
