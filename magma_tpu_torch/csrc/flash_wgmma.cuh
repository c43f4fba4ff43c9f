// Pieces shared by the wgmma flash-attention kernels: the forward's body
// for large launches (flash_attn_fwd_wgmma.cu, K1) and the backward
// (flash_attn_bwd.cu, K9a and K9b).  All of them read (b, s, h, hd) bf16
// tensors through 4-D (hd, h, s, b) tensor maps in boxes of 64 hd x rows in
// the 128-byte swizzle, so a tile of `rows` rows is hd / 64 panels of rows
// x 128 bytes, and strided views (path B's v) load in place.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace flash_wgmma {

using namespace tma_wgmma;

constexpr int ROW_BYTES = 128;      // a swizzled row: 64 bf16 of hd
constexpr int PANEL = 64 * ROW_BYTES;  // a 64-row box of 64 hd

// rows [r0, r0 + box rows) of (batch bi, head hi): hd / 64 boxes, one a
// 64-wide panel of `panel` bytes
template <int HD>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int r0, int hi, int bi, int panel) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) tma_load_4d(dst + c * panel, map, bar, c * 64, hi, r0, bi);
}

// the K-major descriptor of the k16 step kk of a tile of `panel`-byte panels
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk, int panel) {
  return sw128_desc(tile + (kk >> 2) * panel + (kk & 3) * 32);
}

// the register A of the next product, one k16 step a row of `a`, from a
// 64 x (R / 2) fp32 accumulator: D's pairs are A's pairs, rounded to bf16
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[R / 8][4], const float (&x)[R]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16x2(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// a warpgroup's 64 x HD accumulator, the thread's row g times mul0 and row
// g + 8 times mul1, rounded to bf16, into `tile` (free shared memory, 64-row
// panels in the 128-byte swizzle: the bank of each 4-byte write is 4 ((j ^
// g) & 7) + t, so a warp's writes never collide), then rows [row0, row0 +
// 64) of (batch bi, head hi) through the output's tensor map: one 8 KB box
// a panel instead of 4-byte stores scattered over 8 rows a warp; rows past
// the tensor's end are not written
template <int HD>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, uint8_t* tile,
                                           const float (&acc)[HD / 2], float mul0, float mul1,
                                           int row0, int hi, int bi, int ctid, int bar) {
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = (ctid >> 5) * 16 + g + 8 * r;
    const float mul = r == 0 ? mul0 : mul1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(tile + (j >> 3) * PANEL + row * ROW_BYTES +
                                   (((j ^ row) & 7) << 4) + 4 * t) =
          pack_bf16x2(acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
    }
  }
  fence_proxy_async();  // the generic writes, seen by the TMA store
  bar_sync(bar, 128);
  if (ctid == 0) {
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) tma_store_4d(map, tile + c * PANEL, c * 64, hi, row0, bi);
    bulk_store_wait_read();
  }
}

// exp(x) as 2^(x log2(e)): one fma and the MUFU's ex2 (2^-22 relative),
// where expf takes a range reduction
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// keeps A's registers of an rs product in flight from being reused
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
  }
}

// (b, s, h, hd) bf16 at `base`, element strides sb, ss, sh (hd unit), as a
// 4-D (hd, h, s, b) map read in boxes of 64 hd x `rows` rows
inline bool encode_bshd(CUtensorMap* map, const void* base, int b, int s, int h, int hd,
                        long long sb, long long ss, long long sh, int rows) {
  const uint64_t dims[4] = {(uint64_t)hd, (uint64_t)h, (uint64_t)s, (uint64_t)b};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2, (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return encode_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace flash_wgmma
