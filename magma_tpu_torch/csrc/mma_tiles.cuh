// Warp-level bf16 tensor-core helpers of the flash-attention forward (K1):
// 16-byte cp.async copies, ldmatrix fragment loads and mma.sync m16n8k16
// (bf16 x bf16 -> fp32).  tma_wgmma.cuh reuses smem_addr and pack_bf16x2,
// int4_matmul.cu ldmatrix_x4_trans.
//
// Fragment conventions (PTX ISA, mma.m16n8k16 .row.col): a warp's 16 x 16 A
// tile is four 8 x 8 matrices (rows 0-7 / 8-15 x k 0-7 / 8-15) and its
// 16 x 8 B tile two (k 0-7 / 8-15); thread `lane` holds accumulator entries
// (row lane/4 [+8], cols 2 (lane%4) + {0, 1}).  Shared tiles are row-major
// with a row stride of LDS bf16 elements.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tiles {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; an invalid source is zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  cp_async_commit();
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> bf16x2, each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A tile (16 rows from row0, k from k0) of a [row][k] shared tile
template <int LDS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s, int row0,
                                       int k0, int lane) {
  ldmatrix_x4(a, s + (row0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS + k0 + (lane / 16) * 8);
}

// B tiles of two 8-wide n blocks (n0, n0 + 8) at k0 of an [n][k] shared
// tile: b[0], b[1] for the first, b[2], b[3] for the second
template <int LDS>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* s, int n0,
                                          int k0, int lane) {
  ldmatrix_x4(b, s + (n0 + (lane % 8) + (lane / 16) * 8) * LDS + k0 + ((lane / 8) % 2) * 8);
}

// the same from a [k][n] shared tile (transposing load)
template <int LDS>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* s, int k0,
                                          int n0, int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS + n0 + (lane / 16) * 8);
}

// A tile (k block kk) from accumulator tiles t[2 kk], t[2 kk + 1] of a
// 16-row strip, rounded to bf16: how P (or dS) feeds the next product
template <int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&t)[NT][4], int kk) {
  a[0] = pack_bf16x2(t[2 * kk][0], t[2 * kk][1]);
  a[1] = pack_bf16x2(t[2 * kk][2], t[2 * kk][3]);
  a[2] = pack_bf16x2(t[2 * kk + 1][0], t[2 * kk + 1][1]);
  a[3] = pack_bf16x2(t[2 * kk + 1][2], t[2 * kk + 1][3]);
}

// rows [row0, row0 + ROWS) of an (n_rows, HD) bf16 slice with row stride
// `row_stride` -> shared, row stride LDS; rows past n_rows are zero-filled
template <int ROWS, int HD, int LDS, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int n_rows) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src = valid ? base + (long long)(row0 + r) * row_stride + c : base;
    cp_async_16(dst + r * LDS + c, src, valid);
  }
}

}  // namespace mma_tiles
