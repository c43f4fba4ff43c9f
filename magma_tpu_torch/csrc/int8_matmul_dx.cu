// Input gradient of the int8 weight-only product for Hopper (sm_90a): K10.
//
// Replaces: magma_tpu/ops/quant.py `_int8_matmul_dx_kernel` (launched by
// `_int8_matmul_stacked_dx` through pl.pallas_call), the backward of
// `int8_matmul_stacked` and `int8_matmul` that QLoRA training
// (`train_lm_int8`) runs for every frozen int8 product: in_proj, o and
// fc_out of each layer and the untied head.  Same function:
//   dx (M, K) fp32 = bf16(g * s) (M, N) @ bf16(W)^T,
// g the fp32 output gradient, s the (N,) per-channel scales, W the int8
// (K, N) weights read in their stored layout, contracted over N: g * s is
// formed in fp32 and rounded to bf16 (round to nearest even), the int8
// codes widen to bf16 exactly, and the products accumulate in fp32.  No
// transposed or dequantised copy of W is ever built -- that is the
// kernel's reason for being (XLA's transposed copy of the stacked weights
// is ~12 GB at GPT-J 6B).
//
// What bounds it on an H100: at the QLoRA step's M = 2048 rows the in_proj
// (K 4096, N 28672) is 481 GFLOP, 0.49 ms at the 989 TFLOP/s dense bf16
// rate, against 235 MB of fp32 g and 117 MB of int8 W (0.11 ms at
// 3.35 TB/s): the tensor cores bound it, as they do o, fc_out and the
// head at that M.
//
// What the design does about it: a block of 8 warps owns a 128 x 128 tile
// of dx and walks N in 32-column steps, double-buffered with cp.async (the
// fp32 g rows, their 32 scales and the int8 W rows of the step); each
// warp's 32 x 64 sub-tile is 8 mma.sync m16n8k16 tiles whose fp32
// accumulators stay in registers.  A fragments are built from the fp32 g
// tile (g * s rounded to bf16 there), B fragments straight from the int8
// tile (two codes widened to bf16x2), so neither operand is staged twice.
// Each dx element is one thread's sum in N order: no atomics.  wgmma, TMA
// and a deeper pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int BM = 128;       // dx rows per block
constexpr int BK = 128;       // dx columns (W rows) per block
constexpr int BN = 32;        // contraction step over N
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along K, 32 x 64 each
constexpr int G_LDS = BN + 8;   // fp32 per shared g row (8 pad: conflict-free float2 reads)
constexpr int W_LDS = BN + 16;  // bytes per shared W row (16 pad, keeps 16-byte rows)

struct Stage {
  float g[BM * G_LDS];
  float s[BN];
  int8_t w[BK * W_LDS];
};

__device__ __forceinline__ void load_stage(Stage& st, const float* g, const int8_t* w,
                                           const float* s, int m0, int k0, int n0, int M, int N) {
  // g: 128 rows x 32 fp32 = 8 chunks of 16 bytes a row
  for (int i = threadIdx.x; i < BM * (BN / 4); i += THREADS) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const bool valid = m0 + r < M;
    cp_async_16(&st.g[r * G_LDS + c], valid ? g + (long long)(m0 + r) * N + n0 + c : g, valid);
  }
  // W: 128 rows x 32 int8 = 2 chunks a row (K and N are multiples of 128)
  {
    const int r = threadIdx.x / 2, c = (threadIdx.x % 2) * 16;
    cp_async_16(&st.w[r * W_LDS + c], w + (long long)(k0 + r) * N + n0 + c, true);
  }
  if (threadIdx.x < BN / 4) cp_async_16(&st.s[threadIdx.x * 4], s + n0 + threadIdx.x * 4, true);
}

__device__ __forceinline__ uint32_t gs_pair(const Stage& st, int r, int c) {
  const float2 gv = *reinterpret_cast<const float2*>(&st.g[r * G_LDS + c]);
  return pack_bf16x2(__fmul_rn(gv.x, st.s[c]), __fmul_rn(gv.y, st.s[c + 1]));
}

__device__ __forceinline__ uint32_t w_pair(const Stage& st, int r, int c) {
  const char2 q = *reinterpret_cast<const char2*>(&st.w[r * W_LDS + c]);
  return pack_bf16x2((float)q.x, (float)q.y);  // int8 codes are exact in bf16
}

__global__ void __launch_bounds__(THREADS) int8_dx_kernel(const float* __restrict__ g,
                                                          const int8_t* __restrict__ w,
                                                          const float* __restrict__ s,
                                                          float* __restrict__ dx, int M, int N,
                                                          int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage* stages = reinterpret_cast<Stage*>(smem_raw);
  const int m0 = blockIdx.y * BM, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp % 4) * 32;  // the warp's rows within the tile
  const int wk = (warp / 4) * 64;  // and its dx columns

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int n_steps = N / BN;
  load_stage(stages[0], g, w, s, m0, k0, 0, M, N);
  cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load_stage(stages[(step + 1) % 2], g, w, s, m0, k0, (step + 1) * BN, M, N);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's stage has landed
    __syncthreads();
    const Stage& st = stages[step % 2];
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + gid;
        a[i][0] = gs_pair(st, r, kk + tig * 2);
        a[i][1] = gs_pair(st, r + 8, kk + tig * 2);
        a[i][2] = gs_pair(st, r, kk + 8 + tig * 2);
        a[i][3] = gs_pair(st, r + 8, kk + 8 + tig * 2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = wk + j * 8 + gid;
        const uint32_t b0 = w_pair(st, r, kk + tig * 2);
        const uint32_t b1 = w_pair(st, r, kk + 8 + tig * 2);
        mma_16816(acc[0][j], a[0], b0, b1);
        mma_16816(acc[1][j], a[1], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + gid + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + wk + j * 8 + tig * 2;
        *reinterpret_cast<float2*>(dx + (long long)row * K + col) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// C entry for ctypes: g (M, N) fp32, w (K, N) int8, s (N,) fp32, all
// contiguous; dx (M, K) fp32.  K and N multiples of 128.  Returns a
// cudaError_t (0 on success).
extern "C" int magma_int8_matmul_dx(const float* g, const int8_t* w, const float* s, float* dx,
                                    int M, int N, int K, void* stream) {
  if (M <= 0 || N % 128 || K % 128) return (int)cudaErrorInvalidValue;
  const int smem = 2 * (int)sizeof(Stage);
  cudaError_t err = cudaFuncSetAttribute(int8_dx_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(K / BK, (M + BM - 1) / BM);
  int8_dx_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(g, w, s, dx, M, N,
                                                                            K);
  return (int)cudaGetLastError();
}
