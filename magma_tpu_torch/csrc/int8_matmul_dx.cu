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
// What the design does about it: a block owns a 128 x 256 tile of dx and
// walks N in 64-column stages; wgmma.m64n256k16 does the products, each of
// two consumer warpgroups 64 rows of dx with its fp32 accumulators in
// registers.  Of the two operands one has to be bf16 in shared memory
// (wgmma's B); W is the one converted there, because it is the smaller
// stage (16 KB of int8 against 32 KB of fp32 g) and because A = bf16(g s)
// is then built straight from g's natural layout: a thread's A pairs are
// two neighbouring g columns, one float2 load and one scale pair each.
//   * One producer thread keeps a ring of three stages full with TMA (the
//     g box, the int8 W box and the 64 scales by a bulk copy).
//   * The two consumer warpgroups widen the stage's W box into one of two
//     bf16 tiles in wgmma's 128-byte-swizzled layout (two codes in four
//     instructions, exactly; 64 codes a thread) and read their g and s
//     pairs into registers while the previous stage's wgmma runs, release
//     the stage, then round A, meet at a named barrier (the tile is whole)
//     and issue the stage's wgmma.  The widening is the largest cost
//     beside the products: spread over all 256 consumer threads it runs
//     under the previous stage's wgmma (three dedicated converter warps
//     beside the producer thread were slower on the H100).
//   * Tile order: the dx column tile runs fastest, so the blocks in flight
//     share g's row strips and W's tiles out of L2.  Bytes from L2 per
//     stage: 32 KB of g and 16 KB of W for 4.2 MFLOP.
//   * Fewer tiles than SMs (the head's 32 at M = 256): N is split in four
//     over a cluster, and the parts' sums meet through distributed shared
//     memory in rank order.
// Each dx element is a fixed-order sum: no atomics, the same bits from run
// to run.
//
// Measured alone (torch.profiler, scripts/torch_tiles_ab.py, NVIDIA
// H100 80GB HBM3 at a 700 W power limit) at M = 2048: in_proj 1.30 ms (37%
// of its bound; the mma.sync kernel it replaces 3.50 ms), o 0.200, fc_out
// 0.785, head 2.25; the head's M = 256 chunk 0.600 (18%).  About twice the
// bf16 library matmul: the widening and A's rounding sit in the
// consumers' critical path, and the three-stage ring (48 KB a stage)
// leaves little lead for the loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

using namespace tma_wgmma;

namespace {

constexpr int BM = 128;             // dx rows per block: 2 consumer warpgroups x 64
constexpr int BK = 256;             // dx columns (W rows) per block: wgmma's N
constexpr int BN = 64;              // contraction step over N
constexpr int THREADS = 384;        // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int STAGES = 3;
constexpr int MAX_SPLIT = 4;
constexpr int ACC = BK / 2;         // fp32 accumulators a consumer thread holds
constexpr int G_BYTES = BM * BN * 4;   // two 128-byte-swizzled boxes of 32 columns
constexpr int RAW_BYTES = BK * BN;     // the int8 W box
constexpr int S_BYTES = BN * 4;
constexpr int TX_BYTES = G_BYTES + RAW_BYTES + S_BYTES;
constexpr int STAGE_BYTES = (TX_BYTES + 1023) / 1024 * 1024;
constexpr int B_BYTES = BK * BN * 2;   // a widened W tile
constexpr int B_OFFSET = STAGES * STAGE_BYTES;
constexpr int BAR_OFFSET = B_OFFSET + 2 * B_BYTES;
constexpr int SMEM = BAR_OFFSET + 2 * STAGES * 8 + 1024;
static_assert(ACC * CONSUMERS * 4 <= STAGES * STAGE_BYTES, "partials reuse the ring");

struct DxParams {
  CUtensorMap g;  // (M, N) fp32, boxes of 128 rows x 32 columns, 128-byte swizzle
  CUtensorMap w;  // (K, N) int8, boxes of 256 rows x 64 columns
  const float* s;
  float* dx;
  int m, n, k, split;
};

// g[row][col] of a stage's g tile, col even (a float2 of two columns)
__device__ __forceinline__ float2 g_pair(const float* g, int row, int col) {
  const int box = col >> 5, c = col & 31;
  return *reinterpret_cast<const float2*>(g + box * (BM * 32) + row * 32 +
                                          (((c >> 2) ^ (row & 7)) << 2) + (c & 3));
}

__device__ __forceinline__ uint32_t gs_pair(float2 g, float2 s) {
  return pack_bf16x2(__fmul_rn(g.x, s.x), __fmul_rn(g.y, s.y));
}

// this consumer thread's 4 of the stage's 1024 16-code pieces of the int8
// W box (256 rows x 64 codes) -> the bf16 tile, row r's 16-byte chunk c at
// chunk c ^ (r % 8) of its 128-byte row
__device__ __forceinline__ void widen_w(const uint8_t* raw, uint8_t* b, int ctid) {
#pragma unroll
  for (int q = ctid; q < RAW_BYTES / 16; q += CONSUMERS) {
    const int row = q >> 2, c = q & 3;  // codes 16c .. 16c + 15 of the row
    const uint4 v = *reinterpret_cast<const uint4*>(raw + row * BN + c * 16);
    uint4 lo, hi;
    lo.x = s8x2_to_bf16x2(__byte_perm(v.x, 0, 0x4140));
    lo.y = s8x2_to_bf16x2(__byte_perm(v.x, 0, 0x4342));
    lo.z = s8x2_to_bf16x2(__byte_perm(v.y, 0, 0x4140));
    lo.w = s8x2_to_bf16x2(__byte_perm(v.y, 0, 0x4342));
    hi.x = s8x2_to_bf16x2(__byte_perm(v.z, 0, 0x4140));
    hi.y = s8x2_to_bf16x2(__byte_perm(v.z, 0, 0x4342));
    hi.z = s8x2_to_bf16x2(__byte_perm(v.w, 0, 0x4140));
    hi.w = s8x2_to_bf16x2(__byte_perm(v.w, 0, 0x4342));
    uint8_t* dst = b + row * (BN * 2);
    *reinterpret_cast<uint4*>(dst + (((2 * c) ^ (row & 7)) << 4)) = lo;
    *reinterpret_cast<uint4*>(dst + (((2 * c + 1) ^ (row & 7)) << 4)) = hi;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    int8_dx_wgmma_kernel(const __grid_constant__ DxParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR_OFFSET);
  uint64_t* empty = full + STAGES;
  const int split = p.split;
  const int part = blockIdx.z;  // = the block's rank in its cluster
  const int k0 = blockIdx.x * BK;
  const int m0 = blockIdx.y * BM;
  const int steps = p.n / BN;
  const int t0 = part * steps / split;
  const int t1 = (part + 1) * steps / split;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int t = t0; t < t1; ++t) {
        const int u = t - t0, st = u % STAGES;
        if (u >= STAGES) mbar_wait(&empty[st], ((u / STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * STAGE_BYTES;
        mbar_expect_tx(&full[st], TX_BYTES);
        tma_load_2d(stage, &p.g, &full[st], t * BN, m0);
        tma_load_2d(stage + G_BYTES / 2, &p.g, &full[st], t * BN + 32, m0);
        tma_load_2d(stage + G_BYTES, &p.w, &full[st], t * BN, k0);
        bulk_load(stage + G_BYTES + RAW_BYTES, p.s + (long long)t * BN, S_BYTES, &full[st]);
      }
    }
    if (split > 1) {
      cluster_sync();
      cluster_sync();
    }
  } else {  // consumer warpgroups
    regs_inc<232>();
    const int ctid = threadIdx.x - 128;
    const int lane = threadIdx.x & 31;
    const int gi = lane >> 2, tq = lane & 3;
    const int row = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16 + gi;  // and row + 8
    float acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    for (int t = t0; t < t1; ++t) {
      const int u = t - t0, st = u % STAGES;
      const uint8_t* stage = smem + st * STAGE_BYTES;
      uint8_t* b = smem + B_OFFSET + (u & 1) * B_BYTES;
      mbar_wait(&full[st], (u / STAGES) & 1);
      // while the previous stage's wgmma runs: widen W into the other tile
      // (its last readers, two stages back, finished before the last
      // barrier) and read this thread's g and s pairs, so that the stage
      // is released before the wait
      widen_w(stage + G_BYTES, b, ctid);
      fence_proxy_async();  // the generic writes, seen by wgmma
      const float* gt = reinterpret_cast<const float*>(stage);
      const float* sv = reinterpret_cast<const float*>(stage + G_BYTES + RAW_BYTES);
      float2 gv[4][4], sc[4][2];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c = kk * 16 + 2 * tq;
        sc[kk][0] = *reinterpret_cast<const float2*>(sv + c);
        sc[kk][1] = *reinterpret_cast<const float2*>(sv + c + 8);
        gv[kk][0] = g_pair(gt, row, c);
        gv[kk][1] = g_pair(gt, row + 8, c);
        gv[kk][2] = g_pair(gt, row, c + 8);
        gv[kk][3] = g_pair(gt, row + 8, c + 8);
      }
      mbar_arrive(&empty[st]);  // the stage's g, W and s are in registers or the tile
      wgmma_wait<0>();          // the previous stage's wgmma is done with A's registers
      fence_acc(acc);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[kk][r] = gs_pair(gv[kk][r], sc[kk][r >> 1]);
      }
      bar_sync(1, CONSUMERS);  // the tile is whole; both warpgroups' last wgmma done
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<BK>::rs(acc, a[kk], sw128_desc(b + kk * 32));
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);

    if (split == 1) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = k0 + 8 * j + 2 * tq;
        if (col >= p.k) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + row + 8 * h;
          if (m < p.m) {
            *reinterpret_cast<float2*>(p.dx + (long long)m * p.k + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
      }
    } else {
      cluster_reduce<CONSUMERS>(acc, reinterpret_cast<float*>(smem), ctid, part, split,
                                [&](int i, float v) {
                                  const int m = m0 + row + 8 * ((i >> 1) & 1);
                                  const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
                                  if (m < p.m && col < p.k) p.dx[(long long)m * p.k + col] = v;
                                });
    }
  }
}

}  // namespace

// C entry for ctypes: g (M, N) fp32, w (K, N) int8, s (N,) fp32, all
// contiguous and 16-byte aligned; dx (M, K) fp32.  K and N multiples of
// 128.  Returns a cudaError_t (0 on success).
extern "C" int magma_int8_matmul_dx(const float* g, const int8_t* w, const float* s, float* dx,
                                    int M, int N, int K, void* stream) {
  if (M <= 0 || N % 128 || K % 128 || reinterpret_cast<uintptr_t>(s) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  DxParams p;
  if (!encode_2d(&p.g, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, g, M, N, (uint64_t)N * 4, BM, 32,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&p.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, N, BK, BN,
                 CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return (int)cudaErrorInvalidValue;
  }
  p.s = s;
  p.dx = dx;
  p.m = M;
  p.n = N;
  p.k = K;
  const int k_tiles = (K + BK - 1) / BK, m_tiles = (M + BM - 1) / BM;
  p.split = k_tiles * m_tiles < sm_count() ? MAX_SPLIT : 1;
  // once per process: a host call less on every launch
  static const cudaError_t smem_ok =
      cudaFuncSetAttribute(int8_dx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (smem_ok != cudaSuccess) return (int)smem_ok;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k_tiles, m_tiles, p.split);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.split;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, int8_dx_wgmma_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
