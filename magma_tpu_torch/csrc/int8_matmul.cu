// Weight-only int8 matrix products for Hopper (sm_90a): bf16 x times int8 W,
// fp32 accumulate, the per-column scale applied to the accumulator.
//
// Replaces three Pallas kernels of magma_tpu/ops/quant.py:
//   K2a `_int8_matmul_kernel` (the untied int8 head, M=1, K=4096, N=50304),
//   K2b `_int8_matmul_stacked_kernel` (the fused [q|k|v|fc_in] in_proj,
//       K=4096, N=28672; M=1 in decode, M=192 in the caption prefill),
//   K4a `_int8_dual_kernel` (o_proj and fc_out over the K-concatenated
//       [W_o; W_f] stream, Ko=4096, Kf=16384, N=4096, two outputs).
// One C entry serves all three: it takes one or two "segments" (x, W, s,
// out, K), all of width N.  K2a and K2b are one segment (a stacked layer is
// the view's base pointer); K4a is two, one launch, and its outputs stay
// apart because GPT-J's per-branch adapters need them apart.
//
// Function: out[m, n] = (sum_k x[m, k] * float(W[k, n])) * s[n].  int8 -> bf16
// is exact, and a bf16 x bf16 product is exact in fp32, so every regime
// below computes the Pallas kernel's products exactly; only the fp32
// summation order differs.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   M <= 8 (decode): the int8 weight stream.  K2b 117.4 MB -> 35 us, K4a
//       83.9 MB -> 25 us, K2a 206 MB -> 61.5 us; the flops are negligible.
//   M = 192 (prefill): the tensor cores, 2*M*K*N: K2b 45.1 GFLOP -> 46 us,
//       K4a 32.2 GFLOP -> 33 us.
//
// What the design does about it:
//   M <= 8: the slice GEMV of int8_gemv.cuh (shared with fused_adapter.cu):
//       a block of 8 warps owns one 32-column slice of one segment and
//       streams its rows in 32-byte sector pieces with 16-byte loads,
//       int8 -> fp32 by a byte permute.  N/32 slices give 896 blocks for
//       in_proj and 1572 for the head, enough to keep 132 SMs loading.  The
//       dual's N = 4096 gives only 2 x 128, and the fc_out blocks would walk
//       4x the rows of the o_proj ones, one block an SM for the last 3/4 of
//       the time.  So below 512 blocks K is split in 4: a cluster of 4 blocks
//       shares a slice, each walks a quarter of K (1024 o_proj or 4096
//       fc_out rows), and rank 0 adds the four partial sums through
//       distributed shared memory in rank order.  No atomics and no second
//       pass: the result is the same bits from run to run, and greedy tokens
//       repeat.  The segment with more rows goes first, so its blocks are
//       dispatched first.
//   M > 8: wgmma tiles with the operands swapped, out^T = W^T x^T, so that
//       the int8 weights are wgmma's register-sourced A (rather than
//       converter warps writing a bf16 copy of the W tile to shared memory:
//       the widening then costs no shared-memory round trip and no proxy
//       fence, and runs beside the other warpgroup's wgmma): each consumer
//       thread reads its A pairs from the stage's int8 W box (two
//       neighbouring columns of a row with one 16-bit load: A's row g is
//       column 2g of the warp's 16, row g + 8 column 2g + 1) and widens them
//       in registers (exactly, two codes in four instructions), and x in
//       bf16 is B straight from the TMA box, whose N is the tile's rows
//       (64, 128, 192 or 256; ragged M pads with zero rows, never stored).
//       At M = 192 one block holds all rows, so each W tile streams from
//       HBM once; at M = 2048 the m tile runs fastest in the grid, so the
//       blocks in flight share their W tiles out of L2.  A block is a
//       producer warpgroup (one thread issuing TMA into a ring of 4-8
//       stages of 64 k, mbarrier full/empty pairs) and two consumer
//       warpgroups of 64 output columns each, fp32 accumulators in
//       registers.  Per 64-k stage a block reads 8 KB of W and BM x 128
//       bytes of x for 2 x 128 x BM x 64 flops (about 0.01 bytes a flop out
//       of L2).  With fewer tiles than SMs (K4a at M = 192: 32 column tiles
//       a segment) K is split in 4 over a cluster -- fc_out's parts are
//       then as long as o_proj's whole K, and fc_out's blocks go first -- and
//       the parts meet through distributed shared memory, each rank adding
//       a quarter of the entries in rank order: no float atomics, the same
//       bits from run to run.  The epilogue multiplies each column by its
//       scale on the fp32 sum and stores fp32.
//
// Measured alone (torch.profiler, chip_smoke.py, NVIDIA H100 80GB HBM3 at a
// 700 W power limit): at M = 1 the GEMV as before (K2b 69.4 us, 51% of its
// bound; K4a 55.4 us; K2a 117 us); the tiles K2b M=192 90.7 us (50%; the
// mma.sync tile they replace: 437 us in scripts/torch_int8_tiles_ab.py),
// K4a M=192 107 us (30%), K2b M=2048 727 us in_proj (67%), 107 us o, 386
// us fc_out (72%), K2a M=256 164 us (65%).  What holds the tiles back: each stage moves about 0.01 bytes a
// flop out of L2, and the consumers' A widening is not overlapped with
// their own wgmma (the other warpgroup's fills the tensor cores).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"
#include "tma_wgmma.cuh"

using namespace tma_wgmma;

namespace {

// ---------------------------------------------------------------------------
// shared pieces
// ---------------------------------------------------------------------------

struct Segment {
  const __nv_bfloat16* x;  // (M, K), row stride ldx
  long long ldx;
  const int8_t* w;         // (K, N), row stride N
  const float* s;          // (N,)
  float* out;              // (M, N), row stride N
  int k;
};

struct Params {
  Segment seg[2];
  int m, n;
};

// ---------------------------------------------------------------------------
// M <= 8: slice GEMV (int8_gemv.cuh), K split across a cluster when the
// slices alone are too few blocks
// ---------------------------------------------------------------------------

// below this many blocks (about 4 of 8 warps on each of an H100's 132 SMs)
// the slices alone leave the card short of loads in flight
constexpr int GEMV_MIN_BLOCKS = 512;
constexpr int GEMV_SPLIT = 4;  // K parts, one block each, of one cluster

// grid (N / GEMV_SLICE, nseg * SPLIT); for SPLIT > 1 a cluster of (1, SPLIT)
// blocks shares one slice of one segment, each block a quarter of its K
template <int MT, int SPLIT>
__global__ void __launch_bounds__(GEMV_THREADS) gemv_kernel(const Params p) {
  const Segment sg = p.seg[blockIdx.y / SPLIT];
  __shared__ float red[GEMV_WARPS][MT][GEMV_SLICE];
  __shared__ float part_sum[MT * GEMV_SLICE];
  int part = 0;
  if constexpr (SPLIT > 1) part = static_cast<int>(cg::this_cluster().block_rank());
  const int chunk = sg.k / SPLIT;
  slice_gemv<MT>(sg.x, sg.ldx, p.m, sg.w, p.n, part * chunk, (part + 1) * chunk, blockIdx.x,
                 red);
  const int m = threadIdx.x / GEMV_SLICE;
  const int j = threadIdx.x % GEMV_SLICE;
  const bool mine = threadIdx.x < MT * GEMV_SLICE && m < p.m;
  float sum = mine ? warp_total<MT>(red, m, j) : 0.f;
  if constexpr (SPLIT > 1) {
    // rank 0 adds the parts through distributed shared memory in rank
    // order: no atomics, the same bits from run to run
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x < MT * GEMV_SLICE) part_sum[threadIdx.x] = sum;
    cluster.sync();
    if (part == 0 && mine) {
      for (int r = 1; r < SPLIT; ++r) sum += cluster.map_shared_rank(part_sum, r)[threadIdx.x];
    }
    cluster.sync();  // the other ranks' shared memory lives until it is read
  }
  if (part == 0 && mine) {
    const int c = blockIdx.x * GEMV_SLICE + j;
    sg.out[(long long)m * p.n + c] = sum * sg.s[c];
  }
}

template <int MT>
cudaError_t launch_gemv(const Params& p, int nseg, cudaStream_t st) {
  const int slices = p.n / GEMV_SLICE;
  if (slices * nseg >= GEMV_MIN_BLOCKS) {
    gemv_kernel<MT, 1><<<dim3(slices, nseg), GEMV_THREADS, 0, st>>>(p);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slices, nseg * GEMV_SPLIT);
  cfg.blockDim = dim3(GEMV_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = GEMV_SPLIT;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gemv_kernel<MT, GEMV_SPLIT>, p);
}

// ---------------------------------------------------------------------------
// M > 8: wgmma tiles, operands swapped (out^T = W^T x^T)
// ---------------------------------------------------------------------------

constexpr int ALIGN = 128;          // K and N multiples of this
constexpr int TILE_N = 128;         // output columns per block: 2 consumer warpgroups x 64
constexpr int TILE_K = 64;          // k per stage: one 128-byte swizzle row of bf16 x
constexpr int TILE_THREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int W_BYTES = TILE_K * TILE_N;  // the int8 W box of a stage
constexpr int MAX_SPLIT = 4;        // K parts, one block each, of one cluster

// BM output rows per block = wgmma's N; the ring holds as many stages as fit
// beside the other block-sized pieces (the partial sums of a split reuse it)
template <int BM>
struct TileCfg {
  static constexpr int STAGES = BM <= 64 ? 8 : BM <= 128 ? 6 : BM <= 192 ? 5 : 4;
  static constexpr int STAGE_BYTES = W_BYTES + BM * TILE_K * 2;
  static constexpr int ACC = BM / 2;  // fp32 accumulators a consumer thread holds
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(ACC * CONSUMERS * 4 <= STAGES * STAGE_BYTES, "partials reuse the ring");
};

struct TileParams {
  CUtensorMap x[2];  // (M, K_i) bf16, boxes of BM rows x 64 k, 128-byte swizzle
  CUtensorMap w[2];  // (K_i, N) int8, boxes of 64 k x 128 columns, 128-byte swizzle
  const float* s[2];
  float* out[2];
  int k[2];
  int m, n, split;
};

// the two bytes W[k][c], W[k][c + 1] of a stage's 128-byte-swizzled W box
__device__ __forceinline__ uint32_t w_pair(const uint8_t* w, int k, int c) {
  return *reinterpret_cast<const uint16_t*>(w + k * TILE_N + (((c >> 4) ^ (k & 7)) << 4) +
                                            (c & 15));
}

// bytes (W[k][c], W[k][c+1], W[k+1][c], W[k+1][c+1]) -> the bf16x2 A
// registers of column c (k, k+1) and of column c + 1 (k, k+1); exact
__device__ __forceinline__ void widen_a(uint32_t v, uint32_t& col0, uint32_t& col1) {
  col0 = s8x2_to_bf16x2(v);
  col1 = s8x2_to_bf16x2(v >> 8);
}

// Block (m tile, n tile, segment x split part).  Warpgroup 0: one thread
// keeps the ring full with TMA.  Warpgroups 1-2: each owns 64 columns of W
// as wgmma's A rows -- thread row g is column 2g of its warp's 16, row g + 8
// column 2g + 1, so each thread reads two neighbouring bytes per k -- widened
// in registers, and x's rows as B (N = BM) straight from the TMA box.
template <int BM>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    int8_wgmma_tile_kernel(const __grid_constant__ TileParams p) {
  using C = TileCfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int split = p.split;
  const int seg = blockIdx.z / split;
  const int part = blockIdx.z % split;  // = the block's rank in its cluster
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * TILE_N;
  const int steps = p.k[seg] / TILE_K;
  const int t0 = part * steps / split;
  const int t1 = (part + 1) * steps / split;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
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
        const int u = t - t0, st = u % C::STAGES;
        if (u >= C::STAGES) mbar_wait(&empty[st], ((u / C::STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * C::STAGE_BYTES;
        mbar_expect_tx(&full[st], C::STAGE_BYTES);
        tma_load_2d(stage, &p.w[seg], &full[st], n0, t * TILE_K);
        tma_load_2d(stage + W_BYTES, &p.x[seg], &full[st], t * TILE_K, m0);
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
    const int g = lane >> 2, tq = lane & 3;
    const int col = (ctid >> 7) * 64 + ((ctid >> 5) & 3) * 16 + 2 * g;  // and col + 1
    float acc[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) acc[i] = 0.f;

    for (int t = t0; t < t1; ++t) {
      const int u = t - t0, st = u % C::STAGES;
      mbar_wait(&full[st], (u / C::STAGES) & 1);
      const uint8_t* stage = smem + st * C::STAGE_BYTES;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kk * 16 + 2 * tq;
        widen_a(w_pair(stage, k, col) | (w_pair(stage, k + 1, col) << 16), a[kk][0], a[kk][1]);
        widen_a(w_pair(stage, k + 8, col) | (w_pair(stage, k + 9, col) << 16), a[kk][2],
                a[kk][3]);
      }
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<BM>::rs(acc, a[kk], sw128_desc(stage + W_BYTES + kk * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(&empty[st]);
    }

    const float* scale = p.s[seg];
    float* out = p.out[seg];
    const int c = n0 + col;
    if (split == 1) {
      const float s0 = scale[c], s1 = scale[c + 1];
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        const int m = m0 + 8 * j + 2 * tq;
        if (m < p.m) {
          *reinterpret_cast<float2*>(out + (long long)m * p.n + c) =
              make_float2(acc[4 * j] * s0, acc[4 * j + 2] * s1);
        }
        if (m + 1 < p.m) {
          *reinterpret_cast<float2*>(out + (long long)(m + 1) * p.n + c) =
              make_float2(acc[4 * j + 1] * s0, acc[4 * j + 3] * s1);
        }
      }
    } else {
      cluster_reduce<CONSUMERS>(acc, reinterpret_cast<float*>(smem), ctid, part, split,
                                [&](int i, float v) {
                                  const int m = m0 + 8 * (i >> 2) + 2 * tq + (i & 1);
                                  const int cc = c + ((i >> 1) & 1);
                                  if (m < p.m) out[(long long)m * p.n + cc] = v * scale[cc];
                                });
    }
  }
}

template <int BM>
cudaError_t launch_tiles(const Params& p, int nseg, cudaStream_t st) {
  using C = TileCfg<BM>;
  TileParams tp;
  for (int i = 0; i < nseg; ++i) {
    const Segment& sg = p.seg[i];
    if (!encode_2d(&tp.x[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sg.x, p.m, sg.k, sg.ldx * 2, BM,
                   TILE_K, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&tp.w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, sg.w, sg.k, p.n, p.n, TILE_K, TILE_N,
                   CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
    tp.s[i] = sg.s;
    tp.out[i] = sg.out;
    tp.k[i] = sg.k;
  }
  tp.m = p.m;
  tp.n = p.n;
  const int m_tiles = (p.m + BM - 1) / BM;
  const int tiles = m_tiles * (p.n / TILE_N) * nseg;
  // fewer tiles than SMs: split K over a cluster (K4a's o_proj and fc_out
  // parts are then a quarter of each segment, and the longer segment's
  // blocks go first)
  tp.split = tiles < sm_count() ? MAX_SPLIT : 1;
  // once per process: a host call less on every launch
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      int8_wgmma_tile_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (smem_ok != cudaSuccess) return smem_ok;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, p.n / TILE_N, nseg * tp.split);
  cfg.blockDim = dim3(TILE_THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = tp.split;
  cfg.attrs = attr;
  cfg.numAttrs = tp.split > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, int8_wgmma_tile_kernel<BM>, tp);
}

}  // namespace

// C entry for ctypes.  nseg (1 or 2) segments of width n, each x (m, k_i)
// bf16 with row stride ldx_i (a multiple of 8, 16-byte aligned), w (k_i, n)
// int8 contiguous (16-byte aligned), s (n,) fp32, out (m, n) fp32; k_i and n
// multiples of 128.  Returns a cudaError_t (0 on success).
extern "C" int magma_int8_matmul(int nseg, int m, int n,
                                 const void* x0, long long ldx0, const void* w0,
                                 const float* s0, float* out0, int k0,
                                 const void* x1, long long ldx1, const void* w1,
                                 const float* s1, float* out1, int k1, void* stream) {
  // k_i % ALIGN also makes each of the GEMV_SPLIT parts of K a whole number of rows
  if (nseg < 1 || nseg > 2 || m <= 0 || n <= 0 || n % ALIGN || k0 % ALIGN ||
      (nseg == 2 && k1 % ALIGN)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.m = m;
  p.n = n;
  p.seg[0] = Segment{static_cast<const __nv_bfloat16*>(x0), ldx0,
                     static_cast<const int8_t*>(w0), s0, out0, k0};
  p.seg[1] = nseg == 2 ? Segment{static_cast<const __nv_bfloat16*>(x1), ldx1,
                                 static_cast<const int8_t*>(w1), s1, out1, k1}
                       : p.seg[0];
  // the segment with more rows first: its blocks are dispatched first
  if (nseg == 2 && k1 > k0) {
    const Segment first = p.seg[1];
    p.seg[1] = p.seg[0];
    p.seg[0] = first;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m == 1) err = launch_gemv<1>(p, nseg, st);
  else if (m == 2) err = launch_gemv<2>(p, nseg, st);
  else if (m <= 4) err = launch_gemv<4>(p, nseg, st);
  else if (m <= 8) err = launch_gemv<8>(p, nseg, st);
  else if (m <= 64) err = launch_tiles<64>(p, nseg, st);
  else if (m <= 128) err = launch_tiles<128>(p, nseg, st);
  else if (m <= 192) err = launch_tiles<192>(p, nseg, st);
  else err = launch_tiles<256>(p, nseg, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
