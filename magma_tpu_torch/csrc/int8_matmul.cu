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
//   M > 8: mma.sync m16n8k16 bf16 tiles, 64 x 128 per block of 4 warps,
//       K steps of 32.  x arrives by cp.async; W is read as int8, converted
//       to bf16 while it is staged in shared memory, and fed by ldmatrix.trans
//       as the B operand, so device memory only ever sees int8 weights.  Rows
//       past M are zero-filled and never stored.  No pipelining, no wgmma or
//       TMA yet: those come when this kernel is made fast.
//
// Measured alone (torch.profiler, chip_smoke.py, NVIDIA H100 80GB HBM3 at a
// 700 W power limit): K2b 69.5 us at M=1 (51% of its bound) and 427 us at
// M=192 (11%), K4a 54.7 us at M=1 (46%; 65.4-66.6 us without the split of
// K, same run) and 742 us, K2a 117 us (53%).  The GEMV reads ~50% of HBM
// bandwidth; the M > 8 tiles are latency-bound on the serial k loop.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"

namespace cg = cooperative_groups;

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
// M > 8: mma.sync tiles
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 128, BK = 32;
constexpr int MMA_THREADS = 128;  // 2 x 2 warps of 32 x 64
constexpr int LDA = BK + 8;       // bf16 per shared row: staggers ldmatrix banks
constexpr int LDB = BN + 8;

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(ptr)));
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(MMA_THREADS) mma_kernel(const Params p) {
  const Segment sg = p.seg[blockIdx.z];
  __shared__ __align__(16) __nv_bfloat16 sA[BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 sB[BK * LDB];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 32-row half of the tile
  const int wn = warp & 1;   // 64-column half
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < sg.k; k0 += BK) {
    // A: 64 rows x 32 bf16 = 4 chunks of 16 B a row
    for (int i = tid; i < BM * (BK / 8); i += MMA_THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      const bool valid = m0 + r < p.m;
      const __nv_bfloat16* src = valid ? sg.x + (long long)(m0 + r) * sg.ldx + k0 + c : sg.x;
      cp_async_16(sA + r * LDA + c, src, valid);
    }
    // B: 32 rows x 128 int8 = 8 chunks of 16 B a row, converted to bf16
    for (int i = tid; i < BK * (BN / 16); i += MMA_THREADS) {
      const int r = i / (BN / 16);
      const int c = (i % (BN / 16)) * 16;
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(sg.w + (long long)(k0 + r) * p.n + n0 + c));
      float f[16];
      s8x4_to_f32(wv.x, f);
      s8x4_to_f32(wv.y, f + 4);
      s8x4_to_f32(wv.z, f + 8);
      s8x4_to_f32(wv.w, f + 12);
      uint4 lo, hi;
      lo.x = pack_bf16x2(f[0], f[1]);
      lo.y = pack_bf16x2(f[2], f[3]);
      lo.z = pack_bf16x2(f[4], f[5]);
      lo.w = pack_bf16x2(f[6], f[7]);
      hi.x = pack_bf16x2(f[8], f[9]);
      hi.y = pack_bf16x2(f[10], f[11]);
      hi.z = pack_bf16x2(f[12], f[13]);
      hi.w = pack_bf16x2(f[14], f[15]);
      *reinterpret_cast<uint4*>(sB + r * LDB + c) = lo;
      *reinterpret_cast<uint4*>(sB + r * LDB + c + 8) = hi;
    }
    cp_async_commit_and_wait();
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldmatrix_x4(a[mi], sA + (wm * 32 + mi * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDA +
                               kk + (lane / 16) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sB + (kk + (lane % 8) + ((lane / 8) % 2) * 8) * LDB + wn * 64 +
                                 nj * 8 + (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_16816(acc[mi][nj], a[mi], b[0], b[1]);
          mma_16816(acc[mi][nj + 1], a[mi], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // the tiles are read before the next step overwrites them
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int nj = 0; nj < 8; ++nj) {
      const int col = n0 + wn * 64 + nj * 8 + tig * 2;
      const float s0 = sg.s[col];
      const float s1 = sg.s[col + 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 32 + mi * 16 + gid + 8 * r;
        if (row < p.m) {
          *reinterpret_cast<float2*>(sg.out + (long long)row * p.n + col) =
              make_float2(acc[mi][nj][2 * r] * s0, acc[mi][nj][2 * r + 1] * s1);
        }
      }
    }
  }
}

}  // namespace

// C entry for ctypes.  nseg (1 or 2) segments of width n, each x (m, k_i)
// bf16 with row stride ldx_i (a multiple of 8, 16-byte aligned), w (k_i, n)
// int8 contiguous, s (n,) fp32, out (m, n) fp32; k_i and n multiples of 128.
// Returns a cudaError_t (0 on success).
extern "C" int magma_int8_matmul(int nseg, int m, int n,
                                 const void* x0, long long ldx0, const void* w0,
                                 const float* s0, float* out0, int k0,
                                 const void* x1, long long ldx1, const void* w1,
                                 const float* s1, float* out1, int k1, void* stream) {
  // k_i % BN also makes each of the GEMV_SPLIT parts of K a whole number of rows
  if (nseg < 1 || nseg > 2 || m <= 0 || n <= 0 || n % BN || k0 % BN ||
      (nseg == 2 && k1 % BN)) {
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
  if (m <= 8) {
    cudaError_t err;
    if (m == 1) err = launch_gemv<1>(p, nseg, st);
    else if (m == 2) err = launch_gemv<2>(p, nseg, st);
    else if (m <= 4) err = launch_gemv<4>(p, nseg, st);
    else err = launch_gemv<8>(p, nseg, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    const dim3 grid(n / BN, (m + BM - 1) / BM, nseg);
    mma_kernel<<<grid, MMA_THREADS, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}
