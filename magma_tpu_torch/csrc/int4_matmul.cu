// W4A8 matrix products for Hopper (sm_90a): bf16 x, quantised to int8 per
// (row, 256-column block), times nibble-packed int4 W with
// 256-row group scales; int8 x int8 dots in int32, the scales folded onto
// an fp32 sum group by group (w4a8.cuh has the arithmetic).
//
// Replaces two Pallas kernels of magma_tpu/ops/quant.py:
//   K3  `_int4_matmul_stacked_kernel` (the fused [q|k|v|fc_in] in_proj,
//       K=4096, N=28672: M=192 in the caption prefill, M=1 for layer 0 of
//       each decode step; the other layers' in_proj runs inside K6),
//   K4b `_int4_dual_kernel` (o_proj and fc_out over the K-concatenated
//       int4 stream, Ko=4096, Kf=16384, N=4096, two outputs; M=192).
// One C entry serves both, as int8_matmul.cu serves K2b and K4a: one or two
// "segments" (x, q4, s4, out, K) of a common N; a stacked layer is the base
// pointer of its view.
//
// What bounds it on an H100 SXM (3.35 TB/s, 1,979 int8 TOPS dense):
//   M <= 8: the packed weight stream.  K3 in_proj 58.7 MB of nibbles + 1.8 MB
//       of group scales -> 18 us; K4b 41.9 MB -> 12.5 us.
//   M = 192: the int8 tensor cores, 2 M K N: K3 45.1 G operations -> 23 us,
//       K4b 32.2 G -> 16 us.
//
// What the design does about it:
//   M <= 8: a block of 8 warps owns a 32-column slice of one segment; each
//       warp takes one group (256 packed rows) at a time, quantises its two
//       activation blocks itself into shared memory, and streams the group
//       in 32-byte sector pieces, four rows a lane, transposed in registers
//       by byte permutes so that one __dp4a takes four rows of a column.
//       The warps' group terms meet in shared memory and are added in group
//       order: no atomics, the plain version's bits.  N/32 slices: 896
//       blocks for in_proj, 2 x 128 for the dual (its fc_out blocks walk 4x
//       the groups).
//   M > 8: two launches.  A pre-pass quantises each activation row once
//       (one warp a (row, 256-column block)) into int8 codes and scales in
//       scratch the wrapper allocates, rather than in every column tile.
//       Then 64 x 64 tiles of 4 warps, mma.sync m16n8k32 s8 -> s32: for
//       each group the block copies its 64 rows' lo | hi codes by cp.async,
//       reads the group's 256 x 64 packed bytes with 16-byte loads, unpacks
//       the nibbles into int8 tiles stored column-major (the mma's B
//       layout), runs 8 k-steps for the low and the high nibbles into two
//       int32 tiles, and folds them onto the fp32 accumulator.  No
//       pipelining across groups, no wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w4a8.cuh"

namespace {

struct Segment {
  const __nv_bfloat16* x;  // (M, K), row stride ldx
  long long ldx;
  const int8_t* q4;        // (K/2, N) packed, row stride N
  const float* s4;         // (K/256, N)
  float* out;              // (M, N), row stride N
  int k;
  int8_t* codes;           // M > 8: x's int8 codes (M, K)
  float* xs;               // M > 8: x's scales (M, K/256)
};

struct Params {
  Segment seg[2];
  int m, n;
};

// ---------------------------------------------------------------------------
// M <= 8: one 32-column slice a block, one group a warp
// ---------------------------------------------------------------------------

constexpr int GEMV_THREADS = 256;
constexpr int GEMV_WARPS = GEMV_THREADS / 32;

template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS) w4a8_gemv_kernel(const Params p) {
  const Segment sg = p.seg[blockIdx.y];
  __shared__ __align__(16) int8_t codes[GEMV_WARPS][2][MT][W4_GROUP];
  __shared__ float terms[GEMV_WARPS][MT][W4_SLICE];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kp = sg.k / 2;
  const int n_k = kp / W4_GROUP;
  const int col0 = blockIdx.x * W4_SLICE;
  const int tm = threadIdx.x / W4_SLICE;  // the (row, column) this thread sums
  const int tj = threadIdx.x % W4_SLICE;
  const bool mine = threadIdx.x < MT * W4_SLICE && tm < p.m;

  float acc = 0.f;
  for (int g0 = 0; g0 < n_k; g0 += GEMV_WARPS) {
    const int g = g0 + warp;
    if (g < n_k) {
      float term[MT][4];
      w4a8_group_term<MT, false>(sg.x, sg.ldx, p.m, kp, sg.q4, sg.s4, p.n, g, col0, codes[warp],
                                 term);
      if (lane < 8) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) terms[warp][m][4 * lane + c] = term[m][c];
      }
    }
    __syncthreads();
    if (mine) {
      const int count = min(GEMV_WARPS, n_k - g0);
      for (int w = 0; w < count; ++w) acc = __fadd_rn(acc, terms[w][tm][tj]);  // group order
    }
    __syncthreads();  // terms are read before the next groups overwrite them
  }
  if (mine) sg.out[(long long)tm * p.n + col0 + tj] = acc;
}

// ---------------------------------------------------------------------------
// M > 8: the activations quantised once, then mma.sync m16n8k32 s8 tiles
// ---------------------------------------------------------------------------

constexpr int QUANT_WARPS = 8;

// Each segment's x -> int8 codes (M, K) and scales (M, K/256), one warp a
// (row, 256-column block), so the tiles below read codes instead of
// quantising their rows again for every column tile.
__global__ void __launch_bounds__(QUANT_WARPS * 32) w4a8_mma_quantize_kernel(const Params p) {
  const Segment sg = p.seg[blockIdx.y];
  const int blocks = sg.k / W4_GROUP;
  const int item = blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (item >= p.m * blocks) return;  // whole warps leave: the shuffles stay full
  const int row = item / blocks;
  const int b = item % blocks;
  const float s = warp_quantize_row<false>(sg.x + (long long)row * sg.ldx + b * W4_GROUP,
                                           sg.codes + (long long)row * sg.k + b * W4_GROUP);
  if ((threadIdx.x & 31) == 0) sg.xs[(long long)row * blocks + b] = s;
}

constexpr int BM = 64, BN = 64;
constexpr int MMA_THREADS = 128;               // 2 x 2 warps of 32 x 32
constexpr int LDA = 2 * W4_GROUP + 16;         // bytes per shared A row: lo | hi codes
constexpr int LDB = W4_GROUP + 16;             // bytes per shared B column
constexpr int SMEM_A = BM * LDA;
constexpr int SMEM_B = BN * LDB;
constexpr int MMA_SMEM = SMEM_A + 2 * SMEM_B + BM * 2 * (int)sizeof(float);
constexpr int A_CHUNKS = 2 * W4_GROUP / 16;    // 16-byte pieces of a shared A row
constexpr int B_ITEMS = (W4_GROUP / 4) * (BN / 16) / MMA_THREADS;  // 4 x 16-byte items a thread

// d += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte async copy into shared memory; zero-filled where !valid
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(MMA_THREADS) w4a8_mma_kernel(const Params p) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* sA = smem;                        // [BM][LDA]: codes of x lo | x hi
  int8_t* sBlo = smem + SMEM_A;             // [BN][LDB]: low nibbles, column-major
  int8_t* sBhi = sBlo + SMEM_B;             // [BN][LDB]: high nibbles
  float* sx = reinterpret_cast<float*>(sBhi + SMEM_B);  // [BM][2] activation scales

  const Segment sg = p.seg[blockIdx.z];
  const int kp = sg.k / 2;
  const int n_k = kp / W4_GROUP;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 32-row half of the tile
  const int wn = warp & 1;   // 32-column half
  const int gid = lane >> 2;
  const int tig = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int g = 0; g < n_k; ++g) {
    __syncthreads();  // the previous group's tiles are read
    // A: the group's lo and hi codes of the block's rows, by cp.async
    // (rows past M: codes 0, scale 1, as a zero row quantises)
    for (int i = tid; i < BM * A_CHUNKS; i += MMA_THREADS) {
      const int r = i / A_CHUNKS;
      const int c = i % A_CHUNKS;
      const bool valid = m0 + r < p.m;
      const int col = (c < A_CHUNKS / 2 ? 0 : kp - W4_GROUP) + g * W4_GROUP + c * 16;
      cp_async_16(sA + r * LDA + c * 16,
                  sg.codes + (valid ? (long long)(m0 + r) * sg.k + col : 0), valid);
    }
    for (int r = tid; r < BM; r += MMA_THREADS) {
      const bool valid = m0 + r < p.m;
      const float* xs = sg.xs + (long long)(m0 + r) * 2 * n_k;
      sx[2 * r] = valid ? xs[g] : 1.f;
      sx[2 * r + 1] = valid ? xs[n_k + g] : 1.f;
    }
    // B: 256 packed rows x 64 columns; a thread takes 4 rows x 16 columns
    // (four 16-byte loads), transposes each 4 x 4 bytes into columns and
    // stores their low and high nibbles column-major (a warp's 32 items
    // are 32 row quads of one column range: no bank conflicts)
#pragma unroll
    for (int it = 0; it < B_ITEMS; ++it) {
      const int i = tid + it * MMA_THREADS;
      const int r = (i % (W4_GROUP / 4)) * 4;
      const int c = (i / (W4_GROUP / 4)) * 16;
      const int8_t* src = sg.q4 + (long long)(g * W4_GROUP + r) * p.n + n0 + c;
      uint4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = __ldg(reinterpret_cast<const uint4*>(src + j * (long long)p.n));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t col[4];
        transpose4x4(word(w[0], q), word(w[1], q), word(w[2], q), word(w[3], q), col);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          *reinterpret_cast<uint32_t*>(sBlo + (c + 4 * q + j) * LDB + r) = lo_nibbles(col[j]);
          *reinterpret_cast<uint32_t*>(sBhi + (c + 4 * q + j) * LDB + r) = hi_nibbles(col[j]);
        }
      }
    }
    cp_async_commit_and_wait();
    __syncthreads();

    int ilo[2][4][4], ihi[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ilo[i][j][e] = ihi[i][j][e] = 0;

#pragma unroll 2
    for (int ks = 0; ks < W4_GROUP; ks += 32) {
      uint32_t alo[2][4], ahi[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* r0 = sA + (wm * 32 + mi * 16 + gid) * LDA + ks + tig * 4;
        const int8_t* r8 = r0 + 8 * LDA;
        alo[mi][0] = lds32(r0);
        alo[mi][1] = lds32(r8);
        alo[mi][2] = lds32(r0 + 16);
        alo[mi][3] = lds32(r8 + 16);
        ahi[mi][0] = lds32(r0 + W4_GROUP);
        ahi[mi][1] = lds32(r8 + W4_GROUP);
        ahi[mi][2] = lds32(r0 + W4_GROUP + 16);
        ahi[mi][3] = lds32(r8 + W4_GROUP + 16);
      }
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int cb = (wn * 32 + nj * 8 + gid) * LDB + ks + tig * 4;
        const uint32_t blo0 = lds32(sBlo + cb), blo1 = lds32(sBlo + cb + 16);
        const uint32_t bhi0 = lds32(sBhi + cb), bhi1 = lds32(sBhi + cb + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_s8(ilo[mi][nj], alo[mi], blo0, blo1);
          mma_s8(ihi[mi][nj], ahi[mi], bhi0, bhi1);
        }
      }
    }

    // fold the group onto the fp32 sum, as the plain version does
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + wn * 32 + nj * 8 + tig * 2 + e;
        const float slo = __ldg(sg.s4 + (long long)g * p.n + col);
        const float shi = __ldg(sg.s4 + (long long)(n_k + g) * p.n + col);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int rl = wm * 32 + mi * 16 + gid + 8 * r;
            const int i = 2 * r + e;
            acc[mi][nj][i] = __fadd_rn(acc[mi][nj][i],
                                       w4a8_term(ilo[mi][nj][i], sx[2 * rl], slo, ihi[mi][nj][i],
                                                 sx[2 * rl + 1], shi));
          }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int col = n0 + wn * 32 + nj * 8 + tig * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 32 + mi * 16 + gid + 8 * r;
        if (row < p.m) {
          *reinterpret_cast<float2*>(sg.out + (long long)row * p.n + col) =
              make_float2(acc[mi][nj][2 * r], acc[mi][nj][2 * r + 1]);
        }
      }
    }
}

}  // namespace

// C entry for ctypes.  nseg (1 or 2) segments of width n, each x (m, k_i)
// bf16 with row stride ldx_i (a multiple of 8, 16-byte aligned), q4
// (k_i/2, n) int8 and s4 (k_i/256, n) fp32 contiguous, out (m, n) fp32;
// k_i a multiple of 512 and n of 128.  For m > 8, scratch for the
// activations: codes (m (k_0 + k_1)) int8 and xs (m (k_0 + k_1) / 256)
// fp32, segment 0's first; null for m <= 8.  Returns a cudaError_t (0 on
// success).
extern "C" int magma_int4_matmul(int nseg, int m, int n,
                                 const void* x0, long long ldx0, const void* q0,
                                 const float* s0, float* out0, int k0,
                                 const void* x1, long long ldx1, const void* q1,
                                 const float* s1, float* out1, int k1, void* codes, float* xs,
                                 void* stream) {
  if (nseg < 1 || nseg > 2 || m <= 0 || n <= 0 || n % 128 || k0 % (2 * W4_GROUP) ||
      (nseg == 2 && k1 % (2 * W4_GROUP)) || (m > 8 && (codes == nullptr || xs == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int8_t* c8 = static_cast<int8_t*>(codes);
  Params p;
  p.m = m;
  p.n = n;
  p.seg[0] = Segment{static_cast<const __nv_bfloat16*>(x0), ldx0,
                     static_cast<const int8_t*>(q0), s0, out0, k0, c8, xs};
  p.seg[1] = nseg == 2
                 ? Segment{static_cast<const __nv_bfloat16*>(x1), ldx1,
                           static_cast<const int8_t*>(q1), s1, out1, k1,
                           c8 ? c8 + (long long)m * k0 : nullptr,
                           xs ? xs + (long long)m * (k0 / W4_GROUP) : nullptr}
                 : p.seg[0];
  // the segment with more groups first: its blocks are dispatched first
  if (nseg == 2 && k1 > k0) {
    const Segment first = p.seg[1];
    p.seg[1] = p.seg[0];
    p.seg[0] = first;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m <= 8) {
    const dim3 grid(n / W4_SLICE, nseg);
    if (m == 1) w4a8_gemv_kernel<1><<<grid, GEMV_THREADS, 0, st>>>(p);
    else if (m == 2) w4a8_gemv_kernel<2><<<grid, GEMV_THREADS, 0, st>>>(p);
    else if (m <= 4) w4a8_gemv_kernel<4><<<grid, GEMV_THREADS, 0, st>>>(p);
    else w4a8_gemv_kernel<8><<<grid, GEMV_THREADS, 0, st>>>(p);
  } else {
    cudaError_t err = cudaFuncSetAttribute(w4a8_mma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int items = m * ((nseg == 2 && k1 > k0 ? k1 : k0) / W4_GROUP);
    w4a8_mma_quantize_kernel<<<dim3((items + QUANT_WARPS - 1) / QUANT_WARPS, nseg),
                               QUANT_WARPS * 32, 0, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(n / BN, (m + BM - 1) / BM, nseg);
    w4a8_mma_kernel<<<grid, MMA_THREADS, MMA_SMEM, st>>>(p);
  }
  return (int)cudaGetLastError();
}
