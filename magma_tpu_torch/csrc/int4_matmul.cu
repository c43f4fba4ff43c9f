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
//       Then wgmma s8 tiles with the operands swapped, out^T = W^T x^T, as
//       int8_matmul.cu's: a block is a producer warpgroup (one thread
//       issuing TMA into a ring of 5-6 stages, mbarrier full/empty pairs)
//       and two consumer warpgroups of 64 W columns each; x's BM rows (96,
//       or 64 where 96 would leave fewer than two blocks an SM, as K4b at
//       M = 192) are wgmma's N.  A stage is half a group: the packed W box
//       (128 rows x 128 columns, 16 KB) and the block's low and high codes
//       (BM x 128 each); a group's x scales come with its second stage into
//       a small ring of their own.  Each
//       consumer thread takes its A fragments from the W box with one
//       ldmatrix.trans per k32 step (two neighbouring columns of eight
//       consecutive packed rows per matrix, conflict-free under the
//       128-byte swizzle), regroups them with four byte permutes and splits
//       the nibbles into the low and the high A in three instructions, each
//       nibble times 16 (w4a8.cuh): one shared-memory read of a packed byte
//       feeds both chains.  The pre-pass writes x's codes in the k order
//       those fragments have, so B comes straight from the TMA box.
//       Per stage 8 wgmma m64nBMk32 into two s32 sets (a group's first step
//       starts them at 0); the second stage's A is built while the first
//       stage's wgmma run, and each stage is freed as soon as its wgmma are
//       done.  Then the thread folds the sums onto its fp32 accumulators in
//       the plain version's order (w4a8_term_x16, 10 fp32/int operations an
//       output, no int->float conversion unit), while the other
//       warpgroup's wgmma keep the tensor cores busy.  K is
//       never split: each output's groups are added in order by one thread,
//       the plain version's bits.  Rows past M read zero codes (TMA's
//       out-of-bounds fill) and scale 1, and are never stored.
//       Registers: 3 BM/2 accumulators (two s32 sets, one fp32) and 32 A
//       registers a consumer thread, under setmaxnreg's 232.
//
// Measured alone (torch.profiler, chip_smoke.py and
// scripts/torch_tiles_ab.py, NVIDIA H100 80GB HBM3 at a 700 W power
// limit), the pre-pass included: K3 M=192 70.4 us (36% of its bound; the
// mma.sync tile it replaces: 274 us), K4b M=192 53.8 us (32%; was 204 us),
// K3 M=2048 601 us (40%); M = 1 as before (K3 32.5 us, K4b 28.9 us).
// What holds the tile back is feeding it (40 KB of TMA boxes a stage, the
// unpack and the fold), not the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"
#include "w4a8.cuh"

using namespace tma_wgmma;

namespace {

struct Segment {
  const __nv_bfloat16* x;  // (M, K), row stride ldx
  long long ldx;
  const int8_t* q4;        // (K/2, N) packed, row stride N
  const float* s4;         // (K/256, N)
  float* out;              // (M, N), row stride N
  int k;
  int8_t* codes;           // M > 8: x's int8 codes (M, K), in the tile's k order
  float* xs;               // M > 8: x's scales (K/512, xs_rows, 2)
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
// M > 8: the activations quantised once, then wgmma s8 tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int QUANT_WARPS = 8;
constexpr int XS_ROWS = 192;         // the scale scratch's rows: M rounded up to this
constexpr int TILE_N = 128;          // W columns a block: 2 consumer warpgroups x 64
constexpr int HALF = W4_GROUP / 2;   // packed rows (and codes of each nibble) a stage
constexpr int TILE_THREADS = 384;    // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int W_BYTES = HALF * TILE_N;  // the packed W box of a stage

// Each segment's x -> int8 codes (M, K) and scales xs[g][row] = (scale of
// block g, of block K/512 + g) for rows < xs_rows (rows past M: scale 1 and
// no codes, the tile's TMA reads zeros there).  One warp a (row, 256-column
// block).  The codes go in the tile's k order: code c of each 16-code piece
// at slot 4 ((c & 7) >> 1) + 2 (c >> 3) + (c & 1), so slots 4t + j hold
// codes (j >> 1) 8 + 2t + (j & 1), the packed rows the tile's A fragment
// puts there.
__global__ void __launch_bounds__(QUANT_WARPS * 32) w4a8_wgmma_quantize_kernel(const Params p,
                                                                               int xs_rows) {
  const Segment sg = p.seg[blockIdx.y];
  const int blocks = sg.k / W4_GROUP;
  const int n_k = blocks / 2;
  const int item = blockIdx.x * QUANT_WARPS + (threadIdx.x >> 5);
  if (item >= xs_rows * blocks) return;  // whole warps leave: the shuffles stay full
  const int row = item / blocks;
  const int b = item % blocks;
  const int lane = threadIdx.x & 31;
  const bool real = row < p.m;
  uint32_t packed[2];
  const float s = warp_quantize_codes<false>(
      real ? sg.x + (long long)row * sg.ldx + b * W4_GROUP : nullptr, packed);
  if (real) {
    // lane's codes 8 lane .. 8 lane + 7 are pairs at slots 4 q + 2 (lane & 1)
    int8_t* dst = sg.codes + (long long)row * sg.k + b * W4_GROUP + 16 * (lane >> 1) +
                  2 * (lane & 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      *reinterpret_cast<uint16_t*>(dst + 4 * q) =
          static_cast<uint16_t>(packed[q / 2] >> (16 * (q % 2)));
    }
  }
  if (lane == 0) sg.xs[((long long)(b % n_k) * xs_rows + row) * 2 + b / n_k] = s;
}

// BM x rows a block = wgmma's N; a stage is half a group: the W box (128
// packed rows x 128 columns) and the low and the high codes of the block's
// rows (BM x 128 each).  A group's x scales (BM x 2 fp32) come with its
// second stage into a ring of their own, so that the stage is free before
// the fold that reads them: the producer writes group g's scales once its
// stage 2g + 1 - STAGES is free, which (STAGES <= 7) the consumers release
// only after the folds of groups up to g - 4, so SCALE_SLOTS = 4 suffice.
constexpr int SCALE_SLOTS = 4;
template <int BM>
struct TileCfg {
  static constexpr int CODES = BM * HALF;
  static constexpr int SCALES = BM * 2 * 4;
  static constexpr int STAGE_BYTES = W_BYTES + 2 * CODES;  // a multiple of 1024
  static constexpr int STAGES = BM <= 64 ? 6 : 5;
  static constexpr int ACC = BM / 2;  // accumulators of each kind a consumer thread holds
  static constexpr int SMEM = STAGES * STAGE_BYTES + SCALE_SLOTS * SCALES + 2 * STAGES * 8 + 1024;
  static_assert(STAGE_BYTES % 1024 == 0 && CODES % 1024 == 0, "whole swizzle atoms");
  static_assert(STAGES <= 7, "SCALE_SLOTS covers the folds still reading scales");
  static_assert(SMEM <= 232448, "the ring must fit in shared memory");
};

struct TileParams {
  CUtensorMap w[2];      // (K_i/2, N) packed int8: boxes of 128 rows x 128 columns
  CUtensorMap codes[2];  // (M, K_i) int8 codes: boxes of BM rows x 128 codes (both swizzled)
  const float* xs[2];    // (K_i/512, xs_rows, 2)
  const float* s4[2];    // (K_i/256, N)
  float* out[2];         // (M, N)
  int k[2];
  int m, n, xs_rows;
};

// Block (m tile, n tile, segment).  Warpgroup 0: one thread keeps the ring
// full with TMA.  Warpgroups 1-2 own 64 W columns each as wgmma's A rows
// (operands swapped, out^T = W^T x^T) and x's BM rows as B, straight from
// the TMA box.
template <int BM>
__global__ void __launch_bounds__(TILE_THREADS, 1)
    w4a8_wgmma_tile_kernel(const __grid_constant__ TileParams p) {
  using C = TileCfg<BM>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* scales = reinterpret_cast<float*>(smem + C::STAGES * C::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(scales + SCALE_SLOTS * BM * 2);
  uint64_t* empty = full + C::STAGES;
  const int seg = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * TILE_N;
  const int kp = p.k[seg] / 2;
  const int n_k = kp / W4_GROUP;
  const int steps = 2 * n_k;
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
      for (int u = 0; u < steps; ++u) {
        const int st = u % C::STAGES;
        if (u >= C::STAGES) mbar_wait(&empty[st], ((u / C::STAGES) & 1) ^ 1);
        uint8_t* stage = smem + st * C::STAGE_BYTES;
        const int g = u >> 1, h = u & 1;
        const int k0 = g * W4_GROUP + h * HALF;
        mbar_expect_tx(&full[st], W_BYTES + 2 * C::CODES + (h ? C::SCALES : 0));
        tma_load_2d(stage, &p.w[seg], &full[st], n0, k0);
        tma_load_2d(stage + W_BYTES, &p.codes[seg], &full[st], k0, m0);
        tma_load_2d(stage + W_BYTES + C::CODES, &p.codes[seg], &full[st], kp + k0, m0);
        if (h) {
          bulk_load(scales + (g % SCALE_SLOTS) * BM * 2,
                    p.xs[seg] + ((long long)g * p.xs_rows + m0) * 2, C::SCALES, &full[st]);
        }
      }
    }
  } else {  // consumer warpgroups
    regs_inc<232>();
    const int ctid = threadIdx.x - 128;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int chunk = (ctid >> 5);            // the warp's 16 columns: chunk 16 of the box's 128
    const int col = 16 * chunk + 2 * g;       // A row g: column col, row g + 8: col + 1
    const float* s4 = p.s4[seg] + n0 + col;
    int ilo[C::ACC], ihi[C::ACC];
    float acc[C::ACC];
#pragma unroll
    for (int i = 0; i < C::ACC; ++i) {
      ilo[i] = ihi[i] = 0;
      acc[i] = 0.f;
    }

    for (int grp = 0; grp < n_k; ++grp) {
      // the group's weight scales, read while its two stages run
      const float2 slo = __ldg(reinterpret_cast<const float2*>(s4 + (long long)grp * p.n));
      const float2 shi =
          __ldg(reinterpret_cast<const float2*>(s4 + (long long)(n_k + grp) * p.n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int u = 2 * grp + h;
        const int st = u % C::STAGES;
        mbar_wait(&full[st], (u / C::STAGES) & 1);
        const uint8_t* stage = smem + st * C::STAGE_BYTES;
        // A: lane L addresses packed row 32 kk + L of the warp's 16-byte
        // chunk; thread (g, t) gets (row 8q + 2t, 8q + 2t + 1) x (col, col + 1)
        // from matrix q, so k slots 4t + j hold packed rows (j >> 1) 8 + 2t +
        // (j & 1) (the pre-pass's order), slots 16 + 4t + j the same plus 16
        uint32_t alo[4][4], ahi[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int r = 32 * kk + lane;
          uint32_t q[4];
          mma_tiles::ldmatrix_x4_trans(q, stage + r * TILE_N + ((chunk ^ (r & 7)) << 4));
          const uint32_t a[4] = {__byte_perm(q[0], q[1], 0x6420), __byte_perm(q[0], q[1], 0x7531),
                                 __byte_perm(q[2], q[3], 0x6420), __byte_perm(q[2], q[3], 0x7531)};
#pragma unroll
          for (int i = 0; i < 4; ++i) nibbles_x16(a[i], alo[kk][i], ahi[kk][i]);
        }
        const uint8_t* xlo = stage + W_BYTES;
        const uint8_t* xhi = xlo + C::CODES;
        wgmma_fence();
        if (h == 0) {
          fence_acc(ilo);
          fence_acc(ihi);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int accumulate = h | kk;  // a group's first k32 step starts the sums at 0
          WgmmaS8<BM>::rs(ilo, alo[kk], sw128_desc(xlo + 32 * kk), accumulate);
          WgmmaS8<BM>::rs(ihi, ahi[kk], sw128_desc(xhi + 32 * kk), accumulate);
        }
        wgmma_commit();
        // the second stage's A is built while the first stage's wgmma run
      }
      wgmma_wait<1>();
      mbar_arrive(&empty[(2 * grp) % C::STAGES]);
      wgmma_wait<0>();
      fence_acc(ilo);
      fence_acc(ihi);
      mbar_arrive(&empty[(2 * grp + 1) % C::STAGES]);
      // fold the group onto the fp32 sum in the plain version's order:
      // D[4j + e] is (column col + (e >> 1), x row 8j + 2t + (e & 1))
      const float* xs = scales + (grp % SCALE_SLOTS) * BM * 2;
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        // (sxlo, sxhi) of x rows 8j + 2t and 8j + 2t + 1
        const float4 sx = *reinterpret_cast<const float4*>(xs + (8 * j + 2 * tq) * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float term = w4a8_term_x16(ilo[i], e & 1 ? sx.z : sx.x, e & 2 ? slo.y : slo.x,
                                           ihi[i], e & 1 ? sx.w : sx.y, e & 2 ? shi.y : shi.x);
          acc[i] = __fadd_rn(acc[i], term);
        }
      }
    }

    float* out = p.out[seg] + n0 + col;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      const int m = m0 + 8 * j + 2 * tq;
      if (m < p.m) {
        *reinterpret_cast<float2*>(out + (long long)m * p.n) =
            make_float2(acc[4 * j], acc[4 * j + 2]);
      }
      if (m + 1 < p.m) {
        *reinterpret_cast<float2*>(out + (long long)(m + 1) * p.n) =
            make_float2(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
}

template <int BM>
cudaError_t launch_tiles(const Params& p, int nseg, int xs_rows, cudaStream_t st) {
  using C = TileCfg<BM>;
  TileParams tp;
  for (int i = 0; i < nseg; ++i) {
    const Segment& sg = p.seg[i];
    if (!encode_2d(&tp.w[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, sg.q4, sg.k / 2, p.n, p.n,
                   HALF, TILE_N, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !encode_2d(&tp.codes[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, sg.codes, p.m, sg.k, sg.k, BM,
                   HALF, CU_TENSOR_MAP_SWIZZLE_128B)) {
      return cudaErrorInvalidValue;
    }
    tp.xs[i] = sg.xs;
    tp.s4[i] = sg.s4;
    tp.out[i] = sg.out;
    tp.k[i] = sg.k;
  }
  tp.m = p.m;
  tp.n = p.n;
  tp.xs_rows = xs_rows;
  // once per process: a host call less on every launch
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      w4a8_wgmma_tile_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (smem_ok != cudaSuccess) return smem_ok;
  const dim3 grid((p.m + BM - 1) / BM, p.n / TILE_N, nseg);
  w4a8_wgmma_tile_kernel<BM><<<grid, TILE_THREADS, C::SMEM, st>>>(tp);
  return cudaSuccess;
}

}  // namespace

// C entry for ctypes.  nseg (1 or 2) segments of width n, each x (m, k_i)
// bf16 with row stride ldx_i (a multiple of 8, 16-byte aligned), q4
// (k_i/2, n) int8 (16-byte aligned) and s4 (k_i/256, n) fp32 contiguous,
// out (m, n) fp32; k_i a multiple of 512 and n of 128.  For m > 8, scratch
// for the activations: codes (m (k_0 + k_1)) int8 and xs (r (k_0 + k_1) /
// 256) fp32 with r = m rounded up to a multiple of 192, segment 0's first;
// null for m <= 8.  Returns a cudaError_t (0 on success).
extern "C" int magma_int4_matmul(int nseg, int m, int n,
                                 const void* x0, long long ldx0, const void* q0,
                                 const float* s0, float* out0, int k0,
                                 const void* x1, long long ldx1, const void* q1,
                                 const float* s1, float* out1, int k1, void* codes, float* xs,
                                 void* stream) {
  if (nseg < 1 || nseg > 2 || m <= 0 || n <= 0 || n % TILE_N || k0 % (2 * W4_GROUP) ||
      (nseg == 2 && k1 % (2 * W4_GROUP)) || (m > 8 && (codes == nullptr || xs == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int xs_rows = (m + XS_ROWS - 1) / XS_ROWS * XS_ROWS;
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
                           xs ? xs + (long long)xs_rows * (k0 / W4_GROUP) : nullptr}
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
    return (int)cudaGetLastError();
  }
  const int items = xs_rows * ((nseg == 2 && k1 > k0 ? k1 : k0) / W4_GROUP);
  w4a8_wgmma_quantize_kernel<<<dim3((items + QUANT_WARPS - 1) / QUANT_WARPS, nseg),
                               QUANT_WARPS * 32, 0, st>>>(p, xs_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // 96 rows a block unless that leaves fewer than two blocks an SM (K4b at
  // M = 192: 64 blocks would carry fc_out's 32 groups): then 64
  const int blocks96 = (m + 95) / 96 * (n / TILE_N) * nseg;
  err = m <= 64 || blocks96 < 2 * sm_count() ? launch_tiles<64>(p, nseg, xs_rows, st)
                                             : launch_tiles<96>(p, nseg, xs_rows, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
