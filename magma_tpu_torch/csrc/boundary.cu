// The int4 decode's layer boundary in one launch, for Hopper (sm_90a): for
// m <= 8 bf16 rows,
//   a = bf16(ctx @ W_o) [+ bf16(o_bias)] [+ bf16(adapter_attn(a or u_in))]
//   m = bf16(mh @ W_fc_out) + bf16(b_fc_out) [+ bf16(adapter_mlp(m or u_in))]
//   y = x + a + m                                   (bf16 adds, in that order)
//   u = bf16(LN(y) * ln_g + ln_b)                   (fp32 statistics)
//   fused = bf16(u @ W_in[next layer])              (unless the last layer)
// with W_o/W_fc_out the K-concatenated int4 dual payload and W_in the int4
// in_proj, both W4A8 (w4a8.cuh), and the adapters the fused int8 payloads
// of fused_adapter.cu (K5's function: h = relu(src @ Wd * sd + bd) rounded
// to bf16, out = h @ Wu * su + bu).
//
// Replaces: magma_tpu/ops/quant.py `_boundary_kernel` (launched by
// `boundary_fused_stacked`, which `gptj._run_decode_boundary` calls once
// per layer of a b <= 8 int4 decode step).  The Pallas kernel walks one
// sequential grid whose steps are the dual, the adapters, the epilogue and
// the in_proj, carrying its state in VMEM.
//
// What bounds it on an H100 SXM: the weights it streams.  At GPT-J 6B with
// the v1 mlp adapter: the dual's nibbles and scales (42.6 MB), the
// adapter's int8 weights (8.4 MB) and the next in_proj's nibbles and scales
// (60.6 MB), about 112 MB -> 33.5 us at 3.35 TB/s, whatever m is.  The
// operations (2 m (D + F) D + 2 m D NI int8, 4.6 GOP at m = 8) take 2.3 us
// on the tensor cores.
//
// What the design does about it: the pipeline of stream_tiles.cuh (one
// block an SM, a producer warp streaming 256 x 128 weight tiles through a
// TMA ring across the phase barriers, owner-summed tiles released by
// counters), shared with K5.  Per launch, in order:
//   1 dual.  Items (W4A8 group, 128-column tile), group-major, in
//     contiguous ranges: 1280 at 6B, about 10 a block, which span one or
//     two groups.  So each block quantises the ctx and mh blocks of its
//     own groups (w4a8.cuh's arithmetic, 2 m warp tasks a group) into
//     shared memory when its range enters a group: no L2 scratch of codes
//     and no barrier before the dual, and each activation block is
//     quantised by the two or three blocks that share its group rather
//     than by every warp item (the phase-per-barrier design this one
//     replaces: 128 times).  The int32 dots run on mma.sync.m16n8k32.s8:
//     the tile's nibbles (times 16, w4a8.cuh's nibbles_x16) as A, 32
//     columns a warp, the <= 8 rows' codes as the n8 B, K split over two
//     warps and added exactly.  Each (row, column) term is w4a8_term's
//     unfused fp32 steps, to scratch; the block that owns a (tile, row)
//     adds W_o's groups and W_fc_out's in order from 0: the plain
//     version's bits.  Then the biases: a and m, or y without adapters.
//   2 adapter down: K5's items (adapter_items: int8 weights widened to
//     bf16 as mma.sync's A), the 256-row chunks summed in order by the
//     owners: h.
//   3 adapter up: K5's slices (32 columns over all of dh, both adapters in
//     one item), each block adding its own K: y = x + a + m.
//   4 LN and the next in_proj: every block takes the rows' statistics
//     (a warp a row), writes its share of u, and quantises u's blocks of
//     its own in_proj groups (group-major again: 1792 items, about 14 a
//     block); the in_proj's tiles are owned and summed as the dual's:
//     fused, the plain version's bits on this u.
// A grid barrier closes phases 1, 2 and 3 (1 without adapters): three at
// most, against the six of the design it replaces.  No float atomics: the
// same bits on a repeat.  STAMP builds write a %globaltimer stamp at each
// phase's start and end per block (measurement only, never on the main
// path).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "stream_tiles.cuh"
#include "w4a8.cuh"

namespace {

using namespace stream_tiles;
using tma_wgmma::align_1024;
using tma_wgmma::fence_barrier_init;

constexpr int MAX_ROWS = 8;
constexpr int CPITCH = W4_GROUP + 16;  // bytes a row of codes (272: conflict-free B loads)
constexpr int N_PHASES = 8;            // the stamps' phases (ops/quant.py BOUNDARY_PHASES)
enum Map { M_QD, M_SD, M_QI, M_SI, M_WD0, M_WD1, M_WU0, M_WU1, N_MAPS };
enum Phase { P_DUAL, P_DUAL_SUMS, P_DOWN, P_DOWN_SUMS, P_UP, P_LN, P_IN, P_IN_SUMS };

// shared memory, after the 1024-byte alignment of the dynamic base
constexpr int OFF_XS = RING_BYTES;                          // bf16 [8][HPITCH] or [8][XPITCH]
constexpr int OFF_CODES = OFF_XS + MAX_ROWS * HPITCH * 2;   // int8 [lo/hi][8][CPITCH]
constexpr int OFF_XSC = OFF_CODES + 2 * MAX_ROWS * CPITCH;  // fp32 [lo/hi][8]
constexpr int OFF_RED = OFF_XSC + 2 * MAX_ROWS * 4;         // int [2][4 warps][16][32]
constexpr int OFF_STATS = OFF_RED + 2 * 4 * 16 * 32 * 4;    // fp32 [8][2]
constexpr int OFF_BARS = OFF_STATS + MAX_ROWS * 2 * 4;      // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BARS + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "the ring must fit in shared memory");
static_assert(OFF_CODES % 16 == 0 && OFF_RED % 16 == 0 && OFF_BARS % 8 == 0, "alignment");
static_assert(TILE_ROWS == W4_GROUP, "a W4A8 tile is one group");

struct Params {
  // (columns, rows, layer) stacks: the dual's and the in_proj's packed
  // nibbles and group scales, each adapter's Wd and Wu
  CUtensorMap maps[N_MAPS];
  int m, d, f, ni, layer;
  int dh[2], src_in[2];  // 0: attention adapter, 1: mlp adapter; dh 0: absent
  float eps;
  const bf16 *ctx, *mh, *x, *u_in;               // (m, d), (m, f), (m, d), (m, d) or null
  const float *b_fc_out, *ln_g, *ln_b, *o_bias;  // the layer's (d,) rows; o_bias may be null
  const float *sd[2], *bd[2], *su[2], *bu[2];    // the adapters' layer rows
  bf16 *y, *u, *fused;                           // (m, d), (m, d), (m, ni)
  float* terms;              // the phases' chunk terms, one region reused phase after phase
  bf16 *ab, *mb, *h[2];      // (m, d), (m, d), (m, dh[k])
  unsigned long long* flag;  // the launch's nonce, then
  unsigned* counters;        // Plan's counters
  unsigned long long nonce;
  unsigned long long* stamps;  // STAMP: (grid, N_PHASES, 2)
};

// the item counts of a launch: the same in every block and role (ops/quant.py
// `boundary_plan` mirrors it)
struct Plan {
  int T;         // d's 128-column tiles
  int no, nf;    // the dual's W4A8 groups: W_o's, W_fc_out's
  int C;         // d's 256-row chunks (adapter down)
  int tdn[2];    // each adapter's column tiles of dh
  int slices;    // d's 32-column slices (adapter up: an item over both adapters)
  int gi, ti;    // the in_proj's groups and column tiles
  bool adapters;
  int c_dual, c_dn, c_in, n_counters;  // counter offsets (0: the grid barrier's)
};

__host__ __device__ inline Plan make_plan(int d, int f, int ni, const int* dh) {
  Plan q;
  q.T = d / TILE_COLS;
  q.no = d / (2 * W4_GROUP);
  q.nf = f / (2 * W4_GROUP);
  q.C = (d + TILE_ROWS - 1) / TILE_ROWS;
  for (int k = 0; k < 2; ++k) q.tdn[k] = dh[k] / TILE_COLS;
  q.adapters = dh[0] > 0 || dh[1] > 0;
  q.slices = q.adapters ? d / SLICE_COLS : 0;
  q.gi = d / (2 * W4_GROUP);
  q.ti = ni / TILE_COLS;
  q.c_dual = 1;
  q.c_dn = q.c_dual + q.T;
  q.c_in = q.c_dn + q.tdn[0] + q.tdn[1];
  q.n_counters = q.c_in + q.ti;
  return q;
}

// rows of the dual's scale stack holding group g's low and high nibbles'
// scales: W_o's groups, then W_fc_out's, each low then high
__device__ __forceinline__ int2 dual_scale_rows(const Plan& q, int g) {
  if (g < q.no) return make_int2(g, q.no + g);
  const int gf = g - q.no;
  return make_int2(2 * q.no + gf, 2 * q.no + q.nf + gf);
}

__device__ __forceinline__ AdapterProduct down_product(const Params& p, const Plan& q) {
  AdapterProduct P{};
  for (int k = 0; k < 2; ++k) {
    P.src[k] = p.src_in[k] ? p.u_in : (k == 0 ? p.ab : p.mb);
    P.ld[k] = p.d;
    P.k[k] = p.d;
    P.n[k] = p.dh[k];
    P.chunks[k] = p.dh[k] ? q.C : 0;
    P.tiles[k] = q.tdn[k];
    P.terms[k] = p.terms + (k == 0 ? 0ll : (long long)q.C * p.m * p.dh[0]);
    P.cnt[k] = p.counters + q.c_dn + (k == 0 ? 0 : q.tdn[0]);
  }
  return P;
}

// ---------------------------------------------------------------------------
// the producer: every tile of the block's items, in the consumers' order
// ---------------------------------------------------------------------------

__device__ void produce(const Params& p, const Plan& q, Producer& emit) {
  Range r = block_range((q.no + q.nf) * q.T);
  for (int i = r.lo; i < r.hi; ++i) {
    const int g = i / q.T, t = i % q.T;
    const int2 sr = dual_scale_rows(q, g);
    Load ld{};
    ld.bytes = STAGE_BYTES;
    ld.add(M_QD, t * TILE_COLS, g * W4_GROUP, p.layer, 0);
    ld.add(M_SD, t * TILE_COLS, sr.x, p.layer, TILE_BYTES);
    ld.add(M_SD, t * TILE_COLS, sr.y, p.layer, TILE_BYTES + 512);
    emit(ld);
  }
  if (q.adapters) {
    const AdapterProduct dn = down_product(p, q);
    adapter_loads(dn, block_range(dn.items()), M_WD0, p.layer, emit);
    r = block_range(q.slices);
    for (int sl = r.lo; sl < r.hi; ++sl) {
      for (int k = 0; k < 2; ++k) {
        if (p.dh[k]) slice_loads(M_WU0 + k, p.dh[k], sl, p.layer, emit);
      }
    }
  }
  if (p.ni) {
    r = block_range(q.gi * q.ti);
    for (int i = r.lo; i < r.hi; ++i) {
      const int g = i / q.ti, t = i % q.ti;
      Load ld{};
      ld.bytes = STAGE_BYTES;
      ld.add(M_QI, t * TILE_COLS, g * W4_GROUP, p.layer + 1, 0);
      ld.add(M_SI, t * TILE_COLS, g, p.layer + 1, TILE_BYTES);
      ld.add(M_SI, t * TILE_COLS, q.gi + g, p.layer + 1, TILE_BYTES + 512);
      emit(ld);
    }
  }
}

// ---------------------------------------------------------------------------
// W4A8 on tensor cores
// ---------------------------------------------------------------------------

struct Shared {
  bf16* xs;
  int8_t* codes;  // [lo/hi][MAX_ROWS][CPITCH]
  float* xsc;     // [lo/hi][MAX_ROWS]
  int* red;       // [2][4][16][32] (int dots), or phase_up's K-quarter sums
  float* stats;   // [8][mean, 1 / sqrt(var + eps)]
};

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four bytes W[row][c .. c + 3] of a 128-byte-swizzled 256 x 128 tile
__device__ __forceinline__ uint32_t tile_word(const uint8_t* tile, int row, int c) {
  return *reinterpret_cast<const uint32_t*>(tile + row * TILE_COLS +
                                            ((((c >> 4) ^ (row & 7)) << 4) | (c & 15)));
}

// One W4A8 tile (a group's 256 packed rows x 128 columns and its two scale
// rows in the stage) against the group's codes of <= 8 rows: the int32 dots
// on mma.sync.m16n8k32.s8, then each (row, column) term, stored to
// dst (the tile's first column of row 0 of an fp32 (rows, ld) plane) for
// rows < m.  Warp w < 4 takes columns 32 w .. 32 w + 31 over packed rows
// 0-127, warp w + 4 the same columns over rows 128-255; a thread (g, t)
// reads four consecutive columns 32 (w % 4) + 4 g .. + 3 of four rows with
// one load each (transpose4x4 makes each column's four k one A register):
// its A rows g, g + 8 of mma tile 0 are columns + 0, + 1, of tile 1
// columns + 2, + 3.  The halves' dots meet in `red` (integers: exact).
// Every consumer thread calls it.
__device__ void w4a8_tile(Ring& ring, const Shared& s, int item_parity, float* dst, long long ld,
                          int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int half = warp >> 2, col = 32 * (warp & 3) + 4 * g;
  const int8_t* clo = s.codes + g * CPITCH;
  const int8_t* chi = s.codes + (MAX_ROWS + g) * CPITCH;
  int lo[2][4] = {}, hi[2][4] = {};
  int st;
  const uint8_t* tile = ring_wait(ring, st);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int k = half * 128 + ks * 32 + 4 * t;
    uint32_t c0[4], c1[4];
    transpose4x4(tile_word(tile, k, col), tile_word(tile, k + 1, col), tile_word(tile, k + 2, col),
                 tile_word(tile, k + 3, col), c0);
    transpose4x4(tile_word(tile, k + 16, col), tile_word(tile, k + 17, col),
                 tile_word(tile, k + 18, col), tile_word(tile, k + 19, col), c1);
    uint32_t l0[4], h0[4], l1[4], h1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      nibbles_x16(c0[j], l0[j], h0[j]);
      nibbles_x16(c1[j], l1[j], h1[j]);
    }
    const uint32_t blo0 = *reinterpret_cast<const uint32_t*>(clo + k);
    const uint32_t blo1 = *reinterpret_cast<const uint32_t*>(clo + k + 16);
    const uint32_t bhi0 = *reinterpret_cast<const uint32_t*>(chi + k);
    const uint32_t bhi1 = *reinterpret_cast<const uint32_t*>(chi + k + 16);
    mma_s8(lo[0], l0[0], l0[1], l1[0], l1[1], blo0, blo1);
    mma_s8(lo[1], l0[2], l0[3], l1[2], l1[3], blo0, blo1);
    mma_s8(hi[0], h0[0], h0[1], h1[0], h1[1], bhi0, bhi1);
    mma_s8(hi[1], h0[2], h0[3], h1[2], h1[3], bhi0, bhi1);
  }
  int* red = s.red + item_parity * (4 * 16 * 32) + (warp & 3) * (16 * 32) + lane;
  if (half) {
    ring_release(ring, st);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[(0 + j) * 32] = lo[0][j];
      red[(4 + j) * 32] = lo[1][j];
      red[(8 + j) * 32] = hi[0][j];
      red[(12 + j) * 32] = hi[1][j];
    }
  }
  csync();
  if (half) return;
  const float* slo = reinterpret_cast<const float*>(tile + TILE_BYTES) + col;
  const float* shi = reinterpret_cast<const float*>(tile + TILE_BYTES + 512) + col;
  const float4 wlo = *reinterpret_cast<const float4*>(slo);
  const float4 whi = *reinterpret_cast<const float4*>(shi);
  ring_release(ring, st);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[0][j] += red[(0 + j) * 32];
    lo[1][j] += red[(4 + j) * 32];
    hi[0][j] += red[(8 + j) * 32];
    hi[1][j] += red[(12 + j) * 32];
  }
  // lo[T] = (column col + 2T, row 2t), (col + 2T, 2t + 1), (col + 2T + 1, 2t),
  // (col + 2T + 1, 2t + 1)
  const float sl[4] = {wlo.x, wlo.y, wlo.z, wlo.w}, sh[4] = {whi.x, whi.y, whi.z, whi.w};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 2 * t + e;
    if (r >= m) continue;
    const float sxlo = s.xsc[r], sxhi = s.xsc[MAX_ROWS + r];
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int T = c >> 1, idx = (c & 1) * 2 + e;
      v[c] = w4a8_term_x16(lo[T][idx], sxlo, sl[c], hi[T][idx], sxhi, sh[c]);
    }
    *reinterpret_cast<float4*>(dst + r * ld + col) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The codes and scales of one W4A8 group for rows < m: the low block
// (values [256 g, 256 g + 256) of each row of x) and the high block (K/2 on),
// from bf16 rows (row stride ldx, kp = K / 2), one warp a (row, block),
// w4a8.cuh's warp_quantize_codes.  Every consumer thread calls it.
__device__ void quantize_group(const Shared& s, const bf16* x, long long ldx, int kp, int g,
                               int m) {
  const int lane = threadIdx.x & 31;
  csync();  // every warp is done with the codes before
  for (int task = threadIdx.x >> 5; task < 2 * m; task += CWARPS) {
    const int row = task >> 1, hi = task & 1;
    uint32_t packed[2];
    const float scale =
        warp_quantize_codes<false>(x + row * ldx + hi * kp + g * W4_GROUP, packed);
    *reinterpret_cast<uint2*>(s.codes + (hi * MAX_ROWS + row) * CPITCH + 8 * lane) =
        make_uint2(packed[0], packed[1]);
    if (lane == 0) s.xsc[hi * MAX_ROWS + row] = scale;
  }
  csync();
}

// w4a8.cuh's activation quantisation of one 256-value block, lane l holding
// values 8 l .. 8 l + 7 (already rounded to bf16): the codes packed lowest
// byte first, and the block's scale
__device__ __forceinline__ float warp_codes8(const float (&v)[8], uint2& packed) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = static_cast<int>(rintf(__fdiv_rn(v[i], scale)));
    w[i / 4] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * (i % 4));
  }
  packed = make_uint2(w[0], w[1]);
  return scale;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// u = bf16((y - mean) rstd g + b), each step rounded once (K6's order)
__device__ __forceinline__ bf16 ln_value(float y, float mean, float rstd, float g, float b) {
  const float un = __fmul_rn(__fsub_rn(y, mean), rstd);
  return __float2bfloat16_rn(__fadd_rn(__fmul_rn(un, g), b));
}

// ---------------------------------------------------------------------------
// the consumers' phases
// ---------------------------------------------------------------------------

// 1: the dual's items (arrivals on the dual's tile counters follow)
__device__ void phase_dual(const Params& p, const Plan& q, Ring& ring, const Shared& s,
                           int& parity) {
  const int d = p.d, m = p.m;
  const Range r = block_range((q.no + q.nf) * q.T);
  int cur = -1;
  for (int i = r.lo; i < r.hi; ++i) {
    const int g = i / q.T, t = i % q.T;
    if (g != cur) {
      if (g < q.no) quantize_group(s, p.ctx, d, d / 2, g, m);
      else quantize_group(s, p.mh, p.f, p.f / 2, g - q.no, m);
      cur = g;
    }
    w4a8_tile(ring, s, parity, p.terms + (long long)g * m * d + t * TILE_COLS, d, m);
    parity ^= 1;
  }
}

// 1's sums of the owned (tile, row) units: W_o's groups and W_fc_out's,
// each in order from 0 (the plain version's order), then a and m, or y
// without adapters
template <bool STAMP>
__device__ void dual_sums(const Params& p, const Plan& q) {
  const int d = p.d, m = p.m;
  const long long stride = (long long)m * d;
  SumStamps<STAMP> st{p.stamps, N_PHASES, P_DUAL_SUMS, false};
  const unsigned* cnt = p.counters + q.c_dual;
  owned_pairs(q.T * m, q.no + q.nf, [cnt, m](int u) { return cnt + u / m; }, st,
              [&](int u, int j) {
    const int row = u % m, col = (u / m) * TILE_COLS + j;
    const float* base = p.terms + (long long)row * d + col;
    const float ao = sum_chunks<16>(base, stride, q.no);
    const float af = sum_chunks<32>(base + q.no * stride, stride, q.nf);
    const long long i = (long long)row * d + col;
    bf16 a = __float2bfloat16_rn(ao);
    if (p.o_bias) a = bf16_add(a, __float2bfloat16_rn(p.o_bias[col]));
    const bf16 mv = bf16_add(__float2bfloat16_rn(af), __float2bfloat16_rn(p.b_fc_out[col]));
    if (q.adapters) {
      p.ab[i] = a;
      p.mb[i] = mv;
    } else {
      p.y[i] = bf16_add(bf16_add(p.x[i], a), mv);
    }
  });
}

// 2's sums of the owned (adapter tile, row) units (the tiles of both
// adapters in turn): h = bf16(relu(sum of the down chunks in order * sd + bd))
template <bool STAMP>
__device__ void down_sums(const Params& p, const Plan& q, const AdapterProduct& P) {
  const int m = p.m;
  SumStamps<STAMP> st{p.stamps, N_PHASES, P_DOWN_SUMS, false};
  const unsigned* cnt = p.counters + q.c_dn;
  owned_pairs((q.tdn[0] + q.tdn[1]) * m, q.C, [cnt, m](int u) { return cnt + u / m; }, st,
              [&](int u, int j) {
    const int tt = u / m, row = u % m;
    const int k = tt < q.tdn[0] ? 0 : 1, tile = k == 0 ? tt : tt - q.tdn[0];
    const int dh = p.dh[k], col = tile * TILE_COLS + j;
    const float z = sum_chunks(P.terms[k] + (long long)row * dh + col, (long long)m * dh, q.C);
    p.h[k][(long long)row * dh + col] =
        __float2bfloat16_rn(fmaxf(z * p.sd[k][col] + p.bd[k][col], 0.f));
  });
}

// 3: the up slices.  A block adds each adapter's K of its 32 columns
// itself (slice_product, slice_reduce: the quarters in order), then
// a += bf16(z_attn), m += bf16(z_mlp), y = x + a + m
__device__ void phase_up(const Params& p, const Plan& q, Ring& ring, const Shared& s) {
  const int d = p.d, m = p.m, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 16 * ((threadIdx.x >> 5) & 1) + 2 * g;
  const Range r = block_range(q.slices);
  for (int sl = r.lo; sl < r.hi; ++sl) {
    float z[2][1][4] = {};
    bool mine = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int dh = p.dh[k];
      if (dh == 0) continue;
      for (int st = 0; st < slice_stages(dh); ++st) {
        int stg;
        const uint8_t* tile = ring_wait(ring, stg);
        csync();  // every warp is done with the rows before
        const int k0 = st * SLICE_ROWS;
        load_rows<SLICE_ROWS, HPITCH>(s.xs, p.h[k], dh, m, 8, k0, min(SLICE_ROWS, dh - k0));
        csync();
        slice_product<1>(tile, s.xs, z[k]);
        ring_release(ring, stg);
      }
      mine = slice_reduce<1>(z[k], reinterpret_cast<float*>(s.red));
    }
    if (!mine) continue;
    const int c = sl * SLICE_COLS + col;
    for (int e = 0; e < 2; ++e) {
      const int row = 2 * t + e;
      if (row >= m) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns c and c + 1
        const long long i = (long long)row * d + c + h;
        bf16 v[2] = {__ldcg(p.ab + i), __ldcg(p.mb + i)};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          if (p.dh[k]) {
            const float zk = z[k][0][2 * h + e] * p.su[k][c + h] + p.bu[k][c + h];
            v[k] = bf16_add(v[k], __float2bfloat16_rn(zk));
          }
        }
        p.y[i] = bf16_add(bf16_add(p.x[i], v[0]), v[1]);
      }
    }
  }
}

// 4a: the rows' LN statistics, a warp a row (two passes over y, through
// L2), into s.stats; then the block's share of u
__device__ void phase_ln(const Params& p, const Shared& s) {
  const int d = p.d, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (w < p.m) {
    const bf16* yr = p.y + (long long)w * d;
    float sum = 0.f;
    for (int c = 8 * lane; c < d; c += 256) {
      float v[8];
      unpack8(__ldcg(reinterpret_cast<const uint4*>(yr + c)), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, v[e]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = __fdiv_rn(sum, (float)d);
    float sq = 0.f;
    for (int c = 8 * lane; c < d; c += 256) {
      float v[8];
      unpack8(__ldcg(reinterpret_cast<const uint4*>(yr + c)), v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dv = __fsub_rn(v[e], mean);
        sq = __fadd_rn(sq, __fmul_rn(dv, dv));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float var = __fdiv_rn(sq, (float)d);
    if (lane == 0) {
      s.stats[2 * w] = mean;
      s.stats[2 * w + 1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    }
  }
  csync();
  const Range r = block_range(p.m * d);
  for (int i = r.lo + threadIdx.x; i < r.hi; i += CONSUMERS) {
    const int row = i / d, c = i % d;
    p.u[i] = ln_value(__bfloat162float(__ldcg(p.y + i)), s.stats[2 * row], s.stats[2 * row + 1],
                      p.ln_g[c], p.ln_b[c]);
  }
}

// the codes of the in_proj's group g: u's low and high blocks of each row,
// made from y and the statistics (the same bf16 u the block writes)
__device__ void quantize_u_group(const Params& p, const Shared& s, int g) {
  const int d = p.d, lane = threadIdx.x & 31;
  csync();
  for (int task = threadIdx.x >> 5; task < 2 * p.m; task += CWARPS) {
    const int row = task >> 1, hi = task & 1;
    const int c = hi * (d / 2) + g * W4_GROUP + 8 * lane;
    float y[8], v[8];
    unpack8(__ldcg(reinterpret_cast<const uint4*>(p.y + (long long)row * d + c)), y);
    const float4 g0 = __ldg(reinterpret_cast<const float4*>(p.ln_g + c));
    const float4 g1 = __ldg(reinterpret_cast<const float4*>(p.ln_g + c + 4));
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.ln_b + c));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.ln_b + c + 4));
    const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const float mean = s.stats[2 * row], rstd = s.stats[2 * row + 1];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(ln_value(y[e], mean, rstd, gg[e], bb[e]));
    uint2 packed;
    const float scale = warp_codes8(v, packed);
    *reinterpret_cast<uint2*>(s.codes + (hi * MAX_ROWS + row) * CPITCH + 8 * lane) = packed;
    if (lane == 0) s.xsc[hi * MAX_ROWS + row] = scale;
  }
  csync();
}

// 4b: the in_proj's items on u's codes (arrivals on the in_proj's tile
// counters follow)
__device__ void phase_in_items(const Params& p, const Plan& q, Ring& ring, const Shared& s,
                               int& parity) {
  const int m = p.m, ni = p.ni;
  const Range r = block_range(q.gi * q.ti);
  int cur = -1;
  for (int i = r.lo; i < r.hi; ++i) {
    const int g = i / q.ti, t = i % q.ti;
    if (g != cur) {
      quantize_u_group(p, s, g);
      cur = g;
    }
    w4a8_tile(ring, s, parity, p.terms + (long long)g * m * ni + t * TILE_COLS, ni, m);
    parity ^= 1;
  }
}

// 4b's sums of the owned tiles: fused = bf16(sum of the groups in order),
// a thread's column of every row at once (each row's first 8 groups' terms
// in flight together)
template <bool STAMP>
__device__ void in_sums(const Params& p, const Plan& q) {
  const int m = p.m;
  const long long ni = p.ni, stride = (long long)m * ni;
  SumStamps<STAMP> st{p.stamps, N_PHASES, P_IN_SUMS, false};
  const unsigned* cnt = p.counters + q.c_in;
  owned_pairs(q.ti, q.gi, [cnt](int u) { return cnt + u; }, st, [&](int tile, int j) {
    const long long col = tile * TILE_COLS + j;
    float acc[MAX_ROWS];
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) acc[r] = 0.f;
    for (int g0 = 0; g0 < q.gi; g0 += 8) {
      float v[MAX_ROWS][8];
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          v[r][g] = r < m && g0 + g < q.gi ? __ldcg(p.terms + (g0 + g) * stride + r * ni + col)
                                           : 0.f;
        }
#pragma unroll
      for (int r = 0; r < MAX_ROWS; ++r)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          if (g0 + g < q.gi) acc[r] = __fadd_rn(acc[r], v[r][g]);
        }
    }
#pragma unroll
    for (int r = 0; r < MAX_ROWS; ++r) {
      if (r < m) p.fused[r * ni + col] = __float2bfloat16_rn(acc[r]);
    }
  });
}

template <bool STAMP>
__global__ void __launch_bounds__(THREADS, 1)
    boundary_stream_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BARS);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CWARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  const Plan q = make_plan(p.d, p.f, p.ni, p.dh);
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      Producer emit{smem, full, empty, p.maps, 0u, evict_first_policy()};
      for (int i = 0; i < N_MAPS; ++i) {  // the maps the launch encoded
        const bool used = i <= M_SD || (i <= M_SI ? p.ni > 0 : p.dh[(i - M_WD0) & 1] > 0);
        if (used) prefetch_map(&p.maps[i]);
      }
      produce(p, q, emit);
    }
    return;
  }
  stamp<STAMP>(p.stamps, N_PHASES, P_DUAL, 0);
  if (blockIdx.x == 0) open_counters(p.counters, q.n_counters, p.flag, p.nonce);
  Ring ring{smem, full, empty, 0u};
  Shared s;
  s.xs = reinterpret_cast<bf16*>(smem + OFF_XS);
  s.codes = reinterpret_cast<int8_t*>(smem + OFF_CODES);
  s.xsc = reinterpret_cast<float*>(smem + OFF_XSC);
  s.red = reinterpret_cast<int*>(smem + OFF_RED);
  s.stats = reinterpret_cast<float*>(smem + OFF_STATS);
  // rows m..7 of the codes stay 0 (their products are never stored)
  for (int i = threadIdx.x; i < 2 * MAX_ROWS * CPITCH / 16; i += CONSUMERS) {
    reinterpret_cast<uint4*>(s.codes)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned epoch = 0;
  int parity = 0;

  phase_dual(p, q, ring, s, parity);
  stamp<STAMP>(p.stamps, N_PHASES, P_DUAL, 1);
  open_wait(p.flag, p.nonce);
  {
    unsigned* cnt = p.counters + q.c_dual;
    const int T = q.T;
    arrive_items(block_range((q.no + q.nf) * q.T), [cnt, T](int i) { return cnt + i % T; });
  }
  dual_sums<STAMP>(p, q);
  grid_barrier(p.counters, epoch);
  if (q.adapters) {
    const AdapterProduct dn = down_product(p, q);
    const Range r_dn = block_range(dn.items());
    stamp<STAMP>(p.stamps, N_PHASES, P_DOWN, 0);
    adapter_items<1>(dn, p.m, r_dn, ring, s.xs);
    stamp<STAMP>(p.stamps, N_PHASES, P_DOWN, 1);
    adapter_arrive(dn, r_dn);
    down_sums<STAMP>(p, q, dn);
    grid_barrier(p.counters, epoch);
    stamp<STAMP>(p.stamps, N_PHASES, P_UP, 0);
    phase_up(p, q, ring, s);
    stamp<STAMP>(p.stamps, N_PHASES, P_UP, 1);
    grid_barrier(p.counters, epoch);
  }
  stamp<STAMP>(p.stamps, N_PHASES, P_LN, 0);
  phase_ln(p, s);
  stamp<STAMP>(p.stamps, N_PHASES, P_LN, 1);
  if (p.ni == 0) return;  // the last layer: no in_proj
  stamp<STAMP>(p.stamps, N_PHASES, P_IN, 0);
  phase_in_items(p, q, ring, s, parity);
  stamp<STAMP>(p.stamps, N_PHASES, P_IN, 1);
  {
    unsigned* cnt = p.counters + q.c_in;
    const int ti = q.ti;
    arrive_items(block_range(q.gi * q.ti), [cnt, ti](int i) { return cnt + i % ti; });
  }
  in_sums<STAMP>(p, q);
}

const void* const KERNELS[] = {reinterpret_cast<const void*>(boundary_stream_kernel<false>),
                               reinterpret_cast<const void*>(boundary_stream_kernel<true>)};

// the scratch's layout at (m, d, f, ni, dh): the nonce and the counters,
// the terms (the largest phase's), a and m, h of each adapter; byte offsets
// (ops/quant.py `boundary_plan` mirrors it)
struct Layout {
  long long terms, ab, mb, h[2], bytes;
};

inline long long round256(long long b) { return (b + 255) / 256 * 256; }

Layout layout(int m, int d, int f, int ni, const int* dh) {
  const Plan q = make_plan(d, f, ni, dh);
  long long terms = (long long)(q.no + q.nf) * m * d;
  const long long dn = (long long)q.C * m * (dh[0] + dh[1]);
  const long long in = (long long)q.gi * m * ni;
  terms = terms > dn ? terms : dn;
  terms = terms > in ? terms : in;
  Layout L;
  L.terms = round256(8 + 4ll * q.n_counters);
  L.ab = L.terms + round256(4 * terms);
  const long long act = q.adapters ? round256(2ll * m * d) : 0;
  L.mb = L.ab + act;
  L.h[0] = L.mb + act;
  L.h[1] = L.h[0] + round256(2ll * m * dh[0]);
  L.bytes = L.h[1] + round256(2ll * m * dh[1]);
  return L;
}

}  // namespace

// C entry for ctypes.  Rows (ctx, mh, x, u_in) are bf16, contiguous,
// 16-byte aligned; d and f multiples of 512, ni and each adapter's dh
// multiples of 128 (dh 0: no such adapter; ni 0: the last layer, no
// in_proj).  The stacks, all contiguous: q4d (l_dual, (d + f)/2, d)
// packed and s4d (l_dual, (d + f)/256, d) of the dual, q4i (l_in, d/2, ni)
// and s4i (l_in, d/256, ni) of the in_proj (its layer + 1 runs), each
// adapter's wd (l_a or l_m, d, dh) and wu (.., dh, d); the vectors
// (b_fc_out, ln_g, ln_b, o_bias, each adapter's sd, bd, su, bu) are the
// layer's rows.  src flags: 1 the
// attention adapter reads u_in, 2 the mlp adapter does.  scratch:
// scratch_bytes, 256-byte aligned, at least the layout's; stamps null, or
// (grid, 8, 2) int64 for the stamped build.  Returns a cudaError_t.
extern "C" int magma_boundary(int m, int d, int f, int ni, int dh_a, int dh_m, int src,
                              int layer, int l_dual, int l_in, int l_a, int l_m, float ln_eps,
                              const void* ctx,
                              const void* mh, const void* x, const void* u_in, const void* q4d,
                              const void* s4d, const float* b_fc_out, const float* ln_g,
                              const float* ln_b, const float* o_bias, const void* a_wd,
                              const float* a_sd, const float* a_bd, const void* a_wu,
                              const float* a_su, const float* a_bu, const void* m_wd,
                              const float* m_sd, const float* m_bd, const void* m_wu,
                              const float* m_su, const float* m_bu, const void* q4i,
                              const void* s4i, void* y, void* u, void* fused, void* scratch,
                              long long scratch_bytes, void* stamps, void* stream) {
  const int dh[2] = {dh_a, dh_m};
  if (m < 1 || m > MAX_ROWS || d <= 0 || f <= 0 || d % (2 * W4_GROUP) || f % (2 * W4_GROUP) ||
      ni < 0 || ni % TILE_COLS || dh_a < 0 || dh_a % TILE_COLS || dh_m < 0 ||
      dh_m % TILE_COLS || layer < 0 || layer >= l_dual || (ni && layer + 1 >= l_in) ||
      (dh_a && layer >= l_a) || (dh_m && layer >= l_m) ||
      ((((src & 1) && dh_a) || ((src & 2) && dh_m)) && !u_in) ||
      reinterpret_cast<uintptr_t>(scratch) % 256 ||
      scratch_bytes < layout(m, d, f, ni, dh).bytes) {
    return (int)cudaErrorInvalidValue;
  }
  static int cache[MAX_DEVICES] = {};
  static std::mutex mu;
  int grid = 0;
  cudaError_t err = resident_grid(KERNELS, 2, SMEM_BYTES, cache, mu, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p;
  memset(&p, 0, sizeof(p));
  bool ok = weight_map(&p.maps[M_QD], q4d, l_dual, (d + f) / 2, d) &&
            scale_map(&p.maps[M_SD], s4d, l_dual, (d + f) / W4_GROUP, d);
  if (ni) {
    ok = ok && weight_map(&p.maps[M_QI], q4i, l_in, d / 2, ni) &&
         scale_map(&p.maps[M_SI], s4i, l_in, d / W4_GROUP, ni);
  }
  const int l_ad[2] = {l_a, l_m};
  const void* wd[2] = {a_wd, m_wd};
  const void* wu[2] = {a_wu, m_wu};
  const float* vd[2][2] = {{a_sd, a_bd}, {m_sd, m_bd}};
  const float* vu[2][2] = {{a_su, a_bu}, {m_su, m_bu}};
  for (int k = 0; k < 2; ++k) {
    if (dh[k] == 0) continue;
    ok = ok && weight_map(&p.maps[M_WD0 + k], wd[k], l_ad[k], d, dh[k]) &&
         slice_map(&p.maps[M_WU0 + k], wu[k], l_ad[k], dh[k], d);
    p.dh[k] = dh[k];
    p.src_in[k] = (src >> k) & 1;
    p.sd[k] = vd[k][0];
    p.bd[k] = vd[k][1];
    p.su[k] = vu[k][0];
    p.bu[k] = vu[k][1];
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  const Layout L = layout(m, d, f, ni, dh);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  p.flag = reinterpret_cast<unsigned long long*>(s);
  p.counters = reinterpret_cast<unsigned*>(s + 8);
  p.terms = reinterpret_cast<float*>(s + L.terms);
  p.ab = reinterpret_cast<bf16*>(s + L.ab);
  p.mb = reinterpret_cast<bf16*>(s + L.mb);
  p.h[0] = reinterpret_cast<bf16*>(s + L.h[0]);
  p.h[1] = reinterpret_cast<bf16*>(s + L.h[1]);
  p.m = m;
  p.d = d;
  p.f = f;
  p.ni = ni;
  p.layer = layer;
  p.eps = ln_eps;
  p.ctx = static_cast<const bf16*>(ctx);
  p.mh = static_cast<const bf16*>(mh);
  p.x = static_cast<const bf16*>(x);
  p.u_in = static_cast<const bf16*>(u_in);
  p.b_fc_out = b_fc_out;
  p.ln_g = ln_g;
  p.ln_b = ln_b;
  p.o_bias = o_bias;
  p.y = static_cast<bf16*>(y);
  p.u = static_cast<bf16*>(u);
  p.fused = static_cast<bf16*>(fused);
  p.nonce = next_nonce();
  p.stamps = static_cast<unsigned long long*>(stamps);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(KERNELS[stamps ? 1 : 0], dim3(grid), dim3(THREADS), args,
                                    SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid K6 launches on the current device, in *blocks (for the stamps'
// buffer).  Returns a cudaError_t.
extern "C" int magma_boundary_grid(int* blocks) {
  static int cache[MAX_DEVICES] = {};
  static std::mutex mu;
  return (int)resident_grid(KERNELS, 2, SMEM_BYTES, cache, mu, blocks);
}
