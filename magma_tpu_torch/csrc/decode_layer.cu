// Whole decode layers of one token (b = 1) in one launch, for Hopper
// (sm_90a): K7 runs one layer, K8 all of them.  Per layer l, from the
// layer's in_proj output fused = [q | k | v | m_pre] (bf16):
//   q, k = rotary(q, k) in fp32 from the sin/cos tables; q *= scale
//   ctx  = bf16(softmax over the cache positions < pos and the token
//          itself, of q . k, times V), the cache bf16 or int8 with one bf16
//          scale per (position, head): the scores times k_scale, the
//          weights times v_scale after their sum
//   mh   = bf16(gelu_tanh(m_pre + b_fc_in))
//   a    = bf16(ctx @ W_o) [+ bf16(o_bias)] [+ bf16(adapter_attn(a or u_in))]
//   m    = bf16(mh @ W_fc_out) + bf16(b_fc_out) [+ bf16(adapter_mlp(m or u_in))]
//   y    = x + a + m                       (bf16 adds, in that order)
//   u    = bf16(LN(y) * ln_g + ln_b)       (fp32 statistics)
//   fused of the next layer = bf16(u @ W_in[l + 1]), unless the last layer
// with K6's arithmetic (boundary.cu): W4A8 for the int4 stacks (the
// terms of each 512-row group summed in order, w4a8.cuh), W8A16 for the
// int8 ones, the fused int8 adapters of K5.  k_new = bf16(rotated k) and
// v_new = v go out as rows for the caller's bulk cache write.  K8 chains
// fused, y and u from layer to layer in scratch from the wrapper.
//
// Replaces: magma_tpu/ops/decode_layer.py `_declayer_kernel` (:89, called
// by `decode_layer_fused`, K7) and `_alllayer_kernel` (:830, called by
// `decode_all_layers_fused`, K8, which gptj._run_decode_fused_layers
// launches once per b = 1 quantized decode step).  The Pallas kernels walk
// a sequential grid (layer, step) whose pipeline fetches the next step's
// weight block while the current one computes.
//
// What bounds them on an H100 SXM: the bytes they stream, at 3.35 TB/s.
// GPT-J 6B, v1 adapter, pos = 180, per layer: the int4 in_proj (60.6 MB with
// its scales), the int4 dual (42.6 MB), the adapter (8.4 MB) and the cache
// rows below pos (2.9 MB bf16, half that int8), about 115 MB -> 34 us for a
// middle layer of K7 and 3.16 GB -> 0.94 ms for K8's 28 layers (int8
// weights about 213 MB and 5.84 GB).  Operations are nothing.
//
// What the design does about it: the weight stream does not stop at the
// phase barriers.  One cooperative launch of one block per SM (the ring
// below fills its shared memory); a block is a producer warp and eight
// consumer warps.  Every weight the launch reads is cut into tiles of 256
// rows x 128 columns of an int8 stack (int4: 256 packed rows, one W4A8
// group, with its two scale rows; int8: 256 rows), the cache into chunks of
// 16 positions of one head.  Which block takes which (phase, item) follows
// from the grid size and pos alone (items i = b, b + G, ... of each phase,
// rotated by the items of the phases before), so the producer walks the
// block's items of every phase of every layer ahead of the consumers and
// keeps one TMA load a tile in flight through a STAGES-deep ring of shared
// memory (mbarrier completion).  It never waits for the activations: while
// the consumers wait at a grid barrier, it loads the next phase's and the
// next layer's tiles.  The consumers, per layer:
//   1 attention + mh.  Items (head, chunk) from the ring: the chunk's
//     partial softmax to scratch.  The block that owns a head folds its
//     chunks in order from the token itself once they are in: ctx, k_new,
//     v_new and, int4, the head's int8 codes and scale (a head is one
//     256-value W4A8 block).  Warps also compute mh in 256-value blocks,
//     with their codes.
//   2 dual.  Each block copies every code of ctx and mh (their bf16 rows,
//     int8) into shared memory once: an activation is quantized once a
//     layer, not once per warp item.  Items (K chunk, 128-column tile): a
//     chunk's term goes to scratch; the block that owns a tile adds its
//     chunks in order, then the biases: a and m, or y without adapters.
//   3 adapter down: the same over the adapters' int8 payloads, K split in
//     256-row chunks over the grid; the terms stay in scratch.
//   4 adapter up: every block sums the down terms into h itself (1024
//     values an adapter), then the up items; a tile's owner adds them and
//     the residual: y.
//   5 LN and the next in_proj.  Every block makes the LN of y (K6's order
//     of sums) and u's codes itself, so no barrier between the two; the
//     in_proj's tiles are owned and summed as the dual's: fused.
// An owned tile is summed once the items that feed it have arrived: a
// block, after its items of a phase, releases one arrival an item on the
// item's tile counter (red.release, issued together); the tile's owner, a
// block with one item fewer, acquires the count, then reads the terms.  A
// grid barrier (an arrival counter, release/acquire, consumers only) closes
// phases 1, 2, 3, 4 and, but on the last layer, 5: 5 a layer with an
// adapter, 3 without.  Every sum has a fixed order (a tile's rows in order
// within a warp, the warps in order, the chunks in order; the W4A8 dots in
// int32) and no float atomics, so a launch repeats its bits and K7 is K8's
// body over [l, l + 1).  The W4A8 terms are w4a8.cuh's and their sums keep
// K6's order (boundary.cu: each group's term, in order from 0), so the int4
// results over a bf16 cache repeat the phase-per-barrier design's this one
// replaced, bit for bit; the W8A16 products sum 256-row chunks, not that
// design's kc-row ones.  Weights and
// the cache are never written in the launch, so their TMA reads (the async
// proxy) need no fence; what the launch writes is read through L2
// (ld.global.cg) after the barrier or the counter that publishes it.
// Tensor maps are 3-D (columns, rows, layer), so a ragged last chunk reads
// zeros, and they are encoded once per stack and memoised.  STAMP builds
// write a %globaltimer stamp at each phase's start and end per block:
// measurement only, never on the main path.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

#include "int8_gemv.cuh"
#include "tma_wgmma.cuh"
#include "w4a8.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using tma_wgmma::align_1024;
using tma_wgmma::fence_barrier_init;
using tma_wgmma::mbar_arrive;
using tma_wgmma::mbar_expect_tx;
using tma_wgmma::mbar_init;
using tma_wgmma::mbar_wait;
using tma_wgmma::smem_addr;

constexpr int HD = 256;          // head_dim: one consumer thread a dimension
constexpr int ATT_CHUNK = 16;    // cache positions of one attention item
constexpr int PART = HD + 2;     // one chunk's partial: ctx[HD], max, sum
constexpr int CWARPS = 8;        // consumer warps
constexpr int CONSUMERS = 32 * CWARPS;
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int TILE_ROWS = 256;
constexpr int TILE_COLS = 128;
constexpr int TILE_BYTES = TILE_ROWS * TILE_COLS;
constexpr int STAGE_BYTES = TILE_BYTES + 1024;  // + the W4A8 scale rows or cache scales
constexpr int STAGES = 5;
constexpr int XBUF_BYTES = 40960;  // a phase's activations (codes or bf16 rows)
constexpr int XSCALES = 256;       // their W4A8 block scales
constexpr int MAX_LAYERS = 4096;
static_assert(HD == CONSUMERS, "one consumer thread per head dimension");
static_assert(TILE_ROWS == W4_GROUP, "a W4A8 tile is one group");
static_assert(ATT_CHUNK == 2 * CWARPS, "two positions a consumer warp");
static_assert(TILE_COLS == 4 * 32, "four columns a lane");

// shared memory, after the 1024-byte alignment of the dynamic base
constexpr int OFF_XBUF = STAGES * STAGE_BYTES;
constexpr int OFF_XS = OFF_XBUF + XBUF_BYTES;
constexpr int OFF_RED = OFF_XS + XSCALES * 4;                 // [lo/hi][warp][col] int or float
constexpr int OFF_QS = OFF_RED + 2 * CWARPS * TILE_COLS * 4;  // HD floats
constexpr int OFF_XCH = OFF_QS + HD * 4;                      // TILE_COLS floats
constexpr int OFF_SC = OFF_XCH + TILE_COLS * 4;               // ATT_CHUNK floats
constexpr int OFF_SUMRED = OFF_SC + ATT_CHUNK * 4;            // CWARPS floats
constexpr int OFF_BARS = OFF_SUMRED + CWARPS * 4;             // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BARS + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "the ring must fit in shared memory");
static_assert(OFF_BARS % 8 == 0 && OFF_RED % 16 == 0 && STAGE_BYTES % 1024 == 0, "alignment");

// the launch's tensor maps
enum Map { M_QD, M_SD4, M_QI, M_SI4, M_WD0, M_WD1, M_WU0, M_WU1, M_KC, M_VC, M_KS, M_VS, N_MAPS };

struct Adapt {
  const float *sd, *bd, *su, *bu;  // (L, 1, dh), (L, 1, dh), (L, 1, d), (L, 1, d)
  bf16* h;                         // (dh,) scratch
  int dh;                          // 0: no adapter
  int src_in;                      // 1: fed from u_in, 0: from its branch's output
};

struct Params {
  // (columns, rows, layer) int8 stacks in 256 x 128 boxes; (columns, rows,
  // layer) fp32 scales in 128 x 1 boxes (int4); the caches (head_dim, heads,
  // layer x position) in HD x 1 x 16 boxes and their scales (position,
  // layer x head) in 16 x 1 boxes (int8 caches)
  CUtensorMap maps[N_MAPS];  // indexed by Map
  int l0, l1, in_until, h, d, f, ni, max_len, rd, dhmax, n_counters;
  float scale, eps;
  const int* pos;                      // valid cache positions, on the device
  const float *sin, *cos;              // (rd/2,)
  const bf16 *fused_in, *x_in, *u_in;  // layer l0's fused (3d + f), x (d), u (d) or null
  const float* b_fc_in;                          // (L, f)
  const float *b_fc_out, *ln_g, *ln_b, *o_bias;  // (L, d); o_bias may be null
  const float *sd8, *si8;              // int8: (L, 2, d) and (L, ni) channel scales
  Adapt ad[2];                         // 0: attention, 1: mlp
  bf16 *y, *u, *fused;                 // fused: K7's output, K8's chain
  bf16 *k_new, *v_new;                 // (l1 - l0, d)
  bf16 *ctx, *mh, *ab, *mb;            // (d), (f), (d), (d)
  float* part;                         // (h, max_len / ATT_CHUNK, PART)
  float *terms, *terms_b;              // chunk terms: the dual's and adapter up's in
                                       // one region, adapter down's and the in_proj's in
                                       // the other, so no phase writes what another reads
  bf16* y2;                            // y of every other layer
  int8_t* codes;                       // int4: ctx's and mh's codes (d + f)
  float* xsc;                          // and their block scales ((d + f) / 256)
  unsigned* counters;                  // n_counters arrival counters, then the barrier's
  unsigned long long* stamps;          // STAMP: (grid, l1 - l0, 5, 2)
};

// the item counts of a launch: the same in every block and role
struct Plan {
  int G, nck, nci;   // grid; attention chunks below pos, items a head (>= 1)
  int cho, chf, td;  // dual: W_o's and W_fc_out's K chunks; d's column tiles
  int cdn, tdn[2];   // adapter down: d's chunks; each adapter's column tiles
  int cup[2];        // adapter up: each adapter's chunks of dh
  int cupmax;
  int cin, ti;       // in_proj: chunks, column tiles
  int head0;         // the attention's counters: head0 + head, after the tiles'
  bool adapters;
};

template <bool INT4>
__device__ Plan make_plan(const Params& p, int pos) {
  Plan q;
  q.G = gridDim.x;
  q.nck = (pos + ATT_CHUNK - 1) / ATT_CHUNK;
  q.nci = max(q.nck, 1);
  const int rows_per_chunk = INT4 ? 2 * TILE_ROWS : TILE_ROWS;  // activation values a chunk
  q.cho = p.d / rows_per_chunk;
  q.chf = p.f / rows_per_chunk;
  q.td = p.d / TILE_COLS;
  q.cdn = p.d / TILE_ROWS;
  q.cupmax = 0;
  for (int k = 0; k < 2; ++k) {
    q.tdn[k] = p.ad[k].dh / TILE_COLS;
    q.cup[k] = (p.ad[k].dh + TILE_ROWS - 1) / TILE_ROWS;
    q.cupmax = max(q.cupmax, q.cup[k]);
  }
  q.adapters = p.ad[0].dh > 0 || p.ad[1].dh > 0;
  q.cin = p.d / rows_per_chunk;
  q.ti = p.ni / TILE_COLS;
  q.head0 = max(q.td, q.ti);
  return q;
}

// this block's items of a phase of n items whose first goes `off` blocks
// on: i = begin, begin + stride, ... < end
struct Items {
  int begin, end, stride;
};

__device__ __forceinline__ Items my_items(int off, int n, int G) {
  int r = ((int)blockIdx.x - off) % G;
  if (r < 0) r += G;
  return Items{r, n, G};
}

__device__ __forceinline__ int advance(int off, int n, int G) { return (off + n % G) % G; }

// rows of the scale stack holding chunk c's low and high nibbles' scales
// (W4A8): W_o's groups, then W_fc_out's, each low then high
__device__ __forceinline__ int2 dual_scale_rows(const Plan& q, int c) {
  if (c < q.cho) return make_int2(c, q.cho + c);
  const int g = c - q.cho;
  return make_int2(2 * q.cho + g, 2 * q.cho + q.chf + g);
}

// ---------------------------------------------------------------------------
// TMA, barriers, stamps
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the consumer warps of the block (named barrier 1; the producer never joins)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every consumer thread of every block: what the grid wrote before it is
// visible after it.  One counter that only grows within a launch; the
// `epoch`-th barrier waits for epoch x grid arrivals.  A barrier stalled
// for about ten seconds traps instead of holding the card.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& epoch) {
  ++epoch;
  csync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = epoch * gridDim.x;
    long long start = 0;
    while (ld_acquire(bar) < target) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1ll << 34)) {
        asm volatile("trap;");
      }
    }
    __threadfence();
  }
  csync();
}

// Once the block's items of a phase have written their terms: one arrival
// for each item on its tile's counter (tile_of(i)), released to the grid,
// all issued together by the first consumer warp.  Waits for nothing.
template <typename TileOf>
__device__ __forceinline__ void arrive_items(unsigned* cnt, Items items, TileOf tile_of) {
  csync();  // the items' writes come first
  if (threadIdx.x >= 32) return;
  for (int i = items.begin + items.stride * (int)threadIdx.x; i < items.end;
       i += 32 * items.stride) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(cnt + tile_of(i)) : "memory");
  }
}

// The tiles (or heads) of a phase whose sums this block makes: tile k goes
// to the block that takes item n % G + k on (a block with one item fewer,
// where there is one), so tiles k = first, first + G, ... < n_tiles.
__device__ __forceinline__ int first_owned(int off, int n, int G) {
  int r = ((int)blockIdx.x - off - n % G) % G;
  return r < 0 ? r + G : r;
}

// Waits until a tile's counter reaches `target` arrivals, resets it for the
// next phase, and makes the arrivals' writes visible to every consumer
// thread of the block (read them through L2).
__device__ __forceinline__ void wait_count(unsigned* cnt, unsigned target) {
  if (threadIdx.x == 0) {
    long long start = 0;
    while (ld_acquire(cnt) < target) {
      if (start == 0) {
        start = clock64();
      } else if (clock64() - start > (1ll << 34)) {
        asm volatile("trap;");
      }
    }
    *cnt = 0u;
    __threadfence();
  }
  csync();
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <bool STAMP>
__device__ __forceinline__ void stamp(const Params& p, int l, int phase, int end) {
  if (STAMP && threadIdx.x == 0) {
    const long long i =
        (((long long)blockIdx.x * (p.l1 - p.l0) + (l - p.l0)) * 5 + phase) * 2 + end;
    p.stamps[i] = globaltimer();
  }
}

// ---------------------------------------------------------------------------
// the ring, from the consumers' side
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t* base;
  uint64_t *full, *empty;
  uint32_t k;  // tiles taken so far
};

__device__ __forceinline__ const uint8_t* ring_wait(Ring& r, int& st) {
  st = r.k % STAGES;
  mbar_wait(&r.full[st], (r.k / STAGES) & 1);
  ++r.k;
  return r.base + st * STAGE_BYTES;
}

// each consumer warp, after its last read of the stage
__device__ __forceinline__ void ring_release(Ring& r, int st) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&r.empty[st]);
}

// ---------------------------------------------------------------------------
// arithmetic shared with the parts of K6 it replaces
// ---------------------------------------------------------------------------

__device__ __forceinline__ bf16 bf16_add(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k_kappa = 0.044715f;
  const float inner = k_beta * (x + k_kappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// element t of one head's q or k, xv, rotated GPT-J style over the first
// rd dims: out[2i] = x[2i] cos - x[2i+1] sin, out[2i+1] = x[2i+1] cos +
// x[2i] sin, each product and sum rounded once.  Called by whole warps
// (thread t's partner t ^ 1 is in its warp).
__device__ __forceinline__ float rotate(float xv, int t, const float* sin, const float* cos,
                                        int rd) {
  const float partner = __shfl_xor_sync(0xffffffffu, xv, 1);
  if (t >= rd) return xv;
  const float s = sin[t >> 1], c = cos[t >> 1];
  if ((t & 1) == 0) return __fsub_rn(__fmul_rn(xv, c), __fmul_rn(partner, s));
  return __fadd_rn(__fmul_rn(xv, c), __fmul_rn(partner, s));
}

// sum over the consumer threads in a fixed order (lanes by shuffles, then
// the warps in order); every consumer thread gets the total
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  csync();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < CWARPS; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  csync();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  csync();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < CWARPS; ++w) m = fmaxf(m, red[w]);
  return m;
}

// w4a8.cuh's activation quantization of one 256-value block by one warp,
// lane l holding values 8 l .. 8 l + 7 (already rounded to bf16): the codes
// packed lowest byte first, and the block's scale
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

__device__ __forceinline__ void unpack_bf16x8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// `bytes` (a multiple of 16) written in the launch -> shared memory, by
// the consumers
__device__ __forceinline__ void copy_cg(void* dst, const void* src, int bytes) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += CONSUMERS) d[i] = __ldcg(s + i);
}

// The in-order fp32 sums of N columns' chunk terms, written by other
// blocks: acc[j] = terms[0][cols[j]] + terms[1][cols[j]] + ... (n terms,
// `stride` apart; columns j >= nc left at 0), B chunks' loads in flight
// ahead of their adds
template <int N, int B = 8>
__device__ __forceinline__ void sum_cols(const float* terms, long long stride, int n,
                                         const int (&cols)[N], int nc, float (&acc)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < n; c0 += B) {
    float v[B][N];
#pragma unroll
    for (int cc = 0; cc < B; ++cc)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        v[cc][j] = c0 + cc < n && j < nc ? __ldcg(terms + (c0 + cc) * stride + cols[j]) : 0.f;
      }
#pragma unroll
    for (int cc = 0; cc < B; ++cc)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (c0 + cc < n) acc[j] = __fadd_rn(acc[j], v[cc][j]);
      }
  }
}

// one column's sum, 32 chunks in flight (a tile owner's, W_fc_out's 32-64)
__device__ __forceinline__ float sum_terms(const float* base, long long stride, int n) {
  const int col[1] = {0};
  float acc[1];
  sum_cols<1, 32>(base, stride, n, col, 1, acc);
  return acc[0];
}

// ---------------------------------------------------------------------------
// one 256 x 128 weight tile against 256 activation values
// ---------------------------------------------------------------------------

// W4A8: the group's int32 dots of the tile's packed rows with the low and
// high codes (clo, chi, 256 each, shared memory), warp w taking rows 32 w ..
// 32 w + 31 and lane l columns 4 l .. 4 l + 3, the dots carrying the factor
// 16 of w4a8.cuh's nibbles_x16; the warps' dots meet in `red` (integers:
// exact in any order).  Returns the group's fp32 term of column t in
// consumer threads t < 128.  Every consumer thread calls it.
__device__ __forceinline__ float w4a8_tile_term(Ring& r, const int8_t* clo, const int8_t* chi,
                                                float sxlo, float sxhi, int* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int st;
  const uint8_t* tile = ring_wait(r, st);
  int plo[4] = {0, 0, 0, 0}, phi[4] = {0, 0, 0, 0};
  const uint8_t* wrow = tile + warp * 32 * TILE_COLS + 4 * lane;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int rr = warp * 32 + 4 * j;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wrow + (4 * j + 0) * TILE_COLS);
    const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wrow + (4 * j + 1) * TILE_COLS);
    const uint32_t w2 = *reinterpret_cast<const uint32_t*>(wrow + (4 * j + 2) * TILE_COLS);
    const uint32_t w3 = *reinterpret_cast<const uint32_t*>(wrow + (4 * j + 3) * TILE_COLS);
    uint32_t col[4];
    transpose4x4(w0, w1, w2, w3, col);
    const int xl = *reinterpret_cast<const int*>(clo + rr);
    const int xh = *reinterpret_cast<const int*>(chi + rr);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t lo, hi;
      nibbles_x16(col[c], lo, hi);
      plo[c] = __dp4a(static_cast<int>(lo), xl, plo[c]);
      phi[c] = __dp4a(static_cast<int>(hi), xh, phi[c]);
    }
  }
  float slo = 0.f, shi = 0.f;
  if (t < TILE_COLS) {
    slo = reinterpret_cast<const float*>(tile + TILE_BYTES)[t];
    shi = reinterpret_cast<const float*>(tile + TILE_BYTES + 512)[t];
  }
  ring_release(r, st);
  *reinterpret_cast<int4*>(red + warp * TILE_COLS + 4 * lane) =
      make_int4(plo[0], plo[1], plo[2], plo[3]);
  *reinterpret_cast<int4*>(red + (CWARPS + warp) * TILE_COLS + 4 * lane) =
      make_int4(phi[0], phi[1], phi[2], phi[3]);
  csync();
  float term = 0.f;
  if (t < TILE_COLS) {
    int a = 0, b = 0;
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) {
      a += red[w * TILE_COLS + t];
      b += red[(CWARPS + w) * TILE_COLS + t];
    }
    term = w4a8_term_x16(a, sxlo, slo, b, sxhi, shi);
  }
  csync();  // red is read before the next tile's dots overwrite it
  return term;
}

// W8A16: column sums of x[0..256) (bf16, shared memory) times the tile, in
// fp32 (each product exact): warp w sums its rows 32 w .. 32 w + 31 in
// order, then the warps are added in order.  Returns column t's sum in
// consumer threads t < 128.  Every consumer thread calls it.
__device__ __forceinline__ float w8a16_tile_sum(Ring& r, const bf16* x, float* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int st;
  const uint8_t* tile = ring_wait(r, st);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const uint8_t* wrow = tile + warp * 32 * TILE_COLS + 4 * lane;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) {
    const uint32_t wv = *reinterpret_cast<const uint32_t*>(wrow + j * TILE_COLS);
    const float xv = __bfloat162float(x[warp * 32 + j]);
    float wf[4];
    s8x4_to_f32(wv, wf);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = fmaf(xv, wf[c], acc[c]);
  }
  ring_release(r, st);
  *reinterpret_cast<float4*>(red + warp * TILE_COLS + 4 * lane) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  csync();
  float sum = 0.f;
  if (t < TILE_COLS) {
#pragma unroll
    for (int w = 0; w < CWARPS; ++w) sum = __fadd_rn(sum, red[w * TILE_COLS + t]);
  }
  csync();  // red is read before the next tile's sums overwrite it
  return sum;
}

// ---------------------------------------------------------------------------
// the producer: every tile of the block's items, in the consumers' order
// ---------------------------------------------------------------------------

// one ring tile: up to four boxes (a map of Map, its coordinates, the byte
// offset in the stage) and the bytes they bring
struct Load {
  int map[4];
  int c[4][3];
  int dst[4];
  int n;
  uint32_t bytes;
  __device__ void add(int m, int c0, int c1, int c2, int at) {
    map[n] = m;
    c[n][0] = c0;
    c[n][1] = c1;
    c[n][2] = c2;
    dst[n++] = at;
  }
};

// The block's tiles of every phase of every layer, in the consumers' order
// (the attention's cache chunks, the dual, the adapters, the next in_proj),
// each handed to emit() as a Load.
template <bool INT4, bool KV8, typename Emit>
__device__ void walk_tiles(const Params& p, const Plan& q, Emit emit) {
  const int G = q.G;
  int off = 0;
  for (int l = p.l0; l < p.l1; ++l) {
    const int n_att = p.h * q.nci;
    if (q.nck > 0) {
      const Items att = my_items(off, n_att, G);
      for (int i = att.begin; i < att.end; i += att.stride) {
        const int hh = i / q.nci, c = i % q.nci;
        const int row = l * p.max_len + c * ATT_CHUNK;
        Load ld{};
        ld.bytes = KV8 ? 2 * ATT_CHUNK * HD + 2 * ATT_CHUNK * 2 : 4 * ATT_CHUNK * HD;
        ld.add(M_KC, 0, hh, row, 0);
        ld.add(M_VC, 0, hh, row, TILE_BYTES / 2);
        if (KV8) {
          ld.add(M_KS, c * ATT_CHUNK, l * p.h + hh, 0, TILE_BYTES);
          ld.add(M_VS, c * ATT_CHUNK, l * p.h + hh, 0, TILE_BYTES + 512);
        }
        emit(ld);
      }
    }
    off = advance(off, n_att, G);
    const int n_dual = (q.cho + q.chf) * q.td;
    const Items dual = my_items(off, n_dual, G);
    for (int i = dual.begin; i < dual.end; i += dual.stride) {
      const int c = i / q.td, t = i % q.td;
      Load ld{};
      ld.bytes = TILE_BYTES + (INT4 ? 1024 : 0);
      ld.add(M_QD, t * TILE_COLS, c * TILE_ROWS, l, 0);
      if (INT4) {
        const int2 sr = dual_scale_rows(q, c);
        ld.add(M_SD4, t * TILE_COLS, sr.x, l, TILE_BYTES);
        ld.add(M_SD4, t * TILE_COLS, sr.y, l, TILE_BYTES + 512);
      }
      emit(ld);
    }
    off = advance(off, n_dual, G);
    if (q.adapters) {
      const int n0 = q.cdn * q.tdn[0], n_dn = n0 + q.cdn * q.tdn[1];
      const Items dn = my_items(off, n_dn, G);
      for (int i = dn.begin; i < dn.end; i += dn.stride) {
        const int a = i < n0 ? 0 : 1, j = i < n0 ? i : i - n0;
        Load ld{};
        ld.bytes = TILE_BYTES;
        ld.add(M_WD0 + a, j % q.tdn[a] * TILE_COLS, j / q.tdn[a] * TILE_ROWS, l, 0);
        emit(ld);
      }
      off = advance(off, n_dn, G);
      const int u0 = q.cup[0] * q.td, n_up = u0 + q.cup[1] * q.td;
      const Items up = my_items(off, n_up, G);
      for (int i = up.begin; i < up.end; i += up.stride) {
        const int a = i < u0 ? 0 : 1, j = i < u0 ? i : i - u0;
        Load ld{};
        ld.bytes = TILE_BYTES;
        ld.add(M_WU0 + a, j % q.td * TILE_COLS, j / q.td * TILE_ROWS, l, 0);
        emit(ld);
      }
      off = advance(off, n_up, G);
    }
    if (l < p.in_until) {
      const int n_in = q.cin * q.ti;
      const Items inp = my_items(off, n_in, G);
      for (int i = inp.begin; i < inp.end; i += inp.stride) {
        const int c = i / q.ti, t = i % q.ti;
        Load ld{};
        ld.bytes = TILE_BYTES + (INT4 ? 1024 : 0);
        ld.add(M_QI, t * TILE_COLS, c * TILE_ROWS, l + 1, 0);
        if (INT4) {
          ld.add(M_SI4, t * TILE_COLS, c, l + 1, TILE_BYTES);
          ld.add(M_SI4, t * TILE_COLS, q.cin + c, l + 1, TILE_BYTES + 512);
        }
        emit(ld);
      }
      off = advance(off, n_in, G);
    }
  }
}

// The producer thread: each tile into the next free stage of the ring.
template <bool INT4, bool KV8>
__device__ void produce(const Params& p, const Plan& q, uint8_t* ring, uint64_t* full,
                        uint64_t* empty) {
  uint32_t k = 0;
  walk_tiles<INT4, KV8>(p, q, [&](const Load& ld) {
    const int st = k % STAGES;
    if (k >= STAGES) mbar_wait(&empty[st], ((k / STAGES) & 1) ^ 1);
    ++k;
    mbar_expect_tx(&full[st], ld.bytes);
    uint8_t* s = ring + st * STAGE_BYTES;
    for (int b = 0; b < ld.n; ++b) {
      tma_load_3d(s + ld.dst[b], &p.maps[ld.map[b]], &full[st], ld.c[b][0], ld.c[b][1],
                  ld.c[b][2]);
    }
  });
}

// ---------------------------------------------------------------------------
// the consumers' phases
// ---------------------------------------------------------------------------

struct Shared {
  uint8_t* xbuf;
  float *xs, *qs, *xch, *sc, *sum_red;
  int* red;
};

// 1a: mh = bf16(gelu(m_pre + b_fc_in)) in 256-value blocks, a block a warp
// over the grid; int4 also its codes and scale (blocks d/256 on of codes)
template <bool INT4>
__device__ void phase_mh(const Params& p, const Plan& q, int l, const bf16* fused) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nmb = p.f / 256;
  const float* b_in = p.b_fc_in + (long long)l * p.f;
  for (int i = blockIdx.x + q.G * warp; i < nmb; i += q.G * CWARPS) {
    const int e0 = 256 * i + 8 * lane;
    float m[8], v[8];
    unpack_bf16x8(__ldcg(reinterpret_cast<const uint4*>(fused + 3 * (long long)p.d + e0)), m);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(b_in + e0));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(b_in + e0 + 4));
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t out[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const bf16 lo = __float2bfloat16_rn(gelu_tanh(m[e] + bb[e]));
      const bf16 hi = __float2bfloat16_rn(gelu_tanh(m[e + 1] + bb[e + 1]));
      v[e] = __bfloat162float(lo);
      v[e + 1] = __bfloat162float(hi);
      out[e / 2] = (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }
    *reinterpret_cast<uint4*>(p.mh + e0) = make_uint4(out[0], out[1], out[2], out[3]);
    if (INT4) {
      uint2 packed;
      const float scale = warp_codes8(v, packed);
      *reinterpret_cast<uint2*>(p.codes + p.d + e0) = packed;
      if (lane == 0) p.xsc[p.d / 256 + i] = scale;
    }
  }
}

// 1b's fold of head hh: the token itself, then the chunks in order; writes
// ctx (int4: and its codes), k_new and v_new
// (cnt: the head's arrival counter, waited for after the token's own
// values are loaded; null at pos 0)
template <bool INT4>
__device__ void combine_head(const Params& p, const Plan& q, int l, const bf16* fused, int hh,
                             const Shared& s, unsigned* cnt = nullptr) {
  const int t = threadIdx.x;
  const int chunks_max = p.max_len / ATT_CHUNK;
  const float qx = __bfloat162float(__ldcg(fused + hh * HD + t));
  const float kx = __bfloat162float(__ldcg(fused + p.d + hh * HD + t));
  const bf16 v = __ldcg(fused + 2 * (long long)p.d + hh * HD + t);
  if (cnt != nullptr) wait_count(cnt, q.nck);
  const float qv = __fmul_rn(rotate(qx, t, p.sin, p.cos, p.rd), p.scale);
  const float kv = rotate(kx, t, p.sin, p.cos, p.rd);
  float m = block_sum(qv * kv, s.sum_red);  // the token's own score
  float lsum = 1.f, acc = __bfloat162float(v);
  const float* part = p.part + (long long)hh * chunks_max * PART;
  for (int c0 = 0; c0 < q.nck; c0 += 16) {  // 16 chunks' loads in flight
    float mc[16], lc[16], pc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (c0 + j < q.nck) {
        const float* src = part + (long long)(c0 + j) * PART;
        mc[j] = __ldcg(src + HD);
        lc[j] = __ldcg(src + HD + 1);
        pc[j] = __ldcg(src + t);
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (c0 + j < q.nck) {
        const float mn = fmaxf(m, mc[j]);
        const float a = expf(m - mn), b = expf(mc[j] - mn);
        lsum = lsum * a + lc[j] * b;
        acc = acc * a + pc[j] * b;
        m = mn;
      }
    }
  }
  const bf16 cv = __float2bfloat16_rn(__fdiv_rn(acc, lsum));
  p.ctx[hh * HD + t] = cv;
  const long long o = (long long)(l - p.l0) * p.d + hh * HD + t;
  p.k_new[o] = __float2bfloat16_rn(kv);
  p.v_new[o] = v;
  if (INT4) {  // the head is ctx's W4A8 block hh
    const float x = __bfloat162float(cv);
    const float amax = block_max(fabsf(x), s.sum_red);
    const float scale = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
    p.codes[hh * HD + t] = static_cast<int8_t>(static_cast<int>(rintf(__fdiv_rn(x, scale))));
    if (t == 0) p.xsc[hh] = scale;
  }
}

// 1b: the attention items (head, chunk of 16 positions below pos)
template <bool INT4, bool KV8>
__device__ void phase_attention(const Params& p, const Plan& q, int l, const bf16* fused, int pos,
                                int off, Ring& r, const Shared& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int chunks_max = p.max_len / ATT_CHUNK;
  const int n_att = p.h * q.nci;
  const Items items = my_items(off, n_att, q.G);
  for (int i = items.begin; i < items.end; i += items.stride) {
    const int hh = i / q.nci, c = i % q.nci;
    if (q.nck > 0) {
      s.qs[t] = __fmul_rn(rotate(__bfloat162float(__ldcg(fused + hh * HD + t)), t, p.sin, p.cos,
                                 p.rd),
                          p.scale);
      int st;
      const uint8_t* stg = ring_wait(r, st);
      csync();  // qs
      // scores: each warp takes 2 positions, a lane 8 dimensions
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int jl = warp * 2 + jj;
        const int j = c * ATT_CHUNK + jl;
        if (j >= pos) continue;  // the same for the whole warp
        float kv[8];
        if (KV8) {
          const uint2 raw = *reinterpret_cast<const uint2*>(stg + jl * HD + 8 * lane);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) kv[e] = static_cast<float>(b[e]);
        } else {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(stg + (jl * HD + 8 * lane) * 2), kv);
        }
        float sc = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) sc += kv[e] * s.qs[8 * lane + e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
        if (KV8) sc *= __bfloat162float(reinterpret_cast<const bf16*>(stg + TILE_BYTES)[jl]);
        if (lane == 0) s.sc[jl] = sc;
      }
      csync();
      const int nvalid = min(ATT_CHUNK, pos - c * ATT_CHUNK);
      float mc = s.sc[0];
      for (int jl = 1; jl < nvalid; ++jl) mc = fmaxf(mc, s.sc[jl]);
      float lc = 0.f, acc = 0.f;
      const uint8_t* vst = stg + TILE_BYTES / 2;
      for (int jl = 0; jl < nvalid; ++jl) {
        const float pj = expf(s.sc[jl] - mc);
        lc += pj;
        const float pv =
            KV8 ? pj * __bfloat162float(reinterpret_cast<const bf16*>(stg + TILE_BYTES + 512)[jl])
                : pj;
        const float vv = KV8 ? static_cast<float>(reinterpret_cast<const int8_t*>(vst)[jl * HD + t])
                             : __bfloat162float(reinterpret_cast<const bf16*>(vst)[jl * HD + t]);
        acc += pv * vv;
      }
      ring_release(r, st);
      float* dst = p.part + ((long long)hh * chunks_max + c) * PART;
      dst[t] = acc;
      if (t == 0) {
        dst[HD] = mc;
        dst[HD + 1] = lc;
      }
      csync();  // qs and sc are read before the next item overwrites them
    } else {
      combine_head<INT4>(p, q, l, fused, hh, s);  // pos 0: the token alone
    }
  }
  if (q.nck == 0) return;
  const int nci = q.nci;
  unsigned* heads = p.counters + q.head0;
  arrive_items(heads, items, [nci](int i) { return i / nci; });
}

// 1c: the heads this block folds, once all their chunks are in
template <bool INT4>
__device__ void fold_owned_heads(const Params& p, const Plan& q, int l, const bf16* fused,
                                 int off, const Shared& s) {
  if (q.nck == 0) return;
  for (int hh = first_owned(off, p.h * q.nci, q.G); hh < p.h; hh += q.G) {
    combine_head<INT4>(p, q, l, fused, hh, s, p.counters + q.head0 + hh);
  }
}

// 2: the dual's items (ctx's and mh's codes, or bf16 rows, copied to
// shared memory first), then its sums: the block that owns a column tile
// adds W_o's chunks (consumer threads 0..127) and W_fc_out's (128..255),
// each in order from 0 as K6's phase B, then the biases: a and m, or,
// without adapters, y
template <bool INT4>
__device__ void phase_dual(const Params& p, const Plan& q, int l, const bf16* x, bf16* y, int off,
                           Ring& r, const Shared& s) {
  const int t = threadIdx.x;
  const int d = p.d;
  if (INT4) {
    copy_cg(s.xbuf, p.codes, d + p.f);
    for (int i = t; i < (d + p.f) / 256; i += CONSUMERS) s.xs[i] = __ldcg(p.xsc + i);
  } else {
    copy_cg(s.xbuf, p.ctx, 2 * d);
    copy_cg(s.xbuf + 2 * d, p.mh, 2 * p.f);
  }
  csync();
  const int n_dual = (q.cho + q.chf) * q.td;
  const Items items = my_items(off, n_dual, q.G);
  for (int i = items.begin; i < items.end; i += items.stride) {
    const int c = i / q.td, tile = i % q.td;
    float term;
    if (INT4) {
      // ctx's blocks are 0 .. d/256 - 1, mh's d/256 on; a group's high
      // nibbles take the block K/512 on of its low ones
      const int lo = c < q.cho ? c : d / 256 + (c - q.cho);
      const int hi = lo + (c < q.cho ? q.cho : q.chf);
      term = w4a8_tile_term(r, reinterpret_cast<const int8_t*>(s.xbuf) + lo * 256,
                            reinterpret_cast<const int8_t*>(s.xbuf) + hi * 256, s.xs[lo], s.xs[hi],
                            s.red);
    } else {
      term = w8a16_tile_sum(r, reinterpret_cast<const bf16*>(s.xbuf) + c * TILE_ROWS,
                            reinterpret_cast<float*>(s.red));
    }
    if (t < TILE_COLS) p.terms[(long long)c * d + tile * TILE_COLS + t] = term;
  }
  const int td = q.td;
  arrive_items(p.counters, items, [td](int i) { return i % td; });
  for (int tile = first_owned(off, n_dual, q.G); tile < q.td; tile += q.G) {
    wait_count(&p.counters[tile], q.cho + q.chf);
    const int col = tile * TILE_COLS + (t & (TILE_COLS - 1));
    const float acc = t < TILE_COLS ? sum_terms(p.terms + col, d, q.cho)
                                    : sum_terms(p.terms + (long long)q.cho * d + col, d, q.chf);
    if (t >= TILE_COLS) s.xch[t - TILE_COLS] = acc;
    csync();
    if (t < TILE_COLS) {
      float ao = acc, af = s.xch[t];
      if (!INT4) {
        ao = __fmul_rn(ao, p.sd8[(long long)l * 2 * d + col]);
        af = __fmul_rn(af, p.sd8[(long long)l * 2 * d + d + col]);
      }
      bf16 a = __float2bfloat16_rn(ao);
      if (p.o_bias) a = bf16_add(a, __float2bfloat16_rn(p.o_bias[(long long)l * d + col]));
      const bf16 m = bf16_add(__float2bfloat16_rn(af),
                              __float2bfloat16_rn(p.b_fc_out[(long long)l * d + col]));
      if (q.adapters) {
        p.ab[col] = a;
        p.mb[col] = m;
      } else {
        y[col] = bf16_add(bf16_add(__ldcg(x + col), a), m);
      }
    }
    csync();  // xch is read before the next tile's sums overwrite it
  }
}

// 3: each adapter's down product; its terms go to scratch, summed where
// phase 4 needs them
__device__ void phase_adapter_down(const Params& p, const Plan& q, const bf16* u_in, int off,
                                   Ring& r, const Shared& s) {
  const int t = threadIdx.x;
  const int d = p.d;
  bf16* xb = reinterpret_cast<bf16*>(s.xbuf);
  for (int a = 0; a < 2; ++a) {
    if (p.ad[a].dh) copy_cg(xb + a * d, p.ad[a].src_in ? u_in : (a == 0 ? p.ab : p.mb), 2 * d);
  }
  csync();
  const int n0 = q.cdn * q.tdn[0], n_dn = n0 + q.cdn * q.tdn[1];
  const Items items = my_items(off, n_dn, q.G);
  for (int i = items.begin; i < items.end; i += items.stride) {
    const int a = i < n0 ? 0 : 1, j = i < n0 ? i : i - n0;
    const int c = j / q.tdn[a], tile = j % q.tdn[a];
    const float sum =
        w8a16_tile_sum(r, xb + a * d + c * TILE_ROWS, reinterpret_cast<float*>(s.red));
    if (t < TILE_COLS) {
      p.terms_b[((long long)a * q.cdn + c) * p.dhmax + tile * TILE_COLS + t] = sum;
    }
  }
}

// 4: the up products and the residual.  Every block first makes both
// adapters' h = bf16(relu(sum of the down terms in order * sd + bd))
// itself, into shared memory (zeros past dh, for a ragged last chunk); the
// block that owns a column tile then adds the up terms in order: a +=
// bf16(z_attn), m += bf16(z_mlp), y = x + a + m (K6's phase D).
__device__ void phase_adapter_up(const Params& p, const Plan& q, int l, const bf16* x, bf16* y,
                                 int off, Ring& r, const Shared& s) {
  const int t = threadIdx.x;
  const int d = p.d;
  bf16* hb = reinterpret_cast<bf16*>(s.xbuf);
  const int hstride = q.cupmax * TILE_ROWS;
  for (int a = 0; a < 2; ++a) {
    const Adapt& ad = p.ad[a];
    if (ad.dh == 0) continue;
    const float* terms = p.terms_b + (long long)a * q.cdn * p.dhmax;
    for (int c0 = t; c0 < q.cup[a] * TILE_ROWS; c0 += 4 * CONSUMERS) {
      const int cols[4] = {c0, c0 + CONSUMERS, c0 + 2 * CONSUMERS, c0 + 3 * CONSUMERS};
      float acc[4];
      sum_cols<4, 16>(terms, p.dhmax, q.cdn, cols, 4, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = cols[j];
        if (col >= q.cup[a] * TILE_ROWS) continue;
        const long long o = (long long)l * ad.dh + col;
        hb[a * hstride + col] = col < ad.dh
                                    ? __float2bfloat16_rn(fmaxf(acc[j] * ad.sd[o] + ad.bd[o], 0.f))
                                    : __float2bfloat16_rn(0.f);
      }
    }
  }
  csync();
  const int u0 = q.cup[0] * q.td, n_up = u0 + q.cup[1] * q.td;
  const Items items = my_items(off, n_up, q.G);
  for (int i = items.begin; i < items.end; i += items.stride) {
    const int a = i < u0 ? 0 : 1, j = i < u0 ? i : i - u0;
    const int c = j / q.td, tile = j % q.td;
    const float sum = w8a16_tile_sum(r, hb + a * hstride + c * TILE_ROWS,
                                     reinterpret_cast<float*>(s.red));
    if (t < TILE_COLS) {
      p.terms[((long long)a * q.cupmax + c) * d + tile * TILE_COLS + t] = sum;
    }
  }
  const int td = q.td;
  arrive_items(p.counters, items, [td](int i) { return i % td; });
  for (int tile = first_owned(off, n_up, q.G); tile < q.td; tile += q.G) {
    wait_count(&p.counters[tile], q.cup[0] + q.cup[1]);
    // adapter 0's sum in consumer threads 0..127, adapter 1's in 128..255
    const int a2 = t / TILE_COLS;
    const int col = tile * TILE_COLS + (t & (TILE_COLS - 1));
    float z = 0.f;
    if (p.ad[a2].dh) {
      const float acc = sum_terms(p.terms + (long long)a2 * q.cupmax * d + col, d, q.cup[a2]);
      const long long o = (long long)l * d + col;
      z = acc * p.ad[a2].su[o] + p.ad[a2].bu[o];
    }
    if (t >= TILE_COLS) s.xch[t - TILE_COLS] = z;
    csync();
    if (t < TILE_COLS) {
      bf16 av = __ldcg(p.ab + col), mv = __ldcg(p.mb + col);
      if (p.ad[0].dh) av = bf16_add(av, __float2bfloat16_rn(z));
      if (p.ad[1].dh) mv = bf16_add(mv, __float2bfloat16_rn(s.xch[t]));
      y[col] = bf16_add(bf16_add(__ldcg(x + col), av), mv);
    }
    csync();  // xch is read before the next tile's sums overwrite it
  }
}

// 5: the LN of y in every block (K6's order of sums: thread t takes
// elements t, t + 256, ...), u (written out by block 0), then the next
// layer's in_proj on u where the layer has one: fused, summed by the block
// that owns each tile as the dual's
template <bool INT4>
__device__ void phase_ln_inproj(const Params& p, const Plan& q, int l, const bf16* y, int off,
                                Ring& r, const Shared& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int d = p.d;
  bf16* ub = reinterpret_cast<bf16*>(s.xbuf);      // u: [0, 2d) bytes
  bf16* yb = ub + d;                                // y: [2d, 4d)
  int8_t* uc = reinterpret_cast<int8_t*>(s.xbuf) + 4 * d;  // u's codes: [4d, 5d)
  copy_cg(yb, y, 2 * d);
  csync();
  float sm = 0.f;
  for (int c = t; c < d; c += CONSUMERS) sm += __bfloat162float(yb[c]);
  const float mean = __fdiv_rn(block_sum(sm, s.sum_red), (float)d);
  float sq = 0.f;
  for (int c = t; c < d; c += CONSUMERS) {
    const float dv = __fsub_rn(__bfloat162float(yb[c]), mean);
    sq = __fadd_rn(sq, __fmul_rn(dv, dv));
  }
  const float var = __fdiv_rn(block_sum(sq, s.sum_red), (float)d);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
  const float* g = p.ln_g + (long long)l * d;
  const float* b = p.ln_b + (long long)l * d;
  for (int c = t; c < d; c += CONSUMERS) {
    const float un = __fmul_rn(__fsub_rn(__bfloat162float(yb[c]), mean), rstd);
    const bf16 uv = __float2bfloat16_rn(__fadd_rn(__fmul_rn(un, g[c]), b[c]));
    ub[c] = uv;
    if (blockIdx.x == 0) p.u[c] = uv;
  }
  if (l >= p.in_until) return;
  csync();
  if (INT4) {
    for (int blk = warp; blk < d / 256; blk += CWARPS) {
      float v[8];
      unpack_bf16x8(*reinterpret_cast<const uint4*>(ub + blk * 256 + 8 * lane), v);
      uint2 packed;
      const float scale = warp_codes8(v, packed);
      *reinterpret_cast<uint2*>(uc + blk * 256 + 8 * lane) = packed;
      if (lane == 0) s.xs[blk] = scale;
    }
    csync();
  }
  const int n_in = q.cin * q.ti;
  const long long ni = p.ni;
  const Items items = my_items(off, n_in, q.G);
  for (int i = items.begin; i < items.end; i += items.stride) {
    const int c = i / q.ti, tile = i % q.ti;
    float term;
    if (INT4) {
      term = w4a8_tile_term(r, uc + c * 256, uc + (q.cin + c) * 256, s.xs[c], s.xs[q.cin + c],
                            s.red);
    } else {
      term = w8a16_tile_sum(r, ub + c * TILE_ROWS, reinterpret_cast<float*>(s.red));
    }
    if (t < TILE_COLS) p.terms_b[c * ni + tile * TILE_COLS + t] = term;
  }
  const int ti = q.ti;
  arrive_items(p.counters, items, [ti](int i) { return i % ti; });
  for (int tile = first_owned(off, n_in, q.G); tile < q.ti; tile += q.G) {
    wait_count(&p.counters[tile], q.cin);
    if (t < TILE_COLS) {  // as K6's phase G
      const int col = tile * TILE_COLS + t;
      float acc = sum_terms(p.terms_b + col, ni, q.cin);
      if (!INT4) acc = __fmul_rn(acc, p.si8[(l + 1) * ni + col]);
      p.fused[col] = __float2bfloat16_rn(acc);
    }
  }
}

template <bool INT4, bool KV8, bool STAMP>
__device__ void consume(const Params& p, const Plan& q, int pos, Ring& r, const Shared& s) {
  unsigned* bar = p.counters + p.n_counters;
  unsigned epoch = 0;
  int off = 0;
  for (int l = p.l0; l < p.l1; ++l) {
    // y alternates between two buffers so a layer never overwrites the x
    // it reads; the launch's last layer writes p.y
    bf16* y = ((p.l1 - 1 - l) & 1) ? p.y2 : p.y;
    const bf16* x = l == p.l0 ? p.x_in : (y == p.y ? p.y2 : p.y);
    const bf16* u_in = l == p.l0 ? p.u_in : p.u;
    const bf16* fused = l == p.l0 ? p.fused_in : p.fused;
    stamp<STAMP>(p, l, 0, 0);
    phase_mh<INT4>(p, q, l, fused);
    phase_attention<INT4, KV8>(p, q, l, fused, pos, off, r, s);
    fold_owned_heads<INT4>(p, q, l, fused, off, s);
    off = advance(off, p.h * q.nci, q.G);
    stamp<STAMP>(p, l, 0, 1);
    grid_barrier(bar, epoch);
    stamp<STAMP>(p, l, 1, 0);
    phase_dual<INT4>(p, q, l, x, y, off, r, s);
    off = advance(off, (q.cho + q.chf) * q.td, q.G);
    stamp<STAMP>(p, l, 1, 1);
    grid_barrier(bar, epoch);
    if (q.adapters) {
      stamp<STAMP>(p, l, 2, 0);
      phase_adapter_down(p, q, u_in, off, r, s);
      off = advance(off, q.cdn * (q.tdn[0] + q.tdn[1]), q.G);
      stamp<STAMP>(p, l, 2, 1);
      grid_barrier(bar, epoch);
      stamp<STAMP>(p, l, 3, 0);
      phase_adapter_up(p, q, l, x, y, off, r, s);
      off = advance(off, (q.cup[0] + q.cup[1]) * q.td, q.G);
      stamp<STAMP>(p, l, 3, 1);
      grid_barrier(bar, epoch);
    }
    stamp<STAMP>(p, l, 4, 0);
    phase_ln_inproj<INT4>(p, q, l, y, off, r, s);
    if (l < p.in_until) off = advance(off, q.cin * q.ti, q.G);
    stamp<STAMP>(p, l, 4, 1);
    if (l + 1 < p.l1) grid_barrier(bar, epoch);
  }
}

template <bool INT4, bool KV8, bool STAMP>
__global__ void __launch_bounds__(THREADS, 1)
    decode_stream_kernel(const __grid_constant__ Params p) {
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
  // the counters start at 0 in every launch: block 0 clears them before
  // the one grid-wide barrier of every thread
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i <= p.n_counters; i += THREADS) p.counters[i] = 0u;
  }
  __threadfence();
  cg::this_grid().sync();
  const int pos = max(0, min(*p.pos, p.max_len));
  const Plan q = make_plan<INT4>(p, pos);
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) produce<INT4, KV8>(p, q, smem, full, empty);
    return;
  }
  Ring r{smem, full, empty, 0u};
  Shared s;
  s.xbuf = smem + OFF_XBUF;
  s.xs = reinterpret_cast<float*>(smem + OFF_XS);
  s.red = reinterpret_cast<int*>(smem + OFF_RED);
  s.qs = reinterpret_cast<float*>(smem + OFF_QS);
  s.xch = reinterpret_cast<float*>(smem + OFF_XCH);
  s.sc = reinterpret_cast<float*>(smem + OFF_SC);
  s.sum_red = reinterpret_cast<float*>(smem + OFF_SUMRED);
  consume<INT4, KV8, STAMP>(p, q, pos, r, s);
}

// n grid barriers of K8's kind and nothing else, on K8's grid: what the
// kernel's barriers cost apart from the work between them
__global__ void __launch_bounds__(THREADS, 1) barrier_probe_kernel(int n, unsigned* bar) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *bar = 0u;
  __threadfence();
  cg::this_grid().sync();
  if (threadIdx.x >= CONSUMERS) return;
  unsigned epoch = 0;
  for (int i = 0; i < n; ++i) grid_barrier(bar, epoch);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// one block per SM of decode_stream_kernel on device dev (-1 where the
// device has no cooperative launch or the block does not fit), queried at
// the first launch, with the real dynamic shared memory
cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[MAX_DEVICES] = {};  // 0: not queried yet
  static std::mutex mu;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cached[dev] == 0) {
    const void* kernels[] = {
        reinterpret_cast<const void*>(decode_stream_kernel<true, false, false>),
        reinterpret_cast<const void*>(decode_stream_kernel<true, true, false>),
        reinterpret_cast<const void*>(decode_stream_kernel<false, false, false>),
        reinterpret_cast<const void*>(decode_stream_kernel<false, true, false>),
        reinterpret_cast<const void*>(decode_stream_kernel<true, false, true>),
        reinterpret_cast<const void*>(decode_stream_kernel<true, true, true>),
        reinterpret_cast<const void*>(decode_stream_kernel<false, false, true>),
        reinterpret_cast<const void*>(decode_stream_kernel<false, true, true>),
        reinterpret_cast<const void*>(barrier_probe_kernel)};
    int sms = 0, coop = 0, fewest = 1 << 30;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (const void* k : kernels) {
      int per_sm = 0;
      if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
      }
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS, SMEM_BYTES);
      }
      fewest = per_sm < fewest ? per_sm : fewest;
    }
    if (err != cudaSuccess) return err;
    cached[dev] = (coop && fewest > 0) ? fewest * sms : -1;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, memoised on all of its arguments: a stack's maps
// are encoded at its first launch and reused by the launches after it
constexpr int MAP_SLOTS = 256;
struct MapKey {
  const void* base;
  int type, rank;
  uint64_t dims[3], strides[2];
  uint32_t box[3];
};

bool tensor_map(CUtensorMap* out, CUtensorMapDataType type, const void* base, int rank,
                const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  static std::mutex mu;
  static MapKey keys[MAP_SLOTS];
  static CUtensorMap maps[MAP_SLOTS];
  static int used = 0, next = 0;
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.type = (int)type;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i + 1 < rank) key.strides[i] = strides[i];
  }
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *out = maps[i];
      return true;
    }
  }
  const tma_wgmma::EncodeTiledFn fn = tma_wgmma::encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t d[3], st[2];
  cuuint32_t bx[3], es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    if (i + 1 < rank) st[i] = strides[i];
  }
  if (fn(out, type, rank, const_cast<void*>(base), d, st, bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % MAP_SLOTS;
  used = used < MAP_SLOTS ? used + 1 : used;
  return true;
}

// an (L, rows, cols) stack of `esize`-byte elements, read in boxes of
// box_rows x box_cols of one layer
bool stack_map(CUtensorMap* out, CUtensorMapDataType type, int esize, const void* base, int L,
               long long rows, long long cols, int box_rows, int box_cols) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)L};
  const uint64_t strides[2] = {(uint64_t)cols * esize, (uint64_t)(rows * cols * esize)};
  const uint32_t box[3] = {(uint32_t)box_cols, (uint32_t)box_rows, 1u};
  return tensor_map(out, type, base, 3, dims, strides, box);
}

template <bool INT4, bool KV8, bool STAMP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks(dev, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {const_cast<Params*>(&p)};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(decode_stream_kernel<INT4, KV8, STAMP>), dim3(resident),
      dim3(THREADS), args, SMEM_BYTES, stream);
}

// the entry's arrays, in the order of ops/decode_layer.py's _INTS and _PTRS
enum Ints {
  I_LAYERS, I_L0, I_L1, I_IN_UNTIL, I_HEADS, I_D, I_F, I_NI, I_MAX_LEN, I_ROTARY, I_INT4,
  I_KV8, I_DH_A, I_SRC_A, I_DH_M, I_SRC_M, I_HEAD_DIM, I_CHUNK, I_N_COUNTERS, I_N_TERMS, N_INTS
};
enum Floats { F_SCALE, F_EPS, N_FLOATS };
enum Ptrs {
  P_POS, P_SIN, P_COS, P_FUSED_IN, P_X_IN, P_U_IN, P_K_CACHE, P_V_CACHE, P_K_SCALE, P_V_SCALE,
  P_QD, P_SD, P_B_FC_IN, P_B_FC_OUT, P_LN_G, P_LN_B, P_O_BIAS,
  P_A_WD, P_A_SD, P_A_BD, P_A_WU, P_A_SU, P_A_BU, P_A_H,
  P_M_WD, P_M_SD, P_M_BD, P_M_WU, P_M_SU, P_M_BU, P_M_H,
  P_QI, P_SI, P_Y, P_Y2, P_U, P_FUSED, P_K_NEW, P_V_NEW, P_PART, P_TERMS,
  P_CTX, P_MH, P_AB, P_MB, P_CODES, P_XSC, P_COUNTERS, P_STAMPS, N_PTRS
};

}  // namespace

// C entry for ctypes: iv[N_INTS], fv[N_FLOATS], pv[N_PTRS] as enumerated
// above (the counts are passed to catch a mismatch with the wrapper).
// Layers [l0, l1) of the stacks run; layers l < in_until also run the
// next layer's in_proj.  The pointers of what is absent (an adapter, the
// scales of a bf16 cache, o_bias, u_in, the in_proj) may be null; a
// non-null stamps pointer launches the stamped build.  Returns a
// cudaError_t: cudaErrorInvalidValue for a geometry or a scratch the kernel
// does not take, or a tensor map that does not encode.
extern "C" int magma_decode_layers(int n_ints, const long long* iv, int n_floats,
                                   const float* fv, int n_ptrs, void* const* pv, void* stream) {
  if (n_ints != N_INTS || n_floats != N_FLOATS || n_ptrs != N_PTRS) {
    return (int)cudaErrorInvalidValue;
  }
  const bool int4 = iv[I_INT4] != 0, kv8 = iv[I_KV8] != 0;
  const long long d = iv[I_D], f = iv[I_F], ni = iv[I_NI], h = iv[I_HEADS];
  const long long max_len = iv[I_MAX_LEN], rd = iv[I_ROTARY];
  const long long L = iv[I_LAYERS], l0 = iv[I_L0], l1 = iv[I_L1], in_until = iv[I_IN_UNTIL];
  const long long dh_a = iv[I_DH_A], dh_m = iv[I_DH_M];
  const long long dhmax = dh_a > dh_m ? dh_a : dh_m;
  const long long group = int4 ? 2 * TILE_ROWS : TILE_ROWS;
  const bool in_proj = in_until > l0;
  const long long cup = (dhmax + TILE_ROWS - 1) / TILE_ROWS;
  // arrival counters: the dual's or the in_proj's column tiles, then the
  // attention's heads (after them the barrier's); the two regions of chunk
  // terms (ops/decode_layer.py stream_plan)
  const long long need_counters = (d > ni ? d : ni) / TILE_COLS + h;
  const long long terms_a = (d + f) / group * d > 2 * cup * d ? (d + f) / group * d : 2 * cup * d;
  const long long terms_b = 2 * (d / TILE_ROWS) * dhmax > d / group * ni
                                ? 2 * (d / TILE_ROWS) * dhmax
                                : d / group * ni;
  const long long need_terms = terms_a + terms_b;
  const bool fits = (int4 ? d + f : 2 * (d + f)) <= XBUF_BYTES && (d + f) / 256 <= XSCALES &&
                    5 * d <= XBUF_BYTES && 2 * cup * TILE_ROWS * 2 <= XBUF_BYTES;
  if (iv[I_HEAD_DIM] != HD || iv[I_CHUNK] != ATT_CHUNK || h < 1 || d != h * HD || d % group ||
      f <= 0 || f % group || max_len <= 0 || max_len % ATT_CHUNK || rd < 0 || rd > HD || rd % 2 ||
      L > MAX_LAYERS || l0 < 0 || l1 <= l0 || l1 > L || in_until > L - 1 ||
      (in_proj && (ni <= 0 || ni % TILE_COLS || !pv[P_QI] || !pv[P_SI])) ||
      dh_a < 0 || dh_a % TILE_COLS || dh_m < 0 || dh_m % TILE_COLS || !fits ||
      (kv8 && (!pv[P_K_SCALE] || !pv[P_V_SCALE])) ||
      (((dh_a && iv[I_SRC_A]) || (dh_m && iv[I_SRC_M])) && !pv[P_U_IN]) ||
      iv[I_N_COUNTERS] < need_counters || iv[I_N_TERMS] < need_terms ||
      !pv[P_COUNTERS] || !pv[P_TERMS] || !pv[P_PART] || !pv[P_Y] || !pv[P_Y2] ||
      (int4 && (!pv[P_CODES] || !pv[P_XSC])) || (in_proj && !pv[P_FUSED])) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  memset(&p, 0, sizeof(p));
  const CUtensorMapDataType U8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  bool ok = true;
  // the dual: (d + f) / 2 packed rows (int4) or d + f rows of d columns
  ok = ok && stack_map(&p.maps[M_QD], U8, 1, pv[P_QD], L, int4 ? (d + f) / 2 : d + f, d, TILE_ROWS,
                       TILE_COLS);
  if (int4) {
    ok = ok && stack_map(&p.maps[M_SD4], F32, 4, pv[P_SD], L, (d + f) / 256, d, 1, TILE_COLS);
  }
  if (in_proj) {
    ok = ok && stack_map(&p.maps[M_QI], U8, 1, pv[P_QI], L, int4 ? d / 2 : d, ni, TILE_ROWS,
                         TILE_COLS);
    if (int4) ok = ok && stack_map(&p.maps[M_SI4], F32, 4, pv[P_SI], L, d / 256, ni, 1, TILE_COLS);
  }
  const long long dh[2] = {dh_a, dh_m};
  for (int k = 0; k < 2; ++k) {
    if (dh[k] == 0) continue;
    const int b = k == 0 ? P_A_WD : P_M_WD;
    ok = ok && stack_map(&p.maps[M_WD0 + k], U8, 1, pv[b], L, d, dh[k], TILE_ROWS, TILE_COLS) &&
         stack_map(&p.maps[M_WU0 + k], U8, 1, pv[b + 3], L, dh[k], d, TILE_ROWS, TILE_COLS);
    p.ad[k] = Adapt{static_cast<const float*>(pv[b + 1]), static_cast<const float*>(pv[b + 2]),
                    static_cast<const float*>(pv[b + 4]), static_cast<const float*>(pv[b + 5]),
                    static_cast<bf16*>(pv[b + 6]), (int)dh[k],
                    (k == 0 ? iv[I_SRC_A] : iv[I_SRC_M]) ? 1 : 0};
  }
  // the caches: (L max_len, h, HD) rows of HD values; their scales
  // (L h, max_len)
  const CUtensorMapDataType CT = kv8 ? U8 : BF;
  const int ces = kv8 ? 1 : 2;
  if (ok) {  // (HD, h, L max_len) in boxes of HD x 1 x ATT_CHUNK
    const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)h, (uint64_t)(L * max_len)};
    const uint64_t strides[2] = {(uint64_t)HD * ces, (uint64_t)(h * HD * ces)};
    const uint32_t box[3] = {(uint32_t)HD, 1u, (uint32_t)ATT_CHUNK};
    ok = tensor_map(&p.maps[M_KC], CT, pv[P_K_CACHE], 3, dims, strides, box) &&
         tensor_map(&p.maps[M_VC], CT, pv[P_V_CACHE], 3, dims, strides, box);
  }
  if (kv8) {
    ok = ok && stack_map(&p.maps[M_KS], BF, 2, pv[P_K_SCALE], 1, L * h, max_len, 1, ATT_CHUNK) &&
         stack_map(&p.maps[M_VS], BF, 2, pv[P_V_SCALE], 1, L * h, max_len, 1, ATT_CHUNK);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  p.l0 = (int)l0;
  p.l1 = (int)l1;
  p.in_until = (int)in_until;
  p.h = (int)h;
  p.d = (int)d;
  p.f = (int)f;
  p.ni = (int)ni;
  p.max_len = (int)max_len;
  p.rd = (int)rd;
  p.dhmax = (int)dhmax;
  p.n_counters = (int)iv[I_N_COUNTERS];
  p.scale = fv[F_SCALE];
  p.eps = fv[F_EPS];
  p.pos = static_cast<const int*>(pv[P_POS]);
  p.sin = static_cast<const float*>(pv[P_SIN]);
  p.cos = static_cast<const float*>(pv[P_COS]);
  p.fused_in = static_cast<const bf16*>(pv[P_FUSED_IN]);
  p.x_in = static_cast<const bf16*>(pv[P_X_IN]);
  p.u_in = static_cast<const bf16*>(pv[P_U_IN]);
  p.b_fc_in = static_cast<const float*>(pv[P_B_FC_IN]);
  p.b_fc_out = static_cast<const float*>(pv[P_B_FC_OUT]);
  p.ln_g = static_cast<const float*>(pv[P_LN_G]);
  p.ln_b = static_cast<const float*>(pv[P_LN_B]);
  p.o_bias = static_cast<const float*>(pv[P_O_BIAS]);
  p.sd8 = int4 ? nullptr : static_cast<const float*>(pv[P_SD]);
  p.si8 = int4 ? nullptr : static_cast<const float*>(pv[P_SI]);
  p.y = static_cast<bf16*>(pv[P_Y]);
  p.u = static_cast<bf16*>(pv[P_U]);
  p.fused = static_cast<bf16*>(pv[P_FUSED]);
  p.k_new = static_cast<bf16*>(pv[P_K_NEW]);
  p.v_new = static_cast<bf16*>(pv[P_V_NEW]);
  p.ctx = static_cast<bf16*>(pv[P_CTX]);
  p.mh = static_cast<bf16*>(pv[P_MH]);
  p.ab = static_cast<bf16*>(pv[P_AB]);
  p.mb = static_cast<bf16*>(pv[P_MB]);
  p.part = static_cast<float*>(pv[P_PART]);
  p.terms = static_cast<float*>(pv[P_TERMS]);
  p.terms_b = p.terms + terms_a;
  p.y2 = static_cast<bf16*>(pv[P_Y2]);
  p.codes = static_cast<int8_t*>(pv[P_CODES]);
  p.xsc = static_cast<float*>(pv[P_XSC]);
  p.counters = static_cast<unsigned*>(pv[P_COUNTERS]);
  p.stamps = static_cast<unsigned long long*>(pv[P_STAMPS]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.stamps) {
    if (int4) err = kv8 ? launch<true, true, true>(p, st) : launch<true, false, true>(p, st);
    else err = kv8 ? launch<false, true, true>(p, st) : launch<false, false, true>(p, st);
  } else {
    if (int4) err = kv8 ? launch<true, true, false>(p, st) : launch<true, false, false>(p, st);
    else err = kv8 ? launch<false, true, false>(p, st) : launch<false, false, false>(p, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid of K7 and K8 (one block per SM) on the current device, in
// *blocks.  Returns a cudaError_t.
extern "C" int magma_decode_layers_grid(int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks(dev, blocks);
  return (int)err;
}

// C entry for measurement: one cooperative launch of n grid barriers of
// K8's kind on K8's grid; `bar` is one unsigned of device scratch.
// Returns a cudaError_t.
extern "C" int magma_grid_sync_probe(int n, void* bar, void* stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks(dev, &resident);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || resident < 1 || bar == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&n, &bar};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(barrier_probe_kernel), dim3(resident),
                                    dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
