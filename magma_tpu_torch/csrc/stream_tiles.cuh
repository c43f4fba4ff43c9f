// The streamed weight pipeline shared by the fused adapter (fused_adapter.cu,
// K5) and the layer boundary (boundary.cu, K6), for Hopper (sm_90a).
//
// A launch is cooperative, one block an SM.  A block is a producer warp and
// eight consumer warps.  Every weight the launch reads is cut into 32 KB
// tiles of an int8 stack: 256 rows x 128 columns (an adapter's down
// weights, or 256 packed rows of an int4 payload, one W4A8 group, with its
// two scale rows; 128-byte swizzled, which makes the consumers' fragment
// loads free of bank conflicts) or 1024 rows x 32 columns (an adapter's up
// weights).  The items of a phase go to the blocks in contiguous ranges
// (block_range), so a block's items follow from the grid size and the
// shapes alone: the producer walks the block's items of every phase ahead
// of the consumers and keeps one TMA load a tile in flight through a
// STAGES-deep ring (mbarrier completion); it never waits for activations,
// so it loads the next phase's tiles while the consumers wait at a
// barrier.
//
// A chunk's partial sums go to an fp32 scratch ("terms"); a block, after
// its items of a phase, releases one arrival an item on the item's column
// tile counter (red.release); the blocks that own the (tile, row) units
// acquire the count and add the chunks in order (owned_pairs).  A grid
// barrier (an arrival counter) closes a phase whose output the next phase
// reads whole.  Block 0 zeroes the counters at the launch's start and then
// publishes the launch's nonce; the other blocks wait for it before their
// first counter, so the scratch needs no memset.  No float atomics: every
// sum has a fixed order and a launch repeats its bits.  The weights stream
// through L2 evict-first, so they do not push out the terms the owners
// read back.
//
// The adapter's products run on mma.sync.m16n8k16 (bf16 x bf16 -> fp32):
// the int8 weight, widened to bf16 exactly in registers, is A (16 columns
// a warp), the activation rows, padded to a multiple of 8, are B.  The down
// product (adapter_tile) is split over K in 256-row chunks and owner-summed
// as above; the up product (slice_product) goes in 32-column slices over
// all of its K, which one block adds itself.  bf16 x int8 products are
// exact in fp32; only the order of the fp32 sums differs from a plain
// product's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <chrono>
#include <mutex>

#include "mma_tiles.cuh"
#include "tma_wgmma.cuh"

namespace stream_tiles {

using bf16 = __nv_bfloat16;
using mma_tiles::mma_16816;
using mma_tiles::smem_addr;
using tma_wgmma::mbar_arrive;
using tma_wgmma::mbar_expect_tx;
using tma_wgmma::mbar_init;
using tma_wgmma::mbar_wait;
using tma_wgmma::s8x2_to_bf16x2;

constexpr int CWARPS = 8;  // consumer warps
constexpr int CONSUMERS = 32 * CWARPS;
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int TILE_ROWS = 256;
constexpr int TILE_COLS = 128;
constexpr int TILE_BYTES = TILE_ROWS * TILE_COLS;
constexpr int STAGE_BYTES = TILE_BYTES + 1024;  // + two rows of 128 fp32 scales (W4A8)
constexpr int STAGES = 5;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int XPITCH = TILE_ROWS + 8;  // bf16 a row of an activation chunk (528 bytes)
static_assert(STAGE_BYTES % 1024 == 0, "a 128-byte-swizzled tile starts 1024-byte aligned");

// ---------------------------------------------------------------------------
// synchronisation
// ---------------------------------------------------------------------------

// the consumer warps of the block (named barrier 1; the producer never joins)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_acquire64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// a spin that has waited about ten seconds traps instead of holding the card
__device__ __forceinline__ void spin_check(long long& start) {
  if (start == 0) {
    start = clock64();
  } else if (clock64() - start > (1ll << 34)) {
    asm volatile("trap;");
  }
}

// Block 0's consumers zero the launch's n counters, then publish the
// launch's nonce at *flag (release).  Every block calls open_wait before its
// first counter or barrier: what block 0 zeroed is then visible to it.
__device__ __forceinline__ void open_counters(unsigned* counters, int n, unsigned long long* flag,
                                              unsigned long long nonce) {
  for (int i = threadIdx.x; i < n; i += CONSUMERS) counters[i] = 0u;
  csync();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(flag), "l"(nonce) : "memory");
  }
}

// (An acquire by consumer thread 0 followed by the consumers' named barrier
// orders what the releaser published before every consumer thread's later
// reads; a release after that barrier publishes what every consumer thread
// wrote before it.)
__device__ __forceinline__ void open_wait(const unsigned long long* flag,
                                          unsigned long long nonce) {
  if (threadIdx.x == 0) {
    long long start = 0;
    while (ld_acquire64(flag) != nonce) spin_check(start);
  }
  csync();
}

__device__ __forceinline__ void red_release(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(p) : "memory");
}

// Every consumer thread of every block: what the grid wrote before it is
// visible after it.  One counter that only grows within a launch; the
// epoch-th barrier waits for epoch x grid arrivals.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned& epoch) {
  ++epoch;
  csync();
  if (threadIdx.x == 0) {
    red_release(bar);
    const unsigned target = epoch * gridDim.x;
    long long start = 0;
    while (ld_acquire(bar) < target) spin_check(start);
  }
  csync();
}

// a block's items of a phase of n: [lo, hi), contiguous, the same in every
// role of the block
struct Range {
  int lo, hi;
};

__device__ __forceinline__ Range block_range(int n) {
  return Range{(int)((long long)blockIdx.x * n / gridDim.x),
               (int)((long long)(blockIdx.x + 1) * n / gridDim.x)};
}

// Once the block's items of a phase have written their terms: one arrival
// for each item on counter cnt_of(i), released to the grid, issued
// together by the first consumer warp.  Waits for nothing.
template <typename CntOf>
__device__ __forceinline__ void arrive_items(Range r, CntOf cnt_of) {
  csync();  // the items' writes come first
  if (threadIdx.x >= 32) return;
  for (int i = r.lo + (int)threadIdx.x; i < r.hi; i += 32) red_release(cnt_of(i));
}

// Consumer thread 0 waits until *a reaches ta arrivals and thread 32 until
// *b reaches tb (either may be null); what the arrivals wrote is then
// visible to every consumer thread of the block (read it through L2).
// Counters are never reset within a launch, so any number of blocks may
// wait on one.
__device__ __forceinline__ void wait_counts(const unsigned* a, unsigned ta, const unsigned* b,
                                            unsigned tb) {
  const unsigned* c = threadIdx.x == 0 ? a : threadIdx.x == 32 ? b : nullptr;
  const unsigned target = threadIdx.x == 0 ? ta : tb;
  if (c != nullptr) {
    long long start = 0;
    while (ld_acquire(c) < target) spin_check(start);
  }
  csync();
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// STAMP builds: the %globaltimer at a phase's start (end 0) or end (1),
// stamps (grid, n_phases, 2); measurement only
template <bool STAMP>
__device__ __forceinline__ void stamp(unsigned long long* stamps, int n_phases, int phase,
                                      int end) {
  if (STAMP && threadIdx.x == 0) {
    stamps[((long long)blockIdx.x * n_phases + phase) * 2 + end] = globaltimer();
  }
}

// The stamps of a phase of owned sums: its start once the block's first
// counter wait has returned (so the gap before it is the arrivals and the
// wait), its end after the last unit; a block that owns no unit stamps
// nothing.
template <bool STAMP>
struct SumStamps {
  unsigned long long* stamps;
  int n_phases, phase;
  bool started;
  __device__ void waited() {
    if (!started) stamp<STAMP>(stamps, n_phases, phase, 0);
    started = true;
  }
  __device__ void done() {
    if (started) stamp<STAMP>(stamps, n_phases, phase, 1);
  }
};

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

struct Ring {
  uint8_t* base;
  uint64_t *full, *empty;
  uint32_t k;  // tiles taken so far
};

// every consumer thread, for each tile in turn
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

// An L2 policy for data read once: evicted first, so the weights streaming
// through L2 do not push out the chunk terms that the owners read back
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "l"(policy)
      : "memory");
}

// one ring tile: up to four boxes (a tensor map, its (column, row, layer)
// coordinates, the byte offset in the stage) and the bytes they bring
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

// the tensor map's descriptor into the cache ahead of its first load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The producer thread: each Load into the next free stage of the ring,
// weights read once (evict-first in L2).
struct Producer {
  uint8_t* ring;
  uint64_t *full, *empty;
  const CUtensorMap* maps;
  uint32_t k;
  uint64_t policy;
  __device__ void operator()(const Load& ld) {
    const int st = k % STAGES;
    if (k >= STAGES) mbar_wait(&empty[st], ((k / STAGES) & 1) ^ 1);
    ++k;
    mbar_expect_tx(&full[st], ld.bytes);
    uint8_t* s = ring + st * STAGE_BYTES;
    for (int b = 0; b < ld.n; ++b) {
      tma_load_3d(s + ld.dst[b], &maps[ld.map[b]], &full[st], ld.c[b][0], ld.c[b][1],
                  ld.c[b][2], policy);
    }
  }
  // waits until every tile issued so far has landed, so that the tiles
  // issued next do not share the memory system with them
  __device__ void drain() {
    for (uint32_t j = k > STAGES ? k - STAGES : 0; j < k; ++j) {
      mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
    }
  }
};

// ---------------------------------------------------------------------------
// activations, sums
// ---------------------------------------------------------------------------

// rows [0, rows_pad) x columns [k0, k0 + W) of a bf16 matrix (row stride
// ld elements) -> shared memory, PITCH elements a row; rows past `rows` and
// columns past k0 + kvalid are zeros (a zero weight times a stale value
// could be NaN).  Read through L2: the rows may have been written in the
// launch.
template <int W, int PITCH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long ld, int rows,
                                          int rows_pad, int k0, int kvalid) {
  for (int i = threadIdx.x; i < rows_pad * (W / 8); i += CONSUMERS) {
    const int r = i / (W / 8), v = (i % (W / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && v < kvalid) {
      val = __ldcg(reinterpret_cast<const uint4*>(src + r * ld + k0 + v));
    }
    *reinterpret_cast<uint4*>(dst + r * PITCH + v) = val;
  }
}

// the in-order fp32 sum of n chunk terms `stride` floats apart from p
// (written by other blocks: read through L2), B loads in flight
template <int B = 16>
__device__ __forceinline__ float sum_chunks(const float* p, long long stride, int n) {
  float acc = 0.f;
  for (int c0 = 0; c0 < n; c0 += B) {
    float v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = c0 + j < n ? __ldcg(p + (c0 + j) * stride) : 0.f;
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (c0 + j < n) acc = __fadd_rn(acc, v[j]);
    }
  }
  return acc;
}

// The owned units of a phase's sums, two at a time: unit u goes to block
// u % grid; consumer threads 0-127 take unit `base`, 128-255 unit base +
// grid, after thread 0 and thread 32 have waited, side by side, for each
// unit's counter (cnt_of(u)) to reach `target`.  fn(u, the thread's column
// in the unit's tile) runs in each thread of a valid unit and must not
// synchronise the block.
template <bool STAMP, typename CntOf, typename Fn>
__device__ void owned_pairs(int n_units, unsigned target, CntOf cnt_of, SumStamps<STAMP>& st,
                            Fn fn) {
  const int G = gridDim.x, half = threadIdx.x >> 7;
  for (int base = blockIdx.x; base < n_units; base += 2 * G) {
    const int u1 = base + G;
    wait_counts(cnt_of(base), target, u1 < n_units ? cnt_of(u1) : nullptr, target);
    st.waited();
    const int u = half ? u1 : base;
    if (u < n_units) fn(u, threadIdx.x & (TILE_COLS - 1));
  }
  st.done();
}

__device__ __forceinline__ bf16 bf16_add(bf16 a, bf16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// ---------------------------------------------------------------------------
// the adapter tile: int8 weights x bf16 rows on mma.sync (fp32)
// ---------------------------------------------------------------------------

// the two bytes W[k][c], W[k][c + 1] of a 128-byte-swizzled 256 x 128 tile
__device__ __forceinline__ uint32_t tile_pair(const uint8_t* tile, int k, int c) {
  return *reinterpret_cast<const uint16_t*>(tile + k * TILE_COLS +
                                            ((((c >> 4) ^ (k & 7)) << 4) | (c & 15)));
}

// The column sums of x[0 .. 8 NT) (a chunk of 256 bf16 values a row in
// shared memory, XPITCH apart, zero past the valid k) times the stage's
// int8 tile, in fp32: warp w takes columns 16 w .. 16 w + 15 as mma's A
// rows (thread (g, t): row g is column 16 w + 2 g, row g + 8 column
// 16 w + 2 g + 1, so one 16-bit load gives both of a k), widened to bf16 in
// registers (exactly), and the 16 k16 steps accumulate in order.  acc[j] =
// (column c, row 8 j + 2 t), (c, 8 j + 2 t + 1), (c + 1, 8 j + 2 t),
// (c + 1, 8 j + 2 t + 1) with c = 16 w + 2 g.
template <int NT>
__device__ __forceinline__ void adapter_tile(const uint8_t* tile, const bf16* xs,
                                             float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 16 * (threadIdx.x >> 5) + 2 * g;
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 4
  for (int ks = 0; ks < TILE_ROWS / 16; ++ks) {
    const int k = ks * 16 + 2 * t;
    const uint32_t v0 = tile_pair(tile, k, col) | (tile_pair(tile, k + 1, col) << 16);
    const uint32_t v1 = tile_pair(tile, k + 8, col) | (tile_pair(tile, k + 9, col) << 16);
    // bytes (W[k][c], W[k][c+1], W[k+1][c], W[k+1][c+1]): c's pair, then c+1's
    const uint32_t a[4] = {s8x2_to_bf16x2(v0), s8x2_to_bf16x2(v0 >> 8), s8x2_to_bf16x2(v1),
                           s8x2_to_bf16x2(v1 >> 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* xr = xs + (8 * j + g) * XPITCH + k;
      mma_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(xr),
                *reinterpret_cast<const uint32_t*>(xr + 8));
    }
  }
}

// adapter_tile's sums of rows < m to dst (the tile's first column of row 0
// of an fp32 (rows, ld) plane)
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], float* dst, long long ld,
                                           int m) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 16 * (threadIdx.x >> 5) + 2 * g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int r = 8 * j + 2 * t;
    if (r < m) *reinterpret_cast<float2*>(dst + r * ld + col) = make_float2(acc[j][0], acc[j][2]);
    if (r + 1 < m) {
      *reinterpret_cast<float2*>(dst + (r + 1) * ld + col) = make_float2(acc[j][1], acc[j][3]);
    }
  }
}

// One adapter product's items [r.lo, r.hi) of a phase over up to two
// adapters: item i of adapter a is (K chunk c, column tile t), chunk-major,
// adapter 0's first; adapter a has chunks[a] chunks of its k[a] rows and
// tiles[a] tiles of its n[a] columns.  Its activations src[a] (rows m, row
// stride ld[a]) are loaded a chunk at a time; its terms go to
// terms[a] + (c m + row) n[a] + column.  adapter_arrive then releases one
// arrival an item on cnt[a][t].
struct AdapterProduct {
  const bf16* src[2];
  long long ld[2];
  int k[2], n[2], chunks[2], tiles[2];
  float* terms[2];
  unsigned* cnt[2];
  __device__ int items() const { return chunks[0] * tiles[0] + chunks[1] * tiles[1]; }
  // (adapter, chunk, tile) of item i
  __device__ int3 item(int i) const {
    const int n0 = chunks[0] * tiles[0];
    const int a = i < n0 ? 0 : 1, j = i < n0 ? i : i - n0;
    return make_int3(a, j / tiles[a], j % tiles[a]);
  }
};

template <int NT>
__device__ void adapter_items(const AdapterProduct& P, int m, Range r, Ring& ring, bf16* xs) {
  int loaded = -1;
  for (int i = r.lo; i < r.hi; ++i) {
    const int3 it = P.item(i);
    const int key = it.x * 65536 + it.y;
    if (key != loaded) {
      csync();  // every warp is done with the chunk before
      const int k0 = it.y * TILE_ROWS;
      load_rows<TILE_ROWS, XPITCH>(xs, P.src[it.x], P.ld[it.x], m, 8 * NT, k0,
                                   min(TILE_ROWS, P.k[it.x] - k0));
      csync();
      loaded = key;
    }
    int st;
    const uint8_t* tile = ring_wait(ring, st);
    float acc[NT][4];
    adapter_tile<NT>(tile, xs, acc);
    ring_release(ring, st);
    store_tile<NT>(acc,
                   P.terms[it.x] + (long long)it.y * m * P.n[it.x] + it.z * TILE_COLS,
                   P.n[it.x], m);
  }
}

// adapter_items' arrivals, once the block's items have written their terms
__device__ __forceinline__ void adapter_arrive(const AdapterProduct& P, Range r) {
  arrive_items(r, [&P](int i) {
    const int3 it = P.item(i);
    return P.cnt[it.x] + it.z;
  });
}

// The producer's side of adapter_items: the tiles of [r.lo, r.hi) from the
// maps map0 + a (a (columns, rows, layer) int8 stack each), layer `layer`.
template <typename Emit>
__device__ void adapter_loads(const AdapterProduct& P, Range r, int map0, int layer, Emit& emit) {
  for (int i = r.lo; i < r.hi; ++i) {
    const int3 it = P.item(i);
    Load ld{};
    ld.bytes = TILE_BYTES;
    ld.add(map0 + it.x, it.z * TILE_COLS, it.y * TILE_ROWS, layer, 0);
    emit(ld);
  }
}

// ---------------------------------------------------------------------------
// the up product: a column slice over the whole K in one block
// ---------------------------------------------------------------------------

// An up item is a 32-column slice of Wu over all its rows, so the block that
// takes it adds the whole K itself, in a fixed order: no terms, counters or
// owners.  A ring stage holds 1024 rows of the slice (four 256 x 32 boxes,
// row k at 32 k bytes); the activations are h, whose rows of the stage's
// 1024 values sit in shared memory HPITCH apart.
constexpr int SLICE_COLS = 32;
constexpr int SLICE_ROWS = TILE_BYTES / SLICE_COLS;  // 1024
constexpr int SLICE_BOX = 256;
constexpr int HPITCH = SLICE_ROWS + 8;  // bf16 a row of h (2064 bytes: conflict-free B loads)

__host__ __device__ inline int slice_stages(int k) { return (k + SLICE_ROWS - 1) / SLICE_ROWS; }

// the producer's stages of one slice of an int8 (k, n) stack (map): the
// boxes wholly past k are not loaded (their rows meet zeros of h)
template <typename Emit>
__device__ void slice_loads(int map, int k, int slice, int layer, Emit& emit) {
  for (int st = 0; st < slice_stages(k); ++st) {
    const int boxes = min(4, (k - st * SLICE_ROWS + SLICE_BOX - 1) / SLICE_BOX);
    Load ld{};
    ld.bytes = boxes * SLICE_BOX * SLICE_COLS;
    for (int b = 0; b < boxes; ++b) {
      ld.add(map, slice * SLICE_COLS, st * SLICE_ROWS + b * SLICE_BOX, layer,
             b * SLICE_BOX * SLICE_COLS);
    }
    emit(ld);
  }
}

// One stage's partial sums of h rows [0, 8 NT) (shared memory, HPITCH
// apart, zero past the valid k) times the stage's 1024 x 32 slice: warp w
// takes columns 16 (w % 2) .. + 15 (A rows as adapter_tile's) over K rows
// 256 (w / 2) .. + 255, 16 k16 steps added to acc in order.
template <int NT>
__device__ __forceinline__ void slice_product(const uint8_t* tile, const bf16* hs,
                                              float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, w = threadIdx.x >> 5;
  const uint8_t* wc = tile + 16 * (w & 1) + 2 * g;
#pragma unroll 4
  for (int ks = 0; ks < 16; ++ks) {
    const int k = 256 * (w >> 1) + ks * 16 + 2 * t;
    const auto pair = [wc](int r) {
      return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(wc + r * SLICE_COLS));
    };
    const uint32_t v0 = pair(k) | (pair(k + 1) << 16);
    const uint32_t v1 = pair(k + 8) | (pair(k + 9) << 16);
    const uint32_t a[4] = {s8x2_to_bf16x2(v0), s8x2_to_bf16x2(v0 >> 8), s8x2_to_bf16x2(v1),
                           s8x2_to_bf16x2(v1 >> 8)};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const bf16* xr = hs + (8 * j + g) * HPITCH + k;
      mma_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(xr),
                *reinterpret_cast<const uint32_t*>(xr + 8));
    }
  }
}

// The four K quarters' slice_product sums, added in order (quarter 0
// first) into the acc of warps 0 and 1, which then hold, per n8 tile j,
// (column c, row 8 j + 2 t), (c, 8 j + 2 t + 1), (c + 1, 8 j + 2 t),
// (c + 1, 8 j + 2 t + 1) with c = 16 w + 2 g; returns true there.  red:
// 4 x 2 x 4 NT x 32 floats of shared memory.  Every consumer thread calls it.
template <int NT>
__device__ __forceinline__ bool slice_reduce(float (&acc)[NT][4], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, q = w >> 1, half = w & 1;
  if (q) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(((q * 2 + half) * NT + j) * 4 + e) * 32 + lane] = acc[j][e];
  }
  csync();
  if (q == 0) {
    for (int q2 = 1; q2 < 4; ++q2)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[j][e] = __fadd_rn(acc[j][e], red[(((q2 * 2 + half) * NT + j) * 4 + e) * 32 + lane]);
        }
  }
  csync();  // red is read before the next reduction overwrites it
  return q == 0;
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled over an (L, rows, cols) stack of `esize`-byte
// elements read in boxes of box_rows x box_cols of one layer, memoised on
// all of its arguments (a pure function of them): a stack's maps are
// encoded at its first launch and reused by the launches after it
inline bool stack_map(CUtensorMap* out, CUtensorMapDataType type, int esize, const void* base,
                      long long L, long long rows, long long cols, int box_rows, int box_cols,
                      CUtensorMapSwizzle swizzle) {
  struct Key {
    const void* base;
    long long L, rows, cols;
    int type, esize, box_rows, box_cols, swizzle;
  };
  constexpr int SLOTS = 256;
  static std::mutex mu;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  Key key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  key.L = L;
  key.rows = rows;
  key.cols = cols;
  key.type = (int)type;
  key.esize = esize;
  key.box_rows = box_rows;
  key.box_cols = box_cols;
  key.swizzle = (int)swizzle;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *out = maps[i];
      return true;
    }
  }
  const tma_wgmma::EncodeTiledFn fn = tma_wgmma::encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)L};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * esize), (cuuint64_t)(rows * cols * esize)};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1u};
  const cuuint32_t es[3] = {1u, 1u, 1u};
  if (fn(out, type, 3, const_cast<void*>(base), dims, strides, box, es,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % SLOTS;
  used = used < SLOTS ? used + 1 : used;
  return true;
}

// an int8 weight stack in the ring's 256 x 128 swizzled tiles
inline bool weight_map(CUtensorMap* out, const void* base, long long L, long long rows,
                       long long cols) {
  return stack_map(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, L, rows, cols, TILE_ROWS,
                   TILE_COLS, CU_TENSOR_MAP_SWIZZLE_128B);
}

// an int8 up-weight stack in the up slices' 256 x 32 boxes
inline bool slice_map(CUtensorMap* out, const void* base, long long L, long long rows,
                      long long cols) {
  return stack_map(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, L, rows, cols, SLICE_BOX,
                   SLICE_COLS, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// an fp32 (L, rows, cols) scale stack read a row of 128 at a time
inline bool scale_map(CUtensorMap* out, const void* base, long long L, long long rows,
                      long long cols) {
  return stack_map(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, L, rows, cols, 1, TILE_COLS,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

// A launch's nonce: odd, so never the zero of fresh memory, and never one
// an earlier launch of this process published
inline unsigned long long next_nonce() {
  static std::atomic<unsigned long long> seq{0};
  static const unsigned long long base =
      (unsigned long long)std::chrono::steady_clock::now().time_since_epoch().count() | 1ull;
  return base + 2ull * seq.fetch_add(1);
}

constexpr int MAX_DEVICES = 64;

// One block an SM of `kernels` (all launched with THREADS threads and
// `smem` bytes of dynamic shared memory) on the current device, or -1 where
// the device has no cooperative launch or a block does not fit; queried
// once a device and kept in cache[dev].
inline cudaError_t resident_grid(const void* const* kernels, int n_kernels, int smem,
                                 int* cache, std::mutex& mu, int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (cache[dev] == 0) {
    int sms = 0, coop = 0, fewest = 1 << 30;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    for (int i = 0; i < n_kernels && err == cudaSuccess; ++i) {
      int per_sm = 0;
      err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernels[i], THREADS, smem);
      }
      fewest = per_sm < fewest ? per_sm : fewest;
    }
    if (err != cudaSuccess) return err;
    cache[dev] = (coop && fewest > 0) ? sms : -1;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

}  // namespace stream_tiles
