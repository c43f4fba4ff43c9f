// The int8 bottleneck adapter in one launch, for Hopper (sm_90a):
//   h   = relu((x @ Wd) * sd + bd), rounded to bf16
//   out = (h @ Wu) * su + bu                                   (fp32)
// for x (m, D) bf16 with m <= 64, Wd (D, DH) and Wu (DH, D) int8, per-column
// fp32 scales and biases (the scaled_parallel scalar is already folded into
// su and bu).
//
// Replaces: magma_tpu/ops/quant.py `_fused_adapter_kernel` (launched by
// `fused_adapter_stacked` for m <= 64), which runs the down product, the
// bias/relu epilogue and the up product as one Pallas grid with h in VMEM.
// The rounding of h to bf16 before the up product is the Pallas kernel's
// (`h_ref[...].astype(bf16)`, quant.py:843).
//
// What bounds it on an H100 SXM: at the v1 6B adapter (D = 4096, DH = 1024)
// it reads 8.4 MB of int8 weights whatever m is, 2.5 us at 3.35 TB/s; the
// operations (2 * m * 2 * D * DH, 1.1 GFLOP at m = 64) take 1.1 us at the
// bf16 tensor-core rate.  So the bytes, and in practice the launch, the
// one grid barrier and the latency of the phases' sums.
//
// What the design does about it (the pipeline of stream_tiles.cuh, which
// K6's adapter phases share): one cooperative launch, one block an SM, a
// producer warp and eight consumer warps, and each weight tile read from
// HBM once, whatever m is.  The down product is cut into items of 256 K
// rows x 128 columns, D/256 = 16 chunks x DH/128 = 8 tiles = 128 items; the
// chunks' fp32 partials go to scratch, and the block that owns a (column
// tile, row) adds them in chunk order once the tile's counter says they are
// in: h.  One grid barrier.  The up product is cut into 32-column slices
// over all of DH, D/32 = 128 items: a block adds its slice's K itself
// (four warp pairs a quarter each, added in order) and writes out.  So each
// block streams one 32 KB tile of each product: the producer issues the
// down tile at the launch's start and the up tile as soon as the down one
// has landed (the down tiles first take the whole of HBM), so the up
// weights are in shared memory before h is.  The products are mma.sync over
// all rows at once (m padded to 8, 16, 32 or 64; the up product takes 16
// rows of h at a time), the int8 weight widened to bf16 exactly in
// registers.  No float atomics: the same bits on a repeat.  Against the plain version (fp32
// matmuls) only the order of the fp32 sums differs.  STAMP builds write a
// %globaltimer stamp at each phase's start and end per block (measurement
// only, never on the main path).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "stream_tiles.cuh"

namespace {

using namespace stream_tiles;
using tma_wgmma::align_1024;
using tma_wgmma::fence_barrier_init;

constexpr int MAX_ROWS = 64;
constexpr int N_PHASES = 3;  // the stamps' phases (ops/quant.py ADAPTER_PHASES)
constexpr int UP_ROWS = 16;  // rows of h an up pass takes
enum Map { M_WD, M_WU, N_MAPS };
enum Phase { P_DOWN, P_DOWN_SUMS, P_UP };

// shared memory, after the 1024-byte alignment of the dynamic base: the
// down product's x chunk ([64][XPITCH]) or the up product's h rows
// ([16][HPITCH]), then the up product's K-quarter sums
constexpr int XS_BYTES = MAX_ROWS * XPITCH * 2 > UP_ROWS * HPITCH * 2 ? MAX_ROWS * XPITCH * 2
                                                                      : UP_ROWS * HPITCH * 2;
constexpr int OFF_XS = RING_BYTES;
constexpr int OFF_RED = OFF_XS + XS_BYTES;                 // fp32 [4][2][8][32]
constexpr int OFF_BARS = OFF_RED + 4 * 2 * 8 * 32 * 4;     // full[STAGES], empty[STAGES]
constexpr int SMEM_BYTES = OFF_BARS + 2 * STAGES * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "the ring must fit in shared memory");

struct Params {
  CUtensorMap maps[N_MAPS];  // Wd (L, d, dh), Wu (L, dh, d) in the ring's tiles
  int m, d, dh, layer;
  const bf16* x;                     // (m, d)
  const float *sd, *bd, *su, *bu;    // the layer's rows: (dh,), (dh,), (d,), (d,)
  bf16* h;                           // (m, dh) scratch
  float* terms;                      // the chunks' partials, one phase at a time
  float* out;                        // (m, d)
  unsigned long long* flag;          // the launch's nonce, then
  unsigned* counters;                // [barrier, down tiles (dh / 128)]
  unsigned long long nonce;
  unsigned long long* stamps;        // STAMP: (grid, N_PHASES, 2)
};

__device__ __forceinline__ int chunks(int k) { return (k + TILE_ROWS - 1) / TILE_ROWS; }

// the two products over one adapter
__device__ __forceinline__ AdapterProduct down_product(const Params& p) {
  AdapterProduct P{};
  P.src[0] = p.x;
  P.ld[0] = p.d;
  P.k[0] = p.d;
  P.n[0] = p.dh;
  P.chunks[0] = chunks(p.d);
  P.tiles[0] = p.dh / TILE_COLS;
  P.terms[0] = p.terms;
  P.cnt[0] = p.counters + 1;
  return P;
}

// the up product's slices [r.lo, r.hi): out = (h @ Wu[:, slice]) * su + bu,
// h in passes of 8 NT rows (16 at most) against each stage of the slice
template <int NT>
__device__ void up_slices(const Params& p, Range r, Ring& ring, bf16* hs, float* red) {
  constexpr int R = 8 * NT;  // rows a pass
  const int m = p.m, passes = (m + R - 1) / R, stages = slice_stages(p.dh);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = 16 * ((threadIdx.x >> 5) & 1) + 2 * g;
  for (int sl = r.lo; sl < r.hi; ++sl) {
    float acc[MAX_ROWS / R][NT][4];
#pragma unroll
    for (int i = 0; i < MAX_ROWS / R; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    for (int st = 0; st < stages; ++st) {
      int stg;
      const uint8_t* tile = ring_wait(ring, stg);
#pragma unroll
      for (int i = 0; i < MAX_ROWS / R; ++i) {
        if (i >= passes) break;
        csync();  // every warp is done with the rows before
        const int k0 = st * SLICE_ROWS;
        load_rows<SLICE_ROWS, HPITCH>(hs, p.h + (long long)i * R * p.dh, p.dh, m - i * R, R, k0,
                                      min(SLICE_ROWS, p.dh - k0));
        csync();
        slice_product<NT>(tile, hs, acc[i]);
      }
      ring_release(ring, stg);
    }
    const int c = sl * SLICE_COLS + col;
#pragma unroll
    for (int i = 0; i < MAX_ROWS / R; ++i) {
      if (i >= passes) break;
      if (!slice_reduce<NT>(acc[i], red)) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int row = i * R + 8 * j + 2 * t;
        for (int e = 0; e < 2; ++e) {
          if (row + e < m) {
            *reinterpret_cast<float2*>(p.out + (long long)(row + e) * p.d + c) =
                make_float2(acc[i][j][e] * p.su[c] + p.bu[c],
                            acc[i][j][2 + e] * p.su[c + 1] + p.bu[c + 1]);
          }
        }
      }
    }
  }
}

template <int NT, bool STAMP>
__global__ void __launch_bounds__(THREADS, 1)
    fused_adapter_kernel(const __grid_constant__ Params p) {
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
  const AdapterProduct dn = down_product(p);
  const Range r_dn = block_range(dn.items()), r_up = block_range(p.d / SLICE_COLS);
  if (threadIdx.x >= CONSUMERS) {  // the producer: both phases' tiles, the down ones first
    if (threadIdx.x == CONSUMERS) {
      Producer emit{smem, full, empty, p.maps, 0u, evict_first_policy()};
      for (int i = 0; i < N_MAPS; ++i) prefetch_map(&p.maps[i]);
      adapter_loads(dn, r_dn, M_WD, p.layer, emit);
      emit.drain();
      for (int sl = r_up.lo; sl < r_up.hi; ++sl) slice_loads(M_WU, p.dh, sl, p.layer, emit);
    }
    return;
  }
  const int n_counters = 1 + p.dh / TILE_COLS;
  if (blockIdx.x == 0) open_counters(p.counters, n_counters, p.flag, p.nonce);
  Ring ring{smem, full, empty, 0u};
  bf16* xs = reinterpret_cast<bf16*>(smem + OFF_XS);
  const int m = p.m;

  // down: the items, then h = bf16(relu(sum * sd + bd)) of the owned units
  stamp<STAMP>(p.stamps, N_PHASES, P_DOWN, 0);
  adapter_items<NT>(dn, m, r_dn, ring, xs);
  stamp<STAMP>(p.stamps, N_PHASES, P_DOWN, 1);
  open_wait(p.flag, p.nonce);
  adapter_arrive(dn, r_dn);
  {  // the owned (tile, row) units: unit u = tile m + row
    SumStamps<STAMP> st{p.stamps, N_PHASES, P_DOWN_SUMS, false};
    const unsigned* cnt = dn.cnt[0];
    owned_pairs(dn.tiles[0] * m, dn.chunks[0], [cnt, m](int u) { return cnt + u / m; }, st,
                [&](int u, int j) {
      const int row = u % m, col = (u / m) * TILE_COLS + j;
      const float z = sum_chunks(p.terms + (long long)row * p.dh + col, (long long)m * p.dh,
                                 dn.chunks[0]);
      p.h[(long long)row * p.dh + col] =
          __float2bfloat16_rn(fmaxf(z * p.sd[col] + p.bd[col], 0.f));
    });
  }
  unsigned epoch = 0;
  grid_barrier(p.counters, epoch);  // all of h is written; the terms are read

  // up: the slices (their tiles already in the ring), out
  stamp<STAMP>(p.stamps, N_PHASES, P_UP, 0);
  up_slices<NT == 1 ? 1 : 2>(p, r_up, ring, xs, reinterpret_cast<float*>(smem + OFF_RED));
  stamp<STAMP>(p.stamps, N_PHASES, P_UP, 1);
}

// by the rows' n8 tiles (1, 2, 4, 8), then the same stamped
const void* const KERNELS[] = {
    reinterpret_cast<const void*>(fused_adapter_kernel<1, false>),
    reinterpret_cast<const void*>(fused_adapter_kernel<2, false>),
    reinterpret_cast<const void*>(fused_adapter_kernel<4, false>),
    reinterpret_cast<const void*>(fused_adapter_kernel<8, false>),
    reinterpret_cast<const void*>(fused_adapter_kernel<1, true>),
    reinterpret_cast<const void*>(fused_adapter_kernel<2, true>),
    reinterpret_cast<const void*>(fused_adapter_kernel<4, true>),
    reinterpret_cast<const void*>(fused_adapter_kernel<8, true>)};

// the scratch's layout at (m, d, dh): the nonce and the counters, the down
// product's chunk terms, h; byte offsets (ops/quant.py
// `adapter_scratch_bytes` mirrors it)
struct Layout {
  long long terms, h, bytes;
};

Layout layout(int m, int d, int dh) {
  const long long counters = 1 + dh / TILE_COLS;
  const long long terms = (long long)(d + TILE_ROWS - 1) / TILE_ROWS * m * dh;
  Layout L;
  L.terms = (8 + 4 * counters + 255) / 256 * 256;
  L.h = L.terms + (4 * terms + 255) / 256 * 256;
  L.bytes = L.h + 2ll * m * dh;
  return L;
}

}  // namespace

// C entry for ctypes: x (m, d) bf16 contiguous, 1 <= m <= 64; wd (L, d, dh)
// and wu (L, dh, d) int8 stacks, contiguous, of which layer `layer` runs;
// sd, bd (dh,) and su, bu (d,) fp32 (the layer's rows); out (m, d) fp32;
// scratch_bytes of scratch, 256-byte aligned, at least the layout's; d and
// dh multiples of 128; stamps null, or for the stamped
// build, (grid, 3, 2) int64.  Returns a cudaError_t (0 on success).
extern "C" int magma_fused_adapter(const void* x, const void* wd, const float* sd,
                                   const float* bd, const void* wu, const float* su,
                                   const float* bu, void* scratch, long long scratch_bytes,
                                   float* out, int m, int d, int dh, int layers, int layer,
                                   void* stamps, void* stream) {
  if (m < 1 || m > MAX_ROWS || d <= 0 || dh <= 0 || d % TILE_COLS || dh % TILE_COLS ||
      layers < 1 || layer < 0 || layer >= layers ||
      reinterpret_cast<uintptr_t>(scratch) % 256 || scratch_bytes < layout(m, d, dh).bytes) {
    return (int)cudaErrorInvalidValue;
  }
  static int cache[MAX_DEVICES] = {};
  static std::mutex mu;
  int grid = 0;
  cudaError_t err = resident_grid(KERNELS, 8, SMEM_BYTES, cache, mu, &grid);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params p;
  memset(&p, 0, sizeof(p));
  if (!weight_map(&p.maps[M_WD], wd, layers, d, dh) ||
      !slice_map(&p.maps[M_WU], wu, layers, dh, d)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout(m, d, dh);
  uint8_t* s = static_cast<uint8_t*>(scratch);
  p.flag = reinterpret_cast<unsigned long long*>(s);
  p.counters = reinterpret_cast<unsigned*>(s + 8);
  p.terms = reinterpret_cast<float*>(s + L.terms);
  p.h = reinterpret_cast<bf16*>(s + L.h);
  p.m = m;
  p.d = d;
  p.dh = dh;
  p.layer = layer;
  p.x = static_cast<const bf16*>(x);
  p.sd = sd;
  p.bd = bd;
  p.su = su;
  p.bu = bu;
  p.out = out;
  p.nonce = next_nonce();
  p.stamps = static_cast<unsigned long long*>(stamps);
  void* args[] = {&p};
  const int nt = (m <= 8 ? 0 : m <= 16 ? 1 : m <= 32 ? 2 : 3) + (stamps ? 4 : 0);
  err = cudaLaunchCooperativeKernel(KERNELS[nt], dim3(grid), dim3(THREADS), args, SMEM_BYTES,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grid K5 launches on the current device, in *blocks (for the stamps'
// buffer).  Returns a cudaError_t.
extern "C" int magma_fused_adapter_grid(int* blocks) {
  static int cache[MAX_DEVICES] = {};
  static std::mutex mu;
  return (int)resident_grid(KERNELS, 8, SMEM_BYTES, cache, mu, blocks);
}
