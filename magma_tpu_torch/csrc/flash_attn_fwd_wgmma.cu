// Flash-attention forward for Hopper (sm_90a), the body of large launches:
// warp-specialised, wgmma fed by TMA.  bf16 in, bf16 O + fp32 lse out.
//
// Replaces: magma_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_fwd` through pl.pallas_call), as flash_attn_fwd.cu does; the wrapper
// (ops/flash_attention.py `flash_fwd_takes_wgmma`) sends a launch here when
// its grid of 128-row blocks is large (the training layers' attention) and
// to flash_attn_fwd.cu's mma.sync body when it is small (the caption
// prefill).  Same function: fp32 running max, sum and accumulator; scores
// masked with NEG_INF = -0.7 * FLT_MAX where a key is past the row's kv_len
// or (causal) after the query's global position q_offset + i; masked
// probabilities zeroed explicitly, so a fully masked row gives O = 0 and
// lse = NEG_INF; key tiles entirely above a warpgroup's diagonal or past
// kv_len are never visited; lse = m + log(max(l, 1e-30)) per row.
//
// What bounds it on an H100: at path A's layer shape (b 2, s 2048, h 16,
// hd 256, causal) the function is two products (S = Q K^T and O = P V) of
// 2 hd flops over the s (s + 1) / 2 attended pairs of each (batch, head):
// 0.0695 ms at the 989 TFLOP/s dense bf16 rate, against ~0.03 ms for its
// bytes at 3.35 TB/s.  So the tensor cores bound it, and on Hopper only
// wgmma reaches their rate.
//
// What the design does about it (FlashAttention-3's shape):
//   * One block owns 128 query rows of one (batch, head): a producer
//     warpgroup (setmaxnreg 40) and two consumer warpgroups (232) of 64 rows
//     each.  Q stays in shared memory; one producer thread streams K, a
//     second V, each through its own 2-stage ring of 80-key tiles (4-D
//     tensor maps in the 128-byte swizzle, so path B's strided v loads in
//     place; at hd 256, Q and the rings take 224 KB), each stage tracked by
//     a full mbarrier and an empty one that each consumer warp arrives at
//     once.  K_j is released once S_j is done, V_j once P_j V_j is, so a
//     stage of K refills half a step before one of V.
//   * S = Q K^T is an ss wgmma (N = 80).  The masked, exponentiated S
//     (ex2 of a log2(e)-scaled argument) is rounded pairwise to bf16 and is
//     the register A of O += P V (rs, V read MN-major from the same
//     swizzled bytes): no tile is copied or transposed.
//   * Within a warpgroup, step j queues S_j, then P_{j-1} V_{j-1} behind
//     it, and runs S_j's softmax while the PV product runs; O is rescaled
//     once that product is done.  The two warpgroups overlap each other.
//   * Only tiles that cross the diagonal or kv_len take the masked path.
//     The row max is kept over the unscaled scores (the scale is folded
//     into the exponent's fma); each thread keeps a partial row sum over
//     its own columns, added across the row's four threads at the end.
//   * Epilogue: O / l in bf16 goes to the warpgroup's Q tile, which no
//     product reads any more, and leaves by TMA stores; lse per row.
//   * Causal balance: the query blocks with the most steps launch first.
// No float atomics and a fixed order of every sum: the same bits from run
// to run, which remat's recompute relies on.
//
// Measured alone (torch.profiler, scripts/torch_tiles_ab.py, NVIDIA H100
// 80GB HBM3 at a 700 W power limit) at path A's layer shape: about 0.164
// ms, 42% of its bound (the mma.sync body 0.566 ms on the same card); at
// path B's (b 1) about 0.083 ms.  Scratch variants timed against each
// other on one card (not kept): the two warpgroups taking turns to queue
// their products (FA3's ping-pong) 17% slower; 80-key stages 3% faster
// than 64-key ones; one empty-barrier arrival a warp instead of a thread
// about 1% faster.  Copies with one part removed (wrong results, timing
// only) found the K and V loads past the first two stages worth 2% of the
// time, the O rescale 2.5%, the softmax 14% and the P V products 25%:
// the ss S products, both operands read from shared memory (about 112 of
// the 128 bytes a cycle an SM's shared memory delivers), take the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_wgmma.cuh"

using namespace tma_wgmma;
using namespace flash_wgmma;

namespace {

constexpr int ROWS = 64;     // query rows a consumer warpgroup
constexpr int WGS = 2;       // consumer warpgroups: 128 query rows a block
constexpr int KEYS = 80;     // keys a stage
constexpr int STAGES = 2;    // each of the K and V rings
constexpr int THREADS = 128 * (WGS + 1);
constexpr int CONSUMER_WARPS = 4 * WGS;  // each releases a stage by one arrival
constexpr int BAR_STORE = 1;  // 1 + warpgroup: its O tile is in shared memory

// the JAX package's constant: a double product rounded to float
#define NEG_INF_F ((float)(-0.7 * 3.4028234663852886e38))

struct FwdParams {
  CUtensorMap q, k, v;  // (hd, h, s, b) bf16, 128-byte swizzle: boxes of 64 hd x
                        // 64 rows (q) or KEYS rows (k, v)
  CUtensorMap o;        // O, contiguous (b, s_q, h, hd), boxes of 64 hd x 64 rows
  float* lse;           // (b*h, s_q)
  const int* kv_len;    // (b,) or nullptr
  int h, s_q, s_k;
  float scale;
  int causal;
  int q_offset;
};

template <int HD>
struct Fwd {
  static constexpr int QTILE = ROWS * HD * 2;  // a warpgroup's rows of Q
  static constexpr int KTILE = KEYS * HD * 2;  // a stage of K or of V
  static constexpr int K_RING = WGS * QTILE;
  static constexpr int V_RING = K_RING + STAGES * KTILE;
  static constexpr int BARS = V_RING + STAGES * KTILE;
  static constexpr int SMEM = BARS + (1 + 4 * STAGES) * 8 + 1024;
};

// 227 KB: the most shared memory a block of an H100 can have
static_assert(Fwd<256>::SMEM <= 232448, "shared memory");

// query rows [q0, q0 + 128) of (batch, head) blockIdx.x
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ FwdParams p) {
  using L = Fwd<HD>;
  constexpr int KPANEL = KEYS * ROW_BYTES;
  constexpr int NT = KEYS / 2;  // a thread's entries of a 64 x KEYS score tile
  using Keep = std::conditional_t<(NT > 32), uint64_t, uint32_t>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full_k = q_bar + 1;
  uint64_t* empty_k = full_k + STAGES;
  uint64_t* full_v = empty_k + STAGES;
  uint64_t* empty_v = full_v + STAGES;

  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // under the causal mask the last query blocks have the most steps: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (WGS * ROWS);
  const int kv_len = p.kv_len == nullptr ? p.s_k : min(p.s_k, p.kv_len[bi]);
  const int n_end = p.causal ? min(kv_len, p.q_offset + q0 + WGS * ROWS) : kv_len;
  const int steps = max(0, (n_end + KEYS - 1) / KEYS);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_k[i], CONSUMER_WARPS);
      mbar_init(&empty_v[i], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: warp 0 loads Q and K, warp 1 V
    regs_dec<40>();
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0 && warp < 2 && steps > 0) {
      if (warp == 0) {
        mbar_expect_tx(q_bar, WGS * L::QTILE);
        for (int w = 0; w < WGS; ++w)
          load_tile<HD>(smem + w * L::QTILE, &p.q, q_bar, q0 + w * ROWS, hi, bi, PANEL);
      }
      const CUtensorMap* map = warp == 0 ? &p.k : &p.v;
      uint64_t* full = warp == 0 ? full_k : full_v;
      uint64_t* empty = warp == 0 ? empty_k : empty_v;
      uint8_t* ring = smem + (warp == 0 ? L::K_RING : L::V_RING);
      for (int u = 0; u < steps; ++u) {
        const int st = u % STAGES;
        if (u >= STAGES) mbar_wait(&empty[st], ((u / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], L::KTILE);
        load_tile<HD>(ring + st * L::KTILE, map, &full[st], u * KEYS, hi, bi, KPANEL);
      }
    }
    return;
  }

  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  const int ctid = threadIdx.x & 127;
  const int lane = ctid & 31, t = lane & 3;
  const int row0 = q0 + wg * ROWS;                     // this warpgroup's rows
  const int r_lo = row0 + (ctid >> 5) * 16 + (lane >> 2);  // this thread's: r_lo, r_lo + 8
  const int pos[2] = {p.q_offset + r_lo, p.q_offset + r_lo + 8};
  // keys past this warpgroup's causal limit are all masked: skip those steps
  const int wg_steps =
      p.causal ? min(steps, (p.q_offset + row0 + ROWS + KEYS - 1) / KEYS) : steps;
  const uint8_t* sq = smem + wg * L::QTILE;
  const float sl2 = p.scale * kLog2e;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF_F, NEG_INF_F};  // running max of the unscaled, masked scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums
  uint32_t a[NT / 8][4];                // the last step's P in bf16
  if (steps > 0) mbar_wait(q_bar, 0);

  for (int u = 0; u < wg_steps; ++u) {
    const int st = u % STAGES;
    const uint8_t* sk = smem + L::K_RING + st * L::KTILE;
    float s[NT];
    mbar_wait(&full_k[st], (u / STAGES) & 1);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<KEYS>::ss(s, kmajor(sq, kk, PANEL), kmajor(sk, kk, KPANEL), kk > 0);
    wgmma_commit();
    if (u > 0) {
      // O += P V of the last step, queued behind S
      const int sp = (u - 1) % STAGES;
      mbar_wait(&full_v[sp], ((u - 1) / STAGES) & 1);
      const uint8_t* sv = smem + L::V_RING + sp * L::KTILE;
#pragma unroll
      for (int kk = 0; kk < NT / 8; ++kk)
        Wgmma<HD>::template rs<1>(acc, a[kk], sw128_desc_mn(sv + kk * 2048, KPANEL));
      wgmma_commit();
      fence_acc(acc);
      fence_regs(a);
      wgmma_wait<1>();  // S is done; P V may still run
    } else {
      wgmma_wait<0>();
    }
    fence_acc(s);
    if (lane == 0) mbar_arrive(&empty_k[st]);  // the warp's S products are done

    // mask (only a tile that crosses the diagonal or kv_len), row max
    const int n0 = u * KEYS;
    const bool inside =
        n0 + KEYS <= kv_len && (!p.causal || n0 + KEYS - 1 <= p.q_offset + row0);
    Keep keep = ~Keep(0);  // bit i: score s[i] is attendable
    float mx[2] = {m[0], m[1]};
    if (!inside) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = col < kv_len && (!p.causal || col <= pos[(i >> 1) & 1]);
        if (!ok) {
          keep &= ~(Keep(1) << i);
          s[i] = NEG_INF_F;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // the old max's weight; 1 while a row has seen only masked keys
      alpha[r] = exp2_approx((m[r] - mx[r]) * sl2);
      m[r] = mx[r];
      ms[r] = mx[r] * sl2;
    }
    // P = exp(scale (S - m)), masked entries zeroed: a row that has seen
    // only masked keys would otherwise weigh them 1
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float e = exp2_approx(fmaf(s[i], sl2, -ms[(i >> 1) & 1]));
      s[i] = (keep >> i) & 1 ? e : 0.f;
      sum[(i >> 1) & 1] += s[i];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
    if (u > 0) {
      wgmma_wait<0>();  // the last step's P V is done with V and with A
      fence_acc(acc);
      fence_regs(a);
      if (lane == 0) mbar_arrive(&empty_v[(u - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    acc_to_a<NT>(a, s);
  }
  if (wg_steps > 0) {
    const int sp = (wg_steps - 1) % STAGES;
    mbar_wait(&full_v[sp], ((wg_steps - 1) / STAGES) & 1);
    const uint8_t* sv = smem + L::V_RING + sp * L::KTILE;
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < NT / 8; ++kk)
      Wgmma<HD>::template rs<1>(acc, a[kk], sw128_desc_mn(sv + kk * 2048, KPANEL));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty_v[sp]);
  }
  // the block's steps past this warpgroup's causal limit: release their stages
  for (int u = wg_steps; u < steps; ++u) {
    const int st = u % STAGES;
    mbar_wait(&full_k[st], (u / STAGES) & 1);
    if (lane == 0) mbar_arrive(&empty_k[st]);
    mbar_wait(&full_v[st], (u / STAGES) & 1);
    if (lane == 0) mbar_arrive(&empty_v[st]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] == 0.f ? 1.f : 1.f / l[r];
    const int row = r_lo + 8 * r;
    if (t == 0 && row < p.s_q) {
      // a fully masked row: the plain version's NEG_INF + log(1e-30)
      p.lse[(long long)bh * p.s_q + row] =
          (l[r] == 0.f ? NEG_INF_F : m[r] * p.scale) + logf(fmaxf(l[r], 1e-30f));
    }
  }
  if (row0 < p.s_q) {  // a warpgroup past the last query row has nothing to store
    store_tile<HD>(&p.o, smem + wg * L::QTILE, acc, inv[0], inv[1], row0, hi, bi, ctid,
                   BAR_STORE + wg);
  }
}

template <int HD>
cudaError_t launch(const FwdParams& p, int bh, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, (p.s_q + WGS * ROWS - 1) / (WGS * ROWS));
  flash_fwd_wgmma_kernel<HD><<<grid, THREADS, Fwd<HD>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Returns a cudaError_t (0 on success), or -1 when a
// tensor map cannot be encoded.  strides: the (b, s, h) element strides of
// q, k and v, 9 values, each a multiple of 8; every base 16-byte aligned;
// o contiguous (b, s_q, h, hd).
extern "C" int magma_flash_attn_fwd_wgmma(const void* q, const void* k, const void* v, void* o,
                                          float* lse, const int* kv_len, int b, int h, int s_q,
                                          int s_k, int hd, const long long* st, float scale,
                                          int causal, int q_offset, void* stream) {
  if (hd != 128 && hd != 256) return (int)cudaErrorInvalidValue;
  FwdParams p;
  const long long os = (long long)h * hd;  // O's s stride
  if (!encode_bshd(&p.q, q, b, s_q, h, hd, st[0], st[1], st[2], ROWS) ||
      !encode_bshd(&p.k, k, b, s_k, h, hd, st[3], st[4], st[5], KEYS) ||
      !encode_bshd(&p.v, v, b, s_k, h, hd, st[6], st[7], st[8], KEYS) ||
      !encode_bshd(&p.o, o, b, s_q, h, hd, s_q * os, os, hd, ROWS)) {
    return -1;
  }
  p.lse = lse;
  p.kv_len = kv_len;
  p.h = h;
  p.s_q = s_q;
  p.s_k = s_k;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(hd == 128 ? launch<128>(p, b * h, s) : launch<256>(p, b * h, s));
}
