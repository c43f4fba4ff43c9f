// Flash-attention backward for Hopper (sm_90a): K9a (dK, dV) and K9b (dQ).
//
// Replaces: magma_tpu/ops/flash_attention.py `_bwd_dkv_kernel` (K9a) and
// `_bwd_dq_kernel` (K9b), both launched by `_bwd` through pl.pallas_call:
// the custom VJP of the flash attention that every GPT-J layer's training
// forward runs.  Same function, from the forward's saved lse and
// di = rowsum(O * dO) (computed before the launch, as the JAX package
// does outside Pallas):
//   P  = exp(S * scale - lse), masked entries zeroed (a fully masked row,
//        whose lse is ~NEG_INF, gives finite zero gradients);
//   dV = P^T dO;  dP = dO V^T;  dS = P (dP - di);
//   dK = scale dS^T Q;  dQ = scale dS K.
// The masks are the forward's: a key past the row's kv_len, or (causal)
// after the query's global position q_offset + i; key tiles above the
// diagonal or past kv_len are never visited.
//
// What bounds it on an H100: at the training shape (b*h = 32, s = 2048,
// hd = 256, causal) K9a's function is 4 products (S, dP, dV, dK) and K9b's
// 3 (S, dP, dQ) of 2 hd flops over the s (s + 1) / 2 attended pairs of a
// (batch, head): 0.139 and 0.104 ms at the 989 TFLOP/s dense bf16 rate,
// against ~0.03 ms for their bytes at 3.35 TB/s.  So the tensor cores bound
// it, and on Hopper only wgmma reaches their rate.
//
// What the design does about it.  Both kernels are warp-specialised: one
// producer thread keeps TMA loads in flight (4-D (hd, h, s, b) tensor maps,
// so strided views such as path B's v load as they are; each 64-row tile
// is hd / 64 boxes of 64 x 64 bf16 in the 128-byte swizzle), two consumer
// warpgroups run wgmma (setmaxnreg: producer 40 registers, consumers 232).
// The same swizzled bytes serve two products: a tile is B K-major in X Y^T
// (ss, A from shared memory) and B MN-major (trans-b) in P Y (rs), so no
// tile is copied or transposed.  The fp32 accumulator of S (or S^T),
// masked and exponentiated (ex2 of a log2 e-scaled argument), is rounded
// pairwise to bf16 and is then the register A of the next product, as in
// FlashAttention-3.  P and dS are rounded to bf16 only for the tensor
// cores; dS = P (dP - di) uses the fp32 P.
//   * K9a: a block owns 64 keys of one (batch, head); K and V stay in
//     shared memory, a 2-stage ring brings 64 query rows of Q and dO a step
//     (a second producer warp copies their lse, di, read a step ahead).
//     Consumer warpgroup 0: S^T = K Q^T (ss, N = 64), P^T, handed in fp32
//     through an exchange tile, dV += P^T dO (rs, N = hd).  Warpgroup 1:
//     dP^T = V dO^T (ss), waits for P^T at a named barrier, dS^T, dK +=
//     dS^T Q (rs, N = hd).  Each holds one 64 x hd fp32 accumulator: 4
//     products, Q and dO read once a block.  A step's rs product is waited
//     for only after the next step's ss product is queued behind it.
//   * K9b: a block owns 128 query rows, 64 a consumer warpgroup; Q and dO
//     stay in shared memory, a 2-stage ring brings 48 keys of K and V a
//     step.  S = Q K^T and dP = dO V^T (ss, N = 48, both queued before
//     either is waited for), dS, dQ += dS K (rs, N = hd).  A warpgroup
//     skips the steps its causal rows cannot see.
//   * Epilogue: the accumulator, in bf16, goes to a tile of shared memory
//     that no product reads any more and leaves by TMA stores.
//   * Causal balance: key blocks (K9a) and query blocks (K9b) with the most
//     steps are launched first.
// Each output element is summed by one thread in a fixed order: no float
// atomics, the gradients are the same bits from run to run.
//
// Measured alone (torch.profiler, scripts/torch_tiles_ab.py, NVIDIA H100
// 80GB HBM3 at a 700 W power limit) at path A's layer shape: K9a 0.369 ms
// (38% of its bound; the mma.sync kernel it replaces 1.052 ms in the same
// run), K9b 0.222 ms (47%; was 0.616).  Scratch copies with one part
// removed at a time (not kept) found the exponentials and the TMA loads
// nearly free, and the ss products the largest part: by count an ss
// product at N = 64 needs about the 128 bytes of shared memory a cycle that
// the SM delivers (more at smaller N: K9b's 48-key step beat a 32-key one
// with 3 stages), and within a warpgroup each product waits for the one
// before.  Tried and not kept: one 64-row warpgroup with 64-key stages for
// K9b and K9b's rs product waited for behind the next step's ss products
// (both slower), a second exchange tile for K9a and (b, h)-major block
// order (no clear gain).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

using namespace tma_wgmma;
using namespace flash_wgmma;

namespace {

constexpr int BLK = 64;        // K9a: keys a block, query rows a step; K9b: rows a warpgroup
constexpr int STAGES = 2;       // K9a's ring
constexpr int DKV_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;
constexpr int DQ_WGS = 2;        // K9b: consumer warpgroups (64 query rows each)
constexpr int DQ_KEYS = 48;      // K9b: keys a step
constexpr int DQ_STAGES = 2;     // K9b's ring
constexpr int DQ_THREADS = 128 * (DQ_WGS + 1);
constexpr int BAR_READY = 2;     // K9a: P^T is in the exchange tile
constexpr int BAR_FREE = 3;      // K9a: the exchange tile has been read
constexpr int BAR_DONE = 4;      // K9a: both warpgroups are done with K and V
constexpr int BAR_STORE = 5;     // 5 + warpgroup: its output tile is in shared memory

struct BwdParams {
  CUtensorMap q, k, v, dout;  // (hd, h, s, b) bf16, boxes of 64 hd x rows, 128-byte swizzle
  CUtensorMap o0, o1;         // the outputs, contiguous, boxes of 64 x 64: dK, dV or dQ
  const float* lse;           // (b*h, s_q)
  const float* di;            // (b*h, s_q)
  const int* kv_len;          // (b,) or nullptr
  int h, s_q, s_k;
  float scale;
  int causal;
  int q_offset;
};

template <int HD>
struct Dkv {
  static constexpr int TILE = BLK * HD * 2;  // 64 rows of hd
  static constexpr int XCHG = 6 * TILE;      // K, V, 2 x (Q, dO), then P^T in fp32
  static constexpr int LSE = XCHG + BLK * BLK * 4;
  static constexpr int BARS = LSE + 2 * STAGES * BLK * 4;
  static constexpr int SMEM = BARS + (2 * STAGES + 1) * 8 + 1024;
};

template <int HD>
struct Dq {
  static constexpr int TILE = BLK * HD * 2;
  static constexpr int KTILE = DQ_KEYS * HD * 2;
  static constexpr int RING = 2 * DQ_WGS * TILE;  // Q, dO of the block's rows, then the ring
  static constexpr int BARS = RING + DQ_STAGES * 2 * KTILE;
  static constexpr int SMEM = BARS + (2 * DQ_STAGES + 1) * 8 + 1024;
};

// 227 KB: the most shared memory a block of an H100 can have
static_assert(Dkv<256>::SMEM <= 232448 && Dq<256>::SMEM <= 232448, "shared memory");

__device__ __forceinline__ int kv_len_of(const BwdParams& p, int bi) {
  return p.kv_len == nullptr ? p.s_k : min(p.s_k, p.kv_len[bi]);
}

// K9a: keys [n0, n0 + 64) of (batch, head) blockIdx.x
template <int HD>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ BwdParams p) {
  using L = Dkv<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  float* xchg = reinterpret_cast<float*>(smem + L::XCHG);
  float* s_lse = reinterpret_cast<float*>(smem + L::LSE);  // [STAGES][BLK]
  float* s_di = s_lse + STAGES * BLK;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_bar = empty + STAGES;

  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  const int n0 = blockIdx.y * BLK;  // causal: the first key blocks have the most steps
  const int kv_len = kv_len_of(p, bi);
  // the first query block that sees key n0 (causal); no query sees keys past kv_len
  const int m_begin = p.causal ? max(0, n0 - p.q_offset) / BLK * BLK : 0;
  const int steps = n0 < kv_len ? max(0, (p.s_q - m_begin + BLK - 1) / BLK) : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1 + 32);  // the TMA thread's arrival and the lse/di warp's
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_init(kv_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<40>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0 && lane == 0 && steps > 0) {
      mbar_expect_tx(kv_bar, 2 * L::TILE);
      load_tile<HD>(smem, &p.k, kv_bar, n0, hi, bi, PANEL);
      load_tile<HD>(smem + L::TILE, &p.v, kv_bar, n0, hi, bi, PANEL);
      for (int u = 0; u < steps; ++u) {
        const int st = u % STAGES;
        if (u >= STAGES) mbar_wait(&empty[st], ((u / STAGES) & 1) ^ 1);
        uint8_t* sq = smem + (2 + 2 * st) * L::TILE;
        const int m0 = m_begin + u * BLK;
        mbar_expect_tx(&full[st], 2 * L::TILE);
        load_tile<HD>(sq, &p.q, &full[st], m0, hi, bi, PANEL);
        load_tile<HD>(sq + L::TILE, &p.dout, &full[st], m0, hi, bi, PANEL);
      }
    } else if (warp == 1) {
      // lse (times log2 e) and di of the step's rows, lanes r and r + 32; the
      // next step's are read while this one waits for its stage
      float l[2], d[2];
      auto read = [&](int u) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = m_begin + u * BLK + lane + 32 * i;
          const long long at = (long long)bh * p.s_q + row;
          l[i] = row < p.s_q ? p.lse[at] * kLog2e : 0.f;
          d[i] = row < p.s_q ? p.di[at] : 0.f;
        }
      };
      if (steps > 0) read(0);
      for (int u = 0; u < steps; ++u) {
        const int st = u % STAGES;
        if (u >= STAGES) mbar_wait(&empty[st], ((u / STAGES) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s_lse[st * BLK + lane + 32 * i] = l[i];
          s_di[st * BLK + lane + 32 * i] = d[i];
        }
        mbar_arrive(&full[st]);
        if (u + 1 < steps) read(u + 1);
      }
    }
    return;
  }

  // consumer warpgroups: wg 0 accumulates dV, wg 1 dK
  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  const int ctid = threadIdx.x & 127;
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int key0 = n0 + (ctid >> 5) * 16 + g;  // this thread's keys: key0, key0 + 8
  const uint8_t* s_a = smem + wg * L::TILE;    // K (S^T) or V (dP^T)
  const float scale_log2 = p.scale * kLog2e;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];  // P^T or dS^T in bf16: the register A of the step's rs product
  if (steps > 0) mbar_wait(kv_bar, 0);

  for (int u = 0; u < steps; ++u) {
    const int st = u % STAGES;
    const int m0 = m_begin + u * BLK;
    const uint8_t* sq = smem + (2 + 2 * st) * L::TILE;
    const uint8_t* so = sq + L::TILE;
    mbar_wait(&full[st], (u / STAGES) & 1);
    // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1): 64 keys x 64 queries
    float x[32];
    const uint8_t* s_y = wg == 0 ? sq : so;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<64>::ss(x, kmajor(s_a, kk, PANEL), kmajor(s_y, kk, PANEL), kk > 0);
    wgmma_commit();
    if (u > 0) {
      // the last step's rs product, queued before this one, is done with its
      // stage and with A's registers
      wgmma_wait<1>();
      fence_acc(acc);
      fence_regs(a);
      mbar_arrive(&empty[(u - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(x);
    const float* lse = s_lse + st * BLK;
    const float* di = s_di + st * BLK;
    if (wg == 0) {
      // P^T, masked entries zeroed (none in a tile inside every mask); then
      // handed to wg 1 in fp32
      const bool inside = n0 + BLK <= kv_len && m0 + BLK <= p.s_q &&
                          (!p.causal || n0 + BLK - 1 <= p.q_offset + m0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + 2 * t + (i & 1);
        const int qi = m0 + col;
        const int kj = key0 + 8 * ((i >> 1) & 1);
        const bool ok =
            inside || (kj < kv_len && qi < p.s_q && (!p.causal || kj <= p.q_offset + qi));
        x[i] = ok ? exp2_approx(fmaf(x[i], scale_log2, -lse[col])) : 0.f;
      }
      if (u > 0) bar_sync(BAR_FREE, CONSUMERS);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        reinterpret_cast<float4*>(xchg)[j * 128 + ctid] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      bar_arrive(BAR_READY, CONSUMERS);
    } else {
      // dS^T = P^T (dP^T - di)
      bar_sync(BAR_READY, CONSUMERS);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pt = reinterpret_cast<const float4*>(xchg)[j * 128 + ctid];
        const float2 d = *reinterpret_cast<const float2*>(di + 8 * j + 2 * t);
        x[4 * j] = pt.x * (x[4 * j] - d.x);
        x[4 * j + 1] = pt.y * (x[4 * j + 1] - d.y);
        x[4 * j + 2] = pt.z * (x[4 * j + 2] - d.x);
        x[4 * j + 3] = pt.w * (x[4 * j + 3] - d.y);
      }
      if (u + 1 < steps) bar_arrive(BAR_FREE, CONSUMERS);
    }
    acc_to_a<32>(a, x);
    // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1), B MN-major
    const uint8_t* s_b = wg == 0 ? so : sq;
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<HD>::template rs<1>(acc, a[kk], sw128_desc_mn(s_b + kk * 2048, PANEL));
    wgmma_commit();  // waited for after the next step's first product is queued
    fence_acc(acc);
    fence_regs(a);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  // dV (wg 0) into K's tile, dK (wg 1) into V's, once neither is read
  bar_sync(BAR_DONE, CONSUMERS);
  const float mul = wg == 0 ? 1.f : p.scale;
  store_tile<HD>(wg == 0 ? &p.o1 : &p.o0, smem + wg * L::TILE, acc, mul, mul, n0, hi, bi, ctid,
                 BAR_STORE + wg);
}

// K9b: query rows [q0, q0 + 128) of (batch, head) blockIdx.x
template <int HD>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ BwdParams p) {
  using L = Dq<HD>;
  constexpr int KPANEL = DQ_KEYS * ROW_BYTES;
  constexpr int NT = DQ_KEYS / 2;  // accumulators of a 64 x DQ_KEYS tile a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + DQ_STAGES;
  uint64_t* q_bar = empty + DQ_STAGES;

  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // under the causal mask the last query blocks have the most steps: first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (DQ_WGS * BLK);
  const int kv_len = kv_len_of(p, bi);
  const int n_end = p.causal ? min(kv_len, p.q_offset + q0 + DQ_WGS * BLK) : kv_len;
  const int steps = max(0, (n_end + DQ_KEYS - 1) / DQ_KEYS);

  if (threadIdx.x == 0) {
    for (int i = 0; i < DQ_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], DQ_WGS * 128);
    }
    mbar_init(q_bar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0 && steps > 0) {
      mbar_expect_tx(q_bar, 2 * DQ_WGS * L::TILE);
      for (int w = 0; w < DQ_WGS; ++w) {
        load_tile<HD>(smem + w * L::TILE, &p.q, q_bar, q0 + w * BLK, hi, bi, PANEL);
        load_tile<HD>(smem + (DQ_WGS + w) * L::TILE, &p.dout, q_bar, q0 + w * BLK, hi, bi, PANEL);
      }
      for (int u = 0; u < steps; ++u) {
        const int st = u % DQ_STAGES;
        if (u >= DQ_STAGES) mbar_wait(&empty[st], ((u / DQ_STAGES) & 1) ^ 1);
        uint8_t* sk = smem + L::RING + st * 2 * L::KTILE;
        mbar_expect_tx(&full[st], 2 * L::KTILE);
        load_tile<HD>(sk, &p.k, &full[st], u * DQ_KEYS, hi, bi, KPANEL);
        load_tile<HD>(sk + L::KTILE, &p.v, &full[st], u * DQ_KEYS, hi, bi, KPANEL);
      }
    }
    return;
  }

  regs_inc<232>();
  const int wg = (threadIdx.x >> 7) - 1;
  const int ctid = threadIdx.x & 127;
  const int lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * BLK;  // this warpgroup's rows
  const int row[2] = {row0 + (ctid >> 5) * 16 + g, row0 + (ctid >> 5) * 16 + g + 8};
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < p.s_q;
    lse[r] = ok ? p.lse[(long long)bh * p.s_q + row[r]] * kLog2e : 0.f;
    di[r] = ok ? p.di[(long long)bh * p.s_q + row[r]] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;
  // keys past this warpgroup's causal limit are all masked: skip those steps
  const int wg_steps = p.causal ? min(steps, (p.q_offset + row0 + BLK + DQ_KEYS - 1) / DQ_KEYS)
                                : steps;
  const uint8_t* sq = smem + wg * L::TILE;
  const uint8_t* so = smem + (DQ_WGS + wg) * L::TILE;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  if (steps > 0) mbar_wait(q_bar, 0);

  for (int u = 0; u < steps; ++u) {
    const int st = u % DQ_STAGES;
    const int n0 = u * DQ_KEYS;
    const uint8_t* sk = smem + L::RING + st * 2 * L::KTILE;
    const uint8_t* sv = sk + L::KTILE;
    mbar_wait(&full[st], (u / DQ_STAGES) & 1);
    if (u < wg_steps) {
      // S = Q K^T and dP = dO V^T: 64 rows x DQ_KEYS keys each
      float s[NT], dp[NT];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<DQ_KEYS>::ss(s, kmajor(sq, kk, PANEL), kmajor(sk, kk, KPANEL), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Wgmma<DQ_KEYS>::ss(dp, kmajor(so, kk, PANEL), kmajor(sv, kk, KPANEL), kk > 0);
      wgmma_commit();
      fence_acc(dp);
      wgmma_wait<1>();  // S is done; dP may still run
      fence_acc(s);
      const bool inside =
          n0 + DQ_KEYS <= kv_len && (!p.causal || n0 + DQ_KEYS - 1 <= p.q_offset + row0);
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const int r = (i >> 1) & 1;
        const int col = n0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const bool ok = inside || (col < kv_len && (!p.causal || col <= p.q_offset + row[r]));
        s[i] = ok ? exp2_approx(fmaf(s[i], scale_log2, -lse[r])) : 0.f;
      }
      wgmma_wait<0>();
      fence_acc(dp);
      // dS = P (dP - di)
#pragma unroll
      for (int i = 0; i < NT; ++i) s[i] *= dp[i] - di[(i >> 1) & 1];
      uint32_t a[NT / 8][4];
      acc_to_a<NT>(a, s);
      // dQ += dS K, K's tile MN-major
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < NT / 8; ++kk)
        Wgmma<HD>::template rs<1>(acc, a[kk], sw128_desc_mn(sk + kk * 2048, KPANEL));
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
    }
    mbar_arrive(&empty[st]);
  }

  // dQ into this warpgroup's Q tile, which only its own products read
  store_tile<HD>(&p.o0, smem + wg * L::TILE, acc, p.scale, p.scale, row0, hi, bi, ctid,
                 BAR_STORE + wg);
}

// the parameters, with the maps of q, dO in boxes of 64 rows, of k, v in
// boxes of kv_rows and of the contiguous outputs o0 (s_o rows) and o1 (none
// when nullptr, else s_k rows); false when a map cannot be encoded
bool make_params(BwdParams* p, const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* di, void* o0, int s_o, void* o1,
                 const int* kv_len, int b, int h, int s_q, int s_k, int hd,
                 const long long* st, float scale, int causal, int q_offset, int kv_rows) {
  const long long os = (long long)h * hd;  // the outputs' s stride
  if (!encode_bshd(&p->q, q, b, s_q, h, hd, st[0], st[1], st[2], BLK) ||
      !encode_bshd(&p->k, k, b, s_k, h, hd, st[3], st[4], st[5], kv_rows) ||
      !encode_bshd(&p->v, v, b, s_k, h, hd, st[6], st[7], st[8], kv_rows) ||
      !encode_bshd(&p->dout, dout, b, s_q, h, hd, st[9], st[10], st[11], BLK) ||
      !encode_bshd(&p->o0, o0, b, s_o, h, hd, s_o * os, os, hd, BLK) ||
      (o1 != nullptr && !encode_bshd(&p->o1, o1, b, s_k, h, hd, s_k * os, os, hd, BLK))) {
    return false;
  }
  p->lse = lse;
  p->di = di;
  p->kv_len = kv_len;
  p->h = h;
  p->s_q = s_q;
  p->s_k = s_k;
  p->scale = scale;
  p->causal = causal;
  p->q_offset = q_offset;
  return true;
}

template <int HD>
cudaError_t launch_dkv(const BwdParams& p, int bh, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dkv<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, (p.s_k + BLK - 1) / BLK);
  flash_bwd_dkv_kernel<HD><<<grid, DKV_THREADS, Dkv<HD>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const BwdParams& p, int bh, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, Dq<HD>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(bh, (p.s_q + DQ_WGS * BLK - 1) / (DQ_WGS * BLK));
  flash_bwd_dq_kernel<HD><<<grid, DQ_THREADS, Dq<HD>::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entries for ctypes; each returns a cudaError_t (0 on success).
// strides: the (b, s, h) element strides of q, k, v and dO, 12 values, each
// a multiple of 8; every base 16-byte aligned (the tensor maps' rule).
extern "C" int magma_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* di,
                                        void* dk, void* dv, const int* kv_len, int b, int h,
                                        int s_q, int s_k, int hd, const long long* strides,
                                        float scale, int causal, int q_offset, void* stream) {
  BwdParams p;
  if ((hd != 128 && hd != 256) ||
      !make_params(&p, q, k, v, dout, lse, di, dk, s_k, dv, kv_len, b, h, s_q, s_k, hd, strides,
                   scale, causal, q_offset, BLK)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(hd == 128 ? launch_dkv<128>(p, b * h, st) : launch_dkv<256>(p, b * h, st));
}

extern "C" int magma_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* di,
                                       void* dq, const int* kv_len, int b, int h, int s_q,
                                       int s_k, int hd, const long long* strides, float scale,
                                       int causal, int q_offset, void* stream) {
  BwdParams p;
  if ((hd != 128 && hd != 256) ||
      !make_params(&p, q, k, v, dout, lse, di, dq, s_q, nullptr, kv_len, b, h, s_q, s_k, hd,
                   strides, scale, causal, q_offset, DQ_KEYS)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(hd == 128 ? launch_dq<128>(p, b * h, st) : launch_dq<256>(p, b * h, st));
}
