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
// hd = 256, causal) the two kernels do 7 products of 2 s^2 hd / 2 flops a
// (batch, head) -- K9a recomputes S and dP, K9b recomputes S and dP
// again -- about 0.24 TFLOP, 0.24 ms at the 989 TFLOP/s dense bf16 rate;
// they move 5 tensors of 33.5 MB in and 3 out (~0.08 ms at 3.35 TB/s).
// So the tensor cores bound it.
//
// What the design does about it: mma.sync bf16 tiles with fp32
// accumulators, P and dS rounded to bf16 for the tensor cores, S, P, dP,
// dS and the gradient accumulators in registers; nothing (s, s)-sized
// reaches device memory.  K9a: a block owns 64 keys (4 warps x 16) of one
// (batch, head) and walks the 32-row query blocks that can see them; K9b:
// a block owns 64 query rows and walks the 32-key blocks they see.  Each
// output element is written by one thread, summed in a fixed order: no
// float atomics, the gradients are deterministic.  At hd = 256 a warp's
// dK and dV accumulators (2 x 16 x 256 fp32) do not fit its registers, so
// K9a's grid has a z axis of 2: z = 0 blocks accumulate dV, z = 1 blocks
// dK, both recomputing P (5 products in K9a instead of 4).  wgmma, TMA
// and pipelined tile loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;

constexpr int NUM_THREADS = 128;  // 4 warps
constexpr int PAD = 8;            // bf16 per shared row: staggers ldmatrix banks
constexpr int DKV_KEYS = 64;      // K9a: keys per block (4 warps x 16)
constexpr int DKV_QROWS = 32;     // K9a: query rows per step
constexpr int DQ_QROWS = 64;      // K9b: query rows per block (4 warps x 16)
constexpr int DQ_KEYS = 32;       // K9b: keys per step

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;  // (b*h, s_q)
  const float* di;   // (b*h, s_q)
  __nv_bfloat16* dq;  // contiguous (b, s_q, h, hd)
  __nv_bfloat16* dk;  // contiguous (b, s_k, h, hd)
  __nv_bfloat16* dv;
  const int* kv_len;  // (b,) or nullptr
  int h, s_q, s_k;
  long long q_sb, q_ss, q_sh;  // element strides of (b, s, h, hd); hd is unit
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO's
  float scale;
  int causal;
  int q_offset;
};

enum DkvMode { kBoth = 0, kDvOnly = 1, kDkOnly = 2 };

template <int HD>
constexpr int dkv_smem_bytes() {
  return (2 * DKV_KEYS + 2 * DKV_QROWS) * (HD + PAD) * 2 + 2 * DKV_QROWS * 4;
}

template <int HD>
constexpr int dq_smem_bytes() {
  return (2 * DQ_QROWS + 2 * DQ_KEYS) * (HD + PAD) * 2;
}

// K9a's body for one block: keys [n0, n0 + 64) of (batch bi, head hi)
template <int HD, int MODE>
__device__ __forceinline__ void dkv_block(const BwdParams& p, unsigned char* smem) {
  constexpr int LDS = HD + PAD;
  constexpr int QT = DKV_QROWS / 8;  // 8-wide query tiles of a step
  constexpr int DT = HD / 8;         // 8-wide output tiles
  constexpr bool DO_DV = MODE != kDkOnly;
  constexpr bool DO_DK = MODE != kDvOnly;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + DKV_KEYS * LDS;
  __nv_bfloat16* sQ = sV + DKV_KEYS * LDS;
  __nv_bfloat16* sO = sQ + DKV_QROWS * LDS;
  float* sL = reinterpret_cast<float*>(sO + DKV_QROWS * LDS);
  float* sD = sL + DKV_QROWS;

  const int n0 = blockIdx.x * DKV_KEYS;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;

  int kv_len = p.s_k;
  if (p.kv_len != nullptr) kv_len = min(kv_len, p.kv_len[bi]);
  const int key[2] = {n0 + warp * 16 + gid, n0 + warp * 16 + gid + 8};

  load_rows<DKV_KEYS, HD, LDS, NUM_THREADS>(sK, p.k + bi * p.k_sb + hi * p.k_sh, p.k_ss, n0,
                                            p.s_k);
  if (DO_DK)
    load_rows<DKV_KEYS, HD, LDS, NUM_THREADS>(sV, p.v + bi * p.v_sb + hi * p.v_sh, p.v_ss, n0,
                                              p.s_k);
  cp_async_commit_and_wait();

  float dk[DO_DK ? DT : 1][4], dv[DO_DV ? DT : 1][4];
#pragma unroll
  for (int j = 0; j < (DO_DK ? DT : 1); ++j) dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < (DO_DV ? DT : 1); ++j) dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;

  // the first query that sees key n0 (causal); no query sees keys past kv_len
  int m_begin = 0;
  if (p.causal) m_begin = max(0, n0 - p.q_offset) / DKV_QROWS * DKV_QROWS;
  const int m_end = n0 < kv_len ? p.s_q : 0;
  const __nv_bfloat16* qb = p.q + bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* ob = p.dout + bi * p.o_sb + hi * p.o_sh;

  for (int m0 = m_begin; m0 < m_end; m0 += DKV_QROWS) {
    __syncthreads();  // the previous step's reads of sQ, sO, sL, sD are done
    load_rows<DKV_QROWS, HD, LDS, NUM_THREADS>(sQ, qb, p.q_ss, m0, p.s_q);
    load_rows<DKV_QROWS, HD, LDS, NUM_THREADS>(sO, ob, p.o_ss, m0, p.s_q);
    if (threadIdx.x < DKV_QROWS) {
      const int row = m0 + threadIdx.x;
      const bool ok = row < p.s_q;
      sL[threadIdx.x] = ok ? p.lse[(long long)bh * p.s_q + row] : 0.f;
      sD[threadIdx.x] = ok ? p.di[(long long)bh * p.s_q + row] : 0.f;
    }
    cp_async_commit_and_wait();
    __syncthreads();

    // S^T = K Q^T: this warp's 16 keys x 32 queries
    float st[QT][4];
#pragma unroll
    for (int t = 0; t < QT; ++t) st[t][0] = st[t][1] = st[t][2] = st[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      load_a<LDS>(a, sK, warp * 16, kk, lane);
#pragma unroll
      for (int t = 0; t < QT; t += 2) {
        uint32_t b[4];
        load_b_nk<LDS>(b, sQ, t * 8, kk, lane);
        mma_16816(st[t], a, b[0], b[1]);
        mma_16816(st[t + 1], a, b[2], b[3]);
      }
    }
    // P^T, masked entries zeroed
#pragma unroll
    for (int t = 0; t < QT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = t * 8 + tig * 2 + (e & 1);
        const int qi = m0 + c;
        const int kj = key[e >> 1];
        const bool ok = kj < kv_len && qi < p.s_q && (!p.causal || kj <= p.q_offset + qi);
        st[t][e] = ok ? expf(st[t][e] * p.scale - sL[c]) : 0.f;
      }
    }
    if constexpr (DO_DV) {
      // dV += P^T dO
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<QT>(a, st, kk);
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t b[4];
          load_b_kn<LDS>(b, sO, kk * 16, j * 8, lane);
          mma_16816(dv[j], a, b[0], b[1]);
          mma_16816(dv[j + 1], a, b[2], b[3]);
        }
      }
    }
    if constexpr (DO_DK) {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - di)
      float ds[QT][4];
#pragma unroll
      for (int t = 0; t < QT; ++t) ds[t][0] = ds[t][1] = ds[t][2] = ds[t][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        uint32_t a[4];
        load_a<LDS>(a, sV, warp * 16, kk, lane);
#pragma unroll
        for (int t = 0; t < QT; t += 2) {
          uint32_t b[4];
          load_b_nk<LDS>(b, sO, t * 8, kk, lane);
          mma_16816(ds[t], a, b[0], b[1]);
          mma_16816(ds[t + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int t = 0; t < QT; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[t][e] = st[t][e] * (ds[t][e] - sD[t * 8 + tig * 2 + (e & 1)]);
      }
      // dK += dS^T Q (the scale at the store)
#pragma unroll
      for (int kk = 0; kk < DKV_QROWS / 16; ++kk) {
        uint32_t a[4];
        acc_to_a<QT>(a, ds, kk);
#pragma unroll
        for (int j = 0; j < DT; j += 2) {
          uint32_t b[4];
          load_b_kn<LDS>(b, sQ, kk * 16, j * 8, lane);
          mma_16816(dk[j], a, b[0], b[1]);
          mma_16816(dk[j + 1], a, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.s_k) continue;
    const long long off = ((long long)bi * p.s_k + key[r]) * p.h * HD + (long long)hi * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int col = j * 8 + tig * 2;
      if constexpr (DO_DK)
        *reinterpret_cast<__nv_bfloat162*>(p.dk + off + col) =
            __floats2bfloat162_rn(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      if constexpr (DO_DV)
        *reinterpret_cast<__nv_bfloat162*>(p.dv + off + col) =
            __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dkv_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (HD == 128) {
    dkv_block<HD, kBoth>(p, smem_raw);
  } else {
    if (blockIdx.z == 0)
      dkv_block<HD, kDvOnly>(p, smem_raw);
    else
      dkv_block<HD, kDkOnly>(p, smem_raw);
  }
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LDS = HD + PAD;
  constexpr int NT = DQ_KEYS / 8;  // 8-wide key tiles of a step
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + DQ_QROWS * LDS;
  __nv_bfloat16* sK = sO + DQ_QROWS * LDS;
  __nv_bfloat16* sV = sK + DQ_KEYS * LDS;

  const int q0 = blockIdx.x * DQ_QROWS;
  const int bh = blockIdx.y;
  const int bi = bh / p.h, hi = bh % p.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;

  int kv_len = p.s_k;
  if (p.kv_len != nullptr) kv_len = min(kv_len, p.kv_len[bi]);
  int n_end = kv_len;
  if (p.causal) n_end = min(n_end, p.q_offset + q0 + DQ_QROWS);

  load_rows<DQ_QROWS, HD, LDS, NUM_THREADS>(sQ, p.q + bi * p.q_sb + hi * p.q_sh, p.q_ss, q0,
                                            p.s_q);
  load_rows<DQ_QROWS, HD, LDS, NUM_THREADS>(sO, p.dout + bi * p.o_sb + hi * p.o_sh, p.o_ss, q0,
                                            p.s_q);
  cp_async_commit_and_wait();

  const int row[2] = {q0 + warp * 16 + gid, q0 + warp * 16 + gid + 8};
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = row[r] < p.s_q;
    lse[r] = ok ? p.lse[(long long)bh * p.s_q + row[r]] : 0.f;
    di[r] = ok ? p.di[(long long)bh * p.s_q + row[r]] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  const __nv_bfloat16* kb = p.k + bi * p.k_sb + hi * p.k_sh;
  const __nv_bfloat16* vb = p.v + bi * p.v_sb + hi * p.v_sh;

  for (int n0 = 0; n0 < n_end; n0 += DQ_KEYS) {
    __syncthreads();  // the previous step's reads of sK, sV are done (and sQ, sO loaded)
    load_rows<DQ_KEYS, HD, LDS, NUM_THREADS>(sK, kb, p.k_ss, n0, p.s_k);
    load_rows<DQ_KEYS, HD, LDS, NUM_THREADS>(sV, vb, p.v_ss, n0, p.s_k);
    cp_async_commit_and_wait();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x 32 keys
    float s[NT][4], ds[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      ds[t][0] = ds[t][1] = ds[t][2] = ds[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4], ao[4];
      load_a<LDS>(a, sQ, warp * 16, kk, lane);
      load_a<LDS>(ao, sO, warp * 16, kk, lane);
#pragma unroll
      for (int t = 0; t < NT; t += 2) {
        uint32_t b[4];
        load_b_nk<LDS>(b, sK, t * 8, kk, lane);
        mma_16816(s[t], a, b[0], b[1]);
        mma_16816(s[t + 1], a, b[2], b[3]);
        load_b_nk<LDS>(b, sV, t * 8, kk, lane);
        mma_16816(ds[t], ao, b[0], b[1]);
        mma_16816(ds[t + 1], ao, b[2], b[3]);
      }
    }
    // dS = P (dP - di), P = exp(S scale - lse) with masked entries zeroed
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int col = n0 + t * 8 + tig * 2 + (e & 1);
        const bool ok = col < kv_len && (!p.causal || col <= p.q_offset + row[r]);
        const float prob = ok ? expf(s[t][e] * p.scale - lse[r]) : 0.f;
        ds[t][e] = prob * (ds[t][e] - di[r]);
      }
    }
    // dQ += dS K (the scale at the store)
#pragma unroll
    for (int kk = 0; kk < DQ_KEYS / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<NT>(a, ds, kk);
#pragma unroll
      for (int j = 0; j < DT; j += 2) {
        uint32_t b[4];
        load_b_kn<LDS>(b, sK, kk * 16, j * 8, lane);
        mma_16816(dq[j], a, b[0], b[1]);
        mma_16816(dq[j + 1], a, b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.s_q) continue;
    __nv_bfloat16* out = p.dq + ((long long)bi * p.s_q + row[r]) * p.h * HD + (long long)hi * HD;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + tig * 2) =
          __floats2bfloat162_rn(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
    }
  }
}

template <int HD>
cudaError_t launch_dkv(const BwdParams& p, int bh, cudaStream_t stream) {
  const int smem = dkv_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_k + DKV_KEYS - 1) / DKV_KEYS, bh, HD == 128 ? 1 : 2);
  flash_bwd_dkv_kernel<HD><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const BwdParams& p, int bh, cudaStream_t stream) {
  const int smem = dq_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_q + DQ_QROWS - 1) / DQ_QROWS, bh);
  flash_bwd_dq_kernel<HD><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* di, void* dq, void* dk, void* dv,
                      const int* kv_len, int h, int s_q, int s_k, const long long* strides,
                      float scale, int causal, int q_offset) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.di = di;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.kv_len = kv_len;
  p.h = h;
  p.s_q = s_q;
  p.s_k = s_k;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  return p;
}

}  // namespace

// C entries for ctypes; each returns a cudaError_t (0 on success).
// strides: the (b, s, h) element strides of q, k, v and dO, 12 values.
extern "C" int magma_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* di,
                                        void* dk, void* dv, const int* kv_len, int b, int h,
                                        int s_q, int s_k, int hd, const long long* strides,
                                        float scale, int causal, int q_offset, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, di, nullptr, dk, dv, kv_len, h, s_q, s_k,
                                  strides, scale, causal, q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 128: return (int)launch_dkv<128>(p, b * h, st);
    case 256: return (int)launch_dkv<256>(p, b * h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int magma_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* di,
                                       void* dq, const int* kv_len, int b, int h, int s_q,
                                       int s_k, int hd, const long long* strides, float scale,
                                       int causal, int q_offset, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, lse, di, dq, nullptr, nullptr, kv_len, h, s_q,
                                  s_k, strides, scale, causal, q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 128: return (int)launch_dq<128>(p, b * h, st);
    case 256: return (int)launch_dq<256>(p, b * h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
