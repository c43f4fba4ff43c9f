// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 O + fp32 lse out.
//
// Replaces: magma_tpu/ops/flash_attention.py `_fwd_kernel` (launched by
// `_fwd` through pl.pallas_call), the causal online-softmax attention that
// every GPT-J layer's prefill runs.  Same function: fp32 running max, sum
// and accumulator; scores masked with NEG_INF = -0.7 * FLT_MAX where a key
// is past the row's kv_len or (causal) after the query's global position
// q_offset + i; masked probabilities zeroed explicitly, so a fully masked
// row gives O = 0 (not mean(V)); kv tiles entirely above the diagonal or
// past kv_len are never loaded.  lse = m + log(max(l, 1e-30)) per row.
//
// What bounds it on an H100 at the caption prefill's shapes (b*h = 16,
// s = 256, hd = 256): 33.5 MFLOP per head for QK^T (as much again for PV),
// about 0.5 GFLOP a layer once the causal half is skipped, and 8 MB of
// Q/K/V/O.  Against the H100 SXM data sheet (989 TFLOP/s bf16, 3.35 TB/s)
// that is under 1 us of tensor-core time and about 2.5 us of HBM time --
// far below either roofline.  So the launch and each block's serial kv
// loop set its time, not FLOPs or bytes (measured: 0.023 ms a launch on an
// NVIDIA H100 80GB HBM3 at a 700 W power limit).
//
// What the design does about it: one launch per layer covers every
// (batch, head, 64-row q block) at once (grid 4 x 16 = 64 blocks of 4
// warps at the prefill's shape), reads (b, s, h, hd) tensors through
// strides so the wrapper needs no transpose copy, and keeps S, P and the
// O accumulator in registers (mma.sync m16n8k16 bf16 -> fp32, operands
// fed by ldmatrix from padded shared-memory tiles), so nothing of size
// (s, s) ever reaches device memory.  Each warp owns 16 query rows; a kv
// tile is 32 rows, loaded with cp.async.  At hd = 256 the Q tile (33 KB)
// plus one K and one V tile (17 KB each) need 66 KB of dynamic shared
// memory, above the 48 KB default, so the launcher raises the limit.
// wgmma, TMA and a pipelined kv loop are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;  // query rows per block: 4 warps x 16 rows
constexpr int BLOCK_N = 32;  // kv rows per tile
constexpr int NUM_THREADS = 128;
constexpr int PAD = 8;       // bf16 per shared row: staggers ldmatrix banks

// the JAX package's constant: a double product rounded to float
#define NEG_INF_F ((float)(-0.7 * 3.4028234663852886e38))

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;            // (b*h, s_q)
  const int* kv_len;     // (b,) or nullptr
  int h, s_q, s_k;
  long long q_sb, q_ss, q_sh;  // element strides of (b, s, h, hd); hd is unit
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int q_offset;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; a row past the tensor's end is zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit_and_wait() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// rows [row0, row0 + ROWS) of one (batch, head) slice -> shared, row stride HD + PAD
template <int ROWS, int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int row0, int n_rows) {
  constexpr int CHUNKS = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const bool valid = row0 + r < n_rows;
    const __nv_bfloat16* src = valid ? base + (long long)(row0 + r) * row_stride + c : base;
    cp_async_16(dst + r * (HD + PAD) + c, src, valid);
  }
}

template <int HD>
__global__ void __launch_bounds__(NUM_THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LDS = HD + PAD;
  constexpr int N_TILES = BLOCK_N / 8;  // 8-wide score tiles per warp row block
  constexpr int D_TILES = HD / 8;       // 8-wide output tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BLOCK_M * LDS;
  __nv_bfloat16* sV = sK + BLOCK_N * LDS;

  const int q0 = blockIdx.x * BLOCK_M;
  const int bi = blockIdx.y / p.h;
  const int hi = blockIdx.y % p.h;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // accumulator row within the 8-row half
  const int tig = lane & 3;   // accumulator column pair

  const __nv_bfloat16* qb = p.q + bi * p.q_sb + hi * p.q_sh;
  const __nv_bfloat16* kb = p.k + bi * p.k_sb + hi * p.k_sh;
  const __nv_bfloat16* vb = p.v + bi * p.v_sb + hi * p.v_sh;

  int kv_len = p.s_k;
  if (p.kv_len != nullptr) kv_len = min(kv_len, p.kv_len[bi]);
  // keys past kv_len, and (causal) past the block's last query position,
  // are masked for every row of the block: their tiles are skipped
  int n_end = kv_len;
  if (p.causal) n_end = min(n_end, p.q_offset + q0 + BLOCK_M);

  load_tile<BLOCK_M, HD>(sQ, qb, p.q_ss, q0, p.s_q);

  float acc[D_TILES][4];
#pragma unroll
  for (int j = 0; j < D_TILES; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_i[2] = {NEG_INF_F, NEG_INF_F};
  float l_i[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + gid;  // rows of accumulator halves 0 and 1
  const int pos[2] = {p.q_offset + row_a, p.q_offset + row_a + 8};

  for (int n0 = 0; n0 < n_end; n0 += BLOCK_N) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<BLOCK_N, HD>(sK, kb, p.k_ss, n0, p.s_k);
    load_tile<BLOCK_N, HD>(sV, vb, p.v_ss, n0, p.s_k);
    cp_async_commit_and_wait();
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x BLOCK_N keys
    float s[N_TILES][4];
#pragma unroll
    for (int t = 0; t < N_TILES; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS + kk +
                         (lane / 16) * 8);
#pragma unroll
      for (int t = 0; t < N_TILES; t += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sK + (t * 8 + (lane % 8) + (lane / 16) * 8) * LDS + kk +
                           ((lane / 8) % 2) * 8);
        mma_16816(s[t], a, b[0], b[1]);
        mma_16816(s[t + 1], a, b[2], b[3]);
      }
    }

    // scale, mask, and the tile's row maxima
    uint32_t keep = 0;  // bit (t * 4 + e): score s[t][e] is attendable
    float tile_max[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int t = 0; t < N_TILES; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + t * 8 + tig * 2 + (e & 1);
        const bool ok = col < kv_len && (!p.causal || col <= pos[e >> 1]);
        const float x = ok ? s[t][e] * p.scale : NEG_INF_F;
        s[t][e] = x;
        keep |= (ok ? 1u : 0u) << (t * 4 + e);
        tile_max[e >> 1] = fmaxf(tile_max[e >> 1], x);
      }
    }
    float alpha[2], row_sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
      tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
      m_new[r] = fmaxf(m_i[r], tile_max[r]);
      alpha[r] = expf(m_i[r] - m_new[r]);
    }
#pragma unroll
    for (int t = 0; t < N_TILES; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float prob = ((keep >> (t * 4 + e)) & 1u) ? expf(s[t][e] - m_new[e >> 1]) : 0.f;
        s[t][e] = prob;
        row_sum[e >> 1] += prob;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 1);
      row_sum[r] += __shfl_xor_sync(0xffffffffu, row_sum[r], 2);
      l_i[r] = alpha[r] * l_i[r] + row_sum[r];
      m_i[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < D_TILES; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V, P (bf16) straight from the score registers
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < D_TILES; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS + j * 8 +
                                 (lane / 16) * 8);
        mma_16816(acc[j], a, b[0], b[1]);
        mma_16816(acc[j + 1], a, b[2], b[3]);
      }
    }
  }
  if (n_end <= 0) cp_async_commit_and_wait();  // the Q copy was never waited on

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= p.s_q) continue;
    const float l = l_i[r] == 0.f ? 1.f : l_i[r];
    __nv_bfloat16* orow = p.o + bi * p.o_sb + (long long)row * p.o_ss + hi * p.o_sh;
#pragma unroll
    for (int j = 0; j < D_TILES; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[j][2 * r] / l, acc[j][2 * r + 1] / l);
    }
    if (tig == 0) {
      p.lse[(long long)blockIdx.y * p.s_q + row] = m_i[r] + logf(fmaxf(l_i[r], 1e-30f));
    }
  }
}

template <int HD>
cudaError_t launch(const Params& p, int bh, cudaStream_t stream) {
  const int smem = (BLOCK_M + 2 * BLOCK_N) * (HD + PAD) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s_q + BLOCK_M - 1) / BLOCK_M, bh);
  flash_fwd_kernel<HD><<<grid, NUM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Returns a cudaError_t (0 on success).
extern "C" int magma_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    float* lse, const int* kv_len, int b, int h, int s_q,
                                    int s_k, int hd, long long q_sb, long long q_ss,
                                    long long q_sh, long long k_sb, long long k_ss,
                                    long long k_sh, long long v_sb, long long v_ss,
                                    long long v_sh, long long o_sb, long long o_ss,
                                    long long o_sh, float scale, int causal, int q_offset,
                                    void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.kv_len = kv_len;
  p.h = h;
  p.s_q = s_q;
  p.s_k = s_k;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  p.q_offset = q_offset;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 128: return (int)launch<128>(p, b * h, st);
    case 256: return (int)launch<256>(p, b * h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
