// Whole decode layers of one token (b = 1) in one launch, for Hopper
// (sm_90a): K7 runs one layer, K8 all of them.  Per layer l, from the
// layer's in_proj output fused = [q | k | v | m_pre] (bf16):
//   q, k = rotary(q, k) in fp32 from the sin/cos tables; q *= scale
//   ctx  = bf16(softmax over the cache positions < pos and the token
//          itself, of q . k, times V), the cache bf16 or int8 with one bf16
//          scale per (position, head): the scores times k_scale, the
//          weights times v_scale after their sum
//   mh   = bf16(gelu_tanh(m_pre + b_fc_in))
//   then layer_phases.cuh's boundary: the dual (o_proj + fc_out), the
//   adapters, the residual y, the next LN u and, unless it is the last
//   layer, the next layer's in_proj, which is the next layer's fused.
// k_new = bf16(rotated k) and v_new = v go out as rows for the caller's
// bulk cache write.  The weights are the int4 (W4A8) or the int8 (W8A16)
// serving stacks; K8 chains fused, y and u from layer to layer in scratch
// from the wrapper (about 80 KB at GPT-J 6B), so they stay in L2.
//
// Replaces: magma_tpu/ops/decode_layer.py `_declayer_kernel` (:89, called
// by `decode_layer_fused`, K7) and `_alllayer_kernel` (:830, called by
// `decode_all_layers_fused`, K8, which gptj._run_decode_fused_layers
// launches once per b = 1 quantized decode step).  The Pallas kernels walk
// a sequential grid (layer, step) and carry the online softmax and the
// chained activations in VMEM.
//
// What bounds them on an H100 SXM: the bytes they stream, at 3.35 TB/s.
// GPT-J 6B, v1 adapter, pos = 180, per layer: the int4 in_proj (60.6 MB with
// its scales), the int4 dual (42.6 MB), the adapter (8.4 MB) and the cache
// rows below pos (2.9 MB bf16, half that int8), about 115 MB -> 34 us for a
// middle layer of K7 and 3.16 GB -> 0.94 ms for K8's 28 layers (int8
// weights about 213 MB and 5.84 GB).  Operations are nothing.
//
// What the design does about it.  Every phase reads what the whole grid
// wrote in the one before (the attention needs all of q's head, the dual
// all of ctx, the LN all of y, the in_proj all of u), so the kernel is one
// cooperative launch of at most the co-resident block count, with
// cooperative_groups::this_grid().sync() between phases, and K8 loops over
// the layers inside it.  Per layer:
//   P0 attention: block items (head, chunk of 16 positions below pos); each
//      rotates its head's q, scores the chunk, and writes the chunk's max,
//      sum and partial ctx (fp32) to scratch.  mh is computed here too.
//   P1 combine: a block per head starts from the token itself (max = its
//      own score, sum 1, ctx = v) and folds the chunks in order: the online
//      softmax in a fixed order, no float atomics.  Writes ctx, k_new, v_new.
//   A-G the boundary phases of layer_phases.cuh, shared with K6.
// That is 9 grid barriers a layer (6 on the last, which has no in_proj),
// 249 in a GPT-J 6B step: the first thing a later change may cut
// (magma_grid_sync_probe below times them alone).  pos is read from device
// memory (the cache_index tensor): the host never waits for it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "layer_phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 256;         // head_dim: one thread a dimension
constexpr int ATT_CHUNK = 16;   // cache positions of one attention item
constexpr int PART = HD + 2;    // one chunk's partial: ctx[HD], max, sum
static_assert(HD == GEMV_THREADS, "one thread per head dimension");
static_assert(ATT_CHUNK % GEMV_WARPS == 0, "whole positions per warp");

using bf16 = __nv_bfloat16;

// the stacked (L, ...) tensors of a decode step and its scratch
struct Layers {
  int n_layers, l0, l1, in_until;  // layers [l0, l1); an in_proj at layers < in_until
  int h, d, f, ni, max_len, rd, kc;
  float scale, eps;
  const int* pos;                      // valid cache positions, on the device
  const float *sin, *cos;              // (rd/2,) of the token's position
  const bf16 *fused_in, *x_in, *u_in;  // layer l0's fused (3d + f), x (d), u (d) or null
  const void *k_cache, *v_cache;       // (L, max_len, h, HD) bf16 or int8
  const bf16 *k_scale, *v_scale;       // (L, h, max_len), int8 caches
  const int8_t* qd;                    // dual stack
  const float* sd;
  const float* b_fc_in;                             // (L, f)
  const float *b_fc_out, *ln_g, *ln_b, *o_bias;     // (L, d); o_bias may be null
  Adapter ad[2];                                    // layer 0's pointers of each stack
  const int8_t* qi;                                 // in_proj stack or null
  const float* si;
  bf16 *y, *u, *fused;                 // fused: K7's output, K8's chain
  bf16 *k_new, *v_new;                 // (l1 - l0, d)
  float *part, *terms_d, *terms_i;     // (h, max_len / ATT_CHUNK, PART), boundary terms
  bf16 *ctx, *mh, *ab, *mb;
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k_beta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k_kappa = 0.044715f;
  const float inner = k_beta * (x + k_kappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// element t of one head's q or k (HD bf16 values), rotated GPT-J style
// over the first rd dims: out[2i] = x[2i] cos - x[2i+1] sin,
// out[2i+1] = x[2i+1] cos + x[2i] sin, each product and sum rounded once
__device__ __forceinline__ float rotated(const bf16* v, int t, const float* sin,
                                         const float* cos, int rd) {
  const float xv = __bfloat162float(v[t]);
  if (t >= rd) return xv;
  const float s = sin[t >> 1], c = cos[t >> 1];
  if ((t & 1) == 0) {
    return __fsub_rn(__fmul_rn(xv, c), __fmul_rn(__bfloat162float(v[t + 1]), s));
  }
  return __fadd_rn(__fmul_rn(xv, c), __fmul_rn(__bfloat162float(v[t - 1]), s));
}

// 8 cache values of one row from element e, as floats
template <bool KV8>
__device__ __forceinline__ void load8(const void* base, long long e, float (&out)[8]) {
  if (KV8) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(static_cast<const int8_t*>(base) + e));
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(b[i]);
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(static_cast<const bf16*>(base) + e));
    const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(pairs[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

template <bool KV8>
__device__ __forceinline__ float load1(const void* base, long long e) {
  if (KV8) return static_cast<float>(__ldg(static_cast<const int8_t*>(base) + e));
  return __bfloat162float(__ldg(static_cast<const bf16*>(base) + e));
}

__device__ __forceinline__ int n_chunks(int pos) { return (pos + ATT_CHUNK - 1) / ATT_CHUNK; }

// P0: the cache chunks' partial softmax, and mh
template <bool KV8>
__device__ void phase_attention(const Layers& p, int l, const bf16* fused, int pos, float* qs,
                                float* sc) {
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int nck = n_chunks(pos);
  const int chunks_max = p.max_len / ATT_CHUNK;
  for (int item = blockIdx.x; item < p.h * nck; item += gridDim.x) {
    const int hh = item / nck, c = item % nck;
    qs[t] = __fmul_rn(rotated(fused + hh * HD, t, p.sin, p.cos, p.rd), p.scale);
    __syncthreads();
    // scores: each warp takes ATT_CHUNK / 8 positions, a lane 8 dimensions
    for (int jj = 0; jj < ATT_CHUNK / GEMV_WARPS; ++jj) {
      const int jl = warp * (ATT_CHUNK / GEMV_WARPS) + jj;
      const int j = c * ATT_CHUNK + jl;
      if (j >= pos) continue;  // the same for the whole warp
      const long long row = ((long long)l * p.max_len + j) * p.h + hh;
      float kv[8];
      load8<KV8>(p.k_cache, row * HD + 8 * lane, kv);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += kv[i] * qs[8 * lane + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (KV8) s *= __bfloat162float(p.k_scale[((long long)l * p.h + hh) * p.max_len + j]);
      if (lane == 0) sc[jl] = s;
    }
    __syncthreads();
    const int nvalid = min(ATT_CHUNK, pos - c * ATT_CHUNK);
    float mc = sc[0];
    for (int jl = 1; jl < nvalid; ++jl) mc = fmaxf(mc, sc[jl]);
    float lc = 0.f, acc = 0.f;
    for (int jl = 0; jl < nvalid; ++jl) {
      const int j = c * ATT_CHUNK + jl;
      const float pj = expf(sc[jl] - mc);
      lc += pj;
      const float pv =
          KV8 ? pj * __bfloat162float(p.v_scale[((long long)l * p.h + hh) * p.max_len + j]) : pj;
      acc += pv * load1<KV8>(p.v_cache, (((long long)l * p.max_len + j) * p.h + hh) * HD + t);
    }
    float* dst = p.part + ((long long)hh * chunks_max + c) * PART;
    dst[t] = acc;
    if (t == 0) {
      dst[HD] = mc;
      dst[HD + 1] = lc;
    }
    __syncthreads();  // qs and sc are read before the next item overwrites them
  }
  const bf16* m_pre = fused + 3 * (long long)p.d;
  const float* b_in = p.b_fc_in + (long long)l * p.f;
  for (long long i = grid_thread(); i < p.f; i += grid_threads()) {
    p.mh[i] = __float2bfloat16_rn(gelu_tanh(__bfloat162float(m_pre[i]) + b_in[i]));
  }
}

// P1: per head, the token itself, then the chunks in order
__device__ void phase_combine(const Layers& p, int l, const bf16* fused, int pos,
                              PhaseShared<1>& sh) {
  const int t = threadIdx.x;
  const int nck = n_chunks(pos);
  const int chunks_max = p.max_len / ATT_CHUNK;
  for (int hh = blockIdx.x; hh < p.h; hh += gridDim.x) {
    const bf16* qrow = fused + hh * HD;
    const bf16* krow = fused + p.d + hh * HD;
    const bf16* vrow = fused + 2 * p.d + hh * HD;
    const float q = __fmul_rn(rotated(qrow, t, p.sin, p.cos, p.rd), p.scale);
    const float k = rotated(krow, t, p.sin, p.cos, p.rd);
    const bf16 v = vrow[t];
    float m = block_sum(q * k, sh.sum_red);  // the token's own score
    float lsum = 1.f, acc = __bfloat162float(v);
    for (int c = 0; c < nck; ++c) {
      const float* src = p.part + ((long long)hh * chunks_max + c) * PART;
      const float mc = src[HD], lc = src[HD + 1];
      const float mn = fmaxf(m, mc);
      const float a = expf(m - mn), b = expf(mc - mn);
      lsum = lsum * a + lc * b;
      acc = acc * a + src[t] * b;
      m = mn;
    }
    p.ctx[hh * HD + t] = __float2bfloat16_rn(__fdiv_rn(acc, lsum));
    const long long o = (long long)(l - p.l0) * p.d + hh * HD + t;
    p.k_new[o] = __float2bfloat16_rn(k);
    p.v_new[o] = v;
  }
}

// layer l's boundary over the stacks
template <bool INT4>
__device__ __forceinline__ Boundary boundary_of(const Layers& p, int l) {
  const long long d = p.d, f = p.f, ni = p.ni;
  Boundary b{};
  b.m = 1;
  b.d = p.d;
  b.f = p.f;
  b.kc = p.kc;
  b.eps = p.eps;
  b.ctx = p.ctx;
  b.mh = p.mh;
  b.x = l == p.l0 ? p.x_in : p.y;
  b.u_in = l == p.l0 ? p.u_in : p.u;
  b.qd = p.qd + l * (INT4 ? (d + f) / 2 * d : (d + f) * d);
  b.sd = p.sd + l * (INT4 ? (d + f) / W4_GROUP * d : 2 * d);
  b.b_fc_out = p.b_fc_out + l * d;
  b.ln_g = p.ln_g + l * d;
  b.ln_b = p.ln_b + l * d;
  b.o_bias = p.o_bias ? p.o_bias + l * d : nullptr;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const Adapter& s = p.ad[k];
    const long long dh = s.dh;
    b.ad[k] = s.dh ? Adapter{s.wd + l * d * dh, s.sd + l * dh, s.bd + l * dh, s.wu + l * dh * d,
                             s.su + l * d, s.bu + l * d, s.dh, s.src_in, s.h}
                   : Adapter{};
  }
  if (l < p.in_until) {
    b.ni = p.ni;
    b.qi = p.qi + (l + 1) * (INT4 ? d / 2 * ni : d * ni);
    b.si = p.si + (l + 1) * (INT4 ? d / W4_GROUP * ni : ni);
  }
  b.y = p.y;
  b.u = p.u;
  b.fused = p.fused;
  b.terms_d = p.terms_d;
  b.terms_i = p.terms_i;
  b.ab = p.ab;
  b.mb = p.mb;
  return b;
}

template <bool INT4, bool KV8>
__global__ void __launch_bounds__(GEMV_THREADS) decode_layers_kernel(const Layers p) {
  __shared__ __align__(16) PhaseShared<1> sh;
  __shared__ float qs[HD];
  __shared__ float sc[ATT_CHUNK];
  cg::grid_group grid = cg::this_grid();
  const int pos = max(0, min(*p.pos, p.max_len));
  for (int l = p.l0; l < p.l1; ++l) {
    const bf16* fused = l == p.l0 ? p.fused_in : p.fused;
    phase_attention<KV8>(p, l, fused, pos, qs, sc);
    grid.sync();
    phase_combine(p, l, fused, pos, sh);
    grid.sync();
    const Boundary b = boundary_of<INT4>(p, l);
    phase_dual_terms<1, INT4, true>(b, sh);
    grid.sync();
    phase_branch_sums<INT4>(b);
    grid.sync();
    phase_adapter_down<1>(b, sh);
    grid.sync();
    phase_adapter_up_residual<1>(b, sh);
    grid.sync();
    phase_layer_norm<1>(b, sh);
    if (b.qi != nullptr) {
      grid.sync();
      phase_inproj_terms<1, INT4>(b, sh);
      grid.sync();
      phase_inproj_sums<INT4>(b);
    }
    if (l + 1 < p.l1) grid.sync();
  }
}

constexpr int MAX_DEVICES = 64;

// co-resident blocks of decode_layers_kernel<INT4, KV8> on device dev (-1
// where the device has no cooperative launch), queried at its first launch
template <bool INT4, bool KV8>
cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[MAX_DEVICES] = {};  // 0: not queried yet
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_layers_kernel<INT4, KV8>, GEMV_THREADS, 0);
    }
    if (err != cudaSuccess) return err;
    cached[dev] = (coop && per_sm > 0) ? per_sm * sms : -1;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <bool INT4, bool KV8>
cudaError_t launch(Layers p, cudaStream_t stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks<INT4, KV8>(dev, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(decode_layers_kernel<INT4, KV8>),
                                     dim3(resident), dim3(GEMV_THREADS), args, 0, stream);
}

// n grid barriers and nothing else, on the grid of decode_layers_kernel:
// what the kernel's barriers cost apart from the work between them
__global__ void __launch_bounds__(GEMV_THREADS) grid_sync_kernel(int n) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// the entry's arrays, in the order of ops/decode_layer.py's _INTS and _PTRS
enum Ints {
  I_LAYERS, I_L0, I_L1, I_IN_UNTIL, I_HEADS, I_D, I_F, I_NI, I_MAX_LEN, I_ROTARY, I_KC, I_INT4,
  I_KV8, I_DH_A, I_SRC_A, I_DH_M, I_SRC_M, I_HEAD_DIM, I_CHUNK, N_INTS
};
enum Floats { F_SCALE, F_EPS, N_FLOATS };
enum Ptrs {
  P_POS, P_SIN, P_COS, P_FUSED_IN, P_X_IN, P_U_IN, P_K_CACHE, P_V_CACHE, P_K_SCALE, P_V_SCALE,
  P_QD, P_SD, P_B_FC_IN, P_B_FC_OUT, P_LN_G, P_LN_B, P_O_BIAS,
  P_A_WD, P_A_SD, P_A_BD, P_A_WU, P_A_SU, P_A_BU, P_A_H,
  P_M_WD, P_M_SD, P_M_BD, P_M_WU, P_M_SU, P_M_BU, P_M_H,
  P_QI, P_SI, P_Y, P_U, P_FUSED, P_K_NEW, P_V_NEW, P_PART, P_TERMS_D, P_TERMS_I,
  P_CTX, P_MH, P_AB, P_MB, N_PTRS
};

}  // namespace

// C entry for ctypes: iv[N_INTS], fv[N_FLOATS], pv[N_PTRS] as enumerated
// above (the counts are passed to catch a mismatch with the wrapper).
// Layers [l0, l1) of the stacks run; layers l < in_until also run the
// next layer's in_proj.  The pointers of what is absent (an adapter, the
// scales of a bf16 cache, o_bias, u_in, the in_proj) may be null.  Returns
// a cudaError_t.
extern "C" int magma_decode_layers(int n_ints, const long long* iv, int n_floats,
                                   const float* fv, int n_ptrs, void* const* pv, void* stream) {
  if (n_ints != N_INTS || n_floats != N_FLOATS || n_ptrs != N_PTRS) {
    return (int)cudaErrorInvalidValue;
  }
  const int int4 = (int)iv[I_INT4], kv8 = (int)iv[I_KV8];
  const int d = (int)iv[I_D], f = (int)iv[I_F], ni = (int)iv[I_NI], h = (int)iv[I_HEADS];
  const int max_len = (int)iv[I_MAX_LEN], rd = (int)iv[I_ROTARY], kc = (int)iv[I_KC];
  const int L = (int)iv[I_LAYERS], l0 = (int)iv[I_L0], l1 = (int)iv[I_L1];
  const int in_until = (int)iv[I_IN_UNTIL];
  const int dh_a = (int)iv[I_DH_A], dh_m = (int)iv[I_DH_M];
  const int group = int4 ? 2 * W4_GROUP : W4_GROUP;
  if (iv[I_HEAD_DIM] != HD || iv[I_CHUNK] != ATT_CHUNK || h < 1 || d != h * HD ||
      d % group || f <= 0 || f % group || max_len <= 0 || max_len % ATT_CHUNK ||
      rd < 0 || rd > HD || rd % 2 || l0 < 0 || l1 <= l0 || l1 > L || in_until > L - 1 ||
      (in_until > l0 && (ni <= 0 || ni % 128 || !pv[P_QI] || !pv[P_SI])) ||
      (!int4 && (kc <= 0 || d % kc || f % kc)) || dh_a < 0 || dh_a % 128 || dh_m < 0 ||
      dh_m % 128 || (kv8 && (!pv[P_K_SCALE] || !pv[P_V_SCALE])) ||
      (((dh_a && iv[I_SRC_A]) || (dh_m && iv[I_SRC_M])) && !pv[P_U_IN])) {
    return (int)cudaErrorInvalidValue;
  }
  Layers p{};
  p.n_layers = L;
  p.l0 = l0;
  p.l1 = l1;
  p.in_until = in_until;
  p.h = h;
  p.d = d;
  p.f = f;
  p.ni = ni;
  p.max_len = max_len;
  p.rd = rd;
  p.kc = kc;
  p.scale = fv[F_SCALE];
  p.eps = fv[F_EPS];
  p.pos = static_cast<const int*>(pv[P_POS]);
  p.sin = static_cast<const float*>(pv[P_SIN]);
  p.cos = static_cast<const float*>(pv[P_COS]);
  p.fused_in = static_cast<const bf16*>(pv[P_FUSED_IN]);
  p.x_in = static_cast<const bf16*>(pv[P_X_IN]);
  p.u_in = static_cast<const bf16*>(pv[P_U_IN]);
  p.k_cache = pv[P_K_CACHE];
  p.v_cache = pv[P_V_CACHE];
  p.k_scale = static_cast<const bf16*>(pv[P_K_SCALE]);
  p.v_scale = static_cast<const bf16*>(pv[P_V_SCALE]);
  p.qd = static_cast<const int8_t*>(pv[P_QD]);
  p.sd = static_cast<const float*>(pv[P_SD]);
  p.b_fc_in = static_cast<const float*>(pv[P_B_FC_IN]);
  p.b_fc_out = static_cast<const float*>(pv[P_B_FC_OUT]);
  p.ln_g = static_cast<const float*>(pv[P_LN_G]);
  p.ln_b = static_cast<const float*>(pv[P_LN_B]);
  p.o_bias = static_cast<const float*>(pv[P_O_BIAS]);
  const int dh[2] = {dh_a, dh_m};
  const int src[2] = {(int)iv[I_SRC_A], (int)iv[I_SRC_M]};
  for (int k = 0; k < 2; ++k) {
    const int b = k == 0 ? P_A_WD : P_M_WD;
    p.ad[k] = dh[k] ? Adapter{static_cast<const int8_t*>(pv[b]), static_cast<const float*>(pv[b + 1]),
                              static_cast<const float*>(pv[b + 2]),
                              static_cast<const int8_t*>(pv[b + 3]),
                              static_cast<const float*>(pv[b + 4]),
                              static_cast<const float*>(pv[b + 5]), dh[k], src[k] ? 1 : 0,
                              static_cast<bf16*>(pv[b + 6])}
                    : Adapter{};
  }
  p.qi = static_cast<const int8_t*>(pv[P_QI]);
  p.si = static_cast<const float*>(pv[P_SI]);
  p.y = static_cast<bf16*>(pv[P_Y]);
  p.u = static_cast<bf16*>(pv[P_U]);
  p.fused = static_cast<bf16*>(pv[P_FUSED]);
  p.k_new = static_cast<bf16*>(pv[P_K_NEW]);
  p.v_new = static_cast<bf16*>(pv[P_V_NEW]);
  p.part = static_cast<float*>(pv[P_PART]);
  p.terms_d = static_cast<float*>(pv[P_TERMS_D]);
  p.terms_i = static_cast<float*>(pv[P_TERMS_I]);
  p.ctx = static_cast<bf16*>(pv[P_CTX]);
  p.mh = static_cast<bf16*>(pv[P_MH]);
  p.ab = static_cast<bf16*>(pv[P_AB]);
  p.mb = static_cast<bf16*>(pv[P_MB]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (int4) err = kv8 ? launch<true, true>(p, st) : launch<true, false>(p, st);
  else err = kv8 ? launch<false, true>(p, st) : launch<false, false>(p, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// C entry for measurement: one cooperative launch of n grid barriers on the
// grid K7 and K8 launch (the int4, bf16-cache variant's co-resident blocks).
// Returns a cudaError_t.
extern "C" int magma_grid_sync_probe(int n, void* stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks<true, false>(dev, &resident);
  if (err != cudaSuccess) return (int)err;
  if (n < 0 || resident < 1) return (int)cudaErrorInvalidValue;
  void* args[] = {&n};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(grid_sync_kernel), dim3(resident),
                                    dim3(GEMV_THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
