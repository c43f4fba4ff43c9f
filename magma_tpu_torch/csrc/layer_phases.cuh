// The phases of a decode layer's boundary, boundary.cu's (K6; the streamed
// decode_layer.cu, K7 and K8, repeats their arithmetic with its own tiles):
// everything between one layer's attention and the next layer's, for m <= 8
// bf16 rows,
//   a = bf16(ctx @ W_o) [+ bf16(o_bias)] [+ bf16(adapter_attn(a or u_in))]
//   m = bf16(mh @ W_fc_out) + bf16(b_fc_out) [+ bf16(adapter_mlp(m or u_in))]
//   y = x + a + m                                   (bf16 adds, in that order)
//   u = bf16(LN(y) * ln_g + ln_b)                   (fp32 statistics)
//   fused = bf16(u @ W_in[next layer])              (unless the last layer)
// over the K-concatenated dual payload [W_o; W_fc_out] and the in_proj, in
// either weight format of magma_tpu/ops/quant.py:
//   int4: W4A8 (w4a8.cuh), the terms of each 512-row group summed in order;
//   int8: W8A16, the function of K4a and K2b (decode_layer.py:199-202,
//         247-256, 360-373): bf16 activations times int8 weights, exact in
//         fp32, summed in fp32 over chunks of kc rows (int8_gemv.cuh), the
//         chunks summed in order, the per-channel scale applied at the end.
// The adapters are the fused int8 payloads of fused_adapter.cu (K5's
// function: h = relu(src @ Wd * sd + bd) rounded to bf16, out = h @ Wu * su
// + bu).
//
// Each phase function is called by every thread of a cooperative launch and
// leaves its results in device memory; the kernel puts a grid barrier
// (cooperative_groups::this_grid().sync()) between two phases, because each
// reads what the whole grid wrote in the one before:
//   A  dual terms           (term, 32-column slice) items over the grid
//   B  a, m                 each element sums its terms in order, adds biases
//   C  adapter down         h = bf16(relu(src @ Wd * sd + bd)), block items
//   D  adapter up, residual y = x + a + bf16(z_a) + m + bf16(z_m)
//   E  LN                   every block computes the rows' statistics itself
//   F  in_proj terms        as A, on u
//   G  fused                each element sums its terms in order
// No float atomics: every sum has a fixed order, so results repeat from run
// to run.  What one phase writes, the next reads after the grid barrier,
// which orders the writes before the reads at device scope.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_gemv.cuh"
#include "w4a8.cuh"

namespace {

struct Adapter {
  const int8_t* wd;  // (d, dh)
  const float* sd;   // (dh,)
  const float* bd;   // (dh,)
  const int8_t* wu;  // (dh, d)
  const float* su;   // (d,)
  const float* bu;   // (d,)
  int dh;            // 0: no adapter here
  int src_in;        // 1: fed from u_in, 0: from its branch's output
  __nv_bfloat16* h;  // (m, dh) scratch
};

// one layer's boundary: its inputs, weights (this layer's, and the next
// layer's in_proj), outputs and scratch
struct Boundary {
  int m, d, f, ni;
  int kc;  // int8: rows of one term, a divisor of d and f; int4: unused
  float eps;
  const __nv_bfloat16 *ctx, *mh, *x, *u_in;  // (m, d), (m, f), (m, d), (m, d) or null
  const int8_t* qd;  // int4: (d/2 + f/2, d) packed; int8: (d + f, d)
  const float* sd;   // int4: (d/256 + f/256, d) group scales; int8: (2, d)
  const float *b_fc_out, *ln_g, *ln_b, *o_bias;  // (d,); o_bias may be null
  Adapter ad[2];                                 // 0: attention, 1: mlp
  const int8_t* qi;  // int4: (d/2, ni) packed; int8: (d, ni); null: no in_proj
  const float* si;   // int4: (d/256, ni); int8: (ni,)
  __nv_bfloat16 *y, *u, *fused;  // (m, d), (m, d), (m, ni)
  float *terms_d, *terms_i;      // (dual terms, m, d), (in_proj terms, m, ni)
  __nv_bfloat16 *ab, *mb;        // (m, d)
};

template <int MT>
struct PhaseShared {
  int8_t codes[GEMV_WARPS][2][MT][W4_GROUP];  // each warp's activation codes (int4)
  float red[GEMV_WARPS][MT][GEMV_SLICE];      // the warps' partial column sums
  float stats[MT][2];                         // mean, 1 / sqrt(var + eps)
  float sum_red[GEMV_WARPS];
};

__device__ __forceinline__ __nv_bfloat16 bf16_add(__nv_bfloat16 a, __nv_bfloat16 b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
}

// block-wide sum of one value a thread, in a fixed order (lanes by
// shuffles, then the warps in order); every thread gets the total
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < GEMV_WARPS; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ long long grid_thread() {
  return (long long)blockIdx.x * GEMV_THREADS + threadIdx.x;
}

__device__ __forceinline__ long long grid_threads() {
  return (long long)gridDim.x * GEMV_THREADS;
}

// the W4A8 terms of one product, warp items (group, slice) over the grid:
// terms[g][row][col] for rows < `rows`
template <int MT, bool COHERENT>
__device__ __forceinline__ void w4a8_terms(const __nv_bfloat16* x, long long ldx, int rows, int kp,
                                           const int8_t* q4, const float* s4, int n,
                                           float* terms, int8_t (*codes)[MT][W4_GROUP]) {
  const int lane = threadIdx.x & 31;
  const int slices = n / W4_SLICE;
  const int items = (kp / W4_GROUP) * slices;
  const int nwarps = gridDim.x * GEMV_WARPS;
  for (int item = blockIdx.x * GEMV_WARPS + (threadIdx.x >> 5); item < items; item += nwarps) {
    const int g = item / slices;
    const int col0 = (item % slices) * W4_SLICE;
    float term[MT][4];
    w4a8_group_term<MT, COHERENT>(x, ldx, rows, kp, q4, s4, n, g, col0, codes, term);
    if (lane < 8) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m < rows) {
          float* dst = terms + ((long long)g * rows + m) * n + col0 + 4 * lane;
          *reinterpret_cast<float4*>(dst) = make_float4(term[m][0], term[m][1], term[m][2],
                                                        term[m][3]);
        }
      }
    }
  }
}

// the W8A16 terms of one product, block items (chunk of kc rows, 32-column
// slice) over the grid: terms[c][row][col] = x[row, chunk c] @ w[chunk c, col]
template <int MT>
__device__ __forceinline__ void w8a16_terms(const __nv_bfloat16* x, long long ldx, int rows, int k,
                                            int kc, const int8_t* w, int n, float* terms,
                                            PhaseShared<MT>& sh) {
  const int t = threadIdx.x;
  const int tm = t / GEMV_SLICE;
  const int tj = t % GEMV_SLICE;
  const int slices = n / GEMV_SLICE;
  const int items = (k / kc) * slices;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c = item / slices;
    const int slice = item % slices;
    slice_gemv<MT>(x, ldx, rows, w, n, c * kc, (c + 1) * kc, slice, sh.red);
    if (t < MT * GEMV_SLICE && tm < rows) {
      terms[((long long)c * rows + tm) * n + slice * GEMV_SLICE + tj] =
          warp_total<MT>(sh.red, tm, tj);
    }
    __syncthreads();  // red is read before the next item overwrites it
  }
}

// A: the dual's terms; o_proj's first, then fc_out's.  COHERENT: ctx and mh
// were written earlier in the launch (K7, K8); otherwise they are inputs
// read through the read-only path (K6)
template <int MT, bool INT4, bool COHERENT>
__device__ __forceinline__ void phase_dual_terms(const Boundary& p, PhaseShared<MT>& sh) {
  const int d = p.d;
  if constexpr (INT4) {
    const int warp = threadIdx.x >> 5;
    const int nko = d / (2 * W4_GROUP);
    w4a8_terms<MT, COHERENT>(p.ctx, d, p.m, d / 2, p.qd, p.sd, d, p.terms_d, sh.codes[warp]);
    w4a8_terms<MT, COHERENT>(p.mh, p.f, p.m, p.f / 2, p.qd + (long long)(d / 2) * d,
                             p.sd + (long long)(2 * nko) * d, d,
                             p.terms_d + (long long)nko * p.m * d, sh.codes[warp]);
  } else {
    w8a16_terms<MT>(p.ctx, d, p.m, d, p.kc, p.qd, d, p.terms_d, sh);
    w8a16_terms<MT>(p.mh, p.f, p.m, p.f, p.kc, p.qd + (long long)d * d, d,
                    p.terms_d + (long long)(d / p.kc) * p.m * d, sh);
  }
}

// B: a = bf16(acc_o [* s_o]) [+ bf16(o_bias)], m = bf16(acc_f [* s_f]) + bf16(b_fc_out)
template <bool INT4>
__device__ __forceinline__ void phase_branch_sums(const Boundary& p) {
  const int d = p.d;
  const int nko = INT4 ? d / (2 * W4_GROUP) : d / p.kc;
  const int nkf = INT4 ? p.f / (2 * W4_GROUP) : p.f / p.kc;
  for (long long i = grid_thread(); i < (long long)p.m * d; i += grid_threads()) {
    const int row = static_cast<int>(i / d);
    const int c = static_cast<int>(i % d);
    float ao = 0.f, af = 0.f;
    for (int g = 0; g < nko; ++g) {
      ao = __fadd_rn(ao, __ldcg(p.terms_d + ((long long)g * p.m + row) * d + c));
    }
    for (int g = nko; g < nko + nkf; ++g) {
      af = __fadd_rn(af, __ldcg(p.terms_d + ((long long)g * p.m + row) * d + c));
    }
    if constexpr (!INT4) {
      ao = __fmul_rn(ao, p.sd[c]);
      af = __fmul_rn(af, p.sd[d + c]);
    }
    __nv_bfloat16 a = __float2bfloat16_rn(ao);
    if (p.o_bias) a = bf16_add(a, __float2bfloat16_rn(p.o_bias[c]));
    p.ab[i] = a;
    p.mb[i] = bf16_add(__float2bfloat16_rn(af), __float2bfloat16_rn(p.b_fc_out[c]));
  }
}

// C: each adapter's down product, h = bf16(relu(src @ Wd * sd + bd))
template <int MT>
__device__ __forceinline__ void phase_adapter_down(const Boundary& p, PhaseShared<MT>& sh) {
  const int t = threadIdx.x;
  const int tm = t / GEMV_SLICE;
  const int tj = t % GEMV_SLICE;
  const bool mine = t < MT * GEMV_SLICE && tm < p.m;
  const int s0 = p.ad[0].dh / GEMV_SLICE, s1 = p.ad[1].dh / GEMV_SLICE;
  for (int item = blockIdx.x; item < s0 + s1; item += gridDim.x) {
    const int k = item < s0 ? 0 : 1;
    const Adapter& ad = p.ad[k];
    const int slice = k == 0 ? item : item - s0;
    const __nv_bfloat16* src = ad.src_in ? p.u_in : (k == 0 ? p.ab : p.mb);
    slice_gemv<MT>(src, p.d, p.m, ad.wd, ad.dh, 0, p.d, slice, sh.red);
    if (mine) {
      const int c = slice * GEMV_SLICE + tj;
      const float v = fmaxf(warp_total<MT>(sh.red, tm, tj) * ad.sd[c] + ad.bd[c], 0.f);
      ad.h[(long long)tm * ad.dh + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();  // red is read before the next item overwrites it
  }
}

// D: the up products, a += bf16(z_attn), m += bf16(z_mlp), y = x + a + m
template <int MT>
__device__ __forceinline__ void phase_adapter_up_residual(const Boundary& p, PhaseShared<MT>& sh) {
  const int t = threadIdx.x;
  const int tm = t / GEMV_SLICE;
  const int tj = t % GEMV_SLICE;
  const bool mine = t < MT * GEMV_SLICE && tm < p.m;
  const int d = p.d;
  for (int slice = blockIdx.x; slice < d / GEMV_SLICE; slice += gridDim.x) {
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const Adapter& ad = p.ad[k];
      if (ad.dh == 0) continue;
      slice_gemv<MT>(ad.h, ad.dh, p.m, ad.wu, d, 0, ad.dh, slice, sh.red);
      if (mine) {
        const int c = slice * GEMV_SLICE + tj;
        z[k] = warp_total<MT>(sh.red, tm, tj) * ad.su[c] + ad.bu[c];
      }
      __syncthreads();
    }
    if (mine) {
      const long long i = (long long)tm * d + slice * GEMV_SLICE + tj;
      __nv_bfloat16 a = __ldcg(p.ab + i), mv = __ldcg(p.mb + i);
      if (p.ad[0].dh) a = bf16_add(a, __float2bfloat16_rn(z[0]));
      if (p.ad[1].dh) mv = bf16_add(mv, __float2bfloat16_rn(z[1]));
      p.y[i] = bf16_add(bf16_add(p.x[i], a), mv);
    }
  }
}

// E: the LN of each row; every block computes the statistics itself
// (4096 values a row, cheaper than another barrier), then its share of u
template <int MT>
__device__ __forceinline__ void phase_layer_norm(const Boundary& p, PhaseShared<MT>& sh) {
  const int t = threadIdx.x;
  const int d = p.d;
  for (int row = 0; row < p.m; ++row) {
    const __nv_bfloat16* yr = p.y + (long long)row * d;
    float s = 0.f;
    for (int c = t; c < d; c += GEMV_THREADS) s += __bfloat162float(__ldcg(yr + c));
    const float mean = __fdiv_rn(block_sum(s, sh.sum_red), (float)d);
    float q = 0.f;
    for (int c = t; c < d; c += GEMV_THREADS) {
      const float dv = __fsub_rn(__bfloat162float(__ldcg(yr + c)), mean);
      q = __fadd_rn(q, __fmul_rn(dv, dv));
    }
    const float var = __fdiv_rn(block_sum(q, sh.sum_red), (float)d);
    if (t == 0) {
      sh.stats[row][0] = mean;
      sh.stats[row][1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    }
  }
  __syncthreads();
  for (long long i = grid_thread(); i < (long long)p.m * d; i += grid_threads()) {
    const int row = static_cast<int>(i / d);
    const int c = static_cast<int>(i % d);
    const float un = __fmul_rn(__fsub_rn(__bfloat162float(__ldcg(p.y + i)), sh.stats[row][0]),
                               sh.stats[row][1]);
    p.u[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(un, p.ln_g[c]), p.ln_b[c]));
  }
}

// F: the next layer's in_proj terms on u
template <int MT, bool INT4>
__device__ __forceinline__ void phase_inproj_terms(const Boundary& p, PhaseShared<MT>& sh) {
  if constexpr (INT4) {
    const int warp = threadIdx.x >> 5;
    w4a8_terms<MT, true>(p.u, p.d, p.m, p.d / 2, p.qi, p.si, p.ni, p.terms_i, sh.codes[warp]);
  } else {
    w8a16_terms<MT>(p.u, p.d, p.m, p.d, p.kc, p.qi, p.ni, p.terms_i, sh);
  }
}

// G: fused = bf16(sum of the terms in order [* s_in])
template <bool INT4>
__device__ __forceinline__ void phase_inproj_sums(const Boundary& p) {
  const int nt = INT4 ? p.d / (2 * W4_GROUP) : p.d / p.kc;
  for (long long i = grid_thread(); i < (long long)p.m * p.ni; i += grid_threads()) {
    const long long row = i / p.ni;
    const long long c = i % p.ni;
    float acc = 0.f;
    for (int g = 0; g < nt; ++g) {
      acc = __fadd_rn(acc, __ldcg(p.terms_i + (g * p.m + row) * p.ni + c));
    }
    if constexpr (!INT4) acc = __fmul_rn(acc, p.si[c]);
    p.fused[i] = __float2bfloat16_rn(acc);
  }
}

}  // namespace
