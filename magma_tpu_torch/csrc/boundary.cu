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
// the v1 mlp adapter and m = 1: the dual's nibbles and scales (42.6 MB), the
// adapter's int8 weights (8.4 MB) and the next in_proj's nibbles and scales
// (60.6 MB), about 112 MB -> 33.5 us at 3.35 TB/s.  Operations are nothing.
//
// What the design does about it: the phases depend on each other across
// the whole output (the adapter's up product needs all of h, the LN all of
// y, the in_proj all of u), which no one block owns.  So, as K5 does, the
// kernel is one cooperative launch of at most the co-resident block count,
// with cooperative_groups::this_grid().sync() between the phases:
//   A  dual terms: warp items (group, 32-column slice), the W4A8 group term
//      of w4a8.cuh written to an fp32 scratch (40 groups x 128 slices);
//   B  a, m: each element sums its groups' terms in order (the plain
//      version's bits) and adds the biases in bf16;
//   C  adapter down products (block items, the int8 GEMV of int8_gemv.cuh),
//      h rounded to bf16 into scratch;
//   D  adapter up products and the residual: y;
//   E  LN: every block computes the rows' statistics itself from y (4096
//      values a row, cheaper than another barrier), then its share of u;
//   F  in_proj terms: warp items (group, slice) on u, as in A (8 x 896);
//   G  fused: each element sums its 8 terms in order.
// No float atomics: every sum has a fixed order and the result repeats
// from run to run.  Scratch (terms, a, m, h) comes from the wrapper.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"
#include "w4a8.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ROWS = 8;

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

struct Params {
  int m, d, f, ni;
  float eps;
  const __nv_bfloat16 *ctx, *mh, *x, *u_in;  // (m, d), (m, f), (m, d), (m, d) or null
  const int8_t* q4d;                         // (d/2 + f/2, d)
  const float* s4d;                          // (d/256 + f/256, d)
  const float *b_fc_out, *ln_g, *ln_b, *o_bias;  // (d,); o_bias may be null
  Adapter ad[2];                             // 0: attention, 1: mlp
  const int8_t* q4i;                         // (d/2, ni) or null (last layer)
  const float* s4i;                          // (d/256, ni)
  __nv_bfloat16 *y, *u, *fused;              // (m, d), (m, d), (m, ni)
  float *terms_d, *terms_i;                  // (d/512 + f/512, m, d), (d/512, m, ni)
  __nv_bfloat16 *ab, *mb;                    // (m, d)
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

// the W4A8 terms of one product, warp items (group, slice) over the grid:
// terms[g][row][col] for rows < p.m
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

template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS) boundary_kernel(const Params p) {
  __shared__ __align__(16) int8_t codes[GEMV_WARPS][2][MT][W4_GROUP];
  __shared__ float red[GEMV_WARPS][MT][GEMV_SLICE];
  __shared__ float stats[MT][2];  // mean, 1 / sqrt(var + eps)
  __shared__ float sum_red[GEMV_WARPS];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x;
  const int tm = t / GEMV_SLICE;  // the (row, column) a thread finishes in C, D
  const int tj = t % GEMV_SLICE;
  const bool mine = t < MT * GEMV_SLICE && tm < p.m;
  const long long gtid = (long long)blockIdx.x * GEMV_THREADS + t;
  const long long nthreads = (long long)gridDim.x * GEMV_THREADS;
  const int d = p.d;
  const int nko = d / (2 * W4_GROUP);
  const int nkf = p.f / (2 * W4_GROUP);

  // A: the dual's group terms; o_proj's groups first, then fc_out's
  w4a8_terms<MT, false>(p.ctx, d, p.m, d / 2, p.q4d, p.s4d, d, p.terms_d, codes[warp]);
  w4a8_terms<MT, false>(p.mh, p.f, p.m, p.f / 2, p.q4d + (long long)(d / 2) * d,
                        p.s4d + (long long)(2 * nko) * d, d,
                        p.terms_d + (long long)nko * p.m * d, codes[warp]);
  grid.sync();

  // B: a = bf16(acco) [+ bf16(o_bias)], m = bf16(accf) + bf16(b_fc_out)
  for (long long i = gtid; i < (long long)p.m * d; i += nthreads) {
    const int row = static_cast<int>(i / d);
    const int c = static_cast<int>(i % d);
    float ao = 0.f, af = 0.f;
    for (int g = 0; g < nko; ++g) {
      ao = __fadd_rn(ao, __ldcg(p.terms_d + ((long long)g * p.m + row) * d + c));
    }
    for (int g = nko; g < nko + nkf; ++g) {
      af = __fadd_rn(af, __ldcg(p.terms_d + ((long long)g * p.m + row) * d + c));
    }
    __nv_bfloat16 a = __float2bfloat16_rn(ao);
    if (p.o_bias) a = bf16_add(a, __float2bfloat16_rn(p.o_bias[c]));
    p.ab[i] = a;
    p.mb[i] = bf16_add(__float2bfloat16_rn(af), __float2bfloat16_rn(p.b_fc_out[c]));
  }
  grid.sync();

  // C: each adapter's down product, h = bf16(relu(src @ Wd * sd + bd))
  {
    const int s0 = p.ad[0].dh / GEMV_SLICE, s1 = p.ad[1].dh / GEMV_SLICE;
    for (int item = blockIdx.x; item < s0 + s1; item += gridDim.x) {
      const int k = item < s0 ? 0 : 1;
      const Adapter& ad = p.ad[k];
      const int slice = k == 0 ? item : item - s0;
      const __nv_bfloat16* src = ad.src_in ? p.u_in : (k == 0 ? p.ab : p.mb);
      slice_gemv<MT>(src, d, p.m, ad.wd, ad.dh, 0, d, slice, red);
      if (mine) {
        const int c = slice * GEMV_SLICE + tj;
        const float v = fmaxf(warp_total<MT>(red, tm, tj) * ad.sd[c] + ad.bd[c], 0.f);
        ad.h[(long long)tm * ad.dh + c] = __float2bfloat16_rn(v);
      }
      __syncthreads();  // red is read before the next item overwrites it
    }
  }
  grid.sync();

  // D: the up products, a += bf16(z_attn), m += bf16(z_mlp), y = x + a + m
  for (int slice = blockIdx.x; slice < d / GEMV_SLICE; slice += gridDim.x) {
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const Adapter& ad = p.ad[k];
      if (ad.dh == 0) continue;
      slice_gemv<MT>(ad.h, ad.dh, p.m, ad.wu, d, 0, ad.dh, slice, red);
      if (mine) {
        const int c = slice * GEMV_SLICE + tj;
        z[k] = warp_total<MT>(red, tm, tj) * ad.su[c] + ad.bu[c];
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
  grid.sync();

  // E: the LN of each row; every block computes the statistics itself
  for (int row = 0; row < p.m; ++row) {
    const __nv_bfloat16* yr = p.y + (long long)row * d;
    float s = 0.f;
    for (int c = t; c < d; c += GEMV_THREADS) s += __bfloat162float(__ldcg(yr + c));
    const float mean = __fdiv_rn(block_sum(s, sum_red), (float)d);
    float q = 0.f;
    for (int c = t; c < d; c += GEMV_THREADS) {
      const float dv = __fsub_rn(__bfloat162float(__ldcg(yr + c)), mean);
      q = __fadd_rn(q, __fmul_rn(dv, dv));
    }
    const float var = __fdiv_rn(block_sum(q, sum_red), (float)d);
    if (t == 0) {
      stats[row][0] = mean;
      stats[row][1] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, p.eps)));
    }
  }
  __syncthreads();
  for (long long i = gtid; i < (long long)p.m * d; i += nthreads) {
    const int row = static_cast<int>(i / d);
    const int c = static_cast<int>(i % d);
    const float un = __fmul_rn(__fsub_rn(__bfloat162float(__ldcg(p.y + i)), stats[row][0]),
                               stats[row][1]);
    p.u[i] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(un, p.ln_g[c]), p.ln_b[c]));
  }
  if (p.q4i == nullptr) return;  // the last layer: no in_proj
  grid.sync();

  // F: the next layer's in_proj group terms on u
  w4a8_terms<MT, true>(p.u, d, p.m, d / 2, p.q4i, p.s4i, p.ni, p.terms_i, codes[warp]);
  grid.sync();

  // G: fused = bf16(sum of the terms in group order)
  for (long long i = gtid; i < (long long)p.m * p.ni; i += nthreads) {
    const long long row = i / p.ni;
    const long long c = i % p.ni;
    float acc = 0.f;
    for (int g = 0; g < nko; ++g) {
      acc = __fadd_rn(acc, __ldcg(p.terms_i + (g * p.m + row) * p.ni + c));
    }
    p.fused[i] = __float2bfloat16_rn(acc);
  }
}

constexpr int MAX_DEVICES = 64;

// co-resident blocks of boundary_kernel<MT> on device dev (-1 where the
// device has no cooperative launch), queried at its first launch only
template <int MT>
cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[MAX_DEVICES] = {};  // 0: not queried yet
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, boundary_kernel<MT>,
                                                          GEMV_THREADS, 0);
    }
    if (err != cudaSuccess) return err;
    cached[dev] = (coop && per_sm > 0) ? per_sm * sms : -1;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

template <int MT>
cudaError_t launch(Params p, cudaStream_t stream) {
  int dev = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_blocks<MT>(dev, &resident);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(boundary_kernel<MT>),
                                     dim3(resident), dim3(GEMV_THREADS), args, 0, stream);
}

}  // namespace

// C entry for ctypes.  flags: 1 attention adapter, 2 it reads u_in, 4 mlp
// adapter, 8 it reads u_in, 16 o_bias, 32 w_in (not the last layer).  Rows
// (ctx, mh, x, u_in) are bf16, contiguous, 16-byte aligned; d and f
// multiples of 512, ni and each adapter's dh multiples of 128; the pointers
// of what the flags leave out may be null.  Returns a cudaError_t.
extern "C" int magma_boundary(
    int m, int d, int f, int ni, int dh_a, int dh_m, int flags, float ln_eps,
    const void* ctx, const void* mh, const void* x, const void* u_in, const void* q4d,
    const float* s4d, const float* b_fc_out, const float* ln_g, const float* ln_b,
    const float* o_bias, const void* a_wd, const float* a_sd, const float* a_bd,
    const void* a_wu, const float* a_su, const float* a_bu, const void* m_wd,
    const float* m_sd, const float* m_bd, const void* m_wu, const float* m_su,
    const float* m_bu, const void* q4i, const float* s4i, void* y, void* u, void* fused,
    float* terms_d, float* terms_i, void* ab, void* mb, void* h_a, void* h_m, void* stream) {
  const bool has_a = flags & 1, has_m = flags & 4, has_in = flags & 32;
  if (m < 1 || m > MAX_ROWS || d % (2 * W4_GROUP) || f % (2 * W4_GROUP) ||
      (has_in && (ni <= 0 || ni % 128)) || (has_a && (dh_a <= 0 || dh_a % 128)) ||
      (has_m && (dh_m <= 0 || dh_m % 128)) ||
      ((((flags & 2) && has_a) || ((flags & 8) && has_m)) && !u_in)) {
    return (int)cudaErrorInvalidValue;
  }
  using bf = __nv_bfloat16;
  Params p{};
  p.m = m;
  p.d = d;
  p.f = f;
  p.ni = has_in ? ni : 0;
  p.eps = ln_eps;
  p.ctx = static_cast<const bf*>(ctx);
  p.mh = static_cast<const bf*>(mh);
  p.x = static_cast<const bf*>(x);
  p.u_in = static_cast<const bf*>(u_in);
  p.q4d = static_cast<const int8_t*>(q4d);
  p.s4d = s4d;
  p.b_fc_out = b_fc_out;
  p.ln_g = ln_g;
  p.ln_b = ln_b;
  p.o_bias = (flags & 16) ? o_bias : nullptr;
  p.ad[0] = has_a ? Adapter{static_cast<const int8_t*>(a_wd), a_sd, a_bd,
                            static_cast<const int8_t*>(a_wu), a_su, a_bu, dh_a, (flags & 2) ? 1 : 0,
                            static_cast<bf*>(h_a)}
                  : Adapter{};
  p.ad[1] = has_m ? Adapter{static_cast<const int8_t*>(m_wd), m_sd, m_bd,
                            static_cast<const int8_t*>(m_wu), m_su, m_bu, dh_m, (flags & 8) ? 1 : 0,
                            static_cast<bf*>(h_m)}
                  : Adapter{};
  p.q4i = has_in ? static_cast<const int8_t*>(q4i) : nullptr;
  p.s4i = s4i;
  p.y = static_cast<bf*>(y);
  p.u = static_cast<bf*>(u);
  p.fused = static_cast<bf*>(fused);
  p.terms_d = terms_d;
  p.terms_i = terms_i;
  p.ab = static_cast<bf*>(ab);
  p.mb = static_cast<bf*>(mb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m == 1) err = launch<1>(p, st);
  else if (m == 2) err = launch<2>(p, st);
  else if (m <= 4) err = launch<4>(p, st);
  else err = launch<8>(p, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
