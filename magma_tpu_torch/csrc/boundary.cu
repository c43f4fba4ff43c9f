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
// with cooperative_groups::this_grid().sync() between the phases A-G of
// layer_phases.cuh (shared with K7 and K8): dual terms (warp items (group,
// 32-column slice), 40 groups x 128 slices), a and m, adapter down, adapter
// up and the residual, LN, in_proj terms (8 x 896), fused.  No float
// atomics: every sum has a fixed order and the result repeats from run to
// run.  Scratch (terms, a, m, h) comes from the wrapper.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "layer_phases.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ROWS = 8;

template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS) boundary_kernel(const Boundary p) {
  __shared__ __align__(16) PhaseShared<MT> sh;
  cg::grid_group grid = cg::this_grid();
  phase_dual_terms<MT, true, false>(p, sh);
  grid.sync();
  phase_branch_sums<true>(p);
  grid.sync();
  phase_adapter_down<MT>(p, sh);
  grid.sync();
  phase_adapter_up_residual<MT>(p, sh);
  grid.sync();
  phase_layer_norm<MT>(p, sh);
  if (p.qi == nullptr) return;  // the last layer: no in_proj
  grid.sync();
  phase_inproj_terms<MT, true>(p, sh);
  grid.sync();
  phase_inproj_sums<true>(p);
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
cudaError_t launch(Boundary p, cudaStream_t stream) {
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
  Boundary p{};
  p.m = m;
  p.d = d;
  p.f = f;
  p.ni = has_in ? ni : 0;
  p.eps = ln_eps;
  p.ctx = static_cast<const bf*>(ctx);
  p.mh = static_cast<const bf*>(mh);
  p.x = static_cast<const bf*>(x);
  p.u_in = static_cast<const bf*>(u_in);
  p.qd = static_cast<const int8_t*>(q4d);
  p.sd = s4d;
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
  p.qi = has_in ? static_cast<const int8_t*>(q4i) : nullptr;
  p.si = s4i;
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
