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
// and m = 1 it reads 8.4 MB of int8 weights, 2.5 us at 3.35 TB/s; the
// flops (2 * m * 2 * D * DH = 16.8 MFLOP) are nothing.  In practice the
// launch and the one grid-wide barrier between the phases set its time.
//
// What the design does about it: on a GPU the blocks that compute `out`
// need all of h, which no one block owns.  So the kernel is a cooperative
// launch (cudaLaunchCooperativeKernel) whose grid never exceeds the number
// of co-resident blocks: phase 1 writes h, slice by slice, to a bf16
// scratch that the wrapper allocates (bf16, because h is rounded to bf16
// anyway); all blocks meet at cooperative_groups::this_grid().sync(); then
// phase 2 computes slices of `out`.  Both phases are the GEMV of
// int8_gemv.cuh, which int8_matmul.cu shares: a block of 8 warps owns a
// 32-column slice and walks all of K, and the sum over K closes inside the
// block in a fixed order (deterministic, no atomics).  Phase 1 has
// DH / 32 = 32 slices and phase 2 D / 32 = 128, so the grid is 128 blocks on
// 132 SMs.  Rows come in groups of up to 8 whose accumulators stay in
// registers; m > 8 loops over the groups and re-reads the weights from L2.
// h in phase 2 is read with coherent loads: it was written in this launch.
// Measured alone (torch.profiler, chip_smoke.py, NVIDIA H100 80GB HBM3 at a
// 700 W power limit): 13.9 us at m = 1, 162 us at m = 64.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_gemv.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_ROWS = 64;

struct Params {
  const __nv_bfloat16* x;  // (m, d)
  const int8_t* wd;        // (d, dh)
  const float* sd;         // (dh,)
  const float* bd;         // (dh,)
  const int8_t* wu;        // (dh, d)
  const float* su;         // (d,)
  const float* bu;         // (d,)
  __nv_bfloat16* h;        // (m, dh) scratch
  float* out;              // (m, d)
  int m, d, dh;
};

template <int MT>
__global__ void __launch_bounds__(GEMV_THREADS) fused_adapter_kernel(const Params p) {
  __shared__ float red[GEMV_WARPS][MT][GEMV_SLICE];
  const int t = threadIdx.x;
  const int tm = t / GEMV_SLICE;  // the (row, column) this thread finishes
  const int tj = t % GEMV_SLICE;

  // phase 1: h = bf16(relu((x @ Wd) * sd + bd)), one 32-column slice at a time
  for (int slice = blockIdx.x; slice < p.dh / GEMV_SLICE; slice += gridDim.x) {
    for (int g = 0; g < p.m; g += MT) {
      const int rows = min(MT, p.m - g);
      slice_gemv<MT>(p.x + (long long)g * p.d, p.d, rows, p.wd, p.dh, 0, p.d, slice, red);
      if (t < MT * GEMV_SLICE && tm < rows) {
        const int c = slice * GEMV_SLICE + tj;
        const float v = fmaxf(warp_total<MT>(red, tm, tj) * p.sd[c] + p.bd[c], 0.f);
        p.h[(long long)(g + tm) * p.dh + c] = __float2bfloat16_rn(v);
      }
      __syncthreads();  // red is read before the next group overwrites it
    }
  }

  cg::this_grid().sync();  // all of h is written and visible

  // phase 2: out = (h @ Wu) * su + bu
  for (int slice = blockIdx.x; slice < p.d / GEMV_SLICE; slice += gridDim.x) {
    for (int g = 0; g < p.m; g += MT) {
      const int rows = min(MT, p.m - g);
      slice_gemv<MT>(p.h + (long long)g * p.dh, p.dh, rows, p.wu, p.d, 0, p.dh, slice, red);
      if (t < MT * GEMV_SLICE && tm < rows) {
        const int c = slice * GEMV_SLICE + tj;
        p.out[(long long)(g + tm) * p.d + c] = warp_total<MT>(red, tm, tj) * p.su[c] + p.bu[c];
      }
      __syncthreads();
    }
  }
}

constexpr int MAX_DEVICES = 64;

// co-resident blocks of fused_adapter_kernel<MT> on device dev (-1 where the
// device has no cooperative launch), queried at its first launch only: the
// queries cost more host time than the kernel takes
template <int MT>
cudaError_t resident_blocks(int dev, int* blocks) {
  static int cached[MAX_DEVICES] = {};  // 0: not queried yet; -1: none
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_adapter_kernel<MT>,
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
  const int want = max(p.d, p.dh) / GEMV_SLICE;
  const int grid = min(want, resident);  // co-resident, as grid.sync() needs
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fused_adapter_kernel<MT>),
                                     dim3(grid), dim3(GEMV_THREADS), args, 0, stream);
}

}  // namespace

// C entry for ctypes: x (m, d) bf16 contiguous, 1 <= m <= 64; wd (d, dh) and
// wu (dh, d) int8 contiguous; sd, bd (dh,) and su, bu (d,) fp32; h (m, dh)
// bf16 scratch; out (m, d) fp32; d and dh multiples of 128.  Returns a
// cudaError_t (0 on success).
extern "C" int magma_fused_adapter(const void* x, const void* wd, const float* sd,
                                   const float* bd, const void* wu, const float* su,
                                   const float* bu, void* h, float* out, int m, int d, int dh,
                                   void* stream) {
  if (m < 1 || m > MAX_ROWS || d <= 0 || dh <= 0 || d % 128 || dh % 128) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(wd), sd, bd,
           static_cast<const int8_t*>(wu), su, bu, static_cast<__nv_bfloat16*>(h), out,
           m, d, dh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m == 1) err = launch<1>(p, st);
  else if (m == 2) err = launch<2>(p, st);
  else if (m <= 4) err = launch<4>(p, st);
  else err = launch<8>(p, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
