// A check of the bf16 wgmma forms that the flash kernels (flash_attn_fwd.cu,
// K1; flash_attn_bwd.cu, K9a and K9b) build on, one warpgroup a launch:
// D (64 x N, fp32) = A (64 x K) B with A and B bf16 row-major in device
// memory, each copied into shared memory in the 128-byte-swizzled panels a
// 64-column TMA box writes.  B's layout names the form:
//   B K-major, given as (N, K) rows: ss, A from shared memory too
//       (D = A B^T); N = 48, 64 or 80, K = 128 or 256;
//   B MN-major, given as (K, N) rows: rs, A from registers, B through
//       trans-b (D = A B); N = 128 or 256, K = 32, 48 or 64.
// tests/test_torch_cuda.py holds each against torch.matmul.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_wgmma.cuh"

using namespace tma_wgmma;
using namespace flash_wgmma;

namespace {

constexpr int ROWS = 64;  // A's rows: one warpgroup's product

// rows x cols row-major bf16 -> 64-column swizzled panels of rows x 128 bytes
__device__ void to_sw128(uint8_t* dst, const __nv_bfloat16* src, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols / 8; i += blockDim.x) {
    const int r = i / (cols / 8), c16 = i % (cols / 8);  // 16-byte chunk c16 of row r
    *reinterpret_cast<uint4*>(dst + (c16 >> 3) * rows * ROW_BYTES + r * ROW_BYTES +
                              (((c16 & 7) ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(src + (long long)r * cols + c16 * 8);
  }
}

template <int N, bool KMAJOR>
__global__ void __launch_bounds__(128) wgmma_forms_kernel(const __nv_bfloat16* a,
                                                          const __nv_bfloat16* b, float* d, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align_1024(smem_raw);
  uint8_t* sb = sa + (KMAJOR ? ROWS * k * 2 : 0);
  if (KMAJOR) {
    to_sw128(sa, a, ROWS, k);
    to_sw128(sb, b, N, k);
  } else {
    to_sw128(sb, b, k, N);
  }
  fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int kk = 0; kk < k / 16; ++kk) {  // one k16 step at a time: A's registers change
    wgmma_fence();
    fence_acc(acc);
    if constexpr (KMAJOR) {
      Wgmma<N>::ss(acc, kmajor(sa, kk, ROWS * ROW_BYTES), kmajor(sb, kk, N * ROW_BYTES), 1);
    } else {
      const uint32_t* a32 = reinterpret_cast<const uint32_t*>(a);
      const int c = 8 * kk + t, kw = k / 2;  // the bf16 pair at k 16 kk + 2t
      const uint32_t af[4] = {a32[r0 * kw + c], a32[(r0 + 8) * kw + c], a32[r0 * kw + c + 4],
                              a32[(r0 + 8) * kw + c + 4]};
      Wgmma<N>::template rs<1>(acc, af, sw128_desc_mn(sb + kk * 2048, k * ROW_BYTES));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + 2 * t + (i & 1);
    d[row * N + col] = acc[i];
  }
}

template <int N, bool KMAJOR>
cudaError_t launch_forms(const void* a, const void* b, float* d, int k, cudaStream_t stream) {
  const int smem = (KMAJOR ? (ROWS + N) * k * 2 : k * N * 2) + 1024;
  const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_forms_kernel<N, KMAJOR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  wgmma_forms_kernel<N, KMAJOR><<<1, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), d, k);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes; returns a cudaError_t (0 on success).  a (64, k);
// b (n, k) if b_kmajor, else (k, n); d (64, n) fp32.
extern "C" int magma_wgmma_forms_check(const void* a, const void* b, float* d, int n, int k,
                                       int b_kmajor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b_kmajor) {
    if (k != 128 && k != 256) return (int)cudaErrorInvalidValue;
    switch (n) {
      case 48: return (int)launch_forms<48, true>(a, b, d, k, st);
      case 64: return (int)launch_forms<64, true>(a, b, d, k, st);
      case 80: return (int)launch_forms<80, true>(a, b, d, k, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (k != 32 && k != 48 && k != 64) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 128: return (int)launch_forms<128, false>(a, b, d, k, st);
    case 256: return (int)launch_forms<256, false>(a, b, d, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
