// RMSNorm forward for NVIDIA Hopper, sm_90a:
//   out = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32.
//
// Replaces: src/repro/kernels/rmsnorm.py:19 `_rmsnorm_kernel` (launched by
// `rmsnorm` at :50 through `_rows_call` :35, `pl.pallas_call` at :40).
//
// What bounds it on the card: bytes.  Each element is read, squared and
// summed, then scaled once more: ~4 FLOPs per element against 2-4 bytes
// read and 2-4 written, far below the ~295 FLOP/byte ridge of an H100.
// At the model's shapes (4 to 512 rows of 768) the data is a few KB to
// ~1.5 MB, so in practice a launch costs its fixed latency.
//
// Design.  The TPU kernel normalises a [block_rows, D] tile per grid step
// and shrinks block_rows until it divides the row count.  Here one warp owns
// one row: its lanes stride over the row with neighbouring lanes on
// neighbouring addresses (coalesced), sum x^2 in fp32, combine the sum
// with shuffles, then write x * r * scale in fp32 before the cast back, in
// the reference's order.  Four warps share a block; any row count works,
// since a warp past the last row simply exits.  The second read of the row
// is served from L1/L2.  x and out are contiguous [rows, D]; scale is [D]
// in x's dtype, float32 or bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;           // the whole warp leaves together
  const T* xr = x + static_cast<long long>(row) * d;
  T* orow = out + static_cast<long long>(row) * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float f = to_f32(xr[i]);
    ss += f * f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(scale[i]));
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  rmsnorm_kernel<T><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out [rows, d] contiguous; scale [d] in x's dtype.  bf16: 1 for
// bfloat16, 0 for float32.  Returns a cudaError_t (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int bf16, int rows, int d, float eps,
                           void* stream) {
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, st);
  return launch<float>(x, scale, out, rows, d, eps, st);
}
