// RMSNorm forward for NVIDIA Hopper, sm_90a, two entry points:
//   rmsnorm_fwd:        out = x * rsqrt(mean(x^2) + eps) * scale
//   gated_rmsnorm_fwd:  h = y * silu(z); out = h * rsqrt(mean(h^2) + eps) * scale
// statistics in fp32, the scale applied in fp32 before the cast back.
//
// Replaces: src/repro/kernels/rmsnorm.py:19 `_rmsnorm_kernel` (launched by
// `rmsnorm` at :50 through `_rows_call` :35, `pl.pallas_call` at :40) and
// :26 `_gated_kernel` (launched by `gated_rmsnorm` at :65, the same
// `pallas_call`), the Mamba-2 gated norm of src/repro/models/ssm.py:177.
//
// What bounds it on the card: bytes.  Each element is read, squared and
// summed, then scaled once more: ~4 FLOPs per element (~8 with the gate's
// silu) against 2-4 bytes read and 2-4 written, far below the ~295
// FLOP/byte ridge of an H100.  At the models' shapes (4 to 512 rows of 768
// for the plain norm, 4 to 320 rows of 2048 for the gated one) the data is
// a few KB to ~4 MB, so in practice a launch costs its fixed latency.
//
// Design.  The TPU kernel normalises a [block_rows, D] tile per grid step
// and shrinks block_rows until it divides the row count.  Here the plain
// norm gives one warp one row: its lanes stride over the row with
// neighbouring lanes on neighbouring addresses (coalesced), sum the squares
// in fp32, combine the sum with shuffles, then write x * r * scale in fp32
// before the cast back, in the reference's order.  Four warps share a
// block; any row count works, since a warp past the last row simply exits.
// It reads its row a second time from L1/L2.  The gated norm's rows are
// wider (2048 in mamba2-370m), and a warp that walks one of them waits on
// one memory latency per element (15 us a launch on an H100, whatever the
// row count).  So it gives each row a block of 256 threads: a thread loads
// its (up to 16) elements of y and z into registers with every load issued
// before the first use, keeps h = y * silu(z) there, and the block sums
// the squares with shuffles and 8 partial sums in shared memory.  y and z
// are read once; rows of up to 4096 elements are taken.  Its gate z is a
// strided slice of the input projection in the model, so y and z each take
// a row stride (elements between rows; the last dimension is contiguous).
// x, y, z, scale and out share one dtype, float32 or bfloat16; out is
// contiguous [rows, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int GATED_THREADS = 256;      // one block per gated row
constexpr int GATED_MAX_V = 16;         // values a thread holds: d <= 4096

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

template <typename T>
__global__ void __launch_bounds__(GATED_THREADS)
gated_rmsnorm_kernel(const T* __restrict__ y, const T* __restrict__ z,
                     const T* __restrict__ scale, T* __restrict__ out,
                     int d, long long y_stride, long long z_stride,
                     float eps) {
  __shared__ float warp_ss[GATED_THREADS / 32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long row = blockIdx.x;
  const T* yr = y + row * y_stride;
  const T* zr = z + row * z_stride;
  float hv[GATED_MAX_V], zv[GATED_MAX_V];
#pragma unroll
  for (int v = 0; v < GATED_MAX_V; ++v) {  // every load issued first
    const int i = threadIdx.x + v * GATED_THREADS;
    hv[v] = i < d ? to_f32(yr[i]) : 0.f;
    zv[v] = i < d ? to_f32(zr[i]) : 0.f;
  }
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < GATED_MAX_V; ++v) {  // h = y * silu(z); 0 past d
    hv[v] *= zv[v] / (1.f + expf(-zv[v]));
    ss += hv[v] * hv[v];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  ss = 0.f;
#pragma unroll
  for (int w = 0; w < GATED_THREADS / 32; ++w) ss += warp_ss[w];
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int v = 0; v < GATED_MAX_V; ++v) {
    const int i = threadIdx.x + v * GATED_THREADS;
    if (i < d) orow[i] = from_f32<T>(hv[v] * r * to_f32(scale[i]));
  }
}

template <typename T>
cudaError_t launch_gated(const void* y, const void* z, const void* scale,
                         void* out, int rows, int d, long long y_stride,
                         long long z_stride, float eps, cudaStream_t stream) {
  gated_rmsnorm_kernel<T><<<rows, GATED_THREADS, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<const T*>(scale), static_cast<T*>(out), d, y_stride,
      z_stride, eps);
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

// y [rows, d] with row stride y_stride, z [rows, d] with row stride
// z_stride (elements; the last dimension contiguous), scale [d], out
// [rows, d] contiguous, all in one dtype.  bf16: 1 for bfloat16, 0 for
// float32.  Returns a cudaError_t (0 on success).
extern "C" int gated_rmsnorm_fwd(const void* y, const void* z,
                                 const void* scale, void* out, int bf16,
                                 int rows, int d, long long y_stride,
                                 long long z_stride, float eps,
                                 void* stream) {
  if (rows <= 0 || d <= 0 || d > GATED_THREADS * GATED_MAX_V || y_stride < d
      || z_stride < d)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_gated<__nv_bfloat16>(y, z, scale, out, rows, d, y_stride,
                                       z_stride, eps, st);
  return launch_gated<float>(y, z, scale, out, rows, d, y_stride, z_stride,
                             eps, st);
}
