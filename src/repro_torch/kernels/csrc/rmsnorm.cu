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
// FLOP/byte ridge of an H100.  At the models' shapes the data is a few KB
// to ~4 MB: at 4 rows (a decode step over 4 slots) the bound is a few
// nanoseconds and a launch costs its fixed latency plus one round trip to
// memory; at 256-320 rows (a prefill) it is 0.2-1.2 us of bytes, still
// under the launch latency.  So the design keeps each thread's path short:
// every load issued before the first use, and one pass over memory.
//
// Design.  The TPU kernel normalises a [block_rows, D] tile per grid step
// and shrinks block_rows until it divides the row count.  Here:
//   * The plain norm's vector body (`rmsnorm_vec_kernel`), taken when d is
//     a multiple of 16 bytes' worth of elements (8 bf16, 4 fp32), the rows
//     and the scale are 16-byte aligned, and d <= 4096: one block per row,
//     so 4 rows spread over 4 SMs and 320 rows over all 132.  A row gets W
//     warps (1 up to 128 vectors, i.e. d <= 1024 in bf16, else 2, 4 or 8)
//     and each thread holds V <= 4 16-byte vectors of x and of the scale,
//     a compile-time count, all loaded into registers before the first use.
//     x is read once, the squares summed in fp32 (shuffles, and W partial
//     sums in shared memory when W > 1), and x * r * scale written with
//     16-byte stores.  d = 768 in bf16 is W 1, V 3; d = 1024 is W 1, V 4.
//   * Every other width, or a row that is not 16-byte aligned, takes the
//     scalar body (`rmsnorm_kernel`): one warp walks one row, four rows a
//     block, reading its row a second time from L1/L2 for the output.
//   * The gated norm's rows are wider (2048 in mamba2-370m), and a warp
//     that walks one of them waits on one memory latency per element (15
//     us a launch on an H100, whatever the row count).  So it gives each
//     row a block of 256 threads: a thread loads its (up to 16) elements of
//     y and z into registers with every load issued before the first use,
//     keeps h = y * silu(z) there, and the block sums the squares with
//     shuffles and 8 partial sums in shared memory.  y and z are read once;
//     rows of up to 4096 elements are taken.  Its gate z is a strided slice
//     of the input projection in the model, so y and z each take a row
//     stride (elements between rows; the last dimension is contiguous).
// Statistics are fp32, and x * r * scale is computed in fp32 before the
// cast back, in the reference's order.  ptxas (sm_90a, CUDA 12.8): the
// vector body 26-51 registers, no spills.
// x, y, z, scale and out share one dtype, float32 or bfloat16; out is
// contiguous [rows, D].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int WARPS = 4;                // scalar body: rows per block
constexpr int VEC_MAX_V = 4;            // vector body: vectors a thread holds
constexpr int VEC_MAX_W = 8;            // and warps a row: d <= 4096 in bf16
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

// 16 bytes of T as fp32 values, and back (bf16 rounded to nearest even).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {      // a bf16 is the high half of an fp32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  using mma::pack_bf16;
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// One row per block, W warps a row, V 16-byte vectors a thread (vector i of
// the row is thread i % (32 W), slot i / (32 W)).
template <typename T, int W, int V>
__global__ void __launch_bounds__(W * 32)
rmsnorm_vec_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                   T* __restrict__ out, int d, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int nvec = d / E;
  const long long row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  uint4 xv[V], sv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {      // every load issued first
    const int i = threadIdx.x + v * W * 32;
    xv[v] = i < nvec ? xr[i] : make_uint4(0, 0, 0, 0);
    sv[v] = i < nvec ? sr[i] : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float f[E];
    unpack(xv[v], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss += f[e] * f[e];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (W > 1) {
    __shared__ float warp_ss[W];
    if (threadIdx.x % 32 == 0) warp_ss[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += warp_ss[w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = threadIdx.x + v * W * 32;
    if (i < nvec) {
      float f[E], s[E];
      unpack(xv[v], f);
      unpack(sv[v], s);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = f[e] * r * s[e];
      orow[i] = pack(f);
    }
  }
}

template <typename T, int W, int V>
cudaError_t launch_vec(const void* x, const void* scale, void* out, int rows,
                       int d, float eps, cudaStream_t stream) {
  rmsnorm_vec_kernel<T, W, V><<<rows, W * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  const bool vec =
      d % E == 0 && nvec <= VEC_MAX_W * 32 * VEC_MAX_V &&
      (reinterpret_cast<std::uintptr_t>(x) | reinterpret_cast<std::uintptr_t>(
           scale) | reinterpret_cast<std::uintptr_t>(out)) % 16 == 0;
  if (vec) {                         // W warps a row, V vectors a thread
#define VEC(W, V) launch_vec<T, W, V>(x, scale, out, rows, d, eps, stream)
    if (nvec <= 32) return VEC(1, 1);
    if (nvec <= 64) return VEC(1, 2);
    if (nvec <= 96) return VEC(1, 3);
    if (nvec <= 128) return VEC(1, 4);
    if (nvec <= 256) return VEC(2, 4);
    if (nvec <= 512) return VEC(4, 4);
    return VEC(8, 4);
#undef VEC
  }
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
