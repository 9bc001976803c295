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
//   * x takes a row stride (elements between rows; the last dimension is
//     contiguous), as y and z of the gated norm do: MLA's kv_norm
//     (minicpm3-4b) normalises the first 256 columns of a 288-wide
//     projection, rows 288 elements apart, a whole number of vectors, so
//     the vector body takes them; a stride that is not takes the scalar
//     body.
//   * The gated norm's vector body (`gated_rmsnorm_vec_kernel`) is the
//     same cure: one block per row, y, z and the scale loaded as 16-byte
//     vectors into registers with every load issued before the first use,
//     h = y * silu(z) kept there, the squares summed in fp32 by shuffles
//     and per-warp partial sums, and 16-byte stores.  A row gets up to 8
//     warps of one vector a thread before a thread takes a second, the
//     shortest path for each thread: d = 2048 in bf16 (mamba2-370m) is 8
//     warps of one vector each.  Past 1024 vectors a row takes 16 warps of
//     4 vectors (jamba's d = 16384 in bf16: 2048 vectors, 512 threads),
//     and past 2048, 32 warps of 4 (d = 16384 in fp32: 4096 vectors, the
//     whole 1024 threads of a block), so every row up to GATED_MAX_WIDTH
//     stays in registers.  (Only fp32 rows reach 32 warps: in bf16 with an
//     fp32 scale that instance would spill 76 bytes under its 64-register
//     bound.)  Its gate z is a strided slice of the input
//     projection in the model, so y and z each take a row stride
//     (elements between rows; the last dimension is contiguous); the
//     models' gates have row strides of 4384 (mamba2-370m) and 33056
//     (jamba) elements, whole numbers of vectors, so they take this body.
//   * The gated norm's scalar body (`gated_rmsnorm_kernel`), for widths
//     that are not a whole number of vectors and rows whose y or z pointer
//     or row stride is not 16-byte aligned: a block of 256 threads a row
//     up to 4096 elements, 1024 threads up to 16384, each holding up to 16
//     elements of y and z loaded with every load issued first (a warp
//     walking a row of 2048 waited on one memory latency per element, 15
//     us a launch).  It took 3.9 / 5.2 us at 4 / 320 rows of 2048 on an
//     H100.
//   * GATED_MAX_WIDTH (16384, 1024 threads x 16 values) is the widest row
//     either gated body holds in registers: the widest gate of the
//     repo's models (jamba's d_inner).  A wider row is refused.
// Statistics are fp32, and x * r * scale is computed in fp32 before the
// cast back, in the reference's order (repro/models/layers.py:34,
// repro/models/ssm.py:181).
// Dtypes: x, y, z and out share one dtype, float32 or bfloat16, and the
// scale is in that dtype or, with bfloat16 activations, float32: the
// reference keeps a 1-D scale in fp32 under its cast_params
// (repro/train/train_step.py:30) and applies it in fp32, as here.  out is
// contiguous [rows, D] whatever x's row stride.  ptxas (sm_90a, CUDA
// 12.8): every instance 23-80 registers, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int WARPS = 4;                // scalar body: rows per block
constexpr int VEC_MAX_V = 4;            // vector bodies: vectors a thread holds
constexpr int VEC_MAX_W = 8;            // and warps a row: d <= 4096 in bf16
constexpr int GATED_VEC_MAX_W = 32;     // the gated one's: d <= 16384 in fp32
constexpr int GATED_MAX_V = 16;         // gated scalar body: values a thread
constexpr int GATED_MAX_WIDTH = 1024 * GATED_MAX_V;   // d <= 16384

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

// z * sigmoid(z) in fp32 for activations of type T.  For bfloat16, from
// the hardware's exp2 and reciprocal (__expf, __fdividef): a few ulp of
// fp32, far below the output's rounding to bf16, where the accurate expf
// and division are tens of instructions an element on the path of every
// thread.  For float32, the exactness path, the accurate expf and
// division.  0 where exp(-z) overflows.
template <typename T> __device__ __forceinline__ float silu(float z) {
  if constexpr (sizeof(T) == sizeof(float))
    return z / (1.f + expf(-z));
  else
    return __fdividef(z, 1.f + __expf(-z));
}

// T: the activations' dtype; S: the scale's (T, or float with a bf16 T).
template <typename T, typename S>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int rows, int d, long long x_stride,
               float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;           // the whole warp leaves together
  const T* xr = x + row * x_stride;
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

// E values of S held as raw 16-byte words (E * sizeof(S) / 16 of them):
// the elements of one 16-byte vector of the activations.
template <typename S, int E>
struct Vec {
  uint4 w[E * sizeof(S) / 16];
};

// Vector i of E values at row, or zeros when valid is false.
template <typename S, int E>
__device__ __forceinline__ Vec<S, E> load_vec(const S* row, int i,
                                              bool valid) {
  Vec<S, E> v;
  const uint4* p = reinterpret_cast<const uint4*>(row + static_cast<long long>(i) * E);
#pragma unroll
  for (int k = 0; k < E * static_cast<int>(sizeof(S)) / 16; ++k)
    v.w[k] = valid ? p[k] : make_uint4(0, 0, 0, 0);
  return v;
}

// The values as fp32 (a bf16 is the high half of an fp32), and back
// (bf16 rounded to nearest even).
__device__ __forceinline__ void unpack(const Vec<__nv_bfloat16, 8>& v,
                                       float (&f)[8]) {
  const unsigned w[4] = {v.w[0].x, v.w[0].y, v.w[0].z, v.w[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <int E>
__device__ __forceinline__ void unpack(const Vec<float, E>& v, float (&f)[E]) {
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    f[4 * k] = __uint_as_float(v.w[k].x);
    f[4 * k + 1] = __uint_as_float(v.w[k].y);
    f[4 * k + 2] = __uint_as_float(v.w[k].z);
    f[4 * k + 3] = __uint_as_float(v.w[k].w);
  }
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

// The sum of ss over the block's W warps (shuffles, then W partial sums).
template <int W>
__device__ __forceinline__ float block_sum(float ss) {
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
  return ss;
}

// One row per block, W warps a row, V 16-byte vectors of x a thread
// (vector i of the row is thread i % (32 W), slot i / (32 W)).
template <typename T, typename S, int W, int V>
__global__ void __launch_bounds__(W * 32)
rmsnorm_vec_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ out, int d, long long x_stride, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements a vector
  const int nvec = d / E;
  const long long row = blockIdx.x;
  Vec<T, E> xv[V];
  Vec<S, E> sv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {      // every load issued first
    const int i = threadIdx.x + v * W * 32;
    xv[v] = load_vec<T, E>(x + row * x_stride, i, i < nvec);
    sv[v] = load_vec<S, E>(scale, i, i < nvec);
  }
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float f[E];
    unpack(xv[v], f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss += f[e] * f[e];
  }
  const float r = rsqrtf(block_sum<W>(ss) / static_cast<float>(d) + eps);
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

template <typename T, typename S, int W, int V>
cudaError_t launch_vec(const void* x, const void* scale, void* out, int rows,
                       int d, long long x_stride, float eps,
                       cudaStream_t stream) {
  rmsnorm_vec_kernel<T, S, W, V><<<rows, W * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), d, x_stride, eps);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, long long x_stride, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  if (d % E == 0 && x_stride % E == 0 &&
      nvec <= VEC_MAX_W * 32 * VEC_MAX_V && aligned16(x) &&
      aligned16(scale) && aligned16(out)) {  // W warps a row, V vectors a thread
#define VEC(W, V) launch_vec<T, S, W, V>(x, scale, out, rows, d, x_stride, \
                                         eps, stream)
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
  rmsnorm_kernel<T, S><<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, x_stride, eps);
  return cudaGetLastError();
}

// The gated norm's vector body: one row per block, W warps a row, V
// 16-byte vectors of y, of z and of the scale a thread, all loaded before
// the first use; h = y * silu(z) stays in registers.
template <typename T, typename S, int W, int V>
__global__ void __launch_bounds__(W * 32)
gated_rmsnorm_vec_kernel(const T* __restrict__ y, const T* __restrict__ z,
                         const S* __restrict__ scale, T* __restrict__ out,
                         int d, long long y_stride, long long z_stride,
                         float eps) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  const long long row = blockIdx.x;
  Vec<T, E> yv[V], zv[V];
  Vec<S, E> sv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {      // every load issued first
    const int i = threadIdx.x + v * W * 32;
    yv[v] = load_vec<T, E>(y + row * y_stride, i, i < nvec);
    zv[v] = load_vec<T, E>(z + row * z_stride, i, i < nvec);
    sv[v] = load_vec<S, E>(scale, i, i < nvec);
  }
  float hv[V][E];
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {      // h = y * silu(z); 0 past d
    float zf[E];
    unpack(yv[v], hv[v]);
    unpack(zv[v], zf);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      hv[v][e] *= silu<T>(zf[e]);
      ss += hv[v][e] * hv[v][e];
    }
  }
  const float r = rsqrtf(block_sum<W>(ss) / static_cast<float>(d) + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int i = threadIdx.x + v * W * 32;
    if (i < nvec) {
      float s[E];
      unpack(sv[v], s);
#pragma unroll
      for (int e = 0; e < E; ++e) hv[v][e] = hv[v][e] * r * s[e];
      orow[i] = pack(hv[v]);
    }
  }
}

// The gated norm's scalar body, for rows the vector body does not take:
// a block of THREADS threads a row, up to 16 values a thread.
template <typename T, typename S, int THREADS>
__global__ void __launch_bounds__(THREADS)
gated_rmsnorm_kernel(const T* __restrict__ y, const T* __restrict__ z,
                     const S* __restrict__ scale, T* __restrict__ out,
                     int d, long long y_stride, long long z_stride,
                     float eps) {
  const long long row = blockIdx.x;
  const T* yr = y + row * y_stride;
  const T* zr = z + row * z_stride;
  float hv[GATED_MAX_V], zv[GATED_MAX_V];
#pragma unroll
  for (int v = 0; v < GATED_MAX_V; ++v) {  // every load issued first
    const int i = threadIdx.x + v * THREADS;
    hv[v] = i < d ? to_f32(yr[i]) : 0.f;
    zv[v] = i < d ? to_f32(zr[i]) : 0.f;
  }
  float ss = 0.f;
#pragma unroll
  for (int v = 0; v < GATED_MAX_V; ++v) {  // h = y * silu(z); 0 past d
    hv[v] *= silu<T>(zv[v]);
    ss += hv[v] * hv[v];
  }
  const float r = rsqrtf(block_sum<THREADS / 32>(ss) /
                         static_cast<float>(d) + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int v = 0; v < GATED_MAX_V; ++v) {
    const int i = threadIdx.x + v * THREADS;
    if (i < d) orow[i] = from_f32<T>(hv[v] * r * to_f32(scale[i]));
  }
}

template <typename T, typename S, int W, int V>
cudaError_t launch_gated_vec(const void* y, const void* z, const void* scale,
                             void* out, int rows, int d, long long y_stride,
                             long long z_stride, float eps,
                             cudaStream_t stream) {
  gated_rmsnorm_vec_kernel<T, S, W, V><<<rows, W * 32, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(z),
      static_cast<const S*>(scale), static_cast<T*>(out), d, y_stride,
      z_stride, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_gated(const void* y, const void* z, const void* scale,
                         void* out, int rows, int d, long long y_stride,
                         long long z_stride, float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  if (d % E == 0 && y_stride % E == 0 && z_stride % E == 0 &&
      nvec <= GATED_VEC_MAX_W * 32 * VEC_MAX_V && aligned16(y) &&
      aligned16(z) && aligned16(scale) && aligned16(out)) {
#define VEC(W, V) launch_gated_vec<T, S, W, V>(y, z, scale, out, rows, d, \
                                               y_stride, z_stride, eps, stream)
    if (nvec <= 32) return VEC(1, 1);
    if (nvec <= 64) return VEC(2, 1);
    if (nvec <= 128) return VEC(4, 1);
    if (nvec <= 256) return VEC(8, 1);
    if (nvec <= 512) return VEC(8, 2);
    if (nvec <= 1024) return VEC(8, 4);
    if constexpr (E == 8) {     // bf16: d <= GATED_MAX_WIDTH is 2048 vectors
      return VEC(16, 4);
    } else {
      if (nvec <= 2048) return VEC(16, 4);
      return VEC(32, 4);        // fp32 past 8192
    }
#undef VEC
  }
#define SCALAR(THREADS)                                                   \
  gated_rmsnorm_kernel<T, S, THREADS><<<rows, THREADS, 0, stream>>>(      \
      static_cast<const T*>(y), static_cast<const T*>(z),                 \
      static_cast<const S*>(scale), static_cast<T*>(out), d, y_stride,    \
      z_stride, eps)
  if (d <= 256 * GATED_MAX_V)
    SCALAR(256);
  else
    SCALAR(1024);
#undef SCALAR
  return cudaGetLastError();
}

}  // namespace

// x [rows, d] with row stride x_stride (elements; the last dimension
// contiguous), out [rows, d] contiguous; scale [d].  bf16: 1 for bfloat16
// x and out, 0 for float32; scale_f32: 1 for a float32 scale with bfloat16
// x, 0 for a scale in x's dtype.  Returns a cudaError_t (0 on success).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int bf16, int scale_f32, int rows, int d,
                           long long x_stride, float eps, void* stream) {
  if (rows <= 0 || d <= 0 || x_stride < d || (scale_f32 && !bf16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS x, scale, out, rows, d, x_stride, eps, st
  if (!bf16) return launch<float, float>(ARGS);
  if (scale_f32) return launch<__nv_bfloat16, float>(ARGS);
  return launch<__nv_bfloat16, __nv_bfloat16>(ARGS);
#undef ARGS
}

// y [rows, d] with row stride y_stride, z [rows, d] with row stride
// z_stride (elements; the last dimension contiguous), scale [d], out
// [rows, d] contiguous.  bf16: 1 for bfloat16 y, z and out, 0 for float32;
// scale_f32 as for rmsnorm_fwd.  Returns a cudaError_t (0 on success).
extern "C" int gated_rmsnorm_fwd(const void* y, const void* z,
                                 const void* scale, void* out, int bf16,
                                 int scale_f32, int rows, int d,
                                 long long y_stride, long long z_stride,
                                 float eps, void* stream) {
  if (rows <= 0 || d <= 0 || d > GATED_MAX_WIDTH || y_stride < d
      || z_stride < d || (scale_f32 && !bf16))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GATED_ARGS y, z, scale, out, rows, d, y_stride, z_stride, eps, st
  if (!bf16) return launch_gated<float, float>(GATED_ARGS);
  if (scale_f32) return launch_gated<__nv_bfloat16, float>(GATED_ARGS);
  return launch_gated<__nv_bfloat16, __nv_bfloat16>(GATED_ARGS);
#undef GATED_ARGS
}
