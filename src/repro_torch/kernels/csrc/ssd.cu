// Mamba-2 SSD intra-chunk (diagonal block) forward for NVIDIA Hopper, sm_90a:
//
//   y[c, i, h, :] = sum_{j <= i} (C[c, i, g] . B[c, j, g])
//                   * exp(cs[c, i, h] - cs[c, j, h]) * dt[c, j, h] * x[c, j, h, :]
//
// with cs = cumsum(dt * A) over the chunk in fp32 and g = h / (H / G) the
// head's group, all arithmetic in fp32.
//
// Replaces: src/repro/kernels/ssd.py:27 `_ssd_kernel` (launched by
// `ssd_intra_chunk` at :51, `pl.pallas_call` at :63).
//
// What bounds it on the card: bytes, counted with the bf16 peak of the
// inputs.  One 256-token chunk of mamba2-370m (32 heads of 64, one group,
// state 128) moves ~3.2 MB with a bf16 x and an fp32 y, ~1 us at 3.35 TB/s,
// against ~0.15 GFLOP of causal work.  This first kernel does that work on
// the fp32 cores from shared memory, not on the tensor cores, and recomputes
// C.B for each of the heads of a group that share it (~0.45 G FMAs at that
// shape).  Nearly every FMA waits on a shared-memory read, so shared-memory
// traffic bounds it in practice: on an H100 it is slower than its plain
// PyTorch version.  Sharing C.B across a group's heads, or bf16 tensor-core
// products for C.B (exact in fp32), is the way to make it fast.
//
// Design.  The TPU kernel holds a chunk's whole [l, l, heads-of-a-group]
// decay tensor in VMEM (8 MB of fp32 at l = 256 and 32 heads); a block here
// has 227 KB.  So the work is re-tiled as flash attention is, without the
// softmax: one block of 128 threads (4 warps) owns (chunk, head, tile of
// TQ = 32 query rows) and loops over the key tiles of TK = 32 rows at or
// below the diagonal, skipping those above it.  Per key tile it stages B
// and x * dt in shared memory, forms W = (C.B) * exp(cs_i - cs_j) for the
// tile, and adds W @ (x * dt) into fp32 accumulators in registers.  Each
// thread owns rows warp + 4m (m < 8): in the W phase the W entries of key
// lane, in the y phase the outputs of columns lane + 32q (q < 4).  Rows of
// C, B and W are read as float4 (C and W broadcast to the warp, B rows
// padded by 4 floats so that a quarter-warp's 16-byte reads hit distinct
// banks), so a shared load feeds 4 to 16 FMAs.  Tiles are loaded by rows
// per warp and columns per lane, with no division.  Entries with j > i,
// where cs_i - cs_j > 0 and exp can overflow, are selected away and never
// multiplied.  The block's cumsum is a warp scan in double (each lane a
// serial segment, then shuffles), rounded to fp32: that is what
// torch.cumsum of float32 does on the CPU, and it keeps the differences
// cs_i - cs_j, whose absolute error grows with |cs|, the same on the card
// as there.  The chunk length, the head and state widths are runtime values
// (p <= 128, n <= 256; n is padded with zeros to a multiple of 4); ragged
// edges are masked.  x, B and C are read through (chunk, row,
// head-or-group) strides with the last dimension contiguous, so the model's
// strided views need no copy; dt [N, l, h] and A [h] are contiguous fp32.
// y is contiguous [N, l, h, p], in fp32 or in x's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 32;        // query rows a block owns
constexpr int TK = 32;        // key rows per tile; == TQ, so tile kt == qt
                              // is the diagonal one
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_P = 128;
constexpr int MAX_N = 256;
constexpr int ROWS = TQ / WARPS;   // rows a thread covers: warp + 4m
constexpr int COLS = MAX_P / 32;   // output columns a lane covers
constexpr int W_STRIDE = TK + 4;   // W row stride, keeps float4 alignment

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
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Strides {              // elements between chunks, rows, heads/groups
  long long chunk, row, head;
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// floats of dynamic shared memory: cs, C tile, B tile, x*dt tile, W
__host__ __device__ __forceinline__ size_t smem_floats(int l, int n, int p) {
  const int n4 = round4(n);
  return static_cast<size_t>(round4(l)) + TQ * n4 + TK * (n4 + 4) + TK * p
         + TQ * W_STRIDE;
}

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
ssd_intra_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const T* __restrict__ B,
                       const T* __restrict__ C, O* __restrict__ out, int l,
                       int h, int p, int hg, int n, Strides xs, Strides bs,
                       Strides cs_) {
  extern __shared__ float4 smem4[];
  const int qt = blockIdx.x;            // query tile
  const int head = blockIdx.y;
  const int chunk = blockIdx.z;
  const int grp = head / hg;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q0 = qt * TQ;
  const int l_end = min(l, q0 + TQ);    // cs is needed up to here
  const int n4 = round4(n);
  const int b_stride = n4 + 4;

  float* cs = reinterpret_cast<float*>(smem4);  // [l]
  float* Cs = cs + round4(l);           // [TQ][n4]
  float* Bs = Cs + TQ * n4;             // [TK][n4 + 4]
  float* Xs = Bs + TK * b_stride;       // [TK][p]: x * dt
  float* W = Xs + TK * p;               // [TQ][W_STRIDE]

  const float* dtc = dt + static_cast<long long>(chunk) * l * h + head;
  const T* xc = x + chunk * xs.chunk + head * xs.head;
  const T* Bc = B + chunk * bs.chunk + grp * bs.head;
  const T* Cc = C + chunk * cs_.chunk + grp * cs_.head;

  // cs[0, l_end) = cumsum(dt * A): each lane sums a segment in double, a
  // warp scan of the lane totals gives each segment its offset.
  if (warp == 0) {
    const float a = A[head];
    const int seg = (l_end + 31) / 32;
    const int lo = min(lane * seg, l_end), hi = min(lo + seg, l_end);
    double run = 0.0;
    for (int t = lo; t < hi; ++t)
      run += static_cast<double>(dtc[static_cast<long long>(t) * h] * a);
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    run = incl - run;                   // the segment's offset
    for (int t = lo; t < hi; ++t) {
      run += static_cast<double>(dtc[static_cast<long long>(t) * h] * a);
      cs[t] = static_cast<float>(run);
    }
  }
  for (int r = warp; r < TQ; r += WARPS) {       // C tile, zero-padded
    const int i = q0 + r;
    for (int k = lane; k < n4; k += 32)
      Cs[r * n4 + k] = i < l && k < n ? to_f32(Cc[i * cs_.row + k]) : 0.f;
  }

  float acc[ROWS][COLS];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int q = 0; q < COLS; ++q) acc[m][q] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {    // key tiles above the diagonal skipped
    const int k0 = kt * TK;
    __syncthreads();                    // cs and Cs ready; last tile consumed
    for (int r = warp; r < TK; r += WARPS) {
      const int j = k0 + r;
      for (int k = lane; k < n4; k += 32)
        Bs[r * b_stride + k] =
            j < l && k < n ? to_f32(Bc[j * bs.row + k]) : 0.f;
      const float dtj = j < l ? dtc[static_cast<long long>(j) * h] : 0.f;
      for (int c = lane; c < p; c += 32)
        Xs[r * p + c] = j < l ? to_f32(xc[j * xs.row + c]) * dtj : 0.f;
    }
    __syncthreads();

    // W[r][lane] for this thread's rows r = warp + 4m and key j = k0 + lane
    {
      float dot[ROWS];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) dot[m] = 0.f;
      const float4* brow = reinterpret_cast<const float4*>(Bs + lane * b_stride);
      for (int k4 = 0; k4 < n4 / 4; ++k4) {
        const float4 b = brow[k4];
#pragma unroll
        for (int m = 0; m < ROWS; ++m) {
          const float4 c =
              reinterpret_cast<const float4*>(Cs + (warp + WARPS * m) * n4)[k4];
          dot[m] = fmaf(c.x, b.x, dot[m]);
          dot[m] = fmaf(c.y, b.y, dot[m]);
          dot[m] = fmaf(c.z, b.z, dot[m]);
          dot[m] = fmaf(c.w, b.w, dot[m]);
        }
      }
      const int j = k0 + lane;
      const float cs_j = cs[min(j, l_end - 1)];
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int r = warp + WARPS * m, i = q0 + r;
        const bool keep = i >= j && i < l;      // j <= i < l implies j < l
        const float cs_i = cs[min(i, l_end - 1)];
        W[r * W_STRIDE + lane] = keep ? dot[m] * expf(cs_i - cs_j) : 0.f;
      }
    }
    __syncthreads();

    // acc[m][q] += sum_j W[r][j] * Xs[j][c], r = warp + 4m, c = lane + 32q
    for (int j4 = 0; j4 < TK / 4; ++j4) {
      float4 w[ROWS];
#pragma unroll
      for (int m = 0; m < ROWS; ++m)
        w[m] = reinterpret_cast<const float4*>(
            W + (warp + WARPS * m) * W_STRIDE)[j4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* xrow = Xs + (4 * j4 + jj) * p;
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const int c = lane + 32 * q;
          if (c < p) {
            const float xv = xrow[c];
#pragma unroll
            for (int m = 0; m < ROWS; ++m)
              acc[m][q] = fmaf(comp(w[m], jj), xv, acc[m][q]);
          }
        }
      }
    }
  }

  O* oc = out + static_cast<long long>(chunk) * l * h * p
          + static_cast<long long>(head) * p;
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    const int i = q0 + warp + WARPS * m;
    if (i >= l) continue;
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int c = lane + 32 * q;
      if (c < p)
        oc[static_cast<long long>(i) * h * p + c] = from_f32<O>(acc[m][q]);
    }
  }
}

template <typename T, typename O>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* out, int N, int l,
                   int h, int p, int g, int n, Strides xs, Strides bs,
                   Strides cs, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(l, n, p);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((l + TQ - 1) / TQ, h, N);
  ssd_intra_chunk_kernel<T, O><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<O*>(out), l, h, p, h / g, n, xs,
      bs, cs);
  return cudaGetLastError();
}

}  // namespace

// x [N, l, h, p] and B, C [N, l, g, n] in one dtype, read through the given
// (chunk, row, head/group) strides with the last dimension contiguous;
// dt [N, l, h] and A [h] contiguous float32; out [N, l, h, p] contiguous.
// x_bf16: 1 for bfloat16 x, B, C, 0 for float32; out_bf16: 1 for a
// bfloat16 y (x must then be bfloat16), 0 for float32.  Returns a
// cudaError_t (0 on success).
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* out, int x_bf16, int out_bf16, int N, int l, int h,
    int p, int g, int n, long long x_sc, long long x_sl, long long x_sh,
    long long b_sc, long long b_sl, long long b_sg, long long c_sc,
    long long c_sl, long long c_sg, void* stream) {
  if (N <= 0 || l <= 0 || h <= 0 || p <= 0 || p > MAX_P || g <= 0
      || h % g != 0 || n <= 0 || n > MAX_N || N > 65535 || h > 65535
      || (out_bf16 && !x_bf16))
    return cudaErrorInvalidValue;
  const Strides xs{x_sc, x_sl, x_sh}, bs{b_sc, b_sl, b_sg},
      cs{c_sc, c_sl, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16)
    return launch<float, float>(x, dt, A, B, C, out, N, l, h, p, g, n, xs,
                                bs, cs, st);
  if (out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, out, N, l,
                                                h, p, g, n, xs, bs, cs, st);
  return launch<__nv_bfloat16, float>(x, dt, A, B, C, out, N, l, h, p, g, n,
                                      xs, bs, cs, st);
}
