// Mamba-2 SSD intra-chunk (diagonal block) forward for NVIDIA Hopper, sm_90a:
//
//   y[c, i, h, :] = sum_{j <= i} (C[c, i, g] . B[c, j, g])
//                   * exp(cs[c, i, h] - cs[c, j, h]) * dt[c, j, h] * x[c, j, h, :]
//
// with cs = cumsum(dt * A) over the chunk and g = h / (H / G) the head's
// group; every sum is fp32.
//
// Replaces: src/repro/kernels/ssd.py:27 `_ssd_kernel` (launched by
// `ssd_intra_chunk` at :51, `pl.pallas_call` at :63).
//
// Two bodies, chosen by the host:
//   * bfloat16 x, B, C with 16-byte aligned rows (p and n multiples of 8),
//     the fast path: `ssd_intra_chunk_mma_kernel`, both products on the
//     tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).
//   * float32 inputs, the exactness path, and any bf16 input the fast path
//     does not take (rows off 16-byte alignment, p or n not a multiple of
//     8, a chunk too long for its shared memory):
//     `ssd_intra_chunk_kernel`, fp32 FMAs on the CUDA cores with scalar
//     loads, the older of the two, kept as it was written.
//
// What bounds it on the card: at mamba2-370m's full width (2 chunks of
// 256, 32 heads of 64, one group, state 128, bf16 in, fp32 out) the kernel
// moves 6.6 MB (2 us at the HBM rate) for 0.29 GFLOP of causal work (0.3
// us at the bf16 peak): bytes, in theory.  In practice latency bounds it:
// the serial path of the block that owns the last query tile, which walks
// every key tile of its chunk.  The CUDA-core body fed ~0.45 G fp32 FMAs
// from shared memory and recomputed C.B for each of the 32 heads of the
// group that share it (2/3 of the work); on an H100 it was slower than its
// plain PyTorch version (127 against 119 us).  The bf16 body below takes
// ~24 us there (H100 80GB HBM3 at 700 W, chip_smoke.py phase 3).  What
// bounds it now: the x-side mma's of the longest block (4 steps of 96
// mma.sync a warp, two warps to a scheduler) and the causal imbalance
// (the last query tile's blocks walk 4 key tiles, the average 2.5).
// wgmma, or the longest blocks' key tiles shared out further, are the
// levers left.
//
// The bf16 design against that:
//   * C.B on the tensor cores.  A block owns a 64-row query tile of one
//     chunk, 16 rows a warp; C.B of each 64-key tile at or below the
//     diagonal is one mma row block a warp, from ldmatrix fragments of C
//     (read once) and B.  bf16 x bf16 products are exact in fp32, so
//     this is the reference's fp32 dot up to summation order.
//   * C.B shared by the heads of a block.  A block owns HB heads of one
//     group.  It computes C.B once and keeps the fp32 fragments of every
//     key tile in shared memory, in fragment order (float4 a lane, so
//     conflict-free): the warp of a 16-row slice in either group reads
//     them for each of its heads.  On the tensor cores C.B costs about 2/3
//     of one head's x-side product, so sharing it pays, but not at the
//     price of idle SMs: HB = 2, one head for each of the two warp groups
//     below, where the heads of a group pair up, else 1.  At full width
//     that is 2 chunks x 4 query tiles x 16 head pairs = 128 blocks of
//     ~150 KB, one on each of 132 SMs (HB = 1 would need two waves, as two
//     such blocks do not fit an SM; HB = 4 would leave half the SMs idle);
//     a 128-token prompt (one chunk) gives 64 blocks.  The serve's host
//     bounds its tokens/s, so the launch reads the card's shared-memory
//     maximum and raises the kernel's limit once per device, not per call.
//   * A shorter serial path.  A block has 8 warps in two groups of 4 (one
//     warp a 16-row slice in each), and a ring stage holds one tile for
//     each group: the groups share out the C.B key tiles (even, odd), then
//     the heads (even, odd).  At full width the longest block walks 2 C.B
//     steps and 4 x steps instead of 4 and 8, with two warps on each
//     scheduler to hide each other's latencies.  A first build with 4
//     warps walking every tile in series took 35.9 us on an H100 80GB HBM3
//     at 700 W.  Within a step, each 16-key slice loads all its x
//     fragments before its products, and the three terms' products are
//     issued term by term, so NO mma's stand between two into one
//     accumulator (asm volatile keeps the issue order as written).
//   * The x-side product on the tensor cores without losing fp32.  dt_j is
//     folded into the weights, W'[i, j] = (C_i.B_j) exp(cs_i - cs_j) dt_j,
//     in fp32, so x stays the exact bf16 operand; W' is split into three
//     bf16 terms (hi, mid, lo: each the bf16 rounding of what the terms
//     before it left), and the three mma's of a 16-key step go into one
//     fp32 accumulator.  Three terms keep 24 bits of W', what fp32 keeps: a
//     CPU emulation at full width lands at 3% of the 2e-4 tolerance, two
//     terms at 79%, one bf16 rounding 419x over it
//     (tests/test_torch_kernels.py::test_ssd_tensor_core_arithmetic_*).
//     The C fragment of C.B is the A fragment of the W' product, so W'
//     never leaves registers.  The decay is the hardware's exp2 (__expf):
//     its relative error, about 2^-21 plus |cs_i - cs_j| 2^-24, is of the
//     order of the rounding of the cumsums themselves.  A lane reads the
//     cs and dt of its two keys as one float2 each, from arrays padded
//     with zeros to whole tiles.
//   * Loads by 16-byte cp.async into a two-stage ring: the block's B tiles,
//     then the x tiles of each of its heads, stage s + 1 loading while
//     stage s computes; the ragged edge is zero-filled, never read.  Shared rows are
//     padded by 16 bytes, so an ldmatrix's 8 rows hit 32 banks.  Key tiles
//     above the diagonal are never loaded, and a warp whose 16 rows all lie
//     before a key tile skips its products.  The grid takes the last query
//     tile first, so the longest blocks are dispatched first.
//   * Entries with j > i, where cs_i - cs_j > 0 and exp can overflow, are
//     selected away and never multiplied.
//
// Both bodies take the block's cumsum the same way: in fp32, left to
// right, as the plain version does (chunk_cumsum).  The bf16 body first
// loads the dt of its HB heads with all its threads at once into shared
// memory, where one lane a head scans them, while the first tiles load.
//
// Shapes: the chunk length, the head and state widths are runtime values
// (p <= 128, n <= 256); ragged edges are masked.  x, B and C are read
// through (chunk, row, head-or-group) strides with the last dimension
// contiguous, so the model's strided views of one conv output (row stride
// 2304 elements, B and C at 2048 and 2176) need no copy and take the bf16
// body; dt [N, l, h] and A [h] are contiguous fp32.  y is contiguous [N, l,
// h, p], in fp32 or in x's dtype.
//
// The CUDA-core body: one block of 128 threads (4 warps) owns (chunk,
// head, tile of TQ = 32 query rows) and loops over the key tiles of TK =
// 32 rows at or below the diagonal.  Per key tile it stages B and x * dt
// in shared memory as fp32, forms W = (C.B) * exp(cs_i - cs_j) for the
// tile, and adds W @ (x * dt) into fp32 accumulators in registers.  Each
// thread owns rows warp + 4m (m < 8): in the W phase the W entries of key
// lane, in the y phase the outputs of columns lane + 32q (q < 4).  Rows of
// C, B and W are read as float4, so a shared load feeds 4 to 16 FMAs; n is
// padded with zeros to a multiple of 4.
//
// ptxas (sm_90a, CUDA 12.8): the bf16 body 96 / 126 / 128 / 172 registers
// for p up to 16 / 32 / 64 / 128 (4 bytes spilled at 64), the CUDA-core
// body 104-107, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

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

// cs[0, l_end) = cumsum(dt * A) of one head in fp32, left to right, by
// lane 0 of the calling warp: the order of the plain version's cumsum
// (kernels/ref.py::cumsum_f32), so that both give the same sums bit for
// bit (an fp32 cumsum in another order moves y by up to twice SSD_TOL at
// a 256-token chunk).  Each product dt * A is rounded before it is added
// (__fmul_rn keeps nvcc from fusing it into an FMA), as the plain version
// rounds dtA.  dtc is the head's dt column (stride h).  The products of
// 16 steps are loaded and rounded ahead, so that what is serial is the
// adds alone; the bf16 body runs them while its first tiles load.
__device__ __forceinline__ void chunk_cumsum(const float* dtc, int h, float a,
                                             int l_end, int lane, float* cs) {
  if (lane != 0) return;
  constexpr int U = 16;
  float run = 0.f;
  int t = 0;
  for (; t + U <= l_end; t += U) {
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      d[u] = __fmul_rn(dtc[static_cast<long long>(t + u) * h], a);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      run += d[u];
      cs[t + u] = run;
    }
  }
  for (; t < l_end; ++t) {
    run += __fmul_rn(dtc[static_cast<long long>(t) * h], a);
    cs[t] = run;
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

  if (warp == 0) chunk_cumsum(dtc, h, A[head], l_end, lane, cs);
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

// The bf16 body (see the note at the top).  Block (z, head set, chunk)
// owns query rows [q0, q0 + 64) of heads [hb * HB, hb * HB + HB), all of
// one group.  8 warps: warp w works on the 16 rows of slice w % 4 for
// warp group w / 4.  Ring stage s holds two tiles, one for each group: in
// the C.B steps the B tiles 2s and 2s + 1, then for each pair of heads
// (2hp, 2hp + 1) the x tiles kt = 0..qt of both heads.
constexpr int M_TQ = 64;               // query rows a block owns
constexpr int M_TK = 64;               // keys a tile; == M_TQ
constexpr int M_SLICES = M_TQ / 16;    // 16-row slices, one a warp
constexpr int M_GROUPS = 2;            // warp groups sharing out the tiles
constexpr int M_THREADS = M_SLICES * M_GROUPS * 32;  // 256
constexpr int M_MAX_DEVICES = 64;      // devices the launch caches

__host__ __device__ __forceinline__ int round16(int v) {
  return (v + 15) & ~15;
}

struct MmaSmem {                        // byte offsets of the bf16 body
  int c_stride, ring_stride, kt_max;    // (elements, elements, tiles)
  size_t ring, frag, cs, dt, total;
};

template <int PMAX>
__host__ __device__ __forceinline__ MmaSmem mma_smem(int l, int n, int hb) {
  MmaSmem m;
  m.c_stride = round16(n) + 8;         // padded by 16 bytes
  m.ring_stride = m.c_stride > PMAX + 8 ? m.c_stride : PMAX + 8;
  m.kt_max = (l + M_TK - 1) / M_TK;
  m.ring = sizeof(__nv_bfloat16) * M_TQ * m.c_stride;
  m.frag = m.ring
           + sizeof(__nv_bfloat16) * 2 * M_GROUPS * M_TK * m.ring_stride;
  m.cs = m.frag + sizeof(float) * M_TQ * M_TK * m.kt_max;
  m.dt = m.cs + sizeof(float) * hb * M_TK * m.kt_max;
  m.total = m.dt + sizeof(float) * hb * M_TK * m.kt_max;
  return m;
}

template <int PMAX, typename O>
__global__ void __launch_bounds__(M_THREADS)
ssd_intra_chunk_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ A,
                           const __nv_bfloat16* __restrict__ B,
                           const __nv_bfloat16* __restrict__ C,
                           O* __restrict__ out, int l, int h, int p, int hg,
                           int n, int hb_count, Strides xs, Strides bs,
                           Strides cs_) {
  using bf16 = __nv_bfloat16;
  constexpr int NO = PMAX / 8;          // 8-wide output column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int slice = warp % M_SLICES;
  const int group = warp / M_SLICES;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest tiles first
  const int head0 = blockIdx.y * hb_count;
  const int chunk = blockIdx.z;
  const int grp = head0 / hg;
  const int q0 = qt * M_TQ;
  const int l_end = min(l, q0 + M_TQ);
  const int n16 = round16(n);
  const MmaSmem sm = mma_smem<PMAX>(l, n, hb_count);
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);  // [64][c_stride]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + sm.ring);
  float4* frag = reinterpret_cast<float4*>(smem_raw + sm.frag);
  const int lp = M_TK * sm.kt_max;      // l padded to whole tiles
  float* s_cs = reinterpret_cast<float*>(smem_raw + sm.cs);  // [HB][lp]
  float* s_dt = reinterpret_cast<float*>(smem_raw + sm.dt);  // [HB][lp]

  const bf16* Bc = B + chunk * bs.chunk + grp * bs.head;
  const bf16* Cc = C + chunk * cs_.chunk + grp * cs_.head;
  const int nkt = qt + 1;               // key tiles at or below the diagonal
  const int cb_steps = (nkt + M_GROUPS - 1) / M_GROUPS;
  const int n_steps = cb_steps + (hb_count + M_GROUPS - 1) / M_GROUPS * nkt;

  // What group g works on in step s: a B tile (kt), or the x tile kt of
  // head hh; false when it has nothing (past qt, or past the heads).
  auto step_tile = [&](int s, int g, int& kt, int& hh) {
    if (s < cb_steps) {
      kt = M_GROUPS * s + g;
      hh = -1;
      return kt < nkt;
    }
    kt = (s - cb_steps) % nkt;
    hh = M_GROUPS * ((s - cb_steps) / nkt) + g;
    return hh < hb_count;
  };
  // Both tiles of step s into ring stage s % 2.  Zero past l and past n
  // (or p), where nothing is read.
  auto load_step = [&](int s) {
#pragma unroll
    for (int g = 0; g < M_GROUPS; ++g) {
      int kt, hh;
      if (!step_tile(s, g, kt, hh)) continue;
      bf16* dst = ring + ((s % 2) * M_GROUPS + g) * M_TK * sm.ring_stride;
      const bool is_b = hh < 0;
      const bf16* src = is_b ? Bc
          : x + chunk * xs.chunk + (head0 + hh) * xs.head;
      const long long row = is_b ? bs.row : xs.row;
      const int width = is_b ? n : p;
      const int chunks = (is_b ? n16 : PMAX) / 8;
      for (int i = threadIdx.x; i < M_TK * chunks; i += M_THREADS) {
        const int r = i / chunks, c = (i % chunks) * 8;
        const int j = kt * M_TK + r;
        const bool ok = j < l && c < width;
        mma::cp_async16(dst + r * sm.ring_stride + c,
                        src + (ok ? j * row + c : 0), ok);
      }
    }
    mma::cp_async_commit();
  };
  {                                     // the C tile, with the first B tiles
    const int chunks = n16 / 8;
    for (int i = threadIdx.x; i < M_TQ * chunks; i += M_THREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      const int j = q0 + r;
      const bool ok = j < l && c < n;
      mma::cp_async16(sC + r * sm.c_stride + c,
                      Cc + (ok ? j * cs_.row + c : 0), ok);
    }
  }
  load_step(0);
  // dt of the block's heads, every load issued at once, zero from l_end to
  // the end of the last tile (read there, then selected away); then a warp
  // a head takes its cumsum from shared memory
  const float* dtc = dt + static_cast<long long>(chunk) * l * h + head0;
  for (int i = threadIdx.x; i < hb_count * (q0 + M_TQ); i += M_THREADS) {
    const int hh = i % hb_count, t = i / hb_count;
    s_dt[hh * lp + t] =
        t < l_end ? dtc[static_cast<long long>(t) * h + hh] : 0.f;
    if (t >= l_end) s_cs[hh * lp + t] = 0.f;
  }
  __syncthreads();
  for (int hh = warp; hh < hb_count; hh += M_THREADS / 32)
    chunk_cumsum(s_dt + hh * lp, 1, A[head0 + hh], l_end, lane,
                 s_cs + hh * lp);

  const int row_lo = q0 + slice * 16;   // this warp's first row
  const int r0 = row_lo + lane / 4;     // rows of c0, c1; c2, c3 are r0 + 8
  float acc[NO][4];
  for (int s = 0; s < n_steps; ++s) {
    mma::cp_async_wait_all();
    __syncthreads();                    // step s landed; s - 1 consumed
    if (s + 1 < n_steps) load_step(s + 1);
    int kt, hh;
    if (!step_tile(s, group, kt, hh)) continue;
    const bf16* tile =
        ring + ((s % 2) * M_GROUPS + group) * M_TK * sm.ring_stride;
    const int k0 = kt * M_TK;
    // rows all before the tile's first key, or all past l: nothing to add
    const bool idle = k0 > row_lo + 15 || row_lo >= l;
    float4* my_frag = frag + (slice * sm.kt_max + kt) * 8 * 32 + lane;
    if (hh < 0) {                       // C.B of key tile kt
      if (idle) continue;
      float c[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
      for (int kk = 0; kk < n16 / 16; ++kk) {
        unsigned cf[4], bf[4][4];       // C rows; b0, b1 of key tiles
        mma::ldmatrix_x4(cf, sC + (slice * 16 + lane % 16) * sm.c_stride +
                                 kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2)
          mma::ldmatrix_x4(bf[nt / 2],
                           tile + (nt * 8 + lane % 8 + (lane / 16) * 8) *
                                      sm.ring_stride +
                               kk * 16 + ((lane / 8) % 2) * 8);
#pragma unroll
        for (int nt = 0; nt < 8; nt += 2) {
          mma::mma_bf16_16816(c[nt], cf, bf[nt / 2][0], bf[nt / 2][1]);
          mma::mma_bf16_16816(c[nt + 1], cf, bf[nt / 2][2], bf[nt / 2][3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        my_frag[nt * 32] = make_float4(c[nt][0], c[nt][1], c[nt][2], c[nt][3]);
      continue;
    }
    if (kt == 0) {                      // x-side product of head hh
#pragma unroll
      for (int nt = 0; nt < NO; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
    }
    if (!idle) {
      const float* cs = s_cs + hh * lp;
      const float* dth = s_dt + hh * lp;
      const float cs_i[2] = {cs[r0], cs[r0 + 8]};
#pragma unroll
      for (int kk = 0; kk < M_TK / 16; ++kk) {
        unsigned xf[NO / 2][4];         // b0, b1 of output tiles nt, nt + 1
#pragma unroll
        for (int nt = 0; nt < NO; nt += 2)
          mma::ldmatrix_x4_trans(
              xf[nt / 2], tile + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) *
                                     sm.ring_stride + nt * 8 + (lane / 16) * 8);
        // W' of keys k0 + 16kk .. + 15 from the C.B fragments of key
        // tiles 2kk and 2kk + 1, as three bf16 A fragments
        unsigned wf[3][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 sv = my_frag[(2 * kk + half) * 32];
          const float sval[4] = {sv.x, sv.y, sv.z, sv.w};
          const int j0 = k0 + (2 * kk + half) * 8 + (lane % 4) * 2;
          const float2 cs2 = *reinterpret_cast<const float2*>(cs + j0);
          const float2 dt2 = *reinterpret_cast<const float2*>(dth + j0);
          const float cs_j[2] = {cs2.x, cs2.y}, dt_j[2] = {dt2.x, dt2.y};
          float w[3][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + (e >> 1) * 8;
            const int j = j0 + (e & 1);
            const bool keep = j <= i && i < l;  // j <= i < l: j < l
            const float wv = keep ? sval[e] * __expf(cs_i[e >> 1] -
                                                     cs_j[e & 1]) *
                                        dt_j[e & 1]
                                  : 0.f;
            const float hi = __bfloat162float(__float2bfloat16(wv));
            const float rest = wv - hi;
            const float mid = __bfloat162float(__float2bfloat16(rest));
            w[0][e] = hi;
            w[1][e] = mid;
            w[2][e] = rest - mid;
          }
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            wf[term][2 * half] = mma::pack_bf16(w[term][0], w[term][1]);
            wf[term][2 * half + 1] = mma::pack_bf16(w[term][2], w[term][3]);
          }
        }
#pragma unroll
        for (int term = 0; term < 3; ++term)  // NO products between two
#pragma unroll                                // into one accumulator
          for (int nt = 0; nt < NO; nt += 2) {
            mma::mma_bf16_16816(acc[nt], wf[term], xf[nt / 2][0],
                                xf[nt / 2][1]);
            mma::mma_bf16_16816(acc[nt + 1], wf[term], xf[nt / 2][2],
                                xf[nt / 2][3]);
          }
      }
    }
    if (kt == nkt - 1 && row_lo < l) {  // head hh done: write its rows
      O* oc = out + (static_cast<long long>(chunk) * l * h + head0 + hh) * p
              + (lane % 4) * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + 8 * r;
        if (i >= l) continue;
#pragma unroll
        for (int nt = 0; nt < NO; ++nt)
          if (nt * 8 < p)
            store2(oc + static_cast<long long>(i) * h * p + nt * 8,
                   acc[nt][2 * r], acc[nt][2 * r + 1]);
      }
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

// Launches the bf16 body with hb heads a block and returns true, or returns
// false (launching nothing) when its shared memory does not fit the card.
// Per device, the opt-in shared-memory maximum is read once and the
// kernel's limit raised only when a launch needs more than it was set to;
// a race between host threads only repeats a call.
template <int PMAX, typename O>
bool launch_mma(const void* x, const void* dt, const void* A, const void* B,
                const void* C, void* out, int N, int l, int h, int p, int g,
                int n, int hb, Strides xs, Strides bs, Strides cs,
                cudaStream_t stream, cudaError_t* err) {
  static int optin[M_MAX_DEVICES], limit[M_MAX_DEVICES];
  const int smem = static_cast<int>(mma_smem<PMAX>(l, n, hb).total);
  int dev = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return true;
  if (dev >= M_MAX_DEVICES) {
    *err = cudaErrorInvalidDevice;
    return true;
  }
  if (!optin[dev] &&
      (*err = cudaDeviceGetAttribute(
           &optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess)
    return true;
  if (smem > optin[dev]) return false;
  if (smem > limit[dev]) {
    if ((*err = cudaFuncSetAttribute(
             ssd_intra_chunk_mma_kernel<PMAX, O>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return true;
    limit[dev] = smem;
  }
  const dim3 grid((l + M_TQ - 1) / M_TQ, h / hb, N);
  ssd_intra_chunk_mma_kernel<PMAX, O><<<grid, M_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<O*>(out), l, h, p,
      h / g, n, hb, xs, bs, cs);
  *err = cudaGetLastError();
  return true;
}

template <typename O>
bool launch_mma_p(const void* x, const void* dt, const void* A, const void* B,
                  const void* C, void* out, int N, int l, int h, int p, int g,
                  int n, int hb, Strides xs, Strides bs, Strides cs,
                  cudaStream_t stream, cudaError_t* err) {
#define MMA_ARGS \
  x, dt, A, B, C, out, N, l, h, p, g, n, hb, xs, bs, cs, stream, err
  if (p <= 16) return launch_mma<16, O>(MMA_ARGS);
  if (p <= 32) return launch_mma<32, O>(MMA_ARGS);
  if (p <= 64) return launch_mma<64, O>(MMA_ARGS);
  return launch_mma<128, O>(MMA_ARGS);
#undef MMA_ARGS
}

// Whether the bf16 body may read x, B, C: 16-byte aligned base pointers,
// strides and rows (p and n multiples of 8 elements) for cp.async.
bool aligned16(const void* ptr, const Strides& st, int width) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0 && width % 8 == 0 &&
         st.chunk % 8 == 0 && st.row % 8 == 0 && st.head % 8 == 0;
}

}  // namespace

// x [N, l, h, p] and B, C [N, l, g, n] in one dtype, read through the given
// (chunk, row, head/group) strides with the last dimension contiguous;
// dt [N, l, h] and A [h] contiguous float32; out [N, l, h, p] contiguous.
// x_bf16: 1 for bfloat16 x, B, C, 0 for float32; out_bf16: 1 for a
// bfloat16 y (x must then be bfloat16), 0 for float32.  heads_per_block,
// where not null, receives the heads a block of the bf16 body took, or 0
// for the CUDA-core body.  Returns a cudaError_t (0 on success).
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* out, int x_bf16, int out_bf16, int N, int l, int h,
    int p, int g, int n, long long x_sc, long long x_sl, long long x_sh,
    long long b_sc, long long b_sl, long long b_sg, long long c_sc,
    long long c_sl, long long c_sg, int* heads_per_block, void* stream) {
  if (N <= 0 || l <= 0 || h <= 0 || p <= 0 || p > MAX_P || g <= 0
      || h % g != 0 || n <= 0 || n > MAX_N || N > 65535 || h > 65535
      || (out_bf16 && !x_bf16))
    return cudaErrorInvalidValue;
  const Strides xs{x_sc, x_sl, x_sh}, bs{b_sc, b_sl, b_sg},
      cs{c_sc, c_sl, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads_per_block) *heads_per_block = 0;
  if (x_bf16 && aligned16(x, xs, p) && aligned16(B, bs, n) &&
      aligned16(C, cs, n)) {
    cudaError_t err = cudaSuccess;
    const int hb = (h / g) % M_GROUPS ? 1 : M_GROUPS;
    const bool took = out_bf16
        ? launch_mma_p<__nv_bfloat16>(x, dt, A, B, C, out, N, l, h, p, g, n,
                                      hb, xs, bs, cs, st, &err)
        : launch_mma_p<float>(x, dt, A, B, C, out, N, l, h, p, g, n, hb, xs,
                              bs, cs, st, &err);
    if (took) {
      if (heads_per_block && err == cudaSuccess) *heads_per_block = hb;
      return err;
    }
  }
  if (!x_bf16)
    return launch<float, float>(x, dt, A, B, C, out, N, l, h, p, g, n, xs,
                                bs, cs, st);
  if (out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, B, C, out, N, l,
                                                h, p, g, n, xs, bs, cs, st);
  return launch<__nv_bfloat16, float>(x, dt, A, B, C, out, N, l, h, p, g, n,
                                      xs, bs, cs, st);
}
