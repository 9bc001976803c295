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
// Three bodies.  The entry point below picks one by shape and alignment
// alone (`plan_of`, ssd_plan.h, with its shared memory and grid) and
// launches it; it never takes another:
//   * bfloat16 x, B, C with 16-byte aligned rows, head dim 64, state 16 or
//     128, chunks up to 256 (mamba2-370m's and jamba's: every main path):
//     `ssd_intra_chunk_wgmma_kernel`, the Hopper body (below).
//   * other bfloat16 with 16-byte aligned rows (p and n multiples of 8;
//     the reduced configs' head dim 16) whose shared memory fits the card:
//     `ssd_intra_chunk_mma_kernel`, both products on mma.sync m16n8k16
//     (the earlier bf16 body, kept as it was).
//   * float32 inputs, the exactness path, and any bf16 input the others do
//     not take (rows off 16-byte alignment): `ssd_intra_chunk_kernel`, fp32
//     FMAs on the CUDA cores with scalar loads.
//
// What bounds it on the card: at mamba2-370m's serve (2 chunks of 256, 32
// heads of 64, one group, state 128, bf16 in, fp32 out) the kernel moves
// 6.6 MB (2 us at the HBM rate) for 0.29 GFLOP of causal work (0.3 us at
// the bf16 peak): bytes, in theory.  In practice latency and the issue
// slots of the elementwise work bound it.  The mma.sync body took 24-26 us
// there (H100 80GB HBM3 at 700 W): its warps loaded by cp.async and
// multiplied in lockstep behind a two-stage ring, C.B went through shared
// memory as fp32 fragments, 150 KB a block left one block an SM, and the
// last query tile's blocks walked 4 key tiles against 2.5 on average.
//
// The Hopper body against that:
//   * Work items, heaviest first: a pair of 64-row query tiles {nq - 1 - i,
//     i} of one (chunk, head), the middle one alone where nq = ceil(l / 64)
//     is odd, so that every pair walks nq + 1 (query tile, key tile) units.
//     One block an SM walks the items (persistent): 128 items on 132 SMs at
//     the serve, 512 at jamba's chunk and the train step, 3-4 a block.
//   * A producer warpgroup (setmaxnreg 40): one thread loads by TMA an
//     item's C tiles and, for each key tile kt of the longer query tile,
//     its B and x tiles into the half of a 4-stage mbarrier ring that
//     belongs to consumer kt % 2; warp 1 gathers the head's dt and takes its
//     cumsum (below), an item ahead.  Tensor maps read x, B, C through
//     their strides: the model's views of one conv output need no copy.  B
//     and C rows are 128-byte swizzled boxes of 64 columns at state 128 and
//     32-byte swizzled rows at state 16 (hopper.cuh `sw32_desc`): no padding
//     in memory.
//   * Two consumer warpgroups (setmaxnreg 232) share out an item's key
//     tiles: consumer g takes kt = g, g + 2, ... of both query tiles.  For
//     each it forms C.B of the key tile with each query tile on wgmma from
//     shared memory (C and B K-major), the accumulators in registers; W' =
//     (C.B) exp(cs_i - cs_j) dt_j on the accumulator fragment, split into
//     three bf16 terms packed straight into A fragments (hopper.cuh: the
//     accumulator of one product is the A fragment of the next); then y +=
//     W' x, the three terms' wgmma into one fp32 accumulator, x MN-major.
//   * C.B recomputed for each head.  On the tensor cores C.B costs 8
//     m64n64k16 products a unit at state 128 (1 at 16) against the x side's
//     12: 2/3 of it.  Sharing it between two heads would halve the serve's
//     128 items to 64 on 132 SMs and keep the accumulators of two heads'
//     two tiles (128 registers) live; measured, the products are not what
//     set the time (below), so each item is one head.
//   * The partial sums of the two consumers are added in a fixed order, no
//     atomics: consumer 0 (the even key tiles, the more of them) hands its
//     sums over through shared memory and an mbarrier and goes on to its
//     next item; consumer 1 adds them to its own, stages y in 128-byte
//     swizzled boxes and stores it by TMA (rows past l are not written).
//   * Entries with j > i, where cs_i - cs_j > 0 and exp could overflow, or
//     rows past l, take an exponent of -inf: a select before the product,
//     never a branch, and 2^-inf is 0.  Only tiles that cross the diagonal
//     or the end of the chunk test it.  The decay is one ex2.approx.ftz of
//     (cs_i - cs_j) log2(e), as the mma.sync body's __expf.
//   * Where the time goes, by clock64 stamps in a development build: W''s
//     elementwise work (the exp and the three-term split's conversions,
//     about 500 instructions a thread a unit), not the products, which
//     finish soon after their issue; and the first item's start, which
//     waits for its dt and its serial cumsum.  ptxas serialized every wgmma
//     of the kernel (C7520) while the shorter tile's C.B was issued on a
//     divergent path inside a group; it has a group of its own.
//
// All bodies take the block's cumsum the same way: in fp32, left to right,
// as the plain version does (`chunk_cumsum`; the Hopper body's warp 1 adds
// the rounded products dt * A four at a time on one lane).
//
// Shapes: the chunk length, the head and state widths are runtime values
// (p <= 128, n <= 256); ragged edges are masked.  x, B and C are read
// through (chunk, row, head-or-group) strides with the last dimension
// contiguous, so the model's strided views of one conv output (row stride
// 2304 elements, B and C at 2048 and 2176) need no copy; dt [N, l, h] and
// A [h] are contiguous fp32.  y is contiguous [N, l, h, p], in fp32 or in
// x's dtype.
//
// The mma.sync body: a block owns a 64-row query tile of one chunk and HB
// heads of one group (2 where the heads of a group pair up, else 1), 8
// warps in two groups of 4 that share out the C.B key tiles, then the
// heads; C.B is kept in shared memory as fp32 fragments and read by each
// head's x-side step; W' is split into the same three bf16 terms; loads by
// 16-byte cp.async into a two-stage ring, rows padded by 16 bytes for
// ldmatrix; the grid takes the last query tile first.
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
// Registers and spills: ptxas -v for sm_90a, as phase 2 of chip_smoke.py
// prints them (PERF.md).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma.cuh"
#include "ssd_plan.h"

namespace {

// TQ, TK, MAX_P, MAX_N, W_STRIDE, the shared-memory layouts and the
// plan: ssd_plan.h.
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = TQ / WARPS;   // rows a thread covers: warp + 4m
constexpr int COLS = MAX_P / 32;   // output columns a lane covers

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

// cs[0, l_end) = cumsum(dt * A) of one head in fp32, left to right, by
// lane 0 of the calling warp: the order of the plain version's cumsum
// (kernels/ref.py::cumsum_f32), so that both give the same sums bit for
// bit (an fp32 cumsum in another order moves y by up to twice SSD_TOL at
// a 256-token chunk).  Each product dt * A is rounded before it is added
// (__fmul_rn keeps nvcc from fusing it into an FMA), as the plain version
// rounds dtA.  dtc is the head's dt column (stride h).  The products of
// 16 steps are loaded and rounded ahead, so that what is serial is the
// adds alone; the mma.sync body runs them while its first tiles load.
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
// M_TQ, M_TK, M_GROUPS and the layout `mma_smem`: ssd_plan.h.
constexpr int M_SLICES = M_TQ / 16;    // 16-row slices, one a warp
constexpr int M_THREADS = M_SLICES * M_GROUPS * 32;  // 256
constexpr int M_MAX_DEVICES = 64;      // devices the launches cache

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

// The Hopper body (see the note at the top): one producer warpgroup (a
// TMA thread and a cumsum warp) and two consumer warpgroups; one block an
// SM walks the work items.  WG_TILE, WG_P, WG_MAX_L, WG_STAGES and the
// shared-memory layout `WgSsd`: ssd_plan.h.
constexpr int WG_THREADS = 384;
constexpr int WG_PRODUCER_REGS = 40;
constexpr int WG_CONSUMER_REGS = 232;  // 40 x 128 + 232 x 256 <= 65,536
constexpr int WG_HALF = WG_STAGES / 2;
constexpr float LOG2E = 1.4426950408889634f;

// Descriptor of k-step kk (16 state columns) of a B or C tile at `at`,
// K-major: a 128-byte swizzled box of 64 columns holds 4 k-steps, 32 bytes
// apart; a 32-byte row is one k-step.
template <int NS>
__device__ __forceinline__ uint64_t bc_desc(uint32_t at, int kk) {
  if constexpr (WgSsd<NS>::SW128)
    return hopper::sw128_desc(at + (kk / 4) * WG_TILE * 128 + (kk % 4) * 32,
                              16, 1024);
  else
    return hopper::sw32_desc(at);
}

// One B or C tile: rows [row, row + 64) of group grp of chunk `chunk`, in
// boxes of BOX columns, onto `bar`.
template <int NS>
__device__ __forceinline__ void load_bc(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int row, int grp,
                                        int chunk) {
#pragma unroll
  for (int cb = 0; cb < WgSsd<NS>::NCB; ++cb)
    hopper::tma_load_4d(dst + cb * WG_TILE * 128, map, bar,
                        cb * WgSsd<NS>::BOX, row, grp, chunk);
}

// C.B of one key tile (not committed): C (64 query rows) and B (64 keys),
// both K-major over the state.
template <int NS>
__device__ __forceinline__ void start_cb(float (&s)[32], uint32_t c_at,
                                         uint32_t b_at) {
#pragma unroll
  for (int kk = 0; kk < NS / 16; ++kk)
    hopper::wgmma_ss_n64(s, bc_desc<NS>(c_at, kk), bc_desc<NS>(b_at, kk),
                         kk > 0);
}

// y += W' x of one key tile (not committed): the three bf16 terms of W'
// from registers, x MN-major (64 keys of 128-byte rows, transposed by the
// instruction); k-step kk is keys 16 kk .. 16 kk + 15.
__device__ __forceinline__ void start_wx(float (&acc)[32],
                                         const uint32_t (&wf)[4][3][4],
                                         uint32_t x_at) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int term = 0; term < 3; ++term)
      hopper::wgmma_rs_n64(
          acc, wf[kk][term],
          hopper::sw128_desc(x_at + kk * 16 * 128, WG_TILE * 128, 1024), 1);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// W' of one key tile from its C.B accumulator s, in place in registers:
// W'[i, j] = (C_i.B_j) exp(cs_i - cs_j) dt_j where j <= i < l, else 0 (the
// exponent is selected to -inf before the product: above the diagonal exp
// could overflow), split into three bf16 terms, each the rounding of what
// the terms before it left, packed as the A fragments of y += W' x.
// Accumulator element e of this thread is row i0 + 8 ((e >> 1) & 1), key
// j0 + 8 (e >> 2) + (e & 1); elements 8 kk .. 8 kk + 7 are k-step kk's
// fragment (hopper.cuh).
// MASK: the tile crosses the diagonal or the end of the chunk; elsewhere
// every j < i < l.
template <bool MASK>
__device__ __forceinline__ void form_w(const float (&s)[32],
                                       uint32_t (&wf)[4][3][4],
                                       const float* cs, const float* dtv,
                                       int i0, int j0, int l) {
  const float cs_i[2] = {cs[i0], cs[i0 + 8]};
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = j0 + 8 * jj;
    const float2 cs2 = *reinterpret_cast<const float2*>(cs + j);
    const float2 dt2 = *reinterpret_cast<const float2*>(dtv + j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * r;
      float w[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool keep = !MASK || (j + c <= i && i < l);
        const float d = (cs_i[r] - (c ? cs2.y : cs2.x)) * LOG2E;
        const float e =
            hopper::exp2_approx(keep ? d : __int_as_float(0xff800000));
        w[c] = s[4 * jj + 2 * r + c] * e * (c ? dt2.y : dt2.x);
      }
      const __nv_bfloat162 hi = __floats2bfloat162_rn(w[0], w[1]);
      const float2 hf = __bfloat1622float2(hi);
      const float r0 = w[0] - hf.x, r1 = w[1] - hf.y;
      const __nv_bfloat162 mid = __floats2bfloat162_rn(r0, r1);
      const float2 mf = __bfloat1622float2(mid);
      const int kk = jj / 2, q = 2 * (jj % 2) + r;
      wf[kk][0][q] = bits(hi);
      wf[kk][1][q] = bits(mid);
      wf[kk][2][q] = bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y));
    }
  }
}

// Rows [q0, q0 + 64) of one head's y, a (this consumer's sums plus the
// other's), into the staging tile at `tile` as the output map's boxes
// take it: 128-byte rows, 128-byte swizzled (hopper.cuh), of 32 fp32
// columns (two boxes, 8 KiB apart) or 64 bf16.  row and col are those of
// accumulator element 0.
template <typename O>
__device__ __forceinline__ void stage_tile(unsigned char* tile,
                                           const float (&a)[32], int row,
                                           int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = row + 8 * r;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int v = 4 * jj + 2 * r, c = 8 * jj + col;
      if constexpr (sizeof(O) == 4) {
        const int cc = c % 32;
        store2(reinterpret_cast<float*>(
                   tile + (c / 32) * WG_TILE * 128 + rr * 128 +
                   (((cc / 4) ^ (rr % 8)) * 16) + (cc % 4) * 4),
               a[v], a[v + 1]);
      } else {
        store2(reinterpret_cast<O*>(tile + rr * 128 +
                                    (((c / 8) ^ (rr % 8)) * 16) +
                                    (c % 8) * 2),
               a[v], a[v + 1]);
      }
    }
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&wf)[4][3][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(wf[kk]);
}

// The Hopper body.  Work item w, the heaviest first: the pair of query
// tiles {nq - 1 - pi, pi} (one tile where they meet) of head w % h of
// chunk w % (N h) / h, pi = w / (N h); every pair has nq + 1 (query tile,
// key tile) units.  Block b walks the items b + gridDim.x i.  Warpgroup 0
// is the producer: thread 0 loads an item's C tiles and, for each key
// tile kt of the longer query tile, B and x into the ring (the half of
// consumer kt % 2); warp 1 loads the head's dt and takes its cumsum.
// Consumer g takes the key tiles kt = g, g + 2, ... of both query tiles
// (C.B of the key tile for each, W' in registers, y += W' x), then the
// two consumers add their partial sums in a fixed order: consumer 0's
// first, for both tiles.
template <int NS, typename O>
__global__ void __launch_bounds__(WG_THREADS, 1)
ssd_intra_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tb,
                             const __grid_constant__ CUtensorMap tc,
                             const __grid_constant__ CUtensorMap to,
                             const float* __restrict__ dt,
                             const float* __restrict__ A, int N, int l,
                             int h, int hg) {
  using T = WgSsd<NS>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - raw);
  float* merge = reinterpret_cast<float*>(gen + T::MERGE_AT);  // [2][4096]
  float* s_cs = reinterpret_cast<float*>(gen + T::CS_AT);      // [2][MAX_L]
  float* s_dt = reinterpret_cast<float*>(gen + T::DT_AT);
  const uint32_t bars = base + T::BAR_AT;
  auto c_full = [&](int b) { return bars + 8 * b; };
  auto cs_full = [&](int b) { return bars + 8 * (2 + b); };
  auto item_empty = [&](int b) { return bars + 8 * (4 + b); };
  auto full = [&](int s) { return bars + 8 * (6 + s); };
  auto empty = [&](int s) { return bars + 8 * (6 + WG_STAGES + s); };
  const uint32_t part_full = bars + 8 * (6 + 2 * WG_STAGES);
  const uint32_t part_empty = part_full + 8;
  auto c_tile = [&](int b, int q) {
    return base + (2 * b + q) * T::BC_BYTES;
  };
  auto b_tile = [&](int s) { return base + T::RING_AT + s * T::STAGE; };

  const int nq = (l + WG_TILE - 1) / WG_TILE;
  const int n_items = (nq + 1) / 2 * N * h;
  auto item = [&](int w, int& chunk, int& head, int& qhi, int& qlo) {
    const int pi = w / (N * h);
    chunk = w % (N * h) / h;
    head = w % h;
    qhi = nq - 1 - pi;
    qlo = pi;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      hopper::mbar_init(c_full(b), 1);       // the TMA thread
      hopper::mbar_init(cs_full(b), 32);     // warp 1
      hopper::mbar_init(item_empty(b), 2);   // both consumers
    }
    for (int s = 0; s < WG_STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 1);
    }
    hopper::mbar_init(part_full, 128);     // every thread of consumer 0
    hopper::mbar_init(part_empty, 1);      // consumer 1's storing thread
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // the producer
    hopper::setmaxnreg_dec<WG_PRODUCER_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      int used0 = 0, used1 = 0;        // ring slots each consumer was given
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int chunk, head, qhi, qlo;
        item(w, chunk, head, qhi, qlo);
        const int grp = head / hg, b = it & 1;
        hopper::mbar_wait(item_empty(b), ((it >> 1) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(c_full(b),
                                      (qlo < qhi ? 2 : 1) * T::BC_BYTES);
        load_bc<NS>(c_tile(b, 0), &tc, c_full(b), qhi * WG_TILE, grp, chunk);
        if (qlo < qhi)
          load_bc<NS>(c_tile(b, 1), &tc, c_full(b), qlo * WG_TILE, grp,
                      chunk);
        for (int kt = 0; kt <= qhi; ++kt) {
          const int g = kt & 1, c = g ? used1++ : used0++;
          const int s = g + 2 * (c % WG_HALF);
          hopper::mbar_wait(empty(s), ((c / WG_HALF) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full(s), T::BC_BYTES + T::X_BYTES);
          load_bc<NS>(b_tile(s), &tb, full(s), kt * WG_TILE, grp, chunk);
          hopper::tma_load_4d(b_tile(s) + T::BC_BYTES, &tx, full(s), 0,
                              kt * WG_TILE, head, chunk);
        }
      }
    } else if (warp == 1) {
      // dt of the item's head, zero past l_end to the end of its tiles,
      // and its cumsum in fp32, left to right as the plain version's, while
      // the TMA thread's first loads are in flight
      for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
        int chunk, head, qhi, qlo;
        item(w, chunk, head, qhi, qlo);
        const int b = it & 1;
        const int lp = (qhi + 1) * WG_TILE, l_end = min(l, lp);
        float* sdt = s_dt + b * WG_MAX_L;
        float* scs = s_cs + b * WG_MAX_L;
        const float* dtc = dt + static_cast<long long>(chunk) * l * h + head;
        float v[WG_MAX_L / 32];        // every load in flight at once
#pragma unroll
        for (int k = 0; k < WG_MAX_L / 32; ++k) {
          const int t = lane + 32 * k;
          v[k] = t < l_end ? dtc[static_cast<long long>(t) * h] : 0.f;
        }
        hopper::mbar_wait(item_empty(b), ((it >> 1) & 1) ^ 1);
        // dt * A rounded as the plain version rounds dtA, a lane each;
        // then lane 0 adds them left to right, four a load and a store
        const float a = A[head];
#pragma unroll
        for (int k = 0; k < WG_MAX_L / 32; ++k) {
          const int t = lane + 32 * k;
          if (t < lp) {
            sdt[t] = v[k];
            scs[t] = __fmul_rn(v[k], a);
          }
        }
        __syncwarp();
        if (lane == 0) {                 // the next 8 loaded while 8 add
          float4* c4 = reinterpret_cast<float4*>(scs);
          const int n4 = (l_end + 3) / 4;
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 d0 = c4[0], d1 = n4 > 1 ? c4[1] : zero;
          float run = 0.f;
          for (int q = 0; q < n4; q += 2) {
            const float4 e0 = q + 2 < n4 ? c4[q + 2] : zero;
            const float4 e1 = q + 3 < n4 ? c4[q + 3] : zero;
            d0.x = run += d0.x;
            d0.y = run += d0.y;
            d0.z = run += d0.z;
            d0.w = run += d0.w;
            d1.x = run += d1.x;
            d1.y = run += d1.y;
            d1.z = run += d1.z;
            d1.w = run += d1.w;
            c4[q] = d0;
            if (q + 1 < n4) c4[q + 1] = d1;
            d0 = e0;
            d1 = e1;
          }
        }
        __syncwarp();
        for (int t = l_end + lane; t < lp; t += 32) scs[t] = 0.f;
        __syncwarp();
        hopper::mbar_arrive(cs_full(b));
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<WG_CONSUMER_REGS>();
  const int g = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int row = 16 * warp + lane / 4;  // of accumulator element 0
  const int col = 2 * (lane % 4);
  float acc[2][32];                      // the longer and the shorter tile
  float sc[2][32];                       // C.B of a key tile for each
  uint32_t wf[4][3][4];                  // W' of one tile, as A fragments
  int used = 0;                          // ring slots taken so far
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    int chunk, head, qhi, qlo;
    item(w, chunk, head, qhi, qlo);
    const int b = it & 1;
    const bool two = qlo < qhi;
    const float* cs = s_cs + b * WG_MAX_L;
    const float* dtv = s_dt + b * WG_MAX_L;
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[0][e] = acc[1][e] = 0.f;
    hopper::mbar_wait(c_full(b), (it >> 1) & 1);
    for (int kt = g; kt <= qhi; kt += 2) {
      const int s = g + 2 * (used % WG_HALF), lap = used / WG_HALF;
      ++used;
      hopper::mbar_wait(full(s), lap & 1);
      const bool lo = two && kt <= qlo;
      // C.B of the key tile for each query tile; the shorter tile's in a
      // group of its own, so that no product is issued on a divergent path
      // inside a group (ptxas would serialize every wgmma of the kernel)
      hopper::wgmma_fence();
      start_cb<NS>(sc[0], c_tile(b, 0), b_tile(s));
      hopper::wgmma_commit();
      if (lo) {
        hopper::wgmma_fence();
        start_cb<NS>(sc[1], c_tile(b, 1), b_tile(s));
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc[0]);
      hopper::fence_regs(sc[1]);
      hopper::mbar_wait(cs_full(b), (it >> 1) & 1);
      // W' of the longer tile and its product; then, once that product
      // has read its fragments, the shorter tile's
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1) {
          if (!lo) continue;
          hopper::wgmma_wait<0>();
          fence_frags(wf);
        }
        const int qt = q ? qlo : qhi;
        const int i0 = qt * WG_TILE + row, j0 = kt * WG_TILE + col;
        if (kt == qt || (qt + 1) * WG_TILE > l)
          form_w<true>(sc[q], wf, cs, dtv, i0, j0, l);
        else
          form_w<false>(sc[q], wf, cs, dtv, i0, j0, l);
        hopper::wgmma_fence();
        start_wx(acc[q], wf, b_tile(s) + T::BC_BYTES);
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc[0]);
      hopper::fence_regs(acc[1]);
      fence_frags(wf);
      if (t == 0) hopper::mbar_arrive(empty(s));
    }
    if (t == 0) hopper::mbar_arrive(item_empty(b));  // C, cs, dt read

    // y = consumer 0's sums + consumer 1's, for each tile.  Consumer 0,
    // which has the more key tiles, hands its sums over (buffer 0 the
    // longer tile's, 1 the shorter's) and goes on to its next item;
    // consumer 1 adds them to its own, stages each tile's y in the buffer
    // it read and stores it by TMA, then frees the buffers.
    float* part[2] = {merge, merge + 4096};
    if (g == 0) {
      hopper::mbar_wait(part_empty, (it & 1) ^ 1);
#pragma unroll
      for (int v = 0; v < 32; ++v) part[0][v * 128 + t] = acc[0][v];
      if (two) {
#pragma unroll
        for (int v = 0; v < 32; ++v) part[1][v * 128 + t] = acc[1][v];
      }
      hopper::mbar_arrive(part_full);
      continue;
    }
    hopper::mbar_wait(part_full, it & 1);
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[0][v] += part[0][v * 128 + t];
    if (two) {
#pragma unroll
      for (int v = 0; v < 32; ++v) acc[1][v] += part[1][v * 128 + t];
    }
    hopper::named_barrier(3, 128);       // the buffers are read
    stage_tile<O>(reinterpret_cast<unsigned char*>(part[0]), acc[0], row,
                  col);
    if (two)
      stage_tile<O>(reinterpret_cast<unsigned char*>(part[1]), acc[1], row,
                    col);
    hopper::fence_proxy_async();
    hopper::named_barrier(3, 128);
    if (t == 0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) continue;
        const uint32_t at = hopper::smem_u32(part[q]);
#pragma unroll
        for (int cb = 0; cb < WG_P * int(sizeof(O)) / 128; ++cb)
          hopper::tma_store_4d(&to, at + cb * WG_TILE * 128,
                               cb * 128 / int(sizeof(O)),
                               (q ? qlo : qhi) * WG_TILE, head, chunk);
      }
      hopper::bulk_commit();
      hopper::bulk_wait_all<true>();
      hopper::mbar_arrive(part_empty);
    }
  }
  if (t == 0) hopper::bulk_wait_all<false>();
}

// Launches the CUDA-core body at the plan's shared memory and grid.
template <typename T, typename O>
cudaError_t launch(const Plan& pl, const void* x, const void* dt,
                   const void* A, const void* B, const void* C, void* out,
                   int l, int h, int p, int g, int n, Strides xs, Strides bs,
                   Strides cs, cudaStream_t stream) {
  if (pl.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<T, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(pl.grid_x, pl.grid_y, pl.grid_z);
  ssd_intra_chunk_kernel<T, O><<<grid, THREADS, pl.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<O*>(out), l, h, p, h / g, n, xs,
      bs, cs);
  return cudaGetLastError();
}

// Launches the mma.sync body at the plan's heads a block, shared memory
// and grid.  Per device, the kernel's limit is raised only when a launch
// needs more than it was set to; a race between host threads only repeats
// a call.
template <int PMAX, typename O>
cudaError_t launch_mma(const Plan& pl, const void* x, const void* dt,
                       const void* A, const void* B, const void* C,
                       void* out, int dev, int l, int h, int p, int g, int n,
                       Strides xs, Strides bs, Strides cs,
                       cudaStream_t stream) {
  static int limit[M_MAX_DEVICES];
  if (pl.smem > limit[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_mma_kernel<PMAX, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    limit[dev] = pl.smem;
  }
  const dim3 grid(pl.grid_x, pl.grid_y, pl.grid_z);
  ssd_intra_chunk_mma_kernel<PMAX, O><<<grid, M_THREADS, pl.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<O*>(out), l, h, p,
      h / g, n, pl.heads_per_block, xs, bs, cs);
  return cudaGetLastError();
}

template <typename O>
cudaError_t launch_mma_p(const Plan& pl, const void* x, const void* dt,
                         const void* A, const void* B, const void* C,
                         void* out, int dev, int l, int h, int p, int g,
                         int n, Strides xs, Strides bs, Strides cs,
                         cudaStream_t stream) {
#define MMA_ARGS pl, x, dt, A, B, C, out, dev, l, h, p, g, n, xs, bs, cs, stream
  if (p <= 16) return launch_mma<16, O>(MMA_ARGS);
  if (p <= 32) return launch_mma<32, O>(MMA_ARGS);
  if (p <= 64) return launch_mma<64, O>(MMA_ARGS);
  return launch_mma<128, O>(MMA_ARGS);
#undef MMA_ARGS
}

// Negative returns of the entry point: no cuTensorMapEncodeTiled in
// libcuda, or a tensor map it refused.
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_TENSOR_MAP = -2;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime
// (this library does not link libcuda); null if libcuda has none.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The 4-d map (cols, row, head or group, chunk) of a [N, l, heads, cols]
// tensor (bf16, or `type` of `esize` bytes) addressed through its strides,
// in boxes of `box` columns by 64 rows.  A dimension of size 1 is never
// stepped: its stride, which torch may leave at any value, is given as
// cols elements.
bool encode_map(CUtensorMap* map, const void* base, int cols, int rows,
                int heads, int chunks, const Strides& st, int box,
                CUtensorMapSwizzle swizzle,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                int esize = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  auto stride = [&](int size, long long elems) {
    return static_cast<cuuint64_t>(size == 1 ? esize * cols : esize * elems);
  };
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows),
      static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(chunks)};
  const cuuint64_t strides[3] = {stride(rows, st.row),
                                 stride(heads, st.head),
                                 stride(chunks, st.chunk)};
  const cuuint32_t boxes[4] = {static_cast<cuuint32_t>(box), WG_TILE, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base),
            dims, strides, boxes, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches the Hopper body on the plan's blocks (its shared memory is
// WgSsd<NS>::SMEM, as the plan's).
template <int NS, typename O>
int launch_wgmma(const Plan& pl, const void* x, const void* dt,
                 const void* A, const void* B, const void* C, void* out,
                 int dev, int N, int l, int h, int g, Strides xs, Strides bs,
                 Strides cs, cudaStream_t stream) {
  using T = WgSsd<NS>;
  constexpr CUtensorMapSwizzle swizzle =
      T::SW128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap tx, tb, tc, to;
  constexpr bool F32 = sizeof(O) == 4;
  const Strides os{static_cast<long long>(l) * h * WG_P,
                   static_cast<long long>(h) * WG_P, WG_P};
  if (encode_tiled() == nullptr) return ERR_NO_ENCODER;
  if (!encode_map(&tx, x, WG_P, l, h, N, xs, WG_P,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_map(&tb, B, NS, l, g, N, bs, T::BOX, swizzle) ||
      !encode_map(&tc, C, NS, l, g, N, cs, T::BOX, swizzle) ||
      !encode_map(&to, out, WG_P, l, h, N, os, F32 ? 32 : 64,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  F32 ? 4 : 2))
    return ERR_TENSOR_MAP;
  // The shared-memory attribute once a device (a runtime call, on the
  // host's path of every prefill otherwise).
  static bool smem_set[M_MAX_DEVICES] = {};
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_wgmma_kernel<NS, O>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    smem_set[dev] = true;
  }
  ssd_intra_chunk_wgmma_kernel<NS, O><<<pl.grid_x, WG_THREADS, T::SMEM,
                                         stream>>>(
      tx, tb, tc, to, static_cast<const float*>(dt),
      static_cast<const float*>(A), N, l, h, h / g);
  return cudaGetLastError();
}

// The current device and its SMs and opt-in shared memory a block, each
// read once a device; a race between host threads only repeats a read.
cudaError_t device_limits(int* dev, int* sms, int* smem_optin) {
  static int sm_count[M_MAX_DEVICES], optin[M_MAX_DEVICES];
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= M_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[*dev] == 0) {
    int s = 0, o = 0;
    err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, *dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &o, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    optin[*dev] = o;
    sm_count[*dev] = s;
  }
  *sms = sm_count[*dev];
  *smem_optin = optin[*dev];
  return cudaSuccess;
}

}  // namespace

// x [N, l, h, p] and B, C [N, l, g, n] in one dtype, read through the given
// (chunk, row, head/group) strides with the last dimension contiguous;
// dt [N, l, h] and A [h] contiguous float32; out [N, l, h, p] contiguous.
// x_bf16: 1 for bfloat16 x, B, C, 0 for float32; out_bf16: 1 for a
// bfloat16 y (x must then be bfloat16), 0 for float32.  Picks the body by
// `plan_of` (ssd_plan.h) from the shape, the alignment of x, B, C and the
// current device's limits, writes the plan into plan[0..5] (body, smem,
// grid x, y, z, heads a block) before it launches, and launches that body
// or fails; it never takes another.  Returns a cudaError_t (0 on success),
// or ERR_NO_ENCODER / ERR_TENSOR_MAP (negative) when the Hopper body
// cannot build its tensor maps.
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* out, int x_bf16, int out_bf16, int N, int l, int h,
    int p, int g, int n, long long x_sc, long long x_sl, long long x_sh,
    long long b_sc, long long b_sl, long long b_sg, long long c_sc,
    long long c_sl, long long c_sg, int* plan, void* stream) {
  if (!shape_ok(N, l, h, p, g, n) || (out_bf16 && !x_bf16))
    return cudaErrorInvalidValue;
  const Strides xs{x_sc, x_sl, x_sh}, bs{b_sc, b_sl, b_sg},
      cs{c_sc, c_sl, c_sg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, optin = 0;
  const cudaError_t lim = device_limits(&dev, &sms, &optin);
  if (lim != cudaSuccess) return lim;
  const bool tc = x_bf16 && aligned16(x, xs, p) && aligned16(B, bs, n) &&
                  aligned16(C, cs, n);
  const Plan pl = plan_of(tc, N, l, h, p, g, n, sms, optin);
  write_plan(pl, plan);
  if (pl.body == BODY_WGMMA) {
#define WG_ARGS pl, x, dt, A, B, C, out, dev, N, l, h, g, xs, bs, cs, st
    return n == 16 ? (out_bf16 ? launch_wgmma<16, __nv_bfloat16>(WG_ARGS)
                               : launch_wgmma<16, float>(WG_ARGS))
                   : (out_bf16 ? launch_wgmma<128, __nv_bfloat16>(WG_ARGS)
                               : launch_wgmma<128, float>(WG_ARGS));
#undef WG_ARGS
  }
  if (pl.body == BODY_MMA)
    return out_bf16 ? launch_mma_p<__nv_bfloat16>(pl, x, dt, A, B, C, out,
                                                  dev, l, h, p, g, n, xs, bs,
                                                  cs, st)
                    : launch_mma_p<float>(pl, x, dt, A, B, C, out, dev, l, h,
                                          p, g, n, xs, bs, cs, st);
  if (!x_bf16)
    return launch<float, float>(pl, x, dt, A, B, C, out, l, h, p, g, n, xs,
                                bs, cs, st);
  if (out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(pl, x, dt, A, B, C, out, l,
                                                h, p, g, n, xs, bs, cs, st);
  return launch<__nv_bfloat16, float>(pl, x, dt, A, B, C, out, l, h, p, g,
                                      n, xs, bs, cs, st);
}
