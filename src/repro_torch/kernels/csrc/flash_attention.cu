// Flash attention forward (causal or full, GQA) for NVIDIA Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:27 `_flash_kernel`
// (launched by `flash_attention` at :71, `pl.pallas_call` at :97).
//
// Three bodies, chosen by the plan of kernels/flash_attention.py (`_plan`),
// which passes its mode, tile, stages, shared memory and grid to the entry
// point below; the entry point refuses a plan that does not match the
// instance it names, and never takes another body:
//   * bfloat16 at D = 64, 128, 256 (every full-width main path):
//     `flash_fwd_wgmma_kernel`, TMA loads into a ring of mbarrier-tracked
//     stages fed by a producer warp, products on wgmma.  Two modes, "rows"
//     and "split" (below).
//   * bfloat16 at D = 16, 32 (the reduced configs and the test sweep):
//     `flash_fwd_mma_kernel`, mma.sync m16n8k16 fed by cp.async and
//     ldmatrix (the earlier bf16 body).  wgmma's 128-byte swizzled tiles
//     want rows of 64 elements; these head dims run only at toy sizes.
//   * float32, the exactness path: `flash_fwd_kernel`, fp32 FMAs on the
//     CUDA cores.  A TF32 product would keep ~3 decimal digits, which the
//     2e-5 sweep tolerance and the 1e-4 card-vs-CPU logits check of the
//     fp32 model do not allow.
//
// What bounds it on the card.  A causal forward does 4 H D S (S + 1) / 2
// FLOPs on 2 B S (H + Hk) D 2 bytes: at a B8 train shape (internvl2-2b,
// 16 query and 8 KV heads of 128, S = 512) 8.6 GFLOP, 8.7 us at the bf16
// peak, on 50 MB, 15.0 us at the HBM rate; at a B1 prefill (S = 128..640)
// both bounds are under 3 us and the kernel is bound by latency: the
// serial path of the heaviest block and how few blocks fill 132 SMs.
// The mma.sync body reached 73 TFLOP/s at the internvl2 train shape
// and ran 2.0-3.8x SDPA's time at every B8 train shape: mma.sync cannot
// reach the tensor cores' wgmma rate, 157-240 registers a thread left one
// block of 8 warps an SM, and the warps that multiplied also made every
// copy and its address arithmetic.
//
// The wgmma design against that:
//   * TMA.  Tensor maps cover q, k and v as the wrapper passes them, 4-d
//     (D, seq, head, batch) through their strides: [B,S,H,D] views of one
//     qkv buffer are read in place.  A tile is loaded as boxes of 64
//     columns (128 bytes, CU_TENSOR_MAP_SWIZZLE_128B): one a row at D = 64,
//     two at 128, four at 256.  Rows past S or T are zero-filled by the
//     copy; columns at or past T are still masked to NEG_INF.  The maps are
//     encoded on the host for every call (cuTensorMapEncodeTiled, reached
//     through cudaGetDriverEntryPoint: no -lcuda) and passed as
//     __grid_constant__ parameters.
//   * A ring of K/V stages with full and empty mbarriers.  One thread of
//     the producer warpgroup starts every copy; the producer gives up its
//     registers (setmaxnreg 24) to the two consumer warpgroups (240).
//   * wgmma.  S = Q K^T with Q and K from shared memory (K-major), fp32
//     accumulators; the online softmax runs on the accumulator fragment
//     in registers; P goes to bf16 in registers and is the A operand of
//     O += P V, V read from shared memory through the descriptor's
//     transpose.  bf16 x bf16 products are exact in fp32, so QK^T computes
//     the reference's fp32 dot up to summation order.
//   * Two modes, one launch a call.  "rows": 128-row work tiles, each
//     consumer warpgroup 64 of a tile's rows against every KV tile, so a
//     KV tile loaded once serves 128 rows; one block an SM walks the work
//     tiles (persistent), so the producer loads the next tile's Q and KV
//     while the consumers finish the current one.  For grids that fill
//     the card (the B8 train shapes).  "split": a block a 64-row tile, the
//     two warpgroups taking alternate KV tiles, each from its own half of
//     the ring, then merging their (m, l, acc) through shared memory as
//     the online softmax merges two tiles; for the B1 prefills, where
//     tiles are fewer than SMs and a block's serial path sets the time.
//     The rule is the plan's (`_plan`'s docstring).
//   * In a warpgroup, tile i's S = Q K^T is started with tile i-1's O +=
//     P V, and the softmax of tile i runs while the tensor cores do P V
//     (with two stages of the warpgroup's own at least).  Exponentials
//     are one ex2.approx each, in base 2 (s is scaled by scale log2(e)
//     once), with no select per score: clock64() stamps in a development
//     build showed the softmax, not the products, setting a tile's time
//     while exp2f's range checks and a select per score stood in it.
//   * Causal work: KV tiles wholly above the diagonal are not loaded, a
//     warpgroup whose rows all lie before a tile's first key skips it, only
//     tiles that cross the diagonal or the ragged end of T compute a mask,
//     and work tiles are numbered from the last query tile, so the
//     heaviest are dispatched (split) or walked (rows) first.
//
// Every body keeps the TPU kernel's arithmetic: s = (q.k) * scale in fp32
// (:42-43); the online softmax with fp32 running max, sum and accumulator;
// NEG_INF = -1e30 masks, the guard for fully masked rows (safe_m, alpha)
// and the flush by 1 / max(l, 1e-30) (:55-67); causal positions from 0 on
// both axes; GQA by h / G with KV never replicated; P rounded to bf16 once
// before PV, as kernels/ref.py rounds `w.to(v.dtype)`, while l sums the
// fp32 p.  Inputs are read through (batch, seq, head) strides with the
// last dim contiguous; [B,H,S,D] is the same kernel with two strides
// swapped.  The bf16 bodies need 16-byte-aligned base pointers and every
// stride a multiple of 8 elements (TMA and cp.async); the wrapper raises
// otherwise, and the entry point returns cudaErrorMisalignedAddress.
//
// Head dims: 16, 32, 64, 128 or 256; any other D is refused
// (cudaErrorInvalidValue) and the wrapper raises before the launch.
//
// The mma.sync body (D 16, 32): a block owns 64 query rows with 8 warps in
// two groups; a warp owns a 16-row slice and the KV tiles of its group (a
// ring stage holds one 64-key tile for each group, loaded by 16-byte
// cp.async), Q's fragments stay in registers, P stays in registers as the
// A fragment of PV, shared rows are padded by 16 bytes for ldmatrix, and
// group 1 hands its (m, l, acc) to group 0 through shared memory.
//
// The fp32 body: one block per (32-row query tile, head, batch), 4
// threads per row, q, k, v staged in shared memory as fp32 rows padded to
// D+1 floats; each thread holds 16 scores of a 64-key tile and D/4 output
// columns.
//
// Registers and spills: ptxas -v for sm_90a, as phase 2 of chip_smoke.py
// prints them (PERF.md).
//
// The wrapper (kernels/flash_attention.py) checks device, dtype, shapes,
// strides and alignment and makes the plan; this file launches on the
// caller's stream and returns cudaGetLastError(), or a negative code when
// a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 32;               // fp32 body: query rows per block
constexpr int BK = 64;               // keys per KV tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 128
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int MMA_BQ = 64;           // mma.sync body: query rows per block
constexpr int MMA_SLICES = MMA_BQ / 16;       // 16-row slices, one a warp
constexpr int MMA_SPLIT = 2;         // warp groups sharing out the KV tiles
constexpr int MMA_THREADS = MMA_SLICES * MMA_SPLIT * 32;  // 256

// The mma.sync body's tiling: 64-key tiles, and the dynamic shared memory
// (Q tile and a ring of two stages of K and V, rows padded to D + 8).
template <int D>
struct MmaTile {
  static constexpr int BK = 64;
  static constexpr int SUPER = MMA_SPLIT * BK;  // keys of one ring stage
  static constexpr int SMEM = (MMA_BQ + 4 * SUPER) * (D + 8) * 2;
  static_assert(D % 16 == 0 && D <= 32, "the wgmma body takes D >= 64");
  // the groups' merge reuses the ring: (SPLIT - 1) x SLICES x 32 lanes x
  // (acc, m, l) floats
  static_assert((MMA_SPLIT - 1) * MMA_SLICES * 32 * (D / 2 + 4) * 4 <=
                    4 * SUPER * (D + 8) * 2,
                "the merge does not fit in the ring");
};

// The wgmma body: one producer warpgroup and two consumer warpgroups.
constexpr int WG_THREADS = 384;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;   // 24 x 128 + 240 x 256 <= 65,536

// Its tiling by head dim and mode: query rows of a block, keys of a KV
// tile, ring stages, and the dynamic shared memory (Q tile, then the ring's
// K stages, then its V stages, 1024-byte aligned for the 128-byte swizzle,
// then the barriers).  Split mode gives each warpgroup its own half of the
// ring (an even number of stages), so that neither waits on a barrier
// phase that the other's tiles advance.
template <int D, bool SPLIT>
struct WgTile {
  static constexpr int BM = SPLIT ? 64 : 128;
  static constexpr int BK = (SPLIT || D > 128) ? 64 : 128;
  static constexpr int STAGES = SPLIT ? (D > 128 ? 2 : 4) : (D > 128 ? 2 : 3);
  static constexpr int NCB = D / 64;             // 64-column boxes of a row
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;    // K or V of one stage
  static constexpr int RING = STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = Q_BYTES + RING + 1024 + 128;
  static_assert(D % 64 == 0, "rows of whole 128-byte swizzle atoms");
  static_assert(SMEM <= 232448, "past a block's shared memory");
  static_assert(!SPLIT || STAGES % 2 == 0, "split: a half ring each");
  static_assert(8 * (2 + 2 * STAGES) <= 128, "the barriers' room");
  // split: warpgroup 1's (acc, m, l) reuse the ring for the merge
  static_assert(!SPLIT || (D / 2 + 4) * 128 * 4 <= RING,
                "the merge does not fit in the ring");
};


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

struct Strides {
  long long b, s, h;                 // elements; the head dim is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                 int G, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  constexpr int DP = D + 1;          // padded row length
  constexpr int PP = BK + 1;
  constexpr int CPT = BK / TPR;      // score columns per thread
  constexpr int DPT = D / TPR;       // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                  // [BQ][DP]
  float* sk = sq + BQ * DP;          // [BK][DP]
  float* sv = sk + BK * DP;          // [BK][DP]
  float* sp = sv + BK * DP;          // [BQ][PP] probabilities

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;
  const int qpos = q0 + row;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int s = q0 + r;
    sq[r * DP + d] = s < S ? to_f32(qb[s * qs.s + d]) : 0.f;
  }

  float m_run = NEG_INF, l_run = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  // Causal: a tile starting past the block's last query row is all masked.
  const int kv_end = causal ? min(T_len, q0 + BQ) : T_len;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const int t = k0 + r;
      const bool ok = t < T_len;
      sk[r * DP + d] = ok ? to_f32(kb[t * ks.s + d]) : 0.f;
      sv[r * DP + d] = ok ? to_f32(vb[t * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[CPT];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = lane + TPR * j;
      const int t = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += sq[row * DP + d] * sk[c * DP + d];
      const bool valid = t < T_len && (!causal || t <= qpos);
      s[j] = valid ? dot * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    // The TPR threads of a row are adjacent lanes of one warp.
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    const float safe_m = m_new <= NEG_INF ? 0.f : m_new;
    const float alpha = m_run <= NEG_INF ? 0.f : expf(m_run - safe_m);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = s[j] <= NEG_INF ? 0.f : expf(s[j] - safe_m);
      sp[row * PP + lane + TPR * j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    __syncwarp();                    // a row's probabilities come from its own warp
    // Key by key, each weight read once: every output column still sums
    // its keys in order, and no column's weights are held in registers
    // (at D = 256, 64 accumulators a thread besides them).
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = sp[row * PP + c];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * sv[c * DP + lane + TPR * i];
    }
  }

  if (qpos < S) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* ob = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[lane + TPR * i] = from_f32<T>(acc[i] / denom);
  }
}

// The mma.sync body (D 16, 32; see the note at the top).  Block (h, b, z)
// owns query rows [q0, q0 + 64) of head h.  Warp w works on the 16 rows of
// slice w % 4 with the KV tiles of group w / 4: ring stage j holds tiles
// 2j and 2j + 1, one for each group.  Group 1 hands its (m, l, acc) to
// group 0, which merges them and writes the output.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int S, int T_len, int G,
                     Strides qs, Strides ks, Strides vs, Strides os,
                     float scale, int causal) {
  using bf16 = __nv_bfloat16;
  using Tile = MmaTile<D>;
  constexpr int BK = Tile::BK;
  constexpr int SUPER = Tile::SUPER;
  constexpr int SROW = D + 8;        // padded shared row (elements)
  constexpr int CHUNKS = D / 8;      // 16-byte chunks of a row
  constexpr int NS = BK / 8;         // 8-key column tiles of the scores
  constexpr int NO = D / 8;          // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [MMA_BQ][SROW]
  bf16* sk = sq + MMA_BQ * SROW;                 // [2][SUPER][SROW]
  bf16* sv = sk + 2 * SUPER * SROW;              // [2][SUPER][SROW]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int slice = warp % MMA_SLICES;
  const int group = warp / MMA_SLICES;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * MMA_BQ;
  const int hk = h / G;
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  for (int i = tid; i < MMA_BQ * CHUNKS; i += MMA_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const int s = q0 + r;
    mma::cp_async16(sq + r * SROW + c, qb + min(s, S - 1) * qs.s + c, s < S);
  }
  auto load_kv = [&](int k0, int stage) {
    bf16* dk = sk + stage * SUPER * SROW;
    bf16* dv = sv + stage * SUPER * SROW;
    for (int i = tid; i < SUPER * CHUNKS; i += MMA_THREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const int t = k0 + r;
      const long long tc = min(t, T_len - 1);
      mma::cp_async16(dk + r * SROW + c, kb + tc * ks.s + c, t < T_len);
      mma::cp_async16(dv + r * SROW + c, vb + tc * vs.s + c, t < T_len);
    }
    mma::cp_async_commit();
  };

  // Causal: a tile starting past the block's last query row is all masked.
  const int kv_end = causal ? min(T_len, q0 + MMA_BQ) : T_len;
  const int n_stages = (kv_end + SUPER - 1) / SUPER;
  load_kv(0, 0);                     // one group with the Q tile

  const int row_lo = q0 + slice * 16;
  const int r0 = row_lo + lane / 4;  // rows of c0, c1; c2, c3 are r0 + 8
  unsigned qf[D / 16][4];            // Q's A fragments, held all along
  const bf16* q_frag = sq + (slice * 16 + lane % 16) * SROW + (lane / 16) * 8;
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};       // this lane's part of the row sums

  for (int j = 0; j < n_stages; ++j) {
    mma::cp_async_wait_all();
    __syncthreads();                 // stage j landed; stage j-1 is consumed
    if (j + 1 < n_stages) load_kv((j + 1) * SUPER, (j + 1) % 2);
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma::ldmatrix_x4(qf[kk], q_frag + kk * 16);
    }
    const int k0 = j * SUPER + group * BK;
    if (row_lo >= S || k0 >= kv_end || (causal && k0 > row_lo + 15))
      continue;
    const bf16* tk = sk + ((j % 2) * SUPER + group * BK) * SROW;
    const bf16* tv = sv + ((j % 2) * SUPER + group * BK) * SROW;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned kf[4];              // b0, b1 of key tiles n and n + 1
        mma::ldmatrix_x4(kf, tk + (n * 8 + lane % 8 + (lane / 16) * 8) * SROW
                                 + kk * 16 + ((lane / 8) % 2) * 8);
        mma::mma_bf16_16816(s[n], qf[kk], kf[0], kf[1]);
        mma::mma_bf16_16816(s[n + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const bool need_mask =
        k0 + BK > T_len || (causal && k0 + BK - 1 > row_lo);
    float m_tile[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (need_mask) {
          const int t = k0 + n * 8 + (lane % 4) * 2 + (e & 1);
          const int qpos = r0 + (e >> 1) * 8;
          if (t >= T_len || (causal && t > qpos)) x = NEG_INF;
        }
        s[n][e] = x;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
      }
    float safe_m[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // a row's 4 lanes are one quad
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m_run[r], m_tile[r]);
      safe_m[r] = m_new <= NEG_INF ? 0.f : m_new;
      alpha[r] = m_run[r] <= NEG_INF ? 0.f : expf(m_run[r] - safe_m[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            s[n][e] <= NEG_INF ? 0.f : expf(s[n][e] - safe_m[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // The C fragments of key tiles 2kk and 2kk+1 are the A fragment of
      // keys 16kk .. 16kk+15.
      const float(&lo)[4] = s[2 * kk];
      const float(&hi)[4] = s[2 * kk + 1];
      const unsigned pf[4] = {
          mma::pack_bf16(lo[0], lo[1]), mma::pack_bf16(lo[2], lo[3]),
          mma::pack_bf16(hi[0], hi[1]), mma::pack_bf16(hi[2], hi[3])};
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        unsigned vf[4];              // b0, b1 of output tiles n and n + 1
        mma::ldmatrix_x4_trans(
            vf, tv + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * SROW +
                    n * 8 + (lane / 16) * 8);
        mma::mma_bf16_16816(acc[n], pf, vf[0], vf[1]);
        mma::mma_bf16_16816(acc[n + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // Merge the groups' partial softmaxes, as the online softmax merges two
  // tiles, through shared memory (the ring is free once every warp is
  // past its last tile): [group - 1][slice][value][lane] floats.
  constexpr int PART = NO * 4 + 4;   // acc, then m and l of both rows
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* part = reinterpret_cast<float*>(sk);
  __syncthreads();
  if (group > 0) {
    float* mine = part + ((group - 1) * MMA_SLICES + slice) * PART * 32 + lane;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = acc[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mine[(NO * 4 + r) * 32] = m_run[r];
      mine[(NO * 4 + 2 + r) * 32] = l[r];
    }
  }
  __syncthreads();
  if (group > 0) return;
#pragma unroll
  for (int g = 1; g < MMA_SPLIT; ++g) {
    const float* other =
        part + ((g - 1) * MMA_SLICES + slice) * PART * 32 + lane;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_o = other[(NO * 4 + r) * 32];
      const float m_new = fmaxf(m_run[r], m_o);
      const float safe_m = m_new <= NEG_INF ? 0.f : m_new;
      const float a = m_run[r] <= NEG_INF ? 0.f : expf(m_run[r] - safe_m);
      const float a_o = m_o <= NEG_INF ? 0.f : expf(m_o - safe_m);
      l[r] = a * l[r] + a_o * other[(NO * 4 + 2 + r) * 32];
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[n][2 * r + c] =
              a * acc[n][2 * r + c] + a_o * other[(n * 4 + 2 * r + c) * 32];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    const int qpos = r0 + 8 * r;
    if (qpos < S) {
      bf16* orow = o + b * os.b + h * os.h + qpos * os.s + (lane % 4) * 2;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
            __floats2bfloat162_rn(acc[n][2 * r] / denom,
                                  acc[n][2 * r + 1] / denom);
    }
  }
}

// The slot of KV tile j in the ring, and the lap (how many times that
// stage has been filled before).  Rows mode: every warpgroup reads every
// tile, stages in turn.  Split mode: tile j belongs to warpgroup j % 2,
// which has the stages of its parity to itself.
template <int STAGES, bool SPLIT>
__device__ __forceinline__ void ring_slot(int j, int& stage, int& lap) {
  if constexpr (SPLIT) {
    constexpr int HALF = STAGES / 2;
    const int i = j / 2;
    stage = j % 2 + 2 * (i % HALF);
    lap = i / HALF;
  } else {
    stage = j % STAGES;
    lap = j / STAGES;
  }
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "no such S tile");
  if constexpr (N == 64) hopper::wgmma_ss_n64(d, a, b, scale_d);
  else hopper::wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 256, "no such head dim");
  if constexpr (N == 64) hopper::wgmma_rs_n64(d, a, b, 1);
  else if constexpr (N == 128) hopper::wgmma_rs_n128(d, a, b, 1);
  else hopper::wgmma_rs_n256(d, a, b, 1);
}

// S = Q K^T of one KV tile (not committed): Q from the 64 rows at q_at,
// K from the stage at k_at, both K-major boxes of 64 columns; k-step kk
// reads box kk / 4 at byte 32 (kk % 4).
template <int D, int BM, int BK>
__device__ __forceinline__ void start_qk(float (&s)[BK / 2], uint32_t q_at,
                                         uint32_t k_at) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = q_at + (kk / 4) * BM * 128 + (kk % 4) * 32;
    const uint32_t ka = k_at + (kk / 4) * BK * 128 + (kk % 4) * 32;
    wgmma_ss<BK>(s, hopper::sw128_desc(qa, 16, 1024),
                 hopper::sw128_desc(ka, 16, 1024), kk > 0);
  }
}

// O += P V of one KV tile (not committed): V MN-major from the stage at
// v_at, its 64-column boxes BK * 128 bytes apart; k-step kk is keys
// 16 kk .. 16 kk + 15.
template <int D, int BK>
__device__ __forceinline__ void start_pv(float (&acc)[D / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t v_at) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, p[kk],
                hopper::sw128_desc(v_at + kk * 16 * 128, BK * 128, 1024));
}

// The online softmax of one tile's scores in place (s becomes the fp32 p,
// in base 2): masks (only where the tile crosses the diagonal or the end
// of T), the running max and the guards, alpha for the rescale of O, and
// this thread's part of the row sums.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m_run)[2],
                                               float (&l_run)[2],
                                               float (&alpha)[2], int k0,
                                               int row0, int lane, int T_len,
                                               int causal, int r_lo,
                                               float scale_log2) {
  const bool need_mask = k0 + BK > T_len || (causal && k0 + BK - 1 > r_lo);
  float m_tile[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i] * scale_log2;
    if (need_mask) {
      const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int qpos = row0 + 8 * ((i >> 1) & 1);
      if (key >= T_len || (causal && key > qpos)) x = NEG_INF;
    }
    s[i] = x;
    m_tile[(i >> 1) & 1] = fmaxf(m_tile[(i >> 1) & 1], x);
  }
  float safe_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {        // a row's 4 lanes are one quad
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
    m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
    const float m_new = fmaxf(m_run[r], m_tile[r]);
    safe_m[r] = m_new <= NEG_INF ? 0.f : m_new;
    alpha[r] = m_run[r] <= NEG_INF ? 0.f
                                   : hopper::exp2_approx(m_run[r] - safe_m[r]);
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
  // A masked score is NEG_INF and 2^(NEG_INF - safe_m) is 0, as the
  // reference takes exp(NEG_INF) for it: no select per element.
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = hopper::exp2_approx(s[i] - safe_m[r]);
    l_run[r] += s[i];
  }
}

// P rounded to bf16 as the A fragments of PV: accumulator columns 16 kk ..
// 16 kk + 15 are k-step kk's fragment.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2],
                                       uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p[kk][c] = mma::pack_bf16(s[8 * kk + 2 * c], s[8 * kk + 2 * c + 1]);
}

// The wgmma body (see the note at the top).  Work tile w, the heaviest
// first, is query rows [q0, q0 + BM) of head h of batch b: w / (B H)
// counts query tiles from the last, then w walks batches and heads, so the
// heads of a GQA group sit side by side.  Split mode launches a block a
// work tile; rows mode one block an SM (the plan's grid), each walking the
// work tiles w = blockIdx.x + gridDim.x i, so that the producer loads a
// tile's Q and KV while the consumers finish the last one.  Warpgroup 0 is
// the producer; consumer g (warpgroup g + 1) owns rows [q0 + 64 g, q0 +
// 64 g + 64) against every KV tile in rows mode, and rows [q0, q0 + 64)
// against the KV tiles j with j % 2 == g in split mode.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int B, int H, int S,
                       int T_len, int G, Strides os, float scale_log2,
                       int causal) {
  using Tile = WgTile<D, SPLIT>;
  constexpr int BM = Tile::BM, BK = Tile::BK, STAGES = Tile::STAGES;
  constexpr int NCB = Tile::NCB, KV_BYTES = Tile::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;   // Q: NCB boxes of [BM][64]
  const uint32_t sk = sq + Tile::Q_BYTES;       // stage s: NCB of [BK][64]
  const uint32_t sv = sk + STAGES * KV_BYTES;
  const uint32_t bars = sv + STAGES * KV_BYTES;
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + STAGES + s); };

  const int n_q = (S + BM - 1) / BM;
  const int n_work = n_q * B * H;
  auto work = [&](int w, int& q0, int& h, int& b) {
    q0 = (n_q - 1 - w / (B * H)) * BM;
    b = w % (B * H) / H;
    h = w % H;
  };
  // KV tiles of a work tile.  Causal: a tile starting past its last query
  // row is all masked, and not visited.
  auto kv_tiles = [&](int q0) {
    return ((causal ? min(T_len, q0 + BM) : T_len) + BK - 1) / BK;
  };
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 2);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), SPLIT ? 1 : 2);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {                       // the producer
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int ring = 0;                    // KV tiles through the ring so far
      for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
        int q0, h, b;
        work(w, q0, h, b);
        const int n_kv = kv_tiles(q0), hk = h / G;
        // Q of the last work tile is free once both consumers' last Q K^T
        // is done.
        if (it > 0) hopper::mbar_wait(q_empty, (it - 1) & 1);
        hopper::mbar_arrive_expect_tx(q_full, Tile::Q_BYTES);
        for (int cb = 0; cb < NCB; ++cb)
          hopper::tma_load_4d(sq + cb * BM * 128, &tq, q_full, cb * 64, q0, h,
                              b);
        for (int j = 0; j < n_kv; ++j) {
          int stage, lap;
          ring_slot<STAGES, SPLIT>(ring + j, stage, lap);
          hopper::mbar_wait(empty(stage), (lap & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(full(stage), 2 * KV_BYTES);
          for (int cb = 0; cb < NCB; ++cb) {
            const uint32_t at = stage * KV_BYTES + cb * BK * 128;
            hopper::tma_load_4d(sk + at, &tk, full(stage), cb * 64, j * BK,
                                hk, b);
            hopper::tma_load_4d(sv + at, &tv, full(stage), cb * 64, j * BK,
                                hk, b);
          }
        }
        ring += n_kv;
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int g = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int first = SPLIT ? g : 0, step = SPLIT ? 2 : 1;
  constexpr bool OVERLAP = (SPLIT ? STAGES / 2 : STAGES) >= 2;
  const uint32_t q_at = sq + (SPLIT ? 0 : g * 64 * 128);
  float acc[D / 2];
  float m_run[2], l_run[2];            // l_run: this thread's part of the sums
  float s[BK / 2], alpha[2];
  uint32_t p[BK / 16][4];              // P as the A fragments of PV

  int ring = 0;
  for (int w = blockIdx.x, it = 0; w < n_work; w += gridDim.x, ++it) {
    int q0, h, b;
    work(w, q0, h, b);
    const int n_kv = kv_tiles(q0);
    const int r_lo = q0 + (SPLIT ? 0 : 64 * g);  // the warpgroup's 1st row
    const int row0 = r_lo + 16 * warp + lane / 4;  // d[4j+c]; +8: d[4j+2+c]
    // This warpgroup's KV tiles: j = first + step i for i < n_all, of which
    // it computes the first n_mine (in rows mode, causal, a tile whose
    // first key lies past all of its rows is only released).
    const int n_all = SPLIT ? (n_kv - g + 1) / 2 : n_kv;
    const int n_mine = r_lo >= S ? 0
                       : (!SPLIT && causal) ? min(n_all, (r_lo + 63) / BK + 1)
                                            : n_all;
    auto wait_tile = [&](int i) {    // the stage of tile i, once it landed
      int stage, lap;
      ring_slot<STAGES, SPLIT>(ring + first + step * i, stage, lap);
      hopper::mbar_wait(full(stage), lap & 1);
      return stage;
    };
    auto release = [&](int stage) {  // the warpgroup's products are done
      if (t == 0) hopper::mbar_arrive(empty(stage));
    };
    auto key0 = [&](int i) { return (first + step * i) * BK; };
    // O += P V of the tile in `stage`, waited for; then the stage is free.
    auto finish_pv = [&](int stage) {
      hopper::wgmma_fence();
      start_pv<D, BK>(acc, p, sv + stage * KV_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(stage);
    };

#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m_run[0] = m_run[1] = NEG_INF;
    l_run[0] = l_run[1] = 0.f;
    hopper::mbar_wait(q_full, it & 1);

    // With two stages of its own or more, a warpgroup starts tile i's S =
    // Q K^T together with tile i-1's O += P V: the softmax of tile i runs
    // while the tensor cores do P V, and O is rescaled by tile i's alpha
    // once P V has landed.  With one (split mode at D 256), tile i's stage
    // is tile i-1's: P V finishes and frees it before tile i is waited for.
    if (n_mine > 0) {
      int prev = wait_tile(0);
      hopper::wgmma_fence();
      start_qk<D, BM, BK>(s, q_at, sk + prev * KV_BYTES);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      online_softmax<BK>(s, m_run, l_run, alpha, key0(0), row0, lane, T_len,
                         causal, r_lo, scale_log2);
      pack_p<BK>(s, p);
      for (int i = 1; i < n_mine; ++i) {
        if constexpr (!OVERLAP) finish_pv(prev);
        const int stage = wait_tile(i);
        hopper::wgmma_fence();
        start_qk<D, BM, BK>(s, q_at, sk + stage * KV_BYTES);
        hopper::wgmma_commit();
        if constexpr (OVERLAP) {
          start_pv<D, BK>(acc, p, sv + prev * KV_BYTES);
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();     // S of tile i; P V still running
        } else {
          hopper::wgmma_wait<0>();
        }
        hopper::fence_regs(s);
        online_softmax<BK>(s, m_run, l_run, alpha, key0(i), row0, lane,
                           T_len, causal, r_lo, scale_log2);
        if constexpr (OVERLAP) {
          // the softmax's results before the wait, so that the compiler
          // does not sink the exponentials below it
          hopper::fence_regs(s);
          hopper::fence_regs(l_run);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          hopper::fence_regs(p);
          release(prev);
        }
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
        pack_p<BK>(s, p);
        prev = stage;
      }
      if (t == 0) hopper::mbar_arrive(q_empty);  // the last Q K^T is done
      finish_pv(prev);
    } else if (t == 0) {
      hopper::mbar_arrive(q_empty);
    }
    for (int i = n_mine; i < n_all; ++i) release(wait_tile(i));
    ring += n_kv;

    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l_run[r] + __shfl_xor_sync(0xffffffffu, l_run[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if constexpr (SPLIT) {
      // Merge the two partial softmaxes through the ring, free once both
      // warpgroups are past their last product (split mode has one work
      // tile a block): value v of thread t at part[v * 128 + t], acc then
      // m and l of both rows.
      float* part = reinterpret_cast<float*>(smem_raw + (sk - raw));
      hopper::named_barrier(1, 256);
      if (g == 1) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) part[i * 128 + t] = acc[i];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          part[(D / 2 + r) * 128 + t] = m_run[r];
          part[(D / 2 + 2 + r) * 128 + t] = l[r];
        }
      }
      hopper::named_barrier(2, 256);
      if (g == 1) return;
      float a[2], a_o[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_o = part[(D / 2 + r) * 128 + t];
        const float m_new = fmaxf(m_run[r], m_o);
        const float safe = m_new <= NEG_INF ? 0.f : m_new;
        a[r] = m_run[r] <= NEG_INF ? 0.f
                                   : hopper::exp2_approx(m_run[r] - safe);
        a_o[r] = m_o <= NEG_INF ? 0.f : hopper::exp2_approx(m_o - safe);
        l[r] = a[r] * l[r] + a_o[r] * part[(D / 2 + 2 + r) * 128 + t];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int r = (i >> 1) & 1;
        acc[i] = a[r] * acc[i] + a_o[r] * part[i * 128 + t];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + 8 * r;
      if (qpos < S) {
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow =
            o + b * os.b + h * os.h + qpos * os.s + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                    acc[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hk, int S, int T_len, Strides qs,
                       Strides ks, Strides vs, Strides os, float scale,
                       int causal, cudaStream_t stream) {
  constexpr int smem = MmaTile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (S + MMA_BQ - 1) / MMA_BQ);
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      T_len, H / Hk, qs, ks, vs, os, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hk, int S, int T_len, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale, int causal,
                   cudaStream_t stream) {
  const int smem =
      static_cast<int>(((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H / Hk, qs, ks,
      vs, os, scale, causal);
  return cudaGetLastError();
}

// Negative returns of the entry point: no cuTensorMapEncodeTiled in
// libcuda, or a tensor map it refused.
constexpr int ERR_NO_ENCODER = -1;
constexpr int ERR_TENSOR_MAP = -2;
constexpr int MAX_DEVICES = 64;

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

// The 4-d map (D, seq, head, batch) of a bf16 [B, seq, heads, D] tensor
// read through its strides, in boxes of 64 columns by `rows`, 128-byte
// swizzled.  A dimension of size 1 is never stepped: its stride, which
// torch may leave at any value, is given as 2 D bytes.
bool encode_map(CUtensorMap* map, const void* base, int D, int seq,
                int heads, int batch, const Strides& st, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  auto stride = [&](int size, long long elems) {
    return static_cast<cuuint64_t>(size == 1 ? 2 * D : 2 * elems);
  };
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {stride(seq, st.s), stride(heads, st.h),
                                 stride(batch, st.b)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool SPLIT>
int launch_wgmma(int blocks, const void* q, const void* k, const void* v,
                 void* o, int B, int H, int Hk, int S, int T_len, Strides qs,
                 Strides ks, Strides vs, Strides os, float scale, int causal,
                 cudaStream_t stream) {
  using Tile = WgTile<D, SPLIT>;
  CUtensorMap tq, tk, tv;
  if (encode_tiled() == nullptr) return ERR_NO_ENCODER;
  if (!encode_map(&tq, q, D, S, H, B, qs, Tile::BM) ||
      !encode_map(&tk, k, D, T_len, Hk, B, ks, Tile::BK) ||
      !encode_map(&tv, v, D, T_len, Hk, B, vs, Tile::BK))
    return ERR_TENSOR_MAP;
  // The shared-memory attribute once a device (a runtime call, on the
  // host's path of every prefill otherwise).
  static bool smem_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !smem_set[dev]) {
    err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, SPLIT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) smem_set[dev] = true;
  }
  flash_fwd_wgmma_kernel<D, SPLIT><<<blocks, WG_THREADS, Tile::SMEM,
                                     stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, H, S, T_len, H / Hk, os,
      scale * LOG2E, causal);
  return cudaGetLastError();
}

bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

// The modes of the plan (kernels/flash_attention.py MODES).
enum Mode { MODE_FP32 = 0, MODE_MMA = 1, MODE_ROWS = 2, MODE_SPLIT = 3 };

struct Plan {
  int mode, block_m, block_n, stages, threads, smem, gx, gy, gz;
  bool is(int m, int bm, int bn, int st, int th, int sm, int x, int y,
          int z) const {
    return mode == m && block_m == bm && block_n == bn && stages == st &&
           threads == th && smem == sm && gx == x && gy == y && gz == z;
  }
};

// Whether `p` is the plan of the instance this entry point launches for
// (dtype, D, mode): the Python plan and these constants must agree.
template <int D>
bool plan_matches(const Plan& p, int is_bf16, int B, int H, int S) {
  const int fp32_smem = static_cast<int>(
      ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * sizeof(float));
  if (!is_bf16)
    return p.is(MODE_FP32, BQ, BK, 1, THREADS, fp32_smem, (S + BQ - 1) / BQ,
                H, B);
  if constexpr (D <= 32) {
    return p.is(MODE_MMA, MMA_BQ, MmaTile<D>::BK, 2, MMA_THREADS,
                MmaTile<D>::SMEM, H, B, (S + MMA_BQ - 1) / MMA_BQ);
  } else {
    // split: a block a work tile; rows: at most as many blocks as work
    // tiles (the plan gives one an SM)
    using R = WgTile<D, false>;
    using P = WgTile<D, true>;
    const int rows_work = B * H * ((S + R::BM - 1) / R::BM);
    return (p.is(MODE_ROWS, R::BM, R::BK, R::STAGES, WG_THREADS, R::SMEM,
                 p.gx, 1, 1) && p.gx >= 1 && p.gx <= rows_work) ||
           p.is(MODE_SPLIT, P::BM, P::BK, P::STAGES, WG_THREADS, P::SMEM,
                B * H * ((S + P::BM - 1) / P::BM), 1, 1);
  }
}

template <int D>
int dispatch(const Plan& p, int is_bf16, const void* q, const void* k,
             const void* v, void* o, int B, int H, int Hk, int S, int T_len,
             Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int causal, cudaStream_t st) {
  if (!plan_matches<D>(p, is_bf16, B, H, S)) return cudaErrorInvalidValue;
#define FLASH_ARGS q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, os, scale, \
                   causal, st
  if (!is_bf16) return launch<float, D>(FLASH_ARGS);
  if constexpr (D <= 32) {
    return launch_mma<D>(FLASH_ARGS);
  } else {
    if (p.mode == MODE_ROWS) return launch_wgmma<D, false>(p.gx, FLASH_ARGS);
    return launch_wgmma<D, true>(p.gx, FLASH_ARGS);
  }
#undef FLASH_ARGS
}

}  // namespace

// q [B, S, H, D], k/v [B, T, Hk, D], o [B, S, H, D], each addressed through
// its (batch, seq, head) strides in elements.  is_bf16: 1 for bfloat16 (q,
// k, v and every stride 16-byte aligned, else cudaErrorMisalignedAddress),
// 0 for float32.  The plan (mode 0 fp32, 1 mma.sync, 2 rows, 3 split; query
// rows and keys of a tile, stages, threads, dynamic shared memory, grid)
// is kernels/flash_attention.py's `_plan`; one that does not match the
// instance for (dtype, D, mode) is refused with cudaErrorInvalidValue.
// Returns a cudaError_t (0 on success), or ERR_NO_ENCODER /
// ERR_TENSOR_MAP (negative) when the bf16 wgmma body cannot build its
// tensor maps.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int Hk, int S, int T_len, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int mode,
    int block_m, int block_n, int stages, int threads, int smem, int gx,
    int gy, int gz, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || S <= 0 || T_len <= 0)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const Plan plan{mode, block_m, block_n, stages, threads, smem, gx, gy, gz};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16 &&
      (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs)))
    return cudaErrorMisalignedAddress;
#define FLASH_ARGS plan, is_bf16, q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, \
                   os, scale, causal, st
  switch (D) {
    case 16: return dispatch<16>(FLASH_ARGS);
    case 32: return dispatch<32>(FLASH_ARGS);
    case 64: return dispatch<64>(FLASH_ARGS);
    case 128: return dispatch<128>(FLASH_ARGS);
    case 256: return dispatch<256>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}
