// Flash attention forward (causal or full, GQA) for NVIDIA Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:27 `_flash_kernel`
// (launched by `flash_attention` at :71, `pl.pallas_call` at :97).
//
// Two bodies, chosen by dtype:
//   * bfloat16, the fast path: `flash_fwd_mma_kernel`, products on the
//     tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate).
//   * float32, the exactness path: `flash_fwd_kernel`, fp32 FMAs on the
//     CUDA cores.  A TF32 product would keep ~3 decimal digits, which the
//     2e-5 sweep tolerance and the 1e-4 card-vs-CPU logits check of the
//     fp32 model do not allow; this body is the older of the two, kept as
//     it was written.
//
// What bounds it on the card: at the shapes the model gives it (prefill,
// S = T = 128..512, 12 heads of 64, one sequence) the work is
// 4*H*D*S*(S+1)/2 causal FLOPs (0.1 GFLOP at S = 256, 0.1 us at the bf16
// peak) on 4*S*H*D*2 bytes (1.5 MB, 0.47 us at the HBM rate), so either
// bound is far below a microsecond and the kernel is bound by latency:
// the length of one block's serial path (its KV tiles, one after the
// other), and how few blocks there are to fill 132 SMs.  The fp32 body
// adds shared-memory traffic (every FMA is fed by two shared loads); in
// bf16 it took 71 us at S = 256 on an H100 80GB HBM3 at 700 W.
//
// The bf16 design against that:
//   * Products on the tensor cores.  QK^T and PV are mma.sync m16n8k16
//     with fp32 accumulation, operands loaded by ldmatrix (.trans for V);
//     a warp owns a 16-row slice of the query tile, one mma row block.
//     bf16 x bf16 products are exact in fp32, so QK^T computes what the
//     reference's fp32 dot computes, up to summation order.
//   * P stays in registers: the fp32 score fragment of QK^T is, after the
//     online softmax, rounded to bf16 and used as the A fragment of PV, as
//     the plain reference rounds the weights to v's dtype before PV
//     (kernels/ref.py: `w.to(v.dtype)`).  The row sum l takes fp32 p.
//   * Q is read once (cp.async) and its fragments stay in registers for the
//     whole KV loop.  K and V come in by 16-byte cp.async into a ring of
//     two stages, so stage j+1 loads while stage j computes; the ragged
//     edge is zero-filled (src-size 0), never read.  Shared rows are padded
//     by 16 bytes (D + 8 elements), so the 8 rows an ldmatrix reads start
//     4 banks apart and hit 32 different banks.
//   * A shorter serial path.  A block owns 64 query rows with 8 warps in
//     two groups: a ring stage holds two 64-key tiles, one for each group,
//     so each group walks half of the block's KV tiles, and at the end
//     group 1 hands its (m, l, acc) through shared memory to group 0,
//     which merges them as the online softmax merges two tiles.  With one
//     group of 4 warps, S = 256 took 15.1 us on the same card and each KV
//     tile on the critical path cost ~3 us: one warp per scheduler exposes
//     every mma, shuffle and exp latency.  Two groups took 10.8 us.
//   * Grid (H, B, ceil(S / 64)), the query tile taken from the last z index
//     first, so the heaviest causal tiles are dispatched first.  At S = 256
//     that is 48 blocks on 132 SMs; 32-row tiles would give 96, but each
//     would walk the same KV tiles in series and load K/V twice as often.
//   * A warp whose 16 rows all lie before a tile's first key (causal), or
//     past S, skips that tile's products, and only tiles that cross the
//     diagonal or the ragged end of T compute a mask.
//   * Every pointer and (batch, seq, head) stride must be 16-byte aligned
//     for cp.async; the wrapper raises otherwise, and the entry point
//     returns cudaErrorMisalignedAddress rather than take another body.
//
// Both bodies keep the TPU kernel's arithmetic: s = (q.k) * scale with the
// scale applied to the fp32 product (:42-43); the online softmax with fp32
// running max, sum and accumulator; NEG_INF = -1e30 masks, the guard for
// fully masked rows (safe_m, alpha) and the flush dividing by
// max(l, 1e-30) (:55-67); causal positions from 0 on both axes (the
// reference's iota masks), KV tiles wholly above the diagonal not visited;
// GQA by h / G with KV never replicated; ragged S and T masked; inputs
// read through (batch, seq, head) strides with the last dim contiguous, so
// [B,S,H,D] views of one qkv buffer are read in place and [B,H,S,D] is the
// same kernel with two strides swapped.
//
// Head dims: D is 16, 32, 64, 128 or 256, the head dims of the configs
// the port serves: 16 for every reduced config, 64 (llsc-100m,
// granite-moe-1b-a400m), 128 (jamba) and 256 (gemma3-1b's global
// layers).  Each is a multiple of 16, one k-step of mma.m16n8k16; any
// other D is refused (cudaErrorInvalidValue) and the wrapper raises before
// the launch.  D = 32 is the test sweep's.
//
// D = 256 in bf16 takes its own tiling (`MmaTile`).  The tiling of the
// smaller D would ask for (64 + 4 * 128) * 264 * 2 = 304,128 bytes of
// shared memory, past a block's 232,448, and each thread would hold Q's
// fragments (64 registers) and the output (128) before the scores.  So at
// D = 256 a KV tile is 32 keys (a ring stage 64: 168,960 bytes), and Q's
// fragments are not held: each key tile reloads them from shared memory
// with ldmatrix, 16 x4 loads a warp.  The output stays in registers.
// D = 16 keeps the common tiling: its padded row of 24 elements (48 bytes)
// still starts the 8 rows of an ldmatrix matrix at bytes 0, 48, 96, 16,
// 64, 112, 32, 80 modulo 128, 32 different banks.
//
// Registers and spills (ptxas -v for sm_90a, CUDA 12.8, as phase 2 of
// chip_smoke.py prints them): the bf16 body 111 / 127 / 157 / 222 / 240
// registers at D = 16 / 32 / 64 / 128 / 256 (8 warps a block, so 256
// threads x 240 registers fit the SM's 65,536); the fp32 body 48 / 72 /
// 72 / 96 / 128; no spills in either.  The fp32 body's PV product runs
// key by key, each weight read once into a register: column by column
// (each column's sum over the keys in turn) it spills at D = 32 and 128.
//
// The fp32 body: one block per (32-row query tile, head, batch), 4
// threads per row, q, k, v staged in shared memory as fp32 rows padded to
// D+1 floats; each thread holds 16 scores of a 64-key tile and D/4 output
// columns.
//
// The wrapper (kernels/flash_attention.py) checks device, dtype, shapes,
// strides and alignment; this file launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int BQ = 32;               // fp32 body: query rows per block
constexpr int BK = 64;               // keys per KV tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 128
constexpr float NEG_INF = -1e30f;

constexpr int MMA_BQ = 64;           // bf16 body: query rows per block
constexpr int MMA_SLICES = MMA_BQ / 16;       // 16-row slices, one a warp
constexpr int MMA_SPLIT = 2;         // warp groups sharing out the KV tiles
constexpr int MMA_THREADS = MMA_SLICES * MMA_SPLIT * 32;  // 256

// The bf16 body's tiling by head dim (see the note at the top): keys per
// KV tile, whether Q's fragments stay in registers for the whole KV loop,
// and the dynamic shared memory (Q tile and a ring of two stages of K and
// V, rows padded to D + 8).
template <int D>
struct MmaTile {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr int SUPER = MMA_SPLIT * BK;  // keys of one ring stage
  static constexpr int SMEM = (MMA_BQ + 4 * SUPER) * (D + 8) * 2;
  static_assert(D % 16 == 0, "D is a whole number of mma k-steps");
  static_assert(SMEM <= 232448, "past a block's shared memory");
  // the groups' merge reuses the ring: (SPLIT - 1) x SLICES x 32 lanes x
  // (acc, m, l) floats
  static_assert((MMA_SPLIT - 1) * MMA_SLICES * 32 * (D / 2 + 4) * 4 <=
                    4 * SUPER * (D + 8) * 2,
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

// The bf16 body (see the note at the top).  Block (h, b, z) owns query
// rows [q0, q0 + 64) of head h.  Warp w works on the 16 rows of slice
// w % 4 with the KV tiles of group w / 4: ring stage j holds tiles 2j and
// 2j + 1, one for each group.  Group 1 hands its (m, l, acc) to group 0,
// which merges them and writes the output.
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
  // Q's A fragments: all D / 16 of them held, or one reloaded a k-step
  unsigned qf[Tile::Q_IN_REGS ? D / 16 : 1][4];
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
    if constexpr (Tile::Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          mma::ldmatrix_x4(qf[kk], q_frag + kk * 16);
      }
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
      const int qk = Tile::Q_IN_REGS ? kk : 0;
      if constexpr (!Tile::Q_IN_REGS)
        mma::ldmatrix_x4(qf[0], q_frag + kk * 16);
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        unsigned kf[4];              // b0, b1 of key tiles n and n + 1
        mma::ldmatrix_x4(kf, tk + (n * 8 + lane % 8 + (lane / 16) * 8) * SROW
                                 + kk * 16 + ((lane / 8) % 2) * 8);
        mma::mma_bf16_16816(s[n], qf[qk], kf[0], kf[1]);
        mma::mma_bf16_16816(s[n + 1], qf[qk], kf[2], kf[3]);
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

bool aligned16(const void* p, const Strides& st) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 &&
         st.s % 8 == 0 && st.h % 8 == 0;
}

}  // namespace

// q [B, S, H, D], k/v [B, T, Hk, D], o [B, S, H, D], each addressed through
// its (batch, seq, head) strides in elements.  is_bf16: 1 for bfloat16 (the
// tensor-core body; q, k, v and every stride 16-byte aligned, else
// cudaErrorMisalignedAddress), 0 for float32.  Returns a cudaError_t (0 on
// success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int H, int Hk, int S, int T_len, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || S <= 0 || T_len <= 0)
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, os, scale, \
                   causal, st
  if (is_bf16) {
    if (!aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs))
      return cudaErrorMisalignedAddress;
    switch (D) {
      case 16: return launch_mma<16>(FLASH_ARGS);
      case 32: return launch_mma<32>(FLASH_ARGS);
      case 64: return launch_mma<64>(FLASH_ARGS);
      case 128: return launch_mma<128>(FLASH_ARGS);
      case 256: return launch_mma<256>(FLASH_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16: return launch<float, 16>(FLASH_ARGS);
    case 32: return launch<float, 32>(FLASH_ARGS);
    case 64: return launch<float, 64>(FLASH_ARGS);
    case 128: return launch<float, 128>(FLASH_ARGS);
    case 256: return launch<float, 256>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}
