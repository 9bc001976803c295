// Flash attention forward (causal or full, GQA) for NVIDIA Hopper, sm_90a.
//
// Replaces: src/repro/kernels/flash_attention.py:27 `_flash_kernel`
// (launched by `flash_attention` at :71, `pl.pallas_call` at :97).
//
// What bounds it on the card: at the shapes the model gives it
// (prefill, S = T = 128..512, D = 64) the work is ~4*S*T*D*H FLOPs against
// ~4*S*H*D*bytes of q, k, v, o, i.e. tens to a few hundred FLOPs per byte:
// on an H100 that is below the ~295 FLOP/byte ridge at short S and above it
// at long S.  This first version does its products on the CUDA cores in
// fp32 out of shared memory, so it is bounded by shared-memory traffic and
// FMA issue, far from either data-sheet bound; `wgmma` tiles, TMA loads and
// a pipelined KV ring are later work.
//
// Design.  The TPU kernel carries (m, l, acc) in VMEM scratch across a
// sequential KV grid axis.  Blocks on the card run in no order, so one
// block owns one (query tile, head, batch) and loops over KV tiles itself,
// with the running max, sum and accumulator in registers:
//   * BQ = 32 query rows per block, 4 threads per row (128 threads); each
//     thread holds 16 scores of a 64-key tile and D/4 output columns.
//   * q, k and v tiles are staged in shared memory as fp32, rows padded to
//     D+1 floats so that a column read by the 8 rows of a warp hits 8
//     different banks.  Softmax statistics are fp32, with the TPU kernel's
//     NEG_INF = -1e30 guards for masked entries and rows (:55-58) and the
//     flush dividing by max(l, 1e-30) (:67).
//   * Inputs are read through (batch, seq, head) strides with the last dim
//     contiguous, so the model's [B,S,H,D] layout is used as it is and
//     [B,H,S,D] is the same kernel with two strides swapped.
//   * GQA: query head h reads KV head h / G; KV is never replicated.
//   * Causal: positions start at 0 on both axes (the reference's iota
//     masks), and KV tiles wholly above the diagonal are not visited.
//   * Ragged S and T are masked, so nothing has to divide by the tiles.
// The wrapper (kernels/flash_attention.py) checks device, dtype, shapes and
// strides; this file launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 32;               // query rows per block
constexpr int BK = 64;               // keys per KV tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 128
constexpr float NEG_INF = -1e30f;

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
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      const int d = lane + TPR * i;
      float a = acc[i] * alpha;
#pragma unroll 16
      for (int c = 0; c < BK; ++c) a += sp[row * PP + c] * sv[c * DP + d];
      acc[i] = a;
    }
  }

  if (qpos < S) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* ob = o + b * os.b + h * os.h + qpos * os.s;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[lane + TPR * i] = from_f32<T>(acc[i] / denom);
  }
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

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int Hk, int S, int T_len,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, os,
                           scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, os,
                           scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, os,
                            scale, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, D], k/v [B, T, Hk, D], o [B, S, H, D], each addressed through
// its (batch, seq, head) strides in elements.  is_bf16: 1 for bfloat16,
// 0 for float32.  Returns a cudaError_t (0 on success).
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
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hk, S, T_len, qs,
                                     ks, vs, os, scale, causal, st);
  return dispatch_d<float>(D, q, k, v, o, B, H, Hk, S, T_len, qs, ks, vs, os,
                           scale, causal, st);
}
