// The launch plan of the SSD intra-chunk kernel (ssd.cu): which of its
// three bodies a call takes, with what dynamic shared memory and grid,
// from the shape, the alignment of x, B, C and the card's limits alone.
// Plain C++ with no CUDA header, so that it also builds for the host by
// itself (the CPU tests do: g++ -x c++ -shared).  It is included once per
// library: it defines the query entry `ssd_intra_chunk_plan`.
//
// The rule:
//   * bf16 x, B, C, 16-byte aligned (`aligned16`), head dim 64, state 16
//     or 128, chunks up to 256: the Hopper body, one block an SM up to its
//     work items (pairs of 64-row query tiles of one (chunk, head));
//   * other aligned bf16 whose shared memory fits the card's opt-in: the
//     mma.sync body, 2 heads a block where the heads of a group pair up,
//     else 1;
//   * anything else: the CUDA-core body.
#ifndef REPRO_TORCH_SSD_PLAN_H
#define REPRO_TORCH_SSD_PLAN_H

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define SSD_HD __host__ __device__ __forceinline__
#else
#define SSD_HD inline
#endif

namespace {

// The CUDA-core body.
constexpr int TQ = 32;        // query rows a block owns
constexpr int TK = 32;        // key rows per tile; == TQ, so tile kt == qt
                              // is the diagonal one
constexpr int MAX_P = 128;
constexpr int MAX_N = 256;
constexpr int W_STRIDE = TK + 4;   // W row stride, keeps float4 alignment

struct Strides {              // elements between chunks, rows, heads/groups
  long long chunk, row, head;
};

SSD_HD int round4(int v) { return (v + 3) & ~3; }

// floats of dynamic shared memory: cs, C tile, B tile, x*dt tile, W
SSD_HD size_t smem_floats(int l, int n, int p) {
  const int n4 = round4(n);
  return static_cast<size_t>(round4(l)) + TQ * n4 + TK * (n4 + 4) + TK * p
         + TQ * W_STRIDE;
}

// The mma.sync body.
constexpr int M_TQ = 64;               // query rows a block owns
constexpr int M_TK = 64;               // keys a tile; == M_TQ
constexpr int M_GROUPS = 2;            // warp groups sharing out the tiles
constexpr int BF16_BYTES = 2;

SSD_HD int round16(int v) { return (v + 15) & ~15; }

struct MmaSmem {                        // byte offsets of the bf16 body
  int c_stride, ring_stride, kt_max;    // (elements, elements, tiles)
  size_t ring, frag, cs, dt, total;
};

template <int PMAX>
SSD_HD MmaSmem mma_smem(int l, int n, int hb) {
  MmaSmem m;
  m.c_stride = round16(n) + 8;         // padded by 16 bytes
  m.ring_stride = m.c_stride > PMAX + 8 ? m.c_stride : PMAX + 8;
  m.kt_max = (l + M_TK - 1) / M_TK;
  m.ring = BF16_BYTES * M_TQ * m.c_stride;
  m.frag = m.ring + BF16_BYTES * 2 * M_GROUPS * M_TK * m.ring_stride;
  m.cs = m.frag + sizeof(float) * M_TQ * M_TK * m.kt_max;
  m.dt = m.cs + sizeof(float) * hb * M_TK * m.kt_max;
  m.total = m.dt + sizeof(float) * hb * M_TK * m.kt_max;
  return m;
}

inline size_t mma_smem_p(int l, int n, int p, int hb) {
  if (p <= 16) return mma_smem<16>(l, n, hb).total;
  if (p <= 32) return mma_smem<32>(l, n, hb).total;
  if (p <= 64) return mma_smem<64>(l, n, hb).total;
  return mma_smem<128>(l, n, hb).total;
}

// The Hopper body.  Shared memory, 1024-byte aligned: the C tiles of two
// items (the item in work and the next), the ring of B and x tiles, two
// 64 x 64 fp32 buffers (consumer 0's sums, then y's staging), the dt and
// cs of two items, the barriers.
constexpr int WG_TILE = 64;            // query rows and keys of a tile
constexpr int WG_P = 64;               // the head dim it takes
constexpr int WG_MAX_L = 256;          // the longest chunk it takes
constexpr int WG_STAGES = 4;           // ring stages, two for each consumer

template <int NS>
struct WgSsd {
  static_assert(NS == 16 || NS % 64 == 0, "state 16 or whole 128-byte rows");
  static constexpr bool SW128 = NS % 64 == 0;  // else 32-byte rows, SW32
  static constexpr int BOX = SW128 ? 64 : NS;  // columns of a TMA box
  static constexpr int NCB = NS / BOX;         // boxes of a B or C tile
  static constexpr int BC_BYTES = WG_TILE * NS * 2;  // a B or C tile
  static constexpr int X_BYTES = WG_TILE * WG_P * 2;
  static constexpr int STAGE = (BC_BYTES + X_BYTES + 1023) / 1024 * 1024;
  static constexpr int RING_AT = 4 * BC_BYTES;       // after [2 items][2]
  static constexpr int MERGE_AT = RING_AT + WG_STAGES * STAGE;
  static constexpr int CS_AT = MERGE_AT + 2 * WG_TILE * WG_P * 4;
  static constexpr int DT_AT = CS_AT + 2 * WG_MAX_L * 4;
  static constexpr int BAR_AT = DT_AT + 2 * WG_MAX_L * 4;
  static constexpr int SMEM = 1024 + BAR_AT + 8 * (8 + 2 * WG_STAGES);
  static_assert(RING_AT % 1024 == 0 && BC_BYTES % 1024 == 0,
                "swizzled tiles start 1024-byte aligned");
  static_assert(SMEM <= 232448, "past a block's shared memory");
};

// Whether the bf16 bodies may read a [N, l, heads, width] operand: a
// 16-byte aligned base pointer, strides and rows (width a multiple of 8
// elements) for TMA and cp.async.
inline bool aligned16(const void* ptr, const Strides& st, int width) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0 && width % 8 == 0 &&
         st.chunk % 8 == 0 && st.row % 8 == 0 && st.head % 8 == 0;
}

// Whether the kernel takes the shape at all.
inline bool shape_ok(int N, int l, int h, int p, int g, int n) {
  return N > 0 && l > 0 && h > 0 && p > 0 && p <= MAX_P && g > 0 &&
         h % g == 0 && n > 0 && n <= MAX_N && N <= 65535 && h <= 65535;
}

// The bodies, by their numbers (kernels/ssd.py BODIES).
enum Body { BODY_FP32 = 0, BODY_MMA = 1, BODY_WGMMA = 2 };

// One launch: the body, its dynamic shared memory in bytes, its grid and
// the heads a block of a tensor-core body owns (1 for the Hopper body's
// work items, 0 for the CUDA-core body).
struct Plan {
  int body, smem, grid_x, grid_y, grid_z, heads_per_block;
};

// tc: bf16 x, B, C, each `aligned16`.  sms and smem_optin: the card's
// streaming multiprocessors and opt-in shared memory a block.
inline Plan plan_of(bool tc, int N, int l, int h, int p, int g, int n,
                    int sms, int smem_optin) {
  if (tc && p == WG_P && (n == 16 || n == 128) && l <= WG_MAX_L) {
    const int items = ((l + WG_TILE - 1) / WG_TILE + 1) / 2 * N * h;
    return {BODY_WGMMA, n == 16 ? WgSsd<16>::SMEM : WgSsd<128>::SMEM,
            items < sms ? items : sms, 1, 1, 1};
  }
  const int hb = (h / g) % M_GROUPS ? 1 : M_GROUPS;
  const size_t mma = mma_smem_p(l, n, p, hb);
  if (tc && mma <= static_cast<size_t>(smem_optin))
    return {BODY_MMA, static_cast<int>(mma), (l + M_TQ - 1) / M_TQ, h / hb,
            N, hb};
  return {BODY_FP32, static_cast<int>(sizeof(float) * smem_floats(l, n, p)),
          (l + TQ - 1) / TQ, h, N, 0};
}

inline void write_plan(const Plan& pl, int* out) {
  const int v[6] = {pl.body,   pl.smem,   pl.grid_x,
                    pl.grid_y, pl.grid_z, pl.heads_per_block};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

}  // namespace

// The plan of a call (body, smem, grid x, y, z, heads a block into
// plan[0..5]) of x_bf16 (1: bf16 x, B, C) inputs whose base pointers and
// strides are 16-byte aligned where `aligned` is 1 (the rows' widths p and
// n are the shape's), on a card of `sms` SMs and `smem_optin` bytes of
// opt-in shared memory a block: what `ssd_intra_chunk_fwd` launches for
// such inputs.  Returns 0, or 1 (cudaErrorInvalidValue) for a shape the
// kernel does not take.
extern "C" int ssd_intra_chunk_plan(int x_bf16, int aligned, int N, int l,
                                    int h, int p, int g, int n, int sms,
                                    int smem_optin, int* plan) {
  if (!shape_ok(N, l, h, p, g, n) || sms <= 0 || smem_optin <= 0) return 1;
  const bool tc = x_bf16 && aligned && p % 8 == 0 && n % 8 == 0;
  write_plan(plan_of(tc, N, l, h, p, g, n, sms, smem_optin), plan);
  return 0;
}

#endif  // REPRO_TORCH_SSD_PLAN_H
