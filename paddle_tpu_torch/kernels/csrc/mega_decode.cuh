// Persistent decode megakernel for Hopper (sm_90a): one launch runs one
// decode step through every layer of a Llama model.
//
// Replaces the TPU kernel paddle_tpu/kernels/mega_decode.py `_mega_kernel`
// (pallas_call :645): its single-step form (launched by
// `mega_decode_step`), its int8 weight and pool branches, and its
// multi-step form (`mega_decode_loop`).
//
// Per layer l, for the N rows (decode slots) of x [N, h]:
//   1. hn = RMSNorm(x) (f32 statistics, rounded to the model dtype, then
//      times the norm weight); q, k, v = hn @ wq, wk, wv;
//   2. per (slot, kv head): rotate-half RoPE of q and k at lens[n] (f32
//      angles, cos/sin rounded to the model dtype); the fresh k and v rows
//      written into the in-call ring at step t; the true-length walk over
//      the slot's pool prefix (walk_lens[n] positions, block table read on
//      the device: ragged_walk.cuh, shared with B4) as online-softmax
//      partials, then the flash-decoding combine with the ring positions
//      j <= t; the attention output rounded to the model dtype;
//   3. x += att @ wo;
//   4. hn = RMSNorm(x); gu = SiLU(hn @ w_gate) * (hn @ w_up);
//   5. x += gu @ w_down.
// Products accumulate in f32 and round to the model dtype where the
// plain PyTorch version (`decode_layers`, the ragged path's math) rounds.
//
// What bounds it on the H100: HBM bytes. At N <= 8 rows every weight
// element feeds at most 2*N operations, far below the ~295 operations a
// byte at which the tensor cores would be the limit, so the floor is the
// layer weights (14 GB for Llama-3-8B) plus the KV walk over 3.35 TB/s.
// This design keeps the weight stream running for the whole launch:
//
//   - A persistent cooperative grid of one block an SM, warp-specialised:
//     warp 8 is the producer, whose one thread streams weight tiles by TMA
//     into a ring of 16 KB stages in shared memory (9 stages for bf16 at
//     D = 128; full and empty mbarriers), and warps 0-7 (two warpgroups)
//     are the consumers that compute.
//   - Every weight is fixed for the kernel's life, so each block's list of
//     work — (step, layer, phase, column tile, k-range), with the head's
//     tiles after the last layer of each step in the multi-step form — is
//     a static schedule of shapes and grid size alone (`Sched`). The
//     producer walks it ahead of the consumers across phase and layer
//     boundaries: while the consumers wait at a grid barrier, stage their
//     inputs or run attention, the ring fills with the next phase's tiles.
//   - A stage is 4 boxes of 128-byte rows, 32 rows deep (64 bf16, 128
//     int8 or 32 f32 columns a box), read through 3-D tensor maps of the
//     stacked [L, K, M] weights; gate/up's stage holds two boxes of each;
//     the tied head's is two boxes of 64 vocabulary rows of embed [V, h],
//     read K-major. Columns past a matrix are TMA's zero fill (a partial
//     box) or not loaded (a box wholly past it).
//   - Each phase's units (one stage each) split evenly over the blocks: a
//     block takes the contiguous units [b U / G, (b + 1) U / G) of the
//     phase's tiles laid end to end, so a tile's rows may be split over a
//     few blocks (k-ranges). The block holding a tile's first units
//     finishes it: the others leave their f32 sums in a scratch slot and
//     release a flag; it adds the sums in block order (no float atomics:
//     two launches give the same bits) and applies the epilogue.
//   - Products, bf16 weights: out^T = W^T x^T on wgmma (m64n8k16): the
//     weight box is the M-major A operand from shared memory, the input
//     rows, staged with the norm applied and padded to 8, the K-major B
//     operand. int8 weights: the box is loaded with ldmatrix.trans,
//     widened exactly in registers (hopper.cuh `widen2`) and fed to wgmma
//     as its register A operand. An int8 column's bf16 scale multiplies
//     its complete f32 sum, after the ordered combine of its k-ranges.
//     The f32 forms (the checks' high-precision leg) compute the same
//     stages on the CUDA cores.
//   - The grid barrier is among consumers only (a producer blocked on an
//     empty stage would deadlock cooperative groups' grid.sync): an
//     arrival counter in device memory, added to with release and read
//     with acquire, and a named barrier of the 256 consumer threads. The
//     cooperative launch stays: it is what guarantees that every block is
//     resident. What another block wrote before a barrier is read past L1
//     (ld.global.cg).
//   - Attention: the walk stays on ragged_walk.cuh (B4's, with the
//     consumers' barrier and four 32-position stages, three in flight,
//     where B4 keeps one 64-position tile ahead); each step's RoPE
//     cos/sin are computed once a block; the ring combine reads ring rows
//     with coalesced 16-byte loads. Each (slot, kv head)'s walk splits into parts, more for a
//     longer slot, so the phase fills the grid and its longest item is as
//     short as it can be; the parts meet in a fixed order.
//
// int8 pools take B4's int8 walk; the in-call ring stays in the model
// dtype. The weights' type is a template parameter, the pools' a runtime
// branch; the forms build in parallel, one translation unit each
// (mega_decode_<dtype>[_w8].cu, mega_decode_multi_<dtype>[_w8].cu).
//
// The multi-step form (kMulti: the speculative draft's k greedy steps in
// one launch): step s writes ring row t = s, and RoPE reads the rows'
// lengths, which the kernel advances, past L1. After the last layer of a
// step: (E1) the final RMSNorm, applied while the head's input rows are
// staged; (E2) the head product (dense, int8 with bf16 column scales, or
// tied to embed), whose tiles' finishing blocks keep a running (max,
// first index) a row over the logits rounded to the model dtype, written
// to scratch; (E3) after a grid barrier, block n reduces row n's picks
// (larger logit, then lower index: the TPU kernel's `tmax > best` over
// ascending tiles), updates last/lens/done/budget as the TPU kernel does,
// writes the step's emitted token (-1 where the row is inactive or done)
// and gathers embed[last] into x; (E4) a grid barrier, then the next
// step.
#pragma once

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "ragged_walk.cuh"

namespace ptt {
namespace mega {

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;     // and the producer warp
constexpr int kStageBytes = 16384;            // a stage of the weight ring
constexpr int kMaxStages = 16;
constexpr int kRows = 32;            // reduction rows of an M-major stage
constexpr int kXsRows = 2048;        // input rows staged at once
constexpr int kSlots = 512;          // output columns of a tile, at most
constexpr int kMaxParts = 8;         // parts one (slot, kv head) walk takes
constexpr int kWalkTile = 32;        // positions of a walk stage
constexpr int kWalkStages = 4;       // the walk's stages (three in flight)
constexpr int kMiscBytes = 5632;
constexpr int kMaxBlocks = 160;      // blocks of the grid, at most
// `count`: [0] the grid barrier's arrivals; from kFlags one flag a block
// (its split sums are written); from kSsq the rows' sums of squares over
// each residual tile, f32 [2 (wo, w_down)][kMaxTiles][8]; from kWalkFlags
// one flag a walk part (n, hk, p)
constexpr int kFlags = 16;
constexpr int kMaxTiles = 512;       // residual tiles a phase, at most
constexpr int kSsq = kFlags + kMaxBlocks;
constexpr int kWalkFlags = kSsq + 2 * kMaxTiles * 8;
constexpr int kAlign = 1024;         // a 128-byte swizzle atom
constexpr int kSmemLimit = 232448;   // shared memory a block may use
constexpr int kBar = 1;              // the consumers' named barrier

// the phases a build runs (tools/mega_decode_phases.py empties one at a
// time: the producer and the consumers then both skip its tiles)
constexpr bool kRunQkv = true;
constexpr bool kRunAttention = true;
constexpr bool kRunWo = true;
constexpr bool kRunGateUp = true;
constexpr bool kRunDown = true;

// tools/mega_decode_trace.py builds a copy with kTrace = true: consumer
// thread 0 of every block then records clock64() marks and the cycles
// of each phase's parts for layer kTraceLayer of the first step (and the
// first step's head) into `count` from int kTraceOffset on, kTraceSlots
// 64-bit slots a block. Off, it compiles to nothing.
constexpr bool kTrace = false;
constexpr int kTraceLayer = 1;
constexpr int kTraceOffset = 1 << 16;
constexpr int kTraceSlots = 64;
// The slots of a block. Marks: the clock at the layer's 13 boundaries in
// the order it passes them (slot 0 its start, 12 its end), then the
// wave's head: kTrHead before it, + 1 after it, + 2 after the commit.
// Cycles: from kTrParts + 4 * phase (Phase order) a phase's staging,
// stages, settle and epilogue; from kTrAttention attention's RoPE, walk,
// merge and ring combine; from kTrSettle the contributor's write, the
// finisher's wait and its combine. The tool reads these constants from
// this file.
constexpr int kTrHead = 13;
constexpr int kTrParts = 16;
constexpr int kTrAttention = 40;
constexpr int kTrSettle = 44;

struct Args {
  const void* attn_norm;   // [L, h]
  const void* mlp_norm;    // [L, h]
  const void* wq;          // [L, h, Hq*D]
  const void* wk;          // [L, h, Hkv*D]
  const void* wv;          // [L, h, Hkv*D]
  const void* wo;          // [L, Hq*D, h]
  const void* w_gate;      // [L, h, F]
  const void* w_up;        // [L, h, F]
  const void* w_down;      // [L, F, h]
  const float* freq;       // [D/2] RoPE inverse frequencies
  const int* table;        // [N, MB]
  const int* walk_lens;    // [N]
  const int* lens;         // [N]
  const void* k_pool;      // [L, NB, BS, Hkv, D] (model dtype, or int8)
  const void* v_pool;
  const float* ks_pool;    // [L, NB, BS, Hkv] f32 scales of int8 pools
  const float* vs_pool;
  const void* wscale[7];   // [L, M] bf16 scales of int8 wq .. w_down
  void* ring_k;            // [L, N, S, Hkv, D]
  void* ring_v;
  void* x;                 // [N, h], updated in place
  void* qkv;               // [N, (Hq + 2*Hkv)*D] scratch
  void* att;               // [N, Hq*D] scratch
  void* gu;                // [N, F] scratch
  float* part;             // split sums: [grid, kSlots, 8] and the walks'
  int* count;              // kWalkFlags + N * Hkv * kMaxParts, zeroed
  int L, N, h, F, Hkv, G, NB, BS, MB, S, t;
  float eps, scale;
  bool kv_int8;
  // the multi-step form (mega_decode_loop); unused by the single step
  const void* final_norm;  // [h]
  const void* embed;       // [V, h], the model dtype: gather and tied head
  const void* head;        // [h, V] dense (model dtype) or int8; or unused
  const void* head_scale;  // [V] bf16 column scales of an int8 head
  const int* active;       // [N] rows that decode (0: inactive)
  const int* eos;          // [N] end-of-sequence ids (-1: none)
  int* state;              // [4, N] last, lens, done, budget; lens = state + N
  int* emitted;            // [n_steps, N] greedy tokens, -1 where inactive
  float* hmax;             // [hcap, N] each block's best logit a row
  int* hidx;               // [hcap, N] and its first vocab index
  int head_mode, V, n_steps, hcap;
};

// head_mode of the multi-step form
enum HeadMode : int { kHeadDense = 0, kHeadTied = 1, kHeadInt8 = 2 };

// the weights' tensor maps: wq, wk, wv, wo, w_gate, w_up, w_down (3-D,
// [L, K, M]) and the multi-step form's head ([1, h, V], or embed
// [1, V, h] read K-major for a tied head)
struct Maps {
  CUtensorMap m[8];
};

// the kernel and its launch code: internal to each translation unit (a
// static grid size per instantiation must not be shared with another
// library loaded into the same process)
namespace {

using bf16 = __nv_bfloat16;

enum Phase : int { kQkv, kWo, kGu, kDown, kHead };
// how a phase's stages are read: the layers' weights (type W, M-major),
// a dense head (the model dtype), an int8 head, embed as a tied head
enum Mode : int { kModeW, kModeHeadT, kModeHead8, kModeTied };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// columns of a box's 128-byte row
template <typename E>
__host__ __device__ constexpr int box_cols() {
  return 128 / int(sizeof(E));
}

__device__ __forceinline__ void consumer_sync() {
  sm90::named_sync(kBar, kConsumers);
}

// the walk's barrier and threads inside this kernel: the consumers'
struct ConsumerSync {
  __device__ static void sync() { consumer_sync(); }
  __device__ static int threads() { return kConsumers; }
};

// loads of what the kernel itself wrote before a barrier: past L1
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const bf16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes (8 bf16 or 4 f32) as f32: past L1 (_cg) or read-only (_nc)
__device__ __forceinline__ void load16_cg(const bf16* p, float (&v)[8]) {
  unpack8(__ldcg(reinterpret_cast<const uint4*>(p)), v);
}
__device__ __forceinline__ void load16_cg(const float* p, float (&v)[4]) {
  const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load16_nc(const bf16* p, float (&v)[8]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), v);
}
__device__ __forceinline__ void load16_nc(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

// DC (2 or 4) consecutive elements of a ring row, past L1
template <int DC>
__device__ __forceinline__ void load_dc(const bf16* p, float (&v)[DC]) {
  if constexpr (DC == 4) {
    const uint2 u = __ldcg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
    const unsigned u = __ldcg(reinterpret_cast<const unsigned*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    v[0] = a.x;
    v[1] = a.y;
  }
}
template <int DC>
__device__ __forceinline__ void load_dc(const float* p, float (&v)[DC]) {
  if constexpr (DC == 4) {
    const float4 f = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
    const float2 f = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
}

// GPU-scope release and acquire: a flag stored with release makes the
// block's writes that a barrier ordered before it visible to a reader
// that loads the flag with acquire
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p),
               "r"(v)
               : "memory");
}

// until *p reaches v; a wait that never ends (a fault in the schedule)
// traps, so the launch fails instead of holding the card
__device__ __forceinline__ void wait_at_least(const int* p, int v) {
  unsigned tries = 0;
  while (ld_acquire(p) < v) {
    __nanosleep(32);
    if (++tries == (1u << 28)) __trap();
  }
}

// (v, i) beats (bv, bi) as a row's greedy pick: a larger logit, or the
// same logit at a lower vocab index (the first maximum wins)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The shared memory of one block: the weight ring, then a region the
// GEMV phases use for their staged input rows and a tile's sums and the
// attention phase for the walk's staging, then the small state.
template <typename T, int D, int NS>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, bf16>::value;
  static constexpr int kWalkT =
      walk::Layout<T, D, kWalkTile, kWalkStages>::kSmem;
  static constexpr int kWalk8 =
      walk::Layout<int8_t, D, kWalkTile, kWalkStages>::kSmem;
  static constexpr int kWalk = kWalkT > kWalk8 ? kWalkT : kWalk8;
  // bf16: 8 rows (N padded for wgmma's n = 8) in 128-byte swizzled
  // K-major atoms; f32: NS plain rows
  static constexpr int kXsBytes = kBf16 ? 8 * kXsRows * 2 : NS * kXsRows * 4;
  static constexpr int kGemv = kXsBytes + kSlots * 8 * 4;
  static constexpr int kUnion =
      ((kWalk > kGemv ? kWalk : kGemv) + 127) / 128 * 128;
  static constexpr int kFree =
      (kSmemLimit - kAlign - kUnion - kMiscBytes) / kStageBytes;
  static constexpr int kStages = kFree < kMaxStages ? kFree : kMaxStages;
  static constexpr int kBytes =
      kAlign + kStages * kStageBytes + kUnion + kMiscBytes;
  static_assert(kStages >= 2 && kBytes <= kSmemLimit, "shared memory");
};

struct Misc {
  uint64_t full[kMaxStages];
  uint64_t empty[kMaxStages];
  float rn[8];                 // the rows' RMSNorm factors
  float bestv[8];              // the head: this block's best logit a row
  int besti[8];                //   and its vocab index
  int ids[kMaxBlocks];         // the split sums' contributors of a tile
  float red[kConsumerWarps * 8];   // the warps' sums of squares a row
  float rope_c[8 * 64];        // this step's RoPE cos/sin a row, rounded
  float rope_s[8 * 64];
};
static_assert(sizeof(Misc) <= kMiscBytes, "misc");

// input row n, elements k .. k + 16 bytes of a GEMV: RMSNorm(x) as the
// plain version rounds it, or a scratch row as it is
template <typename T>
struct NormIn {
  static constexpr int kV = 16 / int(sizeof(T));
  const T* x;
  const T* w;
  const float* rn;
  int h;
  __device__ void load(int n, int k, float (&v)[kV]) const {
    float xv[kV], wv[kV];
    load16_cg(x + int64_t(n) * h + k, xv);
    load16_nc(w + k, wv);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const float y = round_to<T>(__fmul_rn(xv[i], rn[n]));
      v[i] = round_to<T>(__fmul_rn(y, wv[i]));
    }
  }
};
template <typename T>
struct RawIn {
  static constexpr int kV = 16 / int(sizeof(T));
  const T* src;
  int ld;
  __device__ void load(int n, int k, float (&v)[kV]) const {
    load16_cg(src + int64_t(n) * ld + k, v);
  }
};

// One phase's static schedule: ntiles tiles of tw output columns, each
// upt units of `depth` reduction rows (one ring stage a unit), U units in
// all; block b of nb takes units [lo(b, nb), lo(b + 1, nb)).
struct Sched {
  int kind, mode, K, depth, tw, upt, ntiles, tq, tk;
  long long U;
  __host__ __device__ long long lo(int b, int nb) const {
    return (long long)b * U / nb;
  }
  __device__ long long lo(int b) const { return lo(b, int(gridDim.x)); }
  // the block whose units hold unit u
  __device__ int block_of(long long u) const {
    return int(((u + 1) * (long long)gridDim.x + U - 1) / U) - 1;
  }
  // a tile's output slots: its 4 boxes' columns (2 of the tied head)
  __device__ int slots() const { return kind == kGu ? 2 * tw : tw; }
};

// A phase's schedule from the shapes alone (T the model dtype, W the
// weights'): the producer and the consumers of every block compute it
// alike, and ptt_mega_decode_schedule reports it to the host
template <typename T, typename W>
__host__ __device__ Sched make_sched(int kind, const Args& a, int D) {
  Sched p;
  p.kind = kind;
  p.mode = kModeW;
  p.depth = kRows;
  p.tq = p.tk = 0;
  const int bw = box_cols<W>();
  const int Mq = a.Hkv * a.G * D, Mkv = a.Hkv * D;
  if (kind == kQkv) {
    p.K = a.h;
    p.tw = 4 * bw;
    p.tq = cdiv(Mq, p.tw);
    p.tk = cdiv(Mkv, p.tw);
    p.ntiles = kRunQkv ? p.tq + 2 * p.tk : 0;
  } else if (kind == kWo) {
    p.K = Mq;
    p.tw = 4 * bw;
    p.ntiles = kRunWo ? cdiv(a.h, p.tw) : 0;
  } else if (kind == kGu) {
    p.K = a.h;
    p.tw = 2 * bw;
    p.ntiles = kRunGateUp ? cdiv(a.F, p.tw) : 0;
  } else if (kind == kDown) {
    p.K = a.F;
    p.tw = 4 * bw;
    p.ntiles = kRunDown ? cdiv(a.h, p.tw) : 0;
  } else {
    p.K = a.h;
    if (a.head_mode == kHeadTied) {
      p.mode = kModeTied;
      p.depth = box_cols<T>();
      p.tw = 128;
    } else if (a.head_mode == kHeadInt8) {
      p.mode = kModeHead8;
      p.tw = 4 * box_cols<int8_t>();
    } else {
      p.mode = kModeHeadT;
      p.tw = 4 * box_cols<T>();
    }
    p.ntiles = cdiv(a.V, p.tw);
  }
  p.upt = cdiv(p.K, p.depth);
  p.U = (long long)p.ntiles * p.upt;
  return p;
}

// the address of input row 0, element xrel of the staged bf16 rows (the
// K-major B operand: 64-element, 1024-byte swizzle atoms of 8 rows)
__device__ __forceinline__ uint32_t xs_addr(const unsigned char* xs,
                                            int xrel) {
  return sm90::smem_u32(xs) + (xrel >> 6) * 1024 + (xrel & 63) * 2;
}

// ---------------------------------------------------------------------------
// the products of one stage: a tile's sums for the N input rows, written
// to res [slot][8] by `store` (rows past N are zero)
// ---------------------------------------------------------------------------
template <typename T, typename E, bool kKMajor, int NS>
struct Mma;

// bf16 weights, M-major: warpgroup w takes boxes 2w and 2w + 1 (64 columns
// each) as wgmma's transposed A; the products of one stage stay in flight
// while the next stage's are issued
template <int NS>
struct Mma<bf16, bf16, false, NS> {
  static constexpr bool kAsync = true;
  float acc[2][4];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  __device__ void fence() {
    sm90::fence_acc(acc[0]);
    sm90::fence_acc(acc[1]);
  }
  __device__ void step(const unsigned char* st, const unsigned char* xs,
                       int xrel, int vmask, int) {
    const int wg = threadIdx.x >> 7;
    const uint32_t sa = sm90::smem_u32(st), xb = xs_addr(xs, xrel);
    fence();
    sm90::wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * wg + jj;
      if (vmask >> j & 1) {
#pragma unroll
        for (int kk = 0; kk < kRows / 16; ++kk)
          sm90::wgmma_n8<1, 0>(acc[jj],
                               sm90::desc(sa + j * 4096 + kk * 2048, 4096, 1024),
                               sm90::desc(xb + kk * 32, 16, 1024));
      }
    }
    sm90::wgmma_commit();
    fence();
  }
  __device__ void retire_one() {
    sm90::wgmma_wait<1>();
    fence();
  }
  __device__ void retire_all() {
    sm90::wgmma_wait<0>();
    fence();
  }
  // acc[jj][0..1]: column 64 j + 16 warp + g, rows 2q, 2q + 1; [2..3] the
  // column 8 further
  __device__ void store(float* res, int) {
    const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3;
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = (2 * wg + jj) * 64 + 16 * wl + g;
      *reinterpret_cast<float2*>(res + col * 8 + 2 * q) =
          make_float2(acc[jj][0], acc[jj][1]);
      *reinterpret_cast<float2*>(res + (col + 8) * 8 + 2 * q) =
          make_float2(acc[jj][2], acc[jj][3]);
    }
  }
};

// int8 weights, M-major: warpgroup w takes boxes 2w and 2w + 1 (128
// columns, two 64-column blocks each), loaded as they are stored with
// ldmatrix.trans and widened exactly in registers as wgmma's A (B9-int8's
// layout: A row r of a warp's 16 columns stands for column 2(r % 8) +
// r / 8). The stage is free once the fragments are in registers.
template <int NS>
struct Mma<bf16, int8_t, false, NS> {
  static constexpr bool kAsync = false;
  float acc[4][4];   // [2 jj + bb]
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }
  __device__ void fence() {
#pragma unroll
    for (int j = 0; j < 4; ++j) sm90::fence_acc(acc[j]);
  }
  __device__ void step(const unsigned char* st, const unsigned char* xs,
                       int xrel, int vmask, int) {
    const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, mi = lane >> 3;
    const int lrow = (mi & 1) * 8 + (lane & 7), chunk = 4 * (mi >> 1) + wl;
    const uint32_t sa = sm90::smem_u32(st), xb = xs_addr(xs, xrel);
    uint32_t f[kRows / 16][2][2][4];
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * wg + jj;
        if (vmask >> j & 1) {
          const int k = kk * 16 + lrow;
          uint32_t w[4];
          sm90::ldsm_x4_t(w, sa + j * 4096 + k * 128 + ((chunk ^ (k & 7)) << 4));
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            f[kk][jj][bb][0] = sm90::widen2<false>(w[2 * bb]);
            f[kk][jj][bb][1] = sm90::widen2<true>(w[2 * bb]);
            f[kk][jj][bb][2] = sm90::widen2<false>(w[2 * bb + 1]);
            f[kk][jj][bb][3] = sm90::widen2<true>(w[2 * bb + 1]);
          }
        }
      }
    fence();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (vmask >> (2 * wg + jj) & 1) {
#pragma unroll
          for (int bb = 0; bb < 2; ++bb)
            sm90::wgmma_ra_n8<0>(acc[2 * jj + bb], f[kk][jj][bb],
                                 sm90::desc(xb + kk * 32, 16, 1024));
        }
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence();
  }
  __device__ void retire_one() {}
  __device__ void retire_all() {}
  // acc[2 jj + bb][0..1]: column 128 j + 16 (4 bb + warp) + 2 g, rows 2q,
  // 2q + 1; [2..3] the next column
  __device__ void store(float* res, int) {
    const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3;
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int col = (2 * wg + jj) * 128 + (4 * bb + wl) * 16 + 2 * g;
        const float* d = acc[2 * jj + bb];
        *reinterpret_cast<float2*>(res + col * 8 + 2 * q) =
            make_float2(d[0], d[1]);
        *reinterpret_cast<float2*>(res + (col + 1) * 8 + 2 * q) =
            make_float2(d[2], d[3]);
      }
  }
};

// bf16 embed as the tied head, K-major: warpgroup w takes box w (64
// vocabulary rows, 64 elements of h) as wgmma's A
template <int NS>
struct Mma<bf16, bf16, true, NS> {
  static constexpr bool kAsync = true;
  float acc[4];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = 0.f;
  }
  __device__ void step(const unsigned char* st, const unsigned char* xs,
                       int xrel, int vmask, int) {
    const int wg = threadIdx.x >> 7;
    const uint32_t sa = sm90::smem_u32(st), xb = xs_addr(xs, xrel);
    sm90::fence_acc(acc);
    sm90::wgmma_fence();
    if (vmask >> wg & 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_n8<0, 0>(acc, sm90::desc(sa + wg * 8192 + kk * 32, 16, 1024),
                             sm90::desc(xb + kk * 32, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::fence_acc(acc);
  }
  __device__ void retire_one() {
    sm90::wgmma_wait<1>();
    sm90::fence_acc(acc);
  }
  __device__ void retire_all() {
    sm90::wgmma_wait<0>();
    sm90::fence_acc(acc);
  }
  __device__ void store(float* res, int) {
    const int wg = threadIdx.x >> 7, wl = (threadIdx.x >> 5) & 3;
    const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
    const int row = wg * 64 + 16 * wl + g;
    *reinterpret_cast<float2*>(res + row * 8 + 2 * q) =
        make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(res + (row + 8) * 8 + 2 * q) =
        make_float2(acc[2], acc[3]);
  }
};

// The f32 forms on the CUDA cores, the same stages: a thread holds one
// column (or vocabulary row) over half of a stage's reduction rows, and
// the two halves meet in res.
template <int NS>
__device__ __forceinline__ void store_halves(float* res, int col,
                                             const float (&acc)[NS]) {
  if (threadIdx.x >= 128)
#pragma unroll
    for (int n = 0; n < 8; ++n) res[col * 8 + n] = n < NS ? acc[n] : 0.f;
  consumer_sync();
  if (threadIdx.x < 128)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      res[col * 8 + n] = (n < NS ? acc[n] : 0.f) + res[col * 8 + n];
}

// f32 weights, M-major: 4 boxes of 32 columns
template <int NS>
struct Mma<float, float, false, NS> {
  static constexpr bool kAsync = false;
  float acc[NS];
  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < NS; ++n) acc[n] = 0.f;
  }
  __device__ void step(const unsigned char* st, const unsigned char* xs,
                       int xrel, int vmask, int N) {
    const int c = threadIdx.x & 127, j = c >> 5, cc = c & 31;
    const int r0 = (threadIdx.x >> 7) * 16;
    if (!(vmask >> j & 1)) return;
    const float* x = reinterpret_cast<const float*>(xs) + xrel + r0;
    const unsigned char* box = st + j * 4096;
#pragma unroll 4
    for (int r = 0; r < 16; ++r) {
      const int row = r0 + r;
      const float w = *reinterpret_cast<const float*>(
          box + row * 128 + (((cc >> 2) ^ (row & 7)) << 4) + (cc & 3) * 4);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n < N) acc[n] = fmaf(x[n * kXsRows + r], w, acc[n]);
    }
  }
  __device__ void retire_one() {}
  __device__ void retire_all() {}
  __device__ void store(float* res, int) {
    store_halves<NS>(res, threadIdx.x & 127, acc);
  }
};

// int8 weights for an f32 model: 4 boxes of 128 columns, two a thread
template <int NS>
struct Mma<float, int8_t, false, NS> {
  static constexpr bool kAsync = false;
  float acc[NS][2];
  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < NS; ++n) acc[n][0] = acc[n][1] = 0.f;
  }
  __device__ void step(const unsigned char* st, const unsigned char* xs,
                       int xrel, int vmask, int N) {
    const int j = threadIdx.x >> 6, cc = 2 * (threadIdx.x & 63);
    if (!(vmask >> j & 1)) return;
    const float* x = reinterpret_cast<const float*>(xs) + xrel;
    const unsigned char* box = st + j * 4096;
#pragma unroll 4
    for (int row = 0; row < kRows; ++row) {
      const unsigned short v = *reinterpret_cast<const unsigned short*>(
          box + row * 128 + (((cc >> 4) ^ (row & 7)) << 4) + (cc & 15));
      const float w0 = float(int8_t(v & 0xff)), w1 = float(int8_t(v >> 8));
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n < N) {
          const float xv = x[n * kXsRows + row];
          acc[n][0] = fmaf(xv, w0, acc[n][0]);
          acc[n][1] = fmaf(xv, w1, acc[n][1]);
        }
    }
  }
  __device__ void retire_one() {}
  __device__ void retire_all() {}
  __device__ void store(float* res, int) {
    const int col = (threadIdx.x >> 6) * 128 + 2 * (threadIdx.x & 63);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      res[col * 8 + n] = n < NS ? acc[n][0] : 0.f;
      res[(col + 1) * 8 + n] = n < NS ? acc[n][1] : 0.f;
    }
  }
};

// f32 embed as the tied head: 2 boxes of 64 vocabulary rows, 32 elements
// of h each
template <int NS>
struct Mma<float, float, true, NS> {
  static constexpr bool kAsync = false;
  float acc[NS];
  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < NS; ++n) acc[n] = 0.f;
  }
  __device__ void step(const unsigned char* st, const unsigned char* xs,
                       int xrel, int vmask, int N) {
    const int v = threadIdx.x & 127, j = v >> 6, rr = v & 63;
    const int k0 = (threadIdx.x >> 7) * 16;
    if (!(vmask >> j & 1)) return;
    const float* x = reinterpret_cast<const float*>(xs) + xrel + k0;
    const unsigned char* row = st + j * 8192 + rr * 128;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      const int k = k0 + 4 * kq;
      const float4 w = *reinterpret_cast<const float4*>(
          row + (((k >> 2) ^ (rr & 7)) << 4));
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n < N) {
          const float* xn = x + n * kXsRows + 4 * kq;
          acc[n] = fmaf(xn[0], w.x, acc[n]);
          acc[n] = fmaf(xn[1], w.y, acc[n]);
          acc[n] = fmaf(xn[2], w.z, acc[n]);
          acc[n] = fmaf(xn[3], w.w, acc[n]);
        }
    }
  }
  __device__ void retire_one() {}
  __device__ void retire_all() {}
  __device__ void store(float* res, int) {
    store_halves<NS>(res, threadIdx.x & 127, acc);
  }
};

// ---------------------------------------------------------------------------
// the kernel's per-block state and its phases
// ---------------------------------------------------------------------------
template <typename T, int D, int NS, typename W, bool kMulti>
struct Kern {
  using Lay = Smem<T, D, NS>;
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr bool kW8 = std::is_same<W, int8_t>::value;

  const Args& a;
  const Maps& maps;
  unsigned char* ring;   // Lay::kStages stages
  unsigned char* uni;    // the staged input rows, or the walk's staging
  float* res;            // [kSlots][8]: a tile's f32 sums
  Misc* misc;
  int tid, warp, lane;
  int s = 0;             // the ring position (stage, parity)
  uint32_t ph = 0;
  unsigned target = 0;   // the grid barrier's arrivals to wait for
  long long* trace = nullptr;   // kTrace: this block's slots, while on
  int staged = -1;       // the full chunk in xs: its first row, or -1

  __device__ Kern(const Args& a_, const Maps& m_, unsigned char* base)
      : a(a_), maps(m_) {
    ring = base;
    uni = base + Lay::kStages * kStageBytes;
    res = reinterpret_cast<float*>(uni + Lay::kXsBytes);
    misc = reinterpret_cast<Misc*>(uni + Lay::kUnion);
    tid = threadIdx.x;
    warp = tid >> 5;
    lane = tid & 31;
  }

  // kTrace: mark slot `ev` with the clock, or add the cycles since t0
  __device__ void mark(int ev) {
    if constexpr (kTrace)
      if (tid == 0 && trace) trace[ev] = clock64();
  }
  __device__ void add(int ev, long long t0) {
    if constexpr (kTrace)
      if (tid == 0 && trace) trace[ev] += clock64() - t0;
  }
  __device__ long long now() const {
    if constexpr (kTrace) return clock64();
    return 0;
  }

  __device__ void advance() {
    if (++s == Lay::kStages) {
      s = 0;
      ph ^= 1;
    }
  }
  // a consumer warp is done with stage st
  __device__ void release(int st) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&misc->empty[st]);
  }

  // ---- the schedule (the producer and the consumers compute it alike)
  __device__ Sched sched(int kind) const {
    return make_sched<T, W>(kind, a, D);
  }
  __device__ bool has_items(const Sched& p) const {
    return p.lo(blockIdx.x) < p.lo(blockIdx.x + 1);
  }
  // qkv tile -> its matrix (0 wq, 1 wk, 2 wv), first column, width and
  // offset in the qkv scratch row
  __device__ void qkv_tile(const Sched& p, int tile, int& m, int& c0, int& M,
                           int& off) const {
    const int Mq = a.Hkv * a.G * D, Mkv = a.Hkv * D;
    if (tile < p.tq) {
      m = 0;
      c0 = tile * p.tw;
      M = Mq;
      off = 0;
    } else if (tile < p.tq + p.tk) {
      m = 1;
      c0 = (tile - p.tq) * p.tw;
      M = Mkv;
      off = Mq;
    } else {
      m = 2;
      c0 = (tile - p.tq - p.tk) * p.tw;
      M = Mkv;
      off = Mq + Mkv;
    }
  }
  // box j (< 4) of an M-major tile: its map, first column and the width of
  // its matrix (the box is loaded when col < lim)
  __device__ void tile_box(const Sched& p, int tile, int j, int& mat,
                           int& col, int& lim) const {
    const int bc = p.mode == kModeHeadT ? box_cols<T>()
                   : p.mode == kModeHead8 ? box_cols<int8_t>()
                                          : box_cols<W>();
    if (p.kind == kQkv) {
      int c0, off;
      qkv_tile(p, tile, mat, c0, lim, off);
      col = c0 + j * bc;
    } else if (p.kind == kGu) {
      mat = j < 2 ? 4 : 5;
      col = tile * p.tw + (j & 1) * bc;
      lim = a.F;
    } else if (p.kind == kHead) {
      mat = 7;
      col = tile * p.tw + j * bc;
      lim = a.V;
    } else {
      mat = p.kind == kWo ? 3 : 6;
      col = tile * p.tw + j * bc;
      lim = a.h;
    }
  }
  // the boxes of a tile that are loaded (bit j: box j)
  __device__ int box_mask(const Sched& p, int tile) const {
    int mask = 0;
    if (p.mode == kModeTied) {
      for (int j = 0; j < 2; ++j)
        if (tile * 128 + 64 * j < a.V) mask |= 1 << j;
      return mask;
    }
    for (int j = 0; j < 4; ++j) {
      int mat, col, lim;
      tile_box(p, tile, j, mat, col, lim);
      if (col < lim) mask |= 1 << j;
    }
    return mask;
  }

  // ---- the producer: one thread issues every load of the launch, a
  // tile's boxes worked out once for all its units
  __device__ void produce(const Sched& p, int l) {
    const long long u1 = p.lo(blockIdx.x + 1);
    long long u = p.lo(blockIdx.x);
    while (u < u1) {
      const int tile = int(u / p.upt);
      const long long t0 = (long long)tile * p.upt;
      const int n = int(min(u1, t0 + p.upt) - u);
      int k0 = int(u - t0) * p.depth;
      u += n;
      const int mask = box_mask(p, tile);
      if (p.mode == kModeTied) {
        const uint32_t bytes = __popc(mask) * 8192;
        for (int i = 0; i < n; ++i, k0 += p.depth) {
          sm90::mbar_wait(&misc->empty[s], ph ^ 1);
          unsigned char* st = ring + s * kStageBytes;
          uint64_t* full = &misc->full[s];
          sm90::mbar_arrive_tx(full, bytes);
          for (int j = 0; j < 2; ++j)
            if (mask >> j & 1)
              sm90::tma_load_3d(st + j * 8192, &maps.m[7], full, k0,
                                tile * 128 + 64 * j, 0);
          advance();
        }
        continue;
      }
      const CUtensorMap* mp[4];
      int col[4];
      for (int j = 0; j < 4; ++j) {
        int mat, lim;
        tile_box(p, tile, j, mat, col[j], lim);
        mp[j] = &maps.m[mat];
      }
      const uint32_t bytes = __popc(mask) * 4096;
      const int layer = p.kind == kHead ? 0 : l;
      for (int i = 0; i < n; ++i, k0 += p.depth) {
        sm90::mbar_wait(&misc->empty[s], ph ^ 1);
        unsigned char* st = ring + s * kStageBytes;
        uint64_t* full = &misc->full[s];
        sm90::mbar_arrive_tx(full, bytes);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (mask >> j & 1)
            sm90::tma_load_3d(st + j * 4096, mp[j], full, col[j], k0, layer);
        advance();
      }
    }
  }

  __device__ void producer() {
    const int n_steps = kMulti ? a.n_steps : 1;
    for (int step = 0; step < n_steps; ++step) {
      for (int l = 0; l < a.L; ++l) {
        produce(sched(kQkv), l);
        produce(sched(kWo), l);
        produce(sched(kGu), l);
        produce(sched(kDown), l);
      }
      if constexpr (kMulti) produce(sched(kHead), 0);
    }
  }

  // ---- the consumers
  // the barrier of every consumer thread of the grid: thread 0 adds the
  // block's arrival with release (the barrier before it orders the block's
  // writes) and waits with acquire for every block's
  __device__ void grid_sync() {
    target += gridDim.x;
    consumer_sync();
    if (tid == 0) {
      red_release_add(a.count, 1);
      wait_at_least(a.count, int(target));
    }
    consumer_sync();
  }

  // misc->rn[n] = rsqrt(mean(x[n]^2) + eps) for the N rows of x [N, h],
  // all rows in one pass of 16-byte loads (the warps' sums meet in `res`,
  // free here)
  // rn from the sums of squares the last residual phase (`from`: 0 wo,
  // 1 w_down) left a tile, added in tile order
  __device__ void rms_from_tiles(int from) {
    const int tiles = cdiv(a.h, 4 * box_cols<W>());
    const float* ssq = reinterpret_cast<const float*>(a.count + kSsq)
                       + from * kMaxTiles * 8;
    if (tid < a.N) {
      float tot = 0.f;
      for (int i0 = 0; i0 < tiles; i0 += 8) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = i0 + i < tiles ? __ldcg(ssq + (i0 + i) * 8 + tid) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) tot += v[i];
      }
      misc->rn[tid] = rsqrtf(tot / float(a.h) + a.eps);
    }
    consumer_sync();
  }

  __device__ void rms_factors() {
    constexpr int kV = 16 / int(sizeof(T));
    const T* x = static_cast<const T*>(a.x);
    float sum[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) sum[n] = 0.f;
#pragma unroll 2
    for (int k = tid * kV; k < a.h; k += kConsumers * kV)
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n < a.N) {
          float v[kV];
          load16_cg(x + int64_t(n) * a.h + k, v);
#pragma unroll
          for (int i = 0; i < kV; ++i) sum[n] = fmaf(v[i], v[i], sum[n]);
        }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float w = group_sum<32>(sum[n]);
      if (lane == 0) res[warp * 8 + n] = w;
    }
    consumer_sync();
    if (tid < a.N) {
      float tot = 0.f;
      for (int w = 0; w < kConsumerWarps; ++w) tot += res[w * 8 + tid];
      misc->rn[tid] = rsqrtf(tot / float(a.h) + a.eps);
    }
    consumer_sync();
  }

  // the input rows [ck, ck + kc) of a k-range into xs, zero to kpad and
  // in rows past N
  template <class In>
  __device__ void stage_xs(const In& in, int ck, int kc, int kpad) {
    if constexpr (!kF32) {
      const int chunks = kpad >> 3;
#pragma unroll 8
      for (int e = tid; e < 8 * chunks; e += kConsumers) {
        const int n = e / chunks, c8 = e - n * chunks, k = c8 << 3;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (n < a.N && k < kc) {
          float f[8];
          in.load(n, ck + k, f);
          v = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        }
        *reinterpret_cast<uint4*>(uni + (c8 >> 3) * 1024 + n * 128 +
                                  (((c8 & 7) ^ n) << 4)) = v;
      }
      sm90::fence_async_shared();   // wgmma reads it in the async proxy
    } else {
      const int chunks = kpad >> 2;
      float* xs = reinterpret_cast<float*>(uni);
#pragma unroll 4
      for (int e = tid; e < NS * chunks; e += kConsumers) {
        const int n = e / chunks, c4 = e - n * chunks, k = c4 << 2;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < a.N && k < kc) {
          float f[4];
          in.load(n, ck + k, f);
          v = make_float4(f[0], f[1], f[2], f[3]);
        }
        *reinterpret_cast<float4*>(xs + n * kXsRows + k) = v;
      }
    }
  }

  // units [ub, ue) of one tile: its sums over those rows in res
  template <typename E, bool kK, class In>
  __device__ void item(const Sched& p, int tile, int ub, int ue,
                       const In& in) {
    using M = Mma<T, E, kK, NS>;
    M mma;
    mma.zero();
    const int kb = ub * p.depth, ke = min(p.K, ue * p.depth);
    const int vmask = box_mask(p, tile);
    int prev = -1;
    for (int ck = kb; ck < ke; ck += kXsRows) {
      const int kc = min(kXsRows, ke - ck), nu = cdiv(kc, p.depth);
      if constexpr (M::kAsync) {
        if (prev >= 0) {   // the products reading the last chunk
          mma.retire_all();
          release(prev);
          prev = -1;
        }
      }
      const long long t0 = now();
      // rows inside the full chunk already staged are read from it
      int xoff = ck - staged;
      if (staged < 0 || xoff < 0 || xoff + kc > kXsRows) {
        consumer_sync();
        stage_xs(in, ck, kc, nu * p.depth);
        consumer_sync();
        staged = kc == kXsRows ? ck : -1;
        xoff = 0;
      }
      add(kTrParts + 4 * p.kind, t0);
      const long long t1 = now();
      for (int i = 0; i < nu; ++i) {
        sm90::mbar_wait(&misc->full[s], ph);
        mma.step(ring + s * kStageBytes, uni, xoff + i * p.depth, vmask,
                 a.N);
        if constexpr (M::kAsync) {
          mma.retire_one();   // the last stage's products have retired
          if (prev >= 0) release(prev);
          prev = s;
        } else {
          release(s);
        }
        advance();
      }
      add(kTrParts + 1 + 4 * p.kind, t1);
    }
    if constexpr (M::kAsync) {
      if (prev >= 0) {
        mma.retire_all();
        release(prev);
      }
    }
    mma.store(res, a.N);
    consumer_sync();
  }

  // A tile whose units several blocks hold: the block holding its first
  // units finishes it (that block's range ends in the tile, so it comes
  // to the tile last); every other one writes its sums to its scratch
  // slot and releases its flag with this phase's epoch. The finisher
  // waits for the flags, adds the sums in block order (its own first)
  // into res and returns true; the others return false. A tile one block
  // holds returns true at once. A block contributes to at most one tile
  // of a phase (its first) and finishes at most one (its last), so a
  // slot and a flag a block suffice, and waits only go to higher blocks.
  __device__ bool settle(const Sched& p, int tile) {
    const long long t0 = (long long)tile * p.upt;
    const long long t1 = min(p.U, t0 + p.upt) - 1;
    const int bf = p.block_of(t0), bl = p.block_of(t1);
    if (bf == bl) return true;
    // float4s of the slots' live rows: rows 0-3, and 4-7 when N > 4
    const int per = a.N > 4 ? 2 : 1, n4 = p.slots() * per;
    auto at = [&](int e) { return per == 2 ? e : 2 * e; };
    const int epoch = int(target) + 1;
    float4* r4 = reinterpret_cast<float4*>(res);
    const float4* part4 = reinterpret_cast<const float4*>(a.part);
    if (int(blockIdx.x) != bf) {
      const long long c0 = now();
      float4* mine = reinterpret_cast<float4*>(a.part)
                     + int64_t(blockIdx.x) * (kSlots * 2);
      for (int e = tid; e < n4; e += kConsumers) mine[at(e)] = r4[at(e)];
      consumer_sync();
      if (tid == 0) st_release(a.count + kFlags + blockIdx.x, epoch);
      add(kTrSettle, c0);
      return false;
    }
    const long long c1 = now();
    // the contributors: blocks bf + 1 .. bl whose ranges are not empty
    int* ids = misc->ids;
    const int nb = bl - bf;
    for (int i = tid; i < nb; i += kConsumers) {
      const int b = bf + 1 + i;
      ids[i] = p.lo(b) < p.lo(b + 1) ? b : -1;
      if (ids[i] >= 0) wait_at_least(a.count + kFlags + b, epoch);
    }
    consumer_sync();
    add(kTrSettle + 1, c1);
    const long long c2 = now();
    for (int e0 = tid; e0 < n4; e0 += kConsumers) {
      const int e = at(e0);
      float4 v = r4[e];
      for (int i0 = 0; i0 < nb; i0 += 8) {
        float4 q[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int id = i0 + i < nb ? ids[i0 + i] : -1;
          q[i] = id >= 0 ? __ldcg(part4 + int64_t(id) * (kSlots * 2) + e)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v.x += q[i].x;
          v.y += q[i].y;
          v.z += q[i].z;
          v.w += q[i].w;
        }
      }
      r4[e] = v;
    }
    consumer_sync();
    add(kTrSettle + 2, c2);
    return true;
  }

  // the scale of column `col` of matrix m of layer l (M columns); 1 for
  // dense weights, where the f32 sum times it is the sum itself
  __device__ float wscale(int m, int l, int M, int col) const {
    if constexpr (kW8)
      return __bfloat162float(
          static_cast<const bf16*>(a.wscale[m])[int64_t(l) * M + col]);
    else
      return 1.f;
  }

  // a tile's complete sums (res) into its outputs, rounded as the plain
  // version rounds
  __device__ void epilogue(const Sched& p, int tile, int l) {
    if (p.kind == kHead) {
      head_fold(p, tile);
      return;
    }
    const int N = a.N, F = a.F, tw = p.tw;
    if (p.kind == kWo || p.kind == kDown) {
      residual(p, tile, l);
      return;
    }
    const int Mq = a.Hkv * a.G * D, Mqkv = Mq + 2 * a.Hkv * D;
    int m = 0, c0 = tile * tw, M = 0, off = 0;
    if (p.kind == kQkv) qkv_tile(p, tile, m, c0, M, off);
#pragma unroll 4
    for (int e = tid; e < N * tw; e += kConsumers) {
      const int n = e / tw, c = e - n * tw, col = c0 + c;
      const float v = res[c * 8 + n];
      if (p.kind == kQkv) {
        if (col < M)
          static_cast<T*>(a.qkv)[int64_t(n) * Mqkv + off + col] =
              from_f32<T>(__fmul_rn(v, wscale(m, l, M, col)));
      } else if (col < F) {   // gate/up
        const float g = round_to<T>(__fmul_rn(v, wscale(4, l, F, col)));
        const float sg = round_to<T>(__fdiv_rn(g, 1.f + expf(-g)));
        const float u = round_to<T>(
            __fmul_rn(res[(tw + c) * 8 + n], wscale(5, l, F, col)));
        static_cast<T*>(a.gu)[int64_t(n) * F + col] =
            from_f32<T>(__fmul_rn(sg, u));
      }
    }
  }

  // x[n][col] += the tile's sums times their scale (wo, w_down), rounded
  // as the plain version rounds; and the tile's sums of squares of the new
  // x a row, for the next norm (added in warp order here, in tile order
  // by rms_from_tiles)
  __device__ void residual(const Sched& p, int tile, int l) {
    const int h = a.h, tw = p.tw, c0 = tile * tw, m = p.kind == kWo ? 3 : 6;
    T* x = static_cast<T*>(a.x);
    float ss[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) ss[n] = 0.f;
    for (int c = tid; c < tw; c += kConsumers) {
      const int col = c0 + c;
      if (col >= h) continue;
      const float s = wscale(m, l, h, col);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        if (n < a.N) {
          T* xp = x + int64_t(n) * h + col;
          const float y = round_to<T>(__fmul_rn(res[c * 8 + n], s));
          const T xn = from_f32<T>(__fadd_rn(ld_cg(xp), y));
          *xp = xn;
          const float xf = to_f32(xn);
          ss[n] = fmaf(xf, xf, ss[n]);
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float w = group_sum<32>(ss[n]);
      if (lane == 0) misc->red[warp * 8 + n] = w;
    }
    consumer_sync();
    if (tid < a.N) {
      float tot = 0.f;
      for (int w = 0; w < kConsumerWarps; ++w) tot += misc->red[w * 8 + tid];
      reinterpret_cast<float*>(a.count + kSsq)[
          ((p.kind == kWo ? 0 : 1) * kMaxTiles + tile) * 8 + tid] = tot;
    }
  }

  // one phase of products: this block's items in order, each settled and
  // finished
  template <class In>
  __device__ void gemv_phase(const Sched& p, int l, const In& in) {
    staged = -1;   // xs is the walk's between phases; other inputs here
    const long long u1 = p.lo(blockIdx.x + 1);
    long long u = p.lo(blockIdx.x);
    while (u < u1) {
      const int tile = int(u / p.upt);
      const long long t0 = (long long)tile * p.upt;
      const long long tend = min(u1, t0 + p.upt);
      const int ub = int(u - t0), ue = int(tend - t0);
      if (p.mode == kModeW) {
        item<W, false>(p, tile, ub, ue, in);
      } else if constexpr (kMulti) {
        if (p.mode == kModeHeadT)
          item<T, false>(p, tile, ub, ue, in);
        else if (p.mode == kModeHead8)
          item<int8_t, false>(p, tile, ub, ue, in);
        else
          item<T, true>(p, tile, ub, ue, in);
      }
      const long long c0 = now();
      const bool mine = settle(p, tile);
      add(kTrParts + 2 + 4 * p.kind, c0);
      const long long c1 = now();
      if (mine) epilogue(p, tile, l);
      add(kTrParts + 3 + 4 * p.kind, c1);
      u = tend;
    }
  }

  // ---- attention
  // this step's RoPE cos/sin a row (f32 angles at the row's length, cos
  // and sin rounded to the model dtype)
  __device__ void rope_table() {
    constexpr int D2 = D / 2;
    for (int e = tid; e < a.N * D2; e += kConsumers) {
      const int n = e / D2, i = e - n * D2;
      // the multi-step form moves the lengths in the kernel: past L1
      const float pos = float(kMulti ? __ldcg(a.lens + n) : a.lens[n]);
      const float ang = __fmul_rn(pos, a.freq[i]);
      misc->rope_c[n * 64 + i] = round_to<T>(cosf(ang));
      misc->rope_s[n * 64 + i] = round_to<T>(sinf(ang));
    }
    consumer_sync();
  }

  // Slot n, kv head hk of layer l, part p of P: RoPE of the group's
  // queries (and, in part 0, of the fresh k, written with v into ring row
  // t); the walk over the part's share of the pool prefix (whole
  // 64-position tiles); with P > 1 the other parts' (m, l, acc) go to
  // scratch and part 0 merges the P in order p = 0..P-1; then part 0's
  // block combines with ring rows j <= t (its own ring write among them)
  // and writes the attention output.
  template <typename Pool>
  __device__ void attention_item(int l, int n, int hk, int p, int P, int t) {
    using WL = walk::Layout<Pool, D, kWalkTile, kWalkStages>;
    constexpr int D2 = D / 2, DC = D / 32;
    float* Qs = reinterpret_cast<float*>(uni + kWalkStages * WL::kStageBytes);
    const int G = a.G, Hkv = a.Hkv;
    const int Mq = Hkv * G * D, Mqkv = Mq + 2 * Hkv * D;
    const T* qkv = static_cast<const T*>(a.qkv) + int64_t(n) * Mqkv;
    const int64_t ring0 = (int64_t(l) * a.N + n) * a.S * Hkv * D;
    T* rk = static_cast<T*>(a.ring_k) + ring0;   // [S, Hkv, D]
    T* rv = static_cast<T*>(a.ring_v) + ring0;
    const float* rc = misc->rope_c + n * 64;
    const float* rs = misc->rope_s + n * 64;

    long long t0 = now();
    consumer_sync();   // the previous item is done with Qs
    const int rows = p == 0 ? G + 1 : G;   // part 0 rotates k too
    for (int e = tid; e < rows * D2; e += kConsumers) {
      const int row = e / D2, i = e - row * D2;
      const float cs = rc[i], sn = rs[i];
      const T* src = row < G ? qkv + (hk * G + row) * D : qkv + Mq + hk * D;
      const float x1 = ld_cg(src + i), x2 = ld_cg(src + i + D2);
      const float o1 = round_to<T>(__fsub_rn(round_to<T>(__fmul_rn(x1, cs)),
                                             round_to<T>(__fmul_rn(x2, sn))));
      const float o2 = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x2, cs)),
                                             round_to<T>(__fmul_rn(x1, sn))));
      if (row < G) {
        Qs[row * D + i] = o1;
        Qs[row * D + i + D2] = o2;
      } else {
        T* dst = rk + (int64_t(t) * Hkv + hk) * D;
        dst[i] = from_f32<T>(o1);
        dst[i + D2] = from_f32<T>(o2);
      }
    }
    if (p == 0)
      for (int d = tid; d < D; d += kConsumers)
        rv[(int64_t(t) * Hkv + hk) * D + d] =
            from_f32<T>(ld_cg(qkv + Mq + Hkv * D + hk * D + d));
    consumer_sync();   // queries staged; ring row t written
    add(kTrAttention, t0);
    t0 = now();

    const int len = max(0, min(a.walk_lens[n], a.MB * a.BS));
    const int share = (len + P * kWalkTile - 1) / (P * kWalkTile)
                      * kWalkTile;
    const int begin = min(len, p * share), end = min(len, begin + share);
    float m, lsum, acc[DC];
    walk::ragged_walk<Pool, D, ConsumerSync, kWalkTile, kWalkStages>(
        static_cast<const Pool*>(a.k_pool), static_cast<const Pool*>(a.v_pool),
        a.ks_pool, a.vs_pool, a.table + int64_t(n) * a.MB, begin, end, l,
        a.NB, a.BS, Hkv, hk, G, a.scale, uni, m, lsum, acc);
    add(kTrAttention + 1, t0);
    t0 = now();
    if (P > 1) {
      // parts p > 0 leave G rows of [acc (D), m, l] and release their
      // flag; part 0 waits for the flags and merges them in part order
      float* base = a.part
                    + (int64_t(n) * Hkv + hk) * kMaxParts * G * (D + 2);
      int* flags = a.count + kWalkFlags + (n * Hkv + hk) * kMaxParts;
      const int epoch = int(target) + 1;
      if (p > 0) {
        if (warp < G) {
          float* r = base + (int64_t(p) * G + warp) * (D + 2);
#pragma unroll
          for (int c = 0; c < DC; ++c) r[lane * DC + c] = acc[c];
          if (lane == 0) {
            r[D] = m;
            r[D + 1] = lsum;
          }
        }
        consumer_sync();
        if (tid == 0) st_release(flags + p, epoch);
        return;
      }
      if (tid < P - 1) wait_at_least(flags + 1 + tid, epoch);
      consumer_sync();
      if (warp < G) {
        // every part's (m, l, acc) loaded at once, merged in part order
        float mq[kMaxParts], lq[kMaxParts], aq[kMaxParts][DC];
#pragma unroll
        for (int q = 1; q < kMaxParts; ++q) {
          if (q < P) {
            const float* r = base + (int64_t(q) * G + warp) * (D + 2);
            mq[q] = __ldcg(r + D);
            lq[q] = __ldcg(r + D + 1);
#pragma unroll
            for (int c = 0; c < DC; ++c) aq[q][c] = __ldcg(r + lane * DC + c);
          }
        }
        mq[0] = m;
        lq[0] = lsum;
#pragma unroll
        for (int c = 0; c < DC; ++c) aq[0][c] = acc[c];
        m = kNegInf;
#pragma unroll
        for (int q = 0; q < kMaxParts; ++q)
          if (q < P) m = fmaxf(m, mq[q]);
        lsum = 0.f;
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[c] = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxParts; ++q) {
          if (q < P) {
            const float w = expf(mq[q] - m);
            lsum = fmaf(lq[q], w, lsum);
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[c] = fmaf(aq[q][c], w, acc[c]);
          }
        }
      }
    }
    add(kTrAttention + 2, t0);
    t0 = now();
    if (warp >= G) return;

    // flash-decoding combine with ring positions j <= t (f32
    // probabilities). A ring row's scores come from 16-byte loads: LPR
    // lanes a row, RPP rows a pass, the sums gathered so that lane i
    // holds position j0 + i.
    constexpr int kV = 16 / int(sizeof(T));
    constexpr int LPR = D / kV, RPP = 32 / LPR;
    const int sub = lane % LPR, grp = lane / LPR;
    float qv[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) qv[e] = Qs[warp * D + sub * kV + e];
    for (int j0 = 0; j0 <= t; j0 += 32) {
      float sc = kNegInf;
      // passes of 8 whose loads are all in flight before their sums
      for (int p0 = 0; p0 < 32 / RPP && j0 + p0 * RPP <= t; p0 += 8) {
        float dot[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int j = j0 + (p0 + i) * RPP + grp;
          dot[i] = 0.f;
          if (p0 + i < 32 / RPP && j <= t) {
            float kf[kV];
            load16_cg(rk + (int64_t(j) * Hkv + hk) * D + sub * kV, kf);
#pragma unroll
            for (int e = 0; e < kV; ++e) dot[i] = fmaf(qv[e], kf[e], dot[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = group_sum<LPR>(dot[i]);
          const float got = __shfl_sync(kFullMask, d, (lane % RPP) * LPR);
          if (p0 + i == lane / RPP) sc = got;
        }
      }
      const int j = j0 + lane;
      const float sj = j <= t ? sc * a.scale : kNegInf;
      const float m_new = fmaxf(m, group_max<32>(sj));
      const float alpha = expf(m - m_new);
      const float pr = j <= t ? expf(sj - m_new) : 0.f;
      lsum = lsum * alpha + group_sum<32>(pr);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] *= alpha;
      const int nj = min(32, t + 1 - j0);
      for (int j1 = 0; j1 < nj; j1 += 8) {
        float vv[8][DC];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (j1 + i < nj)
            load_dc<DC>(rv + (int64_t(j0 + j1 + i) * Hkv + hk) * D
                            + lane * DC, vv[i]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pj = __shfl_sync(kFullMask, pr, (j1 + i) & 31);
          if (j1 + i < nj)
#pragma unroll
            for (int c = 0; c < DC; ++c) acc[c] = fmaf(pj, vv[i][c], acc[c]);
        }
      }
      m = m_new;
    }
    T* out = static_cast<T*>(a.att) + int64_t(n) * Mq + (hk * G + warp) * D
             + lane * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) out[c] = from_f32<T>(acc[c] / lsum);
    add(kTrAttention + 3, t0);
  }

  // How many parts each slot's walks split into: one part each, then,
  // while the grid has a block for each of a slot's Hkv walks, one more to
  // the slot whose parts are longest (the lower slot on a tie), so the
  // longest part is as short as the grid allows. A function of the
  // walk lengths alone: every block works it out alike.
  __device__ void walk_parts(int (&P)[8]) const {
    int tiles[8], used = 0;
    for (int n = 0; n < a.N; ++n) {
      const int len = max(0, min(a.walk_lens[n], a.MB * a.BS));
      tiles[n] = max(1, cdiv(len, kWalkTile));
      P[n] = 1;
      used += a.Hkv;
    }
    while (used + a.Hkv <= int(gridDim.x)) {
      int best = -1, longest = 1;
      for (int n = 0; n < a.N; ++n) {
        const int w = cdiv(tiles[n], P[n]);
        if (P[n] < kMaxParts && w > longest) {
          longest = w;
          best = n;
        }
      }
      if (best < 0) break;
      ++P[best];
      used += a.Hkv;
    }
  }

  // every (slot, kv head, part of the walk), a block each in turn
  __device__ void attention_phase(int l, int t) {
    if (!kRunAttention) return;
    int P[8];
    walk_parts(P);
    int total = 0;
    for (int n = 0; n < a.N; ++n) total += a.Hkv * P[n];
    for (int it = blockIdx.x; it < total; it += gridDim.x) {
      int n = 0, r = it;
      while (r >= a.Hkv * P[n]) r -= a.Hkv * P[n++];
      const int hk = r / P[n], part = r % P[n];
      if (a.kv_int8)
        attention_item<int8_t>(l, n, hk, part, P[n], t);
      else
        attention_item<T>(l, n, hk, part, P[n], t);
    }
  }

  // ---- the multi-step form's epilogue
  // a head tile's logits rounded to the model dtype (an int8 column's
  // scale on its complete sum), folded into this block's best a row
  __device__ void head_fold(const Sched& p, int tile) {
    if (warp >= a.N) return;
    const int n = warp;
    const bf16* hs = static_cast<const bf16*>(a.head_scale);
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = lane; c < p.tw; c += 32) {
      const int col = tile * p.tw + c;
      if (col < a.V) {
        float lg = res[c * 8 + n];
        if (p.mode == kModeHead8) lg = __fmul_rn(lg, __bfloat162float(hs[col]));
        lg = round_to<T>(lg);
        if (better(lg, col, bv, bi)) {
          bv = lg;
          bi = col;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv, o);
      const int oi = __shfl_xor_sync(kFullMask, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0 && better(bv, bi, misc->bestv[n], misc->besti[n])) {
      misc->bestv[n] = bv;
      misc->besti[n] = bi;
    }
  }

  // E1, E2: the final norm and the head over this block's units; the
  // block's best (logit, index) a row to hmax/hidx[blockIdx.x][n]
  __device__ void head_phase() {
    if (tid < 8) {
      misc->bestv[tid] = -INFINITY;
      misc->besti[tid] = 0x7fffffff;
    }
    const Sched p = sched(kHead);
    if (has_items(p)) {
      if (kRunDown)
        rms_from_tiles(1);
      else
        rms_factors();
    }
    gemv_phase(p, 0, NormIn<T>{static_cast<const T*>(a.x),
                               static_cast<const T*>(a.final_norm), misc->rn,
                               a.h});
    consumer_sync();
    if (tid < a.N) {
      a.hmax[int64_t(blockIdx.x) * a.N + tid] = misc->bestv[tid];
      a.hidx[int64_t(blockIdx.x) * a.N + tid] = misc->besti[tid];
    }
  }

  // E3 for row n, in block n after a grid barrier: the row's pick over
  // every block's best (`better`: the larger logit, then the lower index),
  // then the TPU kernel's bookkeeping — a row decodes while it is active
  // and not done; it emits its pick (-1 otherwise), advances its length,
  // spends its budget and is done at its eos or with its budget spent —
  // and embed[last] as the row's next input. The state is read and
  // written past L1: other blocks read the lengths after the next
  // barrier.
  __device__ void commit_row(int step, int n) {
    const int N = a.N, h = a.h;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int b = tid; b < int(gridDim.x); b += kConsumers) {
      const float v = __ldcg(a.hmax + int64_t(b) * N + n);
      const int i = __ldcg(a.hidx + int64_t(b) * N + n);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFullMask, bv, o);
      const int oi = __shfl_xor_sync(kFullMask, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    float* wv = reinterpret_cast<float*>(uni);        // [warps]
    int* wi = reinterpret_cast<int*>(uni) + kConsumerWarps;
    int* next = wi + kConsumerWarps;
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    consumer_sync();
    if (tid == 0) {
      for (int w = 0; w < kConsumerWarps; ++w)
        if (better(wv[w], wi[w], bv, bi)) {
          bv = wv[w];
          bi = wi[w];
        }
      int* st = a.state;
      const int last = __ldcg(st + n), len = __ldcg(st + N + n);
      const int done = __ldcg(st + 2 * N + n), rem = __ldcg(st + 3 * N + n);
      const bool act = a.active[n] != 0 && done == 0;
      const int rem2 = rem - int(act);
      const bool done2 = done != 0
                         || (act && a.eos[n] >= 0 && bi == a.eos[n])
                         || (act && rem2 <= 0);
      const int last2 = act ? bi : last;
      a.emitted[int64_t(step) * N + n] = act ? bi : -1;
      __stcg(st + n, last2);
      __stcg(st + N + n, len + int(act));
      __stcg(st + 2 * N + n, int(done2));
      __stcg(st + 3 * N + n, rem2);
      *next = last2;
    }
    consumer_sync();
    const T* src = static_cast<const T*>(a.embed) + int64_t(*next) * h;
    T* dst = static_cast<T*>(a.x) + int64_t(n) * h;
    for (int k = tid; k < h; k += kConsumers) dst[k] = src[k];
  }

  __device__ void consumer() {
    const int n_steps = kMulti ? a.n_steps : 1;
    const int h = a.h, Mq = a.Hkv * a.G * D;
    const T* x = static_cast<const T*>(a.x);
    for (int step = 0; step < n_steps; ++step) {
      const int t = kMulti ? step : a.t;   // the ring index of this step
      rope_table();
      for (int l = 0; l < a.L; ++l) {
        const T* an = static_cast<const T*>(a.attn_norm) + int64_t(l) * h;
        const T* mn = static_cast<const T*>(a.mlp_norm) + int64_t(l) * h;
        if constexpr (kTrace)
          trace = step == 0 && l == kTraceLayer
                      ? reinterpret_cast<long long*>(a.count + kTraceOffset)
                            + int64_t(blockIdx.x) * kTraceSlots
                      : nullptr;
        mark(0);
        {   // 1. q, k, v of the normed rows
          const Sched p = sched(kQkv);
          if (has_items(p)) {
            if (l > 0 && kRunDown)
              rms_from_tiles(1);
            else
              rms_factors();
          }
          mark(1);
          gemv_phase(p, l, NormIn<T>{x, an, misc->rn, h});
        }
        mark(2);
        grid_sync();
        mark(3);
        attention_phase(l, t);   // 2.
        mark(4);
        grid_sync();
        mark(5);
        // 3. x += att @ wo
        gemv_phase(sched(kWo), l, RawIn<T>{static_cast<const T*>(a.att), Mq});
        mark(6);
        grid_sync();
        mark(7);
        {   // 4. gu = SiLU(hn @ w_gate) * (hn @ w_up) of the normed rows
          const Sched p = sched(kGu);
          if (has_items(p)) {
            if (kRunWo)
              rms_from_tiles(0);
            else
              rms_factors();
          }
          mark(8);
          gemv_phase(p, l, NormIn<T>{x, mn, misc->rn, h});
        }
        mark(9);
        grid_sync();
        mark(10);
        // 5. x += gu @ w_down
        gemv_phase(sched(kDown), l,
                   RawIn<T>{static_cast<const T*>(a.gu), a.F});
        mark(11);
        if (l + 1 < a.L) grid_sync();
        mark(12);
      }
      if constexpr (kMulti) {
        if constexpr (kTrace)
          trace = step == 0 ? reinterpret_cast<long long*>(
                                  a.count + kTraceOffset)
                                  + int64_t(blockIdx.x) * kTraceSlots
                            : nullptr;
        grid_sync();                                  // x after the last layer
        mark(kTrHead);
        head_phase();                                 // E1, E2
        mark(kTrHead + 1);
        grid_sync();
        if (int(blockIdx.x) < a.N) commit_row(step, blockIdx.x);   // E3
        if (step + 1 < n_steps) grid_sync();   // E4: the next step's input
        mark(kTrHead + 2);
        if constexpr (kTrace) trace = nullptr;
      }
    }
  }
};

// W: the weight matrices' type, T or int8_t; kMulti: the multi-step form
// (mega_decode_loop: n_steps greedy steps, each ending in the head and
// commit_row), else one step at ring index t
template <typename T, int D, int NS, typename W, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1)
mega_decode_kernel(const __grid_constant__ Args a,
                   const __grid_constant__ Maps maps) {
  using Lay = Smem<T, D, NS>;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = dyn + ((kAlign - (sm90::smem_u32(dyn) & (kAlign - 1)))
                               & (kAlign - 1));
  Kern<T, D, NS, W, kMulti> k(a, maps, base);
  if (threadIdx.x == 0) {
    for (int i = 0; i < Lay::kStages; ++i) {
      sm90::mbar_init(&k.misc->full[i], 1);
      sm90::mbar_init(&k.misc->empty[i], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) k.producer();
    return;
  }
  k.consumer();
}

// blocks of the kernel one SM holds at once (0 when none fits)
template <typename T, int D, int NS, typename W, bool kMulti>
cudaError_t blocks_per_sm(int* per_sm) {
  constexpr int smem = Smem<T, D, NS>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mega_decode_kernel<T, D, NS, W, kMulti>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, mega_decode_kernel<T, D, NS, W, kMulti>, kThreads, smem);
}

template <typename T, int D, int NS, typename W, bool kMulti>
cudaError_t launch(const Args& a, const Maps& maps, cudaStream_t stream) {
  // the grid: one block an SM, every block co-resident, sized once per
  // device
  static int grid_dev = -1, grid_blocks = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != grid_dev) {
    int per_sm = 0, sms = 0;
    err = blocks_per_sm<T, D, NS, W, kMulti>(&per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (sms > kMaxBlocks) return cudaErrorCooperativeLaunchTooLarge;
    grid_dev = dev;
    grid_blocks = sms;
  }
  // the multi-step form's per-block scratch holds hcap blocks, and
  // commit_row takes a block a row
  if (kMulti && (grid_blocks > a.hcap || grid_blocks < a.N))
    return cudaErrorInvalidValue;
  void* args[] = {const_cast<Args*>(&a), const_cast<Maps*>(&maps)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_decode_kernel<T, D, NS, W, kMulti>),
      dim3(grid_blocks), dim3(kThreads), args, Smem<T, D, NS>::kBytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// launch<T, D, NS, W, kMulti> for D (64, 128) and N rows (the 4- or
// 8-row instantiation), and the occupancy of the same instantiation
template <typename T, typename W, bool kMulti>
cudaError_t launch_shape(const Args& a, const Maps& m, int D, int N,
                         cudaStream_t st) {
  if (N < 1 || N > 8) return cudaErrorInvalidValue;
  if (D == 128)
    return N <= 4 ? launch<T, 128, 4, W, kMulti>(a, m, st)
                  : launch<T, 128, 8, W, kMulti>(a, m, st);
  if (D == 64)
    return N <= 4 ? launch<T, 64, 4, W, kMulti>(a, m, st)
                  : launch<T, 64, 8, W, kMulti>(a, m, st);
  return cudaErrorInvalidValue;
}

template <typename T, typename W, bool kMulti>
cudaError_t occupancy_shape(int D, int N, int* per_sm) {
  if (N < 1 || N > 8) return cudaErrorInvalidValue;
  if (D == 128)
    return N <= 4 ? blocks_per_sm<T, 128, 4, W, kMulti>(per_sm)
                  : blocks_per_sm<T, 128, 8, W, kMulti>(per_sm);
  if (D == 64)
    return N <= 4 ? blocks_per_sm<T, 64, 4, W, kMulti>(per_sm)
                  : blocks_per_sm<T, 64, 8, W, kMulti>(per_sm);
  return cudaErrorInvalidValue;
}

}  // namespace

// one translation unit each (mega_decode_<dtype>[_w8].cu, and for the
// multi-step form mega_decode_multi_<dtype>[_w8].cu), so the build
// compiles the eight dtype/weight/step forms in parallel
#define PTT_MEGA_FORM(NAME)                                             \
  cudaError_t launch_##NAME(const Args& a, const Maps& m, int D, int N, \
                            cudaStream_t st);                           \
  cudaError_t occupancy_##NAME(int D, int N, int* per_sm);
PTT_MEGA_FORM(f32)
PTT_MEGA_FORM(bf16)
PTT_MEGA_FORM(f32_w8)
PTT_MEGA_FORM(bf16_w8)
PTT_MEGA_FORM(multi_f32)
PTT_MEGA_FORM(multi_bf16)
PTT_MEGA_FORM(multi_f32_w8)
PTT_MEGA_FORM(multi_bf16_w8)
#undef PTT_MEGA_FORM

}  // namespace mega
}  // namespace ptt
