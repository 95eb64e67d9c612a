// Ragged paged-attention decode walk for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py
// `_ragged_decode_kernel` (launched by `ragged_decode_partial`).
//
// For each slot n the kernel walks the slot's block table up to its TRUE
// length lengths[n] (read on the device: no host sync, no shape change
// when lengths move) over one layer of a [L, NB, BS, Hkv, D] pool, runs
// an online softmax, and emits the un-normalized flash-decoding partial
// state acc [N, Hkv, G, D], m and l [N, Hkv, G] (f32). A length-0 slot
// emits (0, -1e30, 0), the identity of the combine the serving engine
// applies with its in-call ring.
//
// What bounds it on the H100: HBM bytes. Each query token does 4*D FLOPs
// per cached token against 4*D bytes of bf16 K and V, about one operation
// per byte, so the floor is the KV walk 2*sum(len)*Hkv*D*itemsize over
// 3.35 TB/s. A decode step's walk is a few MB: the kernel has to keep
// every SM's copies in flight from its first microsecond.
//
// This design (bf16 queries over bf16 pools, or over int8 pools with f32
// per-position scales):
//
// - Split-K on a persistent grid (`Sched`): each (slot, kv head) walk is a
//   run of 32-position tiles, the walks lie end to end, and the grid's
//   blocks (one an SM) take equal ranges of that line, computed on the
//   device from `lengths`. A range cuts a walk into parts on tile
//   boundaries, so one long slot spreads over every SM, and a block may
//   finish many short walks.
// - Inside a block, four producer-consumer warp pairs each walk a quarter
//   of the range on their own: the producer warp finds its tile's 32
//   positions (a lane each: one division, block ids from 32 table entries
//   a load, the next walk's read a walk ahead) and copies the K and V rows
//   with 16-byte cp.async into its ring (2-3 tiles in flight, zero fill
//   past the length), plus the walk's queries; the ring's full barriers
//   complete when the copies land (cp.async.mbarrier.arrive). The consumer
//   warp scores on tensor cores (mma.sync m16n8k16, bf16 in, f32 sums):
//   S = Q K^T with the group's G query heads as the rows (zero past G), 8
//   positions a column block, then O += P V with V's fragments by
//   ldmatrix.trans. Q and K share a permuted order of D inside each mma,
//   so a lane reads 16 contiguous bytes of a K row.
// - A walk whole in a pair goes straight to the outputs. Pieces cut by a
//   pair boundary meet in shared memory and merge in pair order after the
//   pairs; a walk cut by the block range leaves the block's part in its
//   scratch slot and takes a ticket on the walk's flag, and the block with
//   the last ticket merges every part in part order (the result does not
//   depend on which block merges, so reruns are bit-equal; no block waits
//   for another) and resets the flag. The block's first walk's part is
//   stored and ticketed by the pairs as soon as its pieces are done.
// - The TPU kernel's arithmetic: bf16 pools round P to bf16 before P V;
//   int8 pools scale the score by the K scale, sum the unscaled P into l
//   and take P * V-scale against the V rows widened exactly to bf16 (in a
//   pair's buffer) — that product in f32, so P * V-scale enters the mma as
//   three bf16 terms (hi + mid + lo carry its 24 bits); the int8 K rows
//   widen in registers.
//
// f32 queries (f32 pools, or int8 pools) keep the CUDA-core walk of
// ragged_walk.cuh (shared with B5 and B6) on the same schedule, in its
// 64-position tiles, and the same parts.
//
// The launch path: the dynamic shared-memory attribute and the grid are
// set up once per form and device (`ptt_ragged_decode_grid`); the wrapper
// allocates acc, m and l in one buffer and keeps the flags and the parts'
// scratch per stream.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "ragged_walk.cuh"

namespace ptt {
namespace ragged {
namespace {

using bf16 = __nv_bfloat16;
using sm90::ldsm_x4_t;
using sm90::mbar_arrive;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_sync;
using sm90::smem_u32;
using sm90::widen2;
using walk::kMaxGroup;

constexpr int kTile = 32;            // positions a tile (tensor-core walk)
constexpr int kQw = 2;               // query buffers a pair
constexpr int kMaxParts = 192;       // most blocks a walk spans (grid cap)
constexpr int kSyncId = 1;           // the consumers' named barrier

// Both stay true in every shipped build; tools/ragged_decode_ab.py --probe
// builds copies with one of them false (copies only, or scoring only).
constexpr bool kCopy = true;
constexpr bool kScore = true;

// ---------------------------------------------------------------------------
// The split schedule, shared by both kernels and the host export
// ---------------------------------------------------------------------------
// One walk's piece in one block: walk (n, hk) has `t` tiles; this block
// scores tiles [ta, tb); the walk spans `nparts` blocks from block b0.
struct Seg {
  int n, hk, ta, tb, t, b0, nparts;
};

// `start[n]` = Hkv * (tiles of slots before n), start[N] the total; a slot
// of length 0 counts one (empty) tile, so it still writes its identity.
// Block b takes the walk tiles [b * per, min(total, (b + 1) * per)).
struct Sched {
  const int* start;
  int N, Hkv, grid, per;

  __host__ __device__ Sched(const int* s, int n, int hkv, int g)
      : start(s), N(n), Hkv(hkv), grid(g),
        per((s[n] + g - 1) / g) {}

  __host__ __device__ int slot_of(int r) const {   // start[n] <= r < start[n+1]
    int lo = 0, hi = N - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (start[mid] <= r)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }

  // block b's scratch slot for its part of the walk starting at tile ws
  __host__ __device__ int scratch_slot(int b, int ws) const {
    return ws <= b * per ? 0 : 1;
  }

  // the piece of the walk holding tile r, up to the range end `rend`
  __host__ __device__ Seg seg(int r, int rend) const {
    const int n = slot_of(r);
    const int t = (start[n + 1] - start[n]) / Hkv;
    const int hk = (r - start[n]) / t;
    const int ws = start[n] + hk * t, we = ws + t;
    const int b0 = ws / per;
    return Seg{n, hk, r - ws, min(rend, we) - ws, t, b0,
               (we - 1) / per - b0 + 1};
  }

};

__host__ __device__ inline int walk_tiles(int len, int tile) {
  return len > 0 ? (len + tile - 1) / tile : 1;
}

// start[] and the clamped lengths in shared memory, from `lengths`
__device__ void build_sched(const int* __restrict__ lengths, int N, int cap,
                            int Hkv, int tile, int* start, int* lens) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const int len = max(0, min(lengths[n], cap));
    lens[n] = len;
    start[n + 1] = Hkv * walk_tiles(len, tile);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int c = 0; c < N; c += 32) {
      int v = c + lane < N ? start[c + lane + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFullMask, v, o);
        if (lane >= o) v += u;
      }
      if (c + lane < N) start[c + lane + 1] = base + v;
      base += __shfl_sync(kFullMask, v, 31);
    }
    if (lane == 0) start[0] = 0;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The outputs, and the parts of walks cut by block ranges
// ---------------------------------------------------------------------------
// A walk cut by block ranges leaves one part in each block it crosses, in
// the block's scratch slot (0 when the walk reaches the block's first tile,
// else 1: only a block's first and last walks can be parts). Each block
// stores its part and takes a ticket on the walk's flag; the block that
// takes the last ticket merges every part in part order (so the result
// does not depend on which block merges) and sets the flag back to 0 for
// the next call. No block ever waits for another.
struct Out {
  float* acc;       // [N, Hkv, G, D], then m and l [N, Hkv, G]
  float* scratch;   // [grid, 2, pstride]: a part's acc [G][D], m [G], l [G]
  int* flags;       // [N * Hkv], zero between calls
  int N, Hkv, G, pstride;
};

// The outputs of walk (n, hk): acc [G][D], m and l [G].
struct Dest {
  float *acc, *m, *l;
};

__device__ __forceinline__ Dest out_of(const Out& o, int n, int hk, int D) {
  const int a = o.N * o.Hkv * o.G;
  const int row = (n * o.Hkv + hk) * o.G;       // (n, hk, head 0)
  float* m = o.acc + int64_t(a) * D + row;
  return Dest{o.acc + int64_t(row) * D, m, m + a};
}

// one thread's ticket on a walk's flag, ordered after the block's part
// (release, through the barrier before it) and before the reads of the
// other blocks' parts (acquire): whether it is the last of `nparts`, and
// then the flag is set back to 0 (every ticket of the call is taken)
__device__ __forceinline__ bool last_ticket(int* flag, int nparts) {
  int v;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
               : "=r"(v)
               : "l"(flag)
               : "memory");
  if (v != nparts - 1) return false;
  *flag = 0;
  return true;
}

// The part of walk (n, hk) held by block b (starting at tile ws): acc [G][D],
// m [G], l [G] in its scratch slot.
__device__ __forceinline__ float* part_at(const Out& o, const Sched& sc,
                                          int b, int ws) {
  return o.scratch + int64_t(2 * b + sc.scratch_slot(b, ws)) * o.pstride;
}

// Columns [c, c + kC) of head g of walk `s` merged from its parts in part
// order into the outputs (the head's first column's thread also writes m
// and l): kBatch parts' loads in flight, each batch raising the running
// maximum and rescaling the sums.
template <int D, int kC>
__device__ void merge_parts(const Out& o, const Sched& sc, const Seg& s,
                            int g, int c) {
  const int G = o.G;
  const int ws = sc.start[s.n] + s.hk * s.t;
  const Dest out = out_of(o, s.n, s.hk, D);
  constexpr int kBatch = 8;
  float mx = kNegInf, ls = 0.f, r[kC];
#pragma unroll
  for (int i = 0; i < kC; ++i) r[i] = 0.f;
  for (int q0 = 0; q0 < s.nparts; q0 += kBatch) {
    float mq[kBatch], lq[kBatch], v[kBatch][kC];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      mq[q] = kNegInf;
      if (q0 + q < s.nparts) {
        const float* p = part_at(o, sc, s.b0 + q0 + q, ws);
        mq[q] = __ldcg(p + G * D + g);
        lq[q] = __ldcg(p + G * D + G + g);
        if constexpr (kC == 4) {
          const float4 x =
              __ldcg(reinterpret_cast<const float4*>(p + g * D + c));
          v[q][0] = x.x;
          v[q][1] = x.y;
          v[q][2] = x.z;
          v[q][3] = x.w;
        } else {
#pragma unroll
          for (int i = 0; i < kC; ++i) v[q][i] = __ldcg(p + g * D + c + i);
        }
      }
    }
    float mb = mx;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) mb = fmaxf(mb, mq[q]);
    const float sc0 = expf(mx - mb);
#pragma unroll
    for (int i = 0; i < kC; ++i) r[i] *= sc0;
    ls *= sc0;
    mx = mb;
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (q0 + q < s.nparts) {
        const float w = expf(mq[q] - mx);
#pragma unroll
        for (int i = 0; i < kC; ++i) r[i] = fmaf(v[q][i], w, r[i]);
        ls = fmaf(lq[q], w, ls);
      }
  }
#pragma unroll
  for (int i = 0; i < kC; ++i) out.acc[g * D + c + i] = r[i];
  if (c == 0) {
    out.m[g] = mx;
    out.l[g] = ls;
  }
}

// ---------------------------------------------------------------------------
// The tensor-core walk (bf16 queries; bf16 or int8 pools)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // rows 8-15 of A (a1, a3) are zero: at most 8 query heads a group
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// this thread's cp.async copies so far complete one arrival on `bar`
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Q: the queries' type (bf16); P: the pools' (Q, or int8_t with scale pools)
template <typename Q, typename P, int D>
struct Lay {
  static_assert(std::is_same<Q, bf16>::value, "tensor cores take bf16");
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static constexpr int kEl = int(sizeof(P));
  static constexpr int kRow = D * kEl + 16;           // padded row bytes
  static constexpr int kChunks = D * kEl / 16;        // 16-byte copies a row
  static constexpr int kStage = 2 * kTile * kRow + (kInt8 ? 2 * kTile * 4 : 0);
  static constexpr int kQ = kMaxGroup * D * int(sizeof(Q));   // a walk's
  static constexpr int kVRow = D * 2 + 16;            // widened V rows
  static constexpr int kVBuf = kInt8 ? kTile * kVRow : 0;   // a pair's
  static constexpr int kW = kMaxGroup * D + 2 * kMaxGroup;   // a piece's state
  static constexpr int kP = 4;   // producer-consumer warp pairs
  static constexpr int kThreads = 64 * kP;
  // the rings: up to 136 KB, within what the rest leaves (4 KB kept for
  // the schedule), an equal number of tiles a pair
  static constexpr int kRest = kP * (kQw * kQ + kVBuf + 2 * kW * 4)
                               + 64 * 8 + 4096;
  static constexpr int kRing = sm90::kMaxSmem - kRest < 139264
                                   ? sm90::kMaxSmem - kRest : 139264;
  static constexpr int kStagesW = kRing / kStage / kP < 4
                                      ? kRing / kStage / kP : 4;
  static_assert(kStagesW >= 1, "a pair needs a ring slot");
  // rings, queries, widened V, pieces' states, barriers
  static constexpr int kOffQ = kP * kStagesW * kStage;
  static constexpr int kOffV = kOffQ + kP * kQw * kQ;
  static constexpr int kOffPiece = kOffV + kP * kVBuf;
  static constexpr int kOffBar = kOffPiece + kP * 2 * kW * 4;
  static constexpr int kOffArrived = kOffBar + kP * (2 * kStagesW + kQw) * 8;
  static constexpr int kOffSched = kOffArrived + 16;
  static constexpr int kSmem = kOffSched;   // + the schedule, (2N + 1) ints
};

struct Args {
  const void* q;              // [N, Hkv*G, D]
  const void *k_pool, *v_pool;   // [L, NB, BS, Hkv, D]
  const float *ks_pool, *vs_pool;   // [L, NB, BS, Hkv] (int8 pools)
  const int* table;           // [N, MB]
  const int* lengths;         // [N]
  Out out;
  int layer, NB, BS, MB;
  float scale;
};

// The block's range [r0, r1) split into kP contiguous sub-ranges, one a
// producer-consumer pair: pair w walks [sub(w), sub(w + 1)).
template <int kP>
struct Split {
  int r0, r1;
  __device__ int sub(int w) const { return r0 + (r1 - r0) * w / kP; }
  // the pair whose sub-range holds tile r (r0 <= r < r1)
  __device__ int pair_of(int r) const {
    int w = kP - 1;
    while (sub(w) > r) --w;
    return w;
  }
};

template <typename Q, typename P, int D>
struct Walker {
  using L = Lay<Q, P, D>;
  static constexpr bool kInt8 = L::kInt8;
  static constexpr int KS = D / 16;     // k-steps of Q K^T
  static constexpr int DB = D / 8;      // column blocks of O
  static constexpr int kW = L::kW;
  static constexpr int kP = L::kP;

  struct ConsumerSync {
    __device__ static void sync() { named_sync(kSyncId, 32 * kP); }
  };

  const Args& a;
  unsigned char* smem;
  const Sched& sc;
  const int* lens;
  uint64_t* bars;   // full [kP][kStagesW], empty [..], qempty [kP][kQw]
  int w;            // this warp's pair

  __device__ unsigned char* stage(int slot) const {
    return smem + (w * L::kStagesW + slot) * L::kStage;
  }
  __device__ unsigned char* qbuf(int k) const {
    return smem + L::kOffQ + (w * kQw + k % kQw) * L::kQ;
  }
  __device__ uint64_t* full(int slot) const {
    return bars + w * L::kStagesW + slot;
  }
  __device__ uint64_t* empty(int slot) const {
    return bars + (kP + w) * L::kStagesW + slot;
  }
  __device__ uint64_t* qempty(int k) const {
    return bars + 2 * kP * L::kStagesW + w * kQw + k % kQw;
  }
  // the state slot of pair `pw`'s first (0) or last (1) piece
  __device__ float* piece(int pw, int first_or_last) const {
    return reinterpret_cast<float*>(smem + L::kOffPiece)
           + (pw * 2 + first_or_last) * kW;
  }

  // ---- the pair's producer warp: every tile of its sub-range, in order.
  // Lane i finds position i of a tile (one division a tile, the block ids
  // from 32 table entries a load, the next walk's read a walk ahead) and
  // the warp copies the tile's K and V rows with 16-byte cp.async (zero
  // fill past the length, so P = 0 meets finite rows), the walk's queries
  // and, for int8 pools, the positions' scales. A tile's full barrier
  // completes when every lane's copies have landed.
  __device__ void produce(int r0, int r1) {
    const int lane = threadIdx.x & 31;
    const int Hkv = a.out.Hkv, G = a.out.G;
    const int64_t tok = int64_t(Hkv) * D;            // elements
    const int64_t blk = a.BS * tok;
    const int64_t layer0 = int64_t(a.layer) * a.NB * blk;
    const int64_t slayer0 = int64_t(a.layer) * a.NB * a.BS * Hkv;
    const auto* kp = static_cast<const unsigned char*>(a.k_pool);
    const auto* vp = static_cast<const unsigned char*>(a.v_pool);
    auto entries = [&](const Seg& g, int tb0) {
      return tb0 + lane < a.MB ? a.table[int64_t(g.n) * a.MB + tb0 + lane]
                               : 0;
    };
    if (r0 >= r1) return;
    Seg g = sc.seg(r0, r1);
    int tb0 = g.ta * kTile / a.BS;
    int ent = entries(g, tb0);
    int s = 0;
    for (int r = r0, k = 0; r < r1; ++k) {
      r += g.tb - g.ta;
      Seg nx{};
      int nx_tb0 = 0, nx_ent = 0;
      if (r < r1) {
        nx = sc.seg(r, r1);
        nx_tb0 = nx.ta * kTile / a.BS;
        nx_ent = entries(nx, nx_tb0);
      }
      // the walk's queries, into query buffer k % kQw
      if (k >= kQw) mbar_wait(qempty(k), ((k / kQw) - 1) & 1);
      const auto* qn = reinterpret_cast<const unsigned char*>(
          static_cast<const Q*>(a.q) + (int64_t(g.n) * Hkv + g.hk) * G * D);
      unsigned char* qs = qbuf(k);
      for (int c = lane; c < G * D * int(sizeof(Q)) / 16; c += 32)
        cp_async16(qs + c * 16, qn + c * 16, true);
      const int len = lens[g.n];
      for (int j = g.ta; j < g.tb; ++j, ++s) {
        const int slot = s % L::kStagesW;
        const int p = j * kTile + lane;
        const bool live = kCopy && p < len;
        const int pb = p / a.BS;
        if ((min(len, (j + 1) * kTile) - 1) / a.BS >= tb0 + 32) {
          tb0 = j * kTile / a.BS;
          ent = entries(g, tb0);
        }
        const int b = __shfl_sync(kFullMask, ent, live ? pb - tb0 : 0);
        const int o = p - pb * a.BS;
        const int64_t off = live ? layer0 + int64_t(b) * blk
                                       + int64_t(o) * tok + int64_t(g.hk) * D
                                 : 0;
        if (s >= L::kStagesW)
          mbar_wait(empty(slot), ((s / L::kStagesW) - 1) & 1);
        unsigned char* ks = stage(slot);
        unsigned char* vs = ks + kTile * L::kRow;
#pragma unroll 4
        for (int e = lane; e < kTile * L::kChunks; e += 32) {
          const int t = e / L::kChunks, c = e % L::kChunks;
          const int64_t ot = __shfl_sync(kFullMask, off, t);
          const bool lt = __shfl_sync(kFullMask, live, t);
          const int sm = t * L::kRow + c * 16;
          cp_async16(ks + sm, kp + (ot * L::kEl + c * 16), lt);
          cp_async16(vs + sm, vp + (ot * L::kEl + c * 16), lt);
        }
        if constexpr (kInt8) {
          float* sc4 = reinterpret_cast<float*>(vs + kTile * L::kRow);
          const int64_t soff =
              live ? slayer0 + (int64_t(b) * a.BS + o) * Hkv + g.hk : 0;
          walk::cp_async4(sc4 + lane, a.ks_pool + soff, live);
          walk::cp_async4(sc4 + kTile + lane, a.vs_pool + soff, live);
        }
        cp_async_arrive(full(slot));
      }
      g = nx;
      tb0 = nx_tb0;
      ent = nx_ent;
    }
  }

  // Q's A fragments: qa[k][0] holds k-slots (2t, 2t+1), qa[k][1] (2t+8,
  // 2t+9) of head g = lane / 4 (zero past G), in the D order the K loads
  // give (see tile()).
  __device__ void load_q(const bf16* qs, uint32_t (&qa)[KS][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    if (g >= a.out.G) {
#pragma unroll
      for (int k = 0; k < KS; ++k) qa[k][0] = qa[k][1] = 0u;
      return;
    }
    const bf16* row = qs + g * D;
    if constexpr (!kInt8) {
      // k-steps 2i and 2i+1 take elements 8(t+4i) + 0..3 and + 4..7
#pragma unroll
      for (int i = 0; i < D / 32; ++i) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + 8 * (t + 4 * i));
        qa[2 * i][0] = v.x;
        qa[2 * i][1] = v.y;
        qa[2 * i + 1][0] = v.z;
        qa[2 * i + 1][1] = v.w;
      }
    } else {
      // k-step 4i+j takes bytes d0 + (0, 2 | 1, 3), d0 = 16(t+4i) + 4j
#pragma unroll
      for (int i = 0; i < D / 64; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint2 v = *reinterpret_cast<const uint2*>(
              row + 16 * (t + 4 * i) + 4 * j);
          qa[4 * i + j][0] = __byte_perm(v.x, v.y, 0x5410);
          qa[4 * i + j][1] = __byte_perm(v.x, v.y, 0x7632);
        }
    }
  }

  // Score tile `st` (walk positions pos0 ..) into the warp's state on
  // tensor cores; the ring slot is released through `empty_bar` once read.
  __device__ void tile(const unsigned char* st, unsigned char* vbuf,
                       const uint32_t (&qa)[KS][2], int pos0, int len,
                       float& m, float& l, float (&o)[DB][4],
                       uint64_t* empty_bar) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float s[4][4];
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const unsigned char* krow = st + (nb * 8 + g) * L::kRow;
      if constexpr (!kInt8) {
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(krow + 16 * (t + 4 * i));
          mma16816(s[nb], qa[2 * i][0], qa[2 * i][1], v.x, v.y);
          mma16816(s[nb], qa[2 * i + 1][0], qa[2 * i + 1][1], v.z, v.w);
        }
      } else {
#pragma unroll
        for (int i = 0; i < D / 64; ++i) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(krow + 16 * (t + 4 * i));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma16816(s[nb], qa[4 * i + j][0], qa[4 * i + j][1],
                     widen2<false>(w[j]), widen2<true>(w[j]));
        }
      }
    }
    // scores of head g at positions nb*8 + 2t + e; the online softmax
    const float* kss =
        reinterpret_cast<const float*>(st + 2 * kTile * L::kRow);
    float tmax = kNegInf;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nb * 8 + 2 * t + e;
        float x = s[nb][e] * a.scale;
        if constexpr (kInt8) x *= kss[r];
        s[nb][e] = pos0 + r < len ? x : kNegInf;
        tmax = fmaxf(tmax, s[nb][e]);
      }
    tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(kFullMask, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float p[4][2], psum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nb * 8 + 2 * t + e;
        p[nb][e] = pos0 + r < len ? expf(s[nb][e] - m_new) : 0.f;
        psum += p[nb][e];
      }
    psum += __shfl_xor_sync(kFullMask, psum, 1);
    psum += __shfl_xor_sync(kFullMask, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      o[db][0] *= alpha;
      o[db][1] *= alpha;
    }
    // P's A fragments: k-step kk holds positions 16kk + (2t, 2t+1 | +8)
    constexpr int kTerms = kInt8 ? 3 : 1;
    uint32_t pa[2][kTerms][2];
    const unsigned char* vrows;
    int vrow;
    if constexpr (kInt8) {
      const float* vss = kss + kTile;
      float pv[4][2];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) pv[nb][e] = p[nb][e] * vss[nb * 8 + 2 * t + e];
      // V rows widened exactly to bf16 into the warp's buffer (lane = row)
      const unsigned char* v8 = st + kTile * L::kRow + lane * L::kRow;
      unsigned char* vw = vbuf + lane * L::kVRow;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(v8 + 16 * c);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t x = __byte_perm(ws[j], 0u, 0x3120);
          h[2 * j] = widen2<false>(x);
          h[2 * j + 1] = widen2<true>(x);
        }
        *reinterpret_cast<uint4*>(vw + 32 * c) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(vw + 32 * c + 16) =
            make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar);   // the ring slot is read
      // p * V-scale as hi + mid + lo bf16 terms
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x0 = pv[2 * kk + h][0], x1 = pv[2 * kk + h][1];
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const uint32_t pk = pack_bf16(x0, x1);
            pa[kk][term][h] = pk;
            const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&pk);
            x0 -= __low2float(b);
            x1 -= __high2float(b);
          }
        }
      vrows = vbuf;
      vrow = L::kVRow;
    } else {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        pa[kk][0][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        pa[kk][0][1] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      }
      vrows = st + kTile * L::kRow;
      vrow = L::kRow;
    }
    // O += P V: V's B fragments by ldmatrix.trans, two column blocks a load
    const int mi = lane >> 3;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t base = smem_u32(vrows + (16 * kk + (mi & 1) * 8 + (lane & 7))
                                                 * vrow + (mi >> 1) * 16);
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        uint32_t b[4];
        ldsm_x4_t(b, base + db * 16);
#pragma unroll
        for (int term = 0; term < kTerms; ++term) {
          mma16816(o[db], pa[kk][term][0], pa[kk][term][1], b[0], b[1]);
          mma16816(o[db + 1], pa[kk][term][0], pa[kk][term][1], b[2], b[3]);
        }
      }
    }
    if constexpr (!kInt8) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar);
    }
  }

  // ---- the pair's consumer warp: every piece of its sub-range, each
  // walked alone. A whole walk goes straight to the outputs; the sub-range's
  // first and last pieces, when parts of a longer walk, leave their state
  // in the pair's piece slots for the block's merge.
  // The block's first walk, when it began in an earlier block, is a part:
  // the pairs holding its pieces (each one's first) count in on
  // arrived[0], and the last of them combines the pieces, stores the part
  // and takes its ticket (arrived[1]: the last one) while the other pairs
  // walk on.
  __device__ void consume(const Split<kP>& sp, int* arrived) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int G = a.out.G;
    const int r0 = sp.sub(w), r1 = sp.sub(w + 1), u0 = r0;
    unsigned char* vbuf = smem + L::kOffV + w * L::kVBuf;
    int early_pairs = 0, early_end = 0, early_ws = 0;
    if (sp.r0 < sp.r1) {
      const Seg w0 = sc.seg(sp.r0, sp.r1);
      early_ws = sc.start[w0.n] + w0.hk * w0.t;
      if (early_ws < sp.r0) {   // a contributor's part
        early_end = min(early_ws + w0.t, sp.r1);
        for (int q = 0; q <= sp.pair_of(early_end - 1); ++q)
          early_pairs += sp.sub(q) < sp.sub(q + 1);
      }
    }
    int s = 0, k = 0;
    for (int r = r0; r < r1; ++k) {
      const Seg sg = sc.seg(r, r1);
      r += sg.tb - sg.ta;
      const int len = lens[sg.n];
      const int ws = sc.start[sg.n] + sg.hk * sg.t;
      // whole: straight to the outputs; else slot 0 (the walk began at or
      // before the sub-range) or 1
      const bool whole = sg.ta == 0 && sg.tb == sg.t;
      const Dest out = out_of(a.out, sg.n, sg.hk, D);
      float* pc = piece(w, ws <= u0 ? 0 : 1);
      float* acc_to = whole ? out.acc : pc;
      float* m_to = whole ? out.m : pc + kMaxGroup * D;
      float* l_to = whole ? out.l : pc + kMaxGroup * D + kMaxGroup;
      {
        float m = kNegInf, l = 0.f, o[DB][4];
#pragma unroll
        for (int db = 0; db < DB; ++db)
          o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
        uint32_t qa[KS][2];
        for (int j = sg.ta; j < sg.tb; ++j, ++s) {
          const int slot = s % L::kStagesW;
          mbar_wait(full(slot), (s / L::kStagesW) & 1);
          if (!kScore) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty(slot));
            continue;
          }
          if (j == sg.ta) load_q(reinterpret_cast<const bf16*>(qbuf(k)), qa);
          tile(stage(slot), vbuf, qa, j * kTile, len, m, l, o, empty(slot));
        }
        // head g = lane / 4, columns 8db + 2t, + 1
        if (g < G) {
#pragma unroll
          for (int db = 0; db < DB; ++db)
            *reinterpret_cast<float2*>(acc_to + g * D + db * 8 + 2 * t) =
                make_float2(o[db][0], o[db][1]);
          if (t == 0) {
            m_to[g] = m;
            l_to[g] = l;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty(k));   // the walk's queries are read
      if (k == 0 && early_pairs > 0 && ws == early_ws) {
        int last = 0;
        if (lane == 0) {
          __threadfence_block();               // this pair's piece
          last = atomicAdd(arrived, 1) == early_pairs - 1;
          __threadfence_block();               // the other pairs' pieces
        }
        if (__shfl_sync(kFullMask, last, 0)) {
          const float* pcs[kP];
          const int np = pieces_of(sp, ws, 0, sp.pair_of(early_end - 1), pcs);
          float* mine = part_at(a.out, sc, blockIdx.x, ws);
          combine(pcs, np, Dest{mine, mine + G * D, mine + G * D + G}, lane,
                  32);
          __syncwarp();                        // the part is stored
          // the last ticket: the block's merge merges the walk
          if (lane == 0)
            arrived[1] = last_ticket(a.out.flags + sg.n * a.out.Hkv + sg.hk,
                                     sc.seg(sp.r0, sp.r1).nparts);
        }
      }
    }
  }

  // pieces pcs[0 .. np) of one walk combined in pair order into `dst`, by
  // threads tid of nt: each 4 columns of one head (a head's first column's
  // thread also its m and l)
  __device__ void combine(const float* const* pcs, int np, const Dest& dst,
                          int tid, int nt) const {
    const int G = a.out.G;
    for (int e = tid * 4; e < G * D; e += nt * 4) {
      const int hg = e / D;
      float mx = kNegInf;
#pragma unroll
      for (int q = 0; q < kP; ++q)
        if (q < np) mx = fmaxf(mx, pcs[q][kMaxGroup * D + hg]);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      float ls = 0.f;
#pragma unroll
      for (int q = 0; q < kP; ++q)
        if (q < np) {
          const float wt = expf(pcs[q][kMaxGroup * D + hg] - mx);
          const float4 x = *reinterpret_cast<const float4*>(pcs[q] + e);
          v.x = fmaf(x.x, wt, v.x);
          v.y = fmaf(x.y, wt, v.y);
          v.z = fmaf(x.z, wt, v.z);
          v.w = fmaf(x.w, wt, v.w);
          ls = fmaf(pcs[q][kMaxGroup * D + kMaxGroup + hg], wt, ls);
        }
      *reinterpret_cast<float4*>(dst.acc + e) = v;
      if (e % D == 0) {
        dst.m[hg] = mx;
        dst.l[hg] = ls;
      }
    }
  }

  // the pieces of the walk starting at tile ws held by pairs wa .. wb, in
  // pair order (a pair with an empty sub-range holds none); their count
  __device__ int pieces_of(const Split<kP>& sp, int ws, int wa, int wb,
                           const float* (&pcs)[kP]) const {
    int np = 0;
    for (int q = wa; q <= wb; ++q)
      if (sp.sub(q) < sp.sub(q + 1))
        pcs[np++] = piece(q, ws <= sp.sub(q) ? 0 : 1);
    return np;
  }

  // ---- the block's merge, by the consumer threads after the pairs: each
  // walk cut by a sub-range or range boundary has its pieces combined in
  // pair order, into the outputs (whole in the block) or into the block's
  // part of the walk; a part's last ticket merges all the walk's parts
  __device__ void merge(const Split<kP>& sp, int* arrived) {
    const int tid = threadIdx.x, G = a.out.G;
    constexpr int kT = 32 * kP;                     // consumer threads
    int prev = -1;
    for (int i = 0; i <= kP; ++i) {
      const int r = i < kP ? sp.sub(i) : sp.r1 - 1;
      if (r < sp.r0 || r >= sp.r1) continue;
      const Seg W = sc.seg(r, sp.r1);
      const int id = W.n * a.out.Hkv + W.hk;
      if (id == prev) continue;
      prev = id;
      const int ws = sc.start[W.n] + W.hk * W.t, we = ws + W.t;
      const int lo = max(ws, sp.r0), hi = min(we, sp.r1);
      const int wa = sp.pair_of(lo), wb = sp.pair_of(hi - 1);
      if (wa == wb && ws >= sp.sub(wa) && we <= sp.sub(wa + 1))
        continue;   // whole in one pair: already in the outputs
      // the block's piece of W: whole in the block (to the outputs), or a
      // part: the block's first walk (stored and ticketed by the pairs) or
      // its last (stored and ticketed here); the last ticket merges
      const Seg part = sc.seg(lo, sp.r1);
      const float* pcs[kP];
      const int np = pieces_of(sp, ws, wa, wb, pcs);
      if (part.nparts == 1) {
        combine(pcs, np, out_of(a.out, W.n, W.hk, D), tid, kT);
        continue;
      }
      if (ws < sp.r0) {
        if (!arrived[1]) continue;
      } else {
        float* mine = part_at(a.out, sc, blockIdx.x, ws);
        combine(pcs, np, Dest{mine, mine + G * D, mine + G * D + G}, tid, kT);
        ConsumerSync::sync();                       // the part is stored
        if (tid == 0)
          arrived[2] = last_ticket(a.out.flags + id, part.nparts);
        ConsumerSync::sync();
        if (!arrived[2]) continue;
      }
      for (int e = tid * 4; e < G * D; e += kT * 4)
        merge_parts<D, 4>(a.out, sc, part, e / D, e % D);
    }
  }
};

template <typename Q, typename P, int D>
__global__ void __launch_bounds__(Lay<Q, P, D>::kThreads, 1)
ragged_decode_kernel(const __grid_constant__ Args a) {
  using L = Lay<Q, P, D>;
  constexpr int kP = L::kP;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  int* start = reinterpret_cast<int*>(smem + L::kOffSched);
  int* lens = start + a.out.N + 1;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kP * L::kStagesW; ++i) {
      mbar_init(&bars[i], 32);                     // full: a lane's copies
      mbar_init(&bars[kP * L::kStagesW + i], 1);   // empty: the consumer
    }
    for (int i = 0; i < kP * kQw; ++i)
      mbar_init(&bars[2 * kP * L::kStagesW + i], 1);   // queries read
    int* arrived = reinterpret_cast<int*>(smem + L::kOffArrived);
    arrived[0] = arrived[1] = 0;
  }
  build_sched(a.lengths, a.out.N, a.MB * a.BS, a.out.Hkv, kTile, start, lens);
  const Sched sc(start, a.out.N, a.out.Hkv, gridDim.x);
  const int r0 = blockIdx.x * sc.per;
  const Split<kP> sp{r0, min(start[a.out.N], r0 + sc.per)};
  const int warp = threadIdx.x >> 5;
  const int w = warp % kP;                // consumers 0 .., producers kP ..
  Walker<Q, P, D> wk{a, smem, sc, lens, bars, w};
  if (warp >= kP) {
    wk.produce(sp.sub(w), sp.sub(w + 1));
    return;
  }
  wk.consume(sp, reinterpret_cast<int*>(smem + L::kOffArrived));
  named_sync(kSyncId, 32 * kP);           // every piece's state written
  if (sp.r0 < sp.r1)
    wk.merge(sp, reinterpret_cast<int*>(smem + L::kOffArrived));
}

// ---------------------------------------------------------------------------
// f32 queries (f32 pools, or int8 pools): the CUDA-core walk of
// ragged_walk.cuh (shared with B5 and B6: one warp a query head, 64
// positions a stage, two stages) over each piece of the block's range, on
// the same schedule (in 64-position tiles) and the same parts protocol
// ---------------------------------------------------------------------------
template <typename P, int D>
struct WalkLay {
  static constexpr int kThreads = 32 * kMaxGroup;
  static constexpr int kOffLast = walk::Layout<P, D>::kSmem;   // a ticket
  static constexpr int kOffSched = kOffLast + 16;
  static constexpr int kSmem = kOffSched;   // + the schedule, (2N + 1) ints
};

template <typename P, int D>
__global__ void __launch_bounds__(WalkLay<P, D>::kThreads)
ragged_decode_walk(const __grid_constant__ Args a) {
  using L = WalkLay<P, D>;
  constexpr int DC = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(
      smem + walk::kStages * walk::Layout<P, D>::kStageBytes);
  int* start = reinterpret_cast<int*>(smem + L::kOffSched);
  int* lens = start + a.out.N + 1;
  const int Hkv = a.out.Hkv, G = a.out.G;
  build_sched(a.lengths, a.out.N, a.MB * a.BS, Hkv, walk::kTile, start,
              lens);
  const Sched sc(start, a.out.N, Hkv, gridDim.x);
  const int r0 = blockIdx.x * sc.per;
  const int r1 = min(start[a.out.N], r0 + sc.per);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = r0; r < r1;) {
    const Seg sg = sc.seg(r, r1);
    r += sg.tb - sg.ta;
    const float* qn = static_cast<const float*>(a.q)
                      + (int64_t(sg.n) * Hkv + sg.hk) * G * D;
    for (int e = tid; e < G * D; e += blockDim.x) Qs[e] = qn[e];
    __syncthreads();
    const int len = lens[sg.n];
    float m, l, acc[DC];
    walk::ragged_walk<P, D>(
        static_cast<const P*>(a.k_pool), static_cast<const P*>(a.v_pool),
        a.ks_pool, a.vs_pool, a.table + int64_t(sg.n) * a.MB,
        min(len, sg.ta * walk::kTile), min(len, sg.tb * walk::kTile),
        a.layer, a.NB,
        a.BS, Hkv, sg.hk, G, a.scale, smem, m, l, acc);
    // warp g < G holds head g: columns lane*DC .., m and l: to the
    // outputs, or the block's part of the walk and its ticket
    const int ws = sc.start[sg.n] + sg.hk * sg.t;
    float* mine = part_at(a.out, sc, blockIdx.x, ws);
    const Dest dst = sg.nparts == 1 ? out_of(a.out, sg.n, sg.hk, D)
                                    : Dest{mine, mine + G * D, mine + G * D + G};
    if (warp < G) {
#pragma unroll
      for (int c = 0; c < DC; ++c) dst.acc[warp * D + lane * DC + c] = acc[c];
      if (lane == 0) {
        dst.m[warp] = m;
        dst.l[warp] = l;
      }
    }
    if (sg.nparts > 1) {
      int* last = reinterpret_cast<int*>(smem + L::kOffLast);
      __syncthreads();                            // the part is stored
      if (tid == 0)
        *last = last_ticket(a.out.flags + sg.n * Hkv + sg.hk, sg.nparts);
      __syncthreads();
      if (*last && warp < G)                      // the last ticket merges
        merge_parts<D, DC>(a.out, sc, sg, warp, lane * DC);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side: one-time set-up per kernel and device, the launch
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 16;
using Kernel = void (*)(const Args);

// One form's kernel, its block, its shared memory without the schedule,
// and its per-device grid (0 until set up).
struct Form {
  Kernel kernel;
  int threads, smem;
  int* grid;
};

// kId: the form's number, for its own grid cache
template <int kId>
Form form(Kernel k, int threads, int smem) {
  static int grid[kMaxDevices] = {};
  return Form{k, threads, smem, grid};
}

template <int kId, typename Q, typename P, int D>
Form form() {
  return form<kId>(ragged_decode_kernel<Q, P, D>, Lay<Q, P, D>::kThreads,
                   Lay<Q, P, D>::kSmem);
}

template <int kId, typename P, int D>
Form walk_form() {
  return form<kId>(ragged_decode_walk<P, D>, WalkLay<P, D>::kThreads,
                   WalkLay<P, D>::kSmem);
}

// the form of (dtype, pool_dtype, D); false for one the kernel lacks
bool find_form(int dtype, int pool_dtype, int D, Form& f) {
  const bool i8 = pool_dtype == kPoolInt8;
  if ((pool_dtype != dtype && !i8) || (D != 64 && D != 128)) return false;
  if (dtype == kBF16) {
    if (D == 128)
      f = i8 ? form<0, bf16, int8_t, 128>() : form<1, bf16, bf16, 128>();
    else
      f = i8 ? form<2, bf16, int8_t, 64>() : form<3, bf16, bf16, 64>();
    return true;
  }
  if (dtype == kF32) {
    if (D == 128)
      f = i8 ? walk_form<4, int8_t, 128>() : walk_form<5, float, 128>();
    else
      f = i8 ? walk_form<6, int8_t, 64>() : walk_form<7, float, 64>();
    return true;
  }
  return false;
}

// the form's persistent grid on the current device: every SM's resident
// blocks at the base shared memory (4 KB left for the schedule), at most
// kMaxParts; the first call also sets the dynamic shared-memory attribute
int grid_for(const Form& f) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 0;
  if (f.grid[dev] == 0) {
    if (cudaFuncSetAttribute(f.kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sm90::kMaxSmem) != cudaSuccess)
      return 0;
    int sms = 0, per = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, f.kernel, f.threads, f.smem + 4096) != cudaSuccess ||
        per < 1)
      return 0;
    f.grid[dev] = min(sms * per, kMaxParts);
  }
  return f.grid[dev];
}

}  // namespace
}  // namespace ragged
}  // namespace ptt

using namespace ptt;

// The persistent grid of a form (dtype: the queries', 0 = f32, 1 = bf16;
// pool_dtype: the queries' or 2 = int8), 0 for a form the kernel lacks.
// Sets the form's kernel up on the current device on first use; the
// wrapper sizes the scratch with it: two parts a block, 2 * grid *
// pstride floats, pstride = G * (D + 2) rounded up to a multiple of 4.
extern "C" int ptt_ragged_decode_grid(int dtype, int pool_dtype, int D) {
  ragged::Form f;
  return ragged::find_form(dtype, pool_dtype, D, f) ? ragged::grid_for(f) : 0;
}

// The walk tiles of each block, as the kernel deals them: rows of (block,
// slot, kv head, first tile, end tile, walk tiles, parts of the walk) for
// `lengths` (host memory) at tile size `tile` (the kernel's: 32 for bf16
// queries, 64 for f32) and grid `grid`. Writes at most `cap` rows and returns their number.
extern "C" int ptt_ragged_decode_schedule(const int* lengths, int N, int Hkv,
                                          int MB, int BS, int tile, int grid,
                                          int* rows, int cap) {
  int* start = new int[N + 1];
  start[0] = 0;
  for (int n = 0; n < N; ++n) {
    const int len = lengths[n] < 0 ? 0 : min(lengths[n], MB * BS);
    start[n + 1] = start[n] + Hkv * ragged::walk_tiles(len, tile);
  }
  const ragged::Sched sc(start, N, Hkv, grid);
  int count = 0;
  for (int b = 0; b < grid; ++b) {
    const int r1 = min(start[N], (b + 1) * sc.per);
    for (int r = b * sc.per; r < r1;) {
      const ragged::Seg s = sc.seg(r, r1);
      r += s.tb - s.ta;
      if (count < cap) {
        int* o = rows + 7 * count;
        o[0] = b;
        o[1] = s.n;
        o[2] = s.hk;
        o[3] = s.ta;
        o[4] = s.tb;
        o[5] = s.t;
        o[6] = s.nparts;
      }
      ++count;
    }
  }
  delete[] start;
  return count;
}

// q [N, Hkv*G, D] (dtype), pools [L, NB, BS, Hkv, D] (pool_dtype; int8
// with ks_pool/vs_pool, their [L, NB, BS, Hkv] f32 scales); `out` holds
// acc [N, Hkv, G, D], m [N, Hkv, G] and l [N, Hkv, G] back to back;
// `scratch` (16-byte aligned) as ptt_ragged_decode_grid says, `flags`
// [N * Hkv] int32, zero (left zero). D must be 64 or 128, 1 <= G <= 8 and
// N <= 511 (the wrapper checks). One launch.
extern "C" int ptt_ragged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const float* ks_pool,
                                 const float* vs_pool, const int* table,
                                 const int* lengths, float* out,
                                 float* scratch, int* flags, int N, int layer,
                                 int NB, int BS, int Hkv, int G, int D, int MB,
                                 int dtype, int pool_dtype, float scale,
                                 void* stream) {
  if (G < 1 || G > ragged::kMaxGroup || N < 1) return cudaErrorInvalidValue;
  if (pool_dtype == kPoolInt8 && (ks_pool == nullptr || vs_pool == nullptr))
    return cudaErrorInvalidValue;
  const ragged::Args a{q, k_pool, v_pool, ks_pool, vs_pool, table, lengths,
                       ragged::Out{out, scratch, flags, N, Hkv, G,
                                   (G * (D + 2) + 3) / 4 * 4},
                       layer, NB, BS, MB, scale};
  ragged::Form f;
  if (!ragged::find_form(dtype, pool_dtype, D, f)) return cudaErrorInvalidValue;
  const int grid = ragged::grid_for(f);
  if (grid == 0) return cudaErrorInvalidConfiguration;
  f.kernel<<<grid, f.threads, f.smem + (2 * N + 1) * int(sizeof(int)),
             static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
