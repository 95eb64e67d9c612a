// The split walk shared by the ragged decode kernel (ragged_decode.cu, B4)
// and the paged decode attention kernel (paged_decode.cu, B6): how the
// (slot, kv head) walks are dealt to a persistent grid, the walk's inputs,
// the shared-memory layout of a block's producer-consumer warp pairs, the
// producer warp, the tensor-core pieces of a tile (Q's fragments, S = Q
// K^T, O += P V on mma.sync m16n8k16), the parts of walks cut by block
// ranges and their tickets, and the CUDA-core walk of f32 queries on the
// same schedule.
//
// The schedule (`Sched`): each walk is a run of 32-position tiles (64 for
// f32 queries), the walks lie end to end in (slot, kv head) order, and the
// grid's blocks (one an SM) take equal ranges of that line, computed on
// the device from the lengths. A range cuts a walk into parts on tile
// boundaries, so one long slot spreads over every SM and a block may
// finish many short walks. Inside a block four producer-consumer warp
// pairs each walk a quarter of the range: the producer copies each tile's
// K (and V) rows with 16-byte cp.async into its ring (zero fill past the
// length), plus the walk's queries; a ring slot's full barrier completes
// when the copies land (cp.async.mbarrier.arrive).
//
// A tensor-parallel rank's launch (B4's tp form) holds kv heads [h0, h0 +
// Hkv) of Hs: it deals the whole launch's schedule (every head's walks)
// and walks only its own heads' pieces, so each of its walks is cut into
// the same parts as in the whole launch and merges to the same bits.
//
// A walk cut by block ranges leaves one part in each block it crosses, in
// the block's scratch slot (0 when the walk reaches the block's first
// tile, else 1: only a block's first and last walks can be parts). Each
// block stores its part and takes a ticket on the walk's flag; the block
// that takes the last ticket merges every part in part order (so the
// result does not depend on which block merges) and sets the flag back to
// 0 for the next call. No block ever waits for another.
//
// Everything stays in an anonymous namespace (see hopper.cuh).
#pragma once

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
// The split schedule, shared by the kernels and the host export
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

  // the first tile of the walk of `s`
  __host__ __device__ int walk_start(const Seg& s) const {
    return start[s.n] + s.hk * s.t;
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
// The walks' inputs, and the parts of walks cut by block ranges
// ---------------------------------------------------------------------------
struct Walks {
  const void* q;                    // [N, Hkv*G, D]
  const void *k_pool, *v_pool;      // [L, NB, BS, Hkv, D]
  const float *ks_pool, *vs_pool;   // [L, NB, BS, Hkv] (int8 pools)
  const int* table;                 // [N, MB]
  const int* lengths;               // [N]
  int N, Hkv, G, layer, NB, BS, MB;
  float scale;                      // the softmax scale, 1 / sqrt(D)
  // the schedule's kv heads: Hs of which this launch holds [h0, h0 + Hkv)
  // (a tensor-parallel rank's slice); Hs 0 is Hkv (the whole launch)
  int Hs = 0, h0 = 0;

  __host__ __device__ int heads() const { return Hs > 0 ? Hs : Hkv; }
  // this launch's index of the schedule's head hk, -1 for another's
  __host__ __device__ int local(int hk) const {
    const int h = hk - h0;
    return h >= 0 && h < Hkv ? h : -1;
  }
};

// The parts' scratch: [grid, 2, pstride] floats, a part's acc [G][D], m
// [G] and l [G]; the walks' flags [N * Hkv], zero between calls.
struct Parts {
  float* scratch;
  int* flags;
  int pstride;
};

// The part of the walk starting at tile ws held by block b.
__device__ __forceinline__ float* part_at(const Parts& p, const Sched& sc,
                                          int b, int ws) {
  return p.scratch + int64_t(2 * b + sc.scratch_slot(b, ws)) * p.pstride;
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

// Columns [c, c + kC) of head g of walk `s` (G heads) merged from its
// parts in part order into r, its maximum into mx and its sum into ls:
// kBatch parts' loads in flight, each batch raising the running maximum
// and rescaling the sums. Without kRescale the parts share one maximum
// (B6's walks, against the walk's global maximum) and just add.
template <int D, int kC, bool kRescale = true>
__device__ void merge_parts(const Parts& pt, const Sched& sc, const Seg& s,
                            int G, int g, int c, float (&r)[kC], float& mx,
                            float& ls) {
  const int ws = sc.walk_start(s);
  constexpr int kBatch = 8;
  mx = kNegInf;
  ls = 0.f;
#pragma unroll
  for (int i = 0; i < kC; ++i) r[i] = 0.f;
  for (int q0 = 0; q0 < s.nparts; q0 += kBatch) {
    float mq[kBatch], lq[kBatch], v[kBatch][kC];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      mq[q] = kNegInf;
      if (q0 + q < s.nparts) {
        const float* p = part_at(pt, sc, s.b0 + q0 + q, ws);
        if constexpr (kRescale) mq[q] = __ldcg(p + G * D + g);
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
    if constexpr (kRescale) {
      float mb = mx;
#pragma unroll
      for (int q = 0; q < kBatch; ++q) mb = fmaxf(mb, mq[q]);
      const float sc0 = expf(mx - mb);
#pragma unroll
      for (int i = 0; i < kC; ++i) r[i] *= sc0;
      ls *= sc0;
      mx = mb;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      if (q0 + q < s.nparts) {
        if constexpr (kRescale) {
          const float w = expf(mq[q] - mx);
#pragma unroll
          for (int i = 0; i < kC; ++i) r[i] = fmaf(v[q][i], w, r[i]);
          ls = fmaf(lq[q], w, ls);
        } else {
#pragma unroll
          for (int i = 0; i < kC; ++i) r[i] += v[q][i];
          ls += lq[q];
        }
      }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core walk's pieces (bf16 queries; bf16 or int8 pools)
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

// Q: the queries' type (bf16); P: the pools' (Q, or int8_t with scale
// pools); kKV: a tile stages K and V rows (B6's max pass: K rows only); W:
// floats of a piece's state in shared memory.
template <typename Q, typename P, int D, bool kKV = true,
          int W = kMaxGroup * D + 2 * kMaxGroup>
struct Lay {
  static_assert(std::is_same<Q, bf16>::value, "tensor cores take bf16");
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  static_assert(kKV || !kInt8, "a K-only tile stages no scales");
  static constexpr int kEl = int(sizeof(P));
  static constexpr int kRow = D * kEl + 16;           // padded row bytes
  static constexpr int kChunks = D * kEl / 16;        // 16-byte copies a row
  static constexpr int kStage = (kKV ? 2 : 1) * kTile * kRow
                                + (kInt8 ? 2 * kTile * 4 : 0);
  static constexpr int kQ = kMaxGroup * D * int(sizeof(Q));   // a walk's
  static constexpr int kVRow = D * 2 + 16;            // widened V rows
  static constexpr int kVBuf = kInt8 ? kTile * kVRow : 0;   // a pair's
  static constexpr int kW = W;                        // a piece's state
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

// The prologue of a pairs kernel: the barriers (thread 0), the schedule
// and the clamped lengths in shared memory, the block's range.
template <class L>
__device__ __forceinline__ Split<L::kP> pairs_prologue(const Walks& a, unsigned char* smem,
                                       int*& start, int*& lens) {
  constexpr int kP = L::kP;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  start = reinterpret_cast<int*>(smem + L::kOffSched);
  lens = start + a.N + 1;
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
  build_sched(a.lengths, a.N, a.MB * a.BS, a.heads(), kTile, start, lens);
  const int per = Sched(start, a.N, a.heads(), gridDim.x).per;
  const int r0 = blockIdx.x * per;
  return Split<kP>{r0, min(start[a.N], r0 + per)};
}

// One producer-consumer pair of a block: its ring, query buffers and
// barriers, the producer warp's copies, and the consumer warp's tensor-core
// pieces of a tile.
template <typename Q, typename P, int D, bool kKV = true,
          int W = kMaxGroup * D + 2 * kMaxGroup>
struct Pair {
  using L = Lay<Q, P, D, kKV, W>;
  static constexpr bool kInt8 = L::kInt8;
  static constexpr int KS = D / 16;     // k-steps of Q K^T
  static constexpr int DB = D / 8;      // column blocks of O
  static constexpr int kP = L::kP;

  const Walks& a;
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
           + (pw * 2 + first_or_last) * L::kW;
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

  // ---- the pair's producer warp: every tile of its sub-range, in order.
  // Lane i finds position i of a tile (one division a tile, the block ids
  // from 32 table entries a load, the next walk's read a walk ahead) and
  // the warp copies the tile's K (and V) rows with 16-byte cp.async (zero
  // fill past the length, so P = 0 meets finite rows), the walk's queries
  // and, for int8 pools, the positions' scales. A tile's full barrier
  // completes when every lane's copies have landed.
  __device__ void produce(int r0, int r1) {
    const int lane = threadIdx.x & 31;
    const int Hkv = a.Hkv, G = a.G;
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
    for (int r = r0, k = 0; r < r1;) {
      r += g.tb - g.ta;
      Seg nx{};
      int nx_tb0 = 0, nx_ent = 0;
      if (r < r1) {
        nx = sc.seg(r, r1);
        nx_tb0 = nx.ta * kTile / a.BS;
        nx_ent = entries(nx, nx_tb0);
      }
      const int hl = a.local(g.hk);   // another launch's head: not walked
      if (hl < 0) {
        g = nx;
        tb0 = nx_tb0;
        ent = nx_ent;
        continue;
      }
      // the walk's queries, into query buffer k % kQw
      if (k >= kQw) mbar_wait(qempty(k), ((k / kQw) - 1) & 1);
      const auto* qn = reinterpret_cast<const unsigned char*>(
          static_cast<const Q*>(a.q) + (int64_t(g.n) * Hkv + hl) * G * D);
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
                                       + int64_t(o) * tok + int64_t(hl) * D
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
          if constexpr (kKV)
            cp_async16(vs + sm, vp + (ot * L::kEl + c * 16), lt);
        }
        if constexpr (kInt8) {
          float* sc4 = reinterpret_cast<float*>(vs + kTile * L::kRow);
          const int64_t soff =
              live ? slayer0 + (int64_t(b) * a.BS + o) * Hkv + hl : 0;
          walk::cp_async4(sc4 + lane, a.ks_pool + soff, live);
          walk::cp_async4(sc4 + kTile + lane, a.vs_pool + soff, live);
        }
        cp_async_arrive(full(slot));
      }
      g = nx;
      tb0 = nx_tb0;
      ent = nx_ent;
      ++k;
    }
  }

  // Q's A fragments: qa[k][0] holds k-slots (2t, 2t+1), qa[k][1] (2t+8,
  // 2t+9) of head g = lane / 4 (zero past G), in the D order the K loads
  // give (see score()).
  __device__ void load_q(const bf16* qs, uint32_t (&qa)[KS][2]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    if (g >= a.G) {
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

  // S = Q K^T of the tile in ring slot `st` on tensor cores: s[nb][e] is
  // head g = lane / 4 at position nb*8 + 2t + e (e < 2; e >= 2 are the
  // zero rows 8-15). Q and K share a permuted order of D inside each mma,
  // so a lane reads 16 contiguous bytes of a K row.
  __device__ void score(const unsigned char* st, const uint32_t (&qa)[KS][2],
                        float (&s)[4][4]) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
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
          const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma16816(s[nb], qa[4 * i + j][0], qa[4 * i + j][1],
                     widen2<false>(w4[j]), widen2<true>(w4[j]));
        }
      }
    }
  }

  // O += P V: P's A fragments pa[kk][term] (k-step kk holds positions
  // 16kk + (2t, 2t+1 | +8); kTerms bf16 terms summed), V's B fragments by
  // ldmatrix.trans from rows of `vrow` bytes, two column blocks a load
  template <int kTerms>
  __device__ void pv(const unsigned char* vrows, int vrow,
                     const uint32_t (&pa)[2][kTerms][2],
                     float (&o)[DB][4]) const {
    const int lane = threadIdx.x & 31;
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
  }
};

// The walks a block's merge visits, in order: each walk of this launch's
// heads (`a.local`) that a sub-range or range boundary cuts, once.
// `visit(W, lo, hi, wa, wb)` gets the walk (its piece from its first tile
// in the block), the block's tiles of it [lo, hi) and the pairs wa .. wb
// holding them; a walk whole in one pair is not visited.
template <int kP, class Visit>
__device__ void cut_walks(const Sched& sc, const Split<kP>& sp,
                          const Walks& a, Visit visit) {
  int prev = -1;
  for (int i = 0; i <= kP; ++i) {
    const int r = i < kP ? sp.sub(i) : sp.r1 - 1;
    if (r < sp.r0 || r >= sp.r1) continue;
    const Seg W = sc.seg(r, sp.r1);
    const int id = W.n * a.heads() + W.hk;
    if (id == prev) continue;
    prev = id;
    if (a.local(W.hk) < 0) continue;
    const int ws = sc.walk_start(W), we = ws + W.t;
    const int lo = max(ws, sp.r0), hi = min(we, sp.r1);
    const int wa = sp.pair_of(lo), wb = sp.pair_of(hi - 1);
    if (wa == wb && ws >= sp.sub(wa) && we <= sp.sub(wa + 1))
      continue;   // whole in one pair: already in the outputs
    visit(sc.seg(lo, sp.r1), lo, hi, wa, wb);
  }
}

// ---------------------------------------------------------------------------
// f32 queries (f32 pools, or int8 pools): the CUDA-core walk of
// ragged_walk.cuh (shared with B5: one warp a query head, 64 positions a
// stage, two stages) over each piece of the block's range, on the same
// schedule (in 64-position tiles) and the same parts protocol
// ---------------------------------------------------------------------------
template <typename P, int D>
struct WalkLay {
  static constexpr int kThreads = 32 * kMaxGroup;
  static constexpr int kOffLast = walk::Layout<P, D>::kSmem;   // a ticket
  static constexpr int kOffSched = kOffLast + 16;
  static constexpr int kSmem = kOffSched;   // + the schedule, (2N + 1) ints
};

// The walk of every piece of this block's range: warp g < G ends a piece
// with head g's state (columns lane*DC .., m, l) and hands a walk's final
// state to `a.emit<D, DC>(n, hk, g, c, r, m, l)`: at once for a walk whole
// in the block, else after the block's part is stored and ticketed, by
// the block with the last ticket, merged from every part in part order.
// (`a` by value: the kernel's parameters, read where they are used)
template <typename P, int D, class A>
__device__ __forceinline__ void walk_split(const A a, unsigned char* smem) {
  using L = WalkLay<P, D>;
  constexpr int DC = D / 32;
  float* Qs = reinterpret_cast<float*>(
      smem + walk::kStages * walk::Layout<P, D>::kStageBytes);
  int* start = reinterpret_cast<int*>(smem + L::kOffSched);
  int* lens = start + a.N + 1;
  const int Hkv = a.Hkv, G = a.G;
  build_sched(a.lengths, a.N, a.MB * a.BS, a.heads(), walk::kTile, start,
              lens);
  const Sched sc(start, a.N, a.heads(), gridDim.x);
  const int r0 = blockIdx.x * sc.per;
  const int r1 = min(start[a.N], r0 + sc.per);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int r = r0; r < r1;) {
    const Seg sg = sc.seg(r, r1);
    r += sg.tb - sg.ta;
    const int hl = a.local(sg.hk);   // another launch's head: not walked
    if (hl < 0) continue;
    const float* qn = static_cast<const float*>(a.q)
                      + (int64_t(sg.n) * Hkv + hl) * G * D;
    for (int e = tid; e < G * D; e += blockDim.x) Qs[e] = qn[e];
    __syncthreads();
    const int len = lens[sg.n];
    float m, l, acc[DC];
    walk::ragged_walk<P, D>(
        static_cast<const P*>(a.k_pool), static_cast<const P*>(a.v_pool),
        a.ks_pool, a.vs_pool, a.table + int64_t(sg.n) * a.MB,
        min(len, sg.ta * walk::kTile), min(len, sg.tb * walk::kTile),
        a.layer, a.NB, a.BS, Hkv, hl, G, a.scale, smem, m, l, acc);
    // warp g < G holds head g: to the outputs, or the block's part of the
    // walk and its ticket
    if (sg.nparts == 1) {
      if (warp < G) a.template emit<D, DC>(sg.n, hl, warp, lane * DC, acc, m, l);
    } else {
      float* mine = part_at(a.parts, sc, blockIdx.x, sc.walk_start(sg));
      if (warp < G) {
#pragma unroll
        for (int c = 0; c < DC; ++c) mine[warp * D + lane * DC + c] = acc[c];
        if (lane == 0) {
          mine[G * D + warp] = m;
          mine[G * D + G + warp] = l;
        }
      }
      int* last = reinterpret_cast<int*>(smem + L::kOffLast);
      __syncthreads();                            // the part is stored
      if (tid == 0)
        *last = last_ticket(a.parts.flags + sg.n * Hkv + hl, sg.nparts);
      __syncthreads();
      if (*last && warp < G) {                    // the last ticket merges
        float rr[DC], mx, ls;
        merge_parts<D, DC>(a.parts, sc, sg, G, warp, lane * DC, rr, mx, ls);
        a.template emit<D, DC>(sg.n, hl, warp, lane * DC, rr, mx, ls);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// host side: one-time set-up per kernel and device
// ---------------------------------------------------------------------------
constexpr int kMaxDevices = 16;

// One form's kernel, its block, its shared memory without the schedule,
// and its per-device grid (0 until set up).
template <class K>
struct Form {
  K kernel;
  int threads, smem;
  int* grid;
};

// kId: the form's number, for its own grid cache
template <int kId, class K>
Form<K> form(K k, int threads, int smem) {
  static int grid[kMaxDevices] = {};
  return Form<K>{k, threads, smem, grid};
}

// the form's persistent grid on the current device: every SM's resident
// blocks at the base shared memory (4 KB left for the schedule), at most
// kMaxParts; the first call also sets the dynamic shared-memory attribute
template <class K>
int grid_for(const Form<K>& f) {
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
