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
// per-position scales), on the split walk of ragged_split.cuh (shared with
// B6):
//
// - Split-K on a persistent grid (`Sched`): the walks' 32-position tiles
//   dealt in equal ranges, so one long slot spreads over every SM, and a
//   block may finish many short walks.
// - Inside a block, four producer-consumer warp pairs each walk a quarter
//   of the range on their own (`Pair`: cp.async rings with mbarrier
//   arrival, 2-3 tiles in flight). The consumer warp scores on tensor
//   cores (mma.sync m16n8k16, bf16 in, f32 sums): S = Q K^T with the
//   group's G query heads as the rows (zero past G), 8 positions a column
//   block, then the online softmax, then O += P V with V's fragments by
//   ldmatrix.trans.
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
// 64-position tiles, and the same parts (`walk_split`).
//
// The launch path: the dynamic shared-memory attribute and the grid are
// set up once per form and device (`ptt_ragged_decode_grid`); the wrapper
// allocates acc, m and l in one buffer and keeps the flags and the parts'
// scratch per stream.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "ragged_split.cuh"
#include "ragged_walk.cuh"

namespace ptt {
namespace ragged {
namespace {

// The walks and B4's outputs: acc [N, Hkv, G, D], then m and l [N, Hkv, G]
// (f32), and the parts of walks cut by block ranges.
struct Args : Walks {
  float* acc;
  Parts parts;

  // the outputs of walk (n, hk): acc [G][D], m and l [G]
  __device__ float* acc_of(int n, int hk, int D) const {
    return acc + int64_t((n * Hkv + hk) * G) * D;
  }
  __device__ float* m_of(int n, int hk, int D) const {
    return acc + int64_t(N * Hkv * G) * D + (n * Hkv + hk) * G;
  }
  __device__ float* l_of(int n, int hk, int D) const {
    return m_of(n, hk, D) + N * Hkv * G;
  }
  // head g's columns [c, c + kC) of walk (n, hk) (the first column's
  // thread also writes m and l)
  template <int D, int kC>
  __device__ void emit(int n, int hk, int g, int c, const float (&r)[kC],
                       float m, float l) const {
#pragma unroll
    for (int i = 0; i < kC; ++i) acc_of(n, hk, D)[g * D + c + i] = r[i];
    if (c == 0) {
      m_of(n, hk, D)[g] = m;
      l_of(n, hk, D)[g] = l;
    }
  }
};

// ---------------------------------------------------------------------------
// The tensor-core walk (bf16 queries; bf16 or int8 pools)
// ---------------------------------------------------------------------------
template <typename Q, typename P, int D>
struct Walker : Pair<Q, P, D> {
  using B = Pair<Q, P, D>;
  using L = typename B::L;
  using B::empty;
  using B::full;
  using B::lens;
  using B::piece;
  using B::pieces_of;
  using B::qbuf;
  using B::qempty;
  using B::sc;
  using B::smem;
  using B::stage;
  using B::w;
  static constexpr bool kInt8 = L::kInt8;
  static constexpr int KS = B::KS;
  static constexpr int DB = B::DB;
  static constexpr int kP = L::kP;

  struct ConsumerSync {
    __device__ static void sync() { named_sync(kSyncId, 32 * kP); }
  };

  const Args& args;

  // Score tile `st` (walk positions pos0 ..) into the warp's state on
  // tensor cores; the ring slot is released through `empty_bar` once read.
  __device__ void tile(const unsigned char* st, unsigned char* vbuf,
                       const uint32_t (&qa)[KS][2], int pos0, int len,
                       float& m, float& l, float (&o)[DB][4],
                       uint64_t* empty_bar) const {
    const int lane = threadIdx.x & 31, t = lane & 3;
    float s[4][4];
    B::score(st, qa, s);
    // scores of head g at positions nb*8 + 2t + e; the online softmax
    const float* kss =
        reinterpret_cast<const float*>(st + 2 * kTile * L::kRow);
    float tmax = kNegInf;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nb * 8 + 2 * t + e;
        float x = s[nb][e] * args.scale;
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
        const uint4 wv = *reinterpret_cast<const uint4*>(v8 + 16 * c);
        const uint32_t ws[4] = {wv.x, wv.y, wv.z, wv.w};
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
    B::template pv<kTerms>(vrows, vrow, pa, o);
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
    const int G = args.G;
    const int r0 = sp.sub(w), r1 = sp.sub(w + 1), u0 = r0;
    unsigned char* vbuf = smem + L::kOffV + w * L::kVBuf;
    int early_pairs = 0, early_end = 0, early_ws = 0;
    if (sp.r0 < sp.r1) {
      const Seg w0 = sc.seg(sp.r0, sp.r1);
      early_ws = sc.walk_start(w0);
      // a contributor's part (of a walk of this launch's heads)
      if (early_ws < sp.r0 && args.local(w0.hk) >= 0) {
        early_end = min(early_ws + w0.t, sp.r1);
        for (int q = 0; q <= sp.pair_of(early_end - 1); ++q)
          early_pairs += sp.sub(q) < sp.sub(q + 1);
      }
    }
    int s = 0, k = 0;
    for (int r = r0; r < r1;) {
      const Seg sg = sc.seg(r, r1);
      r += sg.tb - sg.ta;
      const int hl = args.local(sg.hk);   // another launch's head
      if (hl < 0) continue;
      const int len = lens[sg.n];
      const int ws = sc.walk_start(sg);
      // whole: straight to the outputs; else slot 0 (the walk began at or
      // before the sub-range) or 1
      const bool whole = sg.ta == 0 && sg.tb == sg.t;
      float* pc = piece(w, ws <= u0 ? 0 : 1);
      float* acc_to = whole ? args.acc_of(sg.n, hl, D) : pc;
      float* m_to = whole ? args.m_of(sg.n, hl, D) : pc + kMaxGroup * D;
      float* l_to = whole ? args.l_of(sg.n, hl, D)
                          : pc + kMaxGroup * D + kMaxGroup;
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
          if (j == sg.ta) B::load_q(reinterpret_cast<const bf16*>(qbuf(k)), qa);
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
          float* mine = part_at(args.parts, sc, blockIdx.x, ws);
          combine(pcs, np, mine, mine + G * D, mine + G * D + G, lane, 32);
          __syncwarp();                        // the part is stored
          // the last ticket: the block's merge merges the walk
          if (lane == 0)
            arrived[1] = last_ticket(
                args.parts.flags + sg.n * args.Hkv + hl,
                sc.seg(sp.r0, sp.r1).nparts);
        }
      }
      ++k;
    }
  }

  // pieces pcs[0 .. np) of one walk combined in pair order into acc, m and
  // l, by threads tid of nt: each 4 columns of one head (a head's first
  // column's thread also its m and l)
  __device__ void combine(const float* const* pcs, int np, float* acc,
                          float* m, float* l, int tid, int nt) const {
    const int G = args.G;
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
      *reinterpret_cast<float4*>(acc + e) = v;
      if (e % D == 0) {
        m[hg] = mx;
        l[hg] = ls;
      }
    }
  }

  // ---- the block's merge, by the consumer threads after the pairs: each
  // walk cut by a sub-range or range boundary has its pieces combined in
  // pair order, into the outputs (whole in the block) or into the block's
  // part of the walk; a part's last ticket merges all the walk's parts
  __device__ void merge(const Split<kP>& sp, int* arrived) {
    const int tid = threadIdx.x, G = args.G;
    constexpr int kT = 32 * kP;                     // consumer threads
    cut_walks(sc, sp, args, [&](const Seg& part, int lo, int hi, int wa,
                                int wb) {
      const int ws = sc.walk_start(part);
      const int hl = args.local(part.hk);
      const float* pcs[kP];
      const int np = pieces_of(sp, ws, wa, wb, pcs);
      if (part.nparts == 1) {
        combine(pcs, np, args.acc_of(part.n, hl, D), args.m_of(part.n, hl, D),
                args.l_of(part.n, hl, D), tid, kT);
        return;
      }
      // the block's piece of the walk is a part: the block's first walk
      // (stored and ticketed by the pairs) or its last (stored and
      // ticketed here); the last ticket merges
      if (ws < sp.r0) {
        if (!arrived[1]) return;
      } else {
        float* mine = part_at(args.parts, sc, blockIdx.x, ws);
        combine(pcs, np, mine, mine + G * D, mine + G * D + G, tid, kT);
        ConsumerSync::sync();                       // the part is stored
        if (tid == 0)
          arrived[2] = last_ticket(
              args.parts.flags + part.n * args.Hkv + hl, part.nparts);
        ConsumerSync::sync();
        if (!arrived[2]) return;
      }
      for (int e = tid * 4; e < G * D; e += kT * 4) {
        float r[4], mx, ls;
        merge_parts<D, 4>(args.parts, sc, part, G, e / D, e % D, r, mx, ls);
        args.emit<D, 4>(part.n, hl, e / D, e % D, r, mx, ls);
      }
    });
  }
};

template <typename Q, typename P, int D>
__global__ void __launch_bounds__(Lay<Q, P, D>::kThreads, 1)
ragged_decode_kernel(const __grid_constant__ Args a) {
  using L = Lay<Q, P, D>;
  constexpr int kP = L::kP;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  int *start, *lens;
  const Split<kP> sp = pairs_prologue<L>(a, smem, start, lens);
  const Sched sc(start, a.N, a.heads(), gridDim.x);
  const int warp = threadIdx.x >> 5;
  const int w = warp % kP;                // consumers 0 .., producers kP ..
  Walker<Q, P, D> wk{{a, smem, sc, lens, bars, w}, a};
  if (warp >= kP) {
    wk.produce(sp.sub(w), sp.sub(w + 1));
    return;
  }
  wk.consume(sp, reinterpret_cast<int*>(smem + L::kOffArrived));
  named_sync(kSyncId, 32 * kP);           // every piece's state written
  if (sp.r0 < sp.r1)
    wk.merge(sp, reinterpret_cast<int*>(smem + L::kOffArrived));
}

// f32 queries: the CUDA-core walk on the same schedule
template <typename P, int D>
__global__ void __launch_bounds__(WalkLay<P, D>::kThreads)
ragged_decode_walk(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  walk_split<P, D>(a, smem);
}

// ---------------------------------------------------------------------------
// host side: the forms, the launch
// ---------------------------------------------------------------------------
using Kernel = void (*)(const Args);

template <int kId, typename Q, typename P, int D>
Form<Kernel> tc_form() {
  return form<kId>(Kernel(ragged_decode_kernel<Q, P, D>),
                   Lay<Q, P, D>::kThreads, Lay<Q, P, D>::kSmem);
}

template <int kId, typename P, int D>
Form<Kernel> walk_form() {
  return form<kId>(Kernel(ragged_decode_walk<P, D>), WalkLay<P, D>::kThreads,
                   WalkLay<P, D>::kSmem);
}

// the form of (dtype, pool_dtype, D); false for one the kernel lacks
bool find_form(int dtype, int pool_dtype, int D, Form<Kernel>& f) {
  const bool i8 = pool_dtype == kPoolInt8;
  if ((pool_dtype != dtype && !i8) || (D != 64 && D != 128)) return false;
  if (dtype == kBF16) {
    if (D == 128)
      f = i8 ? tc_form<0, bf16, int8_t, 128>() : tc_form<1, bf16, bf16, 128>();
    else
      f = i8 ? tc_form<2, bf16, int8_t, 64>() : tc_form<3, bf16, bf16, 64>();
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
  ragged::Form<ragged::Kernel> f;
  return ragged::find_form(dtype, pool_dtype, D, f) ? ragged::grid_for(f) : 0;
}

// The walk tiles of each block, as the kernels deal them: rows of (block,
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

namespace {

// one launch of B4 (see ptt_ragged_decode and ptt_ragged_decode_shard)
int ragged_launch(const void* q, const void* k_pool, const void* v_pool,
                  const float* ks_pool, const float* vs_pool,
                  const int* table, const int* lengths, float* out,
                  float* scratch, int* flags, int N, int layer, int NB,
                  int BS, int Hkv, int G, int D, int MB, int Hs, int h0,
                  int dtype, int pool_dtype, float scale, void* stream) {
  if (G < 1 || G > ragged::kMaxGroup || N < 1) return cudaErrorInvalidValue;
  if (Hs != 0 && (h0 < 0 || h0 + Hkv > Hs)) return cudaErrorInvalidValue;
  if (pool_dtype == kPoolInt8 && (ks_pool == nullptr || vs_pool == nullptr))
    return cudaErrorInvalidValue;
  const ragged::Args a{{q, k_pool, v_pool, ks_pool, vs_pool, table, lengths,
                        N, Hkv, G, layer, NB, BS, MB, scale, Hs, h0},
                       out,
                       {scratch, flags, (G * (D + 2) + 3) / 4 * 4}};
  ragged::Form<ragged::Kernel> f;
  if (!ragged::find_form(dtype, pool_dtype, D, f)) return cudaErrorInvalidValue;
  const int grid = ragged::grid_for(f);
  if (grid == 0) return cudaErrorInvalidConfiguration;
  f.kernel<<<grid, f.threads, f.smem + (2 * N + 1) * int(sizeof(int)),
             static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

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
  return ragged_launch(q, k_pool, v_pool, ks_pool, vs_pool, table, lengths,
                       out, scratch, flags, N, layer, NB, BS, Hkv, G, D, MB,
                       0, 0, dtype, pool_dtype, scale, stream);
}

// B4's tensor-parallel form: as ptt_ragged_decode, with the inputs kv heads
// [h0, h0 + Hkv) of Hs (a rank's slice; q's query heads those heads' groups)
// walked on the schedule of all Hs heads, so each walk is cut into the parts
// of the whole launch and its partials are the whole launch's, bit for bit.
extern "C" int ptt_ragged_decode_shard(
    const void* q, const void* k_pool, const void* v_pool,
    const float* ks_pool, const float* vs_pool, const int* table,
    const int* lengths, float* out, float* scratch, int* flags, int N,
    int layer, int NB, int BS, int Hkv, int G, int D, int MB, int Hs, int h0,
    int dtype, int pool_dtype, float scale, void* stream) {
  if (Hs < Hkv) return cudaErrorInvalidValue;
  return ragged_launch(q, k_pool, v_pool, ks_pool, vs_pool, table, lengths,
                       out, scratch, flags, N, layer, NB, BS, Hkv, G, D, MB,
                       Hs, h0, dtype, pool_dtype, scale, stream);
}
