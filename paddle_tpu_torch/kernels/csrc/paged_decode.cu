// Paged decode attention for Hopper (sm_90a): one query token per slot
// against the slot's first lengths[n] positions of one pool plane.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py
// `_decode_attn_kernel` (launched by `paged_decode_attention`), which
// copies all of a slot's valid blocks into VMEM and runs a one-shot
// softmax per kv head: scores (q . k) in f32 divided by sqrt(D),
// positions at or past the length masked to -1e30, p = exp(s - max)
// against the slot's maximum, rounded to the pool dtype before the PV
// product, l the sum of the unrounded p, the output acc / l in q's
// dtype. A slot of length 0 returns 0.
//
// What bounds it on the H100: HBM bytes — each query does 4*D operations
// a cached position against 2*D pool elements, about one operation a
// byte, so the floor is the K/V rows under the lengths over 3.35 TB/s.
//
// This design (bf16): the split walk of ragged_split.cuh (B4's schedule,
// producer-consumer warp pairs, cp.async rings and mma.sync tiles) in two
// passes, so that p is rounded against the walk's global maximum exactly
// as the one-shot softmax rounds it. Once every part of a walk knows that
// maximum, the parts need no rescaling: their merge is an ordered sum of
// acc and l, and the result equals the one-shot softmax up to the order of
// f32 sums.
//
// - Pass 1 (`paged_decode_max`) stages K rows only (four 32-position
//   tiles in flight a pair), scores them on tensor cores and writes each
//   walk's maximum: a walk whole in a block into `wmax`, a walk cut by
//   block ranges one maximum a part, in the part's scratch slot.
// - Pass 2 (`paged_decode_sum`) walks the same schedule with K and V: its
//   consumers read the walk's maximum (over its parts), rescore K (from L2:
//   a call's K is a few MB against the 50 MB L2), and accumulate p (rounded
//   to bf16) x V on tensor cores with l in f32. A walk whole in a pair is
//   normalized and stored at once; pieces meet in pair order; a walk cut
//   by block ranges stores its part (acc, l) and the last ticket sums the
//   parts in part order and writes acc / l in bf16.
// - The two passes are two launches on the caller's stream, the second
//   with programmatic dependent launch: pass 1's blocks let it start at
//   once, so pass 2's blocks take each SM as pass 1 leaves it, read the
//   schedule and the table and copy K and V while pass 1 ends; only its
//   consumers wait (griddepcontrol.wait) for pass 1's maxima. No block
//   waits on another block's flag.
// - Pass 1 (and the f32 walk) is launched dependent on the kernel before
//   it, so that its launch overlaps that kernel (B7's token append
//   signals at its start): it waits before it reads the lengths, the
//   table, q or the pools, and lets pass 2 launch only after that wait,
//   since pass 2's producers copy the pools without a wait of their own.
//   With B7 launched the same way, this took 3.2 us a layer off the
//   paged API's decode sequence (B7, then B6; tools/paged_decode_ab.py
//   --chain; NVIDIA H100 80GB HBM3, 700.00 W).
//
// f32 (q and pools): the CUDA-core walk of ragged_walk.cuh on the same
// split schedule in 64-position tiles (`walk_split`, as B4's f32 form),
// one launch; its online softmax in f32 rounds nothing before the PV
// product, and the last ticket merges the parts and writes acc / l.
//
// A bf16 call is two CUDA launches, an f32 call one. Any length takes
// this one path: no size-based fallback.
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"
#include "ragged_split.cuh"
#include "ragged_walk.cuh"

namespace ptt {
namespace paged {
namespace {

using namespace ragged;

// The walks and B6's output y [N, Hkv*G, D] in q's dtype T; `wmax` [N *
// Hkv * G] the maximum score of each walk whole in a block (pass 1), and
// the parts of walks cut by block ranges (their maxima from pass 1 in the
// parts' m slots).
template <typename T>
struct Args : Walks {
  T* y;
  float* wmax;
  Parts parts;

  __device__ T* y_of(int n, int hk, int g, int D) const {
    return y + int64_t((n * Hkv + hk) * G + g) * D;
  }
  // head g's columns [c, c + kC) of walk (n, hk): acc / l in T, 0 for an
  // empty walk (l = 0)
  template <int D, int kC>
  __device__ void emit(int n, int hk, int g, int c, const float (&r)[kC],
                       float /*m*/, float l) const {
    T* o = y_of(n, hk, g, D) + c;
#pragma unroll
    for (int i = 0; i < kC; ++i) o[i] = from_f32<T>(l > 0.f ? r[i] / l : 0.f);
  }
};

// the scaled score x = s / sqrt(D), rounded once (never contracted into
// the exponent's subtraction), so both passes see the same x
__device__ __forceinline__ float scaled(float s, float scale) {
  return __fmul_rn(s, scale);
}

// ---------------------------------------------------------------------------
// Pass 1: each walk's maximum score
// ---------------------------------------------------------------------------
template <int D>
struct MaxPass : Pair<bf16, bf16, D, false, kMaxGroup> {
  using B = Pair<bf16, bf16, D, false, kMaxGroup>;
  using L = typename B::L;
  using B::empty;
  using B::full;
  using B::lens;
  using B::piece;
  using B::pieces_of;
  using B::qbuf;
  using B::qempty;
  using B::sc;
  using B::stage;
  using B::w;
  static constexpr int KS = B::KS;
  static constexpr int kP = L::kP;

  const Args<bf16>& args;

  // the consumer warp: every piece of its sub-range; a walk whole in the
  // pair writes its maximum to wmax, a piece of a longer walk to the
  // pair's piece slot (one float a head)
  __device__ void consume(const Split<kP>& sp) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int G = args.G;
    const int r0 = sp.sub(w), r1 = sp.sub(w + 1);
    int s = 0, k = 0;
    for (int r = r0; r < r1; ++k) {
      const Seg sg = sc.seg(r, r1);
      r += sg.tb - sg.ta;
      const int len = lens[sg.n];
      float m = kNegInf;
      uint32_t qa[KS][2];
      for (int j = sg.ta; j < sg.tb; ++j, ++s) {
        const int slot = s % L::kStagesW;
        mbar_wait(full(slot), (s / L::kStagesW) & 1);
        if (j == sg.ta) B::load_q(reinterpret_cast<const bf16*>(qbuf(k)), qa);
        float sc4[4][4];
        B::score(stage(slot), qa, sc4);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(slot));   // the ring slot is read
        // head g's positions nb*8 + 2t + e under the length
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (j * kTile + nb * 8 + 2 * t + e < len)
              m = fmaxf(m, scaled(sc4[nb][e], args.scale));
      }
      m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 1));
      m = fmaxf(m, __shfl_xor_sync(kFullMask, m, 2));
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty(k));      // the walk's queries are read
      if (g < G && t == 0) {
        if (sg.ta == 0 && sg.tb == sg.t)
          args.wmax[(sg.n * args.Hkv + sg.hk) * G + g] = m;
        else
          piece(w, sc.walk_start(sg) <= r0 ? 0 : 1)[g] = m;
      }
    }
  }

  // the block's merge: each walk cut by a sub-range or range boundary
  // takes the maximum of its pieces, into wmax (whole in the block) or
  // the block's part's m slot
  __device__ void merge(const Split<kP>& sp) const {
    const int tid = threadIdx.x, G = args.G;
    cut_walks(sc, sp, args, [&](const Seg& part, int, int, int wa,
                                    int wb) {
      if (tid >= G) return;
      const int ws = sc.walk_start(part);
      const float* pcs[kP];
      const int np = pieces_of(sp, ws, wa, wb, pcs);
      float mx = kNegInf;
#pragma unroll
      for (int q = 0; q < kP; ++q)
        if (q < np) mx = fmaxf(mx, pcs[q][tid]);
      if (part.nparts == 1)
        args.wmax[(part.n * args.Hkv + part.hk) * G + tid] = mx;
      else
        part_at(args.parts, sc, blockIdx.x, ws)[G * D + tid] = mx;
    });
  }
};

// ---------------------------------------------------------------------------
// Pass 2: p = exp(s - max) against the walk's maximum, rounded, times V
// ---------------------------------------------------------------------------
template <int D>
struct SumPass : Pair<bf16, bf16, D> {
  using B = Pair<bf16, bf16, D>;
  using L = typename B::L;
  using B::empty;
  using B::full;
  using B::lens;
  using B::piece;
  using B::pieces_of;
  using B::qbuf;
  using B::qempty;
  using B::sc;
  using B::stage;
  using B::w;
  static constexpr int KS = B::KS;
  static constexpr int DB = B::DB;
  static constexpr int kP = L::kP;
  static constexpr int kL = kMaxGroup * D + kMaxGroup;   // l in a piece

  const Args<bf16>& args;

  // the maximum score of head g over walk `sg` (pass 1's): its wmax entry,
  // or the largest of its parts' maxima
  __device__ float walk_max(const Seg& sg, int g) const {
    if (sg.nparts == 1)
      return __ldcg(args.wmax + (sg.n * args.Hkv + sg.hk) * args.G + g);
    const int ws = sc.walk_start(sg);
    float m = kNegInf;
    for (int q = 0; q < sg.nparts; ++q)
      m = fmaxf(m, __ldcg(part_at(args.parts, sc, sg.b0 + q, ws)
                          + args.G * D + g));
    return m;
  }

  // One tile at the walk's maximum m: l += sum p, O += round(p) V on
  // tensor cores; the ring slot is released through `empty_bar`.
  __device__ void tile(const unsigned char* st, const uint32_t (&qa)[KS][2],
                       int pos0, int len, float m, float& l,
                       float (&o)[DB][4], uint64_t* empty_bar) const {
    const int lane = threadIdx.x & 31, t = lane & 3;
    float s[4][4];
    B::score(st, qa, s);
    float p[4][2], psum = 0.f;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nb * 8 + 2 * t + e;
        p[nb][e] = pos0 + r < len ? expf(scaled(s[nb][e], args.scale) - m)
                                  : 0.f;
        psum += p[nb][e];
      }
    psum += __shfl_xor_sync(kFullMask, psum, 1);
    psum += __shfl_xor_sync(kFullMask, psum, 2);
    l += psum;
    uint32_t pa[2][1][2];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      pa[kk][0][1] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    }
    B::template pv<1>(st + kTile * L::kRow, L::kRow, pa, o);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar);
  }

  // the consumer warp: every piece of its sub-range. A walk whole in the
  // pair is normalized into y; a piece of a longer walk leaves acc and l
  // in the pair's piece slot.
  __device__ void consume(const Split<kP>& sp) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int G = args.G;
    const int r0 = sp.sub(w), r1 = sp.sub(w + 1);
    // pass 1 has ended and its maxima are visible (this grid may start
    // before it ends; the producers copy meanwhile)
    grid_dependency_wait();
    int s = 0, k = 0;
    for (int r = r0; r < r1; ++k) {
      const Seg sg = sc.seg(r, r1);
      r += sg.tb - sg.ta;
      const int len = lens[sg.n];
      const float m = g < G ? walk_max(sg, g) : 0.f;
      float l = 0.f, o[DB][4];
#pragma unroll
      for (int db = 0; db < DB; ++db)
        o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
      uint32_t qa[KS][2];
      for (int j = sg.ta; j < sg.tb; ++j, ++s) {
        const int slot = s % L::kStagesW;
        mbar_wait(full(slot), (s / L::kStagesW) & 1);
        if (j == sg.ta) B::load_q(reinterpret_cast<const bf16*>(qbuf(k)), qa);
        tile(stage(slot), qa, j * kTile, len, m, l, o, empty(slot));
      }
      // head g = lane / 4, columns 8db + 2t, + 1
      if (g < G) {
        if (sg.ta == 0 && sg.tb == sg.t) {
          bf16* yr = args.y_of(sg.n, sg.hk, g, D);
#pragma unroll
          for (int db = 0; db < DB; ++db)
            *reinterpret_cast<__nv_bfloat162*>(yr + db * 8 + 2 * t) =
                __floats2bfloat162_rn(l > 0.f ? o[db][0] / l : 0.f,
                                      l > 0.f ? o[db][1] / l : 0.f);
        } else {
          float* pc = piece(w, sc.walk_start(sg) <= r0 ? 0 : 1);
#pragma unroll
          for (int db = 0; db < DB; ++db)
            *reinterpret_cast<float2*>(pc + g * D + db * 8 + 2 * t) =
                make_float2(o[db][0], o[db][1]);
          if (t == 0) pc[kL + g] = l;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty(k));   // the walk's queries are read
    }
  }

  // The block's merge, by the consumer threads after the pairs: each walk
  // cut by a sub-range or range boundary has its pieces summed in pair
  // order, into y (whole in the block) or into the block's part (acc, l);
  // a part's last ticket sums all the walk's parts in part order into y.
  __device__ void merge(const Split<kP>& sp, int* arrived) const {
    const int tid = threadIdx.x, G = args.G;
    constexpr int kT = 32 * kP;                     // consumer threads
    cut_walks(sc, sp, args, [&](const Seg& part, int, int, int wa,
                                    int wb) {
      const int ws = sc.walk_start(part);
      const float* pcs[kP];
      const int np = pieces_of(sp, ws, wa, wb, pcs);
      float* mine = part.nparts == 1
                        ? nullptr
                        : part_at(args.parts, sc, blockIdx.x, ws);
      for (int e = tid * 4; e < G * D; e += kT * 4) {
        const int hg = e / D;
        float r[4] = {0.f, 0.f, 0.f, 0.f}, ls = 0.f;
#pragma unroll
        for (int q = 0; q < kP; ++q)
          if (q < np) {
            const float4 x = *reinterpret_cast<const float4*>(pcs[q] + e);
            r[0] += x.x;
            r[1] += x.y;
            r[2] += x.z;
            r[3] += x.w;
            ls += pcs[q][kL + hg];
          }
        if (mine == nullptr) {
          args.emit<D, 4>(part.n, part.hk, hg, e % D, r, 0.f, ls);
        } else {
          // acc and l; the m slot keeps pass 1's maximum of the part
          *reinterpret_cast<float4*>(mine + e) =
              make_float4(r[0], r[1], r[2], r[3]);
          if (e % D == 0) mine[G * D + G + hg] = ls;
        }
      }
      if (mine == nullptr) return;
      named_sync(kSyncId, kT);                      // the part is stored
      if (tid == 0)
        arrived[2] = last_ticket(
            args.parts.flags + part.n * args.Hkv + part.hk, part.nparts);
      named_sync(kSyncId, kT);
      if (!arrived[2]) return;
      for (int e = tid * 4; e < G * D; e += kT * 4) {
        float r[4], mx, ls;
        merge_parts<D, 4, false>(args.parts, sc, part, G, e / D, e % D, r,
                                 mx, ls);
        args.emit<D, 4>(part.n, part.hk, e / D, e % D, r, mx, ls);
      }
    });
  }
};

template <int D>
using MaxLay = typename MaxPass<D>::L;
template <int D>
using SumLay = typename SumPass<D>::L;

template <int D>
__global__ void __launch_bounds__(MaxLay<D>::kThreads, 1)
paged_decode_max(const __grid_constant__ Args<bf16> a) {
  using L = MaxLay<D>;
  constexpr int kP = L::kP;
  extern __shared__ __align__(128) unsigned char smem[];
  // the kernel ahead (a token append, say) may still write q, the pools,
  // the table or the lengths; then pass 2 may launch, whose producers copy
  // K and V without a wait of their own
  grid_dependency_wait();
  launch_dependents();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  int *start, *lens;
  const Split<kP> sp = pairs_prologue<L>(a, smem, start, lens);
  const Sched sc(start, a.N, a.Hkv, gridDim.x);
  const int warp = threadIdx.x >> 5;
  const int w = warp % kP;                // consumers 0 .., producers kP ..
  MaxPass<D> mp{{a, smem, sc, lens, bars, w}, a};
  if (warp >= kP) {
    mp.produce(sp.sub(w), sp.sub(w + 1));
    return;
  }
  mp.consume(sp);
  named_sync(kSyncId, 32 * kP);           // every piece's maximum written
  if (sp.r0 < sp.r1) mp.merge(sp);
}

template <int D>
__global__ void __launch_bounds__(SumLay<D>::kThreads, 1)
paged_decode_sum(const __grid_constant__ Args<bf16> a) {
  using L = SumLay<D>;
  constexpr int kP = L::kP;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  int *start, *lens;
  const Split<kP> sp = pairs_prologue<L>(a, smem, start, lens);
  const Sched sc(start, a.N, a.Hkv, gridDim.x);
  const int warp = threadIdx.x >> 5;
  const int w = warp % kP;
  SumPass<D> ps{{a, smem, sc, lens, bars, w}, a};
  if (warp >= kP) {
    ps.produce(sp.sub(w), sp.sub(w + 1));
    return;
  }
  ps.consume(sp);
  named_sync(kSyncId, 32 * kP);           // every piece's state written
  if (sp.r0 < sp.r1)
    ps.merge(sp, reinterpret_cast<int*>(smem + L::kOffArrived));
}

// f32: the CUDA-core walk on the same schedule
template <int D>
__global__ void __launch_bounds__(WalkLay<float, D>::kThreads)
paged_decode_walk(const __grid_constant__ Args<float> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  grid_dependency_wait();                 // as paged_decode_max
  walk_split<float, D>(a, smem);
}

// ---------------------------------------------------------------------------
// host side: the forms, the launches
// ---------------------------------------------------------------------------
using K16 = void (*)(const Args<bf16>);
using K32 = void (*)(const Args<float>);

// the schedule's shared memory past a form's base
inline int sched_bytes(int N) { return (2 * N + 1) * int(sizeof(int)); }

template <int kId, int D>
cudaError_t launch_bf16(const Args<bf16>& a, cudaStream_t st) {
  const Form<K16> f1 = form<kId>(K16(paged_decode_max<D>),
                                 MaxLay<D>::kThreads, MaxLay<D>::kSmem);
  const Form<K16> f2 = form<kId + 1>(K16(paged_decode_sum<D>),
                                     SumLay<D>::kThreads, SumLay<D>::kSmem);
  // both passes deal the walks over one grid
  const int g1 = grid_for(f1), g2 = grid_for(f2);
  const int grid = g1 < g2 ? g1 : g2;
  if (grid == 0) return cudaErrorInvalidConfiguration;
  const cudaError_t err = launch_dependent(
      f1.kernel, dim3(grid), dim3(f1.threads), f1.smem + sched_bytes(a.N), st,
      a);
  if (err != cudaSuccess) return err;
  return launch_dependent(f2.kernel, dim3(grid), dim3(f2.threads),
                          f2.smem + sched_bytes(a.N), st, a);
}

template <int kId, int D>
cudaError_t launch_f32(const Args<float>& a, cudaStream_t st) {
  const Form<K32> f = form<kId>(K32(paged_decode_walk<D>),
                                WalkLay<float, D>::kThreads,
                                WalkLay<float, D>::kSmem);
  const int grid = grid_for(f);
  if (grid == 0) return cudaErrorInvalidConfiguration;
  return launch_dependent(f.kernel, dim3(grid), dim3(f.threads),
                          f.smem + sched_bytes(a.N), st, a);
}

}  // namespace
}  // namespace paged
}  // namespace ptt

using namespace ptt;

// dtype: 0 = f32, 1 = bf16 (q, the pools and out all of it); D 64 or 128;
// 1 <= G <= 8; N <= 511 (the wrapper checks). q and out [N, Hkv*G, D],
// pools [L, NB, BS, Hkv, D] (every tensor contiguous, q and the pools
// 16-byte aligned), table [N, MB] and lengths [N] int32; `layer` selects
// the pool plane. `scratch` (16-byte aligned) holds two parts a block of
// the largest grid (2 * 192 * pstride floats, pstride = G * (D + 2)
// rounded up to a multiple of 4), `wmax` N * Hkv * G floats, `flags`
// [N * Hkv] int32, zero (left zero); calls that share them run one after
// another (one stream). bf16: two launches, the second dependent on the
// first; f32: one.
extern "C" int ptt_paged_decode_attention(const void* q, const void* k_pool,
                                          const void* v_pool,
                                          const int* table,
                                          const int* lengths, void* out,
                                          float* scratch, float* wmax,
                                          int* flags, int N, int layer,
                                          int NB, int BS, int Hkv, int G,
                                          int D, int MB, int dtype,
                                          void* stream) {
  if (N < 1 || G < 1 || G > ragged::kMaxGroup || (D != 64 && D != 128))
    return cudaErrorInvalidValue;
  const ragged::Walks w{q, k_pool, v_pool, nullptr, nullptr, table, lengths,
                        N, Hkv, G, layer, NB, BS, MB,
                        1.f / sqrtf(float(D))};
  const ragged::Parts parts{scratch, flags, (G * (D + 2) + 3) / 4 * 4};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const paged::Args<__nv_bfloat16> a{
        w, static_cast<__nv_bfloat16*>(out), wmax, parts};
    return D == 128 ? paged::launch_bf16<0, 128>(a, st)
                    : paged::launch_bf16<2, 64>(a, st);
  }
  if (dtype == kF32) {
    const paged::Args<float> a{w, static_cast<float*>(out), wmax, parts};
    return D == 128 ? paged::launch_f32<4, 128>(a, st)
                    : paged::launch_f32<5, 64>(a, st);
  }
  return cudaErrorInvalidValue;
}
