// Persistent decode megakernel for Hopper (sm_90a): one launch runs one
// decode step through every layer of a Llama model.
//
// Replaces the TPU kernel paddle_tpu/kernels/mega_decode.py `_mega_kernel`
// in its single-step form (launched by `mega_decode_step`).
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
//
// This design: a persistent cooperative grid (every block co-resident,
// 2 blocks an SM, sized from the occupancy query times the SM count)
// runs the five phases of each layer separated by grid-wide barriers
// (cooperative groups grid.sync, 5 a layer, ~1.6 us each). Phases 1, 3, 4
// and 5 are GEMVs over 32-column tiles of the stacked [L, in, out]
// weights; where a phase has fewer tiles than half the blocks (wo and
// w_down: 128 tiles for 264 blocks) each tile's rows split into k-ranges,
// as many as keep the work items within one round of the grid. A work
// item streams its column slice of its k-range once for all N rows with
// 16-byte loads (8 in flight a thread at N <= 4, 4 at N <= 8, whose
// accumulators take twice the registers), the input rows staged in
// shared memory first (the norm applied while staging; gate and up share
// one staging), and sums its k-groups through warp shuffles and shared
// memory. Phase 2 splits each (slot, kv head)'s walk into parts, so the
// phase fills the grid too (one block a (slot, kv head) left most of the
// grid idle for a serial walk). Split work meets deterministically: each
// part writes its f32 sums to a scratch row and the block that finishes
// last (an atomic counter per tile or walk) adds them in a fixed order
// and applies the epilogue. x, the per-layer scratch (q/k/v, the
// attention output, gate*up, the partial sums) and the ring stay in
// device memory between phases, written and read only by the kernel, and
// read past L1 (ld.global.cg) after each barrier.
//
// int8 (the TPU kernel's w_int8 and kv_int8 branches, each on its own or
// both): int8 weight leaves stream their [L, K, M] int8 matrix
// unconverted, 8 columns (8 bytes) a load, widened in registers, so the
// weight stream is half the bytes; the per-output-channel bf16 scale
// multiplies the COMPLETE f32 sum of a column, then the result rounds to
// the model dtype — in a split-K phase that is the finishing block's
// epilogue, after the ordered combine of the k-ranges, never a k-range's
// partial sum (the TPU kernel contracts all of K before it scales). int8
// pools take B4's int8 walk (ragged_walk.cuh); the in-call ring stays in
// the model dtype. The weights' type is a template parameter (the bf16
// and f32 kernels carry no int8 code, and the int8 GEMV has its own
// unroll), the pools' a runtime branch; the forms build in parallel, one
// translation unit each (mega_decode_<dtype>[_w8].cu).
//
// The multi-step form (the TPU kernel's `multi` branch, launched by
// `mega_decode_loop`: the speculative draft's k greedy steps in one
// launch) is the template parameter kMulti, so the single-step
// instantiations carry none of it. The step loop lives inside the
// cooperative grid: step s writes ring row t = s, and RoPE reads the
// rows' lengths, which the kernel advances, past L1. After the last
// layer of a step: (E1) the final RMSNorm, applied while the head's input
// rows are staged; (E2) the head product split over the grid — 32-column
// tiles of a dense or int8 [h, V] head (an int8 column's bf16 scale on
// its complete f32 sum), or a warp per vocab row of the tied head's
// contiguous embed rows — with each block keeping a running (max, first
// index) a row over logits rounded to the model dtype, written to
// scratch; (E3) after a grid barrier, block n reduces row n's partials
// (larger logit, then lower index: the TPU kernel's `tmax > best` over
// ascending tiles), updates last/lens/done/budget as the TPU kernel
// does, writes the step's emitted token (-1 where the row is inactive or
// done) and gathers embed[last] into x; (E4) a grid barrier, then the
// next step. Four barriers a step on top of the layers' 5L - 1. The
// split-K tile counters are back at zero after every use, so after every
// step.
//
// Later PRs: wgmma and TMA-fed weight tiles.
#pragma once

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ragged_walk.cuh"

namespace cg = cooperative_groups;

namespace ptt {
namespace mega {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileCols = 32;     // output columns of a GEMV tile
constexpr int kChunkRows = 4096;  // input rows staged in shared memory
constexpr int kMaxSplits = 8;     // k-ranges a GEMV tile is split into

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
  float* part;             // [kMaxSplits, N, max(Hq*D + 2*Hkv*D, 2*F, h)]
  int* count;              // [max(that width / 32, N*Hkv)], zeroed
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

// the kernel and its launch code: internal to each translation unit (a
// static grid size per instantiation must not be shared with another
// library loaded into the same process)
namespace {

// loads of what the kernel itself wrote before a barrier: past L1
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

// 16 bytes of a weight: read-only for the kernel's life, streamed once
__device__ __forceinline__ uint4 ld_weights(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

// 8 bytes of an int8 weight matrix, streamed once like ld_weights
__device__ __forceinline__ uint2 ld_weights8(const void* p) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(r.x), "=r"(r.y)
      : "l"(p));
  return r;
}

// 8 int8 weights widened to f32 (exact)
__device__ __forceinline__ void unpack(const uint2& v, float (&f)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = float(int(v.x << (24 - 8 * i)) >> 24);
    f[4 + i] = float(int(v.y << (24 - 8 * i)) >> 24);
  }
}
// 16 int8 weights widened to f32 (exact)
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[4 * j + i] = float(int(w[j] << (24 - 8 * i)) >> 24);
}

// A weight load at NS accumulator rows: 16 bytes of a bf16 or f32
// matrix; of an int8 one 16 bytes (16 columns) at NS <= 4 and 8 bytes (8
// columns) at NS = 8, so an int8 thread holds no more sums than a bf16
// thread at NS = 8.
template <typename W, int NS>
struct WLoad {
  using Vec = uint4;
  static constexpr int kVec = 16 / int(sizeof(W));   // columns a load
  __device__ static Vec load(const W* p) { return ld_weights(p); }
};
template <int NS>
struct WLoad<int8_t, NS> {
  static constexpr bool kWide = NS <= 4;
  using Vec = typename std::conditional<kWide, uint4, uint2>::type;
  static constexpr int kVec = kWide ? 16 : 8;
  __device__ static Vec load(const int8_t* p) {
    if constexpr (kWide)
      return ld_weights(p);
    else
      return ld_weights8(p);
  }
};

// The GEMV layout for weights of type W and NS (4 or 8) accumulator
// rows: thread (k-group kg, load column c) holds NS x kVec f32 sums and
// kUnroll loads in flight, as many as keep the sums and loads within the
// registers (8 at NS = 4, 4 at NS = 8; int8: 4 16-byte loads at NS = 4,
// 8 8-byte ones at NS = 8).
template <typename W, int NS>
struct Gemv {
  static constexpr bool kInt8 = std::is_same<W, int8_t>::value;
  static constexpr int kVec = WLoad<W, NS>::kVec;    // columns a load
  static constexpr int kCh = kTileCols / kVec;       // loads a tile row
  static constexpr int kGroups = kThreads / kCh;     // k-groups a block
  static constexpr int kUnroll = kInt8 ? (NS <= 4 ? 4 : 8)
                                       : (NS <= 4 ? 8 : 4);
};

// the GEMV phases' shared memory
template <typename T, int NS>
struct GemvSmem {
  T* xs;          // [NS][kChunkRows] staged input rows
  float* red;     // [kWarps][NS][kTileCols] per-warp sums
  float* out0;    // [NS][kTileCols] a tile's result
  float* out1;    // the second result of the gate/up phase
  float* rn;      // [NS] the rows' RMSNorm factors
  float* wsum;    // [kWarps]
  __device__ explicit GemvSmem(unsigned char* s) {
    xs = reinterpret_cast<T*>(s);
    red = reinterpret_cast<float*>(s + NS * kChunkRows * sizeof(T));
    out0 = red + kWarps * NS * kTileCols;
    out1 = out0 + NS * kTileCols;
    rn = out1 + NS * kTileCols;
    wsum = rn + NS;
  }
};

// the larger of the walks over pools of the model dtype and int8 pools,
// and the GEMVs'
template <typename T, int D, int NS>
constexpr int smem_bytes() {
  constexpr int walk_t = walk::Layout<T, D>::kSmem;
  constexpr int walk_i8 = walk::Layout<int8_t, D>::kSmem;
  constexpr int walk = walk_t > walk_i8 ? walk_t : walk_i8;
  constexpr int gemv = NS * kChunkRows * int(sizeof(T))
                       + (kWarps + 2) * NS * kTileCols * 4
                       + (NS + kWarps) * 4;
  return walk > gemv ? walk : gemv;
}

// input row n, element k of a GEMV: RMSNorm(x) as the plain version
// rounds it, or a scratch row as it is
template <typename T>
struct NormIn {
  const T* x;
  const T* w;
  const float* rn;
  int h;
  __device__ T operator()(int n, int k) const {
    const float y = round_to<T>(__fmul_rn(ld_cg(x + int64_t(n) * h + k),
                                          rn[n]));
    return from_f32<T>(__fmul_rn(y, to_f32(w[k])));
  }
};
template <typename T>
struct RawIn {
  const T* src;
  int ld;
  __device__ T operator()(int n, int k) const {
    return from_f32<T>(ld_cg(src + int64_t(n) * ld + k));
  }
};

// rn[n] = rsqrt(mean(x[n]^2) + eps) for the N rows of x [N, h]
template <typename T, int NS>
__device__ void rms_factors(const T* x, int N, int h, float eps,
                            const GemvSmem<T, NS>& sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int n = 0; n < N; ++n) {
    float s = 0.f;
    for (int k = tid; k < h; k += kThreads) {
      const float v = ld_cg(x + int64_t(n) * h + k);
      s = fmaf(v, v, s);
    }
    s = group_sum<32>(s);
    if (lane == 0) sm.wsum[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += sm.wsum[w];
      sm.rn[n] = rsqrtf(tot / float(h) + eps);
    }
    __syncthreads();
  }
}

// xs[n][k - k0] = in(n, k) for k in [k0, k0 + kc)
template <typename T, int NS, typename In>
__device__ void stage(const In& in, int k0, int kc, int N,
                      const GemvSmem<T, NS>& sm) {
  __syncthreads();   // the previous chunk is consumed
  for (int n = 0; n < N; ++n)
    for (int k = threadIdx.x; k < kc; k += kThreads)
      sm.xs[n * kChunkRows + k] = in(n, k0 + k);
  __syncthreads();
}

// out[n][c] = sum over k in [kb, ke) of in(n, k) * W[k][c0 + c], c < 32,
// n < N, in f32: W is [K, M] row-major, of the model dtype T or int8.
// Thread (kg, c) walks rows kg, kg + kGroups, ... of each staged chunk;
// the k-groups of a warp sum by shuffles, the warps through shared
// memory. With `staged` the rows [kb, ke) (at most kChunkRows) are
// already in xs. `out` is ready when this returns (after a barrier).
template <typename T, typename Wt, int NS, typename In>
__device__ void gemv_tile(const Wt* __restrict__ W, int kb, int ke, int M,
                          int c0, int N, const In& in,
                          const GemvSmem<T, NS>& sm, float* out,
                          bool staged) {
  using V = Gemv<Wt, NS>;
  using L = WLoad<Wt, NS>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid % V::kCh, kg = tid / V::kCh;
  float acc[NS][V::kVec];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int v = 0; v < V::kVec; ++v) acc[n][v] = 0.f;

  for (int k0 = kb; k0 < ke; k0 += kChunkRows) {
    const int kc = min(kChunkRows, ke - k0);
    if (!staged) stage(in, k0, kc, N, sm);
    const Wt* wcol = W + int64_t(k0) * M + c0 + c * V::kVec;
    for (int kk = kg; kk < kc; kk += V::kGroups * V::kUnroll) {
      typename L::Vec wv[V::kUnroll];
#pragma unroll
      for (int u = 0; u < V::kUnroll; ++u) {
        const int k = kk + u * V::kGroups;
        wv[u] = k < kc ? L::load(wcol + int64_t(k) * M) : typename L::Vec{};
      }
#pragma unroll
      for (int u = 0; u < V::kUnroll; ++u) {
        const int k = kk + u * V::kGroups;
        if (k < kc) {
          float wf[V::kVec];
          unpack(wv[u], wf);
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            if (n < N) {
              const float xv = to_f32(sm.xs[n * kChunkRows + k]);
#pragma unroll
              for (int v = 0; v < V::kVec; ++v)
                acc[n][v] = fmaf(xv, wf[v], acc[n][v]);
            }
          }
        }
      }
    }
  }
  // lane = (k-group in the warp) * kCh + c: sum over the warp's k-groups
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    if (n < N) {
#pragma unroll
      for (int v = 0; v < V::kVec; ++v) {
        float s = acc[n][v];
#pragma unroll
        for (int o = V::kCh; o < 32; o <<= 1)
          s += __shfl_xor_sync(kFullMask, s, o);
        if (lane < V::kCh)
          sm.red[(warp * NS + n) * kTileCols + lane * V::kVec + v] = s;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < N * kTileCols; e += kThreads) {
    const int n = e / kTileCols, col = e % kTileCols;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w)
      s += sm.red[(w * NS + n) * kTileCols + col];
    out[n * kTileCols + col] = s;
  }
  __syncthreads();
}

// How many k-ranges a phase's tiles split into: as many as keep the
// phase's work items within one round of the grid, at most kMaxSplits
// and at least 256 rows a range.
__device__ __forceinline__ int splits(int tiles, int K) {
  const int s = int(gridDim.x) / tiles;
  return max(1, min(min(s, kMaxSplits), K / 256));
}

// After a block's writes and a __threadfence: true for the block that
// brings `count` to S (the last of S that share it), which leaves it at
// 0 for the next use.
__device__ __forceinline__ bool finish(int* count, int S) {
  const bool last = atomicAdd(count, 1) == S - 1;
  if (last) *count = 0;
  return last;
}

// Split-K: k-range s of S of the tile at columns [c0, c0 + 32) leaves
// its sums in part[s] (`nout` results, out0 then out1, the second at
// column offset `off1` of rows `width` wide); the block that finishes the
// tile's last range adds the S ranges in order s = 0..S-1 (the result
// does not depend on which block is last) into out0/out1 and returns
// true; the others return false. The tile's counter is left at 0 for the
// next phase.
template <typename T, int NS>
__device__ bool sum_splits(const GemvSmem<T, NS>& sm, int* last, int nout,
                           int off1, float* part, int* count, int s, int S,
                           int N, int width, int c0) {
  if (S == 1) return true;
  const int tid = threadIdx.x, n_el = N * kTileCols;
  auto at = [&](int r, int e) {
    const int o = e / n_el, ee = e % n_el;
    return part + (int64_t(r) * N + ee / kTileCols) * width + o * off1 + c0
           + ee % kTileCols;
  };
  for (int e = tid; e < nout * n_el; e += kThreads)
    *at(s, e) = sm.out0[e / n_el * NS * kTileCols + e % n_el];
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = finish(count, S);
  __syncthreads();
  if (!*last) return false;
  __threadfence();
  for (int e = tid; e < nout * n_el; e += kThreads) {
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += __ldcg(at(r, e));
    sm.out0[e / n_el * NS * kTileCols + e % n_el] = v;
  }
  __syncthreads();
  return true;
}

// Phase 2 for slot n, kv head hk of layer l, part p of P: RoPE at `pos`
// (the row's length) of the group's queries (and, in part 0, of the
// fresh k, written with v into ring row t); the walk over the part's
// share of the pool prefix (whole 64-position tiles); with P > 1 the
// part's (m, l, acc) go to `part` and the block that finishes the slot's
// last part merges the P in order p = 0..P-1 (the result does not depend
// on which block is last); then the combine with ring rows j <= t and the
// attention output.
template <typename T, typename Pool, int D>
__device__ void attention_item(const Args& a, int l, int n, int hk, int p,
                               int P, int t, float pos, int* last,
                               unsigned char* smem) {
  using Lay = walk::Layout<Pool, D>;
  constexpr int D2 = D / 2, DC = D / 32;
  float* Qs = reinterpret_cast<float*>(smem + walk::kStages * Lay::kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, Hkv = a.Hkv;
  const int Mq = Hkv * G * D, Mqkv = Mq + 2 * Hkv * D;
  const T* qkv = static_cast<const T*>(a.qkv) + int64_t(n) * Mqkv;
  const int64_t ring0 = (int64_t(l) * a.N + n) * a.S * Hkv * D;
  T* rk = static_cast<T*>(a.ring_k) + ring0;   // [S, Hkv, D]
  T* rv = static_cast<T*>(a.ring_v) + ring0;

  __syncthreads();   // the previous item is done with Qs
  const int rows = p == 0 ? G + 1 : G;   // part 0 rotates k too
  for (int e = tid; e < rows * D2; e += kThreads) {
    const int row = e / D2, i = e % D2;
    const float ang = __fmul_rn(pos, a.freq[i]);
    const float cs = round_to<T>(cosf(ang)), sn = round_to<T>(sinf(ang));
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
    for (int d = tid; d < D; d += kThreads)
      rv[(int64_t(t) * Hkv + hk) * D + d] =
          from_f32<T>(ld_cg(qkv + Mq + Hkv * D + hk * D + d));
  __syncthreads();   // queries staged; ring row t written

  const int len = max(0, min(a.walk_lens[n], a.MB * a.BS));
  const int share = (len + P * walk::kTile - 1) / (P * walk::kTile)
                    * walk::kTile;
  const int begin = min(len, p * share), end = min(len, begin + share);
  float m, lsum, acc[DC];
  walk::ragged_walk<Pool, D>(static_cast<const Pool*>(a.k_pool),
                             static_cast<const Pool*>(a.v_pool), a.ks_pool,
                             a.vs_pool, a.table + int64_t(n) * a.MB, begin,
                             end, l, a.NB, a.BS, Hkv, hk, G, a.scale, smem, m,
                             lsum, acc);
  if (P > 1) {
    // part (n, hk, p): G rows of [acc (D), m, l]
    float* mine = a.part + ((int64_t(n) * Hkv + hk) * P + p) * G * (D + 2);
    if (warp < G) {
      float* r = mine + warp * (D + 2);
#pragma unroll
      for (int c = 0; c < DC; ++c) r[lane * DC + c] = acc[c];
      if (lane == 0) {
        r[D] = m;
        r[D + 1] = lsum;
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = finish(a.count + n * Hkv + hk, P);
    __syncthreads();
    if (!*last) return;
    __threadfence();
    if (warp < G) {
      const float* r0 = mine - int64_t(p) * G * (D + 2) + warp * (D + 2);
      m = kNegInf;
      for (int q = 0; q < P; ++q)
        m = fmaxf(m, __ldcg(r0 + int64_t(q) * G * (D + 2) + D));
      lsum = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] = 0.f;
      for (int q = 0; q < P; ++q) {
        const float* r = r0 + int64_t(q) * G * (D + 2);
        const float w = expf(__ldcg(r + D) - m);
        lsum = fmaf(__ldcg(r + D + 1), w, lsum);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          acc[c] = fmaf(__ldcg(r + lane * DC + c), w, acc[c]);
      }
    }
  }
  if (warp >= G) return;

  // flash-decoding combine with ring positions j <= t (f32 probabilities)
  const float* qw = Qs + warp * D;
  for (int j0 = 0; j0 <= t; j0 += 32) {
    const int j = j0 + lane;
    float s = kNegInf;
    if (j <= t) {
      const T* kr = rk + (int64_t(j) * Hkv + hk) * D;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qw[d], ld_cg(kr + d), dot);
      s = dot * a.scale;
    }
    const float m_new = fmaxf(m, group_max<32>(s));
    const float alpha = expf(m - m_new);
    const float pr = j <= t ? expf(s - m_new) : 0.f;
    lsum = lsum * alpha + group_sum<32>(pr);
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
    const int nj = min(32, t + 1 - j0);
    for (int jj = 0; jj < nj; ++jj) {
      const float pj = __shfl_sync(kFullMask, pr, jj);
      const T* vr = rv + (int64_t(j0 + jj) * Hkv + hk) * D + lane * DC;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] = fmaf(pj, ld_cg(vr + c), acc[c]);
    }
    m = m_new;
  }
  T* out = static_cast<T*>(a.att) + int64_t(n) * Mq + (hk * G + warp) * D
           + lane * DC;
#pragma unroll
  for (int c = 0; c < DC; ++c) out[c] = from_f32<T>(acc[c] / lsum);
}

// (v, i) beats (bv, bi) as a row's greedy pick: a larger logit, or the
// same logit at a lower vocab index (the first maximum wins)
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The multi-step form's E1 and E2, after the last layer of a step: the
// final RMSNorm of x applied while the head's input rows are staged, then
// the head product over this block's share of the vocabulary with a
// running (max, first index) a row over the logits rounded to the model
// dtype; the block's best goes to hmax/hidx[blockIdx.x][n]. A dense or
// int8 [h, V] head streams in 32-column tiles (an int8 column's scale
// multiplies its complete f32 sum); the tied head's vocab columns are
// contiguous rows of embed [V, h], a warp each. Each block takes its
// tiles or rows in ascending order, so a strict > keeps its first
// maximum; commit_row reduces across blocks with `better`. Needs
// h <= kChunkRows (the screen checks it).
template <typename T, int NS>
__device__ void head_argmax(const Args& a, const GemvSmem<T, NS>& sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = a.N, h = a.h, V = a.V;
  const T* x = static_cast<const T*>(a.x);
  const NormIn<T> in{x, static_cast<const T*>(a.final_norm), sm.rn, h};
  rms_factors(x, N, h, a.eps, sm);
  stage(in, 0, h, N, sm);
  float best = -INFINITY;      // thread n < N: row n's best in this block
  int bidx = 0x7fffffff;
  if (a.head_mode == kHeadTied) {
    constexpr int kV = 16 / int(sizeof(T));    // columns of a 16-byte load
    const T* emb = static_cast<const T*>(a.embed);
    float wb[NS];
    int wi[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      wb[n] = -INFINITY;
      wi[n] = 0x7fffffff;
    }
    for (int v = blockIdx.x * kWarps + warp; v < V;
         v += gridDim.x * kWarps) {
      const T* row = emb + int64_t(v) * h;
      float acc[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) acc[n] = 0.f;
      for (int k = lane * kV; k < h; k += 32 * kV) {
        float wf[kV];
        unpack(ld_weights(row + k), wf);
#pragma unroll
        for (int n = 0; n < NS; ++n)
          if (n < N)
#pragma unroll
            for (int j = 0; j < kV; ++j)
              acc[n] = fmaf(to_f32(sm.xs[n * kChunkRows + k + j]), wf[j],
                            acc[n]);
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        if (n < N) {
          const float lg = round_to<T>(group_sum<32>(acc[n]));
          if (lg > wb[n]) {
            wb[n] = lg;
            wi[n] = v;
          }
        }
      }
    }
    // the warps' bests meet in shared memory (sm.red is free here)
    int* ri = reinterpret_cast<int*>(sm.red + kWarps * NS);
    if (lane == 0)
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        sm.red[warp * NS + n] = wb[n];
        ri[warp * NS + n] = wi[n];
      }
    __syncthreads();
    if (tid < N)
      for (int w = 0; w < kWarps; ++w)
        if (better(sm.red[w * NS + tid], ri[w * NS + tid], best, bidx)) {
          best = sm.red[w * NS + tid];
          bidx = ri[w * NS + tid];
        }
  } else {
    const __nv_bfloat16* hs =
        static_cast<const __nv_bfloat16*>(a.head_scale);
    for (int c0 = blockIdx.x * kTileCols; c0 < V;
         c0 += gridDim.x * kTileCols) {
      if (a.head_mode == kHeadInt8)
        gemv_tile(static_cast<const int8_t*>(a.head), 0, h, V, c0, N, in, sm,
                  sm.out0, true);
      else
        gemv_tile(static_cast<const T*>(a.head), 0, h, V, c0, N, in, sm,
                  sm.out0, true);
      if (tid < N)
        for (int col = 0; col < kTileCols; ++col) {
          float lg = sm.out0[tid * kTileCols + col];
          if (a.head_mode == kHeadInt8)
            lg = __fmul_rn(lg, __bfloat162float(hs[c0 + col]));
          lg = round_to<T>(lg);
          if (lg > best) {
            best = lg;
            bidx = c0 + col;
          }
        }
    }
  }
  if (tid < N) {
    a.hmax[int64_t(blockIdx.x) * N + tid] = best;
    a.hidx[int64_t(blockIdx.x) * N + tid] = bidx;
  }
}

// The multi-step form's E3 for row n, in block n after a grid barrier:
// the row's pick over every block's best (`better`: the larger logit,
// then the lower index), then the TPU kernel's bookkeeping — a row
// decodes while it is active and not done; it emits its pick (-1
// otherwise), advances its length, spends its budget and is done at its
// eos or with its budget spent — and embed[last] as the row's next
// input. The state is read and written past L1: other blocks read the
// lengths after the next barrier. `smem` is free scratch here.
template <typename T>
__device__ void commit_row(const Args& a, int step, int n,
                           unsigned char* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = a.N, h = a.h;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int b = tid; b < int(gridDim.x); b += kThreads) {
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
  float* wv = reinterpret_cast<float*>(smem);       // [kWarps]
  int* wi = reinterpret_cast<int*>(smem) + kWarps;  // [kWarps]
  int* next = wi + kWarps;
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 0; w < kWarps; ++w)
      if (better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    int* st = a.state;
    const int last = __ldcg(st + n), len = __ldcg(st + N + n);
    const int done = __ldcg(st + 2 * N + n), rem = __ldcg(st + 3 * N + n);
    const bool act = a.active[n] != 0 && done == 0;
    const int rem2 = rem - int(act);
    const bool done2 = done != 0 || (act && a.eos[n] >= 0 && bi == a.eos[n])
                       || (act && rem2 <= 0);
    const int last2 = act ? bi : last;
    a.emitted[int64_t(step) * N + n] = act ? bi : -1;
    __stcg(st + n, last2);
    __stcg(st + N + n, len + int(act));
    __stcg(st + 2 * N + n, int(done2));
    __stcg(st + 3 * N + n, rem2);
    *next = last2;
  }
  __syncthreads();
  const T* src = static_cast<const T*>(a.embed) + int64_t(*next) * h;
  T* dst = static_cast<T*>(a.x) + int64_t(n) * h;
  for (int k = tid; k < h; k += kThreads) dst[k] = src[k];
}

// W: the weight matrices' type, T or int8_t; kMulti: the multi-step
// form (mega_decode_loop: n_steps greedy steps, each ending in
// head_argmax and commit_row), else one step at ring index t
template <typename T, int D, int NS, typename W, bool kMulti>
__global__ void __launch_bounds__(kThreads, 2)
mega_decode_kernel(const Args a) {
  constexpr bool kW8 = std::is_same<W, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;   // this block finished a tile or a walk
  cg::grid_group grid = cg::this_grid();
  const GemvSmem<T, NS> sm(smem);
  const int tid = threadIdx.x;
  const int N = a.N, h = a.h, F = a.F, Hkv = a.Hkv;
  const int Mq = Hkv * a.G * D, Mkv = Hkv * D, Mqkv = Mq + 2 * Mkv;
  T* x = static_cast<T*>(a.x);
  T* qkv = static_cast<T*>(a.qkv);
  T* att = static_cast<T*>(a.att);
  T* gu = static_cast<T*>(a.gu);
  const void* const wmats[7] = {a.wq, a.wk, a.wv, a.wo, a.w_gate, a.w_up,
                                a.w_down};
  enum { kWq, kWk, kWv, kWo, kWg, kWu, kWd };

  // matrix m (wq .. w_down, [L, K, M]) of layer l: its first element
  auto wmat = [&](int m, int l, int64_t KM) -> const void* {
    return static_cast<const W*>(wmats[m]) + int64_t(l) * KM;
  };
  // the scale of column `col` of matrix m of layer l (M columns); 1 for
  // dense weights, where the f32 sum times it is the sum itself
  auto wscale = [&](int m, int l, int M, int col) -> float {
    if constexpr (kW8)
      return __bfloat162float(static_cast<const __nv_bfloat16*>(
          a.wscale[m])[int64_t(l) * M + col]);
    else
      return 1.f;
  };
  // one GEMV tile over the weights
  auto gemv = [&](const void* Wm, int kb, int ke, int M, int c0,
                  const auto& in, float* out, bool staged) {
    gemv_tile(static_cast<const W*>(Wm), kb, ke, M, c0, N, in, sm, out,
              staged);
  };
  // x[n][c0 + col] += out[n][col] times its scale (matrix m of layer l,
  // M columns), rounded as the plain version rounds
  auto residual = [&](int c0, const float* out, int m, int l, int M) {
    for (int e = tid; e < N * kTileCols; e += kThreads) {
      const int col = c0 + e % kTileCols;
      T* xp = x + int64_t(e / kTileCols) * h + col;
      const float y = round_to<T>(__fmul_rn(out[e], wscale(m, l, M, col)));
      *xp = from_f32<T>(__fadd_rn(ld_cg(xp), y));
    }
  };
  // the k-range [kb, ke) of split s of S over K rows
  auto range = [](int s, int S, int K, int& kb, int& ke) {
    const int per = (K + S - 1) / S;
    kb = min(K, s * per);
    ke = min(K, kb + per);
  };

  const int s_qkv = splits(Mqkv / kTileCols, h);
  const int s_wo = splits(h / kTileCols, Mq);
  const int s_gu = splits(F / kTileCols, h);
  const int s_down = splits(h / kTileCols, F);
  // each slot's walk splits into `parts`, so the phase fills the grid
  const int parts = max(1, min(kMaxSplits, int(gridDim.x) / (N * Hkv)));

  const int n_steps = kMulti ? a.n_steps : 1;
  for (int step = 0; step < n_steps; ++step) {
    // the ring index of this step
    const int t = kMulti ? step : a.t;
    for (int l = 0; l < a.L; ++l) {
      const T* an = static_cast<const T*>(a.attn_norm) + int64_t(l) * h;
      const T* mn = static_cast<const T*>(a.mlp_norm) + int64_t(l) * h;

      // 1. q, k, v of the normed rows
      bool normed = false;
      for (int item = blockIdx.x; item < Mqkv / kTileCols * s_qkv;
           item += gridDim.x) {
        if (!normed) {
          rms_factors(x, N, h, a.eps, sm);
          normed = true;
        }
        const int c0 = item / s_qkv * kTileCols, sp = item % s_qkv;
        int kb, ke;
        range(sp, s_qkv, h, kb, ke);
        int m, M, cc;
        if (c0 < Mq) {
          m = kWq;
          M = Mq;
          cc = c0;
        } else if (c0 < Mq + Mkv) {
          m = kWk;
          M = Mkv;
          cc = c0 - Mq;
        } else {
          m = kWv;
          M = Mkv;
          cc = c0 - Mq - Mkv;
        }
        gemv(wmat(m, l, int64_t(h) * M), kb, ke, M, cc,
             NormIn<T>{x, an, sm.rn, h}, sm.out0, false);
        if (sum_splits(sm, &last, 1, 0, a.part, a.count + c0 / kTileCols, sp,
                       s_qkv, N, Mqkv, c0))
          for (int e = tid; e < N * kTileCols; e += kThreads) {
            const int col = e % kTileCols;
            qkv[int64_t(e / kTileCols) * Mqkv + c0 + col] = from_f32<T>(
                __fmul_rn(sm.out0[e], wscale(m, l, M, cc + col)));
          }
      }
      grid.sync();

      // 2. attention: (slot, kv head, part of the walk) a block
      for (int item = blockIdx.x; item < N * Hkv * parts; item += gridDim.x) {
        const int n = item / parts / Hkv, hk = item / parts % Hkv;
        // the multi-step form moves the lengths in the kernel: past L1
        const float pos = float(kMulti ? __ldcg(a.lens + n) : a.lens[n]);
        if (a.kv_int8)
          attention_item<T, int8_t, D>(a, l, n, hk, item % parts, parts, t,
                                       pos, &last, smem);
        else
          attention_item<T, T, D>(a, l, n, hk, item % parts, parts, t, pos,
                                  &last, smem);
      }
      grid.sync();

      // 3. x += att @ wo
      const void* wo = wmat(kWo, l, int64_t(Mq) * h);
      for (int item = blockIdx.x; item < h / kTileCols * s_wo;
           item += gridDim.x) {
        const int c0 = item / s_wo * kTileCols, sp = item % s_wo;
        int kb, ke;
        range(sp, s_wo, Mq, kb, ke);
        gemv(wo, kb, ke, h, c0, RawIn<T>{att, Mq}, sm.out0, false);
        if (sum_splits(sm, &last, 1, 0, a.part, a.count + c0 / kTileCols, sp,
                       s_wo, N, h, c0))
          residual(c0, sm.out0, kWo, l, h);
      }
      grid.sync();

      // 4. gu = SiLU(hn @ w_gate) * (hn @ w_up) of the normed rows
      const void* wg = wmat(kWg, l, int64_t(h) * F);
      const void* wu = wmat(kWu, l, int64_t(h) * F);
      normed = false;
      for (int item = blockIdx.x; item < F / kTileCols * s_gu;
           item += gridDim.x) {
        if (!normed) {
          rms_factors(x, N, h, a.eps, sm);
          normed = true;
        }
        const int c0 = item / s_gu * kTileCols, sp = item % s_gu;
        int kb, ke;
        range(sp, s_gu, h, kb, ke);
        const NormIn<T> in{x, mn, sm.rn, h};
        // one staging of the range serves both products when it fits
        const bool once = ke - kb <= kChunkRows;
        if (once) stage(in, kb, ke - kb, N, sm);
        gemv(wg, kb, ke, F, c0, in, sm.out0, once);
        gemv(wu, kb, ke, F, c0, in, sm.out1, once);
        if (sum_splits(sm, &last, 2, F, a.part, a.count + c0 / kTileCols, sp,
                       s_gu, N, 2 * F, c0))
          for (int e = tid; e < N * kTileCols; e += kThreads) {
            const int col = c0 + e % kTileCols;
            const float g =
                round_to<T>(__fmul_rn(sm.out0[e], wscale(kWg, l, F, col)));
            const float sg = round_to<T>(__fdiv_rn(g, 1.f + expf(-g)));
            const float u =
                round_to<T>(__fmul_rn(sm.out1[e], wscale(kWu, l, F, col)));
            gu[int64_t(e / kTileCols) * F + col] =
                from_f32<T>(__fmul_rn(sg, u));
          }
      }
      grid.sync();

      // 5. x += gu @ w_down
      const void* wd = wmat(kWd, l, int64_t(F) * h);
      for (int item = blockIdx.x; item < h / kTileCols * s_down;
           item += gridDim.x) {
        const int c0 = item / s_down * kTileCols, sp = item % s_down;
        int kb, ke;
        range(sp, s_down, F, kb, ke);
        gemv(wd, kb, ke, h, c0, RawIn<T>{gu, F}, sm.out0, false);
        if (sum_splits(sm, &last, 1, 0, a.part, a.count + c0 / kTileCols, sp,
                       s_down, N, h, c0))
          residual(c0, sm.out0, kWd, l, h);
      }
      if (l + 1 < a.L) grid.sync();
    }
    if constexpr (kMulti) {
      grid.sync();                        // x after the last layer
      head_argmax<T, NS>(a, sm);          // E1, E2
      grid.sync();
      if (int(blockIdx.x) < N)                                  // E3
        commit_row<T>(a, step, blockIdx.x, smem);
      if (step + 1 < n_steps) grid.sync();   // E4: the next step's input
    }
  }
}

// blocks of the kernel one SM holds at once (0 when none fits)
template <typename T, int D, int NS, typename W, bool kMulti>
cudaError_t blocks_per_sm(int* per_sm) {
  constexpr int smem = smem_bytes<T, D, NS>();
  cudaError_t err = cudaFuncSetAttribute(
      mega_decode_kernel<T, D, NS, W, kMulti>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, mega_decode_kernel<T, D, NS, W, kMulti>, kThreads, smem);
}

template <typename T, int D, int NS, typename W, bool kMulti>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // the grid: every block co-resident, sized once per device
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
    grid_dev = dev;
    grid_blocks = per_sm * sms;
  }
  // the multi-step form's per-block scratch holds hcap blocks, and
  // commit_row takes a block a row
  if (kMulti && (grid_blocks > a.hcap || grid_blocks < a.N))
    return cudaErrorInvalidValue;
  void* args[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_decode_kernel<T, D, NS, W, kMulti>),
      dim3(grid_blocks), dim3(kThreads), args, smem_bytes<T, D, NS>(),
      stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}


// launch<T, D, NS, W, kMulti> for D (64, 128) and N rows (the 4- or
// 8-row instantiation), and the occupancy of the same instantiation
template <typename T, typename W, bool kMulti>
cudaError_t launch_shape(const Args& a, int D, int N, cudaStream_t st) {
  if (N < 1 || N > 8) return cudaErrorInvalidValue;
  if (D == 128)
    return N <= 4 ? launch<T, 128, 4, W, kMulti>(a, st)
                  : launch<T, 128, 8, W, kMulti>(a, st);
  if (D == 64)
    return N <= 4 ? launch<T, 64, 4, W, kMulti>(a, st)
                  : launch<T, 64, 8, W, kMulti>(a, st);
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
#define PTT_MEGA_FORM(NAME)                                              \
  cudaError_t launch_##NAME(const Args& a, int D, int N, cudaStream_t st); \
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
