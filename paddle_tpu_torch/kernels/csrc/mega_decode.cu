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
// Later PRs: wgmma and TMA-fed weight tiles, int8 weights and pools
// (ROADMAP A4), and the multi-step draft form (ROADMAP A6).
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "ragged_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace ptt;

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
  const void* k_pool;      // [L, NB, BS, Hkv, D]
  const void* v_pool;
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
};

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

// The GEMV layout for NS (4 or 8) accumulator rows: thread (k-group kg,
// load column c) holds NS x kVec f32 sums and kUnroll loads in flight
// (8 at NS = 4, 4 at NS = 8, so the sums and loads fit the registers).
template <typename T, int NS>
struct Gemv {
  static constexpr int kVec = 16 / int(sizeof(T));   // columns a load
  static constexpr int kCh = kTileCols / kVec;       // loads a tile row
  static constexpr int kGroups = kThreads / kCh;     // k-groups a block
  static constexpr int kUnroll = NS <= 4 ? 8 : 4;
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

template <typename T, int D, int NS>
constexpr int smem_bytes() {
  constexpr int walk = walk::Layout<T, D>::kSmem;
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
// n < N, in f32: W is [K, M] row-major. Thread (kg, c) walks rows
// kg, kg + kGroups, ... of each staged chunk; the k-groups of a warp sum
// by shuffles, the warps through shared memory. With `staged` the rows
// [kb, ke) (at most kChunkRows) are already in xs. `out` is ready when
// this returns (after a barrier).
template <typename T, int NS, typename In>
__device__ void gemv_tile(const T* __restrict__ W, int kb, int ke, int M,
                          int c0, int N, const In& in,
                          const GemvSmem<T, NS>& sm, float* out,
                          bool staged) {
  using V = Gemv<T, NS>;
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
    const T* wcol = W + int64_t(k0) * M + c0 + c * V::kVec;
    for (int kk = kg; kk < kc; kk += V::kGroups * V::kUnroll) {
      uint4 wv[V::kUnroll];
#pragma unroll
      for (int u = 0; u < V::kUnroll; ++u) {
        const int k = kk + u * V::kGroups;
        wv[u] = k < kc ? ld_weights(wcol + int64_t(k) * M)
                       : make_uint4(0u, 0u, 0u, 0u);
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

// Phase 2 for slot n, kv head hk of layer l, part p of P: RoPE of the
// group's queries (and, in part 0, of the fresh k, written with v into
// ring row t); the walk over the part's share of the pool prefix (whole
// 64-position tiles); with P > 1 the part's (m, l, acc) go to `part` and
// the block that finishes the slot's last part merges the P in order
// p = 0..P-1 (the result does not depend on which block is last); then
// the combine with ring rows j <= t and the attention output.
template <typename T, int D>
__device__ void attention_item(const Args& a, int l, int n, int hk, int p,
                               int P, int* last, unsigned char* smem) {
  using Lay = walk::Layout<T, D>;
  constexpr int D2 = D / 2, DC = D / 32;
  float* Qs = reinterpret_cast<float*>(smem + walk::kStages * Lay::kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.G, Hkv = a.Hkv, t = a.t;
  const int Mq = Hkv * G * D, Mqkv = Mq + 2 * Hkv * D;
  const T* qkv = static_cast<const T*>(a.qkv) + int64_t(n) * Mqkv;
  const int64_t ring0 = (int64_t(l) * a.N + n) * a.S * Hkv * D;
  T* rk = static_cast<T*>(a.ring_k) + ring0;   // [S, Hkv, D]
  T* rv = static_cast<T*>(a.ring_v) + ring0;

  __syncthreads();   // the previous item is done with Qs
  const float pos = float(a.lens[n]);
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
  walk::ragged_walk<T, D>(static_cast<const T*>(a.k_pool),
                          static_cast<const T*>(a.v_pool),
                          a.table + int64_t(n) * a.MB, begin, end, l, a.NB,
                          a.BS, Hkv, hk, G, a.scale, smem, m, lsum, acc);
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

template <typename T, int D, int NS>
__global__ void __launch_bounds__(kThreads, 2)
mega_decode_kernel(const Args a) {
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

  // x[n][c0 + col] += out[n][col], rounded as the plain version rounds
  auto residual = [&](int c0, const float* out) {
    for (int e = tid; e < N * kTileCols; e += kThreads) {
      T* xp = x + int64_t(e / kTileCols) * h + c0 + e % kTileCols;
      *xp = from_f32<T>(__fadd_rn(ld_cg(xp), round_to<T>(out[e])));
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
      const T* W;
      int M, cc;
      if (c0 < Mq) {
        W = static_cast<const T*>(a.wq) + int64_t(l) * h * Mq;
        M = Mq;
        cc = c0;
      } else if (c0 < Mq + Mkv) {
        W = static_cast<const T*>(a.wk) + int64_t(l) * h * Mkv;
        M = Mkv;
        cc = c0 - Mq;
      } else {
        W = static_cast<const T*>(a.wv) + int64_t(l) * h * Mkv;
        M = Mkv;
        cc = c0 - Mq - Mkv;
      }
      gemv_tile(W, kb, ke, M, cc, N, NormIn<T>{x, an, sm.rn, h}, sm,
                sm.out0, false);
      if (sum_splits(sm, &last, 1, 0, a.part, a.count + c0 / kTileCols, sp, s_qkv,
                     N, Mqkv, c0))
        for (int e = tid; e < N * kTileCols; e += kThreads)
          qkv[int64_t(e / kTileCols) * Mqkv + c0 + e % kTileCols] =
              from_f32<T>(sm.out0[e]);
    }
    grid.sync();

    // 2. attention: (slot, kv head, part of the walk) a block
    for (int item = blockIdx.x; item < N * Hkv * parts; item += gridDim.x)
      attention_item<T, D>(a, l, item / parts / Hkv, item / parts % Hkv,
                           item % parts, parts, &last, smem);
    grid.sync();

    // 3. x += att @ wo
    const T* wo = static_cast<const T*>(a.wo) + int64_t(l) * Mq * h;
    for (int item = blockIdx.x; item < h / kTileCols * s_wo;
         item += gridDim.x) {
      const int c0 = item / s_wo * kTileCols, sp = item % s_wo;
      int kb, ke;
      range(sp, s_wo, Mq, kb, ke);
      gemv_tile(wo, kb, ke, h, c0, N, RawIn<T>{att, Mq}, sm, sm.out0, false);
      if (sum_splits(sm, &last, 1, 0, a.part, a.count + c0 / kTileCols, sp, s_wo, N,
                     h, c0))
        residual(c0, sm.out0);
    }
    grid.sync();

    // 4. gu = SiLU(hn @ w_gate) * (hn @ w_up) of the normed rows
    const T* wg = static_cast<const T*>(a.w_gate) + int64_t(l) * h * F;
    const T* wu = static_cast<const T*>(a.w_up) + int64_t(l) * h * F;
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
      gemv_tile(wg, kb, ke, F, c0, N, in, sm, sm.out0, once);
      gemv_tile(wu, kb, ke, F, c0, N, in, sm, sm.out1, once);
      if (sum_splits(sm, &last, 2, F, a.part, a.count + c0 / kTileCols, sp, s_gu, N,
                     2 * F, c0))
        for (int e = tid; e < N * kTileCols; e += kThreads) {
          const float g = round_to<T>(sm.out0[e]);
          const float sg = round_to<T>(__fdiv_rn(g, 1.f + expf(-g)));
          const float u = round_to<T>(sm.out1[e]);
          gu[int64_t(e / kTileCols) * F + c0 + e % kTileCols] =
              from_f32<T>(__fmul_rn(sg, u));
        }
    }
    grid.sync();

    // 5. x += gu @ w_down
    const T* wd = static_cast<const T*>(a.w_down) + int64_t(l) * F * h;
    for (int item = blockIdx.x; item < h / kTileCols * s_down;
         item += gridDim.x) {
      const int c0 = item / s_down * kTileCols, sp = item % s_down;
      int kb, ke;
      range(sp, s_down, F, kb, ke);
      gemv_tile(wd, kb, ke, h, c0, N, RawIn<T>{gu, F}, sm, sm.out0, false);
      if (sum_splits(sm, &last, 1, 0, a.part, a.count + c0 / kTileCols, sp, s_down,
                     N, h, c0))
        residual(c0, sm.out0);
    }
    if (l + 1 < a.L) grid.sync();
  }
}

// blocks of the kernel one SM holds at once (0 when none fits)
template <typename T, int D, int NS>
cudaError_t blocks_per_sm(int* per_sm) {
  constexpr int smem = smem_bytes<T, D, NS>();
  cudaError_t err = cudaFuncSetAttribute(
      mega_decode_kernel<T, D, NS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, mega_decode_kernel<T, D, NS>, kThreads, smem);
}

template <typename T, int D, int NS>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // the grid: every block co-resident, sized once per device
  static int grid_dev = -1, grid_blocks = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev != grid_dev) {
    int per_sm = 0, sms = 0;
    err = blocks_per_sm<T, D, NS>(&per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    grid_dev = dev;
    grid_blocks = per_sm * sms;
  }
  void* args[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(mega_decode_kernel<T, D, NS>),
      dim3(grid_blocks), dim3(kThreads), args, smem_bytes<T, D, NS>(),
      stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiation for dtype, D and N rows: f(tag) with tag's T, D, NS
template <typename F>
cudaError_t dispatch(int dtype, int D, int N, F f) {
  if (N < 1 || N > 8) return cudaErrorInvalidValue;
  const bool small = N <= 4;
  if (dtype == kF32 && D == 128)
    return small ? f(float(), std::integral_constant<int, 128>(),
                     std::integral_constant<int, 4>())
                 : f(float(), std::integral_constant<int, 128>(),
                     std::integral_constant<int, 8>());
  if (dtype == kF32 && D == 64)
    return small ? f(float(), std::integral_constant<int, 64>(),
                     std::integral_constant<int, 4>())
                 : f(float(), std::integral_constant<int, 64>(),
                     std::integral_constant<int, 8>());
  if (dtype == kBF16 && D == 128)
    return small ? f(__nv_bfloat16(), std::integral_constant<int, 128>(),
                     std::integral_constant<int, 4>())
                 : f(__nv_bfloat16(), std::integral_constant<int, 128>(),
                     std::integral_constant<int, 8>());
  if (dtype == kBF16 && D == 64)
    return small ? f(__nv_bfloat16(), std::integral_constant<int, 64>(),
                     std::integral_constant<int, 4>())
                 : f(__nv_bfloat16(), std::integral_constant<int, 64>(),
                     std::integral_constant<int, 8>());
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (weights, x, rings and pools all of it); D 64
// or 128; 1 <= N <= 8 rows; 1 <= G <= 8; h and F multiples of 32 (the
// wrapper checks; anything else returns cudaErrorInvalidValue). Every
// tensor is contiguous; x, the rings and the scratch are written, and
// `count` is zero on entry and on return.
extern "C" int ptt_mega_decode(
    const void* attn_norm, const void* mlp_norm, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* w_gate,
    const void* w_up, const void* w_down, const float* freq,
    const int* table, const int* walk_lens, const int* lens,
    const void* k_pool, const void* v_pool, void* ring_k, void* ring_v,
    void* x, void* qkv, void* att, void* gu, float* part, int* count, int L,
    int N, int h, int F, int Hkv, int G, int D, int NB, int BS, int MB,
    int S, int t, int dtype, float eps, float scale, void* stream) {
  if (G < 1 || G > walk::kMaxGroup || h % kTileCols || F % kTileCols
      || t < 0 || t >= S)
    return cudaErrorInvalidValue;
  const Args a{attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
               freq, table, walk_lens, lens, k_pool, v_pool, ring_k, ring_v,
               x, qkv, att, gu, part, count, L, N, h, F, Hkv, G, NB, BS, MB,
               S, t, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, D, N, [&](auto tv, auto dv, auto nv) {
    return launch<decltype(tv), decltype(dv)::value, decltype(nv)::value>(
        a, st);
  });
}

// blocks of the kernel an SM holds at once for dtype, D and N rows (the
// grid is this times the SM count), or minus a CUDA error code
extern "C" int ptt_mega_decode_blocks_per_sm(int dtype, int D, int N) {
  int per_sm = 0;
  const cudaError_t err = dispatch(dtype, D, N, [&](auto tv, auto dv,
                                                    auto nv) {
    return blocks_per_sm<decltype(tv), decltype(dv)::value,
                         decltype(nv)::value>(&per_sm);
  });
  return err == cudaSuccess ? per_sm : -int(err);
}
