// The ragged paged-decode walk of one (slot, kv head), as device code
// shared by the ragged decode kernel (ragged_decode.cu, B4) and the
// persistent decode megakernel (mega_decode.cu, B5).
//
// The walk reads one slot's block table up to its true length over one
// layer of a [L, NB, BS, Hkv, D] pool and runs an online softmax for the
// G query heads of one kv head: warp g < G scores query head g, every
// K/V row is read from device memory once and shared by the G warps
// through shared memory. It stages 64 positions at a time (each
// position's block looked up on its own, so any block size works) with
// 16-byte cp.async copies, double-buffered: the next tile's copies are in
// flight while the current one is scored (B5 walks with four 32-position
// stages, three in flight). Each lane scores two (or one) positions,
// positions at or past the length are masked to -1e30 before the running
// max, and the accumulators stay in f32 registers.
// Probabilities are rounded to the pool dtype before the PV product, as
// the TPU kernel does.
//
// int8 pools (T = int8_t) carry one f32 scale per (position, kv head) in
// [L, NB, BS, Hkv] scale pools. Their rows are staged unconverted, D + 16
// bytes a row (16 int8 a 16-byte copy), and each position's K and V
// scales are staged beside them with 4-byte cp.async copies. The
// arithmetic is the TPU kernel's int8 branch: the score is (q . k) in f32
// times the softmax scale times the K scale; l sums the unscaled
// probabilities; the probabilities are not rounded, and the PV product
// takes p times the V scale against the widened V row, in f32.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace walk {

constexpr int kTile = 64;     // positions staged per step (two per lane)
constexpr int kMaxGroup = 8;  // query heads per kv head (computing warps)
constexpr int kStages = 2;    // tiles in shared memory: current and next

// kTileP positions a stage (64: two a lane, or 32: one a lane) and
// kStagesP stages; B4 walks with the defaults, B5 with four 32-position
// stages (the same bytes, three tiles in flight ahead of the one scored)
template <typename T, int D, int kTileP = kTile, int kStagesP = kStages>
struct Layout {
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  // +16 bytes a row: lane t reading 16 bytes of row t is conflict-free
  static constexpr int kRowBytes = D * int(sizeof(T)) + 16;
  static constexpr int kVecs = D * int(sizeof(T)) / 16;  // 16-byte copies a row
  static constexpr int kPer = 16 / int(sizeof(T));       // elements a copy
  // K rows, V rows, then (int8) the K and V scales of the tile's positions
  static constexpr int kScaleBytes = kInt8 ? 2 * kTileP * 4 : 0;
  static constexpr int kStageBytes = 2 * kTileP * kRowBytes + kScaleBytes;
  // the staging buffers, then the group's queries in f32
  static constexpr int kSmem = kStagesP * kStageBytes + kMaxGroup * D * 4;
};

// until at most `ahead` (< S) of this thread's cp.async groups are pending
template <int S>
__device__ __forceinline__ void cp_async_wait_upto(int ahead) {
  if constexpr (S > 3) {
    if (ahead >= 3) {
      cp_async_wait<3>();
      return;
    }
  }
  if constexpr (S > 2) {
    if (ahead == 2) {
      cp_async_wait<2>();
      return;
    }
  }
  if (ahead == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// 16 bytes of shared memory as f32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// N (even) consecutive elements of shared memory as f32
template <int N>
__device__ __forceinline__ void load_pairs(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    out[i] = v.x;
    out[i + 1] = v.y;
  }
}
template <int N>
__device__ __forceinline__ void load_pairs(const __nv_bfloat16* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    out[i] = v.x;
    out[i + 1] = v.y;
  }
}

// int8: 16 values of one 16-byte piece, and N (2 or 4) consecutive values
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[4 * i + j] = float(static_cast<int8_t>(w[i] >> (8 * j)));
}
template <int N>
__device__ __forceinline__ void load_pairs(const int8_t* p, float* out) {
  static_assert(N == 2 || N == 4, "int8 rows give 2 or 4 values a lane");
  if constexpr (N == 4) {
    const char4 v = *reinterpret_cast<const char4*>(p);
    out[0] = float(v.x);
    out[1] = float(v.y);
    out[2] = float(v.z);
    out[3] = float(v.w);
  } else {
    const char2 v = *reinterpret_cast<const char2*>(p);
    out[0] = float(v.x);
    out[1] = float(v.y);
  }
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// The block-wide barrier and thread count of a walk: the whole block
// (B4). B5 walks with its consumer threads only and passes its own.
struct BlockSync {
  __device__ static void sync() { __syncthreads(); }
  __device__ static int threads() { return blockDim.x; }
};

// The walk over positions [begin, end) of one slot for the G
// (<= kMaxGroup) query heads of kv head `hk`. Every thread of the block takes part (the
// copies and the barriers); warp g < G leaves its query head's state in
// m, l and acc (lane holds columns lane*D/32 ...). `smem` holds
// Layout::kSmem bytes with the queries (f32, [G][D]) already at offset
// kStagesP * kStageBytes; `tbl` is the slot's block table (shared or
// global memory). `ks_pool`/`vs_pool` are the [L, NB, BS, Hkv] f32 scale
// pools of int8 pools (unused otherwise). A walk of any tile ends with a
// barrier; the caller syncs before it writes the queries of
// another walk. `Sync` names the threads that take part (every thread
// of the block unless a caller says otherwise) and their barrier.
template <typename T, int D, typename Sync = BlockSync, int kTileP = kTile,
          int kStagesP = kStages>
__device__ __forceinline__ void ragged_walk(
    const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const float* __restrict__ ks_pool, const float* __restrict__ vs_pool,
    const int* tbl, int begin, int end, int layer, int NB, int BS, int Hkv,
    int hk, int G, float scale, unsigned char* smem, float& m, float& l,
    float (&acc)[D / 32]) {
  static_assert(kTileP == 32 || kTileP == 64, "one or two positions a lane");
  using Lay = Layout<T, D, kTileP, kStagesP>;
  constexpr int kPL = kTileP / 32;   // positions a lane scores
  const float* Qs = reinterpret_cast<const float*>(
      smem + kStagesP * Lay::kStageBytes);
  const int tid = threadIdx.x, nthreads = Sync::threads();
  const int warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (max(end - begin, 0) + kTileP - 1) / kTileP;

  const int64_t tok_stride = int64_t(Hkv) * D;   // elements
  const int64_t blk_stride = BS * tok_stride;
  const int64_t base0 = int64_t(layer) * NB * blk_stride + int64_t(hk) * D;
  // the scale of head hk at (layer, blk, off): ((layer*NB + blk)*BS + off)*Hkv + hk
  const int64_t sbase0 = int64_t(layer) * NB * BS * Hkv + hk;

  // copies of tile `tile` into buffer `buf`: K rows, then V rows, then
  // (int8) the positions' K and V scales
  auto stage = [&](int tile, int buf) {
    unsigned char* ks = smem + buf * Lay::kStageBytes;
    unsigned char* vs = ks + kTileP * Lay::kRowBytes;
    for (int e = tid; e < kTileP * Lay::kVecs; e += nthreads) {
      const int t = e / Lay::kVecs, c = e % Lay::kVecs;
      const int p = begin + tile * kTileP + t;
      const bool live = p < end;
      const int64_t off = live ? base0 + int64_t(tbl[p / BS]) * blk_stride
                                     + int64_t(p % BS) * tok_stride
                               : 0;
      const int sm = t * Lay::kRowBytes + c * 16;
      cp_async16(ks + sm, k_pool + off + c * Lay::kPer, live);
      cp_async16(vs + sm, v_pool + off + c * Lay::kPer, live);
    }
    if constexpr (Lay::kInt8) {
      float* kss = reinterpret_cast<float*>(vs + kTileP * Lay::kRowBytes);
      for (int t = tid; t < kTileP; t += nthreads) {
        const int p = begin + tile * kTileP + t;
        const bool live = p < end;
        const int64_t so = live ? sbase0 + (int64_t(tbl[p / BS]) * BS
                                            + p % BS) * Hkv
                                : 0;
        cp_async4(kss + t, ks_pool + so, live);
        cp_async4(kss + kTileP + t, vs_pool + so, live);
      }
    }
    cp_async_commit();
  };

  constexpr int DC = D / 32;   // output columns per lane: lane*DC ...
  m = kNegInf;
  l = 0.f;
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  // kStagesP - 1 tiles in flight ahead of the one scored
  for (int j = 0; j < kStagesP - 1; ++j)
    if (j < n_tiles) stage(j, j);
  for (int i = 0; i < n_tiles; ++i) {
    const int next = i + kStagesP - 1;
    if (next < n_tiles) stage(next, next % kStagesP);
    // tile i landed; the tiles after it still in flight
    cp_async_wait_upto<kStagesP>(min(kStagesP - 1, n_tiles - 1 - i));
    Sync::sync();              // tile i visible to every warp
    if (warp < G) {
      const unsigned char* ks = smem + (i % kStagesP) * Lay::kStageBytes;
      const unsigned char* vs = ks + kTileP * Lay::kRowBytes;
      const float* kss = reinterpret_cast<const float*>(vs + kTileP * Lay::kRowBytes);
      const float* qw = Qs + warp * D;

      // warp = query head of the group; lane scores positions lane (and
      // lane+32 in a 64-position tile)
      float s[kPL];
#pragma unroll
      for (int h = 0; h < kPL; ++h) {
        const int t = lane + 32 * h;
        const T* krow = reinterpret_cast<const T*>(ks + t * Lay::kRowBytes);
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < Lay::kVecs; ++c) {
          float kf[Lay::kPer];
          load16(krow + c * Lay::kPer, kf);
#pragma unroll
          for (int j = 0; j < Lay::kPer; ++j)
            dot = fmaf(qw[c * Lay::kPer + j], kf[j], dot);
        }
        float sc = dot * scale;
        if constexpr (Lay::kInt8) sc *= kss[t];
        s[h] = (begin + i * kTileP + t < end) ? sc : kNegInf;
      }
      float smax = s[0];
      if constexpr (kPL == 2) smax = fmaxf(s[0], s[1]);
      const float m_new = fmaxf(m, group_max<32>(smax));
      const float alpha = expf(m - m_new);
      float pe[kPL];
#pragma unroll
      for (int h = 0; h < kPL; ++h) pe[h] = expf(s[h] - m_new);
      float psum = pe[0];
      if constexpr (kPL == 2) psum = pe[0] + pe[1];
      l = l * alpha + group_sum<32>(psum);
      float pr[kPL];
#pragma unroll
      for (int h = 0; h < kPL; ++h) {
        if constexpr (Lay::kInt8)   // the V scale rides the (unrounded) probabilities
          pr[h] = pe[h] * kss[kTileP + lane + 32 * h];
        else
          pr[h] = round_to<T>(pe[h]);
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] *= alpha;
#pragma unroll
      for (int h = 0; h < kPL; ++h) {
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const float pt = __shfl_sync(kFullMask, pr[h], j);
          const T* vrow =
              reinterpret_cast<const T*>(vs + (32 * h + j) * Lay::kRowBytes);
          float vv[DC];
          load_pairs<DC>(vrow + lane * DC, vv);
#pragma unroll
          for (int c = 0; c < DC; ++c) acc[c] = fmaf(pt, vv[c], acc[c]);
        }
      }
      m = m_new;
    }
    Sync::sync();              // buffer i % kStagesP is free for tile next
  }
}

}  // namespace walk
}  // namespace ptt
