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
// 3.35 TB/s.
//
// This design: one thread block per (slot, kv head) and one warp per
// query head of the GQA group (G = 4 at Llama-3-8B), so every K/V row is
// read from HBM once and shared by the G query heads through shared
// memory. The slot's block ids are copied to shared memory once; the
// walk stages 64 positions at a time (each position's block looked up on
// its own, so any block size works) with 16-byte cp.async copies,
// double-buffered: the next tile's copies are in flight while the
// current one is scored. Each lane scores two positions, positions at or
// past the length are masked to -1e30 before the running max, and the
// accumulators stay in f32 registers. Probabilities are rounded to the
// pool dtype before the PV product, as the TPU kernel does.
//
// A later PR should split each slot's walk over several blocks
// (split-K flash-decoding: N*Hkv blocks underfill 132 SMs at small
// batch and a long slot's walk is serial), and take int8 pools
// (ROADMAP A4).
#include <cstdint>

#include "common.cuh"

namespace {

using namespace ptt;

constexpr int kTile = 64;     // positions staged per step (two per lane)
constexpr int kMaxGroup = 8;  // query heads per kv head (warps per block)
constexpr int kStages = 2;    // tiles in shared memory: current and next

template <typename T, int D>
struct Layout {
  // +16 bytes a row: lane t reading 16 bytes of row t is conflict-free
  static constexpr int kRowBytes = D * int(sizeof(T)) + 16;
  static constexpr int kVecs = D * int(sizeof(T)) / 16;  // 16-byte copies a row
  static constexpr int kPer = 16 / int(sizeof(T));       // elements a copy
  static constexpr int kStageBytes = 2 * kTile * kRowBytes;  // K rows, V rows
  // + the group's queries in f32; the slot's block table follows
  static constexpr int kSmem = kStages * kStageBytes + kMaxGroup * D * 4;
};

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

template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxGroup)
ragged_decode_kernel(const T* __restrict__ q,        // [N, Hkv*G, D]
                     const T* __restrict__ k_pool,   // [L, NB, BS, Hkv, D]
                     const T* __restrict__ v_pool,
                     const int* __restrict__ table,  // [N, MB]
                     const int* __restrict__ lengths,  // [N]
                     float* __restrict__ acc_out,    // [N, Hkv, G, D]
                     float* __restrict__ m_out,      // [N, Hkv, G]
                     float* __restrict__ l_out,
                     int layer, int NB, int BS, int Hkv, int G, int MB,
                     float scale) {
  using Lay = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + kStages * Lay::kStageBytes);
  int* tbl = reinterpret_cast<int*>(Qs + kMaxGroup * D);   // [MB]

  const int n = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = max(0, min(lengths[n], MB * BS));
  const int n_tiles = (len + kTile - 1) / kTile;

  const T* qn = q + (int64_t(n) * Hkv * G + int64_t(hk) * G) * D;
  for (int e = tid; e < G * D; e += nthreads) Qs[e] = to_f32(qn[e]);
  // the blocks the walk reads, so a copy's block id is a shared-memory read
  const int* tbl_n = table + int64_t(n) * MB;
  for (int e = tid; e < (len + BS - 1) / BS; e += nthreads) tbl[e] = tbl_n[e];
  __syncthreads();

  const int64_t tok_stride = int64_t(Hkv) * D;   // elements
  const int64_t blk_stride = BS * tok_stride;
  const int64_t base0 = int64_t(layer) * NB * blk_stride + int64_t(hk) * D;

  // copies of tile `tile` into buffer `buf`: K rows, then V rows
  auto stage = [&](int tile, int buf) {
    unsigned char* ks = smem + buf * Lay::kStageBytes;
    unsigned char* vs = ks + kTile * Lay::kRowBytes;
    for (int e = tid; e < kTile * Lay::kVecs; e += nthreads) {
      const int t = e / Lay::kVecs, c = e % Lay::kVecs;
      const int p = tile * kTile + t;
      const bool live = p < len;
      const int64_t off = live ? base0 + int64_t(tbl[p / BS]) * blk_stride
                                     + int64_t(p % BS) * tok_stride
                               : 0;
      const int sm = t * Lay::kRowBytes + c * 16;
      cp_async16(ks + sm, k_pool + off + c * Lay::kPer, live);
      cp_async16(vs + sm, v_pool + off + c * Lay::kPer, live);
    }
    cp_async_commit();
  };

  constexpr int DC = D / 32;   // output columns per lane: lane*DC ...
  float m = kNegInf, l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;

  if (n_tiles > 0) stage(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      stage(i + 1, (i + 1) & 1);
      cp_async_wait<1>();      // tile i landed; tile i+1 still in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // tile i visible to every warp
    const unsigned char* ks = smem + (i & 1) * Lay::kStageBytes;
    const unsigned char* vs = ks + kTile * Lay::kRowBytes;
    const float* qw = Qs + warp * D;

    // warp = query head of the group; lane scores positions lane, lane+32
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
      s[h] = (i * kTile + t < len) ? dot * scale : kNegInf;
    }
    const float m_new = fmaxf(m, group_max<32>(fmaxf(s[0], s[1])));
    const float alpha = expf(m - m_new);
    const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
    l = l * alpha + group_sum<32>(p0 + p1);
    const float pr[2] = {round_to<T>(p0), round_to<T>(p1)};
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
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
    __syncthreads();           // buffer i&1 is free for tile i+2
  }

  const int64_t o = (int64_t(n) * Hkv + hk) * G + warp;
#pragma unroll
  for (int c = 0; c < DC; ++c) acc_out[o * D + lane * DC + c] = acc[c];
  if (lane == 0) {
    m_out[o] = m;
    l_out[o] = l;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* lengths, float* acc,
                   float* m, float* l, int N, int layer, int NB, int BS,
                   int Hkv, int G, int MB, float scale, cudaStream_t stream) {
  const int smem = Layout<T, D>::kSmem + MB * int(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      ragged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N, Hkv);
  ragged_decode_kernel<T, D><<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, lengths, acc, m, l, layer, NB, BS,
      Hkv, G, MB, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. D must be 64 or 128 and 1 <= G <= 8 (the
// wrapper checks). Pools are contiguous [L, NB, BS, Hkv, D]; `layer`
// selects the plane.
extern "C" int ptt_ragged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const int* table,
                                 const int* lengths, float* acc, float* m,
                                 float* l, int N, int layer, int NB, int BS,
                                 int Hkv, int G, int D, int MB, int dtype,
                                 float scale, void* stream) {
  if (G < 1 || G > kMaxGroup) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && D == 128)
    return launch<float, 128>(q, k_pool, v_pool, table, lengths, acc, m, l, N,
                              layer, NB, BS, Hkv, G, MB, scale, st);
  if (dtype == kF32 && D == 64)
    return launch<float, 64>(q, k_pool, v_pool, table, lengths, acc, m, l, N,
                             layer, NB, BS, Hkv, G, MB, scale, st);
  if (dtype == kBF16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, table, lengths, acc, m,
                                      l, N, layer, NB, BS, Hkv, G, MB, scale, st);
  if (dtype == kBF16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, table, lengths, acc, m,
                                     l, N, layer, NB, BS, Hkv, G, MB, scale, st);
  return cudaErrorInvalidValue;
}
