// Paged decode attention for Hopper (sm_90a): one query token per slot
// against the slot's first lengths[n] positions of one pool plane.
//
// Replaces the TPU kernel paddle_tpu/kernels/paged_attention.py
// `_decode_attn_kernel` (launched by `paged_decode_attention`), which
// copies all of a slot's valid blocks into VMEM and runs a one-shot
// softmax per kv head: scores (q . k) in f32 divided by sqrt(D),
// positions at or past the length masked to -1e30, p = exp(s - max)
// rounded to the pool dtype before the PV product, l the sum of the
// unrounded p, the output acc / l in q's dtype. A slot of length 0
// returns 0 (the TPU kernel zeroes the V rows it never copied, and every
// masked probability is then exp(0) = 1 against a zero row).
//
// What bounds it on the H100: HBM bytes — each query does 4*D operations
// a cached position against 2*D pool elements, about one operation a
// byte, so the floor is the K/V rows under the lengths over 3.35 TB/s.
//
// This design: one thread block per (slot, kv head), one warp per query
// head of the group (G <= 8), so every K/V row is read from HBM by one
// block and shared by its G heads through shared memory. The TPU's
// VMEM staging of the whole context does not fit a Hopper SM, so the
// kernel streams the positions under lengths[n] in 64-position tiles
// (16-byte cp.async copies, double-buffered; ragged_walk.cuh's staging
// layout and loaders), in two passes to keep the one-shot softmax's
// rounding: the first pass reads K and finds each head's maximum score,
// the second reads K and V again and accumulates p = exp(s - max) (p
// rounded to the pool dtype for the PV product) exactly as the TPU
// kernel does. The second read of K is the price of that rounding (1.5x
// the bytes of one pass). Any length takes this one path: no size-based
// fallback.
#include <cstdint>

#include "common.cuh"
#include "ragged_walk.cuh"

namespace {

using namespace ptt;
using walk::kMaxGroup;
using walk::kStages;
using walk::kTile;

constexpr int kThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [N, Hkv*G, D]
                    const T* __restrict__ k_pool,   // [L, NB, BS, Hkv, D]
                    const T* __restrict__ v_pool,
                    const int* __restrict__ table,  // [N, MB]
                    const int* __restrict__ lengths,  // [N]
                    T* __restrict__ out,            // [N, Hkv*G, D]
                    int layer, int NB, int BS, int Hkv, int G, int MB,
                    float sqrt_d) {
  using Lay = walk::Layout<T, D>;
  constexpr int DC = D / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + kStages * Lay::kStageBytes);

  const int n = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = max(0, min(lengths[n], MB * BS));
  const int64_t head0 = (int64_t(n) * Hkv + hk) * G;   // first query head

  if (len == 0) {
    for (int e = tid; e < G * D; e += kThreads)
      out[head0 * D + e] = from_f32<T>(0.f);
    return;
  }
  for (int e = tid; e < G * D; e += kThreads)
    Qs[e] = to_f32(q[head0 * D + e]);

  const int* tbl = table + int64_t(n) * MB;
  const int64_t tok_stride = int64_t(Hkv) * D;
  const int64_t blk_stride = BS * tok_stride;
  const int64_t base0 = int64_t(layer) * NB * blk_stride + int64_t(hk) * D;
  const int n_tiles = (len + kTile - 1) / kTile;

  // tile `tile`'s K rows (and V rows with `with_v`) into buffer `buf`
  auto stage = [&](int tile, int buf, bool with_v) {
    unsigned char* ks = smem + buf * Lay::kStageBytes;
    unsigned char* vs = ks + kTile * Lay::kRowBytes;
    for (int e = tid; e < kTile * Lay::kVecs; e += kThreads) {
      const int t = e / Lay::kVecs, c = e % Lay::kVecs;
      const int p = tile * kTile + t;
      const bool live = p < len;
      const int64_t off = live ? base0 + int64_t(tbl[p / BS]) * blk_stride
                                     + int64_t(p % BS) * tok_stride
                               : 0;
      const int sm = t * Lay::kRowBytes + c * 16;
      cp_async16(ks + sm, k_pool + off + c * Lay::kPer, live);
      if (with_v) cp_async16(vs + sm, v_pool + off + c * Lay::kPer, live);
    }
    cp_async_commit();
  };
  // the scores of positions lane and lane + 32 of tile i for head `warp`
  auto scores = [&](int i, float (&s)[2]) {
    const unsigned char* ks = smem + (i & 1) * Lay::kStageBytes;
    const float* qw = Qs + warp * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = lane + 32 * h;
      const T* krow = reinterpret_cast<const T*>(ks + t * Lay::kRowBytes);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < Lay::kVecs; ++c) {
        float kf[Lay::kPer];
        walk::load16(krow + c * Lay::kPer, kf);
#pragma unroll
        for (int j = 0; j < Lay::kPer; ++j)
          dot = fmaf(qw[c * Lay::kPer + j], kf[j], dot);
      }
      s[h] = i * kTile + t < len ? __fdiv_rn(dot, sqrt_d) : kNegInf;
    }
  };
  // both passes: tiles double-buffered, `body(i)` on tile i once it landed
  auto pass = [&](bool with_v, auto&& body) {
    stage(0, 0, with_v);
    for (int i = 0; i < n_tiles; ++i) {
      if (i + 1 < n_tiles) {
        stage(i + 1, (i + 1) & 1, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();         // tile i visible to every warp
      if (warp < G) body(i);
      __syncthreads();         // buffer i & 1 free for tile i + 2
    }
  };

  // pass 1: each head's maximum score
  float m = kNegInf;
  pass(false, [&](int i) {
    float s[2];
    scores(i, s);
    m = fmaxf(m, group_max<32>(fmaxf(s[0], s[1])));
  });

  // pass 2: l and the PV sums at that maximum
  float l = 0.f, acc[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) acc[c] = 0.f;
  pass(true, [&](int i) {
    float s[2];
    scores(i, s);
    const float p0 = expf(s[0] - m), p1 = expf(s[1] - m);
    l += group_sum<32>(p0 + p1);
    const float pr[2] = {round_to<T>(p0), round_to<T>(p1)};
    const unsigned char* vs =
        smem + (i & 1) * Lay::kStageBytes + kTile * Lay::kRowBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const float pt = __shfl_sync(kFullMask, pr[h], j);
        const T* vrow =
            reinterpret_cast<const T*>(vs + (32 * h + j) * Lay::kRowBytes);
        float vv[DC];
        walk::load_pairs<DC>(vrow + lane * DC, vv);
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[c] = fmaf(pt, vv[c], acc[c]);
      }
    }
  });

  if (warp < G) {
    T* o = out + (head0 + warp) * D + lane * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = from_f32<T>(__fdiv_rn(acc[c], l));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* table, const int* lengths, void* out, int N,
                   int layer, int NB, int BS, int Hkv, int G, int MB,
                   cudaStream_t st) {
  constexpr int smem = walk::Layout<T, D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, D><<<dim3(N, Hkv), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lengths, static_cast<T*>(out), layer,
      NB, BS, Hkv, G, MB, sqrtf(float(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const int* table, const int* lengths, void* out, int N,
                     int layer, int NB, int BS, int Hkv, int G, int D,
                     int MB, cudaStream_t st) {
  if (D == 128)
    return launch<T, 128>(q, kp, vp, table, lengths, out, N, layer, NB, BS,
                          Hkv, G, MB, st);
  if (D == 64)
    return launch<T, 64>(q, kp, vp, table, lengths, out, N, layer, NB, BS,
                         Hkv, G, MB, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, the pools and out all of it); D 64 or 128;
// 1 <= G <= 8. q and out [N, Hkv*G, D], pools [L, NB, BS, Hkv, D] (every
// tensor contiguous, the pools 16-byte aligned), table [N, MB] and lengths
// [N] int32; `layer` selects the pool plane.
extern "C" int ptt_paged_decode_attention(const void* q, const void* k_pool,
                                          const void* v_pool,
                                          const int* table,
                                          const int* lengths, void* out,
                                          int N, int layer, int NB, int BS,
                                          int Hkv, int G, int D, int MB,
                                          int dtype, void* stream) {
  if (N < 1 || G < 1 || G > kMaxGroup) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_d<float>(q, k_pool, v_pool, table, lengths, out, N, layer,
                           NB, BS, Hkv, G, D, MB, st);
  if (dtype == kBF16)
    return launch_d<__nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, N,
                                   layer, NB, BS, Hkv, G, D, MB, st);
  return cudaErrorInvalidValue;
}
