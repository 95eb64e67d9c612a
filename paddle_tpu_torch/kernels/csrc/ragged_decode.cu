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
// walk itself (ragged_walk.cuh, shared with the mega decode kernel)
// stages 64 positions at a time with 16-byte cp.async copies,
// double-buffered, and keeps its accumulators in f32 registers.
//
// int8 pools (the TPU kernel's kv_int8 branch) stream their rows
// unconverted beside the f32 per-position scales: half the bytes of a
// bf16 walk plus 8 bytes a position and kv head. The walk widens them in
// registers and folds the scales as the TPU kernel does (ragged_walk.cuh).
//
// A later PR should split each slot's walk over several blocks
// (split-K flash-decoding: N*Hkv blocks underfill 132 SMs at small
// batch and a long slot's walk is serial).
#include <cstdint>

#include "common.cuh"
#include "ragged_walk.cuh"

namespace {

using namespace ptt;
using walk::kMaxGroup;
using walk::kStages;

// T: the queries' type; P: the pools' (T, or int8_t with scale pools)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(32 * kMaxGroup)
ragged_decode_kernel(const T* __restrict__ q,        // [N, Hkv*G, D]
                     const P* __restrict__ k_pool,   // [L, NB, BS, Hkv, D]
                     const P* __restrict__ v_pool,
                     const float* __restrict__ ks_pool,  // [L, NB, BS, Hkv]
                     const float* __restrict__ vs_pool,
                     const int* __restrict__ table,  // [N, MB]
                     const int* __restrict__ lengths,  // [N]
                     float* __restrict__ acc_out,    // [N, Hkv, G, D]
                     float* __restrict__ m_out,      // [N, Hkv, G]
                     float* __restrict__ l_out,
                     int layer, int NB, int BS, int Hkv, int G, int MB,
                     float scale) {
  using Lay = walk::Layout<P, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + kStages * Lay::kStageBytes);
  int* tbl = reinterpret_cast<int*>(Qs + kMaxGroup * D);   // [MB]

  const int n = blockIdx.x, hk = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = max(0, min(lengths[n], MB * BS));

  const T* qn = q + (int64_t(n) * Hkv * G + int64_t(hk) * G) * D;
  for (int e = tid; e < G * D; e += nthreads) Qs[e] = to_f32(qn[e]);
  // the blocks the walk reads, so a copy's block id is a shared-memory read
  const int* tbl_n = table + int64_t(n) * MB;
  for (int e = tid; e < (len + BS - 1) / BS; e += nthreads) tbl[e] = tbl_n[e];
  __syncthreads();

  constexpr int DC = D / 32;
  float m, l, acc[DC];
  walk::ragged_walk<P, D>(k_pool, v_pool, ks_pool, vs_pool, tbl, 0, len,
                          layer, NB, BS, Hkv, hk, G, scale, smem, m, l, acc);

  const int64_t o = (int64_t(n) * Hkv + hk) * G + warp;
#pragma unroll
  for (int c = 0; c < DC; ++c) acc_out[o * D + lane * DC + c] = acc[c];
  if (lane == 0) {
    m_out[o] = m;
    l_out[o] = l;
  }
}

struct Call {
  const void *q, *k_pool, *v_pool;
  const float *ks_pool, *vs_pool;
  const int *table, *lengths;
  float *acc, *m, *l;
  int N, layer, NB, BS, Hkv, G, MB;
  float scale;
};

template <typename T, typename P, int D>
cudaError_t launch(const Call& c, cudaStream_t stream) {
  const int smem = walk::Layout<P, D>::kSmem + c.MB * int(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      ragged_decode_kernel<T, P, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(c.N, c.Hkv);
  ragged_decode_kernel<T, P, D><<<grid, 32 * c.G, smem, stream>>>(
      static_cast<const T*>(c.q), static_cast<const P*>(c.k_pool),
      static_cast<const P*>(c.v_pool), c.ks_pool, c.vs_pool, c.table,
      c.lengths, c.acc, c.m, c.l, c.layer, c.NB, c.BS, c.Hkv, c.G, c.MB,
      c.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pools(const Call& c, int D, int pool_dtype,
                         cudaStream_t st) {
  const bool i8 = pool_dtype == kPoolInt8;
  if (D == 128)
    return i8 ? launch<T, int8_t, 128>(c, st) : launch<T, T, 128>(c, st);
  if (D == 64)
    return i8 ? launch<T, int8_t, 64>(c, st) : launch<T, T, 64>(c, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: the queries', 0 = f32, 1 = bf16; pool_dtype: the pools', the
// queries' or 2 = int8 (then ks_pool/vs_pool are their [L, NB, BS, Hkv]
// f32 scales, else unused). D must be 64 or 128 and 1 <= G <= 8 (the
// wrapper checks). Pools are contiguous [L, NB, BS, Hkv, D]; `layer`
// selects the plane.
extern "C" int ptt_ragged_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const float* ks_pool,
                                 const float* vs_pool, const int* table,
                                 const int* lengths, float* acc, float* m,
                                 float* l, int N, int layer, int NB, int BS,
                                 int Hkv, int G, int D, int MB, int dtype,
                                 int pool_dtype, float scale, void* stream) {
  if (G < 1 || G > kMaxGroup) return cudaErrorInvalidValue;
  if (pool_dtype != dtype && pool_dtype != kPoolInt8)
    return cudaErrorInvalidValue;
  if (pool_dtype == kPoolInt8 && (ks_pool == nullptr || vs_pool == nullptr))
    return cudaErrorInvalidValue;
  const Call c{q, k_pool, v_pool, ks_pool, vs_pool, table, lengths, acc, m,
               l, N, layer, NB, BS, Hkv, G, MB, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch_pools<float>(c, D, pool_dtype, st);
  if (dtype == kBF16) return launch_pools<__nv_bfloat16>(c, D, pool_dtype, st);
  return cudaErrorInvalidValue;
}
