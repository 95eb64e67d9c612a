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
// A later PR should split each slot's walk over several blocks
// (split-K flash-decoding: N*Hkv blocks underfill 132 SMs at small
// batch and a long slot's walk is serial), and take int8 pools
// (ROADMAP A4).
#include <cstdint>

#include "common.cuh"
#include "ragged_walk.cuh"

namespace {

using namespace ptt;
using walk::kMaxGroup;
using walk::kStages;

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
  using Lay = walk::Layout<T, D>;
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
  walk::ragged_walk<T, D>(k_pool, v_pool, tbl, 0, len, layer, NB, BS, Hkv,
                          hk, G, scale, smem, m, l, acc);

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
  const int smem = walk::Layout<T, D>::kSmem + MB * int(sizeof(int));
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
