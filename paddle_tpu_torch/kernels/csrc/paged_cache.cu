// Paged KV-cache appends for Hopper (sm_90a): one token row per slot
// (B7) and whole prefill blocks (B8), written in place into a
// [L, NB, BS, Hkv, D] pool plane chosen at run time.
//
// Replaces the TPU kernels paddle_tpu/kernels/paged_attention.py
// `_append_token_kernel` (launched by `paged_append_token`) and
// `_append_blocks_kernel` (launched by `paged_append_blocks`), which move
// one [Hkv, D] row or one [BS, Hkv, D] block by DMA per grid step.
//
// What bounds them on the H100: HBM bytes — each element is read once
// and written once, with no arithmetic. A token append moves N rows of a
// few KB, so it is latency-bound (one launch, one round trip to HBM);
// a block append moves whole blocks and is bandwidth-bound.
//
// This design: the kernels copy bytes, whatever the element type (the
// wrapper casts the new rows to the pool's dtype first), 16 bytes a
// thread a load (row and block sizes multiples of 16 bytes, pointers
// 16-byte aligned: the wrapper checks). B7: one block per slot, its
// threads striding over the slot's K row and V row. B8: a grid of
// (block, chunk) — each thread block copies one chunk of one prefill
// block, so a few large blocks still spread over many SMs — and each
// thread issues all its loads (kVecs vectors of K and of V, streaming:
// the prefill rows are read once) before its stores, so a thread keeps
// 128 bytes in flight and the card's HBM rate is reached from a cold L2.
// The destination block ids and offsets are read on the device.
// Duplicate destinations (the trash block) are written in an unspecified
// order, as on the TPU.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                      // 16-byte vectors a B8 thread
constexpr int kChunkVecs = kThreads * kVecs;  // copies of K and of V

__global__ void __launch_bounds__(kThreads)
append_token_kernel(const uint4* __restrict__ k_new,   // [N, row]
                    const uint4* __restrict__ v_new,
                    uint4* __restrict__ k_pool,        // [L, NB, BS, row]
                    uint4* __restrict__ v_pool,
                    const int* __restrict__ blk,       // [N]
                    const int* __restrict__ off,       // [N]
                    int layer, int NB, int BS, int row_vecs) {
  const int n = blockIdx.x;
  const int64_t dst =
      ((int64_t(layer) * NB + blk[n]) * BS + off[n]) * row_vecs;
  const int64_t src = int64_t(n) * row_vecs;
  for (int e = threadIdx.x; e < row_vecs; e += blockDim.x) {
    k_pool[dst + e] = k_new[src + e];
    v_pool[dst + e] = v_new[src + e];
  }
}

__global__ void __launch_bounds__(kThreads)
append_blocks_kernel(const uint4* __restrict__ k_blocks,  // [nblk, blk]
                     const uint4* __restrict__ v_blocks,
                     uint4* __restrict__ k_pool,          // [L, NB, blk]
                     uint4* __restrict__ v_pool,
                     const int* __restrict__ blk_ids,     // [nblk]
                     int layer, int NB, int blk_vecs) {
  const int b = blockIdx.x;
  const int64_t src = int64_t(b) * blk_vecs;
  const int e0 = blockIdx.y * kChunkVecs + threadIdx.x;
  uint4 kv[kVecs], vv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = e0 + i * kThreads;
    if (e < blk_vecs) {
      kv[i] = __ldcs(k_blocks + src + e);
      vv[i] = __ldcs(v_blocks + src + e);
    }
  }
  const int64_t dst = (int64_t(layer) * NB + blk_ids[b]) * blk_vecs;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = e0 + i * kThreads;
    if (e < blk_vecs) {
      k_pool[dst + e] = kv[i];
      v_pool[dst + e] = vv[i];
    }
  }
}

}  // namespace

// k_new/v_new [N, Hkv, D] in the pools' dtype; pools [L, NB, BS, Hkv, D];
// row_bytes = Hkv * D * itemsize, a multiple of 16; every pointer 16-byte
// aligned. Writes pool[layer, blk[n], off[n]] = new[n] for n < N.
extern "C" int ptt_paged_append_token(const void* k_new, const void* v_new,
                                      void* k_pool, void* v_pool,
                                      const int* blk, const int* off, int N,
                                      int layer, int NB, int BS,
                                      int row_bytes, void* stream) {
  if (N < 1 || row_bytes <= 0 || row_bytes % 16) return cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  append_token_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<uint4*>(k_pool), static_cast<uint4*>(v_pool), blk, off,
      layer, NB, BS, row_vecs);
  return cudaGetLastError();
}

// k_blocks/v_blocks [nblk, BS, Hkv, D] in the pools' dtype; block_bytes =
// BS * Hkv * D * itemsize, a multiple of 16. Writes pool[layer, ids[b]] =
// blocks[b] for b < nblk.
extern "C" int ptt_paged_append_blocks(const void* k_blocks,
                                       const void* v_blocks, void* k_pool,
                                       void* v_pool, const int* blk_ids,
                                       int nblk, int layer, int NB,
                                       int64_t block_bytes, void* stream) {
  if (nblk < 1 || block_bytes <= 0 || block_bytes % 16
      || block_bytes / 16 > int64_t(1) << 30)
    return cudaErrorInvalidValue;
  const int blk_vecs = int(block_bytes / 16);
  const dim3 grid(nblk, (blk_vecs + kChunkVecs - 1) / kChunkVecs);
  append_blocks_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(k_blocks), static_cast<const uint4*>(v_blocks),
      static_cast<uint4*>(k_pool), static_cast<uint4*>(v_pool), blk_ids, layer,
      NB, blk_vecs);
  return cudaGetLastError();
}
