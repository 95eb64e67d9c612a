// Paged KV-cache appends for Hopper (sm_90a): one token row per slot
// (B7) and whole prefill blocks (B8), written in place into a
// [L, NB, BS, Hkv, D] pool plane chosen at run time.
//
// Replaces the TPU kernels paddle_tpu/kernels/paged_attention.py
// `_append_token_kernel` (launched by `paged_append_token`) and
// `_append_blocks_kernel` (launched by `paged_append_blocks`), which move
// one [Hkv, D] row or one [BS, Hkv, D] block by DMA per grid step.
//
// Both copy bytes, whatever the element type (the wrapper casts the new
// rows to the pool's dtype first), 16 bytes a thread a load (row and
// block sizes multiples of 16 bytes, pointers 16-byte aligned: the
// wrapper checks). The destination block ids and offsets are read on the
// device. Duplicate destinations (the trash block 0) are written in an
// unspecified order, as on the TPU: B8's whole blocks race; of B7's rows
// on one trash position the last slot's wins whole.
//
// B7 moves N rows of a few KB (a Llama-3-8B decode step: 8 slots x 2 KB
// of K and of V, 66 KB). On the H100 it is bound first by the launch
// floor (an empty kernel's device time, ~0.87 us by the profiler: no
// work inside a kernel shortens it), then by one round trip to memory,
// and by bytes only from some hundreds of rows on (256 rows: 2.1 MB,
// 0.63 us at 3.35 TB/s). Its design meets each in turn:
// - the launch: it is launched with programmatic dependent launch and
//   signals its dependents at its start, so its own launch overlaps the
//   kernel before it (when that one signals) and the launch of the kernel
//   after it (B6's first pass) overlaps it; it waits
//   (griddepcontrol.wait) before its first global read, since the kernel
//   before may write the new rows or the indices;
// - the round trip: each thread loads its slot's indices and its K and V
//   vectors together and stores only after them: one round trip, not an
//   index trip and then a row trip;
// - idle threads: a grid of (slots, row chunks) of up to kRowThreads
//   vectors, one (K, V) pair a thread: a 2 KB bf16 row at Hkv=8, D=128 is
//   one block of 128, a 1 KB row at D=64 one of 64, a 4 KB f32 row two
//   of 128; 1000 such slots are 1000 blocks, all resident at once (16 an
//   SM). No loop and no test of the trash block on the common path: each
//   cost ~0.04-0.07 us a call (tools/paged_decode_ab.py, variants of this
//   file; NVIDIA H100 80GB HBM3, 700.00 W).
//
// B8 moves whole blocks and is bandwidth-bound: a grid of (block, chunk) —
// each thread block copies one chunk of one prefill block, so a few large
// blocks still spread over many SMs — and each thread issues all its loads
// (kVecs vectors of K and of V, streaming: the prefill rows are read once)
// before its stores, so a thread keeps 128 bytes in flight and the card's
// HBM rate is reached from a cold L2.
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                      // 16-byte vectors a B8 thread
constexpr int kChunkVecs = kThreads * kVecs;  // copies of K and of V
constexpr int kRowThreads = 128;   // a B7 block's threads along a row

// The store of a B7 thread whose slot n points at the trash block (0),
// the one destination slots may share: the last slot that writes
// position o there writes it, so that its row wins whole, as the TPU's
// grid order has it (a row's vectors are stored by many threads). Out of
// line, so the common path pays nothing for it. Plain loads: the indices
// are read after the grid's dependency wait.
__device__ __noinline__ void trash_store(uint4* k, uint4* v, uint4 kv,
                                         uint4 vv, const int* blk,
                                         const int* off, int n, int N,
                                         int o) {
  for (int m = n + 1; m < N; ++m)
    if (blk[m] == 0 && off[m] == o) return;
  *k = kv;
  *v = vv;
}

// 16 bytes through L2 (coherent: the rows may come from the kernel just
// before), issued where the code puts it
__device__ __forceinline__ uint4 load_cg(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// B7: a grid of (slots, row chunks); thread (x, y) of block (b, c) copies
// vector c * bx + x of slot b * by + y in K and in V (bx = min(row_vecs,
// kRowThreads); by > 1 only for rows under a warp's width)
__global__ void __launch_bounds__(kThreads)
append_token_kernel(const uint4* __restrict__ k_new,   // [N, row]
                    const uint4* __restrict__ v_new,
                    uint4* __restrict__ k_pool,        // [L, NB, BS, row]
                    uint4* __restrict__ v_pool,
                    const int* __restrict__ blk,       // [N]
                    const int* __restrict__ off,       // [N]
                    int layer, int NB, int BS, int row_vecs, int N) {
  ptt::launch_dependents();
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  const int n = blockIdx.x * blockDim.y + threadIdx.y;
  if (e >= row_vecs || n >= N) return;         // a ragged last chunk
  ptt::grid_dependency_wait();
  // the slot's indices and its two vectors, in flight together
  const int b = __ldcg(blk + n), o = __ldcg(off + n);
  const int64_t src = int64_t(n) * row_vecs + e;
  const uint4 kv = load_cg(k_new + src), vv = load_cg(v_new + src);
  const int64_t dst = ((int64_t(layer) * NB + b) * BS + o) * row_vecs + e;
  if (b != 0) {
    k_pool[dst] = kv;
    v_pool[dst] = vv;
  } else {
    trash_store(k_pool + dst, v_pool + dst, kv, vv, blk, off, n, N, o);
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
// aligned. Writes pool[layer, blk[n], off[n]] = new[n] for n < N. Launched
// dependent on the kernel before it (see the note at the top).
extern "C" int ptt_paged_append_token(const void* k_new, const void* v_new,
                                      void* k_pool, void* v_pool,
                                      const int* blk, const int* off, int N,
                                      int layer, int NB, int BS,
                                      int row_bytes, void* stream) {
  if (N < 1 || row_bytes <= 0 || row_bytes % 16) return cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  const int bx = row_vecs < kRowThreads ? row_vecs : kRowThreads;
  const int by = bx < 32 ? 32 / bx : 1;
  const dim3 grid((N + by - 1) / by, (row_vecs + bx - 1) / bx);
  return ptt::launch_dependent(
      append_token_kernel, grid, dim3(bx, by), 0,
      static_cast<cudaStream_t>(stream), static_cast<const uint4*>(k_new),
      static_cast<const uint4*>(v_new), static_cast<uint4*>(k_pool),
      static_cast<uint4*>(v_pool), blk, off, layer, NB, BS, row_vecs, N);
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
