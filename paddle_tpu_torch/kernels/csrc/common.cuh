// Shared helpers of the port's CUDA kernels: element conversion to and
// from the f32 working type, warp reductions, asynchronous copies from
// global to shared memory, and the bf16 tensor-core fragments.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

constexpr float kNegInf = -1e30f;   // the JAX kernels' masking value
constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes shared with the Python wrappers (kPoolInt8: int8 KV pools
// with f32 scale pools; kInt8: int8 weights with per-channel scales)
enum DType : int { kF32 = 0, kBF16 = 1, kPoolInt8 = 2, kInt8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the TPU kernels cast the probabilities to the
// value dtype before the PV product; the port does the same.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// reductions over groups of `width` consecutive lanes (width a power of 2)
template <int width>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = width / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// ---------------------------------------------------------------------------
// bf16 tensor-core fragments (mma.sync m16n8k16, one warp). Lane t holds
// g = t/4, tig = t%4. A (16x16, row): a0 (row g, k 2tig..+1), a1 (row g+8),
// a2 (row g, k +8), a3 (row g+8, k +8). B (16x8, col): b0 (k 2tig..+1,
// col g), b1 (k +8). C (16x8): c0, c1 (row g, cols 2tig, 2tig+1), c2, c3
// (row g+8). Two C tiles side by side (cols 0-7, 8-15) are one A fragment
// of the next product: {pack(c0,c1), pack(c2,c3)} of the left tile, then
// of the right.
// ---------------------------------------------------------------------------

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, transposed: lane t gives the
// row address t%8 of matrix t/8 and receives in r[i] the elements
// (rows 2*(t%4) and 2*(t%4)+1, column t/4) of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of rows [row, row + 16) and columns [col, col + 16) of a
// row-major bf16 tile in shared memory with `stride` elements a row.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* tile,
                                            int stride, int row, int col,
                                            int g, int tig) {
  const __nv_bfloat16* p = tile + (row + g) * stride + col + tig * 2;
  a[0] = ld_u32(p);
  a[1] = ld_u32(p + 8 * stride);
  a[2] = ld_u32(p + 8);
  a[3] = ld_u32(p + 8 * stride + 8);
}

// acc[dt] (16 rows x D columns, DT = D/8 C tiles) += a (16 x 16k) times
// rows [k0, k0 + 16) of the row-major [k][D] bf16 tile `b` in shared
// memory: matrices 0/1 of each ldmatrix are rows k0 + [0,8)/[8,16) of
// column tile dt, matrices 2/3 the same rows of tile dt + 1.
template <int DT>
__device__ __forceinline__ void mma_rows_times_tile(
    float (&acc)[DT][4], const uint32_t (&a)[4], const __nv_bfloat16* b,
    int stride, int k0, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int dt = 0; dt < DT; dt += 2) {
    uint32_t f[4];
    ldmatrix_x4_trans(f, b + (k0 + (mi & 1) * 8 + mr) * stride
                             + (dt + (mi >> 1)) * 8);
    mma_bf16(acc[dt], a, f[0], f[1]);
    mma_bf16(acc[dt + 1], a, f[2], f[3]);
  }
}

}  // namespace ptt
