// The f32 forms of the grouped GEMMs on CUDA cores: the f32 kernels of
// gather_gmm.cu (B9), gmm.cu and tgmm.cu (B10). (Their bf16 forms run on
// the Hopper kernels of grouped_gemm_sm90.cuh.)
//
// f32 runs in full f32 (FMA) for exact parity checks, as the flash kernels
// do: a 64 x 64 tile, 4 x 4 outputs a thread, operands read element by
// element through the caller's accessors.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ptt {
namespace gg {

constexpr int kThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

struct SmemF32 {
  float a[kFK][kFM];
  float b[kFK][kFN];
};

// acc (this thread's 4 x 4 outputs: rows 4*(tid/16)+i, columns
// 4*(tid%16)+j of a 64 x 64 tile) += sum over k in [kbeg, kend) of
// a_at(row, k) * b_at(k, col); the accessors return 0 outside the problem.
template <typename AFn, typename BFn>
__device__ __forceinline__ void f32_tile(float (&acc)[4][4], SmemF32& sm,
                                         int kbeg, int kend, AFn a_at,
                                         BFn b_at, int tid) {
  const int ty = tid >> 4, tx = tid & 15;
  for (int k0 = kbeg; k0 < kend; k0 += kFK) {
    for (int e = tid; e < kFK * kFM; e += kThreads) {
      const int kk = e / kFM, i = e % kFM;
      const bool in = k0 + kk < kend;
      sm.a[kk][i] = in ? a_at(i, k0 + kk) : 0.f;
      sm.b[kk][i] = in ? b_at(k0 + kk, i) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(sm.a[kk][ty * 4 + i], sm.b[kk][tx * 4 + j], acc[i][j]);
    __syncthreads();
  }
}

template <typename OutT>
__device__ __forceinline__ void f32_store(const float (&acc)[4][4], OutT* out,
                                          int64_t ld, int m0, int n0, int M,
                                          int N, int tid) {
  const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[row * ld + col] = from_f32<OutT>(acc[i][j]);
    }
  }
}

// The groups of gs [E] that hold rows of [m0, m0 + bm) ∩ [0, M), in order:
// n entries of (group, first row, end row) in shared memory. Groups are
// consecutive row ranges in group order; empty groups hold no row.
struct TileGroups {
  int n;
  int g[kFM], lo[kFM], hi[kFM];
};

__device__ __forceinline__ void find_groups(TileGroups& tg, const int* gs,
                                            int E, int m0, int bm, int M,
                                            int tid) {
  if (tid == 0) {
    int start = 0, n = 0;
    const int m1 = min(m0 + bm, M);
    for (int e = 0; e < E && start < m1; ++e) {
      const int end = start + gs[e];
      const int lo = max(start, m0), hi = min(end, m1);
      if (lo < hi) {
        tg.g[n] = e;
        tg.lo[n] = lo;
        tg.hi[n] = hi;
        ++n;
      }
      start = end;
    }
    tg.n = n;
  }
  __syncthreads();
}

}  // namespace gg
}  // namespace ptt
