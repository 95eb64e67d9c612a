// Grouped matrix product for Hopper (sm_90a): out[rows of g] = lhs[rows of
// g] @ rhs[g], or @ rhs[g]^T with transpose_rhs.
//
// Replaces B10's `gmm`: the jax megablox grouped matmul that the JAX
// package calls through paddle_tpu/kernels/moe_dispatch.py `_gmm_tuned`
// (:434; forward) and `_gmm_tuned_bwd` (:445; the dgrad, transpose_rhs)
// and from paddle_tpu/kernels/moe_fused.py `_gather_gmm_bwd` (:318). In
// the fused MoE dispatch it is the down projection and both backward
// dgrads.
//
// What bounds it on the H100: tensor-core FLOPs (2*m*k*n; at the
// DeepSeekMoE step's down projection, 57,344 x 1408 x 2048 = 331 GFLOP on
// ~0.6 GB, ~550 operations a byte).
//
// Design: lhs rows are sorted by group, group g holding the gs[g] rows
// after those of groups < g; gs lives on the device and the host never
// reads it. A block owns a 128 x 128 output tile; thread 0 walks gs to
// list the groups that hold rows of the tile (in the unpadded form a tile
// can span several groups), then the block runs one masked pass over the
// reduction per such group, rows outside the group zero-filled, all
// accumulating into the same registers. Rows at or past sum(gs) belong to
// no group and are written as zeros (the megablox kernel leaves them
// unwritten; the JAX package zeroes them after with `_zero_tail`). bf16 on
// mma.sync (grouped_gemm.cuh), f32 on CUDA cores.
#include "grouped_gemm.cuh"

namespace {

using namespace ptt;
using namespace ptt::gg;

// lhs [M, K]; rhs [E, K, N], or [E, N, K] with kTrans; out [M, N]
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
gmm_bf16(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
         const int* __restrict__ gs, bf16* __restrict__ out, int M, int K,
         int N, int E) {
  __shared__ __align__(16) Smem sm;
  __shared__ TileGroups tg;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  find_groups(tg, gs, E, m0, kBM, M, tid);
  const int r = tid >> 2;
  Acc acc;
  zero(acc);
  for (int p = 0; p < tg.n; ++p) {
    const int lo = tg.lo[p], hi = tg.hi[p];
    const bf16* rb = rhs + int64_t(tg.g[p]) * K * N;
    const bf16* a_src[2];
    const bf16* b_src[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = m0 + r + 64 * i;
      a_src[i] = row >= lo && row < hi ? lhs + int64_t(row) * K : nullptr;
      const int col = n0 + r + 64 * i;   // kTrans: rhs[g] rows are columns
      b_src[i] = col < N ? rb + int64_t(col) * K : nullptr;
    }
    auto stage = [&](int kt, int buf) {
      const int k0 = kt * kBK;
      load_rows(sm.t[buf][0], a_src, k0, K, lhs, tid);
      if (kTrans)
        load_rows(sm.t[buf][1], b_src, k0, K, rhs, tid);
      else
        load_cols(sm.t[buf][1], rb, N, k0, 0, K, n0, N, tid);
      cp_async_commit();
    };
    mainloop<false, kTrans>(acc, sm, (K + kBK - 1) / kBK, stage, warp, lane);
  }
  store_tile(acc, out, N, m0, n0, M, N, warp, lane);
}

template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
gmm_f32(const float* __restrict__ lhs, const float* __restrict__ rhs,
        const int* __restrict__ gs, float* __restrict__ out, int M, int K,
        int N, int E) {
  __shared__ SmemF32 sm;
  __shared__ TileGroups tg;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kFN, m0 = blockIdx.y * kFM;
  find_groups(tg, gs, E, m0, kFM, M, tid);
  float acc[4][4] = {};
  for (int p = 0; p < tg.n; ++p) {
    const int lo = tg.lo[p], hi = tg.hi[p];
    const float* rb = rhs + int64_t(tg.g[p]) * K * N;
    f32_tile(
        acc, sm, 0, K,
        [&](int i, int k) {
          const int row = m0 + i;
          return row >= lo && row < hi ? lhs[int64_t(row) * K + k] : 0.f;
        },
        [&](int k, int j) {
          const int col = n0 + j;
          if (col >= N) return 0.f;
          return kTrans ? rb[int64_t(col) * K + k] : rb[int64_t(k) * N + col];
        },
        tid);
  }
  f32_store(acc, out, N, m0, n0, M, N, tid);
}

}  // namespace

// K and N multiples of 8 for bf16, 16-byte aligned operands (the wrapper
// checks).
extern "C" int ptt_gmm(const void* lhs, const void* rhs, const int* gs,
                       void* out, int M, int K, int N, int E,
                       int transpose_rhs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    auto* a = static_cast<const bf16*>(lhs);
    auto* b = static_cast<const bf16*>(rhs);
    auto* o = static_cast<bf16*>(out);
    if (transpose_rhs)
      gmm_bf16<true><<<grid, kThreads, 0, st>>>(a, b, gs, o, M, K, N, E);
    else
      gmm_bf16<false><<<grid, kThreads, 0, st>>>(a, b, gs, o, M, K, N, E);
  } else if (dtype == kF32) {
    const dim3 grid((N + kFN - 1) / kFN, (M + kFM - 1) / kFM);
    auto* a = static_cast<const float*>(lhs);
    auto* b = static_cast<const float*>(rhs);
    auto* o = static_cast<float*>(out);
    if (transpose_rhs)
      gmm_f32<true><<<grid, kThreads, 0, st>>>(a, b, gs, o, M, K, N, E);
    else
      gmm_f32<false><<<grid, kThreads, 0, st>>>(a, b, gs, o, M, K, N, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
