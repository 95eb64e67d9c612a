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
// reads it. bf16 runs on the Hopper kernel of grouped_gemm_sm90.cuh: a
// persistent block per SM, one producer thread issuing TMA loads of the
// lhs tile ([M, K] map) and of the group's weight tile (a 3-D map of rhs,
// N-major [E, K, N] or K-major [E, N, K] for transpose_rhs) into a ring of
// 64-deep stages, and two wgmma consumer warpgroups. Each block lists the
// groups that hold rows of its 128-row tile (in the unpadded form a tile
// can span several) from prefix sums of gs in shared memory, and runs one
// pass over the reduction per group: fresh sums from the whole tile, then
// a store of that group's rows only. Rows at or past sum(gs) belong to no
// group and are written as zeros (the megablox kernel leaves them
// unwritten; the JAX package zeroes them after with `_zero_tail`). The
// tile width (256 or 128 columns) is the wrapper's choice. f32 runs on
// CUDA cores (grouped_gemm.cuh) for exact parity.
#include "grouped_gemm.cuh"
#include "grouped_gemm_sm90.cuh"

namespace {

using namespace ptt;
using namespace ptt::gg;
using ptt::sm90::bf16;

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

// bn: the bf16 kernel's tile width (256 or 128). K and N multiples of 8
// for bf16, 16-byte aligned operands (the wrapper checks).
extern "C" int ptt_gmm(const void* lhs, const void* rhs, const int* gs,
                       void* out, int M, int K, int N, int E,
                       int transpose_rhs, int dtype, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (K == 0)
      return cudaMemsetAsync(out, 0, size_t(M) * N * 2, st);
    sm90::Args a{nullptr, nullptr, nullptr, gs, static_cast<bf16*>(out),
                 M, K, N, E, 0};
    if (transpose_rhs)
      return sm90::launch_bn<false, true, false>(bn, a, lhs, rhs, st);
    return sm90::launch_bn<false, false, false>(bn, a, lhs, rhs, st);
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
