// Grouped weight gradient for Hopper (sm_90a): out[g] = lhs[rows of g]^T @
// rhs[rows of g], [E, K, N].
//
// Replaces B10's `tgmm`: the jax megablox transposed grouped matmul that
// the JAX package calls from paddle_tpu/kernels/moe_dispatch.py
// `_gmm_tuned_bwd` (:445, `_tgmm` at :453) and paddle_tpu/kernels/
// moe_fused.py `_gather_gmm_bwd` (:321): the wgrad of every routed-expert
// GEMM.
//
// What bounds it on the H100: tensor-core FLOPs (2*m*k*n; at the
// DeepSeekMoE step's gate|up wgrad, 57,344 x 2048 x 2816 = 661 GFLOP on
// ~0.3 GB of inputs) and, behind them, the output: [E, K, N] is 738 MB of
// bf16 at that call, ~0.22 ms of HBM time that the stores must hide.
//
// Design: bf16 runs on the persistent, warp-specialised Hopper kernel of
// grouped_gemm_sm90.cuh (`tgmm_sm90`): one block per SM walks 128 x BN
// output tiles of [E, K, N] expert-major; a producer thread feeds a ring
// of 64-row stages by TMA from lhs [M, K] (the caller's lhs^T is its
// transposed view; wgmma reads it as a transposed A) and rhs [M, N]; two
// consumer warpgroups sum each tile over its group's rows, starting at
// the group's first row, and store it (bf16 through shared memory and TMA
// stores, f32 from registers) while the producer runs into the next tile.
// An empty group's tiles are written as zeros, as megablox writes them. No
// split of the reduction and no atomics: every element is summed in one
// fixed order, so two calls are equal bit for bit. The tile width (256 or
// 128 columns) is the wrapper's choice. f32 inputs run on CUDA cores
// (grouped_gemm.cuh) for exact parity.
#include "grouped_gemm.cuh"
#include "grouped_gemm_sm90.cuh"

namespace {

using namespace ptt;
using namespace ptt::gg;
using ptt::sm90::bf16;

__device__ __forceinline__ void group_rows(const int* gs, int e, int M,
                                           int& start, int& end) {
  int s = 0;
  for (int i = 0; i < e; ++i) s += gs[i];
  start = min(s, M);
  end = min(s + gs[e], M);
}

// lhs [M, K], rhs [M, N], out [E, K, N]
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
tgmm_f32(const float* __restrict__ lhs, const float* __restrict__ rhs,
         const int* __restrict__ gs, OutT* __restrict__ out, int M, int K,
         int N) {
  __shared__ SmemF32 sm;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kFN, i0 = blockIdx.y * kFM, e = blockIdx.z;
  int start, end;
  group_rows(gs, e, M, start, end);
  float acc[4][4] = {};
  f32_tile(
      acc, sm, start, end,
      [&](int i, int r) {
        return i0 + i < K ? lhs[int64_t(r) * K + i0 + i] : 0.f;
      },
      [&](int r, int j) {
        return n0 + j < N ? rhs[int64_t(r) * N + n0 + j] : 0.f;
      },
      tid);
  f32_store(acc, out + int64_t(e) * K * N, N, i0, n0, K, N, tid);
}

}  // namespace

// bn: the bf16 kernel's tile width (256 or 128). K and N multiples of 8
// for bf16, 16-byte aligned operands; out_dtype is the output's dtype code
// (the wrapper checks).
extern "C" int ptt_tgmm(const void* lhs, const void* rhs, const int* gs,
                        void* out, int M, int K, int N, int E, int dtype,
                        int out_dtype, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (out_dtype != kBF16 && out_dtype != kF32) return cudaErrorInvalidValue;
    if (M == 0)   // every group empty
      return cudaMemsetAsync(
          out, 0, size_t(E) * K * N * (out_dtype == kF32 ? 4 : 2), st);
    const sm90::TArgs a{gs, out, M, K, N, E};
    if (bn == 256)
      return out_dtype == kBF16
                 ? sm90::launch_tgmm<256, bf16>(a, lhs, rhs, st)
                 : sm90::launch_tgmm<256, float>(a, lhs, rhs, st);
    if (bn == 128)
      return out_dtype == kBF16
                 ? sm90::launch_tgmm<128, bf16>(a, lhs, rhs, st)
                 : sm90::launch_tgmm<128, float>(a, lhs, rhs, st);
    return cudaErrorInvalidValue;
  } else if (dtype == kF32 && out_dtype == kF32) {
    const dim3 grid((N + kFN - 1) / kFN, (K + kFM - 1) / kFM, E);
    tgmm_f32<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs), gs,
        static_cast<float*>(out), M, K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
