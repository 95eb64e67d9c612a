// Grouped weight gradient for Hopper (sm_90a): out[g] = lhs[rows of g]^T @
// rhs[rows of g], [E, K, N].
//
// Replaces B10's `tgmm`: the jax megablox transposed grouped matmul that
// the JAX package calls from paddle_tpu/kernels/moe_dispatch.py
// `_gmm_tuned_bwd` (:445) and paddle_tpu/kernels/moe_fused.py
// `_gather_gmm_bwd` (:321): the wgrad of every routed-expert GEMM.
//
// What bounds it on the H100: tensor-core FLOPs (2*m*k*n; at the
// DeepSeekMoE step's gate|up wgrad, 57,344 x 2048 x 2816 = 661 GFLOP).
//
// Design: one block per (group g, 128-row tile of K, 128-column tile of
// N) walks the group's rows (a consecutive range found from gs on the
// device) in 32-row stages, in order, and writes its tile once: no atomics
// and no split of the walk, so the result is deterministic. lhs is stored
// [m, K] (the caller's lhs^T [K, m] is its transposed view), so its
// stages are "cols" tiles read through ldmatrix.trans; rhs stages are
// "cols" tiles too (grouped_gemm.cuh). An empty group's tile is written as
// zeros, as megablox writes it. A heavily loaded expert makes its blocks'
// walks long; splitting the walk is later work. bf16 on mma.sync with f32
// sums, written in the output's dtype (bf16 or f32); f32 on CUDA cores.
#include "grouped_gemm.cuh"

namespace {

using namespace ptt;
using namespace ptt::gg;

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
tgmm_bf16(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
          const int* __restrict__ gs, OutT* __restrict__ out, int M, int K,
          int N) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, i0 = blockIdx.y * kBM, e = blockIdx.z;
  int start, end;
  group_rows(gs, e, M, start, end);
  Acc acc;
  zero(acc);
  auto stage = [&](int kt, int buf) {
    const int r0 = start + kt * kBK;
    load_cols(sm.t[buf][0], lhs, K, r0, start, end, i0, K, tid);
    load_cols(sm.t[buf][1], rhs, N, r0, start, end, n0, N, tid);
    cp_async_commit();
  };
  mainloop<true, false>(acc, sm, (end - start + kBK - 1) / kBK, stage, warp,
                        lane);
  store_tile(acc, out + int64_t(e) * K * N, N, i0, n0, K, N, warp, lane);
}

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

// K and N multiples of 8 for bf16, 16-byte aligned operands; out_dtype is
// the output's dtype code (the wrapper checks).
extern "C" int ptt_tgmm(const void* lhs, const void* rhs, const int* gs,
                        void* out, int M, int K, int N, int E, int dtype,
                        int out_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    const dim3 grid((N + kBN - 1) / kBN, (K + kBM - 1) / kBM, E);
    auto* a = static_cast<const bf16*>(lhs);
    auto* b = static_cast<const bf16*>(rhs);
    if (out_dtype == kBF16)
      tgmm_bf16<bf16><<<grid, kThreads, 0, st>>>(a, b, gs,
                                                 static_cast<bf16*>(out), M,
                                                 K, N);
    else if (out_dtype == kF32)
      tgmm_bf16<float><<<grid, kThreads, 0, st>>>(a, b, gs,
                                                  static_cast<float*>(out), M,
                                                  K, N);
    else
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
