// Gather-fused grouped GEMM for Hopper (sm_90a): out[i*tm + r] =
// x[idx[i*tm + r]] @ rhs[gid[i]].
//
// Replaces the TPU kernel paddle_tpu/kernels/moe_fused.py `gather_gmm`
// (its inner `kernel`, pallas_call at :266; B9), the gate|up projection of
// the fused MoE dispatch. The rows of x are gathered by expert inside the
// kernel, so the [rows, h] gathered copy of x never exists in device
// memory: that copy is the point of the kernel.
//
// What bounds it on the H100: tensor-core FLOPs. At the DeepSeekMoE step
// (57,344 padded rows, h = 2048, n = 2f = 2816) it does 2*rows*h*n = 661
// GFLOP on 0.37 GB of weights and 0.3 GB of rows and output, ~1000
// operations a byte, far above the card's ~295.
//
// Design: the rows are in a per-group tile-padded layout (the caller's
// `_pad_layout`), so every tm-row tile belongs to one group, gid[tile];
// tm is a multiple of the kernel's 128-row tile. bf16 runs on the Hopper
// kernel of grouped_gemm_sm90.cuh: a persistent block per SM, one producer
// warpgroup and two wgmma consumer warpgroups over a ring of 64-deep
// stages. The producer copies each tile's gathered rows straight from x as
// 16-byte cp.async pieces (TMA has no row gather) and the group's weight
// tile by TMA from a 3-D map of rhs. Padding rows point at a real token
// and are computed like any other (the caller gives them combine weight
// 0). The tile width (256 or 128 columns) is the wrapper's choice. f32
// runs on CUDA cores (grouped_gemm.cuh) for exact parity.
//
// int8 rhs (the TPU kernel's int8 branch: int8 expert weights widened on
// their way to the matrix unit): TMA brings the int8 tile as it is stored
// (half the bytes of bf16) and the kernel computes the tile transposed, the
// weights as wgmma's register operand, widened exactly in registers after
// an ldmatrix.trans, the gathered rows as its shared-memory operand
// (grouped_gemm_sm90.cuh). The output is the f32 sum rounded to x's dtype;
// the per-channel scales stay outside the kernel (the caller folds them
// into its elementwise chain). f32 x with int8 rhs widens each element on
// the CUDA cores.
#include "grouped_gemm.cuh"
#include "grouped_gemm_sm90.cuh"

namespace {

using namespace ptt;
using namespace ptt::gg;
using ptt::sm90::bf16;

// R: the rhs's type (float, or int8_t widened element by element)
template <typename R>
__global__ void __launch_bounds__(kThreads)
gather_gmm_f32(const float* __restrict__ x, const int* __restrict__ idx,
               const R* __restrict__ rhs, const int* __restrict__ gid,
               float* __restrict__ out, int rows, int K, int N, int tm) {
  __shared__ SmemF32 sm;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kFN, m0 = blockIdx.y * kFM;
  const R* rb = rhs + int64_t(gid[m0 / tm]) * K * N;
  float acc[4][4] = {};
  f32_tile(
      acc, sm, 0, K,
      [&](int i, int k) { return x[int64_t(idx[m0 + i]) * K + k]; },
      [&](int k, int j) {
        return n0 + j < N ? float(rb[int64_t(k) * N + n0 + j]) : 0.f;
      },
      tid);
  f32_store(acc, out, N, m0, n0, rows, N, tid);
}

}  // namespace

// dtype: x's and out's (0 = f32, 1 = bf16); rhs_int8: the rhs [E, K, N]
// is int8 (else of x's dtype); bn: the bf16 kernel's tile width (256 or
// 128). rows a multiple of tm and tm a multiple of 128 (the wrapper
// checks), K and N multiples of 8 for bf16 (N of 16 for an int8 rhs),
// 16-byte aligned operands.
extern "C" int ptt_gather_gmm(const void* x, const int* idx, const void* rhs,
                              const int* gid, void* out, int rows, int K,
                              int N, int E, int tm, int dtype, int rhs_int8,
                              int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (K == 0)
      return cudaMemsetAsync(out, 0, size_t(rows) * N * 2, st);
    sm90::Args a{static_cast<const bf16*>(x), idx, gid, nullptr,
                 static_cast<bf16*>(out), rows, K, N, E, tm};
    if (rhs_int8) {
      if (N % 16) return cudaErrorInvalidValue;
      return sm90::launch_bn<true, false, true>(bn, a, nullptr, rhs, st);
    }
    return sm90::launch_bn<true, false, false>(bn, a, nullptr, rhs, st);
  } else if (dtype == kF32) {
    const dim3 grid((N + kFN - 1) / kFN, rows / kFM);
    if (rhs_int8)
      gather_gmm_f32<int8_t><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), idx, static_cast<const int8_t*>(rhs),
          gid, static_cast<float*>(out), rows, K, N, tm);
    else
      gather_gmm_f32<float><<<grid, kThreads, 0, st>>>(
          static_cast<const float*>(x), idx, static_cast<const float*>(rhs),
          gid, static_cast<float*>(out), rows, K, N, tm);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
