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
// tm is a multiple of the block's 128 rows. A block owns a 128 x 128
// output tile: each thread keeps the source row pointers of its two lhs
// rows, and every 32-deep stage copies those rows' 16-byte pieces straight
// from x (cp.async) beside the group's rhs piece (grouped_gemm.cuh).
// Padding rows point at a real token and are computed like any other (the
// caller gives them combine weight 0). bf16 runs on mma.sync; f32 on CUDA
// cores for exact parity.
//
// int8 rhs (the TPU kernel's int8 branch: int8 expert weights widened on
// their way to the matrix unit): each stage copies the rhs piece
// unconverted (cp.async, half the bytes of bf16) into a raw byte tile, and
// a conversion pass widens it exactly into the bf16 tile the products
// read (grouped_gemm.cuh). The output is the f32 sum rounded to x's dtype;
// the per-channel scales stay outside the kernel (the caller folds them
// into its elementwise chain). f32 x with int8 rhs widens each element on
// the CUDA cores.
#include "grouped_gemm.cuh"

namespace {

using namespace ptt;
using namespace ptt::gg;

// x [T, K], idx [rows], rhs [E, K, N], gid [rows / tm], out [rows, N]
__global__ void __launch_bounds__(kThreads)
gather_gmm_bf16(const bf16* __restrict__ x, const int* __restrict__ idx,
                const bf16* __restrict__ rhs, const int* __restrict__ gid,
                bf16* __restrict__ out, int rows, int K, int N, int tm) {
  __shared__ __align__(16) Smem sm;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const bf16* rb = rhs + int64_t(gid[m0 / tm]) * K * N;
  const int r = tid >> 2;
  const bf16* const src[2] = {x + int64_t(idx[m0 + r]) * K,
                              x + int64_t(idx[m0 + r + 64]) * K};
  Acc acc;
  zero(acc);
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    load_rows(sm.t[buf][0], src, k0, K, x, tid);
    load_cols(sm.t[buf][1], rb, N, k0, 0, K, n0, N, tid);
    cp_async_commit();
  };
  mainloop<false, false>(acc, sm, (K + kBK - 1) / kBK, stage, warp, lane);
  store_tile(acc, out, N, m0, n0, rows, N, warp, lane);
}

// the bf16 kernel with an int8 rhs: the stages' tiles, then the raw int8
// rhs tiles, in dynamic shared memory (above the 48 KB static limit)
struct SmemI8 {
  Smem s;
  int8_t raw[2][kBK * kI8Ld];
};

__global__ void __launch_bounds__(kThreads)
gather_gmm_bf16_i8(const bf16* __restrict__ x, const int* __restrict__ idx,
                   const int8_t* __restrict__ rhs, const int* __restrict__ gid,
                   bf16* __restrict__ out, int rows, int K, int N, int tm) {
  extern __shared__ __align__(16) unsigned char dyn[];
  SmemI8& sm = *reinterpret_cast<SmemI8*>(dyn);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int8_t* rb = rhs + int64_t(gid[m0 / tm]) * K * N;
  const int r = tid >> 2;
  const bf16* const src[2] = {x + int64_t(idx[m0 + r]) * K,
                              x + int64_t(idx[m0 + r + 64]) * K};
  Acc acc;
  zero(acc);
  auto stage = [&](int kt, int buf) {
    const int k0 = kt * kBK;
    load_rows(sm.s.t[buf][0], src, k0, K, x, tid);
    load_cols_i8(sm.raw[buf], rb, N, k0, 0, K, n0, N, tid);
    cp_async_commit();
  };
  auto widen = [&](int buf) { widen_cols_i8(sm.s.t[buf][1], sm.raw[buf], tid); };
  mainloop<false, false>(acc, sm.s, (K + kBK - 1) / kBK, stage, warp, lane,
                         widen);
  store_tile(acc, out, N, m0, n0, rows, N, warp, lane);
}

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

// dtype: x's and out's (0 = f32, 1 = bf16); rhs_int8: the rhs is int8
// (else of x's dtype). rows a multiple of tm and tm a multiple of 128 (the
// wrapper checks), K and N multiples of 8 for bf16 (N of 16 for an int8
// rhs), 16-byte aligned operands.
extern "C" int ptt_gather_gmm(const void* x, const int* idx, const void* rhs,
                              const int* gid, void* out, int rows, int K,
                              int N, int tm, int dtype, int rhs_int8,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && rhs_int8) {
    if (N % 16) return cudaErrorInvalidValue;
    const int smem = int(sizeof(SmemI8));
    const cudaError_t err = cudaFuncSetAttribute(
        gather_gmm_bf16_i8, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((N + kBN - 1) / kBN, rows / kBM);
    gather_gmm_bf16_i8<<<grid, kThreads, smem, st>>>(
        static_cast<const bf16*>(x), idx, static_cast<const int8_t*>(rhs), gid,
        static_cast<bf16*>(out), rows, K, N, tm);
  } else if (dtype == kBF16) {
    const dim3 grid((N + kBN - 1) / kBN, rows / kBM);
    gather_gmm_bf16<<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), idx, static_cast<const bf16*>(rhs), gid,
        static_cast<bf16*>(out), rows, K, N, tm);
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
