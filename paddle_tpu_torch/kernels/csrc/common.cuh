// Shared helpers of the port's CUDA kernels: element conversion to and
// from the f32 working type, warp reductions, asynchronous copies from
// global to shared memory, and bf16 packing.
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

// two floats rounded to bf16 and packed, the lower one in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Programmatic dependent launch. A kernel started by launch_dependent may
// run before the kernel ahead of it on the stream has ended: once every
// block of that kernel has run launch_dependents() or exited. It must run
// grid_dependency_wait() before it touches memory the kernel ahead of it
// may write; the wait returns when that kernel has ended and its writes
// are visible (at once, when it had ended or never signalled).
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... K, typename... A>
inline cudaError_t launch_dependent(void (*kernel)(K...), dim3 grid,
                                    dim3 block, size_t smem, cudaStream_t st,
                                    A&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace ptt
