// The persistent decode megakernel (mega_decode.cuh) in its multi-step
// form (mega_decode_loop) for bf16 models with int8 weights:
// its four (D, rows) instantiations.
#include "mega_decode.cuh"

namespace ptt {
namespace mega {

cudaError_t launch_multi_bf16_w8(const Args& a, const Maps& m, int D, int N,
                                 cudaStream_t st) {
  return launch_shape<__nv_bfloat16, int8_t, true>(a, m, D, N, st);
}

cudaError_t occupancy_multi_bf16_w8(int D, int N, int* per_sm) {
  return occupancy_shape<__nv_bfloat16, int8_t, true>(D, N, per_sm);
}

}  // namespace mega
}  // namespace ptt
