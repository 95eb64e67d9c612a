// The persistent decode megakernel (mega_decode.cuh) in its multi-step
// form (mega_decode_loop) for bf16 models with dense weights:
// its four (D, rows) instantiations.
#include "mega_decode.cuh"

namespace ptt {
namespace mega {

cudaError_t launch_multi_bf16(const Args& a, const Maps& m, int D, int N,
                              cudaStream_t st) {
  return launch_shape<__nv_bfloat16, __nv_bfloat16, true>(a, m, D, N, st);
}

cudaError_t occupancy_multi_bf16(int D, int N, int* per_sm) {
  return occupancy_shape<__nv_bfloat16, __nv_bfloat16, true>(D, N, per_sm);
}

}  // namespace mega
}  // namespace ptt
