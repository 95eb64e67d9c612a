// The persistent decode megakernel (mega_decode.cuh) for f32 models
// with int8 weights: its four (D, rows) instantiations.
#include "mega_decode.cuh"

namespace ptt {
namespace mega {

cudaError_t launch_f32_w8(const Args& a, const Maps& m, int D, int N,
                          cudaStream_t st) {
  return launch_shape<float, int8_t, false>(a, m, D, N, st);
}

cudaError_t occupancy_f32_w8(int D, int N, int* per_sm) {
  return occupancy_shape<float, int8_t, false>(D, N, per_sm);
}

}  // namespace mega
}  // namespace ptt
