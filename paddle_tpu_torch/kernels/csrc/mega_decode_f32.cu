// The persistent decode megakernel (mega_decode.cuh) for f32 models
// with dense weights: its four (D, rows) instantiations.
#include "mega_decode.cuh"

namespace ptt {
namespace mega {

cudaError_t launch_f32(const Args& a, const Maps& m, int D, int N,
                       cudaStream_t st) {
  return launch_shape<float, float, false>(a, m, D, N, st);
}

cudaError_t occupancy_f32(int D, int N, int* per_sm) {
  return occupancy_shape<float, float, false>(D, N, per_sm);
}

}  // namespace mega
}  // namespace ptt
