// The persistent decode megakernel (mega_decode.cuh) in its multi-step
// form (mega_decode_loop) for f32 models with dense weights:
// its four (D, rows) instantiations.
#include "mega_decode.cuh"

namespace ptt {
namespace mega {

cudaError_t launch_multi_f32(const Args& a, const Maps& m, int D, int N,
                             cudaStream_t st) {
  return launch_shape<float, float, true>(a, m, D, N, st);
}

cudaError_t occupancy_multi_f32(int D, int N, int* per_sm) {
  return occupancy_shape<float, float, true>(D, N, per_sm);
}

}  // namespace mega
}  // namespace ptt
