// The CUDA runtime's text for an error code the kernels' entry points
// returned, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
