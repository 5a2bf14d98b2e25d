// Helpers shared by every kernel of the library (plain C interface).

#include <cuda_runtime.h>

extern "C" {

// The CUDA runtime's message for an error code a launch function returned.
const char* bulklmm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
