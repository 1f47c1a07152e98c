// The CUDA runtime's message for an error code that a kernel entry point
// returned, so the Python wrappers can raise with it.

#include <cuda_runtime.h>

extern "C" const char* supernet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
