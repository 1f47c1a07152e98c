// An empty kernel, one block of one thread: what the card takes for a launch
// that does no work. profiling.py times it beside the small layers' kernels,
// whose byte bounds lie below it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches the empty kernel on `stream` and returns cudaGetLastError().
extern "C" int supernet_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
