// Fused VDP convolution forward for Hopper, sm_90a: the kernels in one bf16
// pass ("default": each product's operands rounded to bf16, the sums in
// float32, as the TPU's MXU computes a DEFAULT-precision dot). The kernels
// and what they compute are in vdp_conv.cuh; the C entry point is in
// vdp_conv.cu. A source of their own, so that nvcc builds these instances
// beside the float32 ones.

#include "vdp_conv.cuh"

namespace supernet {
namespace vdp {

cudaError_t run_bf16_pass(const Args& a, bool relu, bool with_win, int path,
                          int tile_n, int dtype) {
  return run<true>(a, relu, with_win, path, tile_n, dtype);
}

}  // namespace vdp
}  // namespace supernet
