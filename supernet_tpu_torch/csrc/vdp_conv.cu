// Fused VDP convolution forward for Hopper, sm_90a: the C entry point and
// the kernels at float32 accuracy ("high" and "highest": exact float32 on
// the CUDA cores, 3xTF32 on the tensor cores). The kernels and what they
// compute are in vdp_conv.cuh; vdp_conv_bf16.cu holds their one-bf16-pass
// instances ("default").

#include "vdp_conv.cuh"

namespace supernet {
namespace vdp {

cudaError_t run_f32(const Args& a, bool relu, bool with_win, int path,
                    int tile_n, int dtype) {
  return run<false>(a, relu, with_win, path, tile_n, dtype);
}

}  // namespace vdp
}  // namespace supernet

// mu (and sigma, or null for the input layer): [B, H, W, Cin] of dtype
// `dtype` (0 float32, 1 bf16); w_mu: [k, k, Cin, Cout] (HWIO) float32; sw:
// softplus(w_sigma), [Cout] float32. mu_out, sig_out: [B, H-k+1, W-k+1,
// Cout], of `dtype` with the window sum and float32 without it; win: [B,
// H-k+1, W-k+1, 1] float32. All contiguous, and 16-byte aligned on the
// tensor-core path.
// bf16_pass: 0 float32 accuracy, 1 one bf16 pass (the products' operands
//   rounded to bf16, the sums in float32; see vdp_conv.cuh).
// path 0: the CUDA-core kernel, tile_n (CT) 32 or 64, splits 1, flip_w 0
//   (tile_h, tile_w and planes are not read).
// path 1: the tensor-core kernel: k 3, Cin % 8 == 0 (Cin % 16 == 0 in one
//   bf16 pass), Cout % 4 == 0, 9 Cin Cout and (tile_h + 2) W Cin below 2^31
//   (its offsets are ints), tile_n 32 or 64, a tile of tile_h x tile_w
//   output pixels (at most 64, its halo (tile_h + 2) (tile_w + 2) at most
//   kTcMaxHalo), splits dividing Cin / 8 (Cin / 16); `planes` holds the
//   weight planes, members (Cin / 8) 9 ceil(Cout / tile_n) 32 tile_n words
//   (one bf16 pass: members (Cin / 16) 9 ceil(Cout / tile_n) 16 tile_n);
//   with splits > 1, `scratch` holds 2 splits M Cout + splits M floats
//   (M = B (H-2) (W-2)). flip_w 1: w_mu is [k, k, Cout, Cin], the forward
//   weights of the conv whose transposed pair this call computes, read with
//   the taps mirrored and Cin, Cout swapped.
// with_win 0: no window sum and no ReLU; sw and win are not read or
//   written (may be null), and without sigma neither is sig_out.
// mask: null, or with the ReLU [B, H-k+1, W-k+1, Cout] bytes that receive
//   mu_out > 0 as computed in float32 before the ReLU and the rounding.
// members: the member axis (1 for one parameter set). w_mu, sw and the
//   outputs then hold `members` blocks one after another, and member m reads
//   mu + m x_ms, sigma + m x_ms, w_mu + m w_ms and sw + m sw_ms (elements;
//   x_ms 0 is one input batch shared by every member); with splits > 1,
//   `scratch` holds `members` times the floats above.
// The plan comes from ops/kernels/vdp_conv.py:plan. Launches on `stream`
// and returns cudaGetLastError(); a plan the kernels do not take is
// cudaErrorInvalidValue, and a k whose CUDA-core tiles need more shared
// memory than a block may have comes back as the error of
// cudaFuncSetAttribute.
extern "C" int supernet_vdp_conv_fwd(const void* mu, const void* sigma,
                                     const void* w_mu, const void* sw,
                                     void* mu_out, void* sig_out, void* win,
                                     void* scratch, void* planes, void* mask,
                                     int B, int H, int W, int Cin, int Cout,
                                     int k, int fuse_relu, int with_win,
                                     int path, int tile_n, int tile_h,
                                     int tile_w, int flip_w, int splits,
                                     int members, int dtype, int bf16_pass,
                                     long long x_ms, long long w_ms,
                                     long long sw_ms, void* stream) {
  using supernet::vdp::Args;
  const bool relu = fuse_relu != 0;
  const bool ww = with_win != 0;
  const Args a{mu, sigma, static_cast<const float*>(w_mu),
               static_cast<const float*>(sw), mu_out, sig_out,
               static_cast<float*>(win), static_cast<float*>(scratch),
               static_cast<uint32_t*>(planes), static_cast<uint8_t*>(mask), B,
               H, W, Cin, Cout, k, splits, members, tile_h, tile_w,
               flip_w != 0, x_ms, w_ms, sw_ms, static_cast<cudaStream_t>(stream)};
  if (ww ? (sw == nullptr || sig_out == nullptr || win == nullptr)
         : (relu || (sigma != nullptr && sig_out == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (members < 1 || x_ms < 0 || w_ms < 0 || sw_ms < 0 ||
      (mask != nullptr && !relu) || (bf16_pass != 0 && bf16_pass != 1) ||
      (flip_w != 0 && flip_w != 1) ||
      (dtype != supernet::kFloat32 && dtype != supernet::kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kk = supernet::vdp::tc_step_channels(bf16_pass != 0);
  const bool simt_ok = path == 0 && splits == 1 && flip_w == 0 &&
                       (tile_n == 32 || tile_n == 64) &&
                       static_cast<long long>(members) * B <= 65535;
  const bool tc_ok = path == 1 && k == 3 && Cin % kk == 0 && Cout % 4 == 0 &&
                     tile_h >= 1 && tile_w >= 1 &&
                     tile_h * tile_w <= supernet::vdp::tc::kTileM &&
                     (tile_h + 2) * (tile_w + 2) <= supernet::vdp::kTcMaxHalo &&
                     9LL * Cin * Cout < (1LL << 31) &&
                     (tile_h + 2LL) * W * Cin < (1LL << 31) && planes != nullptr &&
                     splits >= 1 && (Cin / kk) % splits == 0 &&
                     static_cast<long long>(members) * splits <= 65535 &&
                     (splits == 1 || scratch != nullptr) &&
                     (tile_n == 32 || tile_n == 64);
  if (!simt_ok && !tc_ok) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16_pass ? supernet::vdp::run_bf16_pass(a, relu, ww, path, tile_n, dtype)
                : supernet::vdp::run_f32(a, relu, ww, path, tile_n, dtype);
  return static_cast<int>(err);
}
