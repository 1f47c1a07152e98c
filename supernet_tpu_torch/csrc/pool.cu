// Moment max-pool (2x2, stride 2) for Hopper, sm_90a: forward and backward.
//
// The forward replaces supernet_tpu/ops/pallas/pool.py:_pool_fwd_kernel
// (launched by _pool_fwd_call). Per output element: the max of the four mu
// taps, sigma at the selected tap, and optionally the tap index 0..3 (as
// float, the backward's residual). Ties go to the first tap in row-major
// order, exactly as pool.py:81-92:
//   p0 = m00 == mx; p1 = !p0 && m01 == mx; p2 = !(p0 || p1) && m10 == mx;
//   otherwise tap 3.
// Odd H or W follow the composition in ops/moments.py:840-847: a missing tap
// counts as mu = finfo(float32).min and sigma = 0, so no shape leaves the
// kernel.
//
// What bounds it: bytes. Each output reads 8 floats and writes 2 or 3, with
// one compare tree in between, so the kernel is a pure streaming pass at
// device-memory bandwidth. Design: one thread per output element with the
// channel index fastest, so a warp's loads and stores cover consecutive
// addresses of the NHWC tensors; 64-bit offsets throughout.
//
// The backward replaces pool.py:_pool_bwd_kernel (launched by
// _pool_bwd_call): each full-resolution element (y, x) takes its window's
// gradient where idx == 2 * (y % 2) + (x % 2) and 0 elsewhere, for g_mu and
// g_sigma alike. Odd H or W are cropped as in ops/moments.py:_vmaxpool_bwd,
// so again no shape leaves the kernel. Bound by bytes as well: 3 floats read
// and 8 written per window and channel. Design, for C % 4 == 0
// (vmaxpool_bwd_vec_kernel): one thread per pooled window and 4 channels.
// It reads idx, g_mu and g_sigma once, 16 bytes each, works out its window's
// place once, and writes 16 bytes to each tap of d_mu and d_sigma that lies
// inside H x W, so every input byte is loaded by exactly one thread and
// every access of a warp covers whole 128-byte lines (channels fastest,
// then the window's two taps of a row side by side). Any other C takes
// vmaxpool_bwd_kernel: one thread per full-resolution element, channel
// fastest; the four threads of a window share its inputs through L1. Both
// write every output in one pass: no memset, no atomics, bit-exact.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kThreads = 256;

// jnp.maximum semantics: a NaN in either operand is the result (fmaxf would
// drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads) vmaxpool_fwd_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma,
    float* __restrict__ mx_out, float* __restrict__ so_out,
    float* __restrict__ idx_out, int H, int W, int C, int Ho, int Wo,
    long long total) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  long long r = i / C;
  const int ox = static_cast<int>(r % Wo);
  r /= Wo;
  const int oy = static_cast<int>(r % Ho);
  const long long b = r / Ho;

  const int y0 = 2 * oy, x0 = 2 * ox;
  const bool has_x1 = x0 + 1 < W, has_y1 = y0 + 1 < H;
  const long long base = ((b * H + y0) * W + x0) * C + c;
  const long long dx = C, dy = static_cast<long long>(W) * C;

  const float m00 = mu[base], s00 = sigma[base];
  const float m01 = has_x1 ? mu[base + dx] : -FLT_MAX;
  const float s01 = has_x1 ? sigma[base + dx] : 0.f;
  const float m10 = has_y1 ? mu[base + dy] : -FLT_MAX;
  const float s10 = has_y1 ? sigma[base + dy] : 0.f;
  const bool has_11 = has_x1 && has_y1;
  const float m11 = has_11 ? mu[base + dy + dx] : -FLT_MAX;
  const float s11 = has_11 ? sigma[base + dy + dx] : 0.f;

  const float mx = nan_max(nan_max(m00, m01), nan_max(m10, m11));
  const bool p0 = m00 == mx;
  const bool p1 = !p0 && m01 == mx;
  const bool p2 = !(p0 || p1) && m10 == mx;
  mx_out[i] = mx;
  so_out[i] = p0 ? s00 : (p1 ? s01 : (p2 ? s10 : s11));
  if (idx_out != nullptr) {
    idx_out[i] = p0 ? 0.f : (p1 ? 1.f : (p2 ? 2.f : 3.f));
  }
}

__global__ void __launch_bounds__(kThreads) vmaxpool_bwd_kernel(
    const float* __restrict__ idx, const float* __restrict__ g_mu,
    const float* __restrict__ g_sigma, float* __restrict__ d_mu,
    float* __restrict__ d_sigma, int H, int W, int C, int Ho, int Wo,
    long long total) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i % C);
  long long r = i / C;
  const int x = static_cast<int>(r % W);
  r /= W;
  const int y = static_cast<int>(r % H);
  const long long b = r / H;

  const long long q = ((b * Ho + (y >> 1)) * Wo + (x >> 1)) * C + c;
  const bool sel = idx[q] == static_cast<float>(2 * (y & 1) + (x & 1));
  d_mu[i] = sel ? g_mu[q] : 0.f;
  d_sigma[i] = sel ? g_sigma[q] : 0.f;
}

// One thread per pooled window x 4 channels; C4 = C / 4, total = B Ho Wo C4.
__global__ void __launch_bounds__(kThreads) vmaxpool_bwd_vec_kernel(
    const float4* __restrict__ idx, const float4* __restrict__ g_mu,
    const float4* __restrict__ g_sigma, float4* __restrict__ d_mu,
    float4* __restrict__ d_sigma, int H, int W, int C4, int Ho, int Wo,
    unsigned total) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  unsigned r = i / C4;
  const int c4 = static_cast<int>(i - r * C4);
  const unsigned r2 = r / Wo;
  const int ox = static_cast<int>(r - r2 * Wo);
  const unsigned b = r2 / Ho;
  const int oy = static_cast<int>(r2 - b * Ho);

  const float4 id = idx[i], gm = g_mu[i], gs = g_sigma[i];
  const int y0 = 2 * oy, x0 = 2 * ox;
  const long long dx = C4, dy = static_cast<long long>(W) * C4;
  const long long base = ((static_cast<long long>(b) * H + y0) * W + x0) * C4 + c4;
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    if ((tap & 1) && x0 + 1 >= W) continue;
    if ((tap & 2) && y0 + 1 >= H) continue;
    const float ft = static_cast<float>(tap);
    const bool sx = id.x == ft, sy = id.y == ft, sz = id.z == ft, sw = id.w == ft;
    const long long o = base + ((tap & 1) ? dx : 0) + ((tap & 2) ? dy : 0);
    d_mu[o] = make_float4(sx ? gm.x : 0.f, sy ? gm.y : 0.f, sz ? gm.z : 0.f,
                          sw ? gm.w : 0.f);
    d_sigma[o] = make_float4(sx ? gs.x : 0.f, sy ? gs.y : 0.f, sz ? gs.z : 0.f,
                             sw ? gs.w : 0.f);
  }
}

}  // namespace

// mu, sigma: [B, H, W, C] float32, contiguous. mx, so (and idx, or null):
// [B, ceil(H/2), ceil(W/2), C]. Launches on `stream` and returns
// cudaGetLastError() so a refused launch is seen by the caller.
extern "C" int supernet_vmaxpool_fwd(const void* mu, const void* sigma,
                                     void* mx, void* so, void* idx, int B,
                                     int H, int W, int C, void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long total = static_cast<long long>(B) * Ho * Wo * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  vmaxpool_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<float*>(mx), static_cast<float*>(so),
      static_cast<float*>(idx), H, W, C, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}

// idx, g_mu, g_sigma: [B, ceil(H/2), ceil(W/2), C] float32, contiguous.
// d_mu, d_sigma: [B, H, W, C]. `vec` picks the 16-byte kernel: C % 4 == 0,
// every pointer on 16 bytes and fewer than 2^31 windows x C/4. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int supernet_vmaxpool_bwd(const void* idx, const void* g_mu,
                                     const void* g_sigma, void* d_mu,
                                     void* d_sigma, int B, int H, int W, int C,
                                     int vec, void* stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  if (vec) {
    const int C4 = C / 4;
    const long long total = static_cast<long long>(B) * Ho * Wo * C4;
    if (C % 4 != 0 || total >= (1ll << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long blocks = (total + kThreads - 1) / kThreads;
    vmaxpool_bwd_vec_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(idx), static_cast<const float4*>(g_mu),
        static_cast<const float4*>(g_sigma), static_cast<float4*>(d_mu),
        static_cast<float4*>(d_sigma), H, W, C4, Ho, Wo,
        static_cast<unsigned>(total));
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(B) * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  vmaxpool_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(idx), static_cast<const float*>(g_mu),
      static_cast<const float*>(g_sigma), static_cast<float*>(d_mu),
      static_cast<float*>(d_sigma), H, W, C, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}
