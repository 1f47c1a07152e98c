// Moment max-pool (2x2, stride 2) for Hopper, sm_90a: forward and backward.
//
// The forward replaces supernet_tpu/ops/pallas/pool.py:_pool_fwd_kernel
// (launched by _pool_fwd_call). Per output element: the max of the four mu
// taps, sigma at the selected tap, and optionally the tap index 0..3 (the
// backward's residual). Ties go to the first tap in row-major order, exactly
// as pool.py:81-92:
//   p0 = m00 == mx; p1 = !p0 && m01 == mx; p2 = !(p0 || p1) && m10 == mx;
//   otherwise tap 3.
// Odd H or W follow the composition in ops/moments.py:840-847: a missing tap
// counts as mu = finfo(dtype).min and sigma = 0, so no shape leaves the
// kernel.
//
// Dtypes, as the TPU kernel's (pool.py:17-19, 73-95): mu and sigma are
// float32 or bf16, and mx, so and idx come out in that dtype (0..3 are exact
// in bf16). The compares and selects run in float32 registers on the loaded
// values, which a bf16 value converts to exactly; a selected value stored
// back is the value loaded, so the bf16 forward is the float32 forward of
// the same values, bit for bit.
//
// What bounds it: bytes. Each output reads 8 elements and writes 2 or 3,
// with one compare tree in between, so the kernel is a pure streaming pass
// at device-memory bandwidth. Design: one thread per output element with the
// channel index fastest, so a warp's loads and stores cover consecutive
// addresses of the NHWC tensors; 64-bit offsets throughout.
//
// The backward replaces pool.py:_pool_bwd_kernel (launched by
// _pool_bwd_call): each full-resolution element (y, x) takes its window's
// gradient where idx == 2 * (y % 2) + (x % 2) and 0 elsewhere, for g_mu and
// g_sigma alike. idx, g_mu and g_sigma share one dtype, float32 or bf16, and
// d_mu and d_sigma come out in it: the gradients are routed as bit patterns,
// so the routing is exact in either. Odd H or W are cropped as in
// ops/moments.py:_vmaxpool_bwd, so again no shape leaves the kernel. Bound
// by bytes as well: 3 elements read and 8 written per window and channel.
// Design, for C a multiple of the channels in 16 bytes (4 float32 or 8 bf16;
// vmaxpool_bwd_vec_kernel): one thread per pooled window and 16 bytes of
// channels. It reads idx, g_mu and g_sigma once, 16 bytes each, works out
// its window's place once, and writes 16 bytes to each tap of d_mu and
// d_sigma that lies inside H x W, so every input byte is loaded by exactly
// one thread and every access of a warp covers whole 128-byte lines
// (channels fastest, then the window's two taps of a row side by side). Any
// other C takes vmaxpool_bwd_kernel: one thread per full-resolution
// element, channel fastest; the four threads of a window share its inputs
// through L1. Both write every output in one pass: no memset, no atomics,
// bit-exact.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using supernet::bf16;
using supernet::from_f32;
using supernet::to_f32;

constexpr int kThreads = 256;

// jnp.maximum semantics: a NaN in either operand is the result (fmaxf would
// drop it).
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vmaxpool_fwd_kernel(
    const T* __restrict__ mu, const T* __restrict__ sigma,
    T* __restrict__ mx_out, T* __restrict__ so_out, T* __restrict__ idx_out,
    int H, int W, int C, int Ho, int Wo, long long total) {
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
  const float pad = supernet::lowest<T>();

  const float m00 = to_f32(mu[base]), s00 = to_f32(sigma[base]);
  const float m01 = has_x1 ? to_f32(mu[base + dx]) : pad;
  const float s01 = has_x1 ? to_f32(sigma[base + dx]) : 0.f;
  const float m10 = has_y1 ? to_f32(mu[base + dy]) : pad;
  const float s10 = has_y1 ? to_f32(sigma[base + dy]) : 0.f;
  const bool has_11 = has_x1 && has_y1;
  const float m11 = has_11 ? to_f32(mu[base + dy + dx]) : pad;
  const float s11 = has_11 ? to_f32(sigma[base + dy + dx]) : 0.f;

  const float mx = nan_max(nan_max(m00, m01), nan_max(m10, m11));
  const bool p0 = m00 == mx;
  const bool p1 = !p0 && m01 == mx;
  const bool p2 = !(p0 || p1) && m10 == mx;
  mx_out[i] = from_f32<T>(mx);
  so_out[i] = from_f32<T>(p0 ? s00 : (p1 ? s01 : (p2 ? s10 : s11)));
  if (idx_out != nullptr) {
    idx_out[i] = from_f32<T>(p0 ? 0.f : (p1 ? 1.f : (p2 ? 2.f : 3.f)));
  }
}

// T: float or bf16; the gradients move as their bit patterns R.
template <typename T, typename R>
__global__ void __launch_bounds__(kThreads) vmaxpool_bwd_kernel(
    const T* __restrict__ idx, const R* __restrict__ g_mu,
    const R* __restrict__ g_sigma, R* __restrict__ d_mu,
    R* __restrict__ d_sigma, int H, int W, int C, int Ho, int Wo,
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
  const bool sel = to_f32(idx[q]) == static_cast<float>(2 * (y & 1) + (x & 1));
  d_mu[i] = sel ? g_mu[q] : R(0);
  d_sigma[i] = sel ? g_sigma[q] : R(0);
}

// One thread per pooled window x V channels, V = 16 / sizeof(T) (4 float32
// or 8 bf16) held as N 32-bit words; CV = C / V, total = B Ho Wo CV.
template <typename T>
__global__ void __launch_bounds__(kThreads) vmaxpool_bwd_vec_kernel(
    const uint4* __restrict__ idx, const uint4* __restrict__ g_mu,
    const uint4* __restrict__ g_sigma, uint4* __restrict__ d_mu,
    uint4* __restrict__ d_sigma, int H, int W, int CV, int Ho, int Wo,
    unsigned total) {
  constexpr int V = 16 / sizeof(T);
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  unsigned r = i / CV;
  const int cv = static_cast<int>(i - r * CV);
  const unsigned r2 = r / Wo;
  const int ox = static_cast<int>(r - r2 * Wo);
  const unsigned b = r2 / Ho;
  const int oy = static_cast<int>(r2 - b * Ho);

  const uint4 id = idx[i], gm = g_mu[i], gs = g_sigma[i];
  const T* idv = reinterpret_cast<const T*>(&id);
  float tap_of[V];
#pragma unroll
  for (int j = 0; j < V; ++j) tap_of[j] = to_f32(idv[j]);
  const int y0 = 2 * oy, x0 = 2 * ox;
  const long long dx = CV, dy = static_cast<long long>(W) * CV;
  const long long base = ((static_cast<long long>(b) * H + y0) * W + x0) * CV + cv;
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    if ((tap & 1) && x0 + 1 >= W) continue;
    if ((tap & 2) && y0 + 1 >= H) continue;
    const float ft = static_cast<float>(tap);
    // element j of the 16 bytes keeps its bits where idx names this tap
    uint4 om = gm, os = gs;
    unsigned* pm = reinterpret_cast<unsigned*>(&om);
    unsigned* ps = reinterpret_cast<unsigned*>(&os);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      unsigned keep = 0;
#pragma unroll
      for (int e = 0; e < V / 4; ++e) {
        if (tap_of[w * (V / 4) + e] == ft) {
          keep |= V == 4 ? 0xffffffffu : (0xffffu << (16 * e));
        }
      }
      pm[w] &= keep;
      ps[w] &= keep;
    }
    const long long o = base + ((tap & 1) ? dx : 0) + ((tap & 2) ? dy : 0);
    d_mu[o] = om;
    d_sigma[o] = os;
  }
}

template <typename T>
int pool_fwd(const void* mu, const void* sigma, void* mx, void* so, void* idx,
             int B, int H, int W, int C, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long long total = static_cast<long long>(B) * Ho * Wo * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  vmaxpool_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(mu), static_cast<const T*>(sigma),
      static_cast<T*>(mx), static_cast<T*>(so), static_cast<T*>(idx), H, W, C,
      Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename R>
int pool_bwd(const void* idx, const void* g_mu, const void* g_sigma,
             void* d_mu, void* d_sigma, int B, int H, int W, int C, int vec,
             cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int CV = C / V;
    const long long total = static_cast<long long>(B) * Ho * Wo * CV;
    if (C % V != 0 || total >= (1ll << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long blocks = (total + kThreads - 1) / kThreads;
    vmaxpool_bwd_vec_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const uint4*>(idx), static_cast<const uint4*>(g_mu),
        static_cast<const uint4*>(g_sigma), static_cast<uint4*>(d_mu),
        static_cast<uint4*>(d_sigma), H, W, CV, Ho, Wo,
        static_cast<unsigned>(total));
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(B) * H * W * C;
  const long long blocks = (total + kThreads - 1) / kThreads;
  vmaxpool_bwd_kernel<T, R><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(idx), static_cast<const R*>(g_mu),
      static_cast<const R*>(g_sigma), static_cast<R*>(d_mu),
      static_cast<R*>(d_sigma), H, W, C, Ho, Wo, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mu, sigma: [B, H, W, C], contiguous, of dtype `dtype` (0 float32, 1 bf16).
// mx, so (and idx, or null): [B, ceil(H/2), ceil(W/2), C] of the same dtype.
// Launches on `stream` and returns cudaGetLastError() so a refused launch is
// seen by the caller.
extern "C" int supernet_vmaxpool_fwd(const void* mu, const void* sigma,
                                     void* mx, void* so, void* idx, int B,
                                     int H, int W, int C, int dtype,
                                     void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == supernet::kFloat32) return pool_fwd<float>(mu, sigma, mx, so, idx, B, H, W, C, st);
  if (dtype == supernet::kBFloat16) return pool_fwd<bf16>(mu, sigma, mx, so, idx, B, H, W, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// idx, g_mu, g_sigma: [B, ceil(H/2), ceil(W/2), C], contiguous, of dtype
// `dtype`. d_mu, d_sigma: [B, H, W, C] of the same dtype. `vec` picks the
// 16-byte kernel: C a multiple of 16 / element size, every pointer on 16
// bytes and fewer than 2^31 windows x C / (16 / element size). Launches on
// `stream` and returns cudaGetLastError().
extern "C" int supernet_vmaxpool_bwd(const void* idx, const void* g_mu,
                                     const void* g_sigma, void* d_mu,
                                     void* d_sigma, int B, int H, int W, int C,
                                     int vec, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == supernet::kFloat32) {
    return pool_bwd<float, unsigned>(idx, g_mu, g_sigma, d_mu, d_sigma, B, H, W, C, vec, st);
  }
  if (dtype == supernet::kBFloat16) {
    return pool_bwd<bf16, unsigned short>(idx, g_mu, g_sigma, d_mu, d_sigma, B, H, W, C, vec, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
