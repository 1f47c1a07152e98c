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
// values, which a bf16 value converts to exactly (the vector kernel compares
// bf16 pairs, which is exact as well); a selected value stored back is the
// value loaded, so the bf16 forward is the float32 forward of the same
// values, bit for bit.
//
// What bounds it: bytes. Each output reads 8 elements and writes 2 or 3,
// with one compare tree in between, so the kernel is a pure streaming pass
// at device-memory bandwidth. Design, for C a multiple of the channels in
// 16 bytes (4 float32 or 8 bf16; vmaxpool_fwd_vec_kernel): one thread per
// pooled window and 16 bytes of channels. It issues its eight 16-byte loads
// (four taps of mu and of sigma, through the read-only path) before any
// compare, selects per element, and writes mx, so and idx as one 16-byte
// store each. Channels run fastest, then the window, so a warp's loads use
// every 32-byte sector they touch and every input byte is read by exactly
// one thread. Index math is 32-bit. A window at an odd bottom or right edge
// skips the loads of its missing taps. Each kernel runs in one wave: its
// loads, then its compares, then its stores, so the compare tree's
// instructions add to the bytes' time instead of hiding under it. Hence the
// max is one max.NaN instruction, and bf16 compares as bf16x2 pairs (two
// elements an instruction; a max and an equality are exact on bf16 values
// as on their float32 upcasts), so that a bf16 pool's instructions halve
// with its bytes; a selected so or idx is moved as bits. The block size
// comes from the planner (ops/kernels/pool.py:plan_fwd), measured on the
// card. Any other C takes vmaxpool_fwd_kernel: one thread per output
// element, channel fastest, compared in float32, 64-bit offsets.
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

// jnp.maximum semantics: a NaN in either operand makes the result NaN
// (fmaxf would drop it). One instruction; the NaN it returns is canonical.
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The same on two bf16 values in one 32-bit word, and their equality as a
// mask of 0xffff per equal half. Both are exact, as on the float32 upcasts:
// a max is one of its operands (or NaN), and NaN equals nothing.
__device__ __forceinline__ unsigned nan_max2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned eq2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) vmaxpool_fwd_kernel(
    const T* __restrict__ mu, const T* __restrict__ sigma,
    T* __restrict__ mx_out, T* __restrict__ so_out, T* __restrict__ idx_out,
    int H, int W, int C, int Ho, int Wo, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
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

// The selection of one thread of the vector forward: m and s hold the four
// taps' 16 bytes of mu and sigma (a missing tap's words 0), has which taps
// lie inside H x W. Per element: mx, so at the first tap that equals it, and
// that tap's index 0..3, written as 16 bytes each.
template <typename T>
__device__ __forceinline__ void select_taps(const uint4 (&m)[4], const uint4 (&s)[4],
                                            const bool (&has)[4], uint4& mx, uint4& so,
                                            uint4& idx);

// float32: four elements, one per word
template <>
__device__ __forceinline__ void select_taps<float>(const uint4 (&m)[4], const uint4 (&s)[4],
                                                   const bool (&has)[4], uint4& mx,
                                                   uint4& so, uint4& idx) {
  const float pad = supernet::lowest<float>();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = has[k] ? __uint_as_float((&m[k].x)[j]) : pad;
    const float x = nan_max(nan_max(t[0], t[1]), nan_max(t[2], t[3]));
    const bool p0 = t[0] == x;
    const bool p1 = !p0 && t[1] == x;
    const bool p2 = !(p0 || p1) && t[2] == x;
    (&mx.x)[j] = __float_as_uint(x);
    (&so.x)[j] = p0 ? (&s[0].x)[j]
                    : (p1 ? (&s[1].x)[j] : (p2 ? (&s[2].x)[j] : (&s[3].x)[j]));
    (&idx.x)[j] = __float_as_uint(p0 ? 0.f : (p1 ? 1.f : (p2 ? 2.f : 3.f)));
  }
}

// bf16: eight elements, two per word, compared as bf16x2 pairs
template <>
__device__ __forceinline__ void select_taps<bf16>(const uint4 (&m)[4], const uint4 (&s)[4],
                                                  const bool (&has)[4], uint4& mx,
                                                  uint4& so, uint4& idx) {
  const unsigned pad = 0xff7fff7fu;  // finfo(bfloat16).min, twice
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    unsigned t[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) t[k] = has[k] ? (&m[k].x)[j] : pad;
    const unsigned x = nan_max2(nan_max2(t[0], t[1]), nan_max2(t[2], t[3]));
    const unsigned p0 = eq2(t[0], x);
    const unsigned p1 = ~p0 & eq2(t[1], x);
    const unsigned p2 = ~(p0 | p1) & eq2(t[2], x);
    const unsigned p3 = ~(p0 | p1 | p2);
    (&mx.x)[j] = x;
    (&so.x)[j] = ((&s[0].x)[j] & p0) | ((&s[1].x)[j] & p1) | ((&s[2].x)[j] & p2) |
                 ((&s[3].x)[j] & p3);
    // 1.0, 2.0 and 3.0 in bf16, twice (0 is all zero bits)
    (&idx.x)[j] = (0x3f803f80u & p1) | (0x40004000u & p2) | (0x40404040u & p3);
  }
}

// One thread per pooled window x 16 bytes of channels (4 float32 or 8
// bf16); CV = C / those, total = B Ho Wo CV, the block size the launch's.
template <typename T>
__global__ void __launch_bounds__(kThreads) vmaxpool_fwd_vec_kernel(
    const uint4* __restrict__ mu, const uint4* __restrict__ sigma,
    uint4* __restrict__ mx_out, uint4* __restrict__ so_out,
    uint4* __restrict__ idx_out, int H, int W, int CV, int Ho, int Wo,
    unsigned total) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const unsigned r = i / CV;
  const int cv = static_cast<int>(i - r * CV);
  const unsigned r2 = r / Wo;
  const int ox = static_cast<int>(r - r2 * Wo);
  const unsigned b = r2 / Ho;
  const int oy = static_cast<int>(r2 - b * Ho);

  const int y0 = 2 * oy, x0 = 2 * ox;
  const bool has_x1 = x0 + 1 < W, has_y1 = y0 + 1 < H;
  const bool has[4] = {true, has_x1, has_y1, has_x1 && has_y1};
  const long long base = ((static_cast<long long>(b) * H + y0) * W + x0) * CV + cv;
  const long long off[4] = {0, CV, static_cast<long long>(W) * CV,
                            static_cast<long long>(W + 1) * CV};
  // all eight loads in flight before the first compare
  uint4 m[4], s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m[k] = has[k] ? __ldg(mu + base + off[k]) : make_uint4(0u, 0u, 0u, 0u);
    s[k] = has[k] ? __ldg(sigma + base + off[k]) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint4 mx, so, idx;
  select_taps<T>(m, s, has, mx, so, idx);
  mx_out[i] = mx;
  so_out[i] = so;
  if (idx_out != nullptr) idx_out[i] = idx;
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
             int B, int H, int W, int C, int vec, int threads,
             cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  if (threads < 32 || threads > kThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int CV = C / V;
    const long long total = static_cast<long long>(B) * Ho * Wo * CV;
    if (C % V != 0 || total >= (1ll << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long blocks = (total + threads - 1) / threads;
    vmaxpool_fwd_vec_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        static_cast<const uint4*>(mu), static_cast<const uint4*>(sigma),
        static_cast<uint4*>(mx), static_cast<uint4*>(so), static_cast<uint4*>(idx),
        H, W, CV, Ho, Wo, static_cast<unsigned>(total));
    return static_cast<int>(cudaGetLastError());
  }
  const long long total = static_cast<long long>(B) * Ho * Wo * C;
  const long long blocks = (total + threads - 1) / threads;
  vmaxpool_fwd_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
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
// `vec` picks the 16-byte kernel: C a multiple of 16 / element size, every
// pointer on 16 bytes and fewer than 2^31 windows x C / (16 / element size).
// `threads` is the block size, a multiple of 32 up to 256. Launches on
// `stream` and returns cudaGetLastError() so a refused launch is seen by the
// caller.
extern "C" int supernet_vmaxpool_fwd(const void* mu, const void* sigma,
                                     void* mx, void* so, void* idx, int B,
                                     int H, int W, int C, int vec, int threads,
                                     int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == supernet::kFloat32) {
    return pool_fwd<float>(mu, sigma, mx, so, idx, B, H, W, C, vec, threads, st);
  }
  if (dtype == supernet::kBFloat16) {
    return pool_fwd<bf16>(mu, sigma, mx, so, idx, B, H, W, C, vec, threads, st);
  }
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
