// The element types the kernels load and store: float32 and bfloat16.
//
// The TPU kernels keep their blocks in device memory in the activation dtype
// and compute in float32 (supernet_tpu/ops/pallas/pool.py:73-95,
// sigma_bwd.py:82-84); the kernels here do the same. A bf16 value converts
// to float32 exactly (its 16 bits are the high half of the float), and a
// float32 result is rounded to bf16 once, to nearest even, as
// torch.Tensor.to(torch.bfloat16) rounds it. float32 loads and stores are
// plain ones, so a float32 call computes what it did before.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace supernet {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// The most negative finite value of T (finfo(T).min): the pool's padding.
template <typename T>
__device__ __forceinline__ float lowest();
template <>
__device__ __forceinline__ float lowest<float>() {
  return -3.40282347e+38f;
}
template <>
__device__ __forceinline__ float lowest<bf16>() {
  return __uint_as_float(0xff7f0000u);
}

// Four consecutive elements (16 bytes of float32, 8 of bf16) as float32;
// p on a boundary of their size.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u),
                     __uint_as_float(r.y << 16), __uint_as_float(r.y & 0xffff0000u));
}

// Two or four consecutive float32 results stored as T, each rounded once.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 r;
  r.x = *reinterpret_cast<const uint32_t*>(&lo);
  r.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = r;
}

// x rounded to the nearest bf16 (ties to even) and back: the operand a
// tensor core takes in one bf16 pass.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two float32 values rounded to bf16 (ties to even), lo in the low half:
// a bf16x2 operand register, lower K index first.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The dtype codes of the C entry points: 0 float32, 1 bfloat16.
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace supernet
