// Element types of the kernels that come in a float32 and a bfloat16
// instance (dconv_col.cu, dconv_col_bwd.cu, psroi_abuild.cu,
// psroi_abuild_bwd.cu): conversions to and from float, in which every
// instance computes, and the 4-wide loads and stores of their tiled paths.
// bf16 rounds to nearest even (the _rn intrinsics), as XLA's convert does.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mx {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// v rounded to the nearest bf16, as a float
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ uint2 float4_to_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  return u;
}

// four consecutive elements (16 bytes of float, 8 of bf16, aligned so),
// read through the read-only cache
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const bf16* p) {
  return bf16x4_to_float4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// four consecutive elements from shared memory
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const bf16* p) {
  return bf16x4_to_float4(*reinterpret_cast<const uint2*>(p));
}

// four consecutive elements as a streaming store (st.global.cs)
__device__ __forceinline__ void stcs4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);
}
__device__ __forceinline__ void stcs4(bf16* p, float4 v) {
  __stcs(reinterpret_cast<uint2*>(p), float4_to_bf16x4(v));
}

}  // namespace mx
