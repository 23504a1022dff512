// Element I/O and lane-group reductions shared by the LM kernels.
//
// Inputs are float32 or bfloat16; every product and sum runs in float32,
// as in the TPU kernels (`.astype(jnp.float32)` before each dot).  Masked
// scores are kNegInf = -1e30, not -inf, exactly as on the TPU: a tile that
// is masked in full before a row's first valid key then adds exp(0) = 1 per
// entry, and the first valid tile's correction exp(-1e30 - m) = 0 erases it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes at p (16-byte aligned) as floats: 4 float32 or 8 bfloat16.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* out);
template <>
__device__ __forceinline__ void load16<float>(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

// Sum / max over the `kWidth` consecutive lanes of a lane group (kWidth a
// power of two <= 32); every lane of the group gets the result.
template <int kWidth>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kWidth>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace repro
