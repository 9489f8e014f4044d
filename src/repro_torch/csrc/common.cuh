// Element conversions shared by the port's float32 / bfloat16 kernels:
// they load either type as f32, compute in f32, and store in the input
// type (bf16 rounds to nearest even, as XLA's convert does).
#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
