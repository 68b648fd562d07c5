// Helpers shared by the attention kernels and the MK-MMD kernel: dtype
// conversion to and from f32, warp reductions, rounding up.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

}  // namespace
