// Shared pieces of the fused LayerNorm kernels (B4): one warp owns one row
// of x [M, C] at a time and keeps it in registers.  Lane l holds columns
// 128 * i + 4 * l .. + 3 for i < C / 128, so each load and store is 4
// neighbouring elements per lane (16 bytes in f32, 8 in bf16) and a warp
// reads 512 contiguous bytes (f32) per step.  C must be a multiple of 128 and
// at most kMaxLnChunks * 128 = 2048 (the widest LayerNorm of the model
// normalises 4 * 512 channels in the last patch merge).

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int kMaxLnChunks = 16;  // C <= 2048

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  v[0] = __low2float(lo);
  v[1] = __high2float(lo);
  v[2] = __low2float(hi);
  v[3] = __high2float(hi);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 x;
  x.x = *reinterpret_cast<uint32_t*>(&lo);
  x.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = x;
}

// Row mean and rstd = rsqrt(var + eps) in f32, two passes over the registers
// (mean, then the mean of squared deviations), as the Pallas _row_stats.
template <int CHUNKS>
__device__ __forceinline__ void row_stats(const float (&x)[CHUNKS][4], int c, float eps,
                                          float& mean, float& rstd) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) s += (x[i][0] + x[i][1]) + (x[i][2] + x[i][3]);
  mean = warp_sum(s) / (float)c;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = x[i][j] - mean;
      q = fmaf(d, d, q);
    }
  rstd = rsqrtf(warp_sum(q) / (float)c + eps);
}

// Calls launch.template operator()<CHUNKS>() for CHUNKS = c / 128.
template <typename Launch>
cudaError_t dispatch_chunks(int c, Launch&& launch) {
  switch (c / 128) {
    case 1: return launch.template operator()<1>();
    case 2: return launch.template operator()<2>();
    case 3: return launch.template operator()<3>();
    case 4: return launch.template operator()<4>();
    case 5: return launch.template operator()<5>();
    case 6: return launch.template operator()<6>();
    case 7: return launch.template operator()<7>();
    case 8: return launch.template operator()<8>();
    case 9: return launch.template operator()<9>();
    case 10: return launch.template operator()<10>();
    case 11: return launch.template operator()<11>();
    case 12: return launch.template operator()<12>();
    case 13: return launch.template operator()<13>();
    case 14: return launch.template operator()<14>();
    case 15: return launch.template operator()<15>();
    case 16: return launch.template operator()<16>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
