// Helpers shared by the kernels in this folder: dtype conversion to and from
// f32, warp reductions, rounding up, pointer alignment, the dynamic
// shared-memory opt-in, and a fixed-order column sum of per-block partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }
inline bool aligned4(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 3u) == 0; }

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

// Sum of x over a block of THREADS threads, in a fixed order (each warp's
// lane 0, then the warps in turn), so the same from run to run; every thread
// gets it.  red holds THREADS / 32 floats.
template <int THREADS>
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) total += red[w];
  return total;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Resident blocks per SM of `kernel` at this block size and dynamic shared
// memory, from the occupancy calculator (registers, shared memory, threads).
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
}

// out[c] = sum over r of part[r * cols + c], r = 0 .. rows - 1, in one fixed
// order: thread (group, lane) of a 256-thread block adds rows group, group +
// 8, ... of column blockIdx.x * 32 + lane, then group 0 adds the 8 group sums
// in order.  No atomics, so the result is the same from run to run.
__global__ void __launch_bounds__(256) column_sum_kernel(const float* part, float* out, int rows,
                                                         int cols) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (c < cols) {
    for (int r = group; r < rows; r += 8) acc += part[(size_t)r * cols + c];
  }
  sums[group][lane] = acc;
  __syncthreads();
  if (group == 0 && c < cols) {
    float total = 0.0f;
#pragma unroll
    for (int g = 0; g < 8; ++g) total += sums[g][lane];
    out[c] = total;
  }
}

inline cudaError_t launch_column_sum(const float* part, float* out, int rows, int cols,
                                     cudaStream_t stream) {
  column_sum_kernel<<<(cols + 31) / 32, 256, 0, stream>>>(part, out, rows, cols);
  return cudaGetLastError();
}

}  // namespace
