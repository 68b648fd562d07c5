// Products on the wgmma mainloop (hopper_gemm.cuh) that the bf16 routes of
// the fused MLP (B5) and the fused attention sublayer (B6) share: their
// epilogues, the weight gradients over M with their split partials, and
// the column sums of a bf16 matrix over its rows (bias gradients).
//
// No atomics: every sum over M is taken in one fixed order (split partials
// and row-block partials, then column_sum4_kernel or column_sum_kernel), so
// the results are the same bit for bit from run to run.

#pragma once

#include <type_traits>

#include "hopper_gemm.cuh"

namespace {

// out = bf16(acc) for the rows below m.
struct StoreEpilogue {
  __nv_bfloat16* out;
  int m, ld;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int, __nv_bfloat16* stage) const {
    store_rows_bf16<BN>(stage, out, ld, m0 + 16 * (threadIdx.x >> 5), n0, m, [&](int j, int half) {
      return __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    });
  }
};

// out = bf16(acc + bias[col]) for the rows below m, the bias added in f32.
struct BiasEpilogue {
  __nv_bfloat16* out;
  const float* bias;
  int m, ld;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int, __nv_bfloat16* stage) const {
    const float* b = bias + n0 + acc_col0();
    store_rows_bf16<BN>(stage, out, ld, m0 + 16 * (threadIdx.x >> 5), n0, m, [&](int j, int half) {
      const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j);
      return __floats2bfloat162_rn(acc[4 * j + 2 * half] + bj.x, acc[4 * j + 2 * half + 1] + bj.y);
    });
  }
};

// out = acc in f32 for the rows below m; a quad's four float2 stores fill
// one 32-byte sector, so no staging.
struct StoreF32Epilogue {
  float* out;
  int m, ld;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int, __nv_bfloat16*) const {
    const int row = m0 + acc_row0();
    float* o = out + (size_t)row * ld + n0 + acc_col0();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (row < m) *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (row + 8 < m) *reinterpret_cast<float2*>(o + 8 * ld + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// out[split] = acc, f32 (a weight gradient, or a split's partial of it); a
// quad's four float2 stores fill one 32-byte sector, so no staging.
struct WgradEpilogue {
  float* out;
  int ld;
  long long split_elems;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int split, __nv_bfloat16*) const {
    float* o = out + split * split_elems + (size_t)(m0 + acc_row0()) * ld + n0 + acc_col0();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      *reinterpret_cast<float2*>(o + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(o + 8 * ld + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// Column partial sums of a bf16 matrix: part[p][c] = sum of x[p * rows + r][c]
// over the block's `rows` rows (a multiple of 8), x [m, cols] with cols a
// multiple of 8.  Grid (ceil(cols / 256), ceil(m / rows)); a thread sums
// rows ty, ty + 8, ... of 8 columns (16-byte loads), then the 8 row lanes
// are added in order.
__global__ void __launch_bounds__(256) col_partials_kernel(const __nv_bfloat16* __restrict__ x,
                                                           float* __restrict__ part, int m, int cols, int rows) {
  __shared__ float sums[8][256];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c0 = blockIdx.x * 256, c = c0 + 8 * tx;
  float acc[8] = {};
  if (c < cols) {
    const int end = min(m, (blockIdx.y + 1) * rows);
    for (int r = blockIdx.y * rows + ty; r < end; r += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + (size_t)r * cols + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += __bfloat162float(e[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) sums[ty][8 * tx + k] = acc[k];
  __syncthreads();
  if (c0 + threadIdx.x < cols) {
    float total = 0.0f;
#pragma unroll
    for (int y = 0; y < 8; ++y) total += sums[y][threadIdx.x];
    part[(size_t)blockIdx.y * cols + c0 + threadIdx.x] = total;
  }
}

inline cudaError_t launch_col_partials(const void* x, float* part, int m, int cols, int rows, cudaStream_t s) {
  const dim3 grid((unsigned)((cols + 255) / 256), (unsigned)((m + rows - 1) / rows));
  col_partials_kernel<<<grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), part, m, cols, rows);
  return cudaGetLastError();
}

__device__ __forceinline__ void put4(float* out, long long i, float4 v) { reinterpret_cast<float4*>(out)[i] = v; }
__device__ __forceinline__ void put4(__nv_bfloat16* out, long long i, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  reinterpret_cast<uint2*>(out)[i] = u;
}

// out[i] = sum over r of part[r * n + i], r = 0 .. rows - 1 in order, four
// consecutive i a thread (n a multiple of 4), in f32 and rounded once to
// out's type: the weight gradients' split partials, read once in 16-byte
// loads.  No atomics.
template <typename TO>
__global__ void __launch_bounds__(256) column_sum4_kernel(const float4* __restrict__ part, TO* __restrict__ out,
                                                          int rows, long long n4) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n4; i += (long long)gridDim.x * 256) {
    float4 acc = part[i];
    for (int r = 1; r < rows; ++r) {
      const float4 v = part[r * n4 + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    put4(out, i, acc);
  }
}

// out [P, Q] = x^T y over m, x [m, P] and y [m, Q] bf16 read MN-major, out
// f32 or bf16 (rounded once from the f32 sum).  Split z of M covers rows [z
// * chunk, (z + 1) * chunk), chunk a multiple of 64 when splits > 1; the
// splits' f32 partials go to part [splits, P, Q], which a bf16 out needs
// even for one split.  P and Q multiples of 128.
template <typename TO>
cudaError_t launch_wgrad_wgmma(const void* x, const void* y, TO* out, float* part, int m, int pdim, int qdim,
                               int splits, int chunk, cudaStream_t s) {
  constexpr bool kDirect = std::is_same<TO, float>::value;
  CUtensorMap x_map, y_map;
  cudaError_t err = make_tile_map(&x_map, x, m, pdim, 64);
  if (err == cudaSuccess) err = make_tile_map(&y_map, y, m, qdim, 64);
  if (err != cudaSuccess) return err;
  float* dst = part;
  if constexpr (kDirect) {
    if (splits == 1) dst = out;
  }
  const WgradEpilogue ep{dst, qdim, (long long)pdim * qdim};
  err = launch_wgmma_gemm<WgradEpilogue, true, true>(x_map, y_map, ep, pdim, qdim, splits, chunk, m, s);
  if (err != cudaSuccess || (kDirect && splits == 1)) return err;
  const long long n4 = (long long)pdim * qdim / 4;
  const long long want = (n4 + 255) / 256;
  column_sum4_kernel<TO><<<(unsigned)(want < 8192 ? want : 8192), 256, 0, s>>>(reinterpret_cast<const float4*>(part),
                                                                           out, splits, n4);
  return cudaGetLastError();
}

}  // namespace
