// Fused LayerNorm backward (B4).
//
// Replaces: edrl_tpu/kernels/layer_norm.py, fused_layer_norm's backward
// (_bwd_call / _bwd_kernel).  From x [M, C], the output's cotangent dy
// [M, C] (both bf16 or both f32) and gamma [C] f32 it recomputes each row's
// mean and rstd (nothing was saved) and writes
//
//     xhat = (x - mean) * rstd,  dyg = dy * gamma
//     dx = rstd * (dyg - mean(dyg) - xhat * mean(dyg * xhat))   (x's dtype)
//     dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy  (f32)
//
// What bounds it on an H100: it reads x and dy and writes dx (6 bytes per
// element in bf16) with ~20 flops per element: bound by bytes.
//
// What the design does about it: one read of x and dy and one write of dx.
// A warp owns a row at a time (layer_norm.cuh), so both row reductions are
// warp shuffles over registers.  dgamma and dbeta are sums over up to
// 294,912 rows: the TPU kernel carried them across its sequential grid,
// CUDA blocks run in no order.  Here each block walks over its own run of
// rows; each lane adds its columns' dy * xhat and dy into its warp's row of
// f32 sums in shared memory (a lane owns its columns, so no two threads touch
// one address), the block adds its 4 warps' rows in order into a per-block
// partial [blocks, C], and column_sum_kernel adds the partials in block
// order.  No atomics: dgamma and dbeta are the same bit for bit from run to
// run.  The wrapper picks the block count (8 per SM) so that the partials
// stay small (at most ~1,000 x C floats) while the grid fills the card.
//
// The residual form (edrl_layer_norm_bwd_residual) is the LayerNorm part of
// the fused attention sublayer's backward (block_attention.py, _v4_bwd):
// the cotangent dy is f32 (dxln, an f32 product's output) and a residual
// cotangent res in x's dtype is added in f32 before dx is rounded once,
// dx = res + rstd * (...).  The same kernel, with dy read in f32.

#include "layer_norm.cuh"

namespace {

constexpr int kLnBwdWarps = 4;

inline size_t layer_norm_bwd_smem_bytes(int c) {
  return sizeof(float) * 2 * kLnBwdWarps * (size_t)c;
}

// TD: dy's type (T, or f32 in the residual form); kRes: add res (x's type) to dx.
template <typename T, typename TD, bool kRes, int CHUNKS>
__global__ void __launch_bounds__(kLnBwdWarps * 32)
    layer_norm_bwd_kernel(const T* __restrict__ x, const TD* __restrict__ dy, const T* __restrict__ res,
                          const float* __restrict__ gamma, T* __restrict__ dx,
                          float* __restrict__ dgamma_part, float* __restrict__ dbeta_part, int m,
                          int c, int rows_per_block, float eps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* dg_s = smem + (size_t)warp * c;                  // [warps][c]
  float* db_s = smem + (size_t)(kLnBwdWarps + warp) * c;  // [warps][c]
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dg_s[128 * i + 4 * lane + j] = db_s[128 * i + 4 * lane + j] = 0.0f;

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(m, row0 + rows_per_block);
  const float inv_c = 1.0f / (float)c;
  for (int row = row0 + warp; row < row_end; row += kLnBwdWarps) {
    float v[CHUNKS][4], d[CHUNKS][4];
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      load4(x + (size_t)row * c + 128 * i + 4 * lane, v[i]);
      load4(dy + (size_t)row * c + 128 * i + 4 * lane, d[i]);
    }
    float mean, rstd;
    row_stats<CHUNKS>(v, c, eps, mean, rstd);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      float g[4];
      load4(gamma + 128 * i + 4 * lane, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[i][j] = (v[i][j] - mean) * rstd;  // xhat
        const float dyg = d[i][j] * g[j];
        s1 += dyg;
        s2 = fmaf(dyg, v[i][j], s2);
      }
    }
    s1 = warp_sum(s1) * inv_c;
    s2 = warp_sum(s2) * inv_c;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int col = 128 * i + 4 * lane;
      float g[4], out[4];
      load4(gamma + col, g);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        out[j] = rstd * (d[i][j] * g[j] - s1 - v[i][j] * s2);
        dg_s[col + j] = fmaf(d[i][j], v[i][j], dg_s[col + j]);
        db_s[col + j] += d[i][j];
      }
      if (kRes) {
        float r[4];
        load4(res + (size_t)row * c + col, r);
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] += r[j];
      }
      store4(dx + (size_t)row * c + col, out);
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < c; col += kLnBwdWarps * 32) {
    float g = 0.0f, b = 0.0f;
#pragma unroll
    for (int w = 0; w < kLnBwdWarps; ++w) {
      g += smem[(size_t)w * c + col];
      b += smem[(size_t)(kLnBwdWarps + w) * c + col];
    }
    dgamma_part[(size_t)blockIdx.x * c + col] = g;
    dbeta_part[(size_t)blockIdx.x * c + col] = b;
  }
}

template <typename T, typename TD, bool kRes>
struct LaunchBwd {
  const void* x;
  const void* dy;
  const void* res;
  const float* gamma;
  void* dx;
  float* dgamma_part;
  float* dbeta_part;
  int m, c, blocks;
  float eps;
  cudaStream_t stream;

  template <int CHUNKS>
  cudaError_t operator()() const {
    const size_t smem = layer_norm_bwd_smem_bytes(c);
    cudaError_t err = allow_smem(layer_norm_bwd_kernel<T, TD, kRes, CHUNKS>, smem);
    if (err != cudaSuccess) return err;
    const int rows_per_block = (m + blocks - 1) / blocks;
    layer_norm_bwd_kernel<T, TD, kRes, CHUNKS><<<blocks, kLnBwdWarps * 32, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const TD*>(dy), static_cast<const T*>(res), gamma, static_cast<T*>(dx),
        dgamma_part, dbeta_part, m, c, rows_per_block, eps);
    return cudaGetLastError();
  }
};

template <typename T, typename TD, bool kRes>
cudaError_t run_bwd(const void* x, const void* dy, const void* res, const void* gamma, void* dx, void* dgamma,
                    void* dbeta, void* partial, int m, int c, int blocks, float eps, cudaStream_t s) {
  if (c % 128 != 0 || c / 128 > kMaxLnChunks || m < 1 || blocks < 1 || blocks > m) return cudaErrorInvalidValue;
  float* dg_part = static_cast<float*>(partial);
  float* db_part = dg_part + (size_t)blocks * c;
  cudaError_t err = dispatch_chunks(c, LaunchBwd<T, TD, kRes>{x, dy, res, static_cast<const float*>(gamma), dx,
                                                              dg_part, db_part, m, c, blocks, eps, s});
  if (err != cudaSuccess) return err;
  err = launch_column_sum(dg_part, static_cast<float*>(dgamma), blocks, c, s);
  if (err != cudaSuccess) return err;
  return launch_column_sum(db_part, static_cast<float*>(dbeta), blocks, c, s);
}

}  // namespace

// x, dy, dx: [m, c] in bf16 (is_bf16) or f32; gamma, dgamma, dbeta: [c] f32;
// partial: [2, blocks, c] f32 scratch.  c a multiple of 128, at most 2048;
// 1 <= blocks <= m.  Launches the row kernel, then two column sums.
extern "C" int edrl_layer_norm_bwd(const void* x, const void* dy, const void* gamma, void* dx,
                                   void* dgamma, void* dbeta, void* partial, int m, int c,
                                   int blocks, float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run_bwd<__nv_bfloat16, __nv_bfloat16, false>(x, dy, nullptr, gamma, dx, dgamma, dbeta,
                                                                       partial, m, c, blocks, eps, s)
                       : run_bwd<float, float, false>(x, dy, nullptr, gamma, dx, dgamma, dbeta, partial, m, c,
                                                      blocks, eps, s));
}

// The residual form: dy [m, c] f32, res [m, c] in x's dtype, dx = res + the
// LayerNorm's dx, added in f32 and rounded once; the rest as
// edrl_layer_norm_bwd (dgamma and dbeta from the f32 dy).
extern "C" int edrl_layer_norm_bwd_residual(const void* x, const void* dy, const void* res, const void* gamma,
                                            void* dx, void* dgamma, void* dbeta, void* partial, int m, int c,
                                            int blocks, float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run_bwd<__nv_bfloat16, float, true>(x, dy, res, gamma, dx, dgamma, dbeta, partial, m, c,
                                                             blocks, eps, s)
                       : run_bwd<float, float, true>(x, dy, res, gamma, dx, dgamma, dbeta, partial, m, c, blocks,
                                                     eps, s));
}
