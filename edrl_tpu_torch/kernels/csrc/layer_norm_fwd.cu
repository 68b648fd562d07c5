// Fused LayerNorm forward (B4).
//
// Replaces: edrl_tpu/kernels/layer_norm.py, fused_layer_norm's forward
// (_fwd_call / _fwd_kernel).  y = (x - mean) * rsqrt(var + eps) * gamma + beta
// over each row of x [M, C] (bf16 or f32), with f32 statistics taken in two
// passes; gamma and beta [C] f32; y in x's dtype.
//
// What bounds it on an H100: per element it reads x and writes y (4 bytes in
// bf16) and does ~10 flops, far below the card's ~295 flop/byte ridge, so
// it is bound by bytes: 2 * M * C * sizeof(T) over 3.35 TB/s.
//
// What the design does about it: one read of x and one write of y, nothing
// else touches device memory (gamma and beta are 2 * C * 4 bytes, read from
// L1/L2).  A warp owns a row (layer_norm.cuh): the row sits in registers,
// both statistics passes run there with warp shuffles, and the loads are 8
// or 16 bytes per lane, contiguous across the warp.  8 warps (8 rows) per
// block; a grid of ceil(M / 8) blocks fills the SMs many times over at
// every shape of the model (M from 4,608 to 294,912 rows).

#include "layer_norm.cuh"

namespace {

constexpr int kLnFwdWarps = 8;

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(kLnFwdWarps * 32)
    layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ y, int m, int c,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kLnFwdWarps + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* xr = x + (size_t)row * c;
  float v[CHUNKS][4];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) load4(xr + 128 * i + 4 * lane, v[i]);
  float mean, rstd;
  row_stats<CHUNKS>(v, c, eps, mean, rstd);
  T* yr = y + (size_t)row * c;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int col = 128 * i + 4 * lane;
    float g[4], b[4], out[4];
    load4(gamma + col, g);
    load4(beta + col, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = (v[i][j] - mean) * rstd * g[j] + b[j];
    store4(yr + col, out);
  }
}

template <typename T>
struct LaunchFwd {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  int m, c;
  float eps;
  cudaStream_t stream;

  template <int CHUNKS>
  cudaError_t operator()() const {
    const unsigned blocks = (unsigned)((m + kLnFwdWarps - 1) / kLnFwdWarps);
    layer_norm_fwd_kernel<T, CHUNKS><<<blocks, kLnFwdWarps * 32, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), m, c, eps);
    return cudaGetLastError();
  }
};

}  // namespace

// x, y: [m, c] in bf16 (is_bf16) or f32; gamma, beta: [c] f32.  c must be a
// multiple of 128 and at most 2048; pointers 16-byte aligned.
extern "C" int edrl_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   int m, int c, float eps, int is_bf16, void* stream) {
  if (c % 128 != 0 || c / 128 > kMaxLnChunks || m < 1) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_chunks(c, LaunchFwd<__nv_bfloat16>{x, g, b, y, m, c, eps, s})
              : dispatch_chunks(c, LaunchFwd<float>{x, g, b, y, m, c, eps, s});
  return (int)err;
}
