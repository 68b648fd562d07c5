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
// else touches device memory (gamma and beta are read once per thread, into
// registers).  To reach the card's rate it keeps enough loads in flight and
// launches few CTAs: a row group of G threads owns a row (layer_norm.cuh;
// 16-byte loads, G = C / 8, two rows per warp at C = 128), a CTA runs
// 256 / G row groups, and one persistent wave of 1024 threads per SM strides
// over the rows.  Each thread issues the next row's loads before it reduces
// the current row (a register double buffer), so a row's loads are in flight
// while the last one's sums, shuffles and barriers run: ~16 KB of reads per
// SM in bf16, above the ~9 KB Little's law asks for the read half of 3.35
// TB/s at ~0.7 us.  (A ring of two rows ahead measured no faster on the
// H100.)

#include "layer_norm.cuh"

namespace {

template <typename T, int C>
__global__ void __launch_bounds__(LnShape<C, kLnForward>::kThreads, ln_ctas_per_sm(C, 1, kLnForward))
    layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                          T* __restrict__ y, int m, float eps) {
  using S = LnShape<C, kLnForward>;
  constexpr int EPT = S::kEpt, G = S::kGroup, R = S::kRows;
  __shared__ float scratch[R][S::kScratch];
  const int group = threadIdx.x / G;
  const int col = (threadIdx.x % G) * EPT;
  // The warp's first row group leads its loop, so both halves of a warp at
  // G = 16 run the same iterations (their shuffles span the warp).
  const int lead = G >= 32 ? group : (threadIdx.x / 32) * (32 / G);
  const int stride = gridDim.x * R;
  float g[EPT], b[EPT];
  ln_load_f32<EPT>(gamma + col, g);
  ln_load_f32<EPT>(beta + col, b);
  int row = blockIdx.x * R + group;
  int lead_row = blockIdx.x * R + lead;
  LnRaw<T, EPT> next;
  if (row < m) ln_load(x + (size_t)row * C + col, next);
  int slot = 0;
  for (; lead_row < m; row += stride, lead_row += stride) {
    float v[EPT];
    ln_unpack(next, v);
    if (row + stride < m) ln_load(x + (size_t)(row + stride) * C + col, next);
    float s[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < EPT; ++j) s[0] += v[j];
    ln_group_sum<G, 1>(s, scratch[group], slot, group);
    const float mean = s[0] / (float)C;
    float q[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const float d = v[j] - mean;
      q[0] = fmaf(d, d, q[0]);
    }
    ln_group_sum<G, 1>(q, scratch[group], slot, group);
    const float rstd = rsqrtf(q[0] / (float)C + eps);
    if (row < m) {
#pragma unroll
      for (int j = 0; j < EPT; ++j) v[j] = (v[j] - mean) * rstd * g[j] + b[j];
      ln_store(y + (size_t)row * C + col, v);
    }
  }
}

template <typename T>
struct LaunchFwd {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  int m;
  float eps;
  int ctas;
  cudaStream_t stream;

  template <int C>
  cudaError_t operator()() const {
    layer_norm_fwd_kernel<T, C><<<ctas, LnShape<C, kLnForward>::kThreads, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(y), m, eps);
    return cudaGetLastError();
  }
};

template <typename T>
struct FwdOccupancy {
  int* out;

  template <int C>
  cudaError_t operator()() const {
    return ln_occupancy(layer_norm_fwd_kernel<T, C>, LnShape<C, kLnForward>::kThreads, 0, out);
  }
};

}  // namespace

// x, y: [m, c] in bf16 (is_bf16) or f32; gamma, beta: [c] f32.  c must be a
// multiple of 128 and at most 2048; pointers 16-byte aligned.  The grid is
// the plan's (edrl_layer_norm_plan) for this device's SM count.
extern "C" int edrl_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   int m, int c, float eps, int is_bf16, void* stream) {
  int sms = 0;
  int err = ln_sm_count(&sms);
  if (err != 0) return err;
  LnPlan plan;
  if (!ln_plan(m, c, is_bf16, kLnForward, sms, &plan)) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? ln_dispatch(c, LaunchFwd<__nv_bfloat16>{x, g, b, y, m, eps, plan.ctas, s})
                       : ln_dispatch(c, LaunchFwd<float>{x, g, b, y, m, eps, plan.ctas, s}));
}

// The plan of a call (kind 0 forward, 1 backward, 2 residual backward) on a
// card of `sms` SMs: out[4] = threads per row, rows per CTA, CTAs, partials.
extern "C" int edrl_layer_norm_plan(int m, int c, int is_bf16, int kind, int sms, int* out) {
  LnPlan plan;
  if (!ln_plan(m, c, is_bf16, kind, sms, &plan)) return (int)cudaErrorInvalidValue;
  out[0] = plan.threads_per_row;
  out[1] = plan.rows_per_cta;
  out[2] = plan.ctas;
  out[3] = plan.partials;
  return 0;
}

// The forward kernel at width c: out[5] as ln_occupancy gives it.
extern "C" int edrl_layer_norm_fwd_occupancy(int c, int is_bf16, int* out) {
  return (int)(is_bf16 ? ln_dispatch(c, FwdOccupancy<__nv_bfloat16>{out}) : ln_dispatch(c, FwdOccupancy<float>{out}));
}
