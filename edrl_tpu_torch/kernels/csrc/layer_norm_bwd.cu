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
// What the design does about it: one read of x and dy and one write of dx,
// with the forward's column mapping and pipelining (layer_norm.cuh; a row
// group of C / 8 threads per row, the next row's loads issued before the
// current row's sums).  dgamma and dbeta are sums over up to 294,912 rows:
// the TPU kernel carried them across its sequential grid, CUDA blocks run
// in no order.  Here each thread owns its 8 columns for its whole run of
// rows, so it keeps their dy * xhat and dy sums in registers; at the end the
// CTA adds its row groups' sums in group order through shared memory and
// writes one partial row per CTA to [2, P, C].  The plan (ln_plan) sizes P
// to the rows, a whole number of persistent waves, so the partials' bytes
// stay within a tenth of the call's.  A second launch
// (layer_norm_bwd_sums_kernel) adds the partials in a fixed order, dgamma
// and dbeta together in 16-byte loads.  No atomics: dgamma and dbeta are the
// same bit for bit from run to run.  Two launches per call.
//
// The residual form (edrl_layer_norm_bwd_residual) is the LayerNorm part of
// the fused attention sublayer's backward (block_attention.py, _v4_bwd):
// the cotangent dy is f32 (dxln, an f32 product's output) and a residual
// cotangent res in x's dtype is added in f32 before dx is rounded once,
// dx = res + rstd * (...).  The same kernel, with dy read in f32.

#include "layer_norm.cuh"

namespace {

// TD: dy's type (T, or f32 in the residual form); kRes: add res (x's type) to dx.
template <typename T, typename TD, bool kRes, int C>
__global__ void __launch_bounds__(LnShape<C, kLnBackward>::kThreads,
                                  ln_ctas_per_sm(C, std::is_same<T, __nv_bfloat16>::value,
                                                 kRes ? kLnResidual : kLnBackward))
    layer_norm_bwd_kernel(const T* __restrict__ x, const TD* __restrict__ dy, const T* __restrict__ res,
                          const float* __restrict__ gamma, T* __restrict__ dx, float* __restrict__ partial, int m,
                          float eps) {
  using S = LnShape<C, kLnBackward>;
  constexpr int EPT = S::kEpt, G = S::kGroup, R = S::kRows;
  __shared__ float scratch[R][S::kScratch];
  const int group = threadIdx.x / G;
  const int col = (threadIdx.x % G) * EPT;
  const int lead = G >= 32 ? group : (threadIdx.x / 32) * (32 / G);
  const int stride = gridDim.x * R;
  int row = blockIdx.x * R + group;
  int lead_row = blockIdx.x * R + lead;
  float dg[EPT], db[EPT];
#pragma unroll
  for (int j = 0; j < EPT; ++j) dg[j] = db[j] = 0.0f;
  LnRaw<T, EPT> next_x;
  LnRaw<TD, EPT> next_dy;
  if (row < m) {
    ln_load(x + (size_t)row * C + col, next_x);
    ln_load(dy + (size_t)row * C + col, next_dy);
  }
  int slot = 0;
  constexpr float kInvC = 1.0f / (float)C;
  for (; lead_row < m; row += stride, lead_row += stride) {
    const bool valid = row < m;
    float v[EPT], d[EPT];
    ln_unpack(next_x, v);
    ln_unpack(next_dy, d);
    if (row + stride < m) {
      ln_load(x + (size_t)(row + stride) * C + col, next_x);
      ln_load(dy + (size_t)(row + stride) * C + col, next_dy);
    }
    LnRaw<T, EPT> r_raw;
    if (kRes && valid) ln_load(res + (size_t)row * C + col, r_raw);
    float s[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < EPT; ++j) s[0] += v[j];
    ln_group_sum<G, 1>(s, scratch[group], slot, group);
    const float mean = s[0] / (float)C;
    float q[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      const float e = v[j] - mean;
      q[0] = fmaf(e, e, q[0]);
    }
    ln_group_sum<G, 1>(q, scratch[group], slot, group);
    const float rstd = rsqrtf(q[0] / (float)C + eps);
    // xhat into v; the column sums take dy and dy * xhat; d becomes dy * gamma.
    // (In place, so a row holds 2 * EPT values besides the sums: at 512
    // threads and two CTAs per SM a thread has 64 registers.)
    float g[EPT];
    ln_load_f32<EPT>(gamma + col, g);
    float s12[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < EPT; ++j) {
      v[j] = (v[j] - mean) * rstd;
      if (valid) {
        dg[j] = fmaf(d[j], v[j], dg[j]);
        db[j] += d[j];
      }
      d[j] *= g[j];
      s12[0] += d[j];
      s12[1] = fmaf(d[j], v[j], s12[1]);
    }
    ln_group_sum<G, 2>(s12, scratch[group], slot, group);
    const float s1 = s12[0] * kInvC, s2 = s12[1] * kInvC;
    if (valid) {
#pragma unroll
      for (int j = 0; j < EPT; ++j) d[j] = rstd * (d[j] - s1 - v[j] * s2);
      if constexpr (kRes) {
        float rv[EPT];
        ln_unpack(r_raw, rv);
#pragma unroll
        for (int j = 0; j < EPT; ++j) d[j] += rv[j];
      }
      ln_store(dx + (size_t)row * C + col, d);
    }
  }
  // The CTA's partial row: its row groups' sums added in group order.
  float* dg_part = partial + (size_t)blockIdx.x * C;
  float* db_part = partial + ((size_t)gridDim.x + blockIdx.x) * C;
  if constexpr (R == 1) {
    ln_store(dg_part + col, dg);
    ln_store(db_part + col, db);
  } else {
    extern __shared__ float sums[];  // [2][R][C]
    ln_store(sums + (size_t)group * C + col, dg);
    ln_store(sums + (size_t)(R + group) * C + col, db);
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * C; i += S::kThreads) {
      const int which = i / C, c = i - which * C;
      const float* p = sums + (size_t)which * R * C + c;
      float t = p[0];
#pragma unroll
      for (int r = 1; r < R; ++r) t += p[(size_t)r * C];
      (which ? db_part : dg_part)[c] = t;
    }
  }
}

// out [2, C] (dgamma, dbeta) = the sums over p of partial [2, P, C], in one
// fixed order: lane l of the 16 per CTA takes float4 column blockIdx.x * 16
// + l of the [2, C / 4] output, slice s of 16 adds partial rows s, s + 16,
// ... in order (four loads in flight), then slice 0 adds the 16 slices in
// order.
__global__ void __launch_bounds__(kLnSumSlices * kLnSumLanes)
    layer_norm_bwd_sums_kernel(const float4* __restrict__ partial, float4* __restrict__ out, int parts, int c4) {
  __shared__ float4 acc_s[kLnSumSlices][kLnSumLanes];
  const int lane = threadIdx.x % kLnSumLanes, slice = threadIdx.x / kLnSumLanes;
  const int i = blockIdx.x * kLnSumLanes + lane;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < 2 * c4) {
    const int which = i / c4;
    const float4* p = partial + (size_t)which * parts * c4 + (i - which * c4);
    int r = slice;
    for (; r + 3 * kLnSumSlices < parts; r += 4 * kLnSumSlices) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = p[(size_t)(r + k * kLnSumSlices) * c4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc.x += v[k].x, acc.y += v[k].y, acc.z += v[k].z, acc.w += v[k].w;
    }
    for (; r < parts; r += kLnSumSlices) {
      const float4 v = p[(size_t)r * c4];
      acc.x += v.x, acc.y += v.y, acc.z += v.z, acc.w += v.w;
    }
  }
  acc_s[slice][lane] = acc;
  __syncthreads();
  if (slice == 0 && i < 2 * c4) {
    float4 t = acc_s[0][lane];
#pragma unroll
    for (int s = 1; s < kLnSumSlices; ++s) {
      const float4 v = acc_s[s][lane];
      t.x += v.x, t.y += v.y, t.z += v.z, t.w += v.w;
    }
    out[i] = t;
  }
}

template <int C>
constexpr size_t ln_bwd_smem_bytes() {
  return LnShape<C, kLnBackward>::kRows == 1 ? 0 : sizeof(float) * 2 * LnShape<C, kLnBackward>::kRows * C;
}

template <typename T, typename TD, bool kRes>
struct LaunchBwd {
  const void* x;
  const void* dy;
  const void* res;
  const float* gamma;
  void* dx;
  float* partial;
  int m, ctas;
  float eps;
  cudaStream_t stream;

  template <int C>
  cudaError_t operator()() const {
    layer_norm_bwd_kernel<T, TD, kRes, C><<<ctas, LnShape<C, kLnBackward>::kThreads, ln_bwd_smem_bytes<C>(), stream>>>(
        static_cast<const T*>(x), static_cast<const TD*>(dy), static_cast<const T*>(res), gamma, static_cast<T*>(dx),
        partial, m, eps);
    return cudaGetLastError();
  }
};

template <typename T, typename TD, bool kRes>
struct BwdOccupancy {
  int* out;

  template <int C>
  cudaError_t operator()() const {
    return ln_occupancy(layer_norm_bwd_kernel<T, TD, kRes, C>, LnShape<C, kLnBackward>::kThreads,
                        ln_bwd_smem_bytes<C>(), out);
  }
};

// The grid is the plan's for this device; `parts`, the rows of the caller's
// partials buffer, must be the plan's partials.
template <typename T, typename TD, bool kRes>
cudaError_t run_bwd(const void* x, const void* dy, const void* res, const void* gamma, void* dx, void* dgb,
                    void* partial, int m, int c, int parts, float eps, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = (cudaError_t)ln_sm_count(&sms);
  if (err != cudaSuccess) return err;
  LnPlan plan;
  if (!ln_plan(m, c, (int)std::is_same<T, __nv_bfloat16>::value, kRes ? kLnResidual : kLnBackward, sms, &plan) ||
      parts != plan.partials)
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  err = ln_dispatch(c, LaunchBwd<T, TD, kRes>{x, dy, res, static_cast<const float*>(gamma), dx, part, m, plan.ctas,
                                              eps, s});
  if (err != cudaSuccess) return err;
  const int c4 = c / 4;
  layer_norm_bwd_sums_kernel<<<(2 * c4 + kLnSumLanes - 1) / kLnSumLanes, kLnSumSlices * kLnSumLanes, 0, s>>>(
      reinterpret_cast<const float4*>(part), static_cast<float4*>(dgb), plan.partials, c4);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: [m, c] in bf16 (is_bf16) or f32; gamma: [c] f32; dgb: [2, c]
// f32 (dgamma, dbeta); partial: [2, parts, c] f32 scratch, parts the plan's
// partials (edrl_layer_norm_plan; any other count is refused).  c a multiple
// of 128, at most 2048; pointers 16-byte aligned.  Launches the row kernel on
// the plan's grid, then the column sums.
extern "C" int edrl_layer_norm_bwd(const void* x, const void* dy, const void* gamma, void* dx, void* dgb,
                                   void* partial, int m, int c, int parts, float eps, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run_bwd<__nv_bfloat16, __nv_bfloat16, false>(x, dy, nullptr, gamma, dx, dgb, partial, m, c,
                                                                       parts, eps, s)
                       : run_bwd<float, float, false>(x, dy, nullptr, gamma, dx, dgb, partial, m, c, parts, eps, s));
}

// The residual form: dy [m, c] f32, res [m, c] in x's dtype, dx = res + the
// LayerNorm's dx, added in f32 and rounded once; the rest as
// edrl_layer_norm_bwd (dgamma and dbeta from the f32 dy).
extern "C" int edrl_layer_norm_bwd_residual(const void* x, const void* dy, const void* res, const void* gamma,
                                            void* dx, void* dgb, void* partial, int m, int c, int parts, float eps,
                                            int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? run_bwd<__nv_bfloat16, float, true>(x, dy, res, gamma, dx, dgb, partial, m, c, parts, eps, s)
                       : run_bwd<float, float, true>(x, dy, res, gamma, dx, dgb, partial, m, c, parts, eps, s));
}

// The backward's row kernel at width c (residual: its residual form):
// out[5] as ln_occupancy gives it.
extern "C" int edrl_layer_norm_bwd_occupancy(int c, int is_bf16, int residual, int* out) {
  if (residual)
    return (int)(is_bf16 ? ln_dispatch(c, BwdOccupancy<__nv_bfloat16, float, true>{out})
                         : ln_dispatch(c, BwdOccupancy<float, float, true>{out}));
  return (int)(is_bf16 ? ln_dispatch(c, BwdOccupancy<__nv_bfloat16, __nv_bfloat16, false>{out})
                       : ln_dispatch(c, BwdOccupancy<float, float, false>{out}));
}
