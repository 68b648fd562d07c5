// Shared pieces of the fused LayerNorm kernels (B4): the plan, the column
// mapping, vector loads and stores, and the row-group reductions.
//
// Column mapping.  A row group of G threads owns one row of x [M, C] at a
// time; each thread holds EPT neighbouring elements of it in registers,
// loaded in 16-byte pieces (8 bf16 or 2 x 4 f32 values).  EPT is 8 where
// C / 128 is 1 or even, so G = C / 8 is 16 (C = 128, two rows per warp) or
// whole warps (32 at C = 256 .. 256 at C = 2048); at odd C / 128 >= 3, EPT is
// 4 (8-byte bf16 pieces) so that G = C / 4 is again whole warps.  A row's
// sums go through shuffles inside the warp and, where the group spans
// warps, through shared memory behind the group's own named barrier.
//
// The plan (ln_plan, mirrored by layer_norm.layer_norm_plan in Python).  A
// CTA runs R = max(1, T / G) row groups at once (T = 256 threads in the
// forward, 512 in the backward) and the grid is persistent: one wave of
// resident CTAs striding over the rows, row group i of the grid taking rows
// i, i + R * ctas, ...  The forward launches SMs x min(4, 1024 / (R G)) CTAs.  The
// backward keeps each thread's dgamma and dbeta sums in registers over its
// rows and writes one partial row per CTA, so its CTA count is sized to the
// rows: as many whole waves (at most 1024 resident threads per SM in bf16,
// 512 in the f32 and residual forms, whose rows take more registers) as keep
// the partials' bytes (written and read: 16 P C) within a tenth of the
// call's bytes of x, dy (res) and dx; with fewer rows than one wave takes,
// that many CTAs, at least one.  (A wave cut to the partials' limit instead
// of whole waves, 172 CTAs at M = 4608, measured slower on the H100.)

#pragma once

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kMaxLnC = 2048;         // the widest LayerNorm: 4 x 512 channels in the last patch merge
constexpr int kLnFwdThreads = 256;    // row groups per CTA: T / G
constexpr int kLnBwdThreads = 512;
constexpr int kLnResidentThreads = 1024;  // per SM: forward, and the bf16 backward
constexpr int kLnResidentThreadsWide = 512;  // per SM: the f32 and residual backwards
constexpr int kLnMaxCtasPerSm = 4;
constexpr int kLnPartialShare = 10;   // partials' bytes <= call's bytes / kLnPartialShare
constexpr int kLnSumSlices = 16;      // the column sums: slices of partial rows per CTA
constexpr int kLnSumLanes = 16;       // ... and float4 columns per CTA

enum LnKind { kLnForward = 0, kLnBackward = 1, kLnResidual = 2 };

__host__ __device__ constexpr int ln_ept(int c) { return (c / 128 == 1 || (c / 128) % 2 == 0) ? 8 : 4; }
__host__ __device__ constexpr int ln_group(int c) { return c / ln_ept(c); }
__host__ __device__ constexpr int ln_rows_per_cta(int c, int threads) {
  return threads / ln_group(c) > 1 ? threads / ln_group(c) : 1;
}
__host__ __device__ constexpr int ln_cta_threads(int c, int kind) {
  return ln_rows_per_cta(c, kind == kLnForward ? kLnFwdThreads : kLnBwdThreads) * ln_group(c);
}
// Resident threads per SM the kernel is built for (its __launch_bounds__).
__host__ __device__ constexpr int ln_resident_threads(int is_bf16, int kind) {
  return kind == kLnForward || (is_bf16 && kind == kLnBackward) ? kLnResidentThreads : kLnResidentThreadsWide;
}
// CTAs per SM: as many as the resident threads take, and at most
// kLnMaxCtasPerSm (the occupancy calculator gives a CTA with static shared
// memory at most 4 on an H100).
__host__ __device__ constexpr int ln_ctas_per_sm(int c, int is_bf16, int kind) {
  const int n = ln_resident_threads(is_bf16, kind) / ln_cta_threads(c, kind);
  return n < 1 ? 1 : n > kLnMaxCtasPerSm ? kLnMaxCtasPerSm : n;
}

struct LnPlan {
  int threads_per_row;  // G
  int rows_per_cta;     // R, row groups a CTA runs at once
  int ctas;
  int partials;         // rows of dgamma/dbeta partials: ctas in the backward, 0 in the forward
};

// Bytes per element of a call's rows: x and y; x, dy and dx; x, dy (f32), res and dx.
inline int ln_row_bytes(int is_bf16, int kind) {
  const int e = is_bf16 ? 2 : 4;
  return kind == kLnForward ? 2 * e : kind == kLnBackward ? 3 * e : 3 * e + 4;
}

inline bool ln_plan(int m, int c, int is_bf16, int kind, int sms, LnPlan* plan) {
  if (c % 128 != 0 || c < 128 || c > kMaxLnC || m < 1 || sms < 1 || kind < kLnForward || kind > kLnResidual)
    return false;
  const int rows = ln_rows_per_cta(c, kind == kLnForward ? kLnFwdThreads : kLnBwdThreads);
  const long long waves = ln_ctas_per_sm(c, is_bf16, kind);
  long long ctas = waves * sms;
  if (kind != kLnForward) {
    // 16 P C <= row_bytes M C / kLnPartialShare
    const long long most = (long long)m * ln_row_bytes(is_bf16, kind) / (16 * kLnPartialShare);
    const long long k = most / sms < waves ? most / sms : waves;
    ctas = k >= 1 ? k * sms : (most > 1 ? most : 1);
  }
  const long long need = (m + rows - 1) / rows;
  if (ctas > need) ctas = need;
  plan->threads_per_row = ln_group(c);
  plan->rows_per_cta = rows;
  plan->ctas = (int)ctas;
  plan->partials = kind == kLnForward ? 0 : (int)ctas;
  return true;
}

// EPT values of T as loaded from (or stored to) device memory.
template <typename T, int EPT>
struct LnRaw;
template <>
struct LnRaw<__nv_bfloat16, 8> {
  uint4 u;
};
template <>
struct LnRaw<__nv_bfloat16, 4> {
  uint2 u;
};
template <>
struct LnRaw<float, 8> {
  float4 a, b;
};
template <>
struct LnRaw<float, 4> {
  float4 a;
};

__device__ __forceinline__ void ln_load(const __nv_bfloat16* p, LnRaw<__nv_bfloat16, 8>& r) {
  r.u = *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ void ln_load(const __nv_bfloat16* p, LnRaw<__nv_bfloat16, 4>& r) {
  r.u = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void ln_load(const float* p, LnRaw<float, 8>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
  r.b = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void ln_load(const float* p, LnRaw<float, 4>& r) {
  r.a = *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void ln_bf16x2(uint32_t w, float& lo, float& hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w);
  lo = __low2float(h);
  hi = __high2float(h);
}

__device__ __forceinline__ void ln_unpack(const LnRaw<__nv_bfloat16, 8>& r, float (&v)[8]) {
  ln_bf16x2(r.u.x, v[0], v[1]);
  ln_bf16x2(r.u.y, v[2], v[3]);
  ln_bf16x2(r.u.z, v[4], v[5]);
  ln_bf16x2(r.u.w, v[6], v[7]);
}
__device__ __forceinline__ void ln_unpack(const LnRaw<__nv_bfloat16, 4>& r, float (&v)[4]) {
  ln_bf16x2(r.u.x, v[0], v[1]);
  ln_bf16x2(r.u.y, v[2], v[3]);
}
__device__ __forceinline__ void ln_unpack(const LnRaw<float, 8>& r, float (&v)[8]) {
  v[0] = r.a.x, v[1] = r.a.y, v[2] = r.a.z, v[3] = r.a.w;
  v[4] = r.b.x, v[5] = r.b.y, v[6] = r.b.z, v[7] = r.b.w;
}
__device__ __forceinline__ void ln_unpack(const LnRaw<float, 4>& r, float (&v)[4]) {
  v[0] = r.a.x, v[1] = r.a.y, v[2] = r.a.z, v[3] = r.a.w;
}

// EPT f32 values (gamma, beta) into registers.
template <int EPT>
__device__ __forceinline__ void ln_load_f32(const float* p, float (&v)[EPT]) {
  LnRaw<float, EPT> r;
  ln_load(p, r);
  ln_unpack(r, v);
}

__device__ __forceinline__ uint32_t ln_pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void ln_store(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(ln_pack_bf16x2(v[0], v[1]), ln_pack_bf16x2(v[2], v[3]),
                                            ln_pack_bf16x2(v[4], v[5]), ln_pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void ln_store(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(ln_pack_bf16x2(v[0], v[1]), ln_pack_bf16x2(v[2], v[3]));
}
__device__ __forceinline__ void ln_store(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void ln_store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The row-group geometry of one (C, kind) kernel, all compile-time.
template <int C, int KIND>
struct LnShape {
  static constexpr int kEpt = ln_ept(C);
  static constexpr int kGroup = ln_group(C);                   // G threads per row
  static constexpr int kRows = ln_rows_per_cta(C, KIND == kLnForward ? kLnFwdThreads : kLnBwdThreads);
  static constexpr int kThreads = kRows * kGroup;
  static constexpr int kWarps = kGroup >= 32 ? kGroup / 32 : 1;  // warps per row group
  static constexpr int kScratch = 4 * kWarps;                    // ln_group_sum's floats per row group
  static_assert(kGroup == 16 || kGroup % 32 == 0, "a row group is half a warp or whole warps");
  static_assert(kThreads % 32 == 0, "whole warps per CTA");
};

// Sums N values over a row group of G threads, returned to every thread of
// the group in the same bits: an xor butterfly inside the warp (both lanes
// of a pair add the same two numbers), then, where the group spans warps,
// each warp's sum through shared memory, added in warp order by every
// thread after the group's named barrier (id 1 + the group's index; 0 is
// __syncthreads).  scratch holds the group's kLnScratch = [2][warps][2]
// floats; the two halves alternate (slot) so one barrier per sum is enough.
template <int G, int N>
__device__ __forceinline__ void ln_group_sum(float (&v)[N], float* scratch, int& slot, int group) {
  static_assert(N <= 2, "one or two sums at a time");
  constexpr int kWidth = G < 32 ? G : 32;
#pragma unroll
  for (int off = kWidth / 2; off > 0; off >>= 1)
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(0xffffffffu, v[n], off);
  if constexpr (G > 32) {
    constexpr int kWarps = G / 32;
    float* s = scratch + slot * kWarps * 2;
    const int warp = (threadIdx.x % G) / 32;
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) s[warp * N + n] = v[n];
    }
    asm volatile("bar.sync %0, %1;" ::"r"(1 + group), "r"(G) : "memory");
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float t = s[n];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += s[w * N + n];
      v[n] = t;
    }
    slot ^= 1;
  }
}

// Calls launch.template operator()<C>() for C = 128, 256, ..., 2048.
template <typename Launch>
cudaError_t ln_dispatch(int c, Launch&& launch) {
  switch (c) {
    case 128: return launch.template operator()<128>();
    case 256: return launch.template operator()<256>();
    case 384: return launch.template operator()<384>();
    case 512: return launch.template operator()<512>();
    case 640: return launch.template operator()<640>();
    case 768: return launch.template operator()<768>();
    case 896: return launch.template operator()<896>();
    case 1024: return launch.template operator()<1024>();
    case 1152: return launch.template operator()<1152>();
    case 1280: return launch.template operator()<1280>();
    case 1408: return launch.template operator()<1408>();
    case 1536: return launch.template operator()<1536>();
    case 1664: return launch.template operator()<1664>();
    case 1792: return launch.template operator()<1792>();
    case 1920: return launch.template operator()<1920>();
    case 2048: return launch.template operator()<2048>();
    default: return cudaErrorInvalidValue;
  }
}

// out[5]: resident CTAs per SM (occupancy calculator), threads per CTA,
// shared memory bytes (static + dynamic), registers per thread, local-memory
// bytes per thread (nonzero where ptxas spilled).
template <typename Kernel>
cudaError_t ln_occupancy(Kernel kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) err = blocks_per_sm(kernel, threads, smem, &out[0]);
  out[1] = threads;
  out[2] = (int)(attr.sharedSizeBytes + smem);
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return err;
}

inline int ln_sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace
