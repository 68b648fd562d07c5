// Fused MK-MMD backward (B3).
//
// Replaces: edrl_tpu/kernels/mmd_pallas.py, mk_mmd_pallas's backward (_bwd:
// the VJP of the XLA path, which XLA runs as one fused program; the port ran
// it as autograd over the plain path, a chain of small launches).  From the
// forward's state (mmd_fwd.cu: d2 before the clamp, 0 on the diagonal; the
// bandwidth ls; the sign of the signed sum S), the features and the incoming
// gradient g, in closed form:
//
//     sigma_m = ls mul^m + 1e-12,  e_m = exp(-d2 / sigma_m),  w_ij = +-1/(n_a n_b) by block,
//     B = sum_kl w_kl sum_m e_m,kl d2_kl mul^m / sigma_m^2        (dS/dls)
//     G_ij = sign * mask_ij * (c B - w_ij sum_m e_m,ij / sigma_m),  c = 1 / ((n^2 - n) mul^(num/2))
//     H = G + G^T,  dtotal = 2 g (diag(rowsum H) - H) total
//
// where mask is 0 on the diagonal and where d2 < 0 (the clamp), 1/2 where
// d2 == 0 exactly (JAX's VJP of maximum at a tie) and 1 elsewhere; the sign is
// +1 at S == 0 (JAX's VJP of abs).  ops/mmd.py::mk_mmd_bwd_reference is the
// same function in plain PyTorch.
//
// What bounds it on an H100: the [n, n] x [n, d] product, 2 n^2 d = 25 MFLOP
// of f32, and 1.6 MB of features in and gradients out, a microsecond or less
// each at the card's peaks; the n^2 tail (kernel_num exponentials an entry)
// is small.  So one launch's latency is what is left, and the design is one
// launch: a CTA of 512 threads per (64 rows, 64 feature columns) of dtotal
// (48 at the main shape), each copying the state and its first 64 rows of
// total into shared memory by cp.async, every copy in flight at once (the
// rows land while G is formed), forming all of G there (a few thousand
// exponentials, cheaper than a second launch or a cluster exchange; with
// 1 / sigma_m and mul^m / sigma_m^2 taken once, an entry is kernel_num
// exponentials and FMAs, four entries' chains interleaved), then H^T at its
// rows and its [64, n] x [n, 64] product in f32 FMA, 2 x 4 outputs a thread
// from a float2 and a float4, written straight into ds and dt.
// Every sum runs in a fixed order, with no atomics: the gradients are the
// same bit for bit from run to run.

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kBwdThreadsMmd = 512;
constexpr int kMmdBwdTile = 64;      // rows and feature columns of a CTA's dtotal tile
constexpr int kMmdBwdLd = kMmdBwdTile + 4;  // floats per row of H^T and of a chunk of total: 16-byte rows
constexpr int kMmdBwdMaxRows = 128;  // the state and G [n, n] in shared memory
constexpr int kMmdBwdMaxKernels = 16;

struct MmdBwdArgs {
  const float* src;
  const float* tgt;
  const float* state;  // [n * n + 2]: d2 before the clamp, the bandwidth, the sign
  const float* grad;   // the incoming gradient, a 0-d f32 on the card
  float* ds;
  float* dt;
  int n_s;
  int n_t;
  int d;
  float kernel_mul;
  int kernel_num;
  float ls_grad;       // c: d(bandwidth) / d(d2_ij)
  float mul_pow[kMmdBwdMaxKernels];  // kernel_mul^m, taken on the host in double
  int vec16;           // 16-byte copies: features with d % 4 == 0 and aligned, an aligned state of n * n % 4 == 0
};

// Shared memory, in floats from the start, each part 16-byte aligned: the
// state's d2 [n * n]; G [n][n + 1] (padded: a column walk hits every bank
// once); H^T at the CTA's rows [n][68]; a chunk of total's rows [64][68].
__host__ __device__ inline int mmd_bwd_g_at(int n) { return (n * n + 3) / 4 * 4; }
__host__ __device__ inline int mmd_bwd_ht_at(int n) { return mmd_bwd_g_at(n) + (n * (n + 1) + 3) / 4 * 4; }
__host__ __device__ inline int mmd_bwd_x_at(int n) { return mmd_bwd_ht_at(n) + n * kMmdBwdLd; }

inline size_t mmd_bwd_smem_bytes(int n) {
  return sizeof(float) * ((size_t)mmd_bwd_x_at(n) + (size_t)kMmdBwdTile * kMmdBwdLd);
}

__global__ void __launch_bounds__(kBwdThreadsMmd) mmd_bwd_kernel(MmdBwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kBwdThreadsMmd / 32];
  __shared__ float inv_sig[kMmdBwdMaxKernels];  // 1 / sigma_m
  __shared__ float coef[kMmdBwdMaxKernels];     // mul^m / sigma_m^2
  const int n = a.n_s + a.n_t;
  const int nn = n * n;
  const int ld = n + 1;
  float* raw_s = smem;                   // [n * n]: the state's d2
  float* g_s = smem + mmd_bwd_g_at(n);    // [n][ld]: w F, then G
  float* ht_s = smem + mmd_bwd_ht_at(n);  // [n][68]: H^T at this CTA's rows
  float* x_s = smem + mmd_bwd_x_at(n);    // [64][68]: a chunk of total's rows
  const int i0 = blockIdx.y * kMmdBwdTile;
  const int c0 = blockIdx.x * kMmdBwdTile;
  // Rows [j0, j0 + 64) and this CTA's 64 columns of total into x_s by
  // cp.async, zeros past n and d.
  auto stage_x = [&](int j0) {
    if (a.vec16) {
      for (int idx = threadIdx.x; idx < kMmdBwdTile * kMmdBwdTile / 4; idx += kBwdThreadsMmd) {
        const int r = idx >> 4;
        const int c = 4 * (idx & 15);
        const int j = j0 + r;
        const bool valid = j < n && c0 + c < a.d;
        const float* src = j < a.n_s ? a.src + (size_t)j * a.d : a.tgt + (size_t)(j - a.n_s) * a.d;
        cp_async16(x_s + r * kMmdBwdLd + c, valid ? src + c0 + c : a.src, valid);
      }
    } else {
      for (int idx = threadIdx.x; idx < kMmdBwdTile * kMmdBwdTile; idx += kBwdThreadsMmd) {
        const int r = idx >> 6;
        const int c = idx & 63;
        const int j = j0 + r;
        const bool valid = j < n && c0 + c < a.d;
        const float* src = j < a.n_s ? a.src + (size_t)j * a.d : a.tgt + (size_t)(j - a.n_s) * a.d;
        cp_async4(x_s + r * kMmdBwdLd + c, valid ? src + c0 + c : a.src, valid);
      }
    }
  };
  // The state into shared memory, then the first rows of total: every copy
  // in flight at once, the second group landing while G is formed.
  if (a.vec16) {
    for (int e = 4 * threadIdx.x; e < nn; e += 4 * kBwdThreadsMmd) cp_async16(raw_s + e, a.state + e, true);
  } else {
    for (int e = threadIdx.x; e < nn; e += kBwdThreadsMmd) cp_async4(raw_s + e, a.state + e, true);
  }
  cp_async_commit();
  stage_x(0);
  cp_async_commit();
  const float ls = a.state[nn];
  const float sign = a.state[nn + 1];
  if (threadIdx.x < a.kernel_num) {
    const float mul_m = a.mul_pow[threadIdx.x];
    const float inv = 1.0f / (ls * mul_m + 1e-12f);
    inv_sig[threadIdx.x] = inv;
    coef[threadIdx.x] = mul_m * inv * inv;
  }
  cp_async_wait<1>();
  __syncthreads();

  const float w_ss = 1.0f / (float)((long long)a.n_s * a.n_s);
  const float w_tt = 1.0f / (float)((long long)a.n_t * a.n_t);
  const float w_st = -1.0f / (float)((long long)a.n_s * a.n_t);
  // 1. w F into g_s, and B = sum w T, every CTA over all of [n, n] (the
  //    same operations in the same order in each, so the same B).
  //    Four entries a step, their chains interleaved.
  float local = 0.0f;
  for (int e0 = threadIdx.x; e0 < nn; e0 += 4 * kBwdThreadsMmd) {
    float d2[4], f[4], t[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = min(e0 + u * kBwdThreadsMmd, nn - 1);
      const int i = e / n;
      at[u] = i * ld + e - i * n;
      d2[u] = fmaxf(raw_s[e], 0.0f);
      f[u] = t[u] = 0.0f;
    }
    for (int m = 0; m < a.kernel_num; ++m) {
      const float inv = inv_sig[m], cm = coef[m];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float ex = expf(-d2[u] * inv);
        f[u] = fmaf(ex, inv, f[u]);
        t[u] = fmaf(ex, cm, t[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * kBwdThreadsMmd;
      if (e < nn) {
        const int i = at[u] / ld;
        const int j = at[u] - i * ld;
        const float w = (i < a.n_s) == (j < a.n_s) ? (i < a.n_s ? w_ss : w_tt) : w_st;
        g_s[at[u]] = w * f[u];
        local = fmaf(w * t[u], d2[u], local);
      }
    }
  }
  const float cb = a.ls_grad * block_sum<kBwdThreadsMmd>(local, red);
  // 2. G = sign * mask * (c B - w F).
  for (int e = threadIdx.x; e < nn; e += kBwdThreadsMmd) {
    const int i = e / n;
    const int j = e - i * n;
    const float raw = raw_s[e];
    const float mask = (i == j || raw < 0.0f) ? 0.0f : (raw == 0.0f ? 0.5f : 1.0f);
    g_s[i * ld + j] = sign * mask * (cb - g_s[i * ld + j]);
  }
  __syncthreads();
  // 3. H^T at this CTA's rows: ht_s[j][r] = G[i][j] + G[j][i], i = i0 + r.
  for (int idx = threadIdx.x; idx < kMmdBwdTile * n; idx += kBwdThreadsMmd) {
    const int j = idx / kMmdBwdTile;
    const int r = idx - j * kMmdBwdTile;
    const int i = i0 + r;
    ht_s[j * kMmdBwdLd + r] = i < n ? g_s[i * ld + j] + g_s[j * ld + i] : 0.0f;
  }

  // 4. acc = H x and rowsum(H) over this CTA's rows and columns: thread (ty,
  //    tx) rows 2 ty, 2 ty + 1, columns 4 tx .. 4 tx + 3, a float2 of H^T and
  //    a float4 of x a step; x staged 64 rows at a time.
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  float acc[2][4], rs[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    rs[u] = 0.0f;
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  }
  for (int j0 = 0; j0 < n; j0 += kMmdBwdTile) {
    if (j0 > 0) {
      __syncthreads();  // the previous chunk is consumed
      stage_x(j0);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // ht_s is written, this chunk has landed
    const int rows = min(kMmdBwdTile, n - j0);
#pragma unroll 8
    for (int jj = 0; jj < rows; ++jj) {
      const float2 h = *reinterpret_cast<const float2*>(ht_s + (j0 + jj) * kMmdBwdLd + 2 * ty);
      const float4 xv = *reinterpret_cast<const float4*>(x_s + jj * kMmdBwdLd + 4 * tx);
      const float hu[2] = {h.x, h.y};
      const float xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        rs[u] += hu[u];
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(hu[u], xw[v], acc[u][v]);
      }
    }
  }

  // 5. dtotal = 2 g (rowsum(H) x - H x), into ds and dt.
  const float g2 = 2.0f * a.grad[0];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int i = i0 + 2 * ty + u;
    if (i >= n) continue;
    const float* xrow = i < a.n_s ? a.src + (size_t)i * a.d : a.tgt + (size_t)(i - a.n_s) * a.d;
    float* grow = i < a.n_s ? a.ds + (size_t)i * a.d : a.dt + (size_t)(i - a.n_s) * a.d;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int c = c0 + 4 * tx + v;
      if (c < a.d) grow[c] = g2 * (rs[u] * __ldg(xrow + c) - acc[u][v]);
    }
  }
}

// The kernel's dynamic shared memory limit, raised once per device to what
// the largest n needs: the attribute never changes, and setting it is host
// time on every launch otherwise.
cudaError_t mmd_bwd_allow_smem() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev]) return cudaSuccess;
  err = allow_smem(mmd_bwd_kernel, mmd_bwd_smem_bytes(kMmdBwdMaxRows));
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

}  // namespace

// out[4]: the backward kernel's registers per thread, local memory bytes,
// dynamic shared memory bytes at n rows, resident CTAs per SM there.
extern "C" int edrl_mk_mmd_bwd_attributes(int n, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mmd_bwd_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)mmd_bwd_smem_bytes(n);
  err = mmd_bwd_allow_smem();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], mmd_bwd_kernel, kBwdThreadsMmd,
                                                            mmd_bwd_smem_bytes(n));
}

// source [n_s, d], target [n_t, d], state n * n + 2 (the forward's), grad a
// 0-d f32; ds [n_s, d] and dt [n_t, d] f32.  n = n_s + n_t at most 128,
// kernel_num at most 16.
extern "C" int edrl_mk_mmd_bwd(const void* source, const void* target, const void* state, const void* grad,
                               void* ds, void* dt, int n_s, int n_t, int d, float kernel_mul, int kernel_num,
                               void* stream) {
  const int n = n_s + n_t;
  if (n > kMmdBwdMaxRows || n < 2 || kernel_num < 1 || kernel_num > kMmdBwdMaxKernels) {
    return (int)cudaErrorInvalidValue;
  }
  MmdBwdArgs a;
  a.src = static_cast<const float*>(source);
  a.tgt = static_cast<const float*>(target);
  a.state = static_cast<const float*>(state);
  a.grad = static_cast<const float*>(grad);
  a.ds = static_cast<float*>(ds);
  a.dt = static_cast<float*>(dt);
  a.n_s = n_s;
  a.n_t = n_t;
  a.d = d;
  a.kernel_mul = kernel_mul;
  a.kernel_num = kernel_num;
  a.ls_grad = (float)(1.0 / ((double)((long long)n * n - n) * pow((double)kernel_mul, (double)(kernel_num / 2))));
  a.vec16 = d % 4 == 0 && aligned16(source) && aligned16(target) && (n * n) % 4 == 0 && aligned16(state);
  for (int m = 0; m < kMmdBwdMaxKernels; ++m) a.mul_pow[m] = (float)pow((double)kernel_mul, (double)m);
  cudaError_t err = mmd_bwd_allow_smem();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = mmd_bwd_smem_bytes(n);
  const dim3 grid((unsigned)((d + kMmdBwdTile - 1) / kMmdBwdTile), (unsigned)((n + kMmdBwdTile - 1) / kMmdBwdTile));
  mmd_bwd_kernel<<<grid, kBwdThreadsMmd, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
