// Fused MK-MMD forward (B3).
//
// Replaces: edrl_tpu/kernels/mmd_pallas.py, mk_mmd_pallas's forward
// (_mmd_forward / _mmd_kernel).  Over total = concat(source, target), n rows
// of d f32 features (n = 2 * batch = 64 and d = 3072 on the main path):
//
//     gram = total total^T,  d2_ij = gram_ii + gram_jj - 2 gram_ij (0 on the
//     diagonal, clamped at 0),  bandwidth = sum(d2) / (n^2 - n) / mul^(num/2),
//     K = sum_i exp(-d2 / (bandwidth * mul^i + 1e-12)),
//     out = |mean K_ss + mean K_tt - mean K_st - mean K_ts|
//
// in f32, as the TPU kernel computes it (and ops.mmd, its plain version).
// The backward is not a kernel: like the TPU version, the caller
// differentiates the plain path.
//
// What bounds it on an H100: the Gram product is 2 n^2 d = 25 MFLOP of f32
// against 786 KB of input, both under a microsecond at the card's peaks;
// at this size the launches and the one-block tail dominate.  Design: the
// Gram product runs over many blocks, each a 64 x 64 tile of it over 64
// columns of d (48 blocks at the main-path shape), into partial sums; one
// block then adds the partials in a fixed order and does the n^2 tail
// (distances, bandwidth, five exponentials per entry, four block sums).
// No block depends on another's timing and no atomics are used, so the
// value is the same from run to run.  Rows are read from source and target
// in place (no concatenation), and any n and d are taken: the edge tiles
// are masked, so the TPU wrapper's fallback for n % 8 != 0 or d % 128 != 0
// has no counterpart here.

#include "attention_common.cuh"

namespace {

constexpr int kMmdTile = 64;     // rows and columns of a Gram tile
constexpr int kMmdDChunk = 64;   // feature columns per partial
constexpr int kMmdThreads = 256;
constexpr int kMmdFinishThreads = 1024;

__device__ __forceinline__ const float* mmd_row(const float* src, const float* tgt, int n_s,
                                                int d, int r) {
  return r < n_s ? src + (size_t)r * d : tgt + (size_t)(r - n_s) * d;
}

// partial[split][i][j] = sum over columns [split * 64, split * 64 + 64) of
// total_i * total_j, for one 64 x 64 tile of (i, j).
__global__ void __launch_bounds__(kMmdThreads)
mmd_gram_partial_kernel(const float* src, const float* tgt, int n_s, int n_t, int d,
                        float* partial) {
  __shared__ float a[kMmdTile][kMmdDChunk + 1];
  __shared__ float b[kMmdTile][kMmdDChunk + 1];
  const int n = n_s + n_t;
  const int split = blockIdx.x;
  const int c0 = split * kMmdDChunk;
  const int tiles = (n + kMmdTile - 1) / kMmdTile;
  const int i0 = (blockIdx.y / tiles) * kMmdTile;
  const int j0 = (blockIdx.y % tiles) * kMmdTile;

  for (int idx = threadIdx.x; idx < kMmdTile * kMmdDChunk; idx += kMmdThreads) {
    const int r = idx / kMmdDChunk;
    const int c = idx - r * kMmdDChunk;
    const int col = c0 + c;
    const int ri = i0 + r;
    const int rj = j0 + r;
    a[r][c] = (ri < n && col < d) ? mmd_row(src, tgt, n_s, d, ri)[col] : 0.0f;
    b[r][c] = (rj < n && col < d) ? mmd_row(src, tgt, n_s, d, rj)[col] : 0.0f;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16;  // rows ty + 16 * u of the tile
  const int tx = threadIdx.x % 16;  // columns tx + 16 * v
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  for (int c = 0; c < kMmdDChunk; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      av[u] = a[ty + 16 * u][c];
      bv[u] = b[tx + 16 * u][c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
  float* out = partial + (size_t)split * n * n;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= n) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j < n) out[(size_t)i * n + j] = acc[u][v];
    }
  }
}

// Sum of x over the block (kMmdFinishThreads threads); every thread gets it.
__device__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kMmdFinishThreads / 32; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ float mmd_d2(const float* gram, int n, int i, int j) {
  if (i == j) return 0.0f;
  const float x = gram[(size_t)i * n + i] + gram[(size_t)j * n + j] - 2.0f * gram[(size_t)i * n + j];
  return fmaxf(x, 0.0f);
}

__global__ void __launch_bounds__(kMmdFinishThreads)
mmd_finish_kernel(const float* partial, int splits, float* gram, int n_s, int n_t,
                  float kernel_mul, int kernel_num, float bandwidth_div, float* out) {
  __shared__ float red[kMmdFinishThreads / 32];
  const int n = n_s + n_t;
  const long long nn = (long long)n * n;
  for (long long i = threadIdx.x; i < nn; i += kMmdFinishThreads) {
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * nn + i];
    gram[i] = acc;
  }
  __syncthreads();

  float local = 0.0f;
  for (long long e = threadIdx.x; e < nn; e += kMmdFinishThreads) {
    local += mmd_d2(gram, n, (int)(e / n), (int)(e % n));
  }
  const float length_scale = block_sum(local, red) / (float)(nn - n) / bandwidth_div;

  float xx = 0.0f, yy = 0.0f, xy = 0.0f, yx = 0.0f;
  for (long long e = threadIdx.x; e < nn; e += kMmdFinishThreads) {
    const int i = (int)(e / n);
    const int j = (int)(e % n);
    const float d2 = mmd_d2(gram, n, i, j);
    float k = 0.0f;
    for (int s = 0; s < kernel_num; ++s) {
      const float mul_s = (float)pow((double)kernel_mul, (double)s);
      k += expf(-d2 / (length_scale * mul_s + 1e-12f));
    }
    if (i < n_s) {
      if (j < n_s) xx += k; else xy += k;
    } else {
      if (j < n_s) yx += k; else yy += k;
    }
  }
  xx = block_sum(xx, red);
  yy = block_sum(yy, red);
  xy = block_sum(xy, red);
  yx = block_sum(yx, red);
  if (threadIdx.x == 0) {
    const float st = (float)((long long)n_s * n_t);
    out[0] = fabsf(xx / (float)((long long)n_s * n_s) + yy / (float)((long long)n_t * n_t) -
                   xy / st - yx / st);
  }
}

int mmd_splits(int d) { return (d + kMmdDChunk - 1) / kMmdDChunk; }

}  // namespace

// f32 scratch the forward needs at (n = n_s + n_t, d): the Gram partials and
// the Gram matrix.
extern "C" long long edrl_mk_mmd_scratch_floats(int n, int d) {
  return (long long)(mmd_splits(d) + 1) * n * n;
}

extern "C" int edrl_mk_mmd_fwd(const void* source, const void* target, int n_s, int n_t, int d,
                               float kernel_mul, int kernel_num, void* scratch, void* out,
                               void* stream) {
  const float* src = static_cast<const float*>(source);
  const float* tgt = static_cast<const float*>(target);
  const int n = n_s + n_t;
  const int splits = mmd_splits(d);
  const int tiles = (n + kMmdTile - 1) / kMmdTile;
  float* partial = static_cast<float*>(scratch);
  float* gram = partial + (size_t)splits * n * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mmd_gram_partial_kernel<<<dim3((unsigned)splits, (unsigned)(tiles * tiles)), kMmdThreads, 0, s>>>(
      src, tgt, n_s, n_t, d, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float bandwidth_div = (float)pow((double)kernel_mul, (double)(kernel_num / 2));
  mmd_finish_kernel<<<1, kMmdFinishThreads, 0, s>>>(partial, splits, gram, n_s, n_t, kernel_mul,
                                                   kernel_num, bandwidth_div,
                                                   static_cast<float*>(out));
  return (int)cudaGetLastError();
}
