// Shared backward attention kernels for the two backward entry points in
// this folder.
//
// For one (group, head) with o = softmax(s) v, s = (q * scale) k^T + bias,
// and the output's cotangent do, they compute what the Pallas backward
// kernels compute (edrl_tpu/kernels/window_attention.py, _sa_bwd_kernel and
// _attn_bwd_kernel_v2), all in f32 from the inputs upcast:
//
//     p = softmax(s)                      (recomputed; the forward saves nothing)
//     dp = do v^T,  delta = rowsum(dp * p),  ds = p * (dp - delta)
//     dv = p^T do,  dq = ds k * scale,  dk = ds^T (q * scale),  dbias = sum_b ds
//
// dq, dk and dv are written in the input type at the head's columns of their
// packed outputs (through strides, so no transpose or concatenate happens
// outside), dbias in f32.
//
// The TPU kernel runs one program per (b, w, h) and accumulates dbias[w, h]
// across the batch in an output block that its sequential grid revisits.
// CUDA blocks run in no order, so the work is split in two kernels launched
// in this order on one stream:
//
// 1. attention_bwd_dq_kernel: one block per (32-query tile, window, head,
//    chunk of the batch).  For each batch entry of its chunk it computes its
//    rows of s and dp over all keys (kept in shared memory as f32), takes the
//    softmax and ds, writes dq, and writes the row statistics (max, sum,
//    delta) that kernel 2 needs.  ds is summed over the chunk's batch entries
//    in shared memory and written once as the chunk's partial dbias;
//    column_sum_kernel sums the chunks in a fixed order.  Every sum has one fixed
//    order, so dbias is the same from run to run.
// 2. attention_bwd_dkv_kernel: one block per (group, head, 32-key tile).  It
//    keeps its keys and values in shared memory, walks over the queries in
//    chunks of 32, recomputes p and ds for the tile from the saved row
//    statistics (the same f32 products in the same order as kernel 1), and
//    accumulates dk and dv in registers.
//
// The tail keys past N get p = 0 and ds = 0, so they reach neither dbias
// nor dk/dv; the tail queries compute on zeros and are never stored.
// Products are f32 FMA on the CUDA cores for both input types: right first;
// tensor cores (mma.sync / wgmma) are later work.

#pragma once

#include "attention_common.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRows = 4;                       // rows (queries or keys) per warp
constexpr int kBwdTile = kBwdWarps * kBwdRows;    // 32 queries (dq) or keys (dkv) per block
constexpr int kBwdLd = kBwdTile + 1;              // padded: conflict-free transposed stores
constexpr int kBwdChunk = 32;                     // keys (dq) or queries (dkv) per inner step
constexpr int kBwdMaxHeadDim = 128;
constexpr int kBwdCols = kBwdMaxHeadDim / 32;     // output columns per lane
constexpr int kBwdMaxKeys = 256;                  // dq kernel keeps [32, N] rows in shared memory

struct AttnBwdParams {
  const void* q;     // element (group 0, token 0, column 0) of each operand
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* bias;   // [windows, heads, n, n] f32, or nullptr
  float* dbias;        // [batch_chunks, windows, heads, n, n] partial sums, or nullptr
  float* row_m;        // [groups, heads, n] softmax row max
  float* row_l;        // [groups, heads, n] softmax row sum
  float* row_delta;    // [groups, heads, n] rowsum(dp * p)
  long long group_stride_in;    // elements between groups in q/k/v
  long long group_stride_dout;  // ... in dout
  long long group_stride_grad;  // ... in dq/dk/dv
  int row_stride_in;
  int row_stride_dout;
  int row_stride_grad;
  int batch;            // group g = b * windows + w
  int windows;          // 1 for self-attention
  int batch_per_block;  // batch entries one dq block walks over
  int batch_chunks;     // ceil(batch / batch_per_block)
  int heads;
  int n;
  int d;
  int n_pad;            // n rounded up to kBwdChunk
  int tiles;            // ceil(n / kBwdTile)
  float scale;
};

inline size_t attention_bwd_dq_smem_bytes(int n, int d, bool with_dbias) {
  const size_t n_pad = (size_t)round_up(n, kBwdChunk);
  return sizeof(float) * (2 * (size_t)d * kBwdLd + (with_dbias ? 3 : 2) * kBwdTile * n_pad +
                          (size_t)kBwdChunk * (d + 1));
}

inline size_t attention_bwd_dkv_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kBwdTile * (d + 1) + 2 * (size_t)kBwdChunk * (d + 1) +
                          2 * (size_t)kBwdChunk * kBwdLd + 3 * (size_t)kBwdChunk);
}

// Rows [row0, row0 + rows) of one head into f32 shared rows of stride d + 1;
// rows past n are zero.  scale multiplies every element.
template <typename T>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, int row0, int rows, int n,
                                              int d, int row_stride, float scale) {
  for (int i = threadIdx.x; i < rows * d; i += kBwdThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int row = row0 + r;
    dst[r * (d + 1) + c] = row < n ? to_f32(src[(size_t)row * row_stride + c]) * scale : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) attention_bwd_dq_kernel(AttnBwdParams p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int n = p.n;
  const int n_pad = p.n_pad;
  float* q_t = smem;                              // [d][kBwdLd] scaled queries, transposed
  float* do_t = q_t + (size_t)d * kBwdLd;         // [d][kBwdLd] dout, transposed
  float* s = do_t + (size_t)d * kBwdLd;           // [kBwdTile][n_pad] scores, then p
  float* ds = s + (size_t)kBwdTile * n_pad;       // [kBwdTile][n_pad] dp, then ds
  float* dbias_acc = ds + (size_t)kBwdTile * n_pad;  // [kBwdTile][n_pad] if p.dbias
  float* chunk = p.dbias ? dbias_acc + (size_t)kBwdTile * n_pad : dbias_acc;  // [kBwdChunk][d + 1]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x % p.tiles;
  const int rest = blockIdx.x / p.tiles;
  const int w = rest % p.windows;
  const int bc = rest / p.windows;
  const int h = blockIdx.y;
  const int q0 = tile * kBwdTile;
  const int r0 = warp * kBwdRows;
  const int b_begin = bc * p.batch_per_block;
  const int b_end = min(p.batch, b_begin + p.batch_per_block);
  const float* bias = p.bias ? p.bias + ((size_t)w * p.heads + h) * (size_t)n * n : nullptr;

  if (p.dbias) {
    for (int i = threadIdx.x; i < kBwdTile * n_pad; i += kBwdThreads) dbias_acc[i] = 0.0f;
  }

  for (int b = b_begin; b < b_end; ++b) {
    const size_t g = (size_t)b * p.windows + w;
    const size_t col = (size_t)h * d;
    const T* qg = static_cast<const T*>(p.q) + g * p.group_stride_in + col;
    const T* kg = static_cast<const T*>(p.k) + g * p.group_stride_in + col;
    const T* vg = static_cast<const T*>(p.v) + g * p.group_stride_in + col;
    const T* dog = static_cast<const T*>(p.dout) + g * p.group_stride_dout + col;
    T* dqg = static_cast<T*>(p.dq) + g * p.group_stride_grad + col;

    // 1. Scaled queries and dout of this tile, transposed; tail rows are zero.
    __syncthreads();  // the previous batch entry's buffers are consumed
    for (int i = threadIdx.x; i < kBwdTile * d; i += kBwdThreads) {
      const int r = i / d;
      const int c = i - r * d;
      const int row = q0 + r;
      const bool live = row < n;
      q_t[c * kBwdLd + r] = live ? to_f32(qg[(size_t)row * p.row_stride_in + c]) * p.scale : 0.0f;
      do_t[c * kBwdLd + r] = live ? to_f32(dog[(size_t)row * p.row_stride_dout + c]) : 0.0f;
    }

    // 2. Scores and dp over all keys, 32 at a time: lane = key, warp = 4 rows.
    for (int k0 = 0; k0 < n_pad; k0 += kBwdChunk) {
      __syncthreads();
      load_rows_f32(chunk, kg, k0, kBwdChunk, n, d, p.row_stride_in, 1.0f);
      __syncthreads();
      float acc[kBwdRows];
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) acc[j] = 0.0f;
      const float* krow = chunk + lane * (d + 1);
      for (int c = 0; c < d; ++c) {
        const float kv = krow[c];
        const float* qc = q_t + c * kBwdLd + r0;
#pragma unroll
        for (int j = 0; j < kBwdRows; ++j) acc[j] = fmaf(qc[j], kv, acc[j]);
      }
      const int key = k0 + lane;
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) {
        const int row = q0 + r0 + j;
        float x;
        if (key >= n) {
          x = -INFINITY;
        } else if (row >= n) {
          x = 0.0f;
        } else {
          x = acc[j] + (bias ? bias[(size_t)row * n + key] : 0.0f);
        }
        s[(r0 + j) * n_pad + key] = x;
      }
      __syncthreads();
      load_rows_f32(chunk, vg, k0, kBwdChunk, n, d, p.row_stride_in, 1.0f);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) acc[j] = 0.0f;
      const float* vrow = chunk + lane * (d + 1);
      for (int c = 0; c < d; ++c) {
        const float vv = vrow[c];
        const float* dc = do_t + c * kBwdLd + r0;
#pragma unroll
        for (int j = 0; j < kBwdRows; ++j) acc[j] = fmaf(dc[j], vv, acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) ds[(r0 + j) * n_pad + key] = acc[j];
    }

    // 3. Softmax, delta and ds; each warp owns its 4 rows.
    for (int j = 0; j < kBwdRows; ++j) {
      const int r = r0 + j;
      const int row = q0 + r;
      float* srow = s + (size_t)r * n_pad;
      float* drow = ds + (size_t)r * n_pad;
      float m = -INFINITY;
      for (int c = lane; c < n_pad; c += 32) m = fmaxf(m, srow[c]);
      m = warp_max(m);
      float l = 0.0f;
      for (int c = lane; c < n_pad; c += 32) l += expf(srow[c] - m);
      l = warp_sum(l);
      float dl = 0.0f;
      for (int c = lane; c < n_pad; c += 32) {
        const float pc = expf(srow[c] - m) / l;
        srow[c] = pc;
        dl = fmaf(pc, drow[c], dl);
      }
      const float delta = warp_sum(dl);
      for (int c = lane; c < n_pad; c += 32) {
        const float dsv = srow[c] * (drow[c] - delta);
        drow[c] = dsv;
        if (p.dbias) dbias_acc[(size_t)r * n_pad + c] += dsv;
      }
      if (lane == 0 && row < n) {
        const size_t at = (g * p.heads + h) * (size_t)n + row;
        p.row_m[at] = m;
        p.row_l[at] = l;
        p.row_delta[at] = delta;
      }
    }

    // 4. dq = ds k * scale: lane = columns lane + 32 * cc, warp = 4 rows.
    float acc[kBwdRows][kBwdCols];
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j)
#pragma unroll
      for (int cc = 0; cc < kBwdCols; ++cc) acc[j][cc] = 0.0f;
    for (int k0 = 0; k0 < n_pad; k0 += kBwdChunk) {
      __syncthreads();
      load_rows_f32(chunk, kg, k0, kBwdChunk, n, d, p.row_stride_in, 1.0f);
      __syncthreads();
      for (int kk = 0; kk < kBwdChunk; ++kk) {
        float kv[kBwdCols];
#pragma unroll
        for (int cc = 0; cc < kBwdCols; ++cc) {
          const int c = lane + 32 * cc;
          kv[cc] = c < d ? chunk[kk * (d + 1) + c] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kBwdRows; ++j) {
          const float dsv = ds[(r0 + j) * n_pad + k0 + kk];
#pragma unroll
          for (int cc = 0; cc < kBwdCols; ++cc) acc[j][cc] = fmaf(dsv, kv[cc], acc[j][cc]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j) {
      const int row = q0 + r0 + j;
      if (row >= n) continue;
      T* dqrow = dqg + (size_t)row * p.row_stride_grad;
#pragma unroll
      for (int cc = 0; cc < kBwdCols; ++cc) {
        const int c = lane + 32 * cc;
        if (c < d) dqrow[c] = from_f32<T>(acc[j][cc] * p.scale);
      }
    }
  }

  // 5. This chunk's partial dbias for the tile's rows.
  if (p.dbias) {
    __syncthreads();
    float* out = p.dbias + (((size_t)bc * p.windows + w) * p.heads + h) * (size_t)n * n;
    for (int i = threadIdx.x; i < kBwdTile * n; i += kBwdThreads) {
      const int r = i / n;
      const int key = i - r * n;
      const int row = q0 + r;
      if (row < n) out[(size_t)row * n + key] = dbias_acc[(size_t)r * n_pad + key];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads) attention_bwd_dkv_kernel(AttnBwdParams p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int n = p.n;
  const int ld = d + 1;
  float* k_s = smem;                              // [kBwdTile][ld] this block's keys
  float* v_s = k_s + kBwdTile * ld;               // [kBwdTile][ld] and values
  float* q_s = v_s + kBwdTile * ld;               // [kBwdChunk][ld] scaled queries of the chunk
  float* do_s = q_s + kBwdChunk * ld;             // [kBwdChunk][ld] their dout
  float* p_s = do_s + kBwdChunk * ld;             // [kBwdChunk][kBwdLd] p  (query, key)
  float* ds_s = p_s + kBwdChunk * kBwdLd;         // [kBwdChunk][kBwdLd] ds
  float* st = ds_s + kBwdChunk * kBwdLd;          // [3][kBwdChunk] row max, sum, delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x % p.tiles;
  const size_t g = blockIdx.x / p.tiles;
  const int h = blockIdx.y;
  const int w = (int)(g % p.windows);
  const int k0 = tile * kBwdTile;
  const int r0 = warp * kBwdRows;
  const size_t col = (size_t)h * d;
  const T* qg = static_cast<const T*>(p.q) + g * p.group_stride_in + col;
  const T* kg = static_cast<const T*>(p.k) + g * p.group_stride_in + col;
  const T* vg = static_cast<const T*>(p.v) + g * p.group_stride_in + col;
  const T* dog = static_cast<const T*>(p.dout) + g * p.group_stride_dout + col;
  const float* bias = p.bias ? p.bias + ((size_t)w * p.heads + h) * (size_t)n * n : nullptr;
  const size_t stat0 = (g * p.heads + h) * (size_t)n;

  load_rows_f32(k_s, kg, k0, kBwdTile, n, d, p.row_stride_in, 1.0f);
  load_rows_f32(v_s, vg, k0, kBwdTile, n, d, p.row_stride_in, 1.0f);

  float dk[kBwdRows][kBwdCols];
  float dv[kBwdRows][kBwdCols];
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j)
#pragma unroll
    for (int cc = 0; cc < kBwdCols; ++cc) dk[j][cc] = dv[j][cc] = 0.0f;

  const int key = k0 + lane;
  for (int qc0 = 0; qc0 < n; qc0 += kBwdChunk) {
    __syncthreads();  // the previous chunk is consumed
    load_rows_f32(q_s, qg, qc0, kBwdChunk, n, d, p.row_stride_in, p.scale);
    load_rows_f32(do_s, dog, qc0, kBwdChunk, n, d, p.row_stride_dout, 1.0f);
    if (threadIdx.x < kBwdChunk) {
      const int row = qc0 + threadIdx.x;
      const bool live = row < n;
      st[threadIdx.x] = live ? p.row_m[stat0 + row] : 0.0f;
      st[kBwdChunk + threadIdx.x] = live ? p.row_l[stat0 + row] : 1.0f;
      st[2 * kBwdChunk + threadIdx.x] = live ? p.row_delta[stat0 + row] : 0.0f;
    }
    __syncthreads();

    // p and ds for (4 queries of this warp, key = lane), from the same f32
    // products in the same order as the dq kernel.
    float sacc[kBwdRows], pacc[kBwdRows];
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j) sacc[j] = pacc[j] = 0.0f;
    const float* krow = k_s + lane * ld;
    const float* vrow = v_s + lane * ld;
    for (int c = 0; c < d; ++c) {
      const float kv = krow[c];
      const float vv = vrow[c];
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) {
        sacc[j] = fmaf(q_s[(r0 + j) * ld + c], kv, sacc[j]);
        pacc[j] = fmaf(do_s[(r0 + j) * ld + c], vv, pacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kBwdRows; ++j) {
      const int qi = r0 + j;
      const int row = qc0 + qi;
      float pv = 0.0f, dsv = 0.0f;
      if (row < n && key < n) {
        const float sv = sacc[j] + (bias ? bias[(size_t)row * n + key] : 0.0f);
        pv = expf(sv - st[qi]) / st[kBwdChunk + qi];
        dsv = pv * (pacc[j] - st[2 * kBwdChunk + qi]);
      }
      p_s[qi * kBwdLd + lane] = pv;
      ds_s[qi * kBwdLd + lane] = dsv;
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q: warp = 4 keys, lane = columns.
    for (int qi = 0; qi < kBwdChunk; ++qi) {
      float dov[kBwdCols], qv[kBwdCols];
#pragma unroll
      for (int cc = 0; cc < kBwdCols; ++cc) {
        const int c = lane + 32 * cc;
        dov[cc] = c < d ? do_s[qi * ld + c] : 0.0f;
        qv[cc] = c < d ? q_s[qi * ld + c] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kBwdRows; ++j) {
        const float pv = p_s[qi * kBwdLd + r0 + j];
        const float dsv = ds_s[qi * kBwdLd + r0 + j];
#pragma unroll
        for (int cc = 0; cc < kBwdCols; ++cc) {
          dv[j][cc] = fmaf(pv, dov[cc], dv[j][cc]);
          dk[j][cc] = fmaf(dsv, qv[cc], dk[j][cc]);
        }
      }
    }
  }

  T* dkg = static_cast<T*>(p.dk) + g * p.group_stride_grad + col;
  T* dvg = static_cast<T*>(p.dv) + g * p.group_stride_grad + col;
#pragma unroll
  for (int j = 0; j < kBwdRows; ++j) {
    const int kr = k0 + r0 + j;
    if (kr >= n) continue;
#pragma unroll
    for (int cc = 0; cc < kBwdCols; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) {
        dkg[(size_t)kr * p.row_stride_grad + c] = from_f32<T>(dk[j][cc]);
        dvg[(size_t)kr * p.row_stride_grad + c] = from_f32<T>(dv[j][cc]);
      }
    }
  }
}

// Launches the dq kernel, the dkv kernel and, when p.dbias holds more than one
// chunk, the dbias reduction into dbias_out, in that order on `stream`.  The
// caller has checked the shapes (d % 8 == 0, d <= kBwdMaxHeadDim,
// n <= kBwdMaxKeys) and sized the scratch.
template <typename T>
cudaError_t launch_attention_bwd(AttnBwdParams p, float* dbias_out, cudaStream_t stream) {
  p.n_pad = round_up(p.n, kBwdChunk);
  p.tiles = (p.n + kBwdTile - 1) / kBwdTile;
  p.batch_chunks = (p.batch + p.batch_per_block - 1) / p.batch_per_block;

  const size_t dq_smem = attention_bwd_dq_smem_bytes(p.n, p.d, p.dbias != nullptr);
  cudaError_t err = allow_smem(attention_bwd_dq_kernel<T>, dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((unsigned)(p.batch_chunks * p.windows * p.tiles), (unsigned)p.heads);
  attention_bwd_dq_kernel<T><<<dq_grid, kBwdThreads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = attention_bwd_dkv_smem_bytes(p.d);
  err = allow_smem(attention_bwd_dkv_kernel<T>, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((unsigned)((size_t)p.batch * p.windows * p.tiles), (unsigned)p.heads);
  attention_bwd_dkv_kernel<T><<<dkv_grid, kBwdThreads, dkv_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (p.dbias && p.batch_chunks > 1) {
    err = launch_column_sum(p.dbias, dbias_out, p.batch_chunks, p.windows * p.heads * p.n * p.n,
                            stream);
  }
  return err;
}

}  // namespace
