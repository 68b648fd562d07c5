// Shared backward attention kernels for the backward entry points in this
// folder: self_attention_bwd.cu (B1) and window_attention_v2_bwd.cu (B2 and
// v1).
//
// For one (group, head) with o = softmax(s) v, s = (q k^T) * scale + bias,
// and the output's cotangent do, they compute what the Pallas backward
// kernels compute (edrl_tpu/kernels/window_attention.py, _sa_bwd_kernel and
// _attn_bwd_kernel_v2):
//
//     p = softmax(s)                      (recomputed; the forward saves nothing)
//     dp = do v^T,  delta = rowsum(dp * p),  ds = p * (dp - delta)
//     dv = p^T do,  dq = ds k * scale,  dk = ds^T (q * scale),  dbias = sum_b ds
//
// s, p, dp, delta and ds are f32.  Every operand is addressed through three
// strides, between groups, heads and tokens: q, k, v and dout are read in
// place and dq, dk and dv written in the input type at the head's place in
// their outputs (the head's columns of a packed [.., N, C] row, head stride
// D, in B1, B2 and B6; a block of N rows, head stride N*D, in v1's [B, W, H,
// N, D]), so no transpose or concatenate happens outside; dbias in f32.
//
// The TPU kernel runs one program per (b, w, h) and accumulates dbias[w, h]
// across the batch in an output block that its sequential grid revisits.
// CUDA blocks run in no order, so each route splits the work in two kernels
// launched in this order on one stream: a dq kernel per query tile, which
// also writes the row statistics (max, sum, delta) and sums ds over its
// chunk of the batch in shared memory into the chunk's partial dbias; then a
// dk/dv kernel per key tile, which recomputes p and ds from those
// statistics.  column_sum_kernel sums the partials in a fixed order.  No
// atomics anywhere, so dq, dk, dv and dbias are the same bit for bit from
// run to run, and the [N, N] probabilities never reach device memory.
//
// Two routes, chosen per call from the dtype and shape before the launch
// (attention_bwd_route_mma; the wrapper's attention_bwd_route mirrors it):
//
// - Tensor cores: bf16, head_dim % 16 == 0, N <= 224 (every main-path call:
//   N = 144 and 216, head_dim 128), the calls the forward's tensor-core
//   kernel takes.  What bounded the CUDA-core route on the H100 was f32 FMA
//   with every operand read from shared memory as f32 (~10 TFLOP/s, 7
//   products).  Here every product is mma.sync m16n8k16 (bf16 in, f32
//   accumulate) on fragments that ldmatrix reads from bf16 tiles, staged by
//   cp.async ahead of the products that use them, in a shared-memory layout
//   whose strides are compile-time constants (the first version's runtime
//   strides and a kernel unrolled over all N put 47,000 instructions, most
//   of them integer address arithmetic, into the dq kernel).  Blocks of 4
//   warps, 16 rows a warp; s, p, dp and ds live in registers in f32, a
//   32-wide chunk at a time.  p is rounded to bf16 where it enters the dv
//   product as an A operand (as the forward's tensor-core kernel rounds it
//   before its value product); ds enters the dq and dk products as two bf16
//   parts, hi + lo (frag_a_split: with one rounding, B1's backward on a
//   train step's own tensors was off by 3.6% of its largest magnitude);
//   dbias sums the f32 ds.
//   1. attention_bwd_dq_mma_kernel: one block per (64 queries, window, head,
//      batch chunk), two walks over the keys per batch entry: the row
//      statistics and delta online, then ds, dbias and dq.  6 products.
//   2. attention_bwd_dkv_mma_kernel: one block per (group, head, 64 keys),
//      keys and values resident, a walk over the queries in chunks of 32;
//      recomputes s^T and dp^T and accumulates dv and dk in registers.  5
//      products.
//   Registers per thread, shared memory per block and blocks per SM at the
//   main-path shapes: chip_smoke.py phase 2 prints them, PERF.md keeps them.
// - CUDA cores: f32 inputs (the exact path that the f32 bars of 1e-4 hold)
//   and bf16 shapes outside the tensor-core route (head_dim % 16 != 0,
//   224 < N <= 256).  256 threads; q, k, v and do upcast to f32 in shared
//   memory, products as f32 FMA.  attention_bwd_dq_kernel keeps [32, N] f32
//   score and dp rows per 32-query tile (so N <= 256) and recomputes s and dp
//   in attention_bwd_dkv_kernel (32-key tiles).
//
// The tail keys past N get p = 0 and ds = 0, so they reach neither dbias
// nor dk/dv; the tail queries compute on zeros and are never stored.

#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

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
  long long head_stride_in;     // elements between head h and h + 1 in q/k/v (d in packed rows)
  long long head_stride_dout;   // ... in dout
  long long head_stride_grad;   // ... in dq/dk/dv
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
  int tiles;            // ceil(n / rows per block)
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
    const size_t in_off = g * p.group_stride_in + (size_t)h * p.head_stride_in;
    const T* qg = static_cast<const T*>(p.q) + in_off;
    const T* kg = static_cast<const T*>(p.k) + in_off;
    const T* vg = static_cast<const T*>(p.v) + in_off;
    const T* dog = static_cast<const T*>(p.dout) + g * p.group_stride_dout + (size_t)h * p.head_stride_dout;
    T* dqg = static_cast<T*>(p.dq) + g * p.group_stride_grad + (size_t)h * p.head_stride_grad;

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
  const size_t in_off = g * p.group_stride_in + (size_t)h * p.head_stride_in;
  const size_t grad_off = g * p.group_stride_grad + (size_t)h * p.head_stride_grad;
  const T* qg = static_cast<const T*>(p.q) + in_off;
  const T* kg = static_cast<const T*>(p.k) + in_off;
  const T* vg = static_cast<const T*>(p.v) + in_off;
  const T* dog = static_cast<const T*>(p.dout) + g * p.group_stride_dout + (size_t)h * p.head_stride_dout;
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

  T* dkg = static_cast<T*>(p.dk) + grad_off;
  T* dvg = static_cast<T*>(p.dv) + grad_off;
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

// ---------------------------------------------------------------------------
// Tensor-core route (bf16).
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcRows = kTcWarps * 16;          // queries of a dq block, keys of a dkv block
constexpr int kTcStep = 32;                     // keys (dq) or queries (dkv) per staged chunk
constexpr int kTcDqStages = 3;                  // the dq kernel's ring of staged key chunks
constexpr int kTcMaxKeys = 224;                 // the forward's tensor-core route takes the same calls
constexpr int kTcLd = kAttnLd;                  // bf16 row stride of every staged tile
constexpr int kTcKSteps = kBwdMaxHeadDim / 16;  // 16-deep steps over the head dim
constexpr int kTcVecs = kBwdMaxHeadDim / 8;     // 16-byte vectors per staged row
constexpr int kTcBiasLd = kTcRows + 4;          // dkv kernel's staged bias rows: conflict-free reads
constexpr int kTcStage = 2 * kTcStep * kTcLd;   // bf16 elements of one dq stage (keys, values)
constexpr float kLog2e = 1.4426950408889634f;   // p = 2^((x - m) log2 e) / l

// The route of a call; the caller has checked d % 8 == 0, d <= kBwdMaxHeadDim
// and 1 <= n <= kBwdMaxKeys.
inline bool attention_bwd_route_mma(bool is_bf16, int n, int d) {
  return is_bf16 && d % 16 == 0 && n <= kTcMaxKeys;
}

// Row stride of the dq kernel's f32 dbias accumulator: keys rounded up to
// 32, plus 8 so that a warp's float2 updates hit every bank once.
__host__ __device__ inline int tc_dbias_ld(int n) { return (n + kTcStep - 1) / kTcStep * kTcStep + 8; }

inline size_t attention_bwd_dq_mma_smem_bytes(int n, bool with_dbias) {
  return (size_t)kTcDqStages * kTcStage * sizeof(__nv_bfloat16) +
         (with_dbias ? (size_t)kTcRows * tc_dbias_ld(n) * sizeof(float) : 0);
}

inline size_t attention_bwd_dkv_mma_smem_bytes(bool with_bias) {
  return (size_t)(2 * kTcRows + 4 * kTcStep) * kTcLd * sizeof(__nv_bfloat16) +
         2 * (3 + (with_bias ? kTcBiasLd : 0)) * kTcStep * sizeof(float);
}

// Rows [row0, row0 + ROWS) of one head (d bf16 each) into shared rows of
// stride kTcLd by cp.async, 16 bytes per thread and step: thread i copies
// column (i % 16) * 8 of rows i / 16, i / 16 + 8, ...  Rows past n are zero,
// columns past d are left alone.  The caller commits and waits.
template <int ROWS>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row_stride, int row0, int n, int d) {
  constexpr int kRowsPerStep = kTcThreads / kTcVecs;
  static_assert(ROWS % kRowsPerStep == 0, "whole steps");
  const int r = threadIdx.x / kTcVecs;
  const int c = (threadIdx.x % kTcVecs) * 8;
  if (c >= d) return;
  const __nv_bfloat16* s = src + (size_t)(row0 + r) * row_stride + c;
  __nv_bfloat16* o = dst + r * kTcLd + c;
#pragma unroll
  for (int it = 0; it < ROWS / kRowsPerStep; ++it) {
    const bool valid = row0 + r + it * kRowsPerStep < n;
    cp_async16(o + it * kRowsPerStep * kTcLd, valid ? s + (size_t)it * kRowsPerStep * row_stride : src,
               valid);
  }
}

// The A fragment that frag_a_from_c makes, as two bf16 parts, hi rounding
// the f32 values and lo rounding what hi leaves: hi + lo carries ~16
// significant bits.  ds goes to
// the dq and dk products so: those sums cancel (ds sums to 0 over a row), and
// on a train step's own tensors one bf16 rounding of ds put B1's backward
// 3.6% of its largest magnitude off, hi + lo 0.6% (PERF.md).
__device__ __forceinline__ void frag_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4], const float (&c0)[4],
                                             const float (&c1)[4]) {
  const float v[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(v[2 * i] - __low2float(h), v[2 * i + 1] - __high2float(h));
  }
}

// acc[0..3] = the 16 rows whose A fragments `a` holds times rows 0 .. 31 of
// the staged tile b_s transposed, over depth d.
__device__ __forceinline__ void product_nt32(float (&acc)[4][4], const uint32_t (&a)[kTcKSteps][4],
                                             const __nv_bfloat16* b_s, int d) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kTcKSteps; ++kk) {
    if (16 * kk < d) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t b[4];
        frag_b_nk(b, b_s, 16 * half, 16 * kk);
        mma_bf16_16816(acc[2 * half], a[kk], b[0], b[1]);
        mma_bf16_16816(acc[2 * half + 1], a[kk], b[2], b[3]);
      }
    }
  }
}

// One block per (64 queries, window, head, batch chunk), 4 warps of 16
// queries.  A warp keeps its q and do rows as A fragments in registers and
// its dq in f32.  Per batch entry the block walks the keys twice in chunks
// of 32 (keys and values staged by cp.async two chunks ahead in a ring of
// three), and the second walk recomputes the chunk's scores and dp rather
// than keeping a [16, N] f32 row of either, so that the walks stay short
// loops of independent products and the kernel small:
//   1. s = q k^T and dp = do v^T; the row max m, the row sum l and delta =
//      rowsum(dp * p), online;
//   2. s, p and dp again; ds = p * (dp - delta) into the f32 dbias
//      accumulator, and dq += ds k with ds as bf16 hi + lo.
// 6 tensor-core products (s and dp twice, dq twice).
__global__ void __launch_bounds__(kTcThreads, 2) attention_bwd_dq_mma_kernel(AttnBwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d;
  const int n = p.n;
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [kTcDqStages][keys, values][kTcStep][kTcLd]
  float* dbias_acc = reinterpret_cast<float*>(ring + kTcDqStages * kTcStage);  // [kTcRows][ldb]
  const int ldb = tc_dbias_ld(n);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile = blockIdx.x % p.tiles;
  const int rest = blockIdx.x / p.tiles;
  const int w = rest % p.windows;
  const int bc = rest / p.windows;
  const int h = blockIdx.y;
  const int q0 = tile * kTcRows;
  const int r0 = warp * 16;
  const bool live = q0 + r0 < n;  // the warp owns a query row
  const int row_lo = q0 + r0 + g;
  const int row_hi = row_lo + 8;
  const int chunks = (n + kTcStep - 1) / kTcStep;
  const int b_begin = bc * p.batch_per_block;
  const int b_end = min(p.batch, b_begin + p.batch_per_block);
  const float* bias = p.bias ? p.bias + ((size_t)w * p.heads + h) * (size_t)n * n : nullptr;
  const float* bias_lo = bias + (size_t)row_lo * n;  // read only where row_lo < n
  const float* bias_hi = bias + (size_t)row_hi * n;
  float* dbias_lo = dbias_acc + (r0 + g) * ldb + 2 * t;  // this lane's accumulator, row g, key 2t
  float* dbias_hi = dbias_lo + 8 * ldb;

  if (p.dbias) {
    for (int i = threadIdx.x; i < kTcRows * ldb; i += kTcThreads) dbias_acc[i] = 0.0f;
  }

  for (int b = b_begin; b < b_end; ++b) {
    const size_t grp = (size_t)b * p.windows + w;
    const size_t in_off = grp * p.group_stride_in + (size_t)h * p.head_stride_in;
    const bf16* qg = static_cast<const bf16*>(p.q) + in_off;
    const bf16* kg = static_cast<const bf16*>(p.k) + in_off;
    const bf16* vg = static_cast<const bf16*>(p.v) + in_off;
    const bf16* dog = static_cast<const bf16*>(p.dout) + grp * p.group_stride_dout + (size_t)h * p.head_stride_dout;
    bf16* dqg = static_cast<bf16*>(p.dq) + grp * p.group_stride_grad + (size_t)h * p.head_stride_grad;
    const size_t stat0 = (grp * p.heads + h) * (size_t)n;

    // Step j of the two walks stages key chunk j % chunks (its keys and
    // values) into stage j % kTcDqStages: one cp.async group per step.
    auto issue = [&](int j) {
      if (j >= 2 * chunks) return;
      const int k0 = (j >= chunks ? j - chunks : j) * kTcStep;
      bf16* stage = ring + (j % kTcDqStages) * kTcStage;
      stage_rows_bf16<kTcStep>(stage, kg, p.row_stride_in, k0, n, d);
      stage_rows_bf16<kTcStep>(stage + kTcStep * kTcLd, vg, p.row_stride_in, k0, n, d);
    };
    // Start of step j: wait for its chunk (step j + 1 may be in flight),
    // then, every warp being past step j - 1, stage step j + 2 into the
    // stage step j - 1 used.  Returns step j's keys; its values follow them.
    auto begin = [&](int j) {
      cp_async_wait<1>();
      __syncthreads();
      issue(j + 2);
      cp_async_commit();
      return static_cast<const bf16*>(ring + (j % kTcDqStages) * kTcStage);
    };

    // The tile's q and do rows through stages 1 and 2 into the warps' A
    // fragments, key chunk 0 into stage 0 meanwhile; then chunk 1 into
    // stage 1.
    __syncthreads();  // the previous batch entry's stages are consumed
    stage_rows_bf16<kTcRows>(ring + kTcStage, qg, p.row_stride_in, q0, n, d);
    stage_rows_bf16<kTcRows>(ring + 2 * kTcStage, dog, p.row_stride_dout, q0, n, d);
    issue(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    uint32_t qa[kTcKSteps][4], da[kTcKSteps][4];
    if (live) {
#pragma unroll
      for (int kk = 0; kk < kTcKSteps; ++kk) {
        if (16 * kk < d) {
          frag_a(qa[kk], ring + kTcStage, r0, 16 * kk);
          frag_a(da[kk], ring + 2 * kTcStage, r0, 16 * kk);
        }
      }
    }
    __syncthreads();
    issue(1);
    cp_async_commit();

    // x = s * scale + bias for key chunk c: -inf past n, 0 in the tail rows.
    // Lane (g, t) holds rows g and g + 8, keys 32c + 8jj + 2t (+ 1).
    auto scores = [&](float (&x)[4][4], const bf16* k_c, int c) {
      product_nt32(x, qa, k_c, d);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool hi = e >= 2;
          const int row = hi ? row_hi : row_lo;
          const int key = kTcStep * c + 8 * jj + 2 * t + (e & 1);
          const float bv = bias != nullptr && row < n && key < n ? __ldg((hi ? bias_hi : bias_lo) + key) : 0.0f;
          const float v = row < n ? x[jj][e] * p.scale + bv : 0.0f;
          x[jj][e] = key < n ? v : -INFINITY;
        }
      }
    };

    // 1. Row max m, row sum l and delta = rowsum(dp * p), online: with e =
    //    2^((x - m) log2 e), l = sum(e) and a = sum(e * dp), each chunk
    //    rescaling the lane's partial sums to the quad's new max; then
    //    delta = a / l.
    float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f, a_lo = 0.0f, a_hi = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const bf16* k_c = begin(c);
      if (live) {
        float x[4][4], dp[4][4];
        scores(x, k_c, c);
        product_nt32(dp, da, k_c + kTcStep * kTcLd, d);
        float cm_lo = m_lo, cm_hi = m_hi;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          cm_lo = fmaxf(cm_lo, fmaxf(x[jj][0], x[jj][1]));
          cm_hi = fmaxf(cm_hi, fmaxf(x[jj][2], x[jj][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, off));
          cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, off));
        }
        const float r_lo = exp2f((m_lo - cm_lo) * kLog2e);  // 2^-inf = 0 on the first chunk
        const float r_hi = exp2f((m_hi - cm_hi) * kLog2e);
        l_lo *= r_lo;
        a_lo *= r_lo;
        l_hi *= r_hi;
        a_hi *= r_hi;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ex = exp2f((x[jj][e] - (e < 2 ? cm_lo : cm_hi)) * kLog2e);
            if (e < 2) {
              l_lo += ex;
              a_lo += ex * dp[jj][e];
            } else {
              l_hi += ex;
              a_hi += ex * dp[jj][e];
            }
          }
        }
        m_lo = cm_lo;
        m_hi = cm_hi;
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      a_lo += __shfl_xor_sync(0xffffffffu, a_lo, off);
      a_hi += __shfl_xor_sync(0xffffffffu, a_hi, off);
    }
    const float il_lo = __frcp_rn(l_lo);
    const float il_hi = __frcp_rn(l_hi);
    const float dl_lo = a_lo * il_lo;
    const float dl_hi = a_hi * il_hi;
    if (t == 0) {
      if (row_lo < n) {
        p.row_m[stat0 + row_lo] = m_lo;
        p.row_l[stat0 + row_lo] = l_lo;
        p.row_delta[stat0 + row_lo] = dl_lo;
      }
      if (row_hi < n) {
        p.row_m[stat0 + row_hi] = m_hi;
        p.row_l[stat0 + row_hi] = l_hi;
        p.row_delta[stat0 + row_hi] = dl_hi;
      }
    }

    // p = 2^((x - m) log2 e) / l for a chunk, from its scores (as the dkv
    // kernel forms it from the saved statistics).
    auto probs = [&](float (&x)[4][4]) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        x[jj][0] = exp2f((x[jj][0] - m_lo) * kLog2e) * il_lo;
        x[jj][1] = exp2f((x[jj][1] - m_lo) * kLog2e) * il_lo;
        x[jj][2] = exp2f((x[jj][2] - m_hi) * kLog2e) * il_hi;
        x[jj][3] = exp2f((x[jj][3] - m_hi) * kLog2e) * il_hi;
      }
    };

    // 2. ds = p * (dp - delta) into the dbias accumulator, and dq += ds k
    //    with ds as bf16 hi + lo A operands.
    float dq[kBwdMaxHeadDim / 8][4];
#pragma unroll
    for (int dn = 0; dn < kBwdMaxHeadDim / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
      const bf16* k_c = begin(chunks + c);
      if (live) {
        float ds[4][4], dp[4][4];
        scores(ds, k_c, c);
        product_nt32(dp, da, k_c + kTcStep * kTcLd, d);
        probs(ds);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          ds[jj][0] *= dp[jj][0] - dl_lo;
          ds[jj][1] *= dp[jj][1] - dl_lo;
          ds[jj][2] *= dp[jj][2] - dl_hi;
          ds[jj][3] *= dp[jj][3] - dl_hi;
          if (p.dbias) {
            float2* lo = reinterpret_cast<float2*>(dbias_lo + kTcStep * c + 8 * jj);
            float2* hi = reinterpret_cast<float2*>(dbias_hi + kTcStep * c + 8 * jj);
            lo->x += ds[jj][0];
            lo->y += ds[jj][1];
            hi->x += ds[jj][2];
            hi->y += ds[jj][3];
          }
        }
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a_hi[4], a_lo[4];
          frag_a_split(a_hi, a_lo, ds[2 * ks], ds[2 * ks + 1]);
#pragma unroll
          for (int dn = 0; dn < kTcKSteps; ++dn) {
            if (16 * dn < d) {
              uint32_t kb[4];
              frag_b_kn(kb, k_c, 16 * ks, 16 * dn);
              mma_bf16_16816(dq[2 * dn], a_hi, kb[0], kb[1]);
              mma_bf16_16816(dq[2 * dn + 1], a_hi, kb[2], kb[3]);
              mma_bf16_16816(dq[2 * dn], a_lo, kb[0], kb[1]);
              mma_bf16_16816(dq[2 * dn + 1], a_lo, kb[2], kb[3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int dn = 0; dn < kBwdMaxHeadDim / 8; ++dn) {
      if (8 * dn < d) {
        const int c = 8 * dn + 2 * t;
        if (row_lo < n) {
          *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)row_lo * p.row_stride_grad + c) =
              __floats2bfloat162_rn(dq[dn][0] * p.scale, dq[dn][1] * p.scale);
        }
        if (row_hi < n) {
          *reinterpret_cast<__nv_bfloat162*>(dqg + (size_t)row_hi * p.row_stride_grad + c) =
              __floats2bfloat162_rn(dq[dn][2] * p.scale, dq[dn][3] * p.scale);
        }
      }
    }
  }

  // 3. This chunk's partial dbias for the tile's rows.
  if (p.dbias) {
    __syncthreads();
    float* out = p.dbias + (((size_t)bc * p.windows + w) * p.heads + h) * (size_t)n * n;
    for (int i = threadIdx.x; i < kTcRows * n; i += kTcThreads) {
      const int r = i / n;
      const int key = i - r * n;
      const int row = q0 + r;
      if (row < n) out[(size_t)row * n + key] = dbias_acc[r * ldb + key];
    }
  }
}

// One block per (group, head, 64 keys), 4 warps of 16 keys, the keys and
// values resident.  It walks the queries in chunks of 32 (queries, dout,
// their row statistics and their bias rows at the block's keys, staged by
// cp.async one chunk ahead), recomputes s^T and dp^T, forms p^T and ds^T
// from the saved statistics with the dq kernel's f32 operations, and
// accumulates dv += p^T do and dk += ds^T q in registers.  4 products.
__global__ void __launch_bounds__(kTcThreads, 2) attention_bwd_dkv_mma_kernel(AttnBwdParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d;
  const int n = p.n;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kTcRows][kTcLd] this block's keys
  bf16* v_s = k_s + kTcRows * kTcLd;              // [kTcRows][kTcLd] and values
  bf16* qd_s = v_s + kTcRows * kTcLd;             // [2 stages][queries, dout][kTcStep][kTcLd]
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * kTcStep * kTcLd);  // [2][max, sum, delta][kTcStep]
  float* bias_s = st_s + 2 * 3 * kTcStep;         // [2][kTcStep][kTcBiasLd] if p.bias

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tile = blockIdx.x % p.tiles;
  const size_t grp = blockIdx.x / p.tiles;
  const int h = blockIdx.y;
  const int w = (int)(grp % p.windows);
  const int k0 = tile * kTcRows;
  const int r0 = warp * 16;
  const bool live = k0 + r0 < n;  // the warp owns a key
  const int key_lo = k0 + r0 + g;
  const int key_hi = key_lo + 8;
  const int chunks = (n + kTcStep - 1) / kTcStep;
  const size_t in_off = grp * p.group_stride_in + (size_t)h * p.head_stride_in;
  const size_t grad_off = grp * p.group_stride_grad + (size_t)h * p.head_stride_grad;
  const bf16* qg = static_cast<const bf16*>(p.q) + in_off;
  const bf16* kg = static_cast<const bf16*>(p.k) + in_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + in_off;
  const bf16* dog = static_cast<const bf16*>(p.dout) + grp * p.group_stride_dout + (size_t)h * p.head_stride_dout;
  const float* bias = p.bias ? p.bias + ((size_t)w * p.heads + h) * (size_t)n * n : nullptr;
  const size_t stat0 = (grp * p.heads + h) * (size_t)n;
  const bool bias16 = n % 4 == 0;  // bias rows at the block's keys are 16-byte aligned

  // Query chunk c (queries, dout, their row statistics and their bias rows
  // at this block's keys) into stage c & 1.
  auto issue = [&](int c) {
    if (c >= chunks) return;
    const int qc0 = c * kTcStep;
    bf16* stage = qd_s + (c & 1) * 2 * kTcStep * kTcLd;
    stage_rows_bf16<kTcStep>(stage, qg, p.row_stride_in, qc0, n, d);
    stage_rows_bf16<kTcStep>(stage + kTcStep * kTcLd, dog, p.row_stride_dout, qc0, n, d);
    if (threadIdx.x < 3 * kTcStep) {
      const int which = threadIdx.x / kTcStep;
      const int qi = threadIdx.x - which * kTcStep;
      const float* src = which == 0 ? p.row_m : (which == 1 ? p.row_l : p.row_delta);
      const bool valid = qc0 + qi < n;
      cp_async4(st_s + (c & 1) * 3 * kTcStep + threadIdx.x, src + stat0 + (valid ? qc0 + qi : 0), valid);
    }
    if (bias) {
      float* bst = bias_s + (c & 1) * kTcStep * kTcBiasLd;
      if (bias16) {
#pragma unroll
        for (int it = 0; it < kTcStep * kTcRows / 4 / kTcThreads; ++it) {
          const int i = threadIdx.x + it * kTcThreads;
          const int qi = i / (kTcRows / 4);
          const int kj = (i % (kTcRows / 4)) * 4;
          const bool valid = qc0 + qi < n && k0 + kj < n;
          cp_async16(bst + qi * kTcBiasLd + kj, bias + (valid ? (size_t)(qc0 + qi) * n + k0 + kj : 0), valid);
        }
      } else {
#pragma unroll 4
        for (int it = 0; it < kTcStep * kTcRows / kTcThreads; ++it) {
          const int i = threadIdx.x + it * kTcThreads;
          const int qi = i / kTcRows;
          const int kj = i % kTcRows;
          const bool valid = qc0 + qi < n && k0 + kj < n;
          cp_async4(bst + qi * kTcBiasLd + kj, bias + (valid ? (size_t)(qc0 + qi) * n + k0 + kj : 0), valid);
        }
      }
    }
  };

  stage_rows_bf16<kTcRows>(k_s, kg, p.row_stride_in, k0, n, d);
  stage_rows_bf16<kTcRows>(v_s, vg, p.row_stride_in, k0, n, d);
  issue(0);
  cp_async_commit();

  float dk[kBwdMaxHeadDim / 8][4];
  float dv[kBwdMaxHeadDim / 8][4];
#pragma unroll
  for (int dn = 0; dn < kBwdMaxHeadDim / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.0f;
  }

  for (int c = 0; c < chunks; ++c) {
    // Wait for chunk c; then, every warp being past chunk c - 1, stage
    // chunk c + 1 into the stage chunk c - 1 used.
    cp_async_wait<0>();
    __syncthreads();
    issue(c + 1);
    cp_async_commit();
    if (live) {
      const int qc0 = c * kTcStep;
      const bf16* q_c = qd_s + (c & 1) * 2 * kTcStep * kTcLd;
      const bf16* do_c = q_c + kTcStep * kTcLd;
      const float* st = st_s + (c & 1) * 3 * kTcStep;
      const float* bst = bias_s + (c & 1) * kTcStep * kTcBiasLd;

      // s^T = k q^T and dp^T = v do^T for the warp's 16 keys and the
      // chunk's 32 queries: lane (g, t) holds keys g and g + 8, queries
      // 8j + 2t and 8j + 2t + 1.
      float sc[4][4] = {};
      float dpt[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < kTcKSteps; ++kk) {
        if (16 * kk < d) {
          uint32_t ka[4], va[4], b[4];
          frag_a(ka, k_s, r0, 16 * kk);
          frag_a(va, v_s, r0, 16 * kk);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            frag_b_nk(b, q_c, 16 * half, 16 * kk);
            mma_bf16_16816(sc[2 * half], ka, b[0], b[1]);
            mma_bf16_16816(sc[2 * half + 1], ka, b[2], b[3]);
            frag_b_nk(b, do_c, 16 * half, 16 * kk);
            mma_bf16_16816(dpt[2 * half], va, b[0], b[1]);
            mma_bf16_16816(dpt[2 * half + 1], va, b[2], b[3]);
          }
        }
      }

      // p^T and ds^T from the saved row statistics, with the dq kernel's f32
      // operations; 0 past n.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? key_lo : key_hi;
          const int qi = 8 * j + 2 * t + (e & 1);
          const bool in = key < n && qc0 + qi < n;
          const float x = sc[j][e] * p.scale + (bias ? bst[qi * kTcBiasLd + key - k0] : 0.0f);
          const float pv = exp2f((x - st[qi]) * kLog2e) * __frcp_rn(st[kTcStep + qi]);
          sc[j][e] = in ? pv : 0.0f;
          dpt[j][e] = in ? pv * (dpt[j][e] - st[2 * kTcStep + qi]) : 0.0f;
        }
      }

      // dv += p^T do with p rounded to bf16, and dk += ds^T q with ds as
      // bf16 hi + lo, as A operands.
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t pa[4], da_hi[4], da_lo[4];
        frag_a_from_c(pa, sc[2 * ks], sc[2 * ks + 1]);
        frag_a_split(da_hi, da_lo, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
        for (int dn = 0; dn < kTcKSteps; ++dn) {
          if (16 * dn < d) {
            uint32_t b[4];
            frag_b_kn(b, do_c, 16 * ks, 16 * dn);
            mma_bf16_16816(dv[2 * dn], pa, b[0], b[1]);
            mma_bf16_16816(dv[2 * dn + 1], pa, b[2], b[3]);
            frag_b_kn(b, q_c, 16 * ks, 16 * dn);
            mma_bf16_16816(dk[2 * dn], da_hi, b[0], b[1]);
            mma_bf16_16816(dk[2 * dn + 1], da_hi, b[2], b[3]);
            mma_bf16_16816(dk[2 * dn], da_lo, b[0], b[1]);
            mma_bf16_16816(dk[2 * dn + 1], da_lo, b[2], b[3]);
          }
        }
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(p.dk) + grad_off;
  bf16* dvg = static_cast<bf16*>(p.dv) + grad_off;
#pragma unroll
  for (int dn = 0; dn < kBwdMaxHeadDim / 8; ++dn) {
    if (8 * dn < d) {
      const int c = 8 * dn + 2 * t;
      if (key_lo < n) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)key_lo * p.row_stride_grad + c) =
            __floats2bfloat162_rn(dk[dn][0] * p.scale, dk[dn][1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)key_lo * p.row_stride_grad + c) =
            __floats2bfloat162_rn(dv[dn][0], dv[dn][1]);
      }
      if (key_hi < n) {
        *reinterpret_cast<__nv_bfloat162*>(dkg + (size_t)key_hi * p.row_stride_grad + c) =
            __floats2bfloat162_rn(dk[dn][2] * p.scale, dk[dn][3] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvg + (size_t)key_hi * p.row_stride_grad + c) =
            __floats2bfloat162_rn(dv[dn][2], dv[dn][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Dynamic shared memory the largest backward kernel of the call's route takes
// (a call with dbias has a bias).
inline size_t attention_bwd_smem_bytes(bool is_bf16, int n, int d, bool with_dbias) {
  if (attention_bwd_route_mma(is_bf16, n, d)) {
    const size_t dq = attention_bwd_dq_mma_smem_bytes(n, with_dbias);
    const size_t dkv = attention_bwd_dkv_mma_smem_bytes(with_dbias);
    return dq > dkv ? dq : dkv;
  }
  const size_t dq = attention_bwd_dq_smem_bytes(n, d, with_dbias);
  const size_t dkv = attention_bwd_dkv_smem_bytes(d);
  return dq > dkv ? dq : dkv;
}

template <typename T>
cudaError_t launch_attention_bwd_fma(AttnBwdParams p, cudaStream_t stream) {
  p.n_pad = round_up(p.n, kBwdChunk);
  p.tiles = (p.n + kBwdTile - 1) / kBwdTile;
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
  return cudaGetLastError();
}

inline cudaError_t launch_attention_bwd_mma(AttnBwdParams p, cudaStream_t stream) {
  p.tiles = (p.n + kTcRows - 1) / kTcRows;
  const size_t dq_smem = attention_bwd_dq_mma_smem_bytes(p.n, p.dbias != nullptr);
  cudaError_t err = allow_smem(attention_bwd_dq_mma_kernel, dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid((unsigned)(p.batch_chunks * p.windows * p.tiles), (unsigned)p.heads);
  attention_bwd_dq_mma_kernel<<<dq_grid, kTcThreads, dq_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t dkv_smem = attention_bwd_dkv_mma_smem_bytes(p.bias != nullptr);
  err = allow_smem(attention_bwd_dkv_mma_kernel, dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid((unsigned)((size_t)p.batch * p.windows * p.tiles), (unsigned)p.heads);
  attention_bwd_dkv_mma_kernel<<<dkv_grid, kTcThreads, dkv_smem, stream>>>(p);
  return cudaGetLastError();
}

// The route's dq and dk/dv kernels at (n, d): resident blocks per SM from the
// occupancy calculator (registers, shared memory, threads) in out[0] and
// out[1], dynamic shared memory per block in out[2] and out[3].
inline cudaError_t attention_bwd_occupancy(bool is_bf16, int n, int d, bool with_dbias, int* out) {
  cudaError_t err;
  if (attention_bwd_route_mma(is_bf16, n, d)) {
    out[2] = (int)attention_bwd_dq_mma_smem_bytes(n, with_dbias);
    out[3] = (int)attention_bwd_dkv_mma_smem_bytes(with_dbias);
    err = blocks_per_sm(attention_bwd_dq_mma_kernel, kTcThreads, out[2], &out[0]);
    if (err != cudaSuccess) return err;
    return blocks_per_sm(attention_bwd_dkv_mma_kernel, kTcThreads, out[3], &out[1]);
  }
  out[2] = (int)attention_bwd_dq_smem_bytes(n, d, with_dbias);
  out[3] = (int)attention_bwd_dkv_smem_bytes(d);
  if (is_bf16) {
    err = blocks_per_sm(attention_bwd_dq_kernel<__nv_bfloat16>, kBwdThreads, out[2], &out[0]);
    if (err != cudaSuccess) return err;
    return blocks_per_sm(attention_bwd_dkv_kernel<__nv_bfloat16>, kBwdThreads, out[3], &out[1]);
  }
  err = blocks_per_sm(attention_bwd_dq_kernel<float>, kBwdThreads, out[2], &out[0]);
  if (err != cudaSuccess) return err;
  return blocks_per_sm(attention_bwd_dkv_kernel<float>, kBwdThreads, out[3], &out[1]);
}

// Launches the dq kernel, the dkv kernel and, when p.dbias holds more than one
// chunk, the dbias reduction into dbias_out, in that order on `stream`, on
// the route attention_bwd_route_mma picks.  The caller has checked the shapes
// (d % 8 == 0, d <= kBwdMaxHeadDim, 1 <= n <= kBwdMaxKeys) and sized the
// scratch.  The tensor-core route takes 16-byte aligned q, k, v, dout and
// bias and 4-byte aligned dq, dk and dv (packed bf16 pairs), and returns
// cudaErrorMisalignedAddress, launching nothing, for others.
template <typename T>
cudaError_t launch_attention_bwd(AttnBwdParams p, float* dbias_out, cudaStream_t stream) {
  p.batch_chunks = (p.batch + p.batch_per_block - 1) / p.batch_per_block;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (attention_bwd_route_mma(true, p.n, p.d)) {
      if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || !aligned16(p.dout) ||
          !aligned16(p.bias) || !aligned4(p.dq) || !aligned4(p.dk) || !aligned4(p.dv) ||
          (p.group_stride_in | p.head_stride_in | p.row_stride_in | p.group_stride_dout |
           p.head_stride_dout | p.row_stride_dout) % 8 != 0 ||
          (p.group_stride_grad | p.head_stride_grad | p.row_stride_grad) % 2 != 0) {
        return cudaErrorMisalignedAddress;
      }
      err = launch_attention_bwd_mma(p, stream);
    } else {
      err = launch_attention_bwd_fma<T>(p, stream);
    }
  } else {
    err = launch_attention_bwd_fma<T>(p, stream);
  }
  if (err == cudaSuccess && p.dbias && p.batch_chunks > 1) {
    err = launch_column_sum(p.dbias, dbias_out, p.batch_chunks, p.windows * p.heads * p.n * p.n,
                            stream);
  }
  return err;
}

}  // namespace
