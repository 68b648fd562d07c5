// Shared backward attention kernels for the backward entry points in this
// folder: self_attention_bwd.cu (B1) and window_attention_v2_bwd.cu (B2, v1,
// and B2 inside the fused attention sublayer's backward, B6).
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
// launched in this order on one stream: a rows kernel per query tile, which
// computes dq, writes the row statistics (max, sum, delta) and sums ds over
// its chunk of the batch into the chunk's partial dbias; then a keys kernel
// per block of keys, which recomputes p and ds from those statistics and
// accumulates dk and dv.  column_sum_kernel sums the partials in a fixed
// order.  No atomics anywhere, so dq, dk, dv and dbias are the same bit for
// bit from run to run, and the [N, N] probabilities never reach device
// memory.
//
// Two routes, chosen per call from the dtype and shape before the launch
// (attention_bwd_route_wgmma; the wrapper's attention_bwd_route mirrors it):
//
// - "wgmma": bf16, head_dim % 16 == 0, N <= 224, the calls the forward's
//   wgmma route takes; every main-path call (N = 144 and 216, head_dim 128).
//
//   What bounds it on the H100: the bytes.  A call reads q, k, v and do and
//   writes dq, dk and dv once (B1 at [32, 216, 768]: 74 MB, 22 us at 3.35
//   TB/s; B2 at Swin stage 0 of a batch-32 step: 529 MB of qkv, do and dqkv
//   plus the f32 bias and dbias), against 5 products of 2 N^2 D a (group,
//   head), 7 with ds as hi + lo (B1: 16.0 GFLOP, 16 us at the bf16 peak).
//   The route before this one (mma.sync m16n8k16 on ldmatrix fragments,
//   cp.async-staged 32-row chunks, 4-warp blocks at 2 an SM) issued 11
//   products a (group, head) and reached 7-9 % of the bf16 peak: the dq
//   kernel walked the keys twice (online statistics, then ds) and every
//   16-key step waited on its copy and a barrier for a few tiny products.
//
//   This design (attention_bwd_rows_kernel, attention_bwd_keys_kernel):
//   * one CTA of 384 threads per SM (a persistent grid): two consumer
//     warpgroups and a producer warpgroup that issues every load by TMA
//     through 4-D tensor maps over (column, head, token, group) with the
//     call's strides (attention_map_plan, make_attention_map, shared with
//     the forward), so a box reads zeros past D, past N and past the last
//     group, never the next group's tokens.  The producer gives its
//     registers to the consumers (setmaxnreg 24 and 240; the launch's cap is
//     168 a thread at 12 warps an SM);
//   * the rows kernel: a unit is (query tile of 64 rows, window, head,
//     chunk of the batch); for each batch entry of the chunk the head's
//     whole K and V are resident (keys padded to NK = 64, 160 or 224,
//     attention_bwd_keys) beside the tile's q and do.  The two warpgroups
//     split the keys, NK / 2 each (a multiple of 16: the dq product's
//     depth), and run one pass over the row: dp = do v^T and s = q k^T on
//     wgmma (m64n{NK/2}k16, both operands from shared memory); scale, bias
//     and -inf past N in f32; the row max, then the row sum l and a =
//     rowsum(e dp) of e = 2^((x - m) log2 e), each exchanged between the two
//     warpgroups through shared memory (max of the two; sums in warpgroup
//     order); p = e (1 / l), delta = a (1 / l), ds = p (dp - delta) into the f32
//     dbias accumulator in registers, and dq = ds k with ds as bf16 hi + lo
//     register A operands (m64n128k16, K an MN-major operand).  Each
//     warpgroup then sends the dq columns the other stores through shared
//     memory (f32, added in a fixed order) and stores 64 columns.  4
//     products a tile, no second walk; the statistics go to device memory
//     in tiles of 64 rows (m, 1 / l, delta: 768 bytes).  A unit's entries
//     share one bias: at NK <= 160 each thread reads its 40 values once a
//     unit into registers (at 224, the B2 call under B6, once an entry);
//   * the keys kernel: each consumer warpgroup with one producer warp is a
//     pipeline of its own over (item, 64-key block) units: its block's K
//     and V resident, the item's q and do tiles and their statistics
//     streamed through a two-stage ring (one cp.async.bulk for the
//     statistics); per tile s^T = k q^T and dp^T = v do^T (m64n64k16, shared
//     memory), p^T and ds^T from the statistics, dv += p^T do with p rounded
//     to bf16 and dk += ds^T q with ds as hi + lo (m64n128k16, register A).
//     dk and dv stay in registers (128 f32 a thread) until the store.  5
//     products a tile.  The bias comes from a copy in the keys kernel's
//     order (attention_bwd_bias_tiles_kernel, one launch more a call, the
//     bias's bytes once more): each thread reads its 32 values a tile as 8
//     coalesced float4s, prefetched into L1 under the products (read where
//     they fall, 32 scattered floats a tile, they dominated the kernel's
//     time at Swin stage 0);
//   * a warpgroup's stores go through its warps' 16 x 32 staging blocks as
//     16-byte row segments (the forward's);
//   * shared memory (dynamic, with 1024 bytes of alignment slack): the rows
//     kernel holds K and V (2 * NK * 256 bytes), q and do (32 KB) and the dq
//     exchange (32 KB): 99,328 / 148,480 / 181,248 bytes at NK = 64 / 160 /
//     224, and 11,808 static (barriers, the row partials, 10,240 of
//     staging); the keys kernel two pipelines of K and V (32 KB) and a ring
//     of two 33,792-byte stages: 201,728 bytes, and 10,336 static.
//   Registers, shared memory, CTAs per SM and waves at the main-path shapes:
//   chip_smoke.py phase 2 prints them; PERF.md keeps them and the times.
// - "fma": f32 inputs (the exact path that the f32 bars of 1e-4 hold) and
//   bf16 shapes outside the wgmma route (head_dim % 16 != 0, 224 < N <=
//   256).  256 threads; q, k, v and do upcast to f32 in shared memory,
//   products as f32 FMA.  attention_bwd_dq_kernel keeps [32, N] f32 score
//   and dp rows per 32-query tile (so N <= 256) and recomputes s and dp in
//   attention_bwd_dkv_kernel (32-key tiles).
//
// The tail keys past N get p = 0 and ds = 0, so they reach neither dbias
// nor dk/dv; the tail queries compute on zeros and are never stored.

#pragma once

#include <type_traits>

#include "attention_fwd.cuh"

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
  float* bias_tiles;   // wgmma route: the bias in the keys kernel's order (attention_bwd_bias_tiles_floats)
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
// The wgmma route (bf16): TMA loads, wgmma products.
// ---------------------------------------------------------------------------

constexpr int kBwdTileRows = 64;                     // a query tile (rows kernel), a key block (keys kernel)
constexpr int kBwdStatFloats = 3 * kBwdTileRows;     // a query tile's m, 1 / l and delta
constexpr uint32_t kBwdStatBytes = kBwdStatFloats * 4;
constexpr int kBwdCtaThreads = 384;                  // two consumer warpgroups and a producer warpgroup
// setmaxnreg: the producer warpgroup gives its registers to the consumers,
// the CTA's total staying the launch's 168 a thread.  The rows kernel's
// producer is one thread; the keys kernel's two (one a pipeline) need more.
constexpr int kBwdRowsProducerRegs = 24, kBwdRowsConsumerRegs = 240;
constexpr int kBwdKeysProducerRegs = 40, kBwdKeysConsumerRegs = 232;
constexpr int kBwdRing = 2;                          // the keys kernel's (q, do, statistics) stages
constexpr uint32_t kBwdKeysStageBytes = 2 * kQTileBytes + 1024;  // q, do, statistics, 1024-aligned
constexpr uint32_t kBwdPipeBytes = 2 * kQTileBytes + kBwdRing * kBwdKeysStageBytes;  // K, V, the ring
constexpr size_t kBwdKeysSmem = 2 * (size_t)kBwdPipeBytes + 1024;
constexpr float kLog2e = 1.4426950408889634f;        // e = 2^((x - m) log2 e)

// The route of a call; the caller has checked d % 8 == 0, d <= kBwdMaxHeadDim
// and 1 <= n <= kBwdMaxKeys.  The forward's wgmma route takes the same calls.
inline bool attention_bwd_route_wgmma(bool is_bf16, int n, int d) { return attention_fwd_route_wgmma(is_bf16, n, d); }

// The keys the rows kernel holds for a head of n tokens, split in two halves
// of a multiple of 16 (the depth of the dq product's steps).
inline int attention_bwd_keys(int n) { return n <= 64 ? 64 : (n <= 160 ? 160 : 224); }

__host__ __device__ inline int bwd_tiles(int n) { return (n + kBwdTileRows - 1) / kBwdTileRows; }

// The rows kernel at NK keys: K and V, each two regions of NK rows x 128
// bytes (columns 0-63, then 64-127), the tile's q and do (64 rows each), and
// the dq exchange (32 f32 a thread of each warpgroup, for the other).
template <int NK>
struct BwdRowsShape {
  static constexpr int kHalf = NK / 2;                 // keys of a consumer warpgroup
  static constexpr uint32_t kRegionBytes = NK * 128;
  static constexpr uint32_t kKBytes = 2 * kRegionBytes;
  static constexpr uint32_t kK = 0, kV = kKBytes, kQ = 2 * kKBytes, kDo = kQ + kQTileBytes, kX = kDo + kQTileBytes;
  static constexpr uint32_t kXBytes = 2 * 32 * 128 * 4;
  static constexpr size_t kSmem = (size_t)kX + kXBytes + 1024;
};

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// `bytes` (a multiple of 16) from global src into shared dst, completing
// bar's transaction count; both 16-byte aligned.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* ptr) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(ptr));
}

// The floats of the bias in the keys kernel's order
// (attention_bwd_bias_tiles_kernel).
__host__ __device__ inline size_t attention_bwd_bias_tiles_floats(int windows, int heads, int n) {
  return (size_t)windows * heads * bwd_tiles(n) * bwd_tiles(n) * 4096;
}

// The bias in the keys kernel's order, so that its threads read it in
// coalesced float4s rather than 32 scattered floats a tile: for each
// (window, head), key block kb and query tile t, in that order, 1024
// float4s; float4 v of consumer thread tid (warp tid / 32 of its warpgroup,
// lane 4 g + t4), at v * 128 + tid, holds the thread's values 4 v .. 4 v + 3
// in the order of its loop (8 kk + i): query 64 t + 16 kk + 8 (i / 4) + 2 t4
// + i % 2, key 64 kb + 16 (tid / 32) + g + 8 ((i / 2) % 2); 0 past n.  One
// read of the bias and one write of its tiles a call.
__global__ void __launch_bounds__(256)
    attention_bwd_bias_tiles_kernel(const float* bias, float4* out, int n, int tiles, long long total) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  const int tid = (int)(idx & 127), v = (int)((idx >> 7) & 7);
  const long long tile = idx >> 10;
  const int t = (int)(tile % tiles), kb = (int)(tile / tiles % tiles);
  const float* b = bias + tile / ((long long)tiles * tiles) * n * n;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float x[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int kk = (4 * v + c) >> 3, i = (4 * v + c) & 7;
    const int row = kBwdTileRows * t + 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1);
    const int key = kBwdTileRows * kb + 16 * (tid >> 5) + g + 8 * ((i >> 1) & 1);
    x[c] = row < n && key < n ? b[(size_t)row * n + key] : 0.0f;
  }
  out[idx] = make_float4(x[0], x[1], x[2], x[3]);
}

// The A fragment of a 16-deep step (the accumulator's 8 values x = acc + 8
// kk: columns 16 kk .. 16 kk + 15 of rows g and g + 8) as two bf16 parts: hi
// rounds the f32 values, lo rounds what hi leaves, so hi + lo carries ~16
// significant bits.  ds goes to the
// dq and dk products so: their sums cancel (ds sums to 0 over a row), and one
// bf16 rounding of ds put B1's backward on a train step's own tensors 3.6 %
// of its largest magnitude off (PERF.md).
__device__ __forceinline__ void split_bf16(uint32_t (&hi)[4], uint32_t (&lo)[4], const float* x) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack_bf16(x[2 * i] - __low2float(h), x[2 * i + 1] - __high2float(h));
  }
}

// The rows kernel's dq, whose two warpgroups each hold the sum over their
// half of the keys: the warpgroup that stores columns 2 kKeep .. 2 kKeep +
// 63 (its accumulator's values kKeep .. kKeep + 31) sends the other 32 values
// a thread through xbuf (f32; the other warpgroup's thread of the same
// index holds the same rows and columns), adds the 32 it receives in place
// and stores its columns < d of rows < n, times scale.  The two sums are
// added in one order (f32 addition commutes): the same bits in both.
template <int kKeep>
__device__ __forceinline__ void store_dq_half(float (&dq)[kBwdMaxHeadDim / 2], float* xbuf, __nv_bfloat16* stage,
                                              __nv_bfloat16* dqg, int ld, float scale, int row_lo, int n, int d) {
  constexpr int kSend = 32 - kKeep, kWg = kKeep / 32;
  const int tid = threadIdx.x & 127;
  float* out = xbuf + (1 - kWg) * 32 * 128 + tid;
#pragma unroll
  for (int i = 0; i < 32; ++i) out[i * 128] = dq[kSend + i];
  consumers_sync();
  const float* in = xbuf + kWg * 32 * 128 + tid;
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[kKeep + i] += in[i * 128];
#pragma unroll
  for (int q2 = 0; q2 < 2; ++q2) {
    const int col0 = 2 * kKeep + 32 * q2;
    if (col0 < d) store_warp_block(stage, dqg, ld, dq + kKeep + 16 * q2, scale, scale, row_lo, n, col0, d);
  }
}

// Work unit u of the rows kernel: query tile *t (fastest, so that the CTAs
// reading one head's K and V run together), window *w, head *h, batch chunk
// *bc.
__device__ __forceinline__ void bwd_rows_unit(const AttnBwdParams& p, int u, int* t, int* w, int* h, int* bc) {
  *t = u % p.tiles;
  u /= p.tiles;
  *h = u % p.heads;
  u /= p.heads;
  *w = u % p.windows;
  *bc = u / p.windows;
}

// A consumer warpgroup of attention_bwd_rows_kernel: keys [wg NK / 2, (wg +
// 1) NK / 2) of every unit the CTA walks.
template <int NK, bool kBias>
__device__ __forceinline__ void consume_bwd_rows(const AttnBwdParams& p, uint32_t base, float* xbuf,
                                                 uint64_t* qvd_full, uint64_t* k_full, uint64_t* qvd_empty,
                                                 uint64_t* k_empty, float (*row_x)[3][kBwdTileRows],
                                                 __nv_bfloat16* stage) {
  using Shape = BwdRowsShape<NK>;
  using bf16 = __nv_bfloat16;
  constexpr int kHalf = Shape::kHalf, kAcc = kHalf / 2, kSteps = kHalf / 16;
  constexpr bool kBiasRegs = kBias && NK <= 160;
  const int n = p.n, d = p.d;
  const float scale = p.scale;
  const int units = p.tiles * p.windows * p.heads * p.batch_chunks;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r_lo = 16 * warp + g, r_hi = r_lo + 8;  // the thread's rows of the tile
  const int key0 = wg * kHalf;
  const uint32_t q_s = base + Shape::kQ, do_s = base + Shape::kDo;
  const uint32_t k_s = base + Shape::kK + key0 * 128, v_s = base + Shape::kV + key0 * 128;
  int e = 0;  // batch entries walked: the barriers' phases
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int t, w, h, bc;
    bwd_rows_unit(p, u, &t, &w, &h, &bc);
    const int row_lo = t * kBwdTileRows + r_lo, row_hi = row_lo + 8;
    const float* bias = kBias ? p.bias + ((size_t)w * p.heads + h) * (size_t)n * n : nullptr;
    float db[kAcc];  // this chunk's dbias at the thread's (row, key) pairs
    zero_acc(db);
    // Every entry of the unit reads the same bias: at NK <= 160 it is read
    // once into registers (at 224 they would not hold it beside s, dp and
    // db; each entry reads it from L2 there).
    float bb[kBiasRegs ? kAcc : 1];
    if (kBiasRegs) {
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const float2 b_lo = bias_pair(bias, row_lo, key0 + 8 * j + 2 * t4, n);
        const float2 b_hi = bias_pair(bias, row_hi, key0 + 8 * j + 2 * t4, n);
        bb[4 * j] = b_lo.x;
        bb[4 * j + 1] = b_lo.y;
        bb[4 * j + 2] = b_hi.x;
        bb[4 * j + 3] = b_hi.y;
      }
    }
    const int b_end = min(p.batch, (bc + 1) * p.batch_per_block);
    for (int b = bc * p.batch_per_block; b < b_end; ++b, ++e) {
      const size_t grp = (size_t)b * p.windows + w, item = grp * p.heads + h;
      const uint32_t par = e & 1;
      // dp = do v^T, then s = q k^T, over this warpgroup's keys.
      mbar_wait(qvd_full, par);
      float dp[kAcc], s[kAcc];
      zero_acc(dp);
      zero_acc(s);
      fence_acc(dp);
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdMaxHeadDim / 16; ++kk) {
        if (16 * kk < d) {
          Wgmma<kHalf>::template ss<0, 0>(dp, sw128_desc(do_s + (kk >> 2) * kBoxBytes + 32 * (kk & 3), 16, 1024),
                                          sw128_desc(v_s + (kk >> 2) * Shape::kRegionBytes + 32 * (kk & 3), 16, 1024));
        }
      }
      wgmma_commit();
      mbar_wait(k_full, par);
#pragma unroll
      for (int kk = 0; kk < kBwdMaxHeadDim / 16; ++kk) {
        if (16 * kk < d) {
          Wgmma<kHalf>::template ss<0, 0>(s, sw128_desc(q_s + (kk >> 2) * kBoxBytes + 32 * (kk & 3), 16, 1024),
                                          sw128_desc(k_s + (kk >> 2) * Shape::kRegionBytes + 32 * (kk & 3), 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dp);
      fence_acc(s);
      mbar_arrive(qvd_empty);  // q, do and V are done with

      // x = s * scale + bias, -inf past n; the rows' max over both halves.
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int key = key0 + 8 * j + 2 * t4;
        float2 b_lo = make_float2(0.0f, 0.0f), b_hi = b_lo;
        if (kBiasRegs) {
          b_lo = make_float2(bb[4 * j], bb[4 * j + 1]);
          b_hi = make_float2(bb[4 * j + 2], bb[4 * j + 3]);
        } else if (kBias) {
          b_lo = bias_pair(bias, row_lo, key, n);
          b_hi = bias_pair(bias, row_hi, key, n);
        }
        s[4 * j] = key < n ? fmaf(s[4 * j], scale, b_lo.x) : -INFINITY;
        s[4 * j + 1] = key + 1 < n ? fmaf(s[4 * j + 1], scale, b_lo.y) : -INFINITY;
        s[4 * j + 2] = key < n ? fmaf(s[4 * j + 2], scale, b_hi.x) : -INFINITY;
        s[4 * j + 3] = key + 1 < n ? fmaf(s[4 * j + 3], scale, b_hi.y) : -INFINITY;
        m_lo = fmaxf(m_lo, fmaxf(s[4 * j], s[4 * j + 1]));
        m_hi = fmaxf(m_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
        m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
      }
      if (t4 == 0) {
        row_x[wg][0][r_lo] = m_lo;
        row_x[wg][0][r_hi] = m_hi;
      }
      consumers_sync();
      m_lo = fmaxf(row_x[0][0][r_lo], row_x[1][0][r_lo]);
      m_hi = fmaxf(row_x[0][0][r_hi], row_x[1][0][r_hi]);

      // e = 2^((x - m) log2 e) in place of x; l = rowsum(e), a = rowsum(e dp).
      float l_lo = 0.0f, l_hi = 0.0f, a_lo = 0.0f, a_hi = 0.0f;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float ex = exp2f((s[4 * j + i] - (i < 2 ? m_lo : m_hi)) * kLog2e);
          s[4 * j + i] = ex;
          if (i < 2) {
            l_lo += ex;
            a_lo = fmaf(ex, dp[4 * j + i], a_lo);
          } else {
            l_hi += ex;
            a_hi = fmaf(ex, dp[4 * j + i], a_hi);
          }
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
        a_lo += __shfl_xor_sync(0xffffffffu, a_lo, off);
        a_hi += __shfl_xor_sync(0xffffffffu, a_hi, off);
      }
      if (t4 == 0) {
        row_x[wg][1][r_lo] = l_lo;
        row_x[wg][1][r_hi] = l_hi;
        row_x[wg][2][r_lo] = a_lo;
        row_x[wg][2][r_hi] = a_hi;
      }
      consumers_sync();
      l_lo = row_x[0][1][r_lo] + row_x[1][1][r_lo];
      l_hi = row_x[0][1][r_hi] + row_x[1][1][r_hi];
      const float il_lo = __frcp_rn(l_lo), il_hi = __frcp_rn(l_hi);
      const float dl_lo = (row_x[0][2][r_lo] + row_x[1][2][r_lo]) * il_lo;
      const float dl_hi = (row_x[0][2][r_hi] + row_x[1][2][r_hi]) * il_hi;
      if (wg == 0 && t4 == 0) {
        float* st = p.row_m + (item * p.tiles + t) * kBwdStatFloats;
        st[r_lo] = m_lo;
        st[r_hi] = m_hi;
        st[kBwdTileRows + r_lo] = il_lo;
        st[kBwdTileRows + r_hi] = il_hi;
        st[2 * kBwdTileRows + r_lo] = dl_lo;
        st[2 * kBwdTileRows + r_hi] = dl_hi;
      }

      // ds = e / l * (dp - delta) into dbias, then as bf16 hi + lo A operands.
      uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        float* x = s + 8 * kk;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool hi = (i & 2) != 0;
          x[i] = x[i] * (hi ? il_hi : il_lo) * (dp[8 * kk + i] - (hi ? dl_hi : dl_lo));
          if (kBias) db[8 * kk + i] += x[i];
        }
        split_bf16(ah[kk], al[kk], x);
      }

      // dq = ds k over the 16-key steps that hold a key < n.
      float dq[kBwdMaxHeadDim / 2];
      zero_acc(dq);
      fence_regs(ah);
      fence_regs(al);
      fence_acc(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (key0 + 16 * kk < n) {
          const uint64_t kd = sw128_desc(k_s + 2048u * kk, Shape::kRegionBytes, 1024);
          Wgmma<kBwdMaxHeadDim>::template rs<1>(dq, ah[kk], kd);
          Wgmma<kBwdMaxHeadDim>::template rs<1>(dq, al[kk], kd);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(ah);
      fence_regs(al);
      fence_acc(dq);
      mbar_arrive(k_empty);

      // Warpgroup wg stores columns 64 wg .. 64 wg + 63 (its accumulator's
      // values 32 wg ..): it sends the other half of its dq to the other
      // warpgroup and adds what that one sends, in place.
      bf16* dqg = static_cast<bf16*>(p.dq) + grp * p.group_stride_grad + (size_t)h * p.head_stride_grad;
      if (wg == 0) {
        store_dq_half<0>(dq, xbuf, stage, dqg, p.row_stride_grad, scale, row_lo, n, d);
      } else {
        store_dq_half<32>(dq, xbuf, stage, dqg, p.row_stride_grad, scale, row_lo, n, d);
      }
    }
    if (kBias) {
      // This chunk's partial dbias at the thread's rows < n and keys < n.
      float* out = p.dbias + (((size_t)bc * p.windows + w) * p.heads + h) * (size_t)n * n;
#pragma unroll
      for (int j = 0; j < kHalf / 8; ++j) {
        const int key = key0 + 8 * j + 2 * t4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? row_lo : row_hi, kc = key + (i & 1);
          if (row < n && kc < n) out[(size_t)row * n + kc] = db[4 * j + i];
        }
      }
    }
  }
}

// One CTA per SM walks the units (bwd_rows_unit) blockIdx.x, blockIdx.x +
// gridDim.x, ...; kBias: the call has a bias and a dbias (B2, v1).  For each
// batch entry of a unit the producer warpgroup's first thread loads the
// tile's q and do and the head's V (qvd_full), then its K (k_full), by TMA;
// the consumers release q, do and V once s and dp are done (qvd_empty), and
// K once the dq product is (k_empty), so the next entry's loads run under
// this entry's softmax, dq product and stores.
template <int NK, bool kBias>
__global__ void __launch_bounds__(kBwdCtaThreads, 1)
    attention_bwd_rows_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                              const AttnBwdParams p) {
  using Shape = BwdRowsShape<NK>;
  extern __shared__ unsigned char bwd_smem[];
  __shared__ uint64_t qvd_full, k_full, qvd_empty, k_empty;
  __shared__ float row_x[2][3][kBwdTileRows];  // each consumer warpgroup's row max, sum and rowsum(e dp)
  __shared__ __align__(16) __nv_bfloat16 stage[8][kStageElems];  // each consumer warp's store staging
  const uint32_t raw = smem_u32(bwd_smem), base = (raw + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    mbar_init(&qvd_full, 1);
    mbar_init(&k_full, 1);
    mbar_init(&qvd_empty, 256);
    mbar_init(&k_empty, 256);
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdRowsProducerRegs));
    if (threadIdx.x != 256) return;
    const int units = p.tiles * p.windows * p.heads * p.batch_chunks;
    int e = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      int t, w, h, bc;
      bwd_rows_unit(p, u, &t, &w, &h, &bc);
      const int b_end = min(p.batch, (bc + 1) * p.batch_per_block);
      for (int b = bc * p.batch_per_block; b < b_end; ++b, ++e) {
        const int grp = b * p.windows + w, row0 = t * kBwdTileRows;
        if (e > 0) mbar_wait(&qvd_empty, (e - 1) & 1);
        mbar_expect_tx(&qvd_full, 2 * kQTileBytes + Shape::kKBytes);
        tma_load_4d(base + Shape::kQ, &q_map, &qvd_full, 0, h, row0, grp);
        tma_load_4d(base + Shape::kQ + kBoxBytes, &q_map, &qvd_full, 64, h, row0, grp);
        tma_load_4d(base + Shape::kDo, &do_map, &qvd_full, 0, h, row0, grp);
        tma_load_4d(base + Shape::kDo + kBoxBytes, &do_map, &qvd_full, 64, h, row0, grp);
        tma_load_4d(base + Shape::kV, &v_map, &qvd_full, 0, h, 0, grp);
        tma_load_4d(base + Shape::kV + Shape::kRegionBytes, &v_map, &qvd_full, 64, h, 0, grp);
        if (e > 0) mbar_wait(&k_empty, (e - 1) & 1);
        mbar_expect_tx(&k_full, Shape::kKBytes);
        tma_load_4d(base + Shape::kK, &k_map, &k_full, 0, h, 0, grp);
        tma_load_4d(base + Shape::kK + Shape::kRegionBytes, &k_map, &k_full, 64, h, 0, grp);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdRowsConsumerRegs));
    float* xbuf = reinterpret_cast<float*>(bwd_smem + (base - raw) + Shape::kX);
    consume_bwd_rows<NK, kBias>(p, base, xbuf, &qvd_full, &k_full, &qvd_empty, &k_empty, row_x,
                                stage[threadIdx.x >> 5]);
  }
}

// A consumer warpgroup of attention_bwd_keys_kernel: pipeline `pipe`'s units
// u = 2 blockIdx.x + pipe, + 2 gridDim.x, ...: (item u / tiles, key block u
// % tiles).
template <bool kBias>
__device__ __forceinline__ void consume_bwd_keys(const AttnBwdParams& p, uint32_t pipe_base,
                                                 const unsigned char* pipe_ptr, uint64_t* kv_full,
                                                 uint64_t* kv_empty, uint64_t* full, uint64_t* empty,
                                                 __nv_bfloat16* stage) {
  using bf16 = __nv_bfloat16;
  const int n = p.n, d = p.d, tiles = p.tiles;
  const float scale = p.scale;
  const int units = p.batch * p.windows * p.heads * tiles;
  const int pipe = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t k_s = pipe_base, v_s = pipe_base + kQTileBytes, ring = pipe_base + 2 * kQTileBytes;
  int it = 0, stage_i = 0;
  uint32_t phase = 0;
  for (int u = 2 * blockIdx.x + pipe; u < units; u += 2 * gridDim.x, ++it) {
    const int item = u / tiles, kb = u - item * tiles;
    const int grp = item / p.heads, h = item - grp * p.heads;
    const int key_lo = kb * kBwdTileRows + 16 * warp + g, key_hi = key_lo + 8;
    // This unit's bias tiles (attention_bwd_bias_tiles_kernel): tile t's 16 KB
    // at bias_tiles + t * 1024, thread tid's float4 v at v * 128 + tid.
    const float4* bias_tiles = kBias ? reinterpret_cast<const float4*>(p.bias_tiles) +
                                           (((size_t)(grp % p.windows) * p.heads + h) * tiles + kb) * tiles * 1024
                                     : nullptr;
    mbar_wait(kv_full, it & 1);
    float dk[kBwdMaxHeadDim / 2], dv[kBwdMaxHeadDim / 2];
    zero_acc(dk);
    zero_acc(dv);
    for (int t = 0; t < tiles; ++t) {
      const float4* bt = kBias ? bias_tiles + t * 1024 + (threadIdx.x & 127) : nullptr;
      if (kBias) prefetch_l1(bias_tiles + t * 1024 + 8 * (threadIdx.x & 127));  // the tile's 128 lines, one a thread
      mbar_wait(&full[stage_i], phase);
      const uint32_t q_s = ring + stage_i * kBwdKeysStageBytes, do_s = q_s + kQTileBytes;
      const float* st = reinterpret_cast<const float*>(pipe_ptr + 2 * kQTileBytes + stage_i * kBwdKeysStageBytes +
                                                       2 * kQTileBytes);
      // s^T = k q^T and dp^T = v do^T: thread (warp, g, t4) holds keys
      // key_lo and key_hi, queries 8j + 2 t4 (+ 1) of the tile.
      float sT[32], dpT[32];
      zero_acc(sT);
      zero_acc(dpT);
      fence_acc(sT);
      fence_acc(dpT);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdMaxHeadDim / 16; ++kk) {
        if (16 * kk < d) {
          const uint32_t at = (kk >> 2) * kBoxBytes + 32 * (kk & 3);
          Wgmma<64>::template ss<0, 0>(sT, sw128_desc(k_s + at, 16, 1024), sw128_desc(q_s + at, 16, 1024));
          Wgmma<64>::template ss<0, 0>(dpT, sw128_desc(v_s + at, 16, 1024), sw128_desc(do_s + at, 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sT);
      fence_acc(dpT);
      if (t == tiles - 1) mbar_arrive(kv_empty);  // the unit's K and V are done with

      // p^T = 2^((x - m) log2 e) * (1 / l) and ds^T = p^T (dp^T - delta), 0
      // at keys or queries past n; as A operands: p in bf16, ds as hi + lo.
      // Per 16-query step kk: its p^T and ds^T as A operands (p in bf16, ds
      // as hi + lo), then its dv += p^T do and dk += ds^T q products on the
      // steps that hold a query < n, issued while the next step's operands
      // are formed; one step's group stays in flight, so two steps'
      // fragments are live at a time.
      uint32_t frag[2][3][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b4[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
        if (kBias) {
          b4[0] = __ldg(bt + (2 * kk) * 128);
          b4[1] = __ldg(bt + (2 * kk + 1) * 128);
        }
        const float bv8[8] = {b4[0].x, b4[0].y, b4[0].z, b4[0].w, b4[1].x, b4[1].y, b4[1].z, b4[1].w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int key = (i & 2) ? key_hi : key_lo;
          const int qi = 16 * kk + 8 * (i >> 2) + 2 * t4 + (i & 1), row = t * kBwdTileRows + qi;
          const bool in = key < n && row < n;
          const float x = fmaf(sT[8 * kk + i], scale, bv8[i]);
          const float pv = in ? exp2f((x - st[qi]) * kLog2e) * st[kBwdTileRows + qi] : 0.0f;
          sT[8 * kk + i] = pv;
          dpT[8 * kk + i] = in ? pv * (dpT[8 * kk + i] - st[2 * kBwdTileRows + qi]) : 0.0f;
        }
        uint32_t(&fr)[3][4] = frag[kk & 1];
        const float* x = sT + 8 * kk;
        fr[0][0] = pack_bf16(x[0], x[1]);
        fr[0][1] = pack_bf16(x[2], x[3]);
        fr[0][2] = pack_bf16(x[4], x[5]);
        fr[0][3] = pack_bf16(x[6], x[7]);
        split_bf16(fr[1], fr[2], dpT + 8 * kk);
        fence_regs(fr);
        fence_acc(dv);
        fence_acc(dk);
        wgmma_fence();
        if (t * kBwdTileRows + 16 * kk < n) {
          Wgmma<kBwdMaxHeadDim>::template rs<1>(dv, fr[0], sw128_desc(do_s + 2048u * kk, kBoxBytes, 1024));
          const uint64_t qd = sw128_desc(q_s + 2048u * kk, kBoxBytes, 1024);
          Wgmma<kBwdMaxHeadDim>::template rs<1>(dk, fr[1], qd);
          Wgmma<kBwdMaxHeadDim>::template rs<1>(dk, fr[2], qd);
        }
        wgmma_commit();
        wgmma_wait<1>();  // step kk - 1's group is done: its fragments are free for step kk + 1
        fence_regs(frag[(kk + 1) & 1]);
      }
      wgmma_wait<0>();
      fence_regs(frag[0]);
      fence_regs(frag[1]);
      fence_acc(dv);
      fence_acc(dk);
      mbar_arrive(&empty[stage_i]);
      if (++stage_i == kBwdRing) {
        stage_i = 0;
        phase ^= 1u;
      }
    }

    // dk * scale and dv for the keys < n, the columns < d.
    const size_t grad_off = (size_t)grp * p.group_stride_grad + (size_t)h * p.head_stride_grad;
    bf16* dkg = static_cast<bf16*>(p.dk) + grad_off;
    bf16* dvg = static_cast<bf16*>(p.dv) + grad_off;
#pragma unroll
    for (int q4 = 0; q4 < kBwdMaxHeadDim / 32; ++q4) {
      if (32 * q4 < d) {
        store_warp_block(stage, dkg, p.row_stride_grad, dk + 16 * q4, scale, scale, key_lo, n, 32 * q4, d);
        store_warp_block(stage, dvg, p.row_stride_grad, dv + 16 * q4, 1.0f, 1.0f, key_lo, n, 32 * q4, d);
      }
    }
  }
}

// Two pipelines per CTA, one CTA per SM: consumer warpgroup w and producer
// warp w (lane 0 issues) walk units u = 2 blockIdx.x + w, + 2 gridDim.x, ...
// of (item, 64-key block), the key block fastest, so that the pipelines
// reading one item's q and do run together.  Per unit the producer loads the
// block's K and V (kv_full; released after the last tile's s^T and dp^T,
// kv_empty), then every query tile's q, do and statistics into the ring
// (full / empty per stage).  kBias: the call has a bias (B2, v1).
template <bool kBias>
__global__ void __launch_bounds__(kBwdCtaThreads, 1)
    attention_bwd_keys_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                              const AttnBwdParams p) {
  extern __shared__ unsigned char bwd_smem[];
  __shared__ uint64_t kv_full[2], kv_empty[2], full[2][kBwdRing], empty[2][kBwdRing];
  __shared__ __align__(16) __nv_bfloat16 stage[8][kStageElems];
  const uint32_t raw = smem_u32(bwd_smem), base = (raw + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int w = 0; w < 2; ++w) {
      mbar_init(&kv_full[w], 1);
      mbar_init(&kv_empty[w], 128);
      for (int s = 0; s < kBwdRing; ++s) {
        mbar_init(&full[w][s], 1);
        mbar_init(&empty[w][s], 128);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kBwdKeysProducerRegs));
    const int pipe = (threadIdx.x >> 5) & 3;
    if (pipe >= 2 || (threadIdx.x & 31) != 0) return;
    const uint32_t kv = base + pipe * kBwdPipeBytes, ring = kv + 2 * kQTileBytes;
    uint32_t loads = 0;  // tiles loaded: stage loads % kBwdRing, phase loads / kBwdRing
    int it = 0;
    for (int u = 2 * blockIdx.x + pipe; u < p.batch * p.windows * p.heads * p.tiles; u += 2 * gridDim.x, ++it) {
      const int item = u / p.tiles, row0 = (u - item * p.tiles) * kBwdTileRows;
      const int grp = item / p.heads, h = item - grp * p.heads;
      if (it > 0) mbar_wait(&kv_empty[pipe], (it - 1) & 1);
      mbar_expect_tx(&kv_full[pipe], 2 * kQTileBytes);
      tma_load_4d(kv, &k_map, &kv_full[pipe], 0, h, row0, grp);
      tma_load_4d(kv + kBoxBytes, &k_map, &kv_full[pipe], 64, h, row0, grp);
      tma_load_4d(kv + kQTileBytes, &v_map, &kv_full[pipe], 0, h, row0, grp);
      tma_load_4d(kv + kQTileBytes + kBoxBytes, &v_map, &kv_full[pipe], 64, h, row0, grp);
      const float* st = p.row_m + (size_t)item * p.tiles * kBwdStatFloats;
      for (int t = 0; t < p.tiles; ++t, ++loads) {
        const uint32_t stage = loads % kBwdRing;
        mbar_wait(&empty[pipe][stage], ((loads / kBwdRing) & 1) ^ 1u);
        uint64_t* bar = &full[pipe][stage];
        const uint32_t q_s = ring + stage * kBwdKeysStageBytes;
        mbar_expect_tx(bar, 2 * kQTileBytes + kBwdStatBytes);
        tma_load_4d(q_s, &q_map, bar, 0, h, t * kBwdTileRows, grp);
        tma_load_4d(q_s + kBoxBytes, &q_map, bar, 64, h, t * kBwdTileRows, grp);
        tma_load_4d(q_s + kQTileBytes, &do_map, bar, 0, h, t * kBwdTileRows, grp);
        tma_load_4d(q_s + kQTileBytes + kBoxBytes, &do_map, bar, 64, h, t * kBwdTileRows, grp);
        bulk_load(q_s + 2 * kQTileBytes, st + t * kBwdStatFloats, kBwdStatBytes, bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBwdKeysConsumerRegs));
    const uint32_t pipe_base = base + wg * kBwdPipeBytes;
    const unsigned char* pipe_ptr = bwd_smem + (pipe_base - raw);
    consume_bwd_keys<kBias>(p, pipe_base, pipe_ptr, &kv_full[wg], &kv_empty[wg], full[wg], empty[wg],
                            stage[threadIdx.x >> 5]);
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// Calls f(NK, kBias) with the call's keys (attention_bwd_keys) and whether
// it has a bias as compile-time constants (std::integral_constant).
template <class F>
auto with_bwd_rows_kernel(int n, bool with_bias, F&& f) {
  using std::integral_constant;
  switch (attention_bwd_keys(n) + with_bias) {
    case 64:
      return f(integral_constant<int, 64>(), std::false_type());
    case 65:
      return f(integral_constant<int, 64>(), std::true_type());
    case 160:
      return f(integral_constant<int, 160>(), std::false_type());
    case 161:
      return f(integral_constant<int, 160>(), std::true_type());
    case 224:
      return f(integral_constant<int, 224>(), std::false_type());
    default:
      return f(integral_constant<int, 224>(), std::true_type());
  }
}

// The wgmma route's persistent grids: the rows kernel's units (query tiles x
// windows x heads x batch chunks) over at most one CTA an SM, the keys
// kernel's (items x key blocks) over two pipelines a CTA.  out: rows CTAs,
// rows units, keys CTAs, keys units.
inline cudaError_t attention_bwd_grid(int n, int batch, int windows, int heads, int batch_per_block, int* out) {
  const int chunks = (batch + batch_per_block - 1) / batch_per_block;
  out[1] = bwd_tiles(n) * windows * heads * chunks;
  out[3] = batch * windows * heads * bwd_tiles(n);
  unsigned ctas = 0;
  cudaError_t err = persistent_ctas(out[1], 1, &ctas);
  out[0] = (int)ctas;
  if (err != cudaSuccess) return err;
  err = persistent_ctas((out[3] + 1) / 2, 1, &ctas);
  out[2] = (int)ctas;
  return err;
}

template <int NK, bool kBias>
cudaError_t launch_attention_bwd_wgmma(AttnBwdParams p, cudaStream_t stream) {
  using Shape = BwdRowsShape<NK>;
  p.tiles = bwd_tiles(p.n);
  const int groups = p.batch * p.windows;
  // q, do (boxes of 64 rows), k and v (64 rows for the keys kernel, NK for
  // the rows kernel).
  const void* bases[6] = {p.q, p.dout, p.k, p.v, p.k, p.v};
  CUtensorMap maps[6];
  for (int i = 0; i < 6; ++i) {
    AttnMapPlan plan;
    const bool dout = i == 1;
    if (!attention_map_plan(p.d, p.heads, p.n, groups, dout ? p.head_stride_dout : p.head_stride_in,
                            dout ? p.row_stride_dout : p.row_stride_in,
                            dout ? p.group_stride_dout : p.group_stride_in, i < 4 ? kBwdTileRows : NK, &plan)) {
      return cudaErrorMisalignedAddress;
    }
    const cudaError_t err = make_attention_map(&maps[i], bases[i], plan);
    if (err != cudaSuccess) return err;
  }
  int grid[4];
  cudaError_t err = attention_bwd_grid(p.n, p.batch, p.windows, p.heads, p.batch_per_block, grid);
  if (err != cudaSuccess) return err;
  auto rows = attention_bwd_rows_kernel<NK, kBias>;
  err = allow_smem(rows, Shape::kSmem);
  if (err != cudaSuccess) return err;
  rows<<<grid[0], kBwdCtaThreads, Shape::kSmem, stream>>>(maps[0], maps[1], maps[4], maps[5], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (kBias) {
    const long long total = (long long)attention_bwd_bias_tiles_floats(p.windows, p.heads, p.n) / 4;
    attention_bwd_bias_tiles_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        p.bias, reinterpret_cast<float4*>(p.bias_tiles), p.n, p.tiles, total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto keys = attention_bwd_keys_kernel<kBias>;
  err = allow_smem(keys, kBwdKeysSmem);
  if (err != cudaSuccess) return err;
  keys<<<grid[2], kBwdCtaThreads, kBwdKeysSmem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
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

// Dynamic shared memory the largest backward kernel of the call's route takes
// (a call with dbias has a bias).
inline size_t attention_bwd_smem_bytes(bool is_bf16, int n, int d, bool with_dbias) {
  if (attention_bwd_route_wgmma(is_bf16, n, d)) {
    const size_t rows =
        with_bwd_rows_kernel(n, with_dbias, [](auto nk, auto) { return BwdRowsShape<decltype(nk)::value>::kSmem; });
    return rows > kBwdKeysSmem ? rows : kBwdKeysSmem;
  }
  const size_t dq = attention_bwd_dq_smem_bytes(n, d, with_dbias);
  const size_t dkv = attention_bwd_dkv_smem_bytes(d);
  return dq > dkv ? dq : dkv;
}

// The route's rows (dq) and keys (dk/dv) kernels at (n, d): resident blocks
// per SM from the occupancy calculator (registers, shared memory, threads)
// in out[0] and out[1], dynamic shared memory per block in out[2] and out[3].
inline cudaError_t attention_bwd_occupancy(bool is_bf16, int n, int d, bool with_dbias, int* out) {
  cudaError_t err;
  if (attention_bwd_route_wgmma(is_bf16, n, d)) {
    out[3] = (int)kBwdKeysSmem;
    err = with_bwd_rows_kernel(n, with_dbias, [&](auto nk, auto bias) {
      out[2] = (int)BwdRowsShape<decltype(nk)::value>::kSmem;
      return blocks_per_sm(attention_bwd_rows_kernel<decltype(nk)::value, decltype(bias)::value>, kBwdCtaThreads,
                           out[2], &out[0]);
    });
    if (err != cudaSuccess) return err;
    return with_dbias ? blocks_per_sm(attention_bwd_keys_kernel<true>, kBwdCtaThreads, out[3], &out[1])
                      : blocks_per_sm(attention_bwd_keys_kernel<false>, kBwdCtaThreads, out[3], &out[1]);
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

// Launches the rows (dq) kernel, the keys (dk/dv) kernel and, when p.dbias
// holds more than one chunk, the dbias reduction into dbias_out, in that
// order on `stream`, on the route attention_bwd_route_wgmma picks.  The
// caller has checked the shapes (d % 8 == 0, d <= kBwdMaxHeadDim, 1 <= n <=
// kBwdMaxKeys) and sized the scratch: p.row_m holds 3 * items * round_up(n,
// 64) floats (the wgmma route's statistics, in tiles of 64 rows), and with a
// bias p.bias_tiles attention_bwd_bias_tiles_floats (the wgmma route's).
// A call with a bias makes one launch more on that route (its bias tiles).  The wgmma
// route reads by TMA and stores in 16-byte row segments: it takes 16-byte
// aligned q, k, v, dout, bias, dq, dk and dv with strides of whole 16-byte
// vectors, and returns cudaErrorMisalignedAddress, launching nothing, for
// others.
template <typename T>
cudaError_t launch_attention_bwd(AttnBwdParams p, float* dbias_out, cudaStream_t stream) {
  p.batch_chunks = (p.batch + p.batch_per_block - 1) / p.batch_per_block;
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (attention_bwd_route_wgmma(true, p.n, p.d)) {
      if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || !aligned16(p.dout) || !aligned16(p.bias) ||
          !aligned16(p.bias_tiles) || !aligned16(p.dq) || !aligned16(p.dk) || !aligned16(p.dv) ||
          (p.group_stride_in | p.head_stride_in | p.row_stride_in | p.group_stride_dout | p.head_stride_dout |
           p.row_stride_dout | p.group_stride_grad | p.head_stride_grad | p.row_stride_grad) % 8 != 0) {
        return cudaErrorMisalignedAddress;
      }
      err = with_bwd_rows_kernel(p.n, p.bias != nullptr, [&](auto nk, auto bias) {
        return launch_attention_bwd_wgmma<decltype(nk)::value, decltype(bias)::value>(p, stream);
      });
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
