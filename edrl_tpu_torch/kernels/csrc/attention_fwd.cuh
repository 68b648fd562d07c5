// Shared forward attention kernels for the entry points in this folder:
// self_attention_fwd.cu (B1), window_attention_v2_fwd.cu (B2, and the v1
// adapter over it) and the attention phase of attention_sublayer_fwd.cu (B6).
//
// Replaces the forwards of edrl_tpu/kernels/window_attention.py,
// _sa_fwd_kernel (self_attention_fused) and _attn_fwd_kernel_v2
// (window_attention_fused_v2).  For one (group, head):
//     o = softmax((q k^T) * scale + bias) v
// with the scores, the bias, the row max, exp and the row sum in f32, and o
// = (p v) / l written in the input type.
//
// Layout: q, k and v are read in place from their packed [.., N, row_stride]
// tensors (head h owns columns [h*D, (h+1)*D)), and o is written to
// [.., N, row_stride_out] at the same columns, so no transpose happens
// outside the kernel.  The tail keys past N are masked with -inf, and the
// tail queries past N are computed on zeros and never stored.
//
// Two routes, chosen per call from the dtype and shape before the launch
// (attention_fwd_route_mma; kernels/window_attention.py mirrors it as
// attention_fwd_route):
//
// - Tensor cores (attention_fwd_tc_kernel): bf16, head_dim % 16 == 0,
//   N <= 224, the calls the backward's tensor-core route takes; every
//   main-path call (N = 144 and 216, head_dim 128).
//
//   What bounds it on the H100: the bytes.  At the main-path shapes a call
//   reads q, k and v once and writes o once (B1 at [32, 216, 768]: 42 MB,
//   13 us at 3.35 TB/s, against 4.6 GFLOP, 5 us at the bf16 peak; B2 at the
//   Swin stage 0 of a batch-32 step: 302 MB of qkv and o plus a 5.3 MB f32
//   bias that the 32 batch entries read from L2, 90 us, against 21.7 GFLOP,
//   22 us),
//   so the tensor cores' rate is not the limit; how much latency each block
//   hides is.  The first design staged the whole K, then the whole V, with
//   plain loads between its two products, kept a [16, N] f32 score row in
//   registers (2 blocks of 4 warps per SM), read the bias by scalar loads
//   inside the softmax and computed 64-row query tiles (33% padding at
//   N = 144).  This one:
//   * streams the keys in chunks of 16 through a ring of three
//     shared-memory stages that cp.async fills two chunks ahead: a chunk's
//     keys, values and the f32 bias rows of the block's queries at its keys
//     (16-byte copies where N % 4 == 0) are in flight while the chunks
//     before it are computed;
//   * takes the softmax online: a running f32 row max and row sum, the o
//     accumulators rescaled when the max rises, p = 2^(x log2 e - m log2 e)
//     (one FMA), so no score row is kept and a warp's registers hold its
//     q fragments (loaded once by ldmatrix), o, and one chunk's scores;
//   * sizes the query tiles to N (attention_fwd_warps: 16 rows a warp, the
//     least padding in 16-row steps, up to kFwdMaxWarps warps a block);
//     the blocks of one (group, head) re-read its keys from L2;
//   * reads every fragment with ldmatrix (x4 for q and k, x4.trans for v)
//     and skips the 16-key steps that lie wholly past N.
//   p is rounded to bf16 where it enters the value product as an A operand
//   (as the JAX path rounds it before its value product); l sums the f32 p.
//   Registers, shared memory and blocks per SM at the main-path shapes:
//   chip_smoke.py phase 2 prints them, PERF.md keeps them.
// - CUDA cores (attention_fwd_kernel): f32 inputs (the exact path used to
//   compare with the CPU reference at f32 tolerances) and bf16 shapes
//   outside the tensor-core route.  256 threads; q, k and v upcast to f32,
//   q scaled first, products as f32 FMA.  Shared memory holds the scaled
//   query tile transposed, the whole f32 score tile and one chunk of 32 keys
//   or values.

#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;                 // query rows per warp lane
constexpr int kTileQ = kWarps * kRowsPerThread;   // 64 query rows per block
constexpr int kQLd = kTileQ + 1;                  // padded: conflict-free transposed stores
constexpr int kKeyChunk = 32;                     // keys per chunk, one per lane
constexpr int kMaxHeadDim = 128;
constexpr int kColsPerLane = kMaxHeadDim / 32;    // output columns per lane

struct AttnParams {
  const void* q;  // element (group 0, token 0, column 0) of each operand
  const void* k;
  const void* v;
  void* o;
  const float* bias;           // [windows, heads, n, n] f32, or nullptr
  long long group_stride_in;   // elements between consecutive groups in q/k/v
  long long group_stride_out;  // elements between consecutive groups in o
  int row_stride_in;           // elements between consecutive tokens in q/k/v
  int row_stride_out;          // elements between consecutive tokens in o
  int num_groups;              // batch (self-attention) or batch * windows
  int windows;                 // group g reads bias window g % windows
  int heads;
  int n;
  int d;
  int n_pad;                   // n rounded up to kKeyChunk (CUDA-core route)
  int q_tiles;                 // query tiles per (group, head)
  float scale;
};

inline size_t attention_smem_bytes(int n, int d) {
  const int n_pad = round_up(n, kKeyChunk);
  return sizeof(float) *
         ((size_t)d * kQLd + (size_t)kTileQ * n_pad + (size_t)kKeyChunk * (d + 1));
}

// Copies keys or values [k0, k0 + kKeyChunk) of one head into the chunk
// buffer as f32; rows past n are zero so that 0 * row stays 0.
template <typename T>
__device__ __forceinline__ void load_chunk(float* chunk, const T* src, int k0,
                                           const AttnParams& p) {
  const int d = p.d;
  for (int i = threadIdx.x; i < kKeyChunk * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int key = k0 + r;
    chunk[r * (d + 1) + c] =
        key < p.n ? to_f32(src[(size_t)key * p.row_stride_in + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(AttnParams p) {
  extern __shared__ float smem[];
  __shared__ float row_sum[kTileQ];

  const int d = p.d;
  const int n = p.n;
  const int n_pad = p.n_pad;
  float* q_t = smem;                   // [d][kQLd]
  float* s = q_t + (size_t)d * kQLd;   // [kTileQ][n_pad]
  float* chunk = s + (size_t)kTileQ * n_pad;  // [kKeyChunk][d + 1]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x % p.q_tiles;
  const int g = blockIdx.x / p.q_tiles;
  const int h = blockIdx.y;
  const int q0 = tile * kTileQ;

  const size_t in_off = (size_t)g * p.group_stride_in + (size_t)h * d;
  const T* qg = static_cast<const T*>(p.q) + in_off;
  const T* kg = static_cast<const T*>(p.k) + in_off;
  const T* vg = static_cast<const T*>(p.v) + in_off;
  T* og = static_cast<T*>(p.o) + (size_t)g * p.group_stride_out + (size_t)h * d;
  const float* bias =
      p.bias ? p.bias + ((size_t)(g % p.windows) * p.heads + h) * (size_t)n * n : nullptr;

  // 1. Scaled query tile, transposed; tail rows are zero.
  for (int i = threadIdx.x; i < kTileQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int row = q0 + r;
    q_t[c * kQLd + r] =
        row < n ? to_f32(qg[(size_t)row * p.row_stride_in + c]) * p.scale : 0.0f;
  }

  // 2. Scores: lane = key within the chunk, warp = 8 query rows.
  const int r0 = warp * kRowsPerThread;
  for (int k0 = 0; k0 < n_pad; k0 += kKeyChunk) {
    __syncthreads();  // q_t is written / the previous chunk is consumed
    load_chunk(chunk, kg, k0, p);
    __syncthreads();
    float acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.0f;
    const float* krow = chunk + lane * (d + 1);
    for (int c = 0; c < d; ++c) {
      const float kv = krow[c];
      const float* qc = q_t + c * kQLd + r0;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[j] = fmaf(qc[j], kv, acc[j]);
    }
    const int key = k0 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
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
  }
  __syncthreads();

  // 3. Row softmax numerators in place; each warp owns its 8 rows.
  for (int j = 0; j < kRowsPerThread; ++j) {
    float* srow = s + (r0 + j) * n_pad;
    float m = -INFINITY;
    for (int c = lane; c < n_pad; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < n_pad; c += 32) {
      const float e = expf(srow[c] - m);
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) row_sum[r0 + j] = l;
  }

  // 4. o = p v: lane = output columns lane + 32 * cc, warp = 8 query rows.
  float o[kRowsPerThread][kColsPerLane];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
#pragma unroll
    for (int cc = 0; cc < kColsPerLane; ++cc) o[j][cc] = 0.0f;
  for (int k0 = 0; k0 < n_pad; k0 += kKeyChunk) {
    __syncthreads();  // scores are final / the previous chunk is consumed
    load_chunk(chunk, vg, k0, p);
    __syncthreads();
    for (int kk = 0; kk < kKeyChunk; ++kk) {
      float vv[kColsPerLane];
#pragma unroll
      for (int cc = 0; cc < kColsPerLane; ++cc) {
        const int c = lane + 32 * cc;
        vv[cc] = c < d ? chunk[kk * (d + 1) + c] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const float pj = s[(r0 + j) * n_pad + k0 + kk];
#pragma unroll
        for (int cc = 0; cc < kColsPerLane; ++cc) o[j][cc] = fmaf(pj, vv[cc], o[j][cc]);
      }
    }
  }

  // 5. Normalise and store the rows that exist.
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int row = q0 + r0 + j;
    if (row >= n) continue;
    const float l = row_sum[r0 + j];
    T* orow = og + (size_t)row * p.row_stride_out;
#pragma unroll
    for (int cc = 0; cc < kColsPerLane; ++cc) {
      const int c = lane + 32 * cc;
      if (c < d) orow[c] = from_f32<T>(o[j][cc] / l);
    }
  }
}

template <typename T>
cudaError_t launch_attention_fwd_simt(AttnParams p, cudaStream_t stream) {
  p.n_pad = round_up(p.n, kKeyChunk);
  p.q_tiles = (p.n + kTileQ - 1) / kTileQ;
  const size_t smem = attention_smem_bytes(p.n, p.d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)p.num_groups * (unsigned)p.q_tiles, (unsigned)p.heads);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16).
// ---------------------------------------------------------------------------

constexpr int kFwdMaxKeys = 224;                  // the backward's tensor-core route takes the same calls
constexpr int kFwdMaxWarps = 8;                   // query warps of a block, 16 rows each
constexpr int kFwdChunk = 16;                     // keys per staged chunk
constexpr int kFwdStages = 3;                     // the ring of staged chunks, two ahead of the products
constexpr int kFwdKSteps = kMaxHeadDim / 16;      // 16-deep steps over the head dim
constexpr int kFwdBiasLd = kFwdChunk + 8;         // f32 stride of staged bias rows: conflict-free float2 reads
constexpr float kFwdLog2e = 1.4426950408889634f;  // p = 2^(x log2 e - m log2 e)

// The route of a call; the caller has checked d % 8 == 0 and d <= kMaxHeadDim.
inline bool attention_fwd_route_mma(bool is_bf16, int n, int d) {
  return is_bf16 && d % 16 == 0 && n <= kFwdMaxKeys;
}

// Query warps per block at n: of the ways to cut n's 16-row steps into
// tiles of at most kFwdMaxWarps warps, the one with the fewest padding
// steps, then the fewest tiles (N = 144: 3 tiles of 3 warps; N = 216: 2 of 7).
inline int attention_fwd_warps(int n) {
  const int steps = (n + 15) / 16;
  int best = kFwdMaxWarps, best_pad = 1 << 30;
  for (int tiles = (steps + kFwdMaxWarps - 1) / kFwdMaxWarps; tiles <= steps; ++tiles) {
    const int warps = (steps + tiles - 1) / tiles;
    if (tiles * warps - steps < best_pad) {
      best_pad = tiles * warps - steps;
      best = warps;
    }
  }
  return best;
}

// Bytes of one ring stage: keys and values [kFwdChunk][kAttnLd] bf16, then
// with a bias the block's [rows][kFwdBiasLd] f32 bias rows.
__host__ __device__ inline int fwd_stage_bytes(int rows, bool with_bias) {
  return 2 * kFwdChunk * kAttnLd * 2 + (with_bias ? rows * kFwdBiasLd * 4 : 0);
}

// The ring, with the block's query rows staged over stage 1 onwards before
// the first chunk's products (the warps then hold them in registers).
inline size_t attention_fwd_mma_smem_bytes(int n, bool with_bias) {
  const int rows = 16 * attention_fwd_warps(n);
  const size_t stage = fwd_stage_bytes(rows, with_bias);
  const size_t ring = kFwdStages * stage;
  const size_t with_q = stage + (size_t)rows * kAttnLd * 2;
  return ring > with_q ? ring : with_q;
}

// One block per (query tile, group, head), 16 query rows a warp; blockDim.x
// = 32 * attention_fwd_warps(n).  A warp keeps its q rows as A fragments
// and its o rows as f32 accumulators in registers, and walks the keys in
// chunks of kFwdChunk, each staged by cp.async kFwdStages - 1 chunks ahead:
//   s = q k^T (mma.sync), x = s * scale + bias (-inf past n);
//   m' = max(m, rowmax(x)), o and l scaled by 2^((m - m') log2 e);
//   p = 2^(x log2 e - m' log2 e), l += rowsum(p), o += bf16(p) v (mma.sync);
// then o / l for the rows that exist.
__global__ void __launch_bounds__(kFwdMaxWarps * 32) attention_fwd_tc_kernel(AttnParams p) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d;
  const int n = p.n;
  const int threads = blockDim.x;
  const int rows = threads / 2;  // 16 per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and B column) of this lane
  const int t = lane & 3;   // fragment column pair of this lane
  const int tile = blockIdx.x % p.q_tiles;
  const int grp = blockIdx.x / p.q_tiles;
  const int h = blockIdx.y;
  const int q0 = tile * rows;
  const int r0 = warp * 16;
  const bool live = q0 + r0 < n;  // the warp owns a query row
  const int chunks = (n + kFwdChunk - 1) / kFwdChunk;
  const bool with_bias = p.bias != nullptr;
  const int stage_bytes = fwd_stage_bytes(rows, with_bias);

  const size_t in_off = (size_t)grp * p.group_stride_in + (size_t)h * d;
  const bf16* qg = static_cast<const bf16*>(p.q) + in_off;
  const bf16* kg = static_cast<const bf16*>(p.k) + in_off;
  const bf16* vg = static_cast<const bf16*>(p.v) + in_off;
  bf16* og = static_cast<bf16*>(p.o) + (size_t)grp * p.group_stride_out + (size_t)h * d;
  const float* bias =
      with_bias ? p.bias + ((size_t)(grp % p.windows) * p.heads + h) * (size_t)n * n : nullptr;

  // Rows [row0, row0 + count) of the head's q, or of its k and v, into
  // shared rows of stride kAttnLd by 16-byte cp.async; rows past n are zero.
  // Thread i copies column (i % 16) * 8 of rows i / 16, i / 16 + threads / 16, ...
  const int col = (threadIdx.x & 15) * 8;
  const int row_step = threads >> 4;
  auto stage_rows = [&](bf16* dst, bf16* dst2, const bf16* src, const bf16* src2, int row0, int count) {
    if (col >= d) return;
    int r = threadIdx.x >> 4;
    size_t off = (size_t)(row0 + r) * p.row_stride_in + col;
    const size_t off_step = (size_t)row_step * p.row_stride_in;
    for (int at = r * kAttnLd + col; r < count; r += row_step, at += row_step * kAttnLd, off += off_step) {
      const bool valid = row0 + r < n;
      cp_async16(dst + at, src + (valid ? off : 0), valid);
      if (dst2 != nullptr) cp_async16(dst2 + at, src2 + (valid ? off : 0), valid);
    }
  };
  // Chunk j (its keys, values and bias columns) into stage j % kFwdStages.
  auto stage_chunk = [&](int j) {
    if (j >= chunks) return;
    bf16* ks = reinterpret_cast<bf16*>(smem_raw + (j % kFwdStages) * stage_bytes);
    const int k0 = j * kFwdChunk;
    stage_rows(ks, ks + kFwdChunk * kAttnLd, kg, vg, k0, kFwdChunk);
    if (!with_bias) return;
    float* bs = reinterpret_cast<float*>(ks + 2 * kFwdChunk * kAttnLd);
    if ((n & 3) == 0) {  // bias rows start 16-byte aligned: kFwdChunk / 4 vectors per row
      constexpr int kVecs = kFwdChunk / 4;
      const int c = threadIdx.x % kVecs * 4;
      const bool key_ok = k0 + c < n;
      for (int r = threadIdx.x / kVecs; r < rows; r += threads / kVecs) {
        const bool valid = key_ok && q0 + r < n;
        cp_async16(bs + r * kFwdBiasLd + c, bias + (valid ? (size_t)(q0 + r) * n + k0 + c : 0), valid);
      }
    } else {
      for (int i = threadIdx.x; i < rows * kFwdChunk; i += threads) {
        const int r = i / kFwdChunk;
        const int c = i % kFwdChunk;
        const bool valid = q0 + r < n && k0 + c < n;
        cp_async4(bs + r * kFwdBiasLd + c, bias + (valid ? (size_t)(q0 + r) * n + k0 + c : 0), valid);
      }
    }
  };

  // The tile's q rows over stage 1 onwards and chunk 0 into stage 0; q into
  // the warps' A fragments; then the rest of the ring's first chunks.
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw + stage_bytes);
  stage_rows(q_s, nullptr, qg, nullptr, q0, rows);
  stage_chunk(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[kFwdKSteps][4];
  if (live) {
#pragma unroll
    for (int kk = 0; kk < kFwdKSteps; ++kk) {
      if (16 * kk < d) frag_a(qa[kk], q_s, r0, 16 * kk);
    }
  }
  __syncthreads();  // q is read: its stages take the next chunks
  for (int j = 1; j < kFwdStages - 1; ++j) {
    stage_chunk(j);
    cp_async_commit();
  }

  float o[kMaxHeadDim / 8][4];
#pragma unroll
  for (int j = 0; j < kMaxHeadDim / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.0f, l_hi = 0.0f;
  const float scale = p.scale;

  for (int c = 0; c < chunks; ++c) {
    // Chunk c has landed; every warp is past chunk c - 1 (and q), so its
    // stage takes chunk c + kFwdStages - 1.
    cp_async_wait<kFwdStages - 2>();
    __syncthreads();
    stage_chunk(c + kFwdStages - 1);
    cp_async_commit();
    if (!live) continue;
    const bf16* ks = reinterpret_cast<const bf16*>(smem_raw + (c % kFwdStages) * stage_bytes);
    const bf16* vs = ks + kFwdChunk * kAttnLd;
    const float* bs = reinterpret_cast<const float*>(vs + kFwdChunk * kAttnLd);
    const int k0 = c * kFwdChunk;

    // s = q k^T: lane (g, t) holds rows g and g + 8, keys k0 + 8jj + 2t (+ 1).
    float x[kFwdChunk / 8][4];
#pragma unroll
    for (int jj = 0; jj < kFwdChunk / 8; ++jj) x[jj][0] = x[jj][1] = x[jj][2] = x[jj][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kFwdKSteps; ++kk) {
      if (16 * kk < d) {
#pragma unroll
        for (int half = 0; half < kFwdChunk / 16; ++half) {
          if (k0 + 16 * half < n) {
            uint32_t b[4];
            frag_b_nk(b, ks, 16 * half, 16 * kk);
            mma_bf16_16816(x[2 * half], qa[kk], b[0], b[1]);
            mma_bf16_16816(x[2 * half + 1], qa[kk], b[2], b[3]);
          }
        }
      }
    }

    // x = s * scale + bias, -inf past n (the last chunk only).
#pragma unroll
    for (int jj = 0; jj < kFwdChunk / 8; ++jj) {
      float2 b_lo = make_float2(0.0f, 0.0f), b_hi = b_lo;
      if (with_bias) {
        b_lo = *reinterpret_cast<const float2*>(bs + (r0 + g) * kFwdBiasLd + 8 * jj + 2 * t);
        b_hi = *reinterpret_cast<const float2*>(bs + (r0 + g + 8) * kFwdBiasLd + 8 * jj + 2 * t);
      }
      x[jj][0] = fmaf(x[jj][0], scale, b_lo.x);
      x[jj][1] = fmaf(x[jj][1], scale, b_lo.y);
      x[jj][2] = fmaf(x[jj][2], scale, b_hi.x);
      x[jj][3] = fmaf(x[jj][3], scale, b_hi.y);
    }
    if (k0 + kFwdChunk > n) {
#pragma unroll
      for (int jj = 0; jj < kFwdChunk / 8; ++jj) {
        const int key = k0 + 8 * jj + 2 * t;
        if (key >= n) x[jj][0] = x[jj][2] = -INFINITY;
        if (key + 1 >= n) x[jj][1] = x[jj][3] = -INFINITY;
      }
    }
    // The rows' new max over the quad.
    float cm_lo = m_lo, cm_hi = m_hi;
#pragma unroll
    for (int jj = 0; jj < kFwdChunk / 8; ++jj) {
      cm_lo = fmaxf(cm_lo, fmaxf(x[jj][0], x[jj][1]));
      cm_hi = fmaxf(cm_hi, fmaxf(x[jj][2], x[jj][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cm_lo = fmaxf(cm_lo, __shfl_xor_sync(0xffffffffu, cm_lo, off));
      cm_hi = fmaxf(cm_hi, __shfl_xor_sync(0xffffffffu, cm_hi, off));
    }
    // Rescale l and o to the new max where it rose (o and l are 0 before
    // chunk 0, whose max is finite: key 0 is in it).
    if (c > 0 && __any_sync(0xffffffffu, cm_lo != m_lo || cm_hi != m_hi)) {
      const float r_lo = exp2f((m_lo - cm_lo) * kFwdLog2e);
      const float r_hi = exp2f((m_hi - cm_hi) * kFwdLog2e);
      l_lo *= r_lo;
      l_hi *= r_hi;
#pragma unroll
      for (int j = 0; j < kMaxHeadDim / 8; ++j) {
        o[j][0] *= r_lo;
        o[j][1] *= r_lo;
        o[j][2] *= r_hi;
        o[j][3] *= r_hi;
      }
    }
    m_lo = cm_lo;
    m_hi = cm_hi;
    const float ml_lo = cm_lo * kFwdLog2e;
    const float ml_hi = cm_hi * kFwdLog2e;
#pragma unroll
    for (int jj = 0; jj < kFwdChunk / 8; ++jj) {
      x[jj][0] = exp2f(fmaf(x[jj][0], kFwdLog2e, -ml_lo));
      x[jj][1] = exp2f(fmaf(x[jj][1], kFwdLog2e, -ml_lo));
      x[jj][2] = exp2f(fmaf(x[jj][2], kFwdLog2e, -ml_hi));
      x[jj][3] = exp2f(fmaf(x[jj][3], kFwdLog2e, -ml_hi));
      l_lo += x[jj][0] + x[jj][1];
      l_hi += x[jj][2] + x[jj][3];
    }

    // o += p v, p rounded to bf16 as the value product's A operand.
#pragma unroll
    for (int ks16 = 0; ks16 < kFwdChunk / 16; ++ks16) {
      if (k0 + 16 * ks16 < n) {
        uint32_t pa[4];
        frag_a_from_c(pa, x[2 * ks16], x[2 * ks16 + 1]);
#pragma unroll
        for (int dn = 0; dn < kFwdKSteps; ++dn) {
          if (16 * dn < d) {
            uint32_t vb[4];
            frag_b_kn(vb, vs, 16 * ks16, 16 * dn);
            mma_bf16_16816(o[2 * dn], pa, vb[0], vb[1]);
            mma_bf16_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
          }
        }
      }
    }
  }
  if (!live) return;

  // Normalise and store the rows that exist.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float il_lo = 1.0f / l_lo;
  const float il_hi = 1.0f / l_hi;
  const int row_lo = q0 + r0 + g;
  const int row_hi = row_lo + 8;
#pragma unroll
  for (int j = 0; j < kMaxHeadDim / 8; ++j) {
    if (8 * j < d) {
      const int c = 8 * j + 2 * t;
      if (row_lo < n) {
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_lo * p.row_stride_out + c) =
            __floats2bfloat162_rn(o[j][0] * il_lo, o[j][1] * il_lo);
      }
      if (row_hi < n) {
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_hi * p.row_stride_out + c) =
            __floats2bfloat162_rn(o[j][2] * il_hi, o[j][3] * il_hi);
      }
    }
  }
}

inline cudaError_t launch_attention_fwd_mma(AttnParams p, cudaStream_t stream) {
  const int warps = attention_fwd_warps(p.n);
  p.q_tiles = ((p.n + 15) / 16 + warps - 1) / warps;
  const size_t smem = attention_fwd_mma_smem_bytes(p.n, p.bias != nullptr);
  cudaError_t err = allow_smem(attention_fwd_tc_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.num_groups * (unsigned)p.q_tiles, (unsigned)p.heads);
  attention_fwd_tc_kernel<<<grid, 32 * warps, smem, stream>>>(p);
  return cudaGetLastError();
}

// Dynamic shared memory a block of the call's route takes.
inline size_t attention_fwd_smem_bytes(bool is_bf16, int n, int d, bool with_bias) {
  return attention_fwd_route_mma(is_bf16, n, d) ? attention_fwd_mma_smem_bytes(n, with_bias)
                                                : attention_smem_bytes(n, d);
}

// The route's kernel at (n, d): resident blocks per SM from the occupancy
// calculator in out[0], dynamic shared memory per block in out[1], warps per
// block in out[2].
inline cudaError_t attention_fwd_occupancy(bool is_bf16, int n, int d, bool with_bias, int* out) {
  out[1] = (int)attention_fwd_smem_bytes(is_bf16, n, d, with_bias);
  if (attention_fwd_route_mma(is_bf16, n, d)) {
    out[2] = attention_fwd_warps(n);
    return blocks_per_sm(attention_fwd_tc_kernel, 32 * out[2], out[1], &out[0]);
  }
  out[2] = kWarps;
  return is_bf16 ? blocks_per_sm(attention_fwd_kernel<__nv_bfloat16>, kThreads, out[1], &out[0])
                 : blocks_per_sm(attention_fwd_kernel<float>, kThreads, out[1], &out[0]);
}

// Launches the kernel of the route attention_fwd_route_mma picks on `stream`
// and returns cudaGetLastError(); the caller has checked the shapes (d % 8
// == 0, d <= kMaxHeadDim, shared memory within the limit).  The tensor-core
// route stages rows by 16-byte copies: it takes 16-byte aligned q, k, v and
// bias with row strides of whole 16-byte vectors and a 4-byte aligned o, and
// returns cudaErrorMisalignedAddress, launching nothing, for others.
template <typename T>
cudaError_t launch_attention_fwd(AttnParams p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (attention_fwd_route_mma(true, p.n, p.d)) {
      if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || (p.bias && !aligned16(p.bias)) ||
          !aligned4(p.o) || p.row_stride_in % 8 != 0 || p.row_stride_out % 2 != 0) {
        return cudaErrorMisalignedAddress;
      }
      return launch_attention_fwd_mma(p, stream);
    }
  }
  return launch_attention_fwd_simt<T>(p, stream);
}

}  // namespace
