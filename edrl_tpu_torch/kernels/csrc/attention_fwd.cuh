// Shared forward attention kernels for the entry points in this folder:
// self_attention_fwd.cu (B1), window_attention_v2_fwd.cu (B2 and v1) and
// the attention phase of attention_sublayer_fwd.cu (B6).
//
// Replaces the forwards of edrl_tpu/kernels/window_attention.py,
// _sa_fwd_kernel (self_attention_fused) and _attn_fwd_kernel_v2
// (window_attention_fused_v2).  For one (group, head):
//     o = softmax((q k^T) * scale + bias) v
// with the scores, the bias, the row max, exp and the row sum in f32, and o
// = (p v) / l written in the input type.
//
// Layout: q, k and v are read in place through three strides each, one
// between groups, one between heads and one between tokens, and o is written
// through its own three: in the packed [.., N, row_stride] tensors of B1, B2
// and B6 head h owns columns [h*D, (h+1)*D) (head stride D); in v1's [B, W,
// H, N, D] a head is a block of N rows (head stride N*D, row stride D).  So
// no transpose happens outside the kernel.
//
// Two routes, chosen per call from the dtype and shape before the launch
// (attention_fwd_route_wgmma; kernels/window_attention.py mirrors it as
// attention_fwd_route):
//
// - "wgmma" (attention_fwd_wgmma_kernel): bf16, head_dim % 16 == 0, N <=
//   224, the calls the backward's tensor-core route takes; every main-path
//   call (N = 144 and 216, head_dim 128).
//
//   What bounds it on the H100: the bytes.  A call reads q, k and v once and
//   writes o once (B1 at [32, 216, 768]: 42 MB, 12.7 us at 3.35 TB/s,
//   against 4.6 GFLOP, 4.6 us at the bf16 peak; B2 at the Swin stage 0 of a
//   batch-32 step: 302 MB of qkv and o plus a 5.3 MB f32 bias that the 32
//   batch entries read from L2, 92 us, against 21.7 GFLOP, 22 us).  The
//   route before this one (mma.sync on 16-row warp tiles, a cp.async ring of
//   16-key chunks) reached 17 % (B1) and 30 % (B2) of that bound: every
//   query tile's block re-read the head's K and V from L2, and each 16-key
//   step waited on its copy and a barrier for two tiny products a warp.
//
//   This design:
//   * one CTA per SM walks (group, head) items (a persistent grid): a
//     producer warpgroup, one thread of which issues every load by TMA, and
//     consumer warpgroups that each own one 64-row query tile at a time (3
//     at N <= 144, a tile each; 2 at N <= 224, two tiles each; a warpgroup
//     left without a tile, at N <= 128 or in a half-item, still waits for
//     the item's K and V before it releases them).  The
//     producer gives its registers to the consumers (setmaxnreg): the
//     launch's registers are capped by the warps an SM sub-partition holds
//     (16 warps: 128 a thread; 12: 168), the whole score row needs more;
//   * the head's whole K and V are resident in shared memory, loaded once
//     per item: keys padded to NK = 64, 144 or 224 (attention_fwd_keys), in
//     two 128-byte-swizzled regions of NK rows x 64 columns each.  At NK <=
//     144 two K/V buffers let the next item's load run under this item's
//     products; at 224 one (112 KB) fits;
//   * every operand is read through a 4-D tensor map over (column, head,
//     token, group) with the call's strides (attention_map_plan; three
//     encodes a launch, 0.8 us of the host's time together), so TMA's
//     out-of-bounds fill zeroes the columns past D, the tokens past N of a
//     group and everything past the last group: a tile never reads the next
//     head's columns or the next group's tokens (a 2-D map over the flat
//     [G * N, row] view would);
//   * s = q k^T on wgmma (m64nNKk16, both operands from shared memory, K
//     K-major), the whole score row in f32 registers: scale and bias in f32
//     (the bias read from L2 in the accumulator's layout, 4 * N^2 bytes an
//     item: 83 KB at N = 144), -inf past N, the row max over the quad, p =
//     2^(x log2 e - m log2 e) (one FMA), l the f32 row sum; no online
//     rescale;
//   * o = p v on wgmma with p rounded to bf16 as the A operand in registers
//     (as the JAX path rounds it before its value product) and V an
//     MN-major operand from shared memory; o / l staged a warp's 16 x 32
//     block at a time in shared memory and stored for the rows < N in
//     16-byte row segments.
//   * a last wave of at most half the CTAs has its items' query tiles
//     split over two CTAs (attention_fwd_whole_items), each re-reading K
//     and V from L2: B1 at batch 32 has 192 items on 132 SMs, 132 whole,
//     then 60 in 120 halves.
//   At the main-path shapes on an NVIDIA H100 80GB HBM3 at 700 W
//   (chip_smoke.py phase 2; tools/profile_attention_fwd.py, CUDA graphs):
//   registers at launch 168 (N <= 224, 12 warps) and 128 (N <= 144, 16
//   warps), the consumers' 232 and 160 after setmaxnreg, no spill; dynamic
//   shared memory 148,480 and 197,632 bytes, static 10,304 and 15,456, one
//   CTA per SM; waves: B1 2 (132 items, then 120 halves), B2's Swin stages
//   16, 8, 4 and 2 (2048, 1024, 512 and 256 items).  Device time a call:
//   B1 0.0246-0.0249 ms (SDPA 0.0230-0.0233, bound 0.0127), B2 at stage 0
//   0.1615-0.1629 ms (SDPA 0.2525-0.2565, bound 0.0917).
// - "fma" (attention_fwd_kernel): f32 inputs (the exact path used to compare
//   with the CPU reference at f32 tolerances) and bf16 shapes outside the
//   wgmma route.  256 threads; q, k and v upcast to f32, q scaled first,
//   products as f32 FMA.  Shared memory holds the scaled query tile
//   transposed, the whole f32 score tile and one chunk of 32 keys or values.

#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "hopper_gemm.cuh"
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
  long long head_stride_in;    // elements between head h and h + 1 in q/k/v (d in packed rows)
  long long head_stride_out;   // elements between head h and h + 1 in o
  int row_stride_in;           // elements between consecutive tokens in q/k/v
  int row_stride_out;          // elements between consecutive tokens in o
  int num_groups;              // batch (self-attention) or batch * windows
  int windows;                 // group g reads bias window g % windows
  int heads;
  int n;
  int d;
  int n_pad;                   // n rounded up to kKeyChunk (CUDA-core route)
  int q_tiles;                 // query tiles per (group, head)
  int whole_items;             // wgmma route: the items walked whole; the rest in halves (fwd_work_unit)
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

  const size_t in_off = (size_t)g * p.group_stride_in + (size_t)h * p.head_stride_in;
  const T* qg = static_cast<const T*>(p.q) + in_off;
  const T* kg = static_cast<const T*>(p.k) + in_off;
  const T* vg = static_cast<const T*>(p.v) + in_off;
  T* og = static_cast<T*>(p.o) + (size_t)g * p.group_stride_out + (size_t)h * p.head_stride_out;
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
// The wgmma route (bf16): TMA loads, wgmma products.
// ---------------------------------------------------------------------------

constexpr int kWgmmaMaxKeys = 224;                 // the backward's tensor-core route takes the same calls
constexpr int kQTileRows = 64;                     // query rows of a consumer warpgroup's tile
constexpr uint32_t kQTileBytes = 2 * kBoxBytes;    // a query tile: two boxes of 64 rows x 64 columns
constexpr float kFwdLog2e = 1.4426950408889634f;      // p = 2^(x log2 e - m log2 e)

// The route of a call; the caller has checked d % 8 == 0 and d <= kMaxHeadDim.
inline bool attention_fwd_route_wgmma(bool is_bf16, int n, int d) {
  return is_bf16 && d % 16 == 0 && n <= kWgmmaMaxKeys;
}

// The keys a CTA holds for a head of n tokens (the N of the score product).
inline int attention_fwd_keys(int n) { return n <= 64 ? 64 : (n <= 144 ? 144 : 224); }

// A CTA at NK keys: kWgs consumer warpgroups and a producer warpgroup
// (one thread of it loads; it gives its registers to the consumers:
// setmaxnreg, kProducerRegs and kConsumerRegs a thread, the launch's
// 65536 / threads shared out); kKvBufs K/V buffers, each a head's K then its
// V, each two regions of NK rows x 128 bytes (columns 0-63, then 64-127);
// then a query tile per warpgroup.
template <int NK>
struct FwdShape {
  static constexpr int kWgs = NK == 224 ? 2 : (NK == 144 ? 3 : 1);
  static constexpr int kKvBufs = NK == 224 ? 1 : 2;
  static constexpr int kThreads = 128 * (kWgs + 1);
  static constexpr int kProducerRegs = NK == 144 ? 24 : 40;
  static constexpr int kConsumerRegs = NK == 144 ? 160 : 232;
  static constexpr uint32_t kRegionBytes = NK * 128;
  static constexpr uint32_t kKBytes = 2 * kRegionBytes;
  static constexpr uint32_t kKvBytes = 2 * kKBytes;
  static constexpr size_t kSmem = (size_t)kKvBufs * kKvBytes + (size_t)kWgs * kQTileBytes + 1024;
};

// The tensor map of one operand (q, k or v) of a call: 4-D over (column,
// head, token, group), innermost first, with the byte strides of a head, a
// token and a group, read in boxes of 64 columns x box_rows tokens of one
// head of one group, 128-byte swizzled.  A box reads zeros at the columns
// past d, the tokens past n and the groups past the last (TMA's
// out-of-bounds fill).  TMA takes strides in whole 16 bytes: false, and no
// plan, otherwise (edrl_attention_fwd_map_plan exposes it).
struct AttnMapPlan {
  cuuint64_t dims[4];
  cuuint64_t strides[3];
  cuuint32_t box[4];
};

inline bool attention_map_plan(int d, int heads, int n, int groups, long long head_stride, int row_stride,
                               long long group_stride, int box_rows, AttnMapPlan* plan) {
  if (head_stride % 8 != 0 || row_stride % 8 != 0 || group_stride % 8 != 0) return false;
  *plan = {{(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n, (cuuint64_t)groups},
           {(cuuint64_t)head_stride * 2, (cuuint64_t)row_stride * 2, (cuuint64_t)group_stride * 2},
           {64, 1, (cuuint32_t)box_rows, 1}};
  return true;
}

inline cudaError_t make_attention_map(CUtensorMap* map, const void* base, const AttnMapPlan& plan) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), plan.dims,
                            plan.strides, plan.box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The bias at (row, key) and (row, key + 1), zeros outside [0, n)^2; key is even.
__device__ __forceinline__ float2 bias_pair(const float* bias, int row, int key, int n) {
  if (row >= n || key >= n) return make_float2(0.0f, 0.0f);
  const float* at = bias + (size_t)row * n + key;
  if ((n & 1) == 0) return *reinterpret_cast<const float2*>(at);  // key + 1 < n, 8-byte aligned
  return make_float2(at[0], key + 1 < n ? at[1] : 0.0f);
}

// A warp's 16 rows x 32 columns to rows < n of dst (row stride ld), columns
// col0 .. min(col0 + 32, d): o holds the thread's accumulator values of
// those columns (rows row_lo and row_lo + 8, columns 8 jj + 2 t4 and + 1 of
// o + 4 jj), multiplied by mul_lo and mul_hi and rounded to bf16; the warp
// stages them in shared memory and stores 16-byte row segments (a store
// instruction covers 8 rows x 64 bytes, not 8 x 16).
__device__ __forceinline__ void store_warp_block(__nv_bfloat16* stage, __nv_bfloat16* dst, int ld, const float* o,
                                                 float mul_lo, float mul_hi, int row_lo, int n, int col0, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const float* oj = o + 4 * jj;
    *reinterpret_cast<__nv_bfloat162*>(stage + g * kStageLd + 8 * jj + 2 * t4) =
        __floats2bfloat162_rn(oj[0] * mul_lo, oj[1] * mul_lo);
    *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8) * kStageLd + 8 * jj + 2 * t4) =
        __floats2bfloat162_rn(oj[2] * mul_hi, oj[3] * mul_hi);
  }
  __syncwarp();
  const int c = col0 + 8 * t4;
  if (row_lo < n && c < d) {
    *reinterpret_cast<uint4*>(dst + (size_t)row_lo * ld + c) =
        *reinterpret_cast<const uint4*>(stage + g * kStageLd + 8 * t4);
  }
  if (row_lo + 8 < n && c < d) {
    *reinterpret_cast<uint4*>(dst + (size_t)(row_lo + 8) * ld + c) =
        *reinterpret_cast<const uint4*>(stage + (g + 8) * kStageLd + 8 * t4);
  }
  __syncwarp();
}

// Work unit u of a wgmma forward call: its item (group, head) and its query
// tiles [*t0, *t1).  Units below whole_items are items whole; the rest halve
// the last items' tiles (the first ceil(tiles / 2), then the others), so
// that a last wave of at most half the CTAs runs on twice as many
// (attention_fwd_whole_items).
__device__ __forceinline__ int fwd_work_unit(const AttnParams& p, int u, int tiles, int* t0, int* t1) {
  if (u < p.whole_items) {
    *t0 = 0;
    *t1 = tiles;
    return u;
  }
  const int v = u - p.whole_items, mid = (tiles + 1) / 2;
  *t0 = (v & 1) ? mid : 0;
  *t1 = (v & 1) ? tiles : mid;
  return p.whole_items + (v >> 1);
}

// A consumer warpgroup of attention_fwd_wgmma_kernel: its query tiles of
// every work unit the CTA walks.
template <int NK, bool kBias>
__device__ __forceinline__ void consume_fwd(const AttnParams& p, uint32_t kv_base, uint32_t q_base, uint64_t* k_full,
                                            uint64_t* v_full, uint64_t* kv_empty, uint64_t* q_full,
                                            uint64_t* q_empty, __nv_bfloat16* stage) {
  using Shape = FwdShape<NK>;
  using bf16 = __nv_bfloat16;
  constexpr int kWgs = Shape::kWgs, kBufs = Shape::kKvBufs;
  const int n = p.n;
  const int tiles = (n + kQTileRows - 1) / kQTileRows;
  const int units = 2 * p.num_groups * p.heads - p.whole_items;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t q_s = q_base + wg * kQTileBytes;
  const int d = p.d;
  const float scale = p.scale;
  int it = 0, q_loads = 0;  // units walked; query tiles taken (q_full's phases)
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
    int t0, t1;
    const int item = fwd_work_unit(p, u, tiles, &t0, &t1);
    const int grp = item / p.heads, h = item - grp * p.heads;
    const int b = it % kBufs;
    const uint32_t kv_parity = (it / kBufs) & 1;
    const uint32_t k_s = kv_base + b * Shape::kKvBytes, v_s = k_s + Shape::kKBytes;
    const float* bias = kBias ? p.bias + ((size_t)(grp % p.windows) * p.heads + h) * (size_t)n * n : nullptr;
    bf16* og = static_cast<bf16*>(p.o) + (size_t)grp * p.group_stride_out + (size_t)h * p.head_stride_out;
    for (int tile = t0 + wg; tile < t1; tile += kWgs, ++q_loads) {
      mbar_wait(&q_full[wg], q_loads & 1);
      mbar_wait(&k_full[b], kv_parity);
      // s = q k^T: thread (warp, g, t4) holds rows 16 warp + g (s[4j], s[4j +
      // 1]) and + 8 (s[4j + 2], s[4j + 3]) at keys 8j + 2 t4 and + 1.
      float s[NK / 2];
      zero_acc(s);
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
        if (16 * kk < d) {
          Wgmma<NK>::template ss<0, 0>(
              s, sw128_desc(q_s + (kk >> 2) * kBoxBytes + 32 * (kk & 3), 16, 1024),
              sw128_desc(k_s + (kk >> 2) * Shape::kRegionBytes + 32 * (kk & 3), 16, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      mbar_arrive(&q_empty[wg]);

      // x = s * scale + bias, -inf past n; the rows' max over the quad.
      const int row_lo = tile * kQTileRows + 16 * warp + g, row_hi = row_lo + 8;
      float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK / 8; ++j) {
        const int key = 8 * j + 2 * t4;
        float2 b_lo = make_float2(0.0f, 0.0f), b_hi = b_lo;
        if (kBias) {
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
      // p = 2^(x log2 e - m log2 e) in f32, summed into l; rounded to bf16
      // as the A fragments of o's 16-key steps.
      const float ml_lo = m_lo * kFwdLog2e, ml_hi = m_hi * kFwdLog2e;
      float l_lo = 0.0f, l_hi = 0.0f;
      uint32_t pa[NK / 16][4];
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        float* x = s + 8 * kk;
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = exp2f(fmaf(x[i], kFwdLog2e, (i & 2) ? -ml_hi : -ml_lo));
        l_lo += (x[0] + x[1]) + (x[4] + x[5]);
        l_hi += (x[2] + x[3]) + (x[6] + x[7]);
        pa[kk][0] = pack_bf16(x[0], x[1]);
        pa[kk][1] = pack_bf16(x[2], x[3]);
        pa[kk][2] = pack_bf16(x[4], x[5]);
        pa[kk][3] = pack_bf16(x[6], x[7]);
      }

      // o = p v over the 16-key steps that hold a key < n.
      mbar_wait(&v_full[b], kv_parity);
      float o[kMaxHeadDim / 2];
      zero_acc(o);
      fence_regs(pa);
      fence_acc(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        if (16 * kk < n) {
          Wgmma<kMaxHeadDim>::template rs<1>(o, pa[kk], sw128_desc(v_s + 2048u * kk, Shape::kRegionBytes, 1024));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_acc(o);

      // o / l for the rows < n, the columns < d.
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
      }
      const float il_lo = 1.0f / l_lo, il_hi = 1.0f / l_hi;
#pragma unroll
      for (int q = 0; q < kMaxHeadDim / 32; ++q) {
        if (32 * q < d) store_warp_block(stage, og, p.row_stride_out, o + 16 * q, il_lo, il_hi, row_lo, n, 32 * q, d);
      }
    }
    // kv_empty counts every consumer thread once a use.  A warpgroup with no
    // tile in the unit (the third at N <= 128, one of a half-item's) waits
    // for the use's V all the same: arriving at once, it would arrive again
    // for its next unit on this buffer and end the phase before the others
    // are done with it.
    if (t0 + wg >= t1) mbar_wait(&v_full[b], kv_parity);
    mbar_arrive(&kv_empty[b]);
  }
}

// One CTA per SM walks the work units (fwd_work_unit) blockIdx.x, blockIdx.x
// + gridDim.x, ...; kBias: the call has a bias (B2, v1, B6; B1 has none).
// The producer warpgroup's first thread loads each unit's K, its query
// tiles, then V, by TMA (FwdShape), and consumer warpgroup w takes the
// unit's query tiles t0 + w, t0 + w + kWgs, ... (consume_fwd):
//   s = q k^T (wgmma ss, m64nNKk16, over head_dim in 16-deep steps);
//   x = s * scale + bias, -inf at keys past n; m = rowmax(x);
//   p = 2^(x log2 e - m log2 e), l = rowsum(p);
//   o = bf16(p) v (wgmma rs, m64n128k16, p in registers), o / l stored.
// Barriers: k_full / v_full per K/V buffer (the producer's expect_tx, the
// TMA unit's bytes), kv_empty (every consumer thread, after its last tile of
// the item), q_full / q_empty per warpgroup (empty once its s is done).
template <int NK, bool kBias>
__global__ void __launch_bounds__(FwdShape<NK>::kThreads, 1)
    attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                               const __grid_constant__ CUtensorMap v_map, const AttnParams p) {
  using Shape = FwdShape<NK>;
  using bf16 = __nv_bfloat16;
  constexpr int kWgs = Shape::kWgs, kBufs = Shape::kKvBufs;
  // Named apart from the CUDA-core kernel's float smem[] and the mainloop's
  // gemm_smem[]: a unit that includes them all (B6) would see one symbol.
  extern __shared__ unsigned char fwd_smem[];
  __shared__ uint64_t k_full[kBufs], v_full[kBufs], kv_empty[kBufs], q_full[kWgs], q_empty[kWgs];
  __shared__ __align__(16) bf16 o_stage[4 * kWgs][kStageElems];  // each consumer warp's o staging
  const uint32_t kv_base = (smem_u32(fwd_smem) + 1023u) & ~1023u;
  const uint32_t q_base = kv_base + kBufs * Shape::kKvBytes;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(&k_full[b], 1);
      mbar_init(&v_full[b], 1);
      mbar_init(&kv_empty[b], 128 * kWgs);
    }
    for (int w = 0; w < kWgs; ++w) {
      mbar_init(&q_full[w], 1);
      mbar_init(&q_empty[w], 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int tiles = (p.n + kQTileRows - 1) / kQTileRows;
  const int units = 2 * p.num_groups * p.heads - p.whole_items;
  const int wg = threadIdx.x >> 7;

  if (wg == kWgs) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Shape::kProducerRegs));
    if (threadIdx.x != 128 * kWgs) return;
    // Query tile `tile` (the unit's i-th) into its warpgroup's buffer, once
    // the warpgroup's s of its previous tile is done.
    int q_loads[kWgs] = {};
    auto load_q = [&](int i, int tile, int grp, int h) {
      const int w = i % kWgs;
      if (q_loads[w] > 0) mbar_wait(&q_empty[w], (q_loads[w] - 1) & 1);
      ++q_loads[w];
      const uint32_t dst = q_base + w * kQTileBytes;
      mbar_expect_tx(&q_full[w], kQTileBytes);
      tma_load_4d(dst, &q_map, &q_full[w], 0, h, tile * kQTileRows, grp);
      tma_load_4d(dst + kBoxBytes, &q_map, &q_full[w], 64, h, tile * kQTileRows, grp);
    };
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++it) {
      int t0, t1;
      const int item = fwd_work_unit(p, u, tiles, &t0, &t1);
      const int grp = item / p.heads, h = item - grp * p.heads;
      const int b = it % kBufs, use = it / kBufs;
      if (use > 0) mbar_wait(&kv_empty[b], (use - 1) & 1);
      const uint32_t k_s = kv_base + b * Shape::kKvBytes, v_s = k_s + Shape::kKBytes;
      mbar_expect_tx(&k_full[b], Shape::kKBytes);
      tma_load_4d(k_s, &k_map, &k_full[b], 0, h, 0, grp);
      tma_load_4d(k_s + Shape::kRegionBytes, &k_map, &k_full[b], 64, h, 0, grp);
      for (int t = t0; t < t1 && t < t0 + kWgs; ++t) load_q(t - t0, t, grp, h);
      mbar_expect_tx(&v_full[b], Shape::kKBytes);
      tma_load_4d(v_s, &v_map, &v_full[b], 0, h, 0, grp);
      tma_load_4d(v_s + Shape::kRegionBytes, &v_map, &v_full[b], 64, h, 0, grp);
      for (int t = t0 + kWgs; t < t1; ++t) load_q(t - t0, t, grp, h);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Shape::kConsumerRegs));
    consume_fwd<NK, kBias>(p, kv_base, q_base, k_full, v_full, kv_empty, q_full, q_empty, o_stage[threadIdx.x >> 5]);
  }
}

// Calls f(NK, kBias) with the call's keys (attention_fwd_keys) and whether
// it has a bias as compile-time constants (std::integral_constant).
template <class F>
auto with_fwd_kernel(int n, bool with_bias, F&& f) {
  using std::integral_constant;
  switch (attention_fwd_keys(n) + with_bias) {
    case 64:
      return f(integral_constant<int, 64>(), std::false_type());
    case 65:
      return f(integral_constant<int, 64>(), std::true_type());
    case 144:
      return f(integral_constant<int, 144>(), std::false_type());
    case 145:
      return f(integral_constant<int, 144>(), std::true_type());
    case 224:
      return f(integral_constant<int, 224>(), std::false_type());
    default:
      return f(integral_constant<int, 224>(), std::true_type());
  }
}

// The items a call's CTAs walk whole (fwd_work_unit): all of them, unless
// the last wave is at most half the CTAs and an item has 2 or more query
// tiles; then the last wave's items go in halves, twice as many units, one
// wave.  B1 at batch 32: 192 items on 132 CTAs, 132 whole and 60 in halves.
inline int attention_fwd_whole_items(int items, int tiles, int ctas) {
  const int last = items % ctas;
  return tiles >= 2 && last > 0 && 2 * last <= ctas ? items - last : items;
}

// The persistent grid of a call of `items` (group, head) items of n tokens:
// one CTA an SM (at most one an item), the items it walks whole.
inline cudaError_t attention_fwd_grid(int n, int items, unsigned* ctas, int* whole_items) {
  const cudaError_t err = persistent_ctas(items, 1, ctas);
  *whole_items = attention_fwd_whole_items(items, (n + kQTileRows - 1) / kQTileRows, (int)*ctas);
  return err;
}

template <int NK, bool kBias>
cudaError_t launch_attention_fwd_wgmma(AttnParams p, cudaStream_t stream) {
  using Shape = FwdShape<NK>;
  const void* bases[3] = {p.q, p.k, p.v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    AttnMapPlan plan;
    if (!attention_map_plan(p.d, p.heads, p.n, p.num_groups, p.head_stride_in, p.row_stride_in, p.group_stride_in,
                            i == 0 ? kQTileRows : NK, &plan)) {
      return cudaErrorMisalignedAddress;
    }
    const cudaError_t err = make_attention_map(&maps[i], bases[i], plan);
    if (err != cudaSuccess) return err;
  }
  auto kernel = attention_fwd_wgmma_kernel<NK, kBias>;
  cudaError_t err = allow_smem(kernel, Shape::kSmem);
  if (err != cudaSuccess) return err;
  unsigned ctas = 0;
  err = attention_fwd_grid(p.n, p.num_groups * p.heads, &ctas, &p.whole_items);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, Shape::kThreads, Shape::kSmem, stream>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

// Dynamic shared memory a block of the call's route takes.
inline size_t attention_fwd_smem_bytes(bool is_bf16, int n, int d, bool with_bias) {
  if (!attention_fwd_route_wgmma(is_bf16, n, d)) return attention_smem_bytes(n, d);
  return with_fwd_kernel(n, with_bias, [](auto nk, auto) { return FwdShape<decltype(nk)::value>::kSmem; });
}

// The route's kernel at (n, d): resident blocks per SM from the occupancy
// calculator in out[0], dynamic shared memory per block in out[1], warps per
// block in out[2].
inline cudaError_t attention_fwd_occupancy(bool is_bf16, int n, int d, bool with_bias, int* out) {
  out[1] = (int)attention_fwd_smem_bytes(is_bf16, n, d, with_bias);
  if (attention_fwd_route_wgmma(is_bf16, n, d)) {
    return with_fwd_kernel(n, with_bias, [&](auto nk, auto bias) {
      constexpr int kThreadsNk = FwdShape<decltype(nk)::value>::kThreads;
      out[2] = kThreadsNk / 32;
      return blocks_per_sm(attention_fwd_wgmma_kernel<decltype(nk)::value, decltype(bias)::value>, kThreadsNk,
                           out[1], &out[0]);
    });
  }
  out[2] = kWarps;
  return is_bf16 ? blocks_per_sm(attention_fwd_kernel<__nv_bfloat16>, kThreads, out[1], &out[0])
                 : blocks_per_sm(attention_fwd_kernel<float>, kThreads, out[1], &out[0]);
}

// Launches the kernel of the route attention_fwd_route_wgmma picks on
// `stream` and returns cudaGetLastError(); the caller has checked the shapes
// (d % 8 == 0, d <= kMaxHeadDim, shared memory within the limit).  The wgmma
// route reads q, k and v by TMA and stores o in 16-byte row segments: it
// takes 16-byte aligned q, k, v, bias and o with strides of whole 16-byte
// vectors, and returns cudaErrorMisalignedAddress, launching nothing, for
// others.
template <typename T>
cudaError_t launch_attention_fwd(AttnParams p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (attention_fwd_route_wgmma(true, p.n, p.d)) {
      if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || (p.bias && !aligned16(p.bias)) ||
          !aligned16(p.o) || p.row_stride_in % 8 != 0 || p.row_stride_out % 8 != 0 ||
          p.group_stride_in % 8 != 0 || p.head_stride_in % 8 != 0 || p.group_stride_out % 8 != 0 ||
          p.head_stride_out % 8 != 0) {
        return cudaErrorMisalignedAddress;
      }
      return with_fwd_kernel(p.n, p.bias != nullptr, [&](auto nk, auto bias) {
        return launch_attention_fwd_wgmma<decltype(nk)::value, decltype(bias)::value>(p, stream);
      });
    }
  }
  return launch_attention_fwd_simt<T>(p, stream);
}

}  // namespace
