// Shared forward attention kernels for the two entry points in this folder.
//
// Computes, for one (group, head) pair and a tile of 64 query rows,
//     o = softmax((q * scale) k^T + bias) v
// the way the Pallas kernels it replaces do (edrl_tpu/kernels/window_attention.py,
// _attn_fwd_kernel_v2 and _sa_fwd_kernel): scores and softmax in f32, the bias
// added in f32, a row max, exp and a row sum, o = (p v) / l written in the
// input type.
//
// Layout: q, k and v are read in place from their packed [.., N, row_stride]
// tensors (head h owns columns [h*D, (h+1)*D)), and o is written to
// [.., N, row_stride_out] at the same columns, so no transpose happens
// outside the kernel.  The tail keys past N are masked with -inf, and the
// tail queries past N are computed on zeros and never stored.
//
// Two kernels, chosen per call by launch_attention_fwd:
//
// - attention_fwd_mma_kernel (bf16, head_dim % 16 == 0, N <= 224: the whole
//   main path).  4 warps, 16 query rows each.  Q, then K, then V are staged
//   in shared memory as bf16; both products run on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate).  A warp keeps its whole
//   [16, N] f32 score row block in registers, takes the softmax there, and
//   feeds the probabilities, rounded to bf16, straight back as the A operand
//   of the value product (as the JAX XLA path rounds them before its value
//   product).  The scale multiplies the f32 scores rather than q.
// - attention_fwd_kernel (f32 inputs, and any other shape).  256 threads;
//   q, k and v upcast to f32, q scaled first, products as f32 FMA on the
//   CUDA cores.  Shared memory holds the scaled query tile transposed, the
//   whole f32 score tile and one chunk of 32 keys or values.  This is the
//   exact path used to compare with the CPU reference at f32 tolerances.
//
// wgmma, TMA and a persistent schedule are later work.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

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
  int n_pad;                   // n rounded up to kKeyChunk
  int q_tiles;                 // ceil(n / kTileQ)
  float scale;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

inline size_t attention_smem_bytes(int n, int d) {
  const int n_pad = round_up(n, kKeyChunk);
  return sizeof(float) *
         ((size_t)d * kQLd + (size_t)kTileQ * n_pad + (size_t)kKeyChunk * (d + 1));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
// Tensor-core kernel (bf16).
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaTileQ = kMmaWarps * 16;  // 64 query rows, 16 per warp
constexpr int kMmaMaxKeys = 224;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a [16 keys, 8 columns] block of a row-major [key][d] tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// Rows [row0, row0 + rows) of one head (d bf16 each) into shared rows of
// stride ld, 16 bytes per thread and step; rows past n are zero.
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int rows, int n, int d, int ld,
                                               int row_stride) {
  const int chunks = d / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kMmaThreads) {
    const int r = i / chunks;
    const int c = (i - r * chunks) * 8;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) v = *reinterpret_cast<const uint4*>(src + (size_t)row * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// KT: 8-key tiles a warp holds per score row (KT * 8 >= n, KT even).
template <int KT>
__global__ void __launch_bounds__(kMmaThreads, 2) attention_fwd_mma_kernel(AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d;
  const int n = p.n;
  const int ld = d + 8;  // padded rows: conflict-free fragment loads
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMmaTileQ][ld]
  __nv_bfloat16* kv_s = q_s + kMmaTileQ * ld;  // [16 * k_steps][ld]: keys, then values

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (and B column) of this lane
  const int t = lane & 3;   // fragment column pair of this lane
  const int tile = blockIdx.x % p.q_tiles;
  const int grp = blockIdx.x / p.q_tiles;
  const int h = blockIdx.y;
  const int q0 = tile * kMmaTileQ;
  const int n_tiles = (n + 7) / 8;        // 8-key tiles that hold keys
  const int k_steps = (n_tiles + 1) / 2;  // 16-key steps of the value product

  const size_t in_off = (size_t)grp * p.group_stride_in + (size_t)h * d;
  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + in_off;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + in_off;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + in_off;
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + (size_t)grp * p.group_stride_out + (size_t)h * d;
  const float* bias =
      p.bias ? p.bias + ((size_t)(grp % p.windows) * p.heads + h) * (size_t)n * n : nullptr;

  load_rows_bf16(q_s, qg, q0, kMmaTileQ, n, d, ld, p.row_stride_in);
  load_rows_bf16(kv_s, kg, 0, 16 * k_steps, n, d, ld, p.row_stride_in);
  __syncthreads();

  // 1. s = q k^T for this warp's 16 rows and all keys, in registers.
  const int r0 = warp * 16;
  float s[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
  for (int kk = 0; kk < d; kk += 16) {
    const __nv_bfloat16* qa = q_s + (r0 + g) * ld + kk + 2 * t;
    const uint32_t a[4] = {lds32(qa), lds32(qa + 8 * ld), lds32(qa + 8), lds32(qa + 8 * ld + 8)};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j < n_tiles) {
        const __nv_bfloat16* kb = kv_s + (8 * j + g) * ld + kk + 2 * t;
        mma_bf16_16816(s[j], a, lds32(kb), lds32(kb + 8));
      }
    }
  }

  // 2. Scale, bias and masks; row softmax numerators.  Lane (g, t) holds rows
  //    g and g + 8 of the block, keys 8j + 2t and 8j + 2t + 1 of each tile;
  //    a row is spread over the 4 lanes of a quad.
  const int row_lo = q0 + r0 + g;
  const int row_hi = row_lo + 8;
  float m_lo = -INFINITY, m_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? row_lo : row_hi;
      const int key = 8 * j + 2 * t + (e & 1);
      float x;
      if (key >= n) {
        x = -INFINITY;
      } else if (row >= n) {
        x = 0.0f;
      } else {
        x = s[j][e] * p.scale + (bias ? bias[(size_t)row * n + key] : 0.0f);
      }
      s[j][e] = x;
    }
    m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
    m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
    m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
  }
  float l_lo = 0.0f, l_hi = 0.0f;
  uint32_t pa[KT / 2][4];  // probabilities as A fragments of the value product
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    s[j][0] = expf(s[j][0] - m_lo);
    s[j][1] = expf(s[j][1] - m_lo);
    s[j][2] = expf(s[j][2] - m_hi);
    s[j][3] = expf(s[j][3] - m_hi);
    l_lo += s[j][0] + s[j][1];
    l_hi += s[j][2] + s[j][3];
    pa[j / 2][(j & 1) * 2 + 0] = pack_bf16(s[j][0], s[j][1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }

  // 3. o = p v, with v staged where k was.
  __syncthreads();
  load_rows_bf16(kv_s, vg, 0, 16 * k_steps, n, d, ld, p.row_stride_in);
  __syncthreads();
  float o[kMaxHeadDim / 8][4];
#pragma unroll
  for (int dn = 0; dn < kMaxHeadDim / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT / 2; ++kt) {
    if (kt < k_steps) {
      const __nv_bfloat16* vrow = kv_s + (16 * kt + (lane & 15)) * ld;
#pragma unroll
      for (int dn = 0; dn < kMaxHeadDim / 8; ++dn) {
        if (8 * dn < d) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + 8 * dn);
          mma_bf16_16816(o[dn], pa[kt], b0, b1);
        }
      }
    }
  }

  // 4. Normalise and store the rows that exist.
#pragma unroll
  for (int dn = 0; dn < kMaxHeadDim / 8; ++dn) {
    if (8 * dn < d) {
      const int c = 8 * dn + 2 * t;
      if (row_lo < n) {
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_lo * p.row_stride_out + c) =
            __floats2bfloat162_rn(o[dn][0] / l_lo, o[dn][1] / l_lo);
      }
      if (row_hi < n) {
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)row_hi * p.row_stride_out + c) =
            __floats2bfloat162_rn(o[dn][2] / l_hi, o[dn][3] / l_hi);
      }
    }
  }
}

template <int KT>
cudaError_t launch_attention_fwd_mma(AttnParams p, cudaStream_t stream) {
  p.n_pad = 8 * KT;
  p.q_tiles = (p.n + kMmaTileQ - 1) / kMmaTileQ;
  const size_t smem = (size_t)(kMmaTileQ + 8 * KT) * (p.d + 8) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_mma_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)p.num_groups * (unsigned)p.q_tiles, (unsigned)p.heads);
  attention_fwd_mma_kernel<KT><<<grid, kMmaThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// Launches on `stream` and returns cudaGetLastError(); the caller has checked
// the shapes (d % 8 == 0, d <= kMaxHeadDim, shared memory within the limit).
template <typename T>
cudaError_t launch_attention_fwd(AttnParams p, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (p.d % 16 == 0 && p.n <= kMmaMaxKeys && p.row_stride_in % 8 == 0 &&
        p.row_stride_out % 2 == 0 && aligned16(p.q) && aligned16(p.k) && aligned16(p.v) &&
        aligned16(p.o)) {
      return p.n <= 144 ? launch_attention_fwd_mma<18>(p, stream)
                        : launch_attention_fwd_mma<28>(p, stream);
    }
  }
  return launch_attention_fwd_simt<T>(p, stream);
}

}  // namespace
