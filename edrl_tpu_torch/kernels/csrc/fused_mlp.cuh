// Shared pieces of the fused MLP kernels (B5): y = gelu_tanh(u W1 + b1) W2 + b2
// with W1 [C, H], W2 [H, C] and the hidden [M, H] kept on chip.
//
// Every product runs on the tensor cores with mma.sync m16n8k16 (bf16 in,
// f32 accumulate).  The TPU kernel rounds the weights, the activation a and,
// in its backward, dy and dh to bf16, and keeps u in its own dtype.  bf16
// operands go to the tensor cores as they are.  An f32 u is split exactly
// into three bf16 parts, u = u0 + u1 + u2 (each part holds the next 8 bits of
// u's 24-bit significand), and each product with u is three mma.sync into
// one f32 accumulator: the products u_i * w are exact in f32, so the result
// is the f32 product the TPU kernel forms, up to the order of the f32 sums.
//
// Layout of the forward: a block owns BM rows of u (32 in bf16, 16 in f32)
// and 8 warps.  It walks over the hidden units in chunks of BH = 32.  Per
// chunk:
//
// - gemm_small: the [BM, BH] product of the block's rows with one weight
//   chunk (K = C).  The (BM / 16) * (BH / 8) output tiles are spread over the
//   8 warps; where there are fewer tiles than warps, K is split between warp
//   groups, and the groups' f32 partials are added in a fixed order.
// - gemm_wide: the [BM, C] accumulation of a bf16 [BM, BH] tile of the
//   hidden times a [BH, C] weight chunk.  Warp w owns output columns
//   [w * C / 8, (w + 1) * C / 8), i.e. NT = C / 64 tiles of 8 columns, and
//   keeps their f32 sums in registers across all chunks (BM * C / 256
//   floats a thread: 128 at C = 1024, BM = 32).
//
// tile_product, a 128 x 64 output tile of a product whose operands both hold
// K contiguously, serves the backward's row kernels and the fused attention
// sublayer's (B6) bf16 products.
//
// The weights reach the kernels as bf16 copies in the layout whose rows hold
// the product's K dimension contiguously (prep kernels below), so that a B
// fragment is two 32-bit shared-memory loads.  C must be a multiple of 128
// and at most 1024; H a multiple of 32.

#pragma once

#include <type_traits>

#include "mma_common.cuh"

namespace {

constexpr int kMlpWarps = 8;
constexpr int kMlpThreads = kMlpWarps * 32;
constexpr int kMlpMaxC = 1024;
constexpr float kSqrt2OverPi = 0.7978845608028654f;
constexpr float kGeluC = 0.044715f;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float inner = kSqrt2OverPi * (x + kGeluC * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float x2 = x * x;
  const float t = tanhf(kSqrt2OverPi * (x + kGeluC * x * x2));
  const float sech2 = 1.0f - t * t;
  return 0.5f * (1.0f + t) + 0.5f * x * sech2 * kSqrt2OverPi * (1.0f + 3.0f * kGeluC * x2);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = sum of three bf16 pairs, exactly.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  const float r0 = x0 - __bfloat162float(h0), r1 = x1 - __bfloat162float(h1);
  const __nv_bfloat16 m0 = __float2bfloat16(r0), m1 = __float2bfloat16(r1);
  p0 = pack2(h0, h1);
  p1 = pack2(m0, m1);
  p2 = pack_bf16(r0 - __bfloat162float(m0), r1 - __bfloat162float(m1));
}

// A fragments of the 16 x 16 block at (row, k) of a row-major shared tile
// (row = r0 + g, k = k0 + 2t for lane (g, t)): one part for bf16, three for
// f32 (split3).
template <typename T>
struct AFrag;

template <>
struct AFrag<__nv_bfloat16> {
  static constexpr int kParts = 1;
  __device__ static __forceinline__ void load(const __nv_bfloat16* s, int ld, int row, int k,
                                              uint32_t (&a)[1][4]) {
    const __nv_bfloat16* p = s + row * ld + k;
    a[0][0] = lds32(p);
    a[0][1] = lds32(p + 8 * ld);
    a[0][2] = lds32(p + 8);
    a[0][3] = lds32(p + 8 * ld + 8);
  }
};

template <>
struct AFrag<float> {
  static constexpr int kParts = 3;
  __device__ static __forceinline__ void load(const float* s, int ld, int row, int k,
                                              uint32_t (&a)[3][4]) {
    const float* p = s + row * ld + k;
    const float* src[4] = {p, p + 8 * ld, p + 8, p + 8 * ld + 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(src[i]);
      split3(v.x, v.y, a[0][i], a[1][i], a[2][i]);
    }
  }
};

template <typename T>
__host__ __device__ constexpr int elems16() {
  return 16 / (int)sizeof(T);
}

// dst[r][0:cols] = src[row0 + r][col0 : col0 + cols] for r < rows (zero past
// row_end), 16 bytes per thread and step; all threads of the block.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src, int src_ld, int row0,
                                           int rows, int row_end, int col0, int cols) {
  constexpr int kV = elems16<T>();
  const int vecs = cols / kV;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kV;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < row_end) v = *reinterpret_cast<const uint4*>(src + (size_t)row * src_ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

// As stage_rows, asynchronously (cp.async); the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_rows_async(T* dst, int ld, const T* src, int src_ld, int row0,
                                                 int rows, int row_end, int col0, int cols) {
  constexpr int kV = elems16<T>();
  const int vecs = cols / kV;
  for (int i = threadIdx.x; i < rows * vecs; i += blockDim.x) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * kV;
    const bool valid = row0 + r < row_end;
    cp_async16(dst + r * ld + c, src + (size_t)(valid ? row0 + r : 0) * src_ld + col0 + c, valid);
  }
}

// part[kg][BM][BH] = this warp group's K-range of a_s[BM, C] . w_s[BH, C]^T.
// w_s rows are the BH output columns with K contiguous.
template <typename T, int BM, int BH>
__device__ __forceinline__ void gemm_small(const T* a_s, int lda, const __nv_bfloat16* w_s,
                                           int ldw, int c, float* part) {
  constexpr int kTiles = (BM / 16) * (BH / 8);
  constexpr int kGroups = kMlpWarps / kTiles;
  static_assert(kTiles * kGroups == kMlpWarps, "tiles must divide the warps");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tile = warp % kTiles;
  const int kg = warp / kTiles;
  const int mt = tile / (BH / 8), nt = tile % (BH / 8);
  const int k_len = c / kGroups;  // a multiple of 32
  // Two accumulators, for even and odd k-steps, so that consecutive mma.sync
  // do not wait on each other.
  float acc2[2][4] = {};
  for (int k = kg * k_len; k < (kg + 1) * k_len; k += 32) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint32_t a[AFrag<T>::kParts][4];
      AFrag<T>::load(a_s, lda, mt * 16 + g, k + 16 * s + 2 * t, a);
      const __nv_bfloat16* wb = w_s + (nt * 8 + g) * ldw + k + 16 * s + 2 * t;
      const uint32_t b0 = lds32(wb), b1 = lds32(wb + 8);
#pragma unroll
      for (int pi = 0; pi < AFrag<T>::kParts; ++pi) mma_bf16_16816(acc2[s], a[pi], b0, b1);
    }
  }
  const float acc[4] = {acc2[0][0] + acc2[1][0], acc2[0][1] + acc2[1][1], acc2[0][2] + acc2[1][2],
                        acc2[0][3] + acc2[1][3]};
  float* out = part + (size_t)kg * BM * BH;
  const int r = mt * 16 + g, col = nt * 8 + 2 * t;
  out[r * BH + col] = acc[0];
  out[r * BH + col + 1] = acc[1];
  out[(r + 8) * BH + col] = acc[2];
  out[(r + 8) * BH + col + 1] = acc[3];
}

// The k-group sum of gemm_small's partials at (r, j), in group order.
template <int BM, int BH>
__device__ __forceinline__ float small_sum(const float* part, int r, int j) {
  constexpr int kGroups = kMlpWarps / ((BM / 16) * (BH / 8));
  float v = 0.0f;
#pragma unroll
  for (int kg = 0; kg < kGroups; ++kg) v += part[(size_t)kg * BM * BH + r * BH + j];
  return v;
}

// acc[BM/16][NT][4] += h_s[BM, BH] . w_s[C, BH]^T over this warp's NT column
// tiles; w_s rows are the C output columns with the BH hidden units
// contiguous.
template <int BM, int BH, int NT>
__device__ __forceinline__ void gemm_wide(float (&acc)[BM / 16][NT][4], const __nv_bfloat16* h_s,
                                          int ldh, const __nv_bfloat16* w_s, int ldw) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < BH; k += 16) {
    uint32_t a[BM / 16][1][4];
#pragma unroll
    for (int mi = 0; mi < BM / 16; ++mi) {
      AFrag<__nv_bfloat16>::load(h_s, ldh, mi * 16 + g, k + 2 * t, a[mi]);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const __nv_bfloat16* wb = w_s + ((warp * NT + ni) * 8 + g) * ldw + k + 2 * t;
      const uint32_t b0 = lds32(wb), b1 = lds32(wb + 8);
#pragma unroll
      for (int mi = 0; mi < BM / 16; ++mi) mma_bf16_16816(acc[mi][ni], a[mi][0], b0, b1);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float x0, float x1);
template <>
__device__ __forceinline__ void store2<float>(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// Writes the wide accumulator's rows below row_end, plus bias (or nullptr).
template <typename T, int BM, int NT>
__device__ __forceinline__ void store_wide(const float (&acc)[BM / 16][NT][4], T* out, int c,
                                           int row0, int row_end, const float* bias) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < BM / 16; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const int col = (warp * NT + ni) * 8 + 2 * t;
      const float b0 = bias ? bias[col] : 0.0f, b1 = bias ? bias[col + 1] : 0.0f;
      const int r = row0 + mi * 16 + g;
      if (r < row_end) store2<T>(out + (size_t)r * c + col, acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
      if (r + 8 < row_end) {
        store2<T>(out + (size_t)(r + 8) * c + col, acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// A tiled product with both operands K-contiguous: acc += A[rows, K] . B[cols, K]^T
// ---------------------------------------------------------------------------

constexpr int kTileM = 128;  // rows of a block (4 warps of 32)
constexpr int kTileN = 64;   // columns of a block (2 warps of 32)
constexpr int kTileK = 32;   // K per staged slice
constexpr int kLdK = kTileK + 8;  // padded slice rows: conflict-free fragment loads
constexpr int kStages = 2;

// An f32 operand rounded to bf16 (dy where the TPU kernel rounds it).
struct AFragRounded {
  static constexpr int kParts = 1;
  __device__ static __forceinline__ void load(const float* s, int ld, int row, int k,
                                              uint32_t (&a)[1][4]) {
    const float* p = s + row * ld + k;
    const float* src[4] = {p, p + 8 * ld, p + 8, p + 8 * ld + 8};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(src[i]);
      a[0][i] = pack_bf16(v.x, v.y);
    }
  }
};

// acc[2][4][4] += A[row0 + 128 tile, 0:K] . B[col0 + 64 tile, 0:K]^T for this
// warp's 32 x 32 quarter; A of type TA read through Frag, B bf16.  smem holds
// kStages slices of A ([128][kLdK] TA) followed by kStages slices of B.
template <typename Frag, typename TA>
__device__ __forceinline__ void tile_product(float (&acc)[2][4][4], const TA* a, int lda,
                                             int row0, int row_end, const __nv_bfloat16* b,
                                             int ldb, int col0, int k_len, unsigned char* smem) {
  TA* a_s = reinterpret_cast<TA*>(smem);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(a_s + kStages * kTileM * kLdK);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int slices = k_len / kTileK;
  auto stage = [&](int slice) {
    const int buf = slice % kStages;
    stage_rows_async(a_s + buf * kTileM * kLdK, kLdK, a, lda, row0, kTileM, row_end, slice * kTileK, kTileK);
    stage_rows_async(b_s + buf * kTileN * kLdK, kLdK, b, ldb, col0, kTileN, col0 + kTileN, slice * kTileK,
                     kTileK);
    cp_async_commit();
  };
  stage(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TA* as = a_s + (s % kStages) * kTileM * kLdK;
    const __nv_bfloat16* bs = b_s + (s % kStages) * kTileN * kLdK;
#pragma unroll
    for (int k = 0; k < kTileK; k += 16) {
      uint32_t af[2][Frag::kParts][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) Frag::load(as, kLdK, wm + mi * 16 + g, k + 2 * t, af[mi]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* bp = bs + (wn + ni * 8 + g) * kLdK + k + 2 * t;
        const uint32_t b0 = lds32(bp), b1 = lds32(bp + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int pi = 0; pi < Frag::kParts; ++pi) mma_bf16_16816(acc[mi][ni], af[mi][pi], b0, b1);
      }
    }
    __syncthreads();  // this slice's buffer is free for the slice after next
  }
}

template <typename TA>
size_t tile_smem_bytes() {
  return (size_t)kStages * kLdK * (kTileM * sizeof(TA) + kTileN * 2);
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;
}

// ---------------------------------------------------------------------------
// Weight preparation: bf16 copies, transposed or not.
// ---------------------------------------------------------------------------

// out[c][r] = bf16(in[r][c]) for in [rows, cols]; 32 x 32 tiles through
// shared memory, so both the reads and the writes are contiguous.
template <typename TW>
__global__ void __launch_bounds__(256) transpose_bf16_kernel(const TW* __restrict__ in,
                                                             __nv_bfloat16* __restrict__ out,
                                                             int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i, c = c0 + tx;
    tile[i][tx] = (r < rows && c < cols) ? to_f32(in[(size_t)r * cols + c]) : 0.0f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int c = c0 + i, r = r0 + tx;
    if (c < cols && r < rows) out[(size_t)c * rows + r] = __float2bfloat16(tile[tx][i]);
  }
}

__global__ void __launch_bounds__(256) round_bf16_kernel(const float* __restrict__ in,
                                                         __nv_bfloat16* __restrict__ out,
                                                         long long n) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n; i += (long long)gridDim.x * 256) {
    out[i] = __float2bfloat16(in[i]);
  }
}

template <typename TW>
cudaError_t launch_transpose_bf16(const void* in, __nv_bfloat16* out, int rows, int cols,
                                  cudaStream_t stream) {
  const dim3 grid((unsigned)((cols + 31) / 32), (unsigned)((rows + 31) / 32));
  transpose_bf16_kernel<TW><<<grid, 256, 0, stream>>>(static_cast<const TW*>(in), out, rows, cols);
  return cudaGetLastError();
}

inline cudaError_t launch_round_bf16(const float* in, __nv_bfloat16* out, long long n,
                                     cudaStream_t stream) {
  const long long want = (n + 255) / 256;
  round_bf16_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0, stream>>>(in, out, n);
  return cudaGetLastError();
}

// Calls launch.template operator()<NT>() for NT = c / 64 (c a multiple of 128).
template <typename Launch>
cudaError_t dispatch_nt(int c, const Launch& launch) {
  switch (c / 64) {
    case 2: return launch.template operator()<2>();
    case 4: return launch.template operator()<4>();
    case 6: return launch.template operator()<6>();
    case 8: return launch.template operator()<8>();
    case 10: return launch.template operator()<10>();
    case 12: return launch.template operator()<12>();
    case 14: return launch.template operator()<14>();
    case 16: return launch.template operator()<16>();
    default: return cudaErrorInvalidValue;
  }
}

// Hidden units per chunk of the forward.  At C = 1024 a block then holds
// 32 rows of u, one W1 chunk [32, C] and one W2 chunk [C, 32]: ~216 KB.
constexpr int kHiddenChunk = 32;

}  // namespace
