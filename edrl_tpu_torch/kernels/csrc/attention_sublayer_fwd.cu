// Fused attention sublayer forward (B6).
//
// Replaces: edrl_tpu/kernels/block_attention.py, attention_sublayer_fused's
// forward (_v4_fwd_call / _block_attn_fwd_kernel).  Over x [B, W, N, C]:
//
//     xln = LN(x)                                   (f32 statistics, eps 1e-6)
//     qkv = xln . wqkv + bqkv                       [B, W, N, 3C]
//     o   = softmax(q k^T * scale + bias) v         per (b, w, h)
//     y   = x + (o . wproj + bproj)                 rounded once to x's dtype
//
// with gamma, beta, bqkv and bproj f32, wqkv [C, 3C] and wproj [C, C] in x's
// dtype, and bias [Wb, H, N, N] f32, Wb 1 (every window reads the same bias,
// as the TPU's _bias_spec_v4 maps it) or W.  xln and qkv are written in x's
// dtype: they are the backward's residuals.
//
// What bounds it on an H100: per token it reads x and writes y, xln and qkv
// (12 bytes per channel in bf16) and does 8C + 4N flops per channel
// (the two products, 2 * 3C + 2 * C, and the attention, 4 * N).  At the Swin
// stage 0 (C = 128, N = 144) that is ~90 flops per byte, below the card's
// ~295 flops per byte ridge, so bound by bytes; at C = 768 and above the
// products put it above the ridge, bound by the tensor cores.
//
// What the design does about it.  The TPU kernel keeps wqkv and wproj
// resident for its whole grid (16 C^2 bytes in bf16, 8 MB at C = 1024) and a
// [N, C] f32 accumulator per program; a Hopper block has at most 227 KB of
// shared memory.  So the sublayer runs as four launches on one stream, each
// over a grid that fills the card, reusing the port's device code:
//
// (a) B4's LayerNorm forward (edrl_layer_norm_fwd: a persistent grid of row
//     groups, two-pass f32 statistics) writes xln, a residual of the backward;
// (b) qkv = xln . wqkv + bqkv, the bias added in f32 and one rounding;
// (c) the attention of attention_fwd.cuh per (b, w, h, query tile),
//     reading q, k and v in place from qkv and the bias with window index
//     g % Wb, so a Wb = 1 bias is never broadcast.  In bf16 it reads the
//     rounded qkv that (b) wrote (the TPU kernel scores the f32 qkv; see
//     edrl_tpu_torch/kernels/block_attention.py).  o goes to a scratch
//     [B, W, N, C] in x's dtype, which the TPU kernel rounds o to as well.
// (d) y = x + (o . wproj + bproj), bias and residual added in f32, one
//     rounding to x's dtype.
//
// Two routes for the products, chosen here (edrl_attention_sublayer_route;
// block_attention.attention_sublayer_route mirrors it):
//
// - "wgmma", bf16 x: both products on the wgmma mainloop of hopper_gemm.cuh
//   (TMA into mbarrier rings, one producer warp, two consumer warpgroups,
//   persistent grids of 128 x 128 tiles, two CTAs per SM).  xln and o are
//   read K-major, wqkv [C, 3C] and wproj [C, C] MN-major as they lie: no
//   transpose, no scratch.  C is a multiple of 128, so 3C and C are whole
//   tiles.  The epilogues store through each warp's staging buffer in
//   whole row segments; (d)'s also reads x there in row segments.
// - "fma", f32 x (the correctness-check mode): f32 FMA tiles of 64 x 64 on
//   the CUDA cores (both operands f32, the TPU kernel's f32 product).

#include "attention_fwd.cuh"
#include "hopper_products.cuh"

extern "C" int edrl_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   int m, int c, float eps, int is_bf16, void* stream);

namespace {

constexpr float kSublayerLnEps = 1e-6f;

// out[row, col:col + 2] = acc + bias[col:col + 2] (f32 route).
struct F32QkvEpilogue {
  float* out;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(v0 + bias[col], v1 + bias[col + 1]);
  }
};

// out[row, col:col + 2] = x + (acc + bias) (f32 route).
struct F32ResidualEpilogue {
  float* out;
  const float* x;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    const size_t at = (size_t)row * n + col;
    *reinterpret_cast<float2*>(out + at) = make_float2(x[at] + (v0 + bias[col]), x[at + 1] + (v1 + bias[col + 1]));
  }
};

// y = bf16(x + (acc + bias)) for the rows below m (wgmma route): the bias
// and the residual added in f32, one rounding.
struct ResidualEpilogue {
  __nv_bfloat16* y;
  const __nv_bfloat16* x;
  const float* bias;
  int m, ld;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int, __nv_bfloat16* stage) const {
    const float* b = bias + n0 + acc_col0();
    store_rows_bf16_residual<BN>(stage, y, x, ld, m0 + 16 * (threadIdx.x >> 5), n0, m,
                                 [&](int j, int half, float2 r) {
                                   const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j);
                                   return __floats2bfloat162_rn(r.x + (acc[4 * j + 2 * half] + bj.x),
                                                                r.y + (acc[4 * j + 2 * half + 1] + bj.y));
                                 });
  }
};

// f32: epi(a[M, K] . w[K, N]) as f32 FMA, one 64 x 64 tile per block of 256
// threads; thread (ty, tx) owns rows ty + 16 i and column pairs 2 tx + 32 j.
constexpr int kSgTile = 64;
constexpr int kSgK = 16;

template <typename Epi>
__global__ void __launch_bounds__(256) sublayer_gemm_f32_kernel(const float* __restrict__ a,
                                                                const float* __restrict__ w, int m,
                                                                int k, int n, Epi epi) {
  __shared__ float a_s[kSgK][kSgTile + 4];  // transposed: a_s[kk][row]
  __shared__ __align__(16) float w_s[kSgK][kSgTile];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int row0 = blockIdx.x * kSgTile, col0 = blockIdx.y * kSgTile;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < k; k0 += kSgK) {
    {
      const int r = threadIdx.x >> 2, kk = (threadIdx.x & 3) * 4;
      const int row = row0 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < m) v = *reinterpret_cast<const float4*>(a + (size_t)row * k + k0 + kk);
      a_s[kk][r] = v.x;
      a_s[kk + 1][r] = v.y;
      a_s[kk + 2][r] = v.z;
      a_s[kk + 3][r] = v.w;
      const int wk = threadIdx.x >> 4, wc = (threadIdx.x & 15) * 4;
      *reinterpret_cast<float4*>(&w_s[wk][wc]) =
          *reinterpret_cast<const float4*>(w + (size_t)(k0 + wk) * n + col0 + wc);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSgK; ++kk) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 p = *reinterpret_cast<const float2*>(&w_s[kk][2 * tx + 32 * j]);
        wv[2 * j] = p.x;
        wv[2 * j + 1] = p.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) epi(row, col0 + 2 * tx + 32 * j, acc[i][2 * j], acc[i][2 * j + 1]);
  }
}

// epi(a[M, K] . w[K, N]) in f32; N a multiple of 64, K of 16.
template <typename Epi>
cudaError_t launch_gemm_f32(const float* a, const float* w, int m, int k, int n, const Epi& epi, cudaStream_t stream) {
  const dim3 grid((unsigned)((m + kSgTile - 1) / kSgTile), (unsigned)(n / kSgTile));
  sublayer_gemm_f32_kernel<Epi><<<grid, 256, 0, stream>>>(a, w, m, k, n, epi);
  return cudaGetLastError();
}

struct SublayerArgs {
  const void* x;
  const float* gamma;
  const float* beta;
  const void* wqkv;
  const float* bqkv;
  const void* wproj;
  const float* bproj;
  const float* bias;
  void* y;
  void* qkv;
  void* xln;
  void* o;
  int batch, windows, bias_windows, n, c, heads;
  float scale;
};

inline bool sublayer_shape_ok(int c, int heads) {
  return c % 128 == 0 && c >= 128 && c <= 2048 && heads >= 1 && c % heads == 0 && (c / heads) % 8 == 0 &&
         c / heads <= kMaxHeadDim;
}

// The products' route: wgmma for bf16, f32 FMA otherwise.
inline bool sublayer_route_wgmma(bool is_bf16) { return is_bf16; }

template <typename T>
cudaError_t run_attention(const SublayerArgs& s, cudaStream_t stream) {
  T* qkv = static_cast<T*>(s.qkv);
  AttnParams p = {};
  p.q = qkv;
  p.k = qkv + s.c;
  p.v = qkv + 2 * s.c;
  p.o = s.o;
  p.bias = s.bias;
  p.group_stride_in = (long long)s.n * 3 * s.c;
  p.group_stride_out = (long long)s.n * s.c;
  p.head_stride_in = s.c / s.heads;  // heads packed in columns
  p.head_stride_out = s.c / s.heads;
  p.row_stride_in = 3 * s.c;
  p.row_stride_out = s.c;
  p.num_groups = s.batch * s.windows;
  p.windows = s.bias_windows;  // group g = b * W + w reads bias window g % Wb
  p.heads = s.heads;
  p.n = s.n;
  p.d = s.c / s.heads;
  p.scale = s.scale;
  return launch_attention_fwd<T>(p, stream);
}

template <typename T>
cudaError_t run(const SublayerArgs& s, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int m = s.batch * s.windows * s.n;
  const int c = s.c;
  cudaError_t err = cudaSuccess;
  // The wgmma route's tensor maps: xln and o as A (K-major, boxes of 128
  // rows), wqkv and wproj as B (MN-major, boxes of 64 k-rows).
  CUtensorMap xln_map, wqkv_map, o_map, wproj_map;
  if constexpr (kBf16) {
    err = make_tile_map(&xln_map, s.xln, m, c, kGemmBM);
    if (err == cudaSuccess) err = make_tile_map(&wqkv_map, s.wqkv, c, 3 * c, 64);
    if (err == cudaSuccess) err = make_tile_map(&o_map, s.o, m, c, kGemmBM);
    if (err == cudaSuccess) err = make_tile_map(&wproj_map, s.wproj, c, c, 64);
    if (err != cudaSuccess) return err;
  }
  // (a) LayerNorm.
  err = (cudaError_t)edrl_layer_norm_fwd(s.x, s.gamma, s.beta, s.xln, m, c, kSublayerLnEps, (int)kBf16, stream);
  if (err != cudaSuccess) return err;
  // (b) qkv = xln . wqkv + bqkv.
  if constexpr (kBf16) {
    err = launch_wgmma_gemm<BiasEpilogue, false, true>(
        xln_map, wqkv_map, BiasEpilogue{static_cast<__nv_bfloat16*>(s.qkv), s.bqkv, m, 3 * c}, m, 3 * c, 1, c, c,
        stream);
  } else {
    err = launch_gemm_f32(static_cast<const float*>(s.xln), static_cast<const float*>(s.wqkv), m, c, 3 * c,
                          F32QkvEpilogue{static_cast<float*>(s.qkv), s.bqkv, 3 * c}, stream);
  }
  if (err != cudaSuccess) return err;
  // (c) attention per (b, w, h), q, k, v read in place from qkv.
  err = run_attention<T>(s, stream);
  if (err != cudaSuccess) return err;
  // (d) y = x + (o . wproj + bproj).
  if constexpr (kBf16) {
    return launch_wgmma_gemm<ResidualEpilogue, false, true>(
        o_map, wproj_map,
        ResidualEpilogue{static_cast<__nv_bfloat16*>(s.y), static_cast<const __nv_bfloat16*>(s.x), s.bproj, m, c}, m, c,
        1, c, c, stream);
  } else {
    return launch_gemm_f32(static_cast<const float*>(s.o), static_cast<const float*>(s.wproj), m, c, c,
                           F32ResidualEpilogue{static_cast<float*>(s.y), static_cast<const float*>(s.x), s.bproj, c},
                           stream);
  }
}

}  // namespace

// 1 if a call of this dtype and shape takes the wgmma route, 0 if it takes
// the f32 FMA route, -1 if the kernel refuses the shape (C a multiple of
// 128 up to 2048, C / heads a multiple of 8 up to 128).
// block_attention.attention_sublayer_route mirrors this.
extern "C" int edrl_attention_sublayer_route(int is_bf16, int c, int heads) {
  if (!sublayer_shape_ok(c, heads)) return -1;
  return sublayer_route_wgmma(is_bf16 != 0) ? 1 : 0;
}

// The wgmma route's product kernels: resident CTAs per SM (occupancy
// calculator) of the qkv product in out[0] and of the proj product in
// out[1], their dynamic shared memory in out[2] and threads per CTA in
// out[3].  Returns 0 or a CUDA error.
extern "C" int edrl_attention_sublayer_fwd_occupancy(int* out) {
  const size_t smem = ring_smem_bytes(kGemmStages, kGemmBN);
  out[2] = (int)smem;
  out[3] = kGemmThreads;
  cudaError_t err = blocks_per_sm(wgmma_gemm_kernel<BiasEpilogue, kGemmBN, false, true, kGemmStages, kGemmCtasPerSm>,
                                  kGemmThreads, smem, &out[0]);
  if (err != cudaSuccess) return (int)err;
  return (int)blocks_per_sm(wgmma_gemm_kernel<ResidualEpilogue, kGemmBN, false, true, kGemmStages, kGemmCtasPerSm>,
                            kGemmThreads, smem, &out[1]);
}

// x, y, xln, o (scratch): [batch, windows, n, c]; qkv: [batch, windows, n,
// 3c]; wqkv [c, 3c], wproj [c, c]: all bf16 (is_bf16) or all f32, the bf16
// ones 16-byte aligned.  gamma, beta, bproj [c], bqkv [3c], bias
// [bias_windows, heads, n, n]: f32.  c a multiple of 128 up to 2048, c /
// heads a multiple of 8 up to 128, bias_windows 1 or windows; the caller has
// checked the attention's shared memory.
extern "C" int edrl_attention_sublayer_fwd(const void* x, const void* gamma, const void* beta,
                                           const void* wqkv, const void* bqkv, const void* wproj,
                                           const void* bproj, const void* bias, void* y, void* qkv,
                                           void* xln, void* o, int batch, int windows, int bias_windows, int n,
                                           int c, int heads, float scale, int is_bf16, void* stream) {
  if (!sublayer_shape_ok(c, heads) || n < 1 || batch < 1 || windows < 1 ||
      (bias_windows != 1 && bias_windows != windows)) {
    return (int)cudaErrorInvalidValue;
  }
  const SublayerArgs s = {x,
                          static_cast<const float*>(gamma),
                          static_cast<const float*>(beta),
                          wqkv,
                          static_cast<const float*>(bqkv),
                          wproj,
                          static_cast<const float*>(bproj),
                          static_cast<const float*>(bias),
                          y,
                          qkv,
                          xln,
                          o,
                          batch,
                          windows,
                          bias_windows,
                          n,
                          c,
                          heads,
                          scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = sublayer_route_wgmma(is_bf16 != 0) ? run<__nv_bfloat16>(s, st) : run<float>(s, st);
  return (int)err;
}
