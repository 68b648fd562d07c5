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
// shared memory.  So the sublayer runs as three phases on one stream, each
// over a grid that fills the card, reusing the port's device code:
//
// (a) B4's LayerNorm forward (edrl_layer_norm_fwd: a warp per row, two-pass
//     f32 statistics) writes xln; then xln . wqkv + bqkv: in bf16 tiles of
//     128 rows x 64 columns on the tensor cores (tile_product of
//     fused_mlp.cuh: mma.sync, cp.async double buffering, f32 accumulate,
//     the weights transposed once per call so that K is contiguous), in f32
//     tiles of 64 x 64 as f32 FMA on the CUDA cores (both operands f32, the
//     TPU kernel's f32 product); the f32 bias is added to the f32 sum.
// (b) the attention of attention_fwd.cuh per (b, w, h, query tile),
//     reading q, k and v in place from qkv and the bias with window index
//     g % Wb, so a Wb = 1 bias is never broadcast.  In bf16 it reads the
//     rounded qkv that (a) wrote (the TPU kernel scores the f32 qkv; see
//     edrl_tpu_torch/kernels/block_attention.py).  o goes to a scratch
//     [B, W, N, C] in x's dtype, which the TPU kernel rounds o to as well.
// (c) o . wproj as in (a), with the epilogue + bproj + x in f32 and one
//     rounding to x's dtype.
//
// wgmma, TMA and fusing the phases are later work.

#include "attention_fwd.cuh"
#include "fused_mlp.cuh"

extern "C" int edrl_layer_norm_fwd(const void* x, const void* gamma, const void* beta, void* y,
                                   int m, int c, float eps, int is_bf16, void* stream);

namespace {

constexpr float kSublayerLnEps = 1e-6f;

// out[row, col:col + 2] = acc + bias[col:col + 2].
template <typename T>
struct QkvEpilogue {
  T* out;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    store2<T>(out + (size_t)row * n + col, v0 + bias[col], v1 + bias[col + 1]);
  }
};

// out[row, col:col + 2] = x + (acc + bias), rounded once.
template <typename T>
struct ResidualEpilogue {
  T* out;
  const T* x;
  const float* bias;
  int n;
  __device__ __forceinline__ void operator()(int row, int col, float v0, float v1) const {
    const size_t at = (size_t)row * n + col;
    store2<T>(out + at, to_f32(x[at]) + (v0 + bias[col]), to_f32(x[at + 1]) + (v1 + bias[col + 1]));
  }
};

// bf16: epi(a[M, K] . wt[N, K]^T), one 128 x 64 tile per block.
template <typename Epi>
__global__ void __launch_bounds__(kMlpThreads) sublayer_gemm_bf16_kernel(const __nv_bfloat16* a,
                                                                         const __nv_bfloat16* wt, int m,
                                                                         int k, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row0 = blockIdx.x * kTileM, col0 = blockIdx.y * kTileN;
  float acc[2][4][4];
  zero(acc);
  tile_product<AFrag<__nv_bfloat16>, __nv_bfloat16>(acc, a, k, row0, m, wt, k, col0, k, smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = col0 + wn + ni * 8 + 2 * t;
      const int row = row0 + wm + mi * 16 + g;
      if (row < m) epi(row, col, acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < m) epi(row + 8, col, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

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

// epi(a[M, K] . w[K, N]); N a multiple of 64, K of 32.  bf16 transposes w
// into wt [N, K] first.
template <typename T, typename Epi>
cudaError_t launch_gemm(const T* a, const T* w, __nv_bfloat16* wt, int m, int k, int n, const Epi& epi,
                        cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    cudaError_t err = launch_transpose_bf16<__nv_bfloat16>(w, wt, k, n, stream);
    if (err != cudaSuccess) return err;
    const size_t smem = tile_smem_bytes<__nv_bfloat16>();
    err = allow_smem(sublayer_gemm_bf16_kernel<Epi>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((m + kTileM - 1) / kTileM), (unsigned)(n / kTileN));
    sublayer_gemm_bf16_kernel<Epi><<<grid, kMlpThreads, smem, stream>>>(a, wt, m, k, epi);
  } else {
    const dim3 grid((unsigned)((m + kSgTile - 1) / kSgTile), (unsigned)(n / kSgTile));
    sublayer_gemm_f32_kernel<Epi><<<grid, 256, 0, stream>>>(a, w, m, k, n, epi);
  }
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
  __nv_bfloat16* wqkv_t;
  __nv_bfloat16* wproj_t;
  int batch, windows, bias_windows, n, c, heads;
  float scale;
};

template <typename T>
cudaError_t run(const SublayerArgs& s, cudaStream_t stream) {
  const int m = s.batch * s.windows * s.n;
  const int c = s.c;
  T* qkv = static_cast<T*>(s.qkv);
  // (a) LayerNorm, then qkv = xln . wqkv + bqkv.
  cudaError_t err = (cudaError_t)edrl_layer_norm_fwd(s.x, s.gamma, s.beta, s.xln, m, c, kSublayerLnEps,
                                                     (int)std::is_same<T, __nv_bfloat16>::value, stream);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T>(static_cast<const T*>(s.xln), static_cast<const T*>(s.wqkv), s.wqkv_t, m, c, 3 * c,
                       QkvEpilogue<T>{qkv, s.bqkv, 3 * c}, stream);
  if (err != cudaSuccess) return err;
  // (b) attention per (b, w, h), q, k, v read in place from qkv.
  AttnParams p = {};
  p.q = qkv;
  p.k = qkv + c;
  p.v = qkv + 2 * c;
  p.o = s.o;
  p.bias = s.bias;
  p.group_stride_in = (long long)s.n * 3 * c;
  p.group_stride_out = (long long)s.n * c;
  p.row_stride_in = 3 * c;
  p.row_stride_out = c;
  p.num_groups = s.batch * s.windows;
  p.windows = s.bias_windows;  // group g = b * W + w reads bias window g % Wb
  p.heads = s.heads;
  p.n = s.n;
  p.d = c / s.heads;
  p.scale = s.scale;
  err = launch_attention_fwd<T>(p, stream);
  if (err != cudaSuccess) return err;
  // (c) y = x + (o . wproj + bproj).
  return launch_gemm<T>(static_cast<const T*>(s.o), static_cast<const T*>(s.wproj), s.wproj_t, m, c, c,
                        ResidualEpilogue<T>{static_cast<T*>(s.y), static_cast<const T*>(s.x), s.bproj, c},
                        stream);
}

}  // namespace

// x, y, xln, o (scratch): [batch, windows, n, c]; qkv: [batch, windows, n,
// 3c]; wqkv [c, 3c], wproj [c, c]: all bf16 (is_bf16) or all f32.  gamma,
// beta, bproj [c], bqkv [3c], bias [bias_windows, heads, n, n]: f32.  bf16
// scratch wqkv_t [3c, c] and wproj_t [c, c] (unused in f32).  c a multiple
// of 128 up to 2048, c / heads a multiple of 8 up to 128, bias_windows 1 or
// windows; the caller has checked the attention's shared memory.
extern "C" int edrl_attention_sublayer_fwd(const void* x, const void* gamma, const void* beta,
                                           const void* wqkv, const void* bqkv, const void* wproj,
                                           const void* bproj, const void* bias, void* y, void* qkv,
                                           void* xln, void* o, void* wqkv_t, void* wproj_t, int batch,
                                           int windows, int bias_windows, int n, int c, int heads,
                                           float scale, int is_bf16, void* stream) {
  if (c % 128 != 0 || c > 2048 || heads < 1 || c % heads != 0 || (c / heads) % 8 != 0 ||
      c / heads > kMaxHeadDim || n < 1 || batch < 1 || windows < 1 ||
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
                          static_cast<__nv_bfloat16*>(wqkv_t),
                          static_cast<__nv_bfloat16*>(wproj_t),
                          batch,
                          windows,
                          bias_windows,
                          n,
                          c,
                          heads,
                          scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? run<__nv_bfloat16>(s, st) : run<float>(s, st);
  return (int)err;
}
