// Fused MLP forward (B5).
//
// Replaces: edrl_tpu/kernels/fused_mlp.py, fused_mlp's forward (_fwd_call /
// _fwd_kernel).  y = bf16(gelu_tanh(u . bf16(W1) + b1)) . bf16(W2) + b2 over
// u [M, C] (bf16, or f32 kept f32), W1 [C, H], W2 [H, C] (f32 master weights
// when training, bf16 when serving; rounded to bf16 either way), b1 [H] and
// b2 [C] f32; y in u's dtype.
//
// What bounds it on an H100: 4 * M * C * H flops against the bytes of u, y
// and the weights: at C = 768, H = 3072 and M = 6,912 rows that is 65 GFLOP
// against ~30 MB, ~2,000 flop/byte, far above the ~295 flop/byte ridge:
// bound by the tensor cores' 989 TFLOP/s (bf16).
//
// What the design does about it (fused_mlp.cuh): the [M, H] hidden never
// reaches device memory.  A block stages its BM rows of u once and walks
// over the hidden units in chunks: [BM, BH] = u . W1-chunk on the tensor
// cores, + b1 and gelu in f32, rounded to bf16 in shared memory, then
// y[BM, C] += that . W2-chunk into f32 registers.  The TPU kernel holds an
// f32 [512, C] accumulator in VMEM (2 MB at C = 1024); a block here has
// 227 KB of shared memory and 64K registers, so the accumulator lives in
// registers for BM = 32 rows (128 floats a thread at C = 1024) rather than
// splitting C across blocks, which would recompute the hidden once per
// split.  The price is weight traffic: every block reads both weight
// matrices (from L2), 2 * C * H * 2 bytes per 32 rows, about 32 flops per
// byte of L2 traffic.  A first prep pass writes bf16 copies of W1 and W2
// transposed (so that each B fragment is two 32-bit shared loads), which
// also halves the L2 traffic of f32 master weights.  The weight chunks come
// in by cp.async, each into its buffer as soon as the product before it is
// done with it, so one chunk's loads overlap the other product; a block
// holds 32 rows of u and one chunk of each weight matrix (~216 KB at C =
// 1024), one block to an SM.  The products are mma.sync, not wgmma, and the
// staging is not TMA: those are the next steps.  f32 u (the
// correctness-check mode) takes the same path with BM = 16 and u split into
// three exact bf16 parts.

#include "fused_mlp.cuh"

namespace {

template <typename T, int BM>
size_t fwd_smem_bytes(int c) {
  constexpr int bh = kHiddenChunk;
  constexpr int kgroups = kMlpWarps / ((BM / 16) * (bh / 8));
  return (size_t)BM * (c + 8) * sizeof(T) +
         ((size_t)bh * (c + 8) + (size_t)c * (bh + 8) + (size_t)BM * (bh + 8)) * 2 +
         (size_t)kgroups * BM * bh * sizeof(float);
}

struct MlpFwdParams {
  const void* u;
  const __nv_bfloat16* w1t;  // [H, C]
  const float* b1;
  const __nv_bfloat16* w2t;  // [C, H]
  const float* b2;
  void* y;
  int m, c, h;
};

template <typename T, int BM, int NT>
__global__ void __launch_bounds__(kMlpThreads, 1) fused_mlp_fwd_kernel(MlpFwdParams p) {
  constexpr int BH = kHiddenChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = p.c;
  const int ldu = c + 8, ldw = c + 8, ldb = BH + 8;
  T* u_s = reinterpret_cast<T*>(smem_raw);                              // [BM][ldu]
  __nv_bfloat16* w1_s = reinterpret_cast<__nv_bfloat16*>(u_s + BM * ldu);  // [BH][ldw]
  __nv_bfloat16* w2_s = w1_s + BH * ldw;                                 // [C][ldb]
  __nv_bfloat16* a_s = w2_s + c * ldb;                                   // [BM][ldb]
  float* part = reinterpret_cast<float*>(a_s + BM * ldb);                // [groups][BM][BH]

  // Weight chunks arrive by cp.async, each as soon as its buffer is free:
  // W1's next chunk loads during this chunk's second product, W2's next
  // chunk during the next chunk's first product.
  auto load_w1 = [&](int h0) {
    stage_rows_async(w1_s, ldw, p.w1t, c, h0, BH, p.h, 0, c);
    cp_async_commit();
  };
  auto load_w2 = [&](int h0) {
    stage_rows_async(w2_s, ldb, p.w2t, p.h, 0, c, c, h0, BH);
    cp_async_commit();
  };
  load_w1(0);
  load_w2(0);
  const int row0 = blockIdx.x * BM;
  stage_rows(u_s, ldu, static_cast<const T*>(p.u), c, row0, BM, p.m, 0, c);

  float acc[BM / 16][NT][4];
#pragma unroll
  for (int mi = 0; mi < BM / 16; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;

  for (int h0 = 0; h0 < p.h; h0 += BH) {
    const bool more = h0 + BH < p.h;
    cp_async_wait<1>();  // this chunk's W1 (its W2 may still be in flight)
    __syncthreads();
    gemm_small<T, BM, BH>(u_s, ldu, w1_s, ldw, c, part);
    __syncthreads();  // W1's buffer is free, the partials are complete
    if (more) load_w1(h0 + BH);
    for (int i = threadIdx.x; i < BM * BH; i += kMlpThreads) {
      const int r = i / BH, j = i - r * BH;
      const float hidden = small_sum<BM, BH>(part, r, j) + p.b1[h0 + j];
      a_s[r * ldb + j] = __float2bfloat16(gelu_tanh(hidden));
    }
    if (more) {
      cp_async_wait<1>();  // this chunk's W2 (the next W1 may still be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    gemm_wide<BM, BH, NT>(acc, a_s, ldb, w2_s, ldb);
    __syncthreads();  // W2's buffer and the activations are free
    if (more) load_w2(h0 + BH);
  }
  store_wide<T, BM, NT>(acc, static_cast<T*>(p.y), c, row0, p.m, p.b2);
}

template <typename T>
struct LaunchMlpFwd {
  MlpFwdParams p;
  cudaStream_t stream;

  template <int NT>
  cudaError_t operator()() const {
    constexpr int BM = std::is_same<T, float>::value ? 16 : 32;
    const size_t smem = fwd_smem_bytes<T, BM>(p.c);
    cudaError_t err = allow_smem(fused_mlp_fwd_kernel<T, BM, NT>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((p.m + BM - 1) / BM);
    fused_mlp_fwd_kernel<T, BM, NT><<<blocks, kMlpThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace

// u, y: [m, c] bf16 (u_is_bf16) or f32; w1 [c, h], w2 [h, c] bf16
// (w_is_bf16) or f32; b1 [h], b2 [c] f32; w1t [h, c] and w2t [c, h] bf16
// scratch.  c a multiple of 128 and at most 1024, h a multiple of 32.
// Launches the two weight preps, then the fused kernel.
extern "C" int edrl_fused_mlp_fwd(const void* u, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, void* w1t, void* w2t, int m, int c,
                                  int h, int u_is_bf16, int w_is_bf16, void* stream) {
  if (c % 128 != 0 || c > kMlpMaxC || h % 32 != 0 || h < 32 || m < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* w1t_b = static_cast<__nv_bfloat16*>(w1t);
  __nv_bfloat16* w2t_b = static_cast<__nv_bfloat16*>(w2t);
  cudaError_t err = w_is_bf16 ? launch_transpose_bf16<__nv_bfloat16>(w1, w1t_b, c, h, s)
                              : launch_transpose_bf16<float>(w1, w1t_b, c, h, s);
  if (err != cudaSuccess) return (int)err;
  err = w_is_bf16 ? launch_transpose_bf16<__nv_bfloat16>(w2, w2t_b, h, c, s)
                  : launch_transpose_bf16<float>(w2, w2t_b, h, c, s);
  if (err != cudaSuccess) return (int)err;
  const MlpFwdParams p = {u, w1t_b, static_cast<const float*>(b1), w2t_b,
                          static_cast<const float*>(b2), y, m, c, h};
  err = u_is_bf16 ? dispatch_nt(c, LaunchMlpFwd<__nv_bfloat16>{p, s})
                  : dispatch_nt(c, LaunchMlpFwd<float>{p, s});
  return (int)err;
}
