// Fused Swin window attention forward (B2), packed-qkv layout.
//
// Replaces: edrl_tpu/kernels/window_attention.py, window_attention_fused_v2
// (its forward, _v2_fwd_call / _attn_fwd_kernel_v2).  Per (batch, window,
// head), softmax(q k^T * scale + bias) v, with q, k and v read as column
// blocks h*D, C + h*D and 2C + h*D of the packed qkv [B, W, N, 3C] (row
// stride 3C), the bias [W, H, N, N] f32 added in f32 (relative-position bias
// plus the -1e9 shift mask), and the output written as [B, W, N, C].
//
// What bounds it on an H100: at N = 144 and head_dim 128, each (b, w, h)
// does 4 * N^2 * D = 10.6 MFLOP against about 147 KB of q, k, v and o in
// bf16 plus an 83 KB f32 bias, about 46 FLOP/B: far below the card's
// ~295 FLOP/B ridge for bf16 tensor cores, so the fused op is bandwidth- and
// latency-bound.
//
// What the design does about it (attention_fwd.cuh): q, k and v are read in
// place from the qkv projection output, and o is written straight into
// [B, W, N, C], so the attention path has no layout copy.  bf16 streams the
// keys, values and the block's f32 bias rows in 16-key chunks through a
// cp.async ring two chunks ahead of the products, takes the softmax online
// and runs both products on the tensor cores (mma.sync).  The bias is the
// only operand that repeats across the batch; the TPU kernel reused it by
// looping a block over batch rows, and here the per-stage bias (5.3 MB at
// stage 0, less later) stays in the 50 MB L2 while the batch rows' blocks
// read it, so device memory sees it about once.  A block per (b, w, h,
// 48-query tile) gives 6144 blocks of 3 warps at stage 0 and 768 at stage 3
// of a batch-32 step, with no padded rows.  f32 inputs take the CUDA-core
// kernel.

#include "attention_fwd.cuh"

namespace {

template <typename T>
cudaError_t run(const void* qkv, const float* bias, void* o, int batch, int windows, int n,
                int c, int heads, float scale, cudaStream_t stream) {
  const T* base = static_cast<const T*>(qkv);
  AttnParams p = {};
  p.q = base;
  p.k = base + c;
  p.v = base + 2 * c;
  p.o = o;
  p.bias = bias;
  p.group_stride_in = (long long)n * 3 * c;
  p.group_stride_out = (long long)n * c;
  p.row_stride_in = 3 * c;
  p.row_stride_out = c;
  p.num_groups = batch * windows;
  p.windows = windows;
  p.heads = heads;
  p.n = n;
  p.d = c / heads;
  p.scale = scale;
  return launch_attention_fwd<T>(p, stream);
}

}  // namespace

extern "C" int edrl_window_attention_v2_fwd(const void* qkv, const void* bias, void* o,
                                            int batch, int windows, int n, int c, int heads,
                                            float scale, int is_bf16, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? run<__nv_bfloat16>(qkv, b, o, batch, windows, n, c, heads, scale, s)
              : run<float>(qkv, b, o, batch, windows, n, c, heads, scale, s);
  return (int)err;
}
