// Fused self-attention forward (B1) for the ViT-3D trunk.
//
// Replaces: edrl_tpu/kernels/window_attention.py, self_attention_fused
// (its forward, _sa_fwd_call / _sa_fwd_kernel).  Per head,
// softmax(q k^T * scale) v, with q, k and v three [B, N, C] tensors whose
// heads are packed in columns (the raw q/k/v projection outputs) and the
// output written as [B, N, C].
//
// What bounds it on an H100: at the main-path shape [16, 216, 768] with
// 6 heads of 128, each (b, h) does 4 * N^2 * D = 23.9 MFLOP against about
// 221 KB of q, k, v and o in bf16, about 108 FLOP/B.  That is below the
// card's ~295 FLOP/B ridge for bf16 tensor cores, so the fused op is
// bandwidth- and latency-bound: 384 blocks (16 batch x 6 heads x 4 query
// tiles) fill the 132 SMs less than twice, and each block's loads of K and V
// sit between its two products.
//
// What the design does about it (attention_fwd.cuh): q, k and v are read
// once per block straight from their packed layout (no transposes in the
// wrapper), with 16-byte loads; the score rows never leave registers; o is
// written once.  bf16 inputs run both products on the tensor cores
// (mma.sync), ~78 KB of shared memory and 128 threads per block, two blocks
// to an SM.  f32 inputs (used for exact comparisons) take the CUDA-core
// kernel.  Overlapping the K/V loads with compute (cp.async or TMA) and
// wgmma are the next steps.

#include "attention_fwd.cuh"

// Dynamic shared memory one block of either entry point takes at (n, d).
extern "C" long long edrl_attention_smem_bytes(int n, int d) {
  return (long long)attention_smem_bytes(n, d);
}

extern "C" int edrl_self_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int n, int c, int heads, float scale,
                                       int is_bf16, void* stream) {
  AttnParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bias = nullptr;
  p.group_stride_in = (long long)n * c;
  p.group_stride_out = (long long)n * c;
  p.row_stride_in = c;
  p.row_stride_out = c;
  p.num_groups = batch;
  p.windows = 1;
  p.heads = heads;
  p.n = n;
  p.d = c / heads;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch_attention_fwd<__nv_bfloat16>(p, s)
                            : launch_attention_fwd<float>(p, s);
  return (int)err;
}
