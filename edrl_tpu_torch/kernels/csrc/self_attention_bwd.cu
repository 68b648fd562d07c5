// Fused self-attention backward (B1) for the ViT-3D trunk.
//
// Replaces: edrl_tpu/kernels/window_attention.py, self_attention_fused's
// backward (_sa_bwd / _sa_bwd_kernel).  From q, k, v [B, N, C] (heads packed
// in columns) and the output's cotangent do [B, N, C] it recomputes the
// softmax and writes dq, dk and dv [B, N, C] in the input type.
//
// What bounds it on an H100: at the main-path shape [32, 216, 768] with 6
// heads of 128, each (b, h) needs 5 products of 2 * N^2 * D = 11.9 MFLOP
// (recomputed scores, dp, dv, dq, dk) against about 387 KB of q, k, v, do,
// dq, dk and dv in bf16: ~154 FLOP/B, below the card's ~295 FLOP/B ridge for
// bf16 tensor cores, so the ideal kernel is bandwidth-bound (bound_ms in
// chip_smoke.py).  This first version runs its products as f32 FMA on the
// CUDA cores (attention_bwd.cuh), so it is bound by those operations, and it
// recomputes the scores and dp in both of its kernels (7 products instead
// of 5).  What the design does: every operand is read in place through
// strides, the [N, N] probabilities never reach device memory (only three
// f32 numbers per row do), and no block waits on another.
//
// Layout: B1 is attention_bwd.cuh with one window and no bias.

#include "attention_bwd.cuh"

// Dynamic shared memory the larger of the two backward kernels takes at (n, d).
extern "C" long long edrl_attention_bwd_smem_bytes(int n, int d, int with_dbias) {
  const size_t dq = attention_bwd_dq_smem_bytes(n, d, with_dbias != 0);
  const size_t dkv = attention_bwd_dkv_smem_bytes(d);
  return (long long)(dq > dkv ? dq : dkv);
}

// stats: 3 * batch * heads * n f32 scratch (row max, row sum, delta).
extern "C" int edrl_self_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* stats, int batch, int n, int c, int heads,
                                       float scale, int is_bf16, void* stream) {
  AttnBwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bias = nullptr;
  p.dbias = nullptr;
  const size_t rows = (size_t)batch * heads * n;
  p.row_m = static_cast<float*>(stats);
  p.row_l = p.row_m + rows;
  p.row_delta = p.row_l + rows;
  p.group_stride_in = (long long)n * c;
  p.group_stride_dout = (long long)n * c;
  p.group_stride_grad = (long long)n * c;
  p.row_stride_in = c;
  p.row_stride_dout = c;
  p.row_stride_grad = c;
  p.batch = batch;
  p.windows = 1;
  p.batch_per_block = 1;
  p.heads = heads;
  p.n = n;
  p.d = c / heads;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch_attention_bwd<__nv_bfloat16>(p, nullptr, s)
                            : launch_attention_bwd<float>(p, nullptr, s);
  return (int)err;
}
