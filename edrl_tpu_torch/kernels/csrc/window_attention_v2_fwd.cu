// Fused Swin window attention forward: B2 (packed qkv) and v1 ([B, W, H, N,
// D]), one entry point addressing its operands through the strides the
// caller passes (window_attention.attention_strides).
//
// Replaces: edrl_tpu/kernels/window_attention.py, window_attention_fused_v2
// (its forward, _v2_fwd_call / _attn_fwd_kernel_v2) and window_attention_fused
// (v1's forward, _fwd_call / _attn_fwd_kernel).  Per (batch, window, head),
// softmax(q k^T * scale + bias) v, with the bias [W, H, N, N] f32 added in
// f32 (relative-position bias plus the -1e9 shift mask).  B2 reads q, k and
// v as column blocks h*D, C + h*D and 2C + h*D of the packed qkv [B, W, N,
// 3C] (group stride N*3C, head stride D, row stride 3C) and writes o as
// [B, W, N, C]; v1 reads q (pre-scaled; scale 1), k and v and writes o as
// [B, W, H, N, D] (group stride H*N*D, head stride N*D, row stride D), with
// no packing of q, k, v or unpacking of o around the kernel.
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
cudaError_t run(const void* q, const void* k, const void* v, const float* bias, void* o, int batch,
                int windows, int heads, int n, int d, long long in_group, long long in_head, int in_row,
                long long out_group, long long out_head, int out_row, float scale, cudaStream_t stream) {
  AttnParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.bias = bias;
  p.group_stride_in = in_group;
  p.group_stride_out = out_group;
  p.head_stride_in = in_head;
  p.head_stride_out = out_head;
  p.row_stride_in = in_row;
  p.row_stride_out = out_row;
  p.num_groups = batch * windows;
  p.windows = windows;
  p.heads = heads;
  p.n = n;
  p.d = d;
  p.scale = scale;
  return launch_attention_fwd<T>(p, stream);
}

}  // namespace

// q, k and v share the (group, head, row) strides in_*, o takes out_*; each
// pointer is the operand's element (group 0, head 0, token 0, feature 0).
extern "C" int edrl_window_attention_fwd(const void* q, const void* k, const void* v, const void* bias, void* o,
                                         int batch, int windows, int heads, int n, int d, long long in_group,
                                         long long in_head, int in_row, long long out_group, long long out_head,
                                         int out_row, float scale, int is_bf16, void* stream) {
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? run<__nv_bfloat16>(q, k, v, b, o, batch, windows, heads, n, d, in_group, in_head,
                                                 in_row, out_group, out_head, out_row, scale, s)
                            : run<float>(q, k, v, b, o, batch, windows, heads, n, d, in_group, in_head, in_row,
                                         out_group, out_head, out_row, scale, s);
  return (int)err;
}
