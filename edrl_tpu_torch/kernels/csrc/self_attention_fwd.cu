// Fused self-attention forward (B1) for the ViT-3D trunk.
//
// Replaces: edrl_tpu/kernels/window_attention.py, self_attention_fused
// (its forward, _sa_fwd_call / _sa_fwd_kernel).  Per head,
// softmax(q k^T * scale) v, with q, k and v three [B, N, C] tensors whose
// heads are packed in columns (the raw q/k/v projection outputs) and the
// output written as [B, N, C].
//
// What bounds it on an H100: at the main-path shape [32, 216, 768] with 6
// heads of 128, each (b, h) does 4 * N^2 * D = 23.9 MFLOP against about
// 221 KB of q, k, v and o in bf16, about 108 FLOP/B, below the card's
// ~295 FLOP/B ridge for bf16 tensor cores: the call is bound by its 42 MB
// (13 us), and in practice by the latency each block hides.
//
// What the design does about it (attention_fwd.cuh): q, k and v are read
// in place from their packed layout (no transposes in the wrapper), by
// 16-byte cp.async into a ring of 16-key chunks that is filled two chunks
// ahead of the products; the softmax is online, so no score row is kept;
// 2 query tiles of 7 warps cover the 216 rows (224 computed); bf16 inputs
// run both products on the tensor cores (mma.sync, ldmatrix fragments).
// f32 inputs (used for exact comparisons) take the CUDA-core kernel.
// The choice is exposed as edrl_attention_fwd_route.

#include "attention_fwd.cuh"

// 1 if a forward call of this dtype and shape takes the tensor-core route, 0
// if it takes the CUDA-core route (kernels/window_attention.py mirrors this
// as attention_fwd_route).
extern "C" int edrl_attention_fwd_route(int is_bf16, int n, int d) {
  return attention_fwd_route_mma(is_bf16 != 0, n, d) ? 1 : 0;
}

// Dynamic shared memory one block of the forward's route takes at (n, d),
// with or without a bias.
extern "C" long long edrl_attention_fwd_smem_bytes(int is_bf16, int n, int d, int with_bias) {
  return (long long)attention_fwd_smem_bytes(is_bf16 != 0, n, d, with_bias != 0);
}

// The forward route's kernel at (n, d): resident blocks per SM (occupancy
// calculator) in out[0], dynamic shared memory per block in out[1], warps
// per block in out[2]; returns 0 or a CUDA error.
extern "C" int edrl_attention_fwd_occupancy(int is_bf16, int n, int d, int with_bias, int* out) {
  return (int)attention_fwd_occupancy(is_bf16 != 0, n, d, with_bias != 0, out);
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
  p.head_stride_in = c / heads;  // heads packed in columns
  p.head_stride_out = c / heads;
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
