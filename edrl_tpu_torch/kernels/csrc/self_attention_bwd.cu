// Fused self-attention backward (B1) for the ViT-3D trunk.
//
// Replaces: edrl_tpu/kernels/window_attention.py, self_attention_fused's
// backward (_sa_bwd / _sa_bwd_kernel).  From q, k, v [B, N, C] (heads packed
// in columns) and the output's cotangent do [B, N, C] it recomputes the
// softmax and writes dq, dk and dv [B, N, C] in the input type.
//
// What bounds it on an H100: at the main-path shape [32, 216, 768] with 6
// heads of 128, each (b, h) needs 5 products of 2 * N^2 * D = 11.9 MFLOP
// (recomputed scores, dp, dv, dq, dk; 7 with ds as bf16 hi + lo) against
// about 387 KB of q, k, v, do, dq, dk and dv in bf16: ~154 FLOP/B, below the
// card's ~295 FLOP/B ridge for bf16 tensor cores, so the ideal kernel is
// bandwidth-bound (bound_ms in chip_smoke.py: 74 MB per call).  What the
// design does (attention_bwd.cuh, the "wgmma" route): bf16 calls run on
// wgmma fed by TMA, a rows kernel (one pass over each query tile's row of
// 224 keys split over two warpgroups: dq and the row statistics) and a keys
// kernel (64-key blocks with K and V resident, q and do streamed: dk and
// dv), 9 products per (b, h) at N = 216 counting the hi + lo halves.  Every
// operand is read in place through strides, the [N, N] probabilities never
// reach device memory (only three f32 numbers per row do), and no block
// waits on another.  f32 calls keep the CUDA-core route.
//
// Layout: B1 is attention_bwd.cuh with one window and no bias.

#include "attention_bwd.cuh"

// 1 if a call of this dtype and shape takes the wgmma route, 0 if it takes
// the CUDA-core route (kernels/window_attention.py mirrors this as
// attention_bwd_route).
extern "C" int edrl_attention_bwd_route(int is_bf16, int n, int d) {
  return attention_bwd_route_wgmma(is_bf16 != 0, n, d) ? 1 : 0;
}

// The wgmma route's launch plan for a call of batch * windows groups of
// heads heads of n tokens, the rows kernel walking batch_per_block entries
// a unit (attention_bwd_grid): out[0] and out[1] the rows kernel's CTAs and
// units, out[2] and out[3] the keys kernel's CTAs and units (two pipelines a
// CTA), out[4] the keys the rows kernel holds, out[5] and out[6] the
// registers of a consumer thread after setmaxnreg in the rows and the keys
// kernel.
extern "C" int edrl_attention_bwd_grid(int n, int batch, int windows, int heads, int batch_per_block, int* out) {
  out[4] = attention_bwd_keys(n);
  out[5] = kBwdRowsConsumerRegs;
  out[6] = kBwdKeysConsumerRegs;
  return (int)attention_bwd_grid(n, batch, windows, heads, batch_per_block, out);
}

// Dynamic shared memory the largest backward kernel of either route takes
// at (n, d).
extern "C" long long edrl_attention_bwd_smem_bytes(int n, int d, int with_dbias) {
  const size_t fma = attention_bwd_smem_bytes(false, n, d, with_dbias != 0);
  const size_t wgmma = attention_bwd_smem_bytes(true, n, d, with_dbias != 0);
  return (long long)(fma > wgmma ? fma : wgmma);
}

// The route's rows (dq) and keys (dk/dv) kernels at (n, d): resident blocks
// per SM, as the CUDA occupancy calculator gives them (registers, shared
// memory and threads per block), in out[0] and out[1], dynamic shared memory
// per block in out[2] and out[3]; returns 0 or a CUDA error.
extern "C" int edrl_attention_bwd_occupancy(int is_bf16, int n, int d, int with_dbias, int* out) {
  return (int)attention_bwd_occupancy(is_bf16 != 0, n, d, with_dbias != 0, out);
}

// stats: 3 * batch * heads * round_up(n, 64) f32 scratch (row max, row sum,
// delta).
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
  p.head_stride_in = c / heads;  // heads packed in columns
  p.head_stride_dout = c / heads;
  p.head_stride_grad = c / heads;
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
