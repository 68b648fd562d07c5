// Fused Swin window attention backward: B2 (packed qkv) and v1 ([B, W, H, N,
// D]), one entry point addressing its operands through the strides the
// caller passes (window_attention.attention_strides).
//
// Replaces: edrl_tpu/kernels/window_attention.py, window_attention_fused_v2's
// backward (_v2_bwd / _attn_bwd_kernel_v2) and window_attention_fused's (v1:
// _bwd_call / _attn_bwd_kernel).  From q, k, v, the bias [W, H, N, N] f32 and
// the output's cotangent do it recomputes the softmax and writes dq, dk, dv
// in q's layout and dbias [W, H, N, N] f32 summed over the batch.  B2: q, k
// and v are column blocks of the packed qkv [B, W, N, 3C] (head stride D),
// and dq, dk and dv go straight into one packed dqkv [B, W, N, 3C] (columns
// h*D, C + h*D, 2C + h*D: the TPU version needed a concatenate for this); do
// is [B, W, N, C].  v1: q (pre-scaled; scale 1, so dq is unscaled and dk
// takes the pre-scaled q), k, v, do, dq, dk and dv are [B, W, H, N, D] (head
// stride N*D), with no packing or unpacking around the kernels.
//
// What bounds it on an H100: at N = 144 and head_dim 128, each (b, w, h)
// needs 5 products of 2 * N^2 * D = 5.3 MFLOP (7 with ds as bf16 hi + lo)
// against about 258 KB of qkv, do and dqkv in bf16 plus the 83 KB f32 bias
// and dbias per (w, h): ~80 FLOP/B, below the ~295 FLOP/B ridge, so the
// ideal kernel is bandwidth-bound.  What the design does (attention_bwd.cuh,
// the "wgmma" route): bf16 calls (every Swin stage, and N = 216 with W = 1
// under the fused attention sublayer) run on wgmma fed by TMA: a rows kernel
// that holds the head's K and V (160 keys at N = 144, 224 at 216), splits
// them over two warpgroups and makes one pass over each 64-row query tile
// (dq, the row statistics, the chunk's dbias in registers), and a keys
// kernel that streams q and do past 64-key blocks (dk, dv); f32 calls keep
// the CUDA-core route.
//
// The batch reduction of dbias: the TPU kernel accumulated it over a
// sequential batch grid.  Here each unit of the rows kernel walks over a
// chunk of the batch and sums its ds in registers; the chunk size is chosen
// by the caller (window_attention.dbias_chunking: the shortest walk of the
// persistent grid, less the partials' traffic), and a small kernel sums the
// chunks' partials in a fixed order.  The result is deterministic.

#include "attention_bwd.cuh"

namespace {

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const float* bias, float* bias_tiles, const void* dout,
                void* dq, void* dk, void* dv, float* dbias_partial, float* dbias, float* stats, int batch, int windows,
                int heads, int n, int d, long long in_group, long long in_head, int in_row, long long out_group,
                long long out_head, int out_row, int batch_per_block, float scale, cudaStream_t stream) {
  AttnBwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bias = bias;
  p.bias_tiles = bias_tiles;
  p.dbias = dbias_partial;
  const size_t rows = (size_t)batch * windows * heads * n;
  p.row_m = stats;
  p.row_l = stats + rows;
  p.row_delta = stats + 2 * rows;
  p.group_stride_in = p.group_stride_grad = in_group;
  p.head_stride_in = p.head_stride_grad = in_head;
  p.row_stride_in = p.row_stride_grad = in_row;
  p.group_stride_dout = out_group;
  p.head_stride_dout = out_head;
  p.row_stride_dout = out_row;
  p.batch = batch;
  p.windows = windows;
  p.batch_per_block = batch_per_block;
  p.heads = heads;
  p.n = n;
  p.d = d;
  p.scale = scale;
  return launch_attention_bwd<T>(p, dbias, stream);
}

}  // namespace

// q, k, v, dq, dk and dv share the (group, head, row) strides in_*, dout
// takes out_*; each pointer is the operand's element (group 0, head 0, token
// 0, feature 0).  dbias_partial: ceil(batch / batch_per_block) * windows *
// heads * n * n f32 (dbias itself when that is one chunk).  stats: 3 * batch
// * windows * heads * round_up(n, 64) f32.  bias_tiles: the bias in the
// wgmma route's keys-kernel order, windows * heads * ceil(n / 64)^2 * 4096
// f32 (attention_bwd_bias_tiles_floats; unused on the CUDA-core route).
extern "C" int edrl_window_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                         void* bias_tiles, const void* dout, void* dq, void* dk, void* dv,
                                         void* dbias_partial, void* dbias, void* stats, int batch, int windows,
                                         int heads, int n, int d,
                                         long long in_group, long long in_head, int in_row, long long out_group,
                                         long long out_head, int out_row, int batch_per_block, float scale,
                                         int is_bf16, void* stream) {
  const float* b = static_cast<const float*>(bias);
  float* bt = static_cast<float*>(bias_tiles);
  float* part = static_cast<float*>(dbias_partial);
  float* db = static_cast<float*>(dbias);
  float* st = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? run<__nv_bfloat16>(q, k, v, b, bt, dout, dq, dk, dv, part, db, st, batch, windows, heads, n, d,
                                   in_group, in_head, in_row, out_group, out_head, out_row, batch_per_block, scale, s)
              : run<float>(q, k, v, b, bt, dout, dq, dk, dv, part, db, st, batch, windows, heads, n, d, in_group,
                           in_head, in_row, out_group, out_head, out_row, batch_per_block, scale, s);
  return (int)err;
}
