// Fused attention sublayer backward (B6), the bf16 route's products.
//
// Replaces: edrl_tpu/kernels/block_attention.py, attention_sublayer_fused's
// backward (_v4_bwd), outside B2's kernels.  The JAX VJP recomputes o with
// B2's forward, runs B2's backward for dqkv and dbias, and around them four
// products and two column sums, which XLA runs.  Each Dense layer of the
// sublayer (o . wproj and xln . wqkv) has the same backward: from its input
// a [M, P], its output's cotangent dout [M, Q] and its weight w [P, Q],
//
//     dw = bf16(a^T . dout)     [P, Q], f32 sum over M, one rounding
//     db = sum over M of dout   [Q] f32
//     da = dout . w^T           [M, P], f32 sum: rounded to bf16 (the proj
//                               layer's do) or kept f32 (the qkv layer's dxln)
//
// with every operand bf16: o, xln, dy and dqkv are the exact bf16 values the
// JAX VJP casts to f32, whose products f32 accumulation keeps exact, so
// bf16 tensor-core products with f32 sums compute its function up to the
// order of the sums.  The LayerNorm backward that follows (B4's residual
// form, layer_norm_bwd.cu) adds dy to its dx in f32 and rounds once.
//
// What bounds it on an H100: 6 * M * P * Q flops against the bytes of a,
// dout, da and the weights: ~3 * M * (P + Q) * 2 bytes.  At the Swin stage
// 0's qkv layer (P = 128, Q = 384) that is ~96 flops per byte, below the
// card's ~295 flops per byte ridge (bound by bytes); from C = 512 on it is
// above (bound by the tensor cores).
//
// What the design does about it: no f32 copy of any operand.  Each product
// runs on the wgmma mainloop of hopper_gemm.cuh (TMA rings, persistent
// grids of 128 x 128 tiles) reading its operands as they lie: dw with both
// operands MN-major over 64-row slices of M, split over M by the wrapper's
// planner (fused_mlp.wgmma_wgrad_splits, as B5's weight gradients) into f32
// partials that column_sum4_kernel adds in a fixed order and rounds once;
// da with dout K-major and w K-major ([P, Q] is w^T's [N, K]).  db comes
// from column partials over blocks of rows (col_partials_kernel, 16-byte
// loads) added in a fixed order (column_sum_kernel).  No atomics: dw and db
// are the same bit for bit from run to run.

#include "hopper_products.cuh"

namespace {

cudaError_t run_dense_bwd(const void* a, const void* dout, const void* w, __nv_bfloat16* dw, float* db, void* da,
                          float* dw_part, float* db_part, int m, int p, int q, int splits, int chunk,
                          int rows_per_part, bool da_f32, cudaStream_t s) {
  CUtensorMap dout_map, w_map;
  cudaError_t err = make_tile_map(&dout_map, dout, m, q, kGemmBM);
  if (err == cudaSuccess) err = make_tile_map(&w_map, w, p, q, kGemmBN);
  if (err != cudaSuccess) return err;
  if (da_f32) {
    err = launch_wgmma_gemm<StoreF32Epilogue, false, false>(dout_map, w_map, StoreF32Epilogue{static_cast<float*>(da), m, p},
                                                            m, p, 1, q, q, s);
  } else {
    err = launch_wgmma_gemm<StoreEpilogue, false, false>(
        dout_map, w_map, StoreEpilogue{static_cast<__nv_bfloat16*>(da), m, p}, m, p, 1, q, q, s);
  }
  if (err != cudaSuccess) return err;
  err = launch_wgrad_wgmma<__nv_bfloat16>(a, dout, dw, dw_part, m, p, q, splits, chunk, s);
  if (err != cudaSuccess) return err;
  err = launch_col_partials(dout, db_part, m, q, rows_per_part, s);
  if (err != cudaSuccess) return err;
  return launch_column_sum(db_part, db, (m + rows_per_part - 1) / rows_per_part, q, s);
}

}  // namespace

// The backward kernels: resident CTAs per SM (occupancy calculator) of the
// da product with a bf16 result in out[0] and an f32 one in out[1], of the
// weight-gradient product in out[2]; their dynamic shared memory in out[3].
// Returns 0 or a CUDA error.
extern "C" int edrl_attention_sublayer_bwd_occupancy(int* out) {
  const size_t smem = ring_smem_bytes(kGemmStages, kGemmBN);
  out[3] = (int)smem;
  cudaError_t err = blocks_per_sm(wgmma_gemm_kernel<StoreEpilogue, kGemmBN, false, false, kGemmStages, kGemmCtasPerSm>,
                                  kGemmThreads, smem, &out[0]);
  if (err == cudaSuccess) {
    err = blocks_per_sm(wgmma_gemm_kernel<StoreF32Epilogue, kGemmBN, false, false, kGemmStages, kGemmCtasPerSm>,
                        kGemmThreads, smem, &out[1]);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)blocks_per_sm(wgmma_gemm_kernel<WgradEpilogue, kGemmBN, true, true, kGemmStages, kGemmCtasPerSm>,
                            kGemmThreads, smem, &out[2]);
}

// One Dense layer's backward on the wgmma route: a [m, p], dout [m, q], w
// [p, q] bf16, 16-byte aligned; dw [p, q] bf16; db [q] f32; da [m, p] f32
// (da_is_f32) or bf16.  Scratch: dw_part [splits, p, q] f32 (split s sums
// rows [s * chunk, (s + 1) * chunk), chunk a multiple of 64 unless splits is
// 1), db_part [ceil(m / rows_per_part), q] f32, rows_per_part a positive
// multiple of 8.  p and q multiples of 128.
extern "C" int edrl_attention_sublayer_dense_bwd(const void* a, const void* dout, const void* w, void* dw, void* db,
                                                 void* da, void* dw_part, void* db_part, int m, int p, int q,
                                                 int splits, int chunk, int rows_per_part, int da_is_f32,
                                                 void* stream) {
  if (m < 1 || p < 128 || q < 128 || p % 128 != 0 || q % 128 != 0 || splits < 1 || (long long)splits * chunk < m ||
      (splits > 1 && chunk % kGemmBK != 0) || rows_per_part < 8 || rows_per_part % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)run_dense_bwd(a, dout, w, static_cast<__nv_bfloat16*>(dw), static_cast<float*>(db), da,
                            static_cast<float*>(dw_part), static_cast<float*>(db_part), m, p, q, splits, chunk,
                            rows_per_part, da_is_f32 != 0, static_cast<cudaStream_t>(stream));
}
