// Fused MLP backward (B5).
//
// Replaces: edrl_tpu/kernels/fused_mlp.py, fused_mlp's backward (_bwd_call /
// _bwd_kernel).  From u [M, C], the output's cotangent dy [M, C] (both bf16
// or both f32), W1 [C, H], b1 [H] and W2 [H, C] it recomputes the hidden and
// writes, with the TPU kernel's rounding:
//
//     hidden = u . bf16(W1) + b1,  a = gelu(hidden)
//     da = bf16(dy) . bf16(W2)^T,  dh = da * gelu'(hidden)
//     du  = bf16(dh) . bf16(W1)^T           (u's dtype)
//     dW1 = u^T . bf16(dh)                  (f32; u f32 stays f32)
//     dW2 = bf16(a)^T . bf16(dy)            (f32)
//     db1 = sum over rows of dh (f32),  db2 = sum over rows of dy (f32)
//
// What bounds it on an H100: 10 * M * C * H flops (hidden, da, du, dW1,
// dW2) against ~(3 * M * C + 2 * C * H) * 2 bytes: bound by the tensor cores
// at every shape of the model.  The decomposition below also moves the [M,
// H] dh and a through device memory (written once, read twice: ~6 * M * H
// * 2 bytes), which at C <= 256 (Swin stages 0 and 1) takes longer than
// the products.
//
// What the design does about it.  The TPU kernel recomputes the hidden per
// (hidden block, token block) and accumulates the weight gradients across
// its sequential token grid.  CUDA blocks run in no order, so the backward
// is four products launched in this order on one stream, each over a grid
// of 128 x 128 tiles that fills the card:
//
// 1. the hidden kernel, one CTA per 128 rows x 128 hidden units: two
//    products into two accumulators, hidden (K = C) and da (K = C); then dh
//    and a in f32 in registers; writes bf16(dh) and bf16(a) once to an [M,
//    H] bf16 scratch each (the hidden is recomputed once, not once per
//    weight tile), and the tile's column sums of the f32 dh to a [row
//    tiles, H] partial.
// 2. du = bf16(dh) . bf16(W1)^T (K = H) from that scratch.
// 3. dW1 = u^T bf16(dh) and dW2 = bf16(a)^T bf16(dy), over 128 x 128 output
//    tiles and splits of M (the wrapper sizes the splits so that the grid
//    fills the card; each split writes its own f32 partial).
// 4. column partial sums of dy for db2.
//
// Every reduction over M (db1, db2, and dW1, dW2 when M is split) ends in
// column_sum_kernel, which adds the partials in a fixed order.  No atomics:
// the gradients are the same bit for bit from run to run.  The scratch is
// 4 * M * H bytes (600 MB for the widest call of a batch-32 step), freed
// when the call returns.
//
// Two routes, the forward's (fused_mlp_fwd.cu):
//
// - "wgmma", bf16 u: every product on the wgmma mainloop of
//   hopper_gemm.cuh (TMA into a ring of mbarrier-guarded stages, one
//   producer warp, two consumer warpgroups).  The hidden kernel's two
//   products share its ring and output tile: u . W1 reads W1 MN-major as it
//   lies, dy . W2^T reads W2 K-major.  du reads dh and W1 K-major.  The
//   weight gradients contract over M, so both of their operands are read
//   MN-major as they lie (M-rows of u, dh, a and dy), in 64-row slices; a
//   split of M is a multiple of 64 rows, so a slice never crosses into the
//   next split, and TMA's zero fill ends the last one at M.  The wrapper's
//   split planner (fused_mlp.wgmma_wgrad_splits) weighs the last wave's
//   fill against the partials' bytes, which column_sum4_kernel adds in
//   16-byte loads.  Epilogues of bf16 results (dh, a, du) store through a
//   per-warp staging buffer, so that a warp writes whole 64-byte row
//   segments; the GELU and its derivative are taken in f32 in the logistic
//   form (gelu_logistic_grad).  db2's partials come from 64-row tiles of dy
//   (col_partials_kernel).  f32 master weights are rounded to bf16
//   copies first.
// - "mma", f32 u (the correctness-check mode): the same four products on
//   mma.sync over cp.async double buffers (tile_product in fused_mlp.cuh
//   for 1 and 2, 128 x 64 tiles); u enters the products as three exact bf16
//   parts, dy is rounded to bf16 where the TPU kernel rounds it, and W1 is
//   transposed for the hidden kernel.

#include "fused_mlp.cuh"
#include "hopper_products.cuh"

namespace {

struct MlpBwdParams {
  const void* u;
  const void* dy;
  const __nv_bfloat16* w1t;  // [H, C]
  const __nv_bfloat16* w2b;  // [H, C]
  const __nv_bfloat16* w1b;  // [C, H]
  const float* b1;
  void* du;
  __nv_bfloat16* dh;   // [M, H]
  __nv_bfloat16* act;  // [M, H]
  float* db1_part;     // [row tiles, H]
  float* db2_part;     // [row tiles, C]
  int m, c, h;
};

// 1. hidden and da for 128 rows x 64 hidden units; dh, a and db1's partial.
template <typename T>
__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_hidden_kernel(MlpBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float col_sums[4][kTileN];
  const int row0 = blockIdx.x * kTileM, h0 = blockIdx.y * kTileN;
  float hid[2][4][4], da[2][4][4];
  zero(hid);
  zero(da);
  tile_product<AFrag<T>, T>(hid, static_cast<const T*>(p.u), p.c, row0, p.m, p.w1t, p.c, h0, p.c,
                            smem_raw);
  tile_product<AFragRounded, T>(da, static_cast<const T*>(p.dy), p.c, row0, p.m, p.w2b,
                                            p.c, h0, p.c, smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float sums[4][2] = {};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = h0 + wn + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + wm + mi * 16 + g + 8 * half;
        if (row >= p.m) continue;
        float dh[2], act[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float hidden = hid[mi][ni][2 * half + j] + p.b1[col + j];
          dh[j] = da[mi][ni][2 * half + j] * gelu_tanh_grad(hidden);
          act[j] = gelu_tanh(hidden);
          sums[ni][j] += dh[j];
        }
        const size_t at = (size_t)row * p.h + col;
        *reinterpret_cast<__nv_bfloat162*>(p.dh + at) = __floats2bfloat162_rn(dh[0], dh[1]);
        *reinterpret_cast<__nv_bfloat162*>(p.act + at) = __floats2bfloat162_rn(act[0], act[1]);
      }
    }
  // Column sums of dh: over the lane's rows above, then over the 8 row groups
  // of the warp (a fixed butterfly), then over the 4 warps of a column, in order.
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) sums[ni][j] += __shfl_xor_sync(0xffffffffu, sums[ni][j], off);
  if (g == 0) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      col_sums[wm / 32][wn + ni * 8 + 2 * t] = sums[ni][0];
      col_sums[wm / 32][wn + ni * 8 + 2 * t + 1] = sums[ni][1];
    }
  }
  __syncthreads();
  if (threadIdx.x < kTileN) {
    const float s = ((col_sums[0][threadIdx.x] + col_sums[1][threadIdx.x]) + col_sums[2][threadIdx.x]) +
                    col_sums[3][threadIdx.x];
    p.db1_part[(size_t)blockIdx.x * p.h + h0 + threadIdx.x] = s;
  }
}

// 2. du = bf16(dh) . bf16(W1)^T for 128 rows x 64 columns.
template <typename T>
__global__ void __launch_bounds__(kMlpThreads) mlp_bwd_du_kernel(MlpBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row0 = blockIdx.x * kTileM, c0 = blockIdx.y * kTileN;
  float acc[2][4][4];
  zero(acc);
  tile_product<AFrag<__nv_bfloat16>, __nv_bfloat16>(acc, p.dh, p.h, row0, p.m, p.w1b, p.h, c0, p.h,
                                                    smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  T* du = static_cast<T*>(p.du);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = c0 + wn + ni * 8 + 2 * t;
      const int row = row0 + wm + mi * 16 + g;
      if (row < p.m) store2<T>(du + (size_t)row * p.c + col, acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < p.m) store2<T>(du + (size_t)(row + 8) * p.c + col, acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// 4. part[tile][c] = sum of x[tile * 128 + r][c] over the tile's rows, in row order.
template <typename T>
__global__ void __launch_bounds__(256) row_tile_sums_kernel(const T* __restrict__ x,
                                                            float* __restrict__ part, int m,
                                                            int cols) {
  const int row0 = blockIdx.x * kTileM;
  const int row_end = min(m, row0 + kTileM);
  for (int c = threadIdx.x; c < cols; c += 256) {
    float s = 0.0f;
    for (int r = row0; r < row_end; ++r) s += to_f32(x[(size_t)r * cols + c]);
    part[(size_t)blockIdx.x * cols + c] = s;
  }
}

// ---------------------------------------------------------------------------
// Weight gradients: out[P, Q] = sum over m in the block's split of
// x[m, p] * bf16(y[m, q]), with x bf16 or f32 (three exact parts) and y bf16
// or f32 (rounded).  Both operands are M-major, so slices of 32 rows of m are
// staged as they lie and the fragments are read transposed (ldmatrix .trans
// for bf16).
// ---------------------------------------------------------------------------

constexpr int kWgTile = 128;     // a block's P x Q tile; 8 warps of 64 x 32
constexpr int kWgK = 32;         // rows of m per staged slice
constexpr int kWgLd = kWgTile + 8;

// A fragments (A[p][k] = x_s[k][p]) of the 16 x 16 block at (p0, k0).
__device__ __forceinline__ void wg_a_frag(const __nv_bfloat16* x_s, int k0, int p0, uint32_t (&a)[1][4]) {
  const int lane = threadIdx.x & 31;
  const int k = k0 + (lane & 7) + ((lane >> 4) << 3);
  const int p = p0 + (((lane >> 3) & 1) << 3);
  ldmatrix_x4_trans(a[0], x_s + k * kWgLd + p);
}

__device__ __forceinline__ void wg_a_frag(const float* x_s, int k0, int p0, uint32_t (&a)[3][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 2 * t + ((i >> 1) << 3);
    const int p = p0 + g + ((i & 1) << 3);
    split3(x_s[k * kWgLd + p], x_s[(k + 1) * kWgLd + p], a[0][i], a[1][i], a[2][i]);
  }
}

// B fragments (B[k][q] = y_s[k][q]) of the 16 x 8 block at (k0, q0).
__device__ __forceinline__ void wg_b_frag(const __nv_bfloat16* y_s, int k0, int q0, uint32_t& b0,
                                          uint32_t& b1) {
  ldmatrix_x2_trans(b0, b1, y_s + (k0 + (threadIdx.x & 15)) * kWgLd + q0);
}

__device__ __forceinline__ void wg_b_frag(const float* y_s, int k0, int q0, uint32_t& b0, uint32_t& b1) {
  const int lane = threadIdx.x & 31;
  const int q = q0 + (lane >> 2), k = k0 + 2 * (lane & 3);
  b0 = pack_bf16(y_s[k * kWgLd + q], y_s[(k + 1) * kWgLd + q]);
  b1 = pack_bf16(y_s[(k + 8) * kWgLd + q], y_s[(k + 9) * kWgLd + q]);
}

template <typename TX, typename TY>
size_t wgrad_smem_bytes() {
  return (size_t)kStages * kWgK * kWgLd * (sizeof(TX) + sizeof(TY));
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kMlpThreads) mlp_wgrad_kernel(const TX* __restrict__ x,
                                                                const TY* __restrict__ y,
                                                                float* __restrict__ out, int m,
                                                                int pdim, int qdim, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* x_s = reinterpret_cast<TX*>(smem_raw);                 // [kStages][kWgK][kWgLd]
  TY* y_s = reinterpret_cast<TY*>(x_s + kStages * kWgK * kWgLd);
  constexpr int kParts = std::is_same<TX, float>::value ? 3 : 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_tiles = qdim / kWgTile;
  const int p0 = (blockIdx.x / q_tiles) * kWgTile;
  const int q0 = (blockIdx.x % q_tiles) * kWgTile;
  const int wp = (warp >> 2) * 64, wq = (warp & 3) * 32;
  const int m_begin = blockIdx.y * chunk;
  const int m_end = min(m, m_begin + chunk);
  const int slices = (m_end - m_begin + kWgK - 1) / kWgK;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.0f;

  auto stage = [&](int s) {
    const int buf = s % kStages, k0 = m_begin + s * kWgK;
    stage_rows_async(x_s + buf * kWgK * kWgLd, kWgLd, x, pdim, k0, kWgK, m_end, p0, kWgTile);
    stage_rows_async(y_s + buf * kWgK * kWgLd, kWgLd, y, qdim, k0, kWgK, m_end, q0, kWgTile);
    cp_async_commit();
  };
  if (slices > 0) stage(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const TX* xs = x_s + (s % kStages) * kWgK * kWgLd;
    const TY* ys = y_s + (s % kStages) * kWgK * kWgLd;
#pragma unroll
    for (int ks = 0; ks < kWgK; ks += 16) {
      uint32_t a[4][kParts][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) wg_a_frag(xs, ks, wp + mi * 16, a[mi]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t b0, b1;
        wg_b_frag(ys, ks, wq + ni * 8, b0, b1);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int pi = 0; pi < kParts; ++pi) mma_bf16_16816(acc[mi][ni], a[mi][pi], b0, b1);
      }
    }
    __syncthreads();  // this slice's buffer is free for the slice after next
  }
  float* o = out + (size_t)blockIdx.y * pdim * qdim;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = p0 + wp + mi * 16 + g;
      const int col = q0 + wq + ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(o + (size_t)r * qdim + col) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(o + (size_t)(r + 8) * qdim + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

// out = x^T bf16(y) over m; with splits > 1 through part [splits, P, Q].
template <typename TX, typename TY>
cudaError_t launch_wgrad(const void* x, const void* y, float* out, float* part, int m, int pdim,
                         int qdim, int splits, int chunk, cudaStream_t stream) {
  const size_t smem = wgrad_smem_bytes<TX, TY>();
  cudaError_t err = allow_smem(mlp_wgrad_kernel<TX, TY>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((pdim / kWgTile) * (qdim / kWgTile)), (unsigned)splits);
  mlp_wgrad_kernel<TX, TY><<<grid, kMlpThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), splits > 1 ? part : out, m, pdim, qdim,
      chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_column_sum(part, out, splits, pdim * qdim, stream);
}

template <typename T>
cudaError_t run_bwd(const MlpBwdParams& p, float* dw1, float* dw2, float* db1, float* db2,
                    float* dw1_part, float* dw2_part, int splits, int chunk, cudaStream_t s) {
  const unsigned row_tiles = (unsigned)((p.m + kTileM - 1) / kTileM);
  size_t smem = tile_smem_bytes<T>();
  cudaError_t err = allow_smem(mlp_bwd_hidden_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  mlp_bwd_hidden_kernel<T><<<dim3(row_tiles, (unsigned)(p.h / kTileN)), kMlpThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = tile_smem_bytes<__nv_bfloat16>();
  err = allow_smem(mlp_bwd_du_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  mlp_bwd_du_kernel<T><<<dim3(row_tiles, (unsigned)(p.c / kTileN)), kMlpThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_tile_sums_kernel<T><<<row_tiles, 256, 0, s>>>(static_cast<const T*>(p.dy), p.db2_part, p.m, p.c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_column_sum(p.db1_part, db1, (int)row_tiles, p.h, s);
  if (err != cudaSuccess) return err;
  err = launch_column_sum(p.db2_part, db2, (int)row_tiles, p.c, s);
  if (err != cudaSuccess) return err;
  err = launch_wgrad<T, __nv_bfloat16>(p.u, p.dh, dw1, dw1_part, p.m, p.c, p.h, splits, chunk, s);
  if (err != cudaSuccess) return err;
  return launch_wgrad<__nv_bfloat16, T>(p.act, p.dy, dw2, dw2_part, p.m, p.h, p.c, splits, chunk, s);
}

// ---------------------------------------------------------------------------
// The wgmma route.
// ---------------------------------------------------------------------------

constexpr int kHidStages = 4;  // the hidden kernel's ring: 4 x 32 KB

struct HiddenArgs {
  const float* b1;
  __nv_bfloat16* dh;   // [M, H]
  __nv_bfloat16* act;  // [M, H]
  float* db1_part;     // [row tiles, H]
  int m, c, h;
};

// 1. hidden = u . W1 and da = dy . W2^T for 128 rows x 128 hidden units;
// dh, a and db1's partial.  Persistent (one CTA per SM), over tiles t =
// (hidden tile t % (H / 128), row tile t / (H / 128)), as wgmma_gemm_kernel.
__global__ void __launch_bounds__(kGemmThreads, 1)
    mlp_bwd_hidden_wgmma_kernel(const __grid_constant__ CUtensorMap u_map, const __grid_constant__ CUtensorMap w1_map,
                                const __grid_constant__ CUtensorMap dy_map, const __grid_constant__ CUtensorMap w2_map,
                                const HiddenArgs p) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t bars[2 * kHidStages];
  __shared__ float col_sums[kGemmConsumers / 32][kGemmBN];
  __shared__ __align__(16) __nv_bfloat16 stage[kGemmConsumers / 32][kStageElems];
  Ring r = make_ring(smem, bars, kHidStages, kATileBytes + kGemmBN * kGemmBK * 2);
  const bool producer = threadIdx.x >= kGemmConsumers;
  if (producer && threadIdx.x != kGemmConsumers) return;
  const int n_tiles = p.h / kGemmBN, tiles = n_tiles * ((p.m + kGemmBM - 1) / kGemmBM);
  const int iters = p.c / kGemmBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int n0 = (t % n_tiles) * kGemmBN, row_tile = t / n_tiles, m0 = row_tile * kGemmBM;
    if (producer) {
      produce<kGemmBN, false, true>(r, &u_map, &w1_map, m0, n0, 0, iters);
      produce<kGemmBN, false, false>(r, &dy_map, &w2_map, m0, n0, 0, iters);
      continue;
    }
    float hid[kGemmBN / 2], da[kGemmBN / 2];
    zero_acc(hid);
    zero_acc(da);
    consume<kGemmBN, false, true>(r, hid, iters);
    consume<kGemmBN, false, false>(r, da, iters);
    // hid becomes a and da becomes dh, in f32, in place.
    const int row = m0 + acc_row0();
    const float* b1 = p.b1 + n0 + acc_col0();
    float sums[kGemmBN / 8][2];
#pragma unroll
    for (int j = 0; j < kGemmBN / 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(b1 + 8 * j);
      sums[j][0] = sums[j][1] = 0.0f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * j + 2 * half;
        float a0, a1;
        da[i] *= gelu_logistic_grad(hid[i] + b.x, &a0);
        da[i + 1] *= gelu_logistic_grad(hid[i + 1] + b.y, &a1);
        hid[i] = a0;
        hid[i + 1] = a1;
        if (row + 8 * half < p.m) {
          sums[j][0] += da[i];
          sums[j][1] += da[i + 1];
        }
      }
    }
    __nv_bfloat16* st = stage[warp];
    const int row0 = m0 + 16 * warp;
    store_rows_bf16<kGemmBN>(st, p.dh, p.h, row0, n0, p.m, [&](int j, int half) {
      return __floats2bfloat162_rn(da[4 * j + 2 * half], da[4 * j + 2 * half + 1]);
    });
    store_rows_bf16<kGemmBN>(st, p.act, p.h, row0, n0, p.m, [&](int j, int half) {
      return __floats2bfloat162_rn(hid[4 * j + 2 * half], hid[4 * j + 2 * half + 1]);
    });
    // Column sums of dh: over the thread's two rows above, then over the 8
    // row groups of the warp (a fixed butterfly), then over the 8 warps in
    // order.  Named barrier 1 holds the 256 consumer threads only.
#pragma unroll
    for (int j = 0; j < kGemmBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) sums[j][e] += __shfl_xor_sync(0xffffffffu, sums[j][e], off);
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < kGemmBN / 8; ++j) {
        col_sums[warp][8 * j + 2 * lane] = sums[j][0];
        col_sums[warp][8 * j + 2 * lane + 1] = sums[j][1];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kGemmConsumers) : "memory");
    if (threadIdx.x < kGemmBN) {
      float total = 0.0f;
#pragma unroll
      for (int w = 0; w < kGemmConsumers / 32; ++w) total += col_sums[w][threadIdx.x];
      p.db1_part[(size_t)row_tile * p.h + n0 + threadIdx.x] = total;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kGemmConsumers) : "memory");  // col_sums free for the next tile
  }
}

inline size_t hidden_smem_bytes() { return ring_smem_bytes(kHidStages, kGemmBN); }

// db2's partials come from tiles of kDb2Rows rows of dy.
constexpr int kDb2Rows = 64;

// u, dy, du [m, c] bf16; w1b [c, h], w2b [h, c] bf16.
cudaError_t run_bwd_wgmma(const void* u, const void* dy, const __nv_bfloat16* w1b, const __nv_bfloat16* w2b,
                          const float* b1, void* du, float* dw1, float* dw2, float* db1, float* db2,
                          __nv_bfloat16* dh, __nv_bfloat16* act, float* db1_part, float* db2_part, float* dw1_part,
                          float* dw2_part, int m, int c, int h, int splits, int chunk, cudaStream_t s) {
  CUtensorMap u_map, w1_map, dy_map, w2_map, dh_map, w1k_map;
  cudaError_t err = make_tile_map(&u_map, u, m, c, kGemmBM);
  if (err == cudaSuccess) err = make_tile_map(&w1_map, w1b, c, h, 64);
  if (err == cudaSuccess) err = make_tile_map(&dy_map, dy, m, c, kGemmBM);
  if (err == cudaSuccess) err = make_tile_map(&w2_map, w2b, h, c, kGemmBN);
  if (err == cudaSuccess) err = make_tile_map(&dh_map, dh, m, h, kGemmBM);
  if (err == cudaSuccess) err = make_tile_map(&w1k_map, w1b, c, h, kGemmBN);
  if (err != cudaSuccess) return err;
  const unsigned row_tiles = (unsigned)((m + kGemmBM - 1) / kGemmBM);
  const size_t smem = hidden_smem_bytes();
  err = allow_smem(mlp_bwd_hidden_wgmma_kernel, smem);
  if (err != cudaSuccess) return err;
  const HiddenArgs hp = {b1, dh, act, db1_part, m, c, h};
  unsigned ctas = 0;
  err = persistent_ctas((int)row_tiles * (h / kGemmBN), 1, &ctas);
  if (err != cudaSuccess) return err;
  mlp_bwd_hidden_wgmma_kernel<<<ctas, kGemmThreads, smem, s>>>(u_map, w1_map, dy_map, w2_map, hp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_wgmma_gemm<StoreEpilogue, false, false>(dh_map, w1k_map,
                                                        StoreEpilogue{static_cast<__nv_bfloat16*>(du), m, c}, m, c,
                                                        1, h, h, s);
  if (err != cudaSuccess) return err;
  const unsigned db2_rows = (unsigned)((m + kDb2Rows - 1) / kDb2Rows);
  err = launch_col_partials(dy, db2_part, m, c, kDb2Rows, s);
  if (err != cudaSuccess) return err;
  err = launch_column_sum(db1_part, db1, (int)row_tiles, h, s);
  if (err != cudaSuccess) return err;
  err = launch_column_sum(db2_part, db2, (int)db2_rows, c, s);
  if (err != cudaSuccess) return err;
  err = launch_wgrad_wgmma<float>(u, dh, dw1, dw1_part, m, c, h, splits, chunk, s);
  if (err != cudaSuccess) return err;
  return launch_wgrad_wgmma<float>(act, dy, dw2, dw2_part, m, h, c, splits, chunk, s);
}

}  // namespace

// The wgmma route's backward kernels: resident CTAs per SM (occupancy
// calculator) of the hidden kernel in out[0] and its dynamic shared memory
// in out[1]; of du's kernel in out[2] and of the weight-gradient kernel in
// out[3], with their dynamic shared memory in out[4].  Returns 0 or a CUDA
// error.
extern "C" int edrl_fused_mlp_bwd_occupancy(int* out) {
  out[1] = (int)hidden_smem_bytes();
  cudaError_t err = blocks_per_sm(mlp_bwd_hidden_wgmma_kernel, kGemmThreads, hidden_smem_bytes(), &out[0]);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_smem_bytes(kGemmStages, kGemmBN);
  out[4] = (int)smem;
  err = blocks_per_sm(wgmma_gemm_kernel<StoreEpilogue, kGemmBN, false, false, kGemmStages, kGemmCtasPerSm>,
                      kGemmThreads, smem, &out[2]);
  if (err != cudaSuccess) return (int)err;
  return (int)blocks_per_sm(wgmma_gemm_kernel<WgradEpilogue, kGemmBN, true, true, kGemmStages, kGemmCtasPerSm>,
                            kGemmThreads, smem, &out[3]);
}

// u, dy, du: [m, c] bf16 (u_is_bf16) or f32; w1 [c, h], w2 [h, c] bf16
// (w_is_bf16) or f32; b1 [h] f32; dw1 [c, h], db1 [h], dw2 [h, c], db2 [c]
// f32.  Scratch: w1b [c, h], w2b [h, c] bf16 copies of f32 weights (unused
// for bf16 weights); w1t [h, c] bf16 (the mma route's transposed W1;
// unused on the wgmma route); dh, act [m, h] bf16; db1_part [ceil(m / 128),
// h], db2_part [ceil(m / 128), c] (mma) or [ceil(m / 64), c] (wgmma) f32;
// dw1_part [splits, c, h], dw2_part [splits, h, c] f32 (unused when splits
// is 1).  Split s of the weight
// gradients sums rows [s * chunk, (s + 1) * chunk), chunk a multiple of 64
// on the wgmma route.  c a multiple of 128 and at most 1024, h a multiple
// of 128.
extern "C" int edrl_fused_mlp_bwd(const void* u, const void* dy, const void* w1, const void* b1,
                                  const void* w2, void* du, void* dw1, void* db1, void* dw2,
                                  void* db2, void* w1t, void* w1b, void* w2b, void* dh, void* act,
                                  void* db1_part, void* db2_part, void* dw1_part, void* dw2_part,
                                  int m, int c, int h, int splits, int chunk, int u_is_bf16,
                                  int w_is_bf16, void* stream) {
  const bool wgmma = mlp_route_wgmma(u_is_bf16 != 0);
  if (!mlp_shape_ok(c, h) || m < 1 || splits < 1 || (long long)splits * chunk < m ||
      (wgmma && splits > 1 && chunk % kGemmBK != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* w1_b = static_cast<const __nv_bfloat16*>(w1);
  const __nv_bfloat16* w2_b = static_cast<const __nv_bfloat16*>(w2);
  cudaError_t err;
  if (!w_is_bf16) {
    err = launch_round_bf16(static_cast<const float*>(w1), static_cast<__nv_bfloat16*>(w1b),
                            (long long)c * h, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_round_bf16(static_cast<const float*>(w2), static_cast<__nv_bfloat16*>(w2b),
                            (long long)c * h, s);
    if (err != cudaSuccess) return (int)err;
    w1_b = static_cast<const __nv_bfloat16*>(w1b);
    w2_b = static_cast<const __nv_bfloat16*>(w2b);
  }
  float* f_dw1 = static_cast<float*>(dw1);
  float* f_dw2 = static_cast<float*>(dw2);
  float* f_db1 = static_cast<float*>(db1);
  float* f_db2 = static_cast<float*>(db2);
  float* p1 = static_cast<float*>(dw1_part);
  float* p2 = static_cast<float*>(dw2_part);
  if (wgmma) {
    return (int)run_bwd_wgmma(u, dy, w1_b, w2_b, static_cast<const float*>(b1), du, f_dw1, f_dw2, f_db1, f_db2,
                              static_cast<__nv_bfloat16*>(dh), static_cast<__nv_bfloat16*>(act),
                              static_cast<float*>(db1_part), static_cast<float*>(db2_part), p1, p2, m, c, h,
                              splits, chunk, s);
  }
  __nv_bfloat16* w1t_b = static_cast<__nv_bfloat16*>(w1t);
  err = w_is_bf16 ? launch_transpose_bf16<__nv_bfloat16>(w1, w1t_b, c, h, s)
                  : launch_transpose_bf16<float>(w1, w1t_b, c, h, s);
  if (err != cudaSuccess) return (int)err;
  const MlpBwdParams p = {u,
                          dy,
                          w1t_b,
                          w2_b,
                          w1_b,
                          static_cast<const float*>(b1),
                          du,
                          static_cast<__nv_bfloat16*>(dh),
                          static_cast<__nv_bfloat16*>(act),
                          static_cast<float*>(db1_part),
                          static_cast<float*>(db2_part),
                          m,
                          c,
                          h};
  return (int)run_bwd<float>(p, f_dw1, f_dw2, f_db1, f_db2, p1, p2, splits, chunk, s);
}
