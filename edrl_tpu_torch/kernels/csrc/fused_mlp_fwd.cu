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
// Two routes, chosen here (edrl_fused_mlp_route; fused_mlp.fused_mlp_route
// mirrors it):
//
// - "wgmma", every bf16 u: Hopper's warpgroup MMA fed by TMA through
//   mbarrier rings (hopper_gemm.cuh), persistent grids.  W1 and W2 are read
//   MN-major as they lie ([C, H] and [H, C]); f32 master weights are first
//   rounded to bf16 copies (TMA does not convert), bf16 weights are read in
//   place.  The GELU is taken in f32 in its logistic form (gelu_logistic).
//   - C = 128 (Swin stage 0): one kernel keeps the hidden on chip, as the
//     TPU kernel does.  A CTA owns 128 rows and their [128, C] f32
//     y accumulator in registers (C / 2 a thread), and walks over H in
//     chunks of 64: hidden = u . W1-chunk (wgmma from shared memory), + b1
//     and the GELU, rounded to bf16 straight into wgmma's A-fragment
//     registers, then y += a . W2-chunk (wgmma with A from registers).
//     Without the [M, H] round trip the call moves u, y and the weights.
//   - C >= 256 (Swin stages 1 and 2, the ViT, Swin stage 3): y's [128, C]
//     accumulator (C / 2 registers a thread) does not fit beside the
//     hidden chunk within the 168 registers a thread that a 288-thread CTA
//     gets (kFusedMaxC), so the route runs two products through a
//     transient bf16 activation: the first writes a = bf16(gelu(u . W1 +
//     b1)) to an [M, H] scratch from its epilogue, the second reads it back,
//     y = a . W2 + b2.  The rounding is the TPU kernel's (a is rounded to
//     bf16 before the second product), the scratch (2 * M * H bytes written
//     and read once) is freed when the call returns, and nothing is saved
//     for the backward.  Both run 128 x 128 tiles, two CTAs per SM.
// - "mma", f32 u (the correctness-check mode): the kernel below, on
//   mma.sync.  A block stages BM = 16 rows of u once and walks over the
//   hidden units in chunks: [BM, BH] = u . W1-chunk on the tensor cores (u
//   split into three exact bf16 parts, fused_mlp.cuh), + b1 and gelu in
//   f32, rounded to bf16 in shared memory, then y[BM, C] += that .
//   W2-chunk into f32 registers; the [M, H] hidden never reaches device
//   memory.  A first prep pass writes bf16 copies of W1 and W2 transposed,
//   so that each B fragment is two 32-bit shared loads.

#include "fused_mlp.cuh"
#include "hopper_gemm.cuh"

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

// The mma route's forward (f32 u) at NT = C / 64.
struct LaunchMlpFwd {
  MlpFwdParams p;
  cudaStream_t stream;

  template <int NT>
  cudaError_t operator()() const {
    constexpr int BM = 16;
    const size_t smem = fwd_smem_bytes<float, BM>(p.c);
    cudaError_t err = allow_smem(fused_mlp_fwd_kernel<float, BM, NT>, smem);
    if (err != cudaSuccess) return err;
    const unsigned blocks = (unsigned)((p.m + BM - 1) / BM);
    fused_mlp_fwd_kernel<float, BM, NT><<<blocks, kMlpThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

// ---------------------------------------------------------------------------
// The wgmma route's epilogues.
// ---------------------------------------------------------------------------

// act = bf16(gelu(acc + b1)) for the rows below m.
struct GeluEpilogue {
  __nv_bfloat16* act;
  const float* b1;
  int m, h;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int, __nv_bfloat16* stage) const {
    const float* b = b1 + n0 + acc_col0();
    store_rows_bf16<BN>(stage, act, h, m0 + 16 * (threadIdx.x >> 5), n0, m, [&](int j, int half) {
      const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j);
      return __floats2bfloat162_rn(gelu_logistic(acc[4 * j + 2 * half] + bj.x),
                                   gelu_logistic(acc[4 * j + 2 * half + 1] + bj.y));
    });
  }
};

// y = bf16(acc + b2) for the rows below m.
struct BiasEpilogue {
  __nv_bfloat16* y;
  const float* b2;
  int m, c;

  template <int BN>
  __device__ __forceinline__ void tile(const float (&acc)[BN / 2], int m0, int n0, int, __nv_bfloat16* stage) const {
    const float* b = b2 + n0 + acc_col0();
    store_rows_bf16<BN>(stage, y, c, m0 + 16 * (threadIdx.x >> 5), n0, m, [&](int j, int half) {
      const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j);
      return __floats2bfloat162_rn(acc[4 * j + 2 * half] + bj.x, acc[4 * j + 2 * half + 1] + bj.y);
    });
  }
};

// ---------------------------------------------------------------------------
// The wgmma route at C = 128: one kernel, the hidden kept on chip.
//
// A CTA owns 128 rows of u (its two consumer warpgroups 64 each) and walks
// over H in chunks of 64 hidden units.  Per chunk, each warpgroup:
//
//   hidden[64, 64] = u[64, C] . W1[:, chunk]    (wgmma, A and B in shared memory)
//   a = bf16(gelu(hidden + b1))                  (f32, into A-fragment registers)
//   y[64, C] += a . W2[chunk, :]                 (wgmma, A from registers)
//
// y's f32 accumulator is C / 2 registers a thread (64 at C = 128), the
// hidden chunk 32 and the A fragments 16.  The u tile (C / 64
// boxes of 128 rows) is loaded once per row tile, with barriers of its own;
// each ring stage holds one chunk of W1 (C / 64 boxes of 64 x 64, MN-major)
// and of W2 (C / 64 boxes of 64 x 64, MN-major): 256 * C bytes.  The second
// product of one chunk is in flight while the first of the next is
// issued.  The grid is persistent over row tiles, one CTA per SM; the
// producer loads the next tile's u as soon as the last first product of
// this one has completed.
// ---------------------------------------------------------------------------

constexpr int kFusedBH = 64;
// The widest C the fused kernel takes.  At C = 256 its 128 + 32 + 16
// accumulator and fragment registers and the addressing need more than the
// 168 registers a thread that a 288-thread CTA gets: it spilled, and ran
// slower than the two products, which take C = 256 instead.
constexpr int kFusedMaxC = 128;

template <int C>
struct FusedMlpShape {
  static_assert(C % 64 == 0 && C <= kFusedMaxC, "the fused kernel's accumulators must fit the registers");
  static constexpr int kStages = 4;
  static constexpr uint32_t kUBytes = C * kGemmBM * 2;
  static constexpr uint32_t kStageBytes = 256 * C;
  static constexpr size_t kSmem = kUBytes + kStages * kStageBytes + 1024;
};

template <int C>
__global__ void __launch_bounds__(kGemmThreads, 1)
    mlp_fwd_fused_wgmma_kernel(const __grid_constant__ CUtensorMap u_map, const __grid_constant__ CUtensorMap w1_map,
                               const __grid_constant__ CUtensorMap w2_map, const float* __restrict__ b1,
                               const float* __restrict__ b2, __nv_bfloat16* __restrict__ y, int m, int h) {
  using S = FusedMlpShape<C>;
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t bars[2 * S::kStages + 2];
  __shared__ __align__(16) __nv_bfloat16 stage[kGemmConsumers / 32][kStageElems];
  uint64_t* u_full = &bars[2 * S::kStages];
  uint64_t* u_empty = u_full + 1;
  if (threadIdx.x == 0) {
    mbar_init(u_full, 1);
    mbar_init(u_empty, kGemmConsumers);
  }
  // The ring starts after the u tile (both 1024-byte aligned).
  Ring r = make_ring(smem + S::kUBytes, bars, S::kStages, S::kStageBytes);
  const uint32_t u_tile = r.base - S::kUBytes;
  const bool producer = threadIdx.x >= kGemmConsumers;
  if (producer && threadIdx.x != kGemmConsumers) return;
  const int tiles = (m + kGemmBM - 1) / kGemmBM, chunks = h / kFusedBH;
  uint32_t u_phase = 0;
  if (producer) {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, u_phase ^= 1u) {
      const int m0 = t * kGemmBM;
      mbar_wait(u_empty, u_phase ^ 1u);
      mbar_expect_tx(u_full, S::kUBytes);
#pragma unroll
      for (int b = 0; b < C / 64; ++b) tma_load(u_tile + b * kATileBytes, &u_map, u_full, 64 * b, m0);
      for (int i = 0; i < chunks; ++i) {
        mbar_wait(&r.empty[r.stage], r.phase ^ 1u);
        uint64_t* bar = &r.full[r.stage];
        mbar_expect_tx(bar, S::kStageBytes);
        const uint32_t w1_s = r.a_tile(), w2_s = w1_s + C * 128;
#pragma unroll
        for (int b = 0; b < C / 64; ++b) {
          tma_load(w1_s + b * kBoxBytes, &w1_map, bar, i * kFusedBH, 64 * b);
          tma_load(w2_s + b * kBoxBytes, &w2_map, bar, 64 * b, i * kFusedBH);
        }
        r.advance();
      }
    }
    return;
  }
  const int wg = threadIdx.x >> 7, t4 = threadIdx.x & 3;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, u_phase ^= 1u) {
    const int m0 = t * kGemmBM;
    float acc[C / 128][64];
#pragma unroll
    for (int half = 0; half < C / 128; ++half) zero_acc(acc[half]);
    mbar_wait(u_full, u_phase);
    // The A fragments live across the loop, so that the fence after each
    // wait keeps their registers from reuse while a second product reads them.
    uint32_t afrag[kFusedBH / 16][4] = {};
    int prev = -1;
    for (int i = 0; i < chunks; ++i) {
      mbar_wait(&r.full[r.stage], r.phase);
      const uint32_t w1_s = r.a_tile(), w2_s = w1_s + C * 128;
      float hid[kFusedBH / 2];
      zero_acc(hid);
      fence_acc(hid);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const uint32_t a = u_tile + (kk >> 2) * kATileBytes + wg * kBoxBytes;
        Wgmma<kFusedBH>::template ss<0, 1>(hid, slice_desc<false>(a, kk & 3),
                                          slice_desc<true>(w1_s + (kk >> 2) * kBoxBytes, kk & 3));
      }
      wgmma_commit();
      wgmma_wait<0>();  // this chunk's first product, and the last chunk's second
      fence_acc(hid);
      fence_regs(afrag);
#pragma unroll
      for (int half = 0; half < C / 128; ++half) fence_acc(acc[half]);
      if (prev >= 0) mbar_arrive(&r.empty[prev]);
      if (i == chunks - 1) mbar_arrive(u_empty);
      // a = bf16(gelu(hidden + b1)) as the A fragments of the 4 k-slices.
      const float* b = b1 + i * kFusedBH + 2 * t4;
#pragma unroll
      for (int sl = 0; sl < kFusedBH / 16; ++sl) {
        const float2 lo = *reinterpret_cast<const float2*>(b + 16 * sl);
        const float2 hi = *reinterpret_cast<const float2*>(b + 16 * sl + 8);
        const float* d = hid + 8 * sl;
        afrag[sl][0] = pack_bf16(gelu_logistic(d[0] + lo.x), gelu_logistic(d[1] + lo.y));
        afrag[sl][1] = pack_bf16(gelu_logistic(d[2] + lo.x), gelu_logistic(d[3] + lo.y));
        afrag[sl][2] = pack_bf16(gelu_logistic(d[4] + hi.x), gelu_logistic(d[5] + hi.y));
        afrag[sl][3] = pack_bf16(gelu_logistic(d[6] + hi.x), gelu_logistic(d[7] + hi.y));
      }
      fence_regs(afrag);
#pragma unroll
      for (int half = 0; half < C / 128; ++half) fence_acc(acc[half]);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kFusedBH / 16; ++sl)
#pragma unroll
        for (int half = 0; half < C / 128; ++half) {
          Wgmma<128>::template rs<1>(acc[half], afrag[sl],
                                     slice_desc<true>(w2_s + half * 2 * kBoxBytes, sl));
        }
      wgmma_commit();
      prev = r.stage;
      r.advance();
    }
    wgmma_wait<0>();
    fence_regs(afrag);
#pragma unroll
    for (int half = 0; half < C / 128; ++half) fence_acc(acc[half]);
    mbar_arrive(&r.empty[prev]);
    const float* bb = b2 + acc_col0();
    store_rows_bf16<C>(stage[threadIdx.x >> 5], y, C, m0 + 16 * (threadIdx.x >> 5), 0, m, [&](int j, int hf) {
      const float* d = acc[j / 16] + 4 * (j % 16) + 2 * hf;
      const float2 bj = *reinterpret_cast<const float2*>(bb + 8 * j);
      return __floats2bfloat162_rn(d[0] + bj.x, d[1] + bj.y);
    });
  }
}

template <int C>
cudaError_t launch_fwd_fused(const CUtensorMap& u_map, const CUtensorMap& w1_map, const CUtensorMap& w2_map,
                             const float* b1, const float* b2, void* y, int m, int h, cudaStream_t s) {
  auto kernel = mlp_fwd_fused_wgmma_kernel<C>;
  cudaError_t err = allow_smem(kernel, FusedMlpShape<C>::kSmem);
  if (err != cudaSuccess) return err;
  unsigned ctas = 0;
  err = persistent_ctas((m + kGemmBM - 1) / kGemmBM, 1, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kGemmThreads, FusedMlpShape<C>::kSmem, s>>>(u_map, w1_map, w2_map, b1, b2,
                                                             static_cast<__nv_bfloat16*>(y), m, h);
  return cudaGetLastError();
}

// The wgmma route: u, y, w1b [c, h], w2b [h, c] bf16, act [m, h] bf16 scratch.
cudaError_t run_fwd_wgmma(const void* u, const __nv_bfloat16* w1b, const float* b1, const __nv_bfloat16* w2b,
                          const float* b2, void* y, __nv_bfloat16* act, int m, int c, int h, cudaStream_t s) {
  CUtensorMap u_map, w1_map, act_map, w2_map;
  cudaError_t err = make_tile_map(&u_map, u, m, c, kGemmBM);
  if (err == cudaSuccess) err = make_tile_map(&w1_map, w1b, c, h, 64);
  if (err == cudaSuccess) err = make_tile_map(&w2_map, w2b, h, c, 64);
  if (err != cudaSuccess) return err;
  if (c == kFusedMaxC) return launch_fwd_fused<kFusedMaxC>(u_map, w1_map, w2_map, b1, b2, y, m, h, s);
  err = make_tile_map(&act_map, act, m, h, kGemmBM);
  if (err != cudaSuccess) return err;
  err = launch_wgmma_gemm<GeluEpilogue, false, true>(u_map, w1_map, GeluEpilogue{act, b1, m, h}, m, h, 1, c, c, s);
  if (err != cudaSuccess) return err;
  return launch_wgmma_gemm<BiasEpilogue, false, true>(
      act_map, w2_map, BiasEpilogue{static_cast<__nv_bfloat16*>(y), b2, m, c}, m, c, 1, h, h, s);
}

}  // namespace

// 1 if a call of this dtype and shape takes the wgmma route, 0 if it takes
// the mma.sync route, -1 if the kernels refuse the shape.  The backward
// takes the same route (kernels/fused_mlp.py mirrors this as
// fused_mlp_route).
extern "C" int edrl_fused_mlp_route(int u_is_bf16, int c, int h) {
  if (!mlp_shape_ok(c, h)) return -1;
  return mlp_route_wgmma(u_is_bf16 != 0) ? 1 : 0;
}

// The wgmma route's forward kernels: resident CTAs per SM (occupancy
// calculator: registers, shared memory, threads) and dynamic shared memory
// per CTA of the first and the second product at C >= 256 (out[0..1],
// out[2..3]) and of the fused kernel at C = 128 (out[4..5]); threads per
// CTA in out[6].  Returns 0 or a CUDA error.
extern "C" int edrl_fused_mlp_fwd_occupancy(int* out) {
  const size_t smem = ring_smem_bytes(kGemmStages, kGemmBN);
  cudaError_t err = blocks_per_sm(wgmma_gemm_kernel<GeluEpilogue, kGemmBN, false, true, kGemmStages, kGemmCtasPerSm>,
                                  kGemmThreads, smem, &out[0]);
  out[1] = out[3] = (int)smem;
  if (err == cudaSuccess) {
    err = blocks_per_sm(wgmma_gemm_kernel<BiasEpilogue, kGemmBN, false, true, kGemmStages, kGemmCtasPerSm>,
                        kGemmThreads, smem, &out[2]);
  }
  if (err == cudaSuccess) {
    err = blocks_per_sm(mlp_fwd_fused_wgmma_kernel<kFusedMaxC>, kGemmThreads, FusedMlpShape<kFusedMaxC>::kSmem,
                        &out[4]);
  }
  out[5] = (int)FusedMlpShape<kFusedMaxC>::kSmem;
  out[6] = kGemmThreads;
  return (int)err;
}

// u, y: [m, c] bf16 (u_is_bf16) or f32; w1 [c, h], w2 [h, c] bf16
// (w_is_bf16) or f32; b1 [h], b2 [c] f32.  Scratch, by route: wgmma: wa
// [c, h] and wb [h, c] bf16 copies of f32 weights (unused for bf16
// weights), act [m, h] bf16; mma: wa [h, c] and wb [c, h] bf16 transposed
// weights (act unused).  c a multiple of 128 and at most 1024, h a
// multiple of 128.
extern "C" int edrl_fused_mlp_fwd(const void* u, const void* w1, const void* b1, const void* w2,
                                  const void* b2, void* y, void* wa, void* wb, void* act, int m, int c,
                                  int h, int u_is_bf16, int w_is_bf16, void* stream) {
  if (!mlp_shape_ok(c, h) || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* wa_b = static_cast<__nv_bfloat16*>(wa);
  __nv_bfloat16* wb_b = static_cast<__nv_bfloat16*>(wb);
  cudaError_t err;
  if (mlp_route_wgmma(u_is_bf16 != 0)) {
    const __nv_bfloat16* w1_b = static_cast<const __nv_bfloat16*>(w1);
    const __nv_bfloat16* w2_b = static_cast<const __nv_bfloat16*>(w2);
    if (!w_is_bf16) {
      err = launch_round_bf16(static_cast<const float*>(w1), wa_b, (long long)c * h, s);
      if (err == cudaSuccess) err = launch_round_bf16(static_cast<const float*>(w2), wb_b, (long long)c * h, s);
      if (err != cudaSuccess) return (int)err;
      w1_b = wa_b;
      w2_b = wb_b;
    }
    return (int)run_fwd_wgmma(u, w1_b, static_cast<const float*>(b1), w2_b, static_cast<const float*>(b2), y,
                              static_cast<__nv_bfloat16*>(act), m, c, h, s);
  }
  err = w_is_bf16 ? launch_transpose_bf16<__nv_bfloat16>(w1, wa_b, c, h, s)
                  : launch_transpose_bf16<float>(w1, wa_b, c, h, s);
  if (err != cudaSuccess) return (int)err;
  err = w_is_bf16 ? launch_transpose_bf16<__nv_bfloat16>(w2, wb_b, h, c, s)
                  : launch_transpose_bf16<float>(w2, wb_b, h, c, s);
  if (err != cudaSuccess) return (int)err;
  const MlpFwdParams p = {u, wa_b, static_cast<const float*>(b1), wb_b, static_cast<const float*>(b2), y, m, c, h};
  return (int)dispatch_nt(c, LaunchMlpFwd{p, s});
}
