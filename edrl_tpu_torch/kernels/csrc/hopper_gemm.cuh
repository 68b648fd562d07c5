// Hopper building blocks of the fused MLP's bf16 route (B5): TMA tensor
// maps and loads, mbarrier rings, warpgroup MMA (wgmma) and the mainloop
// that every B5 product runs on.
//
// A CTA of the mainloop has 288 threads: two consumer warpgroups (threads
// 0-255, warpgroup w owns rows 64w .. 64w + 63 of a 128-row tile) and one
// producer warp (threads 256-287), whose lane 0 issues every TMA load.  The
// operands stream through a ring of shared-memory stages, each holding a
// 128 x 64 tile of A and a BN x 64 tile of B (K = 64: one 128-byte swizzle
// row of bf16).  Each stage has two mbarriers: "full", which the producer
// arms with the stage's byte count and the TMA unit completes, and
// "empty", on which all 256 consumer threads arrive once their wgmma on
// the stage has completed.  The consumers run wgmma.mma_async m64nNk16
// (bf16 in, f32 accumulators in registers), four per stage.
//
// Layouts.  Every tile is loaded by TMA with 128-byte swizzle in boxes of
// 64 columns (128 bytes), so an 8-row group of a box is one 1024-byte
// swizzle atom; stage buffers are 1024-byte aligned.  An operand is
// K-major when its global matrix holds K along its rows' contiguous axis
// (u [M, C] as A of u . W1) and MN-major when it holds M or N there (W1
// [C, H] as B of u . W1, both operands of the weight gradients, which
// contract over M).  wgmma reads both from shared memory (the transpose
// bits of its 16-bit forms), with these descriptors (byte offsets; the
// descriptor holds them in 16-byte units):
//
// - K-major, a box of rows x 64: rows at 128 bytes, 8-row groups at
//   SBO = 1024; the k-th 16-deep slice starts 32 * k bytes in (LBO unused).
// - MN-major, boxes of 64 k-rows x 64 columns, box j of a tile at 8192 * j:
//   LBO = 8192 (the next 64 columns), SBO = 1024 (the next 8 k-rows); the
//   k-th 16-deep slice starts 2048 * k bytes in.
//
// Rows past the end of a matrix load as zeros (TMA's out-of-bounds fill),
// so ragged M needs no masking in the mainloop, only in the epilogue.
//
// Tensor maps come from the driver's cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point (no link against libcuda), and
// reach the kernels as __grid_constant__ parameters.

#pragma once

#include <cuda.h>

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Host: tensor maps.
// ---------------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TensorMapEncodeTiled tensor_map_encoder() {
  static TensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      encode = reinterpret_cast<TensorMapEncodeTiled>(fn);
    }
  }
  return encode;
}

// The map of a row-major bf16 matrix [rows, cols], read in boxes of
// box_rows x 64 columns with 128-byte swizzle; rows past the end read as
// zeros.  The base must be 16-byte aligned and cols a multiple of 64.
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (!aligned16(base) || cols % 64 != 0 || rows < 1 || box_rows < 1 || box_rows > 256) {
    return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                            steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Device: shared addresses, mbarriers, TMA.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (column c0, row r0) into shared memory at dst,
// completing `bar`'s transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(r0)
      : "memory");
}

// ---------------------------------------------------------------------------
// Device: wgmma.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments in registers, which an asynchronous wgmma reads
// after the instruction that names them has issued.
template <int S, int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[S][R]) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

constexpr uint32_t kBoxBytes = 64 * 128;  // a 64-row box of 64 bf16 columns

// The 16-deep slice kk (0..3) of a stage's operand tile, for wgmma.  kMN:
// the tile is MN-major (boxes of 64 k-rows x 64 columns); otherwise K-major
// (rows of 64 k).  `tile` is the address of the tile's first row (for A,
// the warpgroup's first row or box).
template <bool kMN>
__device__ __forceinline__ uint64_t slice_desc(uint32_t tile, int kk) {
  return kMN ? sw128_desc(tile + 2048u * kk, kBoxBytes, 1024) : sw128_desc(tile + 32u * kk, 16, 1024);
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16.  ss: A and B from shared
// memory (descriptors; kTransA / kTransB = 1 for an MN-major operand).  rs
// (N = 128, the fused forward's second product): A from registers in the
// m16n8k16 A-fragment layout of each warp's 16 rows.  The accumulator d
// holds, for thread (warp w of the warpgroup, lane 4g + t), rows 16w + g
// (d[4j], d[4j + 1]) and 16w + g + 8 (d[4j + 2], d[4j + 3]) of columns
// 8j + 2t and 8j + 2t + 1.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int kTransA, int kTransB>
  __device__ static __forceinline__ void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
  }
};

template <>
struct Wgmma<128> {
  template <int kTransA, int kTransB>
  __device__ static __forceinline__ void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
  }
  template <int kTransB>
  __device__ static __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));
  }
};

// ---------------------------------------------------------------------------
// The mainloop.
// ---------------------------------------------------------------------------

constexpr int kGemmBM = 128;                         // rows of a CTA tile
constexpr int kGemmBK = 64;                          // K per ring stage
constexpr int kGemmConsumers = 256;                  // two warpgroups
constexpr int kGemmThreads = kGemmConsumers + 32;    // and the producer warp
constexpr uint32_t kATileBytes = kGemmBM * kGemmBK * 2;

// A ring of `stages` stages of stage_bytes each, from shared address base;
// stage and phase advance in the same order on the producer and consumer
// sides.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;
  uint32_t stage_bytes;
  int stages;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ uint32_t a_tile() const { return base + stage * stage_bytes; }
  __device__ __forceinline__ uint32_t b_tile() const { return a_tile() + kATileBytes; }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Sets up the ring in dynamic shared memory (1024-byte aligned) with its
// barriers in `bars` (2 * stages); all threads.
__device__ __forceinline__ Ring make_ring(unsigned char* smem, uint64_t* bars, int stages, uint32_t stage_bytes) {
  Ring r;
  r.full = bars;
  r.empty = bars + stages;
  r.base = (smem_u32(smem) + 1023u) & ~1023u;
  r.stage_bytes = stage_bytes;
  r.stages = stages;
  r.stage = 0;
  r.phase = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&r.full[s], 1);
      mbar_init(&r.empty[s], kGemmConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// Producer: `iters` stages of the product A[m0 : m0 + 128, k] . B[k, n0 : n0
// + BN] from k = k0 on, 64 deep each.  A K-major: map a over [M, K] in
// boxes of 128 rows; MN-major: over [K, M] in boxes of 64.  B K-major: map
// b over [N, K] in boxes of BN rows; MN-major: over [K, N] in boxes of 64.
// One thread.
template <int BN, bool kAMN, bool kBMN>
__device__ __forceinline__ void produce(Ring& r, const CUtensorMap* a, const CUtensorMap* b, int m0, int n0, int k0,
                                        int iters) {
  for (int i = 0; i < iters; ++i) {
    mbar_wait(&r.empty[r.stage], r.phase ^ 1u);
    uint64_t* bar = &r.full[r.stage];
    mbar_expect_tx(bar, kATileBytes + BN * kGemmBK * 2);
    const int k = k0 + i * kGemmBK;
    if (kAMN) {
      tma_load(r.a_tile(), a, bar, m0, k);
      tma_load(r.a_tile() + kBoxBytes, a, bar, m0 + 64, k);
    } else {
      tma_load(r.a_tile(), a, bar, k, m0);
    }
    if (kBMN) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j) tma_load(r.b_tile() + j * kBoxBytes, b, bar, n0 + 64 * j, k);
    } else {
      tma_load(r.b_tile(), b, bar, k, n0);
    }
    r.advance();
  }
}

// Consumer warpgroups: acc += their 64 rows of the stages' products, over
// `iters` stages.  One wgmma group stays in flight: a stage is released
// once the group after it has been issued and its own has completed.
template <int BN, bool kAMN, bool kBMN>
__device__ __forceinline__ void consume(Ring& r, float (&acc)[BN / 2], int iters) {
  const int wg = threadIdx.x >> 7;
  int prev = -1;
  for (int i = 0; i < iters; ++i) {
    mbar_wait(&r.full[r.stage], r.phase);
    const uint32_t a_tile = r.a_tile() + wg * kBoxBytes;  // K-major: 64 rows; MN-major: box wg
    const uint32_t b_tile = r.b_tile();
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk) {
      Wgmma<BN>::template ss<kAMN, kBMN>(acc, slice_desc<kAMN>(a_tile, kk), slice_desc<kBMN>(b_tile, kk));
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(acc);
    if (prev >= 0) mbar_arrive(&r.empty[prev]);
    prev = r.stage;
    r.advance();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0) mbar_arrive(&r.empty[prev]);
}

template <int R>
__device__ __forceinline__ void zero_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.0f;
}

// The consumer thread's place in its tile: the row of d[0] (within the
// 128-row tile) and the column of d[0] (within the BN columns).
__device__ __forceinline__ int acc_row0() { return ((threadIdx.x >> 5) << 4) + ((threadIdx.x & 31) >> 2); }
__device__ __forceinline__ int acc_col0() { return 2 * (threadIdx.x & 3); }

// Coalesced bf16 stores of a consumer warp's 16 rows x BN columns of the
// tile (rows row0 .. row0 + 15 of out, columns col0 ..), through the
// warp's staging buffer in shared memory (16 rows x 32 columns, rows
// padded to 80 bytes so that the fragment writes hit 32 distinct banks):
// 32 columns at a time, the warp writes its fragments there, then each
// lane stores 16 contiguous bytes of a row, so that a warp's store covers
// 8 rows x 64 bytes.  pair(j, half) gives the thread's bf16 pair at
// accumulator columns 8j + 2t of row g + 8 half; rows at or past m are
// not stored.
constexpr int kStageLd = 40;                      // bf16 elements per staged row
constexpr int kStageElems = 16 * kStageLd;        // one warp's buffer

template <int BN, class Pair>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* stage, __nv_bfloat16* out, int ld, int row0,
                                                int col0, int m, Pair pair) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (g + 8 * half) * kStageLd + 8 * jj + 2 * t) =
            pair(4 * q + jj, half);
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = g + 8 * i, c = 8 * t;
      if (row0 + r < m) {
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * ld + col0 + 32 * q + c) =
            *reinterpret_cast<const uint4*>(stage + r * kStageLd + c);
      }
    }
    __syncwarp();
  }
}

// Dynamic shared memory of a ring: its stages plus 1024 bytes of alignment slack.
inline size_t ring_smem_bytes(int stages, int bn) {
  return (size_t)stages * (kATileBytes + (size_t)bn * kGemmBK * 2) + 1024;
}

// ---------------------------------------------------------------------------
// A product over 128 x BN output tiles: epilogue(A[m0 : m0 + 128, K-range] .
// B[K-range, n0 : n0 + BN]).  The grid is persistent (kCtasPerSm CTAs per
// SM, or fewer where there are fewer tiles): CTA i takes tiles i, i +
// gridDim.x, ..., so its producer loads the next tile's stages while the
// consumers run this tile's epilogue.  Tile t is (n tile t % n_tiles, row
// tile t / n_tiles % m_tiles, split t / (n_tiles * m_tiles)): N varies
// fastest, so the CTAs that share a row block of A run together and read
// it from device memory once.  Split z covers K rows [z * k_split,
// min(k_end, (z + 1) * k_split)), k_split a multiple of 64.  Each consumer
// thread hands its accumulator to ep.tile<BN>(acc, m0, n0, z, stage), with
// its warp's staging buffer (store_rows_bf16).
// ---------------------------------------------------------------------------

struct TileGrid {
  int n_tiles, m_tiles, splits;
  int k_split, k_end;

  __device__ __forceinline__ int count() const { return n_tiles * m_tiles * splits; }
};

template <class Epi, int BN, bool kAMN, bool kBMN, int kStages, int kCtasPerSm>
__global__ void __launch_bounds__(kGemmThreads, kCtasPerSm)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap a, const __grid_constant__ CUtensorMap b, const Epi ep,
                      const TileGrid g) {
  extern __shared__ unsigned char smem[];
  __shared__ uint64_t bars[2 * kStages];
  __shared__ __align__(16) __nv_bfloat16 stage[kGemmConsumers / 32][kStageElems];
  Ring r = make_ring(smem, bars, kStages, kATileBytes + BN * kGemmBK * 2);
  const bool producer = threadIdx.x >= kGemmConsumers;
  if (producer && threadIdx.x != kGemmConsumers) return;
  for (int t = blockIdx.x; t < g.count(); t += gridDim.x) {
    const int n0 = (t % g.n_tiles) * BN, m0 = (t / g.n_tiles % g.m_tiles) * kGemmBM;
    const int split = t / (g.n_tiles * g.m_tiles), k0 = split * g.k_split;
    const int iters = (min(g.k_end, k0 + g.k_split) - k0 + kGemmBK - 1) / kGemmBK;
    if (producer) {
      produce<BN, kAMN, kBMN>(r, &a, &b, m0, n0, k0, iters);
      continue;
    }
    float acc[BN / 2];
    zero_acc(acc);
    consume<BN, kAMN, kBMN>(r, acc, iters);
    ep.template tile<BN>(acc, m0, n0, split, stage[threadIdx.x >> 5]);
  }
}

// CTAs of a persistent grid of `tiles` tiles at ctas_per_sm per SM.
inline cudaError_t persistent_ctas(int tiles, int ctas_per_sm, unsigned* out) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long slots = (long long)sms * ctas_per_sm;
  *out = (unsigned)(tiles < slots ? tiles : slots);
  return err;
}

// The single-product kernels of B5 use 128 x 128 tiles, two CTAs per SM
// (at most 112 registers a thread) and a 3-stage ring (97 KB each, and
// 10 KB of staging buffers).
constexpr int kGemmBN = 128;
constexpr int kGemmStages = 3;
constexpr int kGemmCtasPerSm = 2;

template <class Epi, bool kAMN, bool kBMN>
cudaError_t launch_wgmma_gemm(const CUtensorMap& a, const CUtensorMap& b, const Epi& ep, int m, int n, int splits,
                              int k_split, int k_end, cudaStream_t stream) {
  auto kernel = wgmma_gemm_kernel<Epi, kGemmBN, kAMN, kBMN, kGemmStages, kGemmCtasPerSm>;
  const size_t smem = ring_smem_bytes(kGemmStages, kGemmBN);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const TileGrid g = {n / kGemmBN, (m + kGemmBM - 1) / kGemmBM, splits, k_split, k_end};
  unsigned ctas = 0;
  err = persistent_ctas(g.n_tiles * g.m_tiles * splits, kGemmCtasPerSm, &ctas);
  if (err != cudaSuccess) return err;
  kernel<<<ctas, kGemmThreads, smem, stream>>>(a, b, ep, g);
  return cudaGetLastError();
}

}  // namespace
