// Fused MK-MMD forward (B3).
//
// Replaces: edrl_tpu/kernels/mmd_pallas.py, mk_mmd_pallas's forward
// (_mmd_forward / _mmd_kernel).  Over total = concat(source, target), n rows
// of d f32 features (n = 2 * batch = 64 and d = 3072 on the main path):
//
//     gram = total total^T,  d2_ij = gram_ii + gram_jj - 2 gram_ij (0 on the
//     diagonal, clamped at 0),  bandwidth = sum(d2) / (n^2 - n) / mul^(num/2),
//     K = sum_i exp(-d2 / (bandwidth * mul^i + 1e-12)),
//     out = |mean K_ss + mean K_tt - mean K_st - mean K_ts|
//
// in f32, as the TPU kernel computes it (and ops.mmd, its plain version).
// It also writes what the backward (mmd_bwd.cu) needs into one small f32
// state: d2 before the clamp (0 on the diagonal) [n, n], the bandwidth and
// the sign of the signed sum (+1 at 0, as JAX's VJP of abs takes it).
//
// What bounds it on an H100: the Gram product is 2 n^2 d = 25 MFLOP of f32
// against 786 KB of input, both a few microseconds or less at the card's
// peaks; at this size one launch's latency and the n^2 tail are what is
// left.  Two routes, chosen from n before the launch (mmd_route_cluster;
// kernels/mmd.py mirrors it as mk_mmd_route):
//
// - "cluster", n <= 64 (every main-path call): one launch of one thread-block
//   cluster of 16 CTAs (the non-portable size, allowed once per process; a
//   card that cannot schedule it fails the launch, and the wrapper raises;
//   16 measured faster than the portable 8 on the H100).  Each CTA sums the whole n x n Gram
//   over its share of the d columns in its own shared memory, on the tensor
//   cores as 3xTF32 (each f32 split into a tf32 hi and lo as a fragment is
//   read; hi hi + hi lo + lo hi, f32 accumulate: f32-accurate, where plain
//   TF32 would keep ~3 digits), only the 20 of 32 16 x 8 tiles that reach
//   the diagonal, its columns staged by cp.async in batches of 32-column
//   chunks, every copy of a batch in flight at once.  After a cluster
//   barrier each CTA adds its share of the rows, and the diagonal, over the
//   CTAs' tiles in rank order, reading them from distributed shared memory
//   by 16-byte loads all in flight at once; it does the tail on those rows:
//   the state's d2, its part of sum(d2) pushed to every CTA (each adds the
//   parts in rank order for the bandwidth), its four kernel sums pushed to
//   CTA 0, which adds them in rank order for the value.  No device-memory
//   scratch, no second launch, no atomics: the value is the same bit for bit
//   from run to run.
// - "split", n > 64: the two launches of the first port, 64 x 64 Gram tiles
//   over 64 columns of d into partial sums (device-memory scratch), then one
//   block adds them in a fixed order and does the tail.
//
// Rows are read from source and target in place (no concatenation), and any
// d is taken: the edges are masked, so the TPU wrapper's fallback for
// n % 8 != 0 or d % 128 != 0 has no counterpart here.

#include <cooperative_groups.h>

#include "attention_common.cuh"
#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMmdTile = 64;            // rows and columns of a Gram tile
constexpr int kMmdDChunk = 64;          // feature columns per partial (split route)
constexpr int kMmdThreads = 256;
constexpr int kMmdFinishThreads = 1024;
constexpr int kMmdClusterMaxRows = 64;  // one Gram tile per CTA
constexpr int kMmdCluster = 16;         // CTAs of the cluster route: 4 of the Gram's rows each
constexpr int kMmdMaxKernels = 16;      // kernel_num a call may ask for
constexpr int kGramChunk = 32;          // feature columns the cluster route stages at a time
constexpr int kGramLd = kGramChunk + 4;  // floats per staged row: 16-byte rows, a fragment's 32 loads on 32 banks
constexpr int kGramBatch = 8;           // chunks staged at once: 74 KB of dynamic shared memory
constexpr int kMmdRowsLd = kMmdTile + 4;  // floats per summed row: 16-byte rows
constexpr size_t kMmdClusterSmem = sizeof(float) * kGramBatch * kMmdTile * kGramLd;
constexpr int kGramTiles = 20;          // 16 x 8 tiles of the 64 x 64 Gram that reach the diagonal
constexpr int kGramTilesPerWarp = 3;    // of 8 warps: tiles w, w + 8, w + 16

struct MmdArgs {
  const float* src;
  const float* tgt;
  int n_s;
  int n_t;
  int d;
  float kernel_mul;
  int kernel_num;
  float bandwidth_div;  // kernel_mul^(kernel_num / 2)
  float mul_pow[kMmdMaxKernels];  // kernel_mul^m, taken on the host in double as the plain version takes it
  float* out;           // the 0-d value
  float* state;         // [n * n + 2]: d2 before the clamp, the bandwidth, the sign
  int vec16;            // rows may be staged by 16-byte copies: d % 4 == 0, 16-byte aligned source and target
};

inline bool mmd_route_cluster(int n) { return n <= kMmdClusterMaxRows; }

// The idx-th 16 x 8 tile (16 * block row, 8 * column: block row * 8 +
// column) of the 64 x 64 Gram, in row order, of those that reach the
// diagonal or above (8 * column + 7 >= 16 * block row): every (i, j) with
// i <= j lies in one.
__device__ __forceinline__ int gram_tile(int idx) {
  for (int mb = 0; mb < 4; ++mb) {
    const int first = 2 * mb;  // the first column tile that reaches row block mb's diagonal
    if (idx < 8 - first) return mb * 8 + first + idx;
    idx -= 8 - first;
  }
  return 0;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32: lo keeps the bits hi leaves.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on the tensor cores, m16n8k8, tf32 in, f32 accumulate.  Fragment
// layout (lane = 4 g + t): A rows g, g + 8, columns t, t + 4; B column g,
// rows t, t + 4; C rows g, g + 8, columns 2t, 2t + 1.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ const float* mmd_row(const float* src, const float* tgt, int n_s,
                                                int d, int r) {
  return r < n_s ? src + (size_t)r * d : tgt + (size_t)(r - n_s) * d;
}

// d2 before the clamp: gram_ii + gram_jj - 2 gram_ij, 0 on the diagonal.
__device__ __forceinline__ float mmd_d2_raw(const float* gram, int ld, int i, int j) {
  if (i == j) return 0.0f;
  return gram[(size_t)i * ld + i] + gram[(size_t)j * ld + j] - 2.0f * gram[(size_t)i * ld + j];
}

// The n^2 tail over the Gram matrix (row stride ld) with the block's THREADS
// threads: the state's d2, the bandwidth, the kernel sums by block, the
// value and its sign.
template <int THREADS>
__device__ void mmd_tail(const float* gram, int ld, const MmdArgs& a, float* red, float* sig) {
  const int n = a.n_s + a.n_t;
  const int nn = n * n;
  float local = 0.0f;
  for (int e = threadIdx.x; e < nn; e += THREADS) {
    const int i = e / n;
    const float raw = mmd_d2_raw(gram, ld, i, e - i * n);
    a.state[e] = raw;
    local += fmaxf(raw, 0.0f);
  }
  const float length_scale = block_sum<THREADS>(local, red) / (float)(nn - n) / a.bandwidth_div;
  if (threadIdx.x < a.kernel_num) {
    sig[threadIdx.x] = length_scale * a.mul_pow[threadIdx.x] + 1e-12f;
  }
  __syncthreads();
  float xx = 0.0f, yy = 0.0f, xy = 0.0f, yx = 0.0f;
  for (int e = threadIdx.x; e < nn; e += THREADS) {
    const int i = e / n;
    const int j = e - i * n;
    const float d2 = fmaxf(mmd_d2_raw(gram, ld, i, j), 0.0f);
    float k = 0.0f;
    for (int m = 0; m < a.kernel_num; ++m) k += expf(-d2 / sig[m]);
    if (i < a.n_s) {
      if (j < a.n_s) xx += k; else xy += k;
    } else {
      if (j < a.n_s) yx += k; else yy += k;
    }
  }
  xx = block_sum<THREADS>(xx, red);
  yy = block_sum<THREADS>(yy, red);
  xy = block_sum<THREADS>(xy, red);
  yx = block_sum<THREADS>(yx, red);
  if (threadIdx.x == 0) {
    const float st = (float)((long long)a.n_s * a.n_t);
    const float s = xx / (float)((long long)a.n_s * a.n_s) + yy / (float)((long long)a.n_t * a.n_t) - xy / st -
                    yx / st;
    a.out[0] = fabsf(s);
    a.state[nn] = length_scale;
    a.state[nn + 1] = s >= 0.0f ? 1.0f : -1.0f;
  }
}

// ---------------------------------------------------------------------------
// "cluster" route: one launch of one cluster of CTAs.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMmdThreads) mmd_cluster_kernel(MmdArgs a) {
  // A batch of staged chunks during 1 (dynamic, kGramBatch of them), then
  // the summed rows (rows_s).
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(16) float gram[kMmdTile * kMmdTile];  // this CTA's Gram over its columns
  __shared__ __align__(16) float pdiag[kMmdTile];            // ... and its diagonal
  __shared__ __align__(16) float diag[kMmdTile];  // the summed Gram's diagonal
  __shared__ float ls_part[kMmdCluster];    // each CTA's sum of d2, pushed to every CTA
  __shared__ float k_part[4][kMmdCluster];  // CTA 0's: each CTA's four kernel sums
  __shared__ float red[kMmdThreads / 32];
  __shared__ float red4[kMmdThreads / 32][4];
  __shared__ float sig[kMmdMaxKernels];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int ctas = kMmdCluster;
  const int n = a.n_s + a.n_t;
  const int nn = n * n;

  // 1. This CTA's Gram over its share of the columns (a multiple of 4 wide),
  //    on the tensor cores: 3xTF32 (x = hi + lo split as a fragment is
  //    read, x y ~ hi hi + hi lo + lo hi, the small terms first), f32
  //    accumulate, the upper triangle's 16 x 8 tiles only.  The columns go
  //    through shared memory in batches of up to kGramBatch 32-column
  //    chunks, every cp.async of a batch in flight at once (all of a CTA's
  //    share at the main shape): a chunk fed through a ring two deep took
  //    ~1.4 us, each waiting out the load latency.
  {
    const int per = ((a.d + ctas - 1) / ctas + 3) / 4 * 4;
    const int c_begin = min(a.d, rank * per);
    const int c_end = min(a.d, c_begin + per);
    const int chunks = (c_end - c_begin + kGramChunk - 1) / kGramChunk;
    auto stage = [&](int c, float* dst) {
      const int c0 = c_begin + c * kGramChunk;
      if (a.vec16) {  // rows of 16-byte vectors (d % 4 == 0, aligned rows)
        for (int idx = threadIdx.x; idx < kMmdTile * kGramChunk / 4; idx += kMmdThreads) {
          const int r = idx / (kGramChunk / 4);
          const int col = c0 + 4 * (idx % (kGramChunk / 4));
          const bool valid = r < n && col < c_end;
          cp_async16(dst + r * kGramLd + col - c0, valid ? mmd_row(a.src, a.tgt, a.n_s, a.d, r) + col : a.src, valid);
        }
      } else {
        for (int idx = threadIdx.x; idx < kMmdTile * kGramChunk; idx += kMmdThreads) {
          const int r = idx / kGramChunk;
          const int col = c0 + idx % kGramChunk;
          const bool valid = r < n && col < c_end;
          cp_async4(dst + r * kGramLd + col - c0, valid ? mmd_row(a.src, a.tgt, a.n_s, a.d, r) + col : a.src, valid);
        }
      }
    };
    // Warp w takes kept tiles w, w + 8, w + 16 (of 20); warps 4 .. 7 compute
    // a third tile too (a repeat of the last) rather than branch.  Two
    // accumulators a tile, for the even and the odd k-steps, so that the
    // warp's six chains of dependent products interleave.
    const int warp = threadIdx.x >> 5;
    const int g = (threadIdx.x & 31) >> 2;
    const int t = threadIdx.x & 3;
    int row[kGramTilesPerWarp], col[kGramTilesPerWarp];
    const int tiles = warp + 16 < kGramTiles ? 3 : 2;
#pragma unroll
    for (int i = 0; i < kGramTilesPerWarp; ++i) {
      const int tile = gram_tile(min(warp + 8 * i, kGramTiles - 1));
      row[i] = 16 * (tile >> 3) + g;
      col[i] = 8 * (tile & 7) + g;
    }
    float acc[kGramTilesPerWarp][2][4];
#pragma unroll
    for (int i = 0; i < kGramTilesPerWarp; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p) acc[i][p][0] = acc[i][p][1] = acc[i][p][2] = acc[i][p][3] = 0.0f;

    for (int b0 = 0; b0 < chunks; b0 += kGramBatch) {
      const int b1 = min(chunks, b0 + kGramBatch);
      if (b0 > 0) __syncthreads();  // the previous batch is consumed
      for (int c = b0; c < b1; ++c) stage(c, ring + (c - b0) * kMmdTile * kGramLd);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int c = b0; c < b1; ++c) {
        const float* st = ring + (c - b0) * kMmdTile * kGramLd;
#pragma unroll
        for (int k = 0; k < kGramChunk; k += 8) {
#pragma unroll
          for (int i = 0; i < kGramTilesPerWarp; ++i) {
            const float* ra = st + row[i] * kGramLd + k + t;
            const float* rb = st + col[i] * kGramLd + k + t;
            uint32_t ah[4], al[4], bh[2], bl[2];
            split_tf32(ra[0], ah[0], al[0]);
            split_tf32(ra[8 * kGramLd], ah[1], al[1]);
            split_tf32(ra[4], ah[2], al[2]);
            split_tf32(ra[8 * kGramLd + 4], ah[3], al[3]);
            split_tf32(rb[0], bh[0], bl[0]);
            split_tf32(rb[4], bh[1], bl[1]);
            float (&d)[4] = acc[i][(k / 8) & 1];
            mma_tf32_1688(d, al, bh[0], bh[1]);
            mma_tf32_1688(d, ah, bl[0], bl[1]);
            mma_tf32_1688(d, ah, bh[0], bh[1]);
          }
        }
      }
    }
    // The tiles into gram, made whole and exactly symmetric: (i, j) with
    // i < j also into (j, i), (i, i) also into pdiag, and the lower half of a
    // tile on the diagonal left to its mirror.  C rows g, g + 8, columns 2t,
    // 2t + 1 of each.
#pragma unroll
    for (int i = 0; i < kGramTilesPerWarp; ++i) {
      if (i < tiles) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row[i] + 8 * (e >> 1);
          const int c = col[i] - g + 2 * t + (e & 1);
          const float v = acc[i][0][e] + acc[i][1][e];
          if (r < c) {
            gram[r * kMmdTile + c] = v;
            gram[c * kMmdTile + r] = v;
          } else if (r == c) {
            gram[r * kMmdTile + c] = v;
            pdiag[r] = v;
          }
        }
      }
    }
  }
  cluster.sync();

  // 2. The summed Gram at this CTA's rows [r0, r0 + rows) and its diagonal,
  //    each element added over the CTAs in rank order from every CTA's
  //    shared memory: 16-byte loads, all of a thread's in flight at once
  //    (a distributed-shared-memory request costs about the same for 4
  //    bytes as for 16), into rows_s and diag.
  float* rows_s = ring;  // [kMmdTile / kMmdCluster][kMmdRowsLd]
  const int rows_per = (kMmdTile + ctas - 1) / ctas;
  const int r0 = rank * rows_per;
  const int rows = max(0, min(rows_per, n - r0));
  auto cluster_sum4 = [&](const float* local, int at) {
    float4 v[ctas];
#pragma unroll
    for (int q = 0; q < ctas; ++q) v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(local, q) + at);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int q = 0; q < ctas; ++q) {
      sum.x += v[q].x;
      sum.y += v[q].y;
      sum.z += v[q].z;
      sum.w += v[q].w;
    }
    return sum;
  };
  if (threadIdx.x < rows * (kMmdTile / 4)) {
    const int r = threadIdx.x / (kMmdTile / 4);
    const int c = 4 * (threadIdx.x % (kMmdTile / 4));
    *reinterpret_cast<float4*>(rows_s + r * kMmdRowsLd + c) = cluster_sum4(gram, (r0 + r) * kMmdTile + c);
  } else if (threadIdx.x >= kMmdThreads - kMmdTile / 4) {
    const int c = 4 * (threadIdx.x - (kMmdThreads - kMmdTile / 4));
    *reinterpret_cast<float4*>(diag + c) = cluster_sum4(pdiag, c);
  }
  __syncthreads();

  // 3. d2 before the clamp at these rows into the state; this CTA's sum of
  //    the clamped d2 pushed into every CTA's ls_part.
  float local = 0.0f;
  for (int e = threadIdx.x; e < rows * n; e += kMmdThreads) {
    const int r = e / n;
    const int i = r0 + r;
    const int j = e - r * n;
    const float raw = i == j ? 0.0f : diag[i] + diag[j] - 2.0f * rows_s[r * kMmdRowsLd + j];
    a.state[i * n + j] = raw;
    local += fmaxf(raw, 0.0f);
  }
  local = block_sum<kMmdThreads>(local, red);
  if (threadIdx.x < ctas) cluster.map_shared_rank(ls_part, (int)threadIdx.x)[rank] = local;
  cluster.sync();

  // 4. The bandwidth (every CTA adds the parts in rank order), then this
  //    CTA's four kernel sums into CTA 0's k_part.
  float total = 0.0f;
  for (int q = 0; q < ctas; ++q) total += ls_part[q];
  const float length_scale = total / (float)(nn - n) / a.bandwidth_div;
  if (threadIdx.x < a.kernel_num) {
    sig[threadIdx.x] = length_scale * a.mul_pow[threadIdx.x] + 1e-12f;
  }
  __syncthreads();
  float xx = 0.0f, yy = 0.0f, xy = 0.0f, yx = 0.0f;
  for (int e = threadIdx.x; e < rows * n; e += kMmdThreads) {
    const int r = e / n;
    const int i = r0 + r;
    const int j = e - r * n;
    const float d2 = i == j ? 0.0f : fmaxf(diag[i] + diag[j] - 2.0f * rows_s[r * kMmdRowsLd + j], 0.0f);
    float k = 0.0f;
#pragma unroll 4
    for (int m = 0; m < a.kernel_num; ++m) k += expf(-d2 / sig[m]);
    if (i < a.n_s) {
      if (j < a.n_s) xx += k; else xy += k;
    } else {
      if (j < a.n_s) yx += k; else yy += k;
    }
  }
  // The four sums over the block at once, in a fixed order.
  xx = warp_sum(xx);
  yy = warp_sum(yy);
  xy = warp_sum(xy);
  yx = warp_sum(yx);
  if ((threadIdx.x & 31) == 0) {
    red4[threadIdx.x >> 5][0] = xx;
    red4[threadIdx.x >> 5][1] = yy;
    red4[threadIdx.x >> 5][2] = xy;
    red4[threadIdx.x >> 5][3] = yx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    xx = yy = xy = yx = 0.0f;
    for (int w = 0; w < kMmdThreads / 32; ++w) {
      xx += red4[w][0];
      yy += red4[w][1];
      xy += red4[w][2];
      yx += red4[w][3];
    }
    float* part = cluster.map_shared_rank(&k_part[0][0], 0);
    part[rank] = xx;
    part[kMmdCluster + rank] = yy;
    part[2 * kMmdCluster + rank] = xy;
    part[3 * kMmdCluster + rank] = yx;
  }
  cluster.sync();  // every remote access is done: the other CTAs may exit

  // 5. CTA 0: the value and its sign.
  if (rank != 0 || threadIdx.x != 0) return;
  xx = yy = xy = yx = 0.0f;
  for (int q = 0; q < ctas; ++q) {
    xx += k_part[0][q];
    yy += k_part[1][q];
    xy += k_part[2][q];
    yx += k_part[3][q];
  }
  const float st = (float)((long long)a.n_s * a.n_t);
  const float s = xx / (float)((long long)a.n_s * a.n_s) + yy / (float)((long long)a.n_t * a.n_t) - xy / st - yx / st;
  a.out[0] = fabsf(s);
  a.state[nn] = length_scale;
  a.state[nn + 1] = s >= 0.0f ? 1.0f : -1.0f;
}

// The cluster kernel's attributes (the non-portable cluster size, its
// dynamic shared memory), set once per device: they never change, and the
// call is host time on every launch otherwise.
cudaError_t mmd_cluster_attributes() {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mmd_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = allow_smem(mmd_cluster_kernel, kMmdClusterSmem);
  if (err == cudaSuccess && dev < kDevices) done[dev] = true;
  return err;
}

cudaError_t launch_mmd_cluster(const MmdArgs& a, cudaStream_t stream) {
  cudaError_t err = mmd_cluster_attributes();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMmdCluster);
  cfg.blockDim = dim3(kMmdThreads);
  cfg.dynamicSmemBytes = kMmdClusterSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMmdCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, mmd_cluster_kernel, a);
}

// ---------------------------------------------------------------------------
// "split" route: Gram partials, then one block for the sum and the tail.
// ---------------------------------------------------------------------------

// partial[split][i][j] = sum over columns [split * 64, split * 64 + 64) of
// total_i * total_j, for one 64 x 64 tile of (i, j).
__global__ void __launch_bounds__(kMmdThreads)
mmd_gram_partial_kernel(const float* src, const float* tgt, int n_s, int n_t, int d,
                        float* partial) {
  __shared__ float a[kMmdTile][kMmdDChunk + 1];
  __shared__ float b[kMmdTile][kMmdDChunk + 1];
  const int n = n_s + n_t;
  const int split = blockIdx.x;
  const int c0 = split * kMmdDChunk;
  const int tiles = (n + kMmdTile - 1) / kMmdTile;
  const int i0 = (blockIdx.y / tiles) * kMmdTile;
  const int j0 = (blockIdx.y % tiles) * kMmdTile;

  for (int idx = threadIdx.x; idx < kMmdTile * kMmdDChunk; idx += kMmdThreads) {
    const int r = idx / kMmdDChunk;
    const int c = idx - r * kMmdDChunk;
    const int col = c0 + c;
    const int ri = i0 + r;
    const int rj = j0 + r;
    a[r][c] = (ri < n && col < d) ? mmd_row(src, tgt, n_s, d, ri)[col] : 0.0f;
    b[r][c] = (rj < n && col < d) ? mmd_row(src, tgt, n_s, d, rj)[col] : 0.0f;
  }
  __syncthreads();

  const int ty = threadIdx.x / 16;  // rows ty + 16 * u of the tile
  const int tx = threadIdx.x % 16;  // columns tx + 16 * v
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  for (int c = 0; c < kMmdDChunk; ++c) {
    float av[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      av[u] = a[ty + 16 * u][c];
      bv[u] = b[tx + 16 * u][c];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  }
  float* out = partial + (size_t)split * n * n;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
    if (i >= n) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (j < n) out[(size_t)i * n + j] = acc[u][v];
    }
  }
}

__global__ void __launch_bounds__(kMmdFinishThreads)
mmd_finish_kernel(const float* partial, int splits, float* gram, MmdArgs a) {
  __shared__ float red[kMmdFinishThreads / 32];
  __shared__ float sig[kMmdMaxKernels];
  const int n = a.n_s + a.n_t;
  const long long nn = (long long)n * n;
  for (long long i = threadIdx.x; i < nn; i += kMmdFinishThreads) {
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) acc += partial[(size_t)s * nn + i];
    gram[i] = acc;
  }
  __syncthreads();
  mmd_tail<kMmdFinishThreads>(gram, n, a, red, sig);
}

int mmd_splits(int d) { return (d + kMmdDChunk - 1) / kMmdDChunk; }

__global__ void empty_kernel() {}

}  // namespace

// 1 for the "cluster" route at n = n_s + n_t rows, 0 for the "split" route.
extern "C" int edrl_mk_mmd_route(int n) { return (int)mmd_route_cluster(n); }

// f32 scratch the forward needs at (n = n_s + n_t, d): none on the cluster
// route; the Gram partials and the Gram matrix on the split route.
extern "C" long long edrl_mk_mmd_scratch_floats(int n, int d) {
  return mmd_route_cluster(n) ? 0 : (long long)(mmd_splits(d) + 1) * n * n;
}

// out[8]: the cluster kernel's registers per thread, static shared memory
// bytes, local memory bytes and threads per CTA; then the split route's
// partial kernel's registers, shared memory and local memory, and the
// cluster route's CTAs.
extern "C" int edrl_mk_mmd_fwd_attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mmd_cluster_kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[3] = kMmdThreads;
  err = cudaFuncGetAttributes(&attr, mmd_gram_partial_kernel);
  if (err != cudaSuccess) return (int)err;
  out[4] = attr.numRegs;
  out[5] = (int)attr.sharedSizeBytes;
  out[6] = (int)attr.localSizeBytes;
  out[7] = kMmdCluster;
  return 0;
}

// source [n_s, d], target [n_t, d] f32; out a 0-d f32, state n * n + 2 f32;
// scratch edrl_mk_mmd_scratch_floats(n, d) f32 (unused on the cluster
// route).  kernel_num at most 16.
extern "C" int edrl_mk_mmd_fwd(const void* source, const void* target, int n_s, int n_t, int d,
                               float kernel_mul, int kernel_num, void* scratch, void* out, void* state,
                               void* stream) {
  if (kernel_num < 1 || kernel_num > kMmdMaxKernels) return (int)cudaErrorInvalidValue;
  MmdArgs a;
  a.src = static_cast<const float*>(source);
  a.tgt = static_cast<const float*>(target);
  a.n_s = n_s;
  a.n_t = n_t;
  a.d = d;
  a.kernel_mul = kernel_mul;
  a.kernel_num = kernel_num;
  a.bandwidth_div = (float)pow((double)kernel_mul, (double)(kernel_num / 2));
  for (int m = 0; m < kMmdMaxKernels; ++m) a.mul_pow[m] = (float)pow((double)kernel_mul, (double)m);
  a.out = static_cast<float*>(out);
  a.state = static_cast<float*>(state);
  a.vec16 = d % 4 == 0 && aligned16(source) && aligned16(target);
  const int n = n_s + n_t;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mmd_route_cluster(n)) {
    return (int)launch_mmd_cluster(a, s);
  }
  const int splits = mmd_splits(d);
  const int tiles = (n + kMmdTile - 1) / kMmdTile;
  float* partial = static_cast<float*>(scratch);
  float* gram = partial + (size_t)splits * n * n;
  mmd_gram_partial_kernel<<<dim3((unsigned)splits, (unsigned)(tiles * tiles)), kMmdThreads, 0, s>>>(
      a.src, a.tgt, n_s, n_t, d, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mmd_finish_kernel<<<1, kMmdFinishThreads, 0, s>>>(partial, splits, gram, a);
  return (int)cudaGetLastError();
}

// One launch of an empty kernel: the floor a one-launch call can reach.
extern "C" int edrl_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
