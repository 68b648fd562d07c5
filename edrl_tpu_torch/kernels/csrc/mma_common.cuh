// Tensor-core and copy helpers shared by the fused MLP, MK-MMD and the
// attention kernels: mma.sync m16n8k16 (bf16 in, f32 accumulate), ldmatrix
// of B fragments, bf16 packing, 32-bit shared-memory loads and cp.async.
//
// Fragment layout of m16n8k16 (lane = 4 * g + t): A rows g and g + 8, columns
// 2t, 2t + 1 (+ 8); B columns g, rows 2t, 2t + 1 (+ 8); C rows g and g + 8,
// columns 2t, 2t + 1.

#pragma once

#include "attention_common.cuh"

namespace {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a [16 keys, 8 columns] block of a row-major [key][d] tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

// 16 bytes (or, when !valid, 16 zero bytes) into shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

// 4 bytes (or 4 zero bytes), asynchronously.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
