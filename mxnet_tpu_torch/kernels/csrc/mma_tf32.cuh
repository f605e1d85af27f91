// Tensor-core building blocks for fp32-accurate products on Hopper (and
// Ampere): the tf32 split, the m16n8k8 tf32 mma.sync, the 3xTF32 product
// and cp.async copies into shared memory. Used by the flash-attention
// kernels through their tile helpers (flash_tiles.cuh).
//
// 3xTF32 ("fast fp32", as CUTLASS's mma_tensor_op_fast_f32.h): an fp32 x
// is split into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// with ties away from zero (the rounding of cvt.rna.tf32.f32); hi + lo
// equals x within 2^-22 |x|.
// a * b is then a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, the small terms
// issued first (into the same fp32 accumulator, or into one of their own);
// the dropped a_lo * b_lo is below 2^-22 of the product.
//
// m16n8k8 fragments (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32),
// for lane = 4 g + t of a warp:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g)  b1 (k t + 4, n g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt {

// the bits of cvt.rna.tf32.f32 for a finite x: half a unit of the 13
// dropped mantissa bits added to the magnitude, then those bits cleared
// (round to nearest, ties away from zero; a carry moves into the exponent).
// Two integer ops, issued at full rate where the cvt is not.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo within 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a b on one m16n8k8 tile, tf32 operands, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b in 3xTF32: the lo terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy src_bytes (0 to BYTES) from global to shared memory and zero the rest
// of the BYTES; both addresses BYTES-aligned
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "n"(BYTES),
                    "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace mxtt
