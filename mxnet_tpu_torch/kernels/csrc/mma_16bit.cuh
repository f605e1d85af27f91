// Tensor-core building blocks for 16-bit operands (bf16 and f16) on Hopper:
// the m16n8k16 mma.sync with fp32 accumulation, ldmatrix fragment loads
// (plain and transposed) from shared memory, the packing of two fp32 values
// into one 16-bit pair (rounded to nearest even) and the fast exp2. Used by
// the 16-bit forward and backward of flash attention (flash_attention.cu,
// flash_attention_bwd.cu).
//
// m16n8k16 fragments (PTX ISA, "Matrix fragments for mma.m16n8k16",
// .bf16 / .f16), for lane = 4 g + t of a warp; each register holds two
// 16-bit values, the lower column (or k) in the low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1)  a1 (g + 8, 2t..)  a2 (g, 2t + 8..)
//                     a3 (g + 8, 2t + 8..)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t + 8.., n g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// So the accumulators of two neighbouring n-tiles (columns 0..7, 8..15) of
// one product, packed in pairs, are the A fragment of the next product
// contracted over those 16 columns: a0 = (c0, c1) and a1 = (c2, c3) of the
// first, a2 and a3 the same of the second. No permutation is needed.
//
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values; lanes 8i..8i+7
// give the row addresses of matrix i, and lane 4 g + t receives row g,
// columns 2t, 2t + 1 of each (with .trans, of its transpose).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt {

// d += a b on one m16n8k16 tile, 16-bit operands of type T, fp32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16<__half>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as one 16-bit pair of type T, each rounded to nearest
// even; lo in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack16<__nv_bfloat16>(float lo,
                                                          float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack16<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 matrices; TRANS loads each transposed
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
  }
}

// The 16 x 16 block of a row-major 16-bit array X (row stride rs elements)
// at (row0, col0) as four registers. ROWS_FIRST: matrix i is rows row0 +
// 8 (i & 1), columns col0 + 8 (i >> 1): with TRANS false the A fragment
// of rows row0.. contracted over columns col0..; with TRANS true the B
// fragments {r0, r1} of n-tile col0 and {r2, r3} of n-tile col0 + 8 when
// the rows are the k index. ROWS_FIRST false swaps the roles (matrix i is
// rows row0 + 8 (i >> 1), columns col0 + 8 (i & 1)): with TRANS false the
// B fragments {r0, r1} of n-tile row0 and {r2, r3} of n-tile row0 + 8
// when the columns are the k index.
template <bool TRANS, bool ROWS_FIRST, typename T>
__device__ __forceinline__ void ldsm_block(uint32_t (&r)[4], const T* X,
                                           int rs, int row0, int col0,
                                           int lane) {
  const int i = lane >> 3;
  const int hi = ROWS_FIRST ? (i & 1) : (i >> 1);
  const int hc = ROWS_FIRST ? (i >> 1) : (i & 1);
  ldsm_x4<TRANS>(r, X + (row0 + (lane & 7) + 8 * hi) * rs + col0 + 8 * hc);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x (ex2.approx: relative error 2^-22, 0 for -inf)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace mxtt
