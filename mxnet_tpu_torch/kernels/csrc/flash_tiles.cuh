// Tile helpers of the flash-attention kernels on the tensor cores, shared by
// the forward (flash_attention.cu) and the backward (flash_attention_bwd.cu):
// the tilings per head dim, the staging of a resident operand split into
// tf32 hi and lo, the cp.async ring of streamed tiles, the m16n8k8 fragment
// loads and the three products of a tile step, in 3xTF32 (mma_tf32.cuh).
//
// Each CTA keeps R rows of one operand resident (q in the forward and in
// dQ, k and v in dK/dV), split once into hi and lo as tf32 words [R][DP +
// 4], and streams tiles of C rows of the others through a two-stage ring
// [C][DP + 16 bytes] in their own dtype. A warp owns MT m-tiles of 16
// resident rows and 1 / WN of the columns of each product.
//
// The k index of a product contracted over the streamed rows is read
// permuted, k = t <-> row 2t and k = t + 4 <-> row 2t + 1 (the same in A
// and B, so the sum is the same). Then the accumulator of s, which holds
// columns (2t, 2t + 1) of rows g and g + 8, is the A fragment of the next
// product as it stands, and the streamed operand's column reads X[2t][g],
// X[2t + 1][g] hit banks 8t + g (+ 4) with the same row stride that keeps
// the D-contracting reads X[g][t] on banks 4g + t: no swizzle and no second
// copy (16-bit tiles: D + 8 elements).

#pragma once

#include "epilogue_common.cuh"
#include "mma_tf32.cuh"

namespace mxtt {

constexpr size_t kMaxSmem = 232448;   // bytes a CTA may use on an H100

// tiles of head dim DP (64, 128 or 256): R resident rows, C rows per
// streamed tile; a warp owns MT m-tiles of 16 rows and 1 / WN of the
// columns of each product
template <int DP>
struct Tiles {
  static constexpr bool kRegP = DP <= 64;     // p, ds stay in registers
  static constexpr int kRes = DP <= 64 ? 128 : (DP <= 128 ? 64 : 32);
  static constexpr int kStream = DP <= 64 ? 64 : (DP <= 128 ? 32 : 16);
  static constexpr int kMT = DP == 128 ? 2 : 1;
  static constexpr int kWN = DP <= 64 ? 1 : (DP <= 128 ? 4 : 2);
  static constexpr int kThreads = 32 * kWN * kRes / (16 * kMT);
  static constexpr int kN1 = kStream / (8 * kWN);  // n-tiles of s, dp
  static constexpr int kN2 = DP / (8 * kWN);       // n-tiles of a gradient
  static constexpr int kRS = DP + 4;               // resident row, words
  static constexpr int kSS = kStream + 8;          // p, ds row, floats
};

// row stride of a streamed tile in elements: 16 bytes of padding
template <typename T, int DP>
__host__ __device__ constexpr int stream_stride() {
  return DP + 16 / static_cast<int>(sizeof(T));
}

// the widest cp.async (16, 8 or 4 bytes) that every row of the two
// streamed operands a and b allows, given their (batch, seq, head) strides
// st in elements of esize bytes; 0 when none does
inline int copy_width(const void* a, const void* b, int64_t esize,
                      const int64_t (&st)[6]) {
  uint64_t bits = reinterpret_cast<uintptr_t>(a) |
                  reinterpret_cast<uintptr_t>(b);
  for (int64_t s : st) bits |= static_cast<uint64_t>(s * esize);
  for (int w = 16; w >= 4; w >>= 1) {
    if ((bits & static_cast<uint64_t>(w - 1)) == 0) return w;
  }
  return 0;
}

// rows [r0, r0 + ROWS) of a (seq, D) operand with sequence stride ss into
// hi and lo [ROWS][DP + 4] as tf32 words; rows past n and columns past d
// are zeros
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void stage_split(uint32_t* hi, uint32_t* lo,
                                            const T* src, int64_t ss,
                                            int64_t r0, int64_t n, int d) {
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
    const int r = idx / DP;
    const int c = idx - r * DP;
    const int64_t row = r0 + r;
    const float x = (row < n && c < d) ? to_f32(src[row * ss + c]) : 0.0f;
    uint32_t h, l;
    split_tf32(x, h, l);
    hi[r * (DP + 4) + c] = h;
    lo[r * (DP + 4) + c] = l;
  }
}

// start copying rows [r0, r0 + ROWS) of a (seq, D) operand into dst
// [ROWS][stream_stride] with cp.async of `width` bytes (zero-filling rows
// past n and bytes past d), or with plain loads when width is 0
template <typename T, int DP, int ROWS, int NT>
__device__ __forceinline__ void issue_rows(T* dst, const T* src, int64_t ss,
                                           int64_t r0, int64_t n, int d,
                                           int width) {
  constexpr int RT = stream_stride<T, DP>();
  if (width == 0) {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int64_t row = r0 + r;
      dst[r * RT + c] = (row < n && c < d) ? src[row * ss + c]
                                           : from_f32<T>(0.0f);
    }
    return;
  }
  const int shift = width == 16 ? 4 : (width == 8 ? 3 : 2);
  const int per_row = (DP * static_cast<int>(sizeof(T))) >> shift;
  const int row_bytes = d * static_cast<int>(sizeof(T));
  for (int idx = threadIdx.x; idx < ROWS * per_row; idx += NT) {
    const int r = idx / per_row;
    const int cb = (idx - r * per_row) << shift;    // byte in the row
    const int64_t row = r0 + r;
    int bytes = row < n ? row_bytes - cb : 0;
    bytes = bytes < 0 ? 0 : (bytes > width ? width : bytes);
    const char* s = reinterpret_cast<const char*>(src);
    if (bytes > 0) s = reinterpret_cast<const char*>(src + row * ss) + cb;
    char* o = reinterpret_cast<char*>(dst + r * RT) + cb;
    if (width == 16) {
      cp_async<16>(o, s, bytes);
    } else if (width == 8) {
      cp_async<8>(o, s, bytes);
    } else {
      cp_async<4>(o, s, bytes);
    }
  }
}

// A fragment of a resident split operand [row][DP + 4], rows row..row+15,
// columns k0..k0+7 (contracted over D)
template <int RS>
__device__ __forceinline__ void load_a_res(uint32_t (&h)[4], uint32_t (&l)[4],
                                           const uint32_t* H,
                                           const uint32_t* L, int row,
                                           int k0, int g, int t) {
  const int i0 = (row + g) * RS + k0 + t;
  const int i1 = i0 + 8 * RS;
  h[0] = H[i0];
  h[1] = H[i1];
  h[2] = H[i0 + 4];
  h[3] = H[i1 + 4];
  l[0] = L[i0];
  l[1] = L[i1];
  l[2] = L[i0 + 4];
  l[3] = L[i1 + 4];
}

// B fragment contracted over D: rows n0..n0+7 of a streamed tile are the
// n index, columns k0..k0+7 the k index: X[n0 + g][k0 + t], [.][k0 + t + 4]
template <typename T, int RT>
__device__ __forceinline__ void load_b_rows(uint32_t (&h)[2],
                                            uint32_t (&l)[2], const T* X,
                                            int n0, int k0, int g, int t) {
  const T* x = X + (n0 + g) * RT + k0 + t;
  split_tf32(to_f32(x[0]), h[0], l[0]);
  split_tf32(to_f32(x[4]), h[1], l[1]);
}

// B fragment contracted over the tile's rows, k permuted: k = t is row
// k0 + 2t and k = t + 4 is row k0 + 2t + 1, column col is the n index
template <typename T, int RT>
__device__ __forceinline__ void load_b_cols(uint32_t (&h)[2],
                                            uint32_t (&l)[2], const T* X,
                                            int k0, int col, int t) {
  const T* x = X + (k0 + 2 * t) * RT + col;
  split_tf32(to_f32(x[0]), h[0], l[0]);
  split_tf32(to_f32(x[RT]), h[1], l[1]);
}

// A fragment of p or ds [row][SS] with the same permuted k: the pairs of
// columns (k0 + 2t, k0 + 2t + 1) of rows row + g and row + g + 8
template <int SS>
__device__ __forceinline__ void load_a_pairs(uint32_t (&h)[4],
                                             uint32_t (&l)[4], const float* W,
                                             int row, int k0, int g, int t) {
  const float2 x =
      *reinterpret_cast<const float2*>(W + (row + g) * SS + k0 + 2 * t);
  const float2 y =
      *reinterpret_cast<const float2*>(W + (row + g + 8) * SS + k0 + 2 * t);
  split_tf32(x.x, h[0], l[0]);
  split_tf32(y.x, h[1], l[1]);
  split_tf32(x.y, h[2], l[2]);
  split_tf32(y.y, h[3], l[3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
}

// acc += part with fp32 adds (rounded to nearest), then part = 0
template <int N>
__device__ __forceinline__ void promote(float (&acc)[N][4],
                                       float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] += part[j][e];
      part[j][e] = 0.0f;
    }
  }
}

// acc * mul into a (seq, D) output: accumulator i = m N2 + j has rows
// row0 + 16 m + g (+ 8) and columns col0 + 8 j + 2t (+ 1); those below n
// and d are stored
template <typename T, int N2, int M>
__device__ __forceinline__ void store_acc(T* dst, int64_t ss, int64_t row0,
                                          int64_t n, int d, int col0,
                                          const float (&acc)[M][4],
                                          float mul, int g, int t) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t row = row0 + 16 * (i / N2) + g + 8 * (e >> 1);
      const int c = col0 + 8 * (i % N2) + 2 * t + (e & 1);
      if (row < n && c < d) dst[row * ss + c] = from_f32<T>(acc[i][e] * mul);
    }
  }
}

__device__ __forceinline__ int64_t bh_index() {
  return static_cast<int64_t>(blockIdx.y) +
         static_cast<int64_t>(gridDim.y) * blockIdx.z;
}

// the contraction over D of one tile step, in 3xTF32: acc[m N + j] +=
// A[row0 + 16 m ..][:] . X[n0 + 8 j ..][:] for a resident split A
// (hi H, lo L) and a streamed X
template <typename T, int DP, int MT, int N, int RS, int RT>
__device__ __forceinline__ void product_over_d(float (&acc)[MT * N][4],
                                               const uint32_t* H,
                                               const uint32_t* L,
                                               const T* X, int row0, int n0,
                                               int g, int t) {
  float small[MT * N][4];         // the lo terms, added once at the end
  zero(small);
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      load_a_res<RS>(ah[m], al[m], H, L, row0 + 16 * m, 8 * kk, g, t);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t bh[2], bl[2];
      load_b_rows<T, RT>(bh, bl, X, n0 + 8 * j, 8 * kk, g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_tf32(small[m * N + j], al[m], bh);
        mma_tf32(small[m * N + j], ah[m], bl);
        mma_tf32(acc[m * N + j], ah[m], bh);
      }
    }
  }
  promote(acc, small);
}

// the contraction over the K tile rows of one tile step, in 3xTF32, into
// acc[m N + j]: W (p or ds, [row][SS]) rows row0 + 16 m .. times X's
// columns col0 + 8 j .., summed into a zeroed part and then added
template <typename T, int MT, int N, int K, int SS, int RT>
__device__ __forceinline__ void product_over_rows(float (&acc)[MT * N][4],
                                                  float (&part)[MT * N][4],
                                                  const float* W, const T* X,
                                                  int row0, int col0, int g,
                                                  int t) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      load_a_pairs<SS>(ah[m], al[m], W, row0 + 16 * m, 8 * kk, g, t);
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t bh[2], bl[2];
      load_b_cols<T, RT>(bh, bl, X, 8 * kk, col0 + 8 * j + g, t);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_3xtf32(part[m * N + j], ah[m], al[m], bh, bl);
      }
    }
  }
  promote(acc, part);
}

// the contraction over the tile's rows with W (p or ds) still in this
// warp's accumulators: n-tile kk of W holds columns (2t, 2t + 1) of rows
// g, g + 8, which is the A fragment of k-step kk under the permuted k
template <typename T, int N, int K, int RT>
__device__ __forceinline__ void product_over_regs(float (&acc)[N][4],
                                                  float (&part)[N][4],
                                                  const float (&w)[K / 8][4],
                                                  const T* X, int col0, int g,
                                                  int t) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    split_tf32(w[kk][0], ah[0], al[0]);
    split_tf32(w[kk][2], ah[1], al[1]);
    split_tf32(w[kk][1], ah[2], al[2]);
    split_tf32(w[kk][3], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint32_t bh[2], bl[2];
      load_b_cols<T, RT>(bh, bl, X, 8 * kk, col0 + 8 * j + g, t);
      mma_3xtf32(part[j], ah, al, bh, bl);
    }
  }
  promote(acc, part);
}

}  // namespace mxtt
