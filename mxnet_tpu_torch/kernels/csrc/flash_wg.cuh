// Helpers of the 16-bit flash-attention kernels on wgmma (D <= 128), shared
// by the forward (flash_attention.cu) and the backward
// (flash_attention_bwd.cu): the backward's tilings, the copy of rows into
// 128-byte-swizzled 64-column tiles (wgmma.cuh) through cp.async, the
// K-major and MN-major descriptors of a k-step of those tiles, the packing
// of two accumulators into the 16-bit A fragment of the next product, and
// the 1024-byte alignment of the dynamic shared memory.

#pragma once

#include "epilogue_common.cuh"
#include "mma_16bit.cuh"
#include "mma_tf32.cuh"
#include "wgmma.cuh"

namespace mxtt {

// the two backward kernels
enum Which { DKV = 0, DQ = 1 };

// tiles of head dim DP (64 or 128) for wgmma: 128 resident rows (two
// warpgroups), C streamed rows per tile (dkv: queries, dq: keys) in a
// three-stage ring, two tiles ahead; every operand in 128-byte-swizzled
// 64-column tiles. C is 128 at D 64; at D 128 the dk and dv (or dq)
// accumulators take the registers that would hold it
template <int DP, int WHICH>
struct TilesWG {
  static constexpr int kRes = 128;
  static constexpr int kStream = DP == 64 ? 128 : (WHICH == DKV ? 32 : 64);
  static constexpr int kStages = 3;
  static constexpr int kThreads = 256;
};

template <int DP, int WHICH>
__host__ __device__ constexpr size_t smem_bytes_wg() {
  using C = TilesWG<DP, WHICH>;
  return 1024                                       // alignment slack
         + 2 * C::kRes * DP * 2                     // resident
         + C::kStages * 2 * C::kStream * DP * 2     // ring
         + (WHICH == DKV ? C::kStages * 2 * C::kStream * 4 : 0);  // stats
}

// start copying rows [r0, r0 + ROWS) of a (seq, D) operand into the
// swizzled tiles dst [DP / 64][ROWS][128 bytes] (wgmma.cuh) from thread
// tid of nthreads: cp.async of `width` bytes (zero-filling rows past n and
// bytes past d), or plain loads when width is 0
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void issue_rows_sw(T* dst, const T* src,
                                              int64_t ss, int64_t r0,
                                              int64_t n, int d, int width,
                                              int tid, int nthreads) {
  char* out = reinterpret_cast<char*>(dst);
  auto at = [](int r, int cb) {       // byte cb of row r in the tiles
    const int c = cb & 127;
    return (cb >> 7) * ROWS * 128 + r * 128 + (((c >> 4) ^ (r & 7)) << 4) +
           (c & 15);
  };
  if (width == 0) {
    for (int idx = tid; idx < ROWS * DP; idx += nthreads) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      const int64_t row = r0 + r;
      *reinterpret_cast<T*>(out + at(r, 2 * c)) =
          (row < n && c < d) ? src[row * ss + c] : from_f32<T>(0.0f);
    }
    return;
  }
  const int shift = width == 16 ? 4 : (width == 8 ? 3 : 2);
  const int per_row = (DP * 2) >> shift;
  const int row_bytes = d * 2;
  for (int idx = tid; idx < ROWS * per_row; idx += nthreads) {
    const int r = idx / per_row;
    const int cb = (idx - r * per_row) << shift;    // byte in the row
    const int64_t row = r0 + r;
    int bytes = row < n ? row_bytes - cb : 0;
    bytes = bytes < 0 ? 0 : (bytes > width ? width : bytes);
    const char* s = reinterpret_cast<const char*>(src);
    if (bytes > 0) s = reinterpret_cast<const char*>(src + row * ss) + cb;
    char* o = out + at(r, cb);
    if (width == 16) {
      cp_async<16>(o, s, bytes);
    } else if (width == 8) {
      cp_async<8>(o, s, bytes);
    } else {
      cp_async<4>(o, s, bytes);
    }
  }
}

// the K-major descriptor of k-step kk (16 columns) of the swizzled tiles
// at shared address base, ROWS rows per 64-column tile
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int kk) {
  return wgmma_desc(base + (kk >> 2) * ROWS * 128 + (kk & 3) * 32, 16, 1024);
}

// the MN-major descriptor of k-step kk (16 rows) of the same tiles
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int kk) {
  return wgmma_desc(base + kk * 2048, ROWS * 128, 1024);
}

// two accumulators of a product (n-tiles 2 kk and 2 kk + 1), packed in
// 16-bit pairs: the A fragment of k-step kk of the next product
template <typename T, int J>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&x)[J][4], int kk) {
  a[0] = pack16<T>(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack16<T>(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack16<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack16<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

__device__ __forceinline__ char* align1024(void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<char*>(p) + ((1024 - (a & 1023)) & 1023);
}

}  // namespace mxtt
