// K2, the matmul epilogue: out = dropout(act(y + bias)), fp32 math, stored
// in y's dtype. The bias is read at its own dtype (fp32, bf16 or f16, a
// run-time code), as the JAX reference reads it: under AMP a Dense layer's
// product is bf16 while its bias stays an fp32 parameter. y is the (R, C)
// output of a matrix product; dropout keeps an element where its uint8
// bits >= threshold and scales it by inv_keep = 1 / (1 - p), else writes 0.
//
// Replaces the Pallas TPU kernel mxnet_tpu/pallas/kernels.py
// _matmul_epilogue_call (entered through _matmul_epilogue_pallas, the N-D
// wrapper fused_matmul_epilogue, the _contrib_matmul_epilogue op and the
// fused path of gluon Dense). It computes what that kernel computes; it
// does not copy its (8, 128)-tiled block grid or its (R, 1)/(1, C) vector
// block specs, and it takes the shapes that the Pallas kernel's supports
// gate sends to the XLA reference (a minor dim under 8, any R and C).
//
// Bound on an H100: bytes. Each element of y (and of bits, with dropout)
// is read once and each output element written once, with one add, an
// activation and at most one multiply in between, so the least time is
// (bytes moved) / 3.35 TB/s. The matrix product before it stays in
// cuBLAS (torch.matmul), as the JAX package leaves it to XLA.
//
// Design: one grid-stride pass over the contiguous y, neighbouring threads
// on neighbouring addresses (coalesced loads and stores). The bias is read
// in place in one of two modes:
//   col: bias[j]   (a (1, C) bias: a Dense layer's, along the last axis)
//   row: bias[i]   (a (R, 1) bias)
// for element (i, j). Dropout is a template switch, so the predict path
// reads no bits. The add and the dropout multiply are rounded separately
// (no fused multiply-add) and inv_keep is the fp32 reciprocal the wrapper
// passes, so the result equals the plain PyTorch version's arithmetic on
// the card.
//   - Vector pass, when C is a multiple of the vector and y, out, bits
//     (and a column bias) are aligned to their vector widths: each thread
//     handles one 16-byte vector of y (8 bf16 or f16 elements, 4 fp32) per
//     step, one 16-byte load of y, one 8- or 4-byte load of its bits and
//     one 16-byte store. The grid's stride is a whole number of rows of
//     vectors, so a thread keeps its column from step to step: its
//     column and row come from one division at the start, it loads its
//     column's bias vector once, and each step adds a fixed number of rows
//     (no i % C per element).
//   - Element pass otherwise (a C that is not a multiple of the vector, a
//     view at an odd offset): one element per thread per step with the
//     index arithmetic below. The same arithmetic per element, so both
//     passes give the same bits.
//
// C interface for ctypes: matmul_epilogue_launch returns the cudaError_t
// of the launch (0 on success); matmul_epilogue_error_string names it.

#include "epilogue_common.cuh"

using namespace mxtt;

namespace {

enum Mode { MODE_COL = 1, MODE_ROW = 2 };

// one element: dropout(act(y + b)), rounded to T once
template <typename T, int ACT, bool DROP>
__device__ __forceinline__ T epilogue(T y, float b, unsigned bits,
                                      unsigned threshold, float inv_keep) {
  float v = activate<ACT>(__fadd_rn(to_f32(y), b));
  if (DROP) v = bits >= threshold ? __fmul_rn(v, inv_keep) : 0.0f;
  return from_f32<T>(v);
}

// the bits that go with one vector of y: 8 bytes for 16-bit elements, 4
// for fp32
template <int N> struct BitsVec;
template <> struct BitsVec<8> { using type = uint2; };
template <> struct BitsVec<4> { using type = uint32_t; };

template <typename T, int ACT, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads)
matmul_epilogue_vec_kernel(const T* __restrict__ y,
                           const void* __restrict__ bias, int bdt,
                           const uint8_t* __restrict__ bits,
                           T* __restrict__ out, int64_t rows, int64_t cv,
                           unsigned threshold, float inv_keep) {
  constexpr int N = 16 / sizeof(T);               // elements per vector
  using B = typename BitsVec<N>::type;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  // the grid's stride is a multiple of cv: the column stays fixed
  const int64_t step = static_cast<int64_t>(blockDim.x) * gridDim.x / cv;
  const int64_t col = start % cv;
  int64_t row = start / cv;
  float bv[N];
  if (MODE == MODE_COL && row < rows) {
#pragma unroll
    for (int e = 0; e < N; ++e) bv[e] = load_f32(bias, col * N + e, bdt);
  }
  for (; row < rows; row += step) {
    const int64_t at = (row * cv + col) * N;
    alignas(16) T yv[N];
    alignas(16) T ov[N];
    alignas(8) uint8_t kv[N];
    *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(y + at);
    if (DROP) {
      *reinterpret_cast<B*>(kv) = *reinterpret_cast<const B*>(bits + at);
    }
    const float br = MODE == MODE_ROW ? load_f32(bias, row, bdt) : 0.0f;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      ov[e] = epilogue<T, ACT, DROP>(yv[e], MODE == MODE_COL ? bv[e] : br,
                                     DROP ? kv[e] : 0u, threshold,
                                     inv_keep);
    }
    *reinterpret_cast<uint4*>(out + at) = *reinterpret_cast<uint4*>(ov);
  }
}

template <typename T, typename I, int ACT, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads)
matmul_epilogue_kernel(const T* __restrict__ y,
                       const void* __restrict__ bias, int bdt,
                       const uint8_t* __restrict__ bits,
                       T* __restrict__ out, I n, I c, unsigned threshold,
                       float inv_keep) {
  const I stride = static_cast<I>(blockDim.x) * static_cast<I>(gridDim.x);
  for (I i = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
             static_cast<I>(threadIdx.x);
       i < n; i += stride) {
    const I b = (MODE == MODE_COL) ? (i % c) : (i / c);
    out[i] = epilogue<T, ACT, DROP>(y[i], load_f32(bias, b, bdt),
                                    DROP ? static_cast<unsigned>(bits[i])
                                         : 0u,
                                    threshold, inv_keep);
  }
}

int64_t gcd(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t r = a % b;
    a = b;
    b = r;
  }
  return a;
}

// the vector pass over the (n / c, c / N) vectors, when every pointer and
// C allow it; returns false (nothing launched) when they do not
template <typename T, int ACT, int MODE>
bool launch_vec(const void* y, const void* bias, int bdt, const void* bits,
                void* out, int64_t n, int64_t c, unsigned threshold,
                float inv_keep, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const uintptr_t mis =
      (reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) &
      15;
  if (c % N != 0 || mis != 0 ||
      (reinterpret_cast<uintptr_t>(bits) & (N - 1)) != 0) {
    return false;
  }
  const int64_t cv = c / N;
  const int64_t rows = n / c;
  // the least grid whose stride (blocks * kThreads) is a multiple of cv,
  // times as many as the vectors need, up to kMaxBlocks
  const int64_t unit = cv / gcd(cv, kThreads);
  const int64_t want = (rows * cv + kThreads - 1) / kThreads;
  int64_t blocks = want < kMaxBlocks ? want : kMaxBlocks;
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > 0x7fffffffLL) return false;
  const T* yp = static_cast<const T*>(y);
  const uint8_t* kp = static_cast<const uint8_t*>(bits);
  T* op = static_cast<T*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (bits != nullptr) {
    matmul_epilogue_vec_kernel<T, ACT, MODE, true>
        <<<grid, kThreads, 0, stream>>>(yp, bias, bdt, kp, op, rows, cv,
                                        threshold, inv_keep);
  } else {
    matmul_epilogue_vec_kernel<T, ACT, MODE, false>
        <<<grid, kThreads, 0, stream>>>(yp, bias, bdt, kp, op, rows, cv,
                                        threshold, inv_keep);
  }
  return true;
}

template <typename T, typename I, int ACT, int MODE>
cudaError_t launch_drop(const void* y, const void* bias, int bdt,
                        const void* bits, void* out, int64_t n, int64_t c,
                        unsigned threshold, float inv_keep,
                        cudaStream_t stream) {
  if (launch_vec<T, ACT, MODE>(y, bias, bdt, bits, out, n, c, threshold,
                               inv_keep, stream)) {
    return cudaGetLastError();
  }
  const unsigned blocks = grid_for(n);
  const T* yp = static_cast<const T*>(y);
  const uint8_t* kp = static_cast<const uint8_t*>(bits);
  T* op = static_cast<T*>(out);
  if (bits != nullptr) {
    matmul_epilogue_kernel<T, I, ACT, MODE, true>
        <<<blocks, kThreads, 0, stream>>>(yp, bias, bdt, kp, op,
                                          static_cast<I>(n),
                                          static_cast<I>(c), threshold,
                                          inv_keep);
  } else {
    matmul_epilogue_kernel<T, I, ACT, MODE, false>
        <<<blocks, kThreads, 0, stream>>>(yp, bias, bdt, kp, op,
                                          static_cast<I>(n),
                                          static_cast<I>(c), threshold,
                                          inv_keep);
  }
  return cudaGetLastError();
}

template <typename T, typename I, int ACT>
cudaError_t launch_mode(int mode, const void* y, const void* bias, int bdt,
                        const void* bits, void* out, int64_t n, int64_t c,
                        unsigned threshold, float inv_keep,
                        cudaStream_t stream) {
  switch (mode) {
    case MODE_COL:
      return launch_drop<T, I, ACT, MODE_COL>(y, bias, bdt, bits, out, n, c,
                                              threshold, inv_keep, stream);
    case MODE_ROW:
      return launch_drop<T, I, ACT, MODE_ROW>(y, bias, bdt, bits, out, n, c,
                                              threshold, inv_keep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
cudaError_t launch_act(int act, int mode, const void* y, const void* bias,
                       int bdt, const void* bits, void* out, int64_t n,
                       int64_t c, unsigned threshold, float inv_keep,
                       cudaStream_t stream) {
  switch (act) {
    case ACT_IDENTITY:
      return launch_mode<T, I, ACT_IDENTITY>(mode, y, bias,
                                             bdt, bits, out, n, c,
                                             threshold, inv_keep, stream);
    case ACT_RELU:
      return launch_mode<T, I, ACT_RELU>(mode, y, bias, bdt, bits, out, n, c,
                                         threshold, inv_keep, stream);
    case ACT_GELU:
      return launch_mode<T, I, ACT_GELU>(mode, y, bias, bdt, bits, out, n, c,
                                         threshold, inv_keep, stream);
    case ACT_TANH:
      return launch_mode<T, I, ACT_TANH>(mode, y, bias, bdt, bits, out, n, c,
                                         threshold, inv_keep, stream);
    case ACT_SIGMOID:
      return launch_mode<T, I, ACT_SIGMOID>(mode, y, bias, bdt, bits, out,
                                            n, c, threshold, inv_keep,
                                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_index(int act, int mode, const void* y, const void* bias,
                         int bdt, const void* bits, void* out, int64_t n,
                         int64_t c, unsigned threshold, float inv_keep,
                         cudaStream_t stream) {
  if (fits_u32(n)) {
    return launch_act<T, uint32_t>(act, mode, y, bias, bdt, bits, out, n, c,
                                   threshold, inv_keep, stream);
  }
  return launch_act<T, int64_t>(act, mode, y, bias, bdt, bits, out, n, c,
                                threshold, inv_keep, stream);
}

}  // namespace

extern "C" int matmul_epilogue_launch(const void* y, const void* bias,
                                      const void* bits, void* out,
                                      long long n, long long c, int mode,
                                      int act, int dtype, int bias_dtype,
                                      int threshold, float inv_keep,
                                      void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || bias == nullptr ||
      !valid_dtype(bias_dtype)) {
    return cudaErrorInvalidValue;
  }
  if (threshold < 0 || threshold > 255) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned t = static_cast<unsigned>(threshold);
  switch (dtype) {
    case DT_F32:
      return launch_index<float>(act, mode, y, bias,
                                 bias_dtype, bits, out, n, c, t,
                                 inv_keep, s);
    case DT_BF16:
      return launch_index<__nv_bfloat16>(act, mode, y, bias,
                                         bias_dtype, bits, out, n, c,
                                         t, inv_keep, s);
    case DT_F16:
      return launch_index<__half>(act, mode, y, bias,
                                  bias_dtype, bits, out, n, c, t,
                                  inv_keep, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* matmul_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
