// K2, the matmul epilogue: out = dropout(act(y + bias)), fp32 math, stored
// in y's dtype. y is the (R, C) output of a matrix product; dropout keeps
// an element where its uint8 bits >= threshold and scales it by
// inv_keep = 1 / (1 - p), else writes 0.
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
// Design: one flat grid-stride pass over the contiguous y, neighbouring
// threads on neighbouring elements (coalesced loads and stores). The bias
// is indexed in place in one of two modes:
//   col: bias[i % C]   (a (1, C) bias: a Dense layer's, along the last axis)
//   row: bias[i / C]   (a (R, 1) bias)
// Dropout is a template switch, so the predict path reads no bits. The add
// and the dropout multiply are rounded separately (no fused multiply-add)
// and inv_keep is the fp32 reciprocal the wrapper passes, so the result
// equals the plain PyTorch version's arithmetic on the card.
//
// C interface for ctypes: matmul_epilogue_launch returns the cudaError_t
// of the launch (0 on success); matmul_epilogue_error_string names it.

#include "epilogue_common.cuh"

using namespace mxtt;

namespace {

enum Mode { MODE_COL = 1, MODE_ROW = 2 };

template <typename T, typename I, int ACT, int MODE, bool DROP>
__global__ void __launch_bounds__(kThreads)
matmul_epilogue_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                       const uint8_t* __restrict__ bits,
                       T* __restrict__ out, I n, I c, unsigned threshold,
                       float inv_keep) {
  const I stride = static_cast<I>(blockDim.x) * static_cast<I>(gridDim.x);
  for (I i = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
             static_cast<I>(threadIdx.x);
       i < n; i += stride) {
    const I b = (MODE == MODE_COL) ? (i % c) : (i / c);
    float v = activate<ACT>(__fadd_rn(to_f32(y[i]), to_f32(bias[b])));
    if (DROP) {
      v = (static_cast<unsigned>(bits[i]) >= threshold)
              ? __fmul_rn(v, inv_keep) : 0.0f;
    }
    out[i] = from_f32<T>(v);
  }
}

template <typename T, typename I, int ACT, int MODE>
cudaError_t launch_drop(const void* y, const void* bias, const void* bits,
                        void* out, int64_t n, int64_t c, unsigned threshold,
                        float inv_keep, cudaStream_t stream) {
  const unsigned blocks = grid_for(n);
  const T* yp = static_cast<const T*>(y);
  const T* bp = static_cast<const T*>(bias);
  const uint8_t* kp = static_cast<const uint8_t*>(bits);
  T* op = static_cast<T*>(out);
  if (bits != nullptr) {
    matmul_epilogue_kernel<T, I, ACT, MODE, true>
        <<<blocks, kThreads, 0, stream>>>(yp, bp, kp, op, static_cast<I>(n),
                                          static_cast<I>(c), threshold,
                                          inv_keep);
  } else {
    matmul_epilogue_kernel<T, I, ACT, MODE, false>
        <<<blocks, kThreads, 0, stream>>>(yp, bp, kp, op, static_cast<I>(n),
                                          static_cast<I>(c), threshold,
                                          inv_keep);
  }
  return cudaGetLastError();
}

template <typename T, typename I, int ACT>
cudaError_t launch_mode(int mode, const void* y, const void* bias,
                        const void* bits, void* out, int64_t n, int64_t c,
                        unsigned threshold, float inv_keep,
                        cudaStream_t stream) {
  switch (mode) {
    case MODE_COL:
      return launch_drop<T, I, ACT, MODE_COL>(y, bias, bits, out, n, c,
                                              threshold, inv_keep, stream);
    case MODE_ROW:
      return launch_drop<T, I, ACT, MODE_ROW>(y, bias, bits, out, n, c,
                                              threshold, inv_keep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
cudaError_t launch_act(int act, int mode, const void* y, const void* bias,
                       const void* bits, void* out, int64_t n, int64_t c,
                       unsigned threshold, float inv_keep,
                       cudaStream_t stream) {
  switch (act) {
    case ACT_IDENTITY:
      return launch_mode<T, I, ACT_IDENTITY>(mode, y, bias, bits, out, n, c,
                                             threshold, inv_keep, stream);
    case ACT_RELU:
      return launch_mode<T, I, ACT_RELU>(mode, y, bias, bits, out, n, c,
                                         threshold, inv_keep, stream);
    case ACT_GELU:
      return launch_mode<T, I, ACT_GELU>(mode, y, bias, bits, out, n, c,
                                         threshold, inv_keep, stream);
    case ACT_TANH:
      return launch_mode<T, I, ACT_TANH>(mode, y, bias, bits, out, n, c,
                                         threshold, inv_keep, stream);
    case ACT_SIGMOID:
      return launch_mode<T, I, ACT_SIGMOID>(mode, y, bias, bits, out, n, c,
                                            threshold, inv_keep, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_index(int act, int mode, const void* y, const void* bias,
                         const void* bits, void* out, int64_t n, int64_t c,
                         unsigned threshold, float inv_keep,
                         cudaStream_t stream) {
  if (fits_u32(n)) {
    return launch_act<T, uint32_t>(act, mode, y, bias, bits, out, n, c,
                                   threshold, inv_keep, stream);
  }
  return launch_act<T, int64_t>(act, mode, y, bias, bits, out, n, c,
                                threshold, inv_keep, stream);
}

}  // namespace

extern "C" int matmul_epilogue_launch(const void* y, const void* bias,
                                      const void* bits, void* out,
                                      long long n, long long c, int mode,
                                      int act, int dtype, int threshold,
                                      float inv_keep, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || bias == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (threshold < 0 || threshold > 255) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned t = static_cast<unsigned>(threshold);
  switch (dtype) {
    case DT_F32:
      return launch_index<float>(act, mode, y, bias, bits, out, n, c, t,
                                 inv_keep, s);
    case DT_BF16:
      return launch_index<__nv_bfloat16>(act, mode, y, bias, bits, out, n, c,
                                         t, inv_keep, s);
    case DT_F16:
      return launch_index<__half>(act, mode, y, bias, bits, out, n, c, t,
                                  inv_keep, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* matmul_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
