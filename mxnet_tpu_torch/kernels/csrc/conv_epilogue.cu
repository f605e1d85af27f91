// K1, the conv epilogue: out = act(scale * y + bias [+ res]), fp32 math,
// stored in y's dtype. scale, bias and res are each read at their own
// dtype (fp32, bf16 or f16, a run-time code per operand), as the JAX
// reference reads every operand at its precision: a bf16 y under AMP
// takes BatchNorm's fp32 scale and bias.
//
// Replaces the Pallas TPU kernel mxnet_tpu/pallas/kernels.py
// _conv_epilogue_call (entered through _conv_epilogue_pallas and the N-D
// wrapper fused_conv_epilogue). It computes what that kernel computes; it
// does not copy its (8, 128)-tiled block grid, its divisor search for a
// block shape, its lane-aligned 2-D view or its tiled per-row vectors.
//
// Bound on an H100: bytes. Each element is read once (y, and res when
// given) and written once, with one multiply-add and an activation in
// between, so the kernel is far below the card's ratio of operations to
// bytes and its least time is (bytes moved) / 3.35 TB/s.
//
// Design: one flat grid-stride pass over the contiguous y. Neighbouring
// threads touch neighbouring elements, so every load and store is
// coalesced. The per-channel vector is indexed directly, in one of three
// modes, so it is never tiled or copied:
//   none: no vector (the residual-only form); y * 1 + 0 == y exactly.
//   col:  channel = i % C               (channel-last layouts)
//   row:  channel = (i / inner) % C     (NCHW: inner = H * W)
// Any size is taken: the loop masks the ragged end itself, and indices
// are 32-bit when the tensor allows it (64-bit division costs more
// instructions than the memory time of an element). The multiply and the
// add are rounded separately (no fused multiply-add) so the result equals
// the plain PyTorch version's fp32 arithmetic.
//
// C interface for ctypes: conv_epilogue_launch returns the cudaError_t of
// the launch (0 on success); conv_epilogue_error_string names it.

#include "epilogue_common.cuh"

using namespace mxtt;

namespace {

enum Mode { MODE_NONE = 0, MODE_COL = 1, MODE_ROW = 2 };

template <typename T, typename I, int ACT, int MODE, bool RES>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const T* __restrict__ y, const void* __restrict__ scale,
                     const void* __restrict__ bias,
                     const void* __restrict__ res, T* __restrict__ out, I n,
                     I c, I inner, int sdt, int bdt, int rdt) {
  const I stride = static_cast<I>(blockDim.x) * static_cast<I>(gridDim.x);
  for (I i = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
             static_cast<I>(threadIdx.x);
       i < n; i += stride) {
    float v = to_f32(y[i]);
    if (MODE != MODE_NONE) {
      const I ch = (MODE == MODE_COL) ? (i % c) : ((i / inner) % c);
      v = __fadd_rn(__fmul_rn(v, load_f32(scale, ch, sdt)),
                    load_f32(bias, ch, bdt));
    }
    if (RES) v = __fadd_rn(v, load_f32(res, i, rdt));
    out[i] = from_f32<T>(activate<ACT>(v));
  }
}

template <typename T, typename I, int ACT, int MODE>
cudaError_t launch_res(const void* y, const void* scale, const void* bias,
                       const void* res, void* out, int64_t n, int64_t c,
                       int64_t inner, const int* dts, cudaStream_t stream) {
  const unsigned blocks = grid_for(n);
  const T* yp = static_cast<const T*>(y);
  T* op = static_cast<T*>(out);
  if (res != nullptr) {
    conv_epilogue_kernel<T, I, ACT, MODE, true>
        <<<blocks, kThreads, 0, stream>>>(
            yp, scale, bias, res, op, static_cast<I>(n), static_cast<I>(c),
            static_cast<I>(inner), dts[0], dts[1], dts[2]);
  } else {
    conv_epilogue_kernel<T, I, ACT, MODE, false>
        <<<blocks, kThreads, 0, stream>>>(
            yp, scale, bias, res, op, static_cast<I>(n), static_cast<I>(c),
            static_cast<I>(inner), dts[0], dts[1], dts[2]);
  }
  return cudaGetLastError();
}

template <typename T, typename I, int ACT>
cudaError_t launch_mode(int mode, const void* y, const void* scale,
                        const void* bias, const void* res, void* out,
                        int64_t n, int64_t c, int64_t inner, const int* dts,
                        cudaStream_t stream) {
  switch (mode) {
    case MODE_NONE:
      return launch_res<T, I, ACT, MODE_NONE>(y, scale, bias, res, out, n,
                                              c, inner, dts, stream);
    case MODE_COL:
      return launch_res<T, I, ACT, MODE_COL>(y, scale, bias, res, out, n,
                                             c, inner, dts, stream);
    case MODE_ROW:
      return launch_res<T, I, ACT, MODE_ROW>(y, scale, bias, res, out, n,
                                             c, inner, dts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
cudaError_t launch_act(int act, int mode, const void* y, const void* scale,
                       const void* bias, const void* res, void* out,
                       int64_t n, int64_t c, int64_t inner, const int* dts,
                       cudaStream_t stream) {
  switch (act) {
    case ACT_IDENTITY:
      return launch_mode<T, I, ACT_IDENTITY>(mode, y, scale, bias, res, out,
                                             n, c, inner, dts, stream);
    case ACT_RELU:
      return launch_mode<T, I, ACT_RELU>(mode, y, scale, bias, res, out, n,
                                         c, inner, dts, stream);
    case ACT_GELU:
      return launch_mode<T, I, ACT_GELU>(mode, y, scale, bias, res, out, n,
                                         c, inner, dts, stream);
    case ACT_TANH:
      return launch_mode<T, I, ACT_TANH>(mode, y, scale, bias, res, out, n,
                                         c, inner, dts, stream);
    case ACT_SIGMOID:
      return launch_mode<T, I, ACT_SIGMOID>(mode, y, scale, bias, res, out,
                                            n, c, inner, dts, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_index(int act, int mode, const void* y, const void* scale,
                         const void* bias, const void* res, void* out,
                         int64_t n, int64_t c, int64_t inner, const int* dts,
                         cudaStream_t stream) {
  if (fits_u32(n)) {
    return launch_act<T, uint32_t>(act, mode, y, scale, bias, res, out, n, c,
                                   inner, dts, stream);
  }
  return launch_act<T, int64_t>(act, mode, y, scale, bias, res, out, n, c,
                                inner, dts, stream);
}

}  // namespace

extern "C" int conv_epilogue_launch(const void* y, const void* scale,
                                    const void* bias, const void* res,
                                    void* out, long long n, long long c,
                                    long long inner, int mode, int act,
                                    int dtype, int scale_dtype,
                                    int bias_dtype, int res_dtype,
                                    void* stream) {
  if (n <= 0 || c <= 0 || inner <= 0) return cudaErrorInvalidValue;
  if (mode != MODE_NONE && (scale == nullptr || bias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (!valid_dtype(scale_dtype) || !valid_dtype(bias_dtype) ||
      !valid_dtype(res_dtype)) {
    return cudaErrorInvalidValue;
  }
  const int dts[3] = {scale_dtype, bias_dtype, res_dtype};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_index<float>(act, mode, y, scale, bias, res, out, n, c,
                                 inner, dts, s);
    case DT_BF16:
      return launch_index<__nv_bfloat16>(act, mode, y, scale, bias, res, out,
                                         n, c, inner, dts, s);
    case DT_F16:
      return launch_index<__half>(act, mode, y, scale, bias, res, out, n, c,
                                  inner, dts, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
