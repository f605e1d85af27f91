// K1, the conv epilogue: out = act(scale * y + bias [+ res]), fp32 math,
// stored in y's dtype.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_TANH = 3,
           ACT_SIGMOID = 4 };
enum Mode { MODE_NONE = 0, MODE_COL = 1, MODE_ROW = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

template <int ACT> __device__ __forceinline__ float activate(float x) {
  if (ACT == ACT_RELU) return x < 0.0f ? 0.0f : x;  // NaN stays NaN
  if (ACT == ACT_GELU) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  if (ACT == ACT_TANH) return tanhf(x);
  if (ACT == ACT_SIGMOID) return 1.0f / (1.0f + expf(-x));
  return x;
}

template <typename T, typename I, int ACT, int MODE, bool RES>
__global__ void __launch_bounds__(256)
conv_epilogue_kernel(const T* __restrict__ y, const T* __restrict__ scale,
                     const T* __restrict__ bias, const T* __restrict__ res,
                     T* __restrict__ out, I n, I c, I inner) {
  const I stride = static_cast<I>(blockDim.x) * static_cast<I>(gridDim.x);
  for (I i = static_cast<I>(blockIdx.x) * static_cast<I>(blockDim.x) +
             static_cast<I>(threadIdx.x);
       i < n; i += stride) {
    float v = to_f32(y[i]);
    if (MODE != MODE_NONE) {
      const I ch = (MODE == MODE_COL) ? (i % c) : ((i / inner) % c);
      v = __fadd_rn(__fmul_rn(v, to_f32(scale[ch])), to_f32(bias[ch]));
    }
    if (RES) v = __fadd_rn(v, to_f32(res[i]));
    out[i] = from_f32<T>(activate<ACT>(v));
  }
}

template <typename T, typename I, int ACT, int MODE>
cudaError_t launch_res(const void* y, const void* scale, const void* bias,
                       const void* res, void* out, int64_t n, int64_t c,
                       int64_t inner, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // enough blocks to fill every SM many times over; the grid-stride loop
  // covers the rest
  if (blocks > 8192) blocks = 8192;
  const T* yp = static_cast<const T*>(y);
  const T* sp = static_cast<const T*>(scale);
  const T* bp = static_cast<const T*>(bias);
  const T* rp = static_cast<const T*>(res);
  T* op = static_cast<T*>(out);
  if (res != nullptr) {
    conv_epilogue_kernel<T, I, ACT, MODE, true>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            yp, sp, bp, rp, op, static_cast<I>(n), static_cast<I>(c),
            static_cast<I>(inner));
  } else {
    conv_epilogue_kernel<T, I, ACT, MODE, false>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            yp, sp, bp, rp, op, static_cast<I>(n), static_cast<I>(c),
            static_cast<I>(inner));
  }
  return cudaGetLastError();
}

template <typename T, typename I, int ACT>
cudaError_t launch_mode(int mode, const void* y, const void* scale,
                        const void* bias, const void* res, void* out,
                        int64_t n, int64_t c, int64_t inner,
                        cudaStream_t stream) {
  switch (mode) {
    case MODE_NONE:
      return launch_res<T, I, ACT, MODE_NONE>(y, scale, bias, res, out, n,
                                              c, inner, stream);
    case MODE_COL:
      return launch_res<T, I, ACT, MODE_COL>(y, scale, bias, res, out, n,
                                             c, inner, stream);
    case MODE_ROW:
      return launch_res<T, I, ACT, MODE_ROW>(y, scale, bias, res, out, n,
                                             c, inner, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, typename I>
cudaError_t launch_act(int act, int mode, const void* y, const void* scale,
                       const void* bias, const void* res, void* out,
                       int64_t n, int64_t c, int64_t inner,
                       cudaStream_t stream) {
  switch (act) {
    case ACT_IDENTITY:
      return launch_mode<T, I, ACT_IDENTITY>(mode, y, scale, bias, res, out,
                                             n, c, inner, stream);
    case ACT_RELU:
      return launch_mode<T, I, ACT_RELU>(mode, y, scale, bias, res, out, n,
                                         c, inner, stream);
    case ACT_GELU:
      return launch_mode<T, I, ACT_GELU>(mode, y, scale, bias, res, out, n,
                                         c, inner, stream);
    case ACT_TANH:
      return launch_mode<T, I, ACT_TANH>(mode, y, scale, bias, res, out, n,
                                         c, inner, stream);
    case ACT_SIGMOID:
      return launch_mode<T, I, ACT_SIGMOID>(mode, y, scale, bias, res, out,
                                            n, c, inner, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_index(int act, int mode, const void* y, const void* scale,
                         const void* bias, const void* res, void* out,
                         int64_t n, int64_t c, int64_t inner,
                         cudaStream_t stream) {
  // 32-bit indices while i + stride cannot overflow them
  if (n + 8192LL * 256LL < (1LL << 32)) {
    return launch_act<T, uint32_t>(act, mode, y, scale, bias, res, out, n, c,
                                   inner, stream);
  }
  return launch_act<T, int64_t>(act, mode, y, scale, bias, res, out, n, c,
                                inner, stream);
}

}  // namespace

extern "C" int conv_epilogue_launch(const void* y, const void* scale,
                                    const void* bias, const void* res,
                                    void* out, long long n, long long c,
                                    long long inner, int mode, int act,
                                    int dtype, void* stream) {
  if (n <= 0 || c <= 0 || inner <= 0) return cudaErrorInvalidValue;
  if (mode != MODE_NONE && (scale == nullptr || bias == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case DT_F32:
      return launch_index<float>(act, mode, y, scale, bias, res, out, n, c,
                                 inner, s);
    case DT_BF16:
      return launch_index<__nv_bfloat16>(act, mode, y, scale, bias, res, out,
                                         n, c, inner, s);
    case DT_F16:
      return launch_index<__half>(act, mode, y, scale, bias, res, out, n, c,
                                  inner, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* conv_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
