// Device helpers shared by the epilogue kernels (K1 conv_epilogue.cu, K2
// matmul_epilogue.cu): the codes the Python wrappers pass, fp32 loads and
// stores of the three element types, loads of an operand whose element
// type is a run-time code, and the five activations. The
// flash-attention kernel (flash_attention.cu) uses the dtype codes and the
// loads and stores.
//
// Every activation is evaluated in fp32 with the same formula PyTorch's
// CUDA kernels use, so a kernel equals its plain PyTorch version bit for
// bit when the adds and multiplies before it are rounded separately too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtt {

enum Act { ACT_IDENTITY = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_TANH = 3,
           ACT_SIGMOID = 4 };
enum DType { DT_F32 = 0, DT_BF16 = 1, DT_F16 = 2 };

// grid-stride launches cap the grid here: enough blocks to fill every SM
// many times over; the loop covers the rest
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

inline unsigned grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// 32-bit indices while i + stride cannot overflow them (64-bit division
// costs more instructions than the memory time of an element)
inline bool fits_u32(int64_t n) {
  return n + kMaxBlocks * kThreads < (1LL << 32);
}

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

// element i of an operand whose dtype is the run-time code dt (a bias,
// scale or residual read at its own precision, whatever y's is). The code
// is the same for every thread of a launch, so the switch never diverges.
__device__ __forceinline__ float load_f32(const void* __restrict__ p,
                                          int64_t i, int dt) {
  if (dt == DT_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  }
  if (dt == DT_F16) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

inline bool valid_dtype(int dt) {
  return dt == DT_F32 || dt == DT_BF16 || dt == DT_F16;
}

template <int ACT> __device__ __forceinline__ float activate(float x) {
  if (ACT == ACT_RELU) return x < 0.0f ? 0.0f : x;  // NaN stays NaN
  if (ACT == ACT_GELU) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  if (ACT == ACT_TANH) return tanhf(x);
  if (ACT == ACT_SIGMOID) return 1.0f / (1.0f + expf(-x));
  return x;
}

}  // namespace mxtt
