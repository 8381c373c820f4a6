// Helpers shared by the kernels: f32 <-> element-type conversion.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tj {

// dtype codes the C entry points take (ops/_build.py DTYPE_CODES).
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// Round to nearest even, as XLA's and PyTorch's f32 -> bf16 casts do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

}  // namespace tj
