// Helpers shared by the kernels: f32 <-> element-type conversion, the
// strides of a [B, T, H, D] tensor, the shared-memory opt-in.
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

// Element strides of a [B, T, H, D] tensor, as the C entry points take them.
struct Strides {
  long long b, t, h, d;
};

// Above 48 KB of shared memory needs the opt-in, once per instantiation (not
// per launch, so launches can be captured into a CUDA graph).
template <typename Kernel>
inline int opt_in_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (*configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *configured = true;
  return 0;
}

}  // namespace tj
