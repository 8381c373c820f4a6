// Row RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel trainingjob_operator_tpu/ops/fused.py
// _rmsnorm_kernel (launched by _rmsnorm_forward): y = x * rsqrt(mean(x^2) +
// eps) * scale, statistics in f32, output in the input dtype.
//
// Bound: device-memory bytes.  Each row is read and written once (plus the
// [D] f32 scale); there are 4 flops per element.  At a 7B serve tick the
// input is 4 x 4096 bf16 (about 80 KB in and out), so the time is launch
// latency, not bandwidth.
//
// Design: one block per row, any row count (no divisor-of-rows block choice
// as on the TPU).  Loads and stores are 16 bytes per thread (8 bf16 or 4
// f32), so D must be a multiple of 8.  The sum of squares is reduced by warp
// shuffles, then across warps through shared memory.  The second pass
// re-reads the row, which the first pass left in L1/L2.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  __shared__ float total;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < kThreads / 32 ? partial[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      w += __shfl_xor_sync(0xffffffffu, w, off);
    if (lane == 0) total = w;
  }
  __syncthreads();
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       T* __restrict__ out, int d, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvec = d / kVec;
  const uint4* xrow =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(blockIdx.x) * d);
  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(blockIdx.x) * d);

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 raw = xrow[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float f = tj::to_f32(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 raw = xrow[i];
    const T* e = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      o[j] = tj::from_f32<T>(tj::to_f32(e[j]) * r * scale[i * kVec + j]);
    orow[i] = packed;
  }
}

}  // namespace

// x and out: contiguous [rows, d], 16-byte aligned; scale: contiguous [d] f32.
extern "C" int tj_rmsnorm_fwd(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == tj::kBF16) {
    rmsnorm_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), sc,
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else if (dtype == tj::kF32) {
    rmsnorm_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), sc, static_cast<float*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
