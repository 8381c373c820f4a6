// Row RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel trainingjob_operator_tpu/ops/fused.py
// _rmsnorm_kernel (launched by _rmsnorm_forward): y = x * rsqrt(mean(x^2) +
// eps) * scale, statistics in f32, output in the input dtype.
//
// Bound: device-memory bytes.  Each row is read and written once (plus the
// [D] f32 scale, which every row shares and L2 keeps); there are 4 flops per
// element.  At the training step's [4096, 4096] bf16 that is 64 MB, 20 us on
// an H100 SXM; a 7B serve tick's [4, 4096] is 64 KB, so there the time is
// launch latency, not bandwidth.  What the design does about it:
// - each row is read from device memory once and stays in registers between
//   the sum of squares and the write (16-byte loads and stores: 8 bf16 or 4
//   f32; D must be a multiple of 8).  A row is held by a team of 1 to 8
//   warps, kPer vectors a thread: at D = 4096 bf16 8 warps of 2 vectors a
//   thread, which ran faster on an H100 than fewer warps holding more (more
//   warps in flight per SM, shorter per-thread chains at few rows);
// - the sum of squares is reduced by warp shuffles; a team of several warps
//   adds its warps' partial sums after one barrier;
// - the scale is read as 16-byte vectors beside the x vector it multiplies;
// - a CTA holds 8 warps, so 8 / team rows (ops/fused.py rmsnorm_plan).
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 8;

template <typename T, int kPer>
__global__ void __launch_bounds__(32 * kMaxWarps)
    rmsnorm_fwd_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int rows, int d, int team, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float partial[kMaxWarps];
  const int team_threads = 32 * team;
  const int row = blockIdx.x * (blockDim.x / team_threads) +
                  threadIdx.x / team_threads;
  const int tid = threadIdx.x % team_threads;  // within the row's team
  const int nvec = d / kVec;
  const bool live = row < rows;
  const uint4* xrow =
      reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * d);

  uint4 v[kPer];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * team_threads;
    v[j] = live && i < nvec ? xrow[i] : make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const T* e = reinterpret_cast<const T*>(&v[j]);
#pragma unroll
    for (int m = 0; m < kVec; ++m) {
      const float f = tj::to_f32(e[m]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (team > 1) {  // uniform over the launch: every thread reaches the barrier
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = ss;
    __syncthreads();
    const int first = warp / team * team;
    ss = 0.f;
    for (int w = 0; w < team; ++w) ss += partial[first + w];
  }
  if (!live) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * d);
  const float4* scale4 = reinterpret_cast<const float4*>(scale);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * team_threads;
    if (i >= nvec) continue;
    float sc[kVec];
#pragma unroll
    for (int m = 0; m < kVec / 4; ++m) {
      const float4 s4 = scale4[i * (kVec / 4) + m];
      sc[4 * m] = s4.x;
      sc[4 * m + 1] = s4.y;
      sc[4 * m + 2] = s4.z;
      sc[4 * m + 3] = s4.w;
    }
    const T* e = reinterpret_cast<const T*>(&v[j]);
    uint4 packed;
    T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int m = 0; m < kVec; ++m)
      o[m] = tj::from_f32<T>(tj::to_f32(e[m]) * r * sc[m]);
    orow[i] = packed;
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, int rows, int d,
           float eps, int per, int team, cudaStream_t s) {
  const int rows_per_cta = kMaxWarps / team;
  const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta);
  const dim3 block(32 * kMaxWarps);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (per) {
    case 1:
      rmsnorm_fwd_kernel<T, 1><<<grid, block, 0, s>>>(xt, scale, ot, rows, d,
                                                      team, eps);
      break;
    case 2:
      rmsnorm_fwd_kernel<T, 2><<<grid, block, 0, s>>>(xt, scale, ot, rows, d,
                                                      team, eps);
      break;
    case 4:
      rmsnorm_fwd_kernel<T, 4><<<grid, block, 0, s>>>(xt, scale, ot, rows, d,
                                                      team, eps);
      break;
    case 8:
      rmsnorm_fwd_kernel<T, 8><<<grid, block, 0, s>>>(xt, scale, ot, rows, d,
                                                      team, eps);
      break;
    case 16:
      rmsnorm_fwd_kernel<T, 16><<<grid, block, 0, s>>>(xt, scale, ot, rows,
                                                       d, team, eps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out: contiguous [rows, d], 16-byte aligned; scale: contiguous [d] f32,
// 16-byte aligned.  per (16-byte vectors a thread) and team (warps a row, a
// divisor of kMaxWarps) come from ops/fused.py rmsnorm_plan.
extern "C" int tj_rmsnorm_fwd(const void* x, const void* scale, void* out,
                              int rows, int d, float eps, int dtype, int per,
                              int team, void* stream) {
  if (rows <= 0) return 0;
  const int vec = dtype == tj::kBF16 ? 8 : 4;
  if ((dtype != tj::kBF16 && dtype != tj::kF32) || d % vec != 0 ||
      team < 1 || kMaxWarps % team != 0 || d / vec > 32 * team * per)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == tj::kBF16)
    return launch<__nv_bfloat16>(x, sc, out, rows, d, eps, per, team, s);
  return launch<float>(x, sc, out, rows, d, eps, per, team, s);
}
