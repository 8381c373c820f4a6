// Building blocks of the f32-FMA flash kernels (flash_fwd.cu, and the dQ
// and dK/dV kernels of flash_bwd.cu): cp.async copies of 4-element chunks
// into shared memory, the XOR swizzle of those chunks, 4-element shared
// loads widened to f32, exp2, and the shared-memory opt-in.
//
// A tile of `rows` x D elements is stored row-major in chunks of 4
// elements (16 bytes of f32, 8 of bf16).  Chunk c of row r sits at chunk
// c ^ (r & M): the rows that the threads of a warp read at one chunk differ
// in their low bits, so their chunks fall in different banks, with no
// padding (which would break the 16-byte alignment of every chunk).  M is
// a template argument of each tile: the readers' row pattern decides it.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace tj {

constexpr float kLog2e = 1.4426950408889634f;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Offset in elements of chunk c of row r of a tile with rows of D
// elements, swizzled by x = r & M (the caller keeps x per row).
template <int D>
__device__ __forceinline__ int chunk_at(int r, int c, int x) {
  return r * D + ((c ^ x) << 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One 4-element chunk from device memory into shared memory, zero-filled
// where !pred (src must still be a valid address).
__device__ __forceinline__ void cp_chunk(float* dst, const float* src,
                                         bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_chunk(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 8 : 0)
               : "memory");
}
// One f32 (lse, delta) into shared memory, zero-filled where !pred.
__device__ __forceinline__ void cp_f32(float* dst, const float* src,
                                       bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 elements at p (16-byte aligned for f32, 8-byte for bf16) as f32.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// 4 f32 values stored as T at p, rounded to nearest even for bf16.
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// acc + a . b, the four products added in order (d ascending).
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 2^x in one MUFU instruction (relative error about 2^-22); -inf-like
// arguments give +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Queue rows t0 .. t0 + ROWS - 1 of one head of x ([B, T, H, D] with d-stride
// 1, rows `st` elements apart) into a shared tile, chunk c of row r at
// chunk c ^ (r & M); rows past T_len are zero-filled.
template <typename T, int D, int ROWS, int NT, int M>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long st,
                                          int t0, int T_len) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int n = 0; n < (ROWS * kChunks + NT - 1) / NT; ++n) {
    const int idx = static_cast<int>(threadIdx.x) + n * NT;
    if (ROWS * kChunks % NT != 0 && idx >= ROWS * kChunks) break;
    const int r = idx / kChunks, c = idx % kChunks, t = t0 + r;
    const bool ok = t < T_len;
    cp_chunk(dst + chunk_at<D>(r, c, r & M), ok ? src + t * st + 4 * c : src,
             ok);
  }
}

// The shared-memory opt-in (common.cuh opt_in_smem) with the largest
// shared carve-out: two or three CTAs of up to 113 KB an SM need it.
template <typename Kernel>
inline int opt_in_max_smem(Kernel kernel, size_t bytes, bool* configured) {
  if (!*configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return opt_in_smem(kernel, bytes, configured);
}

// Whether a [B, T, H, D] tensor of `dtype` (kF32, kBF16) given by its
// element strides can be copied in 4-element chunks: d-stride 1, the other
// strides and the base 4-element aligned.
inline bool chunked(const void* p, const Strides& s, int dtype) {
  const uintptr_t align = dtype == kBF16 ? 8 : 16;
  return s.d == 1 && s.t % 4 == 0 && s.h % 4 == 0 && s.b % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % align == 0;
}

}  // namespace tj
