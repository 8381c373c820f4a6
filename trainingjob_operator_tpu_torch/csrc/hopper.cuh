// Hopper building blocks shared by the tensor-core flash kernels
// (flash_fwd_wgmma.cu, flash_bwd_dq_wgmma.cu, flash_bwd_dkv_wgmma.cu) and the
// grouped expert products (moe_experts.cu), as inline PTX for sm_90a:
// mbarriers, TMA tile loads through 4-D tensor maps with 128-byte swizzle,
// shared-memory matrix descriptors and warpgroup matrix multiplies (wgmma).
//
// Tile layout in shared memory.  A bf16 tile of `rows` x D is stored as D / 64
// panels of rows x 64 elements (128 bytes a row, the widest box the 128-byte
// swizzle takes); panel p holds columns 64p .. 64p + 63 and starts at
// p * rows * 128 bytes.  TMA writes each panel with the 128-byte swizzle: the
// 16-byte chunk c of row r lands at chunk c ^ (r % 8).  wgmma reads the same
// layout through a descriptor:
// - K-major (the reduction dim contiguous: Q, K in Q.K^T): 8-row groups 1024
//   bytes apart (SBO); the k-th 16-element step starts 32 k bytes further
//   into the row, the next panel at the next panel's base.
// - MN-major (the output dim contiguous: V in P.V, K in dQ, dO and Q in dV
//   and dK):
//   the reduction rows advance 16 rows = 2048 bytes a step, 8-row groups
//   are 1024 bytes apart (SBO), 64-column panels rows * 128 bytes apart
//   (LBO); the instruction's transpose bit says so.
// Every tile starts on a 1024-byte boundary, so the swizzle pattern that
// TMA applied by address is the one wgmma undoes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hop {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A fresh barrier is
// in phase 0, so waiting on parity 1 returns at once (the producer's first
// pass over an empty ring).  A wait of more than about 2^35 cycles (over 15 s
// at the H100's clocks) traps, so a broken pipeline fails the launch with an
// error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 35)) __trap();
}

// ---- TMA --------------------------------------------------------------------

// Copy the box at (c0, c1, c2, c3) = (d, t, h, b) of `map` into shared memory
// at `dst`; completion is reported to `bar` as transaction bytes.  Rows past
// the tensor's end arrive as zeros and still count their bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A panelled tile (see the top of this file): rows t0 .. t0 + rows - 1 of
// head h of batch b, all D columns, as D / 64 boxes of 64 columns.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int t0,
                                          int h, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load_4d(dst + p * rows * 128, map, bar, p * 64, t0, h, b);
}

// ---- wgmma ------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (LBO) and stride byte offset (SBO), each in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows x 16 elements at reduction step k of a panelled tile
// of `rows` rows (row0: the first row of the operand within the tile).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows,
                                                int row0, int k) {
  return desc(tile + (k / 4) * rows * 128 + row0 * 128 + (k % 4) * 32, 16,
              1024);
}

// MN-major operand: reduction rows 16 k .. 16 k + 15 of a panelled tile of
// `rows` rows, all of its columns.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows,
                                                 int k) {
  return desc(tile + k * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Two f32 -> one register of two bf16 (round to nearest even), the lower
// column in the low half: a wgmma register-A operand pair.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of a m64nN product, thread t of the warpgroup: register
// 4 j + 2 i + c holds row 16 (t / 32) + (t % 32) / 4 + 8 i, column
// 8 j + 2 (t % 4) + c.  Columns 16 k .. 16 k + 15 of it, packed, are the
// register-A operand of reduction step k of a following product.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&acc)[N], int k,
                                         uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * k + 0], acc[8 * k + 1]);
  a[1] = pack_bf16(acc[8 * k + 2], acc[8 * k + 3]);
  a[2] = pack_bf16(acc[8 * k + 4], acc[8 * k + 5]);
  a[3] = pack_bf16(acc[8 * k + 6], acc[8 * k + 7]);
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory (descriptors), f32 accumulators in registers; scale_d = 0 starts
// the sum afresh.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A MN-major in shared memory (the
// instruction's transpose bit for A: a [16 x 64] tile whose 64 output rows
// are contiguous, desc_mnmajor) and B K-major; scale_d = 0 starts the sum
// afresh.
__device__ __forceinline__ void wgmma_ss_n64_ta(float (&d)[32],
                                                uint64_t desc_a,
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared
// memory (descriptors), f32 accumulators in registers; scale_d = 0 starts
// the sum afresh.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64],
                                              uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A bf16 in registers (acc_to_a),
// B MN-major in shared memory (the instruction's transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A bf16 in registers
// (acc_to_a), B MN-major in shared memory (the instruction's transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- host: tensor maps ------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the CUDA runtime has already
// loaded, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a bf16 [B, T, H, D] tensor given as dims (D, T, H, B) and the
// byte strides of t, h and b (ops/flash_attention.py tensor_map_geometry):
// boxes of 64 x box_rows x 1 x 1, 128-byte swizzle, zeros past the end.
// Returns 0 or a CUDA error code.
inline int make_map(CUtensorMap* map, const void* base, const long long* geom,
                    int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(geom[0]), static_cast<cuuint64_t>(geom[1]),
      static_cast<cuuint64_t>(geom[2]), static_cast<cuuint64_t>(geom[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(geom[4]),
                                 static_cast<cuuint64_t>(geom[5]),
                                 static_cast<cuuint64_t>(geom[6])};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hop
