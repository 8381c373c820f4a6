// Grouped expert products of the routed MLP (models/moe_decode.py
// _routed_mlp_token): every expert's SwiGLU over the rows that chose it, the
// per-expert row ranges read from device memory, so the host never waits for
// the routing.
//
// Replaces no TPU kernel: the JAX package gathers each row's chosen experts'
// weights with jnp.take and leaves the products to XLA
// (trainingjob_operator_tpu/models/moe_decode.py _routed_mlp_token).  The
// port groups the (row, choice) pairs by expert instead, so each expert's
// weights are read once a call and never copied.
//
// Inputs: `ends` [E] int64, the end of each expert's pairs in pair order (an
// inclusive cumulative sum of the per-expert counts: expert e's pairs are
// ends[e-1] .. ends[e] - 1); `rows` [P, K], the pairs' inputs in that order;
// `order` [P] int64, each position's pair index (row * k + choice).  Two
// entry points:
// - tj_moe_gate_up: h[i] = silu(rows[i] . w_gate[e]) * (rows[i] . w_up[e]),
//   h [P, F] in pair order;
// - tj_moe_down: y[order[i]] = h[i] . w_down[e], y [P, D] at each pair's own
//   place (row * k + choice), so no scatter follows.
//
// Bound: bytes.  A decode step (32 rows, 64 pairs) and a 256-row chunk (512
// pairs) of Mixtral-8x7B both read every reached expert's three 4096 x 14336
// bf16 matrices, 2.818 GB a layer for eight experts, 0.841 ms at 3.35 TB/s;
// a chunk's products are 0.18 TFLOP a layer, 0.18 ms at 989 TFLOP/s.  What
// the design does about it:
// - persistent: one CTA an SM walks the tiles (64 weight columns of gate
//   and up of one expert, or 128 of down).  Both roles read the expert's
//   range from `ends` first; an expert no pair chose is skipped before a
//   single weight byte is read;
// - a producer warp streams the weight strips (two 64 x 64 tiles a stage)
//   through a ring by TMA, each stage guarded by a full and an empty
//   mbarrier, and runs on into the next tile while the consumers finish
//   this one, so the epilogues hide under the loads;
// - the ring's row slot is the call's widest pass (read from `ends`),
//   rounded up to boxes of 8 rows, so a decode step (about 8-16 rows an
//   expert) keeps 8 stages in flight;
// - "swap AB": the weight tile is the wgmma's 64-row A operand, MN-major
//   (the output columns are contiguous in memory: the transpose bit), and the
//   expert's rows are the narrow B operand (K-major), 64 a product.  Four
//   consumer warpgroups, in two pairs: a pair takes blocks of 64 rows, one
//   warpgroup of it the stage's first weight tile and one the second
//   (consume_pass).  So a pass takes 256 rows and every weight is read once
//   while an expert has at most 256 rows: every decode step and every chunk
//   of the serving cell, whose busiest expert holds 105-256 of a chunk's
//   256 rows (its random router sends most rows to one expert).  Each
//   warpgroup keeps at most 64 accumulators a thread, and even a decode
//   step, whose rows fill one block, keeps two warpgroups' products in
//   flight;
// - the products of a stage stay in flight while the next stage's are
//   issued, and no product sits under a branch (consume_pass);
// - the rows arrive by TMA in boxes of 8, only as many as the pass holds;
// - the accumulators stay in registers.  gate/up's epilogue rounds as the
//   plain version does (bf16 gate, silu, up and product) and writes h in pair
//   order; down's writes each row at its pair's place.
// Measured on an H100 (700 W), a layer of Mixtral-8x7B: a decode step's
// products in 0.949 ms, 88.7% of the bound (the cuBLAS loop over the
// experts: 1.137 ms); a chunk's in 1.213 ms with uniform routing and
// 1.342 ms when two experts hold about 170 rows (cuBLAS: 1.126, 1.133).  A
// wide expert's rows are read again from L2 for every 64-column tile, more
// bytes than its weights: a chunk would want wider tiles there.
// Tensor maps (built here from the pointers and sizes) reach the kernel as
// __grid_constant__ parameters, so launches can be captured in a CUDA graph.
//
// float32 takes grouped_fma_kernel, register-tiled FMA over the same ranges
// (the tiny configs; no tensor cores).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Weight columns a tile of gate/up (down: two), reduction depth a stage,
// rows a wgmma (n64), rows a pass and rows a TMA box of the row operand
// (ops/moe_experts.py ME_TILE_M, ME_TILE_K, ME_BLOCK_ROWS, ME_PASS_ROWS,
// ME_BOX_ROWS).
constexpr int kTileM = 64;
constexpr int kTileK = 64;
constexpr int kBlockRows = 64;
constexpr int kConsumers = 4;  // warpgroups
constexpr int kPassRows = 4 * kBlockRows;
constexpr int kBoxRows = 8;
constexpr int kBoxBytes = kBoxRows * kTileK * 2;
constexpr int kThreads = 128 * kConsumers + 32;  // + the producer warp

// Bytes of a 64 x 64 weight tile (two a stage), and the most stages of the
// ring (ops/moe_experts.py ME_MAX_STAGES).
constexpr int kWBytes = kTileK * kTileM * 2;
constexpr int kMaxStages = 16;

// One CTA an SM: the ring (ops/moe_experts.py ME_RING_BYTES), then gate/up's
// exchange (gate's and up's products, bf16, a pass's rows by the tile's 64
// columns each), then the barriers.  A product reads its block's 64 rows
// whole, up to 120 rows past the end of a pass's row slot (the pass's rows
// rounded up to 8): those reads land in the exchange, inside shared memory.
constexpr int kRingBytes = 163840;
constexpr int kExchBytes = 2 * kPassRows * kTileM * 2;
// Dynamic shared memory, with 1024 bytes to align the ring.
constexpr size_t kSmemBytes = kRingBytes + kExchBytes + 16 * kMaxStages + 1024;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// silu(gate) * up with the plain version's bf16 roundings: the products,
// silu's result and the final product each rounded once.
__device__ __forceinline__ float swiglu_bf16(float gate, float up) {
  const float g = round_bf16(gate);
  return round_bf16(g / (1.f + expf(-g))) * round_bf16(up);
}

// Waits for the 256 threads of consumer warpgroups 2 pair and 2 pair + 1
// (named barrier 1 + pair; 0 is __syncthreads').
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + pair) : "memory");
}

// Weight columns a tile: gate/up's 64 (gate's and up's tiles in a stage),
// down's 128 (two 64-column tiles in a stage).
template <int kMats>
constexpr int kCols = kMats == 2 ? kTileM : 2 * kTileM;

// The ring of one call: every expert's widest pass, rounded up to whole
// boxes, sets the row slot of a stage; as many stages as the ring holds.
struct Ring {
  int stage_bytes, stages;
};

__device__ __forceinline__ Ring ring_of(const long long* ends, int E) {
  long long prev = 0, widest = 0;
  for (int e = 0; e < E; ++e) {
    widest = max(widest, min(ends[e] - prev, (long long)kPassRows));
    prev = ends[e];
  }
  const int slot = static_cast<int>(
      (widest + kBoxRows - 1) / kBoxRows * kBoxBytes);
  const int stage_bytes = 2 * kWBytes + slot;
  return {stage_bytes, min(kMaxStages, kRingBytes / stage_bytes)};
}

// One pass of consumer warpgroup wg = 2 pair + half: it multiplies the
// stage's weight tile `half` (gate/up: gate or up; down: the tile's first or
// second 64 columns) by blocks pair and pair + 2 of the pass's rows
// (kBlocks of them: the caller picks 1 up to 128 rows, else 2), so that a
// block's gate and up products run in two warpgroups side by side.  No
// product, and no read of the accumulators, sits under a branch: ptxas
// then serializes every wgmma of the kernel (C7520, C7518; measured,
// gate/up at 73% of the bound instead of about 90% in a decode step).  So
// a pair with no rows in the pass returns early, and a second block may
// lie partly or wholly past the rows: those columns are computed and never
// stored.  This thread holds output rows (weight columns) mr and mr + 8 of
// the tile and columns (pass rows) 8 j + nc, + 1 of each block (the wgmma
// accumulator layout).  The products of one stage stay in flight while the
// next stage's are issued; a stage is released once its products are
// done.
template <int kMats, int kBlocks>
__device__ __forceinline__ void consume_pass(
    uint8_t* smem, const Ring& ring, uint64_t* full, uint64_t* empty,
    __nv_bfloat16* exch, int wg, int lane, long long r0, int rows, int m0,
    int M, int n_k, const long long* __restrict__ order,
    __nv_bfloat16* __restrict__ out, int& it) {
  const int half = wg % 2;
  const int pair = wg / 2;
  if (pair * kBlockRows >= rows) {
    // Nothing of this pair's blocks lies in the pass: release each stage.
    // An early return, so that the products below sit under no branch.
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      hop::mbar_wait(&full[it % ring.stages], (it / ring.stages) & 1);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[it % ring.stages]);
    }
    if constexpr (kMats == 2) {
      pair_sync(pair);
      pair_sync(pair);
    }
    return;
  }
  const int mr = 16 * (threadIdx.x / 32 % 4) + lane / 4;
  const int nc = 2 * (lane % 4);
  float acc[kBlocks][32];
#pragma unroll
  for (int bb = 0; bb < kBlocks; ++bb)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[bb][r] = 0.f;

  int held = -1;
  for (int kt = 0; kt < n_k; ++kt, ++it) {
    const int s = it % ring.stages;
    hop::mbar_wait(&full[s], (it / ring.stages) & 1);
    const uint32_t st = hop::smem_addr(smem + s * ring.stage_bytes);
    const uint32_t xr = st + 2 * kWBytes;
#pragma unroll
    for (int bb = 0; bb < kBlocks; ++bb) hop::fence_regs(acc[bb]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk)
#pragma unroll
      for (int bb = 0; bb < kBlocks; ++bb)
        hop::wgmma_ss_n64_ta(
            acc[bb], hop::desc_mnmajor(st + half * kWBytes, kTileK, kk),
            hop::desc_kmajor(xr, kPassRows, kBlockRows * (pair + 2 * bb), kk),
            1);
    hop::wgmma_commit();
    hop::wgmma_wait<1>();
#pragma unroll
    for (int bb = 0; bb < kBlocks; ++bb) hop::fence_regs(acc[bb]);
    __syncwarp();
    if (lane == 0 && held >= 0) hop::mbar_arrive(&empty[held]);
    held = s;
  }
  hop::wgmma_wait<0>();
#pragma unroll
  for (int bb = 0; bb < kBlocks; ++bb) hop::fence_regs(acc[bb]);
  __syncwarp();
  if (lane == 0) hop::mbar_arrive(&empty[held]);

  // down stores its columns straight to the pairs' places.  gate/up: both
  // warpgroups of a pair round their products into the exchange (gate's,
  // then up's), and after the pair's barrier each stores half of the rows'
  // h; a second barrier keeps the next pass from overwriting the exchange
  // before it is read.
#pragma unroll
  for (int bb = 0; bb < kBlocks; ++bb)
#pragma unroll
    for (int j = 0; j < kBlockRows / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = kBlockRows * (pair + 2 * bb) + 8 * j + nc + c;
        if (kMats == 1 && n >= rows) continue;
        long long dst = r0 + n;
        if constexpr (kMats == 1) dst = order[dst];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int col = mr + 8 * hi;
          const float v = acc[bb][4 * j + 2 * hi + c];
          if constexpr (kMats == 2) {
            exch[(half * kPassRows + n) * kTileM + col] =
                __float2bfloat16_rn(v);
          } else {
            const int m = m0 + kTileM * half + col;
            if (m < M) out[dst * M + m] = __float2bfloat16_rn(v);
          }
        }
      }
  if constexpr (kMats == 2) {
    pair_sync(pair);
    // The pair's blocks split between its two warpgroups: each thread
    // stores 8 columns (one 16-byte vector) of a row at a time.
    const int t = threadIdx.x % 256;
    for (int bb = 0; bb < kBlocks; ++bb) {
      const int b = pair + 2 * bb;
      for (int v = t; v < kBlockRows * kTileM / 8; v += 256) {
        const int n = kBlockRows * b + v / (kTileM / 8);
        const int col = 8 * (v % (kTileM / 8));
        if (n >= rows) continue;
        __align__(16) __nv_bfloat16 h[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          h[q] = __float2bfloat16_rn(swiglu_bf16(
              __bfloat162float(exch[n * kTileM + col + q]),
              __bfloat162float(exch[(kPassRows + n) * kTileM + col + q])));
        const int m = m0 + col;
        __nv_bfloat16* dst = out + (r0 + n) * M + m;
        if (m + 8 <= M) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(h);
        } else {
          for (int q = 0; q < 8 && m + q < M; ++q) dst[q] = h[q];
        }
      }
    }
    pair_sync(pair);
  }
}

// Persistent: one CTA an SM walks the tiles (kCols<kMats> weight columns of
// one expert) tile = blockIdx.x + j * gridDim.x, columns fastest.  The
// producer warp and the consumers walk the same tiles, passes and reduction
// steps, counting steps `it` across tiles, so the producer loads the next
// tile while the consumers finish this one.
template <int kMats>
__global__ void __launch_bounds__(kThreads, 1)
    grouped_wgmma_kernel(const __grid_constant__ CUtensorMap map_w0,
                         const __grid_constant__ CUtensorMap map_w1,
                         const __grid_constant__ CUtensorMap map_rows,
                         const long long* __restrict__ ends,
                         const long long* __restrict__ order,
                         __nv_bfloat16* __restrict__ out, int M, int K,
                         int E) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* exch = reinterpret_cast<__nv_bfloat16*>(smem + kRingBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kRingBytes + kExchBytes);
  uint64_t* empty = full + kMaxStages;
  const Ring ring = ring_of(ends, E);
  const int tiles_m = (M + kCols<kMats> - 1) / kCols<kMats>;
  const int n_tiles = tiles_m * E;
  const int n_k = (K + kTileK - 1) / kTileK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 4 * kConsumers);  // one arrival a warp
    }
    hop::mbar_fence_init();
  }
  __syncthreads();  // barriers initialised before anyone waits on them

  if (warp == 4 * kConsumers) {
    // Producer: lane 0 waits for a free stage and loads the two weight
    // tiles (gate's and up's 64 columns, or down's two halves of 128);
    // then the lanes load the pass's row boxes, one box a lane.  An expert
    // no pair chose is skipped before a single byte of it is read.
    int it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int e = tile / tiles_m;
      const int m0 = (tile % tiles_m) * kCols<kMats>;
      const long long start = e > 0 ? ends[e - 1] : 0;
      const long long end = ends[e];
      for (long long r0 = start; r0 < end; r0 += kPassRows) {
        const int rows = static_cast<int>(min(end - r0, (long long)kPassRows));
        const int boxes = (rows + kBoxRows - 1) / kBoxRows;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % ring.stages;
          uint8_t* stage = smem + s * ring.stage_bytes;
          if (lane == 0) {
            hop::mbar_wait(&empty[s], ((it / ring.stages) & 1) ^ 1);
            hop::mbar_arrive_expect_tx(&full[s],
                                       2 * kWBytes + boxes * kBoxBytes);
            hop::tma_load_4d(stage, &map_w0, &full[s], m0, kt * kTileK, e,
                             0);
            hop::tma_load_4d(stage + kWBytes, kMats == 2 ? &map_w1 : &map_w0,
                             &full[s], kMats == 2 ? m0 : m0 + kTileM,
                             kt * kTileK, e, 0);
          }
          __syncwarp();
          for (int b = lane; b < boxes; b += 32)
            hop::tma_load_4d(stage + 2 * kWBytes + b * kBoxBytes, &map_rows,
                             &full[s], kt * kTileK,
                             static_cast<int>(r0) + b * kBoxRows, 0, 0);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int e = tile / tiles_m;
    const int m0 = (tile % tiles_m) * kCols<kMats>;
    const long long start = e > 0 ? ends[e - 1] : 0;
    const long long end = ends[e];
    for (long long r0 = start; r0 < end; r0 += kPassRows) {
      const int rows = static_cast<int>(min(end - r0, (long long)kPassRows));
      if (rows > 2 * kBlockRows)
        consume_pass<kMats, 2>(smem, ring, full, empty, exch, wg, lane, r0,
                               rows, m0, M, n_k, order, out, it);
      else
        consume_pass<kMats, 1>(smem, ring, full, empty, exch, wg, lane, r0,
                               rows, m0, M, n_k, order, out, it);
    }
  }
}

// float32: one CTA per (64 weight columns, expert) walks its range 32 rows
// at a time; a thread holds one column of 8 rows (x kMats accumulators),
// operands staged through shared memory 16 reduction steps at a time.
constexpr int kFmaCols = 64;
constexpr int kFmaRows = 32;
constexpr int kFmaK = 16;
constexpr int kFmaThreads = 256;

template <int kMats>
__global__ void __launch_bounds__(kFmaThreads)
    grouped_fma_kernel(const float* __restrict__ rows,
                       const float* __restrict__ w0,
                       const float* __restrict__ w1,
                       const long long* __restrict__ ends,
                       const long long* __restrict__ order,
                       float* __restrict__ out, int M, int K) {
  const int e = blockIdx.y;
  const long long start = e > 0 ? ends[e - 1] : 0;
  const long long end = ends[e];
  if (start >= end) return;
  __shared__ float xs[kFmaRows][kFmaK + 1];
  __shared__ float ws[kMats][kFmaK][kFmaCols];
  const int t = threadIdx.x;
  const int col = t % kFmaCols;
  const int rg = 8 * (t / kFmaCols);
  const int m0 = blockIdx.x * kFmaCols;
  const long long wbase = static_cast<long long>(e) * K * M;
  for (long long r0 = start; r0 < end; r0 += kFmaRows) {
    float acc[kMats][8];
#pragma unroll
    for (int a = 0; a < kMats; ++a)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[a][r] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kFmaK) {
      for (int idx = t; idx < kFmaRows * kFmaK; idx += kFmaThreads) {
        const int r = idx / kFmaK, kk = idx % kFmaK;
        const long long row = r0 + r;
        xs[r][kk] = (row < end && k0 + kk < K) ? rows[row * K + k0 + kk] : 0.f;
      }
      for (int idx = t; idx < kFmaK * kFmaCols; idx += kFmaThreads) {
        const int kk = idx / kFmaCols, cc = idx % kFmaCols;
        const bool ok = k0 + kk < K && m0 + cc < M;
        const long long at = wbase + static_cast<long long>(k0 + kk) * M +
                             m0 + cc;
        ws[0][kk][cc] = ok ? w0[at] : 0.f;
        if constexpr (kMats == 2) ws[kMats - 1][kk][cc] = ok ? w1[at] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFmaK; ++kk)
#pragma unroll
        for (int a = 0; a < kMats; ++a) {
          const float wv = ws[a][kk][col];
#pragma unroll
          for (int r = 0; r < 8; ++r)
            acc[a][r] = fmaf(xs[rg + r][kk], wv, acc[a][r]);
        }
      __syncthreads();
    }
    if (m0 + col >= M) continue;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long row = r0 + rg + r;
      if (row >= end) continue;
      float v = acc[0][r];
      if constexpr (kMats == 2) v = v / (1.f + expf(-v)) * acc[kMats - 1][r];
      long long dst = row;
      if constexpr (kMats == 1) dst = order[dst];
      out[dst * M + m0 + col] = v;
    }
  }
}

// Tensor map of a bf16 [E, K, M] weight (dims M, K, E), boxes of 64 x 64.
int weight_map(CUtensorMap* map, const void* w, int E, int K, int M) {
  const long long g[7] = {M, K, E, 1, 2ll * M, 2ll * K * M, 2ll * E * K * M};
  return hop::make_map(map, w, g, kTileK);
}

// Tensor map of the bf16 [P, K] row operand (dims K, P), boxes of 64 x 8.
int rows_map(CUtensorMap* map, const void* rows, int P, int K) {
  const long long g[7] = {K, P, 1, 1, 2ll * K, 2ll * P * K, 2ll * P * K};
  return hop::make_map(map, rows, g, kBoxRows);
}

// out = the grouped products of `rows` [P, K] against w0 (and w1) [E, K, M].
template <int kMats>
int launch(const void* rows, const void* w0, const void* w1,
           const long long* ends, const long long* order, void* out, int P,
           int K, int M, int E, int dtype, cudaStream_t stream) {
  if (P <= 0 || M <= 0 || E <= 0) return 0;
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == tj::kF32) {
    const dim3 grid((M + kFmaCols - 1) / kFmaCols, E);
    grouped_fma_kernel<kMats><<<grid, kFmaThreads, 0, stream>>>(
        static_cast<const float*>(rows), static_cast<const float*>(w0),
        static_cast<const float*>(w1), ends, order, static_cast<float*>(out),
        M, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != tj::kBF16 || K % 8 != 0 || M % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (const int err = tj::opt_in_smem(grouped_wgmma_kernel<kMats>,
                                       kSmemBytes, &configured))
    return err;
  int device = 0, sms = 0;
  if (const cudaError_t err = cudaGetDevice(&device))
    return static_cast<int>(err);
  if (const cudaError_t err = cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, device))
    return static_cast<int>(err);
  CUtensorMap m0, m1, mr;
  if (const int err = weight_map(&m0, w0, E, K, M)) return err;
  if (const int err = weight_map(&m1, kMats == 2 ? w1 : w0, E, K, M))
    return err;
  if (const int err = rows_map(&mr, rows, P, K)) return err;
  const int tiles = (M + kCols<kMats> - 1) / kCols<kMats> * E;
  grouped_wgmma_kernel<kMats><<<min(tiles, sms), kThreads, kSmemBytes,
                                 stream>>>(
      m0, m1, mr, ends, order, static_cast<__nv_bfloat16*>(out), M, K, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs [P, D] (pairs in expert order), w_gate and w_up [E, D, F], ends [E]
// int64 on the device; writes h [P, F].  All contiguous, one dtype
// (float32, or bfloat16 with D and F multiples of 8).
extern "C" int tj_moe_gate_up(const void* xs, const void* w_gate,
                              const void* w_up, const void* ends, void* h,
                              int P, int D, int F, int E, int dtype,
                              void* stream) {
  return launch<2>(
      xs, w_gate, w_up, static_cast<const long long*>(ends), nullptr, h, P,
      D, F, E, dtype, static_cast<cudaStream_t>(stream));
}

// h [P, F] (pairs in expert order), w_down [E, F, D], ends and order [P]
// int64 on the device; writes y [P, D], row order[i] from h's row i.
extern "C" int tj_moe_down(const void* h, const void* w_down,
                           const void* ends, const void* order, void* y,
                           int P, int F, int D, int E, int dtype,
                           void* stream) {
  return launch<1>(
      h, w_down, nullptr, static_cast<const long long*>(ends),
      static_cast<const long long*>(order), y, P, F, D, E, dtype,
      static_cast<cudaStream_t>(stream));
}
