// Flash-attention dK/dV on Hopper's tensor cores (sm_90a), bf16 at head dims
// 64 and 128: the FlashAttention-2 scheme with probabilities recomputed from
// the saved LSE, the GQA group summed in registers.
//
// Replaces, for those inputs, the TPU kernel
// trainingjob_operator_tpu/ops/flash_attention.py _bwd_dkv_kernel (launched
// by _flash_backward); flash_bwd.cu's tj_flash_bwd_dkv keeps f32 and bf16 at
// head dims 16 and 32 (dQ: flash_bwd_dq_wgmma.cu).  Same math:
//   z  = (q . k) * scale
//   p  = exp(z - lse) where the mask lets (row, col) through, else exactly 0
//   dp = dO . v
//   dz = p * (dp - delta) * scale   (delta = rowsum(dO * O), computed outside)
//   dk = sum over the GQA group's query heads and rows of dz * q
//   dv = likewise of p * dO
// lse and delta arrive as contiguous [B, Hq, T] f32; dk and dv leave in bf16
// (nearest even), [B, T, Hkv, D] by stride with d-stride 1.
//
// Rounding points: the score products are exact products summed in f32 by
// the tensor cores.  p and dz are rounded to bf16 before p^T . dO and
// dz^T . q (tensor-core operands; FlashAttention-2/3 and SDPA's flash
// backward do the same); dz is formed from the f32 p.  That adds about
// 1.7e-3 relative (RMS) to dk and dv before their final cast;
// chip_smoke.py's BWD_TOL["bfloat16_wgmma"] states the limit that follows.
//
// Bound: 8 D flops per visible (query, key) pair (z, dp, dk, dv) against 2
// bytes per element of q, k, v, dO, dk and dv, so at the training shape (B1
// T4096 H32 D128 causal) the bf16 tensor-core rate bounds it (0.278 ms on an
// H100 SXM).  What the design does about it:
// - all four products are wgmma (m64nNk16, bf16 in, f32 out): z^T = K . Q^T
//   and dp^T = V . dO^T with both operands in shared memory (K-major), then
//   dV += p^T . dO and dK += dz^T . Q with p^T and dz^T from registers (the
//   accumulator layout is the register-A layout) and dO and Q MN-major
//   through the descriptor's transpose bit, so no transpose copy;
// - one CTA of one warpgroup per (64-row KV tile, b, KV head), two CTAs an
//   SM: each thread keeps its rows of dK and dV in registers (2 x 64 f32 at
//   D = 128) beside the step's z^T, dp^T and their bf16 copies, which takes
//   up to 255 registers.  A CTA of several warpgroups gets at most 168 a
//   thread, and the compiler did not hand the producer's registers over
//   (setmaxnreg): the accumulators spilled.  K and V are loaded once by TMA;
//   the Q and dO tiles of the group's heads stream through a ring of
//   kStages stages, each guarded by an mbarrier: thread 0 refills a stage
//   by TMA as soon as the warpgroup is done with it, and the warpgroup
//   stages that step's lse and delta in shared memory;
// - the query-tile loop runs from the causal diagonal to the window bound
//   (the TPU kernel's bounds) and, inside it, over the GQA group's heads, so
//   the group is summed in registers: no atomics, a deterministic result;
// - masks only on diagonal, window-edge and ragged (T % kBM) tiles;
// - KV tile 0 carries the most query tiles under a causal mask, and tiles
//   are issued in ascending order in the grid's slowest dimension: the
//   heaviest start first.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// KV rows per CTA and query rows per step (ops/flash_attention.py
// TC_DKV_TILE); 32 query rows a step were slower at the training shape.
constexpr int kBN = 64;
constexpr int kBM = 64;
constexpr int kStages = 2;
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

using tj::Strides;

template <int D>
struct Layout {
  static constexpr int kKVBytes = kBN * D * 2;  // K or V
  static constexpr int kQBytes = kBM * D * 2;    // one Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;              // + stage * kQBytes
  static constexpr int kG = kQ + kStages * kQBytes;     // dO, likewise
  static constexpr int kStat = kG + kStages * kQBytes;  // lse, delta: per
                                                        // stage 2 kBM f32
  static constexpr int kBar = kStat + kStages * 2 * kBM * 4;  // kv_full, then
                                                             // per stage full
  static constexpr int kBytes = kBar + 8 * (1 + kStages);
  static constexpr size_t kAlloc = kBytes + 1024;  // 1024-byte alignment
};

template <int D>
__device__ __forceinline__ void mma_rs(float (&acc)[D / 2],
                                       const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 128)
    hop::wgmma_rs_n128(acc, a, desc);
  else
    hop::wgmma_rs_n64(acc, a, desc);
}

// Step i of a CTA: query tile qt_start + i / group of head hk * group +
// i % group.  Loads its Q and dO tiles into stage i % kStages (thread 0, by
// TMA) and stages its lse and delta (threads < kBM).
template <int D>
__device__ __forceinline__ void fill_stage(
    uint8_t* smem, const CUtensorMap* map_q, const CUtensorMap* map_g,
    const float* __restrict__ lse, const float* __restrict__ delta, int H,
    int T_len, int b, int hk, int group, int qt_start, int i) {
  using L = Layout<D>;
  const int s = i % kStages;
  const int q0 = (qt_start + i / group) * kBM;
  const int h = hk * group + i % group;
  if (threadIdx.x == 0) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBar) + 1;
    hop::mbar_arrive_expect_tx(&full[s], 2 * L::kQBytes);
    hop::load_tile<D>(smem + L::kQ + s * L::kQBytes, map_q, &full[s], kBM,
                      q0, h, b);
    hop::load_tile<D>(smem + L::kG + s * L::kQBytes, map_g, &full[s], kBM,
                      q0, h, b);
  }
  const int j = threadIdx.x;
  if (j < kBM) {
    float* st = reinterpret_cast<float*>(smem + L::kStat) + s * 2 * kBM;
    const int t = q0 + j;
    const long long at = (static_cast<long long>(b) * H + h) * T_len + t;
    st[threadIdx.x] = t < T_len ? lse[at] : 0.f;
    st[kBM + threadIdx.x] = t < T_len ? delta[at] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Hkv, int T_len, Strides sdk,
    Strides sdv, float scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const float* stat = reinterpret_cast<const float*>(smem + L::kStat);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = kv_full + 1;

  const int k0 = blockIdx.y * kBN;  // ascending: the heaviest tiles first
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  // Query tiles wholly above the diagonal, or wholly past the window's reach
  // (the last row this KV tile serves is its last col + window - 1),
  // contribute nothing.
  int qt_end = (T_len + kBM - 1) / kBM;
  const int qt_start = causal ? k0 / kBM : 0;
  if (causal && window)
    qt_end = min(qt_end, (k0 + kBN + window - 2) / kBM + 1);
  const int n_steps = (qt_end - qt_start) * group;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) hop::mbar_init(&full[s], 1);
    hop::mbar_fence_init();
    hop::mbar_arrive_expect_tx(kv_full, 2 * L::kKVBytes);
    hop::load_tile<D>(smem + L::kK, &map_k, kv_full, kBN, k0, hk, b);
    hop::load_tile<D>(smem + L::kV, &map_v, kv_full, kBN, k0, hk, b);
  }
  __syncthreads();  // barriers initialised before anyone waits on them
  for (int i = 0; i < kStages && i < n_steps; ++i)
    fill_stage<D>(smem, &map_q, &map_g, lse, delta, H, T_len, b, hk,
                      group, qt_start, i);
  __syncthreads();  // the first stages' lse and delta are in place

  // This thread: KV rows r and r + 8 of the tile, and query columns
  // 8 j + cq, 8 j + cq + 1 of each step's z^T tile (the wgmma accumulator
  // layout).
  const int t = threadIdx.x;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int kv_rows[2] = {k0 + r, k0 + r + 8};
  const uint32_t sk = hop::smem_addr(smem + L::kK);
  const uint32_t sv = hop::smem_addr(smem + L::kV);
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
  float zt[kBM / 2], dpt[kBM / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  hop::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int q0 = (qt_start + i / group) * kBM;
    const uint32_t sq = hop::smem_addr(smem + L::kQ + s * L::kQBytes);
    const uint32_t sg = hop::smem_addr(smem + L::kG + s * L::kQBytes);
    const float* st_lse = stat + s * 2 * kBM;
    const float* st_delta = st_lse + kBM;

    // z^T = K Q^T and dp^T = V dO^T (the zeros end the previous step's
    // values, which the first step overwrites anyway, so they are not kept
    // live across the loop).
#pragma unroll
    for (int j = 0; j < kBM / 2; ++j) zt[j] = dpt[j] = 0.f;
    hop::mbar_wait(&full[s], phase);
    hop::fence_regs(zt);
    hop::fence_regs(dpt);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hop::wgmma_ss_n64(zt, hop::desc_kmajor(sk, kBN, 0, k),
                        hop::desc_kmajor(sq, kBM, 0, k), k > 0);
    hop::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hop::wgmma_ss_n64(dpt, hop::desc_kmajor(sv, kBN, 0, k),
                        hop::desc_kmajor(sg, kBM, 0, k), k > 0);
    hop::wgmma_commit();

    // p^T = exp(z - lse), masked, once z^T has landed.
    const bool masked =
        q0 + kBM > T_len ||
        (causal && (q0 < k0 + kBN - 1 ||
                    (window && q0 + kBM - 1 >= k0 + window)));
    hop::wgmma_wait<1>();
    hop::fence_regs(zt);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + cq + (c % 2);
        float p = exp2f(fmaf(zt[4 * j + c], scale_log2,
                             -st_lse[col] * kLog2e));
        if (masked) {
          const int qrow = q0 + col;
          const int kv = kv_rows[c / 2];
          bool ok = qrow < T_len;
          if (causal) {
            ok = ok && kv <= qrow;
            if (window) ok = ok && qrow < kv + window;
          }
          p = ok ? p : 0.f;
        }
        zt[4 * j + c] = p;
      }

    // dz^T = p^T (dp^T - delta) scale, once dp^T has landed.
    hop::wgmma_wait<0>();
    hop::fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + cq + (c % 2);
        dpt[4 * j + c] =
            zt[4 * j + c] * (dpt[4 * j + c] - st_delta[col]) * scale;
      }

    // dV += p^T dO and dK += dz^T Q, p^T and dz^T rounded to bf16.
    uint32_t pa[kBM / 16][4], da[kBM / 16][4];
#pragma unroll
    for (int k = 0; k < kBM / 16; ++k) {
      hop::acc_to_a(zt, k, pa[k]);
      hop::acc_to_a(dpt, k, da[k]);
    }
    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBM / 16; ++k)
      mma_rs<D>(dv_acc, pa[k], hop::desc_mnmajor(sg, kBM, k));
#pragma unroll
    for (int k = 0; k < kBM / 16; ++k)
      mma_rs<D>(dk_acc, da[k], hop::desc_mnmajor(sq, kBM, k));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dv_acc);
    hop::fence_regs(dk_acc);

    // Stage s is free once every warp is past this step: refill it for step
    // i + kStages.  The next use of that stage comes after another
    // __syncthreads, which publishes its lse and delta.
    __syncthreads();
    if (i + kStages < n_steps)
      fill_stage<D>(smem, &map_q, &map_g, lse, delta, H, T_len, b, hk,
                        group, qt_start, i + kStages);
  }

  // Epilogue: dK and dV rows in bf16.
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = kv_rows[ri];
    if (row >= T_len) continue;
    __nv_bfloat16* dkrow = dk + b * sdk.b + row * sdk.t + hk * sdk.h;
    __nv_bfloat16* dvrow = dv + b * sdv.b + row * sdv.t + hk * sdv.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * j + cq) =
          __floats2bfloat162_rn(dk_acc[4 * j + 2 * ri],
                                dk_acc[4 * j + 2 * ri + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * j + cq) =
          __floats2bfloat162_rn(dv_acc[4 * j + 2 * ri],
                                dv_acc[4 * j + 2 * ri + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* g,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int T_len, int H, int Hkv, int causal, int window, float scale,
           const long long* gq, const long long* gk, const long long* gv,
           const long long* gg, Strides sdk, Strides sdv,
           cudaStream_t stream) {
  static bool configured = false;
  if (const int err = tj::opt_in_smem(flash_bwd_dkv_wgmma_kernel<D>,
                                       Layout<D>::kAlloc, &configured))
    return err;
  CUtensorMap mq, mk, mv, mg;
  if (const int err = hop::make_map(&mq, q, gq, kBM)) return err;
  if (const int err = hop::make_map(&mk, k, gk, kBN)) return err;
  if (const int err = hop::make_map(&mv, v, gv, kBN)) return err;
  if (const int err = hop::make_map(&mg, g, gg, kBM)) return err;
  const dim3 grid(B * Hkv, (T_len + kBN - 1) / kBN);
  flash_bwd_dkv_wgmma_kernel<D>
      <<<grid, kThreads, Layout<D>::kAlloc, stream>>>(
          mq, mk, mv, mg, lse, delta, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), H, Hkv, T_len, sdk, sdv, scale,
          causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q and dout: [B, T, Hq, D], k and v: [B, T, Hkv, D], each as its
// tensor-map geometry (dims d, t, h, b, then the byte strides of t, h and b);
// lse and delta: contiguous [B, Hq, T] f32; dk and dv: [B, T, Hkv, D] by
// their (b, t, h, d) element strides, d-stride 1.  D is 64 or 128.
extern "C" int tj_flash_bwd_dkv_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int T_len,
    int H, int Hkv, int D, int causal, int window, float scale,
    const long long* gq, const long long* gk, const long long* gv,
    const long long* gg, long long dkb, long long dkt, long long dkh,
    long long dkd, long long dvb, long long dvt, long long dvh, long long dvd,
    void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || dkd != 1 || dvd != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sdk{dkb, dkt, dkh, dkd}, sdv{dvb, dvt, dvh, dvd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
if (D == 128)
    return launch<128>(q, k, v, dout, l, dl, dk, dv, B, T_len, H, Hkv, causal,
                       window, scale, gq, gk, gv, gg, sdk, sdv, s);
  if (D == 64)
    return launch<64>(q, k, v, dout, l, dl, dk, dv, B, T_len, H, Hkv, causal,
                      window, scale, gq, gk, gv, gg, sdk, sdv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
