// Flash-attention dQ on Hopper's tensor cores (sm_90a), bf16 at head dims 64
// and 128: the FlashAttention-2 scheme with probabilities recomputed from the
// saved LSE, one query tile per CTA.
//
// Replaces, for those inputs, the TPU kernel
// trainingjob_operator_tpu/ops/flash_attention.py _bwd_dq_kernel (launched
// by _flash_backward); flash_bwd.cu's tj_flash_bwd_dq keeps f32 and bf16 at
// head dims 16 and 32.  Same math:
//   z  = (q . k) * scale
//   p  = exp(z - lse) where the mask lets (row, col) through, else exactly 0
//   dp = dO . v
//   dz = p * (dp - delta) * scale   (delta = rowsum(dO * O), computed outside)
//   dq = sum over keys of dz * k
// lse and delta arrive as contiguous [B, Hq, T] f32; dq leaves in bf16
// (nearest even), [B, T, Hq, D] by stride with d-stride 1.
//
// Rounding points: the score products are exact products summed in f32 by
// the tensor cores.  dz is formed from the f32 p and dp and rounded to bf16
// before dz . k (a tensor-core operand; flash_bwd_dkv_wgmma.cu rounds it at
// the same point before dz^T . q).  That adds about 1.7e-3 relative (RMS) to
// dq before its final cast; chip_smoke.py's BWD_TOL["bfloat16_wgmma"] states
// the limit that follows.
//
// Bound: 6 D flops per visible (query, key) pair (z, dp, dq) against 2 bytes
// per element of q, k, v, dO and dq, so at the training shape (B1 T4096 H32
// D128 causal) the bf16 tensor-core rate bounds it (0.2085 ms on an H100
// SXM).  What the design does about it:
// - all three products are wgmma (m64nNk16, bf16 in, f32 out): z = Q . K^T
//   and dp = dO . V^T with both operands in shared memory (K-major), then
//   dQ += dz . K with dz from registers (the accumulator layout of z is the
//   register-A layout) and K MN-major through the descriptor's transpose
//   bit, so no transpose copy;
// - one CTA of one warpgroup per (64-row query tile, b, h), two CTAs an SM:
//   each thread keeps its rows of dQ in registers (64 f32 at D = 128) beside
//   the step's z and dp and dz's bf16 copy, within the 255 registers a
//   thread of a one-warpgroup CTA may have (a CTA of several warpgroups gets
//   at most 168).  KV head h / (H / Hkv): grouped KV is never repeated;
// - Q and dO are loaded once by TMA, and each thread keeps the lse and
//   delta of its two rows in registers.  K and V tiles stream through a
//   ring of kStages stages, each guarded by an mbarrier: thread 0 refills a
//   stage by TMA as soon as the warpgroup is done with it;
// - the KV loop runs from the window's first tile to the causal diagonal
//   (the TPU kernel's bounds); masks only on diagonal, window-edge and
//   ragged (T % 64) tiles;
// - query tiles are issued heaviest first (the last tile of every head
//   first), so the causal tail does not run alone at the end;
// - each CTA writes its dQ rows once, with no atomics: a deterministic
//   result.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Query rows per CTA and keys per K/V tile (ops/flash_attention.py
// TC_DQ_TILE).
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kStages = 2;
constexpr int kThreads = 128;  // one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

using tj::Strides;

template <int D>
struct Layout {
  static constexpr int kQBytes = kBM * D * 2;   // Q or dO
  static constexpr int kKVBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kG = kQ + kQBytes;
  static constexpr int kK = kG + kQBytes;               // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;    // + stage * kKVBytes
  static constexpr int kBar = kV + kStages * kKVBytes;  // qg_full, then per
                                                        // stage kv_full
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

// Thread 0 loads the K and V tiles of KV tile kt into stage i % kStages,
// where i counts the CTA's tiles from 0.
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* smem, uint64_t* kv_full,
                                        const CUtensorMap* map_k,
                                        const CUtensorMap* map_v, int i,
                                        int kt, int hk, int b) {
  using L = Layout<D>;
  const int s = i % kStages;
  hop::mbar_arrive_expect_tx(&kv_full[s], 2 * L::kKVBytes);
  hop::load_tile<D>(smem + L::kK + s * L::kKVBytes, map_k, &kv_full[s], kBN,
                    kt * kBN, hk, b);
  hop::load_tile<D>(smem + L::kV + s * L::kKVBytes, map_v, &kv_full[s], kBN,
                    kt * kBN, hk, b);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_g, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
    int Hkv, int T_len, Strides sdq, float scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qg_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* kv_full = qg_full + 1;

  const int n_qt = (T_len + kBM - 1) / kBM;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);  // heaviest first
  const int q0 = qt * kBM;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int n_kv = (T_len + kBN - 1) / kBN;
  const int kv_end = causal ? min((q0 + kBM + kBN - 1) / kBN, n_kv) : n_kv;
  const int kv_start = (causal && window) ? max(q0 - window + 1, 0) / kBN : 0;
  const int n = kv_end - kv_start;

  if (threadIdx.x == 0) {
    hop::mbar_init(qg_full, 1);
    for (int s = 0; s < kStages; ++s) hop::mbar_init(&kv_full[s], 1);
    hop::mbar_fence_init();
    hop::mbar_arrive_expect_tx(qg_full, 2 * L::kQBytes);
    hop::load_tile<D>(smem + L::kQ, &map_q, qg_full, kBM, q0, h, b);
    hop::load_tile<D>(smem + L::kG, &map_g, qg_full, kBM, q0, h, b);
    for (int i = 0; i < kStages && i < n; ++i)
      load_kv<D>(smem, kv_full, &map_k, &map_v, i, kv_start + i, hk, b);
  }
  __syncthreads();  // barriers initialised before anyone waits on them

  // This thread: query rows r and r + 8 of the tile, key columns 8 j + cq,
  // + 1 of each step's z tile (the wgmma accumulator layout).
  const int t = threadIdx.x;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int rows[2] = {q0 + r, q0 + r + 8};
  const float scale_log2 = scale * kLog2e;
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const long long at =
        (static_cast<long long>(b) * H + h) * T_len + rows[ri];
    const bool in = rows[ri] < T_len;
    lse_log2[ri] = in ? lse[at] * kLog2e : 0.f;
    row_delta[ri] = in ? delta[at] : 0.f;
  }
  const uint32_t sq = hop::smem_addr(smem + L::kQ);
  const uint32_t sg = hop::smem_addr(smem + L::kG);
  const uint32_t sk = hop::smem_addr(smem + L::kK);
  const uint32_t sv = hop::smem_addr(smem + L::kV);

  float dq_acc[D / 2];
  float z[kBN / 2], dp[kBN / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq_acc[j] = 0.f;

  hop::mbar_wait(qg_full, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int k0 = (kv_start + i) * kBN;
    const uint32_t sk_s = sk + s * L::kKVBytes;
    const uint32_t sv_s = sv + s * L::kKVBytes;

    // z = Q K^T and dp = dO V^T (the zeros end the previous step's values,
    // which the first k-step overwrites anyway, so they are not kept live
    // across the loop).
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) z[j] = dp[j] = 0.f;
    hop::mbar_wait(&kv_full[s], (i / kStages) & 1);
    hop::fence_regs(z);
    hop::fence_regs(dp);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hop::wgmma_ss_n64(z, hop::desc_kmajor(sq, kBM, 0, k),
                        hop::desc_kmajor(sk_s, kBN, 0, k), k > 0);
    hop::wgmma_commit();
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
      hop::wgmma_ss_n64(dp, hop::desc_kmajor(sg, kBM, 0, k),
                        hop::desc_kmajor(sv_s, kBN, 0, k), k > 0);
    hop::wgmma_commit();

    // p = exp(z - lse), masked, once z has landed.  Rows past T_len are
    // never stored, so only the key columns need the ragged guard.
    const bool masked =
        k0 + kBN > T_len ||
        (causal && (k0 + kBN - 1 > q0 ||
                    (window && k0 <= q0 + kBM - 1 - window)));
    hop::wgmma_wait<1>();
    hop::fence_regs(z);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = exp2f(fmaf(z[4 * j + c], scale_log2, -lse_log2[c / 2]));
        if (masked) {
          const int col = k0 + 8 * j + cq + (c % 2);
          const int row = rows[c / 2];
          bool ok = col < T_len;
          if (causal) {
            ok = ok && col <= row;
            if (window) ok = ok && col > row - window;
          }
          p = ok ? p : 0.f;
        }
        z[4 * j + c] = p;
      }

    // dz = p (dp - delta) scale, once dp has landed.
    hop::wgmma_wait<0>();
    hop::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dp[4 * j + c] = z[4 * j + c] * (dp[4 * j + c] - row_delta[c / 2]) *
                        scale;

    // dQ += dz K, dz rounded to bf16.
    uint32_t da[kBN / 16][4];
#pragma unroll
    for (int k = 0; k < kBN / 16; ++k) hop::acc_to_a(dp, k, da[k]);
    hop::fence_regs(dq_acc);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBN / 16; ++k)
      mma_rs<D>(dq_acc, da[k], hop::desc_mnmajor(sk_s, kBN, k));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(dq_acc);

    // Stage s is free once every warp is past this step: refill it for step
    // i + kStages.
    __syncthreads();
    if (t == 0 && i + kStages < n)
      load_kv<D>(smem, kv_full, &map_k, &map_v, i + kStages,
                 kv_start + i + kStages, hk, b);
  }

  // Epilogue: dQ rows in bf16.
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = rows[ri];
    if (row >= T_len) continue;
    __nv_bfloat16* dqrow = dq + b * sdq.b + row * sdq.t + h * sdq.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqrow + 8 * j + cq) =
          __floats2bfloat162_rn(dq_acc[4 * j + 2 * ri],
                                dq_acc[4 * j + 2 * ri + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* g,
           const float* lse, const float* delta, void* dq, int B, int T_len,
           int H, int Hkv, int causal, int window, float scale,
           const long long* gq, const long long* gk, const long long* gv,
           const long long* gg, Strides sdq, cudaStream_t stream) {
  static bool configured = false;
  if (const int err = tj::opt_in_smem(flash_bwd_dq_wgmma_kernel<D>,
                                       Layout<D>::kAlloc, &configured))
    return err;
  CUtensorMap mq, mk, mv, mg;
  if (const int err = hop::make_map(&mq, q, gq, kBM)) return err;
  if (const int err = hop::make_map(&mk, k, gk, kBN)) return err;
  if (const int err = hop::make_map(&mv, v, gv, kBN)) return err;
  if (const int err = hop::make_map(&mg, g, gg, kBM)) return err;
  const dim3 grid(B * H, (T_len + kBM - 1) / kBM);
  flash_bwd_dq_wgmma_kernel<D><<<grid, kThreads, Layout<D>::kAlloc, stream>>>(
      mq, mk, mv, mg, lse, delta, static_cast<__nv_bfloat16*>(dq), H, Hkv,
      T_len, sdq, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q and dout: [B, T, Hq, D], k and v: [B, T, Hkv, D], each as its
// tensor-map geometry (dims d, t, h, b, then the byte strides of t, h and b);
// lse and delta: contiguous [B, Hq, T] f32; dq: [B, T, Hq, D] by its
// (b, t, h, d) element strides, d-stride 1.  D is 64 or 128.
extern "C" int tj_flash_bwd_dq_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int T_len, int H,
    int Hkv, int D, int causal, int window, float scale, const long long* gq,
    const long long* gk, const long long* gv, const long long* gg,
    long long dqb, long long dqt, long long dqh, long long dqd, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || dqd != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sdq{dqb, dqt, dqh, dqd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (D == 128)
    return launch<128>(q, k, v, dout, l, dl, dq, B, T_len, H, Hkv, causal,
                       window, scale, gq, gk, gv, gg, sdq, s);
  if (D == 64)
    return launch<64>(q, k, v, dout, l, dl, dq, B, T_len, H, Hkv, causal,
                      window, scale, gq, gk, gv, gg, sdq, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
