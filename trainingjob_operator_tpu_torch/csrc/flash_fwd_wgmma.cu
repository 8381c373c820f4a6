// Flash-attention forward on Hopper's tensor cores (sm_90a), bf16 at head
// dims 64 and 128: O and the per-row log-sum-exp, online softmax in f32.
//
// Replaces, for those inputs, the TPU kernel
// trainingjob_operator_tpu/ops/flash_attention.py _kernel (launched by
// _flash_forward); flash_fwd.cu keeps f32 and bf16 at head dims 16 and 32.
// Same math: scores z = (q . k) * scale in f32; masked scores are -1e30 and
// their probabilities exactly 0; the running max m, denominator l and the
// accumulator are f32; O = acc / max(l, 1e-30) rounded once to bf16 (nearest
// even); LSE = m + log(max(l, 1e-30)) in f32, stored [B, H, T].
//
// Rounding points: q . k is exact products summed in f32 by the tensor
// cores.  The probabilities P are rounded to bf16 before P . V (the tensor
// cores take bf16 operands; FlashAttention-2/3 and SDPA's flash backend do
// the same), while l sums the f32 P.  That adds about 1.7e-3 relative (RMS)
// to O before its final cast; chip_smoke.py's FWD_TOL["bfloat16_wgmma"]
// states the limit that follows.
//
// Bound: 4 D flops per visible (query, key) pair against 2 bytes per element
// of q, k, v and O, so at the training and prefill shapes (T >= 2048, D = 128)
// the bf16 tensor-core rate bounds it (0.139 ms at B1 T4096 H32 D128 causal
// on an H100 SXM).  What the design does about it:
// - both products are wgmma (m64nNk16, bf16 in, f32 out): Q . K^T with Q and
//   K from shared memory (K-major), P . V with P from registers (the
//   accumulator layout of Q . K^T is the register-A layout) and V from
//   shared memory MN-major through the descriptor's transpose bit, so no
//   transpose copy;
// - one CTA of one warpgroup per (64-row query tile, b, h), two CTAs an SM
//   (a CTA of several warpgroups gets at most 168 registers a thread).  KV
//   head h / (H / Hkv): grouped KV is never repeated;
// - the warpgroup overlaps its own work: Q . K^T of the next KV tile runs
//   on the tensor cores while it does the softmax of this one, and P . V
//   of this tile while it issues the next;
// - Q is loaded once by TMA; K and V tiles stream through two rings of
//   kStages stages, each stage guarded by an mbarrier.  Thread 0 refills a
//   stage by TMA as soon as the product that read it is done: K two tiles
//   ahead, V one;
// - the KV loop runs from the window's first tile to the causal diagonal
//   (the TPU kernel's bounds); masks only on diagonal, window-edge and
//   ragged (T % 64) tiles;
// - query tiles are issued heaviest first (the last tile of every head
//   first), so the causal tail does not run alone at the end.
// Tensor maps (4-D over d, t, h, b, built by the host from the tensors'
// strides) reach the kernel as __grid_constant__ parameters, so launches can
// be captured in a CUDA graph.  O is stored by stride (d-stride 1).
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Query rows per CTA and keys per K/V tile (ops/flash_attention.py
// TC_FWD_TILE).
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kStages = 2;     // of the K ring and of the V ring
constexpr int kThreads = 128;  // one warpgroup
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using tj::Strides;

template <int D>
struct Layout {
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;               // + stage * kKVBytes
  static constexpr int kV = kK + kStages * kKVBytes;    // + stage * kKVBytes
  static constexpr int kBar = kV + kStages * kKVBytes;  // q_full, then per
                                                        // stage k_full, then
                                                        // per stage v_full
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  // Dynamic shared memory is 16-byte aligned; the tiles need 1024.
  static constexpr size_t kAlloc = kBytes + 1024;
};

// Thread 0 loads the K (or V) tile of KV tile kt into its ring's stage
// i % kStages, where i counts the CTA's tiles from 0.
template <int D>
__device__ __forceinline__ void load_kv(uint8_t* ring, uint64_t* full,
                                        const CUtensorMap* map, int i, int kt,
                                        int hk, int b) {
  const int s = i % kStages;
  hop::mbar_arrive_expect_tx(&full[s], Layout<D>::kKVBytes);
  hop::load_tile<D>(ring + s * Layout<D>::kKVBytes, map, &full[s], kBN,
                    kt * kBN, hk, b);
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&acc)[D / 2],
                                       const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (D == 128)
    hop::wgmma_rs_n128(acc, a, desc);
  else
    hop::wgmma_rs_n64(acc, a, desc);
}

// s = Q K^T for the CTA's 64 query rows and one 64-key tile.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 2], uint32_t sq,
                                         uint32_t sk) {
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) s[j] = 0.f;
  hop::fence_regs(s);
  hop::wgmma_fence();
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    hop::wgmma_ss_n64(s, hop::desc_kmajor(sq, kBM, 0, k),
                      hop::desc_kmajor(sk, kBN, 0, k), k > 0);
  hop::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int H, int Hkv, int T_len,
                           Strides so, float scale, int causal, int window) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;

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
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&k_full[s], 1);
      hop::mbar_init(&v_full[s], 1);
    }
    hop::mbar_fence_init();
    hop::mbar_arrive_expect_tx(q_full, L::kQBytes);
    hop::load_tile<D>(smem + L::kQ, &map_q, q_full, kBM, q0, h, b);
    for (int i = 0; i < kStages && i < n; ++i) {
      load_kv<D>(smem + L::kK, k_full, &map_k, i, kv_start + i, hk, b);
      load_kv<D>(smem + L::kV, v_full, &map_v, i, kv_start + i, hk, b);
    }
  }
  __syncthreads();  // barriers initialised before anyone waits on them

  // This thread: rows r and r + 8 of the tile, columns 8 j + cq, + 1 of
  // each product (the wgmma accumulator layout).
  const int t = threadIdx.x;
  const int r = 16 * (t / 32) + (t % 32) / 4;
  const int cq = 2 * (t % 4);
  const int rows[2] = {q0 + r, q0 + r + 8};
  const uint32_t sq = hop::smem_addr(smem + L::kQ);
  const uint32_t sk = hop::smem_addr(smem + L::kK);
  const uint32_t sv = hop::smem_addr(smem + L::kV);

  float acc[D / 2];
  float s[kBN / 2];       // scores, then probabilities, of this tile
  float s_next[kBN / 2];  // scores of the next tile, in flight
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share; the quad sums at the end
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  hop::mbar_wait(q_full, 0);
  hop::mbar_wait(&k_full[0], 0);
  issue_qk<D>(s, sq, sk);
  hop::wgmma_wait<0>();
  hop::fence_regs(s);
  __syncthreads();  // K stage 0 is free: tile 2 goes there
  if (t == 0 && kStages < n)
    load_kv<D>(smem + L::kK, k_full, &map_k, kStages, kv_start + kStages, hk,
               b);

  for (int i = 0; i < n; ++i) {
    const bool more = i + 1 < n;
    const int k0 = (kv_start + i) * kBN;
    if (more) {
      const int sn = (i + 1) % kStages;
      hop::mbar_wait(&k_full[sn], ((i + 1) / kStages) & 1);
      issue_qk<D>(s_next, sq, sk + sn * L::kKVBytes);
    }
    // P V of the previous tile has to land before acc is rescaled.
    if (more)
      hop::wgmma_wait<1>();
    else
      hop::wgmma_wait<0>();
    hop::fence_regs(acc);
    if (i >= 1 && more) {
      __syncthreads();  // V stage (i - 1) % kStages is free
      if (t == 0)
        load_kv<D>(smem + L::kV, v_full, &map_v, i + 1, kv_start + i + 1, hk,
                   b);
    }

    // Online softmax on the accumulator fragments.  Only diagonal,
    // window-edge and ragged tiles carry a mask.
    const bool masked =
        k0 + kBN > T_len ||
        (causal && (k0 + kBN - 1 > q0 ||
                    (window && k0 <= q0 + kBM - 1 - window)));
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float z = s[4 * j + c] * scale;
        if (masked) {
          const int col = k0 + 8 * j + cq + (c % 2);
          const int row = rows[c / 2];
          bool ok = col < T_len;
          if (causal) {
            ok = ok && col <= row;
            if (window) ok = ok && col > row - window;
          }
          z = ok ? z : kNegInf;
        }
        s[4 * j + c] = z;
      }
    float corr[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * ri], s[4 * j + 2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[ri], mx);
      corr[ri] = exp2f((m[ri] - m_new) * kLog2e);
      m[ri] = m_new;
      const float m_log2 = m_new * kLog2e;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * ri + c];
          // A masked score is -1e30 and its probability exactly 0, also
          // where the whole row is masked so far (m = -1e30).
          x = (masked && x == kNegInf) ? 0.f : exp2f(fmaf(x, kLog2e, -m_log2));
          sum += x;
        }
      l[ri] = l[ri] * corr[ri] + sum;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[4 * j + c] *= corr[c / 2];

    // acc += P V, P rounded to bf16 in registers.
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int k = 0; k < kBN / 16; ++k) hop::acc_to_a(s, k, pa[k]);
    const int st = i % kStages;
    hop::mbar_wait(&v_full[st], (i / kStages) & 1);
    hop::fence_regs(acc);
    hop::wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBN / 16; ++k)
      mma_pv<D>(acc, pa[k],
                hop::desc_mnmajor(sv + st * L::kKVBytes, kBN, k));
    hop::wgmma_commit();

    if (more) {
      // The next tile's scores have landed (groups complete in order); its
      // K stage is free for the tile after next.
      hop::wgmma_wait<1>();
      hop::fence_regs(s_next);
      __syncthreads();
      if (t == 0 && i + 1 + kStages < n)
        load_kv<D>(smem + L::kK, k_full, &map_k, i + 1 + kStages,
                   kv_start + i + 1 + kStages, hk, b);
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) s[j] = s_next[j];
    }
  }
  hop::wgmma_wait<0>();
  hop::fence_regs(acc);

  // Epilogue: O = acc / max(l, 1e-30) in bf16, LSE = m + log(max(l, 1e-30)).
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    float sum = l[ri];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = fmaxf(sum, 1e-30f);
    const int row = rows[ri];
    if (row >= T_len) continue;
    __nv_bfloat16* orow = o + b * so.b + row * so.t + h * so.h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(
          acc[4 * j + 2 * ri] / denom, acc[4 * j + 2 * ri + 1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = pair;
    }
    if (t % 4 == 0)
      lse[(static_cast<long long>(b) * H + h) * T_len + row] =
          m[ri] + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T_len, int H, int Hkv, int causal, int window,
           float scale, const long long* gq, const long long* gk,
           const long long* gv, Strides so, cudaStream_t stream) {
  static bool configured = false;
  if (const int err = tj::opt_in_smem(flash_fwd_wgmma_kernel<D>,
                                       Layout<D>::kAlloc, &configured))
    return err;
  CUtensorMap mq, mk, mv;
  if (const int err = hop::make_map(&mq, q, gq, kBM)) return err;
  if (const int err = hop::make_map(&mk, k, gk, kBN)) return err;
  if (const int err = hop::make_map(&mv, v, gv, kBN)) return err;
  const dim3 grid(B * H, (T_len + kBM - 1) / kBM);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, Layout<D>::kAlloc, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, Hkv, T_len, so,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q: [B, T, Hq, D], k and v: [B, T, Hkv, D], each as its tensor-map
// geometry (dims d, t, h, b, then the byte strides of t, h and b); o:
// [B, T, Hq, D] by its (b, t, h, d) element strides, d-stride 1; lse:
// contiguous [B, Hq, T] f32.  D is 64 or 128.
extern "C" int tj_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int B, int T_len, int H,
                                  int Hkv, int D, int causal, int window,
                                  float scale, const long long* gq,
                                  const long long* gk, const long long* gv,
                                  long long ob, long long ot, long long oh,
                                  long long od, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || od != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides so{ob, ot, oh, od};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (D == 128)
    return launch<128>(q, k, v, o, l, B, T_len, H, Hkv, causal, window, scale,
                       gq, gk, gv, so, s);
  if (D == 64)
    return launch<64>(q, k, v, o, l, B, T_len, H, Hkv, causal, window, scale,
                      gq, gk, gv, so, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
