// Flash-attention forward for Hopper (sm_90a) with f32 FMAs: O and the
// per-row log-sum-exp, online softmax in f32.  The kernel of float32 at
// every head dim and of bf16 at head dims 16 and 32; bf16 at 64 and 128
// takes the tensor-core kernel (flash_fwd_wgmma.cu).
//
// Replaces the TPU kernel trainingjob_operator_tpu/ops/flash_attention.py
// _kernel (launched by _flash_forward).  Same math: scores (q * scale) . k
// in f32; masked scores are -1e30 and their probabilities exactly 0; the
// running max m, denominator l and accumulator are f32; O = acc / max(l,
// 1e-30) in the input dtype; LSE = m + log(max(l, 1e-30)) in f32, stored
// [B, H, T] (the TPU's 128-lane replication is not ported).  The
// probabilities are exp2(s * log2(e) - m * log2(e)), one MUFU instruction
// each; m and the LSE stay in natural-log units.
//
// Bound: 4 * D flops per visible (query, key) pair against 4 bytes per
// element of q, k, v and O in f32, so at T >= 512 the f32 rate (67 TFLOP/s
// of FMAs on the H100 SXM), not memory.  The design is that of a
// register-blocked SGEMM, twice a K/V tile:
// - Each thread holds MR query rows x SC key columns of the score tile S
//   and the same MR rows x OC output columns of O (FwdCfg: 4 x 8 and 4 x 8
//   at D64, 4 x 8 and 4 x 16 at D128), so a product step reads MR + SC
//   (S = Q K^T) or MR / 4 + OC / 4 (O += P V) 16-byte shared words for
//   4 * MR * SC or MR * OC FMAs.  A warp owns whole query rows: the row
//   max is a shuffle among the TC threads of a row, the row sum stays a
//   per-thread partial until the end, and P goes through a shared region
//   of the warp's own (one __syncwarp, no block barrier).  The shapes
//   were chosen by timing variants on the card (PERF.md).
// - Q (scaled, as f32) and K are stored row-major in 4-element chunks with
//   an XOR swizzle (fma_tile.cuh), V row-major, P key-major with the
//   thread's MR rows contiguous, so every shared load is 16 bytes (8 for a
//   bf16 K or V chunk, widened to f32 as it is read).
// - K and V arrive by cp.async, one buffer each: V_t is queued as S_t
//   starts, K_{t+1} as soon as every warp has finished S_t, so each copy
//   overlaps about half a tile of math; three barriers a tile.
// - Shared memory (fwd_smem_bytes) is 64 KB at D64 and 112 KB at D128, so
//   three and two CTAs of 4 warps share an SM.
// - One CTA per (query tile, b, h), every (b, h) in grid x and the query
//   tiles in y from the last (under a causal mask the heaviest) to the
//   first.  The KV head is h / (Hq / Hkv), so grouped KV is never repeated.
//   The loop runs from the window's first tile to the causal diagonal (the
//   bounds of the TPU kernel); a warp skips a tile none of its rows sees,
//   and tests the mask element by element only on a tile its rows see in
//   part (the diagonal, the window's edge, a ragged last tile).
// Inputs need d-stride 1 and 4-element-aligned rows (cp.async chunks); the
// wrapper copies any other layout first (ops/flash_attention.py fwd_plan).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "fma_tile.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using tj::Strides;

// Per head dim: MR query rows a thread, TC threads across the key (and
// output) columns of a row group, SC score columns a thread, NW warps a
// CTA, MINB CTAs an SM for __launch_bounds__.  ops/flash_attention.py
// FMA_FWD_TILE mirrors BQ, BK.
template <int D>
struct FwdCfg;
template <>
struct FwdCfg<16> {
  static constexpr int MR = 4, TC = 4, SC = 8, NW = 2, MINB = 4;
};
template <>
struct FwdCfg<32> {
  static constexpr int MR = 8, TC = 8, SC = 4, NW = 4, MINB = 3;
};
template <>
struct FwdCfg<64> {
  static constexpr int MR = 4, TC = 8, SC = 8, NW = 4, MINB = 3;
};
template <>
struct FwdCfg<128> {
  static constexpr int MR = 4, TC = 8, SC = 8, NW = 4, MINB = 2;
};

template <int D>
struct FwdShape : FwdCfg<D> {
  using C = FwdCfg<D>;
  static constexpr int TR = 32 / C::TC;   // row groups a warp
  static constexpr int OC = D / C::TC;    // output columns a thread
  static constexpr int RW = C::MR * TR;   // query rows a warp
  static constexpr int PC = C::MR / 4;    // chunks of a thread's P rows
  static constexpr int BQ = C::NW * RW;   // query rows a CTA
  static constexpr int BK = C::TC * C::SC;  // keys a tile
  static constexpr int NT = 32 * C::NW;   // threads a CTA
  static constexpr int NCH = D / 4;       // chunks a row
  // Swizzle masks: Q rows read at one chunk by the TR row groups, K rows by
  // the TC column threads, P rows (keys) written by the TC column threads.
  static constexpr int QM = tj::cmin(tj::cmin(TR, NCH), 8) - 1;
  static constexpr int KM = tj::cmin(tj::cmin(C::TC, NCH), 8) - 1;
  static constexpr int PM = tj::cmin(tj::cmin(RW / 4, C::TC), 8) - 1;
  static_assert(OC % 4 == 0 && C::MR % 4 == 0,
                "output columns and a thread's rows come in 4-element chunks");
};

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  using S = FwdShape<D>;
  // Q (f32, scaled), K and V (input dtype), P (f32).
  return sizeof(float) * S::BQ * D + 2 * sizeof(T) * S::BK * D +
         sizeof(float) * S::BQ * S::BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(FwdShape<D>::NT, FwdShape<D>::MINB)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int T_len,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int causal, int window) {
  using S = FwdShape<D>;
  constexpr int MR = S::MR, TC = S::TC, TR = S::TR, SC = S::SC, OC = S::OC,
                RW = S::RW, PC = S::PC, BQ = S::BQ, BK = S::BK, NT = S::NT,
                NCH = S::NCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  T* sK = reinterpret_cast<T*>(sQ + BQ * D);
  T* sV = sK + BK * D;
  float* sP = reinterpret_cast<float*>(sV + BK * D);

  const int n_q = (T_len + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = lane / TC, tx = lane % TC;
  const int wr = warp * RW;          // the warp's first row in the tile
  const int wa = q0 + wr;            // ... and in the sequence
  const int wb = wa + RW - 1;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  const int n_kv = (T_len + BK - 1) / BK;
  const int kv_end = causal ? min((q0 + BQ + BK - 1) / BK, n_kv) : n_kv;
  const int kv_start = (causal && window) ? max(q0 - window + 1, 0) / BK : 0;

  tj::load_rows<T, D, BK, NT, S::KM>(sK, kb, sk.t, kv_start * BK, T_len);
  tj::cp_commit();
  {
    const T* qb = q + b * sq.b + h * sq.h;
    for (int idx = tid; idx < BQ * NCH; idx += NT) {
      const int r = idx / NCH, c = idx % NCH, t = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T_len) {
        x = tj::ld4(qb + t * sq.t + 4 * c);
        x.x *= scale;
        x.y *= scale;
        x.z *= scale;
        x.w *= scale;
      }
      *reinterpret_cast<float4*>(sQ + tj::chunk_at<D>(r, c, r & S::QM)) = x;
    }
  }

  float m[MR], l[MR], acc[MR][OC];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // The thread's rows of Q and of P, columns of K and V.
  const float* sQt = sQ + (wr + ty) * D;
  const int xq = ty & S::QM;
  const T* sKt = sK + tx * D;
  const int xk = tx & S::KM;
  float* pw = sP + warp * (BK * RW);
  const int xpw = tx & S::PM;

  for (int kt = kv_start; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    tj::cp_wait<0>();
    __syncthreads();  // K_t landed; every warp is done with V_{t-1} and P
    tj::load_rows<T, D, BK, NT, 0>(sV, vb, sv.t, k0, T_len);
    tj::cp_commit();

    // Whether the warp's rows see any key of the tile, and all of them.
    const bool active =
        wa < T_len &&
        (!causal || (k0 <= wb && (!window || k0 + BK - 1 > wa - window)));
    const bool full =
        k0 + BK <= T_len &&
        (!causal || (k0 + BK - 1 <= wa && (!window || k0 > wb - window)));

    float s[MR][SC];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
    if (active) {
#pragma unroll 4
      for (int c = 0; c < NCH; ++c) {
        const int cq = (c ^ xq) << 2, ck = (c ^ xk) << 2;
        float4 kf[SC];
#pragma unroll
        for (int j = 0; j < SC; ++j) kf[j] = tj::ld4(sKt + j * TC * D + ck);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float4 qf = tj::ld4(sQt + i * TR * D + cq);
#pragma unroll
          for (int j = 0; j < SC; ++j) s[i][j] = tj::dot4(qf, kf[j], s[i][j]);
        }
      }
    }
    __syncthreads();  // every warp is done with K_t
    if (kt + 1 < kv_end)
      tj::load_rows<T, D, BK, NT, S::KM>(sK, kb, sk.t, k0 + BK, T_len);
    tj::cp_commit();

    if (active) {
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int row = wa + ty + TR * i;
        unsigned seen = (1u << SC) - 1;
        if (!full) {
          seen = 0;
#pragma unroll
          for (int j = 0; j < SC; ++j) {
            const int col = k0 + tx + TC * j;
            bool ok = col < T_len;
            if (causal) {
              ok = ok && col <= row;
              if (window) ok = ok && col > row - window;
            }
            seen |= static_cast<unsigned>(ok) << j;
          }
        }
        float rmax = kNegInf;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          if (!((seen >> j) & 1u)) s[i][j] = kNegInf;
          rmax = fmaxf(rmax, s[i][j]);
        }
#pragma unroll
        for (int off = TC / 2; off > 0; off >>= 1)
          rmax = fmaxf(rmax, __shfl_xor_sync(kFull, rmax, off));
        const float m_new = fmaxf(m[i], rmax);
        const float corr = tj::ex2((m[i] - m_new) * tj::kLog2e);
        const float mL = m_new * tj::kLog2e;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float p = ((seen >> j) & 1u)
                              ? tj::ex2(fmaf(s[i][j], tj::kLog2e, -mL))
                              : 0.f;
          s[i][j] = p;
          psum += p;
        }
        l[i] = l[i] * corr + psum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
      }
      // P, key-major: the thread's MR rows (MR * ty + i) as PC chunks.
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float* prow = pw + (tx + TC * j) * RW;
#pragma unroll
        for (int u = 0; u < PC; ++u)
          *reinterpret_cast<float4*>(prow + (((PC * ty + u) ^ xpw) << 2)) =
              make_float4(s[4 * u][j], s[4 * u + 1][j], s[4 * u + 2][j],
                          s[4 * u + 3][j]);
      }
    }
    tj::cp_wait<1>();
    __syncthreads();  // V_t landed (and P is visible within the warp)

    if (active) {
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float* prow = pw + c * RW;
        const int xp = c & S::PM;
        float p[MR];
#pragma unroll
        for (int u = 0; u < PC; ++u) {
          const float4 x = tj::ld4(prow + (((PC * ty + u) ^ xp) << 2));
          p[4 * u] = x.x;
          p[4 * u + 1] = x.y;
          p[4 * u + 2] = x.z;
          p[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 vv = tj::ld4(sV + c * D + 4 * (tx + TC * g));
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            acc[i][4 * g] = fmaf(p[i], vv.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(p[i], vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p[i], vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p[i], vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MR; ++i) {
#pragma unroll
    for (int off = TC / 2; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(kFull, l[i], off);
    const int row = wa + ty + TR * i;
    if (row >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + row * so.t + h * so.h;
#pragma unroll
    for (int g = 0; g < OC / 4; ++g)
      tj::st4(orow + 4 * (tx + TC * g),
              make_float4(acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                          acc[i][4 * g + 2] / denom,
                          acc[i][4 * g + 3] / denom));
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * T_len + row] =
          m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T_len, int H, int Hkv, int causal, int window,
           float scale, Strides sq, Strides sk, Strides sv, Strides so,
           cudaStream_t stream) {
  using S = FwdShape<D>;
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  static bool configured = false;
  if (const int err =
          tj::opt_in_max_smem(flash_fwd_kernel<T, D>, smem, &configured))
    return err;
  const dim3 grid(B * H, (T_len + S::BQ - 1) / S::BQ);
  flash_fwd_kernel<T, D><<<grid, S::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, T_len, sq, sk,
      sv, so, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at head dims 64 and 128 takes flash_fwd_wgmma.cu: not instantiated.
template <typename T, int D>
int launch_if(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int T_len, int H, int Hkv, int causal,
              int window, float scale, Strides sq, Strides sk, Strides sv,
              Strides so, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  else
    return launch<T, D>(q, k, v, o, lse, B, T_len, H, Hkv, causal, window,
                        scale, sq, sk, sv, so, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int T_len, int H, int Hkv, int causal,
               int window, float scale, Strides sq, Strides sk, Strides sv,
               Strides so, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_if<T, 16>(q, k, v, o, lse, B, T_len, H, Hkv, causal,
                              window, scale, sq, sk, sv, so, stream);
    case 32:
      return launch_if<T, 32>(q, k, v, o, lse, B, T_len, H, Hkv, causal,
                              window, scale, sq, sk, sv, so, stream);
    case 64:
      return launch_if<T, 64>(q, k, v, o, lse, B, T_len, H, Hkv, causal,
                              window, scale, sq, sk, sv, so, stream);
    case 128:
      return launch_if<T, 128>(q, k, v, o, lse, B, T_len, H, Hkv, causal,
                               window, scale, sq, sk, sv, so, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, T, Hq, D], k and v: [B, T, Hkv, D], o: [B, T, Hq, D], each given by
// its (b, t, h, d) element strides, all chunked (d-stride 1, 4-element
// aligned); lse: contiguous [B, Hq, T] f32.  float32 at head dims 16, 32,
// 64, 128 and bf16 at 16, 32.
extern "C" int tj_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int T_len, int H,
                            int Hkv, int D, int dtype, int causal, int window,
                            float scale, long long qb, long long qt,
                            long long qh, long long qd, long long kb,
                            long long kt, long long kh, long long kd,
                            long long vb, long long vt, long long vh,
                            long long vd, long long ob, long long ot,
                            long long oh, long long od, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{qb, qt, qh, qd}, sk{kb, kt, kh, kd}, sv{vb, vt, vh, vd},
      so{ob, ot, oh, od};
  if (!tj::chunked(q, sq, dtype) || !tj::chunked(k, sk, dtype) ||
      !tj::chunked(v, sv, dtype) || !tj::chunked(o, so, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == tj::kBF16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, l, B, T_len, H, Hkv, causal,
                                     window, scale, sq, sk, sv, so, s);
  if (dtype == tj::kF32)
    return dispatch_d<float>(D, q, k, v, o, l, B, T_len, H, Hkv, causal, window,
                             scale, sq, sk, sv, so, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
