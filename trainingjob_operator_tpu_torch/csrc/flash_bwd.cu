// Flash-attention backward for Hopper (sm_90a): dQ and dK/dV, the
// FlashAttention-2 scheme with probabilities recomputed from the saved LSE,
// with f32 FMAs: the kernels of float32 at every head dim and of bf16 at
// head dims 16 and 32.  bf16 at head dims 64 and 128 takes the tensor-core
// kernels (flash_bwd_dq_wgmma.cu, flash_bwd_dkv_wgmma.cu).
//
// Replaces the TPU kernels trainingjob_operator_tpu/ops/flash_attention.py
// _bwd_dq_kernel (tj_flash_bwd_dq) and _bwd_dkv_kernel (tj_flash_bwd_dkv),
// both launched by _flash_backward.  Same math, all in f32:
//   z  = (q . k) * scale            (the forward has (q * scale) . k)
//   p  = exp(z - lse) where the mask lets (row, col) through, else exactly 0,
//        as exp2(z * log2(e) - lse * log2(e)), one MUFU instruction (both
//        kernels compute it alike, so their p agree bit for bit)
//   dp = dO . v
//   dz = p * (dp - delta) * scale   (delta = rowsum(dO * O), computed outside)
//   dq = sum over keys of dz * k
//   dk = sum over the GQA group's query heads and rows of dz * q
//   dv = likewise of p * dO
// lse and delta arrive as contiguous [B, Hq, T] f32; dq, dk and dv leave in
// the input dtype.  The TPU kernels' padding to a block multiple and their
// 128-lane replication of lse/delta are not ported: `row < T` and `col < T`
// guards handle a ragged last tile.
//
// Bound: dQ does 6 * D flops per visible (query, key) pair and dK/dV 8 * D,
// against 4 bytes per element of q, k, v, dO and the gradients in f32, so
// both are bound by the f32 rate at every T that matters.  What both keep
// from the TPU design is what keeps HBM traffic O(T * D): the [T, T]
// probabilities never leave the block.  Both are register-blocked like an
// SGEMM: f32 FMAs outrun shared memory (128 FMAs against 128 bytes a clock
// an SM), so a thread holds a block of each product and every shared load
// is 16 bytes (8 for a bf16 chunk, widened to f32 as it is read), from
// tiles stored row-major in 4-element chunks under an XOR swizzle
// (fma_tile.cuh).  The shapes were chosen by timing variants on the card
// (tools/fma_sweep.py, PERF.md).
//
// - dQ: one CTA of NW warps per (BQ-row query tile, b, h), every (b, h) in
//   grid x and the query tiles in y from the last (under a causal mask the
//   heaviest) to the first; the KV head is h / (Hq / Hkv), so grouped KV is
//   never repeated.  Each warp owns RW whole query rows (DqShape), as in
//   flash_fwd.cu.  Q, dO, lse and delta of the tile arrive once by
//   cp.async; the block loops over BK-key K/V tiles from the window's first
//   tile to the causal diagonal (the bounds of the TPU kernel).  A step
//   runs three products with MR query rows a thread: dP = dO V^T and S =
//   Q K^T (SC key columns a thread), then p and dz in registers, dz into a
//   shared region of the warp's own (key-major, the thread's rows
//   contiguous; one __syncwarp, no block barrier), then dQ += dZ K (OC
//   columns a thread).  K and V sit in ST stages: with two, tile t + 1 is
//   queued as tile t starts (one barrier a tile); with one, once every
//   warp is done with tile t (two).  A warp skips a tile none of its rows
//   sees and tests the mask element by element only on a tile its rows see
//   in part (the diagonal, the window's edge, a ragged last tile).  Shared
//   memory (dq_smem_bytes) is 112.5 KB at D64 and 104 KB at D128 in f32:
//   two CTAs an SM.  Each CTA sums its own dQ rows over the keys in a
//   fixed order and writes them once: no atomics, deterministic.
// - dK/dV: one block of NW warps per (BK-row KV tile, b, KV head), KV tiles
//   issued in order from tile 0 (under a causal mask the heaviest: it sees
//   every query tile); each warp owns RW key rows (DkvShape).  K and V of
//   the tile stay in shared memory while the block loops over BQ-row query
//   tiles, from the causal diagonal to the window bound, and inside that
//   over the group's query heads h = hk * group + g, as the TPU kernel
//   does.  A step runs four products: S^T = K Q^T and dP^T = V dO^T with
//   MRs key rows x MCs query columns a thread, then dV += P^T dO and dK +=
//   dZ^T Q with MRn key rows x OC columns a thread, P and dZ passing
//   through a shared region of the warp's own.  Q and dO (and lse, delta)
//   arrive by cp.async into one buffer each: dO_{s+1} is queued once every
//   warp has finished dV_s and overlaps dK_s, Q_{s+1} once every warp has
//   finished dK_s and overlaps dP_{s+1}; three barriers a step.  Shared
//   memory (dkv_smem_bytes) is 96 KB at D64 and 112 KB at D128 in f32: two
//   CTAs an SM.  The whole group is summed in registers, so only [B, T,
//   Hkv, D] is written, with no atomics: the result is deterministic.
// Inputs need d-stride 1 and 4-element-aligned rows (cp.async chunks); the
// wrapper copies any other layout first (ops/flash_attention.py dq_plan,
// dkv_plan).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "fma_tile.cuh"

namespace {

using tj::Strides;

// dQ tiles per head dim: MR query rows a thread, TC threads across the key
// (and dQ) columns of a row group, SC score columns a thread, NW warps a
// CTA, ST stages of K and V (1 or 2), MINB CTAs an SM for
// __launch_bounds__.  ops/flash_attention.py FMA_DQ_TILE mirrors BQ, BK and
// FMA_DQ_WARPS NW.
template <int D>
struct DqCfg;
template <>
struct DqCfg<16> {
  static constexpr int MR = 4, TC = 4, SC = 8, NW = 2, ST = 2, MINB = 4;
};
template <>
struct DqCfg<32> {
  static constexpr int MR = 8, TC = 8, SC = 4, NW = 4, ST = 2, MINB = 2;
};
template <>
struct DqCfg<64> {
  static constexpr int MR = 4, TC = 8, SC = 8, NW = 4, ST = 2, MINB = 2;
};
template <>
struct DqCfg<128> {
  static constexpr int MR = 4, TC = 8, SC = 4, NW = 4, ST = 1, MINB = 2;
};

template <int D>
struct DqShape : DqCfg<D> {
  using C = DqCfg<D>;
  static constexpr int TR = 32 / C::TC;     // row groups a warp
  static constexpr int OC = D / C::TC;      // dQ columns a thread
  static constexpr int RW = C::MR * TR;     // query rows a warp
  static constexpr int PC = C::MR / 4;      // chunks of a thread's dZ rows
  static constexpr int BQ = C::NW * RW;     // query rows a CTA
  static constexpr int BK = C::TC * C::SC;  // keys a tile
  static constexpr int NT = 32 * C::NW;     // threads a CTA
  static constexpr int NCH = D / 4;         // chunks a row
  // Swizzle masks: Q and dO rows read at one chunk by the TR row groups, K
  // and V rows by the TC column threads, dZ rows (keys) written by the TC
  // column threads.
  static constexpr int QM = tj::cmin(tj::cmin(TR, NCH), 8) - 1;
  static constexpr int KM = tj::cmin(tj::cmin(C::TC, NCH), 8) - 1;
  static constexpr int PM = tj::cmin(tj::cmin(RW / 4, C::TC), 8) - 1;
  static_assert(OC % 4 == 0 && C::MR % 4 == 0 && (C::ST == 1 || C::ST == 2),
                "dQ tile shape");
};

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  using S = DqShape<D>;
  // Q, dO (the CTA's rows) and ST stages of K and V, in the input dtype;
  // dZ (f32, per warp); lse and delta of the CTA's rows.
  return sizeof(T) * (2 * S::BQ + 2 * S::ST * S::BK) * D +
         sizeof(float) * (S::BQ * S::BK + 2 * S::BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(DqShape<D>::NT, DqShape<D>::MINB)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int T_len, Strides sq, Strides sk,
                        Strides sv, Strides sg, Strides sdq, float scale,
                        int causal, int window) {
  using S = DqShape<D>;
  constexpr int MR = S::MR, TC = S::TC, TR = S::TR, SC = S::SC, OC = S::OC,
                RW = S::RW, PC = S::PC, BQ = S::BQ, BK = S::BK, NT = S::NT,
                NCH = S::NCH, ST = S::ST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sG = sQ + BQ * D;
  T* sKV = sG + BQ * D;  // stage s: K at sKV + 2 s BK D, V after it
  float* sZ = reinterpret_cast<float*>(sKV + ST * 2 * BK * D);
  float* sL = sZ + BQ * BK;
  float* sDelta = sL + BQ;

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

  auto load_kv = [&](int kt, int stage) {
    T* dst = sKV + stage * (2 * BK * D);
    tj::load_rows<T, D, BK, NT, S::KM>(dst, kb, sk.t, kt * BK, T_len);
    tj::load_rows<T, D, BK, NT, S::KM>(dst + BK * D, vb, sv.t, kt * BK,
                                       T_len);
  };
  tj::load_rows<T, D, BQ, NT, S::QM>(sQ, q + b * sq.b + h * sq.h, sq.t, q0,
                                     T_len);
  tj::load_rows<T, D, BQ, NT, S::QM>(sG, dout + b * sg.b + h * sg.h, sg.t,
                                     q0, T_len);
  {
    const long long at = (static_cast<long long>(b) * H + h) * T_len;
    for (int i = tid; i < BQ; i += NT) {
      const bool ok = q0 + i < T_len;
      tj::cp_f32(sL + i, lse + at + (ok ? q0 + i : 0), ok);
      tj::cp_f32(sDelta + i, delta + at + (ok ? q0 + i : 0), ok);
    }
  }
  load_kv(kv_start, 0);
  tj::cp_commit();

  float acc[MR][OC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;

  // The thread's rows of Q and dO, of dZ (a key row of the warp's region).
  const T* sQt = sQ + (wr + ty) * D;
  const T* sGt = sG + (wr + ty) * D;
  const int xq = ty & S::QM;
  const int xk = tx & S::KM;
  float* zw = sZ + warp * (BK * RW);
  const int xpw = tx & S::PM;

  for (int kt = kv_start; kt < kv_end; ++kt) {
    const int k0 = kt * BK;
    const int stage = ST == 2 ? (kt - kv_start) & 1 : 0;
    tj::cp_wait<0>();
    __syncthreads();  // K_t and V_t landed (Q, dO, lse and delta with the
                      // first); every warp is done with tile t - 1
    if (ST == 2 && kt + 1 < kv_end) {
      load_kv(kt + 1, stage ^ 1);
      tj::cp_commit();
    }
    const T* sK = sKV + stage * (2 * BK * D);
    const T* sV = sK + BK * D;

    // Whether the warp's rows see any key of the tile, and all of them
    // (rows past T see zeros: dz is 0 there, and the rows are not written).
    const bool active =
        wa < T_len &&
        (!causal || (k0 <= wb && (!window || k0 + BK - 1 > wa - window)));
    const bool full =
        k0 + BK <= T_len &&
        (!causal || (k0 + BK - 1 <= wa && (!window || k0 > wb - window)));

    if (active) {
      const T* sKt = sK + tx * D;
      const T* sVt = sV + tx * D;
      // dP = dO V^T, then S = Q K^T, d ascending (as dK/dV sums them).
      float dp[MR][SC], s[MR][SC];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) dp[i][j] = s[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < NCH; ++c) {
        const int cg = (c ^ xq) << 2, cv = (c ^ xk) << 2;
        float4 gf[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i) gf[i] = tj::ld4(sGt + i * TR * D + cg);
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float4 vf = tj::ld4(sVt + j * TC * D + cv);
#pragma unroll
          for (int i = 0; i < MR; ++i) dp[i][j] = tj::dot4(gf[i], vf, dp[i][j]);
        }
      }
#pragma unroll 4
      for (int c = 0; c < NCH; ++c) {
        const int cq = (c ^ xq) << 2, ck = (c ^ xk) << 2;
        float4 qf[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i) qf[i] = tj::ld4(sQt + i * TR * D + cq);
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const float4 kf = tj::ld4(sKt + j * TC * D + ck);
#pragma unroll
          for (int i = 0; i < MR; ++i) s[i][j] = tj::dot4(qf[i], kf, s[i][j]);
        }
      }
      // p = exp(z - lse) with z = (q . k) * scale where the mask lets the
      // pair through, else exactly 0; dz = p * (dp - delta) * scale, in s.
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int rl = wr + ty + TR * i, row = q0 + rl;
        const float lseL = sL[rl] * tj::kLog2e;
        const float dl = sDelta[rl];
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          bool ok = true;
          if (!full) {
            const int col = k0 + tx + TC * j;
            ok = col < T_len;
            if (causal) {
              ok = ok && col <= row;
              if (window) ok = ok && col > row - window;
            }
          }
          const float z = s[i][j] * scale;
          const float p = ok ? tj::ex2(fmaf(z, tj::kLog2e, -lseL)) : 0.f;
          s[i][j] = p * (dp[i][j] - dl) * scale;
        }
      }
      // dZ, key-major: the thread's MR rows (MR * ty + i) as PC chunks.
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float* zrow = zw + (tx + TC * j) * RW;
#pragma unroll
        for (int u = 0; u < PC; ++u)
          *reinterpret_cast<float4*>(zrow + (((PC * ty + u) ^ xpw) << 2)) =
              make_float4(s[4 * u][j], s[4 * u + 1][j], s[4 * u + 2][j],
                          s[4 * u + 3][j]);
      }
      __syncwarp();
      // dQ += dZ K over the tile's keys, in order.
#pragma unroll 8
      for (int c = 0; c < BK; ++c) {
        const float* zrow = zw + c * RW;
        const int xz = c & S::PM, xc = c & S::KM;
        float z[MR];
#pragma unroll
        for (int u = 0; u < PC; ++u) {
          const float4 x = tj::ld4(zrow + (((PC * ty + u) ^ xz) << 2));
          z[4 * u] = x.x;
          z[4 * u + 1] = x.y;
          z[4 * u + 2] = x.z;
          z[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 kk =
              tj::ld4(sK + c * D + (((tx + TC * g) ^ xc) << 2));
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            acc[i][4 * g] = fmaf(z[i], kk.x, acc[i][4 * g]);
            acc[i][4 * g + 1] = fmaf(z[i], kk.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(z[i], kk.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(z[i], kk.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
    if (ST == 1 && kt + 1 < kv_end) {
      __syncthreads();  // every warp is done with K_t and V_t
      load_kv(kt + 1, 0);
      tj::cp_commit();
    }
  }

  // dQ in the input dtype.
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int row = wa + ty + TR * i;
    if (row >= T_len) continue;
    T* out = dq + b * sdq.b + row * sdq.t + h * sdq.h;
#pragma unroll
    for (int g = 0; g < OC / 4; ++g)
      tj::st4(out + 4 * (tx + TC * g),
              make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                          acc[i][4 * g + 3]));
  }
}

// dK/dV tiles per head dim.  The score products (S^T = K Q^T, dP^T = V dO^T)
// give each thread MRs = RW / TRs key rows x MCs query columns, the
// gradient products (dV += P^T dO, dK += dZ^T Q) MRn key rows x OC = D /
// TCn columns of dK and of dV.  A warp owns RW key rows; NW warps a CTA,
// MINB CTAs an SM for __launch_bounds__.
// ops/flash_attention.py FMA_DKV_TILE mirrors BK and BQ.
template <int D>
struct DkvCfg;
template <>
struct DkvCfg<16> {
  static constexpr int RW = 32, TRs = 8, MCs = 8, MRn = 4, NW = 2, MINB = 2;
};
template <>
struct DkvCfg<32> {
  static constexpr int RW = 32, TRs = 4, MCs = 4, MRn = 8, NW = 4, MINB = 2;
};
template <>
struct DkvCfg<64> {
  static constexpr int RW = 16, TRs = 4, MCs = 8, MRn = 8, NW = 4, MINB = 2;
};
template <>
struct DkvCfg<128> {
  static constexpr int RW = 16, TRs = 4, MCs = 4, MRn = 8, NW = 4, MINB = 2;
};

template <int D>
struct DkvShape : DkvCfg<D> {
  using C = DkvCfg<D>;
  static constexpr int TCs = 32 / C::TRs;   // score layout: query threads
  static constexpr int MRs = C::RW / C::TRs;  // ... key rows a thread
  static constexpr int TRn = C::RW / C::MRn;  // gradient layout: row threads
  static constexpr int PC = C::MRn / 4;     // chunks of a thread's P rows
  static constexpr int TCn = 32 / TRn;      // ... column threads
  static constexpr int OC = D / TCn;        // dK and dV columns a thread
  static constexpr int BQ = TCs * C::MCs;   // query rows a step
  static constexpr int BK = C::NW * C::RW;  // key rows a CTA
  static constexpr int NT = 32 * C::NW;
  static constexpr int NCH = D / 4;
  // Swizzle masks: K and V rows read at one chunk by the TRs row threads,
  // Q and dO rows by the TCs query threads, P and dZ rows (queries) written
  // by the TCs query threads.
  static constexpr int KM = tj::cmin(tj::cmin(C::TRs, NCH), 8) - 1;
  static constexpr int QM = tj::cmin(tj::cmin(TCs, NCH), 8) - 1;
  static constexpr int PM = tj::cmin(tj::cmin(C::RW / 4, TCs), 8) - 1;
  static_assert(OC % 4 == 0 && C::MRn % 4 == 0 && MRs * C::TRs == C::RW &&
                    TRn * TCn == 32,
                "dK/dV tile shape");
};

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  using S = DkvShape<D>;
  // K, V (the CTA's rows), Q, dO (a step's rows), in the input dtype; P and
  // dZ (f32, per warp); lse and delta of the step's rows.
  return sizeof(T) * (2 * S::BK + 2 * S::BQ) * D +
         sizeof(float) * (2 * S::BQ * S::BK + 2 * S::BQ);
}

// Position of the warp's key row kl in a row of P or dZ: the gradient
// products' thread (kl % TRn) reads its MRn rows (kl / TRn) as MRn / 4
// chunks.
template <int TRn, int MRn>
__device__ __forceinline__ int key_pos(int kl) {
  return MRn * (kl % TRn) + kl / TRn;
}

template <typename T, int D>
__global__ void __launch_bounds__(DkvShape<D>::NT, DkvShape<D>::MINB)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H,
                         int Hkv, int T_len, Strides sq, Strides sk,
                         Strides sv, Strides sg, Strides sdk, Strides sdv,
                         float scale, int causal, int window) {
  using S = DkvShape<D>;
  constexpr int RW = S::RW, TRs = S::TRs, TCs = S::TCs, MRs = S::MRs,
                MCs = S::MCs, MRn = S::MRn, TRn = S::TRn, TCn = S::TCn,
                OC = S::OC, PC = S::PC, BQ = S::BQ, BK = S::BK, NT = S::NT,
                NCH = S::NCH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BK * D;
  T* sQ = sV + BK * D;
  T* sG = sQ + BQ * D;
  float* sP = reinterpret_cast<float*>(sG + BQ * D);
  float* sZ = sP + BQ * BK;
  float* sL = sZ + BQ * BK;
  float* sDelta = sL + BQ;

  const int k0 = blockIdx.y * BK;  // tile 0 first: under a causal mask the
                                   // heaviest
  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x % Hkv;
  const int group = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp * RW;
  const int wka = k0 + wr, wkb = wka + RW - 1;  // the warp's key rows
  const int tys = lane / TCs, txs = lane % TCs;  // score layout
  const int tyn = lane / TCn, txn = lane % TCn;  // gradient layout

  // Query tiles wholly above the diagonal, or wholly past the window's
  // reach (the last row this KV tile serves is its last col + window - 1),
  // contribute nothing.
  int qt_end = (T_len + BQ - 1) / BQ;
  const int qt_first = causal ? k0 / BQ : 0;
  if (causal && window) qt_end = min(qt_end, (k0 + BK + window - 2) / BQ + 1);
  const int n_steps = (qt_end - qt_first) * group;

  auto head_of = [&](int s) { return hk * group + s % group; };
  auto q0_of = [&](int s) { return (qt_first + s / group) * BQ; };
  auto load_q = [&](int s) {
    const int h = head_of(s), q0 = q0_of(s);
    tj::load_rows<T, D, BQ, NT, S::QM>(sQ, q + b * sq.b + h * sq.h, sq.t, q0,
                                       T_len);
    const long long at = (static_cast<long long>(b) * H + h) * T_len;
    for (int i = tid; i < BQ; i += NT) {
      const bool ok = q0 + i < T_len;
      tj::cp_f32(sL + i, lse + at + (ok ? q0 + i : 0), ok);
      tj::cp_f32(sDelta + i, delta + at + (ok ? q0 + i : 0), ok);
    }
  };
  auto load_g = [&](int s) {
    const int h = head_of(s);
    tj::load_rows<T, D, BQ, NT, S::QM>(sG, dout + b * sg.b + h * sg.h, sg.t,
                                       q0_of(s), T_len);
  };

  tj::load_rows<T, D, BK, NT, S::KM>(sK, k + b * sk.b + hk * sk.h, sk.t, k0,
                                     T_len);
  tj::load_rows<T, D, BK, NT, S::KM>(sV, v + b * sv.b + hk * sv.h, sv.t, k0,
                                     T_len);
  if (n_steps > 0) load_g(0);
  tj::cp_commit();
  if (n_steps > 0) load_q(0);
  tj::cp_commit();

  float dk_acc[MRn][OC], dv_acc[MRn][OC];
#pragma unroll
  for (int i = 0; i < MRn; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // The thread's rows of K and V (score layout) and of Q and dO.
  const T* sKt = sK + (wr + tys) * D;
  const T* sVt = sV + (wr + tys) * D;
  const int xk = tys & S::KM;
  const int xq = txs & S::QM;
  float* pw = sP + warp * (BQ * RW);
  float* zw = sZ + warp * (BQ * RW);
  const int xpw = txs & S::PM;
  const float scaleL = scale * tj::kLog2e;

  // Where the thread's score entry (i, j) sits in the warp's P or dZ.
  auto at_pz = [&](int i, int j) {
    const int pos = key_pos<TRn, MRn>(tys + TRs * i);
    return (txs + TCs * j) * RW + ((((pos >> 2) ^ xpw) << 2) | (pos & 3));
  };

  tj::cp_wait<1>();
  __syncthreads();  // K, V and dO_0 landed
  for (int s = 0; s < n_steps; ++s) {
    const int q0 = q0_of(s);
    const bool active =
        wka < T_len &&
        (!causal || (wka <= q0 + BQ - 1 && (!window || wkb > q0 - window)));
    const bool full =
        q0 + BQ <= T_len && wkb < T_len &&
        (!causal || (wkb <= q0 && (!window || wka > q0 + BQ - 1 - window)));

    if (active) {
      // dP^T = V dO^T, parked in the warp's dZ region until S is done.
      float dp[MRs][MCs];
#pragma unroll
      for (int i = 0; i < MRs; ++i)
#pragma unroll
        for (int j = 0; j < MCs; ++j) dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < NCH; ++c) {
        const int cv = (c ^ xk) << 2, cg = (c ^ xq) << 2;
        float4 gf[MCs];
#pragma unroll
        for (int j = 0; j < MCs; ++j)
          gf[j] = tj::ld4(sG + (txs + TCs * j) * D + cg);
#pragma unroll
        for (int i = 0; i < MRs; ++i) {
          const float4 vf = tj::ld4(sVt + i * TRs * D + cv);
#pragma unroll
          for (int j = 0; j < MCs; ++j) dp[i][j] = tj::dot4(gf[j], vf, dp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MRs; ++i)
#pragma unroll
        for (int j = 0; j < MCs; ++j) zw[at_pz(i, j)] = dp[i][j];
    }
    tj::cp_wait<0>();
    __syncthreads();  // Q_s, lse and delta landed

    if (active) {
      float sc[MRs][MCs];
#pragma unroll
      for (int i = 0; i < MRs; ++i)
#pragma unroll
        for (int j = 0; j < MCs; ++j) sc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < NCH; ++c) {
        const int ck = (c ^ xk) << 2, cq = (c ^ xq) << 2;
        float4 qf[MCs];
#pragma unroll
        for (int j = 0; j < MCs; ++j)
          qf[j] = tj::ld4(sQ + (txs + TCs * j) * D + cq);
#pragma unroll
        for (int i = 0; i < MRs; ++i) {
          const float4 kf = tj::ld4(sKt + i * TRs * D + ck);
#pragma unroll
          for (int j = 0; j < MCs; ++j) sc[i][j] = tj::dot4(qf[j], kf, sc[i][j]);
        }
      }
      // p = exp(z - lse) with z = (q . k) * scale, where the mask lets the
      // pair through, else exactly 0; dz = p * (dp - delta) * scale.
#pragma unroll
      for (int j = 0; j < MCs; ++j) {
        const int ql = txs + TCs * j, row = q0 + ql;
        const float lseL = sL[ql] * tj::kLog2e;
        const float dl = sDelta[ql];
#pragma unroll
        for (int i = 0; i < MRs; ++i) {
          const int col = wka + tys + TRs * i;
          bool ok = true;
          if (!full) {
            ok = row < T_len && col < T_len;
            if (causal) {
              ok = ok && col <= row;
              if (window) ok = ok && col > row - window;
            }
          }
          const float z = sc[i][j] * scale;
          const float p = ok ? tj::ex2(fmaf(z, tj::kLog2e, -lseL)) : 0.f;
          const int at = at_pz(i, j);
          pw[at] = p;
          zw[at] = p * (zw[at] - dl) * scale;
        }
      }
      __syncwarp();
      // dV += P^T dO over the step's query rows.
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const int xp = r & S::PM;
        float pv[MRn];
#pragma unroll
        for (int u = 0; u < PC; ++u) {
          const float4 x = tj::ld4(pw + r * RW + (((PC * tyn + u) ^ xp) << 2));
          pv[4 * u] = x.x;
          pv[4 * u + 1] = x.y;
          pv[4 * u + 2] = x.z;
          pv[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 gg = tj::ld4(
              sG + r * D + (((txn + TCn * g) ^ (r & S::QM)) << 2));
#pragma unroll
          for (int i = 0; i < MRn; ++i) {
            dv_acc[i][4 * g] = fmaf(pv[i], gg.x, dv_acc[i][4 * g]);
            dv_acc[i][4 * g + 1] = fmaf(pv[i], gg.y, dv_acc[i][4 * g + 1]);
            dv_acc[i][4 * g + 2] = fmaf(pv[i], gg.z, dv_acc[i][4 * g + 2]);
            dv_acc[i][4 * g + 3] = fmaf(pv[i], gg.w, dv_acc[i][4 * g + 3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with dO_s
    if (s + 1 < n_steps) {
      load_g(s + 1);
      tj::cp_commit();
    }

    if (active) {
      // dK += dZ^T Q over the step's query rows.
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        const int xp = r & S::PM;
        float dz[MRn];
#pragma unroll
        for (int u = 0; u < PC; ++u) {
          const float4 x = tj::ld4(zw + r * RW + (((PC * tyn + u) ^ xp) << 2));
          dz[4 * u] = x.x;
          dz[4 * u + 1] = x.y;
          dz[4 * u + 2] = x.z;
          dz[4 * u + 3] = x.w;
        }
#pragma unroll
        for (int g = 0; g < OC / 4; ++g) {
          const float4 qq = tj::ld4(
              sQ + r * D + (((txn + TCn * g) ^ (r & S::QM)) << 2));
#pragma unroll
          for (int i = 0; i < MRn; ++i) {
            dk_acc[i][4 * g] = fmaf(dz[i], qq.x, dk_acc[i][4 * g]);
            dk_acc[i][4 * g + 1] = fmaf(dz[i], qq.y, dk_acc[i][4 * g + 1]);
            dk_acc[i][4 * g + 2] = fmaf(dz[i], qq.z, dk_acc[i][4 * g + 2]);
            dk_acc[i][4 * g + 3] = fmaf(dz[i], qq.w, dk_acc[i][4 * g + 3]);
          }
        }
      }
    }
    tj::cp_wait<0>();
    __syncthreads();  // dO_{s+1} landed; every warp is done with Q_s
    if (s + 1 < n_steps) {
      load_q(s + 1);
      tj::cp_commit();
    }
  }

  // dK and dV in the input dtype.
#pragma unroll
  for (int i = 0; i < MRn; ++i) {
    const int row = wka + tyn + TRn * i;
    if (row >= T_len) continue;
#pragma unroll
    for (int g = 0; g < OC / 4; ++g) {
      const int d = 4 * (txn + TCn * g);
      const float4 xk = make_float4(dk_acc[i][4 * g], dk_acc[i][4 * g + 1],
                                    dk_acc[i][4 * g + 2], dk_acc[i][4 * g + 3]);
      const float4 xv = make_float4(dv_acc[i][4 * g], dv_acc[i][4 * g + 1],
                                    dv_acc[i][4 * g + 2], dv_acc[i][4 * g + 3]);
      tj::st4(dk + b * sdk.b + row * sdk.t + hk * sdk.h + d, xk);
      tj::st4(dv + b * sdv.b + row * sdv.t + hk * sdv.h + d, xv);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, T_len, H, Hkv, causal, window;
  float scale;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
};

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t stream) {
  using S = DqShape<D>;
  constexpr size_t smem = dq_smem_bytes<T, D>();
  static bool configured = false;
  if (const int err = tj::opt_in_max_smem(flash_bwd_dq_kernel<T, D>, smem,
                                          &configured))
    return err;
  const dim3 grid(a.B * a.H, (a.T_len + S::BQ - 1) / S::BQ);
  flash_bwd_dq_kernel<T, D><<<grid, S::NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.H, a.Hkv, a.T_len, a.sq, a.sk, a.sv,
      a.sg, a.sdq, a.scale, a.causal, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a, cudaStream_t stream) {
  using S = DkvShape<D>;
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  static bool configured = false;
  if (const int err = tj::opt_in_max_smem(flash_bwd_dkv_kernel<T, D>, smem,
                                          &configured))
    return err;
  const dim3 grid(a.B * a.Hkv, (a.T_len + S::BK - 1) / S::BK);
  flash_bwd_dkv_kernel<T, D><<<grid, S::NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.Hkv,
      a.T_len, a.sq, a.sk, a.sv, a.sg, a.sdk, a.sdv, a.scale, a.causal,
      a.window);
  return static_cast<int>(cudaGetLastError());
}

// Instantiates `launch` for the element type and head dim of the call.
template <template <typename, int> class Launch>
int dispatch(int dtype, int D, const Args& a, cudaStream_t s) {
  if (a.B <= 0 || a.T_len <= 0) return 0;
  if (a.Hkv <= 0 || a.H % a.Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == tj::kBF16) {
    switch (D) {
      case 16: return Launch<__nv_bfloat16, 16>::run(a, s);
      case 32: return Launch<__nv_bfloat16, 32>::run(a, s);
      case 64: return Launch<__nv_bfloat16, 64>::run(a, s);
      case 128: return Launch<__nv_bfloat16, 128>::run(a, s);
    }
  } else if (dtype == tj::kF32) {
    switch (D) {
      case 16: return Launch<float, 16>::run(a, s);
      case 32: return Launch<float, 32>::run(a, s);
      case 64: return Launch<float, 64>::run(a, s);
      case 128: return Launch<float, 128>::run(a, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Both kernels serve float32 at every head dim and bf16 at 16 and 32 (bf16
// at 64 and 128 takes flash_bwd_dq_wgmma.cu and flash_bwd_dkv_wgmma.cu):
// those are not instantiated.
template <typename T, int D>
constexpr bool kFmaRoute = !(std::is_same<T, __nv_bfloat16>::value && D > 32);

template <typename T, int D>
struct DQ {
  static int run(const Args& a, cudaStream_t s) {
    if constexpr (kFmaRoute<T, D>)
      return launch_dq<T, D>(a, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
};

template <typename T, int D>
struct DKV {
  static int run(const Args& a, cudaStream_t s) {
    if constexpr (kFmaRoute<T, D>)
      return launch_dkv<T, D>(a, s);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
};

}  // namespace

// q and dout: [B, T, Hq, D], k and v: [B, T, Hkv, D], dq: [B, T, Hq, D],
// each given by its (b, t, h, d) element strides, all chunked (d-stride 1,
// 4-element aligned); lse and delta: contiguous [B, Hq, T] f32.  float32 at
// head dims 16, 32, 64, 128 and bf16 at 16, 32.
extern "C" int tj_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int T_len,
                               int H, int Hkv, int D, int dtype, int causal,
                               int window, float scale, long long qb,
                               long long qt, long long qh, long long qd,
                               long long kb, long long kt, long long kh,
                               long long kd, long long vb, long long vt,
                               long long vh, long long vd, long long gb,
                               long long gt, long long gh, long long gd,
                               long long dqb, long long dqt, long long dqh,
                               long long dqd, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  a.Hkv = Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.sq = Strides{qb, qt, qh, qd};
  a.sk = Strides{kb, kt, kh, kd};
  a.sv = Strides{vb, vt, vh, vd};
  a.sg = Strides{gb, gt, gh, gd};
  a.sdq = Strides{dqb, dqt, dqh, dqd};
  if (!tj::chunked(q, a.sq, dtype) || !tj::chunked(k, a.sk, dtype) ||
      !tj::chunked(v, a.sv, dtype) || !tj::chunked(dout, a.sg, dtype) ||
      !tj::chunked(dq, a.sdq, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<DQ>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// As tj_flash_bwd_dq; dk and dv: [B, T, Hkv, D] by stride, chunked too.
extern "C" int tj_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int B, int T_len, int H, int Hkv,
                                int D, int dtype, int causal, int window,
                                float scale,
                                long long qb, long long qt, long long qh,
                                long long qd, long long kb, long long kt,
                                long long kh, long long kd, long long vb,
                                long long vt, long long vh, long long vd,
                                long long gb, long long gt, long long gh,
                                long long gd, long long dkb, long long dkt,
                                long long dkh, long long dkd, long long dvb,
                                long long dvt, long long dvh, long long dvd,
                                void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk;
  a.dv = dv;
  a.B = B;
  a.T_len = T_len;
  a.H = H;
  a.Hkv = Hkv;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.sq = Strides{qb, qt, qh, qd};
  a.sk = Strides{kb, kt, kh, kd};
  a.sv = Strides{vb, vt, vh, vd};
  a.sg = Strides{gb, gt, gh, gd};
  a.sdk = Strides{dkb, dkt, dkh, dkd};
  a.sdv = Strides{dvb, dvt, dvh, dvd};
  if (!tj::chunked(q, a.sq, dtype) || !tj::chunked(k, a.sk, dtype) ||
      !tj::chunked(v, a.sv, dtype) || !tj::chunked(dout, a.sg, dtype) ||
      !tj::chunked(dk, a.sdk, dtype) || !tj::chunked(dv, a.sdv, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<DKV>(dtype, D, a, static_cast<cudaStream_t>(stream));
}
