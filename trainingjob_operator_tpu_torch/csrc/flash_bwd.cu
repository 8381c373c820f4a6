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
//   p  = exp(z - lse) where the mask lets (row, col) through, else exactly 0
//        (dK/dV: exp2(z * log2(e) - lse * log2(e)), one MUFU instruction)
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
// probabilities never leave the block.
//
// - dQ: 256 threads, one block per (64-row query tile, b, h), tiles staged
//   in shared memory as f32 (rows padded to D + 1 floats), thread (ty, tx)
//   owning rows 4*ty .. 4*ty+3 and columns tx + 16*j of each 64 x 64 score
//   tile.  Q, dO, lse and delta of the tile stay in shared memory while the
//   block loops over K/V tiles from the window's first tile to the causal
//   diagonal (the bounds of the TPU kernel and of flash_fwd.cu).  Each step
//   writes dz to shared memory and adds dz . K to the thread's dq rows
//   (columns tx + 16*c).  Inputs are taken by stride.
// - dK/dV: a register-blocked SGEMM design like flash_fwd.cu's.  One block
//   of NW warps per (BK-row KV tile, b, KV head), KV tiles issued in order
//   from tile 0 (under a causal mask the heaviest: it sees every query
//   tile); each warp owns RW key rows (DkvShape).  K and V of the tile stay
//   in shared memory while the block loops over BQ-row query tiles, from
//   the causal diagonal to the window bound, and inside that over the
//   group's query heads h = hk * group + g, as the TPU kernel does.  A step
//   runs four products: S^T = K Q^T and dP^T = V dO^T with MRs key rows x
//   MCs query columns a thread, then dV += P^T dO and dK += dZ^T Q with MRn
//   key rows x OC columns a thread, P and dZ passing through a shared region
//   of the warp's own.  Q and dO (and lse, delta) arrive by cp.async into
//   one buffer each, chunk-swizzled as in flash_fwd.cu: dO_{s+1} is queued
//   once every warp has finished dV_s and overlaps dK_s, Q_{s+1} once every
//   warp has finished dK_s and overlaps dP_{s+1}; three barriers a step.
//   Shared memory (dkv_smem_bytes) is 96 KB at D64 and 112 KB at D128 in
//   f32: two CTAs an SM.
//   The whole group is summed in registers, so only [B, T, Hkv, D] is
//   written, with no atomics: the result is deterministic.
//   Inputs need d-stride 1 and 4-element-aligned rows; the wrapper copies
//   any other layout first (ops/flash_attention.py dkv_plan).
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "fma_tile.cuh"

namespace {

constexpr int kB = 64;  // query and key tile rows
constexpr int kThreads = 256;

using tj::Strides;

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles; dz; lse and delta.
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (D + 1) +
                          static_cast<size_t>(kB) * (kB + 1) + 2 * kB);
}

// Stage rows t0 .. t0 + 63 of one head of x ([B, T, H, D] by stride) into
// shared memory as f32, zero past T.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          const Strides& s, int t0,
                                          int T_len) {
  constexpr int DP = D + 1;
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int r = i / D, c = i % D, t = t0 + r;
    dst[r * DP + c] = t < T_len ? tj::to_f32(base[t * s.t + c * s.d]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int row, int col, int T_len,
                                        int causal, int window) {
  bool ok = row < T_len && col < T_len;
  if (causal) {
    ok = ok && col <= row;
    if (window) ok = ok && col > row - window;
  }
  return ok;
}

// The 4 x 4 score and dp entries of thread (ty, tx) for one 64 x 64 tile:
// rows 4*ty + i of sQ and sG (dO), columns tx + 16*j of sK and sV.
template <int D>
__device__ __forceinline__ void tile_products(const float* sQ, const float* sG,
                                              const float* sK, const float* sV,
                                              int ty, int tx, float s[4][4],
                                              float dp[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = sQ[(ty * 4 + i) * DP + d];
      gv[i] = sG[(ty * 4 + i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = sK[(tx + 16 * j) * DP + d];
      vv[j] = sV[(tx + 16 * j) * DP + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int T_len, Strides sq, Strides sk,
                        Strides sv, Strides sg, Strides sdq, float scale,
                        int causal, int window) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int DC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + kB * DP;
  float* sK = sG + kB * DP;
  float* sV = sK + kB * DP;
  float* sDZ = sV + kB * DP;
  float* sL = sDZ + kB * PP;
  float* sDelta = sL + kB;

  const int q0 = blockIdx.x * kB;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* kbase = k + b * sk.b + hk * sk.h;
  const T* vbase = v + b * sv.b + hk * sv.h;
  load_tile<T, D>(sQ, q + b * sq.b + h * sq.h, sq, q0, T_len);
  load_tile<T, D>(sG, dout + b * sg.b + h * sg.h, sg, q0, T_len);
  if (tid < kB) {
    const int t = q0 + tid;
    const long long at = (static_cast<long long>(b) * H + h) * T_len + t;
    sL[tid] = t < T_len ? lse[at] : 0.f;
    sDelta[tid] = t < T_len ? delta[at] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int n_kv = (T_len + kB - 1) / kB;
  const int kv_end = causal ? min((q0 + kB + kB - 1) / kB, n_kv) : n_kv;
  const int kv_start = (causal && window) ? max(q0 - window + 1, 0) / kB : 0;

  for (int kt = kv_start; kt < kv_end; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's reads of sK, sV and sDZ are done
    load_tile<T, D>(sK, kbase, sk, k0, T_len);
    load_tile<T, D>(sV, vbase, sv, k0, T_len);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<D>(sQ, sG, sK, sV, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, T_len, causal, window)
                            ? expf(s[i][j] * scale - sL[r])
                            : 0.f;
        sDZ[r * PP + c] = p * (dp[i][j] - sDelta[r]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float dz[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dz[i] = sDZ[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float kk = sK[c * DP + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(dz[i], kk, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T_len) continue;
    T* out = dq + b * sdq.b + row * sdq.t + h * sdq.h;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      out[(tx + 16 * dc) * sdq.d] = tj::from_f32<T>(acc[i][dc]);
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
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured = false;
  if (const int err =
          tj::opt_in_smem(flash_bwd_dq_kernel<T, D>, smem, &configured))
    return err;
  const dim3 grid((a.T_len + kB - 1) / kB, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
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
  if (!configured) {
    // Two CTAs of up to 113 KB an SM need the largest shared carve-out.
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (const int err =
          tj::opt_in_smem(flash_bwd_dkv_kernel<T, D>, smem, &configured))
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

template <typename T, int D>
struct DQ {
  static int run(const Args& a, cudaStream_t s) {
    return launch_dq<T, D>(a, s);
  }
};

// The dK/dV kernel serves float32 at every head dim and bf16 at 16 and 32
// (bf16 at 64 and 128 takes flash_bwd_dkv_wgmma.cu).
template <typename T, int D>
struct DKV {
  static int run(const Args& a, cudaStream_t s) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value && D > 32)
      return static_cast<int>(cudaErrorInvalidValue);
    else
      return launch_dkv<T, D>(a, s);
  }
};

}  // namespace

// q and dout: [B, T, Hq, D], k and v: [B, T, Hkv, D], dq: [B, T, Hq, D],
// each given by its (b, t, h, d) element strides; lse and delta: contiguous
// [B, Hq, T] f32.
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
  return dispatch<DQ>(dtype, D, a, static_cast<cudaStream_t>(stream));
}

// As tj_flash_bwd_dq; dk and dv: [B, T, Hkv, D] by stride.  q, k, v, dout,
// dk and dv must be chunked (d-stride 1, 4-element aligned); float32 at head
// dims 16, 32, 64, 128 and bf16 at 16, 32.
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
