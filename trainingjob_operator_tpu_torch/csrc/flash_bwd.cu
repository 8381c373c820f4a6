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
// at T = 1000 and D = 16 both are bound by the f32 rate.  Like flash_fwd.cu
// they run the products as f32 FMAs out of shared memory (no mma/wgmma, no
// TMA, no pipelining).  What they keep from the TPU design is what keeps HBM
// traffic O(T * D): the [T, T] probabilities never leave the block.
//
// Design, both kernels 256 threads, 64 x 64 tiles staged in shared memory as
// f32 (rows padded to D + 1 floats, against bank conflicts), thread (ty, tx)
// owning rows 4*ty .. 4*ty+3 and columns tx + 16*j of each 64 x 64 score
// tile:
// - dQ: one block per (64-row query tile, b, h).  Q, dO, lse and delta of
//   the tile stay in shared memory while the block loops over K/V tiles from
//   the window's first tile to the causal diagonal (the bounds of the TPU
//   kernel and of flash_fwd.cu).  Each step writes dz to shared memory and
//   adds dz . K to the thread's dq rows (columns tx + 16*c).
// - dK/dV: one block per (64-row KV tile, b, KV head).  K and V of the tile
//   stay in shared memory while the block loops over query tiles, from the
//   causal diagonal (k0 / 64) to the window bound
//   ((k0 + 64 + window - 2) / 64 + 1), and inside that over the group's
//   query heads h = hk * group + g, as the TPU kernel does.  p and dz go to
//   shared memory; the thread adds p^T . dO and dz^T . Q to its dK/dV rows.
//   The whole group is summed in registers, so only [B, T, Hkv, D] is
//   written, with no atomics: the result is deterministic.
// Inputs are taken by stride, so the [B, T, H, D] layout needs no transpose
// copy.
#include <stdint.h>

#include "common.cuh"

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

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles; p and dz; lse and delta.
  return sizeof(float) * (4 * static_cast<size_t>(kB) * (D + 1) +
                          2 * static_cast<size_t>(kB) * (kB + 1) + 2 * kB);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Hkv, int T_len,
                         Strides sq, Strides sk, Strides sv, Strides sg,
                         Strides sdk, Strides sdv, float scale, int causal,
                         int window) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int DC = D / 16;  // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * DP;
  float* sQ = sV + kB * DP;
  float* sG = sQ + kB * DP;
  float* sP = sG + kB * DP;
  float* sDZ = sP + kB * PP;
  float* sL = sDZ + kB * PP;
  float* sDelta = sL + kB;

  const int k0 = blockIdx.x * kB;
  const int b = blockIdx.y / Hkv;
  const int hk = blockIdx.y % Hkv;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  load_tile<T, D>(sK, k + b * sk.b + hk * sk.h, sk, k0, T_len);
  load_tile<T, D>(sV, v + b * sv.b + hk * sv.h, sv, k0, T_len);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Query tiles wholly above the diagonal, or wholly past the window's
  // reach (the last row this KV tile serves is its last col + window - 1),
  // contribute nothing.
  int qt_end = (T_len + kB - 1) / kB;
  const int qt_start = causal ? k0 / kB : 0;
  if (causal && window) qt_end = min(qt_end, (k0 + kB + window - 2) / kB + 1);

  for (int qt = qt_start; qt < qt_end; ++qt) {
    const int q0 = qt * kB;
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      __syncthreads();  // the previous step's reads of sQ, sG, sP, sDZ done
      load_tile<T, D>(sQ, q + b * sq.b + h * sq.h, sq, q0, T_len);
      load_tile<T, D>(sG, dout + b * sg.b + h * sg.h, sg, q0, T_len);
      if (tid < kB) {
        const int t = q0 + tid;
        const long long at = (static_cast<long long>(b) * H + h) * T_len + t;
        sL[tid] = t < T_len ? lse[at] : 0.f;
        sDelta[tid] = t < T_len ? delta[at] : 0.f;
      }
      __syncthreads();

      // Score tile with query rows 4*ty + i and key columns tx + 16*j.
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
          sP[r * PP + c] = p;
          sDZ[r * PP + c] = p * (dp[i][j] - sDelta[r]) * scale;
        }
      }
      __syncthreads();

      // dV rows 4*ty + i (key rows of this tile) += p^T . dO; dK += dz^T . Q.
#pragma unroll 2
      for (int r = 0; r < kB; ++r) {
        float pv[4], dz[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = sP[r * PP + ty * 4 + i];
          dz[i] = sDZ[r * PP + ty * 4 + i];
        }
#pragma unroll
        for (int dc = 0; dc < DC; ++dc) {
          const float gg = sG[r * DP + tx + 16 * dc];
          const float qq = sQ[r * DP + tx + 16 * dc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][dc] = fmaf(pv[i], gg, dv_acc[i][dc]);
            dk_acc[i][dc] = fmaf(dz[i], qq, dk_acc[i][dc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= T_len) continue;
    T* dkrow = dk + b * sdk.b + row * sdk.t + hk * sdk.h;
    T* dvrow = dv + b * sdv.b + row * sdv.t + hk * sdv.h;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      dkrow[(tx + 16 * dc) * sdk.d] = tj::from_f32<T>(dk_acc[i][dc]);
      dvrow[(tx + 16 * dc) * sdv.d] = tj::from_f32<T>(dv_acc[i][dc]);
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
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured = false;
  if (const int err =
          tj::opt_in_smem(flash_bwd_dkv_kernel<T, D>, smem, &configured))
    return err;
  const dim3 grid((a.T_len + kB - 1) / kB, a.B * a.Hkv);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
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

template <typename T, int D>
struct DKV {
  static int run(const Args& a, cudaStream_t s) {
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

// As tj_flash_bwd_dq; dk and dv: [B, T, Hkv, D] by stride.
extern "C" int tj_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B,
                                int T_len, int H, int Hkv, int D, int dtype,
                                int causal, int window, float scale,
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
  return dispatch<DKV>(dtype, D, a, static_cast<cudaStream_t>(stream));
}
