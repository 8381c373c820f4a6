// Flash-attention forward for Hopper (sm_90a): O and the per-row
// log-sum-exp, online softmax in f32.
//
// Replaces the TPU kernel trainingjob_operator_tpu/ops/flash_attention.py
// _kernel (launched by _flash_forward).  Same math: scores (q * scale) . k
// in f32; masked scores are -1e30 and their probabilities exactly 0; the
// running max m, denominator l and accumulator are f32; O = acc / max(l,
// 1e-30) in the input dtype; LSE = m + log(max(l, 1e-30)) in f32, stored
// [B, H, T] (the TPU's 128-lane replication is not ported).
//
// Bound: at the prefill shapes (T = 512 .. 2048, D = 128) the work is
// 4 * D flops per visible (query, key) pair against 2 bytes per element of
// q, k, v and O, so the bound is the tensor-core rate, not memory.  This
// first kernel does not reach it: it runs the products as f32 FMAs out of
// shared memory (no mma/wgmma, no TMA, no pipelining); those are later
// work.  What it does keep from the TPU design is what keeps HBM traffic
// O(T * D): the [T, T] score matrix never leaves the block.
//
// Design: one block of 256 threads per (64-row query tile, b, h).  The KV
// head is h / (Hq / Hkv), so grouped KV is never repeated.  The block loops
// over 64-row K/V tiles staged in shared memory as f32 (rows padded to D + 1
// floats: no bank conflicts).  Thread (ty, tx) owns query rows 4*ty .. 4*ty+3,
// key columns tx + 16*j of each tile and output columns tx + 16*c; the 16
// threads sharing a row reduce its max and sum with shuffles.  The loop stops
// at the causal diagonal and, with a window, starts at the window's first
// tile (the bounds of the TPU kernel); `col < T` masks and guarded loads
// handle a ragged last tile instead of padding.  Inputs are taken by stride,
// so the [B, T, H, D] layout needs no transpose copy.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

using tj::Strides;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          2 * static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int T_len,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float scale, int causal, int window) {
  constexpr int DP = D + 1;    // padded shared-memory row of Q, K, V
  constexpr int PP = kBK + 1;  // padded shared-memory row of P
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * DP;

  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kbase = k + b * sk.b + hk * sk.h;
  const T* vbase = v + b * sv.b + hk * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D, t = q0 + r;
    sQ[r * DP + c] = t < T_len ? tj::to_f32(qb[t * sq.t + c * sq.d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (T_len + kBK - 1) / kBK;
  const int kv_end = causal ? min((q0 + kBQ + kBK - 1) / kBK, n_kv) : n_kv;
  const int kv_start = (causal && window) ? max(q0 - window + 1, 0) / kBK : 0;

  for (int kt = kv_start; kt < kv_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads of sK, sV and sP are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D, t = k0 + r;
      const bool ok = t < T_len;
      sK[r * DP + c] = ok ? tj::to_f32(kbase[t * sk.t + c * sk.d]) : 0.f;
      sV[r * DP + c] = ok ? tj::to_f32(vbase[t * sv.t + c * sv.d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool valid[4];
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        bool ok = col < T_len;
        if (causal) {
          ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
        }
        valid[j] = ok;
        s[i][j] = ok ? s[i][j] : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * PP + tx + 16 * j] = p;
        psum += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + c];
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        const float vv = sV[c * DP + tx + 16 * dc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dc] = fmaf(pv[i], vv, acc[i][dc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + row * so.t + h * so.h;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc)
      orow[(tx + 16 * dc) * so.d] = tj::from_f32<T>(acc[i][dc] / denom);
    if (tx == 0)
      lse[(static_cast<long long>(b) * H + h) * T_len + row] = m[i] + logf(denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T_len, int H, int Hkv, int causal, int window,
           float scale, Strides sq, Strides sk, Strides sv, Strides so,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (const int err =
          tj::opt_in_smem(flash_fwd_kernel<T, D>, smem, &configured))
    return err;
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Hkv, T_len, sq, sk,
      sv, so, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int T_len, int H, int Hkv, int causal,
               int window, float scale, Strides sq, Strides sk, Strides sv,
               Strides so, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, T_len, H, Hkv, causal, window,
                           scale, sq, sk, sv, so, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, T_len, H, Hkv, causal, window,
                           scale, sq, sk, sv, so, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, T_len, H, Hkv, causal, window,
                           scale, sq, sk, sv, so, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, T_len, H, Hkv, causal, window,
                            scale, sq, sk, sv, so, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, T, Hq, D], k and v: [B, T, Hkv, D], o: [B, T, Hq, D], each given by
// its (b, t, h, d) element strides; lse: contiguous [B, Hq, T] f32.
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
