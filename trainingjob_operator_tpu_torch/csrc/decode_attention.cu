// Split-K decode attention over the KV cache for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this attention in plain
// XLA (trainingjob_operator_tpu/models/decode.py _attend_cache).  Added
// because the plain PyTorch version (ops/decode_attention.py
// attend_cache_reference) copies every layer's whole cache slice to f32 and
// reads all of its positions, whatever each row can see.
//
// One query token a row attends to one layer's cache slice: q [B, 1, Hq, D]
// against keys and values [B, S, Hkv, D], read in place in their stored
// dtype (f32 or bf16), Hq = Hkv x group.  Row b sees nvis(b) cache slots:
// in full mode slots 0 .. min(t, S - 1); in ring mode (window > 0) the
// slots whose position p = t - ((t - s) mod S) has p >= 0 and p > t - window,
// that is the min(t + 1, window, S) slots ending at slot t mod S, taken as
// one run of "visible indices" j = 0 .. nvis - 1 at slot (start + j) mod S.
// The positions t are one int for the batch or a per-row device tensor
// ts [B] that the kernel reads itself.
//
// Bound: device-memory bytes.  Every visible position of one KV head is
// 2 x D elements read once for `group` query heads: about 4 FLOP a byte at
// group 4 in bf16, far below the card's 295.  At B 32, S 2048, Hkv 8, D 128
// bf16 a full slice is 268 MB, 80 us at 3.35 TB/s.  What the design does
// about it:
// - the cache is read once, in its stored dtype, and only where a row can
//   see it: a CTA owns `chunk` visible indices of one (row, KV head), and a
//   CTA whose chunk lies past the row's last visible index exits before it
//   loads anything;
// - the grid is (B x Hkv) x splits of the visible indices, splits from
//   ops/decode_attention.py decode_attention_plan, so that a full cache at
//   the serving shapes gives some 2,000 CTAs and a ragged one still fills
//   the card;
// - each thread owns one 16-byte vector of the head dim (8 bf16, 4 f32) of
//   kRows positions a stage and copies exactly the vectors it will read by
//   cp.async into its own shared-memory slots, kStages stages deep: the
//   loads stay in flight without registers, and no barrier is needed until
//   the CTA merges its partial sums;
// - the TX = D / vector lanes of a position add their partial dot products
//   by warp shuffles; the 32 / TX position groups of a warp and the warps
//   each keep their own online softmax (running max, sum and f32
//   accumulator per query head, one step a stage of kRows positions, the
//   sums rescaled only when the max grows) and are merged through shared
//   memory at the end;
// - a CTA writes its (max, sum, accumulator) to a workspace, or, where it
//   is the row's only split, the output itself; a second small launch
//   merges the splits of every row with more than one.
// Numerics: f32 scores times scale, an f32 online softmax in base 2 (exp2 of
// the scores times scale x log2(e), one MUFU instruction), P.V accumulated in
// f32; bf16 is widened exactly, so the plain version differs in summation
// order and in exp2's last bits.  The output is stored in q's dtype.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "fma_tile.cuh"

namespace {

// Warps a CTA, positions a thread copies a stage, and stages in flight:
// kWarps, kRows and kStages of ops/decode_attention.py (DA_WARPS, DA_ROWS,
// DA_STAGES).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;
constexpr int kStages = 4;
// Pipeline bytes a CTA: kStages x kRows x (K, V) x kThreads 16-byte slots.
constexpr int kPipeBytes = kStages * kRows * 2 * kThreads * 16;

// Element strides of a [B, S, H, D] cache slice (d-stride 1).
struct CacheStrides {
  long long b, s, h;
};

// One launch's arguments (tj_decode_attention's, less dtype, D and the
// group's instance), passed to both kernels by value.
struct Params {
  const void *q, *k, *v;
  const long long* ts;  // per-row positions, or null: every row at t
  long long t;
  void* out;
  float *part_acc, *part_ml;
  int B, S, Hkv, group, window, chunk, splits;
  float scale_log2;
  long long qsb, qsh;
  CacheStrides ks, vs;
};

template <typename T, int D>
struct Shape {
  static constexpr int kVec = 16 / sizeof(T);     // elements a thread
  static constexpr int kTx = D / kVec;            // lanes of a position
  static constexpr int kTy = 32 / kTx;            // positions a warp row
  static constexpr int kGroups = kWarps * kTy;    // softmax states a CTA
  static constexpr int kTile = kRows * kGroups;   // positions a stage
};

// Visible slots of a row at position t (see the head of this file).
__host__ __device__ __forceinline__ int visible(long long t, int S,
                                                int window) {
  long long n = t + 1;
  if (n > S) n = S;
  if (window > 0 && n > window) n = window;
  return n > 0 ? static_cast<int>(n) : 0;
}

// Slot of visible index 0: slot 0 in full mode; in ring mode the slot of
// the oldest visible position, (t - nvis + 1) mod S.
__device__ __forceinline__ int first_slot(long long t, int nvis, int S,
                                          int window) {
  if (window <= 0) return 0;
  const long long r = (t - nvis + 1) % S;
  return static_cast<int>(r < 0 ? r + S : r);
}

// 16 bytes from device memory into this thread's shared slot, zero-filled
// where !pred (src must still be a valid address).
__device__ __forceinline__ void cp16(uint4* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tj::smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// A 16-byte vector as f32.
__device__ __forceinline__ void widen(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen(const uint4& u, float (&x)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Params p) {
  using Sh = Shape<T, D>;
  constexpr int V = Sh::kVec, TX = Sh::kTx, TY = Sh::kTy;
  constexpr int NG = Sh::kGroups, P = Sh::kTile;
  static_assert(TX >= 1 && TX <= 32 && TX * V == D, "a position's lanes");
  static_assert((NG * G * D + 2 * NG * G) * 4 <= kPipeBytes,
                "the merge fits the pipeline's shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* slots = reinterpret_cast<uint4*>(smem);
  const T* __restrict__ q = static_cast<const T*>(p.q);
  const T* __restrict__ k = static_cast<const T*>(p.k);
  const T* __restrict__ v = static_cast<const T*>(p.v);
  T* __restrict__ out = static_cast<T*>(p.out);
  const int S = p.S, Hkv = p.Hkv, group = p.group, chunk = p.chunk;
  const CacheStrides ks = p.ks, vs = p.vs;

  const int bh = blockIdx.x, b = bh / Hkv, kvh = bh % Hkv;
  const int split = blockIdx.y;
  const long long t = p.ts != nullptr ? p.ts[b] : p.t;
  const int nvis = visible(t, S, p.window);
  const int j0 = split * chunk;
  const int Hq = Hkv * group;
  if (j0 >= nvis) {
    // A row that sees no slot gets NaN, as a softmax over nothing does.
    if (nvis == 0 && split == 0)
      for (int idx = threadIdx.x; idx < group * D; idx += kThreads)
        out[(static_cast<long long>(b) * Hq + kvh * group) * D + idx] =
            tj::from_f32<T>(NAN);
    return;
  }
  const int j1 = min(j0 + chunk, nvis);
  const int start = first_slot(t, nvis, S, p.window);
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = lane % TX;
  // This thread's softmax state: positions grp, grp + NG, ... of a stage.
  const int grp = (tid >> 5) * TY + lane / TX;

  float qf[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (g < group)
      u = *reinterpret_cast<const uint4*>(q + b * p.qsb +
                                          (kvh * group + g) * p.qsh + tx * V);
    widen(u, qf[g]);
  }

  const T* kb = k + b * ks.b + kvh * ks.h + tx * V;
  const T* vb = v + b * vs.b + kvh * vs.h + tx * V;
  const int ntiles = (j1 - j0 + P - 1) / P;
  auto issue = [&](int tile) {
    uint4* dst = slots + (tile % kStages) * kRows * 2 * kThreads + tid;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + tile * P + r * NG + grp;
      const bool ok = j < j1;
      int slot = start + j;
      if (slot >= S) slot -= S;
      cp16(dst + (2 * r) * kThreads, ok ? kb + slot * ks.s : kb, ok);
      cp16(dst + (2 * r + 1) * kThreads, ok ? vb + slot * vs.s : vb, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s);
    tj::cp_commit();
  }

  float m[G], l[G], acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < ntiles; ++i) {
    if (i + kStages - 1 < ntiles) issue(i + kStages - 1);
    tj::cp_commit();
    tj::cp_wait<kStages - 1>();  // this thread's copies of tile i landed
    const uint4* src = slots + (i % kStages) * kRows * 2 * kThreads + tid;
    // Scores of the stage's kRows positions (scale x log2(e) folded in),
    // the TX lanes of a position adding their partial dot products.
    float x[kRows][G];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float kf[V];
      widen(src[(2 * r) * kThreads], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d = fmaf(qf[g][e], kf[e], d);
        x[r][g] = d;
      }
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          x[r][g] += __shfl_xor_sync(0xffffffffu, x[r][g], off);
      }
    }
    // One online-softmax step for the stage: the running max grows (and
    // the sums are rescaled) at most once, then the visible positions add
    // their weights and values.  Uniform over the TX lanes of a position.
    const int jr = j0 + i * P + grp;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        x[r][g] = jr + r * NG < j1 ? x[r][g] * p.scale_log2 : -INFINITY;
        mx = fmaxf(mx, x[r][g]);
      }
      if (mx > m[g]) {
        const float alpha = tj::ex2(m[g] - mx);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] *= alpha;
        m[g] = mx;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (jr + r * NG >= j1) break;
      float vf[V];
      widen(src[(2 * r + 1) * kThreads], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float w = tj::ex2(x[r][g] - m[g]);
        l[g] += w;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
  }

  // Merge the CTA's NG softmax states through shared memory.
  tj::cp_wait<0>();
  __syncthreads();
  float* sacc = reinterpret_cast<float*>(smem);  // [NG][G][D]
  float* sm = sacc + NG * G * D;                 // [NG][G]
  float* sl = sm + NG * G;                       // [NG][G]
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e)
      sacc[(grp * G + g) * D + tx * V + e] = acc[g][e];
    if (tx == 0) {
      sm[grp * G + g] = m[g];
      sl[grp * G + g] = l[g];
    }
  }
  __syncthreads();
  const bool alone = nvis <= chunk;  // the row's only split
  for (int idx = tid; idx < group * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int n = 0; n < NG; ++n) M = fmaxf(M, sm[n * G + g]);
    float L = 0.f, A = 0.f;
    for (int n = 0; n < NG; ++n) {
      const float w = tj::ex2(sm[n * G + g] - M);
      L = fmaf(sl[n * G + g], w, L);
      A = fmaf(sacc[(n * G + g) * D + d], w, A);
    }
    if (alone) {
      out[(static_cast<long long>(b) * Hq + kvh * group + g) * D + d] =
          tj::from_f32<T>(A / L);
    } else {
      const long long at =
          (static_cast<long long>(bh) * p.splits + split) * G + g;
      p.part_acc[at * D + d] = A;
      if (d == 0) {
        p.part_ml[2 * at] = M;
        p.part_ml[2 * at + 1] = L;
      }
    }
  }
}

// Merge the splits of each (row, KV head) with more than one.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_combine(const Params p, int G, int D) {
  const int bh = blockIdx.x, b = bh / p.Hkv, kvh = bh % p.Hkv;
  const long long t = p.ts != nullptr ? p.ts[b] : p.t;
  const int nvis = visible(t, p.S, p.window);
  const int n = (nvis + p.chunk - 1) / p.chunk;
  if (n <= 1) return;  // written by the main kernel
  const int Hq = p.Hkv * p.group;
  T* out = static_cast<T*>(p.out);
  for (int idx = threadIdx.x; idx < p.group * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    const long long base = static_cast<long long>(bh) * p.splits * G + g;
    float M = -INFINITY;
    for (int s = 0; s < n; ++s) M = fmaxf(M, p.part_ml[2 * (base + s * G)]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n; ++s) {
      const long long at = base + s * G;
      const float w = tj::ex2(p.part_ml[2 * at] - M);
      L = fmaf(p.part_ml[2 * at + 1], w, L);
      A = fmaf(p.part_acc[at * D + d], w, A);
    }
    out[(static_cast<long long>(b) * Hq + kvh * p.group + g) * D + d] =
        tj::from_f32<T>(A / L);
  }
}

template <typename T, int D, int G>
int launch(const Params& p, cudaStream_t stream) {
  if (p.chunk % Shape<T, D>::kTile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  auto kernel = decode_attention_kernel<T, D, G>;
  const int err = tj::opt_in_smem(kernel, kPipeBytes, &configured);
  if (err != 0) return err;
  kernel<<<dim3(p.B * p.Hkv, p.splits), kThreads, kPipeBytes, stream>>>(p);
  if (p.splits > 1)
    decode_attention_combine<T><<<p.B * p.Hkv, kThreads, 0, stream>>>(p, G,
                                                                      D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int by_group(int G, const Params& p, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(p, s);
    case 2: return launch<T, D, 2>(p, s);
    case 4: return launch<T, D, 4>(p, s);
    case 8: return launch<T, D, 8>(p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_head_dim(int D, int G, const Params& p, cudaStream_t s) {
  switch (D) {
    case 16: return by_group<T, 16>(G, p, s);
    case 32: return by_group<T, 32>(G, p, s);
    case 64: return by_group<T, 64>(G, p, s);
    case 128: return by_group<T, 128>(G, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, 1, Hkv x group, D] with d-stride 1 (b- and h-strides qsb, qsh);
// k, v: [B, S, Hkv, D] with d-stride 1 and the other strides given; all
// 16-byte aligned with strides that keep every 16-byte vector aligned.
// ts: int64 [B] positions, or null for the one position t.  out: contiguous
// [B, 1, Hkv x group, D] of q's dtype.  part_acc [B x Hkv, splits,
// group_slots, D] and part_ml [B x Hkv, splits, group_slots, 2], f32: the
// splits' partial sums.  group_slots (a power of two, >= group), chunk (a
// multiple of the tile) and splits come from ops/decode_attention.py
// decode_attention_plan.
extern "C" int tj_decode_attention(
    const void* q, const void* k, const void* v, const long long* ts,
    long long t, void* out, void* part_acc, void* part_ml, int B, int S,
    int Hkv, int D, int group, int group_slots, int window, int dtype,
    int chunk, int splits, float scale, long long qsb, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, void* stream) {
  if (B <= 0 || Hkv <= 0) return 0;
  // The splits cover every slot a row may see: S with per-row positions,
  // the batch's one visible run with an int t.
  const int reach = ts != nullptr ? S : visible(t, S, window);
  if (S <= 0 || group < 1 || group > group_slots || chunk <= 0 ||
      splits < 1 || static_cast<long long>(chunk) * splits < reach)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, ts, t, out, static_cast<float*>(part_acc),
                 static_cast<float*>(part_ml), B, S, Hkv, group, window,
                 chunk, splits, scale * tj::kLog2e, qsb, qsh,
                 CacheStrides{ksb, kss, ksh}, CacheStrides{vsb, vss, vsh}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tj::kBF16)
    return by_head_dim<__nv_bfloat16>(D, group_slots, p, s);
  if (dtype == tj::kF32) return by_head_dim<float>(D, group_slots, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
