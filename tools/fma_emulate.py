"""The f32-FMA flash kernels' CUDA source, run on the CPU.

    python3 -m tools.fma_emulate [--list] [case ...]

Needs g++ (C++20), no card and no ``nvcc``.  The script copies
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu``, cut before their launch
code, beside stand-ins for the CUDA headers and a ``csrc/fma_tile.cuh``
whose ``cp.async`` copies are queued per thread and carried out at
``cp.async.wait_group`` (a missing wait reads stale shared memory) and
whose ``ex2`` is ``exp2f``.  A harness runs each CTA of the grid as one
``std::thread`` a CUDA thread: ``__syncthreads`` and ``__syncwarp`` are
barriers, ``__shfl_xor_sync`` goes through a per-warp exchange, and shared
memory is filled with NaN before each CTA.  A case (kernel, dtype, head
dim, B, T, Hq, Hkv, causal, window) runs the kernel on seeded inputs and
holds its output against a double-precision reference: float32 within
1e-4 of the tensor's RMS plus 1e-4 relative, bf16 within 1e-3 of the RMS
plus 1e-2 relative (``chip_smoke.BWD_TOL``'s limits).  It shows indexing,
masking, staging and tile-order faults; it cannot show timing, register
spills, what the CUDA compiler refuses, or a race whose outcome depends on
how a card interleaves warps.  ``tests/test_torch_fma_emulation.py`` runs
every case.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "trainingjob_operator_tpu_torch" \
    / "csrc"

#: (kernel, dtype, D, B, T, Hq, Hkv, causal, window): every head dim and
#: both dtypes of the f32-FMA route, ragged T, GQA, a window and unmasked.
CASES = [
    ("fwd", "f32", 16, 1, 70, 4, 2, 1, 0),
    ("fwd", "f32", 64, 1, 130, 4, 2, 1, 40),
    ("fwd", "f32", 128, 1, 70, 2, 1, 0, 0),
    ("fwd", "bf16", 32, 1, 100, 2, 2, 1, 0),
    ("dq", "f32", 16, 2, 130, 2, 1, 1, 8),
    ("dq", "f32", 32, 1, 100, 2, 1, 1, 40),
    ("dq", "f32", 64, 1, 130, 4, 2, 1, 0),
    ("dq", "f32", 64, 1, 200, 2, 2, 1, 70),
    ("dq", "f32", 64, 1, 70, 2, 1, 0, 0),
    ("dq", "f32", 128, 1, 130, 4, 1, 1, 0),
    ("dq", "f32", 128, 1, 150, 2, 2, 1, 40),
    ("dq", "bf16", 16, 1, 100, 4, 2, 1, 0),
    ("dq", "bf16", 32, 1, 130, 2, 2, 1, 16),
    ("dkv", "f32", 16, 1, 70, 4, 2, 1, 0),
    ("dkv", "f32", 64, 1, 130, 4, 2, 1, 0),
    ("dkv", "f32", 128, 1, 150, 2, 2, 1, 40),
    ("dkv", "bf16", 32, 1, 130, 2, 2, 1, 16),
]

_RUNTIME_H = r"""#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n) alignas(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct uint2 { unsigned x, y; };
struct emu_uint3 { unsigned x = 0, y = 0, z = 0; };
extern thread_local emu_uint3 threadIdx, blockIdx;
using std::max;
using std::min;
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum {
  cudaFuncAttributePreferredSharedMemoryCarveout,
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaSharedmemCarveoutMaxShared
};
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
void __syncthreads();
void __syncwarp(unsigned mask = 0xffffffffu);
float __shfl_xor_sync(unsigned mask, float v, int lane_mask);
inline unsigned __cvta_generic_to_shared(const void*) { return 0; }
extern unsigned char* emu_smem;
void emu_copy(void* dst, const void* src, int bytes);
void emu_commit();
void emu_wait(int n);
"""

_BF16_H = r"""#pragma once
#include "cuda_runtime.h"
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float(unsigned(h.x) << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
"""

_HARNESS = r"""#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <memory>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "flash_fwd.cu"
#include "flash_bwd.cu"

thread_local emu_uint3 threadIdx, blockIdx;
unsigned char* emu_smem;

namespace {

struct Warp {
  std::barrier<> bar{32};
  float slot[32];
};
std::barrier<>* block_bar;
std::vector<std::unique_ptr<Warp>> warps;
struct Copy {
  void* dst;
  const void* src;
  int bytes;
};
thread_local std::vector<std::vector<Copy>> groups;
thread_local std::vector<Copy> open_group;

}  // namespace

void __syncthreads() { block_bar->arrive_and_wait(); }
void __syncwarp(unsigned) { warps[threadIdx.x / 32]->bar.arrive_and_wait(); }
float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  Warp& w = *warps[threadIdx.x / 32];
  const int lane = threadIdx.x % 32;
  w.slot[lane] = v;
  w.bar.arrive_and_wait();
  const float got = w.slot[lane ^ lane_mask];
  w.bar.arrive_and_wait();
  return got;
}
void emu_copy(void* dst, const void* src, int bytes) {
  if (reinterpret_cast<uintptr_t>(dst) % bytes) {
    std::printf("cp.async destination not %d-byte aligned\n", bytes);
    std::exit(2);
  }
  open_group.push_back({dst, src, bytes});
}
void emu_commit() {
  groups.push_back(open_group);
  open_group.clear();
}
void emu_wait(int n) {
  while (static_cast<int>(groups.size()) > n) {
    for (const Copy& c : groups.front()) {
      if (c.src)
        std::memcpy(c.dst, c.src, c.bytes);
      else
        std::memset(c.dst, 0, c.bytes);
    }
    groups.erase(groups.begin());
  }
}

namespace {

template <typename F>
void run_grid(unsigned gx, unsigned gy, int nt, size_t smem, F kernel) {
  std::vector<float> buf(smem / 4 + 16);
  emu_smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(buf.data()) + 15) & ~uintptr_t(15));
  for (unsigned by = 0; by < gy; ++by)
    for (unsigned bx = 0; bx < gx; ++bx) {
      std::fill(buf.begin(), buf.end(), NAN);
      std::barrier<> bar(nt);
      block_bar = &bar;
      warps.clear();
      for (int w = 0; w < nt / 32; ++w) warps.emplace_back(new Warp);
      std::vector<std::thread> threads;
      for (int t = 0; t < nt; ++t)
        threads.emplace_back([&, t] {
          threadIdx.x = t;
          blockIdx.x = bx;
          blockIdx.y = by;
          groups.clear();
          open_group.clear();
          kernel();
        });
      for (auto& th : threads) th.join();
    }
}

float to_float(float x) { return x; }
float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
T from_float(float x);
template <>
float from_float<float>(float x) { return x; }
template <>
__nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Case {
  std::string kernel;
  int B, T, H, Hkv, causal, window;
};

// Max over elements of |got - want| / (atol + rtol |want|), atol a share of
// want's RMS; <= 1 passes.  NaN or inf gives +inf.
template <typename T>
double tol_used(const std::vector<T>& got, const std::vector<double>& want,
                double atol_rms, double rtol) {
  double ss = 0;
  for (double w : want) ss += w * w;
  const double atol = atol_rms * std::sqrt(ss / want.size());
  double worst = 0;
  for (size_t i = 0; i < want.size(); ++i) {
    const double g = to_float(got[i]);
    if (!std::isfinite(g)) return INFINITY;
    worst = std::max(worst, std::abs(g - want[i]) /
                                (atol + rtol * std::abs(want[i]) + 1e-300));
  }
  return worst;
}

template <typename T, int D>
double run_case(const Case& c) {
  const int B = c.B, Tl = c.T, H = c.H, Hkv = c.Hkv, group = H / Hkv;
  std::mt19937 gen(1234);
  std::normal_distribution<float> normal;
  auto make = [&](int heads) {
    std::vector<T> x(size_t(B) * Tl * heads * D);
    for (auto& e : x) e = from_float<T>(normal(gen));
    return x;
  };
  auto q = make(H), k = make(Hkv), v = make(Hkv), g = make(H);
  const float scale = 1.0f / std::sqrt(float(D));
  auto at = [&](int b, int t, int h, int heads) {
    return ((size_t(b) * Tl + t) * heads + h) * D;
  };
  auto seen = [&](int r, int col) {
    return !c.causal || (col <= r && (!c.window || col > r - c.window));
  };
  auto dot = [&](const std::vector<T>& x, size_t i, const std::vector<T>& y,
                 size_t j) {
    double s = 0;
    for (int d = 0; d < D; ++d)
      s += double(to_float(x[i + d])) * to_float(y[j + d]);
    return s;
  };
  // Reference: out, lse and delta, then dq, dk and dv.
  const size_t rows = size_t(B) * H * Tl;
  std::vector<double> out(q.size()), lse_ref(rows);
  std::vector<float> lse(rows), delta(rows);
  std::vector<double> dq(q.size()), dk(k.size()), dv(v.size());
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h)
      for (int r = 0; r < Tl; ++r) {
        const int hk = h / group;
        double m = -INFINITY, l = 0;
        for (int col = 0; col < Tl; ++col)
          if (seen(r, col))
            m = std::max(m, dot(q, at(b, r, h, H), k, at(b, col, hk, Hkv)) *
                                scale);
        for (int col = 0; col < Tl; ++col)
          if (seen(r, col))
            l += std::exp(dot(q, at(b, r, h, H), k, at(b, col, hk, Hkv)) *
                              scale - m);
        const double L = m + std::log(l);
        for (int col = 0; col < Tl; ++col)
          if (seen(r, col)) {
            const double p = std::exp(
                dot(q, at(b, r, h, H), k, at(b, col, hk, Hkv)) * scale - L);
            for (int d = 0; d < D; ++d)
              out[at(b, r, h, H) + d] += p * to_float(v[at(b, col, hk, Hkv) + d]);
          }
        double dl = 0;
        for (int d = 0; d < D; ++d)
          dl += out[at(b, r, h, H) + d] * to_float(g[at(b, r, h, H) + d]);
        const size_t row = (size_t(b) * H + h) * Tl + r;
        lse_ref[row] = L;
        lse[row] = float(L);
        delta[row] = float(dl);
      }
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h)
      for (int r = 0; r < Tl; ++r) {
        const int hk = h / group;
        const size_t row = (size_t(b) * H + h) * Tl + r;
        for (int col = 0; col < Tl; ++col) {
          if (!seen(r, col)) continue;
          const size_t iq = at(b, r, h, H), ik = at(b, col, hk, Hkv);
          const double p = std::exp(dot(q, iq, k, ik) * scale - lse[row]);
          const double dz = p * (dot(g, iq, v, ik) - delta[row]) * scale;
          for (int d = 0; d < D; ++d) {
            dq[iq + d] += dz * to_float(k[ik + d]);
            dk[ik + d] += dz * to_float(q[iq + d]);
            dv[ik + d] += p * to_float(g[iq + d]);
          }
        }
      }
  const tj::Strides sq{(long long)Tl * H * D, (long long)H * D, D, 1};
  const tj::Strides sk{(long long)Tl * Hkv * D, (long long)Hkv * D, D, 1};
  const bool f32 = sizeof(T) == 4;
  const double atol = f32 ? 1e-4 : 1e-3, rtol = f32 ? 1e-4 : 1e-2;
  if (c.kernel == "fwd") {
    using S = FwdShape<D>;
    std::vector<T> o(q.size(), from_float<T>(NAN));
    std::vector<float> l(rows, NAN);
    run_grid(B * H, (Tl + S::BQ - 1) / S::BQ, S::NT, fwd_smem_bytes<T, D>(),
             [&] {
               flash_fwd_kernel<T, D>(q.data(), k.data(), v.data(), o.data(),
                                      l.data(), H, Hkv, Tl, sq, sk, sk, sq,
                                      scale, c.causal, c.window);
             });
    double lse_err = 0;
    for (size_t i = 0; i < rows; ++i)
      lse_err = std::max(lse_err, std::abs(l[i] - lse_ref[i]) / 1e-4);
    if (!(lse_err <= 1)) return INFINITY;
    return tol_used(o, out, atol, rtol);
  }
  if (c.kernel == "dq") {
    using S = DqShape<D>;
    std::vector<T> got(q.size(), from_float<T>(NAN));
    run_grid(B * H, (Tl + S::BQ - 1) / S::BQ, S::NT, dq_smem_bytes<T, D>(),
             [&] {
               flash_bwd_dq_kernel<T, D>(
                   q.data(), k.data(), v.data(), g.data(), lse.data(),
                   delta.data(), got.data(), H, Hkv, Tl, sq, sk, sk, sq, sq,
                   scale, c.causal, c.window);
             });
    return tol_used(got, dq, atol, rtol);
  }
  using S = DkvShape<D>;
  std::vector<T> gk(k.size(), from_float<T>(NAN));
  std::vector<T> gv(v.size(), from_float<T>(NAN));
  run_grid(B * Hkv, (Tl + S::BK - 1) / S::BK, S::NT, dkv_smem_bytes<T, D>(),
           [&] {
             flash_bwd_dkv_kernel<T, D>(
                 q.data(), k.data(), v.data(), g.data(), lse.data(),
                 delta.data(), gk.data(), gv.data(), H, Hkv, Tl, sq, sk, sk,
                 sq, sk, sk, scale, c.causal, c.window);
           });
  return std::max(tol_used(gk, dk, atol, rtol), tol_used(gv, dv, atol, rtol));
}

}  // namespace

// argv: kernel (fwd, dq, dkv), dtype (f32, bf16), D, B, T, Hq, Hkv,
// causal, window.  Prints the share of the tolerance used; exits 0 when it
// is at most 1.
int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const std::string dtype = argv[2];
  const int D = std::atoi(argv[3]);
  const Case c{argv[1], std::atoi(argv[4]), std::atoi(argv[5]),
               std::atoi(argv[6]), std::atoi(argv[7]), std::atoi(argv[8]),
               std::atoi(argv[9])};
  double used = -1;
  if (dtype == "f32") {
    if (D == 16) used = run_case<float, 16>(c);
    if (D == 32) used = run_case<float, 32>(c);
    if (D == 64) used = run_case<float, 64>(c);
    if (D == 128) used = run_case<float, 128>(c);
  } else if (dtype == "bf16") {
    if (D == 16) used = run_case<__nv_bfloat16, 16>(c);
    if (D == 32) used = run_case<__nv_bfloat16, 32>(c);
  }
  if (used < 0) return 2;
  std::printf("tol_used %.6g\n", used);
  return used <= 1.0 ? 0 : 1;
}
"""

#: fma_tile.cuh functions whose bodies become the emulation's: signature
#: pattern -> new body.
_PATCHES = {
    r"void cp_chunk\(float\* dst": "emu_copy(dst, pred ? src : nullptr, 16);",
    r"void cp_chunk\(__nv_bfloat16\* dst":
        "emu_copy(dst, pred ? src : nullptr, 8);",
    r"void cp_f32\(float\* dst": "emu_copy(dst, pred ? src : nullptr, 4);",
    r"void cp_commit\(\)": "emu_commit();",
    r"void cp_wait\(\)": "emu_wait(N);",
    r"float ex2\(float x\)": "return exp2f(x);",
}
#: Where each kernel source's launch code starts: the copy stops there.
_CUTS = {"flash_fwd.cu": "template <typename T, int D>\nint launch(",
         "flash_bwd.cu": "struct Args {"}
_SMEM_DECL = "extern __shared__ __align__(16) unsigned char smem_raw[];"


def write_sources(work: Path, csrc: Path = CSRC) -> None:
    """The emulation's sources in ``work``: header stand-ins, the patched
    ``fma_tile.cuh``, the kernel sources cut before their launch code, and
    the harness ``emulate.cpp``."""
    (work / "inc").mkdir(parents=True, exist_ok=True)
    (work / "inc" / "cuda_runtime.h").write_text(_RUNTIME_H)
    (work / "inc" / "cuda_bf16.h").write_text(_BF16_H)
    shutil.copy(csrc / "common.cuh", work / "common.cuh")
    tile = (csrc / "fma_tile.cuh").read_text()
    for signature, body in _PATCHES.items():
        tile, n = re.subn(r"(" + signature + r"[^{]*)\{[^{}]*\}",
                          lambda m, b=body: m.group(1) + "{ " + b + " }",
                          tile, count=1)
        if n != 1:
            raise ValueError(f"fma_tile.cuh: no function {signature!r}")
    (work / "fma_tile.cuh").write_text(tile)
    for name, cut in _CUTS.items():
        text = (csrc / name).read_text()
        if cut not in text or _SMEM_DECL not in text:
            raise ValueError(f"{name}: launch code or shared memory not found")
        text = text[:text.index(cut)] + "}  // namespace\n"
        text = text.replace(_SMEM_DECL, "unsigned char* smem_raw = emu_smem;")
        (work / name).write_text(text)
    (work / "emulate.cpp").write_text(_HARNESS)


def build(work: Path, csrc: Path = CSRC) -> Path:
    """Write the sources into ``work`` and compile the harness; its path."""
    write_sources(work, csrc)
    binary = work / "emulate"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-w",
                    "-I", str(work / "inc"), "-o", str(binary),
                    str(work / "emulate.cpp")],
                   check=True, capture_output=True, text=True)
    return binary


def run_case(binary: Path, case) -> subprocess.CompletedProcess:
    """One case through the compiled harness (exit 0: within tolerance)."""
    return subprocess.run([str(binary), *map(str, case)],
                          capture_output=True, text=True, timeout=300)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cases", nargs="*", type=int,
                        help="indices into CASES (default: all)")
    parser.add_argument("--list", action="store_true",
                        help="print CASES with their indices")
    args = parser.parse_args(argv)
    if args.list:
        for i, case in enumerate(CASES):
            print(i, *case)
        return 0
    if not shutil.which("g++"):
        print("fma_emulate: g++ not found", file=sys.stderr)
        return 2
    work = Path(tempfile.mkdtemp(prefix="fma_emulate_"))
    try:
        binary = build(work)
        failed = 0
        for i in args.cases or range(len(CASES)):
            done = run_case(binary, CASES[i])
            failed += done.returncode != 0
            print(i, *CASES[i], done.stdout.strip() or done.stderr.strip(),
                  "ok" if done.returncode == 0 else "FAIL", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
