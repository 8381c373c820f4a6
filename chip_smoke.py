#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (trainingjob_operator_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check raises, and the
script exits non-zero):

1. device: the card's name and power limit (the ``nvidia-smi`` line is
   printed as it is), then the build of every kernel under ``csrc/``
   (set-up time).
2. kernel_checks: each kernel against its plain PyTorch version on the
   card at the serving and training paths' full-width shapes, with the
   tolerance, the kernel's time, the plain version's time, the one-call
   PyTorch yardstick's time (timed only; the port never calls it) and the
   bound.  The flash forward's output (``FWD_TOL``) and the backward
   kernels' gradients (dQ, dK/dV, ``BWD_TOL``) are held to about one bf16
   step, an atol that is a fraction of the reference's RMS and a relative
   L2 limit; the backward must give bit-identical results on a second
   run.  RMSNorm is timed over a rotation of input copies twice the size
   of the card's L2, so that every call reads its input from device
   memory.
3. tiny_equivalence: the tiny config in fp32 through the kernels; every
   request of a DecodeService run must get exactly the tokens ``generate``
   gives for its prompt.
4. tiny_train_equivalence: the tiny config in fp32 trains 5 steps of the
   trainer's step (``llama_elastic.make_step_fn``: AdamW, accum 2), with
   remat "none" and "full", once through the kernels on
   the card and once through the plain versions on the CPU from the same
   parameters and tokens: losses agree to 1e-4 relative at every step,
   the first step's gradients (before any update) to rtol = atol = 1e-4.
   Launches per microbatch of a model of L layers: flash forward L (2 L
   under remat "full", whose backward re-runs each layer), dQ and dK/dV
   L, RMSNorm 2 L + 1 (4 L + 1 under "full").
5. serve_7b: DecodeService on a seeded random-init Llama-2-7B (bf16, all 32
   layers); zero stale-KV violations, every request finished, and RMSNorm
   launched 65 times per decode step and per prefill chunk.
6. generate_7b: a 512-token prompt and 32 greedy steps; the tensor-core
   flash forward is launched once per layer by the prefill.
7. train_7b_width: the trainer's step (``llama_elastic.make_step_fn``) at
   Llama-2-7B widths, 8 of its 32 layers (f32 masters and AdamW state for
   all 32 need about 108 GB), bf16 compute, seq 4096, global batch 2 with
   accum 2, remat "none": 8 steps on one repeated batch; losses finite
   and the last below the first; per step 16 launches each of the flash
   forward, dQ and dK/dV and 34 of RMSNorm (the formula of phase 4), every
   flash forward, dQ and dK/dV launch on the tensor-core kernels.

Then the ``kernels`` line, one entry per hand-written kernel: RMSNorm, and
the tensor-core (wgmma) and f32-FMA kernels of the flash forward, dQ and
dK/dV, with their launches on the paths driven (the 7B phases 5-7 run the
bf16 tensor-core kernels, the tiny fp32 phases 3-4 the f32-FMA ones) and,
last, ``{"ok": true, "device": {...}}``.  Exits non-zero
without printing a result when CUDA is unavailable or the package is not
beside this script.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time

#: Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

EPS = 1e-5
#: (rtol, atol) of the RMSNorm kernel vs its plain version on the card:
#: bf16 outputs may be one bf16 rounding apart; f32 differs only in
#: summation order.
OUT_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
#: (rtol, atol as a fraction of the reference's RMS) of the flash forward's
#: output against the plain forward, and beside it the relative L2 limit
#: FWD_L2_RTOL.  The f32-FMA kernel rounds its f32 sums once, to the input
#: dtype, as the plain version does: under bf16 the two may sit one bf16
#: step apart (at most 2^-7 relative), and the atol covers only entries
#: near 0.  An output entry is about sqrt(e / n) for n visible keys (0.026
#: at n = 4096), so an absolute 2e-2 would let a wrong late query tile pass.
#:
#: The tensor-core kernels ("bfloat16_wgmma": csrc/flash_fwd_wgmma.cu,
#: csrc/flash_bwd_dq_wgmma.cu, csrc/flash_bwd_dkv_wgmma.cu) also round P
#: (forward; dz in dQ; P and dz in dK/dV) to bf16 before the products that
#: take it, as FlashAttention-2/3 and SDPA's flash kernels do.  Rounding to
#: nearest bf16 leaves a relative
#: error uniform within half a step, 2^-8 .. 2^-9 of the value: over
#: mantissas spread evenly in log, an RMS of 2^-7 sqrt(0.541 / 12) = 1.7e-3.
#: Each output entry sums many such rounded terms with random signs, so it
#: carries an absolute error of about 1.7e-3 x the RMS of its row (the row's
#: scale, not the tensor's: under a causal mask an early row of O or dQ or
#: a first KV row of dK/dV is far above the tensor's RMS).  Hence:
#: - atol = 2e-2 x the RMS of each row (over D): the largest of 2^24
#:   Gaussian errors is about 5.8 sigma = 1e-2 x the row's RMS, doubled;
#: - rtol stays 1e-2: the final cast may still put the two one bf16 step
#:   apart;
#: - relative L2 5e-3: the 1.7e-3 of P's rounding and up to 1.7e-3 more
#:   from the two final casts, sqrt(2) x 1.7e-3 = 2.4e-3, doubled.
FWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4),
           "bfloat16_wgmma": (1e-2, 2e-2)}
FWD_L2_RTOL = {"bfloat16": 1e-3, "float32": 1e-5, "bfloat16_wgmma": 5e-3}
LSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-4}
#: Limits whose atol is a fraction of each row's RMS, not the tensor's.
ROW_ATOL = ("bfloat16_wgmma",)
#: (rtol, atol as a fraction of the reference's RMS) of the flash backward
#: kernels against the plain backward.  Both round f32 sums of the same
#: products, in another order, to the input dtype, so under bf16 they may
#: sit one bf16 step apart (at most 2^-7 relative); the atol only covers
#: entries near 0.  Beside it the whole tensor's relative L2 error is held
#: to BWD_L2_RTOL.
#: The tensor-core dQ and dK/dV kernels ("bfloat16_wgmma") round dz (dQ:
#: before dz . k) and p and dz (dK/dV: before p^T . dO and dz^T . q) to
#: bf16.  dQ sums its rounded dz . k terms over the keys as dK sums its
#: dz^T . q terms over the queries, each term carrying the same 1.7e-3
#: relative RMS error, so FWD_TOL's reasoning gives both the limits of the
#: tensor-core forward.
BWD_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4),
           "bfloat16_wgmma": FWD_TOL["bfloat16_wgmma"]}
BWD_L2_RTOL = {"bfloat16": 1e-3, "float32": 1e-5,
               "bfloat16_wgmma": FWD_L2_RTOL["bfloat16_wgmma"]}
#: Floor of dQ's atol, as a fraction of the tensor's RMS.  The first query
#: row of a causal head sees one key, so its dz = p (dp - delta) with delta
#: = p dp is 0 in exact arithmetic and, on both sides, the f32 noise of two
#: sums of the same products (an RMS near 2e-7, against 0.02-0.05 for the
#: next row).  A per-row atol would hold that noise to noise, so dQ's is
#: never below BWD_TOL["bfloat16"]'s atol, what a kernel whose only error is
#: the order of its f32 sums is held to.  Only such degenerate rows reach
#: the floor.  It floors a per-row atol only (ROW_ATOL, the tensor-core
#: route): a tensor-wide atol, as the f32-FMA route's 1e-4 x RMS, stays as
#: BWD_TOL gives it.
DQ_ATOL_FLOOR_RMS = BWD_TOL["bfloat16"][1]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so the host's launch cost is left
    out (eager calls of small kernels are bound by it; see
    ``eager_ms``)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int) -> float:
    """Time per call of ``iters`` eager calls between two CUDA events:
    the device time, or the host's issue time where that is longer."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_violation(got, want, rtol, atol) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 is within tolerance."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


#: (rows, dtype) of the RMSNorm checks, all at D = 4096 (Llama-2-7B): a
#: serve tick's 4 slots, 16 rows, a 2048-token prefill and the training
#: step's microbatch of 4096 tokens.
RMS_CASES = [(4, "bfloat16"), (4, "float32"), (16, "bfloat16"),
             (16, "float32"), (2048, "bfloat16"), (2048, "float32"),
             (4096, "bfloat16")]


def copies_for(nbytes: int, l2_bytes: int) -> int:
    """Copies of an input of ``nbytes`` that together hold twice the L2
    cache of ``l2_bytes``."""
    return max(2, math.ceil(2 * l2_bytes / nbytes))


def rotating(fn, xs):
    """``fn`` applied to the next of the inputs ``xs`` at each call."""
    turn = itertools.cycle(range(len(xs)))
    return lambda: fn(xs[next(turn)])


def check_rmsnorm(torch, F, fused):
    """The kernel against its plain version at RMS_CASES.  Every timed call
    (kernel, plain version, ``F.rms_norm``) takes the next of n copies of
    the input that together hold twice the L2 cache, so no call finds its
    input in L2; at least 200 (50 for the larger shapes) calls, and a
    whole number of turns of the rotation.  ``l2_ms`` and
    ``library_l2_ms`` replay one input, which stays in L2 where it fits,
    as a serve tick's freshly written hidden state does (and as earlier
    runs timed every case)."""
    cases = []
    dev = torch.device("cuda")
    l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
    gen = torch.Generator(device=dev).manual_seed(0)
    d = 4096
    for rows, dname in RMS_CASES:
        dtype = getattr(torch, dname)
        x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
        scale = 1.0 + 0.5 * torch.randn(d, generator=gen, device=dev)
        got = fused.rmsnorm_kernel(x, scale, EPS)
        want = fused.rmsnorm_reference(x, scale, EPS)
        torch.cuda.synchronize()
        rtol, atol = OUT_TOL[dname]
        err = float((got.float() - want.float()).abs().max())
        if max_violation(got, want, rtol, atol) > 0:
            raise AssertionError(f"rmsnorm [{rows}, {d}] {dname}: "
                                 f"max abs err {err} over tolerance")
        n_copies = copies_for(x.numel() * x.element_size(), l2_bytes)
        xs = x.expand(n_copies, rows, d).contiguous()
        base = 200 if rows < 2048 else 50
        iters = n_copies * math.ceil(base / n_copies)
        scale_x = scale.to(dtype)
        esize = x.element_size()
        t_bound, by = bound(2 * rows * d * esize + d * 4, 4 * rows * d,
                            "float32")

        def timed(fn, timer=time_ms):
            return timer(rotating(fn, xs), iters)
        cases.append({
            "shape": [rows, d], "dtype": dname,
            "plan": fused.rmsnorm_plan(rows, d, esize),
            "max_abs_err": err, "rtol": rtol, "atol": atol,
            "rotation": n_copies, "l2_bytes": l2_bytes, "iters": iters,
            "ms": timed(lambda a: fused.rmsnorm_kernel(a, scale, EPS)),
            "eager_ms": timed(lambda a: fused.rmsnorm_kernel(a, scale, EPS),
                              eager_ms),
            "plain_ms": timed(
                lambda a: fused.rmsnorm_reference(a, scale, EPS)),
            "library_ms": timed(lambda a: F.rms_norm(a, (d,), scale_x, EPS)),
            "l2_ms": time_ms(lambda: fused.rmsnorm_kernel(x, scale, EPS),
                             base),
            "library_l2_ms": time_ms(
                lambda: F.rms_norm(x, (d,), scale_x, EPS), base),
            "bound_ms": t_bound, "bound_by": by})
        del x, xs, got, want
        torch.cuda.empty_cache()
    return cases


def visible_pairs(T: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask leaves visible: the work that counts."""
    if not causal:
        return T * T
    if not window:
        return T * (T + 1) // 2
    return sum(min(i + 1, window) for i in range(T))


FLASH_CASES = [
    # (B, T, Hq, Hkv, D, causal, window, dtype)
    (1, 512, 32, 32, 128, True, 0, "bfloat16"),
    (1, 1000, 32, 32, 128, True, 0, "bfloat16"),
    (1, 2048, 32, 32, 128, True, 0, "bfloat16"),
    (1, 2048, 32, 8, 128, True, 0, "bfloat16"),
    (1, 2048, 32, 32, 128, True, 256, "bfloat16"),
    (1, 1000, 32, 32, 16, True, 0, "float32"),
    # The training path's microbatch (train_7b_width).
    (1, 4096, 32, 32, 128, True, 0, "bfloat16"),
    # base_124m's head dim.
    (4, 1024, 12, 12, 64, True, 0, "bfloat16"),
]
#: FLASH_CASES entry of the training path's attention shape.
TRAIN_FLASH_CASE = 6


#: FLASH_CASES entry that exercises the f32-FMA kernels.
FMA_FLASH_CASE = 5


def flash_iters(T: int) -> int:
    return 5 if T >= 4096 else 20 if T >= 1000 else 50


def rates(ops: float, ms: float, bound_ms: float) -> dict:
    """Achieved TFLOP/s and the share of the bound a kernel time reaches."""
    return {"tflops": ops / ms / 1e9, "bound_share": bound_ms / ms}


def launched(torch, fn, key: str, kernel: str):
    """Run ``fn`` once from zeroed counters; raise unless it launched the
    kernel ``key`` once, on the tensor-core route where ``kernel`` is
    "wgmma"."""
    from trainingjob_operator_tpu_torch import ops

    ops.reset_launch_counts()
    result = fn()
    counts = ops.launch_counts()
    tc = counts.get(f"{key}_wgmma", 0)
    if counts[key] != 1 or tc != (kernel == "wgmma"):
        raise AssertionError(f"{key}: launches {counts}, expected one "
                             f"{kernel} launch")
    return result


def check_flash(torch, F, flash):
    cases = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for B, T, H, Hkv, D, causal, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        scale = D ** -0.5
        kernel = flash.fwd_plan(q, k, v)["kernel"]
        out, lse = launched(torch, lambda: flash.flash_kernel_with_lse(
            q, k, v, causal=causal, scale=scale, window=window),
            "flash_attention_fwd", kernel)
        want, want_lse = flash.flash_reference_with_lse(
            q, k, v, causal=causal, scale=scale, window=window)
        torch.cuda.synchronize()
        out_err = fwd_check(torch, out, want, limits(dname, kernel))
        lse_err = float((lse - want_lse).abs().max())
        tag = f"flash B={B} T={T} H={H}/{Hkv} D={D} w={window} {dname}"
        if not out_err["ok"]:
            raise AssertionError(f"{tag}: out {out_err}")
        if lse_err > LSE_ATOL[dname] or not torch.isfinite(lse).all():
            raise AssertionError(f"{tag}: lse max abs err {lse_err}")
        iters = flash_iters(T)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = sdpa_fn(torch, F, T, H, Hkv, causal, window, scale)

        def library():
            return sdpa(qt, kt, vt)
        esize = q.element_size()
        bytes_moved = (2 * B * H * T * D + 2 * B * Hkv * T * D) * esize \
            + B * H * T * 4
        ops = 4 * B * H * D * visible_pairs(T, causal, window)
        t_bound, by = bound(bytes_moved, ops, dname)
        ms = time_ms(lambda: flash.flash_kernel_with_lse(
            q, k, v, causal=causal, scale=scale, window=window), iters)
        cases.append({
            "B": B, "T": T, "Hq": H, "Hkv": Hkv, "D": D, "causal": causal,
            "window": window, "dtype": dname, "kernel": kernel,
            "max_abs_err": out_err["max_abs_err"], "out": out_err,
            "lse_max_abs_err": lse_err, "lse_atol": LSE_ATOL[dname],
            "ms": ms, **rates(ops, ms, t_bound),
            "eager_ms": eager_ms(lambda: flash.flash_kernel_with_lse(
                q, k, v, causal=causal, scale=scale, window=window), iters),
            "plain_ms": time_ms(lambda: flash.flash_reference_with_lse(
                q, k, v, causal=causal, scale=scale, window=window),
                3),
            "library_ms": time_ms(library, iters),
            "bound_ms": t_bound, "bound_by": by})
        del q, k, v, out, lse, want, want_lse
        torch.cuda.empty_cache()
    return cases


def sdpa_fn(torch, F, T, H, Hkv, causal, window, scale):
    """The one-call PyTorch yardstick for a flash case: SDPA over [B, H, T,
    D] with the same mask (a boolean band for a window)."""
    mask = None
    if window:
        rows = torch.arange(T, device="cuda")[:, None]
        cols = torch.arange(T, device="cuda")[None, :]
        mask = (cols <= rows) & (cols > rows - window)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and not window,
            scale=scale, enable_gqa=H != Hkv)
    return sdpa


def limits(dname: str, kernel: str) -> str:
    """Key of the tolerance tables for a kernel route (``fwd_plan`` /
    ``dkv_plan``'s "fma" or "wgmma") and dtype."""
    return f"{dname}_wgmma" if kernel == "wgmma" else dname


def grad_check(torch, got, want, key, atol_floor_rms: float = 0.0) -> dict:
    """How far a backward kernel's gradient lies from the plain one, at
    BWD_TOL and BWD_L2_RTOL (dQ: with DQ_ATOL_FLOOR_RMS as
    ``atol_floor_rms``, which binds on the per-row limits only);
    ``tol_used`` > 1 or ``ok`` false fails."""
    return close_check(torch, got, want, *BWD_TOL[key], BWD_L2_RTOL[key],
                       per_row=key in ROW_ATOL,
                       atol_floor_rms=atol_floor_rms)


def fwd_check(torch, got, want, key) -> dict:
    """How far the flash forward's output lies from the plain one, at
    FWD_TOL and FWD_L2_RTOL (as ``grad_check``)."""
    return close_check(torch, got, want, *FWD_TOL[key], FWD_L2_RTOL[key],
                       per_row=key in ROW_ATOL)


def close_check(torch, got, want, rtol, atol_rms, l2_rtol,
                per_row: bool = False, atol_floor_rms: float = 0.0) -> dict:
    """|got - want| <= atol + rtol |want| elementwise, with atol =
    ``atol_rms`` x the RMS of ``want`` (where ``per_row``: of each row over
    the last dim, but at least ``atol_floor_rms`` x the tensor's RMS; the
    floor leaves a tensor-wide atol as it is), and the relative L2 error
    at most ``l2_rtol``.  Reports max|want|, the RMS, the share of the
    elementwise tolerance used and the L2 error; ``ok`` is the verdict."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    if per_row:
        atol = (atol_rms * w.square().mean(-1, keepdim=True).sqrt()
                ).clamp_min(atol_floor_rms * rms)
    else:
        atol, atol_floor_rms = atol_rms * rms, 0.0
    diff = (g - w).abs()
    rel_l2 = float((g - w).norm() / w.norm())
    # Where want is exactly 0 in a row of zeros, only an exact 0 passes.
    tol_used = float((diff / (atol + rtol * w.abs()).clamp_min(1e-30)).max())
    return {"max_abs_err": float(diff.max()),
            "want_max_abs": float(w.abs().max()), "want_rms": rms,
            "rtol": rtol, "atol_rms": atol_rms,
            "atol_rms_of": "row" if per_row else "tensor",
            "atol_floor_rms": atol_floor_rms,
            "tol_used": tol_used, "rel_l2_err": rel_l2,
            "rel_l2_rtol": l2_rtol,
            "ok": bool(torch.isfinite(g).all()) and tol_used <= 1.0
            and rel_l2 <= l2_rtol}


def check_flash_bwd(torch, F, flash):
    """dQ and dK/dV kernels against the plain backward at FLASH_CASES, from
    the forward kernel's out and LSE and a random dO, at BWD_TOL.  Bounds:
    dQ does 6 D flops per visible pair (z, dp, dq) and dK/dV 8 D (z, dp,
    dk, dv); each
    reads q, k, v, dO, lse and delta once and writes its gradients once.
    The library yardstick is SDPA's backward, dq, dk and dv in one call,
    isolated from its forward: the forward runs once, untimed, and its
    retained graph is differentiated again in each timed call (eager,
    between CUDA events)."""
    dq_cases, dkv_cases = [], []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, T, H, Hkv, D, causal, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(dtype)
        do = torch.randn(B, T, H, D, generator=gen, device=dev).to(dtype)
        opts = dict(causal=causal, scale=D ** -0.5, window=window)
        out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
        delta = flash.flash_delta(do, out)
        args = (q, k, v, do, lse, delta)
        kernel = flash.dkv_plan(q, k, v, do)["kernel"]
        dq_kernel = flash.dq_plan(q, k, v, do)["kernel"]
        dq = launched(torch, lambda: flash.flash_bwd_dq_kernel(*args, **opts),
                      "flash_attention_bwd_dq", dq_kernel)
        dk, dv = launched(
            torch, lambda: flash.flash_bwd_dkv_kernel(*args, **opts),
            "flash_attention_bwd_dkv", kernel)
        want_dq = flash.flash_bwd_dq_reference(*args, **opts)
        want_dk, want_dv = flash.flash_bwd_dkv_reference(*args, **opts)
        deterministic_dq = torch.equal(
            dq, flash.flash_bwd_dq_kernel(*args, **opts))
        deterministic_dkv = all(torch.equal(a, b) for a, b in zip(
            (dk, dv), flash.flash_bwd_dkv_kernel(*args, **opts)))
        torch.cuda.synchronize()
        tag = f"flash bwd B={B} T={T} H={H}/{Hkv} D={D} w={window} {dname}"
        errs = {}
        for name, got, want, key, floor in (
                ("dq", dq, want_dq, limits(dname, dq_kernel),
                 DQ_ATOL_FLOOR_RMS),
                ("dk", dk, want_dk, limits(dname, kernel), 0.0),
                ("dv", dv, want_dv, limits(dname, kernel), 0.0)):
            errs[name] = grad_check(torch, got, want, key, floor)
            if not errs[name]["ok"]:
                raise AssertionError(f"{tag}: {name} {errs[name]}")
        if not (deterministic_dq and deterministic_dkv):
            raise AssertionError(f"{tag}: a second run differs "
                                 f"(dq {deterministic_dq}, dk/dv "
                                 f"{deterministic_dkv})")
        iters = flash_iters(T)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                      for x in (q, k, v))
        lib_out = sdpa_fn(torch, F, T, H, Hkv, causal, window,
                          opts["scale"])(qt, kt, vt)
        lib_do = do.transpose(1, 2)
        library_ms = eager_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_do, retain_graph=True), iters)
        del lib_out
        esize = q.element_size()
        pairs = B * H * visible_pairs(T, causal, window)
        q_bytes = B * H * T * D * esize
        kv_bytes = B * Hkv * T * D * esize
        stat_bytes = 2 * B * H * T * 4
        common = {"B": B, "T": T, "Hq": H, "Hkv": Hkv, "D": D,
                  "causal": causal, "window": window, "dtype": dname,
                  "deterministic": True, "library_ms": library_ms}
        t_bound, by = bound(3 * q_bytes + 2 * kv_bytes + stat_bytes,
                            6 * D * pairs, dname)
        ms = time_ms(lambda: flash.flash_bwd_dq_kernel(*args, **opts), iters)
        dq_cases.append({
            **common, "kernel": dq_kernel,
            "max_abs_err": errs["dq"]["max_abs_err"], "dq": errs["dq"],
            "ms": ms, **rates(6 * D * pairs, ms, t_bound),
            "eager_ms": eager_ms(
                lambda: flash.flash_bwd_dq_kernel(*args, **opts), iters),
            "plain_ms": time_ms(
                lambda: flash.flash_bwd_dq_reference(*args, **opts), 3),
            "bound_ms": t_bound, "bound_by": by})
        t_bound, by = bound(2 * q_bytes + 4 * kv_bytes + stat_bytes,
                            8 * D * pairs, dname)
        ms = time_ms(lambda: flash.flash_bwd_dkv_kernel(*args, **opts),
                     iters)
        dkv_cases.append({
            **common, "kernel": kernel,
            "max_abs_err": max(errs["dk"]["max_abs_err"],
                               errs["dv"]["max_abs_err"]),
            "dk": errs["dk"], "dv": errs["dv"],
            "ms": ms, **rates(8 * D * pairs, ms, t_bound),
            "eager_ms": eager_ms(
                lambda: flash.flash_bwd_dkv_kernel(*args, **opts), iters),
            "plain_ms": time_ms(
                lambda: flash.flash_bwd_dkv_reference(*args, **opts), 3),
            "bound_ms": t_bound, "bound_by": by})
        del q, k, v, do, out, lse, delta, dq, dk, dv, want_dq, want_dk
        del want_dv, qt, kt, vt, lib_do
        torch.cuda.empty_cache()
    return dq_cases, dkv_cases


def train_launches(L: int, remat: str, micro_steps: int,
                   tensor_cores: bool = False):
    """Kernel launches of ``micro_steps`` microbatch steps of an L-layer
    model (phase 4's formula); with ``tensor_cores`` (bf16 at head dim 64
    or 128) every flash forward, dQ and dK/dV launch is a tensor-core
    one."""
    full = remat == "full"
    fwd = micro_steps * (2 if full else 1) * L
    return {"rmsnorm_fwd": micro_steps * ((4 if full else 2) * L + 1),
            "flash_attention_fwd": fwd,
            "flash_attention_bwd_dq": micro_steps * L,
            "flash_attention_bwd_dkv": micro_steps * L,
            "flash_attention_fwd_wgmma": fwd if tensor_cores else 0,
            "flash_attention_bwd_dq_wgmma":
                micro_steps * L if tensor_cores else 0,
            "flash_attention_bwd_dkv_wgmma":
                micro_steps * L if tensor_cores else 0}


def tiny_train_equivalence(torch, llama, llama_elastic, train):
    """fp32 tiny config, 5 steps of the trainer's step
    (``llama_elastic.make_step_fn``: accum 2, AdamW) through the kernels on
    the card and through the plain versions on the CPU."""
    from trainingjob_operator_tpu_torch import ops

    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    steps, accum = 5, 2
    init = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             master=True)
    batches = [torch.randint(0, cfg.vocab_size, (4, 65),
                             generator=torch.Generator().manual_seed(10 + i))
               for i in range(steps)]
    result = {}
    for remat in ("none", "full"):
        runs = {}
        for where in ("cpu", "cuda"):
            params = train.trainable_copy(init, where)
            step_fn = llama_elastic.make_step_fn(params, cfg, accum=accum,
                                                 lr=3e-4, remat=remat)
            ops.reset_launch_counts()
            losses, first_grads = [], None
            for i, tokens in enumerate(batches):
                losses.append(float(step_fn(tokens.to(where))))
                if i == 0:
                    # The step leaves its gradients in the leaves' .grad,
                    # and the AdamW update does not clear them.
                    first_grads = [p.grad.detach().cpu().clone()
                                   for p in train.tree_leaves(params)]
            runs[where] = (losses, first_grads, ops.launch_counts())
        (cpu_l, cpu_g, cpu_n), (gpu_l, gpu_g, gpu_n) = runs["cpu"], \
            runs["cuda"]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gpu_l, cpu_l))
        grad_viol = max(max_violation(a, b, 1e-4, 1e-4)
                        for a, b in zip(gpu_g, cpu_g))
        grad_err = max(float((a - b).abs().max())
                       for a, b in zip(gpu_g, cpu_g))
        expected = train_launches(cfg.n_layers, remat, steps * accum)
        if loss_rel > 1e-4 or not all(map(math.isfinite, gpu_l)):
            raise AssertionError(f"tiny train remat={remat}: losses "
                                 f"{gpu_l} vs {cpu_l}")
        if grad_viol > 0:
            raise AssertionError(f"tiny train remat={remat}: step-1 "
                                 f"gradients differ by {grad_err}")
        if gpu_n != expected or any(cpu_n.values()):
            raise AssertionError(f"tiny train remat={remat}: launches "
                                 f"{gpu_n} (cpu {cpu_n}), expected "
                                 f"{expected}")
        result[remat] = {"losses_cuda": gpu_l, "losses_cpu": cpu_l,
                         "loss_max_rel_err": loss_rel,
                         "grad_max_abs_err": grad_err, "launches": gpu_n}
    return {"steps": steps, "accum": accum, "loss_rtol": 1e-4,
            "grad_rtol": 1e-4, "grad_atol": 1e-4, **result}


def train_7b_width(torch, llama, llama_elastic):
    """The trainer's step at Llama-2-7B widths, 8 layers (see the module
    docstring)."""
    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.workloads import train

    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama.LlamaConfig.llama2_7b(), n_layers=8)
    seq, batch, accum, steps, lr = 4096, 2, 2, 8, 3e-4
    remat = train.default_remat(cfg.n_layers)
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev, master=True)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = llama_elastic.make_step_fn(params, cfg, accum=accum, lr=lr,
                                         remat=remat)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, step_s = [], []
    for _ in range(steps):
        t = time.perf_counter()
        losses.append(float(step_fn(tokens)))
        step_s.append(time.perf_counter() - t)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = train_launches(cfg.n_layers, remat, accum, tensor_cores=True)
    if counts != {k: n * steps for k, n in per_step.items()}:
        raise AssertionError(f"7B-width train: launches {counts}, expected "
                             f"{per_step} per step x {steps}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"7B-width train: losses {losses}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    return {"n_layers": cfg.n_layers, "n_params": llama.num_params(cfg),
            "seq": seq, "global_batch": batch, "accum": accum,
            "remat": remat, "lr": lr, "init_s": init_s, "losses": losses,
            "step_s": step_s, "step_s_median": steady,
            "tokens_per_s": batch * seq / steady,
            "peak_mem_gib": peak / 2 ** 30,
            "launches_per_step": per_step, "launches": counts,
            "step_profile": profile_steps(torch, lambda: step_fn(tokens),
                                          n=2)}


def tiny_equivalence(torch, llama, decode, serve):
    """fp32 tiny config through the kernels: serve == generate, per
    request."""
    from trainingjob_operator_tpu_torch import ops

    dev = torch.device("cuda")
    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    svc = serve.DecodeService(params, cfg, slots=3, prefill_chunk=4,
                              device=dev)
    traffic = serve.synthetic_traffic(12, seed=3, rate=1.5,
                                      vocab=cfg.vocab_size,
                                      prompt_lens=(3, 10),
                                      out_tokens=(2, 12))
    ops.reset_launch_counts()
    result = serve.run_traffic(svc, traffic)
    mismatched = 0
    for req in result["completed"]:
        want = decode.generate(params, torch.tensor([req.prompt],
                                                    device=dev), cfg,
                               steps=req.max_new_tokens)[0].tolist()
        mismatched += req.tokens != want
    counts = ops.launch_counts()
    stats = result["stats"]
    if len(result["completed"]) != 12 or mismatched:
        raise AssertionError(f"tiny fp32: {mismatched} of "
                             f"{len(result['completed'])} requests differ "
                             f"from generate")
    if stats["stale_kv_violations"]:
        raise AssertionError("tiny fp32: stale KV")
    if not (counts["rmsnorm_fwd"] and counts["flash_attention_fwd"]):
        raise AssertionError(f"tiny fp32 run skipped a kernel: {counts}")
    return {"requests": 12, "serve_equals_generate": True,
            "stale_kv_violations": 0, "launches": counts}


def serve_7b(torch, llama, serve, params, cfg):
    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.models import decode

    dev = torch.device("cuda")
    svc = serve.DecodeService(params, cfg, slots=4, max_len=1024,
                              prefill_chunk=16, device=dev)
    svc.warmup()
    traffic = serve.synthetic_traffic(8, seed=0, rate=0.5,
                                      vocab=cfg.vocab_size,
                                      prompt_lens=(16, 64),
                                      out_tokens=(16, 32))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    result = serve.run_traffic(svc, traffic)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    s = result["stats"]
    per_call = 2 * cfg.n_layers + 1
    expected = per_call * (svc.decode_calls + svc.prefill_calls)
    if s["stale_kv_violations"] != 0:
        raise AssertionError(f"7B serve: {s['stale_kv_violations']} stale-KV "
                             f"violations")
    if s["completed_total"] != len(traffic) or s["submitted"] != len(traffic):
        raise AssertionError(f"7B serve finished {s['completed_total']} of "
                             f"{len(traffic)} requests")
    if counts["rmsnorm_fwd"] != expected:
        raise AssertionError(f"7B serve: {counts['rmsnorm_fwd']} rmsnorm "
                             f"launches, expected {expected}")
    if counts["flash_attention_fwd"] != 0:
        raise AssertionError("7B serve launched the flash kernel")
    # A decode tick with every slot at a position inside the cache.
    tokens = torch.arange(1, len(svc.slots) + 1, device=dev)
    ts = torch.arange(len(svc.slots), device=dev) * 100 + 100
    tick = profile_steps(torch, lambda: decode.serve_step(
        svc.params, svc.cache, tokens, ts, cfg))
    return {
        "tick": tick,
        "requests": len(traffic), "completed": s["completed_total"],
        "stale_kv_violations": 0, "tokens_total": s["tokens_total"],
        "decode_steps": svc.decode_calls, "prefill_chunks": svc.prefill_calls,
        "wall_s": s["wall_s"],
        "tokens_per_s": s["aggregate_tokens_per_sec"],
        "ttft_ms_p50": s["ttft_ms_p50"],
        "token_latency_ms_p50": s["token_latency_ms_p50"],
        "token_latency_ms_p99": s["token_latency_ms_p99"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts}


def profile_steps(torch, step, n: int = 5):
    """Where one call of ``step`` spends its time: ``n`` calls timed on the
    host clock, then the same under ``torch.profiler`` for device time by
    kernel.  The idle share is 1 - device time / unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def steps():
        for _ in range(n):
            step()
        torch.cuda.synchronize()

    steps()
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps()
    # Device-side events only: the aten:: host events carry their
    # kernels' device time too and would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    return {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
        "kernels_per_step": sum(e.count for e in kernels) / n,
        "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3 / n,
                 "calls": e.count / n} for e in top]}


def generate_7b(torch, decode, params, cfg):
    from trainingjob_operator_tpu_torch import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                           device=dev)
    steps = 32

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode.generate(params, prompt, cfg, steps=n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    timed(1)                       # first call of this shape: warm-up
    _, prefill_s = timed(1)        # prefill + the first pick
    ops.reset_launch_counts()
    tokens, total_s = timed(steps)
    counts = ops.launch_counts()
    if not (counts["flash_attention_fwd"]
            == counts["flash_attention_fwd_wgmma"] == cfg.n_layers):
        raise AssertionError(f"7B generate: flash launches {counts}, "
                             f"expected {cfg.n_layers}, all on the tensor "
                             f"cores")
    if counts["rmsnorm_fwd"] != (2 * cfg.n_layers + 1) * steps:
        raise AssertionError(f"7B generate: {counts['rmsnorm_fwd']} rmsnorm "
                             f"launches")
    if tuple(tokens.shape) != (1, steps) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab_size)).all()):
        raise AssertionError(f"7B generate: bad tokens {tokens.tolist()}")
    again, _ = timed(steps)
    if not torch.equal(again, tokens):
        raise AssertionError("7B greedy generate is not deterministic")
    _, cache = decode.prefill(params, prompt, cfg, 512 + steps)
    last = tokens[:, -1]
    return {"prompt_len": 512, "steps": steps, "prefill_ms":
            prefill_s * 1e3, "total_ms": total_s * 1e3,
            "per_token_ms": (total_s - prefill_s) / (steps - 1) * 1e3,
            "launches": counts,
            "prefill_profile": profile_steps(
                torch, lambda: decode.prefill(params, prompt, cfg,
                                              512 + steps), n=3),
            "decode_step_profile": profile_steps(
                torch, lambda: decode.decode_step(params, cache, last, 512,
                                                  cfg))}


def summary(name, route, source, replaces, cases, main_case, launches):
    row = dict(main_case)
    return {
        "name": name, "route": route, "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "main_case": {k: v for k, v in row.items()
                      if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
        "cases": cases}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from trainingjob_operator_tpu_torch import ops
    from trainingjob_operator_tpu_torch.models import decode, llama
    from trainingjob_operator_tpu_torch.ops import _build, fused
    from trainingjob_operator_tpu_torch.workloads import (
        llama_elastic,
        serve,
        train,
    )

    flash = sys.modules["trainingjob_operator_tpu_torch.ops.flash_attention"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [line.strip() for line in
             (_build.BUILD_DIR / f"{_build.source_tag()}.log").read_text()
             .splitlines() if "registers" in line or "Compiling entry" in
             line or "spill" in line]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "library": lib_path.name, "ptxas": ptxas})

    rms_cases = check_rmsnorm(torch, F, fused)
    flash_cases = check_flash(torch, F, flash)
    dq_cases, dkv_cases = check_flash_bwd(torch, F, flash)
    emit({"phase": "kernel_checks", "device": name, "nvidia_smi": smi,
          "rmsnorm_fwd": rms_cases, "flash_attention_fwd": flash_cases,
          "flash_attention_bwd_dq": dq_cases,
          "flash_attention_bwd_dkv": dkv_cases})

    tiny = tiny_equivalence(torch, llama, decode, serve)
    emit({"phase": "tiny_equivalence", **tiny})
    tiny_train = tiny_train_equivalence(torch, llama, llama_elastic, train)
    emit({"phase": "tiny_train_equivalence", **tiny_train})

    cfg = llama.LlamaConfig.llama2_7b()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    served = serve_7b(torch, llama, serve, params, cfg)
    emit({"phase": "serve_7b", "device": name, "nvidia_smi": smi,
          "init_s": init_s, "n_params": llama.num_params(cfg), **served})
    generated = generate_7b(torch, decode, params, cfg)
    emit({"phase": "generate_7b", "device": name, "nvidia_smi": smi,
          **generated})
    del params
    torch.cuda.empty_cache()
    trained = train_7b_width(torch, llama, llama_elastic)
    emit({"phase": "train_7b_width", "device": name, "nvidia_smi": smi,
          **trained})

    # Launches on every path driven (each from zeroed counters): the 7B
    # paths run the bf16 tensor-core kernels, the tiny fp32 ones the
    # f32-FMA kernels.
    paths = [served, generated, trained, tiny, tiny_train["none"],
             tiny_train["full"]]
    launches = {k: sum(p["launches"][k] for p in paths)
                for k in ops.launch_counts()}
    fma = {key: launches[key] - launches[f"{key}_wgmma"]
           for key in ("flash_attention_fwd", "flash_attention_bwd_dq",
                       "flash_attention_bwd_dkv")}
    src = "trainingjob_operator_tpu_torch/csrc/"
    tpu = "trainingjob_operator_tpu/ops/"

    def of(cases, kernel):
        return [c for c in cases if c["kernel"] == kernel]
    emit({"kernels": [
        summary("rmsnorm_fwd", "cuda", src + "rmsnorm.cu",
                tpu + "fused.py:18", rms_cases, rms_cases[0],
                launches["rmsnorm_fwd"]),
        summary("flash_attention_fwd_wgmma", "cuda",
                src + "flash_fwd_wgmma.cu", tpu + "flash_attention.py:40",
                of(flash_cases, "wgmma"), flash_cases[TRAIN_FLASH_CASE],
                launches["flash_attention_fwd_wgmma"]),
        summary("flash_attention_fwd_fma", "cuda", src + "flash_fwd.cu",
                tpu + "flash_attention.py:40", of(flash_cases, "fma"),
                flash_cases[FMA_FLASH_CASE], fma["flash_attention_fwd"]),
        summary("flash_attention_bwd_dq_wgmma", "cuda",
                src + "flash_bwd_dq_wgmma.cu",
                tpu + "flash_attention.py:170", of(dq_cases, "wgmma"),
                dq_cases[TRAIN_FLASH_CASE],
                launches["flash_attention_bwd_dq_wgmma"]),
        summary("flash_attention_bwd_dq_fma", "cuda", src + "flash_bwd.cu",
                tpu + "flash_attention.py:170", of(dq_cases, "fma"),
                dq_cases[FMA_FLASH_CASE], fma["flash_attention_bwd_dq"]),
        summary("flash_attention_bwd_dkv_wgmma", "cuda",
                src + "flash_bwd_dkv_wgmma.cu",
                tpu + "flash_attention.py:219", of(dkv_cases, "wgmma"),
                dkv_cases[TRAIN_FLASH_CASE],
                launches["flash_attention_bwd_dkv_wgmma"]),
        summary("flash_attention_bwd_dkv_fma", "cuda", src + "flash_bwd.cu",
                tpu + "flash_attention.py:219", of(dkv_cases, "fma"),
                dkv_cases[FMA_FLASH_CASE], fma["flash_attention_bwd_dkv"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
