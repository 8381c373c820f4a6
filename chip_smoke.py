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
   card at the serving path's full-width shapes, with the tolerance, the
   kernel's time, the plain version's time, the one-call PyTorch
   yardstick's time (timed only; the port never calls it) and the bound.
3. tiny_equivalence: the tiny config in fp32 through the kernels; every
   request of a DecodeService run must get exactly the tokens ``generate``
   gives for its prompt.
4. serve_7b: DecodeService on a seeded random-init Llama-2-7B (bf16, all 32
   layers); zero stale-KV violations, every request finished, and RMSNorm
   launched 65 times per decode step and per prefill chunk.
5. generate_7b: a 512-token prompt and 32 greedy steps; the flash kernel is
   launched once per layer by the prefill.

Then the ``kernels`` line (launch counts from phases 4 and 5, the main
path) and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero
without printing a result when CUDA is unavailable or the package is not
beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

#: Published H100 SXM peaks (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

EPS = 1e-5
#: (rtol, atol) of kernel vs plain version on the card: bf16 outputs may be
#: one bf16 rounding apart; f32 differs only in summation order.
OUT_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (1e-4, 1e-4)}
LSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-4}


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


def check_rmsnorm(torch, F, fused):
    cases = []
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows in (4, 16, 2048):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            d = 4096
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
            iters = 200 if rows < 2048 else 50
            scale_x = scale.to(dtype)
            esize = x.element_size()
            t_bound, by = bound(2 * rows * d * esize + d * 4, 4 * rows * d,
                                "float32")
            cases.append({
                "shape": [rows, d], "dtype": dname,
                "max_abs_err": err, "rtol": rtol, "atol": atol,
                "ms": time_ms(lambda: fused.rmsnorm_kernel(x, scale, EPS),
                              iters),
                "eager_ms": eager_ms(
                    lambda: fused.rmsnorm_kernel(x, scale, EPS), iters),
                "plain_ms": time_ms(
                    lambda: fused.rmsnorm_reference(x, scale, EPS), iters),
                "library_ms": time_ms(
                    lambda: F.rms_norm(x, (d,), scale_x, EPS), iters),
                "bound_ms": t_bound, "bound_by": by})
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
]


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
        out, lse = flash.flash_kernel_with_lse(q, k, v, causal=causal,
                                               scale=scale, window=window)
        want, want_lse = flash.flash_reference_with_lse(
            q, k, v, causal=causal, scale=scale, window=window)
        torch.cuda.synchronize()
        rtol, atol = OUT_TOL[dname]
        err = float((out.float() - want.float()).abs().max())
        lse_err = float((lse - want_lse).abs().max())
        tag = f"flash B={B} T={T} H={H}/{Hkv} D={D} w={window} {dname}"
        if max_violation(out, want, rtol, atol) > 0:
            raise AssertionError(f"{tag}: out max abs err {err}")
        if lse_err > LSE_ATOL[dname] or not torch.isfinite(lse).all():
            raise AssertionError(f"{tag}: lse max abs err {lse_err}")
        iters = 20 if T >= 1000 else 50
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window:
            rows = torch.arange(T, device=dev)[:, None]
            cols = torch.arange(T, device=dev)[None, :]
            band = (cols <= rows) & (cols > rows - window)

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, scale=scale,
                    enable_gqa=H != Hkv)
        else:
            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=H != Hkv)
        esize = q.element_size()
        bytes_moved = (2 * B * H * T * D + 2 * B * Hkv * T * D) * esize \
            + B * H * T * 4
        ops = 4 * B * H * D * visible_pairs(T, causal, window)
        t_bound, by = bound(bytes_moved, ops, dname)
        cases.append({
            "B": B, "T": T, "Hq": H, "Hkv": Hkv, "D": D, "causal": causal,
            "window": window, "dtype": dname, "max_abs_err": err,
            "lse_max_abs_err": lse_err, "rtol": rtol, "atol": atol,
            "lse_atol": LSE_ATOL[dname],
            "ms": time_ms(lambda: flash.flash_kernel_with_lse(
                q, k, v, causal=causal, scale=scale, window=window), iters),
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
    if min(counts.values()) == 0:
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
    if counts["flash_attention_fwd"] != cfg.n_layers:
        raise AssertionError(f"7B generate: {counts['flash_attention_fwd']} "
                             f"flash launches, expected {cfg.n_layers}")
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
    from trainingjob_operator_tpu_torch.workloads import serve

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
             line]
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "library": lib_path.name, "ptxas": ptxas})

    rms_cases = check_rmsnorm(torch, F, fused)
    flash_cases = check_flash(torch, F, flash)
    emit({"phase": "kernel_checks", "device": name, "nvidia_smi": smi,
          "rmsnorm_fwd": rms_cases, "flash_attention_fwd": flash_cases})

    emit({"phase": "tiny_equivalence",
          **tiny_equivalence(torch, llama, decode, serve)})

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

    launches = {k: served["launches"][k] + generated["launches"][k]
                for k in ops.launch_counts()}
    emit({"kernels": [
        summary("rmsnorm_fwd", "cuda",
                "trainingjob_operator_tpu_torch/csrc/rmsnorm.cu",
                "trainingjob_operator_tpu/ops/fused.py:18", rms_cases,
                rms_cases[0], launches["rmsnorm_fwd"]),
        summary("flash_attention_fwd", "cuda",
                "trainingjob_operator_tpu_torch/csrc/flash_fwd.cu",
                "trainingjob_operator_tpu/ops/flash_attention.py:40",
                flash_cases, flash_cases[0],
                launches["flash_attention_fwd"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
