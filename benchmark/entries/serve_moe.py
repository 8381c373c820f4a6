"""Serving cells of a routed model: ``serve.DecodeService(family="moe")``
under the same open loop, window, stamping, trace and reference as
``entries/serve.py``, whose pieces it takes.

What differs from the dense entry: the profiled stretch also records the
program's ``moe.route`` and ``moe.experts`` ranges; the decode step's
weight bytes count every expert of every layer (``flops_moe``); and the
deltas of the program's ``moe_decode_*`` counters over the traced ticks
are handed to the readers; and ``correct`` holds the served tokens' mean
logit gap below the f32 reference's best (``mean_served_gap``) to its
limit, where the dense entry holds the widest.  A program without those
ranges or counters runs the cell all the same: their readers then find
nothing.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

from benchmark import compare, devtrace, flops_moe, weights
from benchmark.entries import port
from benchmark.entries.serve import (
    RANGES as DENSE_RANGES,
    TAIL_S,
    WARM_TICKS,
    Record,
    _Ranged,
    sample,
)
from benchmark.generators.serve_open_loop import arrivals
from benchmark.harness import Bench, Observed, quantile
from benchmark.reference import decoder as ref_decoder
from benchmark.reference.serve import served_logits

RANGES = DENSE_RANGES + ("moe.route", "moe.experts")
#: The program's counters whose deltas over the traced ticks the readers
#: read.
COUNTERS = ("moe_decode_pairs", "moe_decode_experts_reached")


def mean_served_gap(logits: Sequence[torch.Tensor],
                    served: Sequence[Sequence[int]]) -> float:
    """The mean, over every served token, of the gap between the
    reference's best logit and the served token's at the position that
    predicted it (``compare.served_gap`` takes the widest instead).

    A routed model's widest gap is set by the few positions where bf16
    rounding moves a token across a near-tie of its router, so that the
    program and the reference run different experts there; the mean
    counts each such position once among some 500, while a lower
    precision moves every position."""
    total, n = 0.0, 0
    for lg, toks in zip(logits, served):
        ids = torch.tensor(list(toks), device=lg.device)
        gap = lg.max(dim=-1).values - lg.gather(1, ids[:, None])[:, 0]
        total += float(gap.sum())
        n += gap.numel()
    return total / n if n else float("inf")


def _counters() -> Dict[str, float]:
    """The program's routed-decode counters now (0 where it has none)."""
    from trainingjob_operator_tpu_torch.utils.metrics import METRICS

    snap = METRICS.snapshot()
    return {k: snap.get(k, 0.0) for k in COUNTERS}


def run(b: Bench) -> dict:
    cfg, cell, dev = b.cell.config, b.cell.settings, b.device
    _, pcfg = port.program(cfg)
    from trainingjob_operator_tpu_torch.workloads import serve

    port.load_kernels(dev)
    params = weights.program_tree(cfg, b.seed, dev, master=False,
                                  compute=pcfg.compute_dtype)
    svc = serve.DecodeService(
        params, pcfg, slots=int(cell["slots"]), max_len=int(cell["max_len"]),
        prefill_chunk=int(cell["prefill_chunk"]),
        queue_cap=int(cell["queue_cap"]), family=cell["family"], device=dev)
    model = _Ranged(svc.model, svc.slots)
    svc.model = model
    svc.warmup()
    schedule = arrivals(b.cell.traffic, float(cell["rate_per_s"]), b.seed,
                        cfg["vocab_size"])
    nxt = next(schedule)
    records: List[Record] = []
    live: List[Record] = []
    ticks: List[float] = []
    clock = b.clock
    t_base = clock()
    ws = t_base + float(cell["warm_s"])
    we = ws + b.seconds
    prof, traced, counted = None, 0, None
    trace_ticks = int(cell["trace_ticks"]) if b.trace else 0
    window_open, drained = False, False
    while True:
        now = clock()
        if not window_open and now >= ws:
            b.mark_window_start(ws)
            window_open = True
        while t_base + nxt.due_s <= now:
            rec = Record(t_base + nxt.due_s, nxt.prompt)
            try:
                rec.req = svc.submit(nxt.prompt, nxt.max_new, now=rec.due)
                live.append(rec)
            except serve.QueueFull:
                pass
            records.append(rec)
            nxt = next(schedule)
        if now >= we and not drained:
            drained = now >= we + TAIL_S or not any(
                ws <= r.due < we and not r.finished and r.req is not None
                for r in records)
        if drained:
            if not trace_ticks or traced == WARM_TICKS + trace_ticks:
                break
            if prof is None:
                prof = devtrace.profiler(warmup=WARM_TICKS,
                                         active=trace_ticks)
                prof.__enter__()
        if not live:
            time.sleep(max(min(t_base + nxt.due_s - clock(), 0.002), 0.0))
            continue
        t0 = clock()
        if prof is not None:
            with record_function(devtrace.STEP):
                svc.step(now=t0)
        else:
            svc.step(now=t0)
        t1 = clock()
        if ws <= t0 < we:
            ticks.append(t1 - t0)
        for rec in live:
            new = len(rec.req.tokens) - len(rec.stamps)
            if new:
                rec.stamps.extend([t1] * new)
        live = [r for r in live if not r.finished]
        if prof is not None:
            prof.step()
            traced += 1
            if traced == WARM_TICKS:
                model.positions = []
                counted = _counters()
    trace, routed = None, {}
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = devtrace.Trace(prof.events(), RANGES)
        end = _counters()
        routed = {k: end[k] - counted[k] for k in COUNTERS}
    positions = model.positions or []
    svc.model = model._module

    window = [r for r in records if ws <= r.due < we]
    itl, queue_ms, ttft, failed = [], [], [], 0
    unfinished = sum(1 for r in window if r.req is not None
                     and not r.finished)
    for r in window:
        if not r.finished:
            failed += 1
            ttft.append(float("inf"))
            itl.append(float("inf"))
            continue
        ttft.append((r.stamps[0] - r.due) * 1e3)
        itl.extend((b2 - a) * 1e3 for a, b2 in zip(r.stamps, r.stamps[1:]))
        queue_ms.append((r.req.admitted - r.due) * 1e3)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    obs = Observed(b.cell, trace=trace,
                   counters={"queue_ms": queue_ms, "ttft_ms": ttft,
                             "decode_positions": positions,
                             "weight_bytes": flops_moe.decode_weight_bytes(
                                 cfg, int(cell["slots"])),
                             **routed},
                   spans={"serve.tick": ticks})

    picked = sample(window, b.seed, int(cell["check_tokens"]))
    seqs = [(r.prompt, list(r.req.tokens)) for r in picked]
    del svc, params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_decoder.exact_float32()
    numbers = {"logit_gap_mean": float("inf")}
    if seqs:
        logits = served_logits(cfg, b.seed, seqs, dev)
        numbers["logit_gap_mean"] = mean_served_gap(logits,
                                                    [s for _, s in seqs])
    verdict = compare.verdict(numbers, cell["limits"])
    return {"e2e": {"itl_ms_p95": quantile(itl, 0.95)},
            "obs": obs, "correct": verdict["correct"] and not unfinished,
            "checks": verdict["checks"], "attempted": len(window),
            "failed": failed, "memory_peak_bytes": peak, "samples": seqs}
