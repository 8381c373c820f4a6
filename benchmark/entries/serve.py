"""Serving cells: ``serve.DecodeService`` (continuous batching over a
fixed slot batch, chunked prefill into the KV cache, greedy decode),
driven by the benchmark's own open loop in wall time.

Requests are submitted when they fall due on the seed's schedule
(``generators/serve_open_loop.py``), whether or not the service keeps
up; the loop calls ``step()`` while anything is queued or in a slot.
Every token is stamped by the benchmark's clock when ``step()`` has
returned with it (the service has read it to the host by then).
Arrivals start during set-up: the window opens ``warm_s`` later on a
loaded service, runs ``--seconds``, and every request due in it is
followed to its end (a minute at most past the close; one that never
finishes, or was refused, counts as failed and as infinitely late in
the tail of gaps between tokens).  Each request's time to first token
and wait for a slot are kept for ``knee.py``: over a window's 70 or so
requests their tails swing too much from run to run to bound.  With
``--trace`` a profiled stretch of ticks follows, under the same
arrivals, once those requests have ended.  Once the service is freed,
the reference reruns a sample of the finished requests, the longest
among them.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, devtrace, flops, weights
from benchmark.entries import port
from benchmark.generators.serve_open_loop import arrivals
from benchmark.harness import Bench, Observed, quantile
from benchmark.reference import decoder as ref_decoder
from benchmark.reference.serve import served_logits

RANGES = ("bench.prefill_chunk", "bench.serve_step")
#: Seconds a request due in the window may take past its close.
TAIL_S = 60.0
#: Ticks the profiler runs before it records.
WARM_TICKS = 5


@dataclass
class Record:
    due: float
    prompt: List[int]
    req: object = None            # the service's Request; None if refused
    stamps: List[float] = field(default_factory=list)

    @property
    def finished(self) -> bool:
        return self.req is not None and bool(self.req.finished)


class _Ranged:
    """The service's model module with ``prefill_chunk`` and
    ``serve_step`` under ``record_function`` ranges; while ``positions``
    is a list, each decode step appends the cache positions its decoding
    slots attend to."""

    def __init__(self, module, svc_slots):
        self._module, self._slots = module, svc_slots
        self.positions: Optional[List[int]] = None

    def __getattr__(self, name):
        return getattr(self._module, name)

    def prefill_chunk(self, *args, **kwargs):
        with record_function("bench.prefill_chunk"):
            return self._module.prefill_chunk(*args, **kwargs)

    def serve_step(self, *args, **kwargs):
        if self.positions is not None:
            from trainingjob_operator_tpu_torch.workloads.serve import DECODE

            self.positions.append(sum(sl.t + 1 for sl in self._slots
                                      if sl.state == DECODE))
        with record_function("bench.serve_step"):
            return self._module.serve_step(*args, **kwargs)


def sample(records: List[Record], seed: int, tokens: int) -> List[Record]:
    """The longest finished request, then others drawn from the seed,
    until ``tokens`` served tokens are in the sample."""
    done = [r for r in records if r.finished]
    if not done:
        return []
    longest = max(done, key=lambda r: len(r.prompt) + len(r.req.tokens))
    rest = [r for r in done if r is not longest]
    order = np.random.Generator(np.random.PCG64(
        weights.sub_seed(seed, "sample"))).permutation(len(rest))
    out, n = [longest], len(longest.req.tokens)
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += len(rest[i].req.tokens)
    return out


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
    prof, traced = None, 0
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
            # Every request due in the window has ended: the profiled
            # stretch, if any, runs now under the same arrivals.
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
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = devtrace.Trace(prof.events(), RANGES)
    positions = model.positions or []
    svc.model = model._module

    # End-to-end numbers over every request due in the window.
    window = [r for r in records if ws <= r.due < we]
    ttft, itl, queue_ms, failed = [], [], [], 0
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
                             "weight_bytes": flops.decode_weight_bytes(
                                 cfg, int(cell["slots"]))},
                   spans={"serve.tick": ticks})

    # The reference, once the service and its weights are gone.
    picked = sample(window, b.seed, int(cell["check_tokens"]))
    seqs = [(r.prompt, list(r.req.tokens)) for r in picked]
    del svc, params, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_decoder.exact_float32()
    numbers = {"logit_gap": float("inf")}
    if seqs:
        logits = served_logits(cfg, b.seed, seqs, dev)
        numbers["logit_gap"] = compare.served_gap(logits,
                                                  [s for _, s in seqs])
    verdict = compare.verdict(numbers, cell["limits"])
    return {"e2e": {"itl_ms_p95": quantile(itl, 0.95)},
            "obs": obs, "correct": verdict["correct"] and not unfinished,
            "checks": verdict["checks"], "attempted": len(window),
            "failed": failed, "memory_peak_bytes": peak, "samples": seqs}
