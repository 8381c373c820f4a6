"""A ``torch.profiler`` window over some steps of a run, reduced to what
the per-layer readers need: the device operations on the trace's own
timeline, the device time under the benchmark's ``record_function``
ranges, the matrix products by their input shapes, and the host events
that were running while the device sat idle.

Input shapes cost the profiler host time, which would change the
stretch it records, so a stretch records none: where a reader needs them
(to tell the MoE dispatch apart), one more step is recorded with them and
lends each product its shapes by its place in the step
(``Trace.take_shapes``).

The window is the recorded steps (each under a ``bench.step`` range),
from the first one's start to the later of the last one's end and the
last device operation's; the device is busy where the union of its operations'
intervals lies, so the idle share can never read below 0.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function

#: The range around each recorded step.
STEP = "bench.step"
#: Host ops whose own device time is a cuBLAS product.
GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm")


def is_moe_dispatch(op: str, shapes: List[list], cfg: dict) -> bool:
    """Whether a traced product is a routed model's dispatch or combine:
    a ``bmm`` none of whose operands has the ffn width (the expert
    products all have it)."""
    if op != "aten::bmm" or not cfg.get("num_local_experts"):
        return False
    return not any(cfg["intermediate_size"] in s for s in shapes)


class Trace:
    def __init__(self, events, ranges: Tuple[str, ...],
                 shapes_known: bool = False):
        from torch.autograd import DeviceType

        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.ranges: Dict[str, Dict[str, float]] = {}
        #: (op, input shapes, device us) of every product, in the order
        #: they began; the shapes are known where ``shapes_known``.
        self.gemms: List[Tuple[str, list, float]] = []
        self.shapes_known = shapes_known
        products = []
        steps = []
        for e in events:
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # The device side of a record_function range is no op.
                if not (getattr(e, "is_user_annotation", False)
                        or e.name in ranges or e.name == STEP
                        or e.name.startswith("ProfilerStep")):
                    self.kernels.append((e.name, start, end))
                continue
            if e.name == STEP:
                steps.append((start, end))
                continue
            if e.name.startswith("ProfilerStep"):
                continue
            self.host.append((e.name, start, end))
            if e.name in ranges:
                r = self.ranges.setdefault(e.name, {"calls": 0,
                                                    "device_us": 0.0})
                r["calls"] += 1
                r["device_us"] += e.device_time_total
            elif e.name in GEMM_OPS:
                products.append((start, e.name,
                                 [list(s) for s in e.input_shapes
                                  if isinstance(s, (list, tuple))],
                                 e.self_device_time_total))
        products.sort(key=lambda p: p[0])
        steps.sort()
        # Each product's step: the recorded step its host call began in.
        self._step_of = [next((i for i, (s, e) in enumerate(steps)
                               if s <= p[0] <= e), -1) for p in products]
        self.gemms = [(op, shapes, us) for _, op, shapes, us in products]
        self.steps = len(steps)
        if steps:
            last = max([end for _, end in steps]
                       + [end for _, _, end in self.kernels])
            self.window = (min(s for s, _ in steps), last)
        else:
            self.window = (0.0, 0.0)

    def step_products(self, step: int) -> List[int]:
        """Indices into ``gemms`` of the products of recorded step
        ``step``, in order."""
        return [i for i, s in enumerate(self._step_of) if s == step]

    def take_shapes(self, shaped: "Trace") -> bool:
        """Give every product of each recorded step the shapes of the
        product at its place in ``shaped``'s one step, recorded with
        shapes; only where each step ran the same products in the same
        order.  Returns whether the shapes are now known."""
        model = [shaped.gemms[i] for i in shaped.step_products(0)]
        per_step = [self.step_products(k) for k in range(self.steps)]
        if not model or min(self._step_of, default=0) < 0 or any(
                [self.gemms[i][0] for i in idx] != [m[0] for m in model]
                for idx in per_step):
            return False
        for idx in per_step:
            for i, m in zip(idx, model):
                op, _, us = self.gemms[i]
                self.gemms[i] = (op, m[1], us)
        self.shapes_known = True
        return True

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the
        window, sorted."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.kernels
                       if e > lo and s < hi)
        out: List[List[float]] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def kernel_us(self, part: str) -> Tuple[int, float]:
        """(calls, device us) of the device operations whose name holds
        ``part``."""
        hits = [e - s for name, s, e in self.kernels if part in name]
        return len(hits), float(sum(hits))

    def device_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took the most time, by name,
        in seconds."""
        total: Dict[str, float] = {}
        for name, s, e in self.kernels:
            total[name] = total.get(name, 0.0) + (e - s) / 1e6
        return [[k[:160], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time inside the window, summed by the
        innermost host event running at each gap's middle ("host: between
        ops" where none was), the ``n`` largest, in seconds."""
        lo, hi = self.window
        busy = self.busy_intervals()
        edges = [lo] + [x for span in busy for x in span] + [hi]
        gaps = sorted((a, b) for a, b in zip(edges[0::2], edges[1::2])
                      if b > a)
        host = sorted(self.host, key=lambda h: h[1])
        heap: List[Tuple[float, float, str]] = []
        i, total = 0, {}
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while i < len(host) and host[i][1] <= mid:
                heapq.heappush(heap, (-host[i][1], host[i][2], host[i][0]))
                i += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "host: between ops"
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k[:160], v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def profiler(warmup: int, active: int, record_shapes: bool = False):
    """A ``torch.profiler.profile`` (not yet entered) that records the
    ``active`` steps after ``warmup`` ones; the caller calls its
    ``step()`` at each step's end."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=record_shapes,
                   schedule=schedule(wait=0, warmup=warmup, active=active,
                                     repeat=1))


def profiled(step: Callable[[int], None], warmup: int, active: int,
             ranges: Tuple[str, ...], record_shapes: bool = False) -> Trace:
    """Run ``step(i)`` for ``warmup + active`` steps under the profiler
    and reduce the last ``active`` (``step`` synchronises where its work
    must have ended)."""
    with profiler(warmup, active, record_shapes) as prof:
        for i in range(warmup + active):
            with record_function(STEP):
                step(i)
            prof.step()
    return Trace(prof.events(), ranges, shapes_known=record_shapes)
