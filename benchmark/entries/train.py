"""Training cells: the trainer's step, ``llama_elastic.make_step_fn`` with
the family's ``loss_fn`` (gradient accumulation, the flash kernels,
RMSNorm, AdamW), driven step after step on new batches.

Set-up builds the one step object, with the weights drawn from the seed,
and drives its first ``check_steps`` steps through the same call and the
same feed as the window, reading what the comparison needs: each loss,
each slice's first gradient (from AdamW's first moment after step 1:
mu = (1 - b1) g) and each slice's change after the last of them.  Then
the window runs steps until ``--seconds`` have passed, the host one step
ahead of the device, and counts every token of every step it completed
over all of its time.  With ``--trace`` a profiled stretch of steps
follows the window.  Once the program's state is freed, the reference
runs the same first steps from the same weights and batches.
"""

from __future__ import annotations

import gc

import torch
from torch.profiler import record_function

from benchmark import compare, devtrace, flops, weights
from benchmark.entries import port
from benchmark.generators.train_steps import Feed
from benchmark.harness import Bench, Observed
from benchmark.reference import decoder as ref_decoder
from benchmark.reference import train as ref_train

RANGES = ("bench.adamw",)


class _AdamWSpan:
    """``opt.step`` under the ``bench.adamw`` range, which names the
    host's work in the trace; while ``pairs`` is a list, each call also
    puts a pair of CUDA events around its kernels on the stream.  The
    reader times AdamW by these: the profiler's own sum of device time
    under the range counted about one step's AdamW kernels twice in some
    runs."""

    def __init__(self, opt):
        self.pairs = None
        real = opt.step

        def step(params, grads):
            with record_function("bench.adamw"):
                if self.pairs is None:
                    return real(params, grads)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                real(params, grads)
                end.record()
                self.pairs.append((start, end))

        opt.step = step


def slice_norms(cfg: dict, tree: dict, scale: float = 1.0) -> dict:
    out = {}
    for path, shape, lead in weights.leaves(cfg):
        leaf = weights.get(tree, path).detach()
        for index in weights.slices(shape, lead):
            out[weights.slice_key(path, index)] = float(
                leaf[index].float().norm()) * scale
    return out


def delta_norms(cfg: dict, tree: dict, seed: int, device) -> dict:
    out = {}
    with torch.no_grad():
        for path, shape, lead in weights.leaves(cfg):
            leaf = weights.get(tree, path)
            for index in weights.slices(shape, lead):
                p0 = weights.draw(seed, path, index, shape[lead:], device)
                out[weights.slice_key(path, index)] = float(
                    (leaf[index] - p0).norm())
    return out


class _Done:
    """Marks where a step's work ends: a CUDA event, or nothing on the
    CPU, where every call has ended when it returns."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def run(b: Bench) -> dict:
    cfg, cell, dev = b.cell.config, b.cell.settings, b.device
    model, pcfg = port.program(cfg)
    from trainingjob_operator_tpu_torch.workloads import llama_elastic

    port.load_kernels(dev)
    opt_args = cell["optimizer"]
    params = weights.program_tree(cfg, b.seed, dev, master=True)
    for path, _, _ in weights.leaves(cfg):
        weights.get(params, path).requires_grad_(True)
    step_fn = llama_elastic.make_step_fn(
        params, pcfg, accum=int(cell["accum"]), lr=opt_args["lr"],
        remat=cell["remat"], loss_fn=model.loss_fn)
    opt = step_fn.opt
    stated = tuple(opt_args[k] for k in ("b1", "b2", "eps", "weight_decay"))
    runs = (opt.b1, opt.b2, opt.eps, opt.weight_decay)
    if runs != stated:
        raise ValueError(f"the trainer's AdamW (b1, b2, eps, weight decay) "
                         f"is {runs}; the cell states {stated}")
    adamw = _AdamWSpan(opt)
    feed = Feed(b.cell.traffic, cfg["vocab_size"], b.seed, dev)

    # Set-up: the first steps, read for the comparison.
    n_check = int(cell["check_steps"])
    prog = {"losses": []}
    for s in range(n_check):
        prog["losses"].append(float(step_fn(feed.batch(s))))
        if s == 0:
            prog["grad_norms"] = slice_norms(cfg, opt.state["mu"],
                                             1.0 / (1.0 - opt.b1))
    prog["delta_norms"] = delta_norms(cfg, params, b.seed, dev)
    b.sync()

    # The window.
    t0 = b.mark_window_start()
    done, step = None, n_check
    while True:
        step_fn(feed.batch(step))
        step += 1
        now_done = _Done(dev)
        if done is not None:
            done.wait()
        done = now_done
        if b.clock() - t0 >= b.seconds:
            break
    b.sync()
    window_s = b.clock() - t0
    n_steps = step - n_check
    tokens = n_steps * feed.tokens_per_step
    per_token = flops.train_flops_per_token(cfg, feed.seq)
    obs = Observed(b.cell, counters={
        "window_s": window_s, "steps": n_steps, "tokens": tokens,
        "model_flops": per_token * tokens,
        "attn": {"B": feed.rows // int(cell["accum"]), "T": feed.seq,
                 "H": cfg["num_attention_heads"],
                 "Hkv": cfg["num_key_value_heads"], "D": cfg["head_dim"]}})
    if b.trace:
        n_traced = int(cell["trace_steps"])
        timed = [] if dev.type == "cuda" else None

        def traced(i):
            # AdamW is timed in the recorded steps: 1 .. n_traced.
            adamw.pairs = timed if 1 <= i <= n_traced else None
            step_fn(feed.batch(step + i))
            b.sync()

        obs.trace = devtrace.profiled(traced, warmup=1, active=n_traced,
                                      ranges=RANGES)
        if cfg.get("num_local_experts"):
            # The dispatch is told apart by its operands' shapes: one
            # more step records them and lends them to the stretch.
            shaped = devtrace.profiled(
                lambda i: traced(1 + n_traced + i), warmup=1, active=1,
                ranges=RANGES, record_shapes=True)
            obs.trace.take_shapes(shaped)
        obs.counters["traced_steps"] = n_traced
        obs.counters["adamw_ms"] = [a.elapsed_time(z) for a, z in timed or ()]
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    # The reference, once the program's state is gone.
    del step_fn, opt, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_decoder.exact_float32()
    ref = ref_train.follow(cfg, b.seed,
                           [feed.batch(s) for s in range(n_check)], opt_args,
                           dev)
    verdict = compare.verdict(compare.train_numbers(prog, ref),
                              cell["limits"])
    return {"e2e": {"train_tokens_per_s": tokens / window_s}, "obs": obs,
            "correct": verdict["correct"], "checks": verdict["checks"],
            "attempted": n_steps, "failed": 0, "memory_peak_bytes": peak}
