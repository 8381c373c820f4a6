"""The readings that set each cell's limits, besides the program's own:
the control (the reference in the precision below the one the
configuration states: float8 products for bf16 compute) and the faults a
cell can have, each held against the float32 reference as the
comparison holds the program.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed ...]
        [--seconds <s>]

prints one JSON line a seed.  Training: ``control`` (the fp8 reference
in the program's place), ``half_batch`` (each batch's first half only,
the mean taken over it), ``unchanged`` (a step that leaves the state
as it was: the first loss every step, no first moment, no change; read
from the reference's own run), and two faults of AdamW: ``no_bias_correction``
and ``lr_x1.5`` (its step half again as long).  Serving: a short window of the cell at its own
load, then on the sampled requests ``program`` (the served tokens),
``control`` (at each position the token the fp8 reference puts first)
and ``altered`` (one served token a request changed where it was
produced).  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import compare, harness  # noqa: E402


def train_readings(name: str, seed: int, device, overrides=None) -> dict:
    import torch

    from benchmark.generators.train_steps import Feed
    from benchmark.reference import decoder
    from benchmark.reference.train import follow

    cell = harness.find_cell(name, overrides=overrides)
    cfg, settings = cell.config, cell.settings
    feed = Feed(cell.traffic, cfg["vocab_size"], seed, torch.device(device))
    batches = [feed.batch(s) for s in range(int(settings["check_steps"]))]
    opt = settings["optimizer"]
    decoder.exact_float32()
    ref = follow(cfg, seed, batches, opt, device)
    control = follow(cfg, seed, batches, opt, device, lowp="fp8")
    half = follow(cfg, seed, [b[: b.shape[0] // 2] for b in batches], opt,
                  device)
    uncorrected = follow(cfg, seed, batches, opt, device,
                         bias_correction=False)
    long_step = follow(cfg, seed, batches, {**opt, "lr": 1.5 * opt["lr"]},
                       device)
    unchanged = {"losses": ref["losses"][:1] * len(ref["losses"]),
                 "grad_norms": {k: 0.0 for k in ref["grad_norms"]},
                 "delta_norms": {k: 0.0 for k in ref["delta_norms"]}}
    return {"control": compare.train_numbers(control, ref),
            "half_batch": compare.train_numbers(half, ref),
            "unchanged": compare.train_numbers(unchanged, ref),
            "no_bias_correction": compare.train_numbers(uncorrected, ref),
            "lr_x1.5": compare.train_numbers(long_step, ref),
            "reference_losses": ref["losses"]}


def serve_readings(name: str, seed: int, seconds: float, device,
                   overrides=None) -> dict:
    import torch

    from benchmark.entries import serve
    from benchmark.reference.serve import served_logits

    cell = harness.find_cell(name, overrides=overrides)
    bench = harness.Bench(cell, seed, seconds, False, torch.device(device),
                          time.perf_counter())
    out = serve.run(bench)
    seqs = out["samples"]
    cfg = cell.config
    exact = served_logits(cfg, seed, seqs, device)
    low = served_logits(cfg, seed, seqs, device, lowp="fp8")
    served = [s for _, s in seqs]
    picked = [lg.argmax(-1).tolist() for lg in low]
    altered = [[(t + 1) % cfg["vocab_size"] if i == len(s) // 2 else t
                for i, t in enumerate(s)] for s in served]
    return {"program": {"logit_gap": compare.served_gap(exact, served)},
            "control": {"logit_gap": compare.served_gap(exact, picked)},
            "altered": {"logit_gap": compare.served_gap(exact, altered)},
            "served_tokens": sum(len(s) for s in served),
            "in_run": out["checks"]["logit_gap"]["value"]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("python3 benchmark/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, action="append", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    entry = harness.find_cell(args.workload).settings["entry"]
    for seed in args.seed:
        t0 = time.perf_counter()
        if entry == "train":
            got = train_readings(args.workload, seed, "cuda")
        else:
            got = serve_readings(args.workload, seed, args.seconds, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, **got,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
