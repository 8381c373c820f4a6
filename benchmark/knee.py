"""The knee of a serving cell: its traffic at a few fixed rates, each for
one window, and whether the backlog grows.

    python3 benchmark/knee.py --workload <cell> --seed <n> --seconds <s> \\
        --rate <r> [--rate ...]

prints one JSON line a rate: the tails, the requests due and failed, and
the wait for a slot in the window's first and last thirds (a wait that
grows from one to the other is a backlog that grows: the rate is past
the knee).  The cell's own rate is set once from this, at about four
fifths of the highest rate whose wait does not grow; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def at_rate(name: str, seed: int, seconds: float, rate: float,
            device="cuda", overrides=None) -> dict:
    import torch

    from benchmark.entries import serve

    over = dict(overrides or {})
    over["cell"] = {**over.get("cell", {}), "rate_per_s": rate}
    cell = harness.find_cell(name, overrides=over)
    bench = harness.Bench(cell, seed, seconds, False, torch.device(device),
                          time.perf_counter())
    out = serve.run(bench)
    q = out["obs"].counters["queue_ms"]
    third = max(len(q) // 3, 1)
    return {"rate_per_s": rate, **out["e2e"],
            "ttft_ms_p90": harness.quantile(out["obs"].counters["ttft_ms"], 0.9),
            "attempted": out["attempted"],
            "failed": out["failed"],
            "tick_ms": 1e3 * statistics.mean(out["obs"].spans["serve.tick"]),
            "queue_ms_first_third": statistics.mean(q[:third]) if q else None,
            "queue_ms_last_third": statistics.mean(q[-third:]) if q else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("python3 benchmark/knee.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--rate", type=float, action="append", required=True)
    args = parser.parse_args(argv)
    harness.prepare_environment()
    import torch

    if not torch.cuda.is_available():
        print("knee: needs a CUDA card", file=sys.stderr)
        return 2
    for rate in args.rate:
        got = at_rate(args.workload, args.seed, args.seconds, rate)
        print(json.dumps(got), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
