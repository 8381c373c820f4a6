"""Eager wall time of the serving path's host-bound calls, for comparing
checkouts of the port on one card.

    python3 -m trainingjob_operator_tpu_torch.workloads.tick_ab \\
        --root OLD --root . --root . --root OLD

runs one process per ``--root``, in the order given, each importing the
package from that checkout (which may predate this script: it only needs
``models.decode`` and ``models.llama``).  Each builds a seeded random-init
Llama-2-7B (bf16, all 32 layers) and times, on the host clock between two
``torch.cuda.synchronize``, RUNS runs of TICKS back-to-back calls of the
functions below.  Beside each wall time it records the
calling thread's CPU time (``time.thread_time``): the host's own work,
which other load on a shared host stretches less than the wall.

- ``decode.serve_step``: one continuous-batching tick, 4 slots at
  positions 100..400 of a 1024-token cache;
- ``decode.prefill_chunk``: one 16-token chunk into slot 0;
- ``decode.decode_step``: one step after a 512-token prefill.

Prints the ``nvidia-smi`` name and power limit, one JSON line per process
(every run's ms per call, wall and CPU, and their medians), then one
summary line with the median of each root's runs.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: Calls per timed run, and runs per function and process.
TICKS, RUNS = 20, 5


def _time_calls(torch, fn):
    """(wall ms, host-thread CPU ms) per call, one entry per run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    wall, cpu = [], []
    for _ in range(RUNS):
        t0, c0 = time.perf_counter(), time.thread_time()
        for _ in range(TICKS):
            fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3 / TICKS)
        cpu.append((time.thread_time() - c0) * 1e3 / TICKS)
    return wall, cpu


def worker() -> dict:
    import torch

    import trainingjob_operator_tpu_torch as pkg
    from trainingjob_operator_tpu_torch.models import decode, llama

    dev = torch.device("cuda")
    cfg = llama.LlamaConfig.llama2_7b()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    slots, max_len, chunk = 4, 1024, 16
    cache = decode.init_cache(cfg, slots, max_len, device=dev)
    tokens = torch.arange(1, slots + 1, device=dev)
    ts = torch.arange(slots, device=dev) * 100 + 100
    chunk_tokens = torch.arange(1, chunk + 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(1, cfg.vocab_size, (1, 512), generator=gen,
                           device=dev)
    _, one_cache = decode.prefill(params, prompt, cfg, 512 + 32)
    last = prompt[:, -1]
    timed = {
        "serve_step": lambda: decode.serve_step(params, cache, tokens, ts,
                                                cfg),
        "prefill_chunk": lambda: decode.prefill_chunk(
            params, cache, chunk_tokens, 0, 0, cfg),
        "decode_step": lambda: decode.decode_step(params, one_cache, last,
                                                  512, cfg),
    }
    result = {"package": os.path.dirname(os.path.abspath(pkg.__file__)),
              "ticks": TICKS}
    for name, fn in timed.items():
        wall, cpu = _time_calls(torch, fn)
        result[f"{name}_ms"] = wall
        result[f"{name}_ms_median"] = statistics.median(wall)
        result[f"{name}_cpu_ms"] = cpu
        result[f"{name}_cpu_ms_median"] = statistics.median(cpu)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        "python3 -m trainingjob_operator_tpu_torch.workloads.tick_ab")
    parser.add_argument("--root", action="append", default=[],
                        help="a checkout to import the package from; "
                             "repeat for each process, in order")
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return 0
    if not args.root:
        parser.error("give at least one --root")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    by_root = {}
    for i, root in enumerate(args.root):
        root = os.path.abspath(root)
        env = dict(os.environ, PYTHONPATH=root)
        # -P: the script's own directory stays off sys.path, so the package
        # comes from ``root``.
        proc = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--worker"],
            cwd=root, env=env, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"worker for {root} exited "
                             f"{proc.returncode}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        if not line["package"].startswith(root):
            raise SystemExit(f"worker for {root} imported {line['package']}")
        print(json.dumps({"order": i, "root": root, "nvidia_smi": smi,
                          **line}), flush=True)
        by_root.setdefault(root, []).append(line)
    print(json.dumps({"summary": {
        root: {f"{name}{kind}": statistics.median(
            ms for line in lines for ms in line[f"{name}{kind}"])
            for name in ("serve_step", "prefill_chunk", "decode_step")
            for kind in ("_ms", "_cpu_ms")}
        for root, lines in by_root.items()}, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
