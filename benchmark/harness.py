"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything that belongs to one cell is found by name: the workload entry
in ``BENCHMARK.json`` names its configuration and traffic;
``configs/<config>.json`` holds the model, ``traffic/<traffic>.json`` the
traffic mix (read by ``generators/<generator>.py``), ``workloads/<cell>.json``
the cell's own settings and limits, ``entries/<entry>.py`` drives the
program, and ``metrics/<metric>.py`` reads each per-layer metric.  A
later cell, configuration, mix or metric is a file of its own and an
entry in ``BENCHMARK.json``, with no file here edited.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level modules that must not be loaded once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "trainingjob_operator_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), so that set-up
    counts the interpreter's start and every import."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def prepare_environment() -> None:
    """Fixed cache directories inside the checkout (every run of a cell
    there after the first finds the kernels built), and no JAX behind a
    library's back.  Call before ``torch`` is imported."""
    cache = HERE / "cache"
    os.environ["TRAININGJOB_COMPILE_CACHE_DIR"] = str(cache / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    home: Path                  # the benchmark's directory
    chips: int
    config: Dict[str, Any]      # configs/<config>.json
    settings: Dict[str, Any]    # workloads/<cell>.json
    traffic: Dict[str, Any]     # traffic/<traffic>.json
    end_to_end: List[dict]      # the metrics this cell reports
    per_layer: List[dict]


def find_cell(name: str, root: Path = ROOT,
              overrides: Optional[Dict[str, dict]] = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files (and
    ``overrides`` merged into them: {"config"|"cell"|"traffic": {...}},
    for tests at small sizes)."""
    bench = load_json(root / "BENCHMARK.json")
    here = root / "benchmark"
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    over = overrides or {}
    config = {**load_json(root / conf["file"]), **over.get("config", {})}
    settings = {**load_json(here / "workloads" / f"{name}.json"),
                **over.get("cell", {})}
    traffic = {**load_json(here / "traffic" / f"{work['traffic']}.json"),
               **over.get("traffic", {})}
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in reported)]
    return Cell(name, here, int(work["chips"]), config, settings, traffic,
                e2e, layer)


def quantile(values: List[float], p: float) -> float:
    """Nearest-rank ``p`` quantile (an infinite value counts as one)."""
    if not values:
        return math.nan
    ordered = sorted(values)
    return ordered[max(math.ceil(p * len(ordered)) - 1, 0)]


@dataclass
class Bench:
    """What an entry is handed: the cell, the run's arguments, the device,
    and the clock on which set-up ends."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_process: float                  # perf_counter at process start
    window_start: Optional[float] = None

    @staticmethod
    def clock() -> float:
        return time.perf_counter()

    def mark_window_start(self, at: Optional[float] = None) -> float:
        self.window_start = self.clock() if at is None else at
        return self.window_start

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclass
class Observed:
    """What the per-layer readers read: the trace (None without one), the
    run's counters and host spans, and the cell."""
    cell: Cell
    trace: Any = None
    counters: Dict[str, Any] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)


def _finite(x: float) -> Optional[float]:
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", *, root: Path = ROOT,
             overrides: Optional[Dict[str, dict]] = None,
             t_process: Optional[float] = None) -> dict:
    """Run the cell once on ``device`` and return its result line as a
    dict (``checks`` last).  Looks for no card: ``main`` does."""
    import torch

    cell = find_cell(name, root, overrides)
    bench = Bench(cell, seed, seconds, trace, torch.device(device),
                  t_process if t_process is not None else time.perf_counter())
    entry = load_module(cell.home / "entries" / f"{cell.settings['entry']}.py",
                        f"benchmark_entry_{cell.settings['entry']}")
    out = entry.run(bench)
    setup_s = bench.window_start - bench.t_process
    e2e = {**out["e2e"], "setup_s": setup_s}
    obs: Observed = out["obs"]
    if trace:
        values = {}
        for m in cell.per_layer:
            reader = load_module(cell.home / "metrics" / f"{m['name']}.py",
                                 f"benchmark_metric_{m['name']}")
            v = reader.read(obs)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                  for m in cell.end_to_end}
    dev = {"platform": "gpu" if bench.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(bench.device)
                    if bench.device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": values, "device": dev}
    if trace and obs.trace is not None:
        dev["busy_s"] = obs.trace.busy_s
        dev["window_s"] = obs.trace.window_s
        line["breakdown"] = {"device_ops": obs.trace.device_ops(),
                             "idle_gaps": obs.trace.idle_gaps()}
    line["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    return line


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None,
         t_process: Optional[float] = None) -> int:
    parser = argparse.ArgumentParser("python3 benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if t_process is None:
        t_process = time.perf_counter() - process_age_s()
    import torch

    cell = find_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda", t_process=t_process)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {loaded}, which the port must "
              f"not import", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
