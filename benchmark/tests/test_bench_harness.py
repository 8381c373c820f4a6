"""The harness finds every cell's files by name, runs a cell added as
files alone, counts FLOPs as written down by hand, and draws its
open-loop schedule from the seed alone (CPU, small sizes)."""

from __future__ import annotations

import json
import math
import shutil
import statistics

import numpy as np
import pytest
import torch

from benchmark import devtrace, flops, harness
from benchmark.generators import serve_open_loop

ROOT = harness.ROOT

#: The small sizes the CPU runs take (every width cut; the cells' own
#: files are untouched).
TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256, "torch_dtype": "float32"}
TINY_TRAIN = {"config": TINY, "traffic": {"seq": 32, "rows_per_step": 4},
              "cell": {"accum": 2}}


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_files_by_name(name):
    cell = harness.find_cell(name)
    assert (cell.home / "entries" / f"{cell.settings['entry']}.py").exists()
    assert cell.traffic["generator"] in ("train_steps", "serve_open_loop")
    assert (cell.home / "generators"
            / f"{cell.traffic['generator']}.py").exists()
    assert cell.config["name"] == next(
        w["config"] for w in _bench()["workloads"] if w["name"] == name)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert (cell.home / "metrics" / f"{m['name']}.py").exists()
    assert set(cell.settings["limits"])


def test_a_cell_added_as_files_alone_is_found_and_runs(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    bench = _bench()
    bench["workloads"].append(
        {"name": "mistral-7b-pp4.train.s64", "config": "mistral-7b-pp4",
         "traffic": "train.s64", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append(
        {"name": "train.tokens_per_step", "unit": "tokens",
         "better": "higher", "source": "program_counter",
         "layer": "train loop", "moves": "train_tokens_per_s",
         "workloads": ["mistral-7b-pp4.train.s64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    home = tmp_path / "benchmark"
    (home / "traffic" / "train.s64.json").write_text(json.dumps(
        {"generator": "train_steps", "seq": 64, "rows_per_step": 2}))
    cell = json.loads((home / "workloads"
                       / "mistral-7b.train.s4096.json").read_text())
    cell["accum"] = 1
    (home / "workloads" / "mistral-7b-pp4.train.s64.json").write_text(
        json.dumps(cell))
    (home / "metrics" / "train.tokens_per_step.py").write_text(
        "def read(obs):\n"
        "    c = obs.counters\n"
        "    return c['tokens'] / c['steps'] if c.get('steps') else None\n")
    found = harness.find_cell("mistral-7b-pp4.train.s64", root=tmp_path)
    assert found.traffic["seq"] == 64
    assert [m["name"] for m in found.per_layer][-1] == "train.tokens_per_step"
    line = harness.run_cell("mistral-7b-pp4.train.s64", 7, 0.5, True, "cpu",
                            root=tmp_path, overrides={"config": TINY})
    assert line["correct"] is True
    assert line["metrics"]["train.tokens_per_step"]["value"] == 128
    assert list(line)[-1] == "checks"


def test_flop_counts_equal_the_hand_counts():
    def cfg(name):
        return json.loads((ROOT / "benchmark" / "configs"
                           / f"{name}.json").read_text())

    # 8 x (2 x 4096^2 + 2 x 4096 x 1024 + 3 x 4096 x 14336) + 4096 x 32000
    # matmul parameters, x 6, plus 6 x 8 x 4096 x 4096 of attention.
    dense = flops.train_flops_per_token(cfg("mistral-7b-pp4"), 4096)
    assert dense == 6 * 1_875_902_464 + 805_306_368
    assert round(dense / 1e9, 2) == 12.06
    moe = flops.train_flops_per_token(cfg("mixtral-8x7b"), 4096)
    assert round(moe / 1e9, 2) == 5.72


def _first(seed, n, traffic=None, rate=5.0):
    traffic = traffic or json.loads(
        (ROOT / "benchmark" / "traffic" / "serve.chat.json").read_text())
    it = serve_open_loop.arrivals(traffic, rate, seed, 32000)
    return [next(it) for _ in range(n)]


def test_the_open_loop_schedule_is_fixed_by_the_seed():
    seed = 2 ** 31 + 77
    a, b = _first(seed, 200), _first(seed, 200)
    assert [(x.due_s, x.prompt, x.max_new) for x in a] == \
        [(x.due_s, x.prompt, x.max_new) for x in b]
    c = _first(seed + 1, 200)
    assert [x.prompt for x in a] != [x.prompt for x in c]
    assert [x.due_s for x in a] != [x.due_s for x in c]


def test_every_seed_sends_the_same_work_in_another_order():
    # Every STRATA requests take one draw from each band of equal
    # probability: two seeds' k-th smallest gaps of a round share a band,
    # and a round holds about as much work, in another order.
    n, rate = serve_open_loop.STRATA, 5.0
    a, c = _first(1, 2 * n), _first(2 ** 32 + 5, 2 * n)
    for r in range(2):
        for sched in (a, c):
            prev = sched[r * n - 1].due_s if r else 0.0
            gaps = sorted(np.diff([prev] + [x.due_s
                                            for x in sched[r * n:(r + 1) * n]]))
            bands = [math.floor(n * -math.expm1(-rate * g)) for g in gaps]
            assert bands == list(range(n))
        work = [sum(len(x.prompt) + x.max_new for x in s[r * n:(r + 1) * n])
                for s in (a, c)]
        assert abs(work[0] - work[1]) < 0.1 * work[0]
    assert [len(x.prompt) for x in a] != [len(x.prompt) for x in c]


def test_two_seeds_send_their_own_schedules():
    a, c = _first(1, 130), _first(2 ** 32 + 5, 130)
    assert [x.due_s for x in a] != [x.due_s for x in c]
    assert [x.max_new for x in a] != [x.max_new for x in c]
    assert [x.prompt[:4] for x in a] != [x.prompt[:4] for x in c]


def test_the_schedule_follows_the_stated_distributions():
    traffic = json.loads(
        (ROOT / "benchmark" / "traffic" / "serve.chat.json").read_text())
    got = _first(3, 640, traffic, rate=4.0)
    prompts = [len(x.prompt) for x in got]
    outputs = [x.max_new for x in got]
    p, o = traffic["prompt"], traffic["output"]
    assert min(prompts) >= p["min"] and max(prompts) <= p["max"]
    assert min(outputs) >= o["min"] and max(outputs) <= o["max"]
    assert abs(statistics.median(prompts) - p["median"]) <= 0.03 * p["median"]
    assert abs(statistics.median(outputs) - o["median"]) <= 0.03 * o["median"]
    # log-lengths inside the clip spread as the stated sigma
    inner = [math.log(n) for n in prompts if p["min"] < n < p["max"]]
    assert 0.3 < statistics.pstdev(inner) < p["sigma"]
    gaps = [b.due_s - a.due_s for a, b in zip(got, got[1:])]
    assert abs(statistics.mean(gaps) - 1 / 4.0) < 0.02
    assert all(0 <= x.prompt[i] < 32000 for x in got[:5] for i in range(3))


def test_quantile_is_nearest_rank_and_counts_failures_as_late():
    assert harness.quantile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.0
    assert harness.quantile(list(range(1, 11)), 0.9) == 9
    assert harness.quantile([1.0] * 8 + [math.inf] * 2, 0.9) == math.inf


def test_cells_run_on_the_cpu_at_small_sizes():
    line = harness.run_cell("mistral-7b.train.s4096", 2 ** 31 + 3, 0.5,
                            False, "cpu", overrides=TINY_TRAIN)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert all(c["value"] < 1e-5 for c in line["checks"].values())


def test_the_moe_stretch_takes_its_shapes_from_one_more_step():
    import time

    cell = harness.find_cell("mixtral-8x7b.train.s4096", overrides={
        **TINY_TRAIN, "config": {**TINY, "num_local_experts": 4}})
    entry = harness.load_module(cell.home / "entries" / "train.py",
                                "benchmark_entry_train")
    bench = harness.Bench(cell, 2 ** 31 + 9, 0.3, True, torch.device("cpu"),
                          time.perf_counter())
    trace = entry.run(bench)["obs"].trace
    assert trace.shapes_known and trace.steps == 2
    steps = [trace.step_products(k) for k in range(trace.steps)]
    assert steps[0] and len(steps[0]) == len(steps[1])
    assert len(steps[0]) + len(steps[1]) == len(trace.gemms)
    assert all(trace.gemms[i][1] for i in steps[0] + steps[1])
    kinds = [[devtrace.is_moe_dispatch(*trace.gemms[i][:2], cell.config)
              for i in idx] for idx in steps]
    assert kinds[0] == kinds[1] and any(kinds[0]) and not all(kinds[0])
    F = cell.config["intermediate_size"]
    for i in steps[0]:
        op, shapes, _ = trace.gemms[i]
        if op == "aten::bmm" and not kinds[0][steps[0].index(i)]:
            assert any(F in x for x in shapes)


def test_take_shapes_refuses_a_step_of_other_products():
    class E:
        def __init__(self, name, start, end, shapes=()):
            from torch.autograd import DeviceType

            self.name, self.input_shapes = name, list(shapes)
            self.time_range = type("R", (), {"start": start, "end": end})
            self.device_type = DeviceType.CPU
            self.device_time_total = self.self_device_time_total = 0.0

    stretch = devtrace.Trace([E(devtrace.STEP, 0, 10), E("aten::mm", 1, 2),
                              E("aten::bmm", 3, 4)], ())
    same = devtrace.Trace([E(devtrace.STEP, 0, 10),
                           E("aten::mm", 1, 2, [[2, 3], [3, 4]]),
                           E("aten::bmm", 3, 4, [[1, 2, 3], [1, 3, 4]])], ())
    other = devtrace.Trace([E(devtrace.STEP, 0, 10),
                            E("aten::bmm", 1, 2, [[1, 2, 3], [1, 3, 4]])], ())
    assert not stretch.take_shapes(other) and not stretch.shapes_known
    assert stretch.take_shapes(same) and stretch.shapes_known
    assert [g[1] for g in stretch.gemms] == [[[2, 3], [3, 4]],
                                             [[1, 2, 3], [1, 3, 4]]]
