"""The port's routed serving path (``DecodeService(family="moe")``) against
the benchmark's plain float32 reference, on a tiny model in the shape of
the ``mixtral-8x7b-pp2`` configuration; the spans and counters of
``moe_decode._routed_mlp_token``; and the readers and byte count of the
routed serving cell.  CPU only, float32 on both sides."""

from __future__ import annotations

import contextlib
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import compare, flops_moe, harness, weights
from benchmark.entries import port
from benchmark.reference import decoder
from benchmark.reference.serve import served_logits
from trainingjob_operator_tpu_torch.models import moe_decode
from trainingjob_operator_tpu_torch.utils.metrics import METRICS
from trainingjob_operator_tpu_torch.workloads import serve

ROOT = harness.ROOT
CELL = "mixtral-8x7b.serve.chat"
TINY = {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
        "num_local_experts": 8, "num_experts_per_tok": 2,
        "capacity_factor": 4.0, "vocab_size": 256, "torch_dtype": "float32"}
SEED = 2 ** 32 + 21
COUNTERS = ("moe_decode_pairs", "moe_decode_experts_reached")


def _config(**extra):
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "mixtral-8x7b-pp2.json").read_text())
    return {**cfg, **TINY, **extra}


def _service(cfg, family="moe", chunk=8):
    _, pcfg = port.program(cfg)
    params = weights.program_tree(cfg, SEED, "cpu", master=False,
                                  compute=torch.float32)
    return serve.DecodeService(params, pcfg, slots=3, max_len=64,
                               prefill_chunk=chunk, queue_cap=8,
                               family=family, device="cpu")


def _requests(cfg, n=4):
    """``n`` seeded prompts longer than a chunk, with their answer
    lengths."""
    out = []
    for i in range(n):
        T = 11 + 5 * i
        prompt = weights.tokens(SEED, "prompt", i, (T,), cfg["vocab_size"],
                                "cpu").tolist()
        out.append((prompt, 4 + 3 * i))
    return out


def _serve_all(svc, requests):
    reqs = [svc.submit(p, n, now=1.0) for p, n in requests]
    for _ in range(500):
        if all(r.finished for r in reqs):
            break
        svc.step(now=1.0)
    assert all(r.finished for r in reqs)
    return reqs


def _counters():
    snap = METRICS.snapshot()
    return {k: snap.get(k, 0.0) for k in COUNTERS}


def test_served_tokens_agree_with_the_float32_reference():
    cfg = _config()
    svc = _service(cfg)
    requests = _requests(cfg)
    reqs = _serve_all(svc, requests)
    assert svc.prefill_calls > len(requests)        # chunked: several a prompt
    seqs = [(p, list(r.tokens)) for (p, _), r in zip(requests, reqs)]
    logits = served_logits(cfg, SEED, seqs, "cpu")
    assert compare.served_gap(logits, [s for _, s in seqs]) < 1e-4
    for lg, (_, served) in zip(logits, seqs):
        assert lg.argmax(-1).tolist() == served


def test_the_reference_capacity_drops_nothing():
    cfg = _config()
    assert [decoder.capacity(cfg, T) for T in range(1, 65)] == \
        list(range(1, 65))


def test_the_full_size_reference_capacity_drops_nothing():
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "mixtral-8x7b-pp2.json").read_text())
    for T in (1, 7, 256, 1664, 2048):
        assert decoder.capacity(cfg, T) == T


def _routed_call(seed, N):
    """One ``_routed_mlp_token`` call on N seeded rows of the tiny model's
    first layer -> (the counters' deltas, the expected deltas)."""
    cfg = _config()
    _, pcfg = port.program(cfg)
    params = weights.program_tree(cfg, SEED, "cpu", master=False,
                                  compute=torch.float32)
    layer = {"moe": {k: v[0] for k, v in params["layers"]["moe"].items()}}
    x = torch.randn(N, 1, cfg["hidden_size"],
                    generator=torch.Generator().manual_seed(seed))
    probs = torch.softmax(x[:, 0] @ layer["moe"]["router"], dim=-1)
    chosen = torch.sort(probs, dim=-1, descending=True,
                        stable=True).indices[:, :2]
    counts = torch.bincount(chosen.reshape(-1), minlength=8)
    before = _counters()
    moe_decode._routed_mlp_token(x, layer, pcfg, torch.float32)
    after = _counters()
    got = {k: after[k] - before[k] for k in COUNTERS}
    want = {"moe_decode_pairs": 2 * N,
            "moe_decode_experts_reached": int((counts > 0).sum())}
    return got, want


@pytest.mark.parametrize("N", [1, 3, 32])
def test_each_routed_call_moves_the_counters(N):
    got, want = _routed_call(N, N)
    assert got == want


def test_the_service_runs_each_layer_under_both_ranges():
    cfg = _config()
    svc = _service(cfg)
    requests = _requests(cfg, 3)
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_all(svc, requests)
    after = _counters()
    names = [e.name for e in prof.events()]
    calls = svc.decode_calls + svc.prefill_calls
    layers = cfg["num_hidden_layers"]
    assert names.count("moe.route") == layers * calls
    assert names.count("moe.experts") == layers * calls
    reached = after["moe_decode_experts_reached"] - \
        before["moe_decode_experts_reached"]
    assert layers * calls <= reached <= 8 * layers * calls
    rows = 3 * svc.decode_calls + svc.prefill_chunk * svc.prefill_calls
    assert after["moe_decode_pairs"] - before["moe_decode_pairs"] == \
        layers * rows * 2


def test_no_range_is_opened_while_no_profiler_records(monkeypatch):
    opened = []
    real = moe_decode.record_function

    def counted(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(moe_decode, "record_function", counted)
    cfg = _config()
    before = _counters()
    _serve_all(_service(cfg), _requests(cfg, 2))
    assert opened == []
    assert _counters()["moe_decode_pairs"] > before["moe_decode_pairs"]


def test_a_dense_service_moves_no_routed_counter_or_range():
    cfg = {**_config(), "num_local_experts": 0}
    svc = _service(cfg, family="llama")
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_all(svc, _requests(cfg, 2))
    assert _counters() == before
    names = {e.name for e in prof.events()}
    assert not names & {"moe.route", "moe.experts"}


def _reader(name):
    return harness.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                               f"test_metric_{name}")


def _observed(ranges=None, host=(), steps=4, counters=None):
    cell = harness.find_cell(CELL)
    trace = SimpleNamespace(ranges=ranges or {}, host=list(host), steps=steps)
    return harness.Observed(cell, trace=trace, counters=counters or {})


def test_the_experts_roofline_reads_bytes_over_the_range_time():
    cfg = harness.find_cell(CELL).config
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    reached, pairs, us = 256, 4096, 20000.0
    obs = _observed({"moe.experts": {"calls": 32, "device_us": us}},
                    counters={"moe_decode_experts_reached": reached,
                              "moe_decode_pairs": pairs})
    nbytes = reached * 3 * D * F * 2 + pairs * 2 * D * 2
    want = 100.0 * nbytes / 3.35e12 / (us / 1e6)
    assert _reader("serve.moe_experts_roofline").read(obs) == \
        pytest.approx(want, rel=1e-12)


def test_the_route_host_ms_is_the_ranges_host_time_a_tick():
    host = [("moe.route", 100.0, 350.0), ("moe.route", 1000.0, 1750.0),
            ("aten::mm", 0.0, 5000.0), ("moe.experts", 350.0, 900.0)]
    obs = _observed(host=host, steps=2)
    assert _reader("serve.moe_route_host_ms").read(obs) == \
        pytest.approx((250.0 + 750.0) / 1e3 / 2)


@pytest.mark.parametrize("name", ["serve.moe_experts_roofline",
                                  "serve.moe_route_host_ms"])
def test_the_routed_readers_find_nothing_without_the_ranges(name):
    reader = _reader(name)
    assert reader.read(harness.Observed(harness.find_cell(CELL))) is None
    obs = _observed(host=[("aten::mm", 0.0, 10.0)],
                    counters={"moe_decode_experts_reached": 0,
                              "moe_decode_pairs": 0})
    assert reader.read(obs) is None


def test_a_decode_step_of_the_cell_reads_46_70_gb_of_weights():
    cell = harness.find_cell(CELL)
    got = flops_moe.decode_weight_bytes(cell.config, cell.settings["slots"])
    L, D, F, E, V = 16, 4096, 14336, 8, 32000
    experts = L * E * 3 * D * F * 2
    attn = L * (D * D * 2 + D * 1024 * 2) * 2
    hand = (experts + attn + L * D * E * 4 + (2 * L + 1) * D * 4
            + D * V * 2 + 32 * D * 2)
    assert got == hand
    assert abs(got / 1e9 - 46.70) <= 0.01
    assert experts / got > 0.9


TINY_CELL = {"config": {**TINY, "hidden_size": 256,
                        "num_attention_heads": 8, "num_key_value_heads": 4,
                        "head_dim": 32},
             "traffic": {"prompt": {"median": 40, "sigma": 0.5, "min": 8,
                                    "max": 64},
                         "output": {"median": 12, "sigma": 0.5, "min": 4,
                                    "max": 32}},
             "cell": {"slots": 4, "max_len": 96, "prefill_chunk": 16,
                      "rate_per_s": 10.0, "warm_s": 0.3, "check_tokens": 64,
                      "trace_ticks": 6}}


def test_the_cell_runs_through_the_routed_entry():
    line = harness.run_cell(CELL, 2 ** 31 + 77, 0.3, True, "cpu",
                            overrides=TINY_CELL)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["logit_gap_mean"]["value"] < 1e-5
    assert line["metrics"]["serve.moe_route_host_ms"]["value"] > 0


def test_the_cell_runs_on_a_program_without_the_ranges(monkeypatch):
    """What the entry reads of the program's ranges and counters may be
    missing (an older program): the run is still whole, and the routed
    readers report nothing."""
    monkeypatch.setattr(moe_decode, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(moe_decode, "METRICS",
                        SimpleNamespace(inc=lambda *a, **k: None))
    line = harness.run_cell(CELL, 2 ** 31 + 77, 0.3, True, "cpu",
                            overrides=TINY_CELL)
    assert line["correct"] is True
    assert "serve.moe_route_host_ms" not in line["metrics"]
    assert "serve.moe_experts_roofline" not in line["metrics"]
    assert line["device"]["window_s"] > 0          # the stretch was traced


def test_the_mean_gap_counts_every_served_token():
    from benchmark.entries import serve_moe

    logits = [torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.5, 0.0]]),
              torch.tensor([[1.0, 1.5, 4.0]])]
    served = [[1, 1], [0]]
    assert serve_moe.mean_served_gap(logits, served) == \
        pytest.approx((0.0 + 1.5 + 3.0) / 3)
    assert compare.served_gap(logits, served) == pytest.approx(3.0)
    assert serve_moe.mean_served_gap([], []) == float("inf")


def test_tokens_the_model_did_not_pick_are_caught(monkeypatch):
    real = serve.DecodeService._emit_token

    def altered(self, sl, tok, now):
        return real(self, sl, (tok + 1) % TINY["vocab_size"], now)

    monkeypatch.setattr(serve.DecodeService, "_emit_token", altered)
    line = harness.run_cell(CELL, 2 ** 31 + 77, 0.3, False, "cpu",
                            overrides=TINY_CELL)
    assert line["correct"] is False


#: The tiny cell at the served configuration's own width, heads and
#: vocabulary (two layers, narrow experts): its logits have the cell's
#: own scale, so the control is read against the cell's own limit.
WIDE_CELL = {**TINY_CELL,
             "config": {**TINY, "hidden_size": 4096,
                        "num_attention_heads": 32, "num_key_value_heads": 8,
                        "head_dim": 128, "vocab_size": 32000},
             "cell": {**TINY_CELL["cell"], "check_tokens": 256}}


@pytest.mark.parametrize("seed", [3000000123, 2 ** 31 + 1234567])
def test_the_fp8_control_is_caught(seed):
    """The control in the program's place (at each served position the
    token the reference puts first when its products take float8
    operands, as ``benchmark/control.py`` reads it) fails the cell's
    comparison, which the program passes on the same requests."""
    from benchmark.entries import serve_moe

    cell = harness.find_cell(CELL, overrides=WIDE_CELL)
    bench = harness.Bench(cell, seed, 0.6, False, torch.device("cpu"),
                          time.perf_counter())
    out = serve_moe.run(bench)
    assert out["correct"] is True
    seqs = out["samples"]
    exact = served_logits(cell.config, seed, seqs, "cpu")
    low = served_logits(cell.config, seed, seqs, "cpu", lowp="fp8")
    picked = [lg.argmax(-1).tolist() for lg in low]
    gap = serve_moe.mean_served_gap(exact, picked)
    assert compare.verdict({"logit_gap_mean": gap},
                           cell.settings["limits"])["correct"] is False
