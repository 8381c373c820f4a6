"""The plain reference against the port at small sizes on the CPU (float32
both sides), the benchmark's import rules, and (on the card only) one
short run of the command."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, weights
from benchmark.entries import port
from benchmark.reference import decoder, serve as ref_serve, train as ref_train

ROOT = harness.ROOT
HOME = ROOT / "benchmark"
TINY = {"hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "num_hidden_layers": 2, "vocab_size": 256, "torch_dtype": "float32"}
FORBIDDEN = {"jax", "jaxlib", "flax", "trainingjob_operator_tpu"}


def _cfg(name, **extra):
    cfg = json.loads((HOME / "configs" / f"{name}.json").read_text())
    return {**cfg, **TINY, **extra}


CONFIGS = {"dense": _cfg("mistral-7b-pp4"),
           "moe": _cfg("mixtral-8x7b", num_local_experts=4)}


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_loss_and_gradients_equal_the_port(kind):
    cfg = CONFIGS[kind]
    seed = 2 ** 33 + 1
    tokens = weights.tokens(seed, "t", 0, (3, 33), cfg["vocab_size"], "cpu")
    model, pcfg = port.program(cfg)
    tree = weights.program_tree(cfg, seed, "cpu", master=True)
    for path, _, _ in weights.leaves(cfg):
        weights.get(tree, path).requires_grad_(True)
    loss = model.loss_fn(tree, {"tokens": tokens}, pcfg)
    loss.backward()
    ref = ref_train.init(cfg, seed, "cpu")
    want = sum(decoder.sequence_loss(ref, row, cfg) for row in tokens) / 3
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) <= \
        1e-5 * abs(float(want.detach()))
    for path, shape, lead in weights.leaves(cfg):
        grad = weights.get(tree, path).grad
        for index in weights.slices(shape, lead):
            g_ref = ref[weights.slice_key(path, index)].grad
            torch.testing.assert_close(grad[index], g_ref, rtol=1e-4,
                                       atol=1e-6 * float(g_ref.abs().max())
                                       + 1e-12)


def test_served_logits_equal_the_port_forward():
    cfg = CONFIGS["dense"]
    seed = 5
    from trainingjob_operator_tpu_torch.models import llama

    _, pcfg = port.program(cfg)
    tree = weights.program_tree(cfg, seed, "cpu", master=False,
                                compute=torch.float32)
    ids = weights.tokens(seed, "t", 1, (1, 40), cfg["vocab_size"], "cpu")
    want = llama.forward(tree, ids, pcfg)[0]
    prompt, served = ids[0, :25].tolist(), ids[0, 25:].tolist() + [0]
    got = ref_serve.served_logits(cfg, seed, [(prompt, served)], "cpu")[0]
    torch.testing.assert_close(got, want[24:], rtol=1e-4, atol=1e-5)


def test_fp8_rounding_keeps_e4m3s_three_bits():
    x = torch.randn(4096, dtype=torch.float32) * 3
    q = decoder.to_fp8(x)
    rel = ((q - x).abs() / x.abs().clamp_min(1e-3 * float(x.abs().max())))
    assert 0 < float(rel.max()) <= 2 ** -4 + 1e-6


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(where: Path):
    return [p for p in where.rglob("*.py") if "cache" not in p.parts]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources(HOME):
        top = {m.split(".", 1)[0] for m in _imports(path)}
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(HOME / "reference"):
        top = {m.split(".", 1)[0] for m in _imports(path)}
        assert "trainingjob_operator_tpu_torch" not in top, path
    code = ("import sys, benchmark.reference.train, "
            "benchmark.reference.serve, benchmark.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & (FORBIDDEN | {"trainingjob_operator_tpu_torch"})


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the command refuses to run without "
                    "one")


@pytest.mark.cuda
def test_the_command_runs_a_train_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "mistral-7b.train.s4096", "--seed", str(2 ** 31 + 9), "--seconds",
         "3", "--trace", "0"], cwd=ROOT, text=True, capture_output=True,
        env={**os.environ}, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
