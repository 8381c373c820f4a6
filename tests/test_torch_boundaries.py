"""Boundaries of the PyTorch port.

- The port package and ``chip_smoke.py`` import neither ``jax``,
  ``optax``, ``orbax`` nor the JAX package (AST scan), and every port
  module imports with all of them made unimportable.
- The port's copy of the env names (serve knobs, worker identity and
  rendezvous, checkpoint, profiler, telemetry and trace knobs) agrees
  with the JAX package's.
- Without CUDA, the default-device constructors and entry points raise
  ``RuntimeError`` instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "trainingjob_operator_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "trainingjob_operator_tpu")


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported_roots(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_the_parallel_modules_are_scanned():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_files()
               if PKG in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharding.py", "parallel/collectives.py",
            "parallel/reshard.py"} <= scanned
    assert "trainingjob_operator_tpu_torch.parallel.collectives" in \
        _port_modules()


def test_the_sequence_and_pipeline_modules_are_scanned():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_files()
               if PKG in p.parents}
    assert {"parallel/ringattention.py", "parallel/pipeline.py"} <= scanned
    assert {"trainingjob_operator_tpu_torch.parallel.ringattention",
            "trainingjob_operator_tpu_torch.parallel.pipeline"} <= set(
                _port_modules())


def test_the_moe_modules_are_scanned():
    scanned = {p.relative_to(PKG).as_posix() for p in _port_files()
               if PKG in p.parents}
    assert {"models/moe.py", "models/moe_decode.py",
            "workloads/moe_pretrain.py"} <= scanned
    assert {"trainingjob_operator_tpu_torch.models.moe",
            "trainingjob_operator_tpu_torch.models.moe_decode",
            "trainingjob_operator_tpu_torch.workloads.moe_pretrain"} <= \
        set(_port_modules())


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_serve_env_names_agree_with_the_jax_package():
    from trainingjob_operator_tpu.api import constants as jconst

    from trainingjob_operator_tpu_torch import constants as tconst

    names = [n for n in dir(tconst) if n.endswith("_ENV")]
    assert len(names) == 45
    # The multi-process slice's rendezvous names.
    assert {"COORDINATOR_ADDRESS_ENV", "NUM_PROCESSES_ENV",
            "PROCESS_ID_ENV", "SLICE_ID_ENV", "NUM_SLICES_ENV"} <= set(names)
    # The training slice's checkpoint, preemption, profiler and telemetry
    # names.
    assert {"CKPT_SNAPSHOT_ENV", "CKPT_FAULT_ENV", "RESUME_OVERLAP_ENV",
            "PROFILE_DIR_ENV", "PROFILE_STEPS_ENV", "HBM_SAMPLE_STEPS_ENV",
            "TELEMETRY_ADDR_ENV", "JOB_NAMESPACE_ENV", "JOB_NAME_ENV",
            "REPLICA_NAME_ENV", "REPLICA_INDEX_ENV", "MODEL_FLOPS_ENV",
            "PEAK_FLOPS_ENV", "TRACE_CONTEXT_ENV", "TRACE_DIR_ENV",
            "REPLICA_RESTART_COUNT_ENV", "ELASTIC_REPLICAS_ENV"} <= set(names)
    # The elastic-resize slice's channel, knobs and fault injection.
    assert {"RESIZE_DIR_ENV", "RENDEZVOUS_GENERATION_ENV", "RESIZE_POLL_ENV",
            "RESIZE_FASTPATH_ENV", "RESIZE_LIVE_ENV", "RESIZE_BARRIER_ENV",
            "RESIZE_FAULT_ENV"} <= set(names)
    # The worker's pod contract: reservation, platform, kernel cache.
    assert {"RESERVATION_ENV", "RESERVATION_TTL_ENV", "JAX_PLATFORM_ENV",
            "COMPILE_CACHE_DIR_ENV", "COMPILE_CACHE_ENV"} <= set(names)
    for name in names:
        assert getattr(tconst, name) == getattr(jconst, name)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def tiny_cpu_params():
    from trainingjob_operator_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    return cfg, llama.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")


class TestCudaByDefault:
    def test_constructors_raise(self, no_cuda, tiny_cpu_params):
        from trainingjob_operator_tpu_torch import resolve_device
        from trainingjob_operator_tpu_torch.data.loader import Prefetcher
        from trainingjob_operator_tpu_torch.models import decode, llama, moe
        from trainingjob_operator_tpu_torch.workloads import serve, train

        cfg, params = tiny_cpu_params
        moe_cfg = moe.MoEConfig.tiny()
        calls = [
            lambda: moe.init_params(moe_cfg, torch.Generator()),
            lambda: moe.params_from_numpy({}, moe_cfg),
            lambda: serve.DecodeService(params, moe_cfg, family="moe"),
            lambda: resolve_device(),
            lambda: llama.init_params(cfg, torch.Generator()),
            lambda: llama.params_from_numpy({}, cfg),
            lambda: decode.init_cache(cfg, 1, 8),
            lambda: serve.DecodeService(params, cfg),
            lambda: Prefetcher(torch.tensor, 0, 1),
            lambda: train.StepProfiler(),
            lambda: train.adamw_state_from_numpy(()),
            lambda: train.run_elastic_loop(
                step_fn=None, batch_at=None, state=None, params={},
                opt_state={}, steps=1, start_step=0, ckpt_every=1),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
        assert resolve_device("cpu") == torch.device("cpu")

    @pytest.mark.parametrize("module", ["serve", "generate", "llama_elastic",
                                        "moe_pretrain"])
    def test_main_raises_before_any_work(self, no_cuda, monkeypatch, module):
        import importlib

        from trainingjob_operator_tpu_torch.models import llama, moe

        def must_not_run(*a, **k):
            raise AssertionError("main ran work without a device")

        monkeypatch.setattr(llama, "init_params", must_not_run)
        monkeypatch.setattr(moe, "init_params", must_not_run)
        main = importlib.import_module(
            f"trainingjob_operator_tpu_torch.workloads.{module}").main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])

    @pytest.mark.parametrize("module", ["serve", "generate"])
    def test_moe_main_raises_before_any_work(self, no_cuda, monkeypatch,
                                             module):
        import importlib

        from trainingjob_operator_tpu_torch.models import moe

        def must_not_run(*a, **k):
            raise AssertionError("main ran work without a device")

        monkeypatch.setattr(moe, "init_params", must_not_run)
        monkeypatch.setenv("GEN_FAMILY", "moe")
        main = importlib.import_module(
            f"trainingjob_operator_tpu_torch.workloads.{module}").main
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([])

    def test_main_runs_on_the_cpu_when_asked(self, monkeypatch, capsys):
        from trainingjob_operator_tpu_torch.workloads import generate

        monkeypatch.setenv("GEN_STEPS", "3")
        monkeypatch.setenv("GEN_PROMPT", "1,2,3")
        assert generate.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "random init" in out
        tokens = [line for line in out.splitlines()
                  if line.startswith("tokens:")]
        assert len(tokens) == 1 and len(tokens[0].split(",")) == 3

    def test_serve_main_on_the_cpu(self, monkeypatch, capsys):
        from trainingjob_operator_tpu_torch.workloads import serve

        monkeypatch.setenv("TRAININGJOB_SERVE_REQUESTS", "6")
        monkeypatch.setenv("TRAININGJOB_SERVE_SLOTS", "2")
        monkeypatch.setenv("TRAININGJOB_SERVE_PREFILL_CHUNK", "8")
        assert serve.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "completed=6" in out and "stale_kv_violations=0" in out
