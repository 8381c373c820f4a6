"""The worker's pod contract in every port main, on the CPU.

Every main runs ``rendezvous.prepare_worker`` first, as every JAX main
runs ``initialize_jax_distributed`` first:

- A re-expand reservation pod (``TRAININGJOB_RESERVATION=1``, a TTL of one
  second) idles, then exits 143, before it touches the device: no
  ``--device`` is given, so on a host without CUDA a main that went on
  would raise its no-CUDA ``RuntimeError``.  It makes no checkpoint or
  cache directory.  JAX's MNIST main does the same under the same env.
- ``TRAININGJOB_JAX_PLATFORM`` picks the device where ``--device`` is not
  given: ``cpu`` trains on the CPU, ``gpu``/``cuda`` asks for the card, and
  another value raises ``ValueError``; unset, the main still raises
  ``RuntimeError`` without CUDA.  An explicit ``--device`` wins.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

from trainingjob_operator_tpu.workloads import rendezvous as jrdv  # noqa: E402
from trainingjob_operator_tpu_torch import constants  # noqa: E402
from trainingjob_operator_tpu_torch.ops import _build  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import rendezvous  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

PORT_MAINS = ["llama_elastic", "moe_pretrain", "mnist", "bert_pretrain",
              "resnet_dp", "serve", "generate"]
#: Seconds a reservation process may take: the TTL, plus the imports on a
#: loaded host.
HOLD_LIMIT_S = 60


@pytest.fixture(scope="module")
def reservations(tmp_path_factory):
    """Every port main and JAX's MNIST main as a reservation pod with a
    one-second TTL, all started together: {module: (rc, seconds, output,
    checkpoint dir)}."""
    work = tmp_path_factory.mktemp("reservation")
    mains = ([(f"trainingjob_operator_tpu_torch.workloads.{m}", m)
              for m in PORT_MAINS]
             + [("trainingjob_operator_tpu.workloads.mnist", "jax_mnist")])
    procs = {}
    try:
        for module, name in mains:
            env = dict(os.environ)
            env.pop("PYTHONPATH", None)
            env.pop(constants.JAX_PLATFORM_ENV, None)
            env.update({constants.RESERVATION_ENV: "1",
                        constants.RESERVATION_TTL_ENV: "1",
                        constants.CHECKPOINT_DIR_ENV: str(work / name),
                        constants.COORDINATOR_ADDRESS_ENV: "127.0.0.1:1",
                        constants.NUM_PROCESSES_ENV: "4",
                        constants.PROCESS_ID_ENV: "7",
                        "OMP_NUM_THREADS": "1"})
            procs[name] = (time.time(), subprocess.Popen(
                [sys.executable, "-m", module], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        out = {}
        for name, (t0, proc) in procs.items():
            text = proc.communicate(timeout=HOLD_LIMIT_S * 2)[0]
            out[name] = (proc.returncode, time.time() - t0, text,
                         work / name)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


@pytest.mark.parametrize("name", PORT_MAINS + ["jax_mnist"])
def test_a_reservation_pod_holds_then_exits_143(reservations, name):
    rc, secs, text, ckpt = reservations[name]
    assert rc == 143, text
    assert 1.0 <= secs < HOLD_LIMIT_S, text
    # It stopped before the device: without CUDA a main that went on
    # would raise; and it made no checkpoint or cache directory.
    assert "CUDA is not available" not in text, text
    assert "Traceback" not in text, text
    assert not ckpt.exists()


def test_the_reservation_fields_agree_with_the_jax_package():
    for env in ({}, {constants.RESERVATION_ENV: "1"},
                {constants.RESERVATION_ENV: "0",
                 constants.RESERVATION_TTL_ENV: "oops"},
                {constants.RESERVATION_ENV: "1",
                 constants.RESERVATION_TTL_ENV: "30"}):
        assert (rendezvous.from_env(env).is_reservation
                == jrdv.from_env(env).is_reservation)
    rdv = rendezvous.from_env({constants.RESERVATION_ENV: "1",
                               constants.RESERVATION_TTL_ENV: "30"})
    assert rdv.reservation_ttl == 30.0


def test_the_hold_without_a_ttl_has_no_end():
    slept = []

    def sleep(s):
        slept.append(s)
        if len(slept) == 3:
            raise KeyboardInterrupt

    rdv = rendezvous.Rendezvous(is_reservation=True)
    with pytest.raises(KeyboardInterrupt):
        rdv.hold_reservation_if_needed(sleep=sleep)
    assert slept == [3600, 3600, 3600]


def test_the_hold_ends_at_the_ttl_with_143():
    rdv = rendezvous.Rendezvous(is_reservation=True, reservation_ttl=0.2)
    t0 = time.time()
    with pytest.raises(SystemExit) as exc:
        rdv.hold_reservation_if_needed()
    assert exc.value.code == 143
    assert 0.2 <= time.time() - t0 < 5


def test_a_worker_that_is_no_reservation_passes():
    rendezvous.Rendezvous().hold_reservation_if_needed(
        sleep=lambda s: pytest.fail("a worker must not hold"))


# -- the platform override --------------------------------------------------

PLATFORM = constants.JAX_PLATFORM_ENV


@pytest.mark.parametrize("value,device", [("cpu", "cpu"), ("gpu", "cuda"),
                                          ("cuda", "cuda"), ("", "cuda"),
                                          ("CPU", "cpu")])
def test_platform_device(value, device):
    assert rendezvous.platform_device(env={PLATFORM: value}) == device
    assert rendezvous.platform_device(env={}) == "cuda"


@pytest.mark.parametrize("value", ["tpu", "cpux", "cuda,cpu"])
def test_an_unknown_platform_raises(value):
    with pytest.raises(ValueError, match="expected one of cpu, gpu, cuda"):
        rendezvous.platform_device(env={PLATFORM: value})


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_build, "_cache_dir", None)
    for name in (constants.CHECKPOINT_DIR_ENV, constants.RESERVATION_ENV,
                 constants.COMPILE_CACHE_DIR_ENV, constants.COMPILE_CACHE_ENV,
                 constants.COORDINATOR_ADDRESS_ENV, PLATFORM):
        monkeypatch.delenv(name, raising=False)


def _main(module):
    import importlib

    return importlib.import_module(
        f"trainingjob_operator_tpu_torch.workloads.{module}").main


def test_cpu_runs_the_tiny_trainer_without_device(no_cuda, monkeypatch,
                                                  capsys):
    monkeypatch.setenv(PLATFORM, "cpu")
    monkeypatch.setenv("LLAMA_CONFIG", "tiny")
    monkeypatch.setenv("LLAMA_STEPS", "2")
    monkeypatch.setenv("LLAMA_SEQ", "16")
    assert _main("llama_elastic")([]) == 0
    out = capsys.readouterr().out
    assert "device cpu" in out and "done: steps=1" in out


def test_cpu_runs_mnist_without_device(no_cuda, monkeypatch, capsys):
    monkeypatch.setenv(PLATFORM, "cpu")
    monkeypatch.setenv("MNIST_STEPS", "20")
    monkeypatch.setenv("MNIST_HIDDEN", "16")
    monkeypatch.setenv("MNIST_BATCH", "8")
    assert _main("mnist")([]) == 0
    assert "done: steps=20" in capsys.readouterr().out


@pytest.mark.parametrize("module", PORT_MAINS)
def test_tpu_raises_value_error(no_cuda, monkeypatch, module):
    monkeypatch.setenv(PLATFORM, "tpu")
    with pytest.raises(ValueError, match="TRAININGJOB_JAX_PLATFORM='tpu'"):
        _main(module)([])


@pytest.mark.parametrize("value", ["", "gpu", "cuda"])
def test_unset_or_the_card_still_raises_without_cuda(no_cuda, monkeypatch,
                                                     value):
    if value:
        monkeypatch.setenv(PLATFORM, value)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _main("llama_elastic")([])


def test_an_explicit_device_wins(no_cuda, monkeypatch, capsys):
    monkeypatch.setenv(PLATFORM, "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _main("generate")(["--device", "cuda"])
    monkeypatch.setenv(PLATFORM, "tpu")
    monkeypatch.setenv("GEN_STEPS", "2")
    assert _main("generate")(["--device", "cpu"]) == 0
    assert "tokens:" in capsys.readouterr().out
