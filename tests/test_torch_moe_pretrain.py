"""The port's ``workloads/moe_pretrain.py`` on the CPU at MOE_CONFIG=tiny.

- What is not ported is refused at startup: MOE_TP > 1, MOE_EP > 1 and
  more than one process.
- It trains in process and prints the JAX module's params and done lines.
- As its own processes on one checkpoint directory: SIGTERM commits the
  step and exits 143, and the restart resumes there and ends on the same
  parameters and AdamW state as an uninterrupted run, bit for bit; then
  the ``generate`` and ``serve`` mains with GEN_FAMILY=moe read its
  checkpoint.
"""

import os
import signal
import subprocess
import sys
import warnings
from pathlib import Path

import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

from trainingjob_operator_tpu.models import moe as jmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe as tmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe_decode as tmd  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import moe_pretrain  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402,E501

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)


@pytest.mark.parametrize("env", [{"MOE_TP": "2"}, {"MOE_EP": "2"},
                                 {"TRAININGJOB_NUM_PROCESSES": "2"}])
def test_refuses_what_is_not_ported(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 1"):
        moe_pretrain.main(["--device", "cpu"])


def test_trains_on_the_cpu_when_asked(monkeypatch, capsys):
    monkeypatch.setenv("MOE_STEPS", "3")
    monkeypatch.setenv("MOE_BATCH", "2")
    monkeypatch.setenv("MOE_SEQ", "16")
    monkeypatch.setenv("MOE_CE_CHUNK", "8")
    monkeypatch.setenv("MOE_REMAT", "dots")
    assert moe_pretrain.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    jc = jmoe.MoEConfig.tiny()
    assert out[0] == (
        "elastic width 1, mesh {'dp': 1, 'pp': 1, 'fsdp': 1, 'tp': 1, "
        f"'sp': 1, 'ep': 1}}, {jmoe.num_params(jc) / 1e6:.1f}M params "
        f"({jmoe.active_params(jc) / 1e6:.1f}M active), restart 0")
    assert any(ln.startswith("step 3/3 loss ") for ln in out)
    assert out[-1].startswith("done: steps=2 tokens/s=")
    assert " width=1 final_loss=" in out[-1]


def _env(ckpt, steps):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"MOE_CONFIG": "tiny", "MOE_BATCH": "4", "MOE_SEQ": "32",
                "MOE_STEPS": str(steps), "MOE_CKPT_EVERY": "2",
                "TRAININGJOB_CHECKPOINT_DIR": str(ckpt),
                "OMP_NUM_THREADS": "2"})
    return env


def _run(env, sigterm_after=None, timeout=120):
    cmd = [sys.executable, "-m",
           "trainingjob_operator_tpu_torch.workloads.moe_pretrain",
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if sigterm_after and line.startswith(sigterm_after):
                proc.send_signal(signal.SIGTERM)
                sigterm_after = None
        return proc.wait(timeout=timeout), lines
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """A run given SIGTERM after step 2, its restart to two steps past the
    committed one, and an uninterrupted run to the same step."""
    ckpt = tmp_path_factory.mktemp("moe_ckpt")
    plain = tmp_path_factory.mktemp("moe_plain")
    rc, lines = _run(_env(ckpt, 200), sigterm_after="step 2/200 ")
    assert rc == 143, lines
    assert lines[-1] == "preemption checkpoint committed; exiting 143"
    k = ttrain.committed_steps(str(ckpt / "moe"))[0]
    assert k >= 2
    last = k + 2
    rc_restart, restart = _run(_env(ckpt, last))
    rc_plain, uninterrupted = _run(_env(plain, last))
    assert rc_restart == 0 and rc_plain == 0, (restart, uninterrupted)
    return ckpt, plain, k, last, restart, uninterrupted


def _saved(root, step, name):
    return torch.load(root / "moe" / str(step) / f"{name}.pt",
                      weights_only=True)


def test_a_restart_resumes_bit_for_bit(resumed):
    ckpt, plain, k, last, restart, uninterrupted = resumed
    assert f"resumed at step {k} (width 1)" in restart
    assert any(ln.startswith(f"step {k + 1}/{last} loss ")
               and ln.endswith("(first after resume)") for ln in restart)
    final = f"step {last}/{last} loss "
    assert [ln for ln in restart if ln.startswith(final)] == \
        [ln for ln in uninterrupted if ln.startswith(final)]
    for name in ("params", "opt_state"):
        got = ttrain.tree_leaves(_saved(ckpt, last, name))
        want = ttrain.tree_leaves(_saved(plain, last, name))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), name


def test_generate_and_serve_read_the_checkpoint(resumed, monkeypatch,
                                                capsys):
    from trainingjob_operator_tpu_torch.workloads import generate, serve

    ckpt, _, _, last, _, _ = resumed
    monkeypatch.setenv("TRAININGJOB_CHECKPOINT_DIR", str(ckpt))
    monkeypatch.setenv("GEN_FAMILY", "moe")
    monkeypatch.setenv("GEN_STEPS", "4")
    monkeypatch.setenv("GEN_PROMPT", "1,2,3")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        assert generate.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        cfg = tmoe.MoEConfig.tiny()
        params = ttrain._onto(tmoe.init_params(cfg, None, "cpu"),
                              _saved(ckpt, last, "params"))
        want = tmd.generate(params, torch.tensor([[1, 2, 3]]), cfg,
                            steps=4)[0].tolist()
    assert f"sampling from checkpoint at step {last}" in out
    assert "tokens: " + ",".join(map(str, want)) in out

    monkeypatch.setenv("TRAININGJOB_SERVE_REQUESTS", "4")
    monkeypatch.setenv("TRAININGJOB_SERVE_SLOTS", "2")
    assert serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"serving the checkpoint at step {last}" in out
    assert "family=moe" in out and "completed=4" in out
    assert "stale_kv_violations=0" in out
