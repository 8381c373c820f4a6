"""Checkpoints of the PyTorch port (``workloads/train.py``) on the CPU.

- The resume image is the JAX package's container: an image the port
  writes loads with the JAX ``_load_resume_image`` and one JAX writes
  loads in the port; each corruption gives the same classified reason on
  both sides, under the same metric names and labels.
- The committed-step ladder on the port's step directories, with the
  newest 2 retained, and its fault injection.
- The background writer: a failed write is raised at the next ``save``;
  ``finalize`` waits for the write in flight.
- Preemption: a trainer given SIGTERM exits 143 with its step committed,
  and a restart resumes from it.
- Serve and generate restore the parameters of the trainer's checkpoint
  without reading the optimizer moments.
"""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.utils.metrics import METRICS as JMETRICS  # noqa: E402
from trainingjob_operator_tpu.workloads import train as jtrain  # noqa: E402
from trainingjob_operator_tpu_torch.utils.metrics import METRICS as TMETRICS  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import rendezvous  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _numpy_tree(step):
    rng = np.random.default_rng(step)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal((4,)).astype(np.float32)},
            "opt_state": {"count": step,
                          "mu": {"w": np.zeros((3, 4), np.float32),
                                 "b": np.ones((4,), np.float32)}},
            "step": step}


def _torch_tree(tree):
    return ttrain.tree_map(lambda x: torch.from_numpy(x.copy())
                           if isinstance(x, np.ndarray) else x, tree)


def _assert_same(got, want):
    assert set(got) == set(want) if isinstance(want, dict) else True
    if isinstance(want, dict):
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    else:
        assert got == want


class TestResumeImage:
    def test_the_port_image_loads_in_jax(self, tmp_path):
        want = _numpy_tree(3)
        ttrain._write_resume_image(str(tmp_path), 3, _torch_tree(want))
        template = jax.tree.map(jnp.asarray, want)
        got = jtrain._load_resume_image(str(tmp_path), 3, template)
        _assert_same(got, want)

    def test_a_jax_image_loads_in_the_port(self, tmp_path):
        want = _numpy_tree(5)
        jtrain._write_resume_image(str(tmp_path), 5, want)
        template = _torch_tree(_numpy_tree(0))
        got = ttrain._load_resume_image(str(tmp_path), 5, template)
        _assert_same(got, want)
        assert isinstance(got["params"]["w"], torch.Tensor)

    @pytest.mark.parametrize("fault", ["missing", "flipped", "truncated",
                                       "stale", "structure"])
    def test_each_fault_takes_the_same_rung_on_both_sides(
            self, tmp_path, fault):
        reasons = {}
        for side, write, load, metrics, template in (
                ("jax", jtrain._write_resume_image, jtrain._load_resume_image,
                 JMETRICS, jax.tree.map(jnp.asarray, _numpy_tree(0))),
                ("port", ttrain._write_resume_image,
                 ttrain._load_resume_image, TMETRICS,
                 _torch_tree(_numpy_tree(0)))):
            path = tmp_path / side
            path.mkdir()
            tree = _numpy_tree(4)
            if fault == "structure":
                tree["params"]["extra"] = np.zeros(2, np.float32)
            if fault != "missing":
                write(str(path), 4, tree if side == "jax"
                      else _torch_tree(tree))
            image = path / "resume-image.bin"
            if fault == "flipped":
                raw = bytearray(image.read_bytes())
                raw[len(raw) // 2] ^= 0x01
                image.write_bytes(bytes(raw))
            elif fault == "truncated":
                image.write_bytes(image.read_bytes()[:20])
            latest = 5 if fault == "stale" else 4
            before = metrics.snapshot()
            assert load(str(path), latest, template) is None
            after = metrics.snapshot()
            reasons[side] = {k: after[k] - before.get(k, 0.0)
                             for k in after
                             if k.startswith("trainingjob_")
                             and after[k] != before.get(k, 0.0)}
        want = {"missing": "missing", "flipped": "corrupt",
                "truncated": "corrupt", "stale": "stale",
                "structure": "structure_mismatch"}[fault]
        assert reasons["port"] == reasons["jax"] == {
            f'trainingjob_resume_image_fallbacks_total{{reason="{want}"}}':
                1.0}

    def test_the_fault_injection_flips_the_image(self, tmp_path,
                                                 monkeypatch, capsys):
        ttrain._write_resume_image(str(tmp_path), 2,
                                   _torch_tree(_numpy_tree(2)))
        monkeypatch.setenv("TRAININGJOB_CKPT_FAULT", "resume_image")
        assert ttrain._load_resume_image(
            str(tmp_path), 2, _torch_tree(_numpy_tree(0))) is None
        assert "image fallback reason=corrupt (sha256 mismatch)" in \
            capsys.readouterr().out


def _rdv(tmp_path):
    return rendezvous.Rendezvous(checkpoint_dir=str(tmp_path))


def _init():
    return _torch_tree(_numpy_tree(0))


class TestStepDirectories:
    def _save_steps(self, tmp_path, steps, monkeypatch):
        monkeypatch.setenv("TRAININGJOB_CKPT_SNAPSHOT", "0")
        st = ttrain.CheckpointState.restore_or_init(_rdv(tmp_path), _init(),
                                                    subdir="t")
        for s in steps:
            st.save(_torch_tree(_numpy_tree(s)))
        st.finalize()
        return tmp_path / "t"

    def test_keeps_the_newest_two(self, tmp_path, monkeypatch):
        path = self._save_steps(tmp_path, [1, 2, 3, 4], monkeypatch)
        assert ttrain.committed_steps(str(path)) == [4, 3]
        assert sorted(os.listdir(path / "4")) == [
            "opt_state.pt", "params.pt", "step.pt"]
        # Direct mode writes no resume image: the restore reads step 4.
        st = ttrain.CheckpointState.restore_or_init(_rdv(tmp_path), _init(),
                                                    subdir="t")
        _assert_same(st.value, _numpy_tree(4))

    def test_the_ladder_falls_back_to_the_previous_step(
            self, tmp_path, monkeypatch, capsys):
        path = self._save_steps(tmp_path, [1, 2], monkeypatch)
        (path / "2" / "params.pt").write_bytes(b"torn")
        before = TMETRICS.snapshot()
        st = ttrain.CheckpointState.restore_or_init(_rdv(tmp_path), _init(),
                                                    subdir="t")
        _assert_same(st.value, _numpy_tree(1))
        key = 'trainingjob_ckpt_restore_fallbacks_total{reason=' \
              '"corrupt_latest"}'
        assert TMETRICS.snapshot()[key] - before.get(key, 0.0) == 1.0
        out = capsys.readouterr().out
        assert "reason=missing" in out  # no image in direct mode
        assert "restored previous committed step 1 (latest 2 " \
               "unreadable)" in out

    def test_every_rung_failing_raises_the_first_error(self, tmp_path,
                                                       monkeypatch):
        path = self._save_steps(tmp_path, [1, 2], monkeypatch)
        for step in ("1", "2"):
            (path / step / "params.pt").write_bytes(b"torn")
        before = TMETRICS.snapshot()
        with pytest.raises(Exception):
            ttrain.CheckpointState.restore_or_init(_rdv(tmp_path), _init(),
                                                   subdir="t")
        got = {k: v - before.get(k, 0.0) for k, v in
               TMETRICS.snapshot().items() if v != before.get(k, 0.0)}
        assert got == {
            'trainingjob_ckpt_restore_fallbacks_total{reason='
            '"corrupt_latest"}': 1.0,
            'trainingjob_ckpt_restore_fallbacks_total{reason='
            '"corrupt_retained"}': 1.0,
            'trainingjob_resume_image_fallbacks_total{reason="missing"}':
                1.0}

    def test_the_fault_injection_fails_the_latest_step(self, tmp_path,
                                                       monkeypatch):
        self._save_steps(tmp_path, [1, 2], monkeypatch)
        monkeypatch.setenv("TRAININGJOB_CKPT_FAULT", "corrupt_latest")
        st = ttrain.CheckpointState.restore_or_init(_rdv(tmp_path), _init(),
                                                    subdir="t")
        assert st.value["step"] == 1

    def test_a_step_written_again_replaces_its_directory(self, tmp_path,
                                                         monkeypatch):
        path = self._save_steps(tmp_path, [1, 2], monkeypatch)
        st = ttrain.CheckpointState(str(path), _init())
        tree = _numpy_tree(7)
        tree["step"] = 2
        st.save(_torch_tree(tree))
        got = torch.load(path / "2" / "params.pt", weights_only=True)
        np.testing.assert_array_equal(got["w"].numpy(), tree["params"]["w"])
        assert ttrain.committed_steps(str(path)) == [2, 1]

    def test_the_path_contract(self, tmp_path):
        rdv = rendezvous.Rendezvous(checkpoint_dir=str(tmp_path),
                                    replica_name="worker", replica_index=3)
        st = ttrain.CheckpointState.restore_or_init(rdv, _init())
        st.save(_torch_tree(_numpy_tree(1)), wait=True)
        assert ttrain.committed_steps(str(tmp_path / "worker" / "3")) == [1]
        assert ttrain.CheckpointState.restore_or_init(
            rendezvous.Rendezvous(), _init()).save(_init()) == 0.0


class TestWriter:
    def test_snapshot_save_commits_in_the_background(self, tmp_path):
        st = ttrain.CheckpointState(str(tmp_path), _init())
        value = _torch_tree(_numpy_tree(3))
        st.save(value)
        # The snapshot is a copy: the loop may update its tensors at once.
        value["params"]["w"].add_(1.0)
        st.finalize()
        assert st.committed_step == 3
        got = ttrain._load_resume_image(str(tmp_path), 3, _init())
        _assert_same(got, _numpy_tree(3))

    def test_a_writer_error_is_raised_at_the_next_save(self, tmp_path,
                                                       monkeypatch):
        st = ttrain.CheckpointState(str(tmp_path), _init())

        def broken(*a, **k):
            raise OSError("disk gone")

        monkeypatch.setattr(ttrain, "_write_step", broken)
        st.save(_torch_tree(_numpy_tree(1)))
        with st._cv:
            while st._pending is not None or st._busy:
                st._cv.wait(0.05)
        with pytest.raises(RuntimeError, match="background checkpoint "
                                               "write failed") as err:
            st.save(_torch_tree(_numpy_tree(2)))
        assert isinstance(err.value.__cause__, OSError)
        monkeypatch.undo()
        st.save(_torch_tree(_numpy_tree(3)))
        st.finalize()
        assert st.committed_step == 3

    def test_a_waited_save_supersedes_the_write_in_flight(
            self, tmp_path, monkeypatch):
        # A preemption save does not wait for the background write of an
        # older step: that write stops at its next file.
        import threading

        started, real = threading.Event(), torch.save

        def slow_save(obj, f, *a, **k):
            started.set()
            real(obj, f, *a, **k)
            if threading.current_thread().name == "ckpt-writer":
                time.sleep(0.5)

        monkeypatch.setattr(ttrain.torch, "save", slow_save)
        st = ttrain.CheckpointState(str(tmp_path), _init())
        st.save(_torch_tree(_numpy_tree(1)))
        assert started.wait(5)
        t0 = time.perf_counter()
        st.save(_torch_tree(_numpy_tree(2)), wait=True)
        # Without the cancel: the two files left, 0.5 s each, first.
        assert time.perf_counter() - t0 < 1.2
        st.finalize()
        assert ttrain.committed_steps(str(tmp_path)) == [2]
        assert st.committed_step == 2
        assert sorted(os.listdir(tmp_path)) == ["2", "resume-image.bin"]
        _assert_same(ttrain._load_resume_image(str(tmp_path), 2, _init()),
                     _numpy_tree(2))

    def test_finalize_raises_a_writer_error(self, tmp_path, monkeypatch):
        st = ttrain.CheckpointState(str(tmp_path), _init())
        monkeypatch.setattr(ttrain, "_write_step",
                            lambda *a, **k: 1 / 0)
        st.save(_torch_tree(_numpy_tree(1)))
        with pytest.raises(RuntimeError) as err:
            st.finalize()
        assert isinstance(err.value.__cause__, ZeroDivisionError)


def _trainer_env(ckpt, **extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update({"LLAMA_CONFIG": "tiny", "LLAMA_BATCH": "4",
                "LLAMA_SEQ": "32", "LLAMA_CKPT_EVERY": "2",
                "TRAININGJOB_CHECKPOINT_DIR": str(ckpt),
                "OMP_NUM_THREADS": "2"}, **extra)
    return env


def _run_trainer(env, sigterm_after=None, timeout=120):
    cmd = [sys.executable, "-m",
           "trainingjob_operator_tpu_torch.workloads.llama_elastic",
           "--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if sigterm_after and line.startswith(sigterm_after):
                proc.send_signal(signal.SIGTERM)
        return proc.wait(timeout=timeout), lines
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


class TestPreemption:
    def test_sigterm_commits_the_step_exits_143_and_resumes(self, tmp_path):
        env = _trainer_env(tmp_path, LLAMA_STEPS="200")
        rc, lines = _run_trainer(env, sigterm_after="step 2/200 ")
        assert rc == 143, lines
        assert lines[-1] == "preemption checkpoint committed; exiting 143"
        committed = ttrain.committed_steps(str(tmp_path / "llama"))[0]
        assert committed >= 2
        rc, lines = _run_trainer(_trainer_env(
            tmp_path, LLAMA_STEPS=str(committed + 2)))
        assert rc == 0, lines
        assert "resume: step %d restored from resume image" % committed \
            in lines
        assert f"resumed at step {committed} (width 1)" in lines
        assert any(ln.startswith(f"step {committed + 1}/{committed + 2} "
                                 f"loss ") and ln.endswith(
                                     "(first after resume)") for ln in lines)
        assert any(ln.startswith("done: ") for ln in lines)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny trainer run of 4 steps that checkpoints steps 2 and 4."""
    ckpt = tmp_path_factory.mktemp("ckpt")
    rc, lines = _run_trainer(_trainer_env(ckpt, LLAMA_STEPS="4"))
    assert rc == 0, lines
    return ckpt


class TestSamplersRestore:
    def _no_moments(self, monkeypatch):
        read = []
        real = torch.load

        def load(f, *a, **k):
            read.append(os.path.basename(str(f)))
            return real(f, *a, **k)

        monkeypatch.setattr(ttrain.torch, "load", load)
        return read

    def test_generate_reads_the_params_and_not_the_moments(
            self, trained, monkeypatch, capsys):
        from trainingjob_operator_tpu_torch.models import decode, llama
        from trainingjob_operator_tpu_torch.workloads import generate

        read = self._no_moments(monkeypatch)
        monkeypatch.setenv("TRAININGJOB_CHECKPOINT_DIR", str(trained))
        monkeypatch.setenv("GEN_STEPS", "4")
        monkeypatch.setenv("GEN_PROMPT", "1,2,3")
        monkeypatch.setenv("TRAININGJOB_RESUME_OVERLAP", "1")
        assert generate.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "sampling from checkpoint at step 4" in out
        assert read == ["params.pt", "step.pt"]
        got = [line for line in out.splitlines()
               if line.startswith("tokens:")][0]
        # The saved f32 masters, stored as the sampler's leaves (compute
        # dtype for the matmul weights), decode to the same tokens.
        cfg = llama.LlamaConfig.tiny()
        saved = torch.load(trained / "llama" / "4" / "params.pt",
                           weights_only=True)
        params = ttrain._onto(
            llama.init_params(cfg, torch.Generator(), "cpu"), saved)
        want = decode.generate(params, torch.tensor([[1, 2, 3]]), cfg,
                               steps=4)[0].tolist()
        assert got == "tokens: " + ",".join(map(str, want))

    def test_restore_with_the_placeholder_equals_what_was_saved(
            self, trained, monkeypatch):
        from trainingjob_operator_tpu_torch.models import llama

        read = self._no_moments(monkeypatch)
        cfg = llama.LlamaConfig.tiny()
        st = ttrain.CheckpointState.restore_or_init(
            rendezvous.Rendezvous(checkpoint_dir=str(trained)),
            {"params": llama.init_params(cfg, torch.Generator(), "cpu",
                                         master=True),
             "opt_state": ttrain.ckpt_placeholder(), "step": 0},
            subdir="llama")
        assert read == ["params.pt", "step.pt"]
        assert st.value["step"] == 4
        assert st.value["opt_state"] is ttrain.ckpt_placeholder()
        saved = torch.load(trained / "llama" / "4" / "params.pt",
                           weights_only=True)
        for got, want in zip(ttrain.tree_leaves(st.value["params"]),
                             ttrain.tree_leaves(saved)):
            assert torch.equal(got, want)

    def test_serve_serves_the_checkpoint(self, trained, monkeypatch,
                                         capsys):
        from trainingjob_operator_tpu_torch.workloads import serve

        read = self._no_moments(monkeypatch)
        monkeypatch.setenv("TRAININGJOB_CHECKPOINT_DIR", str(trained))
        monkeypatch.setenv("TRAININGJOB_SERVE_REQUESTS", "4")
        monkeypatch.setenv("TRAININGJOB_SERVE_SLOTS", "2")
        assert serve.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "serving the checkpoint at step 4" in out
        assert "completed=4" in out
        assert "opt_state.pt" not in read
