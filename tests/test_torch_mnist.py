"""The port's MNIST trainer (``workloads/mnist.py``, config 1) against the
JAX package's ``workloads/mnist.py`` on the CPU.

- The loss, its gradients and one Adam update equal JAX's, rebuilt from
  the JAX main's own ``loss_fn`` and ``optax.adam``, within ``F32_TOL``.
- Fed JAX's own draws (its init and ``synthetic_mnist`` from
  ``PRNGKey(0)``), the port's ``train`` prints the JAX ``main``'s loss
  lines, character for character.
- Two gloo processes (``tests/_torch_workload_rank.py mnist``), each on
  its half of every batch, equal one process on the whole batches within
  ``F32_TOL``: the averaged gradients are the global batch's.
- The main, killed once its step-20 save has committed and restarted,
  prints ``steps=20`` and ``restart_count=1``, and ends on the parameters
  of an uninterrupted run bit for bit.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from trainingjob_operator_tpu.workloads import mnist as jmnist  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import mnist as tmnist  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 loss, gradients and updated parameters against JAX, and two ranks
#: against one process (rtol = atol).
F32_TOL = 1e-6

ROOT = Path(__file__).resolve().parent.parent
RANK = ROOT / "tests" / "_torch_workload_rank.py"

torch.set_num_threads(2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(inputs, mode, world, work, timeout=120, extra_env=None):
    """Start ``world`` gloo processes of ``_torch_workload_rank.py mode``
    on ``inputs`` (name -> numpy), wait for them, and return each rank's
    outputs."""
    src = work / f"{mode}-inputs.npz"
    np.savez(src, **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
           "TRAININGJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "TRAININGJOB_NUM_PROCESSES": str(world), **(extra_env or {})}
    procs = [subprocess.Popen(
        [sys.executable, str(RANK), str(src),
         str(work / f"{mode}-rank{r}.npz"), mode],
        env={**env, "TRAININGJOB_PROCESS_ID": str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    return [dict(np.load(work / f"{mode}-rank{r}.npz"))
            for r in range(world)]


def _jax_loss(p, x, y):
    # mnist.py:87-90, verbatim.
    h = jax.nn.relu(x @ p["w1"] + p["b1"])
    logits = h @ p["w2"] + p["b2"]
    return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()


def _inputs(hidden=32, batch=16, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w1": rng.standard_normal((784, hidden)) * 0.05,
              "b1": rng.standard_normal(hidden) * 0.01,
              "w2": rng.standard_normal((hidden, 10)) * 0.05,
              "b2": rng.standard_normal(10) * 0.01}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((batch, 784)).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    return params, x, y


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_loss_grads_and_one_adam_update_equal_jax():
    params, x, y = _inputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jl, jg = jax.value_and_grad(_jax_loss)(jp, jnp.asarray(x),
                                           jnp.asarray(y))
    tx = optax.adam(1e-3)
    updates, _ = tx.update(jg, tx.init(jp), jp)
    jnew = optax.apply_updates(jp, updates)

    tp = tmnist.params_from_numpy(params, "cpu")
    for p in tp.values():
        p.requires_grad_(True)
    opt = ttrain.AdamW(tp, 1e-3, b2=0.999, weight_decay=0.0)
    step = tmnist.make_step(tp, opt)
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    _close(float(loss), float(jl))
    for k in params:
        _close(tp[k].grad.numpy(), np.asarray(jg[k]))
        _close(tp[k].detach().numpy(), np.asarray(jnew[k]))
    assert opt.state["count"] == 1


def test_train_fed_jax_draws_prints_jax_mains_losses(monkeypatch, capsys,
                                                     tmp_path):
    steps, hidden, batch = 40, 32, 32
    for key, value in (("MNIST_STEPS", steps), ("MNIST_HIDDEN", hidden),
                       ("MNIST_BATCH", batch)):
        monkeypatch.setenv(key, str(value))
    monkeypatch.delenv("TRAININGJOB_CHECKPOINT_DIR", raising=False)
    assert jmnist.main() == 0
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("step ")]
    assert len(want) == 2

    # mnist.py:63-83: the init and the data of process 0.
    k1, k2, kdata = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"w1": jax.random.normal(k1, (784, hidden)) * 0.05,
              "b1": jnp.zeros((hidden,)),
              "w2": jax.random.normal(k2, (hidden, 10)) * 0.05,
              "b2": jnp.zeros((10,))}
    images, labels = jmnist.synthetic_mnist(jax.random.fold_in(kdata, 0),
                                            steps * batch, batch)
    out = tmnist.train(
        tmnist.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 "cpu"),
        torch.from_numpy(np.array(images)),
        torch.from_numpy(np.array(labels)), lr=1e-3)
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("step ")]
    assert got == want
    assert sorted(out["losses"]) == [20, 40]
    assert out["losses"][40] < out["losses"][20]


def test_two_gloo_ranks_equal_one_process_on_the_whole_batches(tmp_path):
    params, _, _ = _inputs(seed=1)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((4, 16, 784)).astype(np.float32)
    labels = rng.integers(0, 10, (4, 16)).astype(np.int64)
    ranks = run_ranks({**{f"p/{k}": v for k, v in params.items()},
                       "images": images, "labels": labels}, "mnist", 2,
                      tmp_path)

    tp = tmnist.params_from_numpy(params, "cpu")
    for p in tp.values():
        p.requires_grad_(True)
    step = tmnist.make_step(
        tp, ttrain.AdamW(tp, 1e-3, b2=0.999, weight_decay=0.0))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
              for x, y in zip(images, labels)]
    for res in ranks:
        _close(res["losses"], losses)
        for k in params:
            _close(res[f"param/{k}"], tp[k].detach().numpy())
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])


def _start(env, ckpt):
    # One thread: a CPU BLAS splits a product over the threads it finds
    # free, in another order of sums under load, and a resume is held to
    # bit identity.
    return subprocess.Popen(
        [sys.executable, "-m",
         "trainingjob_operator_tpu_torch.workloads.mnist", "--device", "cpu"],
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
             "MNIST_STEPS": "40", "MNIST_HIDDEN": "32", "MNIST_BATCH": "32",
             "TRAININGJOB_CHECKPOINT_DIR": str(ckpt), **env},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    """(returncode, stdout, stderr) of a process ``_start`` began."""
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _main(env, ckpt):
    return _finish(_start(env, ckpt))


def test_killed_and_restarted_resumes_at_step_20_bit_for_bit(tmp_path):
    # The uninterrupted run beside the one that is killed.
    whole = _start({}, tmp_path / "whole")
    killed = _main({"TRAININGJOB_KILL_AT_STEP": "20"}, tmp_path / "kill")
    whole = _finish(whole)
    assert whole.returncode == 0, whole.stderr
    assert killed.returncode == -9, killed.stderr
    assert "step 20/40" in killed.stdout and "step 40/40" not in \
        killed.stdout
    again = _main({"TRAININGJOB_REPLICA_RESTARTCOUNT": "1"},
                  tmp_path / "kill")
    assert again.returncode == 0, again.stderr
    assert "steps=20 " in again.stdout and "restart_count=1" in again.stdout
    assert "step 20/40" not in again.stdout

    def last(out):
        return [line for line in out.splitlines()
                if line.startswith("step 40/40")]

    assert last(again.stdout) == last(whole.stdout) != []
    for name in ("params", "opt_state"):
        want = torch.load(tmp_path / "whole" / "worker" / "0" / "40" /
                          f"{name}.pt", weights_only=True)
        got = torch.load(tmp_path / "kill" / "worker" / "0" / "40" /
                         f"{name}.pt", weights_only=True)
        for a, b in zip(ttrain.tree_leaves(got), ttrain.tree_leaves(want)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)
            else:
                assert a == b


def test_main_refuses_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmnist.main([])
