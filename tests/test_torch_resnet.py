"""The port's ResNet (``models/resnet.py``, ``workloads/resnet_dp.py``,
config 3) against the JAX package's on the CPU.

- The trees are JAX's (conv weights OIHW for HWIO), at tiny and at
  ResNet-50.
- JAX's ``"SAME"`` pads, at 64 px and at 224 px, for the 7x7/2 stem, the
  3x3/2 conv2 and the 3x3/2 max pool, equal ``jax.lax.padtype_to_pads``;
  torch's symmetric ``padding=`` gives another stem output.
- The tiny config in fp32: the loss, the gradients and the new batch
  statistics of ``loss_fn`` equal JAX's ``value_and_grad(has_aux=True)``
  within ``F32_TOL``; ``train=False`` equals JAX's; the running variance
  moves toward the biased batch variance (``F.batch_norm`` would move it
  toward the unbiased one).
- One ``train.SGD`` step from optax's state (``sgd_state_from_numpy``)
  equals ``optax.sgd(0.1, momentum=0.9)``.
- Two gloo processes (``tests/_torch_workload_rank.py resnet``), each on
  its half of the batch: the loss, the summed gradients and the new
  statistics equal one process on the whole batch within ``SELF_TOL``
  (the batch statistics are the global batch's), and so do three SGD
  steps.
- The main resumes its full state: killed once its step-10 save has
  committed and restarted, it ends on the parameters, statistics and
  momenta of an uninterrupted run, bit for bit.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from test_torch_mnist import run_ranks  # noqa: E402
from trainingjob_operator_tpu.models import resnet as jresnet  # noqa: E402
from trainingjob_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from trainingjob_operator_tpu_torch.models import resnet as tresnet  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import resnet_dp  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 against JAX, and two ranks against one process (rtol = atol).
F32_TOL = 1e-5
SELF_TOL = 1e-5
LR = 0.1
B, H = 4, 32

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)


def _configs():
    jc = dataclasses.replace(jresnet.ResNetConfig.tiny(), dtype="float32")
    return jc, tresnet.ResNetConfig(**jc.__dict__)


def _flat(tree):
    return {jsharding.path_of(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nchw(images):
    return torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1,
                                                                  2)))


@pytest.fixture(scope="module")
def inputs():
    """JAX's init, every leaf and running statistic moved off its start,
    and batches of NHWC images."""
    jc, _ = _configs()
    params, stats = jresnet.init_params(jc, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), params)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1 * np.abs(rng.standard_normal(
            x.shape)).astype(np.float32), stats)

    def batch(seed):
        r = np.random.default_rng(seed)
        return {"images": r.standard_normal((B, H, H, 3)).astype(np.float32),
                "labels": r.integers(0, jc.num_classes, B).astype(np.int32)}

    return params, stats, batch(1), [batch(10 + i) for i in range(3)]


def _port(params, stats):
    p, s = tresnet.params_from_numpy(params, stats, "cpu")
    return ttrain.trainable_copy(p, "cpu"), s


def _torch_batch(batch):
    return {"images": _nchw(batch["images"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["tiny", "resnet50"])
def test_trees_are_jaxs(name):
    jc = getattr(jresnet.ResNetConfig, name)()
    tc = tresnet.ResNetConfig(**jc.__dict__)
    jp, js = jax.eval_shape(lambda: jresnet.init_params(
        jc, jax.random.PRNGKey(0)))
    tp, ts = tresnet.init_params(tc, None, "cpu")
    for jtree, ttree in ((jp, tp), (js, ts)):
        want = {jsharding.path_of(kp): tuple(x.shape) for kp, x in
                jax.tree_util.tree_flatten_with_path(jtree)[0]}
        got = {}
        for path, x in tsharding.tree_paths(ttree):
            shape = tuple(x.shape)
            if tresnet._is_conv(path):
                shape = shape[2:] + (shape[1], shape[0])
            got[path] = shape
        assert got == want
    assert tresnet.num_params(tc) == sum(int(np.prod(x.shape)) for x in
                                         jax.tree_util.tree_leaves(jp))


def _pads_of(size):
    """(size, k, stride) of every strided window of ResNet at ``size``."""
    stem_out = math.ceil(size / 2)
    pool_out = math.ceil(stem_out / 2)
    cases = [(size, 7, 2), (stem_out, 3, 2)]
    s = pool_out
    for _ in range(3):
        cases.append((s, 3, 2))
        s = math.ceil(s / 2)
    return cases


@pytest.mark.parametrize("size", [64, 224])
def test_same_pads_equal_jax(size):
    for n, k, stride in _pads_of(size):
        want = jax.lax.padtype_to_pads((n,), (k,), (stride,), "SAME")[0]
        assert tresnet.same_pads(n, k, stride) == tuple(want), (n, k)
    assert tresnet.same_pads(size, 7, 2) == (2, 3)
    assert tresnet.same_pads(size // 2, 3, 2) == (0, 1)


def test_torch_symmetric_padding_is_not_jaxs(inputs):
    params, _, batch, _ = inputs
    x = jnp.asarray(batch["images"])
    want = jax.lax.conv_general_dilated(
        x, jnp.asarray(params["stem"]["conv"]), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    w = torch.from_numpy(np.ascontiguousarray(
        params["stem"]["conv"].transpose(3, 2, 0, 1)))
    got = tresnet._conv(_nchw(batch["images"]), w, 2)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    symmetric = F.conv2d(_nchw(batch["images"]), w, stride=2, padding=3)
    assert symmetric.shape == got.shape
    assert (symmetric - got).abs().max() > 0.1
    pooled = tresnet._max_pool(got)
    want_pool = jax.lax.reduce_window(want, -jnp.inf, jax.lax.max,
                                      (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    np.testing.assert_allclose(pooled.numpy().transpose(0, 2, 3, 1),
                               np.asarray(want_pool), rtol=F32_TOL,
                               atol=F32_TOL)


def test_loss_grads_and_new_stats_equal_jax(inputs):
    params, stats, batch, _ = inputs
    jc, tc = _configs()
    (jl, jstats), jg = jax.value_and_grad(jresnet.loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, stats), _jax_batch(batch), jc)
    p, s = _port(params, stats)
    loss, new_stats = tresnet.loss_fn(p, s, _torch_batch(batch), tc)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=F32_TOL, atol=F32_TOL)
    got = tresnet.params_to_numpy(ttrain.tree_map(lambda x: x.grad, p))
    want = _flat(jg)
    assert set(got) == set(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=path)
    got_stats = {k: v.numpy() for k, v in tsharding.tree_paths(new_stats)}
    want_stats = _flat(jstats)
    assert set(got_stats) == set(want_stats)
    for path, v in want_stats.items():
        np.testing.assert_allclose(got_stats[path], v, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=path)


def test_running_var_moves_toward_the_biased_batch_variance(inputs):
    params, stats, batch, _ = inputs
    p, s = _port(params, stats)
    x = _nchw(batch["images"])
    y = tresnet._conv(x, p["stem"]["conv"].detach(), 2)
    _, new = tresnet._bn(y, p["stem"]["bn"], s["stem"], True)
    biased = y.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(new["var"], 0.9 * s["stem"]["var"]
                               + 0.1 * biased, rtol=1e-6, atol=1e-6)
    running_var = s["stem"]["var"].clone()
    F.batch_norm(y, s["stem"]["mean"].clone(), running_var, training=True,
                 momentum=0.1)
    assert (running_var - new["var"]).abs().max() > 1e-4


def test_eval_mode_equals_jax(inputs):
    params, stats, batch, _ = inputs
    jc, tc = _configs()
    want, jstats = jresnet.forward(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, stats),
        jnp.asarray(batch["images"]), jc, train=False)
    p, s = _port(params, stats)
    with torch.no_grad():
        got, new_stats = tresnet.forward(p, s, _nchw(batch["images"]), tc,
                                         train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    for path, v in tsharding.tree_paths(new_stats):
        np.testing.assert_array_equal(v.numpy(), _flat(stats)[path])


def test_one_sgd_step_from_optax_state_equals_optax(inputs):
    params, stats, batch, steps = inputs
    jc, tc = _configs()
    tx = optax.sgd(LR, momentum=0.9)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, stats)

    def grads(p, b):
        return jax.grad(lambda q: jresnet.loss_fn(q, js, _jax_batch(b),
                                                  jc)[0])(p)

    # One optax step makes a non-zero trace; the port takes it over.
    updates, state = tx.update(grads(jp, steps[0]), tx.init(jp), jp)
    jp = optax.apply_updates(jp, updates)
    trace = ttrain.sgd_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, state), "cpu",
        convert=lambda t: tresnet.params_from_numpy(t, device="cpu")[0])
    updates, state = tx.update(grads(jp, batch), state, jp)
    want = _flat(optax.apply_updates(jp, updates))

    p, s = _port(jax.tree_util.tree_map(np.asarray, jp), stats)
    step = resnet_dp.make_step(p, s, tc, lr=LR, opt_state=trace)
    tb = _torch_batch(batch)
    step(tb["images"], tb["labels"])
    got = tresnet.params_to_numpy(p)
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=path)
    got_trace = tresnet.params_to_numpy(step.opt.state["trace"])
    for path, v in _flat(state[0].trace).items():
        np.testing.assert_allclose(got_trace[path], v, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=path)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    params, stats, batch, steps = inputs

    def nchw(b):
        return {"images": np.ascontiguousarray(
            b["images"].transpose(0, 3, 1, 2)), "labels": b["labels"]}

    flat = {**{f"p/{k}": v for k, v in _flat(params).items()},
            **{f"s/{k}": v for k, v in _flat(stats).items()},
            **nchw(batch)}
    for i, b in enumerate(steps):
        flat.update({f"step{i}/{k}": v for k, v in nchw(b).items()})
    return run_ranks(flat, "resnet", 2, tmp_path_factory.mktemp("resnet"))


def test_two_gloo_ranks_equal_one_process(inputs, ranks):
    params, stats, batch, steps = inputs
    _, tc = _configs()
    p, s = _port(params, stats)
    loss, new_stats = tresnet.loss_fn(p, s, _torch_batch(batch), tc)
    loss.backward()
    grads = tresnet.params_to_numpy(ttrain.tree_map(lambda x: x.grad, p))
    new_stats = {k: v.numpy() for k, v in tsharding.tree_paths(new_stats)}

    p, s = _port(params, stats)
    step = resnet_dp.make_step(p, s, tc, lr=LR)
    losses = [float(step(**{"images": _torch_batch(b)["images"],
                            "labels": _torch_batch(b)["labels"]}))
              for b in steps]
    after = tresnet.params_to_numpy(p)
    after_stats = {k: v.numpy() for k, v in tsharding.tree_paths(s)}

    def close(got, want, path=""):
        np.testing.assert_allclose(got, want, rtol=SELF_TOL, atol=SELF_TOL,
                                   err_msg=path)

    for res in ranks:
        close(float(res["loss"]), float(loss.detach()))
        close(res["sgd/losses"], losses)
        for path, g in grads.items():
            close(res[f"grad/{path}"], g, path)
        for path, v in new_stats.items():
            close(res[f"stats/{path}"], v, path)
        for path, v in after.items():
            close(res[f"sgd/param/{path}"], v, path)
        for path, v in after_stats.items():
            close(res[f"sgd/stats/{path}"], v, path)
    # Each rank normalized its half with the whole batch's statistics:
    # those of its own half differ.
    half = tresnet.forward(*_port(params, stats),
                           _torch_batch(batch)["images"][:B // 2], tc)[1]
    assert not np.allclose(half["stem"]["mean"].detach().numpy(),
                           ranks[0]["stats/stem/mean"], atol=1e-4)


def _start(env, ckpt):
    # One thread: a CPU BLAS splits a product over the threads it finds
    # free, in another order of sums under load, and a resume is held to
    # bit identity.
    return subprocess.Popen(
        [sys.executable, "-m",
         "trainingjob_operator_tpu_torch.workloads.resnet_dp", "--device",
         "cpu"],
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
             "RESNET_BATCH": "8", "RESNET_IMAGE": "32",
             "TRAININGJOB_CHECKPOINT_DIR": str(ckpt), **env},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def test_killed_at_step_10_resumes_the_full_state_bit_for_bit(tmp_path):
    env = {"RESNET_STEPS": "12"}
    whole = _start(env, tmp_path / "whole")
    killed = _finish(_start({**env, "TRAININGJOB_KILL_AT_STEP": "10"},
                            tmp_path / "kill"))
    whole = _finish(whole)
    assert whole.returncode == 0, whole.stderr
    assert killed.returncode == -9, killed.stderr
    again = _finish(_start({**env, "TRAININGJOB_REPLICA_RESTARTCOUNT": "1"},
                           tmp_path / "kill"))
    assert again.returncode == 0, again.stderr
    assert "resumed at step 10" in again.stdout
    assert "restart_count=1" in again.stdout

    def last(out):
        return [line for line in out.splitlines() if line.startswith("step")]

    assert last(again.stdout) == last(whole.stdout)[-1:]
    for name in ("params", "stats", "opt_state", "step"):
        want = torch.load(tmp_path / "whole" / "worker" / "0" / "12" /
                          f"{name}.pt", weights_only=True)
        got = torch.load(tmp_path / "kill" / "worker" / "0" / "12" /
                         f"{name}.pt", weights_only=True)
        if name == "step":
            assert got == want == 12
            continue
        for a, b in zip(ttrain.tree_leaves(got), ttrain.tree_leaves(want)):
            assert torch.equal(a, b), name
