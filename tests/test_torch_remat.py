"""The "attn" and "dots" remat policies of the PyTorch port against the JAX
package's, on the ``tiny`` config in fp32.

- Loss and every gradient under each policy equal the JAX package's under
  the same policy, and equal the port's own without remat bit for bit.
- What each side keeps for the backward: JAX's
  ``jax.ad_checkpoint.print_saved_residuals`` against the port's saved
  tensors (a ``saved_tensors_hooks`` count of what the checkpoint saves,
  and the outputs of the operators its selective policy saves), grouped
  into layer inputs, flash out, flash LSE and dot outputs.
- Whether the backward re-runs the flash forward, by a counter on its
  plain version.
"""

import contextlib
import dataclasses
import importlib
import io
import re

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.ad_checkpoint import print_saved_residuals  # noqa: E402

from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

tflash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")

#: fp32 loss and gradients against JAX (rtol = atol), as
#: tests/test_torch_train.py holds them without remat: the same math in
#: another summation order.  A tighter rtol of 1e-5 does not hold even
#: without remat (tok_embed's gradient, a scatter-add of 100 rows, differs
#: by up to 5.5e-5 absolute at an RMS of 0.077).
F32_TOL = 1e-4

torch.set_num_threads(2)

B, T = 2, 16


def _configs():
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    return jc, tllama.LlamaConfig(**jc.__dict__)


@pytest.fixture(scope="module")
def tree():
    jc, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jc, jax.random.PRNGKey(0)))


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T + 1)).astype(
        np.int32)


def _port_params(tree, tc):
    params = tllama.params_from_numpy(tree, tc, "cpu", master=True)
    for leaf in ttrain.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        out.update(_flat_torch(v, path) if isinstance(v, dict)
                   else {path: v})
    return out


def _port_loss_and_grads(tree, tc, tokens, remat):
    params = _port_params(tree, tc)
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tc,
                          remat=remat)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in _flat_torch(params).items()}


@pytest.mark.parametrize("remat", ["attn", "dots"])
def test_loss_and_every_grad_match_jax_under_the_policy(tree, remat):
    jc, tc = _configs()
    tokens = _tokens()
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, t: jllama.loss_fn(p, {"tokens": t}, jc, remat=remat)))(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
    lt, gt = _port_loss_and_grads(tree, tc, tokens, remat)
    l0, g0 = _port_loss_and_grads(tree, tc, tokens, "none")
    np.testing.assert_allclose(float(lt), float(lj), rtol=F32_TOL)
    assert torch.equal(lt, l0)
    want = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(gj)[0]}
    assert set(gt) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(gt[name].numpy(), w, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=name)
        assert torch.equal(gt[name], g0[name]), name


_RESIDUAL = re.compile(r"^(\w+)\[([\d,]*)\] (.*)$")


def _jax_residuals(tree, jc, remat):
    """(shape, description) of every residual JAX keeps for the loss's
    backward, from ``print_saved_residuals``."""
    tokens = jnp.asarray(_tokens())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(
            lambda p: jllama.loss_fn(p, {"tokens": tokens}, jc, remat=remat),
            jax.tree_util.tree_map(jnp.asarray, tree))
    out = []
    for line in buf.getvalue().splitlines():
        m = _RESIDUAL.match(line.strip())
        assert m, line
        shape = tuple(int(d) for d in m.group(2).split(",") if d)
        out.append((shape, m.group(3)))
    return out


def _jax_layer_groups(residuals, c):
    """Per layer, (count, elements) of what JAX's layer scan keeps: its
    residuals carry a leading layer dim.  Flash out is [L, B, H, T, Dh],
    the LSE [L, B, H, T]; layer inputs and dot outputs are both [L, B, T,
    width], so they make one group here."""
    L, H, Dh = c.n_layers, c.n_heads, c.head_dim
    groups = {"flash_out": [], "flash_lse": [], "inputs_and_dots": []}
    for shape, desc in residuals:
        if not desc.startswith("output of scan") or len(shape) < 4 \
                or shape[0] != L:
            continue
        per_layer = int(np.prod(shape[1:]))
        if shape[1:] == (B, H, T, Dh):
            groups["flash_out"].append(per_layer)
        elif shape[1:] == (B, H, T):
            groups["flash_lse"].append(per_layer)
        else:
            assert shape[1:3] == (B, T), shape
            groups["inputs_and_dots"].append(per_layer)
    return {k: sorted(v) for k, v in groups.items()}


def _port_kept(tree, tc, remat, monkeypatch):
    """What the port keeps inside one forward's checkpointed layers: the
    tensors the checkpoint saves (a ``saved_tensors_hooks`` pack hook) and
    the outputs of the operators the selective policy saves (every
    operator's output seen by a dispatch mode, kept where the policy says
    ``MUST_SAVE``)."""
    policy = tllama._SAVE.get(remat)
    inside = [False]
    saved, ops = [], []

    def checkpoint(*args, **kwargs):
        inside[0] = True
        try:
            return real_checkpoint(*args, **kwargs)
        finally:
            inside[0] = False

    real_checkpoint = tllama.checkpoint
    monkeypatch.setattr(tllama, "checkpoint", checkpoint)

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if inside[0] and policy is not None and policy(None, func) \
                    is tllama.CheckpointPolicy.MUST_SAVE:
                ops.append((func, out))
            return out

    def pack(t):
        if inside[0]:
            saved.append(tuple(t.shape))
        return t

    params = _port_params(tree, tc)
    with Log(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tllama.loss_fn(params, {"tokens": torch.from_numpy(_tokens())}, tc,
                       remat=remat)
    return saved, ops


@pytest.mark.parametrize("remat", ["attn", "dots", "full"])
def test_the_port_keeps_what_jax_keeps(tree, remat, monkeypatch):
    jc, tc = _configs()
    c = tc
    L, H, Dh = c.n_layers, c.n_heads, c.head_dim
    residuals = _jax_residuals(tree, jc, remat)
    jax_groups = _jax_layer_groups(residuals, c)
    saved, ops = _port_kept(tree, tc, remat, monkeypatch)

    # The checkpoint saves each layer's inputs: the residual stream h
    # [B, T, dim] and the rope tables [B, T, 1, Dh/2], which the port
    # computes once per forward and hands to every layer (cos and sin:
    # the same two tensors in every layer).  JAX computes its tables inside
    # the layer from two f32[Dh/2] frequency constants, which it keeps
    # instead ("from a constant").
    rope = (B, T, 1, Dh // 2)
    assert sorted(saved) == sorted([(B, T, c.dim), rope, rope] * L)
    constants = [s for s, d in residuals if d == "from a constant"]
    assert constants == [(Dh // 2,), (Dh // 2,)]
    inputs = [B * T * c.dim] * L

    flash = [o for f, o in ops if f is tflash.FWD_OP]
    dots = [o for f, o in ops if f is torch.ops.aten.mm.default]
    assert len(flash) + len(dots) == len(ops)
    port = {"flash_out": sorted(o[0].numel() for o in flash),
            "flash_lse": sorted(o[1].numel() for o in flash)}
    assert all(tuple(o[0].shape) == (B, T, H, Dh)
               and tuple(o[1].shape) == (B, H, T) for o in flash)
    dot_sizes = [o.numel() for o in dots]
    if remat == "dots":
        # The six products JAX keeps a layer: q, k, v, wo, w_gate and w_up.
        # w_down's output feeds the residual add alone, whose backward
        # reads nothing: JAX's partial evaluation drops it, and the port's
        # policy leaves it to the recompute.
        assert len(dot_sizes) == 6 * L
    else:
        assert dot_sizes == []
    port["inputs_and_dots"] = sorted(inputs + dot_sizes)
    for name in ("flash_out", "flash_lse", "inputs_and_dots"):
        assert port[name] == sorted(jax_groups[name] * L), name
    want_flash = L if remat == "attn" else 0
    assert len(port["flash_out"]) == want_flash


@pytest.mark.parametrize("remat,recomputed", [("none", 0), ("attn", 0),
                                              ("full", 1), ("dots", 1)])
def test_the_backward_reruns_the_flash_forward_only_where_it_must(
        tree, remat, recomputed, monkeypatch):
    _, tc = _configs()
    calls = [0]
    plain = tflash.flash_reference_with_lse

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(tflash, "flash_reference_with_lse", counted)
    params = _port_params(tree, tc)
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(_tokens())},
                          tc, remat=remat)
    forward = calls[0]
    loss.backward()
    assert forward == tc.n_layers
    assert calls[0] - forward == recomputed * tc.n_layers
