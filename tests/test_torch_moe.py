"""PyTorch port of ``models/moe.py`` against the JAX package at the MoE
``tiny`` config (D=64, 2 layers, 4 heads / 2 KV heads, 4 experts, top 2),
in fp32.

One JAX parameter tree (numpy leaves) feeds both packages through
``params_from_numpy``; the JAX forward runs its XLA path on the CPU (its
flash attention and RMSNorm through their XLA references).

Tolerances:

- routing (``_dispatch_combine``) on identical probabilities: exact, atol
  0 -- the same comparisons, cumsums of 0/1 and one division per gate;
- everything downstream of the router (``_moe_mlp``, ``forward``,
  ``loss_fn``, every gradient, the AdamW trajectory): ``F32_TOL``, rtol =
  atol, the same math in another summation order.
"""

import contextlib
import dataclasses
import io
import re
import socket

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.ad_checkpoint import print_saved_residuals  # noqa: E402

from trainingjob_operator_tpu.models import moe as jmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe as tmoe  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import llama_elastic as telastic  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 (rtol = atol) against JAX: the same math in another summation
#: order through 2 layers.
F32_TOL = 1e-4

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)


def _configs(dtype="float32", **kw):
    jc = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=dtype, **kw)
    return jc, tmoe.MoEConfig(**jc.__dict__)


@pytest.fixture(scope="module")
def tree():
    jc, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jmoe.init_params(jc, jax.random.PRNGKey(0)))


def _tokens(B=2, T=13, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_params(tree, tc):
    params = tmoe.params_from_numpy(tree, tc, "cpu", master=True)
    for leaf in ttrain.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _close(got, want, tol=F32_TOL, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probs(B, T, E, seed):
    logits = np.random.default_rng(seed).standard_normal((B, T, E)) * 2
    return np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))


class TestDispatchCombine:
    @pytest.mark.parametrize("k,capacity", [(1, 16), (1, 3), (2, 16),
                                            (2, 5)])
    def test_exact_against_jax(self, k, capacity):
        probs = _probs(2, 16, 4, seed=k * 10 + capacity)
        dj, cj = jmoe._dispatch_combine(jnp.asarray(probs), k, capacity)
        dt, ct = tmoe._dispatch_combine(torch.from_numpy(probs), k,
                                        capacity)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        kept = int(dt.sum())
        if capacity < 16:
            # Tight: some assignment overflowed its expert and dropped.
            assert kept < 2 * 16 * k
        else:
            assert kept == 2 * 16 * k

    def test_ties_route_to_the_lower_expert_as_in_jax(self):
        # Rows of equal probabilities: jax.lax.top_k takes the lower index
        # first, and so must the port, or the tied tokens route elsewhere.
        rows = [[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                [0.3, 0.2, 0.3, 0.2], [0.4, 0.2, 0.2, 0.2]] * 3
        probs = np.asarray(rows, np.float32)[None]
        dj, cj = jmoe._dispatch_combine(jnp.asarray(probs), 2, 4)
        dt, ct = tmoe._dispatch_combine(torch.from_numpy(probs), 2, 4)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        # Token 0's tie over all four goes to experts 0 and 1.
        assert dt[0, 0].sum(-1).tolist() == [1.0, 1.0, 0.0, 0.0]


class TestMoEMlp:
    @pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
    def test_output_and_aux_match_jax(self, tree, capacity_factor):
        jc, tc = _configs(capacity_factor=capacity_factor)
        h = np.random.default_rng(3).standard_normal((2, 13, 64)).astype(
            np.float32)
        layer = jax.tree_util.tree_map(lambda a: a[1], tree["layers"])
        yj, auxj = jmoe._moe_mlp(jnp.asarray(h), _jax(layer), jc,
                                 jnp.float32)
        tl = tmoe.params_from_numpy(layer, tc, "cpu")
        yt, auxt = tmoe._moe_mlp(torch.from_numpy(h), tl, tc, torch.float32)
        assert yt.shape == (2, 13, 64) and auxt.dtype == torch.float32
        _close(yt.numpy(), yj)
        _close(float(auxt), float(auxj))


class TestForward:
    @pytest.mark.parametrize("window", [0, 5])
    def test_logits_aux_and_kv_match_jax(self, tree, window):
        jc, tc = _configs(sliding_window=window)
        tokens = _tokens()
        lj, auxj, (kj, vj) = jmoe.forward(_jax(tree), jnp.asarray(tokens),
                                          jc, return_kv=True)
        tp = tmoe.params_from_numpy(tree, tc, "cpu")
        lt, auxt, (kt, vt) = tmoe.forward(
            tp, torch.from_numpy(tokens).long(), tc, return_kv=True)
        assert lt.dtype == torch.float32 and lt.shape == (2, 13, 256)
        assert kt.shape == (2, 2, 13, 2, 16)
        for got, want in ((lt, lj), (kt, kj), (vt, vj)):
            _close(got.numpy(), want)
        _close(float(auxt), float(auxj))

    def test_return_hidden_matches_jax(self, tree):
        jc, tc = _configs()
        tokens = _tokens()
        hj, auxj = jmoe.forward(_jax(tree), jnp.asarray(tokens), jc,
                                return_hidden=True)
        tp = tmoe.params_from_numpy(tree, tc, "cpu")
        ht, auxt = tmoe.forward(tp, torch.from_numpy(tokens).long(), tc,
                                return_hidden=True)
        _close(ht.numpy(), hj)
        _close(float(auxt), float(auxj))
        with pytest.raises(ValueError, match="mutually exclusive"):
            tmoe.forward(tp, torch.from_numpy(tokens).long(), tc,
                         return_hidden=True, return_kv=True)


def _jax_loss_and_grads(tree, jc, tokens, remat, ce_chunk):
    return jax.jit(jax.value_and_grad(
        lambda p, t: jmoe.loss_fn(p, {"tokens": t}, jc, remat=remat,
                                  ce_chunk=ce_chunk)))(
        _jax(tree), jnp.asarray(tokens))


def _port_loss_and_grads(tree, tc, tokens, remat, ce_chunk):
    params = _port_params(tree, tc)
    loss = tmoe.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tc,
                        remat=remat, ce_chunk=ce_chunk)
    loss.backward()
    return loss.detach(), {
        name: leaf.grad for name, leaf in _flat(params).items()}


class TestLossAndGrads:
    @pytest.mark.parametrize("remat,ce_chunk", [
        ("none", 0), ("none", 8), ("full", 0), ("attn", 0), ("dots", 0),
        ("dots", 8)])
    def test_loss_and_every_grad_match_jax(self, tree, remat, ce_chunk):
        jc, tc = _configs()
        tokens = _tokens(T=17)
        lj, gj = _jax_loss_and_grads(tree, jc, tokens, remat, ce_chunk)
        lt, gt = _port_loss_and_grads(tree, tc, tokens, remat, ce_chunk)
        _close(float(lt), float(lj))
        want = _flat(gj)
        assert set(gt) == set(want)
        for name, w in want.items():
            _close(gt[name].numpy(), w, name=name)
        if remat != "none":
            # The policy changes what the backward keeps, not its numbers.
            _, g0 = _port_loss_and_grads(tree, tc, tokens, "none", ce_chunk)
            for name in gt:
                assert torch.equal(gt[name], g0[name]), name

    def test_ce_chunk_must_divide_and_a_mesh_is_refused(self, tree):
        # ce_chunk must divide T; on a real one-rank mesh (a gloo group of
        # one) the loss and its chunked form equal the one-process ones,
        # and the kv stack, which the mesh path does not return, is
        # refused.
        import torch.distributed as dist

        from trainingjob_operator_tpu_torch.parallel import mesh as tmesh
        from trainingjob_operator_tpu_torch.workloads import rendezvous

        _, tc = _configs()
        params = _port_params(tree, tc)
        batch = {"tokens": torch.from_numpy(_tokens(T=17))}
        with pytest.raises(ValueError, match="does not divide"):
            tmoe.loss_fn(params, batch, tc, ce_chunk=5)
        rdv = rendezvous.Rendezvous(
            coordinator_address=f"127.0.0.1:{_free_port()}")
        rendezvous.initialize_distributed(rdv, torch.device("cpu"))
        try:
            mesh = tmesh.make_mesh(tmesh.mesh_spec_from_rendezvous(
                rdv, expert_parallel=1), "cpu")
            assert mesh.sizes["ep"] == 1
            for ce_chunk in (0, 8):
                want = tmoe.loss_fn(params, batch, tc, ce_chunk=ce_chunk)
                got = tmoe.loss_fn(params, batch, tc, ce_chunk=ce_chunk,
                                   mesh=mesh)
                assert torch.equal(got, want), ce_chunk
            with pytest.raises(ValueError, match="return_kv is not "
                                                 "supported with a mesh"):
                tmoe.forward(params, batch["tokens"][:, :-1], tc,
                             return_kv=True, mesh=mesh)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()


_RESIDUAL = re.compile(r"^(\w+)\[([\d,]*)\] (.*)$")


def _jax_layer_residuals(tree, jc, tokens, remat):
    """Per-layer element counts of what JAX's layer scan keeps for the
    backward (``print_saved_residuals``: outputs of the scan, whose leading
    dim is the layer)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_saved_residuals(
            lambda p: jmoe.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jc,
                                   remat=remat), _jax(tree))
    sizes = []
    for line in buf.getvalue().splitlines():
        m = _RESIDUAL.match(line.strip())
        shape = tuple(int(d) for d in m.group(2).split(",") if d)
        if m.group(3).startswith("output of scan") and len(shape) >= 4 \
                and shape[0] == jc.n_layers:
            sizes.append(int(np.prod(shape[1:])))
    return sorted(sizes)


def _port_saved_products(tree, tc, tokens, remat, monkeypatch):
    """The outputs the port's selective policy saves (``MUST_SAVE``) inside
    the checkpointed layers of one forward, as (operator, element
    count)."""
    policy = tllama._SAVE[remat]
    inside = [False]
    saved = []

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
            if inside[0] and policy(None, func) \
                    is tllama.CheckpointPolicy.MUST_SAVE:
                saved.append((func, out.numel()))
            return out

    params = _port_params(tree, tc)
    with Log():
        tmoe.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tc,
                     remat=remat)
    return saved


@pytest.mark.parametrize("B", [1, 2])
def test_dots_keeps_the_products_jax_keeps(tree, B, monkeypatch):
    # JAX's dots_with_no_batch_dims_saveable keeps q, k, v, wo and the
    # router a layer; the dispatch and combine (batched over b) and the
    # expert products (batched over e) are recomputed -- at B = 1 too,
    # where a flattened product could lower to a plain ``mm``.
    jc, tc = _configs()
    tokens = _tokens(B=B, T=17)
    kept = _jax_layer_residuals(tree, jc, tokens, "dots")
    inputs = _jax_layer_residuals(tree, jc, tokens, "full")
    for size in inputs:
        kept.remove(size)
    saved = _port_saved_products(tree, tc, tokens, "dots", monkeypatch)
    assert {f for f, _ in saved} == {torch.ops.aten.mm.default}
    assert len(saved) == 5 * tc.n_layers
    assert sorted(n for _, n in saved) == sorted(kept * tc.n_layers)
    D, E, kv = tc.dim, tc.n_experts, tc.n_kv_heads * tc.head_dim
    assert sorted(set(kept)) == sorted({B * 16 * D, B * 16 * kv,
                                        B * 16 * E})


class TestParams:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_params_from_numpy_round_trips_leaf_for_leaf(self, tree, dtype):
        _, tc = _configs(dtype)
        tp = tmoe.params_from_numpy(tree, tc, "cpu")
        flat_t = _flat(tp)
        flat_j = _flat(tree)
        assert set(flat_t) == set(flat_j)
        for name, leaf in flat_j.items():
            f32 = "norm" in name or "router" in name
            assert flat_t[name].dtype == (torch.float32 if f32
                                          else tc.compute_dtype), name
            want = np.asarray(jnp.asarray(leaf).astype(
                jnp.float32 if f32 else jnp.dtype(dtype)).astype(
                    jnp.float32))
            np.testing.assert_array_equal(flat_t[name].float().numpy(),
                                          want, name)

    def test_init_params_draws_every_layer_and_expert(self, tree):
        # llama.init_params draws a non-3-D leaf as ONE [in, out] matrix
        # (broadcast into every layer and expert); each matrix of a
        # [L, E, in, out] leaf must be its own draw.
        _, tc = _configs("bfloat16")
        a = tmoe.init_params(tc, torch.Generator().manual_seed(3), "cpu")
        b = tmoe.init_params(tc, torch.Generator().manual_seed(3), "cpu")
        flat_a = _flat(a)
        assert list(flat_a) == list(_flat(b))
        for name, x in flat_a.items():
            assert tuple(x.shape) == _flat(tree)[name].shape, name
            assert torch.equal(x, _flat(b)[name]), name
        w = a["layers"]["moe"]["w_gate"]
        assert w.dtype == torch.bfloat16
        mats = w.float().reshape(-1, *w.shape[-2:])
        for i in range(len(mats)):
            for j in range(i):
                assert not torch.equal(mats[i], mats[j]), (i, j)
        assert abs(float(w.float().std()) - 64 ** -0.5) < 0.01
        down = a["layers"]["moe"]["w_down"].float()
        assert abs(float(down.std()) - 128 ** -0.5) < 0.01
        router = a["layers"]["moe"]["router"]
        assert router.dtype == torch.float32
        assert abs(float(router.std()) - 64 ** -0.5) < 0.02
        assert abs(float(a["tok_embed"].float().std()) - 0.02) < 0.002
        assert torch.equal(a["layers"]["moe_norm"], torch.ones(2, 64))
        master = tmoe.init_params(tc, torch.Generator().manual_seed(3),
                                  "cpu", master=True)
        assert all(x.dtype == torch.float32
                   for x in ttrain.tree_leaves(master))

    @pytest.mark.parametrize("name", ["tiny", "8x7b"])
    def test_param_counts_match_jax(self, name):
        tc = tmoe.CONFIGS[name]()
        jc = {"tiny": jmoe.MoEConfig.tiny,
              "8x7b": jmoe.MoEConfig.mixtral_8x7b}[name]()
        assert tc == tmoe.MoEConfig(**jc.__dict__)
        assert tmoe.num_params(tc) == jmoe.num_params(jc)
        assert tmoe.active_params(tc) == jmoe.active_params(jc)

        def count(node):
            return sum(count(v) if isinstance(v, dict) else int(np.prod(v))
                       for v in node.values())
        assert count(tmoe.param_shapes(tc)) == tmoe.num_params(tc)

    @pytest.mark.parametrize("T", [1, 7, 128, 4096])
    def test_expert_capacity_matches_jax(self, T):
        jc, tc = _configs()
        assert tmoe.expert_capacity(tc, T) == jmoe.expert_capacity(jc, T)
        big = tmoe.MoEConfig.mixtral_8x7b()
        assert tmoe.expert_capacity(big, T) == jmoe.expert_capacity(
            jmoe.MoEConfig.mixtral_8x7b(), T)


class TestTrainStep:
    def test_three_adamw_steps_match_jax(self, tree):
        # The JAX step of moe_pretrain.py:77-85: value_and_grad of
        # moe.loss_fn, then optax.adamw(lr, b1=0.9, b2=0.95, wd=0.1).
        jc, tc = _configs()
        lr, steps = 3e-3, 3
        # One batch three times: the loss must fall.
        batches = [_tokens(B=4, T=17, seed=30)] * steps
        tx = optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)

        @jax.jit
        def step_fn(p, o, tokens):
            value, grads = jax.value_and_grad(
                lambda pp: jmoe.loss_fn(pp, {"tokens": tokens}, jc))(p)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, value

        pj = _jax(tree)
        oj = tx.init(pj)
        want = []
        for tokens in batches:
            pj, oj, value = step_fn(pj, oj, jnp.asarray(tokens))
            want.append(float(value))

        params = _port_params(tree, tc)
        step = telastic.make_step_fn(params, tc, accum=1, lr=lr,
                                     loss_fn=tmoe.loss_fn)
        got = [float(step(torch.from_numpy(t).long())) for t in batches]
        np.testing.assert_allclose(got, want, rtol=F32_TOL)
        assert got[-1] < got[0]
        assert step.opt.state["count"] == steps
