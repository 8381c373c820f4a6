"""PyTorch port of ``models/llama.py`` and ``models/quant.py`` against the
JAX package at the ``tiny`` config (D=64, 2 layers, 4 heads / 2 KV heads).

One JAX parameter tree (numpy leaves) feeds both packages through
``params_from_numpy``; the JAX forward runs its XLA path on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu.models import quant as jquant  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.models import quant as tquant  # noqa: E402

#: fp32 (rtol = atol): same math, another summation order through 2
#: layers.
F32_TOL = 1e-4
#: bf16 logits of the whole model (rtol = atol).  XLA's bf16 logistic
#: (inside silu) rounds differently from PyTorch's on about a third of
#: inputs, so every value downstream of the first MLP moves by about one
#: bf16 ulp; the rounding points themselves are held bit for bit by the
#: case without MLP output.
BF16_TOL = 5e-2

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)


def _bf16_ulp(want):
    """One bf16 ulp at the largest entry of ``want``."""
    return 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)


def _configs(dtype="float32", window=0):
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype,
                             sliding_window=window)
    return jc, tllama.LlamaConfig(**jc.__dict__)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_params():
    jc, _ = _configs()
    return jllama.init_params(jc, jax.random.PRNGKey(0))


def _tokens(B=2, T=13, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(
        np.int32)


class TestForward:
    @pytest.mark.parametrize("dtype,window,mlp_out", [
        ("float32", 0, True), ("float32", 5, True),
        ("bfloat16", 0, True), ("bfloat16", 0, False)])
    def test_logits_and_kv_match_jax(self, jax_params, dtype, window,
                                     mlp_out):
        jc, tc = _configs(dtype, window)
        tokens = _tokens()
        tree = _numpy_tree(jax_params)
        if not mlp_out:
            # w_down = 0: every MLP adds exactly zero on both sides, so
            # silu drops out and each bf16 rounding point (bf16 residual,
            # f32 RMSNorm returning bf16, bf16 cos/sin, f32 cast after the
            # bf16 lm_head matmul) must agree bit for bit.
            tree["layers"]["mlp"]["w_down"] = np.zeros_like(
                tree["layers"]["mlp"]["w_down"])
        lj, (kj, vj) = jllama.forward(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens),
            jc, return_kv=True)
        tp = tllama.params_from_numpy(tree, tc, "cpu")
        lt, (kt, vt) = tllama.forward(tp, torch.from_numpy(tokens).long(),
                                      tc, return_kv=True)
        assert lt.dtype == torch.float32 and lt.shape == (2, 13, 256)
        assert kt.shape == (2, 2, 13, 2, 16) and kt.dtype == tc.compute_dtype
        got = [t.float().numpy() for t in (lt, kt, vt)]
        want = [np.asarray(a, np.float32) for a in (lj, kj, vj)]
        if dtype == "float32":
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL)
        elif not mlp_out:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=BF16_TOL,
                                       atol=BF16_TOL)
            for g, w in zip(got[1:], want[1:]):
                # Layer 1's K/V are upstream of every silu: exact.  Layer
                # 2's are within 2 bf16 ulps of the tensor's largest entry.
                np.testing.assert_array_equal(g[0], w[0])
                np.testing.assert_allclose(g[1], w[1], rtol=0,
                                           atol=2 * _bf16_ulp(w[1]))

    def test_return_hidden_matches_jax(self, jax_params):
        jc, tc = _configs()
        tokens = _tokens()
        hj = jllama.forward(jax_params, jnp.asarray(tokens), jc,
                            return_hidden=True)
        tp = tllama.params_from_numpy(_numpy_tree(jax_params), tc, "cpu")
        ht = tllama.forward(tp, torch.from_numpy(tokens).long(), tc,
                            return_hidden=True)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4,
                                   atol=1e-4)


class TestRope:
    def _x_pos(self, start):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
        pos = (np.tile(np.arange(7)[None], (2, 1)) + start).astype(np.int32)
        return x, pos

    def test_exact_where_cos_and_sin_are_exact(self):
        # At position 0 cos = 1 and sin = 0 exactly on both sides, so the
        # interleaved-pair layout must reproduce x bit for bit.
        x = np.random.default_rng(0).standard_normal(
            (1, 1, 4, 16)).astype(np.float32)
        pos = np.zeros((1, 1), np.int32)
        want = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos),
                                       10000.0))
        got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                           10000.0).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, x)

    @pytest.mark.parametrize("start", [0, 100, 3000])
    def test_matches_jax_to_the_last_ulps(self, start):
        # XLA's and PyTorch's CPU exp/cos/sin differ in the last ulp on a
        # few percent of arguments, so fp32 agreement is a few ulps, not
        # bitwise.  A half-split layout or theta ** (...) frequencies are
        # off by O(1) and O(1e-3) here.
        x, pos = self._x_pos(start)
        want = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos),
                                       10000.0))
        got = tllama._rope(torch.from_numpy(x), torch.from_numpy(pos).long(),
                           10000.0).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=8 * np.finfo(np.float32).eps
                                   * max(1.0, start ** 0.5))

    def test_bf16_casts_cos_sin_first(self):
        x, pos = self._x_pos(50)
        want = np.asarray(jllama._rope(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(pos), 10000.0)
                          .astype(jnp.float32))
        got = tllama._rope(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(pos).long(), 10000.0)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)


class TestParams:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_params_from_numpy_round_trips_leaf_for_leaf(self, jax_params,
                                                         dtype):
        jc, tc = _configs(dtype)
        tree = _numpy_tree(jax_params)
        tp = tllama.params_from_numpy(tree, tc, "cpu")
        flat_j = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_t = {jax.tree_util.keystr(p): leaf for p, leaf in
                  jax.tree_util.tree_flatten_with_path(tp)[0]}
        assert len(flat_j) == len(flat_t)
        for path, leaf in flat_j:
            name = jax.tree_util.keystr(path)
            got = flat_t[name]
            is_norm = "norm" in name
            assert got.dtype == (torch.float32 if is_norm
                                 else tc.compute_dtype), name
            # Stored once in the compute dtype == the JAX per-use astype.
            want = np.asarray(jnp.asarray(leaf).astype(
                jnp.float32 if is_norm else jnp.dtype(dtype)).astype(
                    jnp.float32))
            np.testing.assert_array_equal(got.float().numpy(), want, name)

    def test_quantized_tree_carries_across(self, jax_params):
        _, tc = _configs()
        qtree = _numpy_tree(jquant.quantize_weights(jax_params))
        tp = tllama.params_from_numpy(qtree, tc, "cpu")
        for name in ("wq", "w_down"):
            grp = "attn" if name.startswith("wq") else "mlp"
            src, got = qtree["layers"][grp][name], tp["layers"][grp][name]
            assert got["q"].dtype == torch.int8
            np.testing.assert_array_equal(got["q"].numpy(), src["q"])
            np.testing.assert_array_equal(got["s"].numpy(), src["s"])
        np.testing.assert_array_equal(tp["tok_embed"]["q"].numpy(),
                                      qtree["tok_embed"]["q"])

    def test_init_params_is_seeded_and_shaped_like_jax(self, jax_params):
        _, tc = _configs("bfloat16")
        a = tllama.init_params(tc, torch.Generator().manual_seed(3), "cpu")
        b = tllama.init_params(tc, torch.Generator().manual_seed(3), "cpu")
        flat_a = jax.tree_util.tree_flatten_with_path(a)[0]
        flat_j = jax.tree_util.tree_flatten_with_path(jax_params)[0]
        assert [jax.tree_util.keystr(p) for p, _ in flat_a] == \
            [jax.tree_util.keystr(p) for p, _ in flat_j]
        for (path, x), (_, y), (_, z) in zip(
                flat_a, jax.tree_util.tree_flatten_with_path(b)[0], flat_j):
            assert tuple(x.shape) == z.shape
            assert torch.equal(x, y)
        wq = a["layers"]["attn"]["wq"].float()
        assert abs(float(wq.std()) - 64 ** -0.5) < 0.01
        assert a["tok_embed"].dtype == torch.bfloat16
        assert a["final_norm"].dtype == torch.float32
        assert tllama.num_params(tc) == jllama.num_params(
            jllama.LlamaConfig(**tc.__dict__))


class TestQuant:
    def test_quantize_weights_is_bit_identical(self, jax_params):
        _, tc = _configs()
        want = _numpy_tree(jquant.quantize_weights(jax_params))
        tp = tllama.params_from_numpy(_numpy_tree(jax_params), tc, "cpu")
        got = tquant.quantize_weights(tp)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
            node = got
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node.numpy(), leaf,
                                          jax.tree_util.keystr(path))

    def test_qmatmul_dequantize_rows_and_error_match(self, jax_params):
        _, tc = _configs()
        tp = tllama.params_from_numpy(_numpy_tree(jax_params), tc, "cpu")
        jq = jquant.quantize_weights(jax_params)
        tq = tquant.quantize_weights(tp)
        x = np.random.default_rng(2).standard_normal((3, 64)).astype(
            np.float32)
        want = jquant.qmatmul(jnp.asarray(x), jax.tree_util.tree_map(
            lambda a: a[1], jq["layers"]["mlp"]["w_up"]), jnp.float32)
        got = tquant.qmatmul(torch.from_numpy(x), {
            k: v[1] for k, v in tq["layers"]["mlp"]["w_up"].items()},
            torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        idx = np.array([0, 5, 255])
        np.testing.assert_array_equal(
            tquant.dequantize_rows(tq["tok_embed"], torch.from_numpy(idx),
                                   torch.float32).numpy(),
            np.asarray(jquant.dequantize_rows(jq["tok_embed"],
                                              jnp.asarray(idx),
                                              jnp.float32)))
        np.testing.assert_array_equal(
            tquant.dequantize(tq["lm_head"], torch.float32).numpy(),
            np.asarray(jquant.dequantize(jq["lm_head"], jnp.float32)))
        ej = jquant.quantization_error(jax_params)
        et = tquant.quantization_error(tp)
        assert set(ej) == set(et)
        for k in ej:
            assert et[k] == pytest.approx(ej[k], rel=1e-4)
