"""PyTorch port of ``models/decode.py`` and ``workloads/serve.py`` against
the JAX package, in fp32 at the ``tiny`` config.

The serving executables (serve_step, prefill_chunk, reset_slot) are held
to the JAX functions on the same params and cache; greedy ``generate`` and
the continuous-batching service must give exactly the JAX tokens.  fp32
throughout: across paths only fp32 is exact enough for argmax equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.models import decode as jdecode  # noqa: E402
from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu.models import quant as jquant  # noqa: E402
from trainingjob_operator_tpu.workloads import serve as jserve  # noqa: E402
from trainingjob_operator_tpu_torch.models import decode as tdecode  # noqa: E402,E501
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import serve as tserve  # noqa: E402,E501

RTOL = ATOL = 1e-4

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)


def _configs(window=0):
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32",
                             sliding_window=window)
    return jc, tllama.LlamaConfig(**jc.__dict__)


@pytest.fixture(scope="module")
def setup():
    jc, tc = _configs()
    jp = jllama.init_params(jc, jax.random.PRNGKey(0))
    tp = tllama.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  tc, "cpu")
    return jc, tc, jp, tp


def _quantized(jp, tc):
    jq = jquant.quantize_weights(jp)
    return jq, tllama.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jq), tc, "cpu")


def _random_cache(jc, slots, max_len, seed=4):
    """A cache holding unrelated junk, the same on both sides."""
    rng = np.random.default_rng(seed)
    shape = (jc.n_layers, slots, max_len, jc.n_kv_heads, jc.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


class TestExecutables:
    @pytest.mark.parametrize("int8", [False, True])
    def test_serve_step_matches_jax(self, setup, int8):
        jc, tc, jp, tp = setup
        if int8:
            jp, tp = _quantized(jp, tc)
        cj, ct = _random_cache(jc, 3, 32)
        tokens = np.array([5, 17, 200])
        ts = np.array([0, 9, 31])
        lj, cj = jdecode.serve_step(jp, cj, jnp.asarray(tokens, jnp.int32),
                                    jnp.asarray(ts, jnp.int32), jc)
        lt, ct = tdecode.serve_step(tp, ct, torch.from_numpy(tokens),
                                    torch.from_numpy(ts), tc)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])

    @pytest.mark.parametrize("t0", [0, 8, 24])
    def test_prefill_chunk_matches_jax(self, setup, t0):
        jc, tc, jp, tp = setup
        cj, ct = _random_cache(jc, 2, 32)
        tokens = np.arange(3, 11)
        lj, cj = jdecode.prefill_chunk(jp, cj, jnp.asarray(tokens, jnp.int32),
                                       1, t0, jc)
        lt, ct = tdecode.prefill_chunk(tp, ct, torch.from_numpy(tokens), 1,
                                       t0, tc)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])

    def test_prefill_chunk_past_the_cache_end_raises(self, setup):
        # dynamic_update_slice would clamp t0 to S - C and write the chunk
        # at shifted positions; the port refuses instead.
        jc, tc, _, tp = setup
        _, ct = _random_cache(jc, 1, 30)
        with pytest.raises(ValueError, match="does not fit"):
            tdecode.prefill_chunk(tp, ct, torch.arange(16), 0, 16, tc)

    def test_reset_slot_matches_jax(self, setup):
        jc, _, _, _ = setup
        cj, ct = _random_cache(jc, 3, 16)
        cj = jdecode.reset_slot(cj, 1)
        ct = tdecode.reset_slot(ct, 1)
        np.testing.assert_array_equal(ct["k"].numpy(), np.asarray(cj["k"]))
        np.testing.assert_array_equal(ct["v"].numpy(), np.asarray(cj["v"]))
        assert not ct["k"][:, 1].any() and ct["k"][:, 0].any()

    @pytest.mark.parametrize("window", [0, 4])
    def test_prefill_and_decode_step_match_jax(self, setup, window):
        _, _, jp, tp = setup
        jc, tc = _configs(window)
        prompt = np.array([[7, 3, 11, 2, 9, 4]])
        lj, cj = jdecode.prefill(jp, jnp.asarray(prompt, jnp.int32), jc, 12)
        lt, ct = tdecode.prefill(tp, torch.from_numpy(prompt), tc, 12)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        tok = np.array([42])
        lj, cj = jdecode.decode_step(jp, cj, jnp.asarray(tok, jnp.int32),
                                     jnp.int32(6), jc)
        lt, ct = tdecode.decode_step(tp, ct, torch.from_numpy(tok), 6, tc)
        _close(lt, lj)
        _close(ct["v"], cj["v"])

    def test_init_and_pack_cache_match_jax(self, setup):
        jc, tc, _, _ = setup
        for window, T in ((0, 5), (4, 7), (4, 3)):
            jw = dataclasses.replace(jc, sliding_window=window)
            tw = dataclasses.replace(tc, sliding_window=window)
            k = np.random.default_rng(T).standard_normal(
                (2, 1, T, 2, 16)).astype(np.float32)
            want = jdecode.pack_cache(jnp.asarray(k), jnp.asarray(k), jw, 10)
            got = tdecode.pack_cache(torch.from_numpy(k), torch.from_numpy(k),
                                     tw, 10)
            np.testing.assert_array_equal(got["k"].numpy(),
                                          np.asarray(want["k"]))
            assert (tdecode.init_cache(tw, 2, 10, device="cpu")["k"].shape
                    == jdecode.init_cache(jw, 2, 10)["k"].shape)


class TestGenerate:
    @pytest.mark.parametrize("int8,window", [(False, 0), (True, 0),
                                             (False, 4)])
    def test_greedy_tokens_equal_jax(self, setup, int8, window):
        _, _, jp, tp = setup
        jc, tc = _configs(window)
        prompt = [7, 3, 11, 2, 9, 4]
        want = jdecode.generate(jp, jnp.asarray([prompt, prompt[::-1]],
                                                jnp.int32), jc, steps=10,
                                quantize=int8)
        got = tdecode.generate(tp, torch.tensor([prompt, prompt[::-1]]), tc,
                               steps=10, quantize=int8)
        assert got.tolist() == np.asarray(want).tolist()

    @pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.8), (7, 0.6)])
    def test_mask_logits_matches_jax(self, top_k, top_p):
        logits = np.random.default_rng(9).standard_normal(
            (3, 64)).astype(np.float32) * 2
        want = np.asarray(jdecode._mask_logits(jnp.asarray(logits), top_k,
                                               top_p))
        got = tdecode._mask_logits(torch.from_numpy(logits), top_k,
                                   top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got, want)

    def test_sampling_is_seeded_and_validated(self, setup):
        _, tc, _, tp = setup
        prompt = torch.tensor([[1, 2, 3]])

        def sample(seed):
            return tdecode.generate(
                tp, prompt, tc, steps=6, temperature=0.8, top_k=20,
                generator=torch.Generator().manual_seed(seed))

        assert torch.equal(sample(1), sample(1))
        with pytest.raises(ValueError):
            tdecode.generate(tp, prompt, tc, steps=4, temperature=0.5)
        with pytest.raises(ValueError):
            tdecode.generate(tp, prompt, tc, steps=4, top_k=3)


class TestDecodeService:
    @pytest.mark.parametrize("policy", ["continuous", "static"])
    def test_traffic_tokens_equal_jax_service(self, setup, policy):
        jc, tc, jp, tp = setup
        traffic = jserve.synthetic_traffic(
            12, seed=3, rate=1.5, vocab=jc.vocab_size, prompt_lens=(3, 10),
            out_tokens=(2, 12))
        assert traffic == tserve.synthetic_traffic(
            12, seed=3, rate=1.5, vocab=tc.vocab_size, prompt_lens=(3, 10),
            out_tokens=(2, 12))
        want = jserve.run_traffic(jserve.DecodeService(
            jp, jc, slots=3, prefill_chunk=4, policy=policy), traffic)
        got = tserve.run_traffic(tserve.DecodeService(
            tp, tc, slots=3, prefill_chunk=4, policy=policy, device="cpu"),
            traffic)
        assert got["stats"]["stale_kv_violations"] == 0
        assert got["stats"]["completed_total"] == 12
        assert ({r.rid: r.tokens for r in got["completed"]}
                == {r.rid: r.tokens for r in want["completed"]})
        assert len({r.slot for r in got["completed"]}) > 1

    def test_serve_matches_generate(self, setup):
        _, tc, _, tp = setup
        prompt = [7, 3, 11, 2, 9, 4]
        svc = tserve.DecodeService(tp, tc, slots=2, prefill_chunk=4,
                                   device="cpu")
        svc.warmup()
        req = svc.submit(prompt, 10, now=0.0)
        while not req.finished:
            svc.step()
        want = tdecode.generate(tp, torch.tensor([prompt]), tc, steps=10)
        assert req.tokens == want[0].tolist()
        assert svc.prefill_calls == 2 and svc.decode_calls == 9

    @pytest.mark.parametrize("max_len,chunk", [(30, 16), (100, 8)])
    def test_max_len_not_a_chunk_multiple_is_rejected(self, setup, max_len,
                                                      chunk):
        _, tc, _, tp = setup
        with pytest.raises(ValueError, match="multiple of prefill_chunk"):
            tserve.DecodeService(tp, tc, max_len=max_len,
                                 prefill_chunk=chunk, device="cpu")

    def test_sliding_window_and_queue_full(self, setup):
        _, tc, _, tp = setup
        with pytest.raises(ValueError):
            tserve.DecodeService(tp, dataclasses.replace(
                tc, sliding_window=8), device="cpu")
        svc = tserve.DecodeService(tp, tc, slots=1, queue_cap=2,
                                   device="cpu")
        svc.submit([1, 2], 3)
        svc.submit([1, 2], 3)
        with pytest.raises(tserve.QueueFull):
            svc.submit([1, 2], 3)
        assert svc.rejected_total == 1
        with pytest.raises(ValueError):
            svc.submit([1] * 120, 20)
