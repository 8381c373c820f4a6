"""PyTorch port of ``models/moe_decode.py`` and the MoE family of
``workloads/serve.py`` and ``workloads/generate.py`` against the JAX
package, in fp32 at the MoE ``tiny`` config.

- ``prefill``, ``decode_step``, ``serve_step``, ``prefill_chunk`` and the
  routed MLP: logits and caches within RTOL = ATOL = 1e-4 of JAX
  ``moe_decode`` on the same parameters and cache (the same math in
  another summation order; the port groups the rows by expert where JAX
  gathers weights per row);
- greedy ``generate`` and the continuous-batching service: exactly JAX's
  tokens (fp32 is exact enough for argmax equality here).  The service is
  held to JAX ``moe_decode.generate`` per request, at a dropless capacity
  (``capacity_factor = n_experts / experts_per_token``), where chunked and
  whole-prompt prefill agree: the JAX service itself cannot start a MoE
  model (its ``reset_slot`` fault, ROADMAP.md queue 3).
"""

import dataclasses
import warnings

import torch.nn.functional as F

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.models import moe as jmoe  # noqa: E402
from trainingjob_operator_tpu.models import moe_decode as jmd  # noqa: E402
from trainingjob_operator_tpu.workloads import serve as jserve  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe as tmoe  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe_decode as tmd  # noqa: E402,E501
from trainingjob_operator_tpu_torch.utils.metrics import METRICS  # noqa: E402,E501
from trainingjob_operator_tpu_torch.workloads import serve as tserve  # noqa: E402,E501

RTOL = ATOL = 1e-4

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)


def _configs(**kw):
    jc = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype="float32", **kw)
    return jc, tmoe.MoEConfig(**jc.__dict__)


def _dropless(**kw):
    base = jmoe.MoEConfig.tiny()
    return _configs(capacity_factor=float(base.n_experts
                                          / base.experts_per_token), **kw)


@pytest.fixture(scope="module")
def setup():
    jc, tc = _configs()
    jp = jmoe.init_params(jc, jax.random.PRNGKey(0))
    tp = tmoe.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                                "cpu")
    return jc, tc, jp, tp


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


def _quiet(fn, *args, **kwargs):
    """``fn`` with the capacity warning silenced (tested on its own)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return fn(*args, **kwargs)


def _chosen(x, layer, k):
    """The experts each row of x [N, D] routes to (the port's top k)."""
    probs = torch.softmax(x.float() @ layer["moe"]["router"], dim=-1)
    return torch.sort(probs, dim=-1, descending=True,
                      stable=True).indices[:, :k]


class TestRoutedMlp:
    def test_rows_sharing_an_expert_and_an_expert_chosen_by_none(
            self, setup):
        jc, tc, jp, tp = setup
        layer_j = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
        layer_t = {"moe": {k: v[0] for k, v in
                           tp["layers"]["moe"].items()}}
        for seed in range(100):
            x = np.random.default_rng(seed).standard_normal(
                (3, 1, 64)).astype(np.float32)
            idx = _chosen(torch.from_numpy(x[:, 0]), layer_t, 2)
            counts = torch.bincount(idx.reshape(-1), minlength=4)
            if counts.max() >= 2 and (counts == 0).any():
                break
        assert counts.max() >= 2 and (counts == 0).any(), counts
        want = jmd._routed_mlp_token(jnp.asarray(x), layer_j, jc,
                                     jnp.float32)
        got = tmd._routed_mlp_token(torch.from_numpy(x), layer_t, tc,
                                    torch.float32)
        assert got.shape == (3, 1, 64)
        _close(got, want)


def _per_expert_loop(x, layer, c, compute):
    """The routed MLP as a loop over the experts on the host's counts: the
    port's routed MLP before its products were grouped on the device."""
    N, k = x.shape[0], c.experts_per_token
    xf = x[:, 0]
    w = layer["moe"]
    probs = torch.softmax(xf.float() @ w["router"], dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[:, :k], top.indices[:, :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    pairs = idx.reshape(-1)
    order = torch.argsort(pairs, stable=True)
    counts = torch.bincount(pairs, minlength=c.n_experts).tolist()
    y = xf.new_empty((N * k, c.dim))
    for e, chosen in enumerate(torch.split(order, counts)):
        if not counts[e]:
            continue
        xe = xf[chosen // k]
        gate = F.silu(xe @ w["w_gate"][e].to(compute))
        up = xe @ w["w_up"][e].to(compute)
        y[chosen] = (gate * up) @ w["w_down"][e].to(compute)
    y = torch.einsum("nkd,nk->nd", y.view(N, k, c.dim), gates.to(compute))
    return y[:, None, :]


def _skewed_layer(tp, hot, cold):
    """Layer 0's MoE block with the router pushed by feature 0: rows whose
    feature 0 is large choose ``hot`` first and ``cold`` never."""
    router = tp["layers"]["moe"]["router"][0].clone()
    router[0, hot], router[0, cold] = 100.0, -100.0
    return {"moe": {**{k: v[0] for k, v in tp["layers"]["moe"].items()},
                    "router": router}}


class TestGroupedPlainVersion:
    @pytest.mark.parametrize("N,skewed", [(1, False), (3, False),
                                          (256, False), (256, True)])
    def test_equals_the_per_expert_loop(self, setup, N, skewed):
        # Skewed: every row chooses expert 2 (all 256 rows: a whole pass of
        # the card's kernels) and none chooses expert 1.
        _, tc, _, tp = setup
        rng = np.random.default_rng(N)
        x = torch.from_numpy(rng.standard_normal((N, 1, 64))
                             .astype(np.float32))
        if skewed:
            x[:, 0, 0] = 10.0
            layer = _skewed_layer(tp, hot=2, cold=1)
        else:
            layer = {"moe": {k: v[0] for k, v in
                             tp["layers"]["moe"].items()}}
        chosen = _chosen(x[:, 0], layer, 2)
        counts = torch.bincount(chosen.reshape(-1), minlength=4)
        if skewed:
            assert counts[2] == N and counts[1] == 0
        got = tmd._routed_mlp_token(x, layer, tc, torch.float32)
        want = _per_expert_loop(x, layer, tc, torch.float32)
        assert got.shape == (N, 1, 64)
        assert torch.equal(got, want)

    def test_experts_reached_is_counted_on_the_device(self, setup):
        _, tc, _, tp = setup
        layer = {"moe": {k: v[0] for k, v in tp["layers"]["moe"].items()}}
        before = METRICS.snapshot()
        want_reached, want_pairs = 0, 0
        for seed, n in ((0, 1), (1, 2), (2, 7), (3, 40)):
            x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                (n, 1, 64)).astype(np.float32))
            tmd._routed_mlp_token(x, layer, tc, torch.float32)
            want_reached += len(set(_chosen(x[:, 0], layer, 2)
                                    .reshape(-1).tolist()))
            want_pairs += 2 * n
        after = METRICS.snapshot()

        def delta(key):
            return after.get(key, 0.0) - before.get(key, 0.0)
        assert delta("moe_decode_experts_reached") == want_reached
        assert delta("moe_decode_pairs") == want_pairs


class TestExecutables:
    @pytest.mark.parametrize("window", [0, 4])
    def test_prefill_and_decode_step_match_jax(self, setup, window):
        _, _, jp, tp = setup
        jc, tc = _configs(sliding_window=window)
        prompt = np.array([[7, 3, 11, 2, 9, 4], [1, 5, 200, 31, 8, 77]])
        lj, cj = _quiet(jmd.prefill, jp, jnp.asarray(prompt, jnp.int32),
                        jc, 12)
        lt, ct = _quiet(tmd.prefill, tp, torch.from_numpy(prompt), tc, 12)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])
        tok = np.array([42, 9])
        lj, cj = jmd.decode_step(jp, cj, jnp.asarray(tok, jnp.int32),
                                 jnp.int32(6), jc)
        lt, ct = tmd.decode_step(tp, ct, torch.from_numpy(tok), 6, tc)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])

    def test_serve_step_matches_jax(self, setup):
        # Three slots: six (row, choice) pairs over four experts, so two
        # rows share an expert; the tokens are picked so that the first
        # layer leaves an expert unchosen too.
        jc, tc, jp, tp = setup
        ts = np.array([0, 9, 31])
        for seed in range(100):
            tokens = np.random.default_rng(seed).integers(0, 256, 3)
            cj, ct = _random_cache(jc, 3, 32)
            seen = []
            real = tmd._routed_mlp_token

            def spy(x, layer, config, compute):
                seen.append(_chosen(x[:, 0], layer, 2))
                return real(x, layer, config, compute)

            tmd._routed_mlp_token = spy
            try:
                lt, ct = tmd.serve_step(tp, ct, torch.from_numpy(tokens),
                                        torch.from_numpy(ts), tc)
            finally:
                tmd._routed_mlp_token = real
            counts = torch.bincount(seen[0].reshape(-1), minlength=4)
            if (counts == 0).any():
                break
        assert counts.max() >= 2 and (counts == 0).any(), counts
        lj, cj = jmd.serve_step(jp, cj, jnp.asarray(tokens, jnp.int32),
                                jnp.asarray(ts, jnp.int32), jc)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])

    @pytest.mark.parametrize("t0", [0, 8, 24])
    def test_prefill_chunk_matches_jax(self, setup, t0):
        jc, tc, jp, tp = setup
        cj, ct = _random_cache(jc, 2, 32)
        tokens = np.arange(3, 11)
        lj, cj = jmd.prefill_chunk(jp, cj, jnp.asarray(tokens, jnp.int32),
                                   1, t0, jc)
        lt, ct = tmd.prefill_chunk(tp, ct, torch.from_numpy(tokens), 1, t0,
                                   tc)
        _close(lt, lj)
        _close(ct["k"], cj["k"])
        _close(ct["v"], cj["v"])

    def test_a_chunk_past_the_cache_end_raises(self, setup):
        # JAX's dynamic_update_slice clamps t0 = 28 of a 32-slot cache to
        # 24 and writes the chunk's K/V at shifted positions without an
        # error; the port refuses.
        jc, tc, jp, tp = setup
        cj, ct = _random_cache(jc, 1, 32)
        jmd.prefill_chunk(jp, cj, jnp.arange(8, dtype=jnp.int32), 0, 28, jc)
        with pytest.raises(ValueError, match="does not fit"):
            tmd.prefill_chunk(tp, ct, torch.arange(8), 0, 28, tc)


class TestCapacityWarning:
    def test_warns_as_jax_where_prefill_can_drop(self, setup):
        jc, tc, jp, tp = setup
        prompt = np.array([[7, 3, 11]])
        with pytest.warns(RuntimeWarning) as want:
            jmd.prefill(jp, jnp.asarray(prompt, jnp.int32), jc, 8)
        with pytest.warns(RuntimeWarning) as got:
            tmd.prefill(tp, torch.from_numpy(prompt), tc, 8)

        # Only the RuntimeWarnings: a record also catches whatever the
        # garbage collector reports meanwhile (a ResourceWarning for a
        # socket an earlier test left open).
        def messages(record):
            return [str(w.message) for w in record
                    if issubclass(w.category, RuntimeWarning)]
        assert messages(got) == messages(want)
        assert "capacity_factor=1.25 < n_experts/experts_per_token=2" in \
            messages(got)[0]

    def test_silent_at_a_dropless_capacity(self, setup):
        _, _, _, tp = setup
        _, tc = _dropless()
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            tmd.prefill(tp, torch.tensor([[7, 3, 11]]), tc, 8)


class TestGenerate:
    @pytest.mark.parametrize("window", [0, 4])
    def test_greedy_tokens_equal_jax(self, setup, window):
        _, _, jp, tp = setup
        jc, tc = _configs(sliding_window=window)
        prompt = [7, 3, 11, 2, 9, 4]
        want = _quiet(jmd.generate, jp, jnp.asarray(
            [prompt, prompt[::-1]], jnp.int32), jc, steps=8)
        got = _quiet(tmd.generate, tp, torch.tensor([prompt, prompt[::-1]]),
                     tc, steps=8)
        assert got.tolist() == np.asarray(want).tolist()

    def test_sampling_is_seeded_and_validated(self, setup):
        _, _, _, tp = setup
        _, tc = _dropless()
        prompt = torch.tensor([[1, 2, 3]])

        def sample(seed):
            return tmd.generate(tp, prompt, tc, steps=6, temperature=0.8,
                                top_k=20,
                                generator=torch.Generator().manual_seed(seed))

        assert torch.equal(sample(1), sample(1))
        with pytest.raises(ValueError):
            tmd.generate(tp, prompt, tc, steps=4, temperature=0.5)
        with pytest.raises(ValueError):
            tmd.generate(tp, prompt, tc, steps=4, top_k=3)


class TestDecodeService:
    def test_every_request_gets_jax_generates_tokens(self, setup):
        _, _, jp, tp = setup
        jc, tc = _dropless()
        traffic = tserve.synthetic_traffic(
            8, seed=3, rate=1.5, vocab=tc.vocab_size, prompt_lens=(3, 8),
            out_tokens=(2, 8))
        got = tserve.run_traffic(tserve.DecodeService(
            tp, tc, slots=3, prefill_chunk=4, family="moe", device="cpu"),
            traffic)
        assert got["stats"]["completed_total"] == 8
        assert got["stats"]["stale_kv_violations"] == 0
        assert len({r.slot for r in got["completed"]}) > 1
        want = {}
        for req in got["completed"]:
            key = (tuple(req.prompt), req.max_new_tokens)
            if key not in want:
                want[key] = np.asarray(jmd.generate(
                    jp, jnp.asarray([req.prompt], jnp.int32), jc,
                    steps=req.max_new_tokens))[0].tolist()
            assert req.tokens == want[key], req.rid

    def test_the_jax_service_cannot_start_a_moe_model(self, setup):
        # Reference fault: JAX serve.py jits mod.reset_slot, which
        # moe_decode neither defines nor re-exports.
        jc, _, jp, _ = setup
        with pytest.raises(AttributeError, match="reset_slot"):
            jserve.DecodeService(jp, jc, family="moe")

    def test_refusals(self, setup):
        _, tc, _, tp = setup
        with pytest.raises(ValueError, match="multiple of prefill_chunk"):
            tserve.DecodeService(tp, tc, max_len=30, prefill_chunk=16,
                                 family="moe", device="cpu")
        with pytest.raises(ValueError, match="unknown family"):
            tserve.DecodeService(tp, tc, family="mixtral", device="cpu")


class TestMains:
    def test_serve_main_serves_the_moe_family(self, monkeypatch, capsys):
        from trainingjob_operator_tpu_torch.workloads import serve

        served = []
        real = serve.run_traffic

        def record(service, traffic):
            served.append(service)
            return real(service, traffic)

        monkeypatch.setattr(serve, "run_traffic", record)
        monkeypatch.setenv("GEN_FAMILY", "moe")
        monkeypatch.setenv("TRAININGJOB_SERVE_REQUESTS", "4")
        monkeypatch.setenv("TRAININGJOB_SERVE_SLOTS", "2")
        monkeypatch.setenv("TRAININGJOB_SERVE_QUANT", "1")
        assert serve.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        (svc,) = served
        assert svc.family == "moe" and svc.model is tmd
        assert svc.config == tmoe.MoEConfig.tiny()
        assert set(svc.params["layers"]) == {"attn", "moe", "attn_norm",
                                             "moe_norm"}
        # TRAININGJOB_SERVE_QUANT is skipped for MoE, as in JAX.
        assert "int8" not in out
        assert "family=moe" in out and "completed=4" in out

    def test_generate_main_samples_the_moe_family(self, monkeypatch,
                                                  capsys):
        from trainingjob_operator_tpu_torch.workloads import generate

        monkeypatch.setenv("GEN_FAMILY", "moe")
        monkeypatch.setenv("GEN_STEPS", "5")
        monkeypatch.setenv("GEN_PROMPT", "1,2,3")
        monkeypatch.setenv("GEN_QUANT", "1")
        monkeypatch.setenv("MOE_WINDOW", "4")
        assert _quiet(generate.main, ["--device", "cpu"]) == 0
        out = capsys.readouterr().out.splitlines()
        assert "warning: GEN_QUANT is not supported for GEN_FAMILY=moe; " \
               "decoding in full precision" in out
        cfg = dataclasses.replace(tmoe.MoEConfig.tiny(), sliding_window=4)
        params = tmoe.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
        want = _quiet(tmd.generate, params, torch.tensor([[1, 2, 3]]), cfg,
                      steps=5)[0].tolist()
        assert "tokens: " + ",".join(map(str, want)) in out
