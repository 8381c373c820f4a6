"""PyTorch port of the Llama training path against the JAX package at the
``tiny`` config in fp32: ``loss_fn`` and every gradient, chunked CE and
remat, gradient accumulation, batch geometry, AdamW, a 5-step trajectory,
the token dataset and batch sources, and the trainer's entry point.

One JAX parameter tree (numpy leaves) feeds both packages through
``params_from_numpy``; the JAX side runs its XLA path on the CPU, the port
its plain versions (CPU tensors).
"""

import dataclasses

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from trainingjob_operator_tpu.data import tokens as jtokens  # noqa: E402
from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu.workloads import train as jtrain  # noqa: E402
from trainingjob_operator_tpu_torch.data import tokens as ttokens  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import (  # noqa: E402
    llama_elastic as telastic,
)
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 loss and gradients against JAX (rtol = atol): the same math in
#: another summation order through 2 layers and their backward.
F32_TOL = 1e-4
#: Two computations of the same function in the port (chunked CE or remat
#: against the plain loss, accumulation against the full batch).
SELF_TOL = 1e-5

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)


def _configs(dtype="float32", window=0):
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype,
                             sliding_window=window)
    return jc, tllama.LlamaConfig(**jc.__dict__)


@pytest.fixture(scope="module")
def tree():
    jc, _ = _configs()
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jc, jax.random.PRNGKey(0)))


def _tokens(B=4, T=24, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, T + 1)).astype(
        np.int32)


def _port_params(tree, tc):
    params = tllama.params_from_numpy(tree, tc, "cpu", master=True)
    for leaf in ttrain.tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, tol):
    got = {k: v.detach() for k, v in _flat_torch(got).items()}
    want = _flat(want)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(), w, rtol=tol,
                                   atol=tol, err_msg=name)


def _flat_torch(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}['{k}']"
        out.update(_flat_torch(v, path) if isinstance(v, dict)
                   else {path: v})
    return out


def _port_loss_and_grads(params, tc, tokens, **kw):
    for leaf in ttrain.tree_leaves(params):
        leaf.grad = None
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens)}, tc,
                          **kw)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in _flat_torch(params).items()}


class TestLoss:
    @pytest.mark.parametrize("window", [0, 5])
    def test_loss_and_every_grad_match_jax(self, tree, window):
        jc, tc = _configs(window=window)
        tokens = _tokens()
        lj, gj = jax.jit(jax.value_and_grad(
            lambda p, t: jllama.loss_fn(p, {"tokens": t}, jc)))(
                jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
        params = _port_params(tree, tc)
        lt, gt = _port_loss_and_grads(params, tc, tokens)
        assert lt.dtype == torch.float32 and lt.shape == ()
        np.testing.assert_allclose(float(lt), float(lj), rtol=F32_TOL)
        want = _flat(gj)
        assert set(gt) == set(want)
        for name, w in want.items():
            assert gt[name].dtype == torch.float32, name
            np.testing.assert_allclose(gt[name].numpy(), w, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=name)

    @pytest.mark.parametrize("remat,ce_chunk", [("full", 0), ("none", 8),
                                                ("full", 12), (True, 0)])
    def test_chunked_ce_and_remat_match_the_plain_loss(self, tree, remat,
                                                       ce_chunk):
        _, tc = _configs()
        tokens = _tokens()
        params = _port_params(tree, tc)
        want_l, want_g = _port_loss_and_grads(params, tc, tokens)
        got_l, got_g = _port_loss_and_grads(params, tc, tokens, remat=remat,
                                            ce_chunk=ce_chunk)
        np.testing.assert_allclose(float(got_l), float(want_l),
                                   rtol=SELF_TOL)
        for name, w in want_g.items():
            np.testing.assert_allclose(got_g[name].numpy(), w.numpy(),
                                       rtol=SELF_TOL, atol=SELF_TOL,
                                       err_msg=name)

    def test_chunked_ce_matches_jax(self, tree):
        jc, tc = _configs()
        tokens = _tokens()
        want = jax.jit(lambda p, t: jllama.loss_fn(
            p, {"tokens": t}, jc, ce_chunk=8))(
                jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
        got = tllama.loss_fn(tllama.params_from_numpy(tree, tc, "cpu"),
                             {"tokens": torch.from_numpy(tokens)}, tc,
                             ce_chunk=8)
        np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL)

    def test_ce_chunk_must_divide_the_sequence(self, tree):
        _, tc = _configs()
        params = tllama.params_from_numpy(tree, tc, "cpu")
        with pytest.raises(ValueError, match="does not divide seq 24"):
            tllama.loss_fn(params, {"tokens": torch.from_numpy(_tokens())},
                           tc, ce_chunk=7)

    @pytest.mark.parametrize("remat,want", [(False, "none"), (None, "none"),
                                            ("none", "none"), (True, "full"),
                                            ("full", "full")])
    def test_remat_policy_reads_the_jax_spellings(self, remat, want):
        assert tllama.remat_policy(remat) == want

    @pytest.mark.parametrize("remat", ["attn", "dots", "everything"])
    def test_unported_or_unknown_remat_raises(self, tree, remat):
        # "attn" and "dots" were refused until they were ported; now they
        # give the plain loss, and only an unknown policy raises.
        _, tc = _configs()
        params = tllama.params_from_numpy(tree, tc, "cpu")
        batch = {"tokens": torch.from_numpy(_tokens())}
        if remat not in tllama.REMAT_POLICIES:
            with pytest.raises(ValueError, match="unknown remat policy"):
                tllama.loss_fn(params, batch, tc, remat=remat)
            return
        assert tllama.remat_policy(remat) == remat
        np.testing.assert_allclose(
            float(tllama.loss_fn(params, batch, tc, remat=remat)),
            float(tllama.loss_fn(params, batch, tc)), rtol=SELF_TOL)

    def test_bf16_masters_stay_f32_and_get_f32_grads(self, tree):
        jc, tc = _configs("bfloat16")
        tokens = _tokens(B=2, T=16)
        params = _port_params(tree, tc)
        assert all(x.dtype == torch.float32
                   for x in ttrain.tree_leaves(params))
        lt, gt = _port_loss_and_grads(params, tc, tokens)
        lj = jax.jit(lambda p, t: jllama.loss_fn(p, {"tokens": t}, jc))(
            jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(tokens))
        # bf16 compute: XLA's and PyTorch's bf16 silu round differently
        # (tests/test_torch_llama.py), so the loss agrees to bf16 accuracy.
        np.testing.assert_allclose(float(lt), float(lj), rtol=2e-2)
        for name, g in gt.items():
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        init = tllama.init_params(tc, torch.Generator().manual_seed(0),
                                  "cpu", master=True)
        assert all(x.dtype == torch.float32
                   for x in ttrain.tree_leaves(init))


class TestAccumulation:
    def test_accum_matches_full_batch_and_jax(self, tree):
        jc, tc = _configs()
        tokens = _tokens(B=4, T=16)

        def tloss(p, tb):
            return tllama.loss_fn(p, {"tokens": tb}, tc)

        params = _port_params(tree, tc)
        tokens_t = torch.from_numpy(tokens)
        full_l, full_g = ttrain.accumulated_value_and_grad(tloss, params,
                                                           tokens_t, 1)
        full_g = {k: v.clone() for k, v in _flat_torch(full_g).items()}
        acc_l, acc_g = ttrain.accumulated_value_and_grad(tloss, params,
                                                         tokens_t, 2)
        np.testing.assert_allclose(float(acc_l), float(full_l),
                                   rtol=SELF_TOL)
        for name, g in _flat_torch(acc_g).items():
            np.testing.assert_allclose(g.numpy(), full_g[name].numpy(),
                                       rtol=SELF_TOL, atol=SELF_TOL,
                                       err_msg=name)

        def jloss(p, tb):
            return jllama.loss_fn(p, {"tokens": tb}, jc)

        lj, gj = jax.jit(lambda p, t: jtrain.accumulated_value_and_grad(
            jloss, p, t, 2))(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(tokens))
        np.testing.assert_allclose(float(acc_l), float(lj), rtol=F32_TOL)
        _assert_trees_close(acc_g, gj, F32_TOL)

    def test_microbatches_are_interleaved(self):
        seen = []

        def loss(p, tb):
            seen.append(tb[:, 0].tolist())
            return (p["w"] * tb.float()).sum()

        params = {"w": torch.ones((), requires_grad=True)}
        tokens = torch.arange(6)[:, None].repeat(1, 3)
        ttrain.accumulated_value_and_grad(loss, params, tokens, 3)
        assert seen == [[0, 3], [1, 4], [2, 5]]

    def test_indivisible_batch_raises(self):
        params = {"w": torch.ones((), requires_grad=True)}
        with pytest.raises(ValueError, match="not divisible by accum=2"):
            ttrain.accumulated_value_and_grad(
                lambda p, t: p["w"] * t.sum(), params, torch.ones(3, 2), 2)

    @pytest.mark.parametrize("batch,shards,accum", [
        (8, 1, 1), (8, 1, 3), (12, 2, 4), (3, 4, 2), (10, 3, 2), (7, 1, 8),
        (2, 1, 2)])
    def test_round_global_batch_matches_jax(self, batch, shards, accum,
                                            capsys):
        want = jtrain.round_global_batch(batch, shards, accum=accum)
        want_out = capsys.readouterr().out
        assert ttrain.round_global_batch(batch, shards, accum=accum) == want
        assert capsys.readouterr().out == want_out

    @pytest.mark.parametrize("layers", [2, 8, 31, 32, 80])
    def test_default_remat_matches_jax(self, layers):
        assert ttrain.default_remat(layers) == jtrain.default_remat(layers)

    def test_throughput_line_matches_jax(self):
        assert ttrain.throughput_line("train_done", 3, 4096, 1.5) == \
            jtrain.throughput_line("train_done", 3, 4096, 1.5)


def _random_leaves(seed, shapes=((3, 5), (7,), (2, 2, 4))):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


class TestAdamW:
    def test_matches_optax_adamw(self):
        params = _random_leaves(0)
        grads = [_random_leaves(i + 1) for i in range(5)]
        tx = optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.1)
        pj = [jnp.asarray(p) for p in params]
        state = tx.init(pj)
        for g in grads:
            updates, state = tx.update([jnp.asarray(x) for x in g], state, pj)
            pj = optax.apply_updates(pj, updates)
        pt = {str(i): torch.from_numpy(p.copy()) for i, p in
              enumerate(params)}
        opt = ttrain.AdamW(pt, 1e-2)
        for g in grads:
            opt.step(pt, {str(i): torch.from_numpy(x) for i, x in
                          enumerate(g)})
        for i, want in enumerate(pj):
            np.testing.assert_allclose(pt[str(i)].numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)

    def test_torch_optim_adamw_computes_the_same_update(self):
        params = _random_leaves(10)
        grads = [_random_leaves(i + 11) for i in range(5)]
        mine = {str(i): torch.from_numpy(p.copy())
                for i, p in enumerate(params)}
        ref = [torch.from_numpy(p.copy()).requires_grad_(True)
               for p in params]
        opt = ttrain.AdamW(mine, 1e-2, b1=0.9, b2=0.95, eps=1e-8,
                           weight_decay=0.1)
        topt = torch.optim.AdamW(ref, lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                                 weight_decay=0.1)
        for g in grads:
            opt.step(mine, {str(i): torch.from_numpy(x)
                            for i, x in enumerate(g)})
            for p, x in zip(ref, g):
                p.grad = torch.from_numpy(x)
            topt.step()
        for i, p in enumerate(ref):
            torch.testing.assert_close(mine[str(i)], p.detach(), rtol=1e-6,
                                       atol=1e-7)


class TestTrajectory:
    def test_five_adamw_steps_match_the_jax_step_fn(self, tree):
        # The JAX step of llama_elastic.py:136-146: loss_fn under
        # accumulated_value_and_grad, then optax.adamw.
        jc, tc = _configs()
        lr, accum, steps = 3e-3, 2, 5
        batches = [_tokens(B=4, T=16, seed=20 + i) for i in range(steps)]
        tx = optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)

        @jax.jit
        def step_fn(p, o, tokens):
            def loss(p_, tb):
                return jllama.loss_fn(p_, {"tokens": tb}, jc)

            value, grads = jtrain.accumulated_value_and_grad(loss, p, tokens,
                                                             accum)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, value

        pj = jax.tree_util.tree_map(jnp.asarray, tree)
        oj = tx.init(pj)
        want = []
        for tokens in batches:
            pj, oj, value = step_fn(pj, oj, jnp.asarray(tokens))
            want.append(float(value))

        params = _port_params(tree, tc)
        step = telastic.make_step_fn(params, tc, accum=accum, lr=lr)
        got = [float(step(torch.from_numpy(t))) for t in batches]
        np.testing.assert_allclose(got, want, rtol=F32_TOL)
        assert got[-1] < got[0]


class TestData:
    @pytest.fixture
    def corpus(self, tmp_path):
        path = str(tmp_path / "c.tokens")
        ids = np.random.default_rng(0).integers(0, 200, 5000)
        jtokens.write_tokens(path, ids, vocab_size=200)
        return path

    @pytest.mark.parametrize("region", [(0.0, 1.0), (0.9, 1.0)])
    def test_token_dataset_matches_jax(self, corpus, region):
        want = jtokens.TokenDataset(corpus, seed=3, region=region)
        got = ttokens.TokenDataset(corpus, seed=3, region=region)
        assert (len(got), got.vocab_size) == (len(want), want.vocab_size)
        for step in (0, 1, 17):
            np.testing.assert_array_equal(got.batch(step, 4, 31),
                                          want.batch(step, 4, 31))
        np.testing.assert_array_equal(
            got.batch(2, 4, 31, rows=slice(1, 3)),
            want.batch(2, 4, 31, rows=slice(1, 3)))

    def test_token_dataset_refusals(self, corpus, tmp_path):
        bad = tmp_path / "bad.tokens"
        bad.write_bytes(b"not a token file")
        with pytest.raises(ValueError, match="not a AITJTOK1"):
            ttokens.TokenDataset(str(bad))
        with pytest.raises(ValueError, match="bad region"):
            ttokens.TokenDataset(corpus, region=(0.5, 0.5))
        with pytest.raises(ValueError, match="< window"):
            ttokens.TokenDataset(corpus, region=(0.99, 1.0)).check_window(
                100)

    def test_batch_sources_read_the_corpus(self, corpus, monkeypatch):
        monkeypatch.setenv("LLAMA_DATA", corpus)
        monkeypatch.setenv("LLAMA_SEED", "5")
        batch_at, eval_at, every, _ = ttrain.build_batch_sources(
            prefix="LLAMA", vocab_size=256, global_batch=3, seq=16,
            synthetic_key=17, device="cpu")
        assert eval_at is None and every == 0
        want = jtokens.TokenDataset(corpus, seed=5).batch(4, 3, 16)
        got = batch_at(4)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)

    def test_synthetic_batches_are_a_function_of_step_and_row(self):
        batch_at, _, _, _ = ttrain.build_batch_sources(
            prefix="LLAMA", vocab_size=256, global_batch=3, seq=16,
            synthetic_key=17, device="cpu")
        a, b = batch_at(0), batch_at(1)
        assert a.shape == (3, 17) and a.dtype == torch.int64
        assert int(a.min()) >= 0 and int(a.max()) < 256
        assert torch.equal(a, batch_at(0)) and not torch.equal(a, b)
        assert not torch.equal(a[0], a[1])

    @pytest.mark.parametrize("env,match", [
        ({"LLAMA_EVAL_EVERY": "2"}, "without LLAMA_DATA"),
        ({"LLAMA_EVAL_EVERY": "2", "LLAMA_EVAL_BATCHES": "0"},
         "zero-batch eval"),
        ({"LLAMA_EVAL_EVERY": "2", "LLAMA_EVAL_FRACTION": "1.5"},
         "must be in"),
        ({"vocab": 100}, "exceeds model vocab")])
    def test_batch_source_refusals(self, corpus, monkeypatch, env, match):
        vocab = env.pop("vocab", 256)
        if vocab != 256:
            monkeypatch.setenv("LLAMA_DATA", corpus)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match=match):
            ttrain.build_batch_sources(prefix="LLAMA", vocab_size=vocab,
                                       global_batch=2, seq=8,
                                       synthetic_key=17, device="cpu")

    def test_mean_eval_fn_averages_the_fixed_batches(self):
        seen = []

        def eval_loss(tokens):
            seen.append(int(tokens))
            return torch.tensor(float(tokens))

        fn = ttrain.mean_eval_fn(eval_loss, lambda j: torch.tensor(j), 3)
        assert fn() == pytest.approx(1.0) and seen == [0, 1, 2]


class TestLoop:
    def test_prints_at_the_cadence_and_times_steps(self, monkeypatch,
                                                   capsys, caplog):
        monkeypatch.setenv("TRAININGJOB_STEP_TIMES", "1")
        caplog.set_level("INFO", logger="trainingjob.workload.steps")
        seen = []

        def step_fn(t):
            seen.append(int(t))
            return t.float()

        loss, t_start = ttrain.run_elastic_loop(
            step_fn=step_fn, batch_at=torch.tensor,
            state=ttrain.CheckpointState("", {}), params={}, opt_state={},
            steps=5, start_step=0, ckpt_every=2, eval_fn=lambda: 0.5,
            eval_every=4, units_per_step=10, device="cpu")
        out = capsys.readouterr().out.splitlines()
        assert float(loss) == 4.0 and t_start is not None
        assert seen == [0, 1, 2, 3, 4]
        assert [ln for ln in out if ln.startswith("step ")] == [
            "step 2/5 loss 1.0000", "step 4/5 loss 3.0000",
            "step 5/5 loss 4.0000"]
        assert "eval step 4 loss 0.5000" in out
        assert out[0].startswith("recovery_timing first_step_s=")
        logged = [r.getMessage() for r in caplog.records]
        assert sum(m.startswith("step_time step=") for m in logged) == 5
        assert logged[-1].startswith("train_done steps=4 tokens/s=")


class TestEntryPoint:
    def test_trains_on_the_cpu_when_asked(self, monkeypatch, capsys):
        monkeypatch.setenv("LLAMA_CONFIG", "tiny")
        monkeypatch.setenv("LLAMA_STEPS", "3")
        monkeypatch.setenv("LLAMA_BATCH", "4")
        monkeypatch.setenv("LLAMA_SEQ", "32")
        monkeypatch.setenv("LLAMA_ACCUM", "2")
        assert telastic.main(["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "step 3/3 loss " in out
        done = [ln for ln in out.splitlines() if ln.startswith("done:")]
        assert len(done) == 1 and "width=1" in done[0]
        assert "final_loss=5." in done[0]

    @pytest.mark.parametrize("env,err,match", [
        # tp is ported, but one process cannot hold tp=2 (the JAX mesh
        # arithmetic's error), and a tp that does not divide the heads is
        # refused rather than replicated.
        ({"LLAMA_TP": "2"}, ValueError,
         r"1 devices not divisible by tp\*sp\*ep\*pp=2"),
        ({"LLAMA_TP": "3"}, ValueError, "tp=3 does not divide n_heads=4"),
        # pp and sp are ported too: a pp that does not divide the layers
        # is refused (JAX's gpipe message), and one process cannot hold
        # sp=2.
        ({"LLAMA_PP": "4"}, ValueError, "2 layers not divisible by pp=4"),
        # A width above one card is taken now; a job of several processes
        # without a coordinator to meet at is not.
        ({"TRAININGJOB_CHECKPOINT_DIR": "/x",
          "TRAININGJOB_NUM_PROCESSES": "2"}, ValueError,
         "TRAININGJOB_COORDINATOR_ADDRESS is not set"),
        ({"LLAMA_REMAT": "attn_out"}, ValueError, "unknown remat policy"),
        ({"LLAMA_DTYPE": "float16"}, ValueError, "expected bfloat16 or"),
        ({"LLAMA_CONFIG": "7b", "LLAMA_SP": "2"}, ValueError,
         r"1 devices not divisible by tp\*sp\*ep\*pp=2")])
    def test_refuses_what_is_not_ported(self, monkeypatch, env, err, match):
        def must_not_run(*a, **k):
            raise AssertionError("main built a model it must refuse")

        monkeypatch.setattr(tllama, "init_params", must_not_run)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(err, match=match):
            telastic.main(["--device", "cpu"])

    def test_a_restart_draws_no_init(self, monkeypatch, tmp_path, capsys):
        # The first start draws its parameters on the CPU; a restart that
        # restores a checkpoint only allocates the template.
        gens = []
        real = tllama.init_params

        def recorded(cfg, generator, *a, **k):
            gens.append(generator)
            return real(cfg, generator, *a, **k)

        monkeypatch.setattr(tllama, "init_params", recorded)
        for k, v in {"LLAMA_CONFIG": "tiny", "LLAMA_BATCH": "4",
                     "LLAMA_SEQ": "16", "LLAMA_CKPT_EVERY": "2",
                     "TRAININGJOB_CHECKPOINT_DIR": str(tmp_path)}.items():
            monkeypatch.setenv(k, v)
        for steps in ("2", "4"):
            monkeypatch.setenv("LLAMA_STEPS", steps)
            assert telastic.main(["--device", "cpu"]) == 0
        assert gens[0].device.type == "cpu" and gens[1] is None
        assert "resumed at step 2 (width 1)" in capsys.readouterr().out

    def test_7b_takes_its_default_remat(self, monkeypatch):
        # default_remat gives "attn" at 32 layers; main gets past the
        # policy to the model's init (stopped there: 7B does not fit a
        # test).
        class Reached(Exception):
            pass

        def stop(cfg, *a, **k):
            assert cfg.n_layers == 32
            raise Reached

        monkeypatch.setattr(tllama, "init_params", stop)
        monkeypatch.setenv("LLAMA_CONFIG", "7b")
        with pytest.raises(Reached):
            telastic.main(["--device", "cpu"])

    def test_unknown_config_exits_1(self, monkeypatch, capsys):
        monkeypatch.setenv("LLAMA_CONFIG", "70b")
        assert telastic.main(["--device", "cpu"]) == 1
        assert "unknown" in capsys.readouterr().out


def _step_fn(params, tc, lr, accum, opt_state=None):
    return telastic.make_step_fn(params, tc, accum=accum, lr=lr,
                                 opt_state=opt_state)


class TestResume:
    LR, ACCUM = 3e-3, 2

    def _batches(self, n):
        return [_tokens(B=4, T=16, seed=40 + i) for i in range(n)]

    def test_the_port_continues_a_jax_run(self, tree):
        # JAX trains N steps; its parameters and optax state go through
        # the converters; the port trains M more; the result is JAX's
        # N + M steps.
        jc, tc = _configs()
        N, M = 3, 2
        batches = self._batches(N + M)
        tx = optax.adamw(self.LR, b1=0.9, b2=0.95, weight_decay=0.1)

        @jax.jit
        def jstep(p, o, tokens):
            def loss(p_, tb):
                return jllama.loss_fn(p_, {"tokens": tb}, jc)

            value, grads = jtrain.accumulated_value_and_grad(
                loss, p, tokens, self.ACCUM)
            updates, o = tx.update(grads, o, p)
            return optax.apply_updates(p, updates), o, value

        pj = jax.tree_util.tree_map(jnp.asarray, tree)
        oj = tx.init(pj)
        want = []
        for i, tokens in enumerate(batches):
            pj, oj, value = jstep(pj, oj, jnp.asarray(tokens))
            want.append(float(value))
            if i == N - 1:
                p_mid = jax.tree_util.tree_map(np.asarray, pj)
                o_mid = jax.tree_util.tree_map(np.asarray, oj)
        params = _port_params(p_mid, tc)
        opt_state = ttrain.adamw_state_from_numpy(o_mid, "cpu")
        assert opt_state["count"] == N
        step = _step_fn(params, tc, self.LR, self.ACCUM, opt_state)
        got = [float(step(torch.from_numpy(t))) for t in batches[N:]]
        np.testing.assert_allclose(got, want[N:], rtol=F32_TOL)
        assert step.opt.state["count"] == N + M
        _assert_trees_close(params, pj, F32_TOL)

    def test_a_checkpoint_resume_equals_the_uninterrupted_run(self, tree,
                                                              tmp_path):
        # The port trains N, checkpoints, restores into a fresh
        # CheckpointState and trains M: the same bits as N + M at once.
        from trainingjob_operator_tpu_torch.workloads import rendezvous

        _, tc = _configs()
        N, M = 3, 2
        batches = [torch.from_numpy(t) for t in self._batches(N + M)]
        params = _port_params(tree, tc)
        step = _step_fn(params, tc, self.LR, self.ACCUM)
        want = [float(step(t)) for t in batches]

        rdv = rendezvous.Rendezvous(checkpoint_dir=str(tmp_path))
        params = _port_params(tree, tc)
        st = ttrain.CheckpointState.restore_or_init(
            rdv, {"params": params, "opt_state": ttrain.AdamW(
                params, self.LR).state, "step": 0}, subdir="llama")
        step = _step_fn(params, tc, self.LR, self.ACCUM,
                        st.value["opt_state"])
        got = [float(step(t)) for t in batches[:N]]
        st.save({"params": params, "opt_state": step.opt.state,
                 "step": N})
        st.finalize()

        fresh = _port_params(tree, tc)
        st = ttrain.CheckpointState.restore_or_init(
            rdv, {"params": fresh, "opt_state": ttrain.AdamW(
                fresh, self.LR).state, "step": 0}, subdir="llama")
        assert st.value["step"] == N
        params = st.value["params"]
        for leaf in ttrain.tree_leaves(params):
            leaf.requires_grad_(True)
        step = _step_fn(params, tc, self.LR, self.ACCUM,
                        st.value["opt_state"])
        got += [float(step(t)) for t in batches[N:]]
        assert got == want


class TestPrefetcher:
    def test_batches_come_in_order(self):
        from trainingjob_operator_tpu_torch.data.loader import Prefetcher

        batch_at, *_ = ttrain.build_batch_sources(
            prefix="NOPE", vocab_size=256, global_batch=2, seq=8,
            synthetic_key=17, device="cpu")
        with Prefetcher(batch_at, 3, 9, device="cpu") as batches:
            got = list(batches)
        assert [i for i, _ in got] == list(range(3, 9))
        for i, batch in got:
            assert torch.equal(batch, batch_at(i))

    def test_an_error_is_raised_at_its_step(self):
        from trainingjob_operator_tpu_torch.data.loader import Prefetcher

        def fetch(i):
            if i == 2:
                raise KeyError("no window")
            return torch.tensor([i])

        batches = Prefetcher(fetch, 0, 5, device="cpu")
        assert [next(batches)[0], next(batches)[0]] == [0, 1]
        with pytest.raises(KeyError, match="no window"):
            next(batches)
        with pytest.raises(StopIteration):
            next(batches)


class TestTelemetry:
    def _env(self, monkeypatch, addr):
        from trainingjob_operator_tpu.api import constants

        monkeypatch.setenv(constants.TELEMETRY_ADDR_ENV, addr)
        monkeypatch.setenv(constants.JOB_NAMESPACE_ENV, "default")
        monkeypatch.setenv(constants.JOB_NAME_ENV, "portjob")
        monkeypatch.setenv(constants.REPLICA_NAME_ENV, "Worker")
        monkeypatch.setenv(constants.REPLICA_INDEX_ENV, "0")

    def _drive(self, emitter):
        for i in range(4):
            emitter.emit(i, 20.0 + i, loss=5.0 - i, ckpt_ms=1.5 if i else None,
                         hbm_bytes=1e9 if i % 2 == 0 else None)
        emitter.emit_serve(queue_depth=2, active_slots=3, slots=4,
                           p50_ms=10.0, p99_ms=30.0, tokens_per_sec=100.0,
                           completed=7)
        emitter.emit_request("completed", 5, "e1", 9, ttft_ms=12.0,
                             tpot_ms=3.0, tokens=16, arrival=1.0,
                             phase_ms={"queued": 1.0})

    def test_the_records_are_the_jax_emitters(self, monkeypatch):
        from trainingjob_operator_tpu.obs.telemetry import (
            TelemetryEmitter as JEmitter,
        )

        from trainingjob_operator_tpu_torch.obs.telemetry import (
            TelemetryEmitter as TEmitter,
        )

        self._env(monkeypatch, "127.0.0.1:1")
        monkeypatch.setenv("TRAININGJOB_PEAK_FLOPS", "1e15")
        records = {}
        for side, cls in (("jax", JEmitter), ("port", TEmitter)):
            sent = records[side] = []
            em = cls(units_per_step=64.0, flops_per_step=1e12)
            monkeypatch.setattr(em, "_send", sent.append)
            self._drive(em)
        for rec in records["jax"] + records["port"]:
            rec.pop("ts")
        assert records["port"] == records["jax"]
        assert len(records["port"]) == 6

    @pytest.mark.parametrize("fallback", ["", "corrupt_latest"])
    def test_the_resume_record_is_the_jax_emitters(self, monkeypatch,
                                                   fallback):
        from trainingjob_operator_tpu.obs.telemetry import (
            TelemetryEmitter as JEmitter,
        )

        from trainingjob_operator_tpu_torch.obs.telemetry import (
            TelemetryEmitter as TEmitter,
        )

        self._env(monkeypatch, "127.0.0.1:1")
        records = {}
        for side, cls in (("jax", JEmitter), ("port", TEmitter)):
            sent = records[side] = []
            em = cls()
            monkeypatch.setattr(em, "_send", sent.append)
            em.emit_resume(1234.5678, 0.0, False, fallback=fallback)
        for rec in records["jax"] + records["port"]:
            rec.pop("ts")
        assert records["port"] == records["jax"]
        assert ("resume_fallback" in records["port"][0]) == bool(fallback)

    def test_the_jax_sink_ingests_the_resume_record(self, monkeypatch):
        from conftest import wait_for
        from trainingjob_operator_tpu.obs.telemetry import (
            TelemetryAggregator,
            TelemetrySink,
        )
        from trainingjob_operator_tpu.utils.metrics import MetricsRegistry

        class Incidents:
            def __init__(self):
                self.resumes = []

            def record_resume(self, job, restore_ms, compile_ms, overlapped,
                              now=None, fallback=""):
                self.resumes.append((job, restore_ms, compile_ms, overlapped,
                                     fallback))

        incidents = Incidents()
        reg = MetricsRegistry()
        agg = TelemetryAggregator(metrics=reg, incidents=incidents)
        sink = TelemetrySink(aggregator=agg, publish=False).start()
        try:
            self._env(monkeypatch, sink.address)
            ttrain.push_resume_record(2.5, "corrupt_latest")
            assert wait_for(lambda: incidents.resumes, 10)
            assert incidents.resumes == [
                ("default/portjob", 2500.0, 0.0, False, "corrupt_latest")]
            assert reg.snapshot().get(
                "trainingjob_telemetry_malformed_total", 0) == 0
        finally:
            sink.stop()

    def test_the_jax_sink_ingests_the_port_records(self, monkeypatch):
        from conftest import wait_for
        from trainingjob_operator_tpu.obs.goodput import GoodputTracker
        from trainingjob_operator_tpu.obs.telemetry import (
            TelemetryAggregator,
            TelemetrySink,
        )
        from trainingjob_operator_tpu.utils.metrics import MetricsRegistry

        from trainingjob_operator_tpu_torch.obs.telemetry import (
            TelemetryEmitter,
        )

        reg = MetricsRegistry()
        agg = TelemetryAggregator(metrics=reg,
                                  goodput=GoodputTracker(metrics=reg))
        sink = TelemetrySink(aggregator=agg, publish=False).start()
        try:
            self._env(monkeypatch, sink.address)
            em = TelemetryEmitter(units_per_step=64.0)
            assert em.enabled
            self._drive(em)
            em.close()

            def row():
                table = agg.job_table("default/portjob") or {"replicas": []}
                return table["replicas"][0] if table["replicas"] else None

            assert wait_for(lambda: row() is not None and row()["step"] == 3,
                            10)
            assert wait_for(lambda: agg.serve_stats("default/portjob")
                            is not None, 10)
            r = row()
            assert (r["rtype"], r["rank"], r["loss"]) == ("worker", 0, 2.0)
            assert r["ckpt_ms"] == 1.5 and r["hbm_bytes"] == 1e9
            assert reg.snapshot().get(
                "trainingjob_telemetry_malformed_total", 0) == 0
        finally:
            sink.stop()
