"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct;
and the control (the reference in fp8 in the program's place) fails one
of each cell's numbers.  On the CPU at small sizes, in float32, against
each cell's own limits; the harness's look for a card is skipped."""

from __future__ import annotations

import pytest

from benchmark import control, harness

TINY = {"hidden_size": 128, "intermediate_size": 256,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 32,
        "num_hidden_layers": 2, "vocab_size": 512, "torch_dtype": "float32"}
TRAIN = {"mistral-7b.train.s4096": {"config": TINY},
         "mixtral-8x7b.train.s4096": {"config": {**TINY,
                                                 "num_local_experts": 4}}}
for over in TRAIN.values():
    over.update(traffic={"seq": 64, "rows_per_step": 4}, cell={"accum": 2})
SERVE = {"config": {**TINY, "hidden_size": 512, "num_attention_heads": 16,
                    "num_key_value_heads": 4},
         "traffic": {"prompt": {"median": 40, "sigma": 0.5, "min": 8,
                                "max": 64},
                     "output": {"median": 12, "sigma": 0.5, "min": 4,
                                "max": 32}},
         "cell": {"slots": 4, "max_len": 96, "prefill_chunk": 16,
                  "rate_per_s": 10.0, "warm_s": 0.3, "check_tokens": 64}}
SEED = 2 ** 31 + 101


def _run(name, overrides):
    return harness.run_cell(name, SEED, 0.3, False, "cpu",
                            overrides=overrides)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_a_sound_training_run_is_correct(name):
    assert _run(name, TRAIN[name])["correct"] is True


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_a_step_that_leaves_the_state_unchanged_is_caught(name, monkeypatch):
    from trainingjob_operator_tpu_torch.workloads import train

    monkeypatch.setattr(train.AdamW, "step", lambda self, params, grads: None)
    assert _run(name, TRAIN[name])["correct"] is False


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    from trainingjob_operator_tpu_torch.models import llama, moe

    for module in (llama, moe):
        real = module.loss_fn

        def half(params, batch, config, *, _real=real, **kw):
            tokens = batch["tokens"]
            return _real(params, {"tokens": tokens[: tokens.shape[0] // 2]},
                         config, **kw)

        monkeypatch.setattr(module, "loss_fn", half)
    assert _run(name, TRAIN[name])["correct"] is False


def _adamw_step(lr_scale, bias_correction):
    """``AdamW.step`` as the port writes it, with its step ``lr_scale``
    times as long, or without its bias corrections."""
    import torch
    from trainingjob_operator_tpu_torch.workloads.train import tree_leaves

    @torch.no_grad()
    def step(self, params, grads):
        self.state["count"] += 1
        count = self.state["count"]
        bc1, bc2 = ((1.0 - self.b1 ** count, 1.0 - self.b2 ** count)
                    if bias_correction else (1.0, 1.0))
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(self.state["mu"]),
                              tree_leaves(self.state["nu"])):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.lr * lr_scale)

    return step


@pytest.mark.parametrize("name", sorted(TRAIN))
@pytest.mark.parametrize("fault", ["no_bias_correction", "lr_x1.5"])
def test_a_wrong_adamw_is_caught(name, fault, monkeypatch):
    from trainingjob_operator_tpu_torch.workloads import train

    monkeypatch.setattr(train.AdamW, "step", _adamw_step(
        1.5 if fault == "lr_x1.5" else 1.0, fault != "no_bias_correction"))
    assert _run(name, TRAIN[name])["correct"] is False


def test_the_planted_adamw_unbroken_is_correct(monkeypatch):
    from trainingjob_operator_tpu_torch.workloads import train

    monkeypatch.setattr(train.AdamW, "step", _adamw_step(1.0, True))
    name = "mixtral-8x7b.train.s4096"
    assert _run(name, TRAIN[name])["correct"] is True


def test_a_sound_serving_run_is_correct():
    line = _run("mistral-7b.serve.chat", SERVE)
    assert line["correct"] is True and line["failed"] == 0


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from trainingjob_operator_tpu_torch.workloads import serve

    real = serve.DecodeService._emit_token

    def altered(self, sl, tok, now):
        if len(sl.req.tokens) == 2:
            tok = (tok + 1) % TINY["vocab_size"]
        return real(self, sl, tok, now)

    monkeypatch.setattr(serve.DecodeService, "_emit_token", altered)
    assert _run("mistral-7b.serve.chat", SERVE)["correct"] is False


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_the_training_control_fails_a_number(name):
    got = control.train_readings(name, SEED, "cpu", overrides=TRAIN[name])
    limits = harness.find_cell(name).settings["limits"]
    for reading in ("control", "half_batch", "unchanged",
                    "no_bias_correction", "lr_x1.5"):
        assert any(got[reading][k] > v for k, v in limits.items()), reading
