"""Llama-2 pretraining on one card: the port of the JAX package's
``workloads/llama_elastic.py`` at width 1.

The loss (``models/llama.py`` ``loss_fn``), its backward through the flash
backward kernels, gradient accumulation, AdamW in optax's order and the
step loop (``workloads/train.py``).  Not ported yet, and refused at
startup rather than ignored: more than one card or model-parallel axes
(``LLAMA_TP/SP/PP`` > 1; ROADMAP.md queue 1 item 3) and checkpointing
(``TRAININGJOB_CHECKPOINT_DIR``; queue 1 item 2b).  The parameters are a
seeded random init (``torch.Generator`` seed 0, not JAX's PRNGKey(0)),
f32 masters cast to the compute dtype at each use.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.llama_elastic
[--device cuda|cpu]``.  Env, as the JAX module reads it:
LLAMA_CONFIG=tiny|124m|7b, LLAMA_STEPS, LLAMA_BATCH (global),
LLAMA_SEQ, LLAMA_LR, LLAMA_ACCUM (gradient-accumulation microbatches),
LLAMA_CKPT_EVERY (the loss-print cadence; in JAX it is also the
checkpoint cadence), LLAMA_REMAT (none/full; default ``default_remat``,
which picks "attn" at 32 layers -- not ported, so the 7B config needs
LLAMA_REMAT=none or full), LLAMA_CE_CHUNK (chunked cross-entropy;
0 = whole logits), LLAMA_WINDOW (sliding-window span; 0 = full causal),
LLAMA_DATA (a ``.tokens`` corpus; default synthetic tokens), LLAMA_SEED,
LLAMA_EVAL_EVERY / LLAMA_EVAL_BATCHES / LLAMA_EVAL_FRACTION.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, List, Optional

import torch

from trainingjob_operator_tpu_torch import constants, resolve_device

CONFIGS = ("7b", "124m", "tiny")


def make_step_fn(params, cfg, *, accum: int, lr: float, remat="none",
                 ce_chunk: int = 0) -> Callable[[torch.Tensor], torch.Tensor]:
    """The train step of ``main``: loss and gradients of ``llama.loss_fn``
    over ``accum`` interleaved microbatches, then one AdamW update
    (``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)``, as
    ``llama_elastic.py:111`` builds it).  ``step_fn(tokens [B, T+1])``
    updates the leaves of ``params`` (which must require grad) in place and
    returns the loss."""
    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.workloads import train

    opt = train.AdamW(params, lr, b1=0.9, b2=0.95, weight_decay=0.1)

    def loss(p, tokens):
        return llama.loss_fn(p, {"tokens": tokens}, cfg, remat=remat,
                             ce_chunk=ce_chunk)

    def step_fn(tokens):
        value, grads = train.accumulated_value_and_grad(loss, params, tokens,
                                                        accum)
        opt.step(params, grads)
        return value

    return step_fn


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.llama_elastic")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.workloads import train

    env = os.environ
    cfg_name = env.get("LLAMA_CONFIG", "tiny")
    if cfg_name not in CONFIGS:
        print(f"LLAMA_CONFIG={cfg_name!r} unknown; expected one of "
              f"{sorted(CONFIGS)}", flush=True)
        return 1
    cfg = {"7b": llama.LlamaConfig.llama2_7b,
           "124m": llama.LlamaConfig.base_124m,
           "tiny": llama.LlamaConfig.tiny}[cfg_name]()
    for axis in ("TP", "SP", "PP"):
        if int(env.get(f"LLAMA_{axis}", "1")) > 1:
            raise NotImplementedError(
                f"LLAMA_{axis} > 1: the port trains on one card; model "
                f"parallelism comes with ROADMAP.md queue 1 item 3")
    if env.get(constants.CHECKPOINT_DIR_ENV):
        raise NotImplementedError(
            f"{constants.CHECKPOINT_DIR_ENV} is set, but the port does not "
            f"checkpoint yet (ROADMAP.md queue 1 item 2b); unset it to "
            f"train without checkpoints")
    steps = int(env.get("LLAMA_STEPS", "20"))
    batch_req = int(env.get("LLAMA_BATCH", "8"))
    seq = int(env.get("LLAMA_SEQ", "128"))
    lr = float(env.get("LLAMA_LR", "3e-4"))
    log_every = int(env.get("LLAMA_CKPT_EVERY", "10"))
    accum_req = int(env.get("LLAMA_ACCUM", "1"))
    remat = llama.remat_policy(env.get("LLAMA_REMAT",
                                       train.default_remat(cfg.n_layers)))
    ce_chunk = int(env.get("LLAMA_CE_CHUNK", "0"))
    window = int(env.get("LLAMA_WINDOW", "0"))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)

    global_batch, accum = train.round_global_batch(batch_req, 1,
                                                   accum=accum_req)
    print(f"width 1, device {device}, "
          f"{llama.num_params(cfg) / 1e6:.1f}M params, restart 0",
          flush=True)
    batch_at, eval_batch_at, eval_every, eval_batches = (
        train.build_batch_sources(prefix="LLAMA", vocab_size=cfg.vocab_size,
                                  global_batch=global_batch, seq=seq,
                                  synthetic_key=17, device=device))
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device,
        master=True)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = make_step_fn(params, cfg, accum=accum, lr=lr, remat=remat,
                           ce_chunk=ce_chunk)
    eval_fn = None
    if eval_batch_at is not None:
        # Same remat and ce_chunk as the train step: eval fits where
        # training fits.
        eval_fn = train.mean_eval_fn(
            lambda tokens: llama.loss_fn(params, {"tokens": tokens}, cfg,
                                         remat=remat, ce_chunk=ce_chunk),
            eval_batch_at, eval_batches)

    tokens_per_step = global_batch * seq
    loss, t_start = train.run_loop(
        step_fn=step_fn, batch_at=batch_at, steps=steps,
        log_every=log_every, eval_fn=eval_fn, eval_every=eval_every,
        units_per_step=tokens_per_step)
    dt = max(time.time() - (t_start or time.time()), 1e-9)
    done = max(steps - 1, 1)
    print(f"done: steps={done} tokens/s={done * tokens_per_step / dt:.0f} "
          f"width=1 "
          f"final_loss={float(loss) if loss is not None else -1:.4f} "
          f"restart_count=0", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
