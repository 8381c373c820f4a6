"""Llama-2 pretraining on one card or across processes: the port of the
JAX package's ``workloads/llama_elastic.py`` at a fixed width.

The loss (``models/llama.py`` ``loss_fn``), its backward through the flash
backward kernels, gradient accumulation, AdamW in optax's order, and the
step loop with checkpoints, preemption, prefetch and telemetry
(``workloads/train.py`` ``run_elastic_loop``).  With
``TRAININGJOB_CHECKPOINT_DIR`` set, ``{"params", "opt_state", "step"}``
is restored from ``<dir>/llama`` (or initialised) and saved every
LLAMA_CKPT_EVERY steps; SIGTERM saves the current step and exits 143.

Across processes (``TRAININGJOB_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``; ``MEGASCALE_NUM_SLICES`` sets dp) each process drives one
card: the process group forms (``rendezvous.initialize_distributed``;
with a coordinator address a single process forms a group of one), the
``dp x fsdp x tp`` mesh is built as the JAX ``mesh_from_rendezvous``
builds it, each process initialises and keeps only its blocks of the
parameters and AdamW state, trains on its rows of the global batch, and
writes its shard of each checkpoint, which restores at any width.  Not
ported yet, and refused at startup rather than ignored: sequence and
pipeline parallelism (``LLAMA_SP/PP`` > 1; ROADMAP.md queue 1 items 3-4)
and the in-place resize.  The parameters start as a seeded random init
drawn on the CPU (``torch.Generator`` seed 0, not JAX's PRNGKey(0)), the
same on every device and at every width (and not drawn when a checkpoint
restores), f32 masters cast to the compute dtype at each use.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.llama_elastic
[--device cuda|cpu]``.  Env, as the JAX module reads it:
LLAMA_CONFIG=tiny|124m|7b, LLAMA_TP, LLAMA_STEPS, LLAMA_BATCH (global),
LLAMA_SEQ, LLAMA_LR, LLAMA_ACCUM (gradient-accumulation microbatches),
LLAMA_CKPT_EVERY (the loss-print and checkpoint cadence), LLAMA_REMAT
(none/full/attn/dots; default ``default_remat``: "attn" at 32 layers,
else "none"), LLAMA_CE_CHUNK (chunked cross-entropy;
0 = whole logits), LLAMA_WINDOW (sliding-window span; 0 = full causal),
LLAMA_DTYPE (the compute dtype, bfloat16 or float32; default the
config's: float32 makes runs on the CPU and the card comparable),
LLAMA_DATA (a ``.tokens`` corpus; default synthetic tokens), LLAMA_SEED,
LLAMA_EVAL_EVERY / LLAMA_EVAL_BATCHES / LLAMA_EVAL_FRACTION.  The
operator's worker env (``constants.py``): TRAININGJOB_CHECKPOINT_DIR,
TRAININGJOB_REPLICA_NAME / _INDEX / _RESTARTCOUNT, the rendezvous above,
and the knobs of ``workloads/train.py`` (snapshot saves, fault
injection, profiler, step times, telemetry, trace).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, List, Optional

import torch

from trainingjob_operator_tpu_torch import resolve_device

def make_step_fn(params, cfg, *, accum: int, lr: float, remat="none",
                 ce_chunk: int = 0, opt_state: Optional[dict] = None,
                 mesh=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The train step of ``main``: loss and gradients of ``llama.loss_fn``
    over ``accum`` interleaved microbatches, then one AdamW update
    (``optax.adamw(lr, b1=0.9, b2=0.95, weight_decay=0.1)``, as
    ``llama_elastic.py:111`` builds it) from ``opt_state`` (zeros when
    None).  ``step_fn(tokens [B, T+1])`` updates the leaves of ``params``
    (which must require grad) and the optimizer state ``step_fn.opt.state``
    in place and returns the loss.

    With a ``mesh``, ``params`` and ``opt_state`` are this process's blocks
    and ``tokens`` its rows of the global batch; the gradients reach each
    block summed over the data axes (``llama.loss_fn``), so AdamW, which is
    elementwise, updates the blocks as it would the whole leaves, and the
    loss returned is the global one."""
    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.workloads import train

    opt = train.AdamW(params, lr, b1=0.9, b2=0.95, weight_decay=0.1,
                      state=opt_state)

    def loss(p, tokens):
        return llama.loss_fn(p, {"tokens": tokens}, cfg, remat=remat,
                             ce_chunk=ce_chunk, mesh=mesh)

    def step_fn(tokens):
        value, grads = train.accumulated_value_and_grad(loss, params, tokens,
                                                        accum)
        opt.step(params, grads)
        return value

    step_fn.opt = opt
    return step_fn


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.llama_elastic")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    t_main = time.time()
    device = resolve_device(args.device)

    from trainingjob_operator_tpu_torch.models import llama
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.parallel import sharding
    from trainingjob_operator_tpu_torch.workloads import rendezvous, train

    rdv = rendezvous.from_env()
    env = os.environ
    cfg_name = env.get("LLAMA_CONFIG", "tiny")
    if cfg_name not in llama.CONFIGS:
        print(f"LLAMA_CONFIG={cfg_name!r} unknown; expected one of "
              f"{sorted(llama.CONFIGS)}", flush=True)
        return 1
    cfg = llama.CONFIGS[cfg_name]()
    dtype = env.get("LLAMA_DTYPE", "")
    if dtype:
        if dtype not in ("bfloat16", "float32"):
            raise ValueError(f"LLAMA_DTYPE={dtype!r}: expected bfloat16 or "
                             f"float32")
        cfg = dataclasses.replace(cfg, dtype=dtype)
    for axis in ("SP", "PP"):
        if int(env.get(f"LLAMA_{axis}", "1")) > 1:
            raise NotImplementedError(
                f"LLAMA_{axis} > 1: sequence and pipeline parallelism are "
                f"not ported yet (ROADMAP.md queue 1 items 3-4)")
    tp = int(env.get("LLAMA_TP", "1"))
    llama.check_tp(cfg, tp)
    spec = pmesh.mesh_spec_from_rendezvous(rdv, model_parallel=tp)
    mesh = None
    if rdv.coordinator_address or rdv.num_processes > 1:
        device = rendezvous.initialize_distributed(rdv, device)
        mesh = pmesh.make_mesh(spec, device.type)
    t_init = time.time()
    steps = int(env.get("LLAMA_STEPS", "20"))
    batch_req = int(env.get("LLAMA_BATCH", "8"))
    seq = int(env.get("LLAMA_SEQ", "128"))
    lr = float(env.get("LLAMA_LR", "3e-4"))
    ckpt_every = int(env.get("LLAMA_CKPT_EVERY", "10"))
    accum_req = int(env.get("LLAMA_ACCUM", "1"))
    remat = llama.remat_policy(env.get("LLAMA_REMAT",
                                       train.default_remat(cfg.n_layers)))
    ce_chunk = int(env.get("LLAMA_CE_CHUNK", "0"))
    window = int(env.get("LLAMA_WINDOW", "0"))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)

    n_data = mesh.data_size() if mesh is not None else 1
    global_batch, accum = train.round_global_batch(batch_req, n_data,
                                                   accum=accum_req)
    row0, local_batch = (sharding.data_rows(global_batch, mesh)
                         if mesh is not None else (0, global_batch))
    where = f", mesh {mesh.sizes}" if mesh is not None else ""
    print(f"width {rdv.elastic_replicas}, device {device}{where}, "
          f"{llama.num_params(cfg) / 1e6:.1f}M params, restart "
          f"{rdv.restart_count}", flush=True)
    # Training batches are made on the host and copied to the card by the
    # loop's prefetcher; eval batches go straight to the card.
    batch_at, eval_host_at, eval_every, eval_batches = (
        train.build_batch_sources(prefix="LLAMA", vocab_size=cfg.vocab_size,
                                  global_batch=global_batch, seq=seq,
                                  synthetic_key=17, device="cpu",
                                  local_batch=local_batch, row0=row0))
    # Drawn on the CPU, so that the card and the CPU start from the same
    # parameters, as JAX's PRNG gives the same on every device; a restart
    # that restores a checkpoint draws nothing.
    generator = None
    if not train.CheckpointState.has_checkpoint(rdv, subdir="llama"):
        generator = torch.Generator().manual_seed(0)
    params = llama.init_params(cfg, generator, device, master=True,
                               mesh=mesh)
    opt_state = train.AdamW(params, lr).state
    layout = None
    if mesh is not None:
        blocks = sharding.tree_blocks(llama.param_shapes(cfg),
                                      llama.sharding_rules(), mesh)
        layout = train.ShardLayout(
            rdv.process_id, rdv.num_processes,
            {"params": blocks, "opt_state": {"mu": blocks, "nu": blocks}})
    t_setup = time.time()
    # One checkpoint path for every process of the job, as in JAX.
    state = train.CheckpointState.restore_or_init(
        rdv, {"params": params, "opt_state": opt_state, "step": 0},
        subdir="llama", layout=layout)
    restore_s = time.time() - t_setup
    train.push_resume_record(restore_s, state.fallback)
    start_step = int(state.value["step"])
    params = state.value["params"]
    opt_state = state.value["opt_state"]
    if start_step > 0:
        print(f"resumed at step {start_step} (width "
              f"{rdv.elastic_replicas})", flush=True)
    # JAX's recovery breakdown, for its log readers: eager PyTorch compiles
    # nothing (the kernels build at the first launch, inside first_step_s),
    # so compile_s is 0 and the phases do not overlap.
    print(f"recovery_timing init_s={t_init - t_main:.2f} "
          f"setup_s={t_setup - t_init:.2f} restore_s={restore_s:.2f} "
          f"compile_s=0.00 resume_phases_wall_s={restore_s:.2f} "
          f"resume_overlap=0", flush=True)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = make_step_fn(params, cfg, accum=accum, lr=lr, remat=remat,
                           ce_chunk=ce_chunk, opt_state=opt_state, mesh=mesh)
    eval_fn = None
    if eval_host_at is not None:
        # Same remat and ce_chunk as the train step: eval fits where
        # training fits.
        eval_fn = train.mean_eval_fn(
            lambda tokens: llama.loss_fn(params, {"tokens": tokens}, cfg,
                                         remat=remat, ce_chunk=ce_chunk,
                                         mesh=mesh),
            lambda j: eval_host_at(j).to(device), eval_batches)

    tokens_per_step = global_batch * seq
    n_params = llama.num_params(cfg)
    try:
        loss, t_start = train.run_elastic_loop(
            step_fn=step_fn, batch_at=batch_at, state=state, params=params,
            opt_state=opt_state, steps=steps, start_step=start_step,
            ckpt_every=ckpt_every, eval_fn=eval_fn, eval_every=eval_every,
            units_per_step=tokens_per_step,
            flops_per_step=6.0 * n_params * tokens_per_step, device=device)
    finally:
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()
    dt = max(time.time() - (t_start or time.time()), 1e-9)
    done = max(steps - start_step - 1, 1)
    print(f"done: steps={done} tokens/s={done * tokens_per_step / dt:.0f} "
          f"width={rdv.elastic_replicas} "
          f"final_loss={float(loss) if loss is not None else -1:.4f} "
          f"restart_count={rdv.restart_count}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
