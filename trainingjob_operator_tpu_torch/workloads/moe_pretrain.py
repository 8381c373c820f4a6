"""Mixtral-style MoE pretraining on one card or across processes over a
``dp x fsdp x tp x ep`` mesh: the port of the JAX package's
``workloads/moe_pretrain.py``.

The loss (``models/moe.py`` ``loss_fn``: cross-entropy plus the weighted
load-balancing auxiliary), its backward through the flash backward
kernels, AdamW in optax's order (b1 0.9, b2 0.95, weight decay 0.1) and
the step loop with checkpoints, preemption, prefetch and telemetry are the
Llama trainer's (``llama_elastic.make_step_fn``, ``workloads/train.py``
``run_elastic_loop``).  With ``TRAININGJOB_CHECKPOINT_DIR`` set,
``{"params", "opt_state", "step"}`` is restored from ``<dir>/moe`` (or
initialised) and saved every MOE_CKPT_EVERY steps; SIGTERM saves the
current step and exits 143.  The parameters start as a seeded random init
drawn on the CPU (``torch.Generator`` seed 0), the same on every device,
and are not drawn when a checkpoint restores; f32 masters, cast to the
compute dtype at each use.

Across processes (``TRAININGJOB_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``; ``MEGASCALE_NUM_SLICES`` sets dp), as the Llama trainer:
each process drives one card, the process group forms
(``rendezvous.initialize_distributed``; with a coordinator address one
process forms a group of one), the mesh is JAX's
``mesh_from_rendezvous(..., model_parallel=MOE_TP, expert_parallel=
MOE_EP)`` with its errors, each process keeps its blocks of the
parameters and AdamW state under the MoE sharding rules (experts on
``ep``), trains on its data shard's rows (``sharding.data_rows``: the ep
and tp ranks of a shard take the same rows), and writes its shard of
each checkpoint, which restores at any width.  Without a coordinator one
process takes the single-card path and its checkpoint format.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.moe_pretrain
[--device cuda|cpu]``.  Env, as the JAX module reads it: MOE_CONFIG=
tiny|8x7b, MOE_TP, MOE_EP, MOE_STEPS, MOE_BATCH (global), MOE_SEQ,
MOE_LR, MOE_CKPT_EVERY, MOE_REMAT (none/full/attn/dots; default
``default_remat``), MOE_CE_CHUNK (chunked cross-entropy), MOE_WINDOW
(sliding-window span), and the shared data and eval set (MOE_DATA,
MOE_SEED, MOE_EVAL_EVERY / _BATCHES / _FRACTION: ``build_batch_sources``);
the worker env of ``llama_elastic`` but its resize channel (JAX's MoE
trainer has no resize in place).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import List, Optional

import torch

from trainingjob_operator_tpu_torch import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.moe_pretrain")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    rdv, device = rendezvous.prepare_worker(args.device, subdir="moe")
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.models import llama, moe
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.parallel import sharding
    from trainingjob_operator_tpu_torch.workloads import llama_elastic, train

    env = os.environ
    tp = int(env.get("MOE_TP", "1"))
    ep = int(env.get("MOE_EP", "1"))
    cfg = moe.CONFIGS.get(env.get("MOE_CONFIG", "tiny"), moe.MoEConfig.tiny)()
    steps = int(env.get("MOE_STEPS", "20"))
    global_batch = int(env.get("MOE_BATCH", "8"))
    seq = int(env.get("MOE_SEQ", "128"))
    lr = float(env.get("MOE_LR", "3e-4"))
    ckpt_every = int(env.get("MOE_CKPT_EVERY", "10"))
    remat = llama.remat_policy(env.get("MOE_REMAT",
                                       train.default_remat(cfg.n_layers)))
    ce_chunk = int(env.get("MOE_CE_CHUNK", "0"))
    window = int(env.get("MOE_WINDOW", "0"))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)

    # JAX's mesh arithmetic and errors, then the port's refusal of a tp
    # its attention and experts cannot split, before any group forms.
    spec = pmesh.mesh_spec_from_rendezvous(rdv, model_parallel=tp,
                                           expert_parallel=ep)
    moe.check_tp(cfg, tp)
    mesh = None
    if rdv.coordinator_address or rdv.num_processes > 1:
        device = rendezvous.initialize_distributed(rdv, device)
        mesh = pmesh.make_mesh(spec, device.type)
    print(f"elastic width {rdv.elastic_replicas}, mesh {spec.sizes}, "
          f"{moe.num_params(cfg) / 1e6:.1f}M params "
          f"({moe.active_params(cfg) / 1e6:.1f}M active), restart "
          f"{rdv.restart_count}", flush=True)
    n_data = mesh.data_size() if mesh is not None else 1
    global_batch, _ = train.round_global_batch(global_batch, n_data)
    row0, local_batch = (sharding.data_rows(global_batch, mesh)
                         if mesh is not None else (0, global_batch))

    # Drawn on the CPU, so that the card and the CPU start from the same
    # parameters at every width; a restart that restores draws nothing.
    generator = None
    if not train.CheckpointState.has_checkpoint(rdv, subdir="moe"):
        generator = torch.Generator().manual_seed(0)
    params = moe.init_params(cfg, generator, device, master=True, mesh=mesh)
    state = train.CheckpointState.restore_or_init(
        rdv, {"params": params, "opt_state": train.AdamW(params, lr).state,
              "step": 0}, subdir="moe",
        layout=llama_elastic.shard_layout(rdv, cfg, mesh, moe),
        convert=llama_elastic.from_jax_state(cfg))
    del params
    start_step = int(state.value["step"])
    params = state.value["params"]
    opt_state = state.value["opt_state"]
    if start_step > 0:
        print(f"resumed at step {start_step} (width "
              f"{rdv.elastic_replicas})", flush=True)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)

    batch_at, eval_host_at, eval_every, eval_batches = (
        train.build_batch_sources(
            prefix="MOE", vocab_size=cfg.vocab_size,
            global_batch=global_batch, seq=seq, synthetic_key=23,
            device="cpu", local_batch=local_batch, row0=row0))
    eval_fn = None
    if eval_host_at is not None:
        # Same ce_chunk as training: eval must fit where training fits.
        eval_fn = train.mean_eval_fn(
            lambda tokens: moe.loss_fn(params, {"tokens": tokens}, cfg,
                                       ce_chunk=ce_chunk, mesh=mesh),
            lambda j: eval_host_at(j).to(device), eval_batches)
    step_fn = llama_elastic.make_step_fn(
        params, cfg, accum=1, lr=lr, remat=remat, ce_chunk=ce_chunk,
        opt_state=opt_state, mesh=mesh, loss_fn=moe.loss_fn)

    # The 6 * params * tokens FLOPs estimate is an upper bound for an MoE
    # (only the top-k experts run for a token), as in JAX.
    tokens_per_step = global_batch * seq
    try:
        loss, t_start = train.run_elastic_loop(
            step_fn=step_fn, batch_at=batch_at, state=state, params=params,
            opt_state=opt_state, steps=steps, start_step=start_step,
            ckpt_every=ckpt_every, eval_fn=eval_fn, eval_every=eval_every,
            units_per_step=tokens_per_step,
            flops_per_step=6.0 * moe.num_params(cfg) * tokens_per_step,
            device=device)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    dt = max(time.time() - (t_start or time.time()), 1e-9)
    done = max(steps - start_step - 1, 1)
    print(f"done: steps={done} tokens/s={done * tokens_per_step / dt:.0f} "
          f"width={rdv.elastic_replicas} "
          f"final_loss={float(loss) if loss is not None else -1:.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
