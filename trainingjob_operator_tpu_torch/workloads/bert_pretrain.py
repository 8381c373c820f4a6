"""BERT masked-LM pretraining (config 4) on one card or across processes
over a ``dp x fsdp x tp`` mesh: the port of the JAX package's
``workloads/bert_pretrain.py``.

The loss is ``models/bert.py`` ``loss_fn``; the optimizer is
``optax.adamw(lr, weight_decay=0.01)`` (b1 0.9, b2 0.999, eps 1e-8, the
decay on every leaf): the port's ``AdamW(b2=0.999, weight_decay=0.01)``.
The parameters start as a seeded random init drawn on the CPU
(``torch.Generator`` seed 0, the same at every width), f32 masters cast
to the compute dtype at each use, and are not drawn when a checkpoint
restores.  The data is synthetic, as JAX's: the global batch of step
``i`` is drawn from a generator seeded by ``i`` (``synthetic_mlm_batch``:
targets in [1, vocab), 15% of the positions masked to token 0).

Across processes (``TRAININGJOB_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``; ``MEGASCALE_NUM_SLICES`` sets dp) each process drives
one card, the group forms (``rendezvous.initialize_distributed``), the
mesh is JAX's ``mesh_from_rendezvous(..., model_parallel=BERT_TP)``, each
process keeps its blocks of the parameters and AdamW moments under
JAX's BERT rules (``bert.sharding_rules``), and it trains on its data
shard's rows (``sharding.data_rows``: the tp ranks of a shard take the
same rows).  JAX's main instead gives each process ``global_batch //
process_count`` rows of its own key, which at ``BERT_TP`` > 1 feeds the
tp processes of one shard different rows (a reference fault).

Checkpoints: with ``TRAININGJOB_CHECKPOINT_DIR`` set, ``{"params",
"opt_state", "step"}`` is restored from ``<dir>/bert`` (any width) or
initialised (a state the JAX trainer committed restores from its resume
image: ``from_jax_state``), and saved every 10 steps and at the last.
Like JAX's, the
trainer installs no SIGTERM handler: a killed job resumes from its last
save (``TRAININGJOB_KILL_AT_STEP``: ``train.kill_at_step``).

Run: ``python -m trainingjob_operator_tpu_torch.workloads.bert_pretrain
[--device cuda|cpu]``.  Env, as the JAX module reads it: BERT_CONFIG=
tiny|base (tiny), BERT_TP (1), BERT_STEPS (20), BERT_BATCH (32, global),
BERT_SEQ (128: it must fit the config's max_seq_len, 64 for tiny, which
JAX's default does not either), BERT_LR (1e-4).  Lines: ``resumed at step N`` on a
resume, ``step i/n loss x.xxxx`` every 10 steps and at the last, and
``done: steps= tokens/s= mesh={...} processes= final_loss=``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from trainingjob_operator_tpu_torch import resolve_device

#: Steps between two loss lines and saves (and the last step).
LOG_EVERY = 10
#: The seed of step i's batch is DATA_SEED + i.
DATA_SEED = 11


def synthetic_mlm_batch(generator: torch.Generator, batch: int, seq: int,
                        vocab: int, mask_token: int = 0,
                        rate: float = 0.15) -> Dict[str, torch.Tensor]:
    """Random MLM rows, JAX's distribution: targets uniform in [1, vocab),
    each position masked (set to ``mask_token`` in ``tokens``) with
    probability ``rate``; ``mask`` is 1 where a position was masked.
    Drawn on the generator's device."""
    dev = generator.device
    targets = torch.randint(1, vocab, (batch, seq), generator=generator,
                            device=dev)
    mask = torch.rand((batch, seq), generator=generator, device=dev) < rate
    tokens = torch.where(mask, torch.full_like(targets, mask_token), targets)
    return {"tokens": tokens, "targets": targets, "mask": mask.long()}


def batch_at(step: int, global_batch: int, seq: int, vocab: int,
             row0: int = 0, rows: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
    """Rows ``row0 .. row0 + rows`` of step ``step``'s global batch, drawn
    on the CPU: the same numbers at every width."""
    rows = global_batch if rows is None else rows
    full = synthetic_mlm_batch(
        torch.Generator().manual_seed(DATA_SEED + step), global_batch, seq,
        vocab)
    return {k: v[row0:row0 + rows] for k, v in full.items()}


def make_step(params, cfg, *, lr: float, opt_state=None, mesh=None
              ) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
    """The train step: ``step(batch)`` computes the loss and gradients of
    ``bert.loss_fn`` (with a ``mesh``: this rank's blocks and rows, the
    global loss), updates ``params`` (leaves that require grad) and the
    AdamW state ``step.opt.state`` in place, and returns the loss."""
    from trainingjob_operator_tpu_torch.models import bert
    from trainingjob_operator_tpu_torch.workloads import train

    opt = train.AdamW(params, lr, b1=0.9, b2=0.999, weight_decay=0.01,
                      state=opt_state)

    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss, grads = train.accumulated_value_and_grad(
            lambda p, b: bert.loss_fn(p, b, cfg, mesh=mesh), params, batch,
            1)
        opt.step(params, grads)
        return loss

    step.opt = opt
    return step


def from_jax_state(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``CheckpointState.restore_or_init``'s ``convert`` for the JAX
    trainer's committed tree: f32 master parameters and ``optax.adamw``'s
    state as ``train.AdamW``'s, on the CPU."""
    from trainingjob_operator_tpu_torch.models import bert
    from trainingjob_operator_tpu_torch.workloads import train

    return {"params": bert.params_from_numpy(tree["params"], "cpu"),
            "opt_state": train.adamw_state_from_numpy(tree["opt_state"],
                                                      "cpu")}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.bert_pretrain")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    rdv, device = rendezvous.prepare_worker(args.device, subdir="bert")
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.models import bert
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.parallel import sharding
    from trainingjob_operator_tpu_torch.workloads import (
        llama_elastic,
        train,
    )

    env = os.environ
    cfg = (bert.BertConfig.base() if env.get("BERT_CONFIG", "tiny") == "base"
           else bert.BertConfig.tiny())
    tp = int(env.get("BERT_TP", "1"))
    steps = int(env.get("BERT_STEPS", "20"))
    global_batch = int(env.get("BERT_BATCH", "32"))
    seq = int(env.get("BERT_SEQ", "128"))
    lr = float(env.get("BERT_LR", "1e-4"))

    spec = pmesh.mesh_spec_from_rendezvous(rdv, model_parallel=tp)
    mesh = None
    if rdv.coordinator_address or rdv.num_processes > 1:
        device = rendezvous.initialize_distributed(rdv, device)
        mesh = pmesh.make_mesh(spec, device.type, rdv.num_slices)
    n_data = mesh.data_size() if mesh is not None else 1
    global_batch, _ = train.round_global_batch(global_batch, n_data)
    row0, local_batch = (sharding.data_rows(global_batch, mesh)
                         if mesh is not None else (0, global_batch))

    generator = None
    if not train.CheckpointState.has_checkpoint(rdv, subdir="bert"):
        generator = torch.Generator().manual_seed(0)
    params = bert.init_params(cfg, generator, device, mesh=mesh)
    opt_state = train.AdamW(params, lr, b2=0.999, weight_decay=0.01).state
    state = train.CheckpointState.restore_or_init(
        rdv, {"params": params, "opt_state": opt_state, "step": 0},
        subdir="bert", layout=llama_elastic.shard_layout(rdv, cfg, mesh,
                                                         bert),
        convert=from_jax_state)
    del params, opt_state
    start_step = int(state.value["step"])
    params = state.value["params"]
    if start_step > 0:
        print(f"resumed at step {start_step}", flush=True)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = make_step(params, cfg, lr=lr,
                        opt_state=state.value["opt_state"], mesh=mesh)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    loss = None
    t_start = None
    try:
        for i in range(start_step, steps):
            batch = {k: v.to(device) for k, v in batch_at(
                i, global_batch, seq, cfg.vocab_size, row0,
                local_batch).items()}
            loss = step_fn(batch)
            if i == start_step:
                sync()
                t_start = time.time()
            if (i + 1) % LOG_EVERY == 0 or i == steps - 1:
                print(f"step {i + 1}/{steps} loss {float(loss):.4f}",
                      flush=True)
                state.save({"params": params,
                            "opt_state": step_fn.opt.state, "step": i + 1})
                train.kill_at_step(state, i + 1)
        sync()
        state.finalize()
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    dt = max(time.time() - (t_start or time.time()), 1e-9)
    done = max(steps - start_step - 1, 1)
    print(f"done: steps={done} tokens/s={done * global_batch * seq / dt:.0f} "
          f"mesh={spec.sizes} processes={rdv.num_processes} "
          f"final_loss={float(loss) if loss is not None else -1:.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
