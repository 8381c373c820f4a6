"""ResNet-50 data-parallel training (config 3): the port of the JAX
package's ``workloads/resnet_dp.py``.

The loss is ``models/resnet.py`` ``loss_fn`` (mean softmax CE, batch
norm in training mode), the optimizer ``optax.sgd(lr, momentum=0.9)``:
the port's ``train.SGD``.  The parameters start from a seeded random
init drawn on the CPU (``torch.Generator`` seed 0), f32, cast to the
compute dtype at each use; the data is synthetic, as JAX's: the global
batch of step ``i`` (normal images, uniform labels) is drawn from a
generator seeded by ``i``, the same on every process.

Across processes (``TRAININGJOB_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``) the mesh is one ``dp`` axis over the processes, one card
each, as JAX's one ``dp`` axis over its devices: the parameters are
replicated, each process takes its rows of the global batch
(``sharding.data_rows``), batch norm normalizes with the statistics of
the global batch (``models/resnet.py``), and the gradients are summed
over the processes in one all-reduce before the update.

Checkpoints: with ``TRAININGJOB_CHECKPOINT_DIR`` set, the full state
``{"params", "stats", "opt_state", "step"}`` is restored from the
worker's per-replica path (or initialised; a state the JAX trainer
committed restores from its resume image: ``from_jax_state``) and saved
every 10 steps and at the last, so the run after a restart equals an
uninterrupted one.  No
SIGTERM handler, as in JAX (``TRAININGJOB_KILL_AT_STEP``:
``train.kill_at_step``).

Run: ``python -m trainingjob_operator_tpu_torch.workloads.resnet_dp
[--device cuda|cpu]``.  Env, as the JAX module reads it: RESNET_CONFIG=
tiny|resnet50 (tiny), RESNET_STEPS (20), RESNET_BATCH (32, global),
RESNET_LR (0.1), RESNET_IMAGE (64).  On the card the images and
activations are ``channels_last`` and the convolutions take cuDNN's
deterministic algorithms (``deterministic_convolutions``).  Lines:
``resumed at step N`` on a resume, ``step i/n loss x.xxxx`` every 10
steps and at the last, and ``done: steps= imgs/s= devices= batch=
final_loss= restart_count=``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from trainingjob_operator_tpu_torch import resolve_device

#: Steps between two loss lines and saves (and the last step).
LOG_EVERY = 10
#: The seed of step i's batch is DATA_SEED + i.
DATA_SEED = 7


def batch_at(step: int, global_batch: int, size: int, num_classes: int,
             row0: int = 0, rows: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``row0 .. row0 + rows`` of step ``step``'s global batch, drawn
    on the CPU (the same numbers on every process): images ``[rows, 3,
    size, size]`` standard normal, labels uniform in [0, classes)."""
    rows = global_batch if rows is None else rows
    g = torch.Generator().manual_seed(DATA_SEED + step)
    images = torch.randn((global_batch, 3, size, size), generator=g)
    labels = torch.randint(0, num_classes, (global_batch,), generator=g)
    return images[row0:row0 + rows], labels[row0:row0 + rows]


def deterministic_convolutions() -> None:
    """Make cuDNN take deterministic convolution algorithms: some of its
    default backward algorithms sum with atomics, in an order that varies
    from run to run, and a resumed run must equal an uninterrupted one
    bit for bit."""
    torch.backends.cudnn.deterministic = True


@torch.no_grad()
def _copy_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Each tensor of ``src`` copied into ``dst``'s at the same key."""
    for key, value in dst.items():
        if isinstance(value, dict):
            _copy_into(value, src[key])
        else:
            value.copy_(src[key])


def make_step(params, stats: Dict[str, Any], cfg, *, lr: float,
              opt_state=None, mesh=None, channels_last: bool = False
              ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The train step: ``step(images, labels)`` computes the loss, its
    gradients and the new batch-norm statistics (``resnet.loss_fn``; with
    a ``mesh``: this rank's rows, the global loss and statistics), sums
    the gradients over the data axes, updates ``params`` (leaves that
    require grad) with SGD and copies the new statistics into ``stats``,
    in place, and returns the loss.  The SGD state is
    ``step.opt.state``."""
    from trainingjob_operator_tpu_torch.models import resnet
    from trainingjob_operator_tpu_torch.parallel import collectives
    from trainingjob_operator_tpu_torch.workloads import train

    opt = train.SGD(params, lr, momentum=0.9, state=opt_state)
    leaves = train.tree_leaves(params)

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        for p in leaves:
            p.grad = None
        if channels_last:
            images = images.contiguous(memory_format=torch.channels_last)
        loss, new_stats = resnet.loss_fn(
            params, stats, {"images": images, "labels": labels}, cfg,
            mesh=mesh)
        loss.backward()
        if mesh is not None:
            collectives.all_reduce_data([p.grad for p in leaves], mesh)
        opt.step(params, train.tree_map(lambda p: p.grad, params))
        _copy_into(stats, new_stats)
        return loss.detach()

    step.opt = opt
    return step


def from_jax_state(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``CheckpointState.restore_or_init``'s ``convert`` for the JAX
    trainer's committed tree: the parameters and batch-norm statistics
    (conv weights HWIO -> OIHW) and ``optax.sgd``'s momentum trace as
    ``train.SGD``'s, on the CPU."""
    from trainingjob_operator_tpu_torch.models import resnet
    from trainingjob_operator_tpu_torch.workloads import train

    params, stats = resnet.params_from_numpy(tree["params"], tree["stats"],
                                             "cpu")
    opt_state = train.sgd_state_from_numpy(
        tree["opt_state"], "cpu",
        convert=lambda t: resnet.params_from_numpy(t, None, "cpu")[0])
    return {"params": params, "stats": stats, "opt_state": opt_state}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.resnet_dp")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    rdv, device = rendezvous.prepare_worker(args.device)
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.models import resnet
    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.parallel import sharding
    from trainingjob_operator_tpu_torch.workloads import train

    env = os.environ
    cfg = (resnet.ResNetConfig.resnet50()
           if env.get("RESNET_CONFIG", "tiny") == "resnet50"
           else resnet.ResNetConfig.tiny())
    steps = int(env.get("RESNET_STEPS", "20"))
    global_batch = int(env.get("RESNET_BATCH", "32"))
    lr = float(env.get("RESNET_LR", "0.1"))
    size = int(env.get("RESNET_IMAGE", "64"))

    mesh = None
    if rdv.coordinator_address or rdv.num_processes > 1:
        device = rendezvous.initialize_distributed(rdv, device)
        mesh = pmesh.make_mesh(pmesh.MeshSpec.of(dp=rdv.num_processes),
                               device.type)
    if device.type == "cuda":
        deterministic_convolutions()
    n_dev = mesh.data_size() if mesh is not None else 1
    global_batch, _ = train.round_global_batch(global_batch, n_dev)
    row0, local_batch = (sharding.data_rows(global_batch, mesh)
                         if mesh is not None else (0, global_batch))

    generator = None
    if not train.CheckpointState.has_checkpoint(rdv):
        generator = torch.Generator().manual_seed(0)
    params, stats = resnet.init_params(cfg, generator, device)
    state = train.CheckpointState.restore_or_init(
        rdv, {"params": params, "stats": stats,
              "opt_state": train.SGD(params, lr).state, "step": 0},
        convert=from_jax_state)
    del params, stats
    start_step = int(state.value["step"])
    params, stats = state.value["params"], state.value["stats"]
    if start_step > 0:
        print(f"resumed at step {start_step}", flush=True)
    for leaf in train.tree_leaves(params):
        leaf.requires_grad_(True)
    step_fn = make_step(params, stats, cfg, lr=lr,
                        opt_state=state.value["opt_state"], mesh=mesh,
                        channels_last=device.type == "cuda")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    loss = None
    t_start = None
    try:
        for i in range(start_step, steps):
            images, labels = batch_at(i, global_batch, size,
                                      cfg.num_classes, row0, local_batch)
            loss = step_fn(images.to(device), labels.to(device))
            if i == start_step:
                sync()
                t_start = time.time()
            if (i + 1) % LOG_EVERY == 0 or i == steps - 1:
                print(f"step {i + 1}/{steps} loss {float(loss):.4f}",
                      flush=True)
                state.save({"params": params, "stats": stats,
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
    print(f"done: steps={done} imgs/s={done * global_batch / dt:.1f} "
          f"devices={n_dev} batch={global_batch} "
          f"final_loss={float(loss) if loss is not None else -1:.4f} "
          f"restart_count={rdv.restart_count}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
