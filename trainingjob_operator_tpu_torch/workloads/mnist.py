"""MNIST MLP trainer (config 1): the port of the JAX package's
``workloads/mnist.py``.

A 784 -> ``MNIST_HIDDEN`` -> 10 relu MLP in f32 on synthetic,
class-conditional digits (28x28, 10 classes), trained with Adam
(``optax.adam(lr)``: the port's ``AdamW`` with b2 0.999 and no weight
decay) on the mean softmax cross-entropy.  The parameters start from a
seeded random init drawn on the CPU (``torch.Generator`` seed 0, the
same on every process); each process draws its own data stream, seeded
by its rank, as JAX folds the process id into its data key.

Across processes (``TRAININGJOB_COORDINATOR_ADDRESS``, ``_NUM_PROCESSES``,
``_PROCESS_ID``) each process trains on its own ``MNIST_BATCH`` rows a
step, and the gradients and the loss are averaged over the processes:
the mean over the global batch, which JAX's globalized batch gives.

Checkpoints: with ``TRAININGJOB_CHECKPOINT_DIR`` set, ``{"params",
"opt_state", "step"}`` is restored from the worker's per-replica path
(or initialised) and saved every 20 steps and at the last; a restarted
worker (``TRAININGJOB_REPLICA_RESTARTCOUNT`` > 0) continues from the last
committed step, and the rest of its run equals an uninterrupted one bit
for bit.  Like JAX's, this trainer installs no SIGTERM handler: a killed
worker resumes from its last save (``TRAININGJOB_KILL_AT_STEP=N`` kills
it once step N's save has committed: ``train.kill_at_step``).

Run: ``python -m trainingjob_operator_tpu_torch.workloads.mnist
[--device cuda|cpu]``.  Env, as the JAX module reads it: MNIST_STEPS
(60), MNIST_BATCH (128, a process's rows a step), MNIST_HIDDEN (256),
MNIST_LR (1e-3).  Lines: ``step i/n loss x.xxxx`` every 20 steps and at
the last, a ``recovery_timing`` line after the first step, and ``done:
steps= time= steps/s= final_loss= acc= restart_count=``, acc on this
process's last batch.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Any, Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from trainingjob_operator_tpu_torch import resolve_device  # noqa: E402

#: Steps between two loss lines and saves (and the last step).
LOG_EVERY = 20


def synthetic_mnist(generator: torch.Generator, n: int, batch: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic synthetic digits: ten class centres ``normal * 0.5``
    (drawn first, so they do not depend on ``n``), ``n`` labels in
    [0, 10) and per-image noise ``normal * 0.3``, drawn
    from ``generator`` on its device; returns images ``[n // batch, batch,
    784]`` f32 and labels ``[n // batch, batch]`` int64 (JAX's
    ``synthetic_mnist`` draws the same distribution from its key)."""
    centers = torch.randn((10, 784), generator=generator,
                          device=generator.device) * 0.5
    labels = torch.randint(0, 10, (n,), generator=generator,
                           device=generator.device)
    noise = torch.randn((n, 784), generator=generator,
                        device=generator.device) * 0.3
    images = centers[labels] + noise
    steps = n // batch
    return (images[:steps * batch].reshape(steps, batch, 784),
            labels[:steps * batch].reshape(steps, batch))


def init_params(hidden: int, generator: torch.Generator,
                device="cuda") -> Dict[str, torch.Tensor]:
    """JAX's tree and scales: ``w1`` [784, hidden] and ``w2`` [hidden, 10]
    ``normal * 0.05``, zero biases; drawn on the generator's device and
    moved to ``device``."""
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * 0.05).to(dev)

    return {"w1": normal((784, hidden)),
            "b1": torch.zeros(hidden, device=dev),
            "w2": normal((hidden, 10)),
            "b2": torch.zeros(10, device=dev)}


def params_from_numpy(tree: Dict[str, Any], device="cuda"
                      ) -> Dict[str, torch.Tensor]:
    """JAX's parameter tree (numpy leaves) -> the port's, f32."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in tree.items()}


def from_jax_state(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``CheckpointState.restore_or_init``'s ``convert`` for the JAX
    trainer's committed tree: the parameters and ``optax.adam``'s state
    as ``train.AdamW``'s, on the CPU."""
    from trainingjob_operator_tpu_torch.workloads import train as tr

    return {"params": params_from_numpy(tree["params"], "cpu"),
            "opt_state": tr.adamw_state_from_numpy(tree["opt_state"], "cpu")}


def logits_fn(params: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the batch (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits_fn(params, x), y.long())


def accuracy(params: Dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor) -> float:
    with torch.no_grad():
        return float((logits_fn(params, x).argmax(-1) == y).float().mean())


def make_step(params: Dict[str, torch.Tensor], opt, mesh=None):
    """The step over ``params`` (leaves that require grad) and ``opt``
    (``AdamW``): ``step(x, y)`` returns the loss, a detached scalar, after
    the update.  On a ``mesh`` (data parallel over the processes) the
    gradients and the loss are averaged over its data axes before the
    update: every process holds ``x.shape[0]`` rows, so the mean of their
    means is the global batch's mean."""
    from trainingjob_operator_tpu_torch.parallel import collectives
    from trainingjob_operator_tpu_torch.workloads import train

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss, grads = train.accumulated_value_and_grad(
            lambda p, xy: loss_fn(p, *xy), params, (x, y), 1)
        if mesh is not None:
            loss = loss.reshape(1)
            parts = train.tree_leaves(grads) + [loss]
            collectives.all_reduce_data(parts, mesh)
            for t in parts:
                t.div_(mesh.data_size())
            loss = loss[0]
        opt.step(params, grads)
        return loss

    return step


def train(params: Dict[str, torch.Tensor], images: torch.Tensor,
          labels: torch.Tensor, *, lr: float = 1e-3, start_step: int = 0,
          opt_state: Optional[Dict[str, Any]] = None, state=None,
          mesh=None, on_first_step=None) -> Dict[str, Any]:
    """Train ``params`` in place on ``images[i]``, ``labels[i]`` for the
    steps ``start_step .. len(images) - 1``, Adam from ``opt_state`` (a
    fresh one without), averaged over ``mesh``'s processes where given
    (``make_step``).  Every ``LOG_EVERY`` steps and at the last, prints
    ``step i/n loss x.xxxx`` and saves ``{"params", "opt_state", "step"}``
    to ``state`` (a ``CheckpointState``; None saves nothing).
    ``on_first_step()`` is called after the first step's loss is on the
    host.  Returns ``{"loss": the last loss (None without a step),
    "losses": {step: loss} of the printed lines, "opt_state", "seconds"}``
    (the loop's wall time)."""
    from trainingjob_operator_tpu_torch.workloads import train as tr

    num_steps = images.shape[0]
    opt = tr.AdamW(params, lr, b2=0.999, weight_decay=0.0, state=opt_state)
    for p in params.values():
        p.requires_grad_(True)
    step = make_step(params, opt, mesh)
    losses: Dict[int, float] = {}
    loss = None
    t0 = time.time()
    for i in range(start_step, num_steps):
        loss = step(images[i], labels[i])
        if i == start_step and on_first_step is not None:
            float(loss)
            on_first_step()
        if (i + 1) % LOG_EVERY == 0 or i == num_steps - 1:
            losses[i + 1] = float(loss)
            print(f"step {i + 1}/{num_steps} loss {losses[i + 1]:.4f}",
                  flush=True)
            if state is not None:
                state.save({"params": params, "opt_state": opt.state,
                            "step": i + 1})
                tr.kill_at_step(state, i + 1)
    if state is not None:
        state.finalize()
    for p in params.values():
        p.requires_grad_(False)
    return {"loss": None if loss is None else float(loss),
            "losses": losses, "opt_state": opt.state,
            "seconds": time.time() - t0}


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux ``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.mnist")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    t_main = time.time()
    age_main = process_age_s()
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    rdv, device = rendezvous.prepare_worker(args.device)
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.parallel import mesh as pmesh
    from trainingjob_operator_tpu_torch.workloads import train as tr

    mesh = None
    if rdv.coordinator_address or rdv.num_processes > 1:
        device = rendezvous.initialize_distributed(rdv, device)
        mesh = pmesh.make_mesh(pmesh.MeshSpec.of(dp=rdv.num_processes),
                               device.type)
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
    t_init = time.time()

    num_steps = int(os.environ.get("MNIST_STEPS", "60"))
    batch = int(os.environ.get("MNIST_BATCH", "128"))
    hidden = int(os.environ.get("MNIST_HIDDEN", "256"))
    lr = float(os.environ.get("MNIST_LR", "1e-3"))

    params = init_params(hidden, torch.Generator().manual_seed(0), device)
    images, labels = synthetic_mnist(
        torch.Generator().manual_seed(1000 + rdv.process_id),
        num_steps * batch, batch)
    images, labels = images.to(device), labels.to(device)
    opt_state = tr.AdamW(params, lr, b2=0.999, weight_decay=0.0).state
    t_setup = time.time()
    state = tr.CheckpointState.restore_or_init(
        rdv, {"params": params, "opt_state": opt_state, "step": 0},
        convert=from_jax_state)
    restore_s = time.time() - t_setup
    params, opt_state = state.value["params"], state.value["opt_state"]
    start_step = int(state.value["step"])

    def on_first_step():
        t = time.time()
        prefix = (f"imports_s={age_main:.3f} " if age_main is not None
                  else "")
        print(f"recovery_timing {prefix}init_s={t_init - t_main:.3f} "
              f"setup_s={t_setup - t_init:.3f} restore_s={restore_s:.3f} "
              f"first_step_s={t - t_setup - restore_s:.3f} "
              f"main_to_first_step_s={t - t_main:.3f} "
              f"import_to_first_step_s={t - _T_IMPORT:.3f}", flush=True)

    try:
        out = train(params, images, labels, lr=lr, start_step=start_step,
                    opt_state=opt_state, state=state, mesh=mesh,
                    on_first_step=on_first_step)
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    dt = out["seconds"]
    acc = accuracy(params, images[-1], labels[-1])
    steps_done = num_steps - start_step
    final = out["loss"] if out["loss"] is not None else -1
    print(f"done: steps={steps_done} time={dt:.2f}s "
          f"steps/s={steps_done / max(dt, 1e-9):.1f} "
          f"final_loss={final:.4f} acc={acc:.3f} "
          f"restart_count={rdv.restart_count}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
