"""Single-process training plumbing for the port.

Own copies of the JAX package's ``workloads/train.py`` pieces the Llama
trainer needs on one card: gradient accumulation
(``accumulated_value_and_grad``), batch geometry (``round_global_batch``),
the batch sources (``build_batch_sources``), ``default_remat``,
``mean_eval_fn``, ``throughput_line``, the AdamW of
``workloads/llama_elastic.py`` in optax's order (``AdamW``) and the step
loop (``run_loop``, the counterpart of ``run_elastic_loop`` without the
checkpoint, preemption, resize, telemetry and tracer, which are later
slices: ROADMAP.md queue 1 items 2b, 2c and 3).

Parameters are a nested dict of tensors (the ``models/llama.py`` tree);
where JAX returns new trees, the port updates the leaves in place.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from trainingjob_operator_tpu_torch import constants


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def trainable_copy(tree, device):
    """A copy of a parameter tree on ``device`` whose leaves require grad
    (a copy on the same device too, so that training it leaves ``tree`` as
    it was)."""
    if isinstance(tree, dict):
        return {k: trainable_copy(v, device) for k, v in tree.items()}
    return tree.detach().to(device, copy=True).requires_grad_(True)


def _rebuild(tree, leaves):
    """A tree shaped like ``tree`` holding the next items of ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    return next(leaves)


def accumulated_value_and_grad(loss_fn: Callable, params: Dict[str, Any],
                               tokens: torch.Tensor, accum: int):
    """(loss, grads) of ``loss_fn(params, tokens)`` over ``accum``
    microbatches, as the JAX function: microbatch ``a`` takes the rows
    ``r`` with ``r % accum == a`` (the interleaved split of
    ``train.py:1285``), losses and gradients are summed, then multiplied by
    ``1 / accum``.  Equals the full-batch gradient for a mean loss.

    The leaves of ``params`` must require grad; the gradients accumulate in
    their ``.grad`` (one buffer per leaf, added to in place), which the
    returned tree holds."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.grad = None
    if accum <= 1:
        loss = loss_fn(params, tokens)
        loss.backward()
        return loss.detach(), _rebuild(params, iter(p.grad for p in leaves))
    B = tokens.shape[0]
    if B % accum != 0:
        raise ValueError(f"batch {B} not divisible by accum={accum}")
    micro_batches = tokens.reshape(B // accum, accum,
                                   *tokens.shape[1:]).transpose(0, 1)
    total = None
    for tb in micro_batches:
        loss = loss_fn(params, tb)
        loss.backward()
        total = loss.detach() if total is None else total + loss.detach()
    inv = 1.0 / accum
    return total * inv, _rebuild(params,
                                 iter(p.grad.mul_(inv) for p in leaves))


class AdamW:
    """``optax.adamw(lr, b1, b2, eps, weight_decay)`` as
    ``workloads/llama_elastic.py:111`` builds it (b1 0.9, b2 0.95,
    weight decay 0.1 on every leaf, eps 1e-8), in optax's order: the
    moments, their bias corrections at step count t, then
    ``p += -lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.  The state (two
    moments per leaf, zero at the start, and the count) lives on the
    object; ``step`` updates the leaves in place.  ``torch.optim.AdamW``
    computes the same update in another order of rounding
    (tests/test_torch_train.py)."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
        self.lr, self.b1, self.b2 = float(lr), float(b1), float(b2)
        self.eps, self.weight_decay = float(eps), float(weight_decay)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in tree_leaves(params)]
        self.nu = [torch.zeros_like(p) for p in tree_leaves(params)]

    @torch.no_grad()
    def step(self, params, grads) -> None:
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(self.eps))
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.lr)


def round_global_batch(global_batch: int, shards: int,
                       accum: int = 1) -> "tuple[int, int]":
    """(batch, accum): largest multiple of ``shards * accum`` <= the request.

    Accumulation is the shedable factor: it is clamped down first so the
    global batch never exceeds the request.  When even one row per data
    shard does not fit (batch < shards) the batch is inflated to exactly
    one row per shard, loudly.  The same rule as the JAX package's."""
    shards = max(shards, 1)
    accum = max(accum, 1)
    if global_batch < shards:
        print(f"WARNING: global batch {global_batch} < {shards} data "
              f"shards; inflating to {shards} (one row per shard) -- the "
              f"loss trajectory changes at this width. Keep elastic max "
              f"width <= global batch to avoid this.", flush=True)
        return shards, 1
    # The accum <= requested that yields the largest rounded batch (on ties,
    # the largest accum).
    requested = accum
    best = None
    for a in range(min(accum, global_batch // shards), 0, -1):
        step = shards * a
        rounded = global_batch // step * step
        if best is None or rounded > best[0]:
            best = (rounded, a)
    rounded, accum = best
    if accum != requested:
        print(f"using gradient accumulation {accum} (requested {requested}) "
              f"for {shards} data shards at global batch {rounded}",
              flush=True)
    if rounded != global_batch:
        print(f"rounded global batch {global_batch} -> {rounded} to tile "
              f"{shards} data shards x {accum} accumulation", flush=True)
    return rounded, accum


def _synthetic_seed(key_base: int, step: int, row: int) -> int:
    """A 63-bit seed from (key_base, step, row): splitmix64 finalizer over
    their golden-ratio-weighted sum."""
    mask = (1 << 64) - 1
    x = (key_base * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9
         + row * 0x94D049BB133111EB) & mask
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & mask
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & mask
    x ^= x >> 31
    return x >> 1


def build_batch_sources(*, prefix: str, vocab_size: int, global_batch: int,
                        seq: int, synthetic_key: int, device):
    """(batch_at, eval_batch_at | None, eval_every, eval_batches) from env,
    as the JAX function reads it: ``{P}_DATA`` (.tokens corpus; default
    synthetic), ``{P}_SEED``, ``{P}_EVAL_EVERY`` / ``{P}_EVAL_BATCHES`` /
    ``{P}_EVAL_FRACTION``, with the same startup errors.  ``batch_at(i)``
    is the [global_batch, seq + 1] int64 batch of step i on ``device``.

    Both sources are stateless functions of (source, step).  A corpus
    batch is the JAX package's, byte for byte.  Synthetic tokens come from
    a ``torch.Generator`` per row, seeded from (key, step, row), so a row
    is a pure function of its global index; they are not JAX's threefry
    stream, so the two packages train on different synthetic tokens."""
    data_path = os.environ.get(f"{prefix}_DATA", "")
    seed = int(os.environ.get(f"{prefix}_SEED", str(synthetic_key)))
    eval_every = int(os.environ.get(f"{prefix}_EVAL_EVERY", "0"))
    eval_batches = int(os.environ.get(f"{prefix}_EVAL_BATCHES", "2"))
    eval_frac = float(os.environ.get(f"{prefix}_EVAL_FRACTION", "0.1"))
    if eval_every > 0:
        if eval_batches < 1:
            raise ValueError(
                f"{prefix}_EVAL_BATCHES={eval_batches} with eval enabled: "
                f"a zero-batch eval would print a bogus 0.0 loss")
        if not 0.0 < eval_frac < 1.0:
            raise ValueError(
                f"{prefix}_EVAL_FRACTION={eval_frac} must be in (0, 1)")
        if not data_path:
            raise ValueError(
                f"{prefix}_EVAL_EVERY={eval_every} without {prefix}_DATA: "
                f"eval on the synthetic random-token stream measures "
                f"nothing; point {prefix}_DATA at a .tokens corpus or "
                f"disable eval")
    train_region = (0.0, 1.0 - eval_frac) if eval_every > 0 else (0.0, 1.0)

    ds = eval_ds = None
    if data_path:
        from trainingjob_operator_tpu_torch.data import TokenDataset

        ds = TokenDataset(data_path, seed=seed, region=train_region)
        if ds.vocab_size > vocab_size:
            # An out-of-range id would fail the embedding lookup mid-run.
            raise ValueError(
                f"{data_path}: corpus vocab {ds.vocab_size} exceeds model "
                f"vocab {vocab_size}")
        ds.check_window(seq + 1)
        if eval_every > 0:
            eval_ds = TokenDataset(data_path, seed=seed,
                                   region=(1.0 - eval_frac, 1.0))
            eval_ds.check_window(seq + 1)

    def make_batch_at(dataset, key_base):
        if dataset is not None:
            def fetch(i):
                rows = torch.from_numpy(dataset.batch(i, global_batch, seq))
                return rows.long().to(device, non_blocking=True)
        else:
            def fetch(i):
                gen = torch.Generator()
                rows = []
                for r in range(global_batch):
                    gen.manual_seed(_synthetic_seed(key_base, i, r))
                    rows.append(torch.randint(0, vocab_size, (seq + 1,),
                                              generator=gen))
                return torch.stack(rows).to(device, non_blocking=True)
        return fetch

    batch_at = make_batch_at(ds, synthetic_key)
    eval_batch_at = (make_batch_at(eval_ds, synthetic_key ^ 0x5EED)
                     if eval_every > 0 else None)
    return batch_at, eval_batch_at, eval_every, eval_batches


def default_remat(n_layers: int) -> str:
    """The JAX package's workload default: "attn" for full-depth configs,
    "none" below 32 layers.  The port does not have "attn" yet
    (``models/llama.py`` ``remat_policy`` raises on it)."""
    return "attn" if n_layers >= 32 else "none"


def mean_eval_fn(eval_loss, eval_batch_at, eval_batches: int):
    """Average ``eval_loss(tokens)`` over the fixed held-out batches
    j = 0..N-1, under ``torch.no_grad``."""
    def eval_fn():
        total = 0.0
        with torch.no_grad():
            for j in range(eval_batches):
                total += float(eval_loss(eval_batch_at(j)))
        return total / eval_batches
    return eval_fn


def throughput_line(prefix: str, steps_done: int, units_per_step: int,
                    seconds: float, unit: str = "tokens") -> str:
    rate = steps_done * units_per_step / max(seconds, 1e-9)
    return f"{prefix} steps={steps_done} {unit}/s={rate:.0f}"


def run_loop(*, step_fn: Callable[[torch.Tensor], torch.Tensor],
             batch_at: Callable[[int], torch.Tensor], steps: int,
             log_every: int = 10,
             eval_fn: Optional[Callable[[], float]] = None,
             eval_every: int = 0, units_per_step: float = 0.0):
    """The step loop: ``step_fn(batch_at(i))`` for i in [0, steps) (no
    resume yet: ROADMAP.md queue 1 item 2b), printing ``step i/N loss x``
    every ``log_every`` steps and at the last, ``eval step i loss x`` every
    ``eval_every`` steps, and with ``TRAININGJOB_STEP_TIMES=1`` each step's
    wall time.  Returns ``(loss, t_start)``, ``t_start`` the wall time
    after the first step (its time is set-up: the kernels build there)."""
    step_times = os.environ.get(constants.STEP_TIMES_ENV) == "1"
    loss = None
    t_start = None
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step_fn(batch_at(i))
        if i == 0 or step_times:
            float(loss)  # waits for the step: the fence of both timings
        if i == 0:
            t_start = time.time()
        if step_times:
            print(f"step_time step={i} "
                  f"ms={(time.perf_counter() - t0) * 1e3:.2f}", flush=True)
        if (i + 1) % log_every == 0 or i == steps - 1:
            print(f"step {i+1}/{steps} loss {float(loss):.4f}", flush=True)
        if eval_fn is not None and eval_every > 0 \
                and (i + 1) % eval_every == 0:
            print(f"eval step {i+1} loss {eval_fn():.4f}", flush=True)
    if units_per_step and t_start is not None:
        print(throughput_line("train_done", max(steps - 1, 1),
                              units_per_step,
                              max(time.time() - t_start, 1e-9)), flush=True)
    return loss, t_start
