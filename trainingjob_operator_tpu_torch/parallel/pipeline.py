"""Pipeline parallelism over the ``pp`` axis: GPipe, the port of the JAX
package's ``parallel/pipeline.py``.

Each ``pp`` rank holds one stage: the contiguous ``L / S`` layers that
the ``pp`` entry of the stacked leaves gives it under
``sharding_rules(pipeline=True)``.  ``gpipe`` runs JAX's schedule of
``M + S - 1`` ticks over the ``M`` microbatches of this rank's rows: at
tick ``t`` stage 0 takes microbatch ``t``, every stage whose slot holds a
microbatch advances it by its layers, stage ``S - 1`` keeps microbatch
``t - (S - 1)``, and every rank hands its slot to the next stage
(``collectives.ppermute_next`` over pp).  JAX's ``jnp.roll`` over the
stage dim is that hand-off; its ``partial_manual_shard_map`` and
``flash_attention_pp`` have no counterpart, since the stage body already
runs on this rank's tensors and calls the flash kernel on them.

Autograd runs the schedule backwards, and every rank must make the same
hand-offs in the same order there too.  So every rank hands off at every
tick but the last (whose hand-off nobody reads): ``M + S - 2`` shifts a
forward, as many in the backward.  A slot that holds no microbatch
carries zeros and runs no layers, and every value a stage drops (an idle
slot's input, what stage 0 receives from stage ``S - 1``, the stage's
last slot) still reaches the output with a zero gradient (``touch``), so
that autograd reaches every hand-off on every rank.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from trainingjob_operator_tpu_torch.parallel.collectives import (
    ppermute_next,
    require_axis,
)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


class _Touch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device)
                        if need else None
                        for (shape, dtype, device), need in
                        zip(ctx.others, ctx.needs_input_grad[1:])))


def touch(out: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``out``, with each of ``others`` given a zero gradient: a value a
    rank computes and drops stays in its graph, so that autograd runs
    every node upstream of it (the collectives among them) on every rank,
    as its peers do."""
    return _Touch.apply(out, *others)


def gpipe(block_fn: Callable, local_layers: Sequence, h: torch.Tensor,
          mesh, n_microbatches: int, axis: str = "pp") -> torch.Tensor:
    """Apply this stage's layers ``local_layers`` (one tree per layer) to
    ``h`` [B, ...] as the stage of an S-stage pipeline over ``axis``;
    ``block_fn(h, layer) -> h`` applies one layer.  The last stage returns
    the output of the whole layer stack, [B, ...]; any other stage returns
    zeros of h's shape, touching its last slot (``touch``).  At S = 1 it is
    the plain loop over the layers.

    ``ValueError`` (JAX's) where ``n_microbatches`` does not divide B; a
    layer count the stages do not divide is refused where the layers are
    split (``models/llama.py`` ``check_pp``)."""
    S = require_axis(mesh, axis)
    if S == 1:
        for layer in local_layers:
            h = block_fn(h, layer)
        return h
    M = n_microbatches
    B = h.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")
    stage = mesh.coord(axis)
    microbatches = h.chunk(M)
    outs = []
    x = recv = None
    for t in range(M + S - 1):
        i = t - stage
        active = 0 <= i < M
        dropped = () if recv is None else (recv,)
        if stage == 0 and active:
            x = touch(microbatches[i], *dropped)
        elif active:
            x = recv
        else:
            # Stage s > 0 starts idle: its first slot touches h, whose
            # embedding gradient is summed over the stages.
            x = touch(torch.zeros_like(microbatches[0]), *(dropped or [h]))
        if active:
            for layer in local_layers:
                x = block_fn(x, layer)
            if stage == S - 1:
                outs.append(x)
        if t < M + S - 2:
            recv = ppermute_next(x, mesh, axis)
    if stage == S - 1:
        return torch.cat(outs)
    return touch(torch.zeros_like(h), x)
