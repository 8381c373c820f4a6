"""The reference's training: the first steps of a run, from the same
weights and the same batches, in plain float32 (TF32 off), sequence by
sequence, with AdamW in optax's order.

What it reports is what the comparison reads: each step's loss, each
slice's gradient norm at the first step, and each slice's change after
the last step.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from benchmark import weights
from benchmark.reference.decoder import sequence_loss


def init(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights as the run drew them, f32, one tensor a slice."""
    out = {}
    for path, shape, lead in weights.leaves(cfg):
        for index in weights.slices(shape, lead):
            out[weights.slice_key(path, index)] = weights.draw(
                seed, path, index, shape[lead:], device).requires_grad_(True)
    return out


def follow(cfg: dict, seed: int, batches: List[torch.Tensor], opt: dict,
           device, lowp: Optional[str] = None,
           bias_correction: bool = True) -> dict:
    """``len(batches)`` steps from the run's weights: the mean loss over a
    batch's rows, its gradient, then AdamW (``opt``: lr, b1, b2, eps,
    weight_decay; without its bias corrections where ``bias_correction``
    is false, a fault for the control to read).  Returns {"losses",
    "grad_norms" (step 1), "delta_norms" (after the last step)} with
    norms by slice key."""
    params = init(cfg, seed, device)
    mu = {k: torch.zeros_like(p) for k, p in params.items()}
    nu = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    losses, grad_norms = [], {}
    for step, batch in enumerate(batches, start=1):
        for p in params.values():
            p.grad = None
        total = 0.0
        for row in batch:
            loss = sequence_loss(params, row, cfg, lowp)
            (loss / batch.shape[0]).backward()
            total += float(loss.detach())
        losses.append(total / batch.shape[0])
        if step == 1:
            grad_norms = {k: float(p.grad.norm()) for k, p in params.items()}
        bc1, bc2 = ((1.0 - b1 ** step, 1.0 - b2 ** step) if bias_correction
                    else (1.0, 1.0))
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad
                mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                u = (mu[k] / bc1).div_((nu[k] / bc2).sqrt_().add_(eps))
                u.add_(p, alpha=wd)
                p.add_(u, alpha=-lr)
                p.grad = None
    del mu, nu
    delta_norms = {}
    with torch.no_grad():
        for path, shape, lead in weights.leaves(cfg):
            for index in weights.slices(shape, lead):
                key = weights.slice_key(path, index)
                p0 = weights.draw(seed, path, index, shape[lead:], device)
                delta_norms[key] = float((params[key] - p0).norm())
    return {"losses": losses, "grad_norms": grad_norms,
            "delta_norms": delta_norms}
