"""The reference's serving: each sampled prompt with the tokens the
program served for it, run once through the plain float32 decoder (no
cache), layer by layer with each layer's weights drawn again from the
seed, so that it fits beside nothing else.

It returns the logits at the positions that predicted each served
token; ``compare.served_gap`` reads the gap of the served token below
the best one there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from benchmark import weights
from benchmark.reference.decoder import layer_forward, layer_params, mm, \
    rmsnorm


def _served(cfg: dict, seed: int, path: str, shape, device, index=()):
    """One slice as the program was served it (its served dtype), f32."""
    served = weights.served_dtype(path, getattr(torch, cfg["torch_dtype"]))
    return weights.draw(seed, path, index, shape[len(index):], device,
                        served).float()


@torch.no_grad()
def served_logits(cfg: dict, seed: int,
                  seqs: Sequence[Tuple[List[int], List[int]]], device,
                  lowp: Optional[str] = None) -> List[torch.Tensor]:
    """For each (prompt, served) pair, the logits [len(served), vocab]
    f32 at the positions that predict the served tokens, from the weights
    the program served (drawn in their served dtype, then f32)."""
    shapes = {path: shape for path, shape, _ in weights.leaves(cfg)}
    emb = _served(cfg, seed, "tok_embed", shapes["tok_embed"], device)
    hs, starts = [], []
    for prompt, served in seqs:
        ids = torch.tensor(list(prompt) + list(served[:-1]), device=device)
        hs.append(emb[ids])
        starts.append(len(prompt) - 1)
    del emb
    for layer in range(cfg["num_hidden_layers"]):
        params = {}
        for path, shape, lead in weights.leaves(cfg):
            if lead == 0:
                continue
            for index in weights.slices(shape, lead):
                if index[0] == layer:
                    params[weights.slice_key(path, index)] = _served(
                        cfg, seed, path, shape, device, index)
        p = layer_params(params, cfg, layer)
        for i, h in enumerate(hs):
            positions = torch.arange(h.shape[0], device=device)
            hs[i], _ = layer_forward(h, p, cfg, positions, lowp)
        del params, p
    norm = _served(cfg, seed, "final_norm", shapes["final_norm"], device)
    head = _served(cfg, seed, "lm_head", shapes["lm_head"], device)
    out = [mm(rmsnorm(h[s:], norm, cfg["rms_norm_eps"]), head, lowp)
           for h, s in zip(hs, starts)]
    return out
