"""Weights and token ids drawn from ``--seed``, the same for the program
and the reference.

Every slice of a leaf (one layer's matrix, or one expert's in one layer)
is one ``torch.randn`` call on its own generator, seeded from the run's
seed and the slice's key.  So the program's whole tree is made in a few
hundred large calls on the device, and the reference draws any slice
again, alone, after the program's state is gone.  Nothing here imports
the program: the tree is laid out as the port's parameter tree (stacked
``[L, ...]`` layer leaves and ``[L, E, ...]`` expert leaves, under the
same key paths) so that the program can be handed it as it is.

Scales are the port's and the JAX package's init: normal x in_dim ** -0.5
for every matrix (in_dim = its second last dim), 0.02 for the embedding
and the head, ones for the norm scales.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, List, Tuple

import torch


def sub_seed(seed: int, *key) -> int:
    """A 63-bit seed for the stream ``key`` of the run ``seed``."""
    text = "/".join(str(k) for k in (seed, *key)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *key) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *key))


def leaves(cfg: dict) -> List[Tuple[str, Tuple[int, ...], int]]:
    """(path, global shape, lead) of every leaf, in the port's order;
    ``lead`` counts the leading dims that index slices (0, 1 for a layer
    leaf, 2 for an expert leaf)."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    F, V = cfg["intermediate_size"], cfg["vocab_size"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    out = [("tok_embed", (V, D), 0),
           ("layers/attn/wq", (L, D, q), 1),
           ("layers/attn/wk", (L, D, kv), 1),
           ("layers/attn/wv", (L, D, kv), 1),
           ("layers/attn/wo", (L, q, D), 1)]
    E = cfg.get("num_local_experts", 0)
    if E:
        out += [("layers/moe/router", (L, D, E), 1),
                ("layers/moe/w_gate", (L, E, D, F), 2),
                ("layers/moe/w_up", (L, E, D, F), 2),
                ("layers/moe/w_down", (L, E, F, D), 2),
                ("layers/attn_norm", (L, D), 1),
                ("layers/moe_norm", (L, D), 1)]
    else:
        out += [("layers/mlp/w_gate", (L, D, F), 1),
                ("layers/mlp/w_up", (L, D, F), 1),
                ("layers/mlp/w_down", (L, F, D), 1),
                ("layers/attn_norm", (L, D), 1),
                ("layers/mlp_norm", (L, D), 1)]
    return out + [("final_norm", (D,), 0), ("lm_head", (D, V), 0)]


def name_of(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def slices(shape: Tuple[int, ...], lead: int) -> Iterator[Tuple[int, ...]]:
    """The index of every slice of a leaf, layer-major."""
    if lead == 0:
        yield ()
    elif lead == 1:
        yield from ((i,) for i in range(shape[0]))
    else:
        yield from ((i, j) for i in range(shape[0]) for j in range(shape[1]))


def slice_key(path: str, index: Tuple[int, ...]) -> str:
    return path + ("[" + ",".join(map(str, index)) + "]" if index else "")


def draw(seed: int, path: str, index: Tuple[int, ...],
         shape: Tuple[int, ...], device, dtype=torch.float32) -> torch.Tensor:
    """One slice of ``shape`` (the leaf's shape without its lead dims),
    in f32 then cast to ``dtype``."""
    name = name_of(path)
    if name.endswith("norm"):
        return torch.ones(shape, dtype=dtype, device=device)
    scale = 0.02 if name in ("tok_embed", "lm_head") else shape[-2] ** -0.5
    x = torch.randn(shape, generator=generator(device, seed, path, *index),
                    device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def served_dtype(path: str, compute: torch.dtype) -> torch.dtype:
    """The port's serving layout: matrices, embedding and head in the
    compute dtype; norm scales and the router in f32."""
    name = name_of(path)
    if name.endswith("norm") or name == "router":
        return torch.float32
    return compute


def program_tree(cfg: dict, seed: int, device, *, master: bool,
                 compute: torch.dtype = torch.bfloat16) -> Dict:
    """The port's parameter tree: every leaf f32 with ``master`` (the
    trainer's masters), else in its served dtype (``served_dtype``)."""
    tree: Dict = {}
    for path, shape, lead in leaves(cfg):
        dtype = torch.float32 if master else served_dtype(path, compute)
        leaf = torch.empty(shape, dtype=dtype, device=device)
        for index in slices(shape, lead):
            leaf[index].copy_(draw(seed, path, index, shape[lead:], device,
                                   dtype))
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def get(tree: Dict, path: str):
    for p in path.split("/"):
        tree = tree[p]
    return tree


def tokens(seed: int, stream: str, index: int, shape: Tuple[int, ...],
           vocab: int, device) -> torch.Tensor:
    """Uniform token ids of ``shape``, the ``index``-th draw of
    ``stream``."""
    return torch.randint(0, vocab, shape, device=device,
                         generator=generator(device, seed, stream, index))
