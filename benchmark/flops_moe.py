"""The bytes of a routed model's serving step, beside ``flops.py``: what a
decode step reads of the weights, and what the expert products under the
program's ``moe.experts`` range read and write.  Nothing is taken from
the program but the counts its counters give.
"""

from __future__ import annotations


def expert_matrix_bytes(cfg: dict, esize: int = 2) -> int:
    """One expert's three matrices (gate, up, down) in one layer."""
    return 3 * cfg["hidden_size"] * cfg["intermediate_size"] * esize


def decode_weight_bytes(cfg: dict, rows: int, esize: int = 2) -> int:
    """Bytes of weights one decode step of a routed model reads with every
    expert reached: every expert of every layer, the attention matrices
    and the head in the served dtype, the f32 router and norm scales, and
    ``rows`` embedding rows."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    E = cfg["num_local_experts"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    attn = L * (D * q * 2 + D * kv * 2) * esize
    experts = L * E * expert_matrix_bytes(cfg, esize)
    router = L * D * E * 4
    norms = (2 * L + 1) * D * 4
    head = D * cfg["vocab_size"] * esize
    return experts + attn + router + norms + head + rows * D * esize


def experts_bytes(cfg: dict, reached: int, pairs: int, esize: int = 2) -> int:
    """Bytes the expert products need: the matrices of the ``reached``
    (layer, expert) pairs read once, and each (row, choice) pair's input
    row read and output row written once."""
    return (reached * expert_matrix_bytes(cfg, esize)
            + pairs * 2 * cfg["hidden_size"] * esize)

