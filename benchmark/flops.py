"""The benchmark's own arithmetic: the card's peaks, model FLOPs, and the
operations and bytes of each kernel a per-layer metric holds against its
roofline.  Nothing is taken from the program.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at
the 700 W power limit): 989 TFLOP/s in bf16, 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def matmul_params(cfg: dict) -> int:
    """Parameters a token multiplies through: every projection, the
    routed experts it reaches (``num_experts_per_tok`` of them), the
    router and the head; not the embedding, which is a lookup."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    q = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    attn = D * q * 2 + D * kv * 2
    if cfg.get("num_local_experts"):
        mlp = (cfg["num_experts_per_tok"] * 3 * D * F
               + D * cfg["num_local_experts"])
    else:
        mlp = 3 * D * F
    return cfg["num_hidden_layers"] * (attn + mlp) + D * cfg["vocab_size"]


def train_flops_per_token(cfg: dict, seq: int) -> float:
    """Model FLOPs of a training token: 6 x the matmul parameters, plus
    causal attention, whose forward does 2 x seq/2 x width twice (scores
    and values) a layer: 6 L T D with the backward."""
    attn = 6 * cfg["num_hidden_layers"] * seq * (
        cfg["num_attention_heads"] * cfg["head_dim"])
    return 6.0 * matmul_params(cfg) + attn


def visible_pairs(T: int, causal: bool = True) -> int:
    """(query, key) pairs a causal mask leaves visible."""
    return T * (T + 1) // 2 if causal else T * T


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the HBM bandwidth."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_fwd_bound_s(B, T, H, Hkv, D, esize=2) -> float:
    """Flash forward: 4 D operations a visible pair and head; q, k, v read
    once, the output written once and the f32 log-sum-exp."""
    ops = 4 * B * H * D * visible_pairs(T)
    nbytes = (2 * B * H * T * D + 2 * B * Hkv * T * D) * esize + B * H * T * 4
    return bound_s(ops, nbytes)


def _bwd_bytes(B, T, H, Hkv, D, esize):
    return (B * H * T * D * esize, B * Hkv * T * D * esize, 2 * B * H * T * 4)


def flash_dq_bound_s(B, T, H, Hkv, D, esize=2) -> float:
    """dQ: 6 D operations a visible pair and head (scores, dP, dQ); q,
    dO, lse and delta read once with k and v, dQ written once."""
    q, kv, stat = _bwd_bytes(B, T, H, Hkv, D, esize)
    return bound_s(6 * D * B * H * visible_pairs(T), 3 * q + 2 * kv + stat)


def flash_dkv_bound_s(B, T, H, Hkv, D, esize=2) -> float:
    """dK/dV: 8 D operations a visible pair and head (scores, dP, dK,
    dV); q, dO, lse, delta, k and v read once, dK and dV written once."""
    q, kv, stat = _bwd_bytes(B, T, H, Hkv, D, esize)
    return bound_s(8 * D * B * H * visible_pairs(T), 2 * q + 4 * kv + stat)


def decode_weight_bytes(cfg: dict, rows: int, esize: int = 2) -> int:
    """Bytes of weights one decode step reads: every matrix and the head
    in the served dtype, f32 norm scales, and ``rows`` embedding rows."""
    if cfg.get("num_local_experts"):
        raise ValueError("decode bytes are counted for dense models only")
    D = cfg["hidden_size"]
    norms = (2 * cfg["num_hidden_layers"] + 1) * D * 4
    return matmul_params(cfg) * esize + norms + rows * D * esize


def decode_kv_bytes(cfg: dict, positions: int, esize: int = 2) -> int:
    """Bytes of cached keys and values that ``positions`` visible
    positions (summed over the batch's rows) need, in every layer."""
    return (positions * cfg["num_hidden_layers"] * 2
            * cfg["num_key_value_heads"] * cfg["head_dim"] * esize)
