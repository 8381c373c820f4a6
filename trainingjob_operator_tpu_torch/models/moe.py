"""Mixtral-style sparse-MoE family for the PyTorch port: config,
parameters, forward, loss.

Port of the JAX package's ``models/moe.py`` on one card (the ``ep`` mesh
axis and ``SHARDING_RULES`` are not ported yet: ROADMAP.md queue 1 item
1).  The layers are Llama's (``models/llama.py``: RMSNorm, rope, the flash
kernel, the remat policies) with the dense MLP replaced by a top-k routed
mixture of experts in the GShard/Switch dense-dispatch formulation: one-hot
dispatch and combine tensors of static shape [B, T, E, C], tokens over an
expert's capacity C dropped (combine weight 0), and the Switch
load-balancing auxiliary loss.  The parameter tree keeps the JAX layout,
expert leaves stacked [L, E, in, out], so a JAX tree carries across leaf
for leaf (``params_from_numpy``).

The dispatch, the expert products and the combine are ``torch.bmm`` calls:
batched over b (dispatch, combine) or over e (experts), as the JAX
einsums are.  Remat "dots" therefore recomputes them and saves only the
products without batch dims (q, k, v, wo and the router), as JAX's
``dots_with_no_batch_dims_saveable`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.models import llama
from trainingjob_operator_tpu_torch.ops import flash_attention


@dataclass(frozen=True)
class MoEConfig:
    """Own copy of the JAX package's ``MoEConfig`` (same fields and
    defaults: Mixtral-8x7B)."""
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    #: Sliding-window attention span (Mixtral uses 4096); 0 = full causal.
    sliding_window: int = 0
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @classmethod
    def mixtral_8x7b(cls) -> "MoEConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab_size: int = 256, dim: int = 64, n_layers: int = 2,
             n_heads: int = 4, n_kv_heads: int = 2, ffn_dim: int = 128,
             n_experts: int = 4, experts_per_token: int = 2) -> "MoEConfig":
        return cls(vocab_size=vocab_size, dim=dim, n_layers=n_layers,
                   n_heads=n_heads, n_kv_heads=n_kv_heads, ffn_dim=ffn_dim,
                   n_experts=n_experts, experts_per_token=experts_per_token,
                   max_seq_len=128)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


#: The configs by their ``MOE_CONFIG`` names.
CONFIGS = {"tiny": MoEConfig.tiny, "8x7b": MoEConfig.mixtral_8x7b}


def param_shapes(config: MoEConfig) -> Dict[str, Any]:
    """The global shape of every leaf of the parameter tree (the JAX
    ``init_params`` tree), in its order."""
    c = config
    L, D, F_, E = c.n_layers, c.dim, c.ffn_dim, c.n_experts
    kv_dim = c.n_kv_heads * c.head_dim
    return {
        "tok_embed": (c.vocab_size, D),
        "layers": {
            "attn": {"wq": (L, D, D), "wk": (L, D, kv_dim),
                     "wv": (L, D, kv_dim), "wo": (L, D, D)},
            "moe": {"router": (L, D, E), "w_gate": (L, E, D, F_),
                    "w_up": (L, E, D, F_), "w_down": (L, E, F_, D)},
            "attn_norm": (L, D),
            "moe_norm": (L, D),
        },
        "final_norm": (D,),
        "lm_head": (D, c.vocab_size),
    }


def init_params(config: MoEConfig, generator: Optional[torch.Generator],
                device="cuda", *, master: bool = False) -> Dict[str, Any]:
    """Seeded random init on ``device``, same tree and scales as the JAX
    ``init_params`` (normal * in_dim ** -0.5, in_dim = ``shape[-2]``;
    embeddings and head * 0.02; norms 1); the numbers differ from JAX's
    (another generator).  Every [in, out] matrix of a leaf (one per layer,
    and per expert in a [L, E, in, out] leaf) is drawn on its own in f32 on
    the generator's device and stored in the leaf's dtype: the matmul
    weights in the compute dtype (all f32 with ``master=True``, for
    training), the router and the norm scales in f32.  Without a
    ``generator`` the leaves are allocated and not drawn: a template for a
    checkpoint's restore."""
    from trainingjob_operator_tpu_torch.parallel import sharding

    dev = resolve_device(device)
    compute = config.compute_dtype
    scales = {"tok_embed": 0.02, "lm_head": 0.02}

    def leaf(path, shape):
        name = path.rsplit("/", 1)[-1]
        if name.endswith("norm"):
            return torch.ones(shape, dtype=torch.float32, device=dev)
        out = torch.empty(shape, dtype=llama._leaf_dtype(name, compute,
                                                         master),
                          device=dev)
        if generator is None:
            return out
        scale = scales.get(name, shape[-2] ** -0.5)
        for matrix in out.view(-1, *shape[-2:]):
            matrix.copy_(torch.randn(shape[-2:], generator=generator,
                                     device=generator.device,
                                     dtype=torch.float32) * scale)
        return out

    return sharding.map_with_path(leaf, param_shapes(config))


#: The JAX package's MoE parameter tree (numpy leaves) -> the port's:
#: Llama's rule, under which the router, like the norm scales, stays f32.
params_from_numpy = llama.params_from_numpy


def expert_capacity(config: MoEConfig, seq_len: int) -> int:
    """Static per-expert token budget for one [T] row."""
    c = config
    cap = int(c.capacity_factor * c.experts_per_token * seq_len
              / c.n_experts)
    return max(cap, 1)


def _dispatch_combine(probs: torch.Tensor, k: int, capacity: int):
    """GShard-style routing tensors from router probabilities [B, T, E]
    f32 -> (dispatch, combine), each [B, T, E, C] f32: ``combine`` carries
    the renormalised top-k gate of each (token, expert, slot) assignment,
    ``dispatch`` its 0/1 mask.  Assignment is choice-rank-major, then
    token-major, so an expert over capacity drops its lowest-priority
    tokens.

    As the JAX function, with two PyTorch differences held to it: the top
    k come from a stable descending sort (``jax.lax.top_k`` puts the lower
    index first on ties; ``torch.topk`` promises no order), and a slot
    one-hot is a comparison with ``arange(C)``, which gives the zero row
    that ``jax.nn.one_hot`` gives a position >= C (``F.one_hot`` would
    raise).  Positions are f32 cumsums, exact up to T = 2^24."""
    B, T, E = probs.shape
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    experts = torch.arange(E, device=probs.device)
    slots = torch.arange(capacity, device=probs.device, dtype=probs.dtype)
    dispatch = probs.new_zeros((B, T, E, capacity))
    combine = probs.new_zeros((B, T, E, capacity))
    used = probs.new_zeros((B, E))                          # slots taken
    for choice in range(k):
        onehot = (idx[:, :, choice, None] == experts).to(probs.dtype)
        # Position of each token within its chosen expert's capacity:
        # tokens assigned by earlier choices + earlier tokens of this one.
        pos = (torch.cumsum(onehot, dim=1) - onehot
               + used[:, None, :]) * onehot                # [B,T,E]
        within = (pos < capacity).to(probs.dtype) * onehot
        slot = (pos.sum(-1, keepdim=True) == slots).to(probs.dtype)
        assign = within[..., None] * slot[:, :, None, :]   # [B,T,E,C]
        dispatch = dispatch + assign
        combine = combine + assign * gates[:, :, choice, None, None]
        used = used + within.sum(dim=1)
    return dispatch, combine


def _moe_mlp(h: torch.Tensor, layer, config: MoEConfig,
             compute: torch.dtype):
    """Routed expert MLP for h [B, T, D] -> ([B, T, D], aux loss f32).

    Routing is whole-sequence, as in JAX.  The router runs in f32 (routing
    decisions are precision-sensitive).  Dispatch [B, T, E*C]^T x h gives
    each expert's C rows of every sequence; the three expert products run
    as one ``bmm`` over the E experts on [E, B*C, .] rows; the combine
    weighs the expert outputs back into [B, T, D]."""
    c = config
    B, T, D = h.shape
    E, C = c.n_experts, expert_capacity(c, T)
    moe = layer["moe"]
    logits = h.float() @ moe["router"]                      # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine = _dispatch_combine(probs, c.experts_per_token, C)

    # Switch-transformer load-balancing auxiliary loss: E * sum_e
    # (fraction of tokens routed to e) * (mean router prob of e).
    frac = dispatch.sum(dim=(1, 3)) / max(
        T * c.experts_per_token / c.n_experts, 1e-9) / c.n_experts
    aux = (frac * probs.mean(dim=1)).sum(-1).mean() * c.n_experts

    x_e = torch.bmm(dispatch.to(compute).view(B, T, E * C).transpose(1, 2),
                    h)                                      # [B, E*C, D]
    x_e = x_e.view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    gate = F.silu(torch.bmm(x_e, moe["w_gate"].to(compute)))
    up = torch.bmm(x_e, moe["w_up"].to(compute))
    y_e = torch.bmm(gate * up, moe["w_down"].to(compute))   # [E, B*C, D]
    y_e = y_e.view(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    y = torch.bmm(combine.to(compute).view(B, T, E * C), y_e)
    return y, aux


def _block(h, layer, cos, sin, c: MoEConfig):
    """One decoder layer: attention then the routed MLP, each pre-normed
    and added to the residual stream h [B, T, D]; returns (h, aux, k, v)."""
    compute = c.compute_dtype
    B, T = h.shape[:2]
    attn = layer["attn"]
    x = llama._rmsnorm(h, layer["attn_norm"], c.norm_eps)
    q = (x @ attn["wq"].to(compute)).view(B, T, c.n_heads, c.head_dim)
    k = (x @ attn["wk"].to(compute)).view(B, T, c.n_kv_heads, c.head_dim)
    v = (x @ attn["wv"].to(compute)).view(B, T, c.n_kv_heads, c.head_dim)
    q = llama._apply_rope(q, cos, sin)
    k = llama._apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True, window=c.sliding_window)
    h = h + o.reshape(B, T, c.dim) @ attn["wo"].to(compute)
    y, aux = _moe_mlp(llama._rmsnorm(h, layer["moe_norm"], c.norm_eps),
                      layer, c, compute)
    return h + y, aux, k, v


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            config: MoEConfig, *, remat=False, return_hidden: bool = False,
            return_kv: bool = False):
    """Logits [B, T, vocab] f32 and the mean auxiliary load-balancing loss
    over the layers.

    With ``return_hidden`` returns the final-norm hidden states [B, T, D]
    instead of logits (the chunked cross-entropy path).  With
    ``return_kv`` returns ``(logits, aux, (k, v))``, k/v the post-rope
    per-layer projections stacked [L, B, T, Hkv, Dh] (the decode prefill
    reuses this forward).  ``remat`` is one of ``llama.REMAT_POLICIES``.
    """
    if return_hidden and return_kv:
        raise ValueError("return_hidden and return_kv are mutually "
                         "exclusive (the hidden path drops the kv stack)")
    c = config
    compute = c.compute_dtype
    B, T = tokens.shape
    h = params["tok_embed"].to(compute)[tokens]
    pos = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    cos, sin = llama._rope_tables(pos, c.head_dim, c.rope_theta, compute)
    block = llama._remat_wrap(_block, remat)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    ks, vs = [], []
    for layer in llama.unstack_layers(params["layers"], c.n_layers):
        h, layer_aux, k, v = block(h, layer, cos, sin, c)
        aux = aux + layer_aux
        if return_kv:
            ks.append(k)
            vs.append(v)
    h = llama._rmsnorm(h, params["final_norm"], c.norm_eps)
    aux = aux / c.n_layers
    if return_hidden:
        return h, aux
    logits = (h @ params["lm_head"].to(compute)).float()
    if return_kv:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            config: MoEConfig, *, remat=False, ce_chunk: int = 0,
            mesh=None):
    """Next-token cross-entropy (f32 logits, mean over B * T) plus the
    weighted load-balancing auxiliary; batch: {"tokens": [B, T+1]}.

    ``ce_chunk`` > 0 (dividing T) computes the head and CE in sequence
    chunks (``llama._chunked_ce``).  A ``mesh`` raises: MoE across
    processes is not ported yet (ROADMAP.md queue 1 item 1)."""
    if mesh is not None:
        raise NotImplementedError(
            "MoE on a mesh is not ported yet (ROADMAP.md queue 1 item 1)")
    c = config
    tokens = batch["tokens"]
    T = tokens.shape[1] - 1
    targets = tokens[:, 1:].long()
    if ce_chunk:
        if T % ce_chunk != 0:
            raise ValueError(f"ce_chunk={ce_chunk} does not divide seq {T}")
        h, aux = forward(params, tokens[:, :-1], c, remat=remat,
                         return_hidden=True)
        ce = llama._chunked_ce(h, params["lm_head"], targets, ce_chunk,
                               c.compute_dtype)
    else:
        logits, aux = forward(params, tokens[:, :-1], c, remat=remat)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1))
    return ce + c.aux_loss_weight * aux


def num_params(config: MoEConfig) -> int:
    c = config
    kv_dim = c.n_kv_heads * c.head_dim
    per_layer = (c.dim * c.dim * 2 + c.dim * kv_dim * 2
                 + c.dim * c.n_experts
                 + c.n_experts * c.dim * c.ffn_dim * 3 + 2 * c.dim)
    return c.vocab_size * c.dim * 2 + c.n_layers * per_layer + c.dim


def active_params(config: MoEConfig) -> int:
    """Params touched per token (top-k of the experts): the FLOPs basis."""
    c = config
    kv_dim = c.n_kv_heads * c.head_dim
    per_layer = (c.dim * c.dim * 2 + c.dim * kv_dim * 2
                 + c.dim * c.n_experts
                 + c.experts_per_token * c.dim * c.ffn_dim * 3 + 2 * c.dim)
    return c.vocab_size * c.dim * 2 + c.n_layers * per_layer + c.dim
