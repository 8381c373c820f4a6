"""Mixtral-style sparse-MoE family for the PyTorch port: config,
parameters, forward, loss.

Port of the JAX package's ``models/moe.py``, on one card or on a ``dp x
fsdp x tp x ep`` mesh (``parallel/``).  The layers are Llama's
(``models/llama.py``: RMSNorm, rope, the flash kernel, the remat policies)
with the dense MLP replaced by a top-k routed mixture of experts in the
GShard/Switch dense-dispatch formulation: one-hot dispatch and combine
tensors of static shape [B, T, E, C], tokens over an expert's capacity C
dropped (combine weight 0), and the Switch load-balancing auxiliary loss.
The parameter tree keeps the JAX layout, expert leaves stacked [L, E, in,
out], so a JAX tree carries across leaf for leaf (``params_from_numpy``).

The dispatch, the expert products and the combine are ``torch.bmm`` calls:
batched over b (dispatch, combine) or over e (experts), as the JAX
einsums are.  Remat "dots" therefore recomputes them and saves only the
products without batch dims (q, k, v, wo and the router), as JAX's
``dots_with_no_batch_dims_saveable`` does.

On a mesh (JAX's ``SHARDING_RULES``, ``sharding_rules``) the experts lie
on ``ep`` and, within an expert, on fsdp and tp.  The batch's rows lie on
the data axes only (JAX's ``batch_spec``), so the ep and tp ranks of a
data shard hold the same rows: each routes them to all E experts, runs
its own experts' products on its tp columns, and the partial outputs are
summed over tp and ep (``_moe_mlp``).  That is JAX's function exactly;
no token moves between ranks, so there is no all-to-all.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.models import llama
from trainingjob_operator_tpu_torch.parallel.collectives import (
    copy_to_tp,
    gather,
    reduce_from_tp,
    sum_over_data,
)


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


#: path-pattern -> spec (``parallel/sharding.py`` rules): the JAX
#: package's ``SHARDING_RULES`` verbatim, in its order (the first match
#: wins).  The expert dim rides ``ep``; within an expert the matmul dims
#: keep the Megatron fsdp/tp layout; attention and embeddings as Llama's;
#: the router is split over fsdp only.
def sharding_rules():
    return [
        (r"tok_embed", (("tp", "fsdp"), None)),
        (r"lm_head", ("fsdp", "tp")),
        (r"attn/w[qkv]$", (None, "fsdp", "tp")),
        (r"attn/wo$", (None, "tp", "fsdp")),
        (r"moe/router$", (None, "fsdp", None)),
        (r"moe/w_(gate|up)$", (None, "ep", "fsdp", "tp")),
        (r"moe/w_down$", (None, "ep", "tp", "fsdp")),
        (r"norm", (None,)),
    ]


def mesh_rules(mesh):
    """The rules on ``mesh`` (the family has no pipeline): ``sharding_rules``
    (``llama_elastic.state_blocks`` asks each family for its own)."""
    return sharding_rules()


#: Raises ``ValueError`` unless tp divides the query and KV heads and the
#: ffn width, which the attention and the experts split by hand.  An ep
#: that does not divide the experts is not refused: ``fit_spec`` then
#: keeps every expert whole on every rank, as JAX does (``_expert_range``).
check_tp = llama.check_tp


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
                device="cuda", *, master: bool = False,
                mesh=None) -> Dict[str, Any]:
    """Seeded random init on ``device``, same tree and scales as the JAX
    ``init_params`` (normal * in_dim ** -0.5, in_dim = ``shape[-2]``;
    embeddings and head * 0.02; norms 1); the numbers differ from JAX's
    (another generator).  Every [in, out] matrix of a leaf (one per layer,
    and per expert in a [L, E, in, out] leaf) is drawn on its own in f32 on
    the generator's device and stored in the leaf's dtype: the matmul
    weights in the compute dtype (all f32 with ``master=True``, for
    training), the router and the norm scales in f32.

    With a ``mesh`` each leaf keeps only this rank's block under
    ``sharding_rules``: every matrix is drawn whole, in the same order as
    without a mesh (so the blocks of all ranks make up the same numbers),
    and cut; a matrix of another rank's experts is drawn and dropped.

    Without a ``generator`` the leaves are allocated and not drawn: a
    template for a checkpoint's restore."""
    import itertools

    from trainingjob_operator_tpu_torch.parallel import sharding

    dev = resolve_device(device)
    compute = config.compute_dtype
    shapes = param_shapes(config)
    blocks = None
    if mesh is not None:
        check_tp(config, mesh.size("tp"))
        blocks = dict(sharding.tree_paths(
            sharding.tree_blocks(shapes, sharding_rules(), mesh)))
    scales = {"tok_embed": 0.02, "lm_head": 0.02}

    def leaf(path, shape):
        name = path.rsplit("/", 1)[-1]
        index = tuple((0, n) for n in shape)
        if blocks is not None:
            index = blocks[path][1]
        local = tuple(b - a for a, b in index)
        if name.endswith("norm"):
            return torch.ones(local, dtype=torch.float32, device=dev)
        out = torch.empty(local, dtype=llama._leaf_dtype(name, compute,
                                                         master),
                          device=dev)
        if generator is None:
            return out
        scale = scales.get(name, shape[-2] ** -0.5)
        lead, cut = index[:-2], tuple(slice(a, b) for a, b in index[-2:])
        for at in itertools.product(*(range(n) for n in shape[:-2])):
            full = torch.randn(shape[-2:], generator=generator,
                               device=generator.device, dtype=torch.float32)
            if all(a <= i < b for i, (a, b) in zip(at, lead)):
                mine = tuple(i - a for i, (a, _) in zip(at, lead))
                out[mine].copy_(full[cut] * scale)
        return out

    return sharding.map_with_path(leaf, shapes)


def mesh_specs(config: MoEConfig, mesh) -> Dict[str, Any]:
    """The fitted spec of each leaf on ``mesh`` by its name
    (``llama.layer_specs`` of the MoE tree under ``sharding_rules``)."""
    return llama.layer_specs(param_shapes(config), sharding_rules(), mesh)


#: The JAX package's MoE parameter tree (numpy leaves) -> the port's:
#: Llama's rule, under which the router, like the norm scales, stays f32.
params_from_numpy = llama.params_from_numpy


def expert_capacity(config: MoEConfig, seq_len: int) -> int:
    """Static per-expert token budget for one [T] row."""
    c = config
    cap = int(c.capacity_factor * c.experts_per_token * seq_len
              / c.n_experts)
    return max(cap, 1)


def _dispatch_combine(probs: torch.Tensor, k: int, capacity: int,
                      gates_fn=None):
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
    raise).  Positions are f32 cumsums, exact up to T = 2^24.

    ``gates_fn``, where given, maps the renormalised gates [B, T, k] before
    they weigh ``combine``: the mesh path's ``copy_to_tp`` over the model
    axes, whose backward sums the gates' gradient (read by each rank from
    its own experts' partial outputs) before it reaches the router."""
    B, T, E = probs.shape
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top.values[..., :k], top.indices[..., :k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    if gates_fn is not None:
        gates = gates_fn(gates)
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


def _expert_range(config: MoEConfig, mesh, specs):
    """(first, stop) of this rank's experts: its block of the expert dim
    under the fitted spec, or all E where ``fit_spec`` dropped ep (E % ep
    != 0: every rank holds every expert, as in JAX)."""
    E = config.n_experts
    if mesh is None or specs["w_gate"][0] is None:
        return 0, E
    n = E // mesh.size("ep")
    return mesh.coord("ep") * n, (mesh.coord("ep") + 1) * n


def _model_axes(specs):
    """The axes the experts' partial outputs are summed over: tp, and ep
    where the expert leaves are split on it."""
    return ("tp",) if specs["w_gate"][0] is None else ("tp", "ep")


def _moe_mlp(h: torch.Tensor, layer, config: MoEConfig,
             compute: torch.dtype, mesh=None, specs=None):
    """Routed expert MLP for h [B, T, D] -> ([B, T, D], aux loss f32).

    Routing is whole-sequence, as in JAX.  The router runs in f32 (routing
    decisions are precision-sensitive).  Dispatch [B, T, E*C]^T x h gives
    each expert's C rows of every sequence; the three expert products run
    as one ``bmm`` over the experts on [E, B*C, .] rows; the combine
    weighs the expert outputs back into [B, T, D].

    With a ``mesh`` the router is gathered over fsdp and stays f32, and
    every rank routes its rows to all E experts (the aux loss and the
    router's gradient are whole on every rank).  The dispatch and combine
    are cut to this rank's experts (``_expert_range``), whose leaves are
    gathered over fsdp and keep their ep and tp blocks [E/ep, D, F/tp], so
    the output is a partial sum over tp and ep (``_model_axes``):
    ``reduce_from_tp`` sums it, and ``copy_to_tp`` sums the gradients
    that come out partial, those of the experts' input and of the gates.
    The router's input is not copied: its gradient is already whole."""
    c = config
    B, T, D = h.shape
    C = expert_capacity(c, T)
    moe = layer["moe"]
    first, stop = _expert_range(c, mesh, specs)
    weight = llama._weight(layer, compute, mesh, specs)
    if mesh is None:
        router, x, gates_fn = moe["router"], h, None
    else:
        axes = _model_axes(specs)
        router = gather(moe["router"], specs["router"], mesh)
        x = copy_to_tp(h, mesh, axes)

        def gates_fn(gates):
            return copy_to_tp(gates, mesh, axes)
    logits = h.float() @ router                             # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine = _dispatch_combine(probs, c.experts_per_token, C,
                                          gates_fn)

    # Switch-transformer load-balancing auxiliary loss: E * sum_e
    # (fraction of tokens routed to e) * (mean router prob of e).
    frac = dispatch.sum(dim=(1, 3)) / max(
        T * c.experts_per_token / c.n_experts, 1e-9) / c.n_experts
    aux = (frac * probs.mean(dim=1)).sum(-1).mean() * c.n_experts

    E = stop - first
    dispatch = dispatch[:, :, first:stop].to(compute).reshape(B, T, E * C)
    combine = combine[:, :, first:stop].to(compute).reshape(B, T, E * C)
    x_e = torch.bmm(dispatch.transpose(1, 2), x)            # [B, E*C, D]
    x_e = x_e.view(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    keep = ("tp", "ep")
    gate = F.silu(torch.bmm(x_e, weight("moe", "w_gate", keep)))
    up = torch.bmm(x_e, weight("moe", "w_up", keep))
    y_e = torch.bmm(gate * up, weight("moe", "w_down", keep))  # [E, B*C, D]
    y_e = y_e.view(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)
    y = torch.bmm(combine, y_e)
    if mesh is not None:
        y = reduce_from_tp(y, mesh, axes)
    return y, aux


def _block(h, layer, cos, sin, c: MoEConfig, mesh=None, specs=None):
    """One decoder layer: attention then the routed MLP, each pre-normed
    and added to the residual stream h [B, T, D]; returns (h, aux, k, v).
    With a ``mesh`` the leaves are this rank's blocks, gathered at their
    use (``llama._attention``, ``_moe_mlp``)."""
    h, k, v = llama._attention(h, layer, cos, sin, c, mesh, specs)
    y, aux = _moe_mlp(llama._rmsnorm(h, layer["moe_norm"], c.norm_eps),
                      layer, c, c.compute_dtype, mesh, specs)
    return h + y, aux, k, v


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            config: MoEConfig, *, remat=False, return_hidden: bool = False,
            return_kv: bool = False, mesh=None):
    """Logits [B, T, vocab] f32 and the mean auxiliary load-balancing loss
    over the layers.

    With ``return_hidden`` returns the final-norm hidden states [B, T, D]
    instead of logits (the chunked cross-entropy path).  With
    ``return_kv`` returns ``(logits, aux, (k, v))``, k/v the post-rope
    per-layer projections stacked [L, B, T, Hkv, Dh] (the decode prefill
    reuses this forward).  ``remat`` is one of ``llama.REMAT_POLICIES``.

    With a ``mesh`` ``params`` holds this rank's blocks
    (``init_params(mesh=...)``) and ``tokens`` its rows: each layer
    gathers its weights inside its block, ``tok_embed`` and ``lm_head``
    are gathered whole, and the flash kernel runs on this rank's heads;
    ``return_kv`` raises, as Llama's."""
    if return_hidden and return_kv:
        raise ValueError("return_hidden and return_kv are mutually "
                         "exclusive (the hidden path drops the kv stack)")
    c = config
    compute = c.compute_dtype
    B, T = tokens.shape
    specs = None
    layers = params["layers"]
    if mesh is not None:
        if return_kv:
            raise ValueError("return_kv is not supported with a mesh")
        check_tp(c, mesh.size("tp"))
        specs = mesh_specs(c, mesh)
        # The norm scales are replicated: one gradient all-reduce over the
        # data axes for each stacked leaf.
        layers = {**layers, **{name: gather(layers[name], specs[name], mesh)
                               for name in ("attn_norm", "moe_norm")}}
    h = llama._whole(params, "tok_embed", mesh, specs, compute)[tokens]
    pos = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    cos, sin = llama._rope_tables(pos, c.head_dim, c.rope_theta, compute)
    block = llama._remat_wrap(_block, remat)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    ks, vs = [], []
    for layer in llama.unstack_layers(layers, c.n_layers):
        h, layer_aux, k, v = block(h, layer, cos, sin, c, mesh, specs)
        aux = aux + layer_aux
        if return_kv:
            ks.append(k)
            vs.append(v)
    h = llama._rmsnorm(h, llama._whole(params, "final_norm", mesh, specs),
                       c.norm_eps)
    aux = aux / c.n_layers
    if return_hidden:
        return h, aux
    logits = (h @ llama._whole(params, "lm_head", mesh, specs,
                               compute)).float()
    if return_kv:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            config: MoEConfig, *, remat=False, ce_chunk: int = 0,
            mesh=None):
    """Next-token cross-entropy (f32 logits, mean over B * T) plus the
    weighted load-balancing auxiliary; batch: {"tokens": [B, T+1]}.

    ``ce_chunk`` > 0 (dividing T) computes the head and CE in sequence
    chunks (``llama._chunked_ce``).  With a ``mesh`` the batch is this
    rank's rows and the loss is the global one, as ``llama.loss_fn``'s:
    each rank's loss (a mean over its rows, the aux loss too) divided by
    the data size and summed over the data axes."""
    c = config
    tokens = batch["tokens"]
    T = tokens.shape[1] - 1
    targets = tokens[:, 1:].long()
    if ce_chunk:
        if T % ce_chunk != 0:
            raise ValueError(f"ce_chunk={ce_chunk} does not divide seq {T}")
        h, aux = forward(params, tokens[:, :-1], c, remat=remat,
                         return_hidden=True, mesh=mesh)
        lm_head = params["lm_head"]
        if mesh is not None:
            lm_head = llama._whole(params, "lm_head", mesh,
                                   mesh_specs(c, mesh), c.compute_dtype)
        ce = llama._chunked_ce(h, lm_head, targets, ce_chunk,
                               c.compute_dtype)
    else:
        logits, aux = forward(params, tokens[:, :-1], c, remat=remat,
                              mesh=mesh)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1))
    loss = ce + c.aux_loss_weight * aux
    if mesh is None:
        return loss
    return sum_over_data(loss / mesh.data_size(), mesh)


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
