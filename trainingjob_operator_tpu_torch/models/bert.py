"""BERT encoder and masked-LM head (config 4) for the PyTorch port: the
port of the JAX package's ``models/bert.py``.

Learned position embeddings, post-LN blocks over stacked ``[L, ...]``
layer leaves (the body of JAX's ``lax.scan`` is a loop over the layers),
and an MLM head tied to the token embedding.  The parameter tree keeps
JAX's layout and key paths, so a JAX tree carries across leaf for leaf
(``params_from_numpy``); every leaf is an f32 master, cast to the compute
dtype at each use as JAX's ``astype(compute)`` does.

The numerics follow JAX's line by line: ``_layernorm`` in f32 with the
biased variance (``F.layer_norm`` on the f32 input), cast back; the key
mask added at -1e30 in the compute dtype; the softmax in f32 and its
probabilities cast back; ``jax.nn.gelu`` in its default tanh form; the tied head in the compute dtype, cast to f32
before ``mlm_bias``.  Attention is plain PyTorch, two batched products and
an f32 softmax, as the reference's XLA einsum: the reference reaches no
Pallas kernel here, and the port's flash kernels take no key mask.

With a ``mesh`` (``parallel/mesh.py``; dp x fsdp x tp) each leaf is this
rank's block under ``sharding_rules()``, fitted per leaf
(``sharding.fit_spec``) as JAX fits them:

- ``tok_embed`` and ``pos_embed`` are gathered whole at their uses.
- q, k, v and w_in keep their tp columns, wo and w_out their tp rows,
  with Megatron's ``copy_to_tp``/``reduce_from_tp`` around them, where
  the fitted specs split them on tp and tp divides the heads; otherwise
  the layer's weights are gathered whole and its products run
  replicated.
- The biases are replicated leaves: a column-parallel one (bq, bk, bv,
  b_in) is cut to this rank's columns, and its gradient summed over tp;
  a row-parallel one (bo, b_out) is added once, after the tp sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.parallel.collectives import (
    copy_to_tp,
    gather,
    reduce_from_tp,
    sum_over_data,
)


@dataclass(frozen=True)
class BertConfig:
    """Own copy of the JAX package's ``BertConfig`` (same fields and
    defaults: BERT-base)."""

    vocab_size: int = 30522
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    ffn_dim: int = 3072
    max_seq_len: int = 512
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "BertConfig":
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, ffn_dim=128,
                   max_seq_len=64)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


#: The configs by their ``BERT_CONFIG`` names.
CONFIGS = {"tiny": BertConfig.tiny, "base": BertConfig.base}

#: Column- and row-parallel layer weights (the other layer leaves are
#: replicated).
COLUMN = ("attn/wq", "attn/wk", "attn/wv", "mlp/w_in")
ROW = ("attn/wo", "mlp/w_out")


def sharding_rules():
    """The JAX package's ``SHARDING_RULES`` verbatim and in order: stacked
    layer leaves carry a leading layer entry that stays unsharded; the
    biases, norms and ``mlm_bias`` are replicated."""
    return [
        (r"tok_embed|pos_embed", ("tp", "fsdp")),
        (r"attn/w[qkv]$", (None, "fsdp", "tp")),
        (r"attn/wo$", (None, "tp", "fsdp")),
        (r"mlp/w_in$", (None, "fsdp", "tp")),
        (r"mlp/w_out$", (None, "tp", "fsdp")),
        (r".*", ()),
    ]


def mesh_rules(mesh):
    """The rules on any mesh (``llama_elastic.state_blocks`` reads them):
    ``sharding_rules()``."""
    return sharding_rules()


def param_shapes(config: BertConfig) -> Dict[str, Any]:
    """The global shape of every leaf of JAX's ``init_params`` tree, in
    its order."""
    c = config
    L, D, Fd = c.n_layers, c.dim, c.ffn_dim

    def norm(*lead):
        return {"scale": lead + (D,), "bias": lead + (D,)}

    return {
        "tok_embed": (c.vocab_size, D),
        "pos_embed": (c.max_seq_len, D),
        "embed_norm": norm(),
        "layers": {
            "attn": {"wq": (L, D, D), "wk": (L, D, D), "wv": (L, D, D),
                     "wo": (L, D, D), "bq": (L, D), "bk": (L, D),
                     "bv": (L, D), "bo": (L, D)},
            "mlp": {"w_in": (L, D, Fd), "b_in": (L, Fd),
                    "w_out": (L, Fd, D), "b_out": (L, D)},
            "attn_norm": norm(L),
            "mlp_norm": norm(L),
        },
        "mlm_bias": (c.vocab_size,),
    }


def num_params(config: BertConfig) -> int:
    from trainingjob_operator_tpu_torch.parallel import sharding

    return sum(int(np.prod(s)) for _, s in
               sharding.tree_paths(param_shapes(config)))


def _specs(config: BertConfig, mesh) -> Dict[str, Any]:
    """The fitted spec of every leaf on ``mesh``, by its path."""
    from trainingjob_operator_tpu_torch.parallel import sharding

    return {path: sharding.leaf_spec(path, shape, sharding_rules(), mesh)
            for path, shape in sharding.tree_paths(param_shapes(config))}


def init_params(config: BertConfig, generator: Optional[torch.Generator],
                device="cuda", *, mesh=None) -> Dict[str, Any]:
    """Seeded random init, JAX's tree and scales: dense leaves ``normal *
    0.02``, biases and ``mlm_bias`` 0, norm scales 1; every leaf f32.
    Each dense leaf is drawn whole on the generator's device, in tree
    order, so a CPU generator gives the same numbers on every device and
    at every width; with a ``mesh`` each leaf keeps this rank's block.
    Without a ``generator`` the leaves are allocated, not drawn: a
    template for a checkpoint's restore."""
    from trainingjob_operator_tpu_torch.parallel import sharding

    dev = resolve_device(device)
    specs = _specs(config, mesh) if mesh is not None else {}

    def leaf(path, shape):
        name = path.rsplit("/", 1)[-1]
        cut = (slice(None),) * len(shape)
        if mesh is not None:
            cut = sharding.block_slices(
                sharding.block_of(specs[path], shape, mesh))
        if name.startswith("w") or name.endswith("embed"):
            if generator is None:
                full = torch.empty(shape)
            else:
                full = torch.randn(shape, generator=generator,
                                   device=generator.device) * 0.02
        else:
            full = (torch.ones if name == "scale" else torch.zeros)(shape)
        return full[cut].to(dev, torch.float32, copy=True)

    return sharding.map_with_path(leaf, param_shapes(config))


def params_from_numpy(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """JAX's parameter tree (numpy leaves) -> the port's, f32 masters."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(dev)

    return walk(tree)


def _layernorm(x, scale, bias, eps):
    """JAX's ``_layernorm``: in f32 with the biased variance, ``(x - mean)
    / sqrt(var + eps) * scale + bias``, cast back to x's dtype.
    ``F.layer_norm`` on the f32 input is that function (its variance is
    the biased one), in one kernel each way on the card."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias,
                        eps).to(x.dtype)


class _Leaves:
    """A leaf's use at the compute dtype: cast alone without a mesh;
    gathered over every axis of its spec (tp too where ``whole``) with
    one."""

    def __init__(self, params, config: BertConfig, mesh):
        self.params, self.mesh = params, mesh
        self.compute = config.compute_dtype
        self.specs = _specs(config, mesh) if mesh is not None else None

    def top(self, name, dtype=None):
        """A top-level leaf whole, cast to ``dtype`` where given."""
        x = self.params[name]
        if self.mesh is None:
            return x if dtype is None else x.to(dtype)
        return gather(x, self.specs[name], self.mesh, dtype)

    def tp_split(self, paths) -> bool:
        """Whether every weight of ``paths`` keeps its tp block: its
        fitted spec splits its columns (a column-parallel weight) or its
        rows (a row-parallel one) on tp."""
        if self.mesh is None or self.mesh.size("tp") == 1:
            return False
        from trainingjob_operator_tpu_torch.parallel.sharding import axes_of

        for path in paths:
            spec = self.specs[f"layers/{path}"]
            dim = 2 if path in COLUMN else 1
            if "tp" not in axes_of(spec[dim]):
                return False
        return True


def _split_bias(b, mesh):
    """This rank's tp columns of a whole, replicated bias; its gradient
    is summed over tp (``copy_to_tp``), so every rank's full-width bias
    gradient holds the columns of all."""
    tp, r = mesh.size("tp"), mesh.coord("tp")
    n = b.shape[-1] // tp
    return copy_to_tp(b, mesh)[..., r * n:(r + 1) * n]


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            config: BertConfig, attention_mask: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """tokens [B, T] -> hidden [B, T, dim] in the compute dtype.
    ``attention_mask`` [B, T] (True where a key may be attended; all by
    default).  With a ``mesh``, ``params`` holds this rank's blocks and
    ``tokens`` its rows."""
    c = config
    compute = c.compute_dtype
    B, T = tokens.shape
    if T > c.max_seq_len:
        # JAX's forward fails here too, broadcasting the cut pos_embed.
        raise ValueError(f"sequence of {T} tokens exceeds max_seq_len="
                         f"{c.max_seq_len}")
    leaves = _Leaves(params, c, mesh)
    h = (leaves.top("tok_embed", compute)[tokens]
         + leaves.top("pos_embed", compute)[None, :T])
    norm = params["embed_norm"]
    if mesh is not None:
        norm = {k: gather(v, (None,), mesh) for k, v in norm.items()}
    h = _layernorm(h, norm["scale"], norm["bias"], c.norm_eps)
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.bool,
                                    device=tokens.device)
    bias = torch.where(attention_mask[:, None, None, :], 0.0, -1e30).to(
        compute)

    layers = params["layers"]
    # Each stacked leaf as its L layer slices (``torch.unbind``: the
    # backward stacks their gradients in one pass).  The replicated ones
    # (biases, norms) are made whole once per step in f32, so that their
    # gradients are summed over the data axes in one all-reduce each.
    rep = {}
    for group in ("attn", "mlp", "attn_norm", "mlp_norm"):
        for name, x in layers[group].items():
            path = f"{group}/{name}"
            if mesh is not None and path not in COLUMN and path not in ROW:
                x = gather(x, (None, None), mesh)
            rep[path] = torch.unbind(x)
    attn_tp = leaves.tp_split(("attn/wq", "attn/wk", "attn/wv", "attn/wo"))
    attn_tp = attn_tp and c.n_heads % mesh.size("tp") == 0
    mlp_tp = leaves.tp_split(("mlp/w_in", "mlp/w_out"))
    tp = 1 if mesh is None else mesh.size("tp")
    heads = c.n_heads // tp if attn_tp else c.n_heads

    def weight(path, i, split):
        w = rep[path][i]
        if mesh is None:
            return w.to(compute)
        spec = leaves.specs[f"layers/{path}"][1:]
        return gather(w, spec, mesh, compute, keep=("tp",) if split else ())

    def col_bias(path, i, split):
        b = rep[path][i].to(compute)
        return _split_bias(b, mesh) if split else b

    def ln(x, group, i):
        return _layernorm(x, rep[f"{group}/scale"][i],
                          rep[f"{group}/bias"][i], c.norm_eps)

    for i in range(c.n_layers):
        x = copy_to_tp(h, mesh) if attn_tp else h
        q = x @ weight("attn/wq", i, attn_tp) + col_bias("attn/bq", i,
                                                          attn_tp)
        k = x @ weight("attn/wk", i, attn_tp) + col_bias("attn/bk", i,
                                                          attn_tp)
        v = x @ weight("attn/wv", i, attn_tp) + col_bias("attn/bv", i,
                                                          attn_tp)
        q = q.view(B, T, heads, c.head_dim).transpose(1, 2)
        k = k.view(B, T, heads, c.head_dim).transpose(1, 2)
        v = v.view(B, T, heads, c.head_dim).transpose(1, 2)
        s = (q @ k.transpose(-1, -2)) * (c.head_dim ** -0.5)
        s = s + bias
        p = torch.softmax(s.float(), dim=-1).to(compute)
        o = (p @ v).transpose(1, 2).reshape(B, T, heads * c.head_dim)
        o = o @ weight("attn/wo", i, attn_tp)
        if attn_tp:
            o = reduce_from_tp(o, mesh)
        o = o + rep["attn/bo"][i].to(compute)
        h = ln(h + o, "attn_norm", i)

        x = copy_to_tp(h, mesh) if mlp_tp else h
        f = F.gelu(x @ weight("mlp/w_in", i, mlp_tp)
                   + col_bias("mlp/b_in", i, mlp_tp), approximate="tanh")
        f = f @ weight("mlp/w_out", i, mlp_tp)
        if mlp_tp:
            f = reduce_from_tp(f, mesh)
        f = f + rep["mlp/b_out"][i].to(compute)
        h = ln(h + f, "mlp_norm", i)
    return h


def mlm_logits(params: Dict[str, Any], hidden: torch.Tensor,
               config: BertConfig, mesh=None) -> torch.Tensor:
    """The tied-embedding MLM head: ``hidden @ tok_embed.T`` in the
    compute dtype, cast to f32, plus ``mlm_bias``."""
    leaves = _Leaves(params, config, mesh)
    emb = leaves.top("tok_embed", config.compute_dtype)
    mlm_bias = params["mlm_bias"]
    if mesh is not None:
        mlm_bias = gather(mlm_bias, (None,), mesh)
    return (hidden @ emb.T).float() + mlm_bias


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            config: BertConfig, mesh=None) -> torch.Tensor:
    """Masked-LM loss, a scalar f32 tensor; batch: tokens, targets and mask
    [B, T] (mask 1 where a token was masked and must be predicted).  The
    CE of each masked position, summed, over ``max(mask.sum(), 1)``.

    With a ``mesh`` the batch is this rank's rows and the loss the global
    one: the masked count is summed over the data axes first, and each
    rank's share ``sum / count`` is summed over them (``sum_over_data``),
    whose backward leaves each rank the gradient of its own rows."""
    hidden = forward(params, batch["tokens"], config, mesh=mesh)
    logits = mlm_logits(params, hidden, config, mesh)
    raw = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          batch["targets"].reshape(-1).long(),
                          reduction="none")
    mask = batch["mask"].reshape(-1).float()
    count = mask.sum()
    if mesh is None:
        return (raw * mask).sum() / torch.clamp(count, min=1.0)
    with torch.no_grad():
        count = sum_over_data(count, mesh)
    return sum_over_data((raw * mask).sum() / torch.clamp(count, min=1.0),
                         mesh)
