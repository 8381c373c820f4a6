"""Llama-2 family for the PyTorch port: config, parameters, forward, loss.

Port of the JAX package's ``models/llama.py``: every remat policy, and a
``dp x pp x fsdp x tp x sp`` mesh (``parallel/``): under sp attention is
ring attention over the sequence blocks (``parallel/ringattention.py``),
under pp the layer stack is a GPipe pipeline over the stages
(``parallel/pipeline.py``).  The parameter
tree keeps the JAX layout -- a nested dict with stacked ``[L, in, out]``
layer leaves and ``x @ W`` products, under the same key paths as the JAX
``init_params`` -- so a JAX parameter tree carries across leaf for leaf
(``params_from_numpy``).
"""

from __future__ import annotations

import contextlib
import contextvars
import importlib
import math
import os
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.ops import flash_attention, rmsnorm
from trainingjob_operator_tpu_torch.parallel.collectives import (
    copy_to_tp,
    gather,
    reduce_from_tp,
    sum_over_data,
)
from trainingjob_operator_tpu_torch.parallel.pipeline import gpipe, touch
from trainingjob_operator_tpu_torch.parallel.ringattention import (
    RING_OP,
    ring_attention,
)
from trainingjob_operator_tpu_torch.parallel.sharding import sequence_block

_flash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")

#: Matmul-weight leaf names (stored in the compute dtype).
MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class LlamaConfig:
    """Own copy of the JAX package's ``LlamaConfig`` (same fields and
    defaults: Llama-2-7B)."""
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    #: Sliding-window attention: 0 = full causal; W > 0 restricts row i to
    #: keys (i - W, i].
    sliding_window: int = 0
    dtype: str = "bfloat16"  # compute dtype

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def base_124m(cls) -> "LlamaConfig":
        return cls(dim=768, n_layers=8, n_heads=12, n_kv_heads=12,
                   ffn_dim=3072, max_seq_len=2048)

    @classmethod
    def tiny(cls, vocab_size: int = 256, dim: int = 64, n_layers: int = 2,
             n_heads: int = 4, n_kv_heads: int = 2, ffn_dim: int = 128,
             max_seq_len: int = 128) -> "LlamaConfig":
        return cls(vocab_size=vocab_size, dim=dim, n_layers=n_layers,
                   n_heads=n_heads, n_kv_heads=n_kv_heads, ffn_dim=ffn_dim,
                   max_seq_len=max_seq_len)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


#: The configs by their ``LLAMA_CONFIG`` names.
CONFIGS = {"7b": LlamaConfig.llama2_7b, "124m": LlamaConfig.base_124m,
           "tiny": LlamaConfig.tiny}


def _leaf_dtype(name: str, compute: torch.dtype,
                master: bool = False) -> torch.dtype:
    # Matmul weights, tok_embed and lm_head live in the compute dtype; norm
    # scales stay f32.  Training keeps every leaf an f32 master.
    if not master and (name in MATMUL_LEAVES
                       or name in ("tok_embed", "lm_head")):
        return compute
    return torch.float32


#: path-pattern -> spec (``parallel/sharding.py`` rules): the JAX
#: package's ``sharding_rules`` verbatim.  fsdp splits the large dim, tp
#: heads, ffn and vocab; stacked layer leaves carry a leading layer entry
#: (``pp`` under a pipeline: each stage holds its contiguous layers).
def sharding_rules(pipeline: bool = False):
    lead = "pp" if pipeline else None
    return [
        (r"tok_embed", (("tp", "fsdp"), None)),
        (r"lm_head", ("fsdp", "tp")),
        (r"attn/w[qkv]$", (lead, "fsdp", "tp")),
        (r"attn/wo$", (lead, "tp", "fsdp")),
        (r"mlp/w_(gate|up)$", (lead, "fsdp", "tp")),
        (r"mlp/w_down$", (lead, "tp", "fsdp")),
        (r"layers/.*norm", (lead, None)),
        (r"norm", (None,)),
    ]


def mesh_rules(mesh):
    """The rules on ``mesh``: ``sharding_rules(pipeline=pp > 1)``, as the
    JAX trainer picks them."""
    return sharding_rules(pipeline=mesh is not None and mesh.size("pp") > 1)


def check_pp(config: LlamaConfig, pp: int) -> None:
    """Raise JAX's ``ValueError`` (``pipeline.py:131-132``) unless ``pp``
    divides the layers: each stage holds an equal contiguous block."""
    if config.n_layers % pp != 0:
        raise ValueError(f"{config.n_layers} layers not divisible by "
                         f"pp={pp}")


def check_tp(config: LlamaConfig, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` divides the query and KV heads and
    the ffn width.  JAX's ``fit_spec`` would quietly replicate such a leaf;
    the port's tensor-parallel block splits them by hand, so it refuses."""
    c = config
    for name, n in (("n_heads", c.n_heads), ("n_kv_heads", c.n_kv_heads),
                    ("ffn_dim", c.ffn_dim)):
        if n % tp != 0:
            raise ValueError(f"tp={tp} does not divide {name}={n}")


def param_shapes(config: LlamaConfig) -> Dict[str, Any]:
    """The global shape of every leaf of the parameter tree (the JAX
    ``init_params`` tree), in its order."""
    c = config
    L, D, F = c.n_layers, c.dim, c.ffn_dim
    kv_dim = c.n_kv_heads * c.head_dim
    return {
        "tok_embed": (c.vocab_size, D),
        "layers": {
            "attn": {"wq": (L, D, D), "wk": (L, D, kv_dim),
                     "wv": (L, D, kv_dim), "wo": (L, D, D)},
            "mlp": {"w_gate": (L, D, F), "w_up": (L, D, F),
                    "w_down": (L, F, D)},
            "attn_norm": (L, D),
            "mlp_norm": (L, D),
        },
        "final_norm": (D,),
        "lm_head": (D, c.vocab_size),
    }


def init_params(config: LlamaConfig, generator: Optional[torch.Generator],
                device="cuda", *, master: bool = False,
                mesh=None) -> Dict[str, Any]:
    """Seeded random init on ``device``, same tree and scales as the JAX
    ``init_params`` (normal * in_dim ** -0.5; embeddings and head * 0.02;
    norms 1).  The numbers differ from JAX's (another generator), and they
    are drawn on the generator's device: a CPU generator gives the same
    parameters on every device.  Leaves are drawn in f32 one layer at a
    time and stored in their leaf dtype, so the peak is one f32 layer
    slice, not an f32 copy of the model.

    ``master=True`` keeps every leaf f32, as the JAX package keeps its
    parameters for training: ``forward`` casts each to the compute dtype
    where it is used, and the gradient reaches the f32 leaf through that
    cast.

    With a ``mesh`` (``parallel/mesh.py``) each leaf keeps only this rank's
    block under ``sharding_rules``: every layer slice is drawn whole, as
    without a mesh (so the blocks of all ranks make up the same numbers),
    and cut; the peak is the blocks plus one f32 layer slice.

    Without a ``generator`` the weights are allocated and not drawn: a
    template for a checkpoint's restore."""
    from trainingjob_operator_tpu_torch.parallel import sharding

    dev = resolve_device(device)
    compute = config.compute_dtype
    shapes = param_shapes(config)
    blocks = None
    if mesh is not None:
        check_tp(config, mesh.size("tp"))
        check_pp(config, mesh.size("pp"))
        blocks = dict(sharding.tree_paths(
            sharding.tree_blocks(shapes, mesh_rules(mesh), mesh)))
    scales = {"tok_embed": 0.02, "lm_head": 0.02}

    def leaf(path, shape):
        name = path.rsplit("/", 1)[-1]
        cut, local = (slice(None),) * len(shape), shape
        if blocks is not None:
            cut = sharding.block_slices(blocks[path])
            local = tuple(b - a for a, b in blocks[path][1])
        if name.endswith("norm"):
            return torch.ones(local, dtype=torch.float32, device=dev)
        scale = scales.get(name, shape[-2] ** -0.5)
        out = torch.empty(local, dtype=_leaf_dtype(name, compute, master),
                          device=dev)
        if generator is None:
            return out
        # A stacked leaf is drawn a layer at a time, every layer (a stage
        # keeps the draws of its own: pp splits the layer dim).
        if len(shape) == 3:
            rows = dict(enumerate(out, start=cut[0].start or 0))
            n_rows, row_cut = shape[0], cut[1:]
        else:
            rows, n_rows, row_cut = {0: out}, 1, cut
        for i in range(n_rows):
            full = torch.randn(shape[-2:], generator=generator,
                               device=generator.device, dtype=torch.float32)
            if i in rows:
                rows[i].copy_(full[row_cut] * scale)
        return out

    return sharding.map_with_path(leaf, shapes)


def params_from_numpy(tree: Dict[str, Any], config: LlamaConfig,
                      device="cuda", *, master: bool = False
                      ) -> Dict[str, Any]:
    """The JAX package's parameter tree (numpy leaves, f32 masters or int8
    ``{"q", "s"}`` leaves from ``quant.quantize_weights``) -> the port's.

    Matmul weights, ``tok_embed`` and ``lm_head`` are stored once in the
    compute dtype.  That is bit-identical to the JAX forward's per-use
    ``astype(compute)`` and halves their memory against f32 masters under
    bf16.  Norm scales stay f32; int8 leaves keep int8 ``q`` and f32 ``s``.
    ``master=True`` keeps every float leaf f32, for training.
    """
    dev = resolve_device(device)
    compute = config.compute_dtype

    def walk(node, name=""):
        if isinstance(node, dict) and "q" in node and "s" in node:
            return {"q": torch.from_numpy(np.array(node["q"], np.int8)).to(
                        dev),
                    "s": torch.from_numpy(np.array(node["s"], np.float32)).to(
                        dev)}
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        arr = torch.from_numpy(np.array(node, dtype=np.float32))
        return arr.to(dev, _leaf_dtype(name, compute, master))

    return walk(tree)


def unstack_layers(layers: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The stacked layer tree as ``n`` per-layer trees of views, by
    ``torch.unbind`` (the body of the JAX ``lax.scan`` over layers becomes a
    Python loop over them).  Its backward stacks the ``n`` layer gradients
    into each leaf's gradient in one pass; indexing one layer at a time
    would scatter each layer's gradient into a zero tensor of the whole
    stack."""
    per_key = {k: (unstack_layers(v, n) if isinstance(v, dict)
                   else torch.unbind(v)) for k, v in layers.items()}
    return [{k: per_key[k][i] for k in per_key} for i in range(n)]


def _rmsnorm(x, scale, eps):
    return rmsnorm(x, scale, eps)


#: The remat policies: "none" saves everything, "full" only each layer's
#: inputs, "attn" also the flash forward's (out, lse), "dots" also the
#: output of every matrix product without batch dims.
REMAT_POLICIES = ("none", "full", "attn", "dots")


def remat_policy(remat) -> str:
    """``remat`` as one of ``REMAT_POLICIES`` (bools and None as the JAX
    ``_remat_wrap`` reads them); raises ``ValueError`` for an unknown
    policy."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "full"):
        return "full"
    if remat in ("attn", "dots"):
        return remat
    raise ValueError(f"unknown remat policy {remat!r}; expected bool, "
                     f"'none', 'full', 'attn' or 'dots'")


def _save_attn(ctx, func, *args, **kwargs):
    """JAX ``save_only_these_names("attn_out")``: the flash forward's
    operator and the ring's (``tj_torch::ring_fwd``), whose outputs (out,
    lse) are the residuals their backward reads, are saved; everything
    else is recomputed (q, k and v too, as in JAX, where they are unnamed
    residuals of the custom VJP).  A saved ring runs none of its shifts
    again."""
    if func is _flash.FWD_OP or func is RING_OP:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


#: Set while a layer computes a product whose output no backward reads
#: (w_down's, which feeds the residual add alone): "dots" leaves it to the
#: recompute, as JAX's partial evaluation drops it.
_UNREAD_PRODUCT = contextvars.ContextVar("unread_product", default=False)


@contextlib.contextmanager
def _unread_product():
    token = _UNREAD_PRODUCT.set(True)
    try:
        yield
    finally:
        _UNREAD_PRODUCT.reset(token)


def _save_dots(ctx, func, *args, **kwargs):
    """JAX ``dots_with_no_batch_dims_saveable``: the outputs of matrix
    products without batch dims (``aten.mm``: the ``x @ W`` of q, k, v, wo,
    w_gate and w_up) are saved; w_down's (``_unread_product``), batched
    products (``aten.bmm``) and the flash forward are recomputed, and the
    recompute stops before w_down's product, which nothing reads."""
    if func is torch.ops.aten.mm.default and not _UNREAD_PRODUCT.get():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE = {"attn": _save_attn, "dots": _save_dots}


def _remat_wrap(block, remat):
    """The JAX ``_remat_wrap`` (``llama.py:164-191``) through
    ``torch.utils.checkpoint``: "none" returns ``block``; "full" saves only
    the layer's inputs, and the backward re-runs the whole layer, its
    kernels included; "attn" and "dots" re-run the layer but keep what
    their policy saves (``_save_attn``, ``_save_dots``), by selective
    checkpointing."""
    policy = remat_policy(remat)
    if policy == "none":
        return block
    context_fn = noop_context_fn
    if policy in _SAVE:
        context_fn = partial(create_selective_checkpoint_contexts,
                             _SAVE[policy])

    def wrapped(*args):
        return checkpoint(block, *args, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


def _rope_tables(positions: torch.Tensor, d: int, theta: float,
                 dtype: torch.dtype):
    """cos and sin [B, T, 1, d/2] for ``positions`` [B, T], cast to
    ``dtype``.  Frequencies are exp(-log(theta) * i / d) in f32 (not
    theta ** (...), which differs in the last ulp).  Every layer of a step
    shares one pair of tables."""
    freqs = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                   device=positions.device)
                      * -math.log(theta) / d)
    angles = positions[:, :, None].float() * freqs[None, None, :]
    return (torch.cos(angles)[:, :, None, :].to(dtype),
            torch.sin(angles)[:, :, None, :].to(dtype))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs x[..., 0::2], x[..., 1::2] (not the
    half-split layout); x: [B, T, H, D]."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Rotary embedding; x: [B, T, H, D], positions [B, T].  cos and sin
    are cast to x's dtype before the products, as in the JAX package."""
    return _apply_rope(x, *_rope_tables(positions, x.shape[-1], theta,
                                        x.dtype))


def _weight(layer, compute, mesh, specs):
    """``weight(group, name, keep=("tp", "pp"))``: the layer's
    ``[group][name]`` weight cast to the compute dtype and, with a
    ``mesh``, gathered over every axis of its spec but those in ``keep``
    (its contiguous tp columns or rows, and an expert leaf's ep block,
    stay this rank's; a stage's layers are split on pp, so their
    gradients are not summed over it).
    Under remat the backward's re-run gathers again."""
    def weight(group, name, keep=("tp", "pp")):
        w = layer[group][name]
        if mesh is None:
            return w.to(compute)
        return gather(w, specs[name], mesh, compute, keep=keep)
    return weight


def _attention(h, layer, cos, sin, c, mesh=None, specs=None, ring=False):
    """The pre-normed attention sub-layer of a decoder layer (Llama's and
    the MoE family's): returns (h + attention(h), k, v).  With a ``mesh``,
    q, k and v keep this rank's tp heads, the flash kernel runs on them
    (JAX's ``flash_attention_sharded``: this rank's rows, its heads), and
    wo's product is summed over tp.  With ``ring`` (sequence parallel)
    h is this rank's sequence block, and attention is ring attention over
    sp (JAX's ``ring_attention_sharded``)."""
    compute = c.compute_dtype
    B, T = h.shape[:2]
    tp = 1 if mesh is None else mesh.size("tp")
    weight = _weight(layer, compute, mesh, specs)
    x = _rmsnorm(h, layer["attn_norm"], c.norm_eps)
    if mesh is not None:
        x = copy_to_tp(x, mesh)
    q = (x @ weight("attn", "wq")).view(B, T, c.n_heads // tp, c.head_dim)
    k = (x @ weight("attn", "wk")).view(B, T, c.n_kv_heads // tp,
                                        c.head_dim)
    v = (x @ weight("attn", "wv")).view(B, T, c.n_kv_heads // tp,
                                        c.head_dim)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    if ring:
        o = ring_attention(q, k, v, mesh, causal=True)
    else:
        o = flash_attention(q, k, v, causal=True, window=c.sliding_window)
    y = o.reshape(B, T, c.dim // tp) @ weight("attn", "wo")
    if mesh is not None:
        y = reduce_from_tp(y, mesh)
    return h + y, k, v


def _block(h, layer, cos, sin, c: LlamaConfig, mesh=None, specs=None,
           ring=False):
    """One decoder layer: attention then MLP, each pre-normed and added to
    the residual stream h [B, T, D]; returns (h, k, v).

    With a ``mesh`` the layer's leaves are this rank's blocks, and each
    weight is cast to the compute dtype and gathered over fsdp here, at its
    use (``_weight``).  Tensor parallel: q, k, v, w_gate and w_up keep
    their tp columns (this rank's contiguous heads and ffn columns), wo
    and w_down their tp rows, and the products of wo and w_down are summed
    over tp.  ``ring``: ring attention over sp (``_attention``)."""
    h, k, v = _attention(h, layer, cos, sin, c, mesh, specs, ring)
    weight = _weight(layer, c.compute_dtype, mesh, specs)
    x = _rmsnorm(h, layer["mlp_norm"], c.norm_eps)
    if mesh is not None:
        x = copy_to_tp(x, mesh)
    gate = F.silu(x @ weight("mlp", "w_gate"))
    up = x @ weight("mlp", "w_up")
    with _unread_product():
        down = (gate * up) @ weight("mlp", "w_down")
        if mesh is not None:
            down = reduce_from_tp(down, mesh)
    return h + down, k, v


def _whole(params, name, mesh, specs, dtype=None):
    """A top-level leaf whole on every rank: cast to ``dtype`` where given
    and, with a mesh, gathered on all its axes (``tok_embed`` and
    ``lm_head`` over tp and fsdp; the final norm scale is replicated)."""
    x = params[name]
    if mesh is None:
        return x if dtype is None else x.to(dtype)
    return gather(x, specs[name], mesh, dtype)


def layer_specs(shapes, rules, mesh) -> Dict[str, Any]:
    """The fitted spec of each leaf of a tree of global ``shapes`` on
    ``mesh`` under ``rules``, by the leaf's name: top-level leaves as they
    are stored, layer leaves as one layer's slice (the stacked spec
    without its layer entry; a layer norm scale is replicated either
    way)."""
    from trainingjob_operator_tpu_torch.parallel import sharding

    specs = {}
    for path, shape in sharding.tree_paths(shapes):
        spec = sharding.leaf_spec(path, shape, rules, mesh)
        name = path.rsplit("/", 1)[-1]
        specs[name] = spec[1:] if path.startswith("layers/") and \
            not name.endswith("norm") else spec
    return specs


def mesh_specs(config: LlamaConfig, mesh) -> Dict[str, Any]:
    """``layer_specs`` of the Llama tree under ``mesh_rules``."""
    return layer_specs(param_shapes(config), mesh_rules(mesh), mesh)


def choose_microbatches(batch: int, target: int, n_data: int,
                        n_stages: int, explicit: bool) -> int:
    """Pick the GPipe microbatch count M (JAX's ``choose_microbatches``).

    M must divide ``batch``.  With an EXPLICIT request (``n_microbatches``
    arg or LLAMA_PP_MICROBATCH) the largest divisor <= the request wins,
    period -- the user's bubble/memory trade is not second-guessed.  For
    the default, prefer an M whose microbatch tiles the data axes
    (``(batch/M) % n_data == 0`` -- the condition for the Pallas kernel on
    the pp path, flash_attention_pp) but only when the relative schedule
    cost (M+S-1)/M stays within 15%: a kernel's step win pays for a
    modestly deeper bubble but never for a collapsed pipeline (e.g. M 8 ->
    1 is a 75% bubble at pp=4).
    """
    divs = [d for d in range(1, min(target, batch) + 1) if batch % d == 0]
    m0 = max(divs)
    if explicit:
        return m0
    flashable = [d for d in divs if (batch // d) % n_data == 0]
    if flashable:
        f = max(flashable)
        s = n_stages
        if (f + s - 1) / f <= 1.15 * (m0 + s - 1) / m0:
            return f
    return m0


def pipeline_microbatches(local_batch: int, mesh,
                          n_microbatches: Optional[int] = None):
    """(M, M_jax): the pipeline's microbatches of ``local_batch`` rows on
    ``mesh``, and JAX's for the global batch of ``local_batch`` x the data
    size.  The request is ``n_microbatches``, else LLAMA_PP_MICROBATCH,
    else JAX's default 8 (S - 1) (bubble about 11%), and
    ``choose_microbatches`` picks M_jax as JAX does.  The port's
    microbatches split each rank's own rows, so where M_jax does not
    divide them the port takes the largest M below it that does (JAX's
    ``flash_attention_pp`` condition fails there, and JAX splits the
    global batch instead)."""
    S = mesh.size("pp")
    explicit = n_microbatches is not None
    if n_microbatches is None:
        env_m = int(os.environ.get("LLAMA_PP_MICROBATCH", "0") or 0)
        explicit = env_m > 0
        n_microbatches = env_m or 8 * (S - 1)
    n_data = mesh.data_size()
    m_jax = choose_microbatches(local_batch * n_data, n_microbatches,
                                n_data, S, explicit)
    m = max(d for d in range(1, m_jax + 1) if local_batch % d == 0)
    return m, m_jax


def _pipelined(mesh) -> bool:
    return mesh is not None and mesh.size("pp") > 1


def _last_stage(mesh) -> bool:
    """Whether this rank computes the head: always without a pipeline,
    on the last stage under one."""
    return not _pipelined(mesh) or mesh.coord("pp") == mesh.size("pp") - 1


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            config: LlamaConfig, *, remat=False, return_kv: bool = False,
            return_hidden: bool = False, mesh=None,
            sequence_parallel: bool = False,
            n_microbatches: Optional[int] = None):
    """Logits for tokens [B, T] -> [B, T, vocab] f32.

    With ``return_kv`` returns ``(logits, (k, v))``, k/v the post-rope
    per-layer projections stacked [L, B, T, Hkv, Dh] (the decode prefill
    reuses this forward).  With ``return_hidden`` returns the final-norm
    hidden states [B, T, D] instead of logits.  The residual stream stays in
    the compute dtype; attention is the flash kernel on the card.  ``remat``
    is one of ``REMAT_POLICIES`` (``_remat_wrap``).

    With a ``mesh`` (``parallel/mesh.py``) ``params`` holds this rank's
    blocks (``init_params(mesh=...)``) and ``tokens`` its rows: each layer
    gathers its weights inside its block (``_block``), ``tok_embed`` and
    ``lm_head`` are gathered whole, and the flash kernel runs on this
    rank's heads.

    With ``sequence_parallel`` (and a mesh) ``tokens`` is this rank's
    sequence block of the rows (``sharding.sequence_block``): the rope
    positions carry the block's offset, and attention is ring attention
    over sp.  With pp > 1 on the mesh the layer stack runs as a GPipe
    pipeline over the stages (``parallel/pipeline.py``), in
    ``pipeline_microbatches(B, mesh, n_microbatches)`` microbatches;
    only the last stage has logits.  Any other stage returns a zero f32
    scalar, the stand-in for its loss, which touches its pipeline output
    and the head leaves (``final_norm``, ``lm_head``): their gradients,
    zero here, are summed over pp with the last stage's, so every rank
    runs the same collectives in the backward.

    JAX's refusals, with its types and messages: ``sliding_window`` and
    ``return_kv`` with sequence parallelism, ``return_kv`` under a
    pipeline; the port refuses ``return_kv`` with any mesh.
    """
    c = config
    compute = c.compute_dtype
    B, T = tokens.shape
    if sequence_parallel and c.sliding_window:
        raise ValueError("sliding_window is not supported with "
                         "sequence_parallel (ring attention is the "
                         "full-context long path)")
    if return_kv and sequence_parallel:
        raise ValueError("return_kv is not supported with sequence_parallel")
    if return_kv and _pipelined(mesh):
        raise ValueError("return_kv is not supported under pipeline "
                         "parallelism (stage-sharded layers)")
    ring = (sequence_parallel and mesh is not None
            and "sp" in mesh.axis_names)
    specs = None
    layers = params["layers"]
    if mesh is not None:
        if return_kv:
            raise ValueError("return_kv is not supported with a mesh")
        check_tp(c, mesh.size("tp"))
        check_pp(c, mesh.size("pp"))
        specs = mesh_specs(c, mesh)
        # The norm scales are replicated but for a stage's layers: one
        # gradient all-reduce over the summed axes for each stacked leaf.
        layers = {**layers, **{name: gather(layers[name], specs[name], mesh,
                                            keep=("pp",))
                               for name in ("attn_norm", "mlp_norm")}}
    h = _whole(params, "tok_embed", mesh, specs, compute)[tokens]
    offset = mesh.coord("sp") * T if ring else 0
    pos = torch.arange(offset, offset + T, device=tokens.device)[None, :]
    if not _pipelined(mesh):
        # A pipeline's microbatches take fewer rows: one row of tables
        # broadcasts over them.
        pos = pos.expand(B, T)
    cos, sin = _rope_tables(pos, c.head_dim, c.rope_theta, compute)
    block = _remat_wrap(_block, remat)
    per_layer = unstack_layers(layers, layers["attn_norm"].shape[0])
    ks, vs = [], []
    if _pipelined(mesh):
        m, _ = pipeline_microbatches(B, mesh, n_microbatches)
        h = gpipe(lambda hh, layer: block(hh, layer, cos, sin, c, mesh,
                                          specs, ring)[0],
                  per_layer, h, mesh, m)
    else:
        for layer in per_layer:
            h, k, v = block(h, layer, cos, sin, c, mesh, specs, ring)
            if return_kv:
                ks.append(k)
                vs.append(v)
    final_norm = _whole(params, "final_norm", mesh, specs)
    if not _last_stage(mesh):
        return touch(torch.zeros((), dtype=torch.float32, device=h.device),
                     h, final_norm,
                     _whole(params, "lm_head", mesh, specs, compute))
    h = _rmsnorm(h, final_norm, c.norm_eps)
    if return_hidden:
        return h
    logits = (h @ _whole(params, "lm_head", mesh, specs, compute)).float()
    if return_kv:
        return logits, (torch.stack(ks), torch.stack(vs))
    return logits


def _chunked_ce(h, lm_head, targets, chunk: int, compute):
    """Next-token CE without the full [B, T, vocab] logits (JAX
    ``_chunked_ce``, ``llama.py:413-441``): each ``chunk``-long sequence
    slice computes its f32 logits and summed CE under a checkpoint, so one
    chunk's logits are alive at a time in the forward and the backward.
    The sum over chunks is divided by B * T."""
    B, T, _ = h.shape

    def body(hh, tt, w):
        logits = (hh @ w.to(compute)).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tt.reshape(-1), reduction="sum")

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(T // chunk):
        cols = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(body, h[:, cols], targets[:, cols],
                                   lm_head, use_reentrant=False)
    return total / (B * T)


def loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
            config: LlamaConfig, *, remat=False, ce_chunk: int = 0,
            mesh=None, sequence_parallel: bool = False,
            n_microbatches: Optional[int] = None):
    """Next-token cross-entropy, a scalar f32 tensor; batch: {"tokens":
    [B, T+1]}.  The CE is optax's ``softmax_cross_entropy_with_integer_
    labels`` on f32 logits, averaged over B * T.

    ``ce_chunk`` > 0 (dividing T) computes the head and CE in sequence
    chunks (``_chunked_ce``); a chunk that does not divide T raises rather
    than silently falling back to the whole logits.

    With a ``mesh`` the batch is this rank's rows and the loss is the
    global one: each rank's mean over its tokens, divided by the number of
    ranks holding other tokens (the data size times sp) and summed over
    the summed axes (``sum_over_data``), whose backward leaves each rank
    the gradient of its own tokens for the leaves' collectives to sum.
    With ``sequence_parallel`` each rank takes its sequence block of the
    rows (``sharding.sequence_block``; JAX refuses ``ce_chunk`` there).
    Under a pipeline the last stage's loss is summed with the other
    stages' zero stand-ins (``forward``)."""
    c = config
    tokens = batch["tokens"]
    if sequence_parallel and ce_chunk:
        raise ValueError("ce_chunk is not supported with "
                         "sequence_parallel (logits are seq-sharded)")
    if sequence_parallel and mesh is not None:
        inputs, targets = sequence_block(tokens, mesh)
    else:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    targets = targets.long()
    T = inputs.shape[1]
    run = partial(forward, params, inputs, c, remat=remat, mesh=mesh,
                  sequence_parallel=sequence_parallel,
                  n_microbatches=n_microbatches)
    if not _last_stage(mesh):
        loss = run()
    elif ce_chunk:
        if T % ce_chunk != 0:
            raise ValueError(f"ce_chunk={ce_chunk} does not divide seq {T}")
        h = run(return_hidden=True)
        lm_head = params["lm_head"]
        if mesh is not None:
            lm_head = _whole(params, "lm_head", mesh, mesh_specs(c, mesh),
                             c.compute_dtype)
        loss = _chunked_ce(h, lm_head, targets, ce_chunk, c.compute_dtype)
    else:
        logits = run()
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               targets.reshape(-1))
    if mesh is None:
        return loss
    return sum_over_data(loss / (mesh.data_size() * mesh.size("sp")), mesh)


def num_params(config: LlamaConfig) -> int:
    c = config
    kv_dim = c.n_kv_heads * c.head_dim
    per_layer = (c.dim * c.dim * 2 + c.dim * kv_dim * 2
                 + c.dim * c.ffn_dim * 3 + 2 * c.dim)
    return c.vocab_size * c.dim * 2 + c.n_layers * per_layer + c.dim
