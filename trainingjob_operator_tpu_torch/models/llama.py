"""Llama-2 family for the PyTorch port: config, parameters, forward, loss.

Port of the JAX package's ``models/llama.py`` (single-device path: no mesh,
pipeline or sequence parallelism; remat "none" and "full").  The parameter
tree keeps the JAX layout -- a nested dict with stacked ``[L, in, out]``
layer leaves and ``x @ W`` products, under the same key paths as the JAX
``init_params`` -- so a JAX parameter tree carries across leaf for leaf
(``params_from_numpy``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.ops import flash_attention, rmsnorm

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


def _leaf_dtype(name: str, compute: torch.dtype,
                master: bool = False) -> torch.dtype:
    # Matmul weights, tok_embed and lm_head live in the compute dtype; norm
    # scales stay f32.  Training keeps every leaf an f32 master.
    if not master and (name in MATMUL_LEAVES
                       or name in ("tok_embed", "lm_head")):
        return compute
    return torch.float32


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cuda", *, master: bool = False) -> Dict[str, Any]:
    """Seeded random init on ``device``, same tree and scales as the JAX
    ``init_params`` (normal * in_dim ** -0.5; embeddings and head * 0.02;
    norms 1).  The numbers differ from JAX's (another generator).  Leaves
    are drawn in f32 one layer at a time and stored in their leaf dtype, so
    the peak is one f32 layer slice, not an f32 copy of the model.

    ``master=True`` keeps every leaf f32, as the JAX package keeps its
    parameters for training: ``forward`` casts each to the compute dtype
    where it is used, and the gradient reaches the f32 leaf through that
    cast."""
    dev = resolve_device(device)
    c = config
    compute = c.compute_dtype
    kv_dim = c.n_kv_heads * c.head_dim

    def dense(name, shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        out = torch.empty(shape, dtype=_leaf_dtype(name, compute, master),
                          device=dev)
        rows = out if len(shape) == 3 else out[None]
        for row in rows:
            row.copy_(torch.randn(row.shape, generator=generator,
                                  device=dev, dtype=torch.float32) * scale)
        return out

    L = c.n_layers
    return {
        "tok_embed": dense("tok_embed", (c.vocab_size, c.dim), 0.02),
        "layers": {
            "attn": {
                "wq": dense("wq", (L, c.dim, c.dim)),
                "wk": dense("wk", (L, c.dim, kv_dim)),
                "wv": dense("wv", (L, c.dim, kv_dim)),
                "wo": dense("wo", (L, c.dim, c.dim)),
            },
            "mlp": {
                "w_gate": dense("w_gate", (L, c.dim, c.ffn_dim)),
                "w_up": dense("w_up", (L, c.dim, c.ffn_dim)),
                "w_down": dense("w_down", (L, c.ffn_dim, c.dim)),
            },
            "attn_norm": torch.ones((L, c.dim), dtype=torch.float32,
                                    device=dev),
            "mlp_norm": torch.ones((L, c.dim), dtype=torch.float32,
                                   device=dev),
        },
        "final_norm": torch.ones((c.dim,), dtype=torch.float32, device=dev),
        "lm_head": dense("lm_head", (c.dim, c.vocab_size), 0.02),
    }


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


#: Remat policies of the JAX package that are not ported yet, with the
#: ROADMAP.md item that ports them.
UNPORTED_REMAT = {"attn": "queue 1 item 2a", "dots": "queue 1 item 2a"}


def remat_policy(remat) -> str:
    """``remat`` as "none" or "full" (bools and None as the JAX
    ``_remat_wrap`` reads them); raises ``ValueError`` for "attn" and
    "dots", which are not ported, and for an unknown policy."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "full"):
        return "full"
    if remat in UNPORTED_REMAT:
        raise ValueError(f"remat policy {remat!r} is not ported yet "
                         f"(ROADMAP.md {UNPORTED_REMAT[remat]}); use 'none' "
                         f"or 'full'")
    raise ValueError(f"unknown remat policy {remat!r}; expected bool, "
                     f"'none', 'full', 'attn' or 'dots'")


def _remat_wrap(block, remat):
    """The JAX ``_remat_wrap`` (``llama.py:164-191``) for "none" (save
    everything) and "full" (save only the layer's inputs; the backward
    re-runs the whole layer, its kernels included) through
    ``torch.utils.checkpoint``."""
    if remat_policy(remat) == "none":
        return block

    def wrapped(*args):
        return checkpoint(block, *args, use_reentrant=False)

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


def _block(h, layer, cos, sin, c: LlamaConfig):
    """One decoder layer: attention then MLP, each pre-normed and added to
    the residual stream h [B, T, D]; returns (h, k, v)."""
    compute = c.compute_dtype
    B, T = h.shape[:2]
    attn, mlp = layer["attn"], layer["mlp"]
    x = _rmsnorm(h, layer["attn_norm"], c.norm_eps)
    q = (x @ attn["wq"].to(compute)).view(B, T, c.n_heads, c.head_dim)
    k = (x @ attn["wk"].to(compute)).view(B, T, c.n_kv_heads, c.head_dim)
    v = (x @ attn["wv"].to(compute)).view(B, T, c.n_kv_heads, c.head_dim)
    q = _apply_rope(q, cos, sin)
    k = _apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=True, window=c.sliding_window)
    h = h + o.reshape(B, T, c.dim) @ attn["wo"].to(compute)
    x = _rmsnorm(h, layer["mlp_norm"], c.norm_eps)
    gate = F.silu(x @ mlp["w_gate"].to(compute))
    up = x @ mlp["w_up"].to(compute)
    return h + (gate * up) @ mlp["w_down"].to(compute), k, v


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            config: LlamaConfig, *, remat=False, return_kv: bool = False,
            return_hidden: bool = False):
    """Logits for tokens [B, T] -> [B, T, vocab] f32.

    With ``return_kv`` returns ``(logits, (k, v))``, k/v the post-rope
    per-layer projections stacked [L, B, T, Hkv, Dh] (the decode prefill
    reuses this forward).  With ``return_hidden`` returns the final-norm
    hidden states [B, T, D] instead of logits.  The residual stream stays in
    the compute dtype; attention is the flash kernel on the card.  ``remat``
    is "none" or "full" (``_remat_wrap``).
    """
    c = config
    compute = c.compute_dtype
    B, T = tokens.shape
    h = params["tok_embed"].to(compute)[tokens]
    pos = torch.arange(T, device=tokens.device)[None, :].expand(B, T)
    cos, sin = _rope_tables(pos, c.head_dim, c.rope_theta, compute)
    block = _remat_wrap(_block, remat)
    ks, vs = [], []
    for layer in unstack_layers(params["layers"], c.n_layers):
        h, k, v = block(h, layer, cos, sin, c)
        if return_kv:
            ks.append(k)
            vs.append(v)
    h = _rmsnorm(h, params["final_norm"], c.norm_eps)
    if return_hidden:
        return h
    logits = (h @ params["lm_head"].to(compute)).float()
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
            config: LlamaConfig, *, remat=False, ce_chunk: int = 0):
    """Next-token cross-entropy, a scalar f32 tensor; batch: {"tokens":
    [B, T+1]}.  The CE is optax's ``softmax_cross_entropy_with_integer_
    labels`` on f32 logits, averaged over B * T.

    ``ce_chunk`` > 0 (dividing T) computes the head and CE in sequence
    chunks (``_chunked_ce``); a chunk that does not divide T raises rather
    than silently falling back to the whole logits."""
    c = config
    tokens = batch["tokens"]
    T = tokens.shape[1] - 1
    targets = tokens[:, 1:].long()
    if ce_chunk:
        if T % ce_chunk != 0:
            raise ValueError(f"ce_chunk={ce_chunk} does not divide seq {T}")
        h = forward(params, tokens[:, :-1], c, remat=remat,
                    return_hidden=True)
        return _chunked_ce(h, params["lm_head"], targets, ce_chunk,
                           c.compute_dtype)
    logits = forward(params, tokens[:, :-1], c, remat=remat)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def num_params(config: LlamaConfig) -> int:
    c = config
    kv_dim = c.n_kv_heads * c.head_dim
    per_layer = (c.dim * c.dim * 2 + c.dim * kv_dim * 2
                 + c.dim * c.ffn_dim * 3 + 2 * c.dim)
    return c.vocab_size * c.dim * 2 + c.n_layers * per_layer + c.dim
