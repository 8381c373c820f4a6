"""Autoregressive decoding for the MoE family: KV cache + routed experts.

Port of the JAX package's ``models/moe_decode.py``.  The cache, the
attention and the layer loops are ``models/decode.py``'s (the MoE cache
has the Llama cache's layout), run with this module's MLP block
(``routed_mlp``); the whole-prompt ``prefill`` reuses the training
``moe.forward``, so prompt routing cannot drift from what was trained.

Decode, serve and chunked-prefill rows route per token and are dropless;
the whole-prompt prefill dispatches with finite expert capacity and can
drop tokens (``_check_capacity`` warns where the config allows it).

One difference from the JAX functions, deliberate: JAX gathers the chosen
experts' weights per token (``jnp.take``: [B, k, D, F] copies, about 3.8
GB a matrix a layer for a 16-token chunk at Mixtral width).
``_routed_mlp_token`` instead groups the rows by expert and runs each
chosen expert's three products on its weights in place, then adds the
gated outputs in JAX's order over k: the same row products, batched
otherwise.

While a profiler records, each ``_routed_mlp_token`` call runs under two
ranges, ``moe.route`` (the router up to the host read of the per-expert
counts) and ``moe.experts`` (the expert products and the gated sum).
Every call adds to two counters of ``utils.metrics.METRICS``:
``moe_decode_pairs`` (rows x k) and ``moe_decode_experts_reached``
(experts with a pair).
"""

from __future__ import annotations

import contextlib
import warnings
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from trainingjob_operator_tpu_torch.models import decode, llama, moe
from trainingjob_operator_tpu_torch.utils.metrics import METRICS


def _check_capacity(config: moe.MoEConfig) -> None:
    """Warn when prefill can drop tokens that decode would keep: the JAX
    package's warning, word for word.

    Prefill runs the training dispatch, whose per-expert capacity is
    ``capacity_factor * k * T / E`` slots; decode's per-token routing is
    dropless.  Whenever ``capacity_factor < E / k`` a skewed router can
    overflow an expert at prefill while the same tokens, decoded one at a
    time, would get their full top-k mix."""
    c = config
    threshold = c.n_experts / c.experts_per_token
    if c.capacity_factor < threshold:
        warnings.warn(
            f"capacity_factor={c.capacity_factor} < n_experts/"
            f"experts_per_token={threshold:g}: prefill may drop tokens "
            f"that the dropless decode path would route, so prompt "
            f"representations can differ between prefill and decode",
            RuntimeWarning, stacklevel=3)


def prefill(params, tokens: torch.Tensor, config: moe.MoEConfig,
            max_len: int):
    """Prompt [B, T] -> (last-position logits [B, vocab] f32, cache filled
    for [0, T)), through the training ``moe.forward`` (``return_kv``)."""
    T = tokens.shape[1]
    if T > max_len:
        raise ValueError(f"prompt {T} exceeds max_len {max_len}")
    _check_capacity(config)
    logits_all, _aux, (k, v) = moe.forward(params, tokens, config,
                                           return_kv=True)
    return logits_all[:, -1, :], decode.pack_cache(k, v, config, max_len)


def _range(name: str):
    """``record_function(name)`` while a profiler records, else nothing: a
    range costs about 10 us of host time even when no profiler records,
    and a tick that carries a chunk opens 64 of them."""
    if torch._C._autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


def _routed_mlp_token(x: torch.Tensor, layer, config: moe.MoEConfig,
                      compute: torch.dtype) -> torch.Tensor:
    """Top-k routed expert MLP for single-token rows x [N, 1, D] ->
    [N, 1, D].

    The f32 router picks each row's top k (stable descending sort: lower
    index first on ties, as ``jax.lax.top_k``) and renormalises their
    gates.  The (row, choice) pairs are grouped by expert; each expert some
    row chose runs its three products on those rows against its own
    weights (read once, never copied), and the outputs land at their
    pairs.  The gated sum over k is then the JAX einsum.  One host read a
    call: the per-expert pair counts, which also feed the counters."""
    c = config
    N, k = x.shape[0], c.experts_per_token
    xf = x[:, 0]                                            # [N, D]
    w = layer["moe"]
    with _range("moe.route"):
        probs = torch.softmax(xf.float() @ w["router"], dim=-1)
        top = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = top.values[:, :k], top.indices[:, :k]
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        pairs = idx.reshape(-1)                             # row * k + j
        order = torch.argsort(pairs, stable=True)
        counts = torch.bincount(pairs, minlength=c.n_experts).tolist()
    METRICS.inc("moe_decode_pairs", N * k)
    METRICS.inc("moe_decode_experts_reached", sum(1 for n in counts if n))
    with _range("moe.experts"):
        y = xf.new_empty((N * k, c.dim))
        for e, chosen in enumerate(torch.split(order, counts)):
            if not counts[e]:
                continue
            xe = xf[chosen // k]
            gate = F.silu(xe @ w["w_gate"][e].to(compute))
            up = xe @ w["w_up"][e].to(compute)
            y[chosen] = (gate * up) @ w["w_down"][e].to(compute)
        y = torch.einsum("nkd,nk->nd", y.view(N, k, c.dim),
                         gates.to(compute))
    return y[:, None, :]


def routed_mlp(h: torch.Tensor, layer, compute: torch.dtype,
               c: moe.MoEConfig) -> torch.Tensor:
    """The MoE block of the residual stream h [B, T, D] for the decode
    loops (``decode.dense_mlp``'s counterpart): pre-norm, then every token
    routed on its own (``_routed_mlp_token``, the JAX chunk's [1, C, D] ->
    [C, 1, D] fold)."""
    x = llama._rmsnorm(h, layer["moe_norm"], c.norm_eps)
    B, T, D = x.shape
    return _routed_mlp_token(x.reshape(B * T, 1, D), layer, c,
                             compute).view(B, T, D)


#: ``decode.decode_step``, ``serve_step`` and ``prefill_chunk`` with the
#: routed MLP block: the same contracts (the cache written in place; a
#: chunk past the cache end raises where JAX's ``dynamic_update_slice``
#: would clamp it).
decode_step = partial(decode.decode_step, mlp=routed_mlp)
serve_step = partial(decode.serve_step, mlp=routed_mlp)
prefill_chunk = partial(decode.prefill_chunk, mlp=routed_mlp)


def generate(params, prompt: torch.Tensor, config: moe.MoEConfig, *,
             steps: int, max_len: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sample ``steps`` tokens after ``prompt`` [B, T]; returns [B, steps]
    int64 on the prompt's device.  The sampling surface of
    ``decode.generate`` (no weight-only int8 for this family)."""
    T = prompt.shape[1]
    max_len, top_k, top_p = decode.sampling_args(
        config, T, steps, max_len, temperature, top_k, top_p, generator)
    logits, cache = prefill(params, prompt, config, max_len)
    return decode.sample(logits, cache,
                         lambda cache, token, t: decode_step(
                             params, cache, token, t, config),
                         T, steps, temperature, top_k, top_p, generator)
