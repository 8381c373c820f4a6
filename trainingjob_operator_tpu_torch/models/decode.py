"""Autoregressive decoding for the Llama family: KV cache + sampling.

Port of the JAX package's ``models/decode.py``.  The cache is
``{"k", "v"}`` of [L, B, S, Hkv, Dh] -- ``S`` = ``max_len`` for full causal
attention, a RING of ``window`` slots under a sliding window (slot =
position % S) -- and visibility is decided per slot from positions, as in
the JAX package.

Two differences from the JAX functions, both deliberate:

- The ``lax.scan`` over layers is a Python loop over the stacked leaves.
- The cache is updated IN PLACE: ``decode_step``, ``serve_step``,
  ``prefill_chunk`` and ``reset_slot`` write into the tensors they are
  given and return the same dict.  ``DecodeService`` already treats the
  cache as donated (it rebinds it to each call's result), so in place
  saves a second copy of the plane's largest tensor.

The decode attentions (``_attend_cache``, ``_attend_cache_block``) are
plain PyTorch, as they are plain XLA in the JAX package; RMSNorm in every
layer, and the flash attention of the prefill forward, are the CUDA
kernels on the card.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from trainingjob_operator_tpu_torch import resolve_device
from trainingjob_operator_tpu_torch.models import llama
from trainingjob_operator_tpu_torch.models.quant import (
    dequantize_rows,
    qmatmul,
    quantize_weights,
)


def cache_len(config: llama.LlamaConfig, max_len: int) -> int:
    """``max_len`` for full causal attention, min(max_len, window) under a
    sliding window (the cache is then a ring)."""
    w = config.sliding_window
    return min(max_len, w) if w else max_len


def pack_cache(k: torch.Tensor, v: torch.Tensor, config: llama.LlamaConfig,
               max_len: int) -> Dict[str, torch.Tensor]:
    """Stacked per-layer K/V from prefill ([L, B, T, Hkv, Dh]) -> the cache
    dict, ring-packed when the window cache is smaller than ``max_len``
    (the last min(T, S) positions at slot = position % S)."""
    dtype = config.compute_dtype
    T = k.shape[2]
    S = cache_len(config, max_len)
    if S < max_len:
        keep = min(T, S)
        kk, vv = k[:, :, T - keep:], v[:, :, T - keep:]
        pad = (0, 0, 0, 0, 0, S - keep)
        kk, vv = F.pad(kk, pad), F.pad(vv, pad)
        # Array index i holds position T - keep + i; its slot is that
        # position mod S: a cyclic shift by (T - keep) % S.
        shift = (T - keep) % S
        return {"k": torch.roll(kk, shift, dims=2).to(dtype),
                "v": torch.roll(vv, shift, dims=2).to(dtype)}
    pad = (0, 0, 0, 0, 0, max_len - T)
    return {"k": F.pad(k, pad).to(dtype), "v": F.pad(v, pad).to(dtype)}


def init_cache(config: llama.LlamaConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed KV cache: k/v of [L, B, cache_len, Hkv, Dh]."""
    dev = resolve_device(device)
    c = config
    dtype = dtype or c.compute_dtype
    shape = (c.n_layers, batch, cache_len(c, max_len), c.n_kv_heads,
             c.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _attend_cache(q, keys, values, t, group: int, window: int = 0):
    """q: [B, 1, Hq, Dh] vs cache [B, S, Hkv, Dh] -> [B, 1, Hq, Dh] f32.

    Full mode: slot == position, slots <= t visible.  Ring mode: slot s
    holds position p = t - ((t - s) mod S), visible iff p >= 0 and
    p > t - window.  ``t`` is an int (whole batch at one position) or a
    [B, 1, 1, 1] tensor of per-row positions.  f32 scores, -inf mask,
    f32 softmax."""
    B, S, Hkv, Dh = keys.shape
    qh = q.reshape(B, Hkv, group, Dh).float()
    kh = keys.transpose(1, 2).float()                       # [B,Hkv,S,Dh]
    vh = values.transpose(1, 2).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qh, kh) * (Dh ** -0.5)
    slots = torch.arange(S, device=keys.device)[None, None, None, :]
    if window:
        pos = t - torch.remainder(t - slots, S)
        mask = (pos >= 0) & (pos > t - window)
    else:
        mask = slots <= t
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs, vh)
    return out.reshape(B, 1, Hkv * group, Dh)


def prefill(params, tokens: torch.Tensor, config: llama.LlamaConfig,
            max_len: int):
    """Run the prompt [B, T] through the training ``forward`` once; returns
    (logits of the LAST position [B, vocab], cache filled for [0, T))."""
    T = tokens.shape[1]
    if T > max_len:
        raise ValueError(f"prompt {T} exceeds max_len {max_len}")
    logits_all, (k, v) = llama.forward(params, tokens, config,
                                       return_kv=True)
    return logits_all[:, -1, :], pack_cache(k, v, config, max_len)


def _layer_tail(h, layer, o, compute, c):
    """Attention output projection + residual, then the MLP block."""
    B, T = h.shape[:2]
    h = h + qmatmul(o.reshape(B, T, c.dim), layer["attn"]["wo"], compute)
    x = llama._rmsnorm(h, layer["mlp_norm"], c.norm_eps)
    gate = F.silu(qmatmul(x, layer["mlp"]["w_gate"], compute))
    up = qmatmul(x, layer["mlp"]["w_up"], compute)
    return h + qmatmul(gate * up, layer["mlp"]["w_down"], compute)


def _qkv(x, layer, rope, compute, c):
    """Projections of the normed input [B, T, D], q and k rotated with the
    step's ``rope`` tables (``llama._rope_tables``)."""
    B, T = x.shape[:2]
    attn = layer["attn"]
    q = qmatmul(x, attn["wq"], compute).view(B, T, c.n_heads, c.head_dim)
    k = qmatmul(x, attn["wk"], compute).view(B, T, c.n_kv_heads, c.head_dim)
    v = qmatmul(x, attn["wv"], compute).view(B, T, c.n_kv_heads, c.head_dim)
    return llama._apply_rope(q, *rope), llama._apply_rope(k, *rope), v


def decode_step(params, cache, token: torch.Tensor, t: int,
                config: llama.LlamaConfig):
    """One token [B] at position ``t`` -> (logits [B, vocab] f32, cache).

    ``params`` may carry weight-only int8 leaves (``quant.qmatmul``).  The
    cache is written in place."""
    c = config
    compute = c.compute_dtype
    B = token.shape[0]
    group = c.n_heads // c.n_kv_heads
    S = cache["k"].shape[2]
    if c.sliding_window:
        slot = t % S
    elif not 0 <= t < S:
        raise ValueError(f"position {t} is outside the cache of {S} slots")
    else:
        slot = t
    h = dequantize_rows(params["tok_embed"], token, compute)[:, None, :]
    pos = torch.full((B, 1), t, dtype=torch.long, device=token.device)
    rope = llama._rope_tables(pos, c.head_dim, c.rope_theta, compute)
    for i, layer in enumerate(llama.unstack_layers(params["layers"],
                                                   c.n_layers)):
        x = llama._rmsnorm(h, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(x, layer, rope, compute, c)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        o = _attend_cache(q, k_cache, v_cache, t, group,
                          window=c.sliding_window).to(compute)
        h = _layer_tail(h, layer, o, compute, c)
    h = llama._rmsnorm(h, params["final_norm"], c.norm_eps)
    logits = qmatmul(h[:, 0, :], params["lm_head"], compute)
    return logits.float(), cache


def serve_step(params, cache, token: torch.Tensor, ts: torch.Tensor,
               config: llama.LlamaConfig):
    """One decode step for a continuous-batching slot batch: tokens [B] at
    per-slot positions ``ts`` [B] -> (logits [B, vocab] f32, cache).

    Each row b writes its K/V at its own position ts[b] and sees slots
    <= ts[b].  Free and mid-prefill rows still step: the scheduler passes
    their next UNWRITTEN position, so their junk K/V lands where admission
    or the next prefill chunk overwrites it.  The write index is clamped to
    the cache as ``dynamic_update_slice`` clamps it (the scheduler never
    passes ts >= S; checking that here would cost a device sync per step).
    """
    c = config
    compute = c.compute_dtype
    B = token.shape[0]
    group = c.n_heads // c.n_kv_heads
    S = cache["k"].shape[2]
    slot = (torch.remainder(ts, S) if c.sliding_window
            else torch.clamp(ts, 0, S - 1))
    rows = torch.arange(B, device=ts.device)
    h = dequantize_rows(params["tok_embed"], token, compute)[:, None, :]
    rope = llama._rope_tables(ts[:, None], c.head_dim, c.rope_theta, compute)
    tb = ts.view(B, 1, 1, 1)
    for i, layer in enumerate(llama.unstack_layers(params["layers"],
                                                   c.n_layers)):
        x = llama._rmsnorm(h, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(x, layer, rope, compute, c)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
        o = _attend_cache(q, k_cache, v_cache, tb, group,
                          window=c.sliding_window).to(compute)
        h = _layer_tail(h, layer, o, compute, c)
    h = llama._rmsnorm(h, params["final_norm"], c.norm_eps)
    logits = qmatmul(h[:, 0, :], params["lm_head"], compute)
    return logits.float(), cache


def _attend_cache_block(q, keys, values, positions, group: int):
    """Chunked-prefill attention for ONE sequence: q [C, Hq, Dh] against
    the cache row [S, Hkv, Dh]; ``positions`` [C] are the queries'
    absolute positions (slots <= position visible)."""
    C = q.shape[0]
    S, Hkv, Dh = keys.shape
    qh = q.reshape(C, Hkv, group, Dh).permute(1, 2, 0, 3)    # [Hkv,g,C,Dh]
    kh = keys.transpose(0, 1).float()                        # [Hkv,S,Dh]
    vh = values.transpose(0, 1).float()
    scores = torch.einsum("hgcd,hsd->hgcs", qh.float(), kh) * (Dh ** -0.5)
    mask = (torch.arange(S, device=keys.device)[None, None, None, :]
            <= positions[None, None, :, None])
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgcs,hsd->hgcd", probs, vh)
    return out.permute(2, 0, 1, 3).reshape(C, Hkv * group * Dh)


def prefill_chunk(params, cache, tokens: torch.Tensor, slot: int, t0: int,
                  config: llama.LlamaConfig):
    """Prefill ONE slot with a fixed-size prompt chunk ``tokens`` [C] at
    positions [t0, t0 + C) of batch row ``slot`` -> (logits [C, vocab] f32,
    cache).  The caller reads the logit at its last valid offset.

    Requires a full-causal cache.  Unlike ``dynamic_update_slice``, which
    CLAMPS a start index past ``S - C`` and so writes the chunk's K/V at
    shifted positions, this raises when the chunk does not fit.
    """
    c = config
    if c.sliding_window:
        raise ValueError("chunked prefill requires a full-causal cache "
                         "(sliding_window == 0): padded chunk positions "
                         "would wrap the ring and clobber live slots")
    compute = c.compute_dtype
    C = tokens.shape[0]
    S = cache["k"].shape[2]
    if t0 < 0 or t0 + C > S:
        raise ValueError(f"chunk [{t0}, {t0 + C}) does not fit the cache "
                         f"of {S} slots")
    group = c.n_heads // c.n_kv_heads
    h = dequantize_rows(params["tok_embed"], tokens, compute)[None, :, :]
    positions = t0 + torch.arange(C, device=tokens.device)
    rope = llama._rope_tables(positions[None, :], c.head_dim, c.rope_theta,
                              compute)
    for i, layer in enumerate(llama.unstack_layers(params["layers"],
                                                   c.n_layers)):
        x = llama._rmsnorm(h, layer["attn_norm"], c.norm_eps)
        q, k, v = _qkv(x, layer, rope, compute, c)
        row_k, row_v = cache["k"][i, slot], cache["v"][i, slot]
        row_k[t0:t0 + C] = k[0].to(row_k.dtype)
        row_v[t0:t0 + C] = v[0].to(row_v.dtype)
        o = _attend_cache_block(q[0], row_k, row_v, positions,
                                group).to(compute)
        h = _layer_tail(h, layer, o[None], compute, c)
    h = llama._rmsnorm(h, params["final_norm"], c.norm_eps)
    logits = qmatmul(h[0], params["lm_head"], compute)
    return logits.float(), cache


def reset_slot(cache, slot: int):
    """Zero ONE batch row's K/V across all layers, in place, so an admitted
    sequence starts from a clean page; survivor rows are untouched."""
    cache["k"][:, slot].zero_()
    cache["v"][:, slot].zero_()
    return cache


def _mask_logits(logits: torch.Tensor, top_k: int,
                 top_p: float) -> torch.Tensor:
    """Outside the top-k ids and/or beyond the top-p nucleus, logits become
    -inf (sort + threshold)."""
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, [-1])
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # Keep the smallest prefix with cumulative prob >= top_p (always
        # keep the first); the cutoff logit is the last kept one.
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, float("-inf")).amax(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def generate(params, prompt: torch.Tensor, config: llama.LlamaConfig, *,
             steps: int, max_len: Optional[int] = None,
             temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
             generator: Optional[torch.Generator] = None,
             quantize: bool = False) -> torch.Tensor:
    """Sample ``steps`` tokens after ``prompt`` [B, T]; returns [B, steps]
    int64 on the prompt's device.

    ``temperature`` 0 is greedy (argmax, first index on ties); otherwise
    ``generator`` drives the sampling and ``top_k``/``top_p`` restrict its
    support.  ``quantize`` runs the decode steps on weight-only int8
    (prefill stays full precision).  Tokens stay on the device; the caller
    copies them once.
    """
    B, T = prompt.shape
    max_len = max_len or (T + steps)
    if T + steps > max_len:
        raise ValueError(f"{T} prompt + {steps} steps > max_len {max_len}")
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a torch.Generator")
    top_k = 0 if top_k >= config.vocab_size else top_k
    top_p = 0.0 if top_p >= 1.0 else top_p
    if (top_k or top_p > 0.0) and temperature <= 0.0:
        raise ValueError("top_k/top_p require temperature > 0 (greedy "
                         "already picks the single best token)")

    logits, cache = prefill(params, prompt, config, max_len)
    step_params = quantize_weights(params) if quantize else params

    def pick(logits):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        # Temperature FIRST: the nucleus must hold top_p of the mass of the
        # distribution actually sampled from.
        logits = _mask_logits(logits / temperature, top_k, top_p)
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=generator)[:, 0]

    token = pick(logits)
    out = [token]
    for i in range(steps - 1):
        logits, cache = decode_step(step_params, cache, token, T + i, config)
        token = pick(logits)
        out.append(token)
    return torch.stack(out, dim=1)
