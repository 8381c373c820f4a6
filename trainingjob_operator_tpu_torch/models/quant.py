"""Weight-only int8 quantization for serving (the TRAININGJOB_SERVE_QUANT
path).

Port of the JAX package's ``models/quant.py``: symmetric int8 with f32
scales per OUTPUT channel for matmul weights and ``lm_head`` (scale kept
``[..., 1, out]``, applied after the accumulate), per ROW for
``tok_embed``.  Quantized leaves are ``{"q": int8, "s": f32}`` dicts;
``torch.round`` rounds half to even like ``jnp.round``, so ``q`` and ``s``
match the JAX package bit for bit on the same f32 weights.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from trainingjob_operator_tpu_torch.models.llama import MATMUL_LEAVES


def _is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf


def _quantize_leaf(w: torch.Tensor, dim: int) -> Dict[str, torch.Tensor]:
    """Symmetric int8 over ``dim`` (the reduction dim), in f32."""
    wf = w.float()
    s = torch.amax(torch.abs(wf), dim=dim, keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-12)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_weights(params: Dict[str, Any]) -> Dict[str, Any]:
    """Param tree -> same structure with matmul weights, lm_head and
    tok_embed as ``{"q": int8, "s": f32}``; norms untouched."""

    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if name in MATMUL_LEAVES or name == "lm_head":
            return _quantize_leaf(node, dim=-2)
        if name == "tok_embed":
            return _quantize_leaf(node, dim=-1)
        return node

    return walk(params)


def dequantize(leaf, compute: torch.dtype) -> torch.Tensor:
    """``{"q", "s"}`` (or a plain tensor) -> a ``compute`` tensor (the full
    weight; matmuls use ``qmatmul``)."""
    if _is_quantized(leaf):
        return leaf["q"].to(compute) * leaf["s"].to(compute)
    return leaf.to(compute)


def qmatmul(x: torch.Tensor, leaf, compute: torch.dtype) -> torch.Tensor:
    """``x @ leaf`` with the per-output-channel scale applied after the
    accumulate; plain leaves take the ordinary product."""
    if _is_quantized(leaf):
        y = x @ leaf["q"].to(compute)
        s = leaf["s"]
        return y * s.reshape(s.shape[:-2] + s.shape[-1:]).to(compute)
    return x @ leaf.to(compute)


def dequantize_rows(leaf, idx: torch.Tensor,
                    compute: torch.dtype) -> torch.Tensor:
    """Row lookup for plain or row-quantized tables."""
    if _is_quantized(leaf):
        return leaf["q"][idx].to(compute) * leaf["s"][idx].to(compute)
    return leaf.to(compute)[idx]


def quantization_error(params: Dict[str, Any]) -> Dict[str, float]:
    """Relative Frobenius error per quantized leaf (sanity metric)."""
    qp = quantize_weights(params)
    out: Dict[str, float] = {}

    def walk(orig, quant, path=""):
        if _is_quantized(quant):
            deq = dequantize(quant, torch.float32)
            ref = orig.float()
            num = float(torch.linalg.vector_norm(ref - deq))
            den = float(torch.linalg.vector_norm(ref)) or 1.0
            out[path] = num / den
            return
        if isinstance(orig, dict):
            for k in orig:
                walk(orig[k], quant[k], f"{path}/{k}" if path else k)

    walk(params, qp)
    return out
