"""Plain float32 decoder of the Mistral family, dense (Mistral-7B) or with
routed experts (Mixtral-8x7B), in plain PyTorch: the reference that
decides ``correct``.

It follows the published architecture (Mistral's reference code): RMSNorm
before attention and before the MLP, rotary embeddings on interleaved
pairs of each head's dims, grouped-query causal attention with full
softmax, SwiGLU, and for Mixtral a router whose softmax picks the top
``num_experts_per_tok`` experts, their weights renormalised.  Where the
configuration file states an assumption (Mixtral's capacity 1.25 with
dense dispatch), it is followed as stated: an expert takes at most
``capacity`` tokens of a sequence, choice-major then token-major, and a
dropped assignment adds nothing; the load-balancing term is the Switch
one, ``E x sum_e (kept assignments to e / (T k / E) / E) x mean prob``.

Parameters are a dict of slices by ``weights.slice_key``; it imports
nothing of the program.  ``lowp="fp8"`` is the control: every product
with a weight (projections, experts, head; not the router) takes its
operands rounded to float8 e4m3 with one scale a tensor, and its
backward the gradient in e5m2, as fp8 training recipes do; everything
else stays float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def exact_float32() -> None:
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(t: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to ``fmt`` under one scale (its absolute max onto
    the format's largest value), back in t's dtype."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX[fmt] / amax
    return (t * scale).to(fmt).to(t.dtype) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = to_fp8(x), to_fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = to_fp8(g, torch.float8_e5m2)
        return gq @ wq.T, xq.T @ gq


def mm(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str]):
    """x [N, in] @ w [in, out], in float32 or (``lowp="fp8"``) on fp8
    operands."""
    if lowp is None:
        return x @ w
    if lowp != "fp8":
        raise ValueError(f"unknown lowp {lowp!r}")
    if torch.is_grad_enabled():
        return _Fp8Matmul.apply(x, w)
    return to_fp8(x) @ to_fp8(w)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]) of x [T, H,
    Dh] by angle position x theta ** (-2i / Dh), angles in float64."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = positions.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def attention(q, k, v, positions: torch.Tensor):
    """Causal grouped-query attention of q [T, H, Dh] over k, v [T, Hkv,
    Dh] at ``positions``: a query sees the keys at positions up to its
    own.  Returns [T, H * Dh]."""
    Tq, H, Dh = q.shape
    group = H // k.shape[1]
    kh = k.repeat_interleave(group, dim=1).transpose(0, 1)   # [H, Tk, Dh]
    vh = v.repeat_interleave(group, dim=1).transpose(0, 1)
    scores = (q.transpose(0, 1) @ kh.transpose(1, 2)) * (Dh ** -0.5)
    mask = positions[None, :] > positions[:, None]
    scores = scores.masked_fill(mask[None], float("-inf"))
    out = torch.softmax(scores, dim=-1) @ vh                 # [H, Tq, Dh]
    return out.transpose(0, 1).reshape(Tq, H * Dh)


def _layer_key(path: str, layer: int, expert: Optional[int] = None) -> str:
    return (f"layers/{path}[{layer}]" if expert is None
            else f"layers/{path}[{layer},{expert}]")


def layer_params(params: Dict[str, torch.Tensor], cfg: dict,
                 layer: int) -> Dict[str, object]:
    """Layer ``layer``'s slices of ``params`` by short name (expert
    leaves as lists over the experts)."""
    E = cfg.get("num_local_experts", 0)
    p = {n: params[_layer_key(f"attn/{n}", layer)]
         for n in ("wq", "wk", "wv", "wo")}
    p["attn_norm"] = params[_layer_key("attn_norm", layer)]
    if E:
        p["mlp_norm"] = params[_layer_key("moe_norm", layer)]
        p["router"] = params[_layer_key("moe/router", layer)]
        for n in ("w_gate", "w_up", "w_down"):
            p[n] = [params[_layer_key(f"moe/{n}", layer, e)]
                    for e in range(E)]
    else:
        p["mlp_norm"] = params[_layer_key("mlp_norm", layer)]
        for n in ("w_gate", "w_up", "w_down"):
            p[n] = params[_layer_key(f"mlp/{n}", layer)]
    return p


def capacity(cfg: dict, T: int) -> int:
    """Tokens an expert takes from one sequence of T, as the configuration
    states it: int(capacity_factor x k x T / E), at least 1."""
    return max(int(cfg["capacity_factor"] * cfg["num_experts_per_tok"] * T
                   / cfg["num_local_experts"]), 1)


def moe_mlp(x: torch.Tensor, p, cfg: dict, lowp: Optional[str]):
    """Routed SwiGLU experts of x [T, D] (one sequence) -> ([T, D], aux)."""
    T = x.shape[0]
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    C = capacity(cfg, T)
    probs = torch.softmax(x @ p["router"], dim=-1)           # [T, E]
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top.values[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    choice = top.indices[:, :k]                               # [T, k]
    # Assignments in priority order (every token's first choice, then
    # every token's second), an expert keeping its first C.
    order_e = choice.T.reshape(-1)                            # [k T]
    onehot = F.one_hot(order_e, E)
    rank = (torch.cumsum(onehot, 0) - onehot).gather(
        1, order_e[:, None])[:, 0]
    kept = (rank < C).reshape(k, T).T                         # [T, k]
    y = torch.zeros_like(x)
    counts = torch.zeros(E, device=x.device)
    for e in range(E):
        tok, slot = torch.nonzero((choice == e) & kept, as_tuple=True)
        counts[e] = tok.numel()
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = F.silu(mm(xe, p["w_gate"][e], lowp)) * mm(xe, p["w_up"][e],
                                                       lowp)
        ye = mm(h, p["w_down"][e], lowp) * gates[tok, slot][:, None]
        y = y.index_add(0, tok, ye)
    frac = counts / max(T * k / E, 1e-9) / E
    aux = (frac * probs.mean(0)).sum() * E
    return y, aux


def layer_forward(h: torch.Tensor, p, cfg: dict, positions: torch.Tensor,
                  lowp: Optional[str] = None):
    """One decoder layer on the whole sequence h [T, D] -> (h, aux)."""
    H, Hkv, Dh = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    T = h.shape[0]
    x = rmsnorm(h, p["attn_norm"], cfg["rms_norm_eps"])
    q = mm(x, p["wq"], lowp).view(T, H, Dh)
    k = mm(x, p["wk"], lowp).view(T, Hkv, Dh)
    v = mm(x, p["wv"], lowp).view(T, Hkv, Dh)
    q = rope(q, positions, cfg["rope_theta"])
    k = rope(k, positions, cfg["rope_theta"])
    h = h + mm(attention(q, k, v, positions), p["wo"], lowp)
    x = rmsnorm(h, p["mlp_norm"], cfg["rms_norm_eps"])
    if cfg.get("num_local_experts"):
        y, aux = moe_mlp(x, p, cfg, lowp)
    else:
        y = mm(F.silu(mm(x, p["w_gate"], lowp)) * mm(x, p["w_up"], lowp),
               p["w_down"], lowp)
        aux = x.new_zeros(())
    return h + y, aux


def sequence_loss(params: Dict[str, torch.Tensor], row: torch.Tensor,
                  cfg: dict, lowp: Optional[str] = None) -> torch.Tensor:
    """Training loss of one sequence ``row`` [T + 1]: the mean next-token
    cross-entropy plus ``router_aux_loss_coef`` x the layers' mean aux."""
    inputs, targets = row[:-1], row[1:]
    T = inputs.shape[0]
    positions = torch.arange(T, device=row.device)
    h = params["tok_embed"][inputs]
    aux = h.new_zeros(())
    L = cfg["num_hidden_layers"]
    for layer in range(L):
        h, a = layer_forward(h, layer_params(params, cfg, layer), cfg,
                             positions, lowp)
        aux = aux + a
    h = rmsnorm(h, params["final_norm"], cfg["rms_norm_eps"])
    logits = mm(h, params["lm_head"], lowp)
    ce = F.cross_entropy(logits, targets)
    return ce + cfg.get("router_aux_loss_coef", 0.0) * aux / L
