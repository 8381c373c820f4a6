"""Ring attention: exact attention over a sequence split on the ``sp``
axis, the port of the JAX package's ``parallel/ringattention.py``.

Each rank holds one block of ``Tl`` tokens of the same rows.  The forward
runs ``sp`` steps: at step ``s`` the rank holds the KV block of rank
``(my - s) % sp`` and attends its query block to it, then passes K and V
one hop on (``collectives.ppermute_next``; GQA's narrow ``Hkv`` blocks
travel, as in JAX).  Where JAX runs each block as XLA einsums, the port
launches the flash kernels on it (``ops/flash_attention.py``): the
diagonal block is one ``tj_torch::flash_fwd`` with ``causal=True``, an
earlier block one with ``causal=False``, and a later block, which a
causal mask hides whole, is skipped.  The blocks' (out, lse) are merged
in f32 (``merge_blocks``).  The backward is a second ring pass: with the
merged output's ``delta = rowsum(dO * O)`` and the merged (global) lse,
the dQ and dK/dV kernels give each visible block its exact share of the
gradients; dQ sums at home, and dK and dV ride the ring with their KV
block and are home after ``sp`` hops.

Shifts (each counted under ``collective_counts()["p2p"]``) a layer: the
forward 2 (sp - 1) (K and V), the backward 2 (sp - 1) + 2 sp (K and V,
then dK and dV home); none at sp = 1.

The ring's forward is one operator of PyTorch's dispatcher,
``tj_torch::ring_fwd`` (``RING_OP``), so that the "attn" remat policy
(``models/llama.py``) saves its (out, lse) as it saves the flash
forward's: the backward's recompute of the layer then returns them and
runs no block or shift again (JAX's ``attn_out`` names on the ring's
residuals).

The per-block forward (``block_forward``), the merge (``merge_blocks``),
the per-block backward (``block_backward``) and the schedule
(``ring_blocks``) are plain functions, so that one process can play every
rank of a ring (``chip_smoke.py`` ``ring_7b_width``).  JAX's
``ring_attention_sharded`` (a ``shard_map``) has no counterpart: each
rank already holds its rows, its tp heads and its sequence block.
"""

from __future__ import annotations

import importlib
import itertools
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from trainingjob_operator_tpu_torch.parallel.collectives import (
    ppermute_next,
    require_ici_axis,
)

_flash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")

NEG_INF = -1e30

#: A ring's (step, source rank, diagonal) entries: the KV block held at
#: step ``step`` came from rank ``source``; ``diagonal`` is the causal
#: block of the rank's own tokens.
Block = Tuple[int, int, bool]


def ring_blocks(my: int, sp: int, causal: bool) -> List[Block]:
    """The KV blocks rank ``my`` of a ring of ``sp`` attends to, in ring
    order: step ``s`` holds rank ``(my - s) % sp``'s block.  Under a
    causal mask a later rank's block is hidden whole and left out, so
    rank ``my`` sees ``my + 1`` blocks; without one it sees all ``sp``."""
    blocks = []
    for step in range(sp):
        src = (my - step) % sp
        if causal and src > my:
            continue
        blocks.append((step, src, causal and src == my))
    return blocks


def block_forward(q, k, v, *, diagonal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Tl, H, D] in q's dtype, lse [B, H, Tl] f32) of the query
    block against one KV block: one ``tj_torch::flash_fwd`` (the kernel on
    a CUDA tensor, the plain version on a CPU one), causal on the diagonal
    block, unmasked on an earlier one."""
    return _flash.FWD_OP(q, k, v, bool(diagonal), float(scale), 0)


def merge_blocks(parts) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (out, lse) of attention over the union of the blocks'
    ``parts`` [(out_j, lse_j), ...]: ``lse = logsumexp_j(lse_j)`` and
    ``out = sum_j exp(lse_j - lse) out_j``, in f32, ``out`` returned in
    the blocks' dtype.  One part is returned as it is.

    The kernels write each block's ``out_j`` in q's dtype, so under bf16
    every block's output is rounded once (a relative 2^-9) before the f32
    sum, where JAX keeps one f32 accumulator over the blocks and rounds
    only the result: the merged output carries up to one more bf16
    rounding per block, the same size as the kernel's own."""
    if len(parts) == 1:
        return parts[0]
    lse = torch.logsumexp(torch.stack([p[1] for p in parts]), dim=0)
    out = None
    for o, l in parts:
        w = torch.exp(l - lse).transpose(1, 2)[..., None]
        term = w * o.float()
        out = term if out is None else out.add_(term)
    return out.to(parts[0][0].dtype), lse


def block_backward(q, k, v, g, lse, delta, *, diagonal: bool, scale: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of one visible block given the merged ``lse`` and
    ``delta`` of the whole row ([B, H, Tl] f32): the block's exact share
    of the gradients.  The dQ and dK/dV kernels on CUDA tensors
    (``flash_bwd_dq_kernel``, ``flash_bwd_dkv_kernel``), their plain
    versions on CPU tensors; in q's (k's) dtype."""
    opts = dict(causal=bool(diagonal), scale=float(scale), window=0)
    if q.is_cuda:
        dq = _flash.flash_bwd_dq_kernel(q, k, v, g, lse, delta, **opts)
        dk, dv = _flash.flash_bwd_dkv_kernel(q, k, v, g, lse, delta, **opts)
    else:
        dq = _flash.flash_bwd_dq_reference(q, k, v, g, lse, delta, **opts)
        dk, dv = _flash.flash_bwd_dkv_reference(q, k, v, g, lse, delta,
                                                **opts)
    return dq, dk, dv


def ring_forward(q, k, v, mesh, axis: str, causal: bool, scale: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the forward ring pass (JAX ``_ring_forward``): the
    visible blocks' ``block_forward`` merged, K and V shifted ``sp - 1``
    times."""
    sp, my = mesh.size(axis), mesh.coord(axis)
    visible = {step: diagonal for step, _, diagonal in
               ring_blocks(my, sp, causal)}
    parts = []
    for step in range(sp):
        if step in visible:
            parts.append(block_forward(q, k, v, diagonal=visible[step],
                                       scale=scale))
        if step < sp - 1:
            k, v = (ppermute_next(x, mesh, axis) for x in (k, v))
    return merge_blocks(parts)


def ring_backward(q, k, v, out, lse, g, mesh, axis: str, causal: bool,
                  scale: float):
    """(dq, dk, dv) of the backward ring pass (JAX ``_ring_bwd``): every
    visible block's ``block_backward`` with the global ``lse`` and
    ``delta``; dq sums here in f32, dk and dv in f32 accumulators that
    travel with their KV block and are back at its rank after ``sp``
    hops."""
    sp, my = mesh.size(axis), mesh.coord(axis)
    visible = {step: diagonal for step, _, diagonal in
               ring_blocks(my, sp, causal)}
    delta = _flash.flash_delta(g, out)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for step in range(sp):
        if step in visible:
            bq, bk, bv = block_backward(q, k, v, g, lse, delta,
                                        diagonal=visible[step], scale=scale)
            dq.add_(bq)
            dk.add_(bk)
            dv.add_(bv)
        if step < sp - 1:
            k, v = (ppermute_next(x, mesh, axis) for x in (k, v))
        dk, dv = (ppermute_next(x, mesh, axis) for x in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


#: The rings the operator can name: key -> (a weak reference to the
#: mesh, the axis).  An operator's schema takes no Python object, so
#: ``tj_torch::ring_fwd`` takes the key.
_RINGS: Dict[int, Tuple["weakref.ref", str]] = {}
_KEYS = itertools.count()


def _ring_key(mesh, axis: str) -> int:
    """The key of (mesh, axis) in ``_RINGS``, made at the mesh's first
    ring over ``axis``, after ``require_ici_axis``."""
    keys = mesh.__dict__.setdefault("_ring_keys", {})
    if axis not in keys:
        require_ici_axis(mesh, axis)
        keys[axis] = next(_KEYS)
        _RINGS[keys[axis]] = (weakref.ref(mesh), axis)
    return keys[axis]


def _ring_fwd_impl(q, k, v, causal, scale, ring):
    """``tj_torch::ring_fwd``: ``ring_forward`` on the ring ``ring``."""
    ref, axis = _RINGS[ring]
    return ring_forward(q, k, v, ref(), axis, causal, scale)


_LIB = torch.library.Library("tj_torch", "FRAGMENT")
_LIB.define("ring_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale, int ring) -> (Tensor, Tensor)")
_LIB.impl("ring_fwd", _ring_fwd_impl, "CompositeExplicitAutograd")

#: The ring's forward operator, as a selective-checkpoint policy sees it.
RING_OP = torch.ops.tj_torch.ring_fwd.default


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        out, lse = RING_OP(q, k, v, causal, scale, _ring_key(mesh, axis))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (mesh, axis, causal, scale)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q, k, v, out, lse, g.to(q.dtype),
                                   *ctx.ring)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh, causal: bool = True,
                   scale: Optional[float] = None, axis: str = "sp"
                   ) -> torch.Tensor:
    """Exact attention over the sequence split on ``axis``: q [B, Tl, H, D]
    and k, v [B, Tl, Hkv, D] are this rank's block (GQA: H a multiple of
    Hkv), and so is the output [B, Tl, H, D].  Differentiable in q, k and
    v through the ring backward; the autograd Function runs only where a
    gradient is wanted.  ``ValueError`` where the mesh lacks ``axis`` or
    the axis crosses slices (``collectives.require_ici_axis``)."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"ring attention takes [B, T, H, D] q and equal "
                         f"[B, T, Hkv, D] k, v with Hkv dividing H; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Ring.apply(q, k, v, mesh, axis, bool(causal), scale)[0]
    return RING_OP(q, k, v, bool(causal), scale, _ring_key(mesh, axis))[0]


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain full attention for correctness checks (JAX's
    ``reference_attention``), [B, T, H, D] in q's dtype; k and v may have
    fewer heads (query head h reads KV head h // (H / Hkv))."""
    B, T, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    k, v = (torch.repeat_interleave(x, H // x.shape[2], dim=2)
            for x in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
