"""Decode attention over the KV cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain version.

One query token a row (q [B, 1, Hq, Dh]) attends to one layer's cache
slice (keys, values [B, S, Hkv, Dh]), Hq = Hkv x group.  Full mode
(``window`` 0): slot == position, slots <= t visible.  Ring mode: slot s
holds position p = t - ((t - s) mod S), visible iff p >= 0 and
p > t - window.  ``t`` is an int (the whole batch at one position) or an
int64 [B] tensor of per-row positions.

``decode_attention`` dispatches on the tensor's device: a CUDA tensor
launches the kernel (or raises on what it does not take), a CPU tensor
takes ``attend_cache_reference``, which the CPU tests hold to the JAX
package.  The JAX package computes this attention in plain XLA
(``models/decode.py`` ``_attend_cache``), so the kernel replaces no TPU
kernel.  Its launch plan (``decode_attention_plan``) is plain Python.
"""

from __future__ import annotations

from typing import Union

import torch

from trainingjob_operator_tpu_torch.ops import _build

#: Kernel launches since the last reset (``ops.launch_counts()``'s
#: "decode_attention"); a launch with more than one split runs a second,
#: merging kernel and still counts once.
launches = 0

#: Head dims and query heads a KV head (group) the kernel takes.
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8
#: Warps a CTA, positions a thread copies a stage and stages in flight:
#: kWarps, kRows and kStages of csrc/decode_attention.cu.
DA_WARPS = 4
DA_ROWS = 4
DA_STAGES = 4
#: SMs of an H100 SXM, and the CTAs a full cache should give: at 16 an SM
#: a cache that is half visible still fills every SM several times over
#: (B 32, Hkv 8, S 2048: 8 splits of 256 slots, 2,048 CTAs).
SMS = 132
TARGET_CTAS = 16 * SMS
#: Tiles a CTA takes at the least.  A tile is 8 KB of keys (and 8 KB of
#: values) in every instance, so a CTA reads at least 128 KB: with chunks
#: of one tile a CTA spends most of its time starting up and the merge
#: reads more partials (an H100 sweep at one row and an int t: at t 2047
#: 51.4 us at one tile a CTA, 17.4 at eight; at t 100 one split of eight
#: tiles, which needs no merging launch, 5.9 against 8.5).
MIN_TILES = 8


def attend_cache_reference(q, keys, values, t, group: int,
                           window: int = 0) -> torch.Tensor:
    """Plain version: q [B, 1, Hq, Dh] vs cache [B, S, Hkv, Dh] ->
    [B, 1, Hq, Dh] f32.  f32 copies of the whole slice, f32 scores times
    Dh^-0.5, -inf mask, f32 softmax, f32 P.V."""
    B, S, Hkv, Dh = keys.shape
    if isinstance(t, torch.Tensor):
        t = t.view(B, 1, 1, 1)
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


def decode_attention_plan(B: int, Hkv: int, S: int, Dh: int, group: int,
                          dtype: torch.dtype, reach: int = 0) -> dict:
    """How ``csrc/decode_attention.cu`` covers the cache: ``tile`` slots a
    stage (each thread one 16-byte vector of a position's head dim, 32 /
    (Dh / vector) positions a warp, DA_ROWS a thread, DA_WARPS warps),
    ``chunk`` slots a CTA (at least MIN_TILES tiles), ``splits`` CTAs a
    (row, KV head), the grid, and ``group_slots``, the kernel's query
    heads a KV head (the power of two at or above ``group``).  The splits
    cover ``reach`` slots: all S (``reach`` 0) where each row has its own
    position, the batch's visible slots where it has one.  Raises on a
    head dim, group or dtype the kernel does not take."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode attention kernel takes float32 or "
                        f"bfloat16, not {dtype}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes head dims "
                         f"{HEAD_DIMS}, not {Dh}")
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"decode attention kernel takes 1 to {MAX_GROUP} "
                         f"query heads a KV head, not {group}")
    if B < 1 or Hkv < 1 or S < 1:
        raise ValueError(f"decode attention needs B, Hkv and S >= 1, got "
                         f"{B}, {Hkv}, {S}")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    tile = DA_ROWS * DA_WARPS * (32 // (Dh // vec))
    reach = min(reach, S) if reach > 0 else S
    wanted = -(-TARGET_CTAS // (B * Hkv))
    chunk = tile * max(MIN_TILES, -(-reach // (wanted * tile)))
    splits = -(-reach // chunk)
    return {"vec": vec, "tile": tile, "chunk": chunk, "splits": splits,
            "grid": (B * Hkv, splits),
            "group_slots": 1 << (group - 1).bit_length()}


def visible_slots(t, S: int, window: int = 0) -> int:
    """Slots the batch sees at an int ``t`` (at least 1, so a launch has a
    split); 0, for all S, at a per-row position tensor."""
    if isinstance(t, torch.Tensor):
        return 0
    return max(1, min(int(t) + 1, S, window if window > 0 else S))


def _vector_ready(x: torch.Tensor, vec: int) -> bool:
    """d-stride 1, the other strides and the base on 16-byte vectors."""
    return (x.stride(-1) == 1 and all(s % vec == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0)


def check_kernel_args(q, keys, values, t, group: int, window: int) -> dict:
    """Raise on inputs ``csrc/decode_attention.cu`` does not take; returns
    the plan."""
    B, S, Hkv, Dh = keys.shape
    plan = decode_attention_plan(B, Hkv, S, Dh, group, keys.dtype,
                                 visible_slots(t, S, window))
    if values.shape != keys.shape or q.shape != (B, 1, Hkv * group, Dh):
        raise ValueError(f"decode attention needs q [B, 1, Hkv x group, Dh] "
                         f"and keys, values [B, S, Hkv, Dh]; got "
                         f"{tuple(q.shape)}, {tuple(keys.shape)}, "
                         f"{tuple(values.shape)} at group {group}")
    if not q.dtype == keys.dtype == values.dtype:
        raise TypeError(f"decode attention kernel needs one dtype, got "
                        f"{q.dtype}, {keys.dtype}, {values.dtype}")
    if not (q.device == keys.device == values.device):
        raise ValueError("decode attention needs q, keys and values on one "
                         "device")
    if not all(_vector_ready(x, plan["vec"]) for x in (q, keys, values)):
        raise ValueError("decode attention kernel needs d-stride 1 and "
                         "16-byte aligned rows")
    if isinstance(t, torch.Tensor):
        if (t.dtype != torch.int64 or t.shape != (B,)
                or t.device != keys.device or not t.is_contiguous()):
            raise ValueError(f"decode attention kernel takes positions as "
                             f"an int or a contiguous int64 [{B}] tensor "
                             f"on {keys.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (q, keys, values)):
        raise NotImplementedError("the decode attention kernel has no "
                                  "backward")
    return plan


def decode_attention_kernel(q, keys, values, t, group: int,
                            window: int = 0) -> torch.Tensor:
    """Launch ``csrc/decode_attention.cu`` on CUDA tensors; returns
    [B, 1, Hq, Dh] in q's dtype."""
    global launches
    plan = check_kernel_args(q, keys, values, t, group, window)
    B, S, Hkv, Dh = keys.shape
    out = torch.empty(B, 1, Hkv * group, Dh, dtype=q.dtype, device=q.device)
    splits, slots = plan["splits"], plan["group_slots"]
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(B * Hkv * splits * slots * Dh,
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty(B * Hkv * splits * slots * 2,
                              dtype=torch.float32, device=q.device)
    per_row = isinstance(t, torch.Tensor)
    lib = _build.library()
    code = lib.tj_decode_attention(
        q.data_ptr(), keys.data_ptr(), values.data_ptr(),
        t.data_ptr() if per_row else None, 0 if per_row else int(t),
        out.data_ptr(), part_acc.data_ptr() if part_acc is not None else None,
        part_ml.data_ptr() if part_ml is not None else None,
        B, S, Hkv, Dh, group, slots, int(window), _build.dtype_code(q),
        plan["chunk"], splits, float(Dh ** -0.5), q.stride(0), q.stride(2),
        *keys.stride()[:3], *values.stride()[:3], _build.stream_of(q))
    _build.check(code, "decode_attention")
    launches += 1
    return out


def decode_attention(q, keys, values, t: Union[int, torch.Tensor],
                     group: int, window: int = 0) -> torch.Tensor:
    """q [B, 1, Hq, Dh] against one layer's cache slice -> [B, 1, Hq, Dh]
    in q's dtype: the kernel on a CUDA tensor, the plain version on the
    CPU."""
    if q.is_cuda:
        return decode_attention_kernel(q, keys, values, t, group, window)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: no implementation for device "
                         f"{q.device}")
    return attend_cache_reference(q, keys, values, t, group,
                                  window).to(q.dtype)
