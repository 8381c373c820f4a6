"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain version.

Port of the JAX package's ``ops/flash_attention.py`` forward.  The public
functions take ``[B, T, H, D]`` tensors (k/v may have fewer heads: GQA)
and dispatch on the tensor's device: a CUDA tensor launches the kernel (or
raises), a CPU tensor takes the plain version.  Forward only: the kernel
path refuses inputs that require grad; the backward kernels come with the
training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trainingjob_operator_tpu_torch.ops import _build

NEG_INF = -1e30
#: Head dims the kernel is instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

#: Kernel launches since the last reset (chip_smoke.py reads it).
launches = 0


def _scores(q, k, *, scale: float, causal: bool, window: int = 0):
    """Masked f32 score matrix [B, H, Tq, Tk] (GQA keys repeated);
    q/k in [B, H, T, D]."""
    H, T = q.shape[1], q.shape[2]
    Hkv = k.shape[1]
    if H != Hkv:
        k = torch.repeat_interleave(k, H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        ones = torch.ones((T, T), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones)
        if window:
            # Banded: row i sees cols (i - window, i].
            mask = mask & ~torch.tril(ones, -window)
        s = torch.where(mask[None, None], s, NEG_INF)
    return s


def _reference(q, k, v, *, scale: float, causal: bool, window: int = 0):
    """Plain version, [B, H, T, D] layout, f32 softmax statistics."""
    H = q.shape[1]
    Hkv = v.shape[1]
    if H != Hkv:
        v = torch.repeat_interleave(v, H // Hkv, dim=1)
    s = _scores(q, k, scale=scale, causal=causal, window=window)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _reference_lse(q, k, *, scale: float, causal: bool, window: int = 0):
    """Log-sum-exp rows of the plain scores, [B, H, T] f32."""
    s = _scores(q, k, scale=scale, causal=causal, window=window)
    m = s.amax(-1)
    return m + torch.log(torch.exp(s - m[..., None]).sum(-1))


def flash_reference_with_lse(q, k, v, *, causal: bool = True,
                             scale: Optional[float] = None, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version over [B, T, H, D]: (out [B, T, H, D], lse [B, H, T])."""
    scale = _check_common(q, k, v, causal, scale, window)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = _reference(qt, kt, vt, scale=scale, causal=causal, window=window)
    lse = _reference_lse(qt, kt, scale=scale, causal=causal, window=window)
    return out.transpose(1, 2), lse


def _check_common(q, k, v, causal, scale, window) -> float:
    if window and not causal:
        raise ValueError("window requires causal attention")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash attention takes [B, T, H, D] q, k, v "
                         "with equal k/v shapes")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    return float(D ** -0.5 if scale is None else scale)


def check_kernel_args(q, k, v) -> None:
    """Raise on inputs ``csrc/flash_fwd.cu`` does not take."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernel needs q, k and v of one dtype")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")
    if not (k.device == v.device == q.device):
        raise ValueError("flash kernel needs q, k and v on one device")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "the flash kernel is forward only; its backward comes with "
            "the training slice")


def flash_kernel_with_lse(q, k, v, *, causal: bool, scale: float,
                          window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors [B, T, H, D]; inputs are
    passed by stride, so no transpose or contiguous copy is made."""
    global launches
    check_kernel_args(q, k, v)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.library()
    code = lib.tj_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, T, H, Hkv, D,
        _build.dtype_code(q),
        int(causal), int(window), float(scale),
        *q.stride(), *k.stride(), *v.stride(), *out.stride(),
        _build.stream_of(q))
    _build.check(code, "flash_attention_fwd")
    launches += 1
    return out, lse


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: Optional[float] = None, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, T, H, D] -> (out [B, T, H, D] in q's dtype,
    lse [B, H, T] f32).  ``window`` > 0 (causal only) restricts row i to
    keys (i - window, i]."""
    scale = _check_common(q, k, v, causal, scale, window)
    if q.is_cuda:
        return flash_kernel_with_lse(q, k, v, causal=causal, scale=scale,
                                     window=int(window))
    if q.device.type == "cpu":
        return flash_reference_with_lse(q, k, v, causal=causal, scale=scale,
                                        window=window)
    raise ValueError(f"flash attention: no implementation for device "
                     f"{q.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Attention over [B, T, H, D] (GQA: k/v may have fewer heads)."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)[0]
