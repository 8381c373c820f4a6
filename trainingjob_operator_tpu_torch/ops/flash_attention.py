"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (dQ and dK/dV), each beside its plain version.

Port of the JAX package's ``ops/flash_attention.py``.  The public
functions take ``[B, T, H, D]`` tensors (k/v may have fewer heads: GQA)
and are differentiable through ``_Flash``, the counterpart of the JAX
``custom_vjp`` ``_flash``: its forward saves ``(q, k, v, out, lse)``, its
backward computes ``delta = rowsum(dO * O)`` in plain PyTorch (XLA does it
in JAX) and then the FlashAttention-2 gradients.  Every step dispatches on
the tensor's device: a CUDA tensor launches the kernel (or raises), a CPU
tensor takes the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from trainingjob_operator_tpu_torch.ops import _build

NEG_INF = -1e30
#: Head dims the kernels are instantiated for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

#: Kernel launches since the last reset (chip_smoke.py reads them).
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0


def _mask(T: int, causal: bool, window: int, device):
    """[T, T] bool, True where query row i may see key column j; None when
    every pair is visible."""
    if not causal:
        return None
    ones = torch.ones((T, T), dtype=torch.bool, device=device)
    mask = torch.tril(ones)
    if window:
        # Banded: row i sees cols (i - window, i].
        mask = mask & ~torch.tril(ones, -window)
    return mask


def _repeat_kv(x, H: int):
    """[B, Hkv, T, D] -> [B, H, T, D]: query head h reads KV head
    h // (H / Hkv)."""
    Hkv = x.shape[1]
    return x if H == Hkv else torch.repeat_interleave(x, H // Hkv, dim=1)


def _scores(q, k, *, scale: float, causal: bool, window: int = 0):
    """Masked f32 score matrix [B, H, Tq, Tk] (GQA keys repeated);
    q/k in [B, H, T, D]."""
    k = _repeat_kv(k, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[2], causal, window, q.device)
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    return s


def _reference(q, k, v, *, scale: float, causal: bool, window: int = 0):
    """Plain version, [B, H, T, D] layout, f32 softmax statistics."""
    v = _repeat_kv(v, q.shape[1])
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
    """Raise on inputs ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` do
    not take."""
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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        # Called bare, a kernel would return a tensor cut off from the
        # graph; ``flash_attention`` runs them inside ``_Flash``.
        raise NotImplementedError(
            "the flash kernel wrappers have no backward of their own; call "
            "flash_attention")


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


def flash_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, [B, H, T] contiguous, from [B, T, H, D]
    dO and O (``_flash_bwd`` ``:439``)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_probs(q, k, v, g, lse, delta, *, scale: float, causal: bool,
               window: int):
    """The FA-2 backward's recomputed probabilities and score gradients,
    dense in f32 over [B, H, T, T] (GQA keys repeated): p = where(valid,
    exp(z - lse), 0) with z = (q . k) * scale; dz = p * (dp - delta) * scale
    with dp = dO . v.  Inputs in [B, T, H, D]; also returns q and dO in
    [B, H, T, D] f32."""
    qt, gt = (x.transpose(1, 2).float() for x in (q, g))
    H = qt.shape[1]
    kt, vt = (_repeat_kv(x.transpose(1, 2), H).float() for x in (k, v))
    z = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    p = torch.exp(z - lse[..., None])
    mask = _mask(qt.shape[2], causal, window, q.device)
    if mask is not None:
        p = torch.where(mask[None, None], p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gt, vt)
    dz = p * (dp - delta[..., None]) * scale
    return p, dz, qt, gt, kt


def flash_bwd_dq_reference(q, k, v, g, lse, delta, *, causal: bool,
                           scale: float, window: int) -> torch.Tensor:
    """Plain version of ``tj_flash_bwd_dq``: dq = dz . k, [B, T, H, D] in
    q's dtype."""
    _, dz, _, _, kt = _bwd_probs(q, k, v, g, lse, delta, scale=scale,
                                 causal=causal, window=window)
    dq = torch.einsum("bhqk,bhkd->bhqd", dz, kt)
    return dq.transpose(1, 2).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, g, lse, delta, *, causal: bool,
                            scale: float, window: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``tj_flash_bwd_dkv``: dk = sum over the GQA group
    of dz^T . q, dv likewise of p^T . dO; [B, T, Hkv, D] in k's and v's
    dtypes."""
    p, dz, qt, gt, _ = _bwd_probs(q, k, v, g, lse, delta, scale=scale,
                                  causal=causal, window=window)
    B, T, Hkv, D = k.shape
    H = q.shape[2]

    def group_sum(x):
        return x.reshape(B, Hkv, H // Hkv, T, D).sum(2).transpose(1, 2)

    dk = group_sum(torch.einsum("bhqk,bhqd->bhkd", dz, qt))
    dv = group_sum(torch.einsum("bhqk,bhqd->bhkd", p, gt))
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_args(q, k, v, g, lse, delta) -> None:
    check_kernel_args(q, k, v)
    B, T, H, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError("flash backward needs dO of q's shape, dtype and "
                         "device")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (B, H, T)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash backward needs a contiguous float32 "
                             f"{name} of shape {(B, H, T)} on {q.device}")


def flash_bwd_dq_kernel(q, k, v, g, lse, delta, *, causal: bool,
                        scale: float, window: int) -> torch.Tensor:
    """Launch ``tj_flash_bwd_dq`` (``csrc/flash_bwd.cu``) on CUDA tensors:
    dq [B, T, H, D] in q's dtype.  q, k, v and dO are passed by stride."""
    global bwd_dq_launches
    _check_bwd_args(q, k, v, g, lse, delta)
    B, T, H, D = q.shape
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    code = _build.library().tj_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        B, T, H, k.shape[2], D, _build.dtype_code(q),
        int(causal), int(window), float(scale),
        *q.stride(), *k.stride(), *v.stride(), *g.stride(), *dq.stride(),
        _build.stream_of(q))
    _build.check(code, "flash_attention_bwd_dq")
    bwd_dq_launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, g, lse, delta, *, causal: bool,
                         scale: float, window: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``tj_flash_bwd_dkv`` (``csrc/flash_bwd.cu``) on CUDA tensors:
    (dk, dv) [B, T, Hkv, D] in k's dtype, the GQA group summed inside the
    kernel."""
    global bwd_dkv_launches
    _check_bwd_args(q, k, v, g, lse, delta)
    B, T, H, D = q.shape
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    code = _build.library().tj_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, H, k.shape[2], D, _build.dtype_code(q),
        int(causal), int(window), float(scale),
        *q.stride(), *k.stride(), *v.stride(), *g.stride(), *dk.stride(),
        *dv.stride(), _build.stream_of(q))
    _build.check(code, "flash_attention_bwd_dkv")
    bwd_dkv_launches += 1
    return dk, dv


def _flash_forward(q, k, v, causal, scale, window):
    if q.is_cuda:
        return flash_kernel_with_lse(q, k, v, causal=causal, scale=scale,
                                     window=window)
    return flash_reference_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = _flash_forward(q, k, v, causal, scale, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, scale=scale, window=window)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype)
        delta = flash_delta(g, out)
        if q.is_cuda:
            dq = flash_bwd_dq_kernel(q, k, v, g, lse, delta, **ctx.opts)
            dk, dv = flash_bwd_dkv_kernel(q, k, v, g, lse, delta, **ctx.opts)
        else:
            dq = flash_bwd_dq_reference(q, k, v, g, lse, delta, **ctx.opts)
            dk, dv = flash_bwd_dkv_reference(q, k, v, g, lse, delta,
                                             **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: Optional[float] = None, window: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over [B, T, H, D] -> (out [B, T, H, D] in q's dtype,
    lse [B, H, T] f32).  ``window`` > 0 (causal only) restricts row i to
    keys (i - window, i].  Differentiable in q, k and v (the lse carries
    no gradient, as in JAX, whose ``_flash`` returns only out).  The
    autograd Function runs only where a gradient is wanted."""
    scale = _check_common(q, k, v, causal, scale, window)
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention: no implementation for device "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, bool(causal), scale, int(window))
    return _flash_forward(q, k, v, bool(causal), scale, int(window))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    window: int = 0) -> torch.Tensor:
    """Attention over [B, T, H, D] (GQA: k/v may have fewer heads)."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)[0]
