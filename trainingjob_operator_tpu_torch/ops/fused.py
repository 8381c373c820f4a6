"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Port of the JAX package's ``ops/fused.py``.  ``rmsnorm`` is differentiable
(``_RMSNorm``, the counterpart of the JAX ``custom_vjp``): its forward
dispatches on the tensor's device -- a CUDA tensor launches the kernel (or
raises), a CPU tensor takes ``rmsnorm_reference`` -- and its backward is
the vjp of the plain version, recomputed from the saved ``(x, scale)`` as
in JAX (``fused.py:79-82``).
"""

from __future__ import annotations

import torch

from trainingjob_operator_tpu_torch.ops import _build

#: Kernel launches since the last reset (chip_smoke.py reads it).
launches = 0
#: 16-byte vectors a thread of ``csrc/rmsnorm.cu`` may hold (its largest
#: ``kPer``) and warps a CTA holds (``kMaxWarps``): a row of at most
#: 16 x 32 x 8 vectors (32768 bf16, 16384 f32) fits in a CTA's registers.
MAX_PER_THREAD = 16
MAX_CTA_WARPS = 8
#: 16-byte vectors a thread holds where a team of at most MAX_CTA_WARPS
#: warps can hold the row so: at D = 4096 bf16 a row spread over 8 warps,
#: 2 vectors a thread (PERF.md §6).
PER_THREAD = 2


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Plain version: f32 mean of squares, ``rsqrt(ms + eps)``, times the
    f32 scale, cast back to the input dtype."""
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def rmsnorm_plan(rows: int, d: int, element_size: int) -> dict:
    """How ``csrc/rmsnorm.cu`` holds rows of ``d`` elements: each row in
    the registers of a team of ``team`` warps (the fewest, at most 8, that
    hold it at ``PER_THREAD`` 16-byte vectors a thread), ``per`` vectors a
    thread (the fewest that then hold the row; both powers of two),
    and the grid of CTAs of MAX_CTA_WARPS warps (8 / ``team`` rows).
    Plain Python: the wrapper launches by it and the CPU tests check
    it."""
    nvec = d * element_size // 16
    team = min(MAX_CTA_WARPS,
               _pow2_at_least(-(-nvec // (32 * PER_THREAD))))
    per = _pow2_at_least(-(-nvec // (32 * team)))
    if per > MAX_PER_THREAD:
        most = 32 * MAX_PER_THREAD * MAX_CTA_WARPS * 16 // element_size
        raise ValueError(f"rmsnorm kernel holds rows of at most {most} "
                         f"elements of this dtype, got {d}")
    return {"team": team, "per": per,
            "grid": -(-rows * team // MAX_CTA_WARPS)}


def check_kernel_args(x: torch.Tensor, scale: torch.Tensor) -> None:
    """Raise on inputs ``csrc/rmsnorm.cu`` does not take."""
    d = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if d % 8:
        raise ValueError(f"rmsnorm kernel needs the last dim to be a "
                         f"multiple of 8, got {d}")
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous input")
    if x.data_ptr() % 16:
        raise ValueError("rmsnorm kernel needs a 16-byte aligned input")
    if (scale.dtype != torch.float32 or scale.shape != (d,)
            or not scale.is_contiguous() or scale.device != x.device
            or scale.data_ptr() % 16):
        raise ValueError(f"rmsnorm kernel needs a contiguous, 16-byte "
                         f"aligned float32 scale of shape ({d},) on "
                         f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        # Called bare, the kernel would return a tensor cut off from the
        # graph; ``rmsnorm`` runs it inside its autograd Function.
        raise NotImplementedError(
            "rmsnorm_kernel has no backward of its own; call rmsnorm")


def rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Launch ``csrc/rmsnorm.cu`` on a CUDA tensor."""
    global launches
    check_kernel_args(x, scale)
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    plan = rmsnorm_plan(rows, d, x.element_size())
    lib = _build.library()
    code = lib.tj_rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, float(eps),
        _build.dtype_code(x), plan["per"], plan["team"],
        _build.stream_of(x))
    _build.check(code, "rmsnorm_fwd")
    launches += 1
    return out


def _rmsnorm_forward(x, scale, eps):
    if x.is_cuda:
        return rmsnorm_kernel(x, scale, eps)
    return rmsnorm_reference(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_forward(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            sd = scale.detach().requires_grad_()
            y = rmsnorm_reference(xd, sd, ctx.eps)
        dx, dscale = torch.autograd.grad(y, (xd, sd), g)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis; differentiable, dtype-preserving.  The
    autograd Function runs only where a gradient is wanted: serving calls
    the forward bare and saves nothing."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"rmsnorm: no implementation for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, float(eps))
    return _rmsnorm_forward(x, scale, eps)
