"""Kernels of the port, each beside its plain PyTorch version.

Dispatch goes by the tensor's device, never by environment or by catching
an error: a CUDA tensor launches the hand-written kernel (``csrc/``) or
raises; a CPU tensor takes the plain version, which the CPU tests compare
with the JAX package.  Counterpart of the JAX package's ``ops/__init__.py``
(``use_pallas`` / ``pallas_interpret``).
"""

from typing import Dict

from trainingjob_operator_tpu_torch.ops import decode_attention as _decode
from trainingjob_operator_tpu_torch.ops import flash_attention as _flash
from trainingjob_operator_tpu_torch.ops import fused as _fused
from trainingjob_operator_tpu_torch.ops import moe_experts as _experts
from trainingjob_operator_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_with_lse,
)
from trainingjob_operator_tpu_torch.ops.fused import rmsnorm  # noqa: F401


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``.  The flash
    forward, dQ and dK/dV count every launch; their ``_wgmma`` keys count
    the tensor-core kernels' share of them.  "decode_attention" counts the
    decode attention over the KV cache; "moe_experts_gate_up" and
    "moe_experts_down" the routed MLP's grouped expert products."""
    return {"rmsnorm_fwd": _fused.launches,
            "flash_attention_fwd": _flash.launches,
            "flash_attention_bwd_dq": _flash.bwd_dq_launches,
            "flash_attention_bwd_dkv": _flash.bwd_dkv_launches,
            "flash_attention_fwd_wgmma": _flash.wgmma_fwd_launches,
            "flash_attention_bwd_dq_wgmma": _flash.wgmma_dq_launches,
            "flash_attention_bwd_dkv_wgmma": _flash.wgmma_dkv_launches,
            "decode_attention": _decode.launches,
            "moe_experts_gate_up": _experts.gate_up_launches,
            "moe_experts_down": _experts.down_launches}


def reset_launch_counts() -> None:
    _fused.launches = 0
    _flash.launches = 0
    _flash.bwd_dq_launches = 0
    _flash.bwd_dkv_launches = 0
    _flash.wgmma_fwd_launches = 0
    _flash.wgmma_dq_launches = 0
    _flash.wgmma_dkv_launches = 0
    _decode.launches = 0
    _experts.gate_up_launches = 0
    _experts.down_launches = 0
