"""PyTorch/CUDA port of the workload layer, for NVIDIA Hopper (H100).

The JAX package ``trainingjob_operator_tpu`` stays the reference; this
package mirrors its file layout (``models/llama.py`` here is the
counterpart of ``models/llama.py`` there) and imports nothing of it.
Every TPU kernel on a ported path is a hand-written CUDA C++ kernel under
``csrc/``; its plain PyTorch version sits beside it and serves CPU tensors.

Every entry point and constructor runs on the card by default
(``device="cuda"``) and raises ``RuntimeError`` when CUDA is absent unless
the caller asked for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device when CUDA is unavailable -- the port never falls back to the CPU
    on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) "
            "to run on the CPU")
    return dev
