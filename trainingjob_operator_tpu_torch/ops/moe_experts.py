"""Grouped expert products of the routed MLP: the CUDA kernels
``csrc/moe_experts.cu`` and their plain version.

The (row, choice) pairs of a routed MLP call are sorted by expert: ``xs``
[P, D] holds their inputs in that order, ``ends`` [E] (int64) where each
expert's pairs end (an inclusive cumulative sum of the per-expert counts) and
``order`` [P] (int64) each position's pair index, row * k + choice.
``grouped_experts`` returns y [P, D], the SwiGLU of each pair's expert at
the pair's own place::

    h[i] = silu(xs[i] @ w_gate[e]) * (xs[i] @ w_up[e])
    y[order[i]] = h[i] @ w_down[e]          for ends[e-1] <= i < ends[e]

A CUDA tensor launches the two kernels, which read ``ends`` on the device,
so no call waits for the routing; a CPU tensor takes
``grouped_experts_reference``, the per-expert loop, which reads the counts.
The JAX package gathers each row's experts' weights instead
(``models/moe_decode.py`` ``_routed_mlp_token``), so the kernels replace no
TPU kernel.  Their launch plan (``moe_experts_plan``) is plain Python.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from trainingjob_operator_tpu_torch.ops import _build

#: Launches since the last reset (``ops.launch_counts()``'s
#: "moe_experts_gate_up" and "moe_experts_down").
gate_up_launches = 0
down_launches = 0

#: Weight columns a tile of gate/up (down: twice as many), reduction depth
#: a stage, rows a wgmma product, rows a pass and rows a TMA box of the
#: tensor-core kernels (kTileM, kTileK, kBlockRows, kPassRows and kBoxRows
#: of csrc/moe_experts.cu), the most stages of the ring (kMaxStages) and
#: its bytes (kRingBytes).  One CTA an SM.
ME_TILE_M = 64
ME_TILE_K = 64
ME_BLOCK_ROWS = 64
ME_PASS_ROWS = 256
ME_BOX_ROWS = 8
ME_MAX_STAGES = 16
ME_RING_BYTES = 163840
#: SMs of an H100 SXM.
SMS = 132
#: Weight columns a CTA of the f32 kernel (kFmaCols).
FMA_COLS = 64


def ring_stages(widest: int) -> int:
    """Stages of a CTA's ring (csrc/moe_experts.cu ``ring_of``) when the
    call's widest expert has ``widest`` rows: a stage holds two 64 x 64
    weight tiles (gate's and up's, or two halves of down's 128 columns)
    and a pass's rows rounded up to whole boxes."""
    rows = -(-min(widest, ME_PASS_ROWS) // ME_BOX_ROWS) * ME_BOX_ROWS
    stage = (2 * ME_TILE_M + rows) * ME_TILE_K * 2
    return min(ME_MAX_STAGES, ME_RING_BYTES // stage)


def moe_experts_plan(N: int, k: int, E: int, D: int, Fd: int,
                     dtype: torch.dtype, sms: int = SMS) -> dict:
    """How ``csrc/moe_experts.cu`` covers a call of N rows, k choices a row,
    E experts of width D and ffn width Fd.

    bf16 takes the persistent tensor-core kernels ("wgmma"): for each entry
    its tiles (64 weight columns of one expert for gate/up, 128 for down),
    its grid (one CTA an SM, at most one a tile), ``passes``, the
    most row passes a tile makes (an expert takes each row at most once, so
    at most N rows, ``ME_PASS_ROWS`` a pass, each pass reading the tile's
    weights once), and the ring's stages at the widest expert N allows.
    float32 takes the FMA kernel ("fma"), one CTA a (64 columns, expert).
    Raises on what the kernels do not take."""
    if min(N, k, E, D, Fd) < 1 or k > E:
        raise ValueError(f"expert kernels need N, k, E, D, F >= 1 and "
                         f"k <= E, got {N}, {k}, {E}, {D}, {Fd}")
    tiles = {"gate_up": -(-Fd // ME_TILE_M) * E,
             "down": -(-D // (2 * ME_TILE_M)) * E}
    if dtype == torch.float32:
        return {"kernel": "fma", "pairs": N * k,
                "grid": {"gate_up": (-(-Fd // FMA_COLS), E),
                         "down": (-(-D // FMA_COLS), E)}}
    if dtype != torch.bfloat16:
        raise TypeError(f"expert kernels take float32 or bfloat16, not "
                        f"{dtype}")
    if D % 8 or Fd % 8:
        raise ValueError(f"the bf16 expert kernels need D and F multiples "
                         f"of 8 (16-byte rows), got {D}, {Fd}")
    return {"kernel": "wgmma", "pairs": N * k, "tiles": tiles,
            "grid": {name: (min(n, sms),) for name, n in tiles.items()},
            "passes": -(-N // ME_PASS_ROWS),
            "stages": ring_stages(N)}


def grouped_experts_reference(xs, ends, order, w_gate, w_up, w_down):
    """Plain version: each expert with a pair runs its three products on its
    rows (the counts read to the host), and the outputs land at their
    pairs."""
    y = xs.new_empty((xs.shape[0], w_down.shape[-1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            xe = xs[start:end]
            gate = F.silu(xe @ w_gate[e])
            y[order[start:end]] = (gate * (xe @ w_up[e])) @ w_down[e]
        start = end
    return y


def _ready(t: torch.Tensor) -> bool:
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def check_kernel_args(xs, ends, order, w_gate, w_up, w_down) -> dict:
    """Raise on inputs ``csrc/moe_experts.cu`` does not take; returns the
    plan (N is P here: a bound on any expert's rows)."""
    P, D = xs.shape
    E, Dw, Fd = w_gate.shape
    plan = moe_experts_plan(P, 1, E, D, Fd, xs.dtype)
    if (Dw != D or w_up.shape != w_gate.shape
            or w_down.shape != (E, Fd, D)):
        raise ValueError(f"expert kernels need w_gate, w_up [E, D, F] and "
                         f"w_down [E, F, D] for xs [P, {D}]; got "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)}")
    if not all(w.dtype == xs.dtype for w in (w_gate, w_up, w_down)):
        raise TypeError(f"expert kernels need one dtype, got {xs.dtype}, "
                        f"{w_gate.dtype}, {w_up.dtype}, {w_down.dtype}")
    if (ends.dtype != torch.int64 or ends.shape != (E,)
            or order.dtype != torch.int64 or order.shape != (P,)):
        raise ValueError(f"expert kernels take ends [{E}] and order [{P}] "
                         f"as int64")
    if len({t.device for t in (xs, ends, order, w_gate, w_up, w_down)}) != 1:
        raise ValueError("expert kernels need every input on one device")
    if not all(_ready(t) for t in (xs, ends, order, w_gate, w_up, w_down)):
        raise ValueError("expert kernels need contiguous, 16-byte aligned "
                         "inputs")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, w_gate, w_up, w_down)):
        raise NotImplementedError("the expert kernels have no backward")
    return plan


def grouped_experts_kernel(xs, ends, order, w_gate, w_up,
                           w_down) -> torch.Tensor:
    """Launch ``csrc/moe_experts.cu`` on CUDA tensors: h [P, F] by
    ``tj_moe_gate_up``, then y [P, D] by ``tj_moe_down``."""
    global gate_up_launches, down_launches
    check_kernel_args(xs, ends, order, w_gate, w_up, w_down)
    P, D = xs.shape
    E, _, Fd = w_gate.shape
    dtype, stream = _build.dtype_code(xs), _build.stream_of(xs)
    lib = _build.library()
    h = xs.new_empty((P, Fd))
    _build.check(lib.tj_moe_gate_up(
        xs.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), ends.data_ptr(),
        h.data_ptr(), P, D, Fd, E, dtype, stream), "moe_experts_gate_up")
    gate_up_launches += 1
    y = xs.new_empty((P, D))
    _build.check(lib.tj_moe_down(
        h.data_ptr(), w_down.data_ptr(), ends.data_ptr(), order.data_ptr(),
        y.data_ptr(), P, Fd, D, E, dtype, stream), "moe_experts_down")
    down_launches += 1
    return y


def _grouped_experts_impl(xs, ends, order, w_gate, w_up, w_down):
    """``tj_torch::moe_experts``: the kernels on a CUDA tensor, the plain
    version on the CPU."""
    if xs.is_cuda:
        return grouped_experts_kernel(xs, ends, order, w_gate, w_up, w_down)
    if xs.device.type != "cpu":
        raise ValueError(f"grouped_experts: no implementation for device "
                         f"{xs.device}")
    return grouped_experts_reference(xs, ends, order, w_gate, w_up, w_down)


# The products as one operator of PyTorch's dispatcher: the profiler links a
# kernel to the operator that was running when it was launched, and a
# ctypes launch under a bare ``record_function`` range links to nothing, so
# without the operator no range (``moe.experts``, the benchmark's step
# ranges) would hold the kernels' device time.  The namespace is
# ``ops/flash_attention.py``'s.
_LIB = torch.library.Library("tj_torch", "FRAGMENT")
_LIB.define("moe_experts(Tensor xs, Tensor ends, Tensor order, "
            "Tensor w_gate, Tensor w_up, Tensor w_down) -> Tensor")
_LIB.impl("moe_experts", _grouped_experts_impl, "CompositeExplicitAutograd")

#: The products' operator.
EXPERTS_OP = torch.ops.tj_torch.moe_experts.default


def grouped_experts(xs, ends, order, w_gate, w_up, w_down) -> torch.Tensor:
    """y [P, D] in pair places (``tj_torch::moe_experts``): the kernels on a
    CUDA tensor, the plain version on the CPU."""
    return EXPERTS_OP(xs, ends, order, w_gate, w_up, w_down)
