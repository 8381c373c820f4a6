"""Flash attention: the CUDA kernels ``csrc/flash_fwd_wgmma.cu`` and
``csrc/flash_fwd.cu`` (forward), ``csrc/flash_bwd_dq_wgmma.cu``,
``csrc/flash_bwd_dkv_wgmma.cu`` and ``csrc/flash_bwd.cu`` (dQ and dK/dV),
each beside its plain version.

Which kernel a CUDA tensor takes goes by dtype and head dim alone
(``kernel_route``): bf16 at head dims 64 and 128 (``llama2_7b``,
``base_124m``) runs the forward, dQ and dK/dV on the tensor cores (wgmma,
TMA, an mbarrier ring); float32 at every head dim (the 124M config at
``LLAMA_DTYPE=float32``) and bf16 at 16 and 32 (the tiny config) run the
f32-FMA kernels.  The launch plans (kernel,
grid, tile order, tensor maps, copies) are plain Python (``fwd_plan``,
``dq_plan``, ``dkv_plan``) so that the CPU tests check them.

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
#: Head dims of the tensor-core kernels, which take bf16 only.  TF32 would
#: break the f32 parity of the training tests at 1e-4, and head dims 16 and
#: 32 are only the tiny config's, so those stay on the f32-FMA kernels.
TC_HEAD_DIMS = (64, 128)
#: Tile rows of the tensor-core forward and dQ, (query rows per CTA, keys
#: per K/V tile), and of dK/dV, (KV rows per CTA, query rows per step).
#: They set the TMA boxes and the grids and are the constants kBM, kBN of
#: csrc/flash_fwd_wgmma.cu and csrc/flash_bwd_dq_wgmma.cu and kBN, kBM of
#: csrc/flash_bwd_dkv_wgmma.cu.
TC_FWD_TILE = (64, 64)
TC_DQ_TILE = (64, 64)
TC_DKV_TILE = (64, 64)
#: Columns of a TMA box: 64 bf16 are the 128 bytes the 128-byte swizzle
#: takes; a head dim of 128 loads as two boxes.
TMA_BOX_D = 64
#: Tiles of the f32-FMA forward by head dim, (query rows per CTA, keys per
#: K/V tile), and its warps a CTA: BQ, BK and NW of csrc/flash_fwd.cu
#: FwdShape (the CPU tests derive them from the source's FwdCfg).
FMA_FWD_TILE = {16: (64, 32), 32: (128, 32), 64: (64, 64), 128: (64, 64)}
FMA_FWD_WARPS = {16: 2, 32: 4, 64: 4, 128: 4}
#: Tiles of the f32-FMA dK/dV by head dim, (KV rows per CTA, query rows per
#: step), and its warps a CTA: BK, BQ and NW of csrc/flash_bwd.cu
#: DkvShape (derived from DkvCfg likewise).
FMA_DKV_TILE = {16: (64, 32), 32: (128, 32), 64: (64, 64), 128: (64, 32)}
FMA_DKV_WARPS = {16: 2, 32: 4, 64: 4, 128: 4}
#: Tiles of the f32-FMA dQ by head dim, (query rows per CTA, keys per K/V
#: tile), and its warps a CTA: BQ, BK and NW of csrc/flash_bwd.cu DqShape
#: (derived from DqCfg likewise).
FMA_DQ_TILE = {16: (64, 32), 32: (128, 32), 64: (64, 64), 128: (64, 32)}
FMA_DQ_WARPS = {16: 2, 32: 4, 64: 4, 128: 4}

#: Kernel launches since the last reset (chip_smoke.py reads them): the
#: forward, dQ and dK/dV count every launch, whichever kernel ran; the
#: ``wgmma_*`` counters count the tensor-core kernels' share.
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0
wgmma_fwd_launches = 0
wgmma_dq_launches = 0
wgmma_dkv_launches = 0


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


def kernel_route(dtype, head_dim: int) -> str:
    """"wgmma" (the tensor-core kernels) for bf16 at ``TC_HEAD_DIMS``, else
    "fma" (the f32-FMA kernels).  By dtype and head dim alone, never by a
    failure."""
    if dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS:
        return "wgmma"
    return "fma"


def _tiles(T: int, rows: int) -> int:
    return -(-T // rows)


def tma_ready(t) -> bool:
    """Whether a tensor map can describe ``t`` [B, T, H, D] in place:
    d-stride 1, and a 16-byte aligned base and t, h and b strides."""
    esize = t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s * esize % 16 == 0 for s in t.stride()[:3]))


def tma_operand(t):
    """``t`` itself where ``tma_ready``, else an explicit contiguous copy
    (fresh, so also aligned).  A [B, H, T, D] storage viewed as [B, T, H,
    D] is read in place; a d-stride other than 1 is copied."""
    return t if tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def fma_ready(t) -> bool:
    """Whether the f32-FMA kernels can copy ``t`` [B, T, H, D] into shared
    memory in 4-element chunks (cp.async) in place: d-stride
    1, and the base and the t, h and b strides 4-element aligned."""
    return (t.stride(3) == 1 and t.data_ptr() % (4 * t.element_size()) == 0
            and all(s % 4 == 0 for s in t.stride()[:3]))


def fma_operand(t):
    """``t`` itself where ``fma_ready``, else an explicit contiguous copy
    (fresh, so also aligned).  A [B, H, T, D] storage viewed as [B, T, H,
    D] is read in place; a d-stride other than 1 is copied."""
    return t if fma_ready(t) else t.clone(memory_format=torch.contiguous_format)


def tensor_map_geometry(shape, strides, esize: int, box_rows: int) -> dict:
    """The 4-D tensor map of a [B, T, H, D] tensor with element ``strides``
    (d-stride 1): dims innermost first (d, t, h, b), the byte strides of t,
    h and b, and the box (``TMA_BOX_D`` x ``box_rows`` x 1 x 1)."""
    B, T, H, D = shape
    sb, st, sh, sd = strides
    if sd != 1:
        raise ValueError(f"a tensor map needs d-stride 1, got {sd}")
    return {"dims": (D, T, H, B),
            "strides": (st * esize, sh * esize, sb * esize),
            "box": (TMA_BOX_D, box_rows, 1, 1)}


def _contiguous_strides(shape) -> Tuple[int, ...]:
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def _maps(tensors: dict, box_rows: dict) -> Tuple[dict, dict]:
    """Copies and tensor maps of the tensor-core kernels' inputs: a tensor
    that is not ``tma_ready`` is copied, and its map describes the copy."""
    copies, maps = {}, {}
    for name, t in tensors.items():
        copies[name] = not tma_ready(t)
        strides = _contiguous_strides(t.shape) if copies[name] \
            else t.stride()
        maps[name] = tensor_map_geometry(t.shape, strides, t.element_size(),
                                         box_rows[name])
    return copies, maps


def _query_tile_plan(q, operands: dict, fma_tiles: dict, fma_warps: dict,
                     tc_tile) -> dict:
    """The plan of a kernel with one CTA per (query tile, b, query head):
    the kernel (``kernel_route``), the grid, with every (b, h) in x and the
    query tile in y from the last (under a causal mask the heaviest) to the
    first, the query tiles in that order, and which ``operands`` are copied
    first.  The f32-FMA kernel's (query rows, keys a tile) and warps come
    from ``fma_tiles`` and ``fma_warps`` by head dim; the tensor-core
    kernel's tile is ``tc_tile``, and the plan adds its tensor maps (q and
    dO boxes of ``tc_tile[0]`` rows, k and v of ``tc_tile[1]``)."""
    B, T, H, D = q.shape
    kernel = kernel_route(q.dtype, D)
    tile = fma_tiles[D] if kernel == "fma" else tc_tile
    n = _tiles(T, tile[0])
    plan = {"kernel": kernel, "grid": (B * H, n),
            "tile_order": [n - 1 - y for y in range(n)]}
    if kernel == "fma":
        return {**plan, "tile": tile, "warps": fma_warps[D],
                "copies": _fma_copies(operands)}
    rows_q, rows_kv = tile
    copies, maps = _maps(operands, {name: rows_kv if name in ("k", "v")
                                    else rows_q for name in operands})
    return {**plan, "copies": copies, "maps": maps}


def _fma_copies(operands: dict) -> dict:
    """Which inputs of an f32-FMA kernel are copied first (not
    ``fma_ready``)."""
    return {name: not fma_ready(t) for name, t in operands.items()}


def fwd_plan(q, k, v) -> dict:
    """How the forward launches on [B, T, H, D] inputs.  Plain Python: the
    wrapper launches by it and the CPU tests check it.  As
    ``_query_tile_plan`` says: the f32-FMA kernel with one CTA of
    ``FMA_FWD_WARPS`` warps per ``FMA_FWD_TILE`` query tile, the
    tensor-core kernel per ``TC_FWD_TILE``."""
    return _query_tile_plan(q, {"q": q, "k": k, "v": v}, FMA_FWD_TILE,
                            FMA_FWD_WARPS, TC_FWD_TILE)


def dq_plan(q, k, v, g) -> dict:
    """As ``fwd_plan`` for dQ (``g`` is dO): ``FMA_DQ_TILE`` and
    ``FMA_DQ_WARPS``, or ``TC_DQ_TILE``."""
    return _query_tile_plan(q, {"q": q, "k": k, "v": v, "g": g},
                            FMA_DQ_TILE, FMA_DQ_WARPS, TC_DQ_TILE)


def dkv_plan(q, k, v, g) -> dict:
    """As ``fwd_plan`` for dK/dV (``g`` is dO): one CTA per (KV tile, b, KV
    head), every (b, KV head) in x and the KV tiles in y in ascending order
    (tile 0 sees every query tile under a causal mask: the heaviest first).
    The f32-FMA kernel's tiles are ``FMA_DKV_TILE`` (KV rows, query rows a
    step) with ``FMA_DKV_WARPS`` warps."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    kernel = kernel_route(q.dtype, D)
    if kernel == "fma":
        rows_kv, rows_q = FMA_DKV_TILE[D]
        n = _tiles(T, rows_kv)
        return {"kernel": kernel, "grid": (B * Hkv, n),
                "tile_order": list(range(n)), "tile": (rows_kv, rows_q),
                "warps": FMA_DKV_WARPS[D],
                "copies": _fma_copies({"q": q, "k": k, "v": v, "g": g})}
    rows_kv, rows_q = TC_DKV_TILE
    n = _tiles(T, rows_kv)
    copies, maps = _maps({"q": q, "k": k, "v": v, "g": g},
                         {"q": rows_q, "k": rows_kv, "v": rows_kv,
                          "g": rows_q})
    return {"kernel": kernel, "grid": (B * Hkv, n),
            "tile_order": list(range(n)), "copies": copies, "maps": maps}


def flash_kernel_with_lse(q, k, v, *, causal: bool, scale: float,
                          window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward kernel ``fwd_plan`` names on CUDA tensors [B, T,
    H, D].  The f32-FMA kernel (``csrc/flash_fwd.cu``) copies 4-element
    chunks of its inputs by their t, h and b strides; the tensor-core
    kernel (``csrc/flash_fwd_wgmma.cu``) reads them through tensor maps
    built from their strides, so neither makes a transpose copy.  An input
    whose d-stride is not 1 (or whose base or strides are not aligned) is
    copied contiguous first (``fma_operand``, ``tma_operand``)."""
    global launches, wgmma_fwd_launches
    check_kernel_args(q, k, v)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _build.library()
    plan = fwd_plan(q, k, v)
    if plan["kernel"] == "wgmma":
        q, k, v = (tma_operand(x) for x in (q, k, v))
        maps = plan["maps"]
        code = lib.tj_flash_fwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, T, H, Hkv, D, int(causal), int(window),
            float(scale), _build.geometry(maps["q"]),
            _build.geometry(maps["k"]), _build.geometry(maps["v"]),
            *out.stride(), _build.stream_of(q))
        _build.check(code, "flash_attention_fwd_wgmma")
        wgmma_fwd_launches += 1
    else:
        q, k, v = (fma_operand(x) for x in (q, k, v))
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
    """Launch the dQ kernel ``dq_plan`` names on CUDA tensors: dq [B, T,
    H, D] in q's dtype.  ``tj_flash_bwd_dq`` (``csrc/flash_bwd.cu``) copies
    4-element chunks of q, k, v and dO by their strides,
    ``tj_flash_bwd_dq_wgmma`` (``csrc/flash_bwd_dq_wgmma.cu``) reads them
    through tensor maps, each after an explicit contiguous copy of any
    input it cannot read in place (``fma_operand``, ``tma_operand``)."""
    global bwd_dq_launches, wgmma_dq_launches
    _check_bwd_args(q, k, v, g, lse, delta)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    lib = _build.library()
    plan = dq_plan(q, k, v, g)
    if plan["kernel"] == "wgmma":
        q, k, v, g = (tma_operand(x) for x in (q, k, v, g))
        maps = plan["maps"]
        code = lib.tj_flash_bwd_dq_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, T, H, Hkv, D, int(causal), int(window), float(scale),
            *(_build.geometry(maps[n]) for n in ("q", "k", "v", "g")),
            *dq.stride(), _build.stream_of(q))
        _build.check(code, "flash_attention_bwd_dq_wgmma")
        wgmma_dq_launches += 1
    else:
        q, k, v, g = (fma_operand(x) for x in (q, k, v, g))
        code = lib.tj_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            B, T, H, Hkv, D, _build.dtype_code(q),
            int(causal), int(window), float(scale),
            *q.stride(), *k.stride(), *v.stride(), *g.stride(),
            *dq.stride(), _build.stream_of(q))
        _build.check(code, "flash_attention_bwd_dq")
    bwd_dq_launches += 1
    return dq


def flash_bwd_dkv_kernel(q, k, v, g, lse, delta, *, causal: bool,
                         scale: float, window: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel ``dkv_plan`` names on CUDA tensors: (dk, dv)
    [B, T, Hkv, D] in k's dtype, the GQA group summed inside the kernel.
    ``tj_flash_bwd_dkv`` (``csrc/flash_bwd.cu``) copies 4-element chunks of
    q, k, v and dO by their strides, ``tj_flash_bwd_dkv_wgmma``
    (``csrc/flash_bwd_dkv_wgmma.cu``) reads them through tensor maps, each
    after an explicit contiguous copy of any input it cannot read in place
    (``fma_operand``, ``tma_operand``)."""
    global bwd_dkv_launches, wgmma_dkv_launches
    _check_bwd_args(q, k, v, g, lse, delta)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    lib = _build.library()
    plan = dkv_plan(q, k, v, g)
    if plan["kernel"] == "wgmma":
        q, k, v, g = (tma_operand(x) for x in (q, k, v, g))
        maps = plan["maps"]
        code = lib.tj_flash_bwd_dkv_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, H, Hkv, D, int(causal), int(window), float(scale),
            *(_build.geometry(maps[n]) for n in ("q", "k", "v", "g")),
            *dk.stride(), *dv.stride(), _build.stream_of(q))
        _build.check(code, "flash_attention_bwd_dkv_wgmma")
        wgmma_dkv_launches += 1
    else:
        q, k, v, g = (fma_operand(x) for x in (q, k, v, g))
        code = lib.tj_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, H, Hkv, D, _build.dtype_code(q),
            int(causal), int(window), float(scale),
            *q.stride(), *k.stride(), *v.stride(), *g.stride(),
            *dk.stride(), *dv.stride(), _build.stream_of(q))
        _build.check(code, "flash_attention_bwd_dkv")
    bwd_dkv_launches += 1
    return dk, dv


def _flash_fwd_impl(q, k, v, causal, scale, window):
    """``tj_torch::flash_fwd``: (out, lse), the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.is_cuda:
        return flash_kernel_with_lse(q, k, v, causal=causal, scale=scale,
                                     window=window)
    return flash_reference_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)


# The forward as one operator of PyTorch's dispatcher.  The ctypes launch
# is invisible to a ``TorchDispatchMode``; as an operator the forward is
# one call a selective-checkpoint policy can save (``models/llama.py``
# remat "attn"), and a saved result is returned without a launch, so it
# adds nothing to the launch counts.  Defined through ``torch.library``'s
# schema API: ``torch.library.custom_op`` wraps the same registration, but
# its first call imports torch._dynamo, torch.distributed.tensor and sympy
# (2.8 s of a first step on a CPU).
_LIB = torch.library.Library("tj_torch", "DEF")
_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "float scale, int window) -> (Tensor, Tensor)")
_LIB.impl("flash_fwd", _flash_fwd_impl, "CompositeExplicitAutograd")

#: The forward's operator, as a selective-checkpoint policy sees it.
FWD_OP = torch.ops.tj_torch.flash_fwd.default


def _flash_forward(q, k, v, causal, scale, window):
    return FWD_OP(q, k, v, causal, scale, window)


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
