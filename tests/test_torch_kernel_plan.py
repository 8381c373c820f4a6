"""The kernels' launch plans, on the CPU (no card, no JAX).

Which kernel a call takes, its grid and tile order, when an input is copied
and the tensor maps the tensor-core kernels are built from are decided in
plain Python (``ops/flash_attention.py`` ``fwd_plan``, ``dq_plan`` and
``dkv_plan``; ``ops/fused.py`` ``rmsnorm_plan``;
``ops/decode_attention.py`` ``decode_attention_plan``;
``ops/moe_experts.py`` ``moe_experts_plan``), so they are checked here;
the kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import importlib
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from trainingjob_operator_tpu_torch import ops
from trainingjob_operator_tpu_torch.ops import _build, fused
from trainingjob_operator_tpu_torch.ops import decode_attention as da
from trainingjob_operator_tpu_torch.ops import moe_experts as me

flash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")


def _qkv(B, T, H, Hkv, D, dtype=torch.bfloat16):
    return (torch.zeros(B, T, H, D, dtype=dtype),
            torch.zeros(B, T, Hkv, D, dtype=dtype),
            torch.zeros(B, T, Hkv, D, dtype=dtype))


@pytest.mark.parametrize("dtype,D,kernel", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "fma"),
    (torch.bfloat16, 16, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 64, "fma"),
    (torch.float32, 16, "fma"),
])
def test_the_kernel_goes_by_dtype_and_head_dim(dtype, D, kernel):
    assert flash.kernel_route(dtype, D) == kernel
    q, k, v = _qkv(1, 40, 4, 2, D, dtype)
    assert flash.fwd_plan(q, k, v)["kernel"] == kernel
    assert flash.dq_plan(q, k, v, q)["kernel"] == kernel
    assert flash.dkv_plan(q, k, v, q)["kernel"] == kernel


@pytest.mark.parametrize("T,tiles", [(64, 1), (130, 3), (200, 4),
                                     (1000, 16), (4096, 64)])
def test_forward_grid_issues_the_heaviest_query_tiles_first(T, tiles):
    q, k, v = _qkv(2, T, 32, 8, 128)
    plan = flash.fwd_plan(q, k, v)
    # Every (b, h) in x; the 64-row query tile in y, last tile first: under
    # a causal mask the last tile has the most KV tiles.
    assert flash.TC_FWD_TILE == (64, 64)
    assert plan["grid"] == (2 * 32, tiles)
    assert plan["tile_order"] == list(range(tiles - 1, -1, -1))


@pytest.mark.parametrize("T,tiles", [(64, 1), (130, 3), (2048, 32),
                                     (4096, 64)])
def test_dkv_grid_issues_the_heaviest_kv_tiles_first(T, tiles):
    q, k, v = _qkv(1, T, 32, 8, 128)
    plan = flash.dkv_plan(q, k, v, q)
    # One CTA per (64-row KV tile, b, KV head): KV tile 0 sees every query
    # tile under a causal mask and is issued first.
    assert plan["grid"] == (8, tiles)
    assert plan["tile_order"] == list(range(tiles))


@pytest.mark.parametrize("T,tiles", [(64, 1), (130, 3), (1000, 16),
                                     (4096, 64)])
def test_dq_grid_issues_the_heaviest_query_tiles_first(T, tiles):
    q, k, v = _qkv(2, T, 32, 8, 128)
    plan = flash.dq_plan(q, k, v, q)
    # One CTA per (64-row query tile, b, query head): every (b, h) in x,
    # the last query tile (the most KV tiles under a causal mask) first.
    assert flash.TC_DQ_TILE == (64, 64)
    assert plan["grid"] == (2 * 32, tiles)
    assert plan["tile_order"] == list(range(tiles - 1, -1, -1))


def test_fma_grids_are_those_of_the_f32_kernels():
    q, k, v = _qkv(2, 130, 4, 2, 16, torch.float32)
    # Forward: (b, h) in x, 64-row query tiles in y, the last first.
    assert flash.fwd_plan(q, k, v)["grid"] == (8, 3)
    assert flash.fwd_plan(q, k, v)["tile_order"] == [2, 1, 0]
    # dQ: as the forward.
    assert flash.dq_plan(q, k, v, q)["grid"] == (8, 3)
    assert flash.dq_plan(q, k, v, q)["tile_order"] == [2, 1, 0]
    # dK/dV: (b, KV head) in x, 64-row KV tiles in y, tile 0 first.
    assert flash.dkv_plan(q, k, v, q)["grid"] == (4, 3)
    assert flash.dkv_plan(q, k, v, q)["tile_order"] == [0, 1, 2]


CSRC = Path(flash.__file__).resolve().parents[1] / "csrc"


def _cfg(source: str, struct: str) -> dict:
    """{D: {constant: value}} of the ``struct<D>`` specialisations in
    ``csrc/<source>``."""
    text = (CSRC / source).read_text()
    found = re.findall(rf"struct {struct}<(\d+)> {{\s*static constexpr int "
                       r"([^;]*);", text)
    return {int(D): {name.strip(): int(value) for name, value in
                     (field.split("=") for field in body.split(","))}
            for D, body in found}


def fma_shapes(D: int):
    """The f32-FMA kernels' tiles at head dim ``D`` as the sources define
    them: the forward's (BQ, BK) and NW (csrc/flash_fwd.cu FwdShape from
    FwdCfg), dK/dV's (BK, BQ) and NW (csrc/flash_bwd.cu DkvShape from
    DkvCfg)."""
    f = _cfg("flash_fwd.cu", "FwdCfg")[D]
    b = _cfg("flash_bwd.cu", "DkvCfg")[D]
    fwd_tile = (f["NW"] * f["MR"] * (32 // f["TC"]), f["TC"] * f["SC"])
    dkv_tile = (b["NW"] * b["RW"], (32 // b["TRs"]) * b["MCs"])
    return fwd_tile, f["NW"], dkv_tile, b["NW"]


def fma_dq_shape(D: int):
    """The f32-FMA dQ's (BQ, BK) and NW at head dim ``D`` (csrc/flash_bwd.cu
    DqShape from DqCfg)."""
    c = _cfg("flash_bwd.cu", "DqCfg")[D]
    return (c["NW"] * c["MR"] * (32 // c["TC"]), c["TC"] * c["SC"]), c["NW"]


@pytest.mark.parametrize("D", flash.KERNEL_HEAD_DIMS)
def test_fma_dq_tiles_are_those_of_the_source(D):
    # FMA_DQ_TILE and FMA_DQ_WARPS copy DqCfg: a change to the source shows
    # here.
    cfg = _cfg("flash_bwd.cu", "DqCfg")
    assert set(cfg) == set(flash.KERNEL_HEAD_DIMS)
    tile, warps = fma_dq_shape(D)
    assert flash.FMA_DQ_TILE[D] == tile
    assert flash.FMA_DQ_WARPS[D] == warps
    # dq_smem_bytes at float32 (Q, dO, ST stages of K and V, dZ, lse and
    # delta) stays within the 227 KB a CTA may take.
    rows_q, rows_kv = tile
    smem = 4 * ((2 * rows_q + 2 * cfg[D]["ST"] * rows_kv) * D
                + rows_q * rows_kv + 2 * rows_q)
    assert cfg[D]["ST"] in (1, 2) and smem <= 232448


@pytest.mark.parametrize("D", flash.KERNEL_HEAD_DIMS)
def test_fma_tiles_are_those_of_the_sources(D):
    # The plans' tile tables copy FwdCfg and DkvCfg: a change to a source
    # shows here.
    assert set(_cfg("flash_fwd.cu", "FwdCfg")) == set(flash.KERNEL_HEAD_DIMS)
    assert set(_cfg("flash_bwd.cu", "DkvCfg")) == set(flash.KERNEL_HEAD_DIMS)
    fwd_tile, fwd_warps, dkv_tile, dkv_warps = fma_shapes(D)
    assert flash.FMA_FWD_TILE[D] == fwd_tile
    assert flash.FMA_FWD_WARPS[D] == fwd_warps
    assert flash.FMA_DKV_TILE[D] == dkv_tile
    assert flash.FMA_DKV_WARPS[D] == dkv_warps


@pytest.mark.parametrize("dtype,D", [
    (torch.float32, 16), (torch.bfloat16, 16), (torch.float32, 32),
    (torch.bfloat16, 32), (torch.float32, 64), (torch.float32, 128)])
@pytest.mark.parametrize("T", [1000, 1023, 1024, 2048])
def test_fma_tiles_by_head_dim(dtype, D, T):
    fwd_tile, fwd_warps, dkv_tile, dkv_warps = fma_shapes(D)
    B, H, Hkv = 8, 12, 4
    q, k, v = _qkv(B, T, H, Hkv, D, dtype)
    fwd = flash.fwd_plan(q, k, v)
    assert (fwd["kernel"], fwd["tile"], fwd["warps"]) == (
        "fma", fwd_tile, fwd_warps)
    n_q = -(-T // fwd_tile[0])
    assert fwd["grid"] == (B * H, n_q)
    dkv = flash.dkv_plan(q, k, v, q)
    assert (dkv["kernel"], dkv["tile"], dkv["warps"]) == (
        "fma", dkv_tile, dkv_warps)
    n_kv = -(-T // dkv_tile[0])
    assert dkv["grid"] == (B * Hkv, n_kv)
    # Every query row and every KV row has its CTA; the last tile of a
    # ragged T is partly past the end.
    assert fwd["grid"][1] * fwd_tile[0] >= T > (fwd["grid"][1] - 1) \
        * fwd_tile[0]
    assert dkv["grid"][1] * dkv_tile[0] >= T > (dkv["grid"][1] - 1) \
        * dkv_tile[0]
    # A KV tile is a whole number of the steps' query tiles, so a causal
    # CTA starts its loop at the step of its own first row.
    assert dkv_tile[0] % dkv_tile[1] == 0
    dq_tile, dq_warps = fma_dq_shape(D)
    dq = flash.dq_plan(q, k, v, q)
    assert (dq["kernel"], dq["tile"], dq["warps"]) == ("fma", dq_tile,
                                                       dq_warps)
    assert dq["grid"] == (B * H, -(-T // dq_tile[0]))


@pytest.mark.parametrize("T,tiles", [(32, 1), (130, 3), (1000, 16),
                                     (1024, 16), (2048, 32)])
def test_fma_dkv_issues_the_heaviest_kv_tiles_first(T, tiles):
    # The 124M shape at float32: under a causal mask KV tile y sees the
    # query rows from 64 y on, so work falls with y and the grid issues
    # y = 0 first (every (b, KV head) of a tile before the next tile).
    q, k, v = _qkv(8, T, 12, 12, 64, torch.float32)
    plan = flash.dkv_plan(q, k, v, q)
    assert plan["grid"] == (8 * 12, tiles)
    assert plan["tile_order"] == list(range(tiles))
    rows_kv = plan["tile"][0]
    work = [sum(T - max(r, y * rows_kv) for r in range(y * rows_kv,
                                                      min(T, (y + 1)
                                                          * rows_kv)))
            for y in plan["tile_order"]]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("B,T,H,Hkv,D", [
    # The 124M f32 shape: 1536 CTAs.
    (8, 1024, 12, 12, 64),
    # GQA 32/8 at head dim 128, batch 1: 8 x 32 = 256 CTAs.
    (1, 2048, 32, 8, 128),
    (1, 1000, 32, 8, 128),
    # The tiny config (4/2 heads of 16, T 64): 8 CTAs.
    (4, 64, 4, 2, 16),
    (1, 1000, 32, 32, 16),
    (1, 4096, 32, 32, 128),
])
def test_fma_dkv_grid_is_one_cta_per_kv_tile(B, T, H, Hkv, D):
    # Each CTA walks every query tile its KV tile sees, for the whole GQA
    # group, and writes its rows of dK and dV once: no partial sums.
    q, k, v = _qkv(B, T, H, Hkv, D, torch.float32)
    plan = flash.dkv_plan(q, k, v, q)
    rows_kv = fma_shapes(D)[2][0]
    assert plan["grid"] == (B * Hkv, -(-T // rows_kv))
    assert plan["tile_order"] == list(range(plan["grid"][1]))


@pytest.mark.parametrize("T,tiles", [(64, 1), (130, 3), (1000, 16),
                                     (1023, 16)])
def test_fma_forward_issues_the_heaviest_query_tiles_first(T, tiles):
    q, k, v = _qkv(8, T, 12, 12, 64, torch.float32)
    plan = flash.fwd_plan(q, k, v)
    assert plan["grid"] == (8 * 12, tiles)
    assert plan["tile_order"] == list(range(tiles - 1, -1, -1))


@pytest.mark.parametrize("T,tiles", [(64, 1), (130, 3), (1000, 16),
                                     (1024, 16), (1023, 16)])
def test_fma_dq_issues_the_heaviest_query_tiles_first(T, tiles):
    # The 124M shape at float32: under a causal mask query tile n walks the
    # K/V tiles up to its last row, so a CTA's loop grows with n and the
    # grid issues the last tile first (every (b, h) of a tile before the
    # next tile).
    q, k, v = _qkv(8, T, 12, 12, 64, torch.float32)
    plan = flash.dq_plan(q, k, v, q)
    assert plan["grid"] == (8 * 12, tiles)
    assert plan["tile_order"] == list(range(tiles - 1, -1, -1))
    rows_q, rows_kv = plan["tile"]
    work = [min(-(-(n + 1) * rows_q // rows_kv), -(-T // rows_kv))
            for n in plan["tile_order"]]
    assert work == sorted(work, reverse=True)


def test_tensor_maps_of_contiguous_inputs():
    B, T, H, Hkv, D = 2, 200, 8, 2, 128
    q, k, v = _qkv(B, T, H, Hkv, D)
    plan = flash.fwd_plan(q, k, v)
    assert plan["copies"] == {"q": False, "k": False, "v": False}
    # dims (d, t, h, b); byte strides of t, h and b; 64 x rows boxes.
    assert plan["maps"]["q"] == {"dims": (D, T, H, B),
                                 "strides": (H * D * 2, D * 2, T * H * D * 2),
                                 "box": (64, 64, 1, 1)}
    assert plan["maps"]["k"] == {"dims": (D, T, Hkv, B),
                                 "strides": (Hkv * D * 2, D * 2,
                                             T * Hkv * D * 2),
                                 "box": (64, 64, 1, 1)}
    assert plan["maps"]["v"] == plan["maps"]["k"]
    dkv = flash.dkv_plan(q, k, v, q)
    assert flash.TC_DKV_TILE == (64, 64)
    for name in ("q", "k", "v", "g"):
        assert dkv["maps"][name]["box"] == (64, 64, 1, 1)
    assert dkv["maps"]["g"]["strides"] == plan["maps"]["q"]["strides"]
    dq = flash.dq_plan(q, k, v, q)
    assert dq["copies"] == {"q": False, "k": False, "v": False, "g": False}
    assert {n: dq["maps"][n] for n in ("q", "k", "v")} == plan["maps"]
    assert dq["maps"]["g"] == plan["maps"]["q"]


def test_a_bhtd_view_is_read_in_place():
    # [B, H, T, D] storage viewed as [B, T, H, D]: the maps take its
    # strides and no copy is made.
    B, T, H, D = 1, 130, 4, 64
    q, k, v = (torch.zeros(B, H, T, D, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    plan = flash.fwd_plan(q, k, v)
    assert plan["copies"] == {"q": False, "k": False, "v": False}
    assert plan["maps"]["q"]["strides"] == (D * 2, T * D * 2, H * T * D * 2)
    assert plan["maps"]["q"]["dims"] == (D, T, H, B)
    assert not flash.dkv_plan(q, k, v, q)["copies"]["g"]
    dq = flash.dq_plan(q, k, v, q)
    assert not any(dq["copies"].values())
    assert dq["maps"]["g"]["strides"] == (D * 2, T * D * 2, H * T * D * 2)


def test_a_view_with_d_stride_not_one_is_copied():
    B, T, H, D = 1, 64, 4, 64
    q = torch.zeros(B, T, H, D, dtype=torch.bfloat16)
    k = torch.zeros(B, T, D, H, dtype=torch.bfloat16).transpose(2, 3)
    assert k.stride(3) != 1
    plan = flash.fwd_plan(q, k, k)
    assert plan["copies"] == {"q": False, "k": True, "v": True}
    # The map describes the contiguous copy.
    assert plan["maps"]["k"]["strides"] == (H * D * 2, D * 2, T * H * D * 2)
    assert flash.dkv_plan(q, k, k, q)["copies"] == {
        "q": False, "k": True, "v": True, "g": False}
    dq = flash.dq_plan(q, k, k, q)
    assert dq["copies"] == {"q": False, "k": True, "v": True, "g": False}
    assert dq["maps"]["k"]["strides"] == (H * D * 2, D * 2, T * H * D * 2)
    # dO with d-stride 2 (every other column of a wider tensor) is copied.
    g = torch.zeros(B, T, H, 2 * D, dtype=torch.bfloat16)[..., ::2]
    assert flash.dq_plan(q, q, q, g)["copies"]["g"]


def test_a_misaligned_view_is_copied():
    # An offset of one element leaves the base off the 16-byte grid.
    base = torch.zeros(1 + 64 * 4 * 64, dtype=torch.bfloat16)
    q = base[1:].view(1, 64, 4, 64)
    assert q.data_ptr() % 16
    k = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    plan = flash.fwd_plan(q, k, k)
    assert plan["copies"] == {"q": True, "k": False, "v": False}
    assert flash.dq_plan(q, k, k, q)["copies"] == {
        "q": True, "k": False, "v": False, "g": True}


def test_copies_for_the_kernel_are_fresh_and_contiguous():
    base = torch.arange(1 + 64 * 4 * 64, dtype=torch.float32).to(
        torch.bfloat16)
    q = base[1:].view(1, 64, 4, 64)
    got = flash.tma_operand(q)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, q)
    k = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    assert flash.tma_operand(k) is k


@pytest.mark.parametrize("plan_of", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 32),
                                     (torch.float32, 128)])
def test_the_fma_plan_has_no_maps(plan_of, dtype, D):
    # The f32-FMA kernels take no tensor maps.  They copy 4-element chunks
    # (cp.async): contiguous inputs are read in place, and an input with
    # d-stride 2 is copied first.
    q, k, v = _qkv(1, 64, 4, 4, D, dtype)
    wide = torch.zeros(1, 64, 4, 2 * D, dtype=dtype)[..., ::2]

    def plan(q, k, v):
        return (flash.fwd_plan(q, k, v) if plan_of == "fwd"
                else getattr(flash, f"{plan_of}_plan")(q, k, v, q))
    got = plan(q, k, v)
    assert got["kernel"] == "fma"
    assert "maps" not in got
    names = ["q", "k", "v"] + (["g"] if plan_of != "fwd" else [])
    assert got["copies"] == dict.fromkeys(names, False)
    assert plan(q, wide, wide)["copies"] == {
        name: name in ("k", "v") for name in names}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_fma_copy_rule(dtype):
    B, T, H, D = 1, 70, 4, 32
    # [B, H, T, D] storage viewed as [B, T, H, D]: read in place.
    bhtd = torch.zeros(B, H, T, D, dtype=dtype).transpose(1, 2)
    assert flash.fma_ready(bhtd) and flash.fma_operand(bhtd) is bhtd
    # A base one element off the 4-element grid, and a t-stride that is not
    # a multiple of 4 (rows of 4 * 32 + 2 elements): copied.
    base = torch.arange(1 + B * T * H * D, dtype=torch.float32).to(dtype)
    off = base[1:].view(B, T, H, D)
    padded = torch.zeros(B, T, H * D + 2, dtype=dtype)[..., :H * D] \
        .view(B, T, H, D)
    for t in (off, padded):
        assert not flash.fma_ready(t)
        got = flash.fma_operand(t)
        assert got.is_contiguous() and torch.equal(got, t)
        assert got.data_ptr() % (4 * got.element_size()) == 0
    q, k, v = _qkv(B, T, H, H, D, dtype)
    assert flash.fwd_plan(off, k, v)["copies"] == {
        "q": True, "k": False, "v": False}
    assert flash.dkv_plan(q, k, v, padded)["copies"] == {
        "q": False, "k": False, "v": False, "g": True}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_fma_dq_copy_rule(dtype):
    # dq_plan's copies follow fma_ready for each of q, k, v and dO.
    B, T, H, D = 1, 70, 4, 32
    base = torch.arange(1 + B * T * H * D, dtype=torch.float32).to(dtype)
    off = base[1:].view(B, T, H, D)
    padded = torch.zeros(B, T, H * D + 2, dtype=dtype)[..., :H * D] \
        .view(B, T, H, D)
    wide = torch.zeros(B, T, H, 2 * D, dtype=dtype)[..., ::2]
    bhtd = torch.zeros(B, H, T, D, dtype=dtype).transpose(1, 2)
    q, k, v = _qkv(B, T, H, H, D, dtype)
    assert flash.dq_plan(q, k, v, q)["copies"] == dict.fromkeys(
        ("q", "k", "v", "g"), False)
    assert flash.dq_plan(off, wide, v, padded)["copies"] == {
        "q": True, "k": True, "v": False, "g": True}
    assert flash.dq_plan(bhtd, k, padded, bhtd)["copies"] == {
        "q": False, "k": False, "v": True, "g": False}
    for t in (off, padded, wide, bhtd, q):
        assert flash.dq_plan(t, k, v, q)["copies"]["q"] == \
            (not flash.fma_ready(t))


class _Lib:
    """Stands in for the kernel library: records the entry points called
    and their arguments, and returns ``code`` from each."""

    def __init__(self, code=0, missing=()):
        self.calls, self.args, self.code, self.missing = [], [], code, \
            missing

    def __getattr__(self, name):
        if name in self.missing:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.code
        return entry

    def tj_error_string(self, code):
        return b"stand-in failure"


@pytest.fixture
def lib(monkeypatch):
    """Route the wrappers' launches to a stand-in library (CPU tensors have
    no CUDA stream; the wrappers' dispatch is what is under test)."""
    fake = _Lib()
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    ops.reset_launch_counts()
    yield fake
    ops.reset_launch_counts()


def _dq_args(dtype, D, T=70):
    q, k, v = _qkv(1, T, 4, 2, D, dtype)
    lse = torch.zeros(1, 4, T)
    return (q, k, v, q, lse, lse), dict(causal=True, scale=D ** -0.5,
                                        window=0)


@pytest.mark.parametrize("dtype,D,entry", [
    (torch.bfloat16, 128, "tj_flash_bwd_dq_wgmma"),
    (torch.bfloat16, 64, "tj_flash_bwd_dq_wgmma"),
    (torch.bfloat16, 32, "tj_flash_bwd_dq"),
    (torch.float32, 128, "tj_flash_bwd_dq"),
])
def test_dq_launches_the_entry_its_route_names(lib, dtype, D, entry):
    args, opts = _dq_args(dtype, D)
    with torch.no_grad():
        dq = flash.flash_bwd_dq_kernel(*args, **opts)
    assert lib.calls == [entry]
    assert dq.shape == args[0].shape and dq.dtype == dtype
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dq_wgmma"] == int(
        entry.endswith("wgmma"))


@pytest.mark.parametrize("D", [64, 128])
def test_fma_forward_and_dkv_launch_on_chunk_ready_inputs(lib, D):
    T, H = 70, 4
    q = torch.randn(1, T, H, D)
    # k and v with d-stride 2: the wrapper hands the kernel contiguous
    # copies (d-stride 1 in the strides it passes).
    k, v = (torch.randn(1, T, H, 2 * D)[..., ::2] for _ in range(2))
    opts = dict(causal=True, scale=D ** -0.5, window=0)
    with torch.no_grad():
        flash.flash_kernel_with_lse(q, k, v, **opts)
        lse = torch.zeros(1, H, T)
        flash.flash_bwd_dkv_kernel(q, k, v, q, lse, lse, **opts)
    assert lib.calls == ["tj_flash_fwd", "tj_flash_bwd_dkv"]
    fwd_args, dkv_args = lib.args
    # (b, t, h, d) strides of q, k, v, o after the 14 leading arguments.
    assert fwd_args[14:30] == 4 * (T * H * D, H * D, D, 1)
    assert fwd_args[1] != k.data_ptr()
    # dK/dV: the strides of q, k, v, dO, dk, dv after the 17 leading
    # arguments.
    assert dkv_args[17:41] == 6 * (T * H * D, H * D, D, 1)
    assert dkv_args[2] != k.data_ptr()
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_fwd_wgmma"] == 0


@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 32)])
def test_fma_dq_launches_on_chunk_ready_inputs(lib, dtype, D):
    T, H = 70, 4
    q = torch.randn(1, T, H, D).to(dtype)
    g = torch.randn(1, T, H, D).to(dtype)
    # k and v with d-stride 2 and q one element off the 4-element grid:
    # the wrapper hands the kernel contiguous copies (d-stride 1 in the
    # strides it passes, fresh pointers); dO is read in place.
    k, v = (torch.randn(1, T, H, 2 * D).to(dtype)[..., ::2]
            for _ in range(2))
    q_off = torch.cat([torch.zeros(1, dtype=dtype), q.flatten()])[1:] \
        .view(1, T, H, D)
    assert not flash.fma_ready(q_off)
    lse = torch.zeros(1, H, T)
    with torch.no_grad():
        dq = flash.flash_bwd_dq_kernel(q_off, k, v, g, lse, lse,
                                       causal=True, scale=D ** -0.5,
                                       window=0)
    assert lib.calls == ["tj_flash_bwd_dq"]
    (args,) = lib.args
    # (b, t, h, d) strides of q, k, v, dO and dq after the 16 leading
    # arguments.
    assert args[16:36] == 5 * (T * H * D, H * D, D, 1)
    assert args[0] != q_off.data_ptr()
    assert args[1] != k.data_ptr() and args[2] != v.data_ptr()
    assert args[3] == g.data_ptr() and args[6] == dq.data_ptr()
    assert args[7:15] == (1, T, H, H, D, _build.dtype_code(q), 1, 0)
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dq_wgmma"] == 0


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.float32, 16)])
def test_a_failed_dq_launch_raises_with_no_fallback(lib, dtype, D):
    lib.code = 700
    args, opts = _dq_args(dtype, D)
    with pytest.raises(RuntimeError, match="launch failed"):
        flash.flash_bwd_dq_kernel(*args, **opts)
    # One entry tried, none after it, and nothing counted.
    assert len(lib.calls) == 1
    assert ops.launch_counts()["flash_attention_bwd_dq"] == 0


def test_a_dq_kernel_missing_from_the_library_raises(lib):
    lib.missing = ("tj_flash_bwd_dq_wgmma",)
    args, opts = _dq_args(torch.bfloat16, 64)
    with pytest.raises(AttributeError):
        flash.flash_bwd_dq_kernel(*args, **opts)
    assert lib.calls == []


@pytest.mark.parametrize("rows,d,esize,plan", [
    # Llama-2-7B rows (4096 bf16): 8 warps of 2 vectors a thread, one row a
    # CTA, for a serve tick, a 2048-token prefill and the training
    # microbatch alike.
    (4, 4096, 2, {"team": 8, "per": 2, "grid": 4}),
    (2048, 4096, 2, {"team": 8, "per": 2, "grid": 2048}),
    (4096, 4096, 2, {"team": 8, "per": 2, "grid": 4096}),
    # Wider rows keep 8 warps and hold more a thread.
    (4, 4096, 4, {"team": 8, "per": 4, "grid": 4}),
    (3, 8192, 2, {"team": 8, "per": 4, "grid": 3}),
    (1, 32768, 2, {"team": 8, "per": 16, "grid": 1}),
    # Narrow rows (base_124m's 768, the tiny config's 64, a head's 128):
    # smaller teams, several rows a CTA of 8 warps.
    (5, 768, 2, {"team": 2, "per": 2, "grid": 2}),
    (13, 64, 4, {"team": 1, "per": 1, "grid": 2}),
    (1000, 128, 2, {"team": 1, "per": 1, "grid": 125}),
    (8192, 128, 2, {"team": 1, "per": 1, "grid": 1024}),
])
def test_rmsnorm_plan_holds_each_row_in_registers(rows, d, esize, plan):
    got = fused.rmsnorm_plan(rows, d, esize)
    assert got == plan
    # Every 16-byte vector of a row has a thread, each CTA whole rows.
    assert 32 * got["team"] * got["per"] >= d * esize // 16
    assert fused.MAX_CTA_WARPS % got["team"] == 0
    assert got["grid"] * fused.MAX_CTA_WARPS // got["team"] >= rows


def test_rmsnorm_plan_refuses_a_row_wider_than_a_cta_holds():
    with pytest.raises(ValueError, match="at most 32768"):
        fused.rmsnorm_plan(1, 32768 + 8, 2)
    with pytest.raises(ValueError, match="at most 16384"):
        fused.rmsnorm_plan(1, 16384 + 8, 4)


@pytest.mark.parametrize("rows,esize,copies", [(4, 2, 3200), (2048, 2, 7),
                                               (4096, 2, 4), (2048, 4, 4)])
def test_rmsnorm_timing_rotates_through_twice_the_l2(rows, esize, copies):
    # chip_smoke.check_rmsnorm's rotation at an H100's 50 MiB L2: no call
    # finds its input in L2.
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    l2_bytes = 50 * 2 ** 20
    nbytes = rows * 4096 * esize
    assert smoke.copies_for(nbytes, l2_bytes) == copies
    assert copies * nbytes >= 2 * l2_bytes
    assert (copies - 1) * nbytes < 2 * l2_bytes or copies == 2


def test_decode_plan_covers_the_card_at_the_serving_shapes():
    # Mistral-7B's slice in the serving cell: 32 slots of 2048, GQA 32/8,
    # head dim 128, bf16.  8 splits of 256 slots: 2,048 CTAs, the 132 SMs
    # covered many times over, and still more than twice when half the
    # CTAs find their chunk past the row's position.
    plan = da.decode_attention_plan(32, 8, 2048, 128, 4, torch.bfloat16)
    assert plan["tile"] == 32 and plan["vec"] == 8
    assert (plan["chunk"], plan["splits"]) == (256, 8)
    assert plan["grid"] == (256, 8) and plan["group_slots"] == 4
    assert plan["grid"][0] * plan["grid"][1] // 2 >= 2 * da.SMS
    # generate's one row: no CTA takes fewer than MIN_TILES tiles, so the
    # full cache splits 8 ways, not 64 of one tile each.
    one = da.decode_attention_plan(1, 8, 2048, 128, 4, torch.bfloat16)
    assert (one["chunk"], one["splits"]) == (256, 8)


@pytest.mark.parametrize("t,window,reach,splits", [
    # One row, bf16, head dim 128: chunks of 8 tiles (256 slots) over the
    # slots the batch sees at an int t, and one split (no merging launch)
    # where they fit in one chunk.
    (100, 0, 101, 1), (512, 0, 513, 3), (1500, 0, 1501, 6),
    (2047, 0, 2048, 8), (5000, 0, 2048, 8), (5000, 300, 300, 2),
    (0, 0, 1, 1), (-3, 0, 1, 1)])
def test_decode_plan_covers_only_what_an_int_t_sees(t, window, reach,
                                                    splits):
    assert da.visible_slots(t, 2048, window) == reach
    plan = da.decode_attention_plan(1, 8, 2048, 128, 4, torch.bfloat16,
                                    reach)
    assert plan["chunk"] == 8 * plan["tile"] == 256
    assert plan["splits"] == splits and plan["grid"] == (8, splits)


def test_decode_plan_covers_every_slot_for_per_row_positions():
    # A tensor of positions gives reach 0: the splits cover all S, as
    # without a reach.
    ts = torch.tensor([3, 9])
    assert da.visible_slots(ts, 2048) == 0
    assert da.decode_attention_plan(2, 8, 2048, 128, 4, torch.bfloat16,
                                    0) == da.decode_attention_plan(
        2, 8, 2048, 128, 4, torch.bfloat16)


@pytest.mark.parametrize("B,Hkv,S", [(32, 8, 2048), (32, 8, 300),
                                     (4, 2, 300), (1, 8, 2048), (2, 2, 10),
                                     (3, 1, 1), (64, 8, 4097)])
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 16),
                                     (torch.float32, 128),
                                     (torch.float32, 32)])
def test_decode_plan_splits_cover_every_slot_once(B, Hkv, S, dtype, D):
    # Splits of whole tiles cover S, ragged or not, and the last one holds
    # at least one slot.
    plan = da.decode_attention_plan(B, Hkv, S, D, 2, dtype)
    assert plan["chunk"] % plan["tile"] == 0
    assert (plan["splits"] - 1) * plan["chunk"] < S <= plan["splits"] * \
        plan["chunk"]
    assert plan["grid"] == (B * Hkv, plan["splits"])


@pytest.mark.parametrize("dtype,D,tile", [
    # 4 rows a thread, 4 warps, 32 / (D / vector) positions a warp row.
    (torch.bfloat16, 128, 32), (torch.bfloat16, 64, 64),
    (torch.bfloat16, 32, 128), (torch.bfloat16, 16, 256),
    (torch.float32, 128, 16), (torch.float32, 64, 32),
    (torch.float32, 32, 64), (torch.float32, 16, 128)])
def test_decode_plan_tiles_by_head_dim(dtype, D, tile):
    assert da.decode_attention_plan(1, 1, 8, D, 1, dtype)["tile"] == tile


@pytest.mark.parametrize("group,slots", [(1, 1), (2, 2), (3, 4), (4, 4),
                                         (5, 8), (8, 8)])
def test_decode_plan_rounds_the_group_up_to_an_instance(group, slots):
    plan = da.decode_attention_plan(2, 2, 64, 64, group, torch.bfloat16)
    assert plan["group_slots"] == slots


@pytest.mark.parametrize("D,group,dtype,err", [
    (24, 4, torch.bfloat16, ValueError), (256, 4, torch.bfloat16, ValueError),
    (128, 0, torch.bfloat16, ValueError), (128, 9, torch.float32, ValueError),
    (128, 4, torch.float16, TypeError)])
def test_decode_plan_refuses_what_the_kernel_does_not_take(D, group, dtype,
                                                           err):
    with pytest.raises(err):
        da.decode_attention_plan(32, 8, 2048, D, group, dtype)


def test_decode_plan_constants_are_those_of_the_source():
    src = (_build.SRC_DIR / "decode_attention.cu").read_text()
    for name, value in (("kWarps", da.DA_WARPS), ("kRows", da.DA_ROWS),
                        ("kStages", da.DA_STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_launches_one_entry_on_the_cache_in_place(
        lib, per_row):
    B, S, Hkv, group, D = 2, 300, 2, 4, 128
    q = torch.zeros(B, 1, Hkv * group, D, dtype=torch.bfloat16)
    cache = torch.zeros(3, B, S, Hkv, D, dtype=torch.bfloat16)
    k, v = cache[1], cache[2]
    t = torch.tensor([5, 299]) if per_row else 17
    out = da.decode_attention_kernel(q, k, v, t, group, window=0)
    assert lib.calls == ["tj_decode_attention"]
    (args,) = lib.args
    plan = da.decode_attention_plan(B, Hkv, S, D, group, torch.bfloat16,
                                    0 if per_row else 18)
    # The cache slices are read where they lie; the positions stay on the
    # device (a pointer) or pass as the one int.  Ragged rows split the
    # whole cache and merge through the workspace; at t 17 the batch sees
    # 18 slots, one split that writes the output itself.
    assert args[1:3] == (k.data_ptr(), v.data_ptr())
    assert args[3:5] == ((t.data_ptr(), 0) if per_row else (None, 17))
    assert plan["splits"] == (2 if per_row else 1)
    assert args[5] == out.data_ptr()
    assert (args[6] is not None) == (args[7] is not None) == per_row
    assert args[8:18] == (B, S, Hkv, D, group, 4, 0, _build.dtype_code(q),
                          plan["chunk"], plan["splits"])
    assert args[18] == pytest.approx(D ** -0.5)
    assert args[19:27] == (Hkv * group * D, D, *k.stride()[:3],
                           *v.stride()[:3])
    assert out.shape == q.shape and out.dtype == q.dtype
    assert ops.launch_counts()["decode_attention"] == 1


def test_a_failed_decode_attention_launch_raises_and_counts_nothing(lib):
    lib.code = 700
    q = torch.zeros(1, 1, 4, 64)
    k = v = torch.zeros(1, 40, 1, 64)
    with pytest.raises(RuntimeError, match="launch failed"):
        da.decode_attention_kernel(q, k, v, 3, 4)
    assert len(lib.calls) == 1
    assert ops.launch_counts()["decode_attention"] == 0


def test_decode_attention_counter_is_reported_and_reset():
    da.launches = 5
    assert ops.launch_counts()["decode_attention"] == 5
    ops.reset_launch_counts()
    assert ops.launch_counts()["decode_attention"] == 0


# Mixtral-8x7B's routed MLP in the serving cell: 8 experts of 4096 x 14336.
MIXTRAL_EXPERTS = dict(E=8, D=4096, Fd=14336)


@pytest.mark.parametrize("N,stages", [
    # A decode step of 32 slots: an expert holds at most 32 rows; 16 KB of
    # weight tiles and 4 KB of rows a stage, 8 stages.
    (32, 8),
    # A 256-row chunk: an expert may hold all 256 rows, still one pass; at
    # that width 32 KB of rows a stage, 3 stages.
    (256, 3),
    # generate's one row.
    (1, 9),
])
def test_expert_plan_at_the_serving_shapes(N, stages):
    plan = me.moe_experts_plan(N, 2, dtype=torch.bfloat16, **MIXTRAL_EXPERTS)
    assert plan["kernel"] == "wgmma" and plan["pairs"] == 2 * N
    # gate/up: 64 weight columns a tile, 224 of F an expert; down: 128, 32
    # of D.
    assert plan["tiles"] == {"gate_up": 224 * 8, "down": 32 * 8}
    # Persistent: one CTA an SM.
    assert plan["grid"] == {"gate_up": (me.SMS,), "down": (me.SMS,)}
    # Every weight read once a call: an expert holds each row at most once.
    assert plan["passes"] == 1 and plan["stages"] == stages
    assert me.moe_experts_plan(257, 2, dtype=torch.bfloat16,
                               **MIXTRAL_EXPERTS)["passes"] == 2


@pytest.mark.parametrize("widest,stages", [
    (1, 9), (8, 9), (12, 8), (32, 8), (76, 6), (128, 5), (256, 3),
    (300, 3)])
def test_expert_ring_holds_the_widest_pass(widest, stages):
    # A stage holds two 64 x 64 weight tiles and the widest pass's rows in
    # boxes of 8; a pass holds at most 256 rows.
    assert me.ring_stages(widest) == stages
    rows = -(-min(widest, me.ME_PASS_ROWS) // 8) * 8
    stage = (2 * 64 + rows) * 64 * 2
    assert stages * stage <= me.ME_RING_BYTES < (stages + 1) * stage


def test_expert_plan_of_the_f32_kernel():
    plan = me.moe_experts_plan(3, 2, 4, 64, 128, torch.float32)
    assert plan["kernel"] == "fma"
    assert plan["grid"] == {"gate_up": (2, 4), "down": (1, 4)}


@pytest.mark.parametrize("args,err", [
    ((4, 2, 8, 4096, 14336, torch.float16), TypeError),
    ((4, 2, 8, 4100, 14336, torch.bfloat16), ValueError),
    ((4, 2, 8, 4096, 14330, torch.bfloat16), ValueError),
    ((0, 2, 8, 4096, 14336, torch.bfloat16), ValueError),
    ((4, 9, 8, 4096, 14336, torch.bfloat16), ValueError)])
def test_expert_plan_refuses_what_the_kernels_do_not_take(args, err):
    with pytest.raises(err):
        me.moe_experts_plan(*args)


def test_expert_constants_are_those_of_the_source():
    src = (_build.SRC_DIR / "moe_experts.cu").read_text()
    for name, value in (("kTileM", me.ME_TILE_M), ("kTileK", me.ME_TILE_K),
                        ("kBlockRows", me.ME_BLOCK_ROWS),
                        ("kBoxRows", me.ME_BOX_ROWS),
                        ("kMaxStages", me.ME_MAX_STAGES),
                        ("kRingBytes", me.ME_RING_BYTES),
                        ("kFmaCols", me.FMA_COLS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert re.search(r"constexpr int kPassRows = 4 \* kBlockRows;", src)
    assert me.ME_PASS_ROWS == 4 * me.ME_BLOCK_ROWS


def _expert_args(dtype=torch.bfloat16, N=5, k=2, E=4, D=64, Fd=128):
    pairs = torch.tensor([[0, 2], [2, 1], [0, 2], [3, 0], [2, 3]])[:N]
    order = torch.argsort(pairs.reshape(-1), stable=True)
    ends = torch.cumsum(torch.bincount(pairs.reshape(-1), minlength=E), 0)
    xs = torch.zeros(N * k, D, dtype=dtype)
    return (xs, ends, order, torch.zeros(E, D, Fd, dtype=dtype),
            torch.zeros(E, D, Fd, dtype=dtype),
            torch.zeros(E, Fd, D, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_expert_kernels_launch_gate_up_then_down(lib, dtype):
    args = _expert_args(dtype)
    xs, ends, order, w_gate, w_up, w_down = args
    y = me.grouped_experts_kernel(*args)
    assert lib.calls == ["tj_moe_gate_up", "tj_moe_down"]
    gate_up, down = lib.args
    # The ranges and the order stay on the device (pointers); h is written
    # in pair order and read by down, which writes y at the pairs' places.
    P, D, Fd, E = 10, 64, 128, 4
    assert gate_up[:4] == (xs.data_ptr(), w_gate.data_ptr(),
                           w_up.data_ptr(), ends.data_ptr())
    assert gate_up[5:10] == (P, D, Fd, E, _build.dtype_code(xs))
    assert down[0] == gate_up[4]
    assert down[1:5] == (w_down.data_ptr(), ends.data_ptr(),
                         order.data_ptr(), y.data_ptr())
    assert down[5:10] == (P, Fd, D, E, _build.dtype_code(xs))
    assert y.shape == (P, D) and y.dtype == dtype
    counts = ops.launch_counts()
    assert counts["moe_experts_gate_up"] == counts["moe_experts_down"] == 1


def test_a_failed_expert_launch_raises_with_no_fallback(lib):
    lib.code = 700
    with pytest.raises(RuntimeError, match="moe_experts_gate_up launch "
                       "failed"):
        me.grouped_experts_kernel(*_expert_args())
    assert lib.calls == ["tj_moe_gate_up"]
    counts = ops.launch_counts()
    assert counts["moe_experts_gate_up"] == counts["moe_experts_down"] == 0


def test_an_expert_kernel_missing_from_the_library_raises(lib):
    lib.missing = ("tj_moe_down",)
    with pytest.raises(AttributeError):
        me.grouped_experts_kernel(*_expert_args())
    assert lib.calls == ["tj_moe_gate_up"]
    assert ops.launch_counts()["moe_experts_down"] == 0


@pytest.mark.parametrize("change,err", [
    (lambda a: (a[0].float(), *a[1:]), TypeError),
    (lambda a: (a[0], a[1].int(), *a[2:]), ValueError),
    (lambda a: (a[0], a[1], a[2][:-1], *a[3:]), ValueError),
    (lambda a: (*a[:3], a[3].transpose(1, 2), *a[4:]), ValueError),
    (lambda a: (*a[:5], a[5].transpose(1, 2).contiguous()), ValueError),
    (lambda a: (a[0][:, ::2], *a[1:]), ValueError)])
def test_expert_kernels_refuse_what_they_do_not_take(lib, change, err):
    with pytest.raises(err):
        me.grouped_experts_kernel(*change(_expert_args()))
    assert lib.calls == []


def test_expert_counters_are_reported_and_reset():
    me.gate_up_launches, me.down_launches = 3, 4
    counts = ops.launch_counts()
    assert (counts["moe_experts_gate_up"], counts["moe_experts_down"]) == \
        (3, 4)
    ops.reset_launch_counts()
    assert ops.launch_counts()["moe_experts_gate_up"] == 0
    assert ops.launch_counts()["moe_experts_down"] == 0
