"""The flash kernels' launch plans, on the CPU (no card, no JAX).

Which kernel a call takes, its grid and tile order, when an input is copied
and the tensor maps the tensor-core kernels are built from are decided in
plain Python (``ops/flash_attention.py`` ``fwd_plan``, ``dq_plan`` and
``dkv_plan``; ``ops/fused.py`` ``rmsnorm_plan``), so they are checked here;
the kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

from trainingjob_operator_tpu_torch import ops
from trainingjob_operator_tpu_torch.ops import _build, fused

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
    assert flash.fwd_plan(q, k, v)["grid"] == (3, 8)
    assert flash.dq_plan(q, k, v, q)["grid"] == (3, 8)
    assert flash.dkv_plan(q, k, v, q)["grid"] == (3, 4)
    assert flash.fwd_plan(q, k, v)["tile_order"] == [0, 1, 2]
    assert flash.dq_plan(q, k, v, q)["tile_order"] == [0, 1, 2]


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
    q, k, v = _qkv(1, 64, 4, 4, D, dtype)
    plan = (flash.fwd_plan(q, k, v) if plan_of == "fwd"
            else getattr(flash, f"{plan_of}_plan")(q, k, v, q))
    assert plan["kernel"] == "fma"
    assert "maps" not in plan and "copies" not in plan


class _Lib:
    """Stands in for the kernel library: records the entry points called
    and returns ``code`` from each."""

    def __init__(self, code=0, missing=()):
        self.calls, self.code, self.missing = [], code, missing

    def __getattr__(self, name):
        if name in self.missing:
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            return self.code
        return entry

    def tj_error_string(self, code):
        return b"stand-in failure"


@pytest.fixture
def lib(monkeypatch):
    """Route the dQ wrapper's launches to a stand-in library (CPU tensors
    have no CUDA stream; the wrapper's dispatch is what is under test)."""
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
