"""The flash kernels' launch plans, on the CPU (no card, no JAX).

Which kernel a call takes, its grid and tile order, when an input is copied
and the tensor maps the tensor-core kernels are built from are decided in
plain Python (``ops/flash_attention.py`` ``fwd_plan`` and ``dkv_plan``), so
they are checked here; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import importlib

import pytest
import torch

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


def test_fma_grids_are_those_of_the_f32_kernels():
    q, k, v = _qkv(2, 130, 4, 2, 16, torch.float32)
    assert flash.fwd_plan(q, k, v)["grid"] == (3, 8)
    assert flash.dkv_plan(q, k, v, q)["grid"] == (3, 4)
    assert flash.fwd_plan(q, k, v)["tile_order"] == [0, 1, 2]


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


def test_a_misaligned_view_is_copied():
    # An offset of one element leaves the base off the 16-byte grid.
    base = torch.zeros(1 + 64 * 4 * 64, dtype=torch.bfloat16)
    q = base[1:].view(1, 64, 4, 64)
    assert q.data_ptr() % 16
    k = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    plan = flash.fwd_plan(q, k, k)
    assert plan["copies"] == {"q": True, "k": False, "v": False}


def test_copies_for_the_kernel_are_fresh_and_contiguous():
    base = torch.arange(1 + 64 * 4 * 64, dtype=torch.float32).to(
        torch.bfloat16)
    q = base[1:].view(1, 64, 4, 64)
    got = flash.tma_operand(q)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert torch.equal(got, q)
    k = torch.zeros(1, 64, 4, 64, dtype=torch.bfloat16)
    assert flash.tma_operand(k) is k


def test_the_fma_plan_has_no_maps():
    q, k, v = _qkv(1, 64, 4, 4, 32)
    plan = flash.fwd_plan(q, k, v)
    assert plan["kernel"] == "fma" and "maps" not in plan
