"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it is marked ``cuda`` and skips without
one (the CPU tier-1 run).  The module imports no JAX, so it runs on the
machine with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
chip_smoke.py repeats these checks at the full-width shapes.
"""

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from trainingjob_operator_tpu_torch import ops
from trainingjob_operator_tpu_torch.models import (
    bert,
    decode,
    llama,
    moe,
    moe_decode,
    resnet,
)
from trainingjob_operator_tpu_torch.ops import decode_attention as da
from trainingjob_operator_tpu_torch.ops import fused
from trainingjob_operator_tpu_torch.ops import moe_experts as me
from trainingjob_operator_tpu_torch.workloads import (
    bert_pretrain,
    llama_elastic,
    mnist,
    resnet_dp,
    serve,
    train,
)

flash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")


def _smoke():
    """chip_smoke.py, for its tolerance checks (it imports no torch at
    module level and runs nothing on import)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _smoke()

pytestmark = pytest.mark.cuda

#: (rtol, atol) of RMSNorm: bf16 outputs may be one bf16 rounding apart;
#: f32 differs only in summation order.  The flash forward is held by
#: chip_smoke.fwd_check instead (about one bf16 step, atol a fraction of
#: the reference's RMS, and a relative L2 limit).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (13, 64), (16, 4096),
                                    (5, 768), (300, 4096), (3, 8192),
                                    (2, 24), (1000, 128)])
def test_rmsnorm_kernel_matches_plain(dev, dtype, rows, d):
    # Teams of 1 and 2 warps a row (f32 4096, 8192), 1 to 8 warps a CTA,
    # rows that do not fill the last CTA, partly idle lanes (d = 24, 768).
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, d, generator=g, device=dev).to(dtype)
    scale = torch.randn(d, generator=g, device=dev)
    ops.reset_launch_counts()
    got = ops.rmsnorm(x, scale, 1e-5)
    assert ops.launch_counts()["rmsnorm_fwd"] == 1
    want = fused.rmsnorm_reference(x, scale, 1e-5)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _limits(dtype, head_dim):
    """chip_smoke's tolerance key for the kernel a call takes."""
    return smoke.limits(str(dtype).split(".")[-1],
                        flash.kernel_route(dtype, head_dim))


#: (causal, H, Hkv, T, D, window, dtype): f32 and bf16 at head dims 16 and
#: 32 reach the f32-FMA kernels, bf16 at 64 and 128 the tensor-core ones
#: (ragged T 130, 200 and 1000; GQA 32/8; windows 16 and 256; non-causal).
FLASH_CASES = [
    (True, 4, 4, 64, 16, 0, torch.float32),
    (False, 4, 2, 48, 16, 0, torch.float32),
    (True, 4, 2, 48, 32, 8, torch.float32),
    (True, 4, 2, 130, 64, 0, torch.bfloat16),
    (True, 8, 8, 200, 128, 16, torch.bfloat16),
    (False, 4, 1, 70, 128, 0, torch.bfloat16),
    (True, 4, 4, 100, 16, 0, torch.bfloat16),
    (True, 4, 2, 100, 32, 8, torch.bfloat16),
    (True, 4, 4, 1000, 64, 0, torch.bfloat16),
    (True, 32, 8, 1000, 128, 0, torch.bfloat16),
    (True, 4, 2, 1000, 128, 256, torch.bfloat16),
    (True, 4, 4, 130, 128, 16, torch.bfloat16),
    (False, 4, 4, 200, 64, 0, torch.bfloat16),
    (False, 32, 8, 130, 128, 0, torch.bfloat16),
    (True, 4, 4, 256, 128, 0, torch.bfloat16),
]


@pytest.mark.parametrize("causal,H,Hkv,T,D,window,dtype", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, causal, H, Hkv, T, D, window,
                                    dtype):
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, T, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, T, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, T, Hkv, D, generator=g, device=dev).to(dtype)
    ops.reset_launch_counts()
    out, lse = flash.flash_attention_with_lse(q, k, v, causal=causal,
                                              window=window)
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    tc = flash.kernel_route(dtype, D) == "wgmma"
    assert counts["flash_attention_fwd_wgmma"] == int(tc)
    want, want_lse = flash.flash_reference_with_lse(q, k, v, causal=causal,
                                                    window=window)
    check = smoke.fwd_check(torch, out, want, _limits(dtype, D))
    assert check["ok"], check
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-3)


def test_tensor_core_kernels_read_a_bhtd_view_in_place(dev):
    # bf16 [B, H, T, D] storage viewed as [B, T, H, D]: the tensor maps take
    # its strides, so no copy is made, and both kernels are right.
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn(2, 4, 130, 128, generator=g, device=dev)
                   .to(torch.bfloat16).transpose(1, 2) for _ in range(4))
    assert not any(flash.dkv_plan(q, k, v, do)["copies"].values())
    assert not any(flash.dq_plan(q, k, v, do)["copies"].values())
    opts = dict(causal=True, scale=128 ** -0.5, window=0)
    ops.reset_launch_counts()
    out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
    delta = flash.flash_delta(do, out)
    dq = flash.flash_bwd_dq_kernel(q, k, v, do, lse, delta, **opts)
    dk, dv = flash.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **opts)
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd_wgmma"] == 1
    assert counts["flash_attention_bwd_dq_wgmma"] == 1
    assert counts["flash_attention_bwd_dkv_wgmma"] == 1
    want, _ = flash.flash_reference_with_lse(q, k, v, **opts)
    check = smoke.fwd_check(torch, out, want, "bfloat16_wgmma")
    assert check["ok"], check
    want_dq = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, **opts)
    want_dk, want_dv = flash.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                     delta, **opts)
    for got, want, floor in ((dq, want_dq, smoke.DQ_ATOL_FLOOR_RMS),
                             (dk, want_dk, 0.0), (dv, want_dv, 0.0)):
        check = smoke.grad_check(torch, got, want, "bfloat16_wgmma", floor)
        assert check["ok"], check


def test_flash_kernel_takes_strided_inputs(dev):
    # q, k, v as [B, H, T, D] storage viewed as [B, T, H, D]: the kernel
    # reads them by stride, no copy.
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(1, 4, 40, 16, generator=g, device=dev)
               .transpose(1, 2) for _ in range(3))
    out, _ = flash.flash_attention_with_lse(q, k, v, causal=True)
    want, _ = flash.flash_reference_with_lse(q, k, v, causal=True)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


def test_kernels_refuse_grad(dev):
    # A bare kernel call on a tensor that requires grad would cut the
    # graph; the ops' autograd Functions run the kernels and differentiate.
    x = torch.randn(2, 64, device=dev, requires_grad=True)
    scale = torch.ones(64, device=dev)
    with pytest.raises(NotImplementedError):
        fused.rmsnorm_kernel(x, scale, 1e-5)
    ops.reset_launch_counts()
    ops.rmsnorm(x, scale).sum().backward()
    assert ops.launch_counts()["rmsnorm_fwd"] == 1
    want = torch.autograd.grad(
        fused.rmsnorm_reference(x, scale, 1e-5).sum(), x)[0]
    torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,H,Hkv,T,D,window,dtype", [
    (True, 4, 4, 64, 16, 0, torch.float32),
    (False, 4, 2, 48, 16, 0, torch.float32),
    (True, 4, 2, 100, 32, 8, torch.float32),
    (True, 4, 2, 130, 64, 0, torch.bfloat16),
    (True, 8, 8, 200, 128, 16, torch.bfloat16),
    (False, 4, 1, 70, 128, 0, torch.bfloat16),
    (True, 4, 4, 100, 32, 0, torch.bfloat16),
    (True, 4, 4, 1000, 64, 0, torch.bfloat16),
    (True, 32, 8, 1000, 128, 0, torch.bfloat16),
    (True, 4, 2, 1000, 128, 256, torch.bfloat16),
    (False, 4, 4, 200, 64, 0, torch.bfloat16),
    (True, 4, 4, 256, 128, 0, torch.bfloat16),
])
def test_flash_backward_kernels_match_plain(dev, causal, H, Hkv, T, D,
                                            window, dtype):
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, T, H, D, generator=g, device=dev).to(dtype)
    k = torch.randn(2, T, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(2, T, Hkv, D, generator=g, device=dev).to(dtype)
    do = torch.randn(2, T, H, D, generator=g, device=dev).to(dtype)
    opts = dict(causal=causal, scale=D ** -0.5, window=window)
    out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
    delta = flash.flash_delta(do, out)
    ops.reset_launch_counts()
    dq = flash.flash_bwd_dq_kernel(q, k, v, do, lse, delta, **opts)
    dk, dv = flash.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **opts)
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    tc = flash.kernel_route(dtype, D) == "wgmma"
    assert counts["flash_attention_bwd_dq_wgmma"] == int(tc)
    assert counts["flash_attention_bwd_dkv_wgmma"] == int(tc)
    want_dq = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, **opts)
    want_dk, want_dv = flash.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                     delta, **opts)
    # As chip_smoke holds them: the tensor-core kernels round dz (and p)
    # to bf16 before their products (BWD_TOL["bfloat16_wgmma"]), the
    # f32-FMA kernels round only their f32 sums.
    for got, want, floor in ((dq, want_dq, smoke.DQ_ATOL_FLOOR_RMS),
                             (dk, want_dk, 0.0), (dv, want_dv, 0.0)):
        assert got.dtype == dtype and got.shape == want.shape
        check = smoke.grad_check(torch, got, want, _limits(dtype, D), floor)
        assert check["ok"], check
    # No atomics: a second run is bit for bit the first.
    assert torch.equal(dq, flash.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                     **opts))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), flash.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                             **opts)))


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("T", [1000, 1023])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 256)])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (8, 8)])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 32)])
def test_fma_forward_and_dkv_match_plain(dev, dtype, D, H, Hkv, causal,
                                         window, T, layout):
    # The f32-FMA forward and dK/dV (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
    # against their plain versions at chip_smoke's FWD_TOL / BWD_TOL, with
    # ragged T, GQA, a window and, in the "bhtd" layout, [B, H, T, D]
    # storage read by stride through the [B, T, H, D] view.  GQA at batch 1
    # gives dK/dV a grid smaller than the card (each CTA walks its whole
    # group), MHA at batch 8 one larger.
    g = torch.Generator(device=dev).manual_seed(7)
    B = 1 if H != Hkv else 8

    def make(heads):
        if layout == "bhtd":
            return torch.randn(B, heads, T, D, generator=g, device=dev) \
                .to(dtype).transpose(1, 2)
        return torch.randn(B, T, heads, D, generator=g, device=dev).to(dtype)
    q, k, v, do = make(H), make(Hkv), make(Hkv), make(H)
    assert flash.kernel_route(dtype, D) == "fma"
    assert not any(flash.fwd_plan(q, k, v)["copies"].values())
    assert not any(flash.dkv_plan(q, k, v, do)["copies"].values())
    opts = dict(causal=causal, scale=D ** -0.5, window=window)
    ops.reset_launch_counts()
    out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
    delta = flash.flash_delta(do, out)
    dk, dv = flash.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, **opts)
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    assert counts["flash_attention_fwd_wgmma"] == 0
    assert counts["flash_attention_bwd_dkv_wgmma"] == 0
    key = str(dtype).split(".")[-1]
    want, want_lse = flash.flash_reference_with_lse(q, k, v, **opts)
    check = smoke.fwd_check(torch, out, want, key)
    assert check["ok"], check
    torch.testing.assert_close(lse, want_lse, rtol=0,
                               atol=smoke.LSE_ATOL[key])
    want_dk, want_dv = flash.flash_bwd_dkv_reference(q, k, v, do, lse,
                                                     delta, **opts)
    for got, ref in ((dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype and got.shape == ref.shape
        check = smoke.grad_check(torch, got, ref, key)
        assert check["ok"], check
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), flash.flash_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                             **opts)))


@pytest.mark.parametrize("layout", ["bthd", "bhtd", "wide"])
@pytest.mark.parametrize("T", [1000, 1023])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 256)])
@pytest.mark.parametrize("H,Hkv", [(32, 8), (8, 8)])
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 16),
                                     (torch.bfloat16, 32)])
def test_fma_dq_matches_plain(dev, dtype, D, H, Hkv, causal, window, T,
                              layout):
    # The f32-FMA dQ (csrc/flash_bwd.cu tj_flash_bwd_dq) against its plain
    # version at chip_smoke's BWD_TOL, as the forward and dK/dV above; in
    # the "wide" layout every input has d-stride 2 and is copied first.
    g = torch.Generator(device=dev).manual_seed(8)
    B = 1 if H != Hkv else 8

    def make(heads):
        if layout == "bhtd":
            return torch.randn(B, heads, T, D, generator=g, device=dev) \
                .to(dtype).transpose(1, 2)
        if layout == "wide":
            return torch.randn(B, T, heads, 2 * D, generator=g,
                               device=dev).to(dtype)[..., ::2]
        return torch.randn(B, T, heads, D, generator=g, device=dev).to(dtype)
    q, k, v, do = make(H), make(Hkv), make(Hkv), make(H)
    copies = flash.dq_plan(q, k, v, do)["copies"]
    assert set(copies.values()) == {layout == "wide"}
    opts = dict(causal=causal, scale=D ** -0.5, window=window)
    out, lse = flash.flash_kernel_with_lse(q, k, v, **opts)
    delta = flash.flash_delta(do, out)
    ops.reset_launch_counts()
    dq = flash.flash_bwd_dq_kernel(q, k, v, do, lse, delta, **opts)
    counts = ops.launch_counts()
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dq_wgmma"] == 0
    key = str(dtype).split(".")[-1]
    want = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, **opts)
    assert dq.dtype == dtype and dq.shape == want.shape
    check = smoke.grad_check(torch, dq, want, key, smoke.DQ_ATOL_FLOOR_RMS)
    assert check["ok"], check
    assert torch.equal(dq, flash.flash_bwd_dq_kernel(q, k, v, do, lse, delta,
                                                     **opts))


def test_flash_autograd_goes_through_the_kernels(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(1, 40, 4, 16, generator=g, device=dev)
               .transpose(1, 2).contiguous().transpose(1, 2)
               .requires_grad_(True) for _ in range(3))
    ops.reset_launch_counts()
    flash.flash_attention(q, k, v, causal=True, window=7).square().sum() \
        .backward()
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    assert counts["flash_attention_bwd_dkv"] == 1
    grads = [t.grad for t in (q, k, v)]
    refs = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    flash.flash_attention(*refs, causal=True, window=7).square().sum() \
        .backward()
    for got, ref in zip(grads, refs):
        torch.testing.assert_close(got.cpu(), ref.grad, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("window", [0, 2100])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(dev, dtype, D, group, window,
                                               per_row):
    # A cache of S = 2300 slots, which no split size divides; full mode, or
    # a ring of window 2100 < S at positions past S, so that the visible
    # run wraps.  Ragged rows hold position 0, S - 1 and middle ones.  The
    # splits cover S (ragged rows) or the batch's visible slots (an int t),
    # in more than one chunk at every head dim and dtype.  Held to
    # chip_smoke.DECODE_TOL: both compute in f32 from the same inputs and
    # differ in summation order and exp2's last bits; a bf16 output may
    # round one step apart.
    B, S, Hkv = 4, 2300, 2
    g = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn(B, 1, Hkv * group, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, Hkv, D, generator=g, device=dev).to(dtype)
    rows = [0, S - 1, 1370, 3000] if window else [0, S - 1, 1370, 2211]
    t = (torch.tensor(rows, device=dev) if per_row
         else (3000 if window else 2211))
    reach = da.visible_slots(t, S, window)
    plan = da.decode_attention_plan(B, Hkv, S, D, group, dtype, reach)
    assert (reach or S) % plan["chunk"] and plan["splits"] > 1
    ops.reset_launch_counts()
    got = da.decode_attention(q, k, v, t, group, window)
    assert ops.launch_counts()["decode_attention"] == 1
    want = da.attend_cache_reference(q, k, v, t, group, window)
    assert got.dtype == dtype and got.shape == want.shape
    rtol, atol = smoke.DECODE_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    # The splits merge in a fixed order: a second run is bit for bit.
    assert torch.equal(got, da.decode_attention(q, k, v, t, group, window))


def _expert_inputs(dev, dtype, N, k, E, D, Fd, hot=None, unused=None,
                   seed=0):
    """xs, ends, order and the three weights of N rows, each choosing k
    distinct experts at random; every row chooses ``hot`` first where
    given, and no row chooses ``unused``."""
    rng = np.random.default_rng(seed)
    pool = [e for e in range(E) if e != unused]
    choices = []
    for _ in range(N):
        rest = [e for e in rng.permutation(pool) if e != hot]
        choices.append(([hot] if hot is not None else []) + rest)
    pairs = torch.tensor([c[:k] for c in choices], device=dev).reshape(-1)
    order = torch.argsort(pairs, stable=True)
    ends = torch.cumsum(torch.bincount(pairs, minlength=E), 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(N, D, generator=g, device=dev).to(dtype)
    xs = x[order // k].contiguous()
    ws = [(torch.randn(E, a, b, generator=g, device=dev) * a ** -0.5)
          .to(dtype) for a, b in ((D, Fd), (D, Fd), (Fd, D))]
    return (xs, ends, order, *ws)


@pytest.mark.parametrize("dtype,N,E,D,Fd,hot,unused", [
    # The routed serving cell at Mixtral-8x7B's widths: a decode step (32
    # rows) and a 256-row chunk, with an expert no row chose, and a chunk
    # where every row chooses expert 3 (256 rows: one pass of four blocks).
    (torch.bfloat16, 32, 8, 4096, 14336, None, 7),
    (torch.bfloat16, 256, 8, 4096, 14336, None, 7),
    (torch.bfloat16, 256, 8, 4096, 14336, 3, None),
    # Narrow and ragged widths (D and F multiples of 8, not of 64), one row
    # (generate), and 300 rows on one expert: two passes, the second one
    # partial.
    (torch.bfloat16, 300, 4, 200, 520, 0, None),
    (torch.bfloat16, 1, 4, 200, 520, None, None),
    # float32 (the tiny configs): the FMA kernel.
    (torch.float32, 300, 4, 200, 520, 0, None),
    (torch.float32, 1, 4, 64, 128, None, 2),
])
def test_expert_kernels_match_plain(dev, dtype, N, E, D, Fd, hot, unused):
    # Both sum f32 products of the same operands in another order (about
    # 1e-6 of the output); bf16 rounds at the same points (the products,
    # silu, the gated product, the output), so a rounding near a tie may
    # land one bf16 step apart: within 2^-7 relative, and 2^-9 of the
    # output's RMS near 0.  float32: within 1e-4 relative and 1e-4 of the
    # RMS.
    args = _expert_inputs(dev, dtype, N, 2, E, D, Fd, hot, unused)
    ops.reset_launch_counts()
    got = me.grouped_experts(*args)
    counts = ops.launch_counts()
    assert counts["moe_experts_gate_up"] == counts["moe_experts_down"] == 1
    want = me.grouped_experts_reference(*args)
    assert got.dtype == dtype and got.shape == (2 * N, D)
    rms = float(want.float().pow(2).mean().sqrt())
    rtol, atol = ((2 ** -7, 2 ** -9) if dtype == torch.bfloat16
                  else (1e-4, 1e-4))
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol * rms)
    assert torch.equal(got, me.grouped_experts(*args))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_routed_steps_read_nothing_to_the_host(dev, dtype):
    # A tiny MoE's serve_step and prefill_chunk under the sync debug mode
    # in "error": any host read of a device value (.tolist(), .item(), a
    # blocking copy) raises.  Each layer launches the two expert kernels.
    cfg = dataclasses.replace(moe.MoEConfig.tiny(), dtype=dtype)
    params = moe.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    cache = decode.init_cache(cfg, 4, 32, device=dev)
    tokens = torch.tensor([5, 9, 200, 31], device=dev)
    ts = torch.tensor([3, 0, 7, 12], device=dev)
    chunk = torch.arange(3, 11, device=dev)

    def tick():
        moe_decode.serve_step(params, cache, tokens, ts, cfg)
        moe_decode.prefill_chunk(params, cache, chunk, 1, 8, cfg)

    tick()                         # the library's load, first launches
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tick()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["moe_experts_gate_up"] == 2 * cfg.n_layers
    assert counts["moe_experts_down"] == 2 * cfg.n_layers


def test_tiny_train_step_on_the_card_matches_the_cpu(dev):
    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    init = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             master=True)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33),
                           generator=torch.Generator().manual_seed(1))
    losses = {}
    for where in ("cpu", "cuda"):
        params = train.trainable_copy(init, where)
        step = llama_elastic.make_step_fn(params, cfg, accum=2, lr=1e-3)
        ops.reset_launch_counts()
        losses[where] = [float(step(tokens.to(where))) for _ in range(3)]
        if where == "cuda":
            counts = ops.launch_counts()
    L = cfg.n_layers
    assert counts == {"rmsnorm_fwd": 3 * 2 * (2 * L + 1),
                      "flash_attention_fwd": 3 * 2 * L,
                      "flash_attention_bwd_dq": 3 * 2 * L,
                      "flash_attention_bwd_dkv": 3 * 2 * L,
                      "flash_attention_fwd_wgmma": 0,
                      "flash_attention_bwd_dq_wgmma": 0,
                      "flash_attention_bwd_dkv_wgmma": 0,
                      "decode_attention": 0,
                      "moe_experts_gate_up": 0,
                      "moe_experts_down": 0}
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=0)


def test_tiny_serve_equals_generate_through_the_kernels(dev):
    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    svc = serve.DecodeService(params, cfg, slots=2, prefill_chunk=4,
                              device=dev)
    prompt = [7, 3, 11, 2, 9, 4]
    ops.reset_launch_counts()
    req = svc.submit(prompt, 10)
    while not req.finished:
        svc.step()
    want = decode.generate(params, torch.tensor([prompt], device=dev), cfg,
                           steps=10)
    assert req.tokens == want[0].tolist()
    counts = ops.launch_counts()
    assert counts["rmsnorm_fwd"] > 0 and counts["flash_attention_fwd"] == 2
    # Every decode step of the service and of generate, in every layer.
    assert counts["decode_attention"] > 0
    assert counts["decode_attention"] == cfg.n_layers * (
        svc.decode_calls + 10 - 1)


def test_a_prefetched_run_is_bit_identical_to_an_unprefetched_one(dev):
    # The trainer's loop copies each pinned host batch to the card on the
    # step's stream (data/loader.py); the same steps fed batch_at(i) on
    # the card directly give the same bits.
    base = llama.LlamaConfig.tiny()
    cfg = llama.LlamaConfig(**{**base.__dict__, "dtype": "float32"})
    init = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             master=True)
    batch_at, *_ = train.build_batch_sources(
        prefix="NOPE", vocab_size=cfg.vocab_size, global_batch=4, seq=32,
        synthetic_key=17, device="cpu")
    runs = {}
    for prefetch in (True, False):
        params = train.trainable_copy(init, dev)
        step = llama_elastic.make_step_fn(params, cfg, accum=2, lr=1e-3)
        losses = []
        if prefetch:
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                loss, _ = train.run_elastic_loop(
                    step_fn=lambda t: losses.append(step(t)) or losses[-1],
                    batch_at=batch_at, state=train.CheckpointState("", {}),
                    params=params, opt_state=step.opt.state, steps=6,
                    start_step=0, ckpt_every=100, device=dev)
            side.synchronize()
        else:
            for i in range(6):
                losses.append(step(batch_at(i).to(dev)))
        runs[prefetch] = ([float(x) for x in losses],
                          [p.detach().cpu() for p in
                           train.tree_leaves(params)])
    assert runs[True][0] == runs[False][0]
    for a, b in zip(runs[True][1], runs[False][1]):
        assert torch.equal(a, b)


def test_the_snapshot_has_landed_when_save_returns(dev, tmp_path,
                                                   monkeypatch):
    # AdamW updates the parameters in place right after a save: the host
    # copy must already hold the saved values.
    x = torch.randn(4096, 1024, device=dev)
    want = x.cpu()
    st = train.CheckpointState(str(tmp_path), {})
    seen = {}
    real = train._write_step

    def record(path, step, host_value, keep, cancel=None):
        seen["host"] = host_value["params"]["x"].clone()
        seen["pinned"] = host_value["params"]["x"].is_pinned()
        real(path, step, host_value, keep, cancel)

    monkeypatch.setattr(train, "_write_step", record)
    st.save({"params": {"x": x}, "step": 1})
    x.add_(1.0)  # what the next step does to the live buffer
    st.finalize()
    assert seen["pinned"]
    assert torch.equal(seen["host"], want)
    got = torch.load(tmp_path / "1" / "params.pt", weights_only=True)
    assert torch.equal(got["x"], want)


@pytest.fixture
def no_tf32(dev):
    """TF32 off for cuBLAS and cuDNN (cuDNN's convolutions default to it),
    restored after: a TF32 product would be 1e-3 off the CPU's f32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield dev
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _no_kernel_launched():
    """The three workloads reach no TPU kernel in the reference, and their
    paths launch none of the port's."""
    assert all(n == 0 for n in ops.launch_counts().values()), \
        ops.launch_counts()


def test_tiny_mnist_steps_on_the_card_match_the_cpu(no_tf32):
    images, labels = mnist.synthetic_mnist(
        torch.Generator().manual_seed(1), 4 * 32, 32)
    init = mnist.init_params(32, torch.Generator().manual_seed(0), "cpu")
    losses = {}
    for where in ("cpu", "cuda"):
        params = {k: v.to(where, copy=True).requires_grad_(True)
                  for k, v in init.items()}
        step = mnist.make_step(params, train.AdamW(
            params, 1e-3, b2=0.999, weight_decay=0.0))
        ops.reset_launch_counts()
        losses[where] = [float(step(x.to(where), y.to(where)))
                         for x, y in zip(images, labels)]
        _no_kernel_launched()
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=0)


def test_tiny_bert_steps_on_the_card_match_the_cpu(no_tf32):
    cfg = bert.BertConfig(**{**bert.BertConfig.tiny().__dict__,
                             "dtype": "float32"})
    init = bert.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    losses = {}
    for where in ("cpu", "cuda"):
        params = train.trainable_copy(init, where)
        step = bert_pretrain.make_step(params, cfg, lr=1e-3)
        ops.reset_launch_counts()
        losses[where] = [float(step({k: v.to(where) for k, v in
                                     bert_pretrain.batch_at(
                                         i, 4, 32, cfg.vocab_size).items()}))
                         for i in range(3)]
        _no_kernel_launched()
    torch.testing.assert_close(losses["cuda"], losses["cpu"], rtol=1e-4,
                               atol=0)


def test_tiny_resnet_steps_on_the_card_match_the_cpu(no_tf32):
    cfg = resnet.ResNetConfig(**{**resnet.ResNetConfig.tiny().__dict__,
                                 "dtype": "float32"})
    init, init_stats = resnet.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")
    out = {}
    for where in ("cpu", "cuda"):
        params = train.trainable_copy(init, where)
        stats = train.tree_map(lambda x: x.to(where, copy=True), init_stats)
        step = resnet_dp.make_step(params, stats, cfg, lr=0.1,
                                   channels_last=where == "cuda")
        ops.reset_launch_counts()
        losses = []
        for i in range(3):
            images, labels = resnet_dp.batch_at(i, 8, 32, cfg.num_classes)
            losses.append(float(step(images.to(where), labels.to(where))))
        _no_kernel_launched()
        out[where] = (losses, [x.cpu() for x in train.tree_leaves(stats)])
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=0)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
