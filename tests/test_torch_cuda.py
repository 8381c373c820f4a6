"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it is marked ``cuda`` and skips without
one (the CPU tier-1 run).  The module imports no JAX, so it runs on the
machine with the card: ``python -m pytest tests/test_torch_cuda.py -q``.
chip_smoke.py repeats these checks at the full-width shapes.
"""

import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

from trainingjob_operator_tpu_torch import ops
from trainingjob_operator_tpu_torch.models import decode, llama
from trainingjob_operator_tpu_torch.ops import fused
from trainingjob_operator_tpu_torch.workloads import (
    llama_elastic,
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
                      "flash_attention_bwd_dkv_wgmma": 0}
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
