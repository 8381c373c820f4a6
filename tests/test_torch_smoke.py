"""chip_smoke.py's tolerance for the flash backward kernels, on the CPU.

``grad_check`` holds a kernel's dQ, dK or dV against the plain backward on
the card.  Here the plain backward's own bf16 gradients stand in for both
sides, and a perturbed copy for a faulty kernel: the same f32 sums
rounded after a little noise pass (some entries one bf16 step away), a
10% error confined to the last KV tile fails, and so does a 0.4% error
spread over every entry.  No JAX is imported.
"""

import importlib
import importlib.util
from pathlib import Path

import pytest
import torch

flash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")

torch.set_num_threads(2)


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _smoke()


def _plain_grads(dtype):
    """dq, dk, dv [B, T, H, D] of a causal T=256 case from bf16 inputs,
    in ``dtype`` (f32: the plain backward's sums before the final cast)."""
    g = torch.Generator().manual_seed(0)
    T, H, D = 256, 4, 16
    q, k, v, do = (torch.randn(1, T, H, D, generator=g).to(torch.bfloat16)
                   .to(dtype) for _ in range(4))
    opts = dict(causal=True, scale=D ** -0.5, window=0)
    out, lse = flash.flash_reference_with_lse(q, k, v, **opts)
    delta = flash.flash_delta(do, out.to(torch.bfloat16).to(dtype))
    dq = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, **opts)
    dk, dv = flash.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **opts)
    return {"dq": dq, "dk": dk, "dv": dv}


@pytest.fixture(scope="module")
def grads():
    return _plain_grads(torch.bfloat16)


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_the_same_sums_in_another_order_pass(name):
    # A correct kernel: the plain backward's f32 sums, each off by a
    # relative 1e-5 (far more than another summation order gives), rounded
    # to bf16 -- so some entries land one bf16 step away.
    f32 = _plain_grads(torch.float32)[name]
    noise = torch.randn(f32.shape, generator=torch.Generator().manual_seed(1))
    got = (f32 * (1 + 1e-5 * noise)).to(torch.bfloat16)
    want = f32.to(torch.bfloat16)
    assert not torch.equal(got, want)
    check = smoke.grad_check(torch, got, want, "bfloat16")
    assert check["ok"], check


@pytest.mark.parametrize("name", ["dk", "dv"])
def test_an_error_in_the_late_kv_tiles_fails(grads, name):
    want = grads[name]
    got = want.clone()
    got[:, -64:] = (want[:, -64:].float() * 1.1).to(torch.bfloat16)
    check = smoke.grad_check(torch, got, want, "bfloat16")
    assert not check["ok"] and check["tol_used"] > 1, check


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_a_small_error_on_every_entry_fails(grads, name):
    want = grads[name]
    # 0.4% on every entry: inside the elementwise rtol, not the L2 limit.
    got = (want.float() * 1.004).to(torch.bfloat16)
    check = smoke.grad_check(torch, got, want, "bfloat16")
    assert check["tol_used"] <= 1, check
    assert check["rel_l2_err"] > smoke.BWD_L2_RTOL["bfloat16"]
    assert not check["ok"]
