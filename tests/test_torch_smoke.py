"""chip_smoke.py's tolerances for the flash kernels, on the CPU.

``grad_check`` holds a kernel's dQ, dK or dV against the plain backward on
the card, ``fwd_check`` the forward's output against the plain forward.
Here the plain versions' own bf16 results stand in for both sides, and a
perturbed copy for a faulty kernel: the same f32 sums rounded after a
little noise pass (some entries one bf16 step away), a 10% error confined
to the last tile (of KV rows for dK/dV, of query rows for the forward)
fails, and so does an error spread over every entry that stays inside
the elementwise limit but not the L2 one.  No JAX is imported.
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


def _plain_out(dtype, T=256):
    """Forward output [B, T, H, D] of a causal case from bf16 inputs, in
    ``dtype`` (f32: the plain forward's sums before the final cast)."""
    g = torch.Generator().manual_seed(2)
    H, D = 4, 64
    q, k, v = (torch.randn(1, T, H, D, generator=g).to(torch.bfloat16)
               .to(dtype) for _ in range(3))
    out, _ = flash.flash_reference_with_lse(q, k, v, causal=True)
    return out


def test_the_forward_in_another_order_passes():
    f32 = _plain_out(torch.float32)
    noise = torch.randn(f32.shape, generator=torch.Generator().manual_seed(3))
    got = (f32 * (1 + 1e-5 * noise)).to(torch.bfloat16)
    want = f32.to(torch.bfloat16)
    assert not torch.equal(got, want)
    check = smoke.fwd_check(torch, got, want, "bfloat16")
    assert check["ok"], check


def test_a_forward_error_in_the_last_query_rows_fails():
    want = _plain_out(torch.bfloat16)
    got = want.clone()
    got[:, -64:] = (want[:, -64:].float() * 1.1).to(torch.bfloat16)
    check = smoke.fwd_check(torch, got, want, "bfloat16")
    assert not check["ok"] and check["tol_used"] > 1, check


def test_a_forward_error_just_above_the_l2_limit_fails():
    want = _plain_out(torch.bfloat16)
    limit = smoke.FWD_L2_RTOL["bfloat16"]
    got = want.float() * (1 + 1.25 * limit)
    check = smoke.fwd_check(torch, got, want, "bfloat16")
    assert check["tol_used"] <= 1, check
    assert limit < check["rel_l2_err"] < 1.5 * limit
    assert not check["ok"]


# The tensor-core kernels round P (forward), dz (dQ) and P and dz (dK/dV)
# to bf16 before the products that take them.  A plain emulation of those
# rounding points stands in for a correct kernel: it must pass the limits
# chip_smoke.py derives for them ("bfloat16_wgmma"), and the same faults as
# above must still fail them.

def _inputs(T, H=2, Hkv=2, D=64, seed=4):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(1, T, h, D, generator=g).to(torch.bfloat16)
                 for h in (H, Hkv, Hkv, H))


def _emulate_fwd(q, k, v):
    """The causal forward with P rounded to bf16 before P . V, l summed
    over the f32 P, O rounded once to bf16."""
    scale = q.shape[-1] ** -0.5
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    s = flash._scores(qt, kt, scale=scale, causal=True)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(flash._mask(s.shape[-1], True, 0, s.device), p, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
                     flash._repeat_kv(vt, q.shape[2]).float()) / l
    return o.transpose(1, 2).to(torch.bfloat16)


def _emulate_dkv(q, k, v, do, lse, delta):
    """dK/dV with p and dz rounded to bf16 before their products."""
    opts = dict(scale=q.shape[-1] ** -0.5, causal=True, window=0)
    p, dz, qt, gt, _ = flash._bwd_probs(q, k, v, do, lse, delta, **opts)
    B, T, Hkv, D = k.shape
    group = q.shape[2] // Hkv

    def summed(a, x):
        y = torch.einsum("bhqk,bhqd->bhkd", a.to(torch.bfloat16).float(), x)
        return y.reshape(B, Hkv, group, T, D).sum(2).transpose(1, 2)
    return summed(dz, qt).to(k.dtype), summed(p, gt).to(v.dtype)


def _emulate_dq(q, k, v, do, lse, delta):
    """dQ with dz rounded to bf16 before dz . k, and the score products
    summed in f64 (another order than the plain version's f32 sums, as the
    tensor cores' order is)."""
    scale = q.shape[-1] ** -0.5
    qt, gt = (x.transpose(1, 2).double() for x in (q, do))
    kt, vt = (flash._repeat_kv(x.transpose(1, 2), q.shape[2]).double()
              for x in (k, v))
    z = (torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale).float()
    p = torch.exp(z - lse[..., None])
    p = torch.where(flash._mask(z.shape[-1], True, 0, z.device), p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gt, vt).float()
    dz = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", dz.to(torch.bfloat16).float(),
                      kt.float())
    return dq.transpose(1, 2).to(torch.bfloat16)


@pytest.fixture(scope="module", params=[256, 2048])
def tc_case(request):
    """Plain and emulated results of one causal bf16 case (GQA 4/2)."""
    q, k, v, do = _inputs(request.param, H=4, Hkv=2)
    opts = dict(causal=True, scale=q.shape[-1] ** -0.5, window=0)
    out, lse = flash.flash_reference_with_lse(q, k, v, **opts)
    delta = flash.flash_delta(do, out)
    dq = flash.flash_bwd_dq_reference(q, k, v, do, lse, delta, **opts)
    dk, dv = flash.flash_bwd_dkv_reference(q, k, v, do, lse, delta, **opts)
    edk, edv = _emulate_dkv(q, k, v, do, lse, delta)
    return {"out": (_emulate_fwd(q, k, v), out),
            "dq": (_emulate_dq(q, k, v, do, lse, delta), dq),
            "dk": (edk, dk), "dv": (edv, dv)}


def test_the_forward_rounding_emulation_passes_the_tensor_core_limits(
        tc_case):
    got, want = tc_case["out"]
    assert not torch.equal(got, want)
    check = smoke.fwd_check(torch, got, want, "bfloat16_wgmma")
    assert check["ok"], check
    # The bf16 P is what the FMA kernels' tighter limits would refuse.
    assert not smoke.fwd_check(torch, got, want, "bfloat16")["ok"]


@pytest.mark.parametrize("name", ["dk", "dv"])
def test_the_dkv_rounding_emulation_passes_the_tensor_core_limits(
        tc_case, name):
    got, want = tc_case[name]
    check = smoke.grad_check(torch, got, want, "bfloat16_wgmma")
    assert check["ok"], check


def test_the_dq_rounding_emulation_passes_the_tensor_core_limits(tc_case):
    got, want = tc_case["dq"]
    check = smoke.grad_check(torch, got, want, "bfloat16_wgmma",
                             smoke.DQ_ATOL_FLOOR_RMS)
    assert check["ok"], check
    assert check["tol_used"] < 0.75 and check["rel_l2_err"] < 4e-3, check
    # The bf16 dz is what the FMA kernels' tighter limits would refuse.
    assert not smoke.grad_check(torch, got, want, "bfloat16",
                                smoke.DQ_ATOL_FLOOR_RMS)["ok"]


def test_only_the_first_query_row_needs_the_dq_atol_floor(tc_case):
    # Row 0 of a causal head sees one key: its dQ is f32 noise on both
    # sides, which a per-row atol cannot hold.  Every other row passes the
    # per-row limit without the floor.
    got, want = tc_case["dq"]
    assert float(want[:, 0].float().abs().max()) < 1e-5
    bare = smoke.grad_check(torch, got, want, "bfloat16_wgmma")
    assert not bare["ok"] and bare["tol_used"] > 1
    rest = smoke.grad_check(torch, got[:, 1:], want[:, 1:], "bfloat16_wgmma")
    assert rest["ok"], rest


def test_a_wrong_first_query_row_fails_the_dq_limits(tc_case):
    # The floor is 1e-3 x the tensor's RMS: a first row off by 1% of the
    # tensor's RMS fails.
    got, want = tc_case["dq"]
    got = got.clone()
    got[:, 0] += 1e-2 * float(want.float().square().mean().sqrt())
    check = smoke.grad_check(torch, got, want, "bfloat16_wgmma",
                             smoke.DQ_ATOL_FLOOR_RMS)
    assert not check["ok"] and check["tol_used"] > 1, check


def test_the_dq_atol_floor_leaves_the_f32_limit_as_it_is():
    # The f32-FMA dQ is held to 1e-4 x the tensor's RMS: one entry off by
    # 5e-4 x the RMS fails, though it lies under the tensor-core floor and
    # inside the L2 limit.
    want = _plain_grads(torch.float32)["dq"].contiguous()
    rms = float(want.square().mean().sqrt())
    got = want.clone()
    got.view(-1)[want.abs().argmin()] += 5e-4 * rms
    check = smoke.grad_check(torch, got, want, "float32",
                             smoke.DQ_ATOL_FLOOR_RMS)
    assert check["rel_l2_err"] <= smoke.BWD_L2_RTOL["float32"], check
    assert check["atol_floor_rms"] == 0.0
    assert not check["ok"] and check["tol_used"] > 1, check


def test_a_dq_error_in_the_last_query_rows_fails_the_tensor_core_limits(
        tc_case):
    _, want = tc_case["dq"]
    got = want.clone()
    got[:, -64:] = (want[:, -64:].float() * 1.1).to(torch.bfloat16)
    check = smoke.grad_check(torch, got, want, "bfloat16_wgmma",
                             smoke.DQ_ATOL_FLOOR_RMS)
    assert not check["ok"] and check["tol_used"] > 1, check


@pytest.mark.parametrize("name", ["dk", "dv"])
def test_an_error_in_the_late_kv_tiles_fails_the_tensor_core_limits(
        tc_case, name):
    _, want = tc_case[name]
    got = want.clone()
    got[:, -64:] = (want[:, -64:].float() * 1.1).to(torch.bfloat16)
    check = smoke.grad_check(torch, got, want, "bfloat16_wgmma")
    assert not check["ok"] and check["tol_used"] > 1, check


def test_a_forward_error_in_the_last_query_rows_fails_the_tensor_core_limits(
        tc_case):
    _, want = tc_case["out"]
    got = want.clone()
    got[:, -64:] = (want[:, -64:].float() * 1.1).to(torch.bfloat16)
    check = smoke.fwd_check(torch, got, want, "bfloat16_wgmma")
    assert not check["ok"] and check["tol_used"] > 1, check


@pytest.mark.parametrize("name", ["out", "dq", "dk", "dv"])
def test_an_error_just_above_the_tensor_core_l2_limit_fails(tc_case, name):
    _, want = tc_case[name]
    limit = smoke.FWD_L2_RTOL["bfloat16_wgmma"]
    assert limit == smoke.BWD_L2_RTOL["bfloat16_wgmma"]
    got = want.float() * (1 + 1.25 * limit)
    floor = smoke.DQ_ATOL_FLOOR_RMS if name == "dq" else 0.0
    check = smoke.close_check(torch, got, want, *smoke.FWD_TOL[
        "bfloat16_wgmma"], limit, per_row=True, atol_floor_rms=floor)
    assert check["tol_used"] <= 1, check
    assert limit < check["rel_l2_err"] < 1.5 * limit
    assert not check["ok"]


@pytest.mark.parametrize("remat,L,micro", [("none", 2, 4), ("full", 2, 4),
                                           ("none", 8, 2)])
@pytest.mark.parametrize("tensor_cores", [False, True])
def test_train_launches_counts_every_kernel(remat, L, micro, tensor_cores):
    # The formula chip_smoke.py holds the training paths' counters to: a
    # key for every counter, the tensor-core share of the forward, dQ and
    # dK/dV all of their launches or none.
    from trainingjob_operator_tpu_torch import ops

    want = smoke.train_launches(L, remat, micro, tensor_cores)
    assert set(want) == set(ops.launch_counts())
    fwd = micro * L * (2 if remat == "full" else 1)
    assert want["flash_attention_fwd"] == fwd
    for key, n in (("flash_attention_fwd", fwd),
                   ("flash_attention_bwd_dq", micro * L),
                   ("flash_attention_bwd_dkv", micro * L)):
        assert want[key] == n
        assert want[f"{key}_wgmma"] == (n if tensor_cores else 0)
    assert want["rmsnorm_fwd"] == micro * (
        (4 if remat == "full" else 2) * L + 1)
