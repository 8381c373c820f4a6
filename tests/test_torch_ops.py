"""PyTorch port ops against the JAX package: RMSNorm and flash attention,
forward and backward.

The same numpy inputs go through the JAX function -- its Pallas kernel in
interpret mode, and its XLA reference (or that reference's vjp) -- and
through the port's plain version, which is what a CPU tensor dispatches
to.  The CUDA kernels run only on the card: tests/test_torch_cuda.py and
chip_smoke.py hold them against the plain versions there.
"""

import importlib

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.ops import fused as jfused  # noqa: E402
from trainingjob_operator_tpu_torch import ops  # noqa: E402
from trainingjob_operator_tpu_torch.ops import fused as tfused  # noqa: E402

# ``ops.flash_attention`` is the function (both packages re-export it over
# the module name), so the modules come from importlib.
jfa = importlib.import_module("trainingjob_operator_tpu.ops.flash_attention")
tfa = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")

#: (rtol, atol) per dtype.  fp32: both sides compute the same f32 math in
#: another reduction order.  bf16: outputs are rounded to bf16 (8 bits of
#: mantissa), so one rounding step apart is ~4e-3 relative.
TOL = {"float32": (2e-4, 2e-5), "bfloat16": (2e-2, 2e-2)}
LSE_ATOL = 1e-4

# The tier-1 run spreads the suite over several worker processes;
# tiny shapes gain nothing from more intra-op threads.
torch.set_num_threads(2)


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor of ``dtype``."""
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


class TestRmsnorm:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("jax_side", ["pallas_interpret", "reference"])
    def test_matches_jax(self, monkeypatch, dtype, jax_side):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
        scale = rng.standard_normal((64,)).astype(np.float32)
        xj, xt = _pair(x, dtype)
        eps = 1e-5
        if jax_side == "pallas_interpret":
            monkeypatch.setenv("TRAININGJOB_PALLAS", "interpret")
            want = jfused.rmsnorm(xj, jnp.asarray(scale), eps)
        else:
            want = jfused._reference(xj, jnp.asarray(scale), eps=eps)
        got = tfused.rmsnorm(xt, torch.from_numpy(scale), eps)
        assert got.dtype == xt.dtype
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(_np(got), _np(want), rtol=rtol,
                                   atol=atol)

    def test_cpu_tensor_takes_plain_path(self):
        ops.reset_launch_counts()
        x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
        scale = torch.ones(64)
        got = ops.rmsnorm(x, scale, 1e-5)
        assert torch.equal(got, tfused.rmsnorm_reference(x, scale, 1e-5))
        assert ops.launch_counts()["rmsnorm_fwd"] == 0

    @pytest.mark.parametrize("case", ["odd_dim", "f16", "scale_bf16",
                                      "strided", "grad"])
    def test_kernel_refuses_what_it_does_not_take(self, case):
        x = torch.zeros(4, 64)
        scale = torch.ones(64)
        err = ValueError
        if case == "odd_dim":
            x, scale = torch.zeros(4, 12), torch.ones(12)
        elif case == "f16":
            x, err = x.half(), TypeError
        elif case == "scale_bf16":
            scale = scale.bfloat16()
        elif case == "strided":
            x = torch.zeros(64, 4).t()
        else:
            x.requires_grad_(True)
            err = NotImplementedError
        with pytest.raises(err):
            tfused.check_kernel_args(x, scale)


FLASH_CASES = [
    # (causal, H, Hkv, T, window, dtype)
    (True, 4, 4, 64, 0, "float32"),
    (False, 4, 4, 64, 0, "float32"),
    (True, 4, 2, 64, 0, "float32"),
    (True, 4, 2, 48, 0, "float32"),
    (False, 4, 2, 48, 0, "float32"),
    (True, 4, 2, 48, 8, "float32"),
    (True, 4, 4, 64, 16, "float32"),
    (True, 4, 2, 48, 0, "bfloat16"),
    (True, 4, 2, 48, 16, "bfloat16"),
]


def _qkv(B, T, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, T, Hkv, D)).astype(np.float32))


class TestFlashAttention:
    @pytest.mark.parametrize("causal,H,Hkv,T,window,dtype", FLASH_CASES)
    @pytest.mark.parametrize("jax_side", ["pallas_interpret", "reference"])
    def test_out_and_lse_match_jax(self, causal, H, Hkv, T, window, dtype,
                                   jax_side):
        D = 16
        q, k, v = _qkv(2, T, H, Hkv, D)
        (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, k, v))
        scale = D ** -0.5
        # The JAX kernels take [B, H, T, D].
        qj, kj, vj = (a.transpose(0, 2, 1, 3) for a in (qj, kj, vj))
        if jax_side == "pallas_interpret":
            # Blocks of 32 do not divide T = 48: the padded-tail masking
            # runs on the JAX side, the ragged-tile guards on the port's.
            out_j, lse_j = jfa._flash_forward(
                qj, kj, vj, scale=scale, causal=causal, block_q=32,
                block_k=32, interpret=True, window=window)
        else:
            out_j = jfa._reference(qj, kj, vj, scale=scale, causal=causal,
                                   window=window)
            lse_j = jfa._reference_lse(qj, kj, scale=scale, causal=causal,
                                       window=window)
        out_t, lse_t = tfa.flash_attention_with_lse(
            qt, kt, vt, causal=causal, window=window)
        assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
        assert lse_t.dtype == torch.float32 and lse_t.shape == (2, H, T)
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(_np(out_t),
                                   _np(out_j).transpose(0, 2, 1, 3),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                                   rtol=0, atol=LSE_ATOL)

    def test_flash_attention_is_out_of_with_lse(self):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 4, 2, 16))
        out, _ = tfa.flash_attention_with_lse(q, k, v, causal=True)
        assert torch.equal(tfa.flash_attention(q, k, v, causal=True), out)

    def test_cpu_tensor_takes_plain_path(self):
        ops.reset_launch_counts()
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 4, 2, 16))
        ops.flash_attention(q, k, v, causal=True)
        assert ops.launch_counts()["flash_attention_fwd"] == 0

    @pytest.mark.parametrize("case", ["window_non_causal", "gqa_mismatch",
                                      "head_dim", "dtype_mix", "grad"])
    def test_refusals(self, case):
        q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 4, 2, 16))
        if case == "window_non_causal":
            with pytest.raises(ValueError):
                tfa.flash_attention(q, k, v, causal=False, window=4)
        elif case == "gqa_mismatch":
            q3, k3, v3 = (torch.from_numpy(a) for a in _qkv(1, 20, 4, 3, 16))
            with pytest.raises(ValueError):
                tfa.flash_attention(q3, k3, v3)
        elif case == "head_dim":
            q, k, v = (torch.from_numpy(a) for a in _qkv(1, 20, 4, 2, 24))
            with pytest.raises(ValueError):
                tfa.check_kernel_args(q, k, v)
        elif case == "dtype_mix":
            with pytest.raises(TypeError):
                tfa.check_kernel_args(q, k.bfloat16(), v)
        else:
            q.requires_grad_(True)
            with pytest.raises(NotImplementedError):
                tfa.check_kernel_args(q, k, v)


class TestRmsnormGrad:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_grads_match_jax_vjp(self, dtype):
        rng = np.random.default_rng(3)
        x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2
        scale = rng.standard_normal((64,)).astype(np.float32)
        g = rng.standard_normal((3, 5, 64)).astype(np.float32)
        (xj, xt), (gj, gt) = _pair(x, dtype), _pair(g, dtype)
        _, vjp = jax.vjp(lambda a, s: jfused.rmsnorm(a, s, 1e-5), xj,
                         jnp.asarray(scale))
        dxj, dsj = vjp(gj)
        xt.requires_grad_(True)
        st = torch.from_numpy(scale).requires_grad_(True)
        tfused.rmsnorm(xt, st, 1e-5).backward(gt)
        assert xt.grad.dtype == xt.dtype and st.grad.dtype == torch.float32
        assert st.grad.shape == (64,)
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(_np(xt.grad), _np(dxj), rtol=rtol,
                                   atol=atol)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(dsj),
                                   rtol=rtol, atol=atol)

    def test_kernel_takes_grad_inputs_inside_the_function(self):
        # The autograd Function's forward runs with grad mode off: the
        # check that refuses a bare call lets the Function's call through.
        x = torch.zeros(4, 64, requires_grad=True)
        with torch.no_grad():
            tfused.check_kernel_args(x, torch.ones(64))

    @pytest.mark.parametrize("requires_grad,grad_mode,traced", [
        (True, True, True), (True, False, False), (False, True, False)])
    def test_function_runs_only_where_a_gradient_is_wanted(
            self, requires_grad, grad_mode, traced):
        # Serving calls the forward bare: no Function, nothing saved.
        x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0),
                        requires_grad=requires_grad)
        scale = torch.ones(64)
        with torch.set_grad_enabled(grad_mode):
            y = tfused.rmsnorm(x, scale, 1e-5)
        assert (type(y.grad_fn).__name__ == "_RMSNormBackward") == traced
        assert (y.grad_fn is not None) == traced
        torch.testing.assert_close(
            y, tfused.rmsnorm_reference(x, scale, 1e-5), rtol=0, atol=0)


#: (causal, H, Hkv, T, window, dtype) of the backward cases: T <= 40,
#: ragged against the JAX side's blocks of 16 and 8.
BWD_CASES = [
    (True, 4, 4, 40, 0, "float32"),
    (False, 4, 2, 40, 0, "float32"),
    (True, 4, 2, 37, 0, "float32"),
    (False, 4, 4, 37, 0, "float32"),
    (True, 4, 2, 37, 5, "float32"),
    (True, 4, 4, 40, 5, "float32"),
    (True, 4, 2, 37, 0, "bfloat16"),
    (True, 4, 2, 40, 5, "bfloat16"),
]
#: The cases also run against the Pallas kernels in interpret mode (a few
#: seconds each): causal GQA with a ragged tile, non-causal, window, bf16.
INTERPRET_CASES = [BWD_CASES[i] for i in (2, 1, 4, 7)]
#: (rtol, atol) of the gradients: fp32 the same math in another order;
#: bf16 gradients one bf16 rounding apart.
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}


class TestFlashBackward:
    @pytest.mark.parametrize(
        "jax_side,causal,H,Hkv,T,window,dtype",
        [("pallas_interpret",) + c for c in INTERPRET_CASES]
        + [("reference_vjp",) + c for c in BWD_CASES])
    def test_grads_match_jax(self, monkeypatch, jax_side, causal, H, Hkv, T,
                             window, dtype):
        D = 16
        q, k, v = _qkv(2, T, H, Hkv, D, seed=4)
        g = np.random.default_rng(5).standard_normal(
            (2, T, H, D)).astype(np.float32)
        (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
            _pair(a, dtype) for a in (q, k, v, g))
        if jax_side == "pallas_interpret":
            # The JAX custom_vjp with its Pallas forward and _flash_backward
            # kernels, blocks of 16 and 8.
            monkeypatch.setenv("TRAININGJOB_PALLAS", "interpret")

            def fwd(a, b, c):
                return jfa.flash_attention(a, b, c, causal=causal,
                                           window=window, block_q=16,
                                           block_k=8)
        else:
            def fwd(a, b, c):
                return jfa.attention_xla(a, b, c, causal=causal,
                                         window=window)
        _, vjp = jax.vjp(fwd, qj, kj, vj)
        want = vjp(gj)
        for t in (qt, kt, vt):
            t.requires_grad_(True)
        ops.reset_launch_counts()
        tfa.flash_attention(qt, kt, vt, causal=causal,
                            window=window).backward(gt)
        assert sum(ops.launch_counts().values()) == 0
        rtol, atol = BWD_TOL[dtype]
        for got, w in zip((qt.grad, kt.grad, vt.grad), want):
            assert got.dtype == qt.dtype and got.shape == w.shape
            np.testing.assert_allclose(_np(got), _np(w), rtol=rtol,
                                       atol=atol)

    def test_plain_kernels_match_jax_pallas_kernels(self):
        # The plain dQ and dK/dV functions against _flash_backward itself,
        # fed the same lse and delta.
        D, T, H, Hkv, causal, window = 16, 37, 4, 2, True, 5
        q, k, v = _qkv(1, T, H, Hkv, D, seed=6)
        g = np.random.default_rng(7).standard_normal(
            (1, T, H, D)).astype(np.float32)
        scale = D ** -0.5
        qj, kj, vj, gj = (jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (q, k, v, g))
        out = jfa._reference(qj, kj, vj, scale=scale, causal=causal,
                             window=window)
        lse = jfa._reference_lse(qj, kj, scale=scale, causal=causal,
                                 window=window)
        delta = (gj * out).sum(-1)
        want = jfa._flash_backward(qj, kj, vj, lse, gj, scale=scale,
                                   causal=causal, block_q=16, block_k=8,
                                   interpret=True, delta=delta,
                                   window=window)
        args = [torch.from_numpy(a) for a in (q, k, v, g)] + [
            torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(delta))]
        opts = dict(causal=causal, scale=scale, window=window)
        dq = tfa.flash_bwd_dq_reference(*args, **opts)
        dk, dv = tfa.flash_bwd_dkv_reference(*args, **opts)
        for got, w in zip((dq, dk, dv), want):
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(w).transpose(0, 2, 1, 3),
                                       rtol=1e-4, atol=1e-4)

    def test_delta_is_rowsum_of_do_times_o(self):
        rng = np.random.default_rng(8)
        g, o = (torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(
            np.float32)) for _ in range(2))
        delta = tfa.flash_delta(g, o)
        assert delta.shape == (2, 4, 9) and delta.is_contiguous()
        torch.testing.assert_close(delta, (g * o).sum(-1).transpose(1, 2))

    def test_lse_carries_no_gradient(self):
        q, k, v = (torch.from_numpy(a).requires_grad_(True)
                   for a in _qkv(1, 12, 4, 2, 16))
        out, lse = tfa.flash_attention_with_lse(q, k, v)
        assert out.requires_grad and not lse.requires_grad

    def test_kernel_takes_grad_inputs_inside_the_function(self):
        q, k, v = (torch.from_numpy(a).requires_grad_(True)
                   for a in _qkv(1, 20, 4, 2, 16))
        with torch.no_grad():
            tfa.check_kernel_args(q, k, v)

    @pytest.mark.parametrize("requires_grad,grad_mode,traced", [
        (True, True, True), (True, False, False), (False, True, False)])
    def test_function_runs_only_where_a_gradient_is_wanted(
            self, requires_grad, grad_mode, traced):
        q, k, v = (torch.from_numpy(a).requires_grad_(requires_grad)
                   for a in _qkv(1, 20, 4, 2, 16))
        with torch.set_grad_enabled(grad_mode):
            out, lse = tfa.flash_attention_with_lse(q, k, v, window=5)
        assert (type(out.grad_fn).__name__ == "_FlashBackward") == traced
        assert (out.grad_fn is not None) == traced
        want, want_lse = tfa.flash_reference_with_lse(
            q, k, v, causal=True, scale=16 ** -0.5, window=5)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)


class TestBuild:
    def test_ctypes_signatures_match_the_c_entry_points(self):
        # The argtypes in _build.SIGNATURES must list exactly the
        # parameters of each extern "C" entry point, or ctypes would pass
        # misplaced or truncated arguments.
        import re

        from trainingjob_operator_tpu_torch.ops import _build

        found = {}
        for src in sorted(_build.SRC_DIR.glob("*.cu")):
            text = src.read_text()
            for m in re.finditer(r'extern "C" int (tj_\w+)\(([^)]*)\)',
                                 text):
                found[m.group(1)] = len(m.group(2).split(","))
        assert found == {name: len(args) for name, args in
                         _build.SIGNATURES.items()}

    def test_source_tag_covers_every_source(self, tmp_path, monkeypatch):
        from trainingjob_operator_tpu_torch.ops import _build

        for src in _build.SRC_DIR.glob("*.cu*"):
            (tmp_path / src.name).write_bytes(src.read_bytes())
        monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
        tag = _build.source_tag()
        assert tag == _build.source_tag()
        (tmp_path / "common.cuh").write_text("// edited\n")
        assert _build.source_tag() != tag

    def test_build_without_nvcc_raises(self, monkeypatch, tmp_path):
        from trainingjob_operator_tpu_torch.ops import _build

        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
