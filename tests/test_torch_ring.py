"""Ring attention (``trainingjob_operator_tpu_torch/parallel/
ringattention.py``) and the ring exchange of ``parallel/collectives.py``
against the JAX package's ``parallel/ringattention.py`` and against one
process.

- In one process: the ring's schedule, the per-block forward merged over
  a split of the keys equals the whole flash forward (out and lse), and
  the per-block backward with the merged lse and delta sums to the whole
  backward; at sp = 1 ``ring_attention`` is the flash kernel's path bit
  for bit and shifts nothing; ``ring_permutation``, ``require_axis`` and
  ``require_ici_axis`` equal JAX's (values, types and messages).
- Four gloo processes (``tests/_torch_sp_pp_rank.py ring``) on the meshes
  fsdp=2 x sp=2 and sp=4, MHA (4/4) and GQA (4/2), causal and not: each
  rank's out and dq, dk, dv of ``sum(out * w)`` on its rows and sequence
  block, put together, equal one process's ``reference_attention``
  within ``SELF_TOL`` and JAX's ``ring_attention_sharded`` on the 8
  virtual CPU devices (fp32) within ``F32_TOL``; each rank shifts
  2 (sp - 1) + 2 (sp - 1) + 2 sp blocks.
"""

import importlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from trainingjob_operator_tpu.parallel import collectives as jcoll  # noqa: E402
from trainingjob_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from trainingjob_operator_tpu.parallel import ringattention as jring  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import collectives as tcoll  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import ringattention as tring  # noqa: E402

tflash = importlib.import_module(
    "trainingjob_operator_tpu_torch.ops.flash_attention")

#: The port on four processes against the port on one: the same math,
#: merged over blocks.
SELF_TOL = 1e-5
#: Against JAX in fp32, as tests/test_torch_parallel.py holds the mesh.
F32_TOL = 1e-4
ROOT = Path(__file__).resolve().parent.parent
RANK = ROOT / "tests" / "_torch_sp_pp_rank.py"
#: As in the worker: mesh -> sp, and (Hq, Hkv, causal) cases.
MESHES = {"fsdp2_sp2": 2, "sp4": 4}
CASES = [(4, 4, True), (4, 4, False), (4, 2, True), (4, 2, False)]
B, T, D = 2, 16, 8

torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ring:
    """A one-rank view of a mesh for the in-process cases (no group: a
    ring of one shifts nothing)."""

    def __init__(self, **sizes):
        self.spec = tmesh.MeshSpec.of(**sizes)
        self.sizes = self.spec.sizes
        self.axis_names = self.spec.names
        self.num_slices = 1

    def size(self, axis):
        return self.sizes.get(axis, 1)

    def coord(self, axis):
        return 0


def _qkv(hq, hkv, t=T, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, t, hq, D), (B, t, hkv, D), (B, t, hkv, D),
                      (B, t, hq, D))]


@pytest.mark.parametrize("sp", [1, 2, 3, 4])
def test_the_schedule_sees_each_visible_block_once(sp):
    for my in range(sp):
        causal = tring.ring_blocks(my, sp, causal=True)
        assert [src for _, src, _ in causal] == list(range(my, -1, -1))
        assert [diag for _, _, diag in causal] == [True] + [False] * my
        full = tring.ring_blocks(my, sp, causal=False)
        assert sorted(src for _, src, _ in full) == list(range(sp))
        assert not any(diag for _, _, diag in full)
        assert [step for step, src, _ in full] == [
            (my - src) % sp for _, src, _ in full]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_blocks_merged_equal_the_whole_forward_and_backward(hq, hkv):
    """The second half of the queries against the two halves of the keys
    (an earlier block, unmasked, and the diagonal block, causal) is the
    whole causal attention's second half, out, lse and gradients."""
    q, k, v, g = _qkv(hq, hkv)
    scale = D ** -0.5
    out, lse = tflash.flash_reference_with_lse(q, k, v, causal=True)
    h = T // 2
    qb, gb = q[:, h:], g[:, h:]
    kv = [(k[:, :h], v[:, :h], False), (k[:, h:], v[:, h:], True)]
    parts = [tring.block_forward(qb, kb, vb, diagonal=diag, scale=scale)
             for kb, vb, diag in kv]
    got, got_lse = tring.merge_blocks(parts)
    np.testing.assert_allclose(got, out[:, h:], rtol=SELF_TOL, atol=SELF_TOL)
    np.testing.assert_allclose(got_lse, lse[..., h:], rtol=SELF_TOL,
                               atol=SELF_TOL)
    delta = tflash.flash_delta(g, out)
    opts = dict(causal=True, scale=scale, window=0)
    dq = tflash.flash_bwd_dq_reference(q, k, v, g, lse, delta, **opts)
    dk, dv = tflash.flash_bwd_dkv_reference(q, k, v, g, lse, delta, **opts)
    lse_b, delta_b = (x[..., h:].contiguous() for x in (lse, delta))
    grads = [tring.block_backward(qb, kb, vb, gb, lse_b, delta_b,
                                  diagonal=diag, scale=scale)
             for kb, vb, diag in kv]
    np.testing.assert_allclose(grads[0][0] + grads[1][0], dq[:, h:],
                               rtol=SELF_TOL, atol=SELF_TOL)
    # The second half of the queries is all that sees the second half of
    # the keys.
    for i, want in ((1, dk), (2, dv)):
        np.testing.assert_allclose(grads[1][i], want[:, h:], rtol=SELF_TOL,
                                   atol=SELF_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_a_ring_of_one_is_the_flash_path(causal):
    q, k, v, g = _qkv(4, 2)
    mesh = _Ring(fsdp=1, sp=1)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = tflash.flash_attention(*leaves, causal=causal)
    (want * g).sum().backward()
    tcoll.reset_collective_counts()
    got_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    got = tring.ring_attention(*got_leaves, mesh, causal=causal)
    (got * g).sum().backward()
    assert torch.equal(got, want)
    for a, b in zip(got_leaves, leaves):
        assert torch.equal(a.grad, b.grad)
    assert tcoll.collective_counts()["p2p"] == 0
    with torch.no_grad():
        assert torch.equal(tring.ring_attention(q, k, v, mesh,
                                                causal=causal), want)


def test_ring_permutation_equals_jax():
    for n in (1, 2, 3, 5):
        for reverse in (False, True):
            assert tcoll.ring_permutation(n, reverse) == \
                jcoll.ring_permutation(n, reverse)


class _JaxFakeMesh:
    """A JAX mesh over devices with slice ids, as tests/test_parallel.py
    builds one."""

    class Dev:
        def __init__(self, slice_index):
            self.slice_index = slice_index

    def __init__(self, names, shape, per_slice):
        n = int(np.prod(shape))
        self.devices = np.array([self.Dev(i // per_slice) for i in range(n)],
                                dtype=object).reshape(shape)
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


@pytest.mark.parametrize("sizes,slices,axis", [
    ({"fsdp": 2, "sp": 2}, 1, "sp"), ({"fsdp": 2, "sp": 2}, 2, "sp"),
    ({"fsdp": 2, "sp": 2}, 4, "sp"), ({"dp": 2, "sp": 2}, 2, "dp"),
    ({"fsdp": 2, "sp": 2}, 2, "fsdp")])
def test_require_ici_axis_equals_jax(sizes, slices, axis):
    spec = tmesh.MeshSpec.of(**sizes)
    mesh = _Ring(**sizes)
    mesh.num_slices = slices
    jm = _JaxFakeMesh(spec.names, spec.shape, spec.size() // slices)

    def outcome(fn, m):
        try:
            return fn(m, axis)
        except ValueError as exc:
            return ("ValueError", str(exc))
    assert outcome(tcoll.require_ici_axis, mesh) == \
        outcome(jcoll.require_ici_axis, jm)
    assert tmesh.axis_crosses_slices(spec, axis, slices) == \
        jcoll.axis_crosses_dcn(jm, axis)


def test_require_axis_equals_jax():
    spec = tmesh.MeshSpec.of(fsdp=2, tp=2)
    jm = _JaxFakeMesh(spec.names, spec.shape, 4)
    with pytest.raises(ValueError) as want:
        jcoll.require_axis(jm, "sp")
    with pytest.raises(ValueError) as got:
        tcoll.require_axis(_Ring(fsdp=2, tp=2), "sp")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="no 'sp'"):
        tring.ring_attention(*_qkv(4, 4)[:3], _Ring(fsdp=1), causal=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    data = {"q": rng.standard_normal((B, T, 4, D)),
            "w": rng.standard_normal((B, T, 4, D))}
    for hkv in (4, 2):
        data[f"k_{hkv}"] = rng.standard_normal((B, T, hkv, D))
        data[f"v_{hkv}"] = rng.standard_normal((B, T, hkv, D))
    return {k: v.astype(np.float32) for k, v in data.items()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The four ranks' outputs of ``_torch_sp_pp_rank.py ring``."""
    work = tmp_path_factory.mktemp("ring")
    src = work / "inputs.npz"
    np.savez(src, **inputs)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
           "TRAININGJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{_free_port()}",
           "TRAININGJOB_NUM_PROCESSES": "4"}
    procs = []
    try:
        for rank in range(4):
            procs.append(subprocess.Popen(
                [sys.executable, str(RANK), str(src),
                 str(work / f"rank{rank}.npz"), "ring"],
                env={**env, "TRAININGJOB_PROCESS_ID": str(rank)}, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]


def _gathered(ranks, key):
    """out, dq, dk, dv whole from the ranks' row and sequence blocks."""
    full = {}
    for res in ranks:
        r0, n, t0, tl = res[f"{key}/rows"]
        for part in ("out", "dq", "dk", "dv"):
            block = res[f"{key}/{part}"]
            if part not in full:
                full[part] = np.full((B, T) + block.shape[2:], np.nan,
                                     np.float32)
            full[part][r0:r0 + n, t0:t0 + tl] = block
    assert not any(np.isnan(x).any() for x in full.values())
    return full


def _one_process(inputs, hq, hkv, causal):
    q, k, v = (torch.from_numpy(inputs[x]).requires_grad_(True)
               for x in ("q", f"k_{hkv}", f"v_{hkv}"))
    out = tring.reference_attention(q, k, v, causal=causal)
    (out * torch.from_numpy(inputs["w"])).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": k.grad.numpy(), "dv": v.grad.numpy()}


def _jax_ring(inputs, sp, hq, hkv, causal):
    """JAX's ``ring_attention_sharded`` and its gradients on a mesh of
    (B rows over fsdp) x sp of the virtual CPU devices."""
    sizes = {"fsdp": 4 // sp, "sp": sp} if sp < 4 else {"sp": sp}
    mesh = jmesh.make_mesh(jmesh.MeshSpec.of(**sizes),
                           devices=jax.devices()[:4])
    spec = P("fsdp" if "fsdp" in sizes else None, "sp", None, None)
    q, k, v = (jax.device_put(jnp.asarray(inputs[x]),
                              NamedSharding(mesh, spec))
               for x in ("q", f"k_{hkv}", f"v_{hkv}"))
    w = jnp.asarray(inputs["w"])

    def loss(q, k, v):
        out = jring.ring_attention_sharded(q, k, v, mesh, causal=causal)
        return (out * w).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"out": np.asarray(out),
            **{n: np.asarray(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


@pytest.mark.parametrize("hq,hkv,causal", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_the_ring_equals_one_process(ranks, inputs, mesh, hq, hkv, causal):
    key = f"{mesh}/{hq}_{hkv}_{int(causal)}"
    got = _gathered(ranks, key)
    want = _one_process(inputs, hq, hkv, causal)
    for part in want:
        np.testing.assert_allclose(got[part], want[part], rtol=SELF_TOL,
                                   atol=SELF_TOL, err_msg=part)
    sp = MESHES[mesh]
    assert [int(r[f"{key}/p2p"]) for r in ranks] == \
        [2 * (sp - 1) + 2 * (sp - 1) + 2 * sp] * 4


@pytest.mark.parametrize("hq,hkv,causal", CASES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_the_ring_equals_jax_ring_attention_sharded(ranks, inputs, mesh, hq,
                                                    hkv, causal):
    got = _gathered(ranks, f"{mesh}/{hq}_{hkv}_{int(causal)}")
    want = _jax_ring(inputs, MESHES[mesh], hq, hkv, causal)
    for part in want:
        np.testing.assert_allclose(got[part], want[part], rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=part)
