"""The port's mesh, sharding rules and sharded training step
(``trainingjob_operator_tpu_torch/parallel/``, ``models/llama.py`` with a
mesh) against the JAX package and against the port on one process.

- ``mesh_spec_from_rendezvous`` gives the axis sizes the JAX
  ``mesh_from_rendezvous`` gives on the 8 virtual CPU devices, with the
  same errors; ``fit_spec(spec_for_path(...))`` equals JAX's for every
  leaf of the tiny, 124m and 7b trees on three meshes; the blocks of all
  ranks tile every leaf.
- Two gloo processes (``tests/_torch_parallel_rank.py``) on the tiny
  config in fp32, on the meshes fsdp=2, tp=2 and dp=2 (two slices), under
  remat "none" and "attn": the loss and every gradient, gathered from the
  two ranks' blocks, equal the one-process port's within rtol = atol =
  1e-5 and JAX's ``loss_fn`` with ``mesh=`` within ``F32_TOL``; three
  AdamW steps' losses equal one process's within 1e-5.  tok_embed's
  gradient entries and the parameters after AdamW are held to ``LOOSE``
  times those limits (see there).
- A tp that does not divide the heads is refused.
- Sequence and pipeline parallelism (``tests/_torch_sp_pp_rank.py
  llama``), the tiny config with 4 layers in fp32: two gloo processes on
  sp=2 and pp=2 and four on tp=2 x sp=2, pp=2 x fsdp=2 and pp=2 x sp=2,
  under remat "none" and "attn": the loss on every rank and every
  gradient equal one process's within 1e-5 and JAX's ``loss_fn`` with
  ``mesh=`` (``sequence_parallel`` where sp > 1) within ``F32_TOL``; each
  rank shifts what the ring and the schedule say (``_shifts``), the same
  under both policies; the pipeline's microbatches are JAX's but on
  pp=2 x fsdp=2, where JAX's 4 does not divide a rank's 2 rows.
"""

import dataclasses
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

from trainingjob_operator_tpu.models import llama as jllama  # noqa: E402
from trainingjob_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from trainingjob_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from trainingjob_operator_tpu.workloads import rendezvous as jrdv  # noqa: E402
from trainingjob_operator_tpu_torch.models import llama as tllama  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import (  # noqa: E402
    llama_elastic as telastic,
)
from trainingjob_operator_tpu_torch.workloads import rendezvous as trdv  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 loss and gradients against JAX (rtol = atol), as
#: tests/test_torch_train.py holds the one-process port.
F32_TOL = 1e-4
#: The port on two processes against the port on one: the same math with
#: the gradients summed over ranks in another order.
SELF_TOL = 1e-5
#: Two things are held to LOOSE x the tolerance:
#: - tok_embed's gradient, elementwise (as a whole it is held to a
#:   relative L2 error of the tolerance itself, as every leaf): it is the
#:   first RMSNorm's backward (a difference of two terms each about 50x
#:   the result, at an embedding RMS of 0.02) of a sum that tp splits in
#:   two and adds in another order.  Under tp=2, 4 of its 16384 entries
#:   differ from one process by up to 1.9e-5 (4.5e-5 relative; relative
#:   L2 error 6.1e-6) and 1 from JAX's mesh by 1.1e-4 (relative L2 5.2e-5);
#:   JAX's own gradient moves by 1.3e-4 between no mesh and tp=2.
#: - the parameters after AdamW steps (the losses are held to SELF_TOL):
#:   the first update is about lr x sign(g), so an entry whose gradient is
#:   near 0 carries the gradient's rounding into its update.  Under tp=2,
#:   entries of tok_embed, wk and w_up differ by up to 2.5e-5 after three
#:   steps, and tok_embed's relative L2 error is 1.2e-5.
LOOSE = 10


def _assert_close(got, want, tol, path, elementwise=None):
    elementwise = elementwise or tol
    np.testing.assert_allclose(got, want, rtol=elementwise, atol=elementwise,
                               err_msg=path)
    rel_l2 = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert rel_l2 <= tol, (path, rel_l2)


ROOT = Path(__file__).resolve().parent.parent
RANK = ROOT / "tests" / "_torch_parallel_rank.py"
#: As in the worker: mesh -> (tp, num_slices), and the remat policies.
CASES = {"fsdp": (1, 1), "tp": (2, 1), "dp": (1, 2)}
REMATS = ("none", "attn")
#: The trainer's LLAMA_LR default.  AdamW's first update is about lr x
#: sign(g), so an entry whose gradient is rounding noise on both sides
#: may move by up to 2 lr either way.
ADAMW_LR = 3e-4
B, T = 4, 16

torch.set_num_threads(2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("tp,slices", [(1, 1), (2, 1), (4, 1), (8, 1),
                                       (1, 2), (2, 2), (2, 4), (1, 8)])
def test_mesh_spec_matches_jax(tp, slices):
    want = jmesh.mesh_from_rendezvous(
        jrdv.from_env({"MEGASCALE_NUM_SLICES": str(slices)}),
        model_parallel=tp)
    got = tmesh.mesh_spec_from_rendezvous(
        trdv.from_env({"TRAININGJOB_NUM_PROCESSES":
                       str(jax.device_count()),
                       "MEGASCALE_NUM_SLICES": str(slices)}),
        model_parallel=tp)
    assert got.names == tuple(want.axis_names)
    assert got.sizes == dict(want.shape)
    assert got.size() == jax.device_count()


@pytest.mark.parametrize("tp,slices,match", [
    (3, 1, "not divisible by tp"), (1, 3, "not divisible by num_slices")])
def test_mesh_spec_refusals_match_jax(tp, slices, match):
    rdv = jrdv.from_env({"MEGASCALE_NUM_SLICES": str(slices)})
    with pytest.raises(ValueError, match=match):
        jmesh.mesh_from_rendezvous(rdv, model_parallel=tp)
    with pytest.raises(ValueError, match=match):
        tmesh.mesh_spec_from_rendezvous(
            trdv.from_env({"TRAININGJOB_NUM_PROCESSES": "8",
                           "MEGASCALE_NUM_SLICES": str(slices)}),
            model_parallel=tp)


MESHES = {"fsdp2": {"fsdp": 2}, "fsdp2_tp2": {"fsdp": 2, "tp": 2},
          "dp2_fsdp2": {"dp": 2, "fsdp": 2}}
CONFIGS = {"tiny": jllama.LlamaConfig.tiny,
           "124m": jllama.LlamaConfig.base_124m,
           "7b": jllama.LlamaConfig.llama2_7b}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fit_spec_matches_jax_on_every_leaf(config, mesh_name):
    sizes = MESHES[mesh_name]
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(**sizes),
                         devices=jax.devices()[:n])
    tm = tmesh.MeshSpec.of(**sizes)
    jc = CONFIGS[config]()
    shapes = jax.eval_shape(lambda: jllama.init_params(
        jc, jax.random.PRNGKey(0)))
    jrules = jllama.sharding_rules()
    trules = tllama.sharding_rules()
    assert [tuple(r[1]) for r in trules] == [tuple(r[1]) for r in jrules]
    got_shapes = dict(tsharding.tree_paths(tllama.param_shapes(
        tllama.LlamaConfig(**jc.__dict__))))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) == len(got_shapes) == 12
    for key_path, leaf in leaves:
        path = jsharding.path_of(key_path)
        assert got_shapes[path] == tuple(leaf.shape), path
        want = jsharding.fit_spec(jsharding.spec_for_path(path, jrules),
                                  leaf.shape, jm)
        got = tsharding.fit_spec(tsharding.spec_for_path(path, trules),
                                 leaf.shape, tm)
        assert got == tuple(want), (path, got, want)


class _Rank:
    """A mesh seen from one rank (``coord``, ``size``, ``sizes`` and the
    data shard's size and index) without a process group."""

    def __init__(self, spec, index):
        self.sizes = spec.sizes
        self._coords = dict(zip(spec.names,
                                np.unravel_index(index, spec.shape)))

    def coord(self, axis):
        return int(self._coords.get(axis, 0))

    def size(self, axis):
        return self.sizes.get(axis, 1)

    data_size = tmesh.Mesh.data_size
    data_index = tmesh.Mesh.data_index


@pytest.mark.parametrize("sizes", [{"fsdp": 4}, {"fsdp": 2, "tp": 2},
                                   {"dp": 2, "fsdp": 2, "tp": 2}])
def test_the_blocks_of_all_ranks_tile_every_leaf(sizes):
    cfg = tllama.LlamaConfig.tiny()
    spec = tmesh.MeshSpec.of(**sizes)
    ranks = [_Rank(spec, i) for i in range(spec.size())]
    for path, shape in tsharding.tree_paths(tllama.param_shapes(cfg)):
        count = np.zeros(shape, np.int64)
        for rank in ranks:
            block = tsharding.block_of(
                tsharding.leaf_spec(path, shape, tllama.sharding_rules(),
                                    rank), shape, rank)
            count[tsharding.block_slices(block)] += 1
        # Each element is held by every rank whose axes the leaf is
        # replicated over, and by no other.
        assert count.min() == count.max() > 0, path
        assert count.sum() == count.size * count.max(), path


def test_a_tp_that_does_not_divide_the_heads_is_refused():
    cfg = tllama.LlamaConfig.tiny()
    tllama.check_tp(cfg, 2)
    with pytest.raises(ValueError, match="tp=3 does not divide n_heads=4"):
        tllama.check_tp(cfg, 3)
    gqa = dataclasses.replace(cfg, n_heads=8, n_kv_heads=2)
    with pytest.raises(ValueError, match="tp=4 does not divide n_kv_heads"):
        tllama.check_tp(gqa, 4)
    spec = tmesh.MeshSpec.of(fsdp=1, tp=3)
    with pytest.raises(ValueError, match="does not divide"):
        tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                           mesh=_Rank(spec, 0))


def _configs():
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    return jc, tllama.LlamaConfig(**jc.__dict__)


def _flat_numpy(tree):
    return {jsharding.path_of(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def inputs():
    jc, _ = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    batches = {"tokens": rng.integers(0, 256, (B, T + 1)).astype(np.int32)}
    for i in range(3):
        batches[f"step{i}"] = rng.integers(0, 256, (B, T + 1)).astype(
            np.int32)
    return tree, batches


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The two ranks' outputs of ``_torch_parallel_rank.py``."""
    tree, batches = inputs
    work = tmp_path_factory.mktemp("parallel")
    src = work / "inputs.npz"
    np.savez(src, **{f"p/{k}": v for k, v in _flat_numpy(tree).items()},
             **batches)
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
           "TRAININGJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
           "TRAININGJOB_NUM_PROCESSES": "2"}
    procs = []
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(RANK), str(src),
                 str(work / f"rank{rank}.npz")],
                env={**env, "TRAININGJOB_PROCESS_ID": str(rank)}, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=50)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]


def _gathered(ranks, kind, prefix, shapes):
    """Every leaf whole from the two ranks' blocks; where both hold an
    element, their values agree within SELF_TOL."""
    out = {}
    for path, shape in shapes.items():
        full = np.full(shape, np.nan, np.float32)
        for res in ranks:
            index = res[f"{kind}/block/{path}"]
            cut = tuple(slice(a, b) for a, b in index)
            block = res[f"{prefix}/{path}"]
            held = full[cut]
            seen = ~np.isnan(held)
            np.testing.assert_allclose(block[seen], held[seen],
                                       rtol=SELF_TOL, atol=SELF_TOL,
                                       err_msg=path)
            full[cut] = block
        assert not np.isnan(full).any(), path
        out[path] = full
    return out


def _one_process(tree, batches, remat):
    """The port on one process: loss and gradients, and three AdamW steps
    of ``make_step_fn`` (accumulation 2)."""
    _, tc = _configs()
    params = ttrain.trainable_copy(
        tllama.params_from_numpy(tree, tc, "cpu", master=True), "cpu")
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(
        batches["tokens"]).long()}, tc, remat=remat)
    loss.backward()
    grads = {p: x.grad.numpy() for p, x in tsharding.tree_paths(params)}
    params = ttrain.trainable_copy(
        tllama.params_from_numpy(tree, tc, "cpu", master=True), "cpu")
    step_fn = telastic.make_step_fn(params, tc, accum=2, lr=ADAMW_LR,
                                    remat=remat)
    losses = [float(step_fn(torch.from_numpy(batches[f"step{i}"]).long()))
              for i in range(3)]
    return (float(loss.detach()), grads, losses,
            {p: x.detach().numpy() for p, x in tsharding.tree_paths(params)})


@pytest.fixture(scope="module")
def one_process(inputs):
    tree, batches = inputs
    return {remat: _one_process(tree, batches, remat) for remat in REMATS}


def _jax_loss_and_grads(tree, tokens, kind, remat):
    jc, _ = _configs()
    tp, slices = CASES[kind]
    mesh = jmesh.make_mesh(jmesh.MeshSpec.of(dp=slices, fsdp=2 // tp // slices,
                                             tp=tp),
                           devices=jax.devices()[:2])
    params = jsharding.shard_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree), jllama.SHARDING_RULES,
        mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jllama.loss_fn(p, {"tokens": t}, jc, mesh=mesh,
                                    remat=remat)))(params,
                                                   jnp.asarray(tokens))
    return float(loss), _flat_numpy(grads)


def _shapes():
    _, tc = _configs()
    return dict(tsharding.tree_paths(tllama.param_shapes(tc)))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("kind", sorted(CASES))
def test_two_ranks_equal_one_process(ranks, one_process, kind, remat):
    loss, grads, _, _ = one_process[remat]
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{kind}/{remat}/loss"]), loss,
                                   rtol=SELF_TOL, atol=SELF_TOL)
    got = _gathered(ranks, kind, f"{kind}/{remat}/grad", _shapes())
    assert set(got) == set(grads)
    for path, want in grads.items():
        _assert_close(got[path], want, SELF_TOL, path,
                      LOOSE * SELF_TOL if path == "tok_embed" else None)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("kind", sorted(CASES))
def test_two_ranks_equal_jax_on_its_mesh(inputs, ranks, kind, remat):
    tree, batches = inputs
    lj, gj = _jax_loss_and_grads(tree, batches["tokens"], kind, remat)
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{kind}/{remat}/loss"]), lj,
                                   rtol=F32_TOL)
    got = _gathered(ranks, kind, f"{kind}/{remat}/grad", _shapes())
    assert set(got) == set(gj)
    for path, want in gj.items():
        _assert_close(got[path], want, F32_TOL, path,
                      LOOSE * F32_TOL if path == "tok_embed" else None)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("kind", sorted(CASES))
def test_three_adamw_steps_equal_one_process(ranks, one_process, kind,
                                             remat):
    _, _, losses, params = one_process[remat]
    for res in ranks:
        np.testing.assert_allclose(res[f"{kind}/{remat}/adamw/losses"],
                                   losses, rtol=SELF_TOL, atol=SELF_TOL)
    got = _gathered(ranks, kind, f"{kind}/{remat}/adamw/param", _shapes())
    for path, want in params.items():
        _assert_close(got[path], want, LOOSE * SELF_TOL, path)


#: The sp and pp meshes of tests/_torch_sp_pp_rank.py: world -> mesh ->
#: (tp, sp, pp), on the tiny config with SP_PP_LAYERS layers.
SP_PP = {2: {"sp2": (1, 2, 1), "pp2": (1, 1, 2)},
         4: {"tp2_sp2": (2, 2, 1), "pp2_fsdp2": (1, 1, 2),
             "pp2_sp2": (1, 2, 2)}}
SP_PP_MESHES = {name: (world, axes) for world, meshes in SP_PP.items()
                for name, axes in meshes.items()}
SP_PP_LAYERS = 4
SP_PP_RANK = ROOT / "tests" / "_torch_sp_pp_rank.py"
#: The relative L2 error a gradient may have on an sp mesh against one
#: process (elementwise it is held to SELF_TOL as everywhere).  The ring
#: sums each softmax row over blocks, in another order than one process,
#: and the 4-layer backward amplifies that rounding: JAX's own gradients
#: on its sp=2 mesh lie 1.8e-5 (wk, relative L2) from its gradients
#: without a mesh.  The port's largest: 1.4e-5 at sp=2 and pp=2 x sp=2,
#: 2.6e-5 at tp=2 x sp=2 (wv).
RING_L2 = 4e-5


def _sp_pp_configs():
    jc = dataclasses.replace(jllama.LlamaConfig.tiny(n_layers=SP_PP_LAYERS),
                             dtype="float32")
    return jc, tllama.LlamaConfig(**jc.__dict__)


@pytest.fixture(scope="module")
def sp_pp_inputs():
    """PRNGKey(0), as ``inputs``.  (At PRNGKey(1) the 4-layer gradients are
    ill-conditioned in f32: JAX's own f32 gradient of wk lies 2.2e-4
    (relative L2) from its f64 gradient there, and the one-process port's
    5.1e-4; at PRNGKey(0) 2.3e-5 and 3.8e-5.)"""
    jc, _ = _sp_pp_configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jc, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(9).integers(0, 256, (B, T + 1)).astype(
        np.int32)
    return tree, tokens


@pytest.fixture(scope="module")
def sp_pp_ranks(sp_pp_inputs, tmp_path_factory):
    """Each world's ranks' outputs of ``_torch_sp_pp_rank.py llama``: the
    two- and four-process groups run side by side."""
    tree, tokens = sp_pp_inputs
    work = tmp_path_factory.mktemp("sp_pp")
    src = work / "inputs.npz"
    np.savez(src, **{f"p/{k}": v for k, v in _flat_numpy(tree).items()},
             tokens=tokens)
    procs = {}
    try:
        for world in SP_PP:
            env = {**os.environ, "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": str(ROOT),
                   "TRAININGJOB_COORDINATOR_ADDRESS":
                       f"127.0.0.1:{_free_port()}",
                   "TRAININGJOB_NUM_PROCESSES": str(world)}
            procs[world] = [subprocess.Popen(
                [sys.executable, str(SP_PP_RANK), str(src),
                 str(work / f"w{world}_rank{rank}.npz"), "llama"],
                env={**env, "TRAININGJOB_PROCESS_ID": str(rank)}, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for rank in range(world)]
        outs = {world: [p.communicate(timeout=60)[0] for p in ps]
                for world, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    assert all(p.returncode == 0 for ps in procs.values() for p in ps), outs
    return {world: [dict(np.load(work / f"w{world}_rank{r}.npz"))
                    for r in range(world)] for world in SP_PP}


@pytest.fixture(scope="module")
def sp_pp_one_process(sp_pp_inputs):
    tree, tokens = sp_pp_inputs
    _, tc = _sp_pp_configs()
    params = ttrain.trainable_copy(
        tllama.params_from_numpy(tree, tc, "cpu", master=True), "cpu")
    loss = tllama.loss_fn(params, {"tokens": torch.from_numpy(tokens).long()},
                          tc)
    loss.backward()
    return float(loss.detach()), {p: x.grad.numpy() for p, x in
                                  tsharding.tree_paths(params)}


def _sp_pp_shapes():
    _, tc = _sp_pp_configs()
    return dict(tsharding.tree_paths(tllama.param_shapes(tc)))


def _shifts(mesh, microbatches):
    """One rank's shifts of a loss and its backward: each of its layers
    rings once a microbatch, 2 (sp - 1) forward and 2 (sp - 1) + 2 sp
    backward (``parallel/ringattention.py``); the schedule hands off
    M + S - 2 times each way (``parallel/pipeline.py``)."""
    _, (tp, sp, pp) = SP_PP_MESHES[mesh]
    ring = (SP_PP_LAYERS // pp) * microbatches * (
        6 * sp - 4) if sp > 1 else 0
    return ring + (2 * (microbatches + pp - 2) if pp > 1 else 0)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("mesh", sorted(SP_PP_MESHES))
def test_sp_pp_ranks_equal_one_process(sp_pp_ranks, sp_pp_one_process, mesh,
                                       remat):
    world, _ = SP_PP_MESHES[mesh]
    ranks = sp_pp_ranks[world]
    loss, grads = sp_pp_one_process
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{mesh}/{remat}/loss"]), loss,
                                   rtol=SELF_TOL, atol=SELF_TOL)
    got = _gathered(ranks, mesh, f"{mesh}/{remat}/grad", _sp_pp_shapes())
    assert set(got) == set(grads)
    l2 = RING_L2 if SP_PP_MESHES[mesh][1][1] > 1 else SELF_TOL
    for path, want in grads.items():
        _assert_close(got[path], want, l2, path,
                      LOOSE * SELF_TOL if path == "tok_embed" else SELF_TOL)


def _jax_sp_pp(tree, tokens, mesh):
    jc, _ = _sp_pp_configs()
    world, (tp, sp, pp) = SP_PP_MESHES[mesh]
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(pp=pp, fsdp=world // (tp * sp * pp),
                                           tp=tp, sp=sp),
                         devices=jax.devices()[:world])
    params = jsharding.shard_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jllama.sharding_rules(pipeline=pp > 1), jm)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jllama.loss_fn(p, {"tokens": t}, jc, mesh=jm,
                                    sequence_parallel=sp > 1)))(
        params, jnp.asarray(tokens))
    return float(loss), _flat_numpy(grads)


@pytest.fixture(scope="module")
def sp_pp_jax(sp_pp_inputs):
    """JAX's loss and gradients on each mesh (remat changes neither)."""
    tree, tokens = sp_pp_inputs
    return {mesh: _jax_sp_pp(tree, tokens, mesh) for mesh in SP_PP_MESHES}


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("mesh", sorted(SP_PP_MESHES))
def test_sp_pp_ranks_equal_jax_on_its_mesh(sp_pp_ranks, sp_pp_jax, mesh,
                                           remat):
    world, _ = SP_PP_MESHES[mesh]
    ranks = sp_pp_ranks[world]
    lj, gj = sp_pp_jax[mesh]
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{mesh}/{remat}/loss"]), lj,
                                   rtol=F32_TOL)
    got = _gathered(ranks, mesh, f"{mesh}/{remat}/grad", _sp_pp_shapes())
    assert set(got) == set(gj)
    for path, want in gj.items():
        _assert_close(got[path], want, F32_TOL, path,
                      LOOSE * F32_TOL if path == "tok_embed" else None)


@pytest.mark.parametrize("mesh", sorted(SP_PP_MESHES))
def test_sp_pp_shifts_and_microbatches(sp_pp_ranks, mesh):
    world, (_, _, pp) = SP_PP_MESHES[mesh]
    for res in sp_pp_ranks[world]:
        m, m_jax = (int(x) for x in res[f"{mesh}/microbatches"])
        # The rows of a data shard: B over dp x fsdp.
        rows = B // (world // int(np.prod(SP_PP_MESHES[mesh][1])))
        if pp > 1:
            n_data = world // int(np.prod(SP_PP_MESHES[mesh][1]))
            assert m_jax == jllama.choose_microbatches(
                B, 8 * (pp - 1), n_data, pp, False)
            assert m == (m_jax if rows % m_jax == 0 else rows)
        # "attn" saves the ring's (out, lse): its backward shifts no more
        # than "none"'s.
        for remat in REMATS:
            assert int(res[f"{mesh}/{remat}/p2p"]) == _shifts(mesh, m), \
                (remat, res[f"{mesh}/{remat}/p2p"])
    assert [int(r[f"{mesh}/microbatches"][0]) != int(
        r[f"{mesh}/microbatches"][1]) for r in sp_pp_ranks[world]] == \
        [mesh == "pp2_fsdp2"] * world
