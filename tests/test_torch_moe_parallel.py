"""The port's MoE family on a mesh (``models/moe.py`` with ``mesh=``, the
``ep`` axis) against the JAX package and against the port on one
process.

- ``fit_spec(spec_for_path(...))`` under ``moe.sharding_rules()`` equals
  JAX's under ``moe.SHARDING_RULES`` for every leaf of the tiny and 8x7b
  trees on ep=2, tp=2 x ep=2 and fsdp=2 x tp=2 x ep=2; the blocks of all
  ranks tile every leaf, and the sharded init's blocks make up the
  one-process init.
- The routing of a data shard's rows equals JAX's routing of the whole
  batch on those rows, at atol 0.
- Gloo processes (``tests/_torch_parallel_rank.py moe``) on the tiny
  config in fp32: two on the meshes ep=2, tp=2 and fsdp=2, four on tp=2 x
  ep=2 (where the experts' and the gates' gradients are partial over
  both axes), under remat "none" and "dots".  The loss and every
  gradient, gathered from the ranks' blocks, equal the one-process
  port's within rtol = atol = ``SELF_TOL`` and JAX's ``moe.loss_fn`` with
  ``mesh=`` within ``F32_TOL``; three AdamW steps' losses equal one
  process's within ``SELF_TOL``.  tok_embed's gradient entries and the
  parameters after AdamW are held to ``LOOSE`` times those limits, for
  the reasons ``tests/test_torch_parallel.py`` gives.
- JAX's ``moe_pretrain`` hands a process rows that its device's data
  shard does not hold once ep or tp is above 1 (a reference fault); the
  port's ``data_rows`` hands it the rows its shard holds.
"""

import dataclasses
import os
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

from test_torch_parallel import (  # noqa: E402
    LOOSE,
    _assert_close,
    _free_port,
    _gathered,
    _Rank,
)
from trainingjob_operator_tpu.models import moe as jmoe  # noqa: E402
from trainingjob_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from trainingjob_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from trainingjob_operator_tpu_torch.models import moe as tmoe  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import (  # noqa: E402
    llama_elastic as telastic,
)
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 loss and gradients against JAX (rtol = atol), as
#: tests/test_torch_moe.py holds the one-process port.
F32_TOL = 1e-4
#: The port across processes against the port on one: the same math with
#: partial sums added over ranks in another order.
SELF_TOL = 1e-5

ROOT = Path(__file__).resolve().parent.parent
RANK = ROOT / "tests" / "_torch_parallel_rank.py"
#: As in the worker: world size -> mesh -> (tp, ep).
CASES = {2: {"ep": (1, 2), "tp": (2, 1), "fsdp": (1, 1)},
         4: {"tp_ep": (2, 2)}}
KINDS = [(world, kind) for world in sorted(CASES) for kind in CASES[world]]
REMATS = ("none", "dots")
#: The trainer's MOE_LR default.
ADAMW_LR = 3e-4
B, T = 4, 16

torch.set_num_threads(2)


MESHES = {"ep2": {"ep": 2}, "tp2_ep2": {"tp": 2, "ep": 2},
          "fsdp2_tp2_ep2": {"fsdp": 2, "tp": 2, "ep": 2}}
CONFIGS = {"tiny": jmoe.MoEConfig.tiny, "8x7b": jmoe.MoEConfig.mixtral_8x7b}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fit_spec_matches_jax_on_every_leaf(config, mesh_name):
    sizes = MESHES[mesh_name]
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(**sizes),
                         devices=jax.devices()[:n])
    tm = tmesh.MeshSpec.of(**sizes)
    jc = CONFIGS[config]()
    shapes = jax.eval_shape(lambda: jmoe.init_params(
        jc, jax.random.PRNGKey(0)))
    trules = tmoe.sharding_rules()
    assert trules == [(p, tuple(s)) for p, s in jmoe.SHARDING_RULES]
    got_shapes = dict(tsharding.tree_paths(tmoe.param_shapes(
        tmoe.MoEConfig(**jc.__dict__))))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) == len(got_shapes) == 13
    split = set()
    for key_path, leaf in leaves:
        path = jsharding.path_of(key_path)
        assert got_shapes[path] == tuple(leaf.shape), path
        want = jsharding.fit_spec(
            jsharding.spec_for_path(path, jmoe.SHARDING_RULES), leaf.shape,
            jm)
        got = tsharding.fit_spec(tsharding.spec_for_path(path, trules),
                                 leaf.shape, tm)
        assert got == tuple(want), (path, got, want)
        split |= {a for entry in got for a in tsharding.axes_of(entry)}
    assert "ep" in split


class TestBlocks:
    @pytest.mark.parametrize("sizes", sorted(MESHES.values(), key=str))
    def test_the_blocks_of_all_ranks_tile_every_leaf(self, sizes):
        cfg = tmoe.MoEConfig.tiny()
        spec = tmesh.MeshSpec.of(**sizes)
        ranks = [_Rank(spec, i) for i in range(spec.size())]
        for path, shape in tsharding.tree_paths(tmoe.param_shapes(cfg)):
            count = np.zeros(shape, np.int64)
            for rank in ranks:
                block = tsharding.block_of(
                    tsharding.leaf_spec(path, shape, tmoe.sharding_rules(),
                                        rank), shape, rank)
                count[tsharding.block_slices(block)] += 1
            # Each element is held by every rank whose axes the leaf is
            # replicated over, and by no other.
            assert count.min() == count.max() > 0, path
            assert count.sum() == count.size * count.max(), path

    @pytest.mark.parametrize("sizes", [{"ep": 2}, {"fsdp": 2, "tp": 2,
                                                   "ep": 2}])
    def test_the_sharded_init_makes_up_the_one_process_init(self, sizes):
        cfg = tmoe.MoEConfig.tiny()
        whole = tmoe.init_params(cfg, torch.Generator().manual_seed(5),
                                 "cpu", master=True)
        spec = tmesh.MeshSpec.of(**sizes)
        for i in range(spec.size()):
            rank = _Rank(spec, i)
            mine = tmoe.init_params(cfg, torch.Generator().manual_seed(5),
                                    "cpu", master=True, mesh=rank)
            want = tsharding.shard_tree(whole, tmoe.sharding_rules(), rank)
            for (path, got), (_, w) in zip(tsharding.tree_paths(mine),
                                           tsharding.tree_paths(want)):
                assert torch.equal(got, w), (i, path)

    def test_an_ep_that_does_not_divide_the_experts_keeps_them_whole(self):
        # fit_spec drops ep, as JAX's: every rank holds every expert and
        # nothing is summed over ep.
        cfg = dataclasses.replace(tmoe.MoEConfig.tiny(), n_experts=3)
        rank = _Rank(tmesh.MeshSpec.of(fsdp=1, tp=2, ep=2), 3)
        specs = tmoe.mesh_specs(cfg, rank)
        assert specs["w_gate"] == (None, "fsdp", "tp")
        assert tmoe._expert_range(cfg, rank, specs) == (0, 3)
        assert tmoe._model_axes(specs) == ("tp",)
        even = tmoe.mesh_specs(tmoe.MoEConfig.tiny(), rank)
        assert tmoe._expert_range(tmoe.MoEConfig.tiny(), rank,
                                  even) == (2, 4)
        assert tmoe._model_axes(even) == ("tp", "ep")

    def test_a_tp_that_does_not_divide_is_refused(self):
        cfg = tmoe.MoEConfig.tiny()
        tmoe.check_tp(cfg, 2)
        with pytest.raises(ValueError, match="tp=3 does not divide "
                                             "n_heads=4"):
            tmoe.check_tp(cfg, 3)
        with pytest.raises(ValueError, match="tp=4 does not divide "
                                             "n_kv_heads=2"):
            tmoe.check_tp(cfg, 4)
        odd = dataclasses.replace(cfg, ffn_dim=127)
        with pytest.raises(ValueError, match="tp=2 does not divide "
                                             "ffn_dim=127"):
            tmoe.init_params(odd, torch.Generator().manual_seed(0), "cpu",
                             mesh=_Rank(tmesh.MeshSpec.of(tp=2), 0))


@pytest.mark.parametrize("sizes", [{"fsdp": 2, "ep": 2},
                                   {"dp": 2, "fsdp": 2, "tp": 2}])
def test_routing_on_a_data_shard_equals_jax(sizes):
    # Routing is per row: a data shard's rows route as they do in the
    # whole batch, exactly, and every ep/tp rank of a shard routes the
    # same rows.
    cfg = tmoe.MoEConfig.tiny()
    logits = np.random.default_rng(11).standard_normal((8, 16, 4)) * 2
    probs = np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    C = tmoe.expert_capacity(cfg, 16)
    dj, cj = jmoe._dispatch_combine(jnp.asarray(probs), 2, C)
    spec = tmesh.MeshSpec.of(**sizes)
    seen = {}
    for i in range(spec.size()):
        rank = _Rank(spec, i)
        row0, n = tsharding.data_rows(8, rank)
        dt, ct = tmoe._dispatch_combine(
            torch.from_numpy(probs[row0:row0 + n]), 2, C)
        np.testing.assert_array_equal(dt.numpy(),
                                      np.asarray(dj)[row0:row0 + n])
        np.testing.assert_array_equal(ct.numpy(),
                                      np.asarray(cj)[row0:row0 + n])
        seen.setdefault(rank.data_index(), set()).add(row0)
    assert all(len(rows) == 1 for rows in seen.values())


def test_jax_moe_pretrain_hands_a_process_rows_its_shard_does_not_hold():
    # moe_pretrain.py:87-92: local_batch = global_batch // process_count,
    # row0 = process_id * local_batch.  At one device a process on an
    # ep=2 mesh the batch spec P(("dp", "fsdp")) gives each device all the
    # rows (one data shard), while that rule hands process 1 rows 4..7 of
    # 8 only.  The port takes its rows from the data shard (data_rows).
    global_batch, n = 8, 2
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(fsdp=1, ep=2),
                         devices=jax.devices()[:n])
    held = NamedSharding(jm, jsharding.batch_spec(jm)).devices_indices_map(
        (global_batch, 17))
    local_batch = global_batch // n
    for pid, device in enumerate(jm.devices.flat):
        rows = held[device][0]
        shard = set(range(global_batch)[rows])
        jax_rows = set(range(pid * local_batch, (pid + 1) * local_batch))
        assert shard == set(range(global_batch))
        assert jax_rows != shard
        rank = _Rank(tmesh.MeshSpec.of(fsdp=1, ep=2), pid)
        row0, local = tsharding.data_rows(global_batch, rank)
        assert set(range(row0, row0 + local)) == shard


def _configs():
    jc = dataclasses.replace(jmoe.MoEConfig.tiny(), dtype="float32")
    return jc, tmoe.MoEConfig(**jc.__dict__)


def _flat_numpy(tree):
    return {jsharding.path_of(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def inputs():
    jc, _ = _configs()
    tree = jax.tree_util.tree_map(
        np.asarray, jmoe.init_params(jc, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    batches = {"tokens": rng.integers(0, 256, (B, T + 1)).astype(np.int32)}
    for i in range(3):
        batches[f"step{i}"] = rng.integers(0, 256, (B, T + 1)).astype(
            np.int32)
    return tree, batches


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """world -> the ranks' outputs of ``_torch_parallel_rank.py moe``: the
    two-process and the four-process job run together."""
    tree, batches = inputs
    work = tmp_path_factory.mktemp("moe_parallel")
    src = work / "inputs.npz"
    np.savez(src, **{f"p/{k}": v for k, v in _flat_numpy(tree).items()},
             **batches)
    procs = {}
    try:
        for world in CASES:
            env = {**os.environ, "OMP_NUM_THREADS": "1",
                   "PYTHONPATH": str(ROOT),
                   "TRAININGJOB_COORDINATOR_ADDRESS":
                       f"127.0.0.1:{_free_port()}",
                   "TRAININGJOB_NUM_PROCESSES": str(world)}
            procs[world] = [subprocess.Popen(
                [sys.executable, str(RANK), str(src),
                 str(work / f"w{world}-rank{rank}.npz"), "moe"],
                env={**env, "TRAININGJOB_PROCESS_ID": str(rank)}, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for rank in range(world)]
        outs = {w: [p.communicate(timeout=80)[0] for p in ps]
                for w, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for world, ps in procs.items():
        assert all(p.returncode == 0 for p in ps), outs[world]
    return {world: [dict(np.load(work / f"w{world}-rank{r}.npz"))
                    for r in range(world)] for world in CASES}


def _one_process(tree, batches, remat):
    """The port on one process: loss and gradients, and three AdamW steps
    of ``make_step_fn`` (accumulation 1, the MoE trainer's)."""
    _, tc = _configs()
    params = ttrain.trainable_copy(
        tmoe.params_from_numpy(tree, tc, "cpu", master=True), "cpu")
    loss = tmoe.loss_fn(params, {"tokens": torch.from_numpy(
        batches["tokens"]).long()}, tc, remat=remat)
    loss.backward()
    grads = {p: x.grad.numpy() for p, x in tsharding.tree_paths(params)}
    params = ttrain.trainable_copy(
        tmoe.params_from_numpy(tree, tc, "cpu", master=True), "cpu")
    step_fn = telastic.make_step_fn(params, tc, accum=1, lr=ADAMW_LR,
                                    remat=remat, loss_fn=tmoe.loss_fn)
    losses = [float(step_fn(torch.from_numpy(batches[f"step{i}"]).long()))
              for i in range(3)]
    return (float(loss.detach()), grads, losses,
            {p: x.detach().numpy() for p, x in tsharding.tree_paths(params)})


@pytest.fixture(scope="module")
def one_process(inputs):
    tree, batches = inputs
    return {remat: _one_process(tree, batches, remat) for remat in REMATS}


def _jax_loss_and_grads(tree, tokens, world, kind, remat):
    jc, _ = _configs()
    tp, ep = CASES[world][kind]
    mesh = jmesh.make_mesh(jmesh.MeshSpec.of(fsdp=world // tp // ep, tp=tp,
                                             ep=ep),
                           devices=jax.devices()[:world])
    params = jsharding.shard_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree), jmoe.SHARDING_RULES,
        mesh)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jmoe.loss_fn(p, {"tokens": t}, jc, mesh=mesh,
                                  remat=remat)))(params, jnp.asarray(tokens))
    return float(loss), _flat_numpy(grads)


def _shapes():
    _, tc = _configs()
    return dict(tsharding.tree_paths(tmoe.param_shapes(tc)))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("world,kind", KINDS)
def test_ranks_equal_one_process(ranks, one_process, world, kind, remat):
    loss, grads, _, _ = one_process[remat]
    for res in ranks[world]:
        np.testing.assert_allclose(float(res[f"{kind}/{remat}/loss"]), loss,
                                   rtol=SELF_TOL, atol=SELF_TOL)
    got = _gathered(ranks[world], kind, f"{kind}/{remat}/grad", _shapes())
    assert set(got) == set(grads)
    for path, want in grads.items():
        _assert_close(got[path], want, SELF_TOL, path,
                      LOOSE * SELF_TOL if path == "tok_embed" else None)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("world,kind", KINDS)
def test_ranks_equal_jax_on_its_mesh(inputs, ranks, world, kind, remat):
    tree, batches = inputs
    lj, gj = _jax_loss_and_grads(tree, batches["tokens"], world, kind,
                                 remat)
    for res in ranks[world]:
        np.testing.assert_allclose(float(res[f"{kind}/{remat}/loss"]), lj,
                                   rtol=F32_TOL)
    got = _gathered(ranks[world], kind, f"{kind}/{remat}/grad", _shapes())
    assert set(got) == set(gj)
    for path, want in gj.items():
        _assert_close(got[path], want, F32_TOL, path,
                      LOOSE * F32_TOL if path == "tok_embed" else None)


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("world,kind", KINDS)
def test_three_adamw_steps_equal_one_process(ranks, one_process, world,
                                             kind, remat):
    _, _, losses, params = one_process[remat]
    for res in ranks[world]:
        np.testing.assert_allclose(res[f"{kind}/{remat}/adamw/losses"],
                                   losses, rtol=SELF_TOL, atol=SELF_TOL)
    got = _gathered(ranks[world], kind, f"{kind}/{remat}/adamw/param",
                    _shapes())
    for path, want in params.items():
        _assert_close(got[path], want, LOOSE * SELF_TOL, path)
