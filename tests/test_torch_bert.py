"""The port's BERT (``models/bert.py``, ``workloads/bert_pretrain.py``,
config 4) against the JAX package's on the CPU.

- The rules are JAX's ``SHARDING_RULES``, and ``fit_spec`` of every leaf
  equals JAX's on tp = 2, tp = 4 (which does not divide the vocab) and
  fsdp = 2 x tp = 2; the shapes are JAX's tree's.
- ``forward``, ``mlm_logits``, ``loss_fn`` and its gradients equal JAX's
  on tiny in fp32 within ``F32_TOL``, and in bf16 within ``BF16_LOSS_RTOL``
  (loss), ``BF16_LOGITS_REL_L2`` and ``BF16_GRAD_REL_L2`` (the logits' and
  each gradient's relative L2 error); the ``attention_mask=`` path
  equals JAX's, and a masked key changes nothing.
- The parity traps, each against JAX: ``jax.nn.gelu`` is the tanh form
  (the exact form differs), ``_layernorm`` uses the biased variance.
- One ``bert_pretrain.make_step`` equals ``optax.adamw(lr,
  weight_decay=0.01)``.
- Two gloo processes (``tests/_torch_workload_rank.py bert``) at tp = 2
  and at fsdp = 2: the loss and the gradients gathered from the ranks'
  blocks equal one process within ``SELF_TOL`` and JAX's loss on its
  tp = 2 mesh within ``F32_TOL_MESH``; three AdamW steps equal one
  process's.
- JAX's ``bert_pretrain`` hands a process rows its data shard does not
  hold at ``BERT_TP=2`` (a reference fault); the port's ``data_rows``
  hands it the shard's rows.
- The main resumes from its checkpoint (``resumed at step 2``), and a
  killed run's restart ends on the parameters of an uninterrupted one.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import apply_jax_platform_override

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from test_torch_mnist import run_ranks  # noqa: E402
from test_torch_parallel import _Rank  # noqa: E402
from trainingjob_operator_tpu.models import bert as jbert  # noqa: E402
from trainingjob_operator_tpu.parallel import mesh as jmesh  # noqa: E402
from trainingjob_operator_tpu.parallel import sharding as jsharding  # noqa: E402
from trainingjob_operator_tpu_torch.models import bert as tbert  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import bert_pretrain  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import train as ttrain  # noqa: E402

#: fp32 against JAX (rtol = atol).
F32_TOL = 1e-5
#: The ranks against JAX's mesh: GSPMD's partial sums in another order.
F32_TOL_MESH = 1e-4
#: The ranks against one process of the port.
SELF_TOL = 1e-5
#: bf16: the loss relative to JAX; the logits' L2 error relative to
#: their norm (they leave a bf16 product: each carries its own rounding
#: of up to 2^-8 = 3.9e-3, and those of the two layers before); each
#: gradient's L2 error relative to its norm.
BF16_LOSS_RTOL = 2e-3
BF16_LOGITS_REL_L2 = 1e-2
BF16_GRAD_REL_L2 = 3e-2
LR = 1e-4
B, T = 4, 16

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)


def _configs(dtype="float32"):
    jc = dataclasses.replace(jbert.BertConfig.tiny(), dtype=dtype)
    return jc, tbert.BertConfig(**jc.__dict__)


def _flat(tree):
    return {jsharding.path_of(kp): np.asarray(x, np.float32)
            for kp, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def inputs():
    """JAX's init, every leaf moved off its constant start (so the biases
    and norms take part), and MLM batches drawn with numpy."""
    jc, _ = _configs()
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32),
        jbert.init_params(jc, jax.random.PRNGKey(0)))

    def batch(seed):
        r = np.random.default_rng(seed)
        targets = r.integers(1, jc.vocab_size, (B, T)).astype(np.int32)
        mask = (r.random((B, T)) < 0.3).astype(np.int32)
        return {"tokens": np.where(mask == 1, 0, targets).astype(np.int32),
                "targets": targets, "mask": mask}

    return tree, batch(1), [batch(10 + i) for i in range(3)]


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


MESHES = {"tp2": {"tp": 2}, "tp4": {"tp": 4},
          "fsdp2_tp2": {"fsdp": 2, "tp": 2}}


def test_rules_and_shapes_are_jaxs():
    assert tbert.sharding_rules() == [(p, tuple(s))
                                      for p, s in jbert.SHARDING_RULES]
    for name in ("tiny", "base"):
        jc = getattr(jbert.BertConfig, name)()
        tc = tbert.BertConfig(**jc.__dict__)
        want = {jsharding.path_of(kp): tuple(x.shape) for kp, x in
                jax.tree_util.tree_flatten_with_path(jax.eval_shape(
                    lambda: jbert.init_params(jc, jax.random.PRNGKey(0))))[0]}
        got = dict(tsharding.tree_paths(tbert.param_shapes(tc)))
        assert got == want
        assert tbert.num_params(tc) == sum(int(np.prod(s))
                                           for s in got.values())
    assert tbert.BertConfig.base() == tbert.BertConfig(
        **jbert.BertConfig.base().__dict__)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("config", ["tiny", "base"])
def test_fit_spec_matches_jax_on_every_leaf(config, mesh_name):
    sizes = MESHES[mesh_name]
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(**sizes),
                         devices=jax.devices()[:n])
    tm = tmesh.MeshSpec.of(**sizes)
    jc = getattr(jbert.BertConfig, config)()
    shapes = tbert.param_shapes(tbert.BertConfig(**jc.__dict__))
    for path, shape in tsharding.tree_paths(shapes):
        want = jsharding.fit_spec(
            jsharding.spec_for_path(path, jbert.SHARDING_RULES), shape, jm)
        got = tsharding.fit_spec(
            tsharding.spec_for_path(path, tbert.sharding_rules()), shape, tm)
        assert got == tuple(want), (path, got, want)
    if config == "base" and mesh_name == "tp4":
        # 30522 % 4 != 0: the embedding is not split on tp, as in JAX.
        assert tsharding.fit_spec(("tp", "fsdp"), (30522, 768), tm) == \
            (None, None)


def test_the_sharded_init_makes_up_the_one_process_init():
    cfg = tbert.BertConfig.tiny()
    whole = tbert.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    spec = tmesh.MeshSpec.of(fsdp=2, tp=2)
    for index in range(spec.size()):
        rank = _Rank(spec, index)
        part = tbert.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", mesh=rank)
        for path, x in tsharding.tree_paths(whole):
            shape = tuple(x.shape)
            block = tsharding.block_of(tsharding.leaf_spec(
                path, shape, tbert.sharding_rules(), rank), shape, rank)
            got = dict(tsharding.tree_paths(part))[path]
            assert torch.equal(got, x[tsharding.block_slices(block)]), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_loss_and_grads_equal_jax(inputs, dtype):
    tree, batch, _ = inputs
    jc, tc = _configs(dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jh = jbert.forward(jp, jnp.asarray(batch["tokens"]), jc)
    jlogits = jbert.mlm_logits(jp, jh, jc)
    jl, jg = jax.value_and_grad(jbert.loss_fn)(jp, _jax_batch(batch), jc)

    params = ttrain.trainable_copy(tbert.params_from_numpy(tree, "cpu"),
                                   "cpu")
    tb = _torch_batch(batch)
    with torch.no_grad():
        th = tbert.forward(params, tb["tokens"], tc)
        tlogits = tbert.mlm_logits(params, th, tc)
    assert th.dtype == tc.compute_dtype and tlogits.dtype == torch.float32
    loss = tbert.loss_fn(params, tb, tc)
    loss.backward()
    got = {p: x.grad.numpy() for p, x in tsharding.tree_paths(params)}
    want = _flat(jg)
    assert set(got) == set(want)
    if dtype == "float32":
        for a, b in ((th.numpy(), jh), (tlogits.numpy(), jlogits),
                     (float(loss.detach()), float(jl))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=F32_TOL,
                                       atol=F32_TOL)
        for path, g in want.items():
            np.testing.assert_allclose(got[path], g, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=path)
        return
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=BF16_LOSS_RTOL)
    rel = np.linalg.norm(tlogits.numpy() - np.asarray(jlogits)) / \
        np.linalg.norm(np.asarray(jlogits))
    assert rel < BF16_LOGITS_REL_L2
    for path, g in want.items():
        if path == "layers/attn/bk":
            # Zero in exact arithmetic (a key bias shifts every score of a
            # query alike, which the softmax cancels): rounding noise on
            # both sides, far below the other gradients.
            assert max(np.abs(got[path]).max(), np.abs(g).max()) < 1e-4
            continue
        err = np.linalg.norm(got[path] - g) / max(np.linalg.norm(g), 1e-30)
        assert err < BF16_GRAD_REL_L2, (path, err)


def test_attention_mask_path_equals_jax(inputs):
    tree, batch, _ = inputs
    jc, tc = _configs()
    tokens = batch["tokens"]
    mask = np.ones((B, T), bool)
    mask[:, -5:] = False
    mask[1, 3] = False
    corrupted = tokens.copy()
    corrupted[:, -5:] = 7
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    want = jbert.forward(jp, jnp.asarray(tokens), jc,
                         attention_mask=jnp.asarray(mask))
    params = tbert.params_from_numpy(tree, "cpu")
    got = tbert.forward(params, torch.from_numpy(tokens).long(), tc,
                        attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    # tests/test_models.py:192-201: a masked key's token changes nothing
    # at the other positions.
    other = tbert.forward(params, torch.from_numpy(corrupted).long(), tc,
                          attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(other[:, :-5].numpy(), got[:, :-5].numpy(),
                               rtol=F32_TOL, atol=F32_TOL)


def test_gelu_is_the_tanh_form_and_layernorm_the_biased_variance():
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tanh = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    exact = F.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tanh, want, rtol=1e-6, atol=1e-6)
    assert np.abs(exact - want).max() > 1e-4
    rng = np.random.default_rng(3)
    h = rng.standard_normal((3, 8)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    want = np.asarray(jbert._layernorm(jnp.asarray(h), jnp.asarray(scale),
                                       jnp.asarray(bias), 1e-12))
    got = tbert._layernorm(torch.from_numpy(h), torch.from_numpy(scale),
                           torch.from_numpy(bias), 1e-12).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xt = torch.from_numpy(h)
    wrong = ((xt - xt.mean(-1, keepdim=True))
             / torch.sqrt(xt.var(-1, keepdim=True) + 1e-12)).numpy()
    assert np.abs(wrong * scale + bias - want).max() > 1e-3


def test_one_adamw_step_equals_optax(inputs):
    tree, batch, _ = inputs
    jc, tc = _configs()
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = optax.adamw(LR, weight_decay=0.01)
    _, jg = jax.value_and_grad(jbert.loss_fn)(jp, _jax_batch(batch), jc)
    updates, jstate = tx.update(jg, tx.init(jp), jp)
    want = _flat(optax.apply_updates(jp, updates))
    params = ttrain.trainable_copy(tbert.params_from_numpy(tree, "cpu"),
                                   "cpu")
    step = bert_pretrain.make_step(params, tc, lr=LR)
    step(_torch_batch(batch))
    for path, x in tsharding.tree_paths(params):
        np.testing.assert_allclose(x.detach().numpy(), want[path],
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=path)
    mu = _flat(ttrain.adamw_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), "cpu")["mu"])
    got_mu = {p: x.numpy() for p, x in tsharding.tree_paths(
        step.opt.state["mu"])}
    for path in mu:
        np.testing.assert_allclose(got_mu[path], mu[path], rtol=F32_TOL,
                                   atol=F32_TOL)
    assert step.opt.state["count"] == 1


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    tree, batch, steps = inputs
    flat = {f"p/{p}": x for p, x in _flat(tree).items()}
    for i, b in enumerate(steps):
        flat.update({f"step{i}/{k}": v for k, v in b.items()})
    return run_ranks({**flat, **batch}, "bert", 2,
                     tmp_path_factory.mktemp("bert_ranks"))


@pytest.fixture(scope="module")
def one_process(inputs):
    tree, batch, steps = inputs
    _, tc = _configs()
    params = ttrain.trainable_copy(tbert.params_from_numpy(tree, "cpu"),
                                   "cpu")
    loss = tbert.loss_fn(params, _torch_batch(batch), tc)
    loss.backward()
    grads = {p: x.grad.numpy() for p, x in tsharding.tree_paths(params)}
    params = ttrain.trainable_copy(tbert.params_from_numpy(tree, "cpu"),
                                   "cpu")
    step = bert_pretrain.make_step(params, tc, lr=LR)
    losses = [float(step(_torch_batch(b))) for b in steps]
    return (float(loss.detach()), grads, losses,
            {p: x.detach().numpy() for p, x in tsharding.tree_paths(params)})


def _gathered(ranks, kind, prefix):
    """Each leaf whole from the ranks' blocks; where two ranks hold an
    element, they agree within SELF_TOL."""
    _, tc = _configs()
    out = {}
    for path, shape in tsharding.tree_paths(tbert.param_shapes(tc)):
        full = np.full(shape, np.nan, np.float32)
        for res in ranks:
            cut = tuple(slice(a, b) for a, b in res[f"{kind}/block/{path}"])
            held = full[cut]
            seen = ~np.isnan(held)
            block = res[f"{prefix}/{path}"]
            np.testing.assert_allclose(block[seen], held[seen],
                                       rtol=SELF_TOL, atol=SELF_TOL)
            full[cut] = block
        assert not np.isnan(full).any(), path
        out[path] = full
    return out


@pytest.mark.parametrize("kind", ["tp", "fsdp"])
def test_ranks_equal_one_process(ranks, one_process, kind):
    loss, grads, losses, params = one_process
    for res in ranks:
        np.testing.assert_allclose(float(res[f"{kind}/loss"]), loss,
                                   rtol=SELF_TOL, atol=SELF_TOL)
        np.testing.assert_allclose(res[f"{kind}/adamw/losses"], losses,
                                   rtol=SELF_TOL, atol=SELF_TOL)
    got = _gathered(ranks, kind, f"{kind}/grad")
    for path, want in grads.items():
        np.testing.assert_allclose(got[path], want, rtol=SELF_TOL,
                                   atol=SELF_TOL, err_msg=path)
    got = _gathered(ranks, kind, f"{kind}/adamw/param")
    for path, want in params.items():
        np.testing.assert_allclose(got[path], want, rtol=SELF_TOL,
                                   atol=SELF_TOL, err_msg=path)
    if kind == "tp":
        # The tp ranks hold different columns of q, k, v and w_in.
        assert not np.array_equal(ranks[0]["tp/block/layers/attn/wq"],
                                  ranks[1]["tp/block/layers/attn/wq"])


def test_tp2_ranks_equal_jax_on_its_mesh(inputs, ranks):
    tree, batch, _ = inputs
    jc, _ = _configs()
    mesh = jmesh.make_mesh(jmesh.MeshSpec.of(fsdp=1, tp=2),
                           devices=jax.devices()[:2])
    params = jsharding.shard_pytree(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jbert.SHARDING_RULES, mesh)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jbert.loss_fn(p, b, jc)))(params, _jax_batch(batch))
    for res in ranks:
        np.testing.assert_allclose(float(res["tp/loss"]), float(jl),
                                   rtol=F32_TOL_MESH, atol=F32_TOL_MESH)
    got = _gathered(ranks, "tp", "tp/grad")
    for path, want in _flat(jg).items():
        np.testing.assert_allclose(got[path], want, rtol=F32_TOL_MESH,
                                   atol=F32_TOL_MESH, err_msg=path)


def test_jax_bert_pretrain_hands_a_process_rows_its_shard_does_not_hold():
    # bert_pretrain.py:85-91: local_batch = global_batch // process_count
    # rows, drawn from a key of process_id.  At BERT_TP=2 on two processes
    # of one device each the mesh is fsdp=1 x tp=2, and the batch spec
    # P(("dp", "fsdp")) gives both devices all the rows (one data shard),
    # while that rule hands each process half as many rows of its own
    # draw.  The port takes the shard's rows (data_rows): both processes
    # the same rows, all of them.
    global_batch, n = 8, 2
    jm = jmesh.make_mesh(jmesh.MeshSpec.of(fsdp=1, tp=2),
                         devices=jax.devices()[:n])
    held = NamedSharding(jm, jsharding.batch_spec(jm)).devices_indices_map(
        (global_batch, 32))
    local_batch = global_batch // n
    for pid, device in enumerate(jm.devices.flat):
        shard = set(range(global_batch)[held[device][0]])
        assert shard == set(range(global_batch))
        assert local_batch < len(shard)
        rank = _Rank(tmesh.MeshSpec.of(fsdp=1, tp=2), pid)
        row0, local = tsharding.data_rows(global_batch, rank)
        assert set(range(row0, row0 + local)) == shard


def _start(env, ckpt):
    # One thread: a CPU BLAS splits a product over the threads it finds
    # free, in another order of sums under load, and a resume is held to
    # bit identity.
    return subprocess.Popen(
        [sys.executable, "-m",
         "trainingjob_operator_tpu_torch.workloads.bert_pretrain",
         "--device", "cpu"],
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT),
             "BERT_BATCH": "8", "BERT_SEQ": "32",
             "TRAININGJOB_CHECKPOINT_DIR": str(ckpt), **env},
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    """(returncode, stdout, stderr) of a process ``_start`` began."""
    try:
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def _main(env, ckpt):
    return _finish(_start(env, ckpt))


def test_resume_restores_params(tmp_path):
    first = _main({"BERT_STEPS": "2"}, tmp_path)
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stdout
    again = _main({"BERT_STEPS": "4"}, tmp_path)
    assert again.returncode == 0, again.stderr
    assert "resumed at step 2" in again.stdout
    assert "step 4/4 loss" in again.stdout and "done: steps=1 " in \
        again.stdout


def test_killed_at_step_10_resumes_bit_for_bit(tmp_path):
    env = {"BERT_STEPS": "12"}
    # The uninterrupted run beside the one that is killed.
    whole = _start(env, tmp_path / "whole")
    killed = _main({**env, "TRAININGJOB_KILL_AT_STEP": "10"},
                   tmp_path / "kill")
    whole = _finish(whole)
    assert whole.returncode == 0 and killed.returncode == -9
    again = _main({**env, "TRAININGJOB_REPLICA_RESTARTCOUNT": "1"},
                  tmp_path / "kill")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 10" in again.stdout

    def last(out):
        return [line for line in out.splitlines() if line.startswith("step")]

    assert last(again.stdout) == last(whole.stdout)[-1:]
    want = torch.load(tmp_path / "whole" / "bert" / "12" / "params.pt",
                      weights_only=True)
    got = torch.load(tmp_path / "kill" / "bert" / "12" / "params.pt",
                     weights_only=True)
    for a, b in zip(ttrain.tree_leaves(got), ttrain.tree_leaves(want)):
        assert torch.equal(a, b)


def test_a_sequence_past_max_seq_len_is_refused_as_jax_fails(inputs):
    # The trainer's defaults (BERT_CONFIG=tiny, BERT_SEQ=128) exceed the
    # tiny config's 64 positions: JAX's forward fails broadcasting the
    # cut pos_embed, the port refuses with the reason.
    tree, _, _ = inputs
    jc, tc = _configs()
    tokens = np.zeros((1, jc.max_seq_len + 1), np.int32)
    with pytest.raises((TypeError, ValueError)):
        jbert.forward(jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(tokens), jc)
    with pytest.raises(ValueError, match="exceeds max_seq_len=64"):
        tbert.forward(tbert.params_from_numpy(tree, "cpu"),
                      torch.from_numpy(tokens).long(), tc)


def test_an_empty_mask_gives_a_zero_loss_as_jax(inputs):
    # bert.py:162-173: the masked mean over max(mask.sum(), 1).
    tree, batch, _ = inputs
    jc, tc = _configs()
    empty = {**batch, "mask": np.zeros_like(batch["mask"])}
    want = jbert.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                         _jax_batch(empty), jc)
    got = tbert.loss_fn(tbert.params_from_numpy(tree, "cpu"),
                        _torch_batch(empty), tc)
    assert float(got) == float(want) == 0.0


def test_tp_that_divides_neither_heads_nor_vocab_follows_fit_spec(
        tmp_path):
    # 3 heads and a vocab of 511 at tp = 2: fit_spec still splits wq, wk,
    # wv and wo (dim 48 is even), as JAX does; the port gathers them and
    # runs attention whole, keeps the MLP's tp blocks, and equals one
    # process.  Nothing is refused.
    from _torch_workload_rank import ODD_BERT

    jc = jbert.BertConfig(**ODD_BERT.__dict__)
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32),
        jbert.init_params(jc, jax.random.PRNGKey(1)))

    def batch(seed):
        r = np.random.default_rng(seed)
        targets = r.integers(1, jc.vocab_size, (B, T)).astype(np.int32)
        mask = (r.random((B, T)) < 0.3).astype(np.int32)
        return {"tokens": np.where(mask == 1, 0, targets).astype(np.int32),
                "targets": targets, "mask": mask}

    flat = {f"p/{p}": x for p, x in _flat(tree).items()}
    for i in range(3):
        flat.update({f"step{i}/{k}": v for k, v in batch(20 + i).items()})
    one = batch(19)
    ranks = run_ranks({**flat, **one}, "bert_odd", 2, tmp_path)
    spec = tmesh.MeshSpec.of(fsdp=1, tp=2)
    assert tsharding.fit_spec((None, "fsdp", "tp"), (2, 48, 48),
                              spec)[-1] == "tp"
    assert tsharding.fit_spec(("tp", "fsdp"), (511, 48), spec)[0] is None

    params = ttrain.trainable_copy(tbert.params_from_numpy(tree, "cpu"),
                                   "cpu")
    loss = tbert.loss_fn(params, _torch_batch(one), ODD_BERT)
    loss.backward()
    for res in ranks:
        np.testing.assert_allclose(float(res["tp/loss"]),
                                   float(loss.detach()), rtol=SELF_TOL,
                                   atol=SELF_TOL)
    shapes = dict(tsharding.tree_paths(tbert.param_shapes(ODD_BERT)))
    for path, x in tsharding.tree_paths(params):
        full = np.full(shapes[path], np.nan, np.float32)
        for res in ranks:
            cut = tuple(slice(a, b) for a, b in res[f"tp/block/{path}"])
            full[cut] = res[f"tp/grad/{path}"]
        np.testing.assert_allclose(full, x.grad.numpy(), rtol=SELF_TOL,
                                   atol=SELF_TOL, err_msg=path)
    # wq is split on tp (each rank holds half its columns).
    assert not np.array_equal(ranks[0]["tp/block/layers/attn/wq"],
                              ranks[1]["tp/block/layers/attn/wq"])


def test_a_tp2_checkpoint_resumes_on_one_process(tmp_path):
    from test_torch_mnist import free_port

    env = {"BERT_STEPS": "2", "BERT_TP": "2", "OMP_NUM_THREADS": "1",
           "TRAININGJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "TRAININGJOB_NUM_PROCESSES": "2"}
    procs = [_start({**env, "TRAININGJOB_PROCESS_ID": str(r)}, tmp_path)
             for r in range(2)]
    outs = [_finish(p) for p in procs]
    assert all(o.returncode == 0 for o in outs), [o.stderr for o in outs]
    assert "'tp': 2" in outs[0].stdout
    assert sorted(os.listdir(tmp_path / "bert" / "2")) == ["shard-0.pt",
                                                           "shard-1.pt"]
    again = _main({"BERT_STEPS": "4"}, tmp_path)
    assert again.returncode == 0, again.stderr
    assert "resumed at step 2" in again.stdout
    assert "processes=1 " in again.stdout
