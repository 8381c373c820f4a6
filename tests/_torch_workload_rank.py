"""One rank of the gloo runs of tests/test_torch_mnist.py,
tests/test_torch_bert.py and tests/test_torch_resnet.py.

Run as ``python tests/_torch_workload_rank.py <inputs.npz> <out.npz>
mnist|bert|bert_odd|resnet`` with the rendezvous env
(``TRAININGJOB_COORDINATOR_ADDRESS``, ``TRAININGJOB_NUM_PROCESSES``,
``TRAININGJOB_PROCESS_ID``).  The inputs hold the parameters
(``p/<path>``, f32, in JAX's layout), for ResNet the batch-norm
statistics (``s/<path>``), and the global batches; each rank takes its
rows (``sharding.data_rows``).  Imports no JAX.

- ``mnist``: ``images`` [S, G, 784], ``labels`` [S, G]; S steps of
  ``mnist.make_step`` on the ``dp`` mesh of the ranks; writes the losses and the
  parameters after.
- ``bert`` (tiny, fp32): ``tokens``, ``targets``, ``mask`` [B, T] and
  three step batches ``step<i>/...``; for each mesh of ``BERT_CASES``
  writes the loss and this rank's gradient blocks of ``bert.loss_fn``,
  the blocks' index ranges, and the losses and parameter blocks after
  three ``bert_pretrain.make_step`` steps.
- ``bert_odd``: as ``bert`` at tp = 2 only, on ``ODD_BERT`` (3 heads,
  vocab 511: neither split on tp).
- ``resnet`` (tiny, fp32, dp over the ranks): ``images`` [B, 3, H, W]
  and ``labels``, and ``step<i>/...``; writes the loss, the gradients
  (whole: the parameters are replicated) and the new statistics of
  ``resnet.loss_fn``, and the losses, parameters and statistics after
  three ``resnet_dp.make_step`` steps.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from trainingjob_operator_tpu_torch.models import bert, resnet  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import collectives  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import (  # noqa: E402
    bert_pretrain,
    mnist,
    rendezvous,
    resnet_dp,
    train,
)

#: BERT's meshes on two ranks: name -> BERT_TP.
BERT_CASES = {"tp": 2, "fsdp": 1}
BERT_LR = 1e-4
#: A BERT whose heads and vocab tp = 2 does not divide (``_bert_odd``).
ODD_BERT = bert.BertConfig(vocab_size=511, dim=48, n_layers=2, n_heads=3,
                           ffn_dim=96, max_seq_len=64, dtype="float32")
RESNET_LR = 0.1
MNIST_LR = 1e-3


def _tree(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _sub(inputs, prefix):
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def _rows(batch, row0, n):
    return {k: torch.from_numpy(v[row0:row0 + n]) for k, v in batch.items()}


def _mnist(inputs, rdv, out):
    mesh = pmesh.make_mesh(pmesh.MeshSpec.of(dp=rdv.num_processes), "cpu")
    images, labels = inputs["images"], inputs["labels"]
    row0, n = sharding.data_rows(images.shape[1], mesh)
    rows = slice(row0, row0 + n)
    params = mnist.params_from_numpy(_sub(inputs, "p/"), "cpu")
    for p in params.values():
        p.requires_grad_(True)
    opt = train.AdamW(params, MNIST_LR, b2=0.999, weight_decay=0.0)
    step = mnist.make_step(params, opt, mesh)
    out["losses"] = np.array([float(step(torch.from_numpy(x[rows]),
                                         torch.from_numpy(y[rows])))
                              for x, y in zip(images, labels)])
    for k, v in params.items():
        out[f"param/{k}"] = v.detach().numpy()


def _bert(inputs, rdv, out, cfg=None, cases=None):
    cfg = cfg or dataclasses.replace(bert.BertConfig.tiny(),
                                     dtype="float32")
    full = _tree(_sub(inputs, "p/"))
    for name, tp in (cases or BERT_CASES).items():
        spec = pmesh.mesh_spec_from_rendezvous(rdv, model_parallel=tp)
        mesh = pmesh.make_mesh(spec, "cpu")
        row0, n = sharding.data_rows(inputs["tokens"].shape[0], mesh)
        whole = bert.params_from_numpy(full, "cpu")
        for path, shape in sharding.tree_paths(bert.param_shapes(cfg)):
            out[f"{name}/block/{path}"] = np.array(sharding.block_of(
                sharding.leaf_spec(path, shape, bert.sharding_rules(), mesh),
                shape, mesh)[1])
        params = train.trainable_copy(
            sharding.shard_tree(whole, bert.sharding_rules(), mesh), "cpu")
        batch = _rows({k: inputs[k] for k in ("tokens", "targets", "mask")},
                      row0, n)
        loss = bert.loss_fn(params, batch, cfg, mesh=mesh)
        loss.backward()
        out[f"{name}/loss"] = float(loss.detach())
        for path, x in sharding.tree_paths(params):
            out[f"{name}/grad/{path}"] = x.grad.numpy()
        params = train.trainable_copy(
            sharding.shard_tree(whole, bert.sharding_rules(), mesh), "cpu")
        step = bert_pretrain.make_step(params, cfg, lr=BERT_LR, mesh=mesh)
        out[f"{name}/adamw/losses"] = np.array([
            float(step(_rows(_sub(inputs, f"step{i}/"), row0, n)))
            for i in range(3)])
        for path, x in sharding.tree_paths(params):
            out[f"{name}/adamw/param/{path}"] = x.detach().numpy()


def _bert_odd(inputs, rdv, out):
    """BERT at tp = 2 on a config whose heads (3) tp does not divide,
    nor its vocab (511), while it divides dim and ffn: the fitted specs
    split q, k, v and wo on tp, the port gathers them whole and runs
    attention replicated, and keeps the MLP's tp blocks."""
    _bert(inputs, rdv, out, cfg=ODD_BERT, cases={"tp": 2})


def _resnet(inputs, rdv, out):
    cfg = dataclasses.replace(resnet.ResNetConfig.tiny(), dtype="float32")
    mesh = pmesh.make_mesh(pmesh.MeshSpec.of(dp=rdv.num_processes), "cpu")
    row0, n = sharding.data_rows(inputs["images"].shape[0], mesh)
    ptree, stree = _tree(_sub(inputs, "p/")), _tree(_sub(inputs, "s/"))

    params, stats = resnet.params_from_numpy(ptree, stree, "cpu")
    params = train.trainable_copy(params, "cpu")
    batch = _rows({k: inputs[k] for k in ("images", "labels")}, row0, n)
    loss, new_stats = resnet.loss_fn(params, stats, batch, cfg, mesh=mesh)
    loss.backward()
    out["loss"] = float(loss.detach())
    grads = train.tree_map(lambda p: p.grad, params)
    collectives.all_reduce_data(train.tree_leaves(grads), mesh)
    for path, x in resnet.params_to_numpy(grads).items():
        out[f"grad/{path}"] = x
    for path, x in sharding.tree_paths(new_stats):
        out[f"stats/{path}"] = x.numpy()

    params, stats = resnet.params_from_numpy(ptree, stree, "cpu")
    params = train.trainable_copy(params, "cpu")
    step = resnet_dp.make_step(params, stats, cfg, lr=RESNET_LR, mesh=mesh)
    losses = []
    for i in range(3):
        b = _rows(_sub(inputs, f"step{i}/"), row0, n)
        losses.append(float(step(b["images"], b["labels"])))
    out["sgd/losses"] = np.array(losses)
    for path, x in resnet.params_to_numpy(params).items():
        out[f"sgd/param/{path}"] = x
    for path, x in sharding.tree_paths(stats):
        out[f"sgd/stats/{path}"] = x.numpy()


def main() -> int:
    src, dst, mode = sys.argv[1:4]
    torch.set_num_threads(1)
    rdv = rendezvous.from_env()
    rendezvous.initialize_distributed(rdv, torch.device("cpu"))
    inputs = dict(np.load(src))
    out = {}
    try:
        {"mnist": _mnist, "bert": _bert, "bert_odd": _bert_odd,
         "resnet": _resnet}[mode](
            inputs, rdv, out)
    finally:
        dist.destroy_process_group()
    np.savez(dst, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
