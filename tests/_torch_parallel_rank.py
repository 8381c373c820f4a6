"""One rank of the gloo runs of tests/test_torch_parallel.py (Llama) and
tests/test_torch_moe_parallel.py (MoE).

Run as ``python tests/_torch_parallel_rank.py <inputs.npz> <out.npz>
[llama|moe]`` with the rendezvous env (``TRAININGJOB_COORDINATOR_ADDRESS``,
``TRAININGJOB_NUM_PROCESSES``, ``TRAININGJOB_PROCESS_ID``).  The inputs
hold the parameters (``p/<path>``, f32), a batch (``tokens``) and three
step batches (``step<i>``).  For each mesh of the family's ``CASES`` at
this world size and each remat policy of its ``REMATS`` it writes this
rank's loss and gradient blocks of ``loss_fn``, the losses and parameter
blocks after three AdamW steps of ``make_step_fn`` (accumulation
``ACCUM``: the family's trainer's), and the index ranges of its blocks.
Imports no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from trainingjob_operator_tpu_torch.models import llama, moe  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import (  # noqa: E402
    llama_elastic,
    rendezvous,
    train,
)

#: family -> world size -> mesh -> (tp, ep, num_slices).
CASES = {
    "llama": {2: {"fsdp": (1, 1, 1), "tp": (2, 1, 1), "dp": (1, 1, 2)}},
    "moe": {2: {"ep": (1, 2, 1), "tp": (2, 1, 1), "fsdp": (1, 1, 1)},
            4: {"tp_ep": (2, 2, 1)}},
}
REMATS = {"llama": ("none", "attn"), "moe": ("none", "dots")}
ACCUM = {"llama": 2, "moe": 1}
MODELS = {"llama": (llama, llama.LlamaConfig.tiny),
          "moe": (moe, moe.MoEConfig.tiny)}
ADAMW_LR = 3e-4


def _tree(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def main() -> int:
    torch.set_num_threads(1)
    src, out = sys.argv[1], sys.argv[2]
    family = sys.argv[3] if len(sys.argv) > 3 else "llama"
    model, config = MODELS[family]
    data = np.load(src)
    rdv = rendezvous.from_env()
    rendezvous.initialize_distributed(rdv, torch.device("cpu"))
    cfg = dataclasses.replace(config(), dtype="float32")
    full = model.params_from_numpy(
        _tree({k[2:]: data[k] for k in data.files if k.startswith("p/")}),
        cfg, "cpu", master=True)
    tokens = torch.from_numpy(data["tokens"]).long()
    batches = [torch.from_numpy(data[f"step{i}"]).long() for i in range(3)]
    rules = model.sharding_rules()
    res = {}
    for kind, (tp, ep, slices) in CASES[family][rdv.num_processes].items():
        spec = pmesh.mesh_spec_from_rendezvous(
            dataclasses.replace(rdv, num_slices=slices), model_parallel=tp,
            expert_parallel=ep)
        mesh = pmesh.make_mesh(spec, "cpu")
        local = sharding.shard_tree(full, rules, mesh)
        blocks = sharding.tree_blocks(model.param_shapes(cfg), rules, mesh)
        for path, block in sharding.tree_paths(blocks):
            res[f"{kind}/block/{path}"] = np.array(block[1])
        row0, n = sharding.data_rows(tokens.shape[0], mesh)
        for remat in REMATS[family]:
            key = f"{kind}/{remat}"
            params = train.trainable_copy(local, "cpu")
            loss = model.loss_fn(params, {"tokens": tokens[row0:row0 + n]},
                                 cfg, remat=remat, mesh=mesh)
            loss.backward()
            res[f"{key}/loss"] = loss.detach().numpy()
            for path, leaf in sharding.tree_paths(params):
                res[f"{key}/grad/{path}"] = leaf.grad.numpy()
            params = train.trainable_copy(local, "cpu")
            step_fn = llama_elastic.make_step_fn(
                params, cfg, accum=ACCUM[family], lr=ADAMW_LR, remat=remat,
                mesh=mesh, loss_fn=model.loss_fn)
            res[f"{key}/adamw/losses"] = np.array(
                [float(step_fn(b[row0:row0 + n])) for b in batches])
            for path, leaf in sharding.tree_paths(params):
                res[f"{key}/adamw/param/{path}"] = leaf.detach().numpy()
    np.savez(out, **res)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
