"""One rank of the gloo runs of sequence and pipeline parallelism:
tests/test_torch_ring.py (ring attention) and tests/test_torch_parallel.py
(the Llama loss on sp and pp meshes).

Run as ``python tests/_torch_sp_pp_rank.py <inputs.npz> <out.npz> ring|llama``
with the rendezvous env (``TRAININGJOB_COORDINATOR_ADDRESS``,
``TRAININGJOB_NUM_PROCESSES``, ``TRAININGJOB_PROCESS_ID``).  For each mesh
of the kind's cases at this world size it writes, under
``<mesh>/<case>/``:

- ring: this rank's out and dq, dk, dv blocks of ``ring_attention`` on its
  rows and sequence block of the global q, k, v (``q``, ``k_<Hkv>``,
  ``v_<Hkv>``) with the loss ``sum(out * w)``, and its ``p2p`` shifts;
- llama: the loss and gradient blocks of ``llama.loss_fn`` on the tiny
  config with ``LAYERS`` layers in fp32 (``p/<path>``, ``tokens``) under
  each remat policy of ``REMATS``, the ``p2p`` shifts, the pipeline's
  microbatches and the index ranges of the blocks.

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

from trainingjob_operator_tpu_torch.models import llama  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import collectives  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import ringattention  # noqa: E402
from trainingjob_operator_tpu_torch.parallel import sharding  # noqa: E402
from trainingjob_operator_tpu_torch.workloads import (  # noqa: E402
    rendezvous,
    train,
)

#: kind -> world size -> mesh -> (tp, sp, pp).
CASES = {
    "ring": {4: {"fsdp2_sp2": (1, 2, 1), "sp4": (1, 4, 1)}},
    "llama": {2: {"sp2": (1, 2, 1), "pp2": (1, 1, 2)},
              4: {"tp2_sp2": (2, 2, 1), "pp2_fsdp2": (1, 1, 2),
                  "pp2_sp2": (1, 2, 2)}},
}
#: Ring cases: (query heads, KV heads, causal).
RING_CASES = [(4, 4, True), (4, 4, False), (4, 2, True), (4, 2, False)]
REMATS = ("none", "attn")
LAYERS = 4


def _tree(flat):
    tree = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _mesh(rdv, tp, sp, pp):
    spec = pmesh.mesh_spec_from_rendezvous(
        rdv, model_parallel=tp, sequence_parallel=sp, pipeline_parallel=pp)
    return pmesh.make_mesh(spec, "cpu")


def ring(data, rdv, res):
    for name, (tp, sp, pp) in CASES["ring"][rdv.num_processes].items():
        mesh = _mesh(rdv, tp, sp, pp)
        row0, n = sharding.data_rows(data["q"].shape[0], mesh)
        T = data["q"].shape[1]
        tl, r = T // sp, mesh.coord("sp")

        def block(x):
            return torch.from_numpy(
                x[row0:row0 + n, r * tl:(r + 1) * tl]).requires_grad_(True)

        for hq, hkv, causal in RING_CASES:
            key = f"{name}/{hq}_{hkv}_{int(causal)}"
            q, k, v = (block(data[x]) for x in
                       ("q", f"k_{hkv}", f"v_{hkv}"))
            w = block(data["w"]).detach()
            collectives.reset_collective_counts()
            out = ringattention.ring_attention(q, k, v, mesh, causal=causal)
            (out * w).sum().backward()
            res[f"{key}/p2p"] = collectives.collective_counts()["p2p"]
            res[f"{key}/rows"] = np.array([row0, n, r * tl, tl])
            for part, x in (("out", out), ("dq", q.grad), ("dk", k.grad),
                            ("dv", v.grad)):
                res[f"{key}/{part}"] = x.detach().numpy()


def llama_cases(data, rdv, res):
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(n_layers=LAYERS),
                              dtype="float32")
    full = llama.params_from_numpy(
        _tree({k[2:]: data[k] for k in data.files if k.startswith("p/")}),
        cfg, "cpu", master=True)
    tokens = torch.from_numpy(data["tokens"]).long()
    for name, (tp, sp, pp) in CASES["llama"][rdv.num_processes].items():
        mesh = _mesh(rdv, tp, sp, pp)
        rules = llama.mesh_rules(mesh)
        local = sharding.shard_tree(full, rules, mesh)
        blocks = sharding.tree_blocks(llama.param_shapes(cfg), rules, mesh)
        for path, block in sharding.tree_paths(blocks):
            res[f"{name}/block/{path}"] = np.array(block[1])
        row0, n = sharding.data_rows(tokens.shape[0], mesh)
        res[f"{name}/microbatches"] = np.array(
            llama.pipeline_microbatches(n, mesh) if pp > 1 else (1, 1))
        for remat in REMATS:
            key = f"{name}/{remat}"
            params = train.trainable_copy(local, "cpu")
            collectives.reset_collective_counts()
            loss = llama.loss_fn(params, {"tokens": tokens[row0:row0 + n]},
                                 cfg, remat=remat, mesh=mesh,
                                 sequence_parallel=sp > 1)
            loss.backward()
            res[f"{key}/p2p"] = collectives.collective_counts()["p2p"]
            res[f"{key}/loss"] = loss.detach().numpy()
            for path, leaf in sharding.tree_paths(params):
                res[f"{key}/grad/{path}"] = leaf.grad.numpy()


def main() -> int:
    torch.set_num_threads(1)
    src, out, kind = sys.argv[1], sys.argv[2], sys.argv[3]
    data = np.load(src)
    rdv = rendezvous.from_env()
    rendezvous.initialize_distributed(rdv, torch.device("cpu"))
    res = {}
    {"ring": ring, "llama": llama_cases}[kind](data, rdv, res)
    np.savez(out, **res)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
