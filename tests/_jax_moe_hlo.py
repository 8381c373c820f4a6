"""Count the collectives in the JAX package's compiled MoE training step.

Run as ``JAX_PLATFORMS=cpu python tests/_jax_moe_hlo.py`` from the repo
root.  It compiles ``value_and_grad(moe.loss_fn(mesh=...))`` of the tiny
config in fp32 on meshes of the 8 virtual CPU devices, with the
parameters placed by ``moe.SHARDING_RULES``, and prints per mesh how many
all-to-all, all-gather, all-reduce, reduce-scatter and
collective-permute ops the optimised HLO text holds (an op in the layer
scan's body counts once).  It shows what XLA chose for the step that the
port computes with per-rank expert slices and sums over tp and ep.
"""

import dataclasses
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from conftest import apply_jax_platform_override  # noqa: E402

apply_jax_platform_override()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from trainingjob_operator_tpu.models import moe  # noqa: E402
from trainingjob_operator_tpu.parallel import mesh as pmesh  # noqa: E402
from trainingjob_operator_tpu.parallel import sharding  # noqa: E402

MESHES = ({"fsdp": 2, "tp": 2, "ep": 2}, {"fsdp": 4, "ep": 2},
          {"fsdp": 2, "ep": 4})
OPS = ("all-to-all", "all-gather", "all-reduce", "reduce-scatter",
       "collective-permute")


def main() -> int:
    cfg = dataclasses.replace(moe.MoEConfig.tiny(), dtype="float32")
    for sizes in MESHES:
        n = 1
        for size in sizes.values():
            n *= size
        mesh = pmesh.make_mesh(pmesh.MeshSpec.of(**sizes),
                               devices=jax.devices()[:n])
        params = sharding.shard_pytree(
            moe.init_params(cfg, jax.random.PRNGKey(0)),
            moe.SHARDING_RULES, mesh)
        step = jax.jit(jax.value_and_grad(
            lambda p, t: moe.loss_fn(p, {"tokens": t}, cfg, mesh=mesh)))
        hlo = step.lower(params, jnp.zeros((8, 17), jnp.int32)).compile() \
            .as_text()
        counts = {op: len(re.findall(rf"= [^=\n]*? {op}(-start)?\(", hlo))
                  for op in OPS}
        print(json.dumps({"mesh": sizes, "jax": jax.__version__, **counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
