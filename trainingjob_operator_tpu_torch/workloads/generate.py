"""Sample from a Llama or MoE model with the KV-cache decoder (offline
generate).

Port of the JAX package's ``workloads/generate.py``: the parameters come
from the family's trainer's checkpoint (``llama_elastic``'s
``<dir>/llama`` or ``moe_pretrain``'s ``<dir>/moe``, the same path
contract, ``workloads/train.py`` ``CheckpointState``) without reading the
optimizer moments, or from a seeded random init where there is no
checkpoint.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.generate
[--device cuda|cpu]``.  Env: GEN_FAMILY=llama|moe (which trainer's
checkpoint to sample; any value but "moe" is Llama), LLAMA_CONFIG=tiny|
124m|7b (the trainer's configs; the JAX module reads tiny|7b) or
MOE_CONFIG=tiny|8x7b, GEN_STEPS (default 32), GEN_BATCH (default 1),
GEN_TEMPERATURE (0 = greedy), GEN_TOP_K / GEN_TOP_P (need a temperature),
GEN_SEED, GEN_PROMPT (comma-separated token ids; default "1"), GEN_QUANT=1
(weight-only int8 decode; Llama only: with MoE it warns and decodes at
full precision, as in JAX), LLAMA_WINDOW / MOE_WINDOW (sliding-window
span; must match the trainer's), TRAININGJOB_CHECKPOINT_DIR (the trainer's
checkpoint root).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Mapping, Optional, Tuple

import torch

from trainingjob_operator_tpu_torch import resolve_device


def family_of(env: Mapping[str, str]) -> str:
    """The family GEN_FAMILY names, which is also its trainer's checkpoint
    subdir: "moe", or "llama" for any other value."""
    return "moe" if env.get("GEN_FAMILY", "llama") == "moe" else "llama"


def family_config(env: Mapping[str, str]) -> Tuple[str, object]:
    """(family, config) from GEN_FAMILY and the family's config name, as
    the JAX ``generate`` and ``serve`` read them: "moe" with MOE_CONFIG
    (8x7b, else tiny), any other family Llama with LLAMA_CONFIG."""
    from trainingjob_operator_tpu_torch.models import llama, moe

    if family_of(env) == "moe":
        return "moe", moe.CONFIGS.get(env.get("MOE_CONFIG", "tiny"),
                                      moe.MoEConfig.tiny)()
    return "llama", llama.CONFIGS.get(env.get("LLAMA_CONFIG", "tiny"),
                                      llama.LlamaConfig.tiny)()


def restore_params(cfg, device, family: str = "llama") -> Tuple[dict, int]:
    """(params, step) of the family's trainer's newest checkpoint under
    ``TRAININGJOB_CHECKPOINT_DIR`` (``<dir>/<family>``), as the sampler's
    leaves on ``device`` (compute dtype for the matmul weights), or a
    seeded random init and step 0 where there is none.  The placeholder
    skips the AdamW moments: twice the parameters, never read here.  A
    checkpoint of the JAX package's trainer gives the parameters of its
    resume image (the moments are unpickled but not converted)."""
    from trainingjob_operator_tpu_torch.models import llama, moe
    from trainingjob_operator_tpu_torch.workloads import rendezvous, train

    model = moe if family == "moe" else llama
    state = train.CheckpointState.restore_or_init(
        rendezvous.from_env(),
        {"params": model.init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device),
         "opt_state": train.ckpt_placeholder(), "step": 0},
        subdir=family,
        convert=lambda tree: {"params": model.params_from_numpy(
            tree["params"], cfg, "cpu")})
    return state.value["params"], int(state.value["step"])


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.generate")
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: the card, or what "
                             "TRAININGJOB_JAX_PLATFORM asks for)")
    args = parser.parse_args(argv)
    from trainingjob_operator_tpu_torch.workloads import rendezvous

    _, device = rendezvous.prepare_worker(args.device,
                                          subdir=family_of(os.environ))
    device = resolve_device(device)

    from trainingjob_operator_tpu_torch.models import decode, moe_decode

    env = os.environ
    family, cfg = family_config(env)
    window = int(env.get("MOE_WINDOW" if family == "moe" else
                         "LLAMA_WINDOW", "0"))
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    steps = int(env.get("GEN_STEPS", "32"))
    batch = int(env.get("GEN_BATCH", "1"))
    temperature = float(env.get("GEN_TEMPERATURE", "0"))
    top_k = int(env.get("GEN_TOP_K", "0"))
    top_p = float(env.get("GEN_TOP_P", "0"))
    seed = int(env.get("GEN_SEED", "0"))
    quantize = env.get("GEN_QUANT", "") in ("1", "true")
    prompt_ids = [int(x) for x in env.get("GEN_PROMPT", "1").split(",")]

    params, step = restore_params(cfg, device, family)
    if step == 0:
        print("warning: no checkpoint found, sampling from random init",
              flush=True)
    else:
        print(f"sampling from checkpoint at step {step}", flush=True)
    prompt = torch.tensor([prompt_ids] * batch, dtype=torch.long,
                          device=device)
    generator = (torch.Generator(device=device).manual_seed(seed)
                 if temperature > 0 else None)
    sampling = dict(steps=steps, temperature=temperature, top_k=top_k,
                    top_p=top_p, generator=generator)
    if family == "moe":
        if quantize:
            print("warning: GEN_QUANT is not supported for GEN_FAMILY=moe; "
                  "decoding in full precision", flush=True)
        out = moe_decode.generate(params, prompt, cfg, **sampling)
    else:
        if quantize:
            print("decoding with weight-only int8", flush=True)
        out = decode.generate(params, prompt, cfg, quantize=quantize,
                              **sampling)
    for row in out.tolist():
        print("tokens:", ",".join(str(t) for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
