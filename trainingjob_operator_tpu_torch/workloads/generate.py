"""Sample from a Llama model with the KV-cache decoder (offline generate).

Port of the JAX package's ``workloads/generate.py``.  There is no
checkpoint restore yet, so it samples from a seeded random init.

Run: ``python -m trainingjob_operator_tpu_torch.workloads.generate
[--device cuda|cpu]``.  Env: LLAMA_CONFIG=tiny|7b, GEN_STEPS (default 32),
GEN_BATCH (default 1), GEN_TEMPERATURE (0 = greedy), GEN_TOP_K /
GEN_TOP_P (need a temperature), GEN_SEED, GEN_PROMPT (comma-separated
token ids; default "1"), GEN_QUANT=1 (weight-only int8 decode),
LLAMA_WINDOW (sliding-window span).  GEN_FAMILY=moe is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

import torch

from trainingjob_operator_tpu_torch import resolve_device


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        "python -m trainingjob_operator_tpu_torch.workloads.generate")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    from trainingjob_operator_tpu_torch.models import decode, llama

    env = os.environ
    if env.get("GEN_FAMILY", "llama") != "llama":
        raise SystemExit("GEN_FAMILY: only 'llama' is ported")
    cfg = (llama.LlamaConfig.llama2_7b()
           if env.get("LLAMA_CONFIG", "tiny") == "7b"
           else llama.LlamaConfig.tiny())
    window = int(env.get("LLAMA_WINDOW", "0"))
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

    print("warning: no checkpoint restore in the port yet, sampling from "
          "random init", flush=True)
    params = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    prompt = torch.tensor([prompt_ids] * batch, dtype=torch.long,
                          device=device)
    generator = (torch.Generator(device=device).manual_seed(seed)
                 if temperature > 0 else None)
    if quantize:
        print("decoding with weight-only int8", flush=True)
    out = decode.generate(params, prompt, cfg, steps=steps,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          generator=generator, quantize=quantize)
    for row in out.tolist():
        print("tokens:", ",".join(str(t) for t in row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
