"""The port as the entries see it: its config for a configuration file,
and its kernel library built into the benchmark's cache directory."""

from __future__ import annotations

import os


def program(cfg: dict):
    """(the port's model module, its config) for the configuration file
    ``cfg`` (the model's published keys)."""
    from trainingjob_operator_tpu_torch.models import llama, moe

    if cfg["hidden_size"] // cfg["num_attention_heads"] != cfg["head_dim"]:
        raise ValueError("the port derives head_dim as hidden_size / heads")
    common = dict(vocab_size=cfg["vocab_size"], dim=cfg["hidden_size"],
                  n_layers=cfg["num_hidden_layers"],
                  n_heads=cfg["num_attention_heads"],
                  n_kv_heads=cfg["num_key_value_heads"],
                  ffn_dim=cfg["intermediate_size"],
                  max_seq_len=cfg["max_position_embeddings"],
                  rope_theta=float(cfg["rope_theta"]),
                  norm_eps=float(cfg["rms_norm_eps"]),
                  sliding_window=int(cfg["sliding_window"] or 0),
                  dtype=cfg["torch_dtype"])
    if cfg.get("num_local_experts"):
        return moe, moe.MoEConfig(
            **common, n_experts=cfg["num_local_experts"],
            experts_per_token=cfg["num_experts_per_tok"],
            capacity_factor=float(cfg["capacity_factor"]),
            aux_loss_weight=float(cfg["router_aux_loss_coef"]))
    return llama, llama.LlamaConfig(**common)


def load_kernels(device) -> None:
    """Point the kernel library at the benchmark's cache directory and
    load it (built there by ``nvcc`` on a checkout's first run)."""
    if device.type != "cuda":
        return
    from trainingjob_operator_tpu_torch.ops import _build

    _build.set_cache_dir(os.environ.get("TRAININGJOB_COMPILE_CACHE_DIR",
                                        ""))
    _build.library()
