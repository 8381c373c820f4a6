"""Device ms a step of the MoE dispatch and combine: the ``aten::bmm``
products none of whose operands has the ffn width (the one-hot
``[B, T, E*C]`` products of ``models/moe.py`` ``_moe_mlp``)."""

from benchmark.devtrace import is_moe_dispatch


def read(obs):
    t = obs.trace
    cfg = obs.cell.config
    if t is None or not cfg.get("num_local_experts") or not t.shapes_known:
        return None
    us = sum(d for op, shapes, d in t.gemms
             if is_moe_dispatch(op, shapes, cfg))
    if not us:
        return None
    return us / 1e3 / obs.counters["traced_steps"]
