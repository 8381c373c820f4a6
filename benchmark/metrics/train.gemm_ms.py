"""Device ms a step of cuBLAS products (``aten::mm``, ``bmm``,
``addmm``, forward and backward), the MoE dispatch and combine left out
(``train.moe_dispatch_ms`` has them)."""

from benchmark.devtrace import is_moe_dispatch


def read(obs):
    t = obs.trace
    if t is None or not t.gemms:
        return None
    cfg = obs.cell.config
    if cfg.get("num_local_experts") and not t.shapes_known:
        return None
    us = sum(d for op, shapes, d in t.gemms
             if not is_moe_dispatch(op, shapes, cfg))
    if not us:
        return None
    return us / 1e3 / obs.counters["traced_steps"]
