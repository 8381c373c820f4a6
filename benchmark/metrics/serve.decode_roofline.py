"""The decode step's share of its roofline: for every traced
``serve_step``, the weights it reads plus the cached keys and values its
decoding slots' positions need, over the HBM bandwidth, against the
device time under the benchmark's ``bench.serve_step`` range."""

from benchmark import flops


def read(obs):
    t = obs.trace
    r = t.ranges.get("bench.serve_step") if t is not None else None
    positions = obs.counters.get("decode_positions")
    if not r or not r["device_us"] or not positions:
        return None
    cfg = obs.cell.config
    n = min(len(positions), r["calls"])
    nbytes = sum(obs.counters["weight_bytes"]
                 + flops.decode_kv_bytes(cfg, p) for p in positions[:n])
    us = r["device_us"] * n / r["calls"]
    return 100.0 * nbytes / flops.PEAK_HBM_BYTES / (us / 1e6)
