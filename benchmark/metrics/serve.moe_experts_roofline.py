"""The expert products' share of the HBM roofline: the matrices of every
(layer, expert) the traced ticks' routed calls reached, read once, and
each (row, choice) pair's bf16 input and output rows, over 3.35 TB/s,
against the device time under the program's ``moe.experts`` range."""

from benchmark import flops, flops_moe


def read(obs):
    t = obs.trace
    r = t.ranges.get("moe.experts") if t is not None else None
    reached = obs.counters.get("moe_decode_experts_reached")
    pairs = obs.counters.get("moe_decode_pairs")
    if not r or not r["device_us"] or not reached or not pairs:
        return None
    nbytes = flops_moe.experts_bytes(obs.cell.config, reached, pairs)
    return 100.0 * nbytes / flops.PEAK_HBM_BYTES / (r["device_us"] / 1e6)
