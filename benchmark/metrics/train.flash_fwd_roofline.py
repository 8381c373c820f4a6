"""The flash forward kernels' share of their roofline: the bound of
every traced call (``flops.flash_fwd_bound_s`` at the step's attention
shape) over their device time."""

from benchmark import flops


def read(obs):
    t = obs.trace
    if t is None:
        return None
    n, us = t.kernel_us("flash_fwd")
    if not n or not us:
        return None
    a = obs.counters["attn"]
    bound = flops.flash_fwd_bound_s(a["B"], a["T"], a["H"], a["Hkv"], a["D"])
    return 100.0 * n * bound / (us / 1e6)
