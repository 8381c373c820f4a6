"""The flash backward kernels' (dQ and dK/dV together) share of their
roofline: the bound of every traced pair of calls
(``flops.flash_dq_bound_s`` + ``flash_dkv_bound_s``) over their device
time."""

from benchmark import flops


def read(obs):
    t = obs.trace
    if t is None:
        return None
    n_dq, us_dq = t.kernel_us("flash_bwd_dq")
    n_dkv, us_dkv = t.kernel_us("flash_bwd_dkv")
    if not n_dq or not n_dkv or not us_dq + us_dkv:
        return None
    a = obs.counters["attn"]
    shape = (a["B"], a["T"], a["H"], a["Hkv"], a["D"])
    bound = (n_dq * flops.flash_dq_bound_s(*shape)
             + n_dkv * flops.flash_dkv_bound_s(*shape))
    return 100.0 * bound / ((us_dq + us_dkv) / 1e6)
