"""Model FLOPs of the window's steps (``flops.train_flops_per_token``:
6 x the matmul parameters a token reaches, plus causal attention) over
the window's time, as a share of the card's bf16 peak.  The window's
steps are not profiled."""

from benchmark import flops


def read(obs):
    c = obs.counters
    if not c.get("window_s"):
        return None
    return 100.0 * c["model_flops"] / c["window_s"] / flops.PEAK_BF16_FLOPS
