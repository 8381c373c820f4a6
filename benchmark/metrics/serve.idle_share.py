"""The share of the traced steps' window in which no device operation
ran (1 - union of their intervals / window)."""


def read(obs):
    t = obs.trace
    if t is None or not t.kernels or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
