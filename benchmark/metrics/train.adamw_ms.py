"""Device ms a step of the trainer's ``AdamW.step``: CUDA events around
it on the stream, in the traced steps, where the host runs ahead of the
card and its kernels run back to back."""


def read(obs):
    ms = obs.counters.get("adamw_ms")
    return sum(ms) / len(ms) if ms else None
