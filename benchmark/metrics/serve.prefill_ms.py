"""Device ms a prefill chunk: the kernels under the benchmark's
``bench.prefill_chunk`` range over its calls in the traced ticks."""


def read(obs):
    t = obs.trace
    r = t.ranges.get("bench.prefill_chunk") if t is not None else None
    if not r or not r["calls"] or not r["device_us"]:
        return None
    return r["device_us"] / 1e3 / r["calls"]
