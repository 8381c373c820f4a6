"""Host wall ms a traced tick spends under the program's ``moe.route``
range (the router, and the wait for its per-expert counts to reach the
host), summed over the layers of the tick's chunk and decode step."""


def read(obs):
    t = obs.trace
    if t is None or not t.steps:
        return None
    spans = [end - start for name, start, end in t.host
             if name == "moe.route"]
    return sum(spans) / 1e3 / t.steps if spans else None
