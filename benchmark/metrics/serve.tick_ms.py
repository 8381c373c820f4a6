"""Mean host wall ms of a ``DecodeService.step()`` call over the window
(a benchmark span around each call)."""


def read(obs):
    ticks = obs.spans.get("serve.tick")
    return 1e3 * sum(ticks) / len(ticks) if ticks else None
