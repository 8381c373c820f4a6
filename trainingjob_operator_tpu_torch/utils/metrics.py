"""Counter registry of the workload: the counting part of the JAX package's
``utils/metrics.py`` (``MetricsRegistry.inc``, the Prometheus key format),
for the checkpoint fallback counters.  No exposition: a worker's counters
reach the controller through telemetry, not a scrape."""

from __future__ import annotations

import threading
from typing import Dict


def _escape_label_value(value: str) -> str:
    """Prometheus text-format label escaping: backslash, double-quote, LF."""
    return (value.replace("\\", "\\\\")
                 .replace('"', '\\"')
                 .replace("\n", "\\n"))


def _key(name: str, labels: Dict[str, str]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Thread-safe counters keyed ``name{label="value",...}``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1.0, **labels: str) -> None:
        key = _key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)


#: The process's registry.
METRICS = MetricsRegistry()
