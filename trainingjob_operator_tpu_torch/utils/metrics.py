"""Counter registry of the workload: the counting part of the JAX package's
``utils/metrics.py`` (``MetricsRegistry.inc``, the Prometheus key format),
for the checkpoint fallback counters and the routed decode's counters.  No
exposition: a worker's counters reach the controller through telemetry, not
a scrape.

A counter may also be added to with a 0-d tensor: the sum stays on the
tensor's device, so the caller never waits for it, and ``snapshot`` folds
every pending sum into the counters with one read a device."""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch


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
        #: (key, device) -> a 0-d tensor summed on that device, not yet read.
        self._pending: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def inc(self, name: str, value=1.0, **labels: str) -> None:
        """Add ``value``: a number, or a 0-d tensor, which is not read (the
        sum stays on its device until ``snapshot``)."""
        key = _key(name, labels)
        with self._lock:
            if isinstance(value, torch.Tensor):
                at = (key, value.device)
                prev = self._pending.get(at)
                self._pending[at] = value if prev is None else prev + value
            else:
                self._counters[key] = self._counters.get(key, 0.0) + value

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            by_device: Dict[torch.device, List[Tuple[str, torch.Tensor]]] = {}
            for (key, device), value in self._pending.items():
                by_device.setdefault(device, []).append((key, value))
            self._pending.clear()
            for items in by_device.values():
                read = torch.stack([v.double() for _, v in items]).tolist()
                for (key, _), value in zip(items, read):
                    self._counters[key] = self._counters.get(key, 0.0) + value
            return dict(self._counters)


#: The process's registry.
METRICS = MetricsRegistry()
