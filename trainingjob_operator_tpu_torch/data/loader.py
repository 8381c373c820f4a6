"""One-step-ahead batch prefetch: own copy of the JAX package's
``data/loader.py`` ``Prefetcher``.

A background thread runs ``fetch(step)`` for the next step while the
current one computes on the card.  ``fetch`` returns a host tensor; for a
CUDA ``device`` the thread pins it, and ``next()`` copies it to the card
with ``non_blocking=True`` on the consumer's current stream, so the copy is
ordered before the step that reads it whatever stream the consumer uses
(a tensor made on the helper thread would sit on that thread's stream).
Exceptions of ``fetch`` are raised at the matching ``next()``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable

import torch

from trainingjob_operator_tpu_torch import constants, resolve_device

_DONE = object()


def _stall_timeout() -> float:
    """Seconds of consumer wait per warning (TRAININGJOB_PREFETCH_STALL_S,
    default 300, at least 0.1)."""
    try:
        v = float(os.environ.get(constants.PREFETCH_STALL_ENV, "300")
                  or 300)
    except ValueError:
        v = 300.0
    return max(v, 0.1)


class Prefetcher:
    """Iterates ``(step, fetch(step))`` for step = start..stop-1, one step
    ahead, each batch on ``device`` (the card unless the caller asks for
    the CPU)."""

    def __init__(self, fetch: Callable[[int], torch.Tensor], start: int,
                 stop: int, device="cuda"):
        self._fetch = fetch
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(start, stop), name="prefetcher",
            daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._shutdown.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, start: int, stop: int) -> None:
        for step in range(start, stop):
            if self._shutdown.is_set():
                return
            try:
                batch = self._fetch(step)
                if self._device.type == "cuda":
                    batch = batch.pin_memory()
                item = (step, batch, None)
            # Forwarded through the queue and raised in __next__.
            except BaseException as exc:
                self._put((step, None, exc))
                return
            if not self._put(item):
                return
        self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        """(step, batch) in order; raises the producer's exception, or
        StopIteration after the last step."""
        if self._shutdown.is_set():
            raise StopIteration
        stall = _stall_timeout()
        waited = 0.0
        while True:
            try:
                item = self._q.get(timeout=stall)
                break
            except queue.Empty:
                waited += stall
                if not self._thread.is_alive():
                    # The producer may have queued its last item and exited
                    # between the timeout and this check.
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        pass
                    raise RuntimeError(
                        f"prefetcher thread died after {waited:.0f} s wait "
                        f"(dataset IO crashed?)")
                if self._shutdown.is_set():
                    raise StopIteration
                print(f"WARNING: prefetcher stalled {waited:.0f} s; producer "
                      f"thread alive, still waiting (slow dataset IO? tune "
                      f"TRAININGJOB_PREFETCH_STALL_S)", flush=True)
        if item is _DONE:
            self._thread.join(timeout=5.0)
            raise StopIteration
        step, batch, exc = item
        if exc is not None:
            self.close()
            raise exc
        return step, batch.to(self._device, non_blocking=True)

    def close(self) -> None:
        """Stop the producer (an early exit of the loop)."""
        self._shutdown.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
